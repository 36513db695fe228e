"""A small ShapeNet-layout HDF5 store for the port's tests, written with
h5py."""

import os

import numpy as np

SHAPENET_AZIMUTHS = list(range(0, 360, 20))


def write_shapenet_store(root, objects=("obj0", "obj1"), size=32, seed=0,
                         model="car"):
    """A ShapeNet-layout store (gfla_tpu/data/shapenet_data.py): each
    object's 18 azimuths at elevation slot 0 in `data_{model}.hdf5`, groups
    `{object}_{azimuth / 10}_0` holding a seeded uint8 (size, size, 3)
    `image` and `pose` (azimuth / 10, 0); every view listed in
    `id_{model}_train.txt` and `id_{model}_test.txt`, the objects in
    `name_{model}_test.txt`."""
    import h5py

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    ids = []
    yy, xx = np.mgrid[:size, :size]
    with h5py.File(os.path.join(root, f"data_{model}.hdf5"), "w") as f:
        for i, name in enumerate(objects):
            for a in SHAPENET_AZIMUTHS:
                key = f"{name}_{a // 10}_0"
                smooth = np.stack([(yy * 7 + a) % 256, (xx * 5 + 40 * i) % 256,
                                   (xx + yy) * 3 % 256], -1)
                noise = rng.randint(-30, 31, (size, size, 3))
                group = f.create_group(key)
                group["image"] = np.clip(smooth + noise, 0, 255).astype(
                    np.uint8)
                group["pose"] = np.array([a // 10, 0], np.int32)
                ids.append(key)
    for phase in ("train", "test"):
        with open(os.path.join(root, f"id_{model}_{phase}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    with open(os.path.join(root, f"name_{model}_test.txt"), "w") as f:
        f.write("\n".join(objects) + "\n")
    return str(root)


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "shapenet_car")
FIXTURE_SIZE = 64


def fixture_image(obj, azimuth, size=FIXTURE_SIZE):
    """A (size, size, 3) uint8 view of object `obj` at `azimuth` degrees:
    a shaded ellipse turned with the azimuth over a graded ground, in 16
    levels a channel, so that gzip has runs to compress."""
    yy, xx = np.mgrid[:size, :size] / (size - 1.0) * 2 - 1
    t = np.deg2rad(azimuth)
    u = xx * np.cos(t) + yy * np.sin(t) * 0.3
    v = yy - 0.2
    body = (u / (0.7 - 0.2 * obj)) ** 2 + (v / 0.35) ** 2 < 1
    ground = np.stack([60 + 40 * (yy + 1), 80 + 20 * (xx + 1),
                       120 + 30 * yy], -1)
    paint = np.stack([150 + 90 * np.cos(t + 3 * u), 90 + 60 * obj + 40 * v,
                      200 - 80 * obj + 30 * np.sin(t) + 0 * u], -1)
    image = np.clip(np.where(body[..., None], paint, ground), 0, 255)
    return (image.astype(np.uint8) // 16 * 16).astype(np.uint8)


def write_fixture_store(root=FIXTURE, model="car"):
    """tests/fixtures/shapenet_car: 2 objects x 18 azimuths at elevation
    slot 0, 64x64x3 uint8 views. `car0`'s images are contiguous with
    int32 poses, as `write_shapenet_store` writes them; `car1`'s chunked
    with gzip level 4 and int64 poses, as
    scripts/make_synth_shapenet_dataset.py writes them. Beside the store,
    the id and name lists and `digests.json`: each view's sha256 of its
    image bytes, its shape and dtype, and its pose. h5py stamps times into
    the file, so only what it holds is compared, never its bytes."""
    import hashlib
    import json

    import h5py

    os.makedirs(root, exist_ok=True)
    ids, digests = [], {}
    with h5py.File(os.path.join(root, f"data_{model}.hdf5"), "w") as f:
        for i, name in enumerate(("car0", "car1")):
            for a in SHAPENET_AZIMUTHS:
                key = f"{name}_{a // 10}_0"
                image = fixture_image(i, a)
                pose = np.array([a // 10, 0], (np.int32, np.int64)[i])
                group = f.create_group(key)
                if i == 0:
                    group["image"] = image
                    group["pose"] = pose
                else:
                    group.create_dataset("image", data=image,
                                         compression="gzip",
                                         compression_opts=4)
                    group.create_dataset("pose", data=pose)
                ids.append(key)
                digests[key] = {
                    "sha256": hashlib.sha256(image.tobytes()).hexdigest(),
                    "shape": list(image.shape), "dtype": str(image.dtype),
                    "pose": pose.tolist()}
    for phase in ("train", "test"):
        with open(os.path.join(root, f"id_{model}_{phase}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    with open(os.path.join(root, f"name_{model}_test.txt"), "w") as f:
        f.write("car0\ncar1\n")
    with open(os.path.join(root, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return str(root)


if __name__ == "__main__":
    print(write_fixture_store())
