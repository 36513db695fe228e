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
