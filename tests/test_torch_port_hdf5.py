"""The port's HDF5 reader (gfla_tpu_torch/data/hdf5.py) against h5py, and
the ShapeNet dataset that reads through it against gfla_tpu's, which reads
through h5py.

Stores are written here with h5py in every layout the reader takes:
contiguous, chunked gzip level 4, shuffle + gzip, grey (H, W) and RGBA
images, int32 and int64 poses (either byte order), a scalar, and a root of
2400 tiny groups whose group B-tree has more than one level. Each array
the reader returns equals h5py's in dtype, shape and every element; a
missing view raises KeyError, and what the reader does not read (a
libver="latest" dense group, an lzf dataset) raises an error that names
it. The committed fixture tests/fixtures/shapenet_car, read by both, holds
what its `digests.json` says.
"""

import argparse
import hashlib
import json
import os
import pickle

import h5py
import numpy as np
import pytest
import torch
from torch_port_store import (
    FIXTURE,
    SHAPENET_AZIMUTHS,
    fixture_image,
    write_fixture_store,
)

from gfla_tpu.data.shapenet_data import ShapeNetDataset as JaxShapeNetDataset
from gfla_tpu_torch.data import collate, hdf5
from gfla_tpu_torch.data.shapenet_data import ShapeNetDataset
from gfla_tpu_torch.tasks.pose import prepare_batch

MANY = 2400  # tiny groups at the root: a group B-tree of two levels


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """A store of every layout, and the names of its datasets."""
    path = tmp_path_factory.mktemp("hdf5") / "layouts.hdf5"
    rng = np.random.RandomState(0)
    names = []
    with h5py.File(path, "w") as f:
        def put(name, data, **kw):
            f.create_dataset(name, data=data, **kw)
            names.append(name)

        put("contiguous/image", rng.randint(0, 256, (33, 17, 3))
            .astype(np.uint8))
        put("gzip/image", rng.randint(0, 256, (64, 64, 3)).astype(np.uint8),
            compression="gzip", compression_opts=4)
        put("gzip/edges", rng.randn(37, 21).astype(np.float32),
            compression="gzip", compression_opts=4, chunks=(8, 5))
        put("shuffle/image", rng.randint(0, 256, (40, 24, 3))
            .astype(np.uint8), compression="gzip", shuffle=True)
        put("shuffle/values", rng.randn(50, 7).astype(">f8"),
            compression="gzip", shuffle=True, chunks=(16, 7))
        put("grey/image", rng.randint(0, 256, (20, 30)).astype(np.uint8))
        put("rgba/image", rng.randint(0, 256, (20, 30, 4)).astype(np.uint8))
        put("pose32", np.array([7, 10], np.int32))
        put("pose64", np.array([-3, 20], np.int64))
        put("pose64be", np.array([5, 0], ">i8"))
        put("scalar", np.float32(2.5))
        put("half", rng.randn(3, 5).astype(np.float16))
        for i in range(MANY):
            f.create_group(f"v{i:05d}_{i % 18}_0")["pose"] = np.array(
                [i, i % 3], np.int64)
    return path, names


def test_every_layout_matches_h5py(layouts):
    path, names = layouts
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        for name in names:
            got, want = f[name][()], ref[name][()]
            assert got.dtype == want.dtype, name
            assert got.shape == want.shape, name
            assert np.array_equal(got, want), name
        # the same datasets reached group by group
        assert np.array_equal(f["gzip"]["image"][()], ref["gzip/image"][()])


def test_many_groups_search_a_deep_group_btree(layouts):
    path, _ = layouts
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        level, _, children = f._node(f.root._btree, 0, f._l)
        assert level >= 1 and len(children) > 1
        for i in list(range(0, MANY, 97)) + [MANY - 1]:
            key = f"v{i:05d}_{i % 18}_0"
            got = f[key]["pose"][()]
            assert got.dtype == np.int64
            assert np.array_equal(got, ref[key]["pose"][()]), key


@pytest.mark.parametrize("key", ["v00000_1_0", "w", "v99999_0_0", "0", "a",
                                 "gzip/nope", "contiguous/image/x"])
def test_missing_name_raises_key_error(layouts, key):
    with hdf5.File(layouts[0]) as f:
        with pytest.raises(KeyError):
            f[key]


def test_file_does_not_pickle(layouts):
    with hdf5.File(layouts[0]) as f:
        with pytest.raises(TypeError, match="does not pickle"):
            pickle.dumps(f)


def test_unsupported_structures_are_named(tmp_path):
    """A dense new-style group (libver="latest", more links than a compact
    group holds) and an lzf dataset: each refused with what it is."""
    dense = tmp_path / "latest.hdf5"
    with h5py.File(dense, "w", libver="latest") as f:
        for i in range(20):
            f.create_group(f"view_{i}_0")["pose"] = np.array([i, 0])
    with pytest.raises(hdf5.UnsupportedHDF5,
                       match="new-style group .dense: its links in a "
                             "fractal heap indexed by a version-2 B-tree"):
        hdf5.File(dense)
    lzf = tmp_path / "lzf.hdf5"
    with h5py.File(lzf, "w") as f:
        f.create_dataset("v/image", data=np.zeros((8, 8, 3), np.uint8),
                         compression="lzf")
    with hdf5.File(lzf) as f:
        with pytest.raises(hdf5.UnsupportedHDF5, match="the lzf filter"):
            f["v"]["image"][()]


def _check_digests(read):
    with open(os.path.join(FIXTURE, "digests.json")) as fh:
        digests = json.load(fh)
    assert len(digests) == 2 * len(SHAPENET_AZIMUTHS)
    for key, want in digests.items():
        image, pose = read(key)
        assert hashlib.sha256(image.tobytes()).hexdigest() == \
            want["sha256"], key
        assert list(image.shape) == want["shape"] == [64, 64, 3], key
        assert str(image.dtype) == want["dtype"] == "uint8", key
        assert pose.tolist() == want["pose"], key


def test_committed_fixture_holds_its_digests():
    """Both readers give every view its digest; the images are the ones
    `write_fixture_store` draws, and car1's are chunked with gzip."""
    path = os.path.join(FIXTURE, "data_car.hdf5")
    with hdf5.File(path) as f:
        _check_digests(lambda k: (f[k]["image"][()], f[k]["pose"][()]))
        assert f["car0_0_0"]["image"]._class == 1
        assert f["car1_0_0"]["image"]._class == 2
        assert f["car0_0_0"]["pose"].dtype == np.int32
        assert f["car1_0_0"]["pose"].dtype == np.int64
    with h5py.File(path, "r") as f:
        _check_digests(lambda k: (f[k]["image"][()], f[k]["pose"][()]))
        assert f["car1_2_0"]["image"].compression == "gzip"
        assert f["car1_2_0"]["image"].compression_opts == 4
        assert np.array_equal(fixture_image(1, 20),
                              f["car1_2_0"]["image"][()])


def test_fixture_writer_gives_the_committed_content(tmp_path):
    root = write_fixture_store(str(tmp_path / "car"))
    for name in ("digests.json", "id_car_train.txt", "id_car_test.txt",
                 "name_car_test.txt"):
        with open(os.path.join(root, name)) as a, \
                open(os.path.join(FIXTURE, name)) as b:
            assert a.read() == b.read(), name


# --- the dataset against gfla_tpu's ------------------------------------------

def _data_opt(root, phase, load_size):
    return argparse.Namespace(
        dataroot=str(root), phase=phase, isTrain=phase == "train",
        load_size=load_size, ang_skip=20, sub_dataset_model="car",
        label_nc_h=18, label_nc_v=3)


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def odd_store(tmp_path_factory):
    """A store of grey and RGBA views (chunked, shuffled and gzipped) with
    int64 poses: the dataset's `_rgb` path."""
    root = tmp_path_factory.mktemp("odd") / "car"
    os.makedirs(root)
    ids = []
    with h5py.File(root / "data_car.hdf5", "w") as f:
        for i, name in enumerate(("grey", "rgba")):
            for a in SHAPENET_AZIMUTHS:
                key = f"{name}_{a // 10}_0"
                img = fixture_image(i, a, 32)
                img = img[..., 0] if i == 0 else np.concatenate(
                    [img, img[..., :1] // 2 + 7], -1)
                g = f.create_group(key)
                g.create_dataset("image", data=img, compression="gzip",
                                 shuffle=True)
                g.create_dataset("pose", data=np.array([a // 10, 0],
                                                       np.int64))
                ids.append(key)
    for phase in ("train", "test"):
        (root / f"id_car_{phase}.txt").write_text("\n".join(ids) + "\n")
    (root / "name_car_test.txt").write_text("grey\nrgba\n")
    return root


@pytest.mark.parametrize("where,load", [("fixture", 64), ("fixture", 48),
                                        ("odd", 32)])
def test_dataset_matches_gfla_tpu(odd_store, where, load):
    """Training samples under one seeded rng, and every test sweep, after
    the port's device-side resize: gfla_tpu's samples exactly."""
    root = FIXTURE if where == "fixture" else odd_store
    cpu = torch.device("cpu")
    port = ShapeNetDataset(_data_opt(root, "train", load))
    ref = JaxShapeNetDataset(_data_opt(root, "train", load))
    assert len(port) == len(ref) == 36
    port.rng, ref.rng = (np.random.RandomState(11) for _ in "ab")
    for i in range(0, len(ref), 5):
        want, got = ref[i], port[i]
        for key in ("P1_path", "P2_path", "BP1", "BP2"):
            assert np.array_equal(got[key], want[key]), (i, key)
        prepared = prepare_batch(collate([got]), cpu, load)
        for key in ("P1", "P2"):
            assert np.array_equal(_nhwc(prepared[key])[0], want[key])
    port = ShapeNetDataset(_data_opt(root, "test", load))
    ref = JaxShapeNetDataset(_data_opt(root, "test", load))
    assert len(port) == len(ref) == 2
    for i in range(2):
        want, got = ref[i], port[i]
        prepared = prepare_batch(collate([got]), cpu, load)
        assert np.array_equal(_nhwc(prepared["P1"])[0], want["P1"])
        assert np.array_equal(prepared["P2"][0].permute(0, 2, 3, 1).numpy(),
                              want["P2"])
        assert np.array_equal(prepared["BP2"][0].numpy(), want["BP2"])
        assert got["P2_path"] == want["P2_path"]
    assert pickle.loads(pickle.dumps(port))._h5 is None
