"""The port's file-backed pose data against gfla_tpu's, on the CPU.

A DeepFashion-layout and a Market-layout tree of 8 JPEGs at 64x44, written
here with PIL, go through gfla_tpu's datasets (its native warp-resize pass)
and the port's (the JPEG bytes, decoded by the port's CPU decoder, PIL, and
warped and resized by data/resample.py in `prepare_batch`), with the same
options and seed:
- P1 and P2 within 1e-5 abs (the native pass's coordinate arithmetic is
  reproduced exactly; its blend's fused products part the two by ~4e-7);
- KP1 and KP2 within 1e-5 (both truncate to the same integers);
- augmentation off, on, and at market's train-time ranges.
Also: `resample` against gfla_tpu's native pass on random inverse matrices,
fully off-image ones included, within 1e-5; the loader's index batches equal
gfla_tpu's `DataLoader._index_batches` over two epochs with an `exclude`
set; the committed JPEG fixture decodes to its PIL array; the PNG writer
round-trips through PIL bit-exactly; and the default `--dataset_mode`
(fashion) parses, which raised KeyError while the port had only `synthetic`.
"""

import argparse
import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_trees import write_tree

from gfla_tpu.data import native
from gfla_tpu.data.affine import inverse_affine_matrix as jax_inverse
from gfla_tpu.data.loader import DataLoader as JaxDataLoader
from gfla_tpu.data.paired_dataset import FashionDataset as JaxFashion
from gfla_tpu.data.paired_dataset import MarketDataset as JaxMarket
from gfla_tpu_torch.data import collate, make_loader
from gfla_tpu_torch.data.image_io import (
    decode_jpeg_batch,
    upsample_chroma,
    write_png,
    ycc_to_rgb,
)
from gfla_tpu_torch.data.loader import EpochBatchSampler
from gfla_tpu_torch.data.paired_dataset import FashionDataset, MarketDataset
from gfla_tpu_torch.data.resample import affine_resize_normalize
from gfla_tpu_torch.options import TrainOptions
from gfla_tpu_torch.tasks.pose import prepare_batch

FIXTURES = Path(__file__).resolve().parent / "fixtures"
ATOL = 1e-5


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the other test workers share these cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    return {"fashion": write_tree(base / "fashion", "fasion"),
            "market": write_tree(base / "market", "market",
                                 old_size=(128, 64), seed=1)}


CASES = {  # dataset, phase, is_train, ranges (None: the dataset's)
    "fashion-plain": ("fashion", "test", False, {}),
    "fashion-augmented": ("fashion", "train", True,
                          dict(angle=(-10, 10), shift=(-6, 6),
                               scale=(0.9, 1.1))),
    "market-train-ranges": ("market", "train", True, {}),
    "market-test": ("market", "test", False, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_samples_match_gfla_tpu(trees, case):
    assert native.available(), "gfla_tpu's native pass did not build"
    mode, phase, is_train, ranges = CASES[case]
    jax_cls, cls = {"fashion": (JaxFashion, FashionDataset),
                    "market": (JaxMarket, MarketDataset)}[mode]

    def opt():
        o = argparse.Namespace(dataroot=trees[mode], phase=phase,
                               load_size=64, seed=3, angle=None, shift=None,
                               scale=None)
        for k, v in ranges.items():
            setattr(o, k, v)
        return o

    want_opt = jax_cls.apply_defaults(opt(), is_train)
    got_opt = cls.apply_defaults(opt(), is_train)
    assert vars(got_opt) == vars(want_opt)
    if mode == "market" and is_train:
        assert got_opt.angle == (-5, 5) and got_opt.scale == (0.95, 1.05)
    want_ds, got_ds = jax_cls(want_opt), cls(got_opt)
    assert len(got_ds) == len(want_ds) == 12
    for i in range(len(want_ds)):
        want = want_ds[i]
        raw = got_ds[i]
        assert raw["P1_path"] == want["P1_path"]
        assert raw["P2_path"] == want["P2_path"]
        got = prepare_batch(collate([raw]), torch.device("cpu"),
                            got_opt.load_size)
        for key in ("P1", "P2"):
            img = got[key][0].permute(1, 2, 0).numpy()
            assert img.shape == want[key].shape
            np.testing.assert_allclose(img, want[key], rtol=0, atol=ATOL,
                                       err_msg=f"{case} sample {i} {key}")
        for key in ("KP1", "KP2"):
            np.testing.assert_allclose(raw[key], want[key], rtol=0,
                                       atol=ATOL)
        moved = not np.array_equal(raw["P1_inv"], np.eye(2, 3))
        assert moved == bool(ranges or (mode == "market" and is_train))


def _random_inverse(rng, hw):
    H, W = hw
    center = (W * 0.5 + 0.5, H * 0.5 + 0.5)
    return np.asarray(jax_inverse(
        center, rng.uniform(-40, 40), (rng.uniform(-15, 15),
                                       rng.uniform(-15, 15)),
        rng.uniform(0.5, 1.6)), np.float32)


@pytest.mark.parametrize("src_hw,out_hw", [
    ((64, 44), (64, 64)), ((256, 176), (256, 256)), ((128, 64), (128, 64)),
    ((31, 17), (20, 45))], ids=["fashion-64", "fashion-256", "market",
                               "odd"])
def test_resample_matches_native_pass(src_hw, out_hw):
    assert native.available(), "gfla_tpu's native pass did not build"
    rng = np.random.RandomState(sum(src_hw))
    B = 6
    src = rng.randint(0, 256, (B, *src_hw, 3)).astype(np.uint8)
    inv = np.stack([_random_inverse(rng, out_hw) for _ in range(B - 2)]
                   + [np.array([1, 0, 4 * out_hw[1], 0, 1, 0], np.float32),
                      np.array([0.2, 0, -3 * out_hw[1], 0, 0.3,
                                5 * out_hw[0]], np.float32)])
    got = affine_resize_normalize(torch.from_numpy(src), out_hw,
                                  torch.from_numpy(inv)).numpy()
    for b in range(B):
        want = native.affine_resize_normalize(src[b], out_hw, inv[b])
        np.testing.assert_allclose(got[b], want, rtol=0, atol=ATOL)
    fill = np.float32(128) / np.float32(127.5) - np.float32(1)
    np.testing.assert_array_equal(got[-2:], fill)  # wholly off the image
    plain = affine_resize_normalize(torch.from_numpy(src[:1]), out_hw)
    np.testing.assert_allclose(
        plain[0].numpy(), native.affine_resize_normalize(src[0], out_hw),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,batch,shuffle,drop_last,exclude", [
    (37, 8, True, True, [3, 11, 30]),
    (37, 8, True, False, None),
    (20, 4, False, True, [0, 19]),
    (9, 8, True, False, [2, 2, 5]),
], ids=["train-exclude", "shuffle-tail", "serial-exclude", "repeat-exclude"])
def test_index_batches_match_gfla_tpu(n, batch, shuffle, drop_last,
                                      exclude):
    exclude = None if exclude is None else np.asarray(exclude)
    want = JaxDataLoader(list(range(n)), batch, shuffle=shuffle,
                         drop_last=drop_last, num_workers=0, seed=5)
    want.exclude = exclude
    sampler = EpochBatchSampler(n, batch, shuffle, drop_last, seed=5,
                                exclude=exclude)
    for epoch in range(2):
        want._epoch = epoch
        got = list(sampler)
        assert got == [b.tolist() for b in want._index_batches()]
    assert len(sampler) == len(want)


def test_loader_batches_hold_bytes_lists_and_stacked_arrays(trees):
    opt = FashionDataset.apply_defaults(argparse.Namespace(
        dataroot=trees["fashion"], phase="test", load_size=64, seed=0,
        batchSize=5, serial_batches=True, nThreads=0), False)
    batches = list(make_loader(FashionDataset(opt), opt, train=False))
    assert [len(b["P1"]) for b in batches] == [5, 5, 2]
    first = batches[0]
    assert isinstance(first["P1"], list) and first["P1"][0].dtype == np.uint8
    assert first["P1_inv"].shape == (5, 2, 3)
    assert first["KP1"].shape == (5, 18, 2)
    assert first["P1_path"][0].endswith(".jpg")


def test_pil_fixture_decodes_to_its_array():
    data = np.fromfile(FIXTURES / "pil_q75_96x64.jpg", np.uint8)
    (img,) = decode_jpeg_batch([data], "cpu", ["pil_q75_96x64.jpg"])
    np.testing.assert_array_equal(img.numpy(),
                                  np.load(FIXTURES / "pil_q75_96x64.npy"))


def test_decoder_failure_names_the_file():
    with pytest.raises(ValueError, match="broken.jpg"):
        decode_jpeg_batch([np.zeros(64, np.uint8)], "cpu", ["broken.jpg"])


@pytest.mark.parametrize("shape", [(7, 5, 3), (9, 4), (3, 6, 1)],
                         ids=["rgb", "grey", "one-channel"])
def test_png_writer_round_trips_through_pil(tmp_path, shape):
    arr = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "x.png"), torch.from_numpy(arr))
    with Image.open(tmp_path / "x.png") as img:
        back = np.array(img)
    np.testing.assert_array_equal(back, arr.reshape(back.shape))


def test_default_dataset_mode_parses(tmp_path):
    """Fails before the file-backed datasets were registered: the default
    --dataset_mode=fashion raised KeyError in both CLIs' option parsing."""
    opt = TrainOptions().parse([f"--checkpoints_dir={tmp_path}"], save=False)
    assert opt.dataset_mode == "fashion"
    assert opt.old_size == (256, 176) and opt.load_size == 256


def test_chip_smoke_trees_survive_the_jpeg_round_trip():
    """chip_smoke.py's pictures, through the port's CPU encoder and decoder
    (PIL) at quality 75, stay above the PSNR it asks of nvJPEG."""
    import chip_smoke
    from gfla_tpu_torch.data.image_io import encode_jpeg

    for H, W in ((256, 176), (128, 64)):
        for img in chip_smoke.disk_images(4, H, W, 70):
            data = np.frombuffer(encode_jpeg(torch.from_numpy(img)), np.uint8)
            (back,) = decode_jpeg_batch([data], "cpu")
            assert chip_smoke.psnr(back.numpy(), img) >= \
                chip_smoke.DISK_PSNR_MIN


@pytest.mark.parametrize("subsampling,code", [("420", 2), ("422", 1),
                                              ("444", 0)])
def test_chroma_upsampling_and_colour_follow_pil(subsampling, code):
    """The card's decode upsamples and converts nvJPEG's planes with
    libjpeg's arithmetic. A YCbCr JPEG at quality 100 whose planes are
    constant over each DCT block decodes to exactly those planes (a DC-only
    block's inverse DCT is exact), so upsample_chroma + ycc_to_rgb on them
    must give PIL's pixels bit for bit."""
    rng = np.random.RandomState(code)
    H, W = 48, 80
    sy, sx = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}[subsampling]
    y = np.kron(rng.randint(16, 240, (H // 8, W // 8)), np.ones((8, 8)))
    chroma = [np.kron(rng.randint(16, 240, (H // (8 * sy), W // (8 * sx))),
                      np.ones((8, 8))) for _ in range(2)]
    full = [np.kron(c, np.ones((sy, sx))) for c in chroma]
    ycc = np.stack([y, *full], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(ycc, mode="YCbCr").save(buf, format="JPEG", quality=100,
                                            subsampling=code)
    with Image.open(buf) as img:
        want = np.array(img.convert("RGB"))
    planes = [torch.from_numpy(c.astype(np.uint8))[None] for c in chroma]
    cb, cr = (upsample_chroma(p, subsampling)[0, :H, :W] for p in planes)
    got = ycc_to_rgb(torch.from_numpy(y.astype(np.uint8)), cb, cr)
    np.testing.assert_array_equal(got.numpy(), want)
