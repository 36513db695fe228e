"""The port's evaluation path against gfla_tpu's, on the CPU.

- Inception-v3 pool3 features within 1e-4 x max|feature| of gfla_tpu's,
  its fallback variables carried across by `convert.inception_state_dict`,
  at two sizes of 75-107 px (the widths are Inception's own); a synthetic
  npz written by scripts/convert_inception_weights.py loads into both and
  gives the same features;
- LPIPS, plain and masked, within 1e-4 relative, on carried and on
  converter-written weights; the fallback linear weights bitwise gfla_tpu's;
  the mask resize within 1e-6 of `jax.image.resize` at every tap size of
  DeepFashion's and Market's images;
- `calculate_frechet_distance` equal; the reconstruction metrics (ssim_256
  and mae among them) within 1e-12, from disk on JPEG and on grey, RGB and
  RGBA PNG, with the same metrics.npz;
- the PNG reader bitwise PIL's for every row filter, grey, RGB and RGBA,
  and `read_images` PIL's `convert("RGB")` and imageio's stored channels;
- the skeleton drawing, heatmaps and the body mask bitwise gfla_tpu's cv2
  versions, and the 5x5 closing cv2's;
- the metrics CLI, run with jax, flax, pandas, imageio and gfla_tpu
  unimportable, against gfla_tpu's CLI on the same files and weights: the
  same columns in the same order, the values at the tolerances above, the
  stamped file name, the statistics cache; the refusal without
  --allow_fallback_weights;
- `demo.main` adds `--phase val`, and the walkthrough's staging.
"""

import functools
import io
import os
import runpy
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(__file__))
import torch_metric_ref as tref  # noqa: E402

from gfla_tpu.data import pose_utils as jax_pose  # noqa: E402
from gfla_tpu.metrics import fid as jax_fid  # noqa: E402
from gfla_tpu.metrics import inception as jax_inception  # noqa: E402
from gfla_tpu.metrics import lpips as jax_lpips  # noqa: E402
from gfla_tpu.metrics import reconstruction as jax_rec  # noqa: E402
from gfla_tpu_torch import convert, demo  # noqa: E402
from gfla_tpu_torch.data import image_io, pose_utils  # noqa: E402
from gfla_tpu_torch.metrics import fid, inception, lpips  # noqa: E402
from gfla_tpu_torch.metrics import reconstruction  # noqa: E402
from gfla_tpu_torch.metrics.__main__ import write_csv  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
BLOCKED = ("jax", "flax", "pandas", "imageio", "gfla_tpu")


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the other test workers share these cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_nets():
    """gfla_tpu's fallback Inception and AlexNet variables, built once."""
    variables, has = jax_inception.load_inception_params()
    lvars, lins, lhas = jax_lpips.load_lpips_params()
    assert not has and not lhas, "the tests expect no assets/ weights"
    return variables, lvars, lins


@pytest.fixture(scope="module")
def jax_features():
    """gfla_tpu's jitted Inception features as its FID runs them."""
    return jax.jit(jax_inception.inception_features)


def _port_inception(variables):
    net = inception.InceptionV3Features()
    missing, unexpected = net.load_state_dict(
        convert.inception_state_dict(variables), strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    return net.eval()


def _port_lpips(lvars, lins):
    net = lpips.LPIPSNet()
    net.load_state_dict(convert.lpips_state_dict(lvars, lins))
    return net.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _run_script(monkeypatch, name, *args):
    monkeypatch.setattr(sys, "argv", [name, *args])
    runpy.run_path(str(SCRIPTS / name), run_name="__main__")


@pytest.mark.parametrize("hw", [(75, 75), (107, 91)])
def test_inception_features_match(jax_nets, jax_features, hw):
    variables = jax_nets[0]
    x = np.random.RandomState(hw[0]).rand(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax_features(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_inception(variables)(_nchw(x)).numpy()
    assert got.shape == (2, 2048)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_inception_npz_round_trip(tmp_path, monkeypatch, jax_features):
    """A torchvision-key state dict through the repo's converter: both
    packages read the npz and give the same features."""
    torch.save(tref.build_inception_sd(seed=0, dtype=torch.float32),
               tmp_path / "inception.pth")
    npz = tmp_path / "inception_v3.npz"
    _run_script(monkeypatch, "convert_inception_weights.py",
                f"--state_dict={tmp_path / 'inception.pth'}", f"--out={npz}")
    variables, has = jax_inception.load_inception_params(str(npz))
    net, port_has = inception.load_inception_params(str(npz))
    assert has and port_has
    x = np.random.RandomState(3).rand(2, 83, 79, 3).astype(np.float32)
    want = np.asarray(jax_features(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # and GFLA_ASSETS_DIR is read at call time
    monkeypatch.setenv("GFLA_ASSETS_DIR", str(tmp_path))
    assert inception.load_inception_params()[1]


def _lpips_inputs(seed, B=2, H=256, W=176):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, H, W, 3).astype(np.float32) * 2 - 1
    y = np.clip(x * 0.6 + rng.randn(B, H, W, 3).astype(np.float32) * 0.2,
                -1, 1)
    masks = []
    for b in range(B):
        kp = np.stack([rng.randint(20, H - 20, 18),
                       rng.randint(10, W - 10, 18)], 1).astype(float)
        kp[rng.rand(18) < 0.15] = -1
        masks.append(pose_utils.produce_ma_mask(kp, (H, W)))
    return x, y, np.stack(masks).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_lpips_matches(jax_nets, masked):
    _, lvars, lins = jax_nets
    x, y, m = _lpips_inputs(5)
    want = np.asarray(jax_lpips.lpips_distance(
        lvars, lins, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(m[..., None]) if masked else None))
    with torch.no_grad():
        got = lpips.lpips_distance(
            _port_lpips(lvars, lins), _nchw(x), _nchw(y),
            torch.from_numpy(m[:, None]) if masked else None).numpy()
    assert np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_lpips_npz_and_fallback(tmp_path, monkeypatch):
    """Converter-written LPIPS weights load into both and give the same
    distances; without the file the linear weights are gfla_tpu's bit for
    bit."""
    torch.save(tref.build_alexnet_sd(seed=1, dtype=torch.float32),
               tmp_path / "alex.pth")
    torch.save(tref.build_lpips_lin_sd(seed=2, dtype=torch.float32),
               tmp_path / "lin.pth")
    npz = tmp_path / "lpips_alex.npz"
    _run_script(monkeypatch, "convert_lpips_weights.py",
                f"--alexnet={tmp_path / 'alex.pth'}",
                f"--linear={tmp_path / 'lin.pth'}", f"--out={npz}")
    lvars, lins, has = jax_lpips.load_lpips_params.__wrapped__(str(npz))
    net, port_has = lpips.load_lpips_params(str(npz))
    assert has and port_has
    x, y, m = _lpips_inputs(6, B=2, H=128, W=64)
    for mask in (None, m):
        want = np.asarray(jax_lpips.lpips_distance(
            lvars, lins, jnp.asarray(x), jnp.asarray(y),
            None if mask is None else jnp.asarray(mask[..., None])))
        with torch.no_grad():
            got = lpips.lpips_distance(
                net, _nchw(x), _nchw(y),
                None if mask is None else torch.from_numpy(mask[:, None]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    fallback, port_has = lpips.load_lpips_params(str(tmp_path / "none.npz"))
    _, jax_lins, _ = jax_lpips.load_lpips_params.__wrapped__(
        str(tmp_path / "none.npz"))
    assert not port_has
    for got, want in zip(fallback.lins(), jax_lins):
        assert np.array_equal(got.numpy(), np.asarray(want))


# every LPIPS tap of DeepFashion's 256x176 and Market's 128x64 images
TAP_SIZES = [((256, 176), (63, 43)), ((256, 176), (31, 21)),
             ((256, 176), (15, 10)), ((128, 64), (31, 15)),
             ((128, 64), (15, 7)), ((128, 64), (7, 3))]


@pytest.mark.parametrize("src,dst", TAP_SIZES)
def test_mask_resize_matches_jax(src, dst):
    rng = np.random.RandomState(src[0] + dst[0])
    m = (rng.rand(2, *src) > 0.5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m[..., None]),
                                       (2, *dst, 1), "bilinear"))[..., 0]
    got = lpips.resize_mask(torch.from_numpy(m[:, None]), dst)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_frechet_distance_equal():
    rng = np.random.RandomState(0)
    a, b = rng.randn(40, 64), rng.randn(40, 64) * 1.3 + 0.2
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0),
            np.cov(b, rowvar=False))
    assert fid.calculate_frechet_distance(*args) == \
        jax_fid.calculate_frechet_distance(*args)


def _png(arr, kinds):
    """An 8-bit PNG of `arr` whose rows take the filter types `kinds` in
    turn (the encoder PIL and libpng share)."""
    n = 1 if arr.ndim == 2 else arr.shape[2]
    H, W = arr.shape[:2]
    rows = arr.reshape(H, -1).astype(np.int64)
    raw, prev = [], np.zeros(W * n, np.int64)
    for y in range(H):
        kind, cur = kinds[y % len(kinds)], rows[y]
        left = np.concatenate([np.zeros(n, np.int64), cur[:-n]])
        upleft = np.concatenate([np.zeros(n, np.int64), prev[:-n]])
        if kind == 4:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        else:
            pred = [0 * cur, left, prev, (left + prev) // 2][kind]
        raw.append(bytes([kind]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
        prev = cur
    colour = {1: 0, 3: 2, 4: 6}[n]
    chunk = image_io._chunk
    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(b"".join(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "rgb", "rgba"])
def test_png_reader_matches_pil(tmp_path, channels):
    rng = np.random.RandomState(channels)
    shape = (9, 13) if channels == 1 else (9, 13, channels)
    arr = rng.randint(0, 256, shape).astype(np.uint8)
    for kinds in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        data = _png(arr, kinds)
        want = np.array(Image.open(io.BytesIO(data)))
        assert np.array_equal(want, arr)
        got = image_io.read_png(data)
        assert got.dtype == np.uint8 and np.array_equal(got, want), kinds
    # PIL's own encoder (adaptive filters) and the port's writer
    smooth = np.cumsum(rng.randint(0, 3, shape), axis=1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(smooth).save(buf, format="PNG")
    assert np.array_equal(image_io.read_png(buf.getvalue()), smooth)
    if channels != 4:
        image_io.write_png(str(tmp_path / "w.png"), smooth)
        data = (tmp_path / "w.png").read_bytes()
        assert np.array_equal(image_io.read_png(data),
                              np.array(Image.open(tmp_path / "w.png")))


def test_png_reader_leaves_other_layouts_to_pil(tmp_path):
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, (6, 7, 3)).astype(np.uint8)
    pal = Image.fromarray(arr).convert("P")
    pal.save(tmp_path / "p.png")
    Image.fromarray(arr[..., 0].astype(np.uint16) * 250).save(
        tmp_path / "i16.png")
    for name in ("p.png", "i16.png"):
        assert image_io.read_png((tmp_path / name).read_bytes()) is None
    got = image_io.read_images([str(tmp_path / "p.png")], "cpu")[0]
    assert np.array_equal(got.numpy(),
                          np.array(Image.open(tmp_path / "p.png")
                                   .convert("RGB")))
    with pytest.raises(ValueError):
        image_io.read_png(b"\x89PNG\r\n\x1a\n" + b"\0" * 8)


def _mixed_tree(root):
    """The same picture stored as RGB and grey JPEG, and grey, RGB and
    RGBA PNG (PIL's encoder), and as BMP."""
    rng = np.random.RandomState(1)
    yy, xx = np.mgrid[:40, :30]
    rgb = np.stack([(yy * 6) % 256, (xx * 8) % 256,
                    rng.randint(0, 256, (40, 30))], -1).astype(np.uint8)
    rgba = np.concatenate([rgb, rng.randint(0, 256, (40, 30, 1))],
                          -1).astype(np.uint8)
    files = {"rgb.jpg": rgb, "grey.jpg": rgb[..., 0], "grey.png": rgb[..., 1],
             "rgb.png": rgb, "rgba.png": rgba, "rgb.bmp": rgb}
    for name, arr in files.items():
        Image.fromarray(arr).save(os.path.join(root, name))
    return sorted(os.path.join(root, f) for f in files)


def test_read_images_modes(tmp_path):
    paths = _mixed_tree(tmp_path)
    rgb = image_io.read_images(paths, "cpu")
    stored = image_io.read_images(paths, "cpu", "stored")
    for path, a, b in zip(paths, rgb, stored):
        with Image.open(path) as img:
            want = np.array(img.convert("RGB"))
        assert a.dtype == torch.uint8 and np.array_equal(a.numpy(), want)
        assert np.array_equal(b.numpy(), imageio.imread(path)), path


def test_reconstruction_matches(tmp_path, monkeypatch):
    rng = np.random.RandomState(2)
    for shape in ((32, 24, 3), (60, 60)):
        a = rng.rand(*shape)
        b = np.clip(a + rng.randn(*shape) * 0.1, 0, 1)
        for kw in ({}, {"gaussian_weights": True, "sigma": 1.5,
                        "use_sample_covariance": False}):
            assert reconstruction.compare_ssim(a, b, 1.0, **kw) == \
                pytest.approx(jax_rec.compare_ssim(a, b, 1.0, **kw),
                              abs=1e-12)
        assert reconstruction.compare_mae(a, b) == jax_rec.compare_mae(a, b)
    gen, gt = tmp_path / "gen", tmp_path / "gt"
    gen.mkdir()
    gt.mkdir()
    paths = _mixed_tree(gt)
    for i, path in enumerate(paths):
        arr = np.asarray(imageio.imread(path)).astype(np.int16)
        noisy = np.clip(arr + rng.randint(-30, 30, arr.shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(
            gen / os.path.basename(path))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setattr(reconstruction, "CHUNK", 4)  # a chunk boundary
    got = reconstruction.ReconstructionMetrics(device="cpu") \
        .calculate_from_disk(str(gen), str(gt), save_path=str(port_dir))
    want = jax_rec.ReconstructionMetrics().calculate_from_disk(
        str(gen), str(gt), save_path=str(jax_dir))
    assert list(got) == list(want)
    for key in want:
        assert got[key][0] == pytest.approx(want[key][0], abs=1e-12), key
    a, b = np.load(port_dir / "metrics.npz"), np.load(jax_dir / "metrics.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in b.files:
        np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-12)


def _skeleton(rng, H, W):
    kp = np.stack([rng.randint(-3, H + 3, 18), rng.randint(-3, W + 3, 18)], 1)
    for axis, size in ((0, H), (1, W)):  # joints on the image's edge
        edge = rng.rand(18) < 0.2
        kp[edge, axis] = rng.choice([0, size - 1], edge.sum())
    kp[rng.rand(18) < 0.2] = -1
    return kp


@pytest.mark.parametrize("size", [(128, 64), (256, 176)])
def test_pose_drawing_bitwise(size):
    rng = np.random.RandomState(size[0])
    for _ in range(25):
        kp = _skeleton(rng, *size)
        kpf = kp + rng.rand(18, 2) * (kp != -1)
        assert np.array_equal(pose_utils.produce_ma_mask(kpf, size),
                              jax_pose.produce_ma_mask(kpf, size))
        for got, want in zip(pose_utils.draw_pose_from_cords(kp, size),
                             jax_pose.draw_pose_from_cords(kp, size)):
            assert np.array_equal(got, want)
        heat = pose_utils.cords_to_map(kp, size)
        assert np.array_equal(heat, jax_pose.cords_to_map(kp, size))
        assert np.array_equal(pose_utils.map_to_cord(heat),
                              jax_pose.map_to_cord(heat))
        for got, want in zip(pose_utils.draw_pose_from_map(heat, radius=3),
                             jax_pose.draw_pose_from_map(heat, radius=3)):
            assert np.array_equal(got, want)


def test_morph_close_matches_cv2():
    rng = np.random.RandomState(4)
    kernel = np.ones((5, 5), np.uint8)
    for shape in ((17, 23), (5, 5), (3, 9)):
        for density in (0.1, 0.5, 0.9):
            m = (rng.rand(*shape) < density).astype(np.uint8)
            assert np.array_equal(
                pose_utils.morph_close(m),
                cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel))


def test_write_csv_matches_pandas(tmp_path):
    import pandas as pd

    dic = {"name": ["a,b"], "psnr": [float("inf")], "ssim": [0.1 + 0.2],
           "mae": [1e-07], "fid": [12.0], "lpips": [123456789.123],
           "FALLBACK_WEIGHTS": [True]}
    write_csv(str(tmp_path / "port.csv"), dic)
    pd.DataFrame(dic).to_csv(tmp_path / "pandas.csv", index=True)
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "pandas.csv").read_text()


def _write_pairs(root, n=6, size=(256, 176), seed=11):
    """gt/p{i}.jpg and gen/ref_2_p{i}_vis.jpg, the generated set a shifted
    distribution of the real one (contrast, brightness and noise), so that
    FID is far from zero and stable (tests/test_metrics_cli_golden.py)."""
    rng = np.random.RandomState(seed)
    gt, gen = root / "gt", root / "gen"
    gt.mkdir(parents=True)
    gen.mkdir()
    for i in range(n):
        a = (rng.rand(*size, 3) * 255).astype(np.uint8)
        b = np.clip(a * 0.55 + 40.0 + rng.randn(*size, 3) * 15, 0,
                    255).astype(np.uint8)
        Image.fromarray(a).save(gt / f"p{i}.jpg", quality=95)
        Image.fromarray(b).save(gen / f"ref_2_p{i}_vis.jpg", quality=95)
    return gt, gen


def _copy_tree(src, dst):
    dst.mkdir(parents=True)
    for f in src.iterdir():
        (dst / f.name).write_bytes(f.read_bytes())
    return dst


def _block_and_run(args, env):
    """The port's CLI in a fresh interpreter where BLOCKED cannot be
    imported; it prints what of them ended up in sys.modules."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {BLOCKED!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from gfla_tpu_torch.metrics.__main__ import main\n"
        "try:\n"
        "    main(sys.argv[1:])\n"
        "finally:\n"
        f"    print('LOADED', sorted(m for m in sys.modules if "
        f"m.split('.')[0] in {BLOCKED!r}))\n")
    return subprocess.Popen(
        [sys.executable, "-c", code, *args], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, **env})


def _gfla_variables(net, lnet):
    """The port's networks in gfla_tpu's variable layout."""
    inc = {"params": {}, "batch_stats": {}}
    for key, value in net.state_dict().items():
        try:
            npz_key, suffix = inception.flax_key(key)
        except KeyError:
            continue
        value = value.numpy()
        if suffix == "conv.weight":
            value = value.transpose(2, 3, 1, 0)
        collection, *path = npz_key.split("/")
        node = inc[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = jnp.asarray(value)
    lparams = {}
    for i in range(5):
        conv = getattr(lnet.features, f"conv{i}")
        lparams[f"conv{i}"] = {
            "kernel": jnp.asarray(conv.weight.numpy().transpose(2, 3, 1, 0)),
            "bias": jnp.asarray(conv.bias.numpy())}
    lins = [jnp.asarray(lin.numpy()) for lin in lnet.lins()]
    return inc, {"params": lparams}, lins


def test_cli_matches_gfla_tpu(tmp_path, monkeypatch):
    """The port's CLI on its fallback weights (stamped) against gfla_tpu's
    CLI given the same weights, each on its own copy of the files."""
    import pandas as pd

    from gfla_tpu.metrics import __main__ as jax_cli

    gt, gen = _write_pairs(tmp_path / "port")
    empty = tmp_path / "no_assets"
    empty.mkdir()
    out = tmp_path / "port_eval"
    flags = [f"--gt_path={gt}", f"--distorated_path={gen}",
             f"--fid_real_path={gt}", "--name=golden", f"--out_dir={out}"]
    env = {"GFLA_ASSETS_DIR": str(empty), "OMP_NUM_THREADS": "2",
           "OPENBLAS_NUM_THREADS": "2"}
    refused = _block_and_run(flags + ["--gpu_ids=-1"], env)
    ran = _block_and_run(flags + ["--gpu_ids=-1", "--allow_fallback_weights",
                                  "--calculate_mask"], env)

    # gfla_tpu's CLI in this process, on the port's fallback weights
    jgt = _copy_tree(gt, tmp_path / "jax" / "gt")
    jgen = _copy_tree(gen, tmp_path / "jax" / "gen")
    inc, lvars, lins = _gfla_variables(
        inception.load_inception_params(str(empty / "x"))[0],
        lpips.load_lpips_params(str(empty / "x"))[0])
    monkeypatch.setattr(jax_fid, "load_inception_params",
                        lambda: (inc, True))
    monkeypatch.setattr(jax_lpips, "load_lpips_params",
                        lambda: (lvars, lins, True))
    monkeypatch.setattr(jax_cli, "setup_runtime", lambda: None)
    # batches of 8, not 64: gfla_tpu pads a short batch with zero images,
    # which changes no feature in inference mode
    monkeypatch.setattr(jax_cli, "FID",
                        functools.partial(jax_fid.FID, batch_size=8))
    jout = tmp_path / "jax_eval"
    monkeypatch.setattr(sys, "argv", [
        "metrics", f"--gt_path={jgt}", f"--distorated_path={jgen}",
        f"--fid_real_path={jgt}", "--name=golden", f"--out_dir={jout}"])
    jax_cli.main()

    text, _ = refused.communicate(timeout=300)
    assert refused.returncode != 0
    assert "--allow_fallback_weights" in text and "LOADED []" in text
    text, _ = ran.communicate(timeout=300)
    assert ran.returncode == 0, text[-3000:]
    assert "LOADED []" in text, text[-2000:]
    assert "mask-LPIPS requires pose CSVs" in text
    assert sorted(os.listdir(out)) == ["golden_FALLBACK-WEIGHTS.csv"]
    port = pd.read_csv(out / "golden_FALLBACK-WEIGHTS.csv")
    want = pd.read_csv(jout / "golden.csv")
    assert list(port.columns) == list(want.columns) + ["FALLBACK_WEIGHTS"]
    assert bool(port["FALLBACK_WEIGHTS"][0]) is True
    row, ref = port.iloc[0], want.iloc[0]
    assert row["name"] == ref["name"] == "golden"
    for col in want.columns[2:-2]:  # the reconstruction columns
        assert row[col] == pytest.approx(ref[col], abs=1e-12), col
    assert row["fid"] > 1.0
    assert row["fid"] == pytest.approx(ref["fid"], rel=1e-3)
    assert row["lpips"] == pytest.approx(ref["lpips"], rel=1e-4)

    # the caches: statistics.npz beside each real set, metrics.npz in each
    # generated set, and the port reading its cache back
    ours, theirs = np.load(gt / "statistics.npz"), np.load(
        jgt / "statistics.npz")
    scale = np.abs(theirs["mu"]).max()
    np.testing.assert_allclose(ours["mu"], theirs["mu"], rtol=0,
                               atol=1e-4 * scale)
    assert (gen / "metrics.npz").exists() and (jgen / "metrics.npz").exists()
    monkeypatch.setenv("GFLA_ASSETS_DIR", str(empty))
    mu, sigma = fid.FID(allow_fallback=True, device="cpu") \
        .compute_statistics_of_path(str(gt))
    assert np.array_equal(mu, ours["mu"])
    assert np.array_equal(sigma, ours["sigma"])


def test_lpips_from_disk_masked(tmp_path, monkeypatch, jax_nets):
    """LPIPS.calculate_from_disk with Market masks, both classes on
    gfla_tpu's fallback weights."""
    _, lvars, lins = jax_nets
    x, y, m = _lpips_inputs(8, B=3, H=128, W=64)
    gen, gt = tmp_path / "gen", tmp_path / "gt"
    gen.mkdir()
    gt.mkdir()
    for i in range(3):
        for folder, img in ((gen, x[i]), (gt, y[i])):
            Image.fromarray(((img + 1) * 127.5).astype(np.uint8)).save(
                folder / f"{i}.png")
    masks = list(m)
    want = jax_lpips.LPIPS(batch_size=2, allow_fallback=True) \
        .calculate_from_disk(str(gen), str(gt), masks=masks)
    monkeypatch.setattr(lpips, "load_lpips_params",
                        lambda: (_port_lpips(lvars, lins), False))
    got = lpips.LPIPS(batch_size=2, allow_fallback=True, device="cpu") \
        .calculate_from_disk(str(gen), str(gt), masks=masks)
    assert got == pytest.approx(want, rel=1e-4)


class _Switches(torch.nn.Module):
    """Records both TF32 switches when called."""

    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def forward(self, x, *rest):
        self.seen.append((torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32))
        return x.flatten(1).mean(1)


def test_metric_classes_default_to_the_card_with_tf32_off(monkeypatch):
    """Given no device, FID, LPIPS and ReconstructionMetrics ask for the
    first card (and raise where there is none); the networks run with TF32
    off whatever the caller's switches, which are restored after."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (fid.FID, lpips.LPIPS, reconstruction.ReconstructionMetrics):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()
    seen = []
    monkeypatch.setattr(fid, "load_inception_params",
                        lambda: (_Switches(seen), True))
    monkeypatch.setattr(lpips, "load_lpips_params",
                        lambda: (_Switches(seen), True))
    monkeypatch.setattr(lpips, "lpips_distance",
                        lambda net, a, b, masks: net(a))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    img = [torch.zeros(8, 6, 3, dtype=torch.uint8)]
    fid.FID(device="cpu").features(img)
    lpips.LPIPS(device="cpu").distance(img, img)
    assert seen == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def test_demo_main_adds_val_phase(monkeypatch):
    from gfla_tpu_torch import test as test_entry

    seen = []
    monkeypatch.setattr(test_entry, "main", lambda args: seen.append(args))
    demo.main(["--model=pose", "--gpu_ids=-1"])
    demo.main(["--phase=test"])
    assert seen == [["--model=pose", "--gpu_ids=-1", "--phase", "val"],
                    ["--phase=test"]]


def test_demo_staging(tmp_path):
    panels = tmp_path / "demo"
    panels.mkdir()
    for src, tgt in (("a", "b"), ("c", "d")):
        for kind in ("vis", "gt", "ref", "all"):
            (panels / f"{src}_2_{tgt}_{kind}.jpg").write_bytes(
                f"{src}{tgt}{kind}".encode())
    n = demo.stage_for_metrics(str(panels), str(tmp_path / "gt"),
                               str(tmp_path / "gen"))
    assert n == 2
    assert sorted(os.listdir(tmp_path / "gt")) == ["b.jpg", "d.jpg"]
    assert (tmp_path / "gt" / "d.jpg").read_bytes() == b"cdgt"
    assert sorted(os.listdir(tmp_path / "gen")) == ["a_2_b_vis.jpg",
                                                    "c_2_d_vis.jpg"]
