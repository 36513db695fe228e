"""The port's pose modules, converter, data and options against gfla_tpu.

Weights: gfla_tpu's flax params are initialised, every leaf is replaced by
seeded numpy noise (so norms and biases are exercised), and the tree goes to
the port through gfla_tpu_torch.convert. Inputs are seeded numpy arrays,
NHWC for gfla_tpu and the same arrays as NCHW for the port. Everything runs
in f32 on the CPU; tolerance 1e-4 abs, for single blocks and for the whole
generator, whose outputs are O(1) under these weights: it covers the f32
rounding of sums taken in other orders across about 20 conv and
instance-norm layers (2e-5 observed).
"""

import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref as tr
from gfla_tpu.convert import convert_pose_generator
from gfla_tpu.data.paired_dataset import SyntheticPoseDataset as JaxSynthetic
from gfla_tpu.data.pose_utils import encode_heatmaps as jax_encode_heatmaps
from gfla_tpu.models.generators import PoseGenerator as JaxPoseGenerator
from gfla_tpu.nn import attention as jattn
from gfla_tpu.nn import blocks as jblocks
from gfla_tpu_torch import convert
from gfla_tpu_torch.data import SyntheticPoseDataset, encode_heatmaps
from gfla_tpu_torch.models import define_g
from gfla_tpu_torch.nn import attention, blocks

SMALL = dict(image_nc=3, structure_nc=18, output_nc=3, ngf=16, img_f=64,
             layers=3, num_blocks=2, norm_type="instance",
             activation="LeakyReLU", attn_layer=(2, 3),
             extractor_kz={"2": 5, "3": 3})


def _noise(tree, seed):
    """Replace every leaf with seeded noise: weights N(0, 1/fan_in), biases
    N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        noise = rng.randn(*leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:  # (..., fan_in dims, out): kernel, w1, w2
            noise /= np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            noise *= 0.1
            if "scale" in jax.tree_util.keystr(path):
                noise += 1.0
        leaves.append(noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _close(ours_nchw, theirs_nhwc, atol):
    np.testing.assert_allclose(
        ours_nchw.detach().numpy(),
        np.asarray(theirs_nhwc).transpose(0, 3, 1, 2), rtol=0, atol=atol)


def _load(module, sd, prefix=""):
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module.eval()


BLOCKS = {
    # name: (flax module, port module, input channels, converter)
    "encoder": (jblocks.EncoderBlock(12, "instance", "LeakyReLU"),
                blocks.EncoderBlock(6, 12, "instance", "LeakyReLU"), 6,
                convert._pre_act),
    "resblock": (jblocks.ResBlock(None, None, "instance", "LeakyReLU"),
                 blocks.ResBlock(6, None, None, "instance", "LeakyReLU"), 6,
                 convert._resblock),
    "resblock-learnable": (
        jblocks.ResBlock(10, 8, "instance", "LeakyReLU"),
        blocks.ResBlock(6, 10, 8, "instance", "LeakyReLU"), 6,
        convert._resblock),
    "decoder": (jblocks.ResBlockDecoder(5, 7, "instance", "LeakyReLU"),
                blocks.ResBlockDecoder(6, 5, 7, "instance", "LeakyReLU"), 6,
                convert._resblock_decoder),
    "jump": (jblocks.Jump(7, 3, "none", "LeakyReLU"),
             blocks.Jump(6, 7, 3, "none", "LeakyReLU"), 6, convert._jump),
    "output": (jblocks.Output(3, 3, "none", "LeakyReLU"),
               blocks.Output(6, 3, 3, "none", "LeakyReLU"), 6, convert._jump),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name):
    jmod, port, c, conv = BLOCKS[name]
    x = np.random.RandomState(1).randn(2, 12, 10, c).astype(np.float32)
    params = _noise(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))[
        "params"], seed=2)
    want = jmod.apply({"params": params}, jnp.asarray(x), train=False)
    sd = {}
    conv(params, "m", sd)
    _load(port, sd, "m.")
    _close(port(_nchw(x).contiguous(memory_format=torch.channels_last)),
           want, atol=1e-4)


@pytest.mark.parametrize("k", [3, 5])
def test_extractor_attn_matches_flax(k):
    rng = np.random.RandomState(k)
    src, tgt = (rng.randn(2, 12, 12, 8).astype(np.float32) for _ in "st")
    flow = (rng.randn(2, 12, 12, 2) * 2).astype(np.float32)
    jmod = jattn.ExtractorAttn(k, activation="LeakyReLU")
    args = tuple(jnp.asarray(a) for a in (src, tgt, flow))
    params = _noise(jmod.init(jax.random.PRNGKey(0), *args)["params"], 3)
    attn_j, out_j = jmod.apply({"params": params}, *args, return_attn=True)
    sd = {}
    convert._attn(params, "a", sd)
    port = _load(attention.ExtractorAttn(8, k, "LeakyReLU"), sd, "a.")
    inputs = [_nchw(a) for a in (src, tgt, flow)]
    _close(port(*inputs), out_j, atol=1e-4)
    attn, out = port(*inputs, return_attn=True)
    _close(attn, attn_j, atol=1e-5)
    _close(out, out_j, atol=1e-4)


@pytest.fixture(scope="module")
def generator_pair():
    """gfla_tpu's PoseGenerator with noise params, and the port's with the
    same weights through convert.py, at 64x64, ngf 16, img_f 64."""
    rng = np.random.RandomState(21)
    p1 = np.tanh(rng.randn(2, 64, 64, 3)).astype(np.float32)
    bp1, bp2 = (rng.rand(2, 64, 64, 18).astype(np.float32) for _ in "ab")
    jmod = JaxPoseGenerator(**SMALL)
    args = tuple(jnp.asarray(a) for a in (p1, bp1, bp2))
    params = _noise(jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)[
        "params"], seed=22)
    want = jax.jit(lambda p, *a: jmod.apply(
        {"params": p}, *a, train=False, update_stats=False,
        return_hooks=True))(params, *args)
    port = define_g("pose", **SMALL)
    port.load_state_dict(convert.pose_generator_state_dict(params),
                         strict=True)
    return port.eval(), [_nchw(a) for a in (p1, bp1, bp2)], want


def test_pose_generator_matches_flax(generator_pair):
    port, inputs, (img_j, flows_j, masks_j, _) = generator_pair
    with torch.inference_mode():
        img, flows, masks = port(*inputs)
    assert img.shape == (2, 3, 64, 64)
    assert [tuple(f.shape) for f in flows] == [(2, 2, 8, 8), (2, 2, 16, 16)]
    for f, f_j in zip(flows, flows_j):
        _close(f, f_j, atol=1e-4)
    for m, m_j in zip(masks, masks_j):
        _close(m, m_j, atol=1e-4)
    _close(img, img_j, atol=1e-4)


def test_pose_generator_hooks_match_flax(generator_pair):
    port, inputs, (_, _, _, hooks_j) = generator_pair
    with torch.inference_mode():
        _, _, _, hooks = port(*inputs, return_hooks=True)
    assert sorted(hooks) == sorted(hooks_j)
    for key in hooks:
        assert len(hooks[key]) == len(hooks_j[key]) == 2
        for ours, theirs in zip(hooks[key], hooks_j[key]):
            _close(ours, theirs, atol=1e-4)


def test_attention_inputs_stay_channels_last(generator_pair):
    """The NHWC views handed to the warp are contiguous permutes: no copy."""
    port, inputs, _ = generator_pair
    seen = []

    def record(mod, args):
        seen.append([a.permute(0, 2, 3, 1).is_contiguous() for a in args])

    handles = [port.target.attn0.register_forward_pre_hook(record),
               port.target.attn1.register_forward_pre_hook(record)]
    with torch.inference_mode():
        port(*inputs)
    for h in handles:
        h.remove()
    assert seen == [[True, True, True], [True, True, True]]


# ---------------------------------------------------------------------------
# checkpoints of the original GFLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [
    pytest.param(dict(ngf=16, img_f=64), id="small"),
    pytest.param(dict(ngf=64, img_f=512), id="full-width"),
])
def test_reference_state_dict_loads_strict(width):
    """A state dict with the original's exact keys, the Jump/Output
    `model.2` aliases included, loads into the port with strict=True."""
    sd, aliases = tr.build_pose_generator_sd(seed=5, dtype=torch.float32,
                                             **width)
    assert aliases
    port = define_g("pose", **dict(SMALL, **width))
    port.load_state_dict(sd, strict=True)
    assert set(port.state_dict()) == set(sd)


def test_converter_round_trip_is_exact():
    sd, _ = tr.build_pose_generator_sd(seed=6, dtype=torch.float32, ngf=16,
                                       img_f=64)
    params = convert_pose_generator(sd, layers=3, attn_layer=(2, 3))
    back = convert.pose_generator_state_dict(params, layers=3,
                                             attn_layer=(2, 3))
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key


def test_pose_task_loads_original_checkpoint(tmp_path):
    from gfla_tpu_torch.tasks.pose import PoseTask

    sd, _ = tr.build_pose_generator_sd(seed=7, dtype=torch.float32, ngf=16,
                                       img_f=64)
    (tmp_path / "exp").mkdir()
    torch.save({f"module.{k}": v for k, v in sd.items()},
               tmp_path / "exp" / "latest_net_G.pth")
    opt = SimpleNamespace(image_nc=3, structure_nc=18, ngf=16, img_f=64,
                          layers=3, attn_layer=[2, 3],
                          kernel_size={"2": 5, "3": 3}, use_spect_g=False,
                          compute_dtype="float32", gpu_ids="-1", seed=0,
                          checkpoints_dir=str(tmp_path), name="exp",
                          which_iter="latest")
    task = PoseTask(opt)
    assert task.load_checkpoint()
    loaded = task.net_g.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())


# ---------------------------------------------------------------------------
# data and options
# ---------------------------------------------------------------------------

def test_synthetic_dataset_matches_gfla_tpu():
    opt = SimpleNamespace(load_size=32, max_dataset_size=5, structure_nc=18)
    ours, theirs = SyntheticPoseDataset(opt), JaxSynthetic(opt)
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], np.ndarray):
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert a[key] == b[key]


def test_encode_heatmaps_matches_gfla_tpu():
    rng = np.random.RandomState(8)
    kp = (rng.rand(3, 18, 2) * 40).astype(np.float32)
    kp[:, -3:] = -1  # missing joints give zero maps
    kp[0, 2, 0] = -1  # one coordinate missing is missing too
    want = jax_encode_heatmaps(jnp.asarray(kp), 40, 30)
    got = encode_heatmaps(torch.from_numpy(kp), 40, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert not got[:, :, :, -3:].any() and not got[0, :, :, 2].any()


@pytest.mark.parametrize("argv", [
    ["--model=pose", "--dataset_mode=synthetic"],
    ["--model=pose", "--dataset_mode=synthetic", "--load_size=64",
     "--attn_layer=2,3", "--kernel_size=2=5,3=3", "--gpu_ids=-1",
     "--use_spect_d", "--angle=5"],
])
def test_options_match_gfla_tpu(argv, monkeypatch):
    from gfla_tpu.options import TestOptions as JaxTestOptions
    from gfla_tpu_torch.options import TestOptions

    monkeypatch.setattr(sys, "argv", ["test.py", *argv])
    want = vars(JaxTestOptions().gather_options())
    got = vars(TestOptions().gather_options(argv))
    assert got == want
