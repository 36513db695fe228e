"""The animation heads' modules, serving and CLIs (dance, face) against
gfla_tpu, on the CPU.

Held:
- Conv3d (plain and spectral), ResBlock3DEncoder, TemporalDiscriminator and
  PatchDiscriminator (spectral, plain, with CoordConv channels): forward
  within 1e-4 abs, input and parameter gradients within 1e-4 x the
  tensor's largest of gfla_tpu's, stored u within 1e-5; the spectral
  PatchDiscriminator in bf16 through cast_call by the bf16 rule;
  `add_coords` within 2.5e-7 (the two linspaces' rounding);
- FaceGenerator and DanceGenerator in eval mode against gfla_tpu's
  `net_g.apply(..., train=False)` on its scan route, at 64x64, batch 2, 3
  frames, ngf 8, img_f 32, layers 3 (both attention levels), noise weights:
  every frame, flow, mask and previous frame within 1e-4 abs;
- the correctness loss's `frames`, `mask` and bilinear branches, alone and
  together: the loss within 1e-4 relative; its gradient to each flow in
  float64 on both sides (jax.enable_x64), within 1e-9 x its largest: in f32
  an entry of the combined case whose terms cancel sits 5e-7 (gfla_tpu) and
  1e-6 (the port) from the float64 gradient, 1.1e-4 of the largest;
- `test_step` streaming two chunks, the second from the first's carry:
  every frame within 1e-4 abs;
- FaceGenerator with `--use_spect_g` in training mode: its frames, flows
  and masks, and each spectral conv's stored u after a chunk, u carried
  through gfla_tpu's scan (once a frame for the per-frame nets, once a chunk
  for the reference encoder) within 1e-5;
- the synthetic clips, window sampling and test cursor: exactly gfla_tpu's;
- both CLIs' options for dance and face: the namespace gfla_tpu parses;
- the three `--frames_D_V` refusals;
- the training CLI on `synthetic_video` writes `net_G`, `net_D` and
  `net_D_V`, evaluates its held-out clips and writes the visuals; the
  serving CLI loads that G and writes gfla_tpu's file names; neither
  imports JAX or an image library;
- under `--compute_dtype=bfloat16` (the section's notes below): one dance
  chunk step against gfla_tpu's bf16 step and one face chunk step against
  the port's f32 step, a planted fault failing the hold, `--remat`
  bitwise the step without it, the streaming test over two chunks against
  gfla_tpu's test step (f32 whatever the flag says), and both CLIs (dance
  with `--use_mask` from a tree with iPER masks).
"""

import argparse
import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gfla_tpu.data import create_dataloader as jax_create_dataloader
from gfla_tpu.convert import convert_dance_generator as jax_convert_dance
from gfla_tpu.convert import convert_face_generator as jax_convert_face
from gfla_tpu.data.animation_data import \
    SyntheticVideoDataset as JaxSyntheticVideo
from gfla_tpu.losses.perceptual import \
    PerceptualCorrectness as JaxCorrectness
from gfla_tpu.models.discriminators import \
    PatchDiscriminator as JaxPatchD
from gfla_tpu.models.discriminators import \
    TemporalDiscriminator as JaxTemporalD
from gfla_tpu.models.generators import DanceGenerator as JaxDance
from gfla_tpu.models.generators import FaceGenerator as JaxFace
from gfla_tpu.nn.blocks import ResBlock3DEncoder as JaxResBlock3D
from gfla_tpu.nn.norms import Conv3d as JaxConv3d
from gfla_tpu.nn.norms import add_coords as jax_add_coords
from gfla_tpu.tasks.animation import AnimationTaskBase as JaxAnimationTask
from gfla_tpu.train.precision import cast_tree, to_f32
from test_torch_port_animation_train import (
    D_LAYERS,
    FRAMES,
    _clip,
    _dev,
    _dv_state_dict,
    _f32,
    _first_chunk,
    _g_state_dict,
    _indices,
    _pair,
    _port,
)
from test_torch_port_animation_train import _opt as _train_opt
from test_torch_port_bf16 import (
    OUT_TOL,
    SLACK,
    _bf16_values,
    _cos,
    _errors,
    _norm_ratio,
    _rule,
    _unheld,
)
from test_torch_port_bf16 import _noise as _bf16_noise
from gfla_tpu_torch import convert
from gfla_tpu_torch.data.animation_data import SyntheticVideoDataset
from gfla_tpu_torch.losses import PerceptualCorrectness
from gfla_tpu_torch.models import define_d, define_g
from gfla_tpu_torch.nn.blocks import ResBlock3DEncoder
from gfla_tpu_torch.nn.norms import add_coords, conv3d
from gfla_tpu_torch.tasks.animation import DanceTask, FaceTask
from gfla_tpu_torch.train.precision import cast_call

REPO = Path(__file__).resolve().parents[1]
H = 64
B = 2
T = 3
NC = {"face": 16, "dance": 20}
G_CFG = dict(image_nc=3, output_nc=3, ngf=8, img_f=32, layers=3,
             num_blocks=2, norm_type="instance", activation="LeakyReLU",
             attn_layer=(2, 3), extractor_kz={"2": 5, "3": 3})
GRAD_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _noise(tree, seed):
    """Every leaf replaced by seeded noise: kernels N(0, 1/fan_in), vectors
    N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten(tree)
    leaves = []
    for leaf in flat:
        noise = np.asarray(rng.randn(*leaf.shape), np.float32)
        if leaf.ndim >= 2:
            noise /= np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            noise *= 0.1
        leaves.append(noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _close(got, want, atol=1e-4, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


def _grad_close(got, want, what=""):
    scale = np.abs(np.asarray(want)).max()
    _close(got, want, GRAD_REL * scale, what)


# ---------------------------------------------------------------------------
# Conv3d, ResBlock3DEncoder, TemporalDiscriminator, add_coords
# ---------------------------------------------------------------------------

def _module_case(name):
    """(flax module, port module, flax input (NDHWC / clip), port input,
    params -> port state dict, stats -> {port key: u})."""
    rng = np.random.RandomState(21)
    if name.startswith("conv3d"):
        spect = name.endswith("spect")
        x = rng.randn(B, 6, 12, 10, 5).astype(np.float32)
        jmod = JaxConv3d(7, (3, 4, 4), (1, 2, 2), (0, 1, 1), use_spect=spect)
        port = conv3d(5, 7, (3, 4, 4), (1, 2, 2), (0, 1, 1), spect)

        def to_sd(params, stats):
            sd = {}
            convert._conv(params, "c", sd, stats or None)
            return {k.removeprefix("c."): v for k, v in sd.items()}

        return jmod, port, x, x.transpose(0, 4, 1, 2, 3), to_sd
    if name == "resblock3d":
        x = rng.randn(B, 6, 12, 10, 5).astype(np.float32)
        jmod = JaxResBlock3D(8, 6)
        port = ResBlock3DEncoder(5, 8, 6)

        def to_sd(params, stats):
            sd = {}
            for ours, theirs in (("conv1", "model.1"), ("conv2", "model.3"),
                                 ("shortcut", "shortcut.1")):
                convert._conv(params[ours], theirs, sd, stats[ours])
            return sd

        return jmod, port, x, x.transpose(0, 4, 1, 2, 3), to_sd
    if name.startswith("patch_d"):
        spect, coord = name != "patch_d_plain", name == "patch_d_coord"
        x = rng.randn(B, 40, 36, 3).astype(np.float32)
        jmod = JaxPatchD(ndf=8, img_f=32, layers=3, use_spect=spect,
                         use_coord=coord)
        port = define_d("patch", ndf=8, img_f=32, layers=3, use_spect=spect,
                        use_coord=coord)

        def to_sd(params, stats):
            return convert.patch_discriminator_state_dict(params, stats, 3,
                                                          coord)

        return jmod, port, x, x.transpose(0, 3, 1, 2), to_sd
    x = rng.randn(B, 6, 16, 16, 3).astype(np.float32)
    jmod = JaxTemporalD(input_length=6, ndf=4, img_f=16, layers=3)
    port = define_d("temporal", input_length=6, ndf=4, img_f=16, layers=3)

    def to_sd(params, stats):
        return convert.temporal_discriminator_state_dict(params, stats, 3)

    return jmod, port, x, x.transpose(0, 1, 4, 2, 3), to_sd


@pytest.mark.parametrize("name", ["conv3d", "conv3d_spect", "resblock3d",
                                  "temporal_d"])
def test_3d_modules_match_flax(name):
    """Forward, d input, d parameters, and the u a training call stores."""
    _hold_module(name)


@pytest.mark.parametrize("name", ["patch_d", "patch_d_plain",
                                  "patch_d_coord"])
def test_patch_discriminator_matches_flax(name):
    """PatchDiscriminator (spectral, plain, with CoordConv channels) in f32:
    forward, d input, d parameters, the u a training call stores."""
    _hold_module(name)


def test_patch_discriminator_bf16_through_cast_call():
    """The spectral PatchDiscriminator in bf16 through cast_call from f32
    masters, against flax's apply on cast_tree'd variables: the logits and
    the stored u by the bf16 rule (tests/test_torch_port_bf16.py: against
    the f32 result within 2x gfla_tpu's bf16 error + 1e-3 x max, and
    against gfla_tpu's bf16 within 1e-2 x max for u, read 5.5e-3, and 3e-2
    for the logits, five bf16 convs deep, read 1.4e-2); the input and
    parameter gradients by cosine and norm ratio against gfla_tpu's (read:
    cosine 0.99959 and up; a max error cannot hold them: one entry of a
    cancelling sum sits 16% of max off f32 in either framework); the
    masters, their gradients and u stay f32."""
    jmod, port, xj, xp, to_sd = _module_case("patch_d")
    xj = _bf16_values(xj)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xj))
    params = jax.tree_util.tree_map(_bf16_values,
                                    _noise(variables["params"], 22))
    stats = jax.device_get(variables["batch_stats"])
    w = np.random.RandomState(23).randn(
        *jax.eval_shape(lambda x: jmod.apply(
            {"params": params, "batch_stats": stats}, x,
            mutable=["batch_stats"])[0], jnp.asarray(xj)).shape
    ).astype(np.float32)

    def loss(params, x, dt):
        out, new = jmod.apply(
            {"params": cast_tree(params, dt),
             "batch_stats": cast_tree(stats, dt)}, x.astype(dt),
            mutable=["batch_stats"])
        out = out.astype(jnp.float32)
        return jnp.sum(out * w), (out, to_f32(new["batch_stats"]))

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                   static_argnums=2)
    got = {}
    for dt in (jnp.float32, jnp.bfloat16):
        (_, (out, new)), (gp, gx) = step(params, jnp.asarray(xj), dt)
        got[dt] = (np.asarray(out), to_sd(jax.device_get(gp),
                                          jax.device_get(new)),
                   np.asarray(gx).transpose(0, 3, 1, 2))
    port.load_state_dict(to_sd(params, stats), strict=True)
    x = torch.from_numpy(np.ascontiguousarray(xp)).requires_grad_(True)
    out = cast_call(port.train(), torch.bfloat16, x, update_stats=True)
    assert out.dtype == torch.float32
    (out.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum().backward()
    ref, f32 = got[jnp.bfloat16], got[jnp.float32]
    _rule(out.permute(0, 2, 3, 1), ref[0], f32[0], 3e-2, "logits")
    grads = [("d input", x.grad, ref[2])] + [
        (f"d {key}", p.grad, ref[1][key])
        for key, p in port.named_parameters()]
    for what, g, want in grads:
        assert g.dtype == torch.float32, what
        cos, ratio = _cos(g, want), _norm_ratio(g, want)
        assert cos >= 0.999 and 0.99 <= ratio <= 1.01, (what, cos, ratio)
    for key, u in port.state_dict().items():
        if key.endswith("weight_u"):
            assert u.dtype == torch.float32, key
            _rule(u, ref[1][key], f32[1][key], 1e-2, key)


def _hold_module(name):
    jmod, port, xj, xp, to_sd = _module_case(name)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xj))
    params = _noise(variables["params"], 22)
    stats = jax.device_get(variables.get("batch_stats", {}))
    port.load_state_dict(to_sd(params, stats), strict=True)
    rng = np.random.RandomState(23)

    def loss(params, x):
        out, new = jmod.apply({"params": params, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
        w = jnp.asarray(rng_w, out.dtype)
        return jnp.sum(out * w), (out, new)

    out_shape = jax.eval_shape(
        lambda x: jmod.apply({"params": params, "batch_stats": stats}, x,
                             mutable=["batch_stats"])[0], jnp.asarray(xj))
    rng_w = rng.randn(*out_shape.shape).astype(np.float32)
    (_, (out_j, new)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xj))

    x = torch.from_numpy(np.ascontiguousarray(xp)).requires_grad_(True)
    port.train()
    out = port(x)
    perm = (0, 2, 3, 4, 1) if out.dim() == 5 else (0, 2, 3, 1)
    out_nhwc = out.permute(*perm)
    (out_nhwc * torch.from_numpy(rng_w)).sum().backward()
    _close(out_nhwc.detach().numpy(), out_j, 1e-4, f"{name} forward")
    inv = {"temporal_d": (0, 1, 4, 2, 3)}.get(
        name, (0, 3, 1, 2) if name.startswith("patch_d") else (0, 4, 1, 2, 3))
    _grad_close(x.grad.numpy(), np.asarray(gx).transpose(*inv), "d input")
    want = to_sd(jax.device_get(gp), jax.device_get(new["batch_stats"])
                 if stats else None)
    for key, p in port.named_parameters():
        _grad_close(p.grad.numpy(), want[key].numpy(), f"d {key}")
    us = [k for k in port.state_dict() if k.endswith("weight_u")]
    assert bool(us) == (name not in ("conv3d", "patch_d_plain"))
    for key in us:
        _close(port.state_dict()[key].numpy(), want[key].numpy(), 1e-5, key)


def test_temporal_fold_is_gfla_tpus():
    """After the 3-D blocks, (B, C, T', H, W) folds to channels t * C + c:
    a D whose encoder0 reads only channel t * C + c sees frame t's
    feature c."""
    d = define_d("temporal", input_length=6, ndf=4, img_f=16,
                 layers=3).eval()
    x = torch.randn(1, 6, 3, 16, 16)
    feats = d.block1(d.block0(x.transpose(1, 2)))        # (1, 8, 2, 4, 4)
    C, L = feats.shape[1], feats.shape[2]
    captured = {}
    d.encoder0.register_forward_pre_hook(
        lambda m, args: captured.setdefault("x", args[0]))
    d(x)
    for t in range(L):
        for c in range(C):
            assert torch.equal(captured["x"][:, t * C + c], feats[:, c, t])


@pytest.mark.parametrize("with_r", [False, True])
def test_add_coords_matches_flax(with_r):
    x = np.random.RandomState(3).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jax_add_coords(jnp.asarray(x), with_r))
    got = add_coords(torch.from_numpy(x).permute(0, 3, 1, 2), with_r)
    assert np.array_equal(got[:, :3].permute(0, 2, 3, 1).numpy(), x)
    # torch.linspace and jnp.linspace round their inner points apart by up
    # to 2 f32 ulps of 1
    _close(got.permute(0, 2, 3, 1).numpy(), want, 2.5e-7)


# ---------------------------------------------------------------------------
# the generators in eval mode, and test_step's streaming
# ---------------------------------------------------------------------------

def _inputs(kind, seed, frames=T):
    rng = np.random.RandomState(seed)
    nc = NC[kind]
    return (rng.rand(B, frames, H, H, nc).astype(np.float32),
            np.tanh(rng.randn(B, H, H, 3)).astype(np.float32),
            rng.rand(B, H, H, nc).astype(np.float32))


def _port_inputs(bp, p_ref, bp_ref):
    return (torch.from_numpy(bp).permute(0, 1, 4, 2, 3),
            torch.from_numpy(p_ref).permute(0, 3, 1, 2),
            torch.from_numpy(bp_ref).permute(0, 3, 1, 2))


@pytest.fixture(scope="module", params=["face", "dance"])
def generator_pair(request):
    return _generator_pair(request.param)


@functools.lru_cache(maxsize=None)
def _generator_pair(kind):
    """gfla_tpu's generator with noise parameters and its eval-mode apply,
    compiled once; the port's with the same."""
    jmod = (JaxFace if kind == "face" else JaxDance)(
        structure_nc=NC[kind], **G_CFG)
    port = define_g(kind, structure_nc=NC[kind], **G_CFG)
    to_flax = jax_convert_face if kind == "face" else jax_convert_dance
    params = _noise(to_flax(port.state_dict(), layers=3,
                            attn_layer=(2, 3)), 12)
    fn = getattr(convert, f"{kind}_generator_state_dict")
    port.load_state_dict(fn(params, layers=3, attn_layer=(2, 3)),
                         strict=True)
    # the previous pair always given (the reference pair for a first
    # chunk, as gfla_tpu's own default), so one compilation serves both
    # tests
    apply = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, train=False))
    return kind, apply, params, port.eval()


def _bt(x):
    """(B, T, C, H, W) -> gfla_tpu's (B, T, H, W, C)."""
    return x.permute(0, 1, 3, 4, 2).numpy()


def test_generator_eval_matches_flax(generator_pair):
    kind, apply, params, port = generator_pair
    args = _inputs(kind, 13)
    gen_j, flows_j, masks_j, prev_j = apply(params, *args, *args[1:])
    with torch.no_grad():
        gen, flows, masks, prev = port(*_port_inputs(*args))
    assert gen.shape == (B, T, 3, H, H)
    assert [tuple(f.shape) for f in flows] == [
        (B, T, 2, s, s) for s in (8, 8, 16, 16)]
    assert [tuple(m.shape) for m in masks] == [
        (B, T, 1, s, s) for s in (8, 8, 16, 16)]
    _close(_bt(gen), gen_j, what="frames")
    _close(_bt(prev), prev_j, what="previous frames")
    for j, (a, b) in enumerate(zip(flows, flows_j)):
        _close(_bt(a), b, what=f"flow {j}")
    for j, (a, b) in enumerate(zip(masks, masks_j)):
        _close(_bt(a), b, what=f"mask {j}")


def test_test_step_streams_two_chunks(generator_pair):
    """Two chunks of one clip: gfla_tpu's test_step carries the last frame
    and skeleton into the second; the port's the same."""
    _stream_two_chunks(*generator_pair, "float32")


def _stream_two_chunks(kind, apply, params, port, dtype):
    """gfla_tpu's test_step and the port's, both built for `dtype`, over
    two chunks, the second from the first's carry: every frame and the
    carried frame within 1e-4 abs, the carried skeleton exactly."""
    opt = argparse.Namespace(
        model=kind, isTrain=False, image_nc=3, structure_nc=NC[kind],
        layers=3, attn_layer=[2, 3], kernel_size={"2": 5, "3": 3}, ngf=8,
        img_f=32, frames_D_V=5, max_frames_per_gpu=6, gpu_ids="-1", seed=0,
        use_spect_g=False, compute_dtype=dtype)
    task = (FaceTask if kind == "face" else DanceTask)(opt)
    task.net_g.load_state_dict(port.state_dict())
    # gfla_tpu's test_step alone (it reads no compute dtype)
    jtask = types.SimpleNamespace(net_g=None, opt=opt)
    state = types.SimpleNamespace(params_g=params, stats_g={})
    jtask._test_step = lambda p, s, *a: apply(p, *a)[0]
    carry_j = carry = None
    for seed in (14, 15):
        bp, p_ref, bp_ref = _inputs(kind, seed)
        batch_j = {"BP_all": bp, "ref_image": p_ref, "ref_skeleton": bp_ref}
        gen_j, carry_j = JaxAnimationTask.test_step(
            jtask, state, batch_j, *(carry_j or (None, None)))
        bpt, pt, bprt = _port_inputs(bp, p_ref, bp_ref)
        gen, carry = task.test_step(
            {"BP_all": bpt, "ref_image": pt, "ref_skeleton": bprt},
            *(carry or (None, None)))
        _close(_bt(gen), gen_j, what=f"chunk {seed}")
        _close(carry[0].permute(0, 2, 3, 1).numpy(), carry_j[0])
        assert np.array_equal(carry[1].permute(0, 2, 3, 1).numpy(),
                              carry_j[1])


def test_spectral_face_u_through_the_frames_matches_flax():
    """--use_spect_g: FaceGenerator's training forward over 3 frames on
    gfla_tpu's scan route, u carried through its scan: the frames, flows
    and masks within 1e-4, and every stored u within 1e-5 (the per-frame
    nets' advanced once a frame, the reference encoder's once). gfla_tpu's
    variables are shaped on its unrolled route: on the scan route its
    init's first carry lacks the per-frame nets' u, and its init
    raises."""
    jmod = JaxFace(structure_nc=16, use_spect=True, **G_CFG)
    args = _inputs("face", 16)
    shapes = jax.eval_shape(lambda r, *a: jmod.init(r, *a, use_scan=False),
                            jax.random.PRNGKey(0), *args)
    params = _noise(shapes["params"], 17)
    rng = np.random.RandomState(18)
    stats = jax.tree_util.tree_map(  # unit u vectors; sigma is not read
        lambda a: (lambda u: u / np.linalg.norm(u))(
            np.asarray(rng.randn(*a.shape), np.float32)),
        shapes["batch_stats"])
    (gen_j, flows_j, masks_j, _), new = jax.jit(
        lambda p, s, *a: jmod.apply({"params": p, "batch_stats": s}, *a,
                                    mutable=["batch_stats"]))(
        params, stats, *args)
    port = define_g("face", structure_nc=16, use_spect=True, **G_CFG)
    port.load_state_dict(convert.face_generator_state_dict(
        params, batch_stats=stats), strict=True)
    before = {k: v.clone() for k, v in port.state_dict().items()
              if k.endswith("weight_u")}
    with torch.no_grad():
        gen, flows, masks, _ = port.train()(*_port_inputs(*args))
    _close(_bt(gen), gen_j, what="frames")
    for j, (a, b) in enumerate(zip(flows + masks,
                                   list(flows_j) + list(masks_j))):
        _close(_bt(a), b, what=f"flow/mask {j}")
    want = convert.face_generator_state_dict(
        jax.device_get(params), batch_stats=jax.device_get(
            new["batch_stats"]))
    got = port.state_dict()
    assert len(before) == sum(k.endswith("weight_u") for k in want) > 50
    for key in before:
        _close(got[key].numpy(), want[key].numpy(), 1e-5, key)
        assert not torch.equal(got[key], before[key]), key


# ---------------------------------------------------------------------------
# the correctness loss's branches
# ---------------------------------------------------------------------------

CORR_CASES = {"frames": dict(frames=2), "mask": dict(mask=True),
              "mask_frames": dict(mask=True, frames=2),
              "bilinear": dict(use_bilinear_sampling=True),
              "bilinear_mask_frames": dict(use_bilinear_sampling=True,
                                           mask=True, frames=2)}


@pytest.fixture(scope="module")
def correctness_pair():
    """gfla_tpu's loss in every case, and its gradient to the flows, in one
    compiled function, on seeded ReLU feature maps (VGG19's relu3_1 at 8x8,
    relu4_1 at 4x4) of 2 clips of 2 frames, folded."""
    rng = np.random.RandomState(31)
    n = 4

    def feats():
        return {"relu3_1": np.maximum(rng.randn(n, 8, 8, 16), 0),
                "relu4_1": np.maximum(rng.randn(n, 4, 4, 32), 0)}

    target, source = feats(), feats()
    target["relu4_1"][0, 0, 0] = 0  # a zero vector: _safe_norm's 0 gradient
    # a flow for each layer (the first resized to 4x4), far enough for the
    # bilinear warp to leave the image
    flows = [(rng.randn(n, 8, 8, 2) * 2.5).astype(np.float32)
             for _ in range(2)]
    mask = rng.rand(n, 16, 16, 1).astype(np.float32)
    target, source = ({k: v.astype(np.float32) for k, v in f.items()}
                      for f in (target, source))
    loss_j = JaxCorrectness(None)

    def all_cases(flows):
        out = {}
        for name, kw in CORR_CASES.items():
            kw = dict(kw, mask=jnp.asarray(mask) if kw.get("mask") else None)
            out[name] = loss_j(None, None, flows, [2, 3], **kw,
                               target_feats=target, source_feats=source)
        return out

    values = jax.device_get(jax.jit(all_cases)(flows))
    with jax.enable_x64(True):
        target, source = ({k: v.astype(np.float64) for k, v in f.items()}
                          for f in (target, source))
        mask = mask.astype(np.float64)
        grads = jax.device_get(jax.jit(lambda f: {
            name: jax.grad(lambda f, name=name: all_cases(f)[name])(f)
            for name in CORR_CASES})([f.astype(np.float64) for f in flows]))
    return (target, source, flows, mask, values, grads,
            PerceptualCorrectness(None))


@pytest.mark.parametrize("case", list(CORR_CASES))
def test_correctness_branches_match_gfla_tpu(correctness_pair, case):
    target, source, flows, mask, values, grads, loss = correctness_pair
    kw = dict(CORR_CASES[case])
    if kw.get("mask"):
        kw["mask"] = torch.from_numpy(mask).permute(0, 3, 1, 2)
    def run(dtype):
        kwd = {k: v.to(dtype) if torch.is_tensor(v) else v
               for k, v in kw.items()}
        flows_t = [torch.from_numpy(f).permute(0, 3, 1, 2).to(dtype)
                   .requires_grad_(True) for f in flows]
        nchw = [{k: torch.from_numpy(v).permute(0, 3, 1, 2).to(dtype)
                 for k, v in f.items()} for f in (target, source)]
        out = loss(None, None, flows_t, [2, 3], **kwd,
                   target_feats=nchw[0], source_feats=nchw[1])
        out.backward()
        return float(out), [f.grad.permute(0, 2, 3, 1).numpy()
                            for f in flows_t]

    got, _ = run(torch.float32)
    want = float(values[case])
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    _, dflows = run(torch.float64)
    for got_g, want_g in zip(dflows, grads[case]):
        _close(got_g, want_g, 1e-9 * np.abs(want_g).max(), case)


# ---------------------------------------------------------------------------
# data, options and refusals
# ---------------------------------------------------------------------------

def _data_opt(phase, **over):
    opt = argparse.Namespace(
        phase=phase, isTrain=phase == "train", load_size=16,
        structure_nc=20, n_frames_total=12, n_frames_pre_load_test=6,
        max_frames_per_gpu=6, max_t_step=3, start_frame=0, seed=7)
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


@pytest.mark.parametrize("phase", ["train", "test"])
def test_synthetic_clips_and_sampling_match_gfla_tpu(phase):
    opt = _data_opt(phase)
    port, ref = SyntheticVideoDataset(opt), JaxSyntheticVideo(opt)
    assert len(port) == len(ref) == 8
    for i in (0, 5):
        want, got = ref[i], port[i]
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(np.asarray(got[key]),
                                  np.asarray(want[key])), key
    assert got["P_all"].shape == (12 if phase == "train" else 6, 16, 16, 3)
    if phase == "train":
        for seq_len in (3, 12, 40, 100):
            assert port.sample_window(seq_len) == ref.sample_window(seq_len)
    # the test cursor: the port looks chunk i up, gfla_tpu moves a cursor
    port.index_sequences([15, 15])
    want = []
    for _ in range(6):
        seq, start = ref.seq_idx, ref.frame_idx
        want.append((seq, start, ref.advance_test_cursor(15)))
    got = [(seq, start, start + 6 >= 15) for seq, start in port.chunks]
    assert got == want


def _anim_opt(kind, **over):
    opt = argparse.Namespace(
        model=kind, isTrain=True, image_nc=3, structure_nc=NC[kind],
        layers=3, attn_layer=[2, 3], kernel_size={"2": 5, "3": 3}, ngf=8,
        img_f=32, gpu_ids="-1", seed=0, use_spect_g=False,
        compute_dtype="float32")
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


@pytest.mark.parametrize("kind,over", [
    ("dance", dict(frames_D_V=8, max_frames_per_gpu=6)),
    ("dance", dict(frames_D_V=4, max_frames_per_gpu=4)),
    ("face", dict(frames_D_V=8, max_frames_per_gpu=6))],
    ids=["dance-window", "dance-minimum", "face-window"])
def test_frames_d_v_refusals_match_gfla_tpu(kind, over):
    """A D_V window longer than a chunk, and dance's below the temporal
    D's minimum of 5, refused at init as gfla_tpu refuses them."""
    with pytest.raises(ValueError, match="frames_D_V") as want:
        JaxAnimationTask.__init__(types.SimpleNamespace(kind=kind),
                                  _anim_opt(kind, **over))
    task_cls = FaceTask if kind == "face" else DanceTask
    with pytest.raises(ValueError, match="frames_D_V") as got:
        task_cls(_anim_opt(kind, **over))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["dance", "face"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_options_parse_like_gfla_tpu(monkeypatch, tmp_path, kind, mode):
    from gfla_tpu.options.options import TestOptions as JaxTestOptions
    from gfla_tpu.options.options import TrainOptions as JaxTrainOptions
    from gfla_tpu_torch.options import TestOptions, TrainOptions

    flags = [f"--model={kind}", "--dataset_mode=synthetic_video",
             "--load_size=128", "--frames_D_V=5", "--use_mask",
             "--n_frames_total=18", "--write_ext=jpg",
             f"--checkpoints_dir={tmp_path}"]
    monkeypatch.setattr(sys, "argv", [f"{mode}.py", *flags])
    jax_cls, port_cls = ((JaxTrainOptions, TrainOptions) if mode == "train"
                         else (JaxTestOptions, TestOptions))
    want = vars(jax_cls().parse(save=False))
    got = vars(port_cls().parse(flags, save=False))
    assert got == want
    assert got["netD_V"] == ("temporal" if kind == "dance" else "res")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

FORBIDDEN = {"jax", "flax", "optax", "orbax", "pandas", "cv2", "gfla_tpu",
             "imageio", "PIL"}
SMALL = ["--gpu_ids=-1", "--dataset_mode=synthetic_video", "--load_size=64",
         "--nThreads=0", "--max_frames_per_gpu=3", "--frames_D_V=3",
         "--n_frames_pre_load_test=3", "--n_frames_total=3"]


def _cli(module, tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-X", "importtime", "-m", module, *SMALL, *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"))


def _imported(stderr):
    return {line.rsplit("|", 1)[-1].strip().split(".")[0]
            for line in stderr.splitlines()
            if line.startswith("import time:")}


def test_clis_train_and_serve_face(tmp_path):
    """One training iteration of the full-width face head (G, D and D_V
    saved, the held-out clips evaluated, the last frame's visual written),
    then the serving CLI on that G: gfla_tpu's file names for every clip
    of the test set. Neither imports JAX or an image library."""
    ckpt = tmp_path / "ckpt"
    proc = _cli("gfla_tpu_torch.train", tmp_path, "--model=face",
                "--batchSize=2", "--max_iters=1", "--print_freq=1",
                "--eval_iters_freq=1", "--display_freq=1",
                f"--checkpoints_dir={ckpt}", "--name=anim")
    assert proc.returncode == 0, proc.stderr
    assert not _imported(proc.stderr) & FORBIDDEN
    run = ckpt / "anim"
    for net in ("G", "D", "D_V"):
        assert (run / f"1_net_{net}.pth").exists(), net
    assert "held out 2 samples" in proc.stdout
    assert any("ssim:" in line for line in proc.stdout.splitlines())
    assert (run / "web" / "images" / "iter00000001_img_gen.png").exists()

    res = tmp_path / "res"
    proc = _cli("gfla_tpu_torch.test", tmp_path, "--model=face",
                f"--checkpoints_dir={ckpt}", "--name=anim",
                f"--results_dir={res}")
    assert proc.returncode == 0, proc.stderr
    assert "loaded checkpoint" in proc.stdout
    assert not _imported(proc.stderr) & FORBIDDEN
    got = sorted(p.relative_to(res).as_posix() for p in res.rglob("*.png"))

    opt = argparse.Namespace(
        dataset_mode="synthetic_video", phase="test", isTrain=False,
        load_size=64, structure_nc=16, n_frames_pre_load_test=3,
        n_frames_total=3, max_frames_per_gpu=3, start_frame=0, batchSize=1,
        serial_batches=True, nThreads=0, seed=0,
        max_dataset_size=sys.maxsize, results_dir=str(tmp_path / "ref"),
        name="anim", write_ext="png")
    stub = types.SimpleNamespace(test_step=lambda state, dev, i, s: (
        jnp.zeros(dev["P_all"].shape), None))
    JaxAnimationTask.run_test(
        stub, opt, None, jax_create_dataloader(opt),
        lambda b: {k: jnp.asarray(v) for k, v in b.items()
                   if isinstance(v, np.ndarray)})
    want = sorted(p.relative_to(tmp_path / "ref").as_posix()
                  for p in (tmp_path / "ref").rglob("*.png"))
    assert len(want) == 8 * 3 * 2 and got == want


# ---------------------------------------------------------------------------
# bf16: the chunk step of each head, --remat, the streaming test, the CLIs
# ---------------------------------------------------------------------------
# gfla_tpu casts G's f32 parameters and inputs to bf16 once for the whole
# chunk, D and D_V likewise, and the frozen VGG19 once (gfla_tpu/tasks/
# animation.py:160-161, 227-260); the port does the same through
# `train.precision.cast_call`. Sizes: tests/test_torch_port_animation_train
# .py's (64x64 clips, batch 2, 3 frames a chunk for face and 5 for dance, G
# at ngf 8, img_f 32 with both attention levels, D and D_V at ndf 8); every
# weight and clip value is seeded noise that bf16 represents
# (tests/test_torch_port_bf16.py's `_noise`).
#
# bf16 rounds at other places in the two frameworks (XLA keeps excess
# precision inside a fusion), so the steps are held as tests/test_torch_port
# _bf16.py holds pose's, by cosine and norm ratio. At these sizes much of
# G's bf16 gradient is rounding: the port's own bf16 step on the batch in
# reversed order (the same sums in another order) leaves 95 of dance's 275 G
# tensors below cosine 0.7 with the step in order, one at -0.36. So a tensor
# is held against gfla_tpu's where bf16 resolves it (RESOLVED): where the
# reordered step keeps its direction and gfla_tpu's bf16 gradient keeps the
# port's f32 one's; every tensor with a gradient counts in the network's
# mean error against the port's f32 step (2x gfla_tpu's + SLACK).

# gfla_tpu's bf16 chunk step compiled at XLA's backend optimization level 1
# (tests/conftest.py sets 0 for the whole test run): at 0 a run of it takes
# ~12 s, at the full level its compilation ~1.4x the CPU time of level 1's
GFLA_BF16_XLA = {"xla_backend_optimization_level": 1}
# each loss against gfla_tpu's, x the f32 step's: the correctness losses
# sum per-frame terms that bf16 features move (read: face correctness_r
# 1.9e-2, gfla_tpu's own 2.9e-2 off f32 and the port's 1.0e-2; every other
# loss within 1.3e-2)
LOSS_REL = 5e-2
RESOLVED = 0.7
# tag: per-tensor cosine floor, whole-network floor, per-tensor norm-ratio
# band, whole-network band, over the resolved tensors. Readings against
# gfla_tpu's bf16 step (face, dance), G: 180 of 198 and 148 of 275 tensors
# resolved, cosine 0.687 and 0.663 and up (the latter the k=5 warp's b1),
# norm ratios 0.683-1.628, the whole network 0.924 and 0.977, 1.010 and
# 0.991; D: all 20, 0.984 and 0.975 and up, 0.957-1.769, 0.992 and 0.991,
# 1.023 and 1.017; D_V: all 20, 0.987 and 0.837 (the first 3-D block's
# bias: gfla_tpu's bf16 sum of it is the one off f32, by cosine 0.838, and
# its norm 2.7x smaller), ratios 0.935-2.675, whole 0.998 and 0.992, 1.017
# and 1.013. Face against the port's f32 step: G 190 of 198 resolved,
# cosine 0.655 and up, ratios 0.645-1.481, whole 0.934 and 1.003; D and
# D_V cosine 0.998 and up, ratios 0.975-1.017, whole 0.99994. The floors
# and bands stand 2-3x further from a match than the readings.
STEP_HOLD = {
    "G": (0.4, 0.8, (1 / 3, 3.0), (0.8, 1.25)),
    "D": (0.6, 0.97, (1 / 4, 4.0), (0.95, 1.05)),
    "D_V": (0.6, 0.97, (1 / 4, 4.0), (0.95, 1.05)),
}
# the served frames and the carry against gfla_tpu's bf16 ones, x max|f32|
# (the pose head's IMAGE_TOL, tests/test_torch_port_bf16.py)
SERVE_TOL = 2.5e-1
# a stored u against the f32 step's, x max|f32 u|: a unit vector after two
# bf16 power-iteration steps (read: face's first D block 7.0e-3, where
# XLA's fused iteration, rounding once, leaves gfla_tpu's at 2.4e-3)
U_TOL = 2e-2
TASKS = {"face": FaceTask, "dance": DanceTask}


def _bf16_tree(batch):
    return {k: _bf16_values(v) for k, v in _f32(batch).items()}


def _port_task(kind, dtype, sds, vgg_sd):
    task = TASKS[kind](_train_opt(kind, compute_dtype=dtype))
    for tag, net in _nets(task).items():
        net.load_state_dict(sds[tag], strict=True)
    task.vgg.load_state_dict(vgg_sd, strict=True)
    return task


def _nets(task):
    return {"G": task.net_g, "D": task.net_d, "D_V": task.net_d_v}


def _sds(kind, params_g, params_d, stats_d):
    return {"G": _g_state_dict(kind, params_g),
            "D": convert.res_discriminator_state_dict(
                params_d["D"], stats_d["D"], layers=D_LAYERS),
            "D_V": _dv_state_dict(kind, params_d["D_V"], stats_d["D_V"])}


def _bf16_chunk(kind, against_gfla_tpu):
    """The port's chunk steps from a noise state: f32, bf16, and bf16 on the
    reversed batch; with `against_gfla_tpu`, gfla_tpu's bf16 step from it
    (the one bf16 chunk step of gfla_tpu's these tests compile)."""
    task, task_j, state = _pair(kind, compute_dtype="bfloat16")
    assert task_j.dtype == jnp.bfloat16
    state = jax.device_get(state.replace(
        params_g=_bf16_noise(state.params_g, 5),
        params_d=_bf16_noise(state.params_d, 6)))
    sds = _sds(kind, state.params_g, state.params_d, state.stats_d)
    vgg_sd = task.vgg.float().state_dict()
    batch = _bf16_tree(_clip(kind, FRAMES[kind], 1))
    rng = jax.random.PRNGKey(5)
    idx = _indices(rng, FRAMES[kind], FRAMES[kind])
    steps = {}
    chunk = _first_chunk(_port(batch))
    for run, dt, order in (("float32", "float32", 1),
                           ("bfloat16", "bfloat16", 1),
                           ("reordered", "bfloat16", -1)):
        port = _port_task(kind, dt, sds, vgg_sd)
        logs, carry = port.train_chunk(
            {k: v.flip(0) if order < 0 else v for k, v in chunk.items()},
            idx)
        steps[run] = dict(task=port, logs=logs, carry=carry)
    out = dict(steps=steps, sds=sds, vgg_sd=vgg_sd, batch=batch, idx=idx,
               grads=None)
    if against_gfla_tpu:
        step = jax.jit(task_j._chunk_step_impl,
                       compiler_options=GFLA_BF16_XLA)
        state2, out["logs_j"], out["carry_j"] = jax.device_get(step(
            _dev(state), _dev(_first_chunk(batch)), _dev(rng)))
        out["want"] = _sds(kind, state2.params_g, state2.params_d,
                           state2.stats_d)
        out["grads"] = _sds(kind, state2.opt_state_g[0].mu,
                            state2.opt_state_d[0].mu, state2.stats_d)
    return out


@pytest.fixture(scope="module")
def face_bf16():
    return _bf16_chunk("face", against_gfla_tpu=False)


@pytest.fixture(scope="module")
def dance_bf16():
    return _bf16_chunk("dance", against_gfla_tpu=True)


@pytest.fixture(params=["dance"])
def bf16_chunk(request):
    return request.getfixturevalue(f"{request.param}_bf16")


def _grads(task, tag):
    return {n: p.grad for n, p in _nets(task)[tag].named_parameters()}


def _live(steps, tag):
    """The tensors with a gradient in the f32 step: a conv bias that feeds
    an instance norm has none, and bf16 gives it rounding only."""
    g32 = _grads(steps["float32"]["task"], tag)
    scale = max(g.abs().max().item() for g in g32.values())
    return [n for n, g in g32.items() if g.abs().max() > 1e-5 * scale]


def _resolved(run, tag):
    """The live tensors bf16 resolves (cosine >= RESOLVED between the
    port's bf16 steps on the batch in order and reversed, and, where the
    run has it, between gfla_tpu's bf16 gradient and the port's f32
    one)."""
    steps = run["steps"]
    bf, again, g32 = (_grads(steps[k]["task"], tag)
                      for k in ("bfloat16", "reordered", "float32"))
    ref = g32 if run["grads"] is None else run["grads"][tag]
    return [n for n in _live(steps, tag)
            if _cos(bf[n], again[n]) >= RESOLVED
            and _cos(ref[n], g32[n]) >= RESOLVED]


def test_chunk_step_bf16_matches_gfla_tpu(bf16_chunk):
    """One chunk step in bf16 against gfla_tpu's bf16 `_chunk_step_impl`,
    its four indices passed to the port: every loss within LOSS_REL x the
    f32 step's; the resolved gradients of G, D and D_V tensor by tensor and
    as a whole network by STEP_HOLD, and each network's mean error against
    the port's f32 step within 2x gfla_tpu's + SLACK; the masters, their
    gradients and the stored u in f32, u within U_TOL of the f32 step's
    and OUT_TOL of gfla_tpu's; the carry by the bf16 rule (SERVE_TOL)."""
    run = bf16_chunk
    steps = run["steps"]
    bf = steps["bfloat16"]
    logs, logs32 = bf["logs"], steps["float32"]["logs"]
    for name, want in run["logs_j"].items():
        got, want, f32 = float(logs[name]), float(want), float(logs32[name])
        assert np.isfinite(got) and abs(got - want) <= LOSS_REL * abs(f32), (
            name, got, want, f32)
    for got, want, f32 in zip(bf["carry"], run["carry_j"],
                              steps["float32"]["carry"]):
        assert got.dtype == torch.float32
        _rule(got.permute(0, 2, 3, 1), np.asarray(want),
              f32.permute(0, 2, 3, 1), SERVE_TOL, "carry")
    task = bf["task"]
    for tag in ("G", "D", "D_V"):
        grads, ref = _grads(task, tag), run["grads"][tag]
        live, resolved = _live(steps, tag), _resolved(run, tag)
        assert len(resolved) >= len(live) / 2, (tag, len(resolved))
        for name, p in _nets(task)[tag].named_parameters():
            assert p.dtype == p.grad.dtype == torch.float32, (tag, name)
        bad = _unheld(grads, ref, resolved, *STEP_HOLD[tag])
        assert not bad, (tag, bad)
        g32 = _grads(steps["float32"]["task"], tag)
        errors = [_errors(grads[n], ref[n], g32[n], f"{tag} {n}")
                  for n in live]
        e_port, e_ref, _ = np.mean(errors, axis=0)
        assert e_port <= 2 * e_ref + SLACK, (tag, e_port, e_ref)
        u32 = dict(_nets(steps["float32"]["task"])[tag].named_buffers())
        for name, u in _nets(task)[tag].named_buffers():
            assert u.dtype == torch.float32, (tag, name)
            if name.endswith("weight_u"):
                e_port, _, e_dir = _errors(u, run["want"][tag][name],
                                           u32[name], name)
                assert e_port <= U_TOL and e_dir <= OUT_TOL, (
                    tag, name, e_port, e_dir)


def test_chunk_step_bf16_holds_to_f32(face_bf16):
    """The face head's bf16 chunk step against the port's f32 step from the
    same state (the dance head's is held against gfla_tpu's above): every
    loss within LOSS_REL x the f32 one; the carry within SERVE_TOL x
    max|f32|; the resolved gradients of G, D and D_V by STEP_HOLD against
    the f32 ones; the masters, their gradients and the stored u in f32, u
    within U_TOL of the f32 step's."""
    steps = face_bf16["steps"]
    bf, f32 = steps["bfloat16"], steps["float32"]
    for name, want in f32["logs"].items():
        got, want = float(bf["logs"][name]), float(want)
        assert np.isfinite(got) and abs(got - want) <= LOSS_REL * abs(want), (
            name, got, want)
    for got, want in zip(bf["carry"], f32["carry"]):
        assert got.dtype == torch.float32
        top = want.abs().max().item()
        assert (got - want).abs().max().item() <= SERVE_TOL * top
    task = bf["task"]
    for tag in ("G", "D", "D_V"):
        g32 = _grads(f32["task"], tag)
        live, resolved = _live(steps, tag), _resolved(face_bf16, tag)
        assert len(resolved) >= len(live) / 2, (tag, len(resolved))
        for name, p in _nets(task)[tag].named_parameters():
            assert p.dtype == p.grad.dtype == torch.float32, (tag, name)
        bad = _unheld(_grads(task, tag), g32, resolved, *STEP_HOLD[tag])
        assert not bad, (tag, bad)
        u32 = dict(_nets(f32["task"])[tag].named_buffers())
        for name, u in _nets(task)[tag].named_buffers():
            assert u.dtype == torch.float32, (tag, name)
            if name.endswith("weight_u"):
                top = u32[name].abs().max().item()
                assert (u - u32[name]).abs().max().item() <= U_TOL * top, (
                    tag, name)


@pytest.mark.parametrize("fault", ["zeroed", "negated"])
@pytest.mark.parametrize("name", [
    "target.attn_p1.fully_connect_layer.2.weight",  # W2 of a k=5 warp
    "flow_net_previous.output2.weight",             # fed by its d_flow
])
def test_chunk_step_hold_catches_a_planted_fault(dance_bf16, name, fault):
    """STEP_HOLD fails a dance step in which one warp-fed G gradient is
    zeroed or negated, and names that tensor only."""
    grads = _grads(dance_bf16["steps"]["bfloat16"]["task"], "G")
    ref = dance_bf16["grads"]["G"]
    resolved = _resolved(dance_bf16, "G")
    assert name in resolved
    assert not _unheld(grads, ref, resolved, *STEP_HOLD["G"])
    grads[name] = grads[name] * (0.0 if fault == "zeroed" else -1.0)
    bad = {t[0] for t in _unheld(grads, ref, resolved, *STEP_HOLD["G"])}
    assert bad - {"whole network"} == {name}, bad


def test_remat_bf16_keeps_the_chunk_step(dance_bf16):
    """--remat in bf16: the recomputed frames run on the bf16 copies the
    forward ran on (the target net's forward runs twice a frame, on bf16),
    and the losses, every gradient and every stored u are bitwise the
    plain bf16 step's."""
    run = dance_bf16
    task = _port_task("dance", "bfloat16", run["sds"], run["vgg_sd"])
    task.opt.remat = True
    calls = []
    target = task.net_g.target.forward
    task.net_g.target.forward = lambda *a: calls.append(
        a[1][0].dtype) or target(*a)
    logs, _ = task.train_chunk(_first_chunk(_port(run["batch"])), run["idx"])
    assert calls == [torch.bfloat16] * (2 * FRAMES["dance"])
    want = run["steps"]["bfloat16"]
    for name, v in want["logs"].items():
        assert torch.equal(logs[name], v), name
    for tag, net in _nets(want["task"]).items():
        other = dict(_nets(task)[tag].named_parameters())
        for name, p in net.named_parameters():
            assert torch.equal(other[name].grad, p.grad), (tag, name)
        buffers = dict(_nets(task)[tag].named_buffers())
        for name, b in net.named_buffers():
            assert torch.equal(buffers[name], b), (tag, name)


def test_streamed_serving_bf16_matches_gfla_tpu():
    """Serving under --compute_dtype=bfloat16: gfla_tpu's animation test
    step runs G's f32 parameters whatever the flag says
    (gfla_tpu/tasks/animation.py:495-514), and so does the port's; two
    face chunks as test_test_step_streams_two_chunks holds them (1e-4
    abs)."""
    _stream_two_chunks(*_generator_pair("face"), "bfloat16")


def test_clis_train_and_stream_dance_bf16(tmp_path):
    """`--compute_dtype=bfloat16` through both CLIs: one dance iteration
    with --use_mask from a tree with iPER masks (the masks read, decoded
    and warped by the loader and prepare_batch; finite losses; checkpoints
    in f32), then the serving CLI streaming the tree's test sequence in
    bf16 from that G."""
    root = str(tmp_path / "dance")
    chip_smoke.write_video_tree(root, "dance", 72, 56, 5, "cpu", seqs=1,
                                frames=5)
    ckpt, res = tmp_path / "ckpt", tmp_path / "res"
    common = ["--gpu_ids=-1", "--model=dance", "--dataset_mode=dance",
              f"--dataroot={root}", "--load_size=64", "--nThreads=0",
              "--compute_dtype=bfloat16", f"--checkpoints_dir={ckpt}",
              "--name=bf16"]

    def cli(module, *args):
        return subprocess.run(
            [sys.executable, "-m", module, *common, *args], cwd=tmp_path,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"))

    proc = cli("gfla_tpu_torch.train", "--use_mask", "--batchSize=1",
               "--max_frames_per_gpu=5", "--n_frames_total=5",
               "--frames_D_V=5", "--max_iters=1", "--print_freq=1",
               "--seed=3")
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = [line for line in proc.stdout.splitlines()
              if line.startswith("(epoch:")]
    assert len(losses) == 1 and "nan" not in losses[0].lower()
    for net in ("G", "D", "D_V"):
        sd = torch.load(ckpt / "bf16" / f"1_net_{net}.pth",
                        weights_only=True)
        assert {t.dtype for t in sd.values()} == {torch.float32}, net
    proc = cli("gfla_tpu_torch.test", "--n_frames_pre_load_test=3",
               f"--results_dir={res}")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded checkpoint" in proc.stdout
    assert "wrote 6 frames" in proc.stdout  # 5 frames padded to 2 chunks
    assert len(list(res.rglob("*_vis.png"))) == 5
