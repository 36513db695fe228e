"""The animation heads' modules, serving and CLIs (dance, face) against
gfla_tpu, on the CPU.

Held:
- Conv3d (plain and spectral), ResBlock3DEncoder and TemporalDiscriminator:
  forward within 1e-4 abs, input and parameter gradients within 1e-4 x the
  tensor's largest of gfla_tpu's, stored u within 1e-5; `add_coords`
  within 2.5e-7 (the two linspaces' rounding);
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
- the three `--frames_D_V` refusals and the bf16 refusal;
- the training CLI on `synthetic_video` writes `net_G`, `net_D` and
  `net_D_V`, evaluates its held-out clips and writes the visuals; the
  serving CLI loads that G and writes gfla_tpu's file names; neither
  imports JAX or an image library.
"""

import argparse
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

from gfla_tpu.data import create_dataloader as jax_create_dataloader
from gfla_tpu.convert import convert_dance_generator as jax_convert_dance
from gfla_tpu.convert import convert_face_generator as jax_convert_face
from gfla_tpu.data.animation_data import \
    SyntheticVideoDataset as JaxSyntheticVideo
from gfla_tpu.losses.perceptual import \
    PerceptualCorrectness as JaxCorrectness
from gfla_tpu.models.discriminators import \
    TemporalDiscriminator as JaxTemporalD
from gfla_tpu.models.generators import DanceGenerator as JaxDance
from gfla_tpu.models.generators import FaceGenerator as JaxFace
from gfla_tpu.nn.blocks import ResBlock3DEncoder as JaxResBlock3D
from gfla_tpu.nn.norms import Conv3d as JaxConv3d
from gfla_tpu.nn.norms import add_coords as jax_add_coords
from gfla_tpu.tasks.animation import AnimationTaskBase as JaxAnimationTask
from gfla_tpu_torch import convert
from gfla_tpu_torch.data.animation_data import SyntheticVideoDataset
from gfla_tpu_torch.losses import PerceptualCorrectness
from gfla_tpu_torch.models import define_d, define_g
from gfla_tpu_torch.nn.blocks import ResBlock3DEncoder
from gfla_tpu_torch.nn.norms import add_coords, conv3d
from gfla_tpu_torch.tasks.animation import DanceTask, FaceTask

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
    inv = (0, 4, 1, 2, 3) if name != "temporal_d" else (0, 1, 4, 2, 3)
    _grad_close(x.grad.numpy(), np.asarray(gx).transpose(*inv), "d input")
    want = to_sd(jax.device_get(gp), jax.device_get(new["batch_stats"])
                 if stats else None)
    for key, p in port.named_parameters():
        _grad_close(p.grad.numpy(), want[key].numpy(), f"d {key}")
    us = [k for k in port.state_dict() if k.endswith("weight_u")]
    assert bool(us) == (name != "conv3d")
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
    """gfla_tpu's generator with noise parameters and its eval-mode apply,
    compiled once; the port's with the same."""
    kind = request.param
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
    kind, apply, params, port = generator_pair
    opt = argparse.Namespace(
        model=kind, isTrain=False, image_nc=3, structure_nc=NC[kind],
        layers=3, attn_layer=[2, 3], kernel_size={"2": 5, "3": 3}, ngf=8,
        img_f=32, frames_D_V=5, max_frames_per_gpu=6, gpu_ids="-1", seed=0,
        use_spect_g=False, compute_dtype="float32")
    task = (FaceTask if kind == "face" else DanceTask)(opt)
    task.net_g.load_state_dict(port.state_dict())
    jtask = types.SimpleNamespace(net_g=None)  # gfla_tpu's test_step alone
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
    for seq_len in (3, 12, 40, 100):
        assert port.sample_window(seq_len) == ref.sample_window(seq_len)
    flags = [(port.advance_test_cursor(15), port.frame_idx, port.seq_idx)
             for _ in range(4)]
    assert flags == [(ref.advance_test_cursor(15), ref.frame_idx,
                      ref.seq_idx) for _ in range(4)]


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
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_bfloat16_is_refused(kind, is_train):
    """No silent float32: the animation heads refuse bf16, naming the
    ROADMAP item, before they choose a device."""
    opt = _anim_opt(kind, isTrain=is_train, compute_dtype="bfloat16",
                    frames_D_V=6 if kind == "dance" else 3,
                    max_frames_per_gpu=6, gpu_ids="0")
    task_cls = FaceTask if kind == "face" else DanceTask
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        task_cls(opt)


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
