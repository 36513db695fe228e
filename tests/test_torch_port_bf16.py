"""The pose head under `--compute_dtype=bfloat16` against gfla_tpu, on the CPU.

gfla_tpu's mixed precision (train/precision.py, tasks/pose.py:145-181) casts
the f32 master parameters to bf16 inside the differentiated function and
its warp kernel rounds to bf16 at fixed points of its body
(ops/pallas_warp.py:183-200, 286-319, 467). The port does the same through
`train.precision.cast_call` and the bf16 mode of `ops.warp`. Inputs and
weights are seeded numpy values that bf16 represents, so both packages and
both types see the same numbers.

bf16 rounds at other places in the two frameworks (XLA may keep excess
precision inside a fusion), so no f32 tolerance can hold. Every bf16 result
of a kernel or module is held by one rule, on each output or tensor:
- its max error against the f32 result of the same inputs and weights is at
  most 2x gfla_tpu's own bf16 error there, plus 1e-3 x max|f32 result|;
- and it is within a stated tolerance of gfla_tpu's bf16 result, relative
  to max|f32 result|: the warp's output and d_source 1e-2 (a bf16 ulp is
  3.9e-3 of the largest value, and the outputs are rounded to bf16), its
  other gradients 3e-2 (gfla_tpu's own bf16 gradients sit up to 12% off
  its f32 ones at these sizes, where sums cancel; the port's plain twin
  rounds where gfla_tpu does and measured within 6e-4); the step's losses
  1e-2 relative.
At the generator's widths gfla_tpu's modules take its XLA composition on
the CPU (its warp kernel needs C and D multiples of 128 there, and its
tiles H*W a multiple of 128), which blends the blocks at bf16 flow
coordinates; the port's default route, the warp, keeps them in f32 as
gfla_tpu's kernel does. So ExtractorAttn's warp route is held against
gfla_tpu's kernel, interpreted, its composite route (GFLA_ATTN_PALLAS=0)
against the composition, and its attention-math route (GFLA_ATTN_PALLAS=1)
against gfla_tpu's `attn_math_fused` under the same switch; the generator
and the step run on all three routes against gfla_tpu's composition.
The generator and the step start from seeded noise weights (N(0, 1/fan_in),
as tests/test_torch_port_pose.py's generator test). Through ~30 bf16 conv
and norm layers (instance norms down to 1x1 at 32x32) rounding accumulates
in both frameworks alike: the two bf16 images sit 13-16% of max off the
f32 one and 18% apart, though 7.7% in norm (IMAGE_TOL, IMAGE_NORM_TOL);
the flows and masks 4% (FLOW_TOL). The step's gradients are held per
tensor by cosine and norm ratio against gfla_tpu's (STEP_HOLD, with the
readings), and by the rule's first clause on each network's mean over
tensors against the port's f32 step; the updated parameters by their moves
(MOVE_HOLD); u by the whole rule.
gfla_tpu's interpreted kernel is its Pallas body run by the interpreter, as
tests/test_torch_port_ops.py runs it. The whole pose step of gfla_tpu in
bf16 is built once, in a module fixture, and the port's steps from it once
on each route. The f32 results of the step are the port's own f32 step,
which tests/test_torch_port_train.py holds to gfla_tpu's within 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfla_tpu.nn import attention as jattn
from gfla_tpu.nn import norms as jnorms
from gfla_tpu.ops.pallas_warp import attn_warp_core, local_attn_warp_fused
from gfla_tpu.tasks import create_task as jax_create_task
from gfla_tpu.train import precision as jax_precision
from test_torch_port_train import _batch as train_batch
from test_torch_port_train import _opt as train_opt
from test_torch_port_train import _port_batch

from gfla_tpu_torch import convert
from gfla_tpu_torch.nn import attention
from gfla_tpu_torch.nn.norms import SpectralConv2d
from gfla_tpu_torch.ops import warp
from gfla_tpu_torch.ops.local_attn import local_attn_warp, target_stream
from gfla_tpu_torch.tasks.pose import PoseTask
from gfla_tpu_torch.train import precision

BF16 = torch.bfloat16
SLACK = 1e-3      # the rule's absolute slack, x max|f32 result|
OUT_TOL = 1e-2    # outputs rounded to bf16 (one ulp: 3.9e-3 of the max)
GRAD_TOL = 3e-2   # gradients, where sums cancel
LOSS_REL = 1e-2   # the step's losses, relative
# the generator against gfla_tpu's, both routes (readings: the image 0.180-
# 0.185 of max and 0.077 in norm, flows and masks at most 0.040)
FLOW_TOL = 8e-2
IMAGE_TOL = 2.5e-1
IMAGE_NORM_TOL = 1.2e-1
ROUTES = {"warp": "auto", "composite": "0",  # GFLA_ATTN_PALLAS
          "attn_math": "1"}


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: these steps run beside the other test workers
    on the same cores, where torch's default of one thread a core
    oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_values(a):
    """float32 copies of `a` that bf16 represents exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float(
        ).numpy()


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _errors(port, ref, f32, what=""):
    """Max errors of `port` and `ref` (bf16) against `f32` and of `port`
    against `ref`, relative to max|f32|."""
    port, ref, f32 = _f(port), _f(ref), _f(f32)
    assert port.shape == ref.shape == f32.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    top = max(np.abs(f32).max(), 1e-30)
    return (np.abs(port - f32).max() / top, np.abs(ref - f32).max() / top,
            np.abs(port - ref).max() / top)


def _rule(port, ref, f32, tol, what=""):
    """The bf16 rule: `port` (bf16) against `f32` within 2x `ref`'s (bf16)
    error there + SLACK x max|f32|, and against `ref` within tol x
    max|f32|."""
    e_port, e_ref, e_dir = _errors(port, ref, f32, what)
    assert e_port <= 2 * e_ref + SLACK, (what, e_port, e_ref)
    assert e_dir <= tol, (what, e_dir, tol)


# ---------------------------------------------------------------------------
# train/precision.py
# ---------------------------------------------------------------------------

def test_precision_casts_the_tree_as_gfla_tpu():
    rng = np.random.RandomState(0)
    w = rng.randn(3, 4).astype(np.float32)
    tree_j = {"w": jnp.asarray(w), "n": jnp.arange(3, dtype=jnp.int32),
              "m": jnp.asarray([True, False]), "list": [jnp.asarray(w[0])]}
    tree_t = {"w": torch.from_numpy(w), "n": torch.arange(3, dtype=torch.int32),
              "m": torch.tensor([True, False]), "list": [torch.from_numpy(w[0])]}
    for name in ("bfloat16", "bf16", "float32"):
        dt_j = jax_precision.compute_dtype(name)
        dt_t = precision.compute_dtype(name)
        assert str(jnp.dtype(dt_j)) == str(dt_t).removeprefix("torch.")
        cast_j = jax_precision.cast_tree(tree_j, dt_j)
        cast_t = precision.cast_tree(tree_t, dt_t)
        assert cast_t["n"].dtype == torch.int32 and cast_t["n"] is tree_t["n"]
        assert cast_t["m"].dtype == torch.bool
        assert cast_t["w"].dtype == dt_t and cast_t["list"][0].dtype == dt_t
        np.testing.assert_array_equal(_f(cast_t["w"]), _f(cast_j["w"]))
        back = precision.to_f32(cast_t)
        assert back["w"].dtype == torch.float32
        np.testing.assert_array_equal(back["w"].numpy(),
                                      _f(jax_precision.to_f32(cast_j)["w"]))


@pytest.mark.parametrize("update", [True, False])
def test_cast_call_reaches_the_f32_masters_as_gfla_tpu(update):
    """A spectral-norm conv in bf16 from f32 masters: the output, u stored
    in f32 (only with update_stats), and f32 gradients of the masters and
    the input, against flax's apply on cast_tree'd variables."""
    rng = np.random.RandomState(1)
    x = _bf16_values(rng.randn(2, 10, 12, 5))
    r = rng.randn(2, 6, 5, 6).astype(np.float32)  # NCHW, as the output
    jmod = jnorms.Conv2d(6, (4, 4), (2, 2), 1, use_spect=True)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(_bf16_values(np.asarray(a) * 3)), v["params"])
    stats = v["batch_stats"]

    def f(p, x, dt):
        out, new = jmod.apply(
            {"params": jax_precision.cast_tree(p, dt),
             "batch_stats": jax_precision.cast_tree(stats, dt)},
            x.astype(dt), update_stats=update, mutable=["batch_stats"])
        out = out.astype(jnp.float32)
        return jnp.sum(out * jnp.asarray(r).transpose(0, 2, 3, 1)), (
            out, jax_precision.to_f32(new))

    results = {}
    for dt in (jnp.float32, jnp.bfloat16):
        (_, (out, new)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x), dt)
        results[dt] = out, new, gp, gx
    sd = {}
    convert._conv(params, "c", sd, stats)
    ports = {}
    for dt in (torch.float32, BF16):
        port = SpectralConv2d(5, 6, 4, 2, 1)
        port.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
        u0 = port.weight_u.clone()
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
        out = precision.cast_call(port, dt, xt, update_stats=update)
        assert out.dtype == torch.float32
        (out * torch.from_numpy(r)).sum().backward()
        assert {p.grad.dtype for p in port.parameters()} == {torch.float32}
        assert port.weight_u.dtype == torch.float32
        assert torch.equal(port.weight_u, u0) != update
        ports[dt] = out, port, xt.grad
    out_j, new_j, gp_j, gx_j = results[jnp.bfloat16]
    out32, port32, gx32 = ports[torch.float32]
    out, port, gx = ports[BF16]
    nhwc = (0, 2, 3, 1)
    _rule(out.permute(*nhwc), out_j, out32.permute(*nhwc), OUT_TOL, "out")
    _rule(gx.permute(*nhwc), gx_j, gx32.permute(*nhwc), GRAD_TOL, "d_x")
    grads = {"weight_orig": lambda g: g.permute(2, 3, 1, 0),
             "bias": lambda g: g}
    for name, view in grads.items():
        _rule(view(getattr(port, name).grad), gp_j["Conv_0"][
            "kernel" if name == "weight_orig" else "bias"],
            view(getattr(port32, name).grad), GRAD_TOL, name)
    if update:
        u_j = new_j["batch_stats"]["SpectralNorm_0"]["Conv_0/kernel/u"]
        assert u_j.dtype == jnp.float32
        _rule(port.weight_u, u_j.reshape(-1), port32.weight_u, OUT_TOL, "u")


# ---------------------------------------------------------------------------
# the warp's bf16 plain twins against gfla_tpu's interpreted kernel
# ---------------------------------------------------------------------------

WARP_CASES = [  # k, c, d, flow scale, seed (tests/test_torch_port_ops.py)
    pytest.param(3, 8, 16, 1.5, 0, id="k3"),
    pytest.param(5, 8, 16, 1.5, 1, id="k5"),
    pytest.param(3, 8, 16, 60.0, 2, id="k3-far-flow"),
]
WARP_OUTPUTS = ("out", "d_source", "d_flow", "d_hidden_bt", "dW1s", "dW2",
                "db2")


def _warp_inputs(k, c, d, scale, seed, b=2, h=16, w=16):
    rng = np.random.RandomState(seed)
    return {n: _bf16_values(v) for n, v in dict(
        source=rng.randn(b, h, w, c), target=rng.randn(b, h, w, c),
        flow=rng.randn(b, h, w, 2) * scale, w1=rng.randn(k * k, 2 * c, d) * 0.1,
        b1=rng.randn(d) * 0.1, w2=rng.randn(d, k * k) * 0.1,
        b2=rng.randn(k * k) * 0.1, r=rng.randn(b, h, w, c)).items()}


def _jax_warp(a, k, dt):
    """gfla_tpu: the fused op's output, and jax.grad through
    `attn_warp_core` of sum(out * r), interpreted, in `dt`."""
    j = {n: jnp.asarray(v, dt) for n, v in a.items()}
    out = local_attn_warp_fused(j["source"], j["target"], j["flow"], k,
                                j["w1"], j["b1"], j["w2"], j["b2"],
                                interpret=True)
    c = a["source"].shape[-1]
    hbt = target_stream(torch.from_numpy(a["target"]).to(_tdt(dt)),
                        torch.from_numpy(a["w1"]).to(_tdt(dt)),
                        torch.from_numpy(a["b1"]).to(_tdt(dt)), k)
    args = (j["source"], j["flow"], jnp.asarray(hbt.numpy()),
            j["w1"][:, c:, :].reshape(k * k * c, -1), j["w2"], j["b2"])

    def loss(*xs):
        o = attn_warp_core(*xs, k, 0.1, True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(a["r"]))

    grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
    return [out, *grads], hbt


def _tdt(dt):
    return BF16 if dt == jnp.bfloat16 else torch.float32


def _port_warp(a, k, dt, hbt):
    """The port: local_attn_warp's output, and the gradients of
    sum(out * r) through `warp.warp_fwd` (WarpFunction, plain twins)."""
    t = {n: torch.from_numpy(v).to(dt) for n, v in a.items()}
    out = local_attn_warp(t["source"], t["target"], t["flow"], k, t["w1"],
                          t["b1"], t["w2"], t["b2"])
    c = a["source"].shape[-1]
    xs = [t["source"], t["flow"], hbt.clone(),
          t["w1"][:, c:, :].reshape(k * k * c, -1), t["w2"], t["b2"]]
    xs = [x.detach().requires_grad_() for x in xs]
    (warp.warp_fwd(*xs, k).float() * torch.from_numpy(a["r"])).sum(
        ).backward()
    return [out, *(x.grad for x in xs)]


@pytest.mark.parametrize("k,c,d,scale,seed", WARP_CASES)
def test_warp_bf16_matches_pallas_kernel_interpreted(k, c, d, scale, seed):
    a = _warp_inputs(k, c, d, scale, seed)
    ref32, hbt32 = _jax_warp(a, k, jnp.float32)
    ref, hbt = _jax_warp(a, k, jnp.bfloat16)
    port = _port_warp(a, k, BF16, hbt)
    assert hbt.dtype == hbt32.dtype == torch.float32
    for name, p, r, f in zip(WARP_OUTPUTS, port, ref, ref32):
        assert str(p.dtype).removeprefix("torch.") == str(r.dtype), name
        _rule(p, r, f, OUT_TOL if name in ("out", "d_source") else GRAD_TOL,
              name)


def test_warp_f32_mode_is_unchanged_by_the_bf16_points():
    """A float32 source runs the same plain twin as before: the rounding
    points are no-ops, and float64 stays float64."""
    a = _warp_inputs(3, 8, 16, 1.5, 3)
    for dt in (torch.float32, torch.float64):
        t = {n: torch.from_numpy(v).to(dt) for n, v in a.items()}
        hbt = target_stream(t["target"], t["w1"], t["b1"], 3)
        w1s = t["w1"][:, 8:, :].reshape(72, 16)
        out, hpre = warp.warp_fwd_plain(t["source"], t["flow"], hbt, w1s,
                                        t["w2"], t["b2"], 3, with_hpre=True)
        assert out.dtype == hpre.dtype == dt
        grads = warp.warp_bwd_plain(t["source"], t["flow"], hbt, w1s,
                                    t["w2"], t["b2"], t["r"], 3)
        assert {g.dtype for g in grads} == {dt}


def test_warp_bf16_rounds_where_gfla_tpu_does():
    """The bf16 twin's blocks, hidden layer and attention weights are bf16
    values, and its output is bf16; the f32 hpre is not rounded."""
    a = _warp_inputs(3, 8, 16, 1.5, 4)
    t = {n: torch.from_numpy(v).to(BF16) for n, v in a.items()}
    hbt = target_stream(t["target"], t["w1"], t["b1"], 3)
    w1s = t["w1"][:, 8:, :].reshape(72, 16)
    out, hpre = warp.warp_fwd_plain(t["source"], t["flow"], hbt, w1s,
                                    t["w2"], t["b2"], 3, with_hpre=True)
    assert out.dtype == BF16 and hpre.dtype == torch.float32
    assert not torch.equal(hpre, hpre.to(BF16).float())
    blocks = warp._blocks(t["source"], t["flow"], 3)
    assert blocks.dtype == torch.float32
    assert torch.equal(blocks, blocks.to(BF16).float())
    d_hpre = warp.warp_bwd_pos_plain(t["source"], t["flow"], hbt, w1s,
                                     t["w2"], t["b2"], t["r"], 3)[2]
    assert torch.equal(d_hpre, d_hpre.to(BF16).float())


# ---------------------------------------------------------------------------
# ExtractorAttn, the generator and the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("k", [3, 5])
def test_extractor_attn_bf16_matches_flax(k, route, monkeypatch):
    """The composite route against flax's ExtractorAttn (gfla_tpu's XLA
    composition at this width), the attention-math route against flax's
    ExtractorAttn under the same GFLA_ATTN_PALLAS=1 (gfla_tpu's
    `attn_math_fused`, interpreted), the warp route against gfla_tpu's
    Pallas kernel interpreted on the same parameters (16x16: the kernel's
    tiles need H*W a multiple of 128); each within OUT_TOL."""
    monkeypatch.setenv("GFLA_ATTN_PALLAS", ROUTES[route])
    rng = np.random.RandomState(k)
    src, tgt = (_bf16_values(rng.randn(2, 16, 16, 8)) for _ in "st")
    flow = _bf16_values(rng.randn(2, 16, 16, 2) * 2)
    jmod = jattn.ExtractorAttn(k, activation="LeakyReLU")
    args = tuple(jnp.asarray(a, jnp.bfloat16) for a in (src, tgt, flow))
    params = jmod.init(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(_bf16_values(
            np.random.RandomState(3).randn(*p.shape) * 0.3)), params)
    cast = jax_precision.cast_tree(params, jnp.bfloat16)
    if route in ("composite", "attn_math"):
        want = jmod.apply({"params": cast}, *args)
    else:
        want = local_attn_warp_fused(*args, k, cast["w1"], cast["b1"],
                                     cast["w2"], cast["b2"], interpret=True)
    sd = {}
    convert._attn(params, "a", sd)
    port = attention.ExtractorAttn(8, k, "LeakyReLU")
    port.load_state_dict({n[2:]: v for n, v in sd.items()}, strict=True)
    inputs = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
              for x in (src, tgt, flow)]
    got = {dt: precision.cast_call(port, dt, *inputs).permute(0, 2, 3, 1)
           for dt in (torch.float32, BF16)}
    assert want.dtype == jnp.bfloat16
    _rule(got[BF16], want, got[torch.float32], OUT_TOL, "out")


def _opt(**over):
    """tests/test_torch_port_train.py's options, in bf16 unless asked."""
    return train_opt(**{"compute_dtype": "bfloat16", **over})


def _batch(seed):
    """tests/test_torch_port_train.py's batch, images bf16 represents."""
    return {k: _bf16_values(v) if k in ("P1", "P2") else v
            for k, v in train_batch(seed).items()}


def _noise(tree, seed):
    """Every leaf replaced by seeded noise that bf16 represents: kernels
    N(0, 1/fan_in), vectors N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        noise = rng.randn(*leaf.shape)
        if leaf.ndim >= 2:
            noise /= np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            noise *= 0.1
            if "scale" in jax.tree_util.keystr(path):
                noise += 1.0
        leaves.append(jnp.asarray(_bf16_values(noise)))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _sds(params_g, params_d, stats_d):
    return (convert.pose_generator_state_dict(jax.device_get(params_g)),
            convert.res_discriminator_state_dict(
                jax.device_get(params_d), jax.device_get(stats_d), layers=4))


@pytest.fixture(scope="module")
def bf16_step():
    """gfla_tpu's bf16 pose task: its serving forward and one step; the
    port's tasks in f32 and bf16 holding the same state before it."""
    task_j = jax_create_task(_opt())
    batch = _batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = task_j.init_state(jax.random.PRNGKey(0), jb)
    state = state.replace(params_g=_noise(state.params_g, 5),
                          params_d=_noise(state.params_d, 6))
    served = jax.device_get(task_j.test_step(state, jb))
    g_sd, d_sd = _sds(state.params_g, state.params_d, state.stats_d)
    state2, logs = task_j.train_step(state, jb)  # donates `state`
    tasks = {}
    for dt in ("float32", "bfloat16"):
        task = PoseTask(_opt(compute_dtype=dt))
        task.net_g.load_state_dict(g_sd, strict=True)
        task.net_d.load_state_dict(d_sd, strict=True)
        task.vgg.load_state_dict(convert.vgg19_state_dict(
            jax.device_get(jax_precision.to_f32(task_j.vgg_params))),
            strict=True)
        tasks[dt] = task
    assert task_j.dtype == jnp.bfloat16
    assert tasks["bfloat16"].vgg.conv1_1.weight.dtype == BF16
    return dict(served=served, state2=jax.device_get(state2),
                logs=jax.device_get(logs), tasks=tasks, batch=batch)


@pytest.mark.parametrize("route", ROUTES)
def test_pose_generator_eval_bf16_matches_gfla_tpu(bf16_step, route,
                                                   monkeypatch):
    monkeypatch.setenv("GFLA_ATTN_PALLAS", ROUTES[route])
    batch = _port_batch(bf16_step["batch"])
    got = {dt: task.test_step(batch)
           for dt, task in bf16_step["tasks"].items()}
    img_j, flows_j, masks_j = bf16_step["served"]
    assert img_j.dtype == np.float32 and got["bfloat16"][0].dtype == \
        torch.float32
    nhwc = (0, 2, 3, 1)
    pairs = [("img", got["bfloat16"][0], img_j, got["float32"][0])]
    for i in range(2):
        pairs += [(f"flow{i}", got["bfloat16"][1][i], flows_j[i],
                   got["float32"][1][i]),
                  (f"mask{i}", got["bfloat16"][2][i], masks_j[i],
                   got["float32"][2][i])]
    for name, p, r, f in pairs:
        _rule(p.permute(*nhwc), r, f.permute(*nhwc),
              IMAGE_TOL if name == "img" else FLOW_TOL, name)
    img, img_j = _f(got["bfloat16"][0].permute(*nhwc)), _f(img_j)
    assert np.linalg.norm(img - img_j) <= IMAGE_NORM_TOL * np.linalg.norm(
        img_j)


def _cos(a, b):
    a, b = (_f(x).ravel().astype(np.float64) for x in (a, b))
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb)) if na and nb else 0.0


def _norm_ratio(a, b):
    nb = np.linalg.norm(_f(b))
    return float(np.linalg.norm(_f(a)) / nb) if nb else np.inf


def _unheld(port, ref, live, floor, whole_floor, band, whole_band):
    """What of one network's bf16 values `port` is not held against
    gfla_tpu's `ref`: each tensor of `live` (those with a gradient in f32)
    whose cosine falls below `floor` or whose norm ratio leaves `band`, and
    the network's concatenated tensors by `whole_floor` and `whole_band`.
    A list of (name, cosine, norm ratio)."""
    def held(a, b, lo, band):
        c, r = _cos(a, b), _norm_ratio(a, b)
        return c >= lo and band[0] <= r <= band[1], c, r

    bad = []
    for name in live:
        ok, c, r = held(port[name], ref[name], floor, band)
        if not ok:
            bad.append((name, c, r))
    ok, c, r = held(*(np.concatenate([_f(t[n]).ravel() for n in live])
                      for t in (port, ref)), whole_floor, whole_band)
    return bad + ([] if ok else [("whole network", c, r)])


@pytest.fixture(scope="module")
def port_steps(bf16_step):
    """The port's f32 and bf16 steps from the fixture's state, on each
    route: the logs, and each network's gradients, parameters before and
    after, and buffers."""
    batch = _port_batch(bf16_step["batch"])
    steps = {}
    for route, env in ROUTES.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GFLA_ATTN_PALLAS", env)
            tasks = {dt: copy.deepcopy(t)
                     for dt, t in bf16_step["tasks"].items()}
            logs = {dt: t.train_step(batch) for dt, t in tasks.items()}
        nets = {}
        for dt, task in tasks.items():
            for tag in "GD":
                net = getattr(task, f"net_{tag.lower()}")
                before = getattr(bf16_step["tasks"][dt], f"net_{tag.lower()}")
                nets[dt, tag] = dict(
                    grad={n: p.grad for n, p in net.named_parameters()},
                    param={n: p.detach() for n, p in net.named_parameters()},
                    before={n: p.detach()
                            for n, p in before.named_parameters()},
                    buffer=dict(net.named_buffers()))
        steps[route] = dict(logs=logs, nets=nets)
    return steps


def _gfla_step(bf16_step):
    """gfla_tpu's bf16 step, per network: its gradients (optax's first
    moment after one step at beta1 = 0), its parameters and stats after."""
    state2 = bf16_step["state2"]
    after = _sds(state2.params_g, state2.params_d, state2.stats_d)
    grads = _sds(state2.opt_state_g[0].mu, state2.opt_state_d[0].mu,
                 state2.stats_d)
    return {"G": (grads[0], after[0]), "D": (grads[1], after[1])}


def _live(step, tag):
    """The tensors with a gradient in f32: a conv bias that feeds an
    instance norm has none, and bf16 gives it rounding only."""
    g32 = step["nets"]["float32", tag]["grad"]
    scale = max(g.abs().max().item() for g in g32.values())
    return [n for n, g in g32.items() if g.abs().max() > 1e-5 * scale]


# The step's bf16 gradients against gfla_tpu's bf16 gradients. A max error
# cannot hold them: through ~30 bf16 layers each framework's G gradient
# sits ~50% of its max off the f32 one, in directions the two do not share.
# Their cosines can. Readings on both routes at this set-up, G: each
# tensor's cosine 0.592-1.000 (median 0.89), norm ratio 0.497-1.828; the
# whole network 0.835 and 0.911; D: 0.991-1.000, 0.938-1.089; 0.9993 and
# 0.988. The floors and bands leave 1.2-7x of those readings' distance
# from a perfect match. A zeroed (cosine 0) or negated (below -0.5)
# tensor fails (test_train_step_hold_catches_a_planted_fault).
STEP_HOLD = {  # tag: floor, whole floor, norm band, whole norm band
    "G": (0.45, 0.7, (1 / 3, 3.0), (0.8, 1.25)),
    "D": (0.95, 0.995, (0.8, 1.25), (0.95, 1.05)),
}
# The updated parameters by their moves: Adam's first step at beta1 = 0
# moves each entry by lr x sign(gradient), so a move's cosine counts the
# signs that agree, and every norm ratio is ~1. Readings, G: 0.333-1.000
# (median 0.71), the whole network 0.654; D: 0.875-1.000, 0.975.
MOVE_HOLD = {  # tag: floor, whole floor
    "G": (0.2, 0.5),
    "D": (0.75, 0.93),
}
ANY = (0.0, np.inf)


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_bf16_matches_gfla_tpu(bf16_step, port_steps, route):
    """Losses within LOSS_REL of gfla_tpu's bf16 step; each network's
    gradients and parameter moves held against gfla_tpu's by STEP_HOLD
    and MOVE_HOLD, the gradients also by the rule's first clause on each
    network's mean over tensors against the port's f32 step, the stored u
    by the rule; the masters, their gradients and u stay f32."""
    step = port_steps[route]
    logs = step["logs"]
    for name, want in bf16_step["logs"].items():
        got = float(logs["bfloat16"][name])
        assert abs(got - float(want)) <= LOSS_REL * abs(float(want)), (
            name, got, float(want), float(logs["float32"][name]))
    gfla = _gfla_step(bf16_step)
    for tag, lr in (("G", 1e-4), ("D", 1e-5)):
        bf, f32 = step["nets"]["bfloat16", tag], step["nets"]["float32", tag]
        ref, want = gfla[tag]
        live = _live(step, tag)
        for name, p in bf["param"].items():
            assert p.dtype == bf["grad"][name].dtype == torch.float32, name
            # Adam's first step moves each entry by at most lr; + the f32
            # rounding of two such steps from parameters of up to ~4
            assert (p - want[name]).abs().max() <= 2 * lr + 1e-6, name
        bad = _unheld(bf["grad"], ref, live, *STEP_HOLD[tag])
        assert not bad, (tag, "gradients", bad)
        moves = {n: bf["param"][n] - bf["before"][n] for n in live}
        ref_moves = {n: want[n] - bf["before"][n] for n in live}
        bad = _unheld(moves, ref_moves, live, *MOVE_HOLD[tag], ANY, ANY)
        assert not bad, (tag, "moves", bad)
        errors = [_errors(bf["grad"][n], ref[n], f32["grad"][n],
                          f"{tag} {n} grad") for n in live]
        e_port, e_ref, _ = np.mean(errors, axis=0)
        assert e_port <= 2 * e_ref + SLACK, (tag, e_port, e_ref)
    d_want = gfla["D"][1]
    u32 = step["nets"]["float32", "D"]["buffer"]
    for name, u in step["nets"]["bfloat16", "D"]["buffer"].items():
        assert u.dtype == torch.float32, name
        if name.endswith("weight_u"):
            _rule(u, d_want[name], u32[name], OUT_TOL, name)


@pytest.mark.parametrize("fault", ["zeroed", "negated"])
@pytest.mark.parametrize("name", [
    "target.attn1.fully_connect_layer.0.weight",  # W1 of the k=5 warp
    "target.attn0.fully_connect_layer.2.bias",    # b2 of the k=3 warp
    "flow_net.output2.weight",                    # fed by the warp's d_flow
])
def test_train_step_hold_catches_a_planted_fault(bf16_step, port_steps,
                                                 name, fault):
    """STEP_HOLD fails a step in which one warp-fed tensor's bf16 gradient
    is zeroed or negated, and names that tensor only."""
    step = port_steps["warp"]
    grads = dict(step["nets"]["bfloat16", "G"]["grad"])
    ref = _gfla_step(bf16_step)["G"][0]
    live = _live(step, "G")
    assert name in live
    assert not _unheld(grads, ref, live, *STEP_HOLD["G"])
    grads[name] = grads[name] * (0.0 if fault == "zeroed" else -1.0)
    bad = {t[0] for t in _unheld(grads, ref, live, *STEP_HOLD["G"])}
    assert bad - {"whole network"} == {name}, bad


def test_bf16_checkpoint_resumes_into_f32_and_back(bf16_step, tmp_path):
    """A save under bf16 holds f32 masters: an f32 task resumes them
    exactly, and a bf16 task resumed from the f32 task's save takes the
    uninterrupted run's next step."""
    task = copy.deepcopy(bf16_step["tasks"]["bfloat16"])
    task.opt = _opt(checkpoints_dir=str(tmp_path), name="mixed")
    b1, b2 = _port_batch(_batch(1)), _port_batch(_batch(2))
    task.train_step(b1)
    task.save(1)
    want = task.train_step(b2)

    f32 = PoseTask(_opt(compute_dtype="float32",
                        checkpoints_dir=str(tmp_path), name="mixed"))
    f32.vgg.load_state_dict(task.vgg.state_dict())
    assert f32.resume("latest") == 1
    f32.save(1)  # back: the f32 task's own save
    back = PoseTask(_opt(checkpoints_dir=str(tmp_path), name="mixed"))
    back.vgg.load_state_dict(task.vgg.state_dict())
    assert back.resume("latest") == 1
    for a, b in zip(back.net_g.state_dict().values(),
                    f32.net_g.state_dict().values()):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    got = back.train_step(b2)
    for name in want:
        assert torch.allclose(got[name], want[name], rtol=1e-6, atol=0), name
