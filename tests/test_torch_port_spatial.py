"""The data x spatial mode (`--spatial`, `--halo`; gfla_tpu_torch.parallel's
spatial axis) on the CPU: gloo ranks, each on its row band, held against
gfla_tpu and against the same modules run whole.

Two worlds run every rank-side case once (tests/torch_port_bands.py, no
jax in the ranks, 2 torch threads a rank), in a module fixture that starts
them beside gfla_tpu's own work and bounds each at RANKS_TIMEOUT:
- 4 ranks, at S=4 (one spatial group) and then S=2 (dp 2 x sp 2);
- 2 ranks, dp 1 x sp 2: a pose SGD step, the other single-frame heads'
  steps, pose's in bf16 and with --remat, then the training CLI's loop
  (pose, and ShapeNet from the committed store).
Held:
(a) the port's halo gather (`halo_block_extract`) and the warp route on the
    band's window (`local_attn_warp`, the warp kernels' plain twins)
    against gfla_tpu's `block_extract` and local attention under
    `spatial_halo_attention(make_mesh_2d(1, S), halo=4)` on conftest's 8
    virtual CPU devices: outputs and the gradients to source and flow (and
    target) within 1e-6 of the largest |value|, with a flow past the halo
    that gfla_tpu's window clamp freezes and the unsharded gather does
    not. The test flows are multiples of 1/64: the warp kernels count a
    row from their window's first row, gfla_tpu from the image's, and only
    with exact sums do the two forms take the same fractional weights;
    otherwise they part by f32's rounding of y + flow_y, not by a clamp;
(b) the band convolutions (3x3, 4x4 stride 2, 1x1, spectral, the
    transposed 2x, Jump's reflection pad), InstanceNorm, VGG19 and
    ResDiscriminator against the same modules run whole: outputs, input
    gradients and the parameter gradients (the bands' shares summed)
    within 1e-6 of the largest |value|, and the spectral norms' u equal on
    every band;
(c) one tiny pose SGD step under dp 1 x sp 2 from one state in both
    packages (the port's seeded init, the flow heads' biases set off the
    resampler's floor kinks, carried into gfla_tpu through convert.py's
    map): against gfla_tpu's single-device step by
    tests/test_train.py::TestSpatialPartitioning's rule (total_G within
    2e-3; under 1e-4 of the entries above 1e-3 of max |g|, under 1e-6
    above 1e-2), against the port's one-rank step by the 8-vs-1 rule of
    tests/test_torch_port_parallel.py (total_G within 1e-4), with the
    parameters and u bitwise equal on both ranks;
(c') poseflownet, shapenet and shapenetflow steps under dp 1 x sp 2,
    against gfla_tpu's single-device step by the same rule and against
    the port's one rank by the 8-vs-1 rule, the ranks bitwise equal; a
    bf16 pose step against gfla_tpu's bf16 step and the port's one-rank
    bf16 step by test_torch_port_bf16.py's STEP_HOLD (`_bf16_held`); a
    --remat step against the same step without it, with as many
    collectives on each rank; the band modules in bf16 against the whole
    modules in bf16 (`_beside_bf16`);
(d) the options: `--spatial` accepted for pose, poseflownet, shapenet and
    shapenetflow, in bf16 and with --remat, refused with gfla_tpu's two
    messages where S does not divide the rank count or the load size,
    refused per level (ShapeNet's 8-row seed among them), for dance, face
    and keypoint naming their ROADMAP item; a world without `--spatial`
    unchanged; GFLA_HALO_DEBUG;
and the training CLI's loop under `--gpu_ids=-1 --mesh_devices=2
--spatial=2` (evaluation and visuals gathered from the bands): one set of
checkpoints and one loss log, and a `--continue_train` run that takes the
next step; ShapeNet's stage 1 and stage 2 from tests/fixtures/shapenet_car.
"""

import argparse
import concurrent.futures
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import test_torch_port_bf16 as bf16_rule
import torch_port_bands as bands
from gfla_tpu.ops.block_extract import block_extract as jax_block_extract
from gfla_tpu.ops.local_attn import local_attn_warp as jax_local_attn
from gfla_tpu.parallel import make_mesh_2d, spatial_halo_attention
from gfla_tpu.tasks import create_task as jax_create_task
from gfla_tpu.train.state import GANTrainState
from gfla_tpu_torch import convert, parallel
from gfla_tpu_torch.nn import norms
from gfla_tpu_torch.ops import block_extract as port_block_extract
from gfla_tpu_torch.options import (
    TrainOptions,
    refuse_parallel_flags,
    spatial_layout,
)
from gfla_tpu_torch.tasks import create_task

RANKS_TIMEOUT = 300  # s, each world: as tests/test_torch_port_parallel.py
REL = 1e-6
BF16_BANDS, BF16_SLACK = 2.0, 2 ** -8
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads here and in each spawned rank: the other test
    workers share these cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    yield
    torch.set_num_threads(n)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


def _nhwc(t):
    return jnp.asarray(t.permute(0, 2, 3, 1).numpy())


def _carried(shapes, to_port, port_sd):
    """gfla_tpu's trees of `shapes` (ShapeDtypeStructs) holding the port's
    state dict `port_sd`. convert.py's map from gfla_tpu's trees to the
    port's keys moves each element once (transposes, flips, the tied
    alias), but for the derived `weight_v`: fed each element's index, it
    says where each of the port's elements goes. flax's spectral-norm
    `sigma`, a record of the last call's that no call reads, is left at
    its init, 1."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    sizes = [int(np.prod(leaf.shape)) for _, leaf in leaves]
    starts = np.cumsum([0] + sizes)
    ids = [np.arange(a, a + n, dtype=np.float64).reshape(leaf.shape)
           for a, n, (_, leaf) in zip(starts, sizes, leaves)]
    flat = np.full(starts[-1], np.nan, np.float32)
    for key, where in to_port(treedef.unflatten(ids)).items():
        if not key.endswith("weight_v"):
            flat[where.numpy().astype(np.int64).ravel()] = \
                port_sd[key].numpy().ravel()
    out = []
    for (path, leaf), a, n in zip(leaves, starts, sizes):
        values = flat[a:a + n].reshape(leaf.shape)
        if jax.tree_util.keystr(path).endswith("/sigma']"):
            values = np.ones_like(values)
        assert not np.isnan(values).any(), jax.tree_util.keystr(path)
        out.append(jnp.asarray(values))
    return treedef.unflatten(out)


# gfla_tpu's G tree -> the port's state dict, for each head at
# torch_port_bands.py's sizes
G_STATE = {
    "pose": convert.pose_generator_state_dict,
    "poseflownet": convert.poseflownet_state_dict,
    "shapenet": functools.partial(convert.shapenet_generator_state_dict,
                                  layers=1, attn_layer=(1,)),
    "shapenetflow": functools.partial(convert.shapenetflow_state_dict,
                                      attn_layer=(1,)),
}


def _jax_batch(model):
    return {k: _nhwc(v) if v.dim() == 4 else jnp.asarray(v.numpy())
            for k, v in bands.step_batch(model).items()}


def _sgd_jax_task(model, **over):
    task = jax_create_task(bands.step_opt(model, **over))
    task.tx_g = optax.sgd(chip_smoke.DP_SGD_LR)
    task.tx_d = optax.sgd(chip_smoke.DP_SGD_LR)
    return task


def _gfla_tpu_state(model, state_dir):
    """The port's tiny task of `model` at its seeded init, the flow heads'
    biases set off the floor kinks of the warp and the resampler
    (chip_smoke.off_the_kinks), saved at `{state_dir}/{model}.pt` with
    gfla_tpu's VGG19; gfla_tpu's task with SGD and the same state, carried
    through convert.py (`_carried`; no init of gfla_tpu's runs). Returns
    (task, state, batch, host copies of the state's G and D parameters and
    D's spectral stats)."""
    port = chip_smoke.off_the_kinks(create_task(bands.step_opt(model), CPU))
    sds = {tag: net.state_dict()
           for tag, net in chip_smoke.nets(port).items()}
    task = _sgd_jax_task(model)
    batch = _jax_batch(model)
    semantic = getattr(task, "_semantic", lambda b: b)  # ShapeNet's codes
    shapes = jax.eval_shape(lambda r, b: task._init_state_impl(
        r, semantic(b)), jax.random.PRNGKey(0), batch)
    d_layers = bands.step_opt(model).d_layers
    params_g = _carried(shapes.params_g, G_STATE[model], sds["G"])
    params_d, stats_d = {}, {}
    if "D" in sds:
        params_d, stats_d = _carried(
            (shapes.params_d, shapes.stats_d),
            lambda t: convert.res_discriminator_state_dict(*t, d_layers),
            sds["D"])
    get = jax.device_get
    torch.save({**sds, "VGG": convert.vgg19_state_dict(
        get(task.vgg_params))}, os.path.join(state_dir, f"{model}.pt"))
    return task, batch, get((params_g, params_d, stats_d))


def _bf16_state(state_dir, host):
    """Pose's state with G's and D's parameters replaced by the seeded
    noise of tests/test_torch_port_bf16.py (`_noise`), saved at
    `{state_dir}/pose_bf16.pt`; its host copies. From the seeded init G's
    gradient is nearly all the output conv's bias, whose bf16 sum over the
    image the two frameworks round apart (a norm 0.59 x f32's in gfla_tpu,
    0.99 x in the port), so no per-network hold could read it; the noise
    is where tests/test_torch_port_bf16.py reads its STEP_HOLD."""
    p_g, p_d, stats_d = host
    p_g, p_d = (jax.device_get(bf16_rule._noise(t, seed))
                for t, seed in ((p_g, 5), (p_d, 6)))
    state = torch.load(os.path.join(state_dir, "pose.pt"), weights_only=True)
    state["G"] = G_STATE["pose"](p_g)
    state["D"] = convert.res_discriminator_state_dict(
        p_d, stats_d, bands.step_opt().d_layers)
    torch.save(state, os.path.join(state_dir, "pose_bf16.pt"))
    return p_g, p_d, stats_d


def _gfla_tpu_step(model, task, batch, host):
    """gfla_tpu's single-device step on the whole batch, from `host`:
    (logs, G's and D's gradients by name, as the port's state dict)."""
    get = jax.device_get
    p_g, p_d, stats_d = host
    state = GANTrainState.create(
        params_g=jax.tree_util.tree_map(jnp.asarray, p_g),
        params_d=jax.tree_util.tree_map(jnp.asarray, p_d), stats_g={},
        stats_d=jax.tree_util.tree_map(jnp.asarray, stats_d),
        tx_g=task.tx_g, tx_d=task.tx_d)
    d_layers = bands.step_opt(model).d_layers
    after, logs = task.train_step(state, batch)  # donates `state`
    lr = chip_smoke.DP_SGD_LR
    grads = {"G": _trained(G_STATE[model](jax.tree_util.tree_map(
        lambda a, b: (a - b) / lr, p_g, get(after.params_g))))}
    if p_d:
        grads["D"] = _trained(convert.res_discriminator_state_dict(
            jax.tree_util.tree_map(lambda a, b: (a - b) / lr, p_d,
                                   get(after.params_d)), stats_d, d_layers))
    return {k: float(v) for k, v in get(logs).items()}, grads


def _trained(state_dict):
    """The entries of a state dict that the port's `named_parameters`
    name: without the spectral norms' `weight_u` and `weight_v`, and
    without `model.2`, the alias under which Jump's and Output's
    `nn.Sequential` hold their tied conv1."""
    return {k: v for k, v in state_dict.items()
            if not k.endswith(("weight_u", "weight_v"))
            and not re.search(r"(jump\d+|outconv)\.model\.2\.", k)}


def _jax_both(k):
    """A fresh function (jit caches its trace by the function, and the
    halo mesh is read when tracing) of the gather's and the attention's
    outputs and gradients under the cotangents."""
    def both(x):
        g, vjp = jax.vjp(lambda s, f: jax_block_extract(s, f, k),
                         x["source"], x["flow"])
        ds, df = vjp(x["cot_gather"])
        a, vjp = jax.vjp(
            lambda s, t, f: jax_local_attn(
                s, t, f, k, x["w1"], x["b1"], x["w2"], x["b2"],
                use_pallas=False),
            x["source"], x["target"], x["flow"])
        das, dat, daf = vjp(x["cot_attn"])
        return {"gather": {"out": g, "d_source": ds, "d_flow": df},
                "warp": {"out": a, "d_source": das, "d_target": dat,
                         "d_flow": daf}}
    return jax.jit(both)


def _jax_attn(size):
    """gfla_tpu's gather and local attention (its XLA composition, the path
    it takes under the spatial mesh) under the halo gathers of a (1, size)
    mesh, with their gradients; with the first size, also without the
    mesh."""
    mesh = make_mesh_2d(1, size)
    out = {}
    for name, k, _ in bands.ATTN_CASES:
        x = {n: jnp.asarray(v.numpy())
             for n, v in bands.attn_inputs(name).items()}
        with spatial_halo_attention(mesh, halo=bands.HALO):
            out[name] = _jax_both(k)(x)
        if size == bands.SPATIAL[0]:
            out[name]["unsharded"] = _jax_both(k)(x)
    return jax.device_get(out)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results by rank, and gfla_tpu's: the 4-rank world
    starts at once, the 2-rank one once gfla_tpu's states are saved for
    it; gfla_tpu's steps (each head's in f32, pose's in bf16) and
    attention run while they do."""
    out = tmp_path_factory.mktemp("bands")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        modules = pool.submit(parallel.spawn, bands.module_bands, [CPU] * 4,
                              str(out), timeout=RANKS_TIMEOUT)
        try:
            jax_states = {m: _gfla_tpu_state(m, out) for m in bands.HEADS}
            _, batch, host = jax_states["pose"]
            noised = _bf16_state(out, host)
            steps = pool.submit(parallel.spawn, bands.step_bands, [CPU] * 2,
                                str(out), str(out), timeout=RANKS_TIMEOUT)
            step = {m: _gfla_tpu_step(m, *jax_states[m])
                    for m in bands.HEADS}
            step["pose_bf16"] = _gfla_tpu_step(
                "pose", _sgd_jax_task("pose", compute_dtype="bfloat16"),
                batch, noised)
            attn = {size: _jax_attn(size) for size in bands.SPATIAL}
            for name, case in attn[bands.SPATIAL[0]].items():
                for size in bands.SPATIAL[1:]:
                    attn[size][name]["unsharded"] = case["unsharded"]
        finally:
            modules.result()
        steps.result()
    return {"bands": [torch.load(out / f"bands_rank{r}.pt",
                                 weights_only=False) for r in range(4)],
            "step": [torch.load(out / f"step_rank{r}.pt",
                                weights_only=False) for r in range(2)],
            "gfla_tpu_step": step["pose"], "gfla_tpu_steps": step,
            "gfla_tpu_attn": attn, "state_dir": out,
            "state_path": out / "pose.pt", "ckpt": out / "ckpt" / "sp",
            "views": out / "ckpt" / "views"}


@pytest.fixture(scope="module")
def one_rank(worlds):
    """The port's steps of torch_port_bands.STEPS on the whole batch, as
    one rank."""
    one = {name: bands.sgd_step(worlds["state_dir"] / f"{state}.pt",
                                model=model, **over)
           for name, model, state, over in bands.STEPS}
    # which tensors have a gradient in f32 (the bf16 rule's live ones)
    one["pose_bf16_f32"] = bands.sgd_step(worlds["state_dir"]
                                          / "pose_bf16.pt")
    return one


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:g} x {scale:.3e}"


def _group(worlds, size):
    """The results of rank 0's spatial group at S=`size`, in band order;
    at S=2 the second group's (the same rows) held bitwise equal to it."""
    res = [r[size] for r in worlds["bands"]]
    assert [r["band"] for r in res] == [i % size for i in range(4)]
    for i in range(size, 4):
        a, b = res[i - size], res[i]
        for case in ("attn", "modules", "modules_bf16"):
            flat_a = _flatten(a[case])
            flat_b = _flatten(b[case])
            assert flat_a.keys() == flat_b.keys()
            for k in flat_a:
                assert torch.equal(flat_a[k], flat_b[k]), (size, k)
    return res[:size]


def _flatten(tree, prefix=""):
    if torch.is_tensor(tree):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}.{k}"))
    return out


def _whole(parts, dim):
    return torch.cat(parts, dim).numpy()


# --- (a) the halo gather and the warp on the window -------------------------

@pytest.mark.parametrize("size", bands.SPATIAL)
@pytest.mark.parametrize("name", [c[0] for c in bands.ATTN_CASES])
def test_halo_gather_and_warp_window_match_gfla_tpu(worlds, size, name):
    """Each band result within 1e-6 of the largest |value| of gfla_tpu's
    halo result, beyond the port's own distance from gfla_tpu on the
    whole image (the same function in another summation order: 2e-7 of
    the warp's flow gradient at k=5)."""
    group = _group(worlds, size)
    want = worlds["gfla_tpu_attn"][size][name]
    whole = bands.attn_case(name)
    for route in ("gather", "warp"):
        for key, ref in want[route].items():
            got = _whole([g["attn"][name][route][key] for g in group], 1)
            own = float(np.abs(whole[route][key].numpy()
                               - want["unsharded"][route][key]).max())
            _close(got, ref, f"S={size} {name} {route} {key}",
                   REL + own / max(float(np.abs(ref).max()), 1e-30))
    got = _whole([g["attn"][name]["gather"]["out"] for g in group], 1)
    unsharded = want["unsharded"]["gather"]["out"]
    if name.endswith("_far"):  # the window clamp froze the far rows
        assert np.abs(got - unsharded).max() > 1e-2
        for b in range(2):
            rows = [r for r in range(bands.ATTN_H) if b or r not in (5, 10)]
            np.testing.assert_allclose(got[b, rows], unsharded[b, rows],
                                       rtol=0, atol=1e-6)


# --- (b) band modules against the whole -------------------------------------

@pytest.fixture(scope="module")
def whole_modules():
    """Each module run whole, in f32 and in f64."""
    return {name: (bands.module_case(name),
                   bands.module_case(name, dtype=torch.float64))
            for name in bands.MODULES}


def _beside_f64(got, f32, f64, what):
    """`got` (the bands' result) no further from the f64 result than the
    whole module's f32 result is, plus 1e-6 of the largest |value|: the
    bands add no error but f32's rounding in another summation order."""
    got, f32, f64 = (np.asarray(t, np.float64) for t in (got, f32, f64))
    assert got.shape == f64.shape, (what, got.shape, f64.shape)
    own = float(np.abs(f32 - f64).max())
    err = float(np.abs(got - f64).max())
    bound = own + REL * float(np.abs(f64).max())
    assert err <= bound, f"{what}: {err:.3e} > {own:.3e} + {REL:g} x max"


@pytest.mark.parametrize("size", bands.SPATIAL)
@pytest.mark.parametrize("name", bands.MODULES)
def test_band_modules_match_whole(worlds, whole_modules, size, name):
    group = [g["modules"][name] for g in _group(worlds, size)]
    f32, f64 = whole_modules[name]
    for key in f32["outs"]:
        _beside_f64(_whole([g["outs"][key] for g in group], 2),
                    f32["outs"][key], f64["outs"][key],
                    f"S={size} {name} {key}")
    _beside_f64(_whole([g["d_input"] for g in group], 2), f32["d_input"],
                f64["d_input"], f"S={size} {name} d_input")
    assert group[0]["d_params"].keys() == f32["d_params"].keys()
    for key in f32["d_params"]:
        _beside_f64(sum(g["d_params"][key] for g in group),
                    f32["d_params"][key], f64["d_params"][key],
                    f"S={size} {name} d_{key}")
    for key in f32["u"]:
        assert all(torch.equal(g["u"][key], group[0]["u"][key])
                   for g in group), key
        _beside_f64(group[0]["u"][key], f32["u"][key], f64["u"][key],
                    f"S={size} {name} {key}")


@pytest.fixture(scope="module")
def whole_bf16():
    """Each module of BF16_MODULES run whole in bf16."""
    return {name: bands.module_case(name, dtype=torch.bfloat16)
            for name in bands.BF16_MODULES}


def _beside_bf16(got, bf16, f64, what):
    """`got` (the bands' bf16 result) no further from the f64 result than
    BF16_BANDS x the whole module's bf16 result is, plus BF16_SLACK of the
    largest |value|: the bands' bf16 rounding falls elsewhere than the
    whole module's, but adds no more of it."""
    got, bf16, f64 = (np.asarray(torch.as_tensor(t).double(), np.float64)
                      for t in (got, bf16, f64))
    assert got.shape == f64.shape, (what, got.shape, f64.shape)
    own = float(np.abs(bf16 - f64).max())
    err = float(np.abs(got - f64).max())
    bound = BF16_BANDS * own + BF16_SLACK * float(np.abs(f64).max())
    assert err <= bound, f"{what}: {err:.3e} > {BF16_BANDS} x {own:.3e} + " \
        f"{BF16_SLACK:g} x max"


@pytest.mark.parametrize("size", bands.SPATIAL)
@pytest.mark.parametrize("name", bands.BF16_MODULES)
def test_band_modules_bf16_match_whole(worlds, whole_modules, whole_bf16,
                                       size, name):
    """The band modules in bf16 against the same modules run whole in
    bf16: outputs, input gradients and the parameter gradients (the bands'
    shares summed) by `_beside_bf16`, and u equal on every band and as
    near the f64 u."""
    group = [g["modules_bf16"][name] for g in _group(worlds, size)]
    bf16, f64 = whole_bf16[name], whole_modules[name][1]
    for key in bf16["outs"]:
        _beside_bf16(_whole([g["outs"][key].float() for g in group], 2),
                     bf16["outs"][key], f64["outs"][key],
                     f"S={size} {name} {key}")
    _beside_bf16(_whole([g["d_input"].float() for g in group], 2),
                 bf16["d_input"], f64["d_input"], f"S={size} {name} d_input")
    assert group[0]["d_params"].keys() == bf16["d_params"].keys()
    for key in bf16["d_params"]:
        assert all(g["d_params"][key].dtype == torch.bfloat16
                   for g in group)
        _beside_bf16(sum(g["d_params"][key].float() for g in group),
                     bf16["d_params"][key], f64["d_params"][key],
                     f"S={size} {name} d_{key}")
    for key in bf16["u"]:
        assert all(torch.equal(g["u"][key], group[0]["u"][key])
                   for g in group), key
        _beside_bf16(group[0]["u"][key], bf16["u"][key], f64["u"][key],
                     f"S={size} {name} {key}")


# --- (c) one pose step under dp 1 x sp 2 -------------------------------------

def test_spatial_step_matches_gfla_tpu(worlds):
    """gfla_tpu's rule for its 2 x 4 spatial step against one device
    (tests/test_train.py:334-357), on G and on D."""
    logs, grads = worlds["gfla_tpu_step"]
    got = worlds["step"][0]["step"]
    np.testing.assert_allclose(got["logs"]["total_G"], logs["total_G"],
                               rtol=2e-3)
    for tag, want in grads.items():
        have = got["grads"][tag]
        assert set(have) == set(want), (tag, set(have) ^ set(want))
        g1 = torch.cat([want[k].flatten() for k in sorted(have)]).double()
        g2 = torch.cat([have[k].flatten() for k in sorted(have)]).double()
        d = (g1 - g2).abs() / max(1e-6, g1.abs().max().item())
        assert (d > 1e-3).double().mean().item() < 1e-4, tag
        assert (d > 1e-2).double().mean().item() < 1e-6, tag


def test_spatial_step_matches_one_rank(worlds):
    one = bands.sgd_step(worlds["state_path"])
    got = [r["step"] for r in worlds["step"]]
    assert got[0]["logs"] == got[1]["logs"]
    assert got[0]["logs"].keys() == one["logs"].keys()
    np.testing.assert_allclose(got[0]["logs"]["total_G"],
                               one["logs"]["total_G"], rtol=1e-4)
    for tag, want in one["grads"].items():
        for name, g in got[0]["grads"][tag].items():
            assert torch.equal(g, got[1]["grads"][tag][name]), (tag, name)
        chip_smoke.dp_rule(f"spatial {tag}", want, got[0]["grads"][tag])


def test_spatial_replicas_bitwise_equal(worlds):
    a, b = (r["step"]["replica"] for r in worlds["step"])
    assert a.keys() == b.keys()
    assert sum(k.endswith("weight_u") for k in a) >= 7  # D's convs
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- (c') the other heads, bf16 and --remat under dp 1 x sp 2 ---------------

def _spatial_rule(want, have, tag):
    """gfla_tpu's spatial rule (tests/test_train.py:334-357) on one
    network's gradients."""
    assert set(have) == set(want), (tag, set(have) ^ set(want))
    g1 = torch.cat([want[k].flatten() for k in sorted(have)]).double()
    g2 = torch.cat([have[k].flatten() for k in sorted(have)]).double()
    d = (g1 - g2).abs() / max(1e-6, g1.abs().max().item())
    assert (d > 1e-3).double().mean().item() < 1e-4, tag
    assert (d > 1e-2).double().mean().item() < 1e-6, tag


@pytest.mark.parametrize("head", ["poseflownet", "shapenet", "shapenetflow"])
def test_spatial_head_step_matches_gfla_tpu(worlds, head):
    """Each head's step on two bands against gfla_tpu's single-device step
    by its spatial rule (total_G within 2e-3, the gradients' shares),
    on G and, for shapenet, on D."""
    logs, grads = worlds["gfla_tpu_steps"][head]
    got = worlds["step"][0][head]
    assert got["logs"].keys() == logs.keys()
    np.testing.assert_allclose(got["logs"]["total_G"], logs["total_G"],
                               rtol=2e-3)
    assert set(grads) == ({"G", "D"} if head == "shapenet" else {"G"})
    for tag, want in grads.items():
        have = got["grads"][tag]
        for name in set(want) - set(have):  # a mask head: no stage-1 loss
            assert ".mask" in name and not want[name].abs().max(), name
        _spatial_rule({k: want[k] for k in have}, have, f"{head} {tag}")


@pytest.mark.parametrize("head", ["poseflownet", "shapenet", "shapenetflow"])
def test_spatial_head_step_matches_one_rank(worlds, one_rank, head):
    """... and against the port's one-rank step by the 8-vs-1 rule, every
    rank's logs, gradients, parameters and u bitwise equal."""
    one = one_rank[head]
    got = [r[head] for r in worlds["step"]]
    assert got[0]["logs"] == got[1]["logs"]
    np.testing.assert_allclose(got[0]["logs"]["total_G"],
                               one["logs"]["total_G"], rtol=1e-4)
    for tag, want in one["grads"].items():
        for name, g in got[0]["grads"][tag].items():
            assert torch.equal(g, got[1]["grads"][tag][name]), (tag, name)
        chip_smoke.dp_rule(f"spatial {head} {tag}", want,
                           got[0]["grads"][tag])
    a, b = got[0]["replica"], got[1]["replica"]
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def _bf16_held(got, want, f32):
    """The bf16 step rule of tests/test_torch_port_bf16.py (STEP_HOLD:
    per-tensor cosine and norm ratio, and the network's whole, on the
    tensors with a gradient in `f32`, the port's one-rank f32 step) of
    `got` against `want`, on each network. A tensor or network it does not
    hold passes if the same hold holds `got` against `f32`: the reference's
    own bf16 rounding took it there. (gfla_tpu's bf16 gradients of biases
    summed over the whole image, XLA's reductions in bf16, land at 0.59 x
    the f32 norm at the output conv and at D's first block; the port sums
    them in f32, at 0.99-1.00 x.) A one-element gradient (a flow net's
    mask-head bias, a sum over every position that cancels to nearly 0,
    whose sign bf16 rounding decides) has a cosine of +-1 and is held in
    the network's whole only, as chip_smoke's bf16 rule holds it
    (`one_element`)."""
    for tag, g32 in f32.items():
        scale = max(g.abs().max().item() for g in g32.values())
        live = [n for n, g in g32.items() if g.abs().max() > 1e-5 * scale]
        hold = bf16_rule.STEP_HOLD[tag]
        near_f32 = {b[0] for b in bf16_rule._unheld(got[tag], g32, live,
                                                     *hold)}
        bad = [b for b in bf16_rule._unheld(got[tag], want[tag], live,
                                            *hold)
               if b[0] in near_f32 and (b[0] == "whole network"
                                        or got[tag][b[0]].numel() > 1)]
        assert not bad, (tag, bad)


def test_spatial_bf16_step_matches_gfla_tpu(worlds, one_rank):
    """--compute_dtype=bfloat16 on two bands against gfla_tpu's bf16
    single-device step: each loss within the bf16 rule's LOSS_REL of
    gfla_tpu's, plus 1e-6 of total_G (at this init the flows are nearly
    affine, and the regularisation, 2e-14 to 4e-9 in the two packages, is
    bf16 rounding alone), the gradients by its per-tensor cosine and
    norm-ratio hold; the f32 masters' gradients stay f32."""
    logs, grads = worlds["gfla_tpu_steps"]["pose_bf16"]
    got = worlds["step"][0]["pose_bf16"]
    floor = 1e-6 * abs(logs["total_G"])
    for name, want in logs.items():
        assert abs(got["logs"][name] - want) <= \
            bf16_rule.LOSS_REL * abs(want) + floor, \
            (name, got["logs"][name], want)
    for tag, g in got["grads"].items():
        assert all(t.dtype == torch.float32 for t in g.values()), tag
    _bf16_held(got["grads"], grads, one_rank["pose_bf16_f32"]["grads"])


def test_spatial_bf16_step_matches_one_rank(worlds, one_rank):
    """... and against the port's one-rank bf16 step by the same hold, the
    ranks bitwise equal."""
    one = one_rank["pose_bf16"]
    got = [r["pose_bf16"] for r in worlds["step"]]
    assert got[0]["logs"] == got[1]["logs"]
    np.testing.assert_allclose(got[0]["logs"]["total_G"],
                               one["logs"]["total_G"],
                               rtol=bf16_rule.LOSS_REL)
    a, b = got[0]["replica"], got[1]["replica"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    _bf16_held(got[0]["grads"], one["grads"],
               one_rank["pose_bf16_f32"]["grads"])


def test_spatial_remat_step_is_the_step_without_it(worlds):
    """--remat on two bands: the step's logs and gradients within 1e-6 of
    the largest |value| of the same step without it, u bitwise equal; the
    recomputation issues the forward's collectives again, as many on each
    rank."""
    for rank in worlds["step"]:
        plain, remat = rank["step"], rank["pose_remat"]
        for name, want in plain["logs"].items():
            assert abs(remat["logs"][name] - want) <= REL * abs(want), name
        for tag, want in plain["grads"].items():
            scale = max(g.abs().max().item() for g in want.values())
            assert remat["grads"][tag].keys() == want.keys()
            for name, g in want.items():
                err = (remat["grads"][tag][name] - g).abs().max().item()
                assert err <= REL * scale, (tag, name, err)
        us = [k for k in plain["replica"] if k.endswith("weight_u")]
        assert len(us) >= 7
        for k in us:
            assert torch.equal(remat["replica"][k], plain["replica"][k]), k
    counts = [r["pose_remat"]["collectives"] for r in worlds["step"]]
    plain = [r["step"]["collectives"] for r in worlds["step"]]
    assert counts[0] == counts[1] and plain[0] == plain[1]
    assert counts[0] > plain[0]


# --- the training CLI -------------------------------------------------------

def test_training_cli_spatial_writes_one_set_and_resumes(worlds):
    """The loop of `--gpu_ids=-1 --mesh_devices=2 --spatial=2`: one
    evaluated, displayed step and its checkpoints, then a --continue_train
    run that resumes at 1 and takes step 2 (an unresumed run would log
    step 1 again)."""
    assert [r["cli"] for r in worlds["step"]] == [0, 0]
    assert [r["resume"] for r in worlds["step"]] == [0, 0]
    run = worlds["ckpt"]
    assert sorted(p.name for p in run.glob("*_net_*.pth")) == [
        "1_net_D.pth", "1_net_G.pth", "2_net_D.pth", "2_net_G.pth",
        "latest_net_D.pth", "latest_net_G.pth"]
    log = (run / "loss_log.txt").read_text().splitlines()
    steps = [line.split(",")[1] for line in log if line.startswith("(epoch:")]
    assert steps == [" iters: 1", " iters: 2"]
    assert sum(line.startswith("=====") for line in log) == 2
    evals = (run / "eval_log.txt").read_text().splitlines()
    assert len(evals) == 1 and "ssim:" in evals[0]
    images = sorted(p.name for p in (run / "web" / "images").iterdir())
    assert "iter00000001_flow_field1.png" in images
    assert "iter00000001_img_gen.png" in images


def test_training_cli_spatial_trains_shapenet_from_the_store(worlds):
    """ShapeNet from the committed store under `--spatial=2`: a stage-1
    shapenetflow step writes G alone; `--model=shapenet --continue_train`
    resumes at 1 on its flow net and takes step 2, evaluated on the
    held-out view and displayed, each gathered from the bands."""
    assert [r["views_flow"] for r in worlds["step"]] == [0, 0]
    assert [r["views"] for r in worlds["step"]] == [0, 0]
    run = worlds["views"]
    assert sorted(p.name for p in run.glob("*_net_*.pth")) == [
        "1_net_G.pth", "2_net_D.pth", "2_net_G.pth", "latest_net_D.pth",
        "latest_net_G.pth"]
    lines = [line for line in (run / "loss_log.txt").read_text()
             .splitlines() if line.startswith("(epoch:")]
    assert [line.split(",")[1] for line in lines] == [" iters: 1",
                                                      " iters: 2"]
    assert "correctness:" in lines[0] and "dis_img_gen:" in lines[1]
    evals = (run / "eval_log.txt").read_text().splitlines()
    assert len(evals) == 1 and "iters: 2" in evals[0] and "ssim:" in evals[0]
    images = sorted(p.name for p in (run / "web" / "images").iterdir())
    assert "iter00000002_img_gen.png" in images
    assert "iter00000002_flow_field0.png" in images


# --- (d) the options ---------------------------------------------------------

def _train_opt(*args):
    return TrainOptions().parse(["--gpu_ids=-1", "--dataset_mode=synthetic",
                                 *args], save=False, show=False)


def test_spatial_accepted_for_pose():
    for load, ranks, sp in ((64, 2, 2), (256, 4, 2), (256, 4, 4),
                            (256, 8, 4)):
        opt = _train_opt(f"--load_size={load}", f"--spatial={sp}",
                         "--batchSize=2")
        refuse_parallel_flags(opt)
        assert spatial_layout(opt, ranks, ranks) == sp


def test_training_cli_main_starts_the_spatial_ranks(monkeypatch, capsys,
                                                   tmp_path):
    """`main` with --mesh_devices=2 --spatial=2 hands its two CPU devices
    to parallel.spawn (recorded here, not started)."""
    import gfla_tpu_torch.train.__main__ as train_cli

    calls = []
    monkeypatch.setattr(parallel, "spawn",
                        lambda fn, devices, opt: calls.append((devices, opt)))
    assert train_cli.main(["--gpu_ids=-1", "--mesh_devices=2",
                           "--spatial=2", "--dataset_mode=synthetic",
                           "--load_size=64", "--batchSize=1",
                           f"--checkpoints_dir={tmp_path}"]) == 0
    (devices, opt), = calls
    assert devices == [CPU, CPU] and opt.spatial == 2 and opt.halo == 8
    assert "2 ranks on ['cpu', 'cpu'], 1 rows each" in capsys.readouterr().out


@pytest.mark.parametrize("args,ranks,message", [
    (("--spatial=2",), 3, "--spatial 2 must divide the device count 3"),
    (("--spatial=3", "--load_size=64"), 3,
     "--spatial 3 must divide the image height 64"),
    (("--spatial=4", "--load_size=64"), 4,
     "--spatial 4: the flow net's level 4 has 4 rows"),
    (("--spatial=2", "--load_size=32"), 2,
     "--spatial 2: the flow net's level 4 has 2 rows"),
])
def test_spatial_refused_with_gfla_tpus_checks(args, ranks, message):
    opt = _train_opt("--batchSize=4", *args)
    with pytest.raises(SystemExit, match=message):
        spatial_layout(opt, ranks, ranks)


@pytest.mark.parametrize("over", [
    {"model": "poseflownet"}, {"model": "shapenet"},
    {"model": "shapenetflow"}, {"compute_dtype": "bfloat16"},
    {"remat": True}])
def test_spatial_accepted_for_the_other_heads_and_levers(over):
    """The single-frame heads, bf16 and --remat take --spatial, each with
    its spatial_layout: at 256 rows S=4 on 8 ranks, S=8 on 8."""
    args = ["--load_size=256", "--batchSize=2"]
    if "model" in over:
        args.append(f"--model={over['model']}")
        if over["model"].startswith("shapenet"):
            args.append("--dataset_mode=shapenet")
    if "compute_dtype" in over:
        args.append(f"--compute_dtype={over['compute_dtype']}")
    if over.get("remat"):
        args.append("--remat")
    for sp in (4, 8):
        opt = _train_opt(*args, f"--spatial={sp}")
        for key, value in over.items():
            assert getattr(opt, key) == value
        refuse_parallel_flags(opt)
        assert spatial_layout(opt, 8, 8) == sp


def test_spatial_refused_at_shapenets_seed():
    """ShapeNet's target net grows from an 8-row seed whatever the image's
    height: at 256 rows --spatial=16 is refused there, naming the level."""
    opt = _train_opt("--model=shapenet", "--dataset_mode=shapenet",
                     "--load_size=256", "--spatial=16", "--batchSize=1")
    refuse_parallel_flags(opt)
    with pytest.raises(SystemExit, match="--spatial 16: the target net's "
                                         "8x8 seed has 8 rows"):
        spatial_layout(opt, 16, 16)


@pytest.mark.parametrize("over,item", [
    ({"model": m}, "item 2") for m in ("dance", "face", "keypoint")])
def test_spatial_refused_elsewhere_names_its_item(over, item):
    opt = argparse.Namespace(**{"model": "pose", "spatial": 2,
                                "compute_dtype": "float32", "remat": False,
                                **over})
    with pytest.raises(NotImplementedError,
                       match=f"--spatial=2 .*queue 1, {item}:"):
        refuse_parallel_flags(opt)
    opt.spatial = 1
    refuse_parallel_flags(opt)


def test_world_without_spatial_is_unchanged():
    """No bands in this process: each band-aware module is the torch op it
    extends, bit for bit, and the band reductions are plain means."""
    assert parallel.bands() is None and parallel.data_world() == \
        parallel.world() and parallel.first_group()
    torch.manual_seed(3)
    x = torch.randn(2, 3, 8, 6)
    for m in (norms.conv2d(3, 4, 3, 1, 1), norms.conv2d(3, 4, 4, 2, 1),
              norms.ConvTranspose2x(3, 4), norms.ReflectionPad2d(1)):
        base = type(m).__mro__[1]
        assert torch.equal(m(x), base.forward(m, x)), type(m).__name__
    norm = norms.InstanceNorm(3)
    var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
    assert torch.equal(norm(x), (x - mean) * torch.rsqrt(var + 1e-5)
                       * norm.weight[:, None, None]
                       + norm.bias[:, None, None])
    assert torch.equal(parallel.band_mean(x), x.mean())
    assert parallel.whole(x) is x and parallel.gather_rows(x) is x


def test_halo_debug_prints_only_when_set(monkeypatch, capsys):
    """GFLA_HALO_DEBUG=1: one line where max|flow_y| + k//2 exceeds the
    halo; unset, the flow is not read (nothing waits for the device)."""
    flow = torch.zeros(1, 4, 4, 2)
    flow[0, 1, 2, 1] = -6.5

    class Unread:
        def __getitem__(self, key):
            raise AssertionError("the flow was read")

    monkeypatch.delenv("GFLA_HALO_DEBUG", raising=False)
    port_block_extract.halo_debug(Unread(), 3, 4)
    monkeypatch.setenv("GFLA_HALO_DEBUG", "1")
    port_block_extract.halo_debug(flow, 3, 8)
    assert capsys.readouterr().out == ""
    port_block_extract.halo_debug(flow, 3, 4)
    assert capsys.readouterr().out.splitlines() == [
        "WARNING: halo-sharded gather clamped: max|flow_y|+k//2 exceeds "
        "halo=4 by 3.5 rows (raise --halo)"]
