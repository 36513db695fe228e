"""The data x spatial mode (`--spatial`, `--halo`; gfla_tpu_torch.parallel's
spatial axis) on the CPU: gloo ranks, each on its row band, held against
gfla_tpu and against the same modules run whole.

Two worlds run every rank-side case once (tests/torch_port_bands.py, no
jax in the ranks, 2 torch threads a rank), in a module fixture that starts
them beside gfla_tpu's own work and bounds each at RANKS_TIMEOUT:
- 4 ranks, at S=4 (one spatial group) and then S=2 (dp 2 x sp 2);
- 2 ranks, dp 1 x sp 2: a pose SGD step, then the training CLI's loop.
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
(d) the options: `--spatial` accepted for pose, refused with gfla_tpu's
    two messages where S does not divide the rank count or the load size,
    refused per level, for every other head, with bf16 and with --remat,
    each naming its ROADMAP item; a world without `--spatial` unchanged;
    GFLA_HALO_DEBUG;
and the training CLI's loop under `--gpu_ids=-1 --mesh_devices=2
--spatial=2` (evaluation and visuals gathered from the bands): one set of
checkpoints and one loss log, and a `--continue_train` run that takes the
next step.
"""

import argparse
import concurrent.futures
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
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
from gfla_tpu_torch.tasks.pose import PoseTask

RANKS_TIMEOUT = 300  # s, each world: as tests/test_torch_port_parallel.py
REL = 1e-6
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


def _gfla_tpu_state(state_path):
    """The port's tiny pose task at its seeded init, the flow heads' biases
    set off the floor kinks of the warp and the resampler
    (chip_smoke.off_the_kinks), saved at `state_path` with gfla_tpu's
    VGG19; gfla_tpu's task with SGD and the same state, carried through
    convert.py (`_carried`; no init of gfla_tpu's runs). Returns (task,
    state, batch, host copies of the state's G and D parameters and D's
    spectral stats)."""
    port = chip_smoke.off_the_kinks(PoseTask(bands.step_opt()))
    sd_g, sd_d = port.net_g.state_dict(), port.net_d.state_dict()
    task = jax_create_task(bands.step_opt())
    task.tx_g = optax.sgd(chip_smoke.DP_SGD_LR)
    task.tx_d = optax.sgd(chip_smoke.DP_SGD_LR)
    batch = {k: _nhwc(v) for k, v in bands.step_batch().items()}
    shapes = jax.eval_shape(task._init_state_impl, jax.random.PRNGKey(0),
                            batch)
    d_layers = bands.step_opt().d_layers
    params_g = _carried(shapes.params_g, convert.pose_generator_state_dict,
                        sd_g)
    params_d, stats_d = _carried(
        (shapes.params_d, shapes.stats_d),
        lambda t: convert.res_discriminator_state_dict(*t, d_layers),
        sd_d)
    state = GANTrainState.create(params_g=params_g, params_d=params_d,
                                 stats_g={}, stats_d=stats_d,
                                 tx_g=task.tx_g, tx_d=task.tx_d)
    get = jax.device_get
    torch.save({"G": sd_g, "D": sd_d,
                "VGG": convert.vgg19_state_dict(get(task.vgg_params))},
               state_path)
    return task, state, batch, get((params_g, params_d, stats_d))


def _gfla_tpu_step(task, state, batch, host):
    """gfla_tpu's single-device step on the whole batch: (logs, G's and D's
    gradients by name, as the port's state dict)."""
    get = jax.device_get
    p_g, p_d, stats_d = host
    d_layers = bands.step_opt().d_layers
    after, logs = task.train_step(state, batch)  # donates `state`
    lr = chip_smoke.DP_SGD_LR
    g = convert.pose_generator_state_dict(jax.tree_util.tree_map(
        lambda a, b: (a - b) / lr, p_g, get(after.params_g)))
    d = convert.res_discriminator_state_dict(jax.tree_util.tree_map(
        lambda a, b: (a - b) / lr, p_d, get(after.params_d)), stats_d,
        d_layers)
    return ({k: float(v) for k, v in get(logs).items()},
            {"G": _trained(g), "D": _trained(d)})


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
    starts at once, the 2-rank one once gfla_tpu's state is saved for it;
    gfla_tpu's step and attention run while they do."""
    out = tmp_path_factory.mktemp("bands")
    state_path = out / "state.pt"
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        modules = pool.submit(parallel.spawn, bands.module_bands, [CPU] * 4,
                              str(out), timeout=RANKS_TIMEOUT)
        try:
            jax_state = _gfla_tpu_state(state_path)
            steps = pool.submit(parallel.spawn, bands.step_bands, [CPU] * 2,
                                str(state_path), str(out),
                                timeout=RANKS_TIMEOUT)
            step = _gfla_tpu_step(*jax_state)
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
            "gfla_tpu_step": step, "gfla_tpu_attn": attn,
            "state_path": state_path, "ckpt": out / "ckpt" / "sp"}


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
        for case in ("attn", "modules"):
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


@pytest.mark.parametrize("over,item", [
    *[({"model": m}, "item 2a") for m in ("poseflownet", "shapenet",
                                         "shapenetflow", "dance", "face",
                                         "keypoint")],
    ({"compute_dtype": "bfloat16"}, "item 2b"),
    ({"remat": True}, "item 2c"),
])
def test_spatial_refused_elsewhere_names_its_item(over, item):
    opt = argparse.Namespace(**{"model": "pose", "spatial": 2,
                                "compute_dtype": "float32", "remat": False,
                                **over})
    with pytest.raises(NotImplementedError,
                       match=f"--spatial=2 .*queue 1, {item}"):
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
