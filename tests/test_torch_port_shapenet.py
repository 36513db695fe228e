"""The ShapeNet novel-view heads (shapenet, shapenetflow) against gfla_tpu,
on the CPU.

Small sizes: 64x64 images, batch 2, layers 1 with one attention level (1,
kernel 3, at 32x32), ngf 16 and img_f 64, a 3-layer discriminator (ndf 16,
img_f 32); the flow net keeps its fixed widths (ngf 32, img_f 256, 5
levels). Inputs are seeded numpy; weights go
across with gfla_tpu_torch.convert. Held:
- the one-hot viewpoint code of every (azimuth, elevation) class, and of a
  test sweep: exactly;
- ShapeNetFlowNet, ShapeNetTargetNet, ShapeNetGenerator and
  ShapeNetFlowNetGenerator in eval mode: 1e-4 abs;
- one ShapeNetTask step and one ShapeNetFlowTask step from the port's
  initial state: losses within 1e-4 relative, D's stored u within 1e-5
  abs, every gradient within 1e-4 x its net's largest of gfla_tpu's (its
  Adam first moment: beta1 = 0). At the init the norm biases are 0,
  and an instance norm over a spatially constant channel gives exactly 0:
  LeakyReLU's derivative there is 1 in jax.nn.leaky_relu and the slope,
  0.1, in torch. That happens at the target net's `block0`, which takes the
  21-channel code tiled to 8x8, and at the 21 tiled code-difference
  channels entering the flow net's bottleneck ResBlock (AT_THE_KINK); those
  entries alone are held to the port's float64 step instead, at the same
  tolerance;
- the HDF5 dataset's samples after `prepare_batch`, and its training
  targets under one seeded rng, exactly; the on-device resize against PIL's,
  exactly (the same uint8 levels), and the identity at the stored size;
- the two-stage load: the stage-2 task loads exactly the flow-net tensors
  gfla_tpu's partial_load loads;
- the serving CLI's 18-view file names, gfla_tpu's; the training CLI's two
  stages; ShapeNetFlowTask under --compute_dtype=bfloat16 equal to its
  float32 step bitwise.
"""

import argparse
import copy
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
from PIL import Image
from torch_port_store import SHAPENET_AZIMUTHS, write_shapenet_store

from gfla_tpu.convert import convert_res_discriminator as \
    jax_convert_discriminator
from gfla_tpu.convert import convert_shapenet_generator as \
    jax_convert_generator
from gfla_tpu.data import create_dataloader as jax_create_dataloader
from gfla_tpu.data.shapenet_data import ShapeNetDataset as JaxShapeNetDataset
from gfla_tpu.models.generators import ShapeNetFlowNet as JaxFlowNet
from gfla_tpu.models.generators import ShapeNetFlowNetGenerator as JaxFlowG
from gfla_tpu.models.generators import ShapeNetGenerator as JaxGenerator
from gfla_tpu.models.generators import ShapeNetTargetNet as JaxTargetNet
from gfla_tpu.tasks import create_task as jax_create_task
from gfla_tpu.tasks.shapenet import ShapeNetTask as JaxShapeNetTask
from gfla_tpu.tasks.shapenet import labels_to_semantic as jax_labels
from gfla_tpu.train.checkpoint import partial_load as jax_partial_load
from gfla_tpu.train.state import GANTrainState
from gfla_tpu_torch import convert
from gfla_tpu_torch.data import collate
from gfla_tpu_torch.data.resample import resize_like_pil
from gfla_tpu_torch.data.shapenet_data import ShapeNetDataset
from gfla_tpu_torch.models import define_g
from gfla_tpu_torch.tasks.pose import prepare_batch
from gfla_tpu_torch.tasks.poseflownet import FLOW_NET
from gfla_tpu_torch.tasks.shapenet import (
    ShapeNetFlowTask,
    ShapeNetTask,
    labels_to_semantic,
    viewpoint_batch,
)

REPO = Path(__file__).resolve().parents[1]
H = 64
B = 2
ATTN = (1,)
KZ = {"1": 3}
G_CFG = dict(image_nc=3, structure_nc=21, output_nc=3, ngf=16, img_f=64,
             layers=1, num_blocks=2, norm_type="instance",
             activation="LeakyReLU", attn_layer=ATTN, extractor_kz=KZ)
REL = 1e-4
D_LAYERS = 3  # a small discriminator: ndf 16, img_f 32
# The flow heads' kernels: N(0, FLOW_NOISE^2 / fan_in). Enough to lift the
# regularization loss well above f32 rounding (to 1.1e-7 in the shapenet
# step, 5.3e-7 in the stage-1 step), and not far more: its gradient, which
# dominates the stage-1 step's and sums to nearly 0 over the image, carries
# the f32 rounding at LeakyReLU's kink into every weight gradient above it.
# From gfla_tpu's own init, at 10, one LeakyReLU input (4.8e-6 in float64)
# landed on the other side of 0 in f32, and the flow net's gradients 1.5e-3
# of its largest off the float64 ones; here 0.3 leaves them 7.8e-7 off.
FLOW_NOISE = 0.3
# {parameter: the entries of it at the LeakyReLU kink} (module docstring);
# the flow net's bottleneck is 256 channels, then the 21 code channels
AT_THE_KINK = {"target.block0.model.0.bias": slice(None),
               "flow_net.cat.model.0.model.0.bias": slice(256, None)}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads, for the module fixtures too: the other test
    workers share these cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _labels(rng, n=B):
    """Raw labels as the store holds them: (azimuth / 10, elevation)."""
    return np.stack([rng.randint(0, 18, n) * 2, rng.randint(0, 3, n) * 10],
                    axis=1).astype(np.int32)


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


# ---------------------------------------------------------------------------
# the viewpoint code
# ---------------------------------------------------------------------------

def test_labels_to_semantic_matches_gfla_tpu():
    """Every one of the 54 (azimuth, elevation) classes, from the lowest and
    the highest raw label of each."""
    h, v = np.meshgrid(np.arange(18), np.arange(3), indexing="ij")
    low = np.stack([2 * h.ravel(), 10 * v.ravel()], 1)
    bp = np.concatenate([low, low + [1, 9]]).astype(np.int32)
    want = np.asarray(jax_labels(jnp.asarray(bp), 18, 3)).transpose(
        0, 3, 1, 2)
    got = labels_to_semantic(torch.from_numpy(bp))
    assert got.dtype == torch.float32 and got.shape == (108, 21, 1, 1)
    assert np.array_equal(got.numpy(), want)
    assert len({tuple(c) for c in got[:54, :, 0, 0].tolist()}) == 54


def test_sweep_batch_matches_gfla_tpu():
    """A test batch's (B, V, 2) sweep and (B, V, ...) targets give their
    view 0, as gfla_tpu's `_semantic` does."""
    rng = np.random.RandomState(3)
    batch = {"P1": rng.rand(B, 8, 8, 3).astype(np.float32),
             "BP1": _labels(rng),
             "P2": rng.rand(B, 18, 8, 8, 3).astype(np.float32),
             "BP2": np.stack([_labels(rng, 18) for _ in range(B)])}
    want = JaxShapeNetTask._semantic(
        types.SimpleNamespace(label_nc_h=18, label_nc_v=3),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = viewpoint_batch(prepare_batch(batch, torch.device("cpu"), 8),
                          (18, 3))
    for key in ("BP1", "BP2"):
        assert np.array_equal(got[key].numpy(),
                              np.asarray(want[key]).transpose(0, 3, 1, 2))
    assert np.array_equal(_nhwc(got["P2"]), np.asarray(want["P2"]))


# ---------------------------------------------------------------------------
# the four generators
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def generator_pair():
    """gfla_tpu's ShapeNetGenerator with noise parameters, the port's with
    the same, and their inputs."""
    rng = np.random.RandomState(11)
    p1 = np.tanh(rng.randn(B, H, H, 3)).astype(np.float32)
    b1, b2 = _labels(rng), _labels(rng)
    args = (jnp.asarray(p1), jax_labels(jnp.asarray(b1), 18, 3),
            jax_labels(jnp.asarray(b2), 18, 3))
    jmod = JaxGenerator(**G_CFG)
    params = _noise(jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)[
        "params"], 12)
    port = define_g("shapenet", **G_CFG)
    port.load_state_dict(convert.shapenet_generator_state_dict(
        params, layers=1, attn_layer=ATTN), strict=True)
    port.eval()
    port_args = (_nchw(p1), labels_to_semantic(torch.from_numpy(b1)),
                 labels_to_semantic(torch.from_numpy(b2)))
    return jmod, jax.device_get(params), args, port, port_args


def _close(got, want, what):
    for a, b in zip(got, want):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=what)


FLOW_CFG = dict(structure_nc=21, attn_layer=ATTN, **FLOW_NET)


def _jit_apply(module, params, *args):
    """A flax module's eval-mode forward, compiled (eager flax on the CPU
    takes seconds a forward)."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a,
                                              train=False))(params, *args)


@pytest.mark.parametrize("module", ["generator", "flow_net", "target",
                                    "flow_generator"])
def test_shapenet_modules_match_flax(generator_pair, module):
    jmod, params, args, port, port_args = generator_pair
    with torch.no_grad():
        if module == "generator":
            img_j, flows_j, masks_j = _jit_apply(jmod, params, *args)
            img, flows, masks = port(*port_args)
            assert img.shape == (B, 3, H, H)
            assert [tuple(f.shape) for f in flows] == [(B, 2, 32, 32)]
            _close([img, *flows, *masks], [img_j, *flows_j, *masks_j],
                   module)
        elif module == "flow_net":
            want = _jit_apply(JaxFlowNet(**FLOW_CFG), params["flow_net"],
                              *args)
            got = port.flow_net(*port_args)
            _close([*got[0], *got[1]], [*want[0], *want[1]], module)
        elif module == "target":
            rng = np.random.RandomState(13)
            feats = [np.tanh(rng.randn(B, 32, 32, 16)),
                     np.tanh(rng.randn(B, H, H, 3))]
            flows = [rng.randn(B, 32, 32, 2) * 1.5]
            masks = [1 / (1 + np.exp(-rng.randn(B, 32, 32, 1)))]
            feats, flows, masks = ([a.astype(np.float32) for a in x]
                                   for x in (feats, flows, masks))
            want = _jit_apply(
                JaxTargetNet(**{k: v for k, v in G_CFG.items()
                                if k not in ("image_nc", "structure_nc")}),
                params["target"], args[2], feats, flows, masks)
            got = port.target(port_args[2], *([_nchw(a) for a in x]
                                              for x in (feats, flows, masks)))
            _close([got], [want], module)
        else:
            flow_params = {"flow_net": params["flow_net"]}
            want = _jit_apply(JaxFlowG(**FLOW_CFG), flow_params, *args)
            net = define_g("shapenetflow", image_nc=3, **FLOW_CFG)
            sd = convert.shapenetflow_state_dict(flow_params, attn_layer=ATTN)
            assert set(sd) == {k for k in port.state_dict()
                               if k.startswith("flow_net.")}
            net.load_state_dict(sd, strict=True)
            got = net.eval()(*port_args)
            _close([*got[0], *got[1]], [*want[0], *want[1]], module)


# ---------------------------------------------------------------------------
# one training step of each task
# ---------------------------------------------------------------------------

def _opt(model, **over):
    opt = argparse.Namespace(
        model=model, dataset_mode="shapenet", phase="train", isTrain=True,
        batchSize=B, load_size=H, old_size=H, structure_nc=21, image_nc=3,
        label_nc_h=18, label_nc_v=3, layers=1, attn_layer=list(ATTN),
        ngf=16, img_f=64, kernel_size=dict(KZ), use_spect_g=False,
        no_spect_d=False, lr=1e-4, lr_policy="lambda", niter=100,
        niter_decay=0, iter_count=1, iters_per_epoch=10, gan_mode="lsgan",
        ratio_g2d=0.1, lambda_rec=5.0, lambda_g=2.0, lambda_style=500.0,
        lambda_content=0.5, compute_dtype="float32", seed=0, gpu_ids="-1",
        d_layers=D_LAYERS, ndf=16, d_img_f=32)
    if model == "shapenet":
        opt.lambda_correct, opt.lambda_regularization = 5.0, 0.0025
    else:
        opt.lambda_correct, opt.lambda_regularization = 20.0, 0.01
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"P1": (rng.rand(B, H, H, 3) * 2 - 1).astype(np.float32),
            "P2": (rng.rand(B, H, H, 3) * 2 - 1).astype(np.float32),
            "BP1": _labels(rng), "BP2": _labels(rng)}


def _off_the_kinks(params):
    """The flow heads' biases set to seeded fractions in [0.3, 0.7] and
    their kernels to seeded noise (FLOW_NOISE). At the init the flows are
    nearly 0: every tap of the warp and of the correctness loss's resampler
    sits on an integer coordinate, where floor() makes two summation orders
    part, and the flow field is so nearly affine that the regularization
    loss is f32 rounding (from gfla_tpu's init: 5.7e-10, the two packages
    1.1e-4 of it apart)."""
    rng = np.random.RandomState(33)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    for name, head in params["flow_net"].items():
        if name.startswith("output"):
            conv = head["Conv_0"]
            conv["bias"] = (0.3 + 0.4 * rng.rand(*conv["bias"].shape)
                            ).astype(np.float32)
            kernel = conv["kernel"]
            conv["kernel"] = (rng.randn(*kernel.shape) * FLOW_NOISE
                              / np.sqrt(np.prod(kernel.shape[:-1]))
                              ).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, params)


def _step_pair(model, seed):
    """The port's task at its seeded init, the flow heads moved off the
    kinks, and gfla_tpu's task holding the same state (carried across with
    gfla_tpu's own converters, which is quicker than compiling its init)
    and one step of it."""
    opt = _opt(model, seed=seed)
    task_j = jax_create_task(opt)
    batch = _batch(seed)
    task = (ShapeNetTask if model == "shapenet" else ShapeNetFlowTask)(opt)
    full = task.net_g
    if model == "shapenetflow":  # the flow net inside a whole generator
        full = define_g("shapenet", **G_CFG)
        full.flow_net.load_state_dict(task.net_g.flow_net.state_dict())
    params_g = jax_convert_generator(full.state_dict(), layers=1,
                                     attn_layer=ATTN)
    params_g = _off_the_kinks(params_g if model == "shapenet"
                              else {"flow_net": params_g["flow_net"]})
    params_d, stats_d = {}, {}
    if model == "shapenet":
        d = jax_convert_discriminator(task.net_d.state_dict(),
                                      layers=D_LAYERS)
        params_d, stats_d = d["params"], d["batch_stats"]
    state = jax.device_get(GANTrainState.create(
        params_g, params_d, {}, stats_d, task_j.tx_g, task_j.tx_d))
    if model == "shapenet":
        task.net_g.load_state_dict(convert.shapenet_generator_state_dict(
            state.params_g, layers=1, attn_layer=ATTN), strict=True)
        task.net_d.load_state_dict(convert.res_discriminator_state_dict(
            state.params_d, state.stats_d, layers=D_LAYERS), strict=True)
    else:
        task.net_g.load_state_dict(convert.shapenetflow_state_dict(
            state.params_g, attn_layer=ATTN), strict=True)
    task.vgg.load_state_dict(convert.vgg19_state_dict(
        jax.device_get(task_j.vgg_params)), strict=True)
    state2, logs_j = task_j.train_step(
        jax.tree_util.tree_map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return state, jax.device_get(state2), jax.device_get(logs_j), task, batch


@pytest.fixture(scope="module")
def shapenet_step():
    return _step_pair("shapenet", 0)


@pytest.fixture(scope="module")
def flow_step():
    return _step_pair("shapenetflow", 1)


def _port_batch(batch):
    return prepare_batch(batch, torch.device("cpu"), H)


def _nets(task):
    return {"G": task.net_g, **({"D": task.net_d}
                                if hasattr(task, "net_d") else {})}


def _hold_step(task, batch, logs_j, mu):
    """The port's step against gfla_tpu's: losses, and each gradient
    against gfla_tpu's (`mu`, by net), AT_THE_KINK's entries against the
    port's float64 step."""
    exact = copy.deepcopy(task)
    for module in (*_nets(exact).values(), exact.vgg):
        module.double()
    exact.train_step({k: v.double() if v.is_floating_point() else v
                      for k, v in _port_batch(batch).items()})
    task = copy.deepcopy(task)
    logs = task.train_step(_port_batch(batch))
    assert sorted(logs) == sorted(type(task).loss_names + ["total_G"])
    for name, want in logs_j.items():
        got = float(logs[name])
        assert np.isfinite(got)
        assert abs(got - float(want)) <= REL * abs(float(want)), (
            name, got, float(want))
    kinks = 0
    for tag, net in _nets(task).items():
        grads = mu[tag]
        scale = max(g.abs().max().item() for g in grads.values()
                    if g.is_floating_point())
        for (name, p), q in zip(net.named_parameters(),
                                _nets(exact)[tag].parameters()):
            if p.grad is None:  # a mask head: no stage-1 loss reaches it
                assert name.startswith("flow_net.mask") and q.grad is None
                assert not grads[name].abs().max(), name
                continue
            got, want = p.grad.clone(), grads[name].clone()
            if tag == "G" and name in AT_THE_KINK:
                at = AT_THE_KINK[name]
                want[at] = q.grad[at].float()
                kinks += 1
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=REL * scale,
                                       err_msg=f"{tag} d {name}")
    assert kinks == (2 if "D" in _nets(task) else 1)
    return task


def test_shapenet_step_matches_gfla_tpu(shapenet_step):
    _, state2, logs_j, task, batch = shapenet_step
    mu = {"G": convert.shapenet_generator_state_dict(
              state2.opt_state_g[0].mu, layers=1, attn_layer=ATTN),
          "D": convert.res_discriminator_state_dict(
              state2.opt_state_d[0].mu, state2.stats_d, layers=D_LAYERS)}
    task = _hold_step(task, batch, logs_j, mu)
    want = convert.res_discriminator_state_dict(
        state2.params_d, state2.stats_d, layers=D_LAYERS)
    got = task.net_d.state_dict()
    keys = [k for k in want if k.endswith("weight_u")]
    assert len(keys) == 3 * D_LAYERS + 1
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-5, err_msg=key)


def test_shapenetflow_step_matches_gfla_tpu(flow_step):
    _, state2, logs_j, task, batch = flow_step
    mu = {"G": convert.shapenetflow_state_dict(state2.opt_state_g[0].mu,
                                               attn_layer=ATTN)}
    _hold_step(task, batch, logs_j, mu)


def test_shapenetflow_bfloat16_is_its_float32_step(flow_step):
    """The stage-1 head trains in float32 whatever --compute_dtype says."""
    task, batch = flow_step[3], _port_batch(flow_step[4])
    runs = []
    for dtype in ("float32", "bfloat16"):
        run = copy.deepcopy(task)
        run.opt = _opt("shapenetflow", compute_dtype=dtype)
        logs = run.train_step(batch)
        runs.append((logs, {n: p.detach() for n, p in
                            run.net_g.named_parameters()}))
    for name in runs[0][0]:
        assert torch.equal(runs[0][0][name], runs[1][0][name]), name
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name


def test_two_stage_loads_what_gfla_tpu_loads(flow_step, shapenet_step,
                                             tmp_path, capsys):
    """Stage 2 resumes the stage-1 directory: the flow-net tensors gfla_tpu's
    partial_load takes from a shapenetflow state, and no other."""
    state_flow, _, _, flow_task, batch = flow_step
    state_g = shapenet_step[0]
    merged, loaded_j, skipped_j = jax_partial_load(state_g.params_g,
                                                   state_flow.params_g)
    leaves = jax.tree_util.tree_leaves(state_flow.params_g)
    assert len(loaded_j) == len(leaves) and not skipped_j
    assert all(path.startswith("/flow_net/") for path in loaded_j)

    flow_task = copy.deepcopy(flow_task)
    flow_task.opt = _opt("shapenetflow", checkpoints_dir=str(tmp_path),
                         name="exp")
    flow_task.save(1)
    task = ShapeNetTask(_opt("shapenet", checkpoints_dir=str(tmp_path),
                             name="exp"))
    init = {k: v.clone() for k, v in task.net_g.state_dict().items()}
    assert task.resume("latest") == 1
    stage1 = convert.shapenetflow_state_dict(state_flow.params_g,
                                             attn_layer=ATTN)
    report = capsys.readouterr().out
    assert (f"G: loaded {len(stage1)} tensors from latest_net_G.pth: "
            f"flow_net ({len(stage1)}); skipped 0" in report), report
    want = convert.shapenet_generator_state_dict(
        jax.device_get(merged), layers=1, attn_layer=ATTN)
    for key, value in task.net_g.state_dict().items():
        if key in stage1:
            assert torch.equal(value, want[key]), key
        else:
            assert not key.startswith("flow_net.") and torch.equal(
                value, init[key]), key
    assert not task.opt_g.state and not task.opt_d.state
    logs = task.train_step(_port_batch(batch))
    assert all(np.isfinite(float(v)) for v in logs.values())


# ---------------------------------------------------------------------------
# the HDF5 dataset and the resize
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_shapenet_store(tmp_path_factory.mktemp("shapenet") / "car")


def _data_opt(store, phase, load_size=32):
    return argparse.Namespace(
        dataroot=store, phase=phase, isTrain=phase == "train",
        load_size=load_size, ang_skip=20, sub_dataset_model="car",
        label_nc_h=18, label_nc_v=3)


def test_dataset_test_phase_matches_gfla_tpu(store):
    opt = _data_opt(store, "test")
    port, ref = ShapeNetDataset(opt), JaxShapeNetDataset(opt)
    assert len(port) == len(ref) == 2
    for i in range(len(ref)):
        want, sample = ref[i], port[i]
        assert sample["P2"].dtype == np.uint8
        assert sample["P2"].shape == (18, 32, 32, 3)
        got = prepare_batch(collate([sample]), torch.device("cpu"), 32)
        assert np.array_equal(_nhwc(got["P1"])[0], want["P1"])
        assert np.array_equal(got["P2"][0].permute(0, 2, 3, 1).numpy(),
                              want["P2"])
        for key in ("BP1", "BP2"):
            assert got[key].dtype == torch.int32
            assert np.array_equal(got[key][0].numpy(), want[key])
        assert sample["P1_path"] == want["P1_path"] == f"obj{i}_{2 * i}_0"
        assert sample["P2_path"] == want["P2_path"] == [
            f"obj{i}_{a // 10}_0" for a in SHAPENET_AZIMUTHS]


def test_dataset_train_targets_match_gfla_tpu(store):
    opt = _data_opt(store, "train")
    port, ref = ShapeNetDataset(opt), JaxShapeNetDataset(opt)
    assert len(port) == len(ref) == 36
    port.rng, ref.rng = (np.random.RandomState(5) for _ in "ab")
    for i in range(len(ref)):
        want, got = ref[i], port[i]
        for key in ("P1_path", "P2_path", "BP1", "BP2"):
            assert np.array_equal(got[key], want[key]), (i, key)
        prepared = prepare_batch(collate([got]), torch.device("cpu"), 32)
        for key in ("P1", "P2"):
            assert np.array_equal(_nhwc(prepared[key])[0], want[key])
    # the loader's workers start by spawn: the open store stays behind
    import pickle

    assert pickle.loads(pickle.dumps(port))._h5 is None


@pytest.mark.parametrize("size", [20, 32, 48, 64])
def test_resize_like_pil_gives_pils_pixels(size):
    """PIL's bilinear resize of a 32x32 picture, down to 20 and up to 48
    and 64: the same uint8 levels (Pillow's own fixed-point arithmetic); at
    32, the picture itself."""
    rng = np.random.RandomState(size)
    yy, xx = np.mgrid[:32, :32]
    imgs = np.stack([np.clip(np.stack([yy * 8, xx * 7, (xx + yy) * 4], -1)
                             + rng.randint(-40, 41, (32, 32, 3)), 0, 255)
                     for _ in range(3)]).astype(np.uint8)
    want = np.stack([np.asarray(Image.fromarray(img).resize(
        (size, size), Image.BILINEAR)) for img in imgs]).astype(np.int16)
    got = resize_like_pil(torch.from_numpy(imgs), size)
    assert got.shape == (3, size, size, 3) and got.dtype == torch.float32
    levels = ((got + 1.0) * 127.5).round().numpy().astype(np.int16)
    assert np.array_equal(levels, want)
    if size == 32:
        assert torch.equal(got, torch.from_numpy(imgs).float() / 127.5 - 1.0)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

FORBIDDEN = {"jax", "flax", "optax", "orbax", "pandas", "cv2", "gfla_tpu",
             "imageio"}
SMALL = ["--gpu_ids=-1", "--dataset_mode=shapenet", "--load_size=64",
         "--attn_layer=1", "--kernel_size=1=3", "--nThreads=0"]


def _cli(module, tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-X", "importtime", "-m", module, *SMALL, *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"))


def _imported(stderr):
    return {line.rsplit("|", 1)[-1].strip().split(".")[0]
            for line in stderr.splitlines()
            if line.startswith("import time:")}


def test_train_cli_runs_both_stages(store, tmp_path):
    """Stage 1 writes only G; stage 2 prints the flow-net tensors it loads
    and trains on from there, with the held-out evaluation, the visuals and
    a trace. Neither imports JAX or PIL (the card's path reads no image
    through PIL), nor h5py: the store is read by the port's own reader."""
    common = [f"--dataroot={store}", "--batchSize=2", "--print_freq=1",
              f"--checkpoints_dir={tmp_path / 'ckpt'}", "--name=views"]
    proc = _cli("gfla_tpu_torch.train", tmp_path, *common,
                "--model=shapenetflow", "--max_iters=1")
    assert proc.returncode == 0, proc.stderr
    assert not _imported(proc.stderr) & (FORBIDDEN | {"PIL"})
    assert "h5py" not in _imported(proc.stderr)
    ckpt = tmp_path / "ckpt" / "views"
    assert not any("net_D" in p.name for p in ckpt.iterdir())
    n = len(torch.load(ckpt / "1_net_G.pth", weights_only=True))
    proc = _cli("gfla_tpu_torch.train", tmp_path, *common, "--model=shapenet",
                "--layers=1", "--continue_train", "--max_iters=4",
                "--eval_iters_freq=2", "--display_freq=2", "--profile_iters=1")
    assert proc.returncode == 0, proc.stderr
    assert not _imported(proc.stderr) & (FORBIDDEN | {"PIL", "h5py"})
    assert f"G: loaded {n} tensors" in proc.stdout
    assert f"flow_net ({n})" in proc.stdout
    assert "resumed from iteration 1" in proc.stdout
    assert "held out 2 samples" in proc.stdout
    assert any("ssim:" in line for line in proc.stdout.splitlines())
    images = sorted(p.name for p in (ckpt / "web" / "images").iterdir())
    assert "iter00000002_img_gen.png" in images
    assert not any("BP2" in name for name in images)
    assert (ckpt / "profile" / "trace_4.json").stat().st_size > 0
    assert (ckpt / "4_net_D.pth").exists()


def test_serving_cli_writes_gfla_tpu_sweep_names(store, tmp_path):
    """18 _vis.jpg a test source, named as gfla_tpu's sweep names them."""
    proc = _cli("gfla_tpu_torch.test", tmp_path, f"--dataroot={store}",
                "--model=shapenet", "--layers=1", "--batchSize=2",
                f"--results_dir={tmp_path / 'res'}",
                f"--checkpoints_dir={tmp_path / 'ckpt'}", "--name=views")
    assert proc.returncode == 0, proc.stderr
    assert not _imported(proc.stderr) & FORBIDDEN
    got = sorted(p.name for p in (tmp_path / "res" / "views").iterdir())
    assert "wrote 36 results" in proc.stdout

    opt = argparse.Namespace(
        dataset_mode="shapenet", dataroot=store, phase="test", isTrain=False,
        load_size=32, ang_skip=20, sub_dataset_model="car", batchSize=2,
        serial_batches=True, nThreads=0, seed=0, max_dataset_size=sys.maxsize,
        results_dir=str(tmp_path / "ref"), name="views")
    stub = types.SimpleNamespace(test_step=lambda state, view: (
        jnp.zeros(view["P1"].shape), None, None))
    JaxShapeNetTask.run_test(
        stub, opt, None, jax_create_dataloader(opt),
        lambda b: {k: jnp.asarray(v) for k, v in b.items()
                   if isinstance(v, np.ndarray)})
    want = sorted(p.name for p in (tmp_path / "ref" / "views").iterdir())
    assert len(want) == 36 and got == want
    for src in ("obj0_0_0", "obj1_2_0"):
        assert sum(n.startswith(f"{src}_2_") for n in got) == 18


@pytest.mark.parametrize("module", ["gfla_tpu_torch.train",
                                    "gfla_tpu_torch.test"])
def test_clis_ask_for_cuda(store, tmp_path, module):
    """Without --gpu_ids=-1, on a machine without CUDA, each CLI raises."""
    proc = subprocess.run(
        [sys.executable, "-m", module, "--model=shapenet",
         "--dataset_mode=shapenet", f"--dataroot={store}",
         f"--checkpoints_dir={tmp_path}", f"--results_dir={tmp_path}"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
                 CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
