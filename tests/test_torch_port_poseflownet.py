"""Stage-1 flow pretraining (poseflownet) against gfla_tpu, on the CPU.

gfla_tpu's PoseFlowNetGenerator and its variables, carried across with
`convert.poseflownet_state_dict`, give the port's flows and masks within
2e-5. One training step of `PoseFlowNetTask` from the same state and batch
(32x32, batch 2, the head's fixed widths: ngf 32, img_f 256, 5 levels)
matches gfla_tpu's step: losses within 1e-4 relative, updated parameters by
the masked rule of test_torch_port_train.py (2 lr everywhere; 1e-6 where
|grad| > 1e-3 x the tensor's max and gfla_tpu's f32 gradient resolves the
float64 one). The two-stage protocol: the pose task resumed on a poseflownet
directory starts its flow net from it and keeps the rest at init, and the
trainer CLI runs both stages without importing JAX.
"""

import argparse
import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfla_tpu.data import encode_heatmaps as jax_encode_heatmaps
from gfla_tpu.models.generators import PoseFlowNetGenerator as JaxFlowG
from gfla_tpu.tasks import create_task as jax_create_task
from gfla_tpu_torch import convert
from gfla_tpu_torch.models import define_g
from gfla_tpu_torch.tasks.pose import PoseTask
from gfla_tpu_torch.tasks.poseflownet import FLOW_NET, PoseFlowNetTask

REPO = Path(__file__).resolve().parents[1]
H = W = 32


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


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


def test_poseflownet_generator_matches_flax():
    rng = np.random.RandomState(31)
    p1 = np.tanh(rng.randn(2, H, W, 3)).astype(np.float32)
    bp1, bp2 = (rng.rand(2, H, W, 18).astype(np.float32) for _ in "ab")
    args = tuple(jnp.asarray(a) for a in (p1, bp1, bp2))
    jmod = JaxFlowG(attn_layer=(2, 3), **FLOW_NET)
    params = _noise(jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)[
        "params"], 32)
    flows_j, masks_j = jmod.apply({"params": params}, *args)
    port = define_g("poseflownet", attn_layer=(2, 3), **FLOW_NET)
    sd = convert.poseflownet_state_dict(params)
    assert all(k.startswith("flow_net.") for k in sd)
    port.load_state_dict(sd, strict=True)
    flows, masks = port(*(_nchw(a) for a in (p1, bp1, bp2)))
    assert [tuple(f.shape) for f in flows] == [(2, 2, 4, 4), (2, 2, 8, 8)]
    for a, b in zip(flows + masks, list(flows_j) + list(masks_j)):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=0,
                                   atol=2e-5)
    # the stage-1 keys are exactly the pose generator's flow_net keys
    pose = define_g("pose", image_nc=3, structure_nc=18, output_nc=3,
                    ngf=16, img_f=64, layers=3, num_blocks=2,
                    norm_type="instance", activation="LeakyReLU",
                    attn_layer=(2, 3), extractor_kz={"2": 5, "3": 3})
    assert set(sd) == {k for k in pose.state_dict()
                       if k.startswith("flow_net.")}


def _opt(**over):
    opt = argparse.Namespace(
        model="poseflownet", dataset_mode="synthetic", phase="train",
        isTrain=True, batchSize=2, load_size=H, old_size=(H, W),
        structure_nc=18, image_nc=3, attn_layer=[2, 3],
        kernel_size={"2": 5, "3": 3}, use_spect_g=False, lr=1e-4,
        lr_policy="lambda", niter=100, niter_decay=0, iter_count=1,
        iters_per_epoch=10, lambda_correct=20.0, lambda_regularization=0.01,
        compute_dtype="float32", seed=0, gpu_ids="-1")
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _batch(seed):
    rng = np.random.RandomState(seed)
    kp = rng.rand(2, 2, 18, 2).astype(np.float32) * (H - 1)
    return {"P1": (rng.rand(2, H, W, 3) * 2 - 1).astype(np.float32),
            "P2": (rng.rand(2, H, W, 3) * 2 - 1).astype(np.float32),
            "BP1": np.asarray(jax_encode_heatmaps(jnp.asarray(kp[0]), H, W)),
            "BP2": np.asarray(jax_encode_heatmaps(jnp.asarray(kp[1]), H, W))}


def _port_batch(b):
    return {k: _nchw(v).contiguous(memory_format=torch.channels_last)
            for k, v in b.items()}


def _off_the_kinks(params):
    """The flow heads' biases set to seeded fractions in [0.3, 0.7]. At the
    init the flows are nearly 0, every tap of the correctness loss's
    resampler sits on an integer coordinate, and floor() makes f32 and
    float64 gradients part there; between integers both are smooth."""
    rng = np.random.RandomState(33)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    for name, head in params["flow_net"].items():
        if name.startswith("output"):
            bias = head["Conv_0"]["bias"]
            head["Conv_0"]["bias"] = (0.3 + 0.4 * rng.rand(*bias.shape)
                                      ).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def step_pair():
    """gfla_tpu's poseflownet task and one step of it, and the port's task
    holding the same state before the step."""
    opt = _opt()
    task_j = jax_create_task(opt)
    batch = _batch(0)
    state = task_j.init_state(jax.random.PRNGKey(0),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    state = state.replace(params_g=_off_the_kinks(state.params_g))
    task = PoseFlowNetTask(opt)
    task.net_g.load_state_dict(convert.poseflownet_state_dict(
        jax.device_get(state.params_g)), strict=True)
    task.vgg.load_state_dict(convert.vgg19_state_dict(
        jax.device_get(task_j.vgg_params)), strict=True)
    state2, logs_j = task_j.train_step(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.device_get(state2), jax.device_get(logs_j), task, batch


def test_poseflownet_step_matches_gfla_tpu(step_pair):
    state2, logs_j, task, batch = step_pair
    exact = copy.deepcopy(task)
    for module in (exact.net_g, exact.vgg):
        module.double()
    exact.train_step({k: v.double() for k, v in _port_batch(batch).items()})
    exact = {n: p.grad for n, p in exact.net_g.named_parameters()
             if p.grad is not None}

    task = copy.deepcopy(task)
    logs = task.train_step(_port_batch(batch))
    assert sorted(logs) == sorted(PoseFlowNetTask.loss_names + ["total_G"])
    for name, want in logs_j.items():
        got = float(logs[name])
        assert np.isfinite(got)
        assert abs(got - float(want)) <= 1e-4 * abs(float(want)), (
            name, got, float(want))

    want = convert.poseflownet_state_dict(jax.device_get(state2.params_g))
    ref = convert.poseflownet_state_dict(  # beta1 = 0: mu is the gradient
        jax.device_get(state2.opt_state_g[0].mu))
    scale = max(g.abs().max().item() for g in exact.values())
    held = 0
    for name, p in task.net_g.named_parameters():
        got, w = p.detach(), want[name]
        assert (got - w).abs().max() <= 2e-4, name
        g64 = exact.get(name)
        if g64 is None:  # a mask head: no stage-1 loss reaches it
            assert name.startswith("flow_net.mask"), name
            assert torch.equal(got, w), name
            continue
        top = g64.abs().max().item()
        if top <= 1e-9 * scale:  # exactly 0 in f64
            continue
        assert (p.grad.double() - g64).abs().max() <= 1e-3 * top, name
        if (ref[name].double() - g64).abs().max() > 1e-3 * top:
            continue  # gfla_tpu's f32 gradient does not resolve this one
        big = g64.abs() > 1e-3 * top
        assert (got - w)[big].abs().max() <= 1e-6, name
        held += 1
    assert held >= 40


def test_two_stage_partial_load(step_pair, tmp_path, capsys):
    """A pose task resumed on a poseflownet directory: flow_net loaded, the
    source and target nets and D at their init, the step kept, the
    optimizers fresh; and one pose step runs from there."""
    _, _, flow_task, batch = step_pair
    flow_task = copy.deepcopy(flow_task)
    flow_task.opt = _opt(checkpoints_dir=str(tmp_path), name="exp")
    flow_task.train_step(_port_batch(batch))
    flow_task.save(3)
    assert not (tmp_path / "exp" / "3_net_D.pth").exists()

    pose_opt = argparse.Namespace(**vars(_opt(
        model="pose", checkpoints_dir=str(tmp_path), name="exp", layers=3,
        ngf=16, img_f=64, gan_mode="lsgan", ratio_g2d=0.1, lambda_rec=5.0,
        lambda_g=2.0, lambda_correct=5.0, lambda_style=500.0,
        lambda_content=0.5, lambda_regularization=0.0025, no_spect_d=False)))
    pose = PoseTask(pose_opt)
    init_g = {k: v.clone() for k, v in pose.net_g.state_dict().items()}
    init_d = {k: v.clone() for k, v in pose.net_d.state_dict().items()}
    assert pose.resume("latest") == 3 and pose.step == 3
    report = capsys.readouterr().out
    assert "loaded 90 tensors" in report and "flow_net (90)" in report
    assert "no latest_net_D.pth; left at its init" in report
    saved = flow_task.net_g.state_dict()
    for key, value in pose.net_g.state_dict().items():
        if key.startswith("flow_net."):
            assert torch.equal(value, saved[key]), key
        else:
            assert torch.equal(value, init_g[key]), key
    for key, value in pose.net_d.state_dict().items():
        assert torch.equal(value, init_d[key]), key
    assert not pose.opt_g.state and not pose.opt_d.state
    assert pose.sched_g.last_epoch == 0
    logs = pose.train_step(_port_batch(batch))
    assert all(np.isfinite(float(v)) for v in logs.values())

    # a directory the pose task wrote itself still loads strictly
    pose.save(4)
    again = PoseTask(pose_opt)
    assert again.resume("latest") == 4
    assert again.opt_g.state and again.sched_g.last_epoch == 1


@pytest.fixture(scope="module")
def spectral_pair():
    """gfla_tpu's poseflownet task with `--use_spect_g`, its state (the flow
    heads off the resampler's kinks) and one step of it, and the port's
    task holding the same state, u included."""
    opt = _opt(use_spect_g=True)
    task_j = jax_create_task(opt)
    batch = _batch(7)
    state = task_j.init_state(jax.random.PRNGKey(7),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    state = state.replace(params_g=_off_the_kinks(state.params_g))
    state = jax.device_get(state)
    task = PoseFlowNetTask(opt)
    task.net_g.load_state_dict(convert.poseflownet_state_dict(
        state.params_g, batch_stats=state.stats_g), strict=True)
    task.vgg.load_state_dict(convert.vgg19_state_dict(
        jax.device_get(task_j.vgg_params)), strict=True)
    state2, logs_j = task_j.train_step(
        jax.tree_util.tree_map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return task_j, state, jax.device_get(state2), jax.device_get(logs_j), \
        task, batch


def test_spectral_flow_net_matches_gfla_tpu(spectral_pair):
    """--use_spect_g on the stage-1 head: eval-mode flows and masks within
    2e-5 abs (as the plain head's); one training step's losses within 1e-4
    relative, the stored u of every spectral conv within 1e-5 abs, and every
    gradient within 1e-3 x its tensor's max of the float64 step's and within
    1e-4 x the net's largest gradient of gfla_tpu's (its Adam first moment:
    beta1 = 0). At 32x32 the flow net's bottleneck is 1x1, so the instance
    norms around it put exactly 0 into a LeakyReLU, whose slope there is 1
    in gfla_tpu and 0.1 in torch: the two norm biases there (no more) are
    held to the float64 step alone, as in test_train_step_matches_gfla_tpu."""
    task_j, state, state2, logs_j, task, batch = spectral_pair
    args = [jnp.asarray(batch[k]) for k in ("P1", "BP1", "BP2")]
    flows_j, masks_j = task_j.net_g.apply(
        {"params": state.params_g, "batch_stats": state.stats_g}, *args,
        train=False, update_stats=False)
    task = copy.deepcopy(task)
    task.net_g.eval()
    with torch.no_grad():
        flows, masks = task.net_g(*(_nchw(batch[k])
                                    for k in ("P1", "BP1", "BP2")))
    for a, b in zip(flows + masks, list(flows_j) + list(masks_j)):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=0,
                                   atol=2e-5)

    task.net_g.train()
    exact = copy.deepcopy(task)
    for module in (exact.net_g, exact.vgg):
        module.double()
    exact.train_step({k: v.double() for k, v in _port_batch(batch).items()})
    logs = task.train_step(_port_batch(batch))
    for name, want in logs_j.items():
        assert abs(float(logs[name]) - float(want)) <= 1e-4 * abs(
            float(want)), (name, float(logs[name]), float(want))
    grads = convert.poseflownet_state_dict(
        jax.device_get(state2.opt_state_g[0].mu),
        batch_stats=state2.stats_g)
    scale = max(g.abs().max().item() for g in grads.values()
                if g.is_floating_point())
    held, at_zero = 0, []
    for (name, p), q in zip(task.net_g.named_parameters(),
                            exact.net_g.parameters()):
        if p.grad is None:  # a mask head: no stage-1 loss reaches it
            assert q.grad is None and not grads[name].abs().max(), name
            continue
        top = q.grad.abs().max().item()
        if top > 1e-9 * scale:  # not exactly 0 in f64 (a bias before a norm)
            assert (p.grad.double() - q.grad).abs().max() <= 1e-3 * top, name
            if (grads[name].double() - q.grad).abs().max() > 1e-3 * top:
                at_zero.append(name)
                continue
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=0, atol=1e-4 * scale,
                                   err_msg=f"d {name}")
        held += 1
    assert held >= 40 and len(at_zero) <= 2, at_zero
    want_u = convert.poseflownet_state_dict(state2.params_g,
                                            batch_stats=state2.stats_g)
    keys = [k for k in task.net_g.state_dict() if k.endswith("weight_u")]
    assert keys
    for key in keys:
        np.testing.assert_allclose(task.net_g.state_dict()[key].numpy(),
                                   want_u[key].numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)


FORBIDDEN = {"jax", "flax", "optax", "orbax", "pandas", "cv2", "gfla_tpu",
             "PIL", "imageio"}


def _train(tmp_path, *args):
    """`python -m gfla_tpu_torch.train` on the CPU; -X importtime lists every
    module the run imports on stderr."""
    return subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "gfla_tpu_torch.train",
         "--gpu_ids=-1", "--dataset_mode=synthetic", "--load_size=64",
         "--batchSize=2", "--max_dataset_size=4", "--print_freq=1",
         f"--checkpoints_dir={tmp_path / 'ckpt'}", "--name=twostage", *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"))


def test_train_cli_runs_both_stages(tmp_path):
    proc = _train(tmp_path, "--model=poseflownet", "--max_iters=2")
    assert proc.returncode == 0, proc.stderr
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")}
    assert "gfla_tpu_torch" in imported and not imported & FORBIDDEN
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("(epoch:")]
    assert len(lines) == 2
    assert all("correctness:" in line and "regularization:" in line
               for line in lines)
    ckpt = tmp_path / "ckpt" / "twostage"
    names = {p.name for p in ckpt.iterdir()}
    assert {"2_net_G.pth", "latest_net_G.pth", "2_train_state.pth"} <= names
    assert not any("net_D" in n for n in names)

    proc = _train(tmp_path, "--model=pose", "--continue_train",
                  "--max_iters=3")
    assert proc.returncode == 0, proc.stderr
    assert "flow_net (90)" in proc.stdout
    assert "resumed from iteration 2" in proc.stdout
    assert (ckpt / "3_net_D.pth").exists()
