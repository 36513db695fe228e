"""The rank side of tests/test_torch_port_spatial.py: the inputs, modules
and steps that the ranks of the data x spatial mode's gloo worlds on the CPU
run (started by gfla_tpu_torch.parallel.spawn), each on its row band, and
that the test process runs once more whole. Torch and the port only: no
jax, so that a rank starts fast.

- `module_bands` (a world of 4 ranks): at S=4 (one spatial group) and then
  at S=2 (two groups, dp 2 x sp 2), the halo gather (`halo_block_extract`) and
  the warp route (`local_attn_warp`, its plain twin on the window) at
  k=3 and 5, with a flow past the halo; the band convolutions, the
  reflection pad, InstanceNorm, VGG19 and ResDiscriminator, and most of
  these again in bf16 (BF16_MODULES). Each result is the band's output and
  its gradients under a fixed cotangent.
- `step_bands` (a world of 2 ranks, dp 1 x sp 2): one pose SGD step from
  given state dicts on the band of a 64x64 batch of 2; the same for
  poseflownet, shapenet and shapenetflow, and pose's in bf16 and with
  `--remat` (STEPS), each counting the spatial group's collectives; then
  the training loop of `python -m gfla_tpu_torch.train --gpu_ids=-1
  --mesh_devices=2 --spatial=2` for one step with its evaluation and
  visuals, a `--continue_train` run that takes the next step, and
  ShapeNet from the committed store (tests/fixtures/shapenet_car): a
  stage-1 shapenetflow step, then shapenet resumed on it for a step with
  its evaluation and visuals.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import chip_smoke
import torch_port_ranks as ranks
from torch_port_store import FIXTURE
from gfla_tpu_torch import parallel
from gfla_tpu_torch.models.discriminators import ResDiscriminator
from gfla_tpu_torch.models.vgg import VGG19
from gfla_tpu_torch.nn import blocks, norms
from gfla_tpu_torch.ops.block_extract import block_extract, halo_block_extract
from gfla_tpu_torch.ops.local_attn import local_attn_warp
from gfla_tpu_torch.tasks import create_task

HALO = 4
ATTN_H, ATTN_W, ATTN_C, ATTN_D = 16, 6, 3, 8
# (name, k, rows whose flow_y is planted far past the halo); at k=5 some
# taps of the test flows leave the window of 4 rows too
ATTN_CASES = [("k5", 5, ()), ("k3_far", 3, (5, 10))]
FAR_Y = 30.0
MODULE_H = 16   # the convolutions' and the norm's image rows
VGG_H = 64      # VGG19's: 4 rows a band at S=4 after its 4 pools
D_H = 32        # ResDiscriminator's (3 layers): 1 row a band at S=4
STEP_H = 64     # the pose step's: the flow net's 5 levels leave 1 row a band
SPATIAL = (4, 2)
THREADS = 2


def attn_inputs(name):
    """A case's (B, H, W, C) source and target, (B, H, W, 2) flow, gfla_tpu
    layout weights w1 (k^2, 2C, D), b1, w2 (D, k^2), b2 and cotangents of
    the gather's (B, H, W, k^2, C) and the attention's (B, H, W, C)
    outputs. Flows are multiples of 1/64, so that y + flow_y is exact in
    f32 whether a row counts from the image's top (the halo gather) or
    from its window's (the warp kernels): the two forms then take the same
    fractional weights, and only their sums' order differs; their
    fractions stay off the floor's kinks, in [0.3, 0.7]."""
    _, k, far = next(c for c in ATTN_CASES if c[0] == name)
    rng = np.random.RandomState(7 + k)
    B, H, W, C, D = 2, ATTN_H, ATTN_W, ATTN_C, ATTN_D
    flow = np.stack([rng.randn(B, H, W) * 3.0,
                     rng.uniform(-2.5, 2.5, (B, H, W))], -1)
    flow = np.floor(flow) + np.round(rng.uniform(0.3, 0.7, flow.shape)
                                     * 64) / 64
    for row in far:
        flow[0, row, :, 1] = FAR_Y
    t = {"source": rng.randn(B, H, W, C), "target": rng.randn(B, H, W, C),
         "flow": flow,
         "w1": rng.randn(k * k, 2 * C, D) * 0.3, "b1": rng.randn(D) * 0.1,
         "w2": rng.randn(D, k * k) * 0.3, "b2": rng.randn(k * k) * 0.1,
         "cot_gather": rng.randn(B, H, W, k * k, C),
         "cot_attn": rng.randn(B, H, W, C)}
    return {n: torch.from_numpy(v.astype(np.float32)) for n, v in t.items()}


def band(t, index, size, dim):
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


def attn_case(name, index=0, size=1):
    """The gather's and the warp route's band outputs and their gradients
    (source, flow; target for the warp) under the cotangents' band."""
    x = attn_inputs(name)
    k = next(c[1] for c in ATTN_CASES if c[0] == name)
    ins = {n: band(x[n], index, size, 1).clone().requires_grad_(True)
           for n in ("source", "target", "flow")}
    out = {}
    gather = block_extract if parallel.bands() is None else halo_block_extract
    g = gather(ins["source"], ins["flow"], k)
    ds, df = torch.autograd.grad(
        (g * band(x["cot_gather"], index, size, 1)).sum(),
        (ins["source"], ins["flow"]))
    out["gather"] = {"out": g.detach(), "d_source": ds, "d_flow": df}
    a = local_attn_warp(ins["source"], ins["target"], ins["flow"], k,
                        x["w1"], x["b1"], x["w2"], x["b2"])
    ds, dt, df = torch.autograd.grad(
        (a * band(x["cot_attn"], index, size, 1)).sum(),
        (ins["source"], ins["target"], ins["flow"]))
    out["warp"] = {"out": a.detach(), "d_source": ds, "d_target": dt,
                   "d_flow": df}
    return out


def _module(name):
    """(module, input (B, C, H, W)), seeded: the same on every rank."""
    torch.manual_seed(11)
    m = {
        "conv3x3": lambda: norms.conv2d(3, 4, 3, 1, 1),
        "conv4x4s2": lambda: norms.conv2d(3, 4, 4, 2, 1),
        "conv1x1": lambda: norms.conv2d(3, 4, 1, 1, 0),
        "spectral4x4s2": lambda: norms.conv2d(3, 4, 4, 2, 1, True),
        "convT2x": lambda: norms.ConvTranspose2x(3, 4),
        "spectral_convT2x": lambda: norms.ConvTranspose2x(3, 4, True),
        "reflect_jump": lambda: blocks.Jump(3, 4, 3),
        "instance_norm": lambda: norms.InstanceNorm(3),
        "vgg19": VGG19,
        "res_discriminator": lambda: ResDiscriminator(3, 8, 16, 3),
    }[name]()
    H = {"vgg19": VGG_H, "res_discriminator": D_H}.get(name, MODULE_H)
    if name == "vgg19":
        gen = torch.Generator().manual_seed(12)
        with torch.no_grad():
            for conv in m.modules():
                if isinstance(conv, torch.nn.Conv2d):
                    conv.weight.copy_(torch.randn(conv.weight.shape,
                                                  generator=gen)
                                      / np.sqrt(conv.weight[0].numel()))
                    conv.bias.copy_(torch.randn(conv.bias.shape,
                                                generator=gen) * 0.1)
    if name == "instance_norm":
        with torch.no_grad():
            m.weight.copy_(torch.rand(3) + 0.5)
            m.bias.copy_(torch.randn(3))
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(2, 3, H, H // 2 + 2).astype(np.float32))
    return m, x


MODULES = ["conv3x3", "conv4x4s2", "conv1x1", "spectral4x4s2", "convT2x",
           "spectral_convT2x", "reflect_jump", "instance_norm", "vgg19",
           "res_discriminator"]
VGG_OUT = ("relu1_2", "relu2_2", "relu3_4", "relu4_4", "relu5_4")
# the modules held in bf16 too (InstanceNorm's band sums in f32, the
# halo rows exchanged in bf16)
BF16_MODULES = ["conv3x3", "conv4x4s2", "convT2x", "reflect_jump",
                "instance_norm", "vgg19", "res_discriminator"]


def module_case(name, index=0, size=1, dtype=torch.float32):
    """The band's outputs, its input gradient and this band's share of the
    parameter gradients (the bands' shares sum to the whole image's),
    under a seeded cotangent on the whole output; the spectral norms' u
    after a training-mode call. In `dtype` (bf16, or the test's f64
    reference)."""
    m, x = _module(name)
    m.to(dtype)
    xb = band(x, index, size, 2).to(dtype).clone().requires_grad_(True)
    y = m(xb, update_stats=True) if name == "res_discriminator" else m(xb)
    outs = ({n: y[n] for n in VGG_OUT} if isinstance(y, dict)
            else {"out": y})
    loss = 0.0
    for i, (n, t) in enumerate(outs.items()):
        shape = (*t.shape[:2], t.shape[2] * size, t.shape[3])
        cot = torch.from_numpy(np.random.RandomState(20 + i).randn(
            *shape).astype(np.float32)).to(dtype)
        loss = loss + (t * band(cot, index, size, 2)).sum()
    loss.backward()
    return {"outs": {n: t.detach() for n, t in outs.items()},
            "d_input": xb.grad,
            "d_params": {n: p.grad.clone() for n, p in m.named_parameters()
                         if p.grad is not None},
            "u": {n: t.clone() for n, t in m.named_buffers()
                  if n.endswith("weight_u")}}


def module_bands(device, out_dir):
    """Every attention case and module at S=4, then at S=2 (dp 2 x sp 2),
    on this rank's band; results to `{out_dir}/bands_rank{r}.pt`."""
    torch.set_num_threads(THREADS)
    out = {}
    for size in SPATIAL:
        b = parallel.init_bands(size, HALO)
        out[size] = {"band": b.index,
                     "attn": {n: attn_case(n, b.index, size)
                              for n, _, _ in ATTN_CASES},
                     "modules": {n: module_case(n, b.index, size)
                                 for n in MODULES},
                     "modules_bf16": {
                         n: module_case(n, b.index, size, torch.bfloat16)
                         for n in BF16_MODULES}}
    torch.save(out, os.path.join(out_dir,
                                 f"bands_rank{parallel.world().rank}.pt"))


HEADS = ("pose", "poseflownet", "shapenet", "shapenetflow")
# ShapeNet's heads at 64 rows: one G level (the target grows from an 8x8
# seed to 8 * 2^(layers + 2) rows) and one attention level, k=3
SHAPENET = dict(dataset_mode="shapenet", structure_nc=21, label_nc_h=18,
                label_nc_v=3, layers=1, attn_layer=[1], kernel_size={"1": 3})
STAGE_1 = dict(lambda_correct=20.0, lambda_regularization=0.01)


def step_opt(model="pose", **over):
    """The tiny task's options for `model` (tests/torch_port_ranks.py's
    widths) at STEP_H rows."""
    ranks.H = STEP_H
    head = {"poseflownet": STAGE_1, "shapenet": SHAPENET,
            "shapenetflow": {**SHAPENET, **STAGE_1}}.get(model, {})
    return ranks.pose_opt(**{"load_size": STEP_H,
                             "old_size": (STEP_H, STEP_H), **head,
                             "model": model, **over})


def step_batch(model="pose"):
    """A prepared batch of 2 for `model`: pose's heatmaps, or ShapeNet's
    raw viewpoint labels, (B, 2) ints (azimuth / 10, elevation)."""
    ranks.H = STEP_H
    batch = ranks.pose_batch(1)
    if model.startswith("shapenet"):
        rng = np.random.RandomState(2)
        for key in ("BP1", "BP2"):
            batch[key] = torch.from_numpy(np.stack(
                [rng.randint(0, 18, 2) * 2, rng.randint(0, 3, 2) * 10],
                1).astype(np.int32))
    return batch


def sgd_task(state_path, model="pose", **over):
    """The tiny task of `model` with SGD, from the state dicts at
    `state_path` (gfla_tpu's weights, carried through convert.py)."""
    task = chip_smoke.sgd(create_task(step_opt(model, **over),
                                      torch.device("cpu")))
    state = torch.load(state_path, weights_only=True)
    task.vgg.load_state_dict(state.pop("VGG"))
    for tag, sd in state.items():
        chip_smoke.nets(task)[tag].load_state_dict(sd)
    return task


def sgd_step(state_path, index=0, size=1, model="pose", **over):
    """One SGD step on this band of the batch: its logs, gradients (the
    world's mean), parameters and buffers after it, and the spatial
    group's collectives it issued."""
    task = sgd_task(state_path, model, **over)
    batch = {k: band(v, index, size, 2) if v.dim() == 4 else v
             for k, v in step_batch(model).items()}
    before = parallel.band_collectives
    logs = task.train_step(batch)
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": chip_smoke.dp_grads(task),
            "replica": chip_smoke.replica_state(task),
            "collectives": parallel.band_collectives - before}


# the steps each rank of the dp 1 x sp 2 world takes beside pose's:
# (name, model, state, options)
STEPS = [("poseflownet", "poseflownet", "poseflownet", {}),
         ("shapenet", "shapenet", "shapenet", {}),
         ("shapenetflow", "shapenetflow", "shapenetflow", {}),
         ("pose_bf16", "pose", "pose_bf16", {"compute_dtype": "bfloat16"}),
         ("pose_remat", "pose", "pose", {"remat": True})]


CLI_ARGS = ["--gpu_ids=-1", "--mesh_devices=2", "--spatial=2",
            "--model=pose", "--dataset_mode=synthetic",
            f"--load_size={STEP_H}", "--batchSize=1", "--nThreads=0",
            "--print_freq=1", "--name=sp"]


# ShapeNet from the committed store: stage 1, then stage 2 resumed on it
VIEWS_ARGS = ["--gpu_ids=-1", "--mesh_devices=2", "--spatial=2",
              "--dataset_mode=shapenet", f"--dataroot={FIXTURE}",
              f"--load_size={STEP_H}", "--attn_layer=1",
              "--kernel_size=1=3", "--batchSize=1", "--nThreads=0",
              "--print_freq=1", "--name=views"]


def cli_loop(ckpt, *extra, args=CLI_ARGS):
    """The training CLI's loop on this rank, as its `main` starts it on
    each of the ranks it spawns."""
    from gfla_tpu_torch.options import (
        TrainOptions,
        refuse_parallel_flags,
        spatial_layout,
    )
    from gfla_tpu_torch.train.loop import train

    opt = TrainOptions().parse([*args, f"--checkpoints_dir={ckpt}",
                                *extra], show=False)
    refuse_parallel_flags(opt)
    assert spatial_layout(opt, 2, 2) == 2
    return train(torch.device("cpu"), opt)


def step_bands(device, state_dir, out_dir):
    """(c), the other heads' steps, pose's in bf16 and with --remat, and the
    CLI on this rank of a dp 1 x sp 2 world; results to
    `{out_dir}/step_rank{r}.pt`. The states are `{state_dir}/{state}.pt`."""
    torch.set_num_threads(THREADS)
    b = parallel.init_bands(2, HALO)
    out = {"step": sgd_step(os.path.join(state_dir, "pose.pt"), b.index, 2)}
    for name, model, state, over in STEPS:
        out[name] = sgd_step(os.path.join(state_dir, f"{state}.pt"),
                             b.index, 2, model, **over)
    ckpt = os.path.join(out_dir, "ckpt")
    out["cli"] = cli_loop(ckpt, "--max_iters=1", "--eval_iters_freq=1",
                          "--display_freq=1")
    out["resume"] = cli_loop(ckpt, "--max_iters=2", "--continue_train",
                             "--eval_iters_freq=0")
    out["views_flow"] = cli_loop(ckpt, "--model=shapenetflow",
                                 "--max_iters=1", "--eval_iters_freq=0",
                                 args=VIEWS_ARGS)
    out["views"] = cli_loop(ckpt, "--model=shapenet", "--layers=1",
                            "--continue_train",
                            "--max_iters=2", "--eval_iters_freq=2",
                            "--display_freq=2", args=VIEWS_ARGS)
    torch.save(out, os.path.join(out_dir,
                                 f"step_rank{parallel.world().rank}.pt"))

