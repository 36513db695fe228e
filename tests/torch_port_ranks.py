"""The rank side of tests/test_torch_port_parallel.py: small tasks, batches
and the steps that every rank of a 2-rank gloo world on the CPU runs
(`rank_steps`, started by gfla_tpu_torch.parallel.spawn), and that the test
process runs once more as one rank on the whole batch. Torch and the port
only: no jax, so that a rank starts fast.

Sizes: 32x32, G at ngf 8, img_f 32 with both attention levels (k=5 at
8x8, k=3 at 4x4), D at ndf 8, img_f 16, 3 layers; global batches of 2 (one
row a rank, as gfla_tpu's 8-device test has one a device): pose pairs,
dance clips of 5 frames with --use_mask, keypoint windows of 86 frames.
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch

import chip_smoke
from gfla_tpu_torch import parallel
from gfla_tpu_torch.data.pose_utils import encode_heatmaps
from gfla_tpu_torch.losses.perceptual import PerceptualCorrectness
from gfla_tpu_torch.tasks.animation import DanceTask
from gfla_tpu_torch.tasks.keypoint import KeypointTask
from gfla_tpu_torch.tasks.pose import PoseTask

H = 32
POSE_B, DANCE_B, KP_B = 2, 2, 2  # one row a rank, as gfla_tpu's 8-vs-1 test
DANCE_T, DANCE_NC = 5, 20
KP_T = 86
MASK_T = 3  # frames of the masked correctness loss's folded batch
THREADS = 2


def _namespace(base, over):
    opt = argparse.Namespace(**base)
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


COMMON = dict(
    phase="train", isTrain=True, load_size=H, image_nc=3, layers=3,
    attn_layer=[2, 3], kernel_size={"2": 5, "3": 3}, ngf=8, img_f=32, ndf=8,
    d_img_f=16, d_layers=3, use_spect_g=False, no_spect_d=False, lr=1e-4,
    lr_policy="lambda", niter=100, niter_decay=0, iter_count=1,
    iters_per_epoch=10, gan_mode="lsgan", ratio_g2d=0.1, lambda_rec=5.0,
    lambda_g=2.0, lambda_correct=5.0, lambda_style=500.0, lambda_content=0.5,
    lambda_regularization=0.0025, compute_dtype="float32", seed=0,
    gpu_ids="-1", remat=False)


def pose_opt(**over):
    return _namespace(dict(COMMON, model="pose", dataset_mode="synthetic",
                           batchSize=POSE_B, old_size=(H, H),
                           structure_nc=18), over)


def dance_opt(**over):
    return _namespace(dict(
        COMMON, model="dance", dataset_mode="synthetic_video",
        batchSize=DANCE_B, structure_nc=DANCE_NC, frames_D_V=DANCE_T,
        max_frames_per_gpu=DANCE_T, n_frames_total=DANCE_T,
        use_mask=True), over)


def kp_opt(**over):
    return _namespace(dict(
        model="keypoint", dataset_mode="keypoint", phase="train",
        isTrain=True, batchSize=KP_B, structure_nc=17, lr=1e-4,
        lr_policy="lambda", niter=100, niter_decay=0, iter_count=1,
        iters_per_epoch=10, seed=0, gpu_ids="-1"), over)


def pose_batch(seed, B=POSE_B):
    """A prepared pose batch, NCHW in channels_last memory."""
    rng = np.random.RandomState(seed)
    kp = torch.from_numpy(rng.rand(2, B, 18, 2).astype(np.float32) * (H - 1))
    images = torch.from_numpy(
        (rng.rand(2, B, 3, H, H) * 2 - 1).astype(np.float32))
    batch = {"P1": images[0], "P2": images[1],
             "BP1": encode_heatmaps(kp[0], H, H).permute(0, 3, 1, 2),
             "BP2": encode_heatmaps(kp[1], H, H).permute(0, 3, 1, 2)}
    return {k: v.contiguous(memory_format=torch.channels_last)
            for k, v in batch.items()}


def _masks(rng, B, T, h, w):
    """(B, T, 1, h, w) person masks that differ between batch rows: row b
    keeps a block whose width grows with b, soft values around it and
    zeros, so that each half of the batch has its own mask sums."""
    mask = np.clip(rng.rand(B, T, 1, h, w) * 1.5 - 0.25, 0, 1)
    for b in range(B):
        mask[b, :, :, h // 4:3 * h // 4, :(b + 1) * w // (B + 1)] = 1.0
        mask[b, :, :, :, (b + 2) * w // (B + 2):] *= 0.1 * b
    return mask.astype(np.float32)


def dance_chunk(seed, B=DANCE_B):
    """A first chunk (the reference pair as the carry) of a masked dance
    clip, in the port's layout."""
    rng = np.random.RandomState(seed)
    T = DANCE_T

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    ref = t(np.tanh(rng.randn(B, 3, H, H)))
    ref_skel = t(rng.rand(B, DANCE_NC, H, H))
    return {"P_step": t(np.tanh(rng.randn(B, T, 3, H, H))),
            "BP_step": t(rng.rand(B, T, DANCE_NC, H, H)),
            "ref_image": ref, "ref_skeleton": ref_skel, "pre_image": ref,
            "pre_skeleton": ref_skel, "pre_gt_image": ref,
            "mask_step": t(_masks(rng, B, T, H, H))}


def kp_batch(seed, B=KP_B):
    rng = np.random.RandomState(seed)
    return {"input_data": torch.from_numpy(
                rng.randn(B, KP_T, 34).astype(np.float32) * 0.5),
            "gt_data": torch.from_numpy(
                rng.randn(B, KP_T - 80, 34).astype(np.float32) * 0.5)}


def kp_masks(seed, B=KP_B):
    return chip_smoke.kp_dropout_masks(B, KP_T, np.random.RandomState(seed))


def masked_inputs(seed=5, B=2, T=MASK_T, C=16, h=8):
    """The masked correctness loss's inputs on a folded batch of B * T
    frames: target and source features (B*T, C, h, h), a flow (B*T, 2, h,
    h) and masks (B*T, 1, 2h, 2h) that differ between the batch rows."""
    rng = np.random.RandomState(seed)
    feats = np.maximum(rng.randn(2, B * T, C, h, h), 0).astype(np.float32)
    flow = (rng.rand(B * T, 2, h, h) * 3 - 1.5).astype(np.float32)
    mask = _masks(rng, B, T, 2 * h, 2 * h).reshape(B * T, 1, 2 * h, 2 * h)
    return {"target": torch.from_numpy(feats[0]),
            "source": torch.from_numpy(feats[1]),
            "flow": torch.from_numpy(flow), "mask": torch.from_numpy(mask)}


def rows(tree, rank, size):
    """This rank's contiguous block of every tensor's leading axis."""
    def block(t):
        n = t.shape[0] // size
        return t[rank * n:(rank + 1) * n]
    if isinstance(tree, dict):
        return {k: rows(v, rank, size) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rows(v, rank, size) for v in tree]
    return block(tree)


def noised(task, seed):
    """The keypoint net's parameters replaced by seeded noise (kernels
    N(0, 1/fan_in), the rest N(0, 0.1^2), the layer norms' scales 1 + that),
    so that every tensor has gradients f32 resolves."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in task.net_g.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.shape[1:] == (1,):  # LayerNormAll's (C, 1) affine
                p.copy_(noise * 0.1 + float(name.endswith("weight")))
            elif p.dim() >= 2:
                p.copy_(noise / np.sqrt(p[0].numel()))
            else:
                p.copy_(noise * 0.1)
    return task


def step_logs(logs):
    """A step's logs averaged over the ranks, as floats."""
    return {k: float(v) for k, v in parallel.allreduce_mean(logs).items()}


def pose_sgd(rank=0, size=1, task=None, dtype="float32"):
    task = chip_smoke.sgd(task or PoseTask(pose_opt(compute_dtype=dtype)))
    logs = task.train_step(rows(pose_batch(1), rank, size))
    return {"logs": step_logs(logs), "grads": chip_smoke.dp_grads(task)}


def dance_sgd(rank=0, size=1):
    task = chip_smoke.sgd(DanceTask(dance_opt()))
    indices = task.draw_indices(DANCE_T)
    logs, _ = task.train_chunk(rows(dance_chunk(2), rank, size))
    return {"logs": step_logs(logs), "grads": chip_smoke.dp_grads(task),
            "indices": indices}


def kp_sgd(rank=0, size=1):
    task = chip_smoke.sgd(noised(KeypointTask(kp_opt()), 4))
    with chip_smoke.fixed_dropout(task.net_g, rows(kp_masks(3), rank, size)):
        logs = task.train_step(rows(kp_batch(6), rank, size))
    return {"logs": step_logs(logs), "grads": chip_smoke.dp_grads(task)}


def masked_loss(rank=0, size=1):
    """This rank's masked correctness loss (frames=MASK_T) on its rows and
    its gradient in its flow rows."""
    x = rows(masked_inputs(), rank, size)
    flow = x["flow"].clone().requires_grad_(True)
    loss = PerceptualCorrectness.layer_loss(x["target"], x["source"], flow,
                                            x["mask"], frames=MASK_T)
    loss.backward()
    return {"loss": loss.detach(), "mean": step_logs({"loss": loss})["loss"],
            "d_flow": flow.grad}


def pose_adam(out, remat, ckpt, task=None):
    """Two Adam steps of `task` (a new one if None; the replicas after
    them); with `ckpt`, a save there, a fresh task resumed from it, and the
    next step of both."""
    at = parallel.world()
    opt = pose_opt(remat=remat, use_spect_g=remat, checkpoints_dir=ckpt,
                   name="dp")
    if task is None:
        task = PoseTask(opt)
    task.opt = opt
    for seed in (2, 3):
        task.train_step(rows(pose_batch(seed), at.rank, at.size))
    out["replica"] = chip_smoke.replica_state(task)
    if ckpt is None:
        return
    task.save(2)
    resumed = PoseTask(opt)
    out["resumed_at"] = resumed.resume("latest")
    batch = rows(pose_batch(4), at.rank, at.size)
    # the two steps on one thread, in torch's deterministic algorithms: with
    # threads, MKL may take fewer of them when the cores are busy, which
    # reorders its sums, and under load that parted two runs from one state
    # in the last bits
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    try:
        for key, t in (("next", task), ("resumed", resumed)):
            out[f"{key}_logs"] = step_logs(t.train_step(batch))
            out[f"{key}_replica"] = chip_smoke.replica_state(t)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(THREADS)


def resumed_apart():
    """parallel.same_everywhere on a value every rank shares, then on one
    that differs between them (the rank): the error this rank raised, or
    None."""
    at = parallel.world()
    parallel.same_everywhere(7, "shared")
    try:
        parallel.same_everywhere(at.rank, "resumed")
    except RuntimeError as e:
        return str(e)
    return None


def rank_steps(device, out_dir):
    """Every scenario on this rank; its results to
    `{out_dir}/rank{r}.pt`."""
    torch.set_num_threads(THREADS)
    at = parallel.world()
    pose = PoseTask(pose_opt())
    out = {"world": (at.rank, at.size, at.local_rank, at.local_size,
                     at.node, at.nodes),
           "masked": masked_loss(at.rank, at.size),
           "pose": pose_sgd(at.rank, at.size, copy.deepcopy(pose)),
           "pose_bf16": pose_sgd(at.rank, at.size, dtype="bfloat16"),
           "dance": dance_sgd(at.rank, at.size),
           "keypoint": kp_sgd(at.rank, at.size),
           "apart": resumed_apart(), "adam": {}, "remat": {}}
    pose_adam(out["adam"], False, os.path.join(out_dir, "ckpt"), pose)
    pose_adam(out["remat"], True, None)
    torch.save(out, os.path.join(out_dir, f"rank{at.rank}.pt"))
