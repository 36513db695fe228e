"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py [test options...]

Phases, each failing the run (non-zero exit) on the first error:
  1. card: CUDA must be present; prints nvidia-smi's name and power limit.
  2. build: compiles the CUDA kernels from gfla_tpu_torch/csrc with nvcc.
  3. kernel: the warp kernel against its plain torch version at both live
     attention sites of the DeepFashion generator, with far-off flows and
     at the sites of a 64x64 input; max errors and median times of both.
  4. bwd kernel: both backward kernels (per position; dW1s) against their
     plain versions in the same cases, each of the six outputs within
     1e-4 x its max |value|; median times of both.
  5. slice: the full-width pose generator (ngf 64, img_f 512, attention at
     levels 2/3 with kernels 5/3) serves four batch-8 requests of 256x176
     content in 256x256 tensors through PoseTask.test_step; checks shape,
     range, the kernel launch count, the plain-warp path and a CPU run on a
     small input; median ms per forward of both paths.
  6. train: the full-width pose training step (G as in 5, the 4-layer
     spectral-norm ResDiscriminator, VGG19, six G losses, two Adams) takes
     four batch-8 steps through the kernels: finite losses, every parameter
     moved, u stored by the two D passes and not by the G-loss pass, 2
     launches of each kernel per step; a checkpoint save/resume gives the
     same next step; one step against the plain path from one state and
     one card step against a CPU step at 2x64x64, gradients held against a
     float64 step; median ms per step of both paths and the peak memory.
Extra arguments go to the test options, e.g. `--checkpoints_dir DIR --name N
--which_iter latest` to serve an original-GFLA `latest_net_G.pth` instead of
the seeded random init. The last line is the JSON device record.
"""

from __future__ import annotations

import copy
import json
import statistics
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

KERNEL_ATOL = 1e-4  # f32, TF32 off: only the summation order differs
SLICE_ATOL = 1e-3   # the same, carried through ~20 conv/norm layers
CPU_ATOL = 1e-3     # card vs CPU on a small input: cuDNN vs CPU convs
FLOW_FAR = 2.5      # far-off flows reach +-2.5 H
BWD_REL = 1e-4      # backward: each output within 1e-4 x its max |value|
                    # (f32; summation order and atomicAdd order differ)
TRAIN_STEPS = 4
TRAIN_LOSS_REL = 1e-3  # two steps from one state: each loss, relative
GRAD_F64_REL = 5e-2  # each f32 gradient vs the f64 one, x its tensor's
                     # max: a check for gross faults; the flow net's
                     # gradients are small sums of larger terms, 1.6e-2 off
                     # in f32 at 64x64 on the CPU (2x2 bottleneck)
MASK_REL = 1e-3     # the parameters held tight: |grad| > 1e-3 x tensor max
PARAM_ATOL = 1e-6   # how tight
ADAM_FLOOR = 1e-6   # ... and |grad| > 100 x Adam's eps
RESOLVED = 10.0     # ... and |grad| > 10 x the tensor's f32 rounding
CKPT_REL = 1e-5     # the step after a save/resume vs the uninterrupted one

KERNEL_CASES = [  # name, B, H, W, C, D, k, flow scale (None: far-off)
    ("k=5 site 64x64 C128", 8, 64, 64, 128, 128, 5, 1.5),
    ("k=3 site 32x32 C256", 8, 32, 32, 256, 128, 3, 1.5),
    ("k=5 far-off flows", 8, 64, 64, 128, 128, 5, None),
    ("k=5 site at 64x64 input", 2, 16, 16, 128, 128, 5, 1.5),
    ("k=3 site at 64x64 input", 2, 8, 8, 256, 128, 3, 1.5),
]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_card():
    from gfla_tpu_torch.runtime import card_line

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")


def phase_build():
    from gfla_tpu_torch.ops._build import load_library

    t0 = time.perf_counter()
    load_library(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s")


def warp_inputs(B, H, W, C, D, k, flow_scale, seed, device):
    from gfla_tpu_torch.ops.local_attn import target_stream

    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    src, tgt = t(rng.randn(B, H, W, C)), t(rng.randn(B, H, W, C))
    if flow_scale is None:  # far-off: uniform in +-FLOW_FAR * H
        flow = t(rng.uniform(-FLOW_FAR * H, FLOW_FAR * H, (B, H, W, 2)))
    else:
        flow = t(rng.randn(B, H, W, 2) * flow_scale)
    w1 = t(rng.randn(k * k, 2 * C, D) * 0.05)
    b1, w2 = t(rng.randn(D) * 0.1), t(rng.randn(D, k * k) * 0.1)
    b2 = t(rng.randn(k * k) * 0.1)
    hidden_bt = target_stream(tgt, w1, b1, k)
    w1s = w1[:, C:, :].reshape(k * k * C, D).contiguous()
    return src, flow, hidden_bt, w1s, w2, b2


def phase_kernel(device):
    from gfla_tpu_torch.ops import warp

    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(KERNEL_CASES):
        args = warp_inputs(B, H, W, C, D, k, scale, i, device)
        got = warp.warp_fwd(*args, k)
        want = warp.warp_fwd_plain(*args, k)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        ms = cuda_ms(lambda: warp.warp_fwd(*args, k))
        plain_ms = cuda_ms(lambda: warp.warp_fwd_plain(*args, k))
        print(f"kernel {name}: B={B} max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (tol {KERNEL_ATOL:g} abs) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= KERNEL_ATOL, f"{name}: kernel vs plain {err:.3e}")
        results[name] = (err, ms, plain_ms)

    # what the wrapper refuses on a CUDA tensor, before any launch
    args = warp_inputs(1, 8, 8, 16, 32, 3, 1.0, 9, device)
    refusals = {
        "even k": (ValueError, lambda: warp.warp_fwd(
            *warp_inputs(1, 8, 8, 16, 32, 4, 1.0, 9, device), 4)),
        "D > 256": (ValueError, lambda: warp.warp_fwd(
            *warp_inputs(1, 8, 8, 16, 320, 3, 1.0, 9, device), 3)),
        "non-contiguous": (ValueError, lambda: warp.warp_fwd(
            args[0].transpose(1, 2), *args[1:], 3)),
        "bfloat16": (TypeError, lambda: warp.warp_fwd(
            args[0].detach().bfloat16(), *args[1:], 3)),
    }
    for name, (exc, call) in refusals.items():
        try:
            call()
        except exc:
            continue
        raise RuntimeError(f"FAILED: the wrapper accepted {name}")
    print(f"wrapper refuses: {', '.join(refusals)}")

    # an input that requires grad goes through WarpFunction: forward kernel,
    # then both backward kernels
    src = args[0].clone().requires_grad_()
    counts = (warp.launches, warp.bwd_pos_launches, warp.bwd_w1_launches)
    warp.warp_fwd(src, *args[1:], 3).square().sum().backward()
    torch.cuda.synchronize()
    after = (warp.launches, warp.bwd_pos_launches, warp.bwd_w1_launches)
    check([b - a for a, b in zip(counts, after)] == [1, 1, 1],
          f"requires_grad launches {counts} -> {after}")
    check(src.grad is not None and bool(torch.isfinite(src.grad).all()),
          "requires_grad: no finite gradient")
    print("a requires_grad input launched the forward and both backward "
          "kernels")
    return results


BWD_OUTPUTS = ("d_source", "d_flow", "d_hidden_bt", "dW1s", "dW2", "db2")


def phase_bwd_kernel(device):
    """Both backward kernels against warp_bwd_pos_plain/warp_bwd_w1_plain at
    the two live sites and with far-off flows: each of the six outputs
    within BWD_REL x its max |value|."""
    from gfla_tpu_torch.ops import warp

    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(KERNEL_CASES):
        args = warp_inputs(B, H, W, C, D, k, scale, 20 + i, device)
        g = torch.from_numpy(np.random.RandomState(30 + i).randn(
            B, H, W, C).astype(np.float32)).to(device)
        got = warp.warp_bwd(*args, g, k)
        want = warp.warp_bwd_plain(*args, g, k)
        torch.cuda.synchronize()
        errs = []
        for out, a, b in zip(BWD_OUTPUTS, got, want):
            err = (a - b).abs().max().item()
            bound = BWD_REL * b.abs().max().item()
            check(bool(torch.isfinite(a).all()), f"{name}: {out} non-finite")
            check(err <= bound, f"{name}: {out} kernel vs plain {err:.3e} > "
                  f"{bound:.3e}")
            errs.append(err)
        d_hpre = want[2]
        pos_ms = cuda_ms(lambda: warp.warp_bwd_pos(*args, g, k), iters=10)
        pos_plain = cuda_ms(lambda: warp.warp_bwd_pos_plain(*args, g, k),
                            iters=10)
        w1_ms = cuda_ms(lambda: warp.warp_bwd_w1(args[0], args[1], d_hpre, k),
                        iters=10)
        w1_plain = cuda_ms(lambda: warp.warp_bwd_w1_plain(
            args[0], args[1], d_hpre, k), iters=10)
        print(f"backward {name}: max_abs_err "
              + " ".join(f"{o}={e:.3e}" for o, e in zip(BWD_OUTPUTS, errs))
              + f" (tol {BWD_REL:g} x max|value|); per-position kernel "
              f"{pos_ms:.4f} ms plain {pos_plain:.4f} ms; dW1s kernel "
              f"{w1_ms:.4f} ms plain {w1_plain:.4f} ms")
        results[name] = dict(pos=(max(errs[:3] + errs[4:]), pos_ms, pos_plain),
                             w1=(errs[3], w1_ms, w1_plain))

    args = warp_inputs(1, 8, 8, 16, 32, 3, 1.0, 9, device)
    g = torch.zeros(1, 8, 8, 16, device=device)
    refusals = {
        "g of the wrong shape": (ValueError, lambda: warp.warp_bwd(
            *args, g[:, :4], 3)),
        "non-contiguous g": (ValueError, lambda: warp.warp_bwd(
            *args, g.transpose(1, 2), 3)),
        "float64 d_hpre": (ValueError, lambda: warp.warp_bwd_w1(
            args[0], args[1], args[2].double(), 3)),
    }
    for what, (exc, call) in refusals.items():
        try:
            call()
        except exc:
            continue
        raise RuntimeError(f"FAILED: the backward wrapper accepted {what}")
    print(f"backward wrapper refuses: {', '.join(refusals)}")
    return results


def deepfashion_batch(seed, B=8, size=256, content_w=176, structure_nc=18):
    """Random images in the DeepFashion layout: content in a centred
    256x176 band of a 256x256 tensor, white (1.0) side borders; keypoints
    (y, x) inside the band."""
    rng = np.random.RandomState(seed)
    x0 = (size - content_w) // 2
    imgs = np.ones((2, B, size, size, 3), np.float32)
    imgs[:, :, :, x0:x0 + content_w] = rng.rand(
        2, B, size, content_w, 3).astype(np.float32) * 2 - 1
    kp = rng.rand(2, B, structure_nc, 2).astype(np.float32)
    kp[..., 0] *= size - 1
    kp[..., 1] = kp[..., 1] * (content_w - 1) + x0
    return {"P1": imgs[0], "KP1": kp[0], "P2": imgs[1], "KP2": kp[1]}


def phase_slice(extra_args):
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    opt = TestOptions().parse(
        ["--model=pose", "--dataset_mode=synthetic", "--load_size=256",
         "--batchSize=8", "--gpu_ids=0", *extra_args], save=False)
    task = create_task(opt)
    task.load_checkpoint()
    g = task.net_g
    check(g.source.block0.model[2].out_channels == 64
          and g.target.attn1.kernel_size == 5
          and g.target.attn0.kernel_size == 3, "not the full-width config")
    print(f"generator: {sum(p.numel() for p in g.parameters())} parameters "
          f"on {task.device}")

    requests = [task.prepare_batch(deepfashion_batch(seed))
                for seed in range(4)]
    reset_launch_counts()
    outs = [task.test_step(batch) for batch in requests]
    torch.cuda.synchronize()
    launches = launch_counts()["warp_fwd"]
    print(f"served {len(requests)} requests: {launches} kernel launches")
    check(launches == 2 * len(requests),
          f"{launches} launches for {len(requests)} forwards, expected 2 each")
    for img, flows, masks in outs:
        check(tuple(img.shape) == (8, 3, 256, 256), f"shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "non-finite output")
        check(img.min().item() >= -1 and img.max().item() <= 1,
              "output outside [-1, 1]")
        check([tuple(f.shape) for f in flows] == [(8, 2, 32, 32),
                                                  (8, 2, 64, 64)],
              "flow shapes")

    not_cl = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: not_cl.append(name)
        if isinstance(out, torch.Tensor) and out.dim() == 4
        and not out.is_contiguous(memory_format=torch.channels_last)
        else None) for name, m in g.named_modules()]
    task.test_step(requests[0])
    for h in hooks:
        h.remove()
    print(f"layout: module outputs not channels_last: {not_cl}")

    with plain_warp():
        plain_img = task.test_step(requests[0])[0]
    diff = (outs[0][0] - plain_img).abs().max().item()
    print(f"kernel path vs plain path: max_abs_diff={diff:.3e} "
          f"(bound {SLICE_ATOL:g})")
    check(diff <= SLICE_ATOL, f"kernel path vs plain path {diff:.3e}")

    small = task.prepare_batch(deepfashion_batch(7, B=2, size=64,
                                                 content_w=44))
    card_img = task.test_step(small)[0].cpu()
    cpu_task = copy.copy(task)
    cpu_task.net_g = copy.deepcopy(g).cpu()
    cpu_img = cpu_task.test_step({k: v.cpu() for k, v in small.items()})[0]
    diff_cpu = (card_img - cpu_img).abs().max().item()
    print(f"card vs CPU at 2x64x64: max_abs_diff={diff_cpu:.3e} "
          f"(bound {CPU_ATOL:g})")
    check(diff_cpu <= CPU_ATOL, f"card vs CPU {diff_cpu:.3e}")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with plain_warp():
        plain_ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    ms_again = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    print(f"forward batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(again {ms_again:.3f}), plain path {plain_ms:.3f} ms, "
          f"peak {peak:.0f} MiB")
    return launches


def launch_counts():
    from gfla_tpu_torch.ops import warp

    return {"warp_fwd": warp.launches, "warp_bwd_pos": warp.bwd_pos_launches,
            "warp_bwd_w1": warp.bwd_w1_launches}


def reset_launch_counts():
    from gfla_tpu_torch.ops import warp

    warp.launches = warp.bwd_pos_launches = warp.bwd_w1_launches = 0


def plain_warp():
    """The plain path: the warp as `warp_fwd_plain`, differentiated by
    autograd, so neither kernel nor WarpFunction is on it."""
    from gfla_tpu_torch.ops import warp

    return mock.patch.object(warp, "warp_fwd", warp.warp_fwd_plain)


def nets(task):
    return {"G": task.net_g, "D": task.net_d}


def snapshot(task):
    """Parameters, gradients and spectral-norm u buffers, cloned."""
    return {tag: dict(
        params={n: p.detach().clone() for n, p in net.named_parameters()},
        grads={n: p.grad.detach().clone() for n, p in net.named_parameters()
               if p.grad is not None},
        u={n: b.clone() for n, b in net.named_buffers()
           if n.endswith("weight_u")})
        for tag, net in nets(task).items()}


def exact_grads(task, batch):
    """Gradients of one step of `task`'s state in float64 on the plain path
    (the kernels take float32 only): the reference that tells the
    gradients f32 resolves from those it does not."""
    task = copy.deepcopy(task)
    for module in (task.net_g, task.net_d, task.vgg):
        module.double()
    with plain_warp():
        task.train_step({k: v.double() for k, v in batch.items()})
    grads = {tag: s["grads"] for tag, s in snapshot(task).items()}
    del task
    torch.cuda.empty_cache()
    return grads


def check_step_pair(what, logs_a, snap_a, logs_b, snap_b, exact, lrs,
                    masked=True):
    """Two steps from one state, a (kernel path, card) against b (plain path,
    CPU): losses within TRAIN_LOSS_REL; each gradient of a within
    GRAD_F64_REL x its tensor's largest exact |grad| of the exact (float64)
    one (b's is printed: the CPU's f32 is the further off of the two at
    64x64); the updated parameters within 2 lr everywhere
    and, with `masked`, within PARAM_ATOL where |exact grad| > MASK_REL x
    that largest one, where f32 resolves it, and where Adam's step is a
    sign.

    Adam's first step with beta1 = 0 is lr * g / (|g| + 1e-8): lr * sign(g)
    where |g| is well above 1e-8, lr * g / 1e-8 where it is not, and there
    the f32 rounding of g is multiplied by lr / 1e-8 = 1e4. So an entry is
    held tight only where |exact g| > ADAM_FLOOR and > RESOLVED x the
    tensor's f32 rounding (its largest f32-vs-f64 gradient difference on
    either side); the rest are held to 2 lr. A tensor whose exact gradient
    is 0 (a conv bias feeding an instance norm) gets f32 rounding as its
    gradient and is held to 2 lr only."""
    faults = []
    loss_rel = 0.0
    for name, want in logs_b.items():
        got, want = float(logs_a[name]), float(want)
        rel = abs(got - want) / max(abs(want), 1e-30)
        if not (np.isfinite(got) and rel <= TRAIN_LOSS_REL):
            faults.append(f"loss {name} {got} vs {want}")
        loss_rel = max(loss_rel, rel)
    grad_rel = [0.0, 0.0]
    param_err = floored_err = 0.0
    held = skipped = n_big = n_signed = n_resolved = 0
    for tag, lr in lrs.items():
        ex = exact[tag]
        scale = max(g.abs().max().item() for g in ex.values())
        for name, a in snap_a[tag]["params"].items():
            diff = (a - snap_b[tag]["params"][name]).abs()
            if diff.max().item() > 2 * lr:
                faults.append(f"{tag} {name} moved {diff.max().item():.3e} "
                              f"apart, > 2 lr")
            g64 = ex[name]
            top = g64.abs().max().item()
            if top <= 1e-9 * scale:  # exactly 0 in f64
                skipped += 1
                continue
            grads = [side[tag]["grads"][name].double()
                     for side in (snap_a, snap_b)]
            sides = [(g - g64).abs().max().item() for g in grads]
            rounding = max(sides)
            if sides[0] > GRAD_F64_REL * top:
                faults.append(f"{tag} {name} grad off the f64 one by "
                              f"{sides[0] / top:.3e} of its max {top:.3e}")
            grad_rel = [max(r, e / top) for r, e in zip(grad_rel, sides)]
            held += 1
            if not masked:
                continue
            big = g64.abs() > MASK_REL * top
            signed = big & (g64.abs() > ADAM_FLOOR)
            resolved = signed & (g64.abs() > RESOLVED * rounding)
            n_big += int(big.sum())
            n_signed += int(signed.sum())
            n_resolved += int(resolved.sum())
            if big.any():
                floored_err = max(floored_err, diff[big].max().item())
            if not resolved.any():
                continue
            i = torch.where(resolved, diff, 0).argmax()
            err = diff.flatten()[i].item()
            param_err = max(param_err, err)
            if err > PARAM_ATOL:
                faults.append(
                    f"{tag} {name} updated {err:.3e} apart at an entry with "
                    f"grad f64 {g64.flatten()[i].item():.4e}, "
                    f"{grads[0].flatten()[i].item():.4e} vs "
                    f"{grads[1].flatten()[i].item():.4e}")
    rule = (f"updated parameters within {param_err:.3e} (bound {PARAM_ATOL:g})"
            f" at the {n_resolved} of {n_big} entries with |grad| > "
            f"{MASK_REL:g} max that Adam signs ({n_signed}) and f32 "
            f"resolves, within {floored_err:.3e} at all {n_big}" if masked else
            "updated parameters within 2 lr")
    print(f"{what}: losses within {loss_rel:.3e} rel; gradients within "
          f"{grad_rel[0]:.3e} and {grad_rel[1]:.3e} of each tensor's max of "
          f"the f64 step's; {rule}; "
          f"{held} tensors, {skipped} more with zero f64 gradient held to "
          f"2 lr")
    for fault in faults[:40]:
        print(f"  {what}: {fault}")
    check(not faults, f"{what}: {len(faults)} faults")


def timed_steps(task, batches):
    """One train_step per batch: (CUDA-event milliseconds, logs) of each."""
    times, logs = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logs.append(task.train_step(batch))
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times, logs


def off_the_kinks(task):
    """A copy of `task` whose flow heads' biases are seeded fractions in
    [0.3, 0.7]. At the seeded init the flows are nearly 0, so every sample
    of the warp and of the correctness loss's resampler sits on an integer
    coordinate, where floor() makes the gradient jump; the last bits of a
    float32 flow then decide the side, and no two summation orders (f32 vs
    f64, card vs CPU) agree there. Between integers both are smooth."""
    task = copy.deepcopy(task)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, head in task.net_g.flow_net.named_children():
            if name.startswith("output"):
                head.bias.copy_(0.3 + 0.4 * torch.rand(
                    head.bias.shape, generator=gen))
    return task


def compare_steps(what, state, batch, lrs, to_cpu=False):
    """One step of `state` on the kernel path against one on the plain path
    (or, with `to_cpu`, one on the card against one on the CPU), both held
    against a float64 step by check_step_pair; card and CPU convolutions
    round differently all through G, so that pair is not masked."""
    exact = exact_grads(state, batch)
    a = copy.deepcopy(state)
    logs_a = a.train_step(batch)
    snap_a = snapshot(a)
    del a
    b = copy.deepcopy(state)
    if to_cpu:
        for module in (b.net_g, b.net_d, b.vgg):
            module.cpu()
        logs_b = b.train_step({k: v.cpu() for k, v in batch.items()})
    else:
        with plain_warp():
            logs_b = b.train_step(batch)
    snap_b = {tag: {kind: {n: t.to(batch["P1"].device) for n, t in d.items()}
                    for kind, d in s.items()}
              for tag, s in snapshot(b).items()}
    del b
    check_step_pair(what, logs_a, snap_a, logs_b, snap_b, exact, lrs,
                    masked=not to_cpu)


def phase_train():
    """The full-width pose training step (D then G) through the kernels."""
    from gfla_tpu_torch.options import TrainOptions
    from gfla_tpu_torch.tasks import create_task

    ckpt = tempfile.TemporaryDirectory()
    opt = TrainOptions().parse(
        ["--model=pose", "--dataset_mode=synthetic", "--load_size=256",
         "--batchSize=8", "--gpu_ids=0", f"--checkpoints_dir={ckpt.name}",
         "--name=train_smoke"], save=False)
    opt.iters_per_epoch = 1000
    task = create_task(opt)
    check(task.net_g.source.block0.model[2].out_channels == 64
          and task.net_d.block0.model[1].weight_orig.shape[0] == 32
          and task.net_d.layers == 4, "not the full-width train config")
    lrs = {"G": opt.lr, "D": opt.lr * opt.ratio_g2d}
    batches = [task.prepare_batch(deepfashion_batch(100 + s))
               for s in range(TRAIN_STEPS + 1)]
    state0 = copy.deepcopy(task)
    s0 = snapshot(state0)

    # the main path: TRAIN_STEPS kernel steps, counted and timed; step 1
    # records the D u buffers after each D pass
    u_seen = []
    hook = task.net_d.register_forward_hook(
        lambda mod, args, kwargs, out: u_seen.append(
            (kwargs.get("update_stats"),
             {n: b.clone() for n, b in mod.named_buffers()
              if n.endswith("weight_u")})), with_kwargs=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, logs = timed_steps(task, batches[:1])
    hook.remove()
    u_after = snapshot(task)
    more_times, more_logs = timed_steps(task, batches[1:TRAIN_STEPS])
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    times, logs = times + more_times, logs + more_logs
    print(f"trained {TRAIN_STEPS} steps: kernel launches {counts}")
    check(counts == {name: 2 * TRAIN_STEPS for name in counts},
          f"launches {counts} for {TRAIN_STEPS} steps, expected 2 forward "
          f"and 2 of each backward kernel per step")

    # losses finite; parameters moved; u stored by the D step only
    for i, step_logs in enumerate(logs):
        check(sorted(step_logs) == sorted(task.loss_names + ["total_G"]),
              f"loss names {sorted(step_logs)}")
        for name, v in step_logs.items():
            check(bool(torch.isfinite(v)), f"step {i + 1}: {name} not finite")
    for i in (0, TRAIN_STEPS - 1):
        print(f"losses, step {i + 1}: " + " ".join(
            f"{k} {float(v):.5f}" for k, v in logs[i].items()))
    for tag, net in nets(task).items():
        still = [n for n, p in net.named_parameters()
                 if torch.equal(p, s0[tag]["params"][n])]
        check(not still, f"{tag}: parameters unchanged: {still}")
    check([flag for flag, _ in u_seen] == [True, True, False],
          f"D passes of step 1: update_stats {[f for f, _ in u_seen]}")
    u0, (_, u_real), (_, u_fake), (_, u_gen) = s0["D"]["u"], *u_seen
    spectral = [n for n in u0 if u0[n].numel() > 1]  # 1 output: u is 1
    for n in spectral:
        check(not torch.equal(u_real[n], u0[n])
              and not torch.equal(u_fake[n], u_real[n]),
              f"D step left {n} unchanged")
        check(torch.equal(u_gen[n], u_fake[n])
              and torch.equal(u_after["D"]["u"][n], u_fake[n]),
              f"the G-loss pass stored {n}")
    print(f"u: D(real) and D(fake) each stored a new u in the "
          f"{len(spectral)} spectral convs with more than one output; the "
          f"G-loss pass stored none")

    # the plain path's time per step, from the state the main path reached
    plain = copy.deepcopy(task)
    with plain_warp():
        plain_times, _ = timed_steps(plain, batches[1:TRAIN_STEPS])
    del plain

    # checkpoint round trip: the resumed task's next step equals this one's
    task.save(TRAIN_STEPS)
    resumed = create_task(opt)
    check(resumed.resume("latest") == TRAIN_STEPS, "resume step")
    want = task.train_step(batches[TRAIN_STEPS])
    got = resumed.train_step(batches[TRAIN_STEPS])
    ckpt_rel = max(abs(float(got[n]) - float(want[n]))
                   / max(abs(float(want[n])), 1e-30) for n in want)
    print(f"checkpoint save/resume at step {TRAIN_STEPS}: next-step losses "
          f"within {ckpt_rel:.3e} rel (bound {CKPT_REL:g})")
    check(ckpt_rel <= CKPT_REL, f"resumed step {got} vs {want}")
    del resumed, task
    ckpt.cleanup()

    # one step from one state: kernel vs plain path; card vs CPU
    state = off_the_kinks(state0)
    del state0
    compare_steps("kernel vs plain path, batch 8 at 256x256", state,
                  batches[0], lrs)
    small = state.prepare_batch(deepfashion_batch(7, B=2, size=64,
                                                  content_w=44))
    compare_steps("card vs CPU at 2x64x64", state, small, lrs, to_cpu=True)

    ms = statistics.median(times[1:])
    plain_ms = statistics.median(plain_times)
    print(f"train step batch 8 at 256x256: kernel path {ms:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in times)}), plain path "
          f"{plain_ms:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in plain_times)}), "
          f"peak {peak:.2f} GiB")
    return counts


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from gfla_tpu_torch.runtime import set_tf32

    set_tf32(False)
    phase_card()
    phase_build()
    kernel = phase_kernel(device)
    bwd = phase_bwd_kernel(device)
    serve = phase_slice(argv)
    train = phase_train()
    shape = "k=5 B=8 64x64 C=128 D=128"
    _, ms, plain_ms = kernel["k=5 site 64x64 C128"]
    entries = [{
        "name": "warp_fwd", "route": "cuda",
        "source": "gfla_tpu_torch/csrc/warp_fwd.cu",
        "replaces": "gfla_tpu/ops/pallas_warp.py:166",
        "launches": serve + train["warp_fwd"],
        "launches_by_path": {"serve": serve, "train": train["warp_fwd"]},
        "max_abs_err": max(e for e, _, _ in kernel.values()),
        "ms": ms, "plain_ms": plain_ms, "ms_shape": shape}]
    for name, part in (("warp_bwd_pos", "pos"), ("warp_bwd_w1", "w1")):
        entries.append({
            "name": name, "route": "cuda",
            "source": "gfla_tpu_torch/csrc/warp_bwd.cu",
            "replaces": "gfla_tpu/ops/pallas_warp.py:243",
            "launches": train[name],
            "max_abs_err": max(r[part][0] for r in bwd.values()),
            "tolerance": f"{BWD_REL:g} x max|value| of each output",
            "ms": bwd["k=5 site 64x64 C128"][part][1],
            "plain_ms": bwd["k=5 site 64x64 C128"][part][2],
            "ms_shape": shape})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
