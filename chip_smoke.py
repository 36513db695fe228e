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
  7. corr kernel: the max-correlation kernel against its plain scan at both
     sites of the correctness loss, at a ragged shape and with duplicated
     and zero rows (exact ties); median ms of the kernel, the scan and one
     unchunked torch.bmm + max, the yardstick the port never calls.
  8. attn-math kernels: the math-fused forward and backward against their
     plain twins at both attention sites and a ragged N; median ms of each.
  9. poseflownet: stage-1 flow pretraining at full width, batch 8, with
     GFLA_PALLAS_CORR=1: four steps, 2 max-correlation launches each;
     finite losses; every parameter the losses reach moved; one step
     against the scan path from one state (float64 rule as in 6); a save,
     then the pose task's --continue_train on it starts its flow net from
     it (the two-stage protocol); median ms per step of both paths.
 10. switches: the pose head under GFLA_ATTN_PALLAS=1 (serving, one training
     step) and GFLA_PALLAS_CORR=1 (one training step): the kernels each
     setting selects, and agreement with the default path.
The switches are set per phase with mock.patch.dict, so none leaks into the
next; every other phase runs with GFLA_ATTN_PALLAS=auto, GFLA_PALLAS_CORR=0.
Extra arguments go to the test options, e.g. `--checkpoints_dir DIR --name N
--which_iter latest` to serve an original-GFLA `latest_net_G.pth` instead of
the seeded random init. The last line is the JSON device record.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
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
FLOW_GRAD_F64_REL = 1e-1  # the same for the stage-1 flow net alone: its
                     # deepest encoder weights get gradients of ~1e-6 that
                     # f32 sums 6.9e-2 off the f64 ones on both paths alike
FLOW_PAIR_REL = BWD_REL  # ... so its kernel path is also held to its scan
                     # path, each gradient within this x the tensor's max:
                     # both take the same argmax, and their cmax differ in
                     # the last bits (losses ~4e-7 apart), which those small
                     # gradients magnify to ~7e-6 of a tensor's max on an
                     # H100
MASK_REL = 1e-3     # the parameters held tight: |grad| > 1e-3 x tensor max
PARAM_ATOL = 1e-6   # how tight
ADAM_FLOOR = 1e-6   # ... and |grad| > 100 x Adam's eps
RESOLVED = 10.0     # ... and |grad| > 10 x the tensor's f32 rounding
CKPT_REL = 1e-5     # the step after a save/resume vs the uninterrupted one
CORR_ATOL = 1e-5    # max-correlation: cmax, and argmax where the top-two
                    # gap of the plain correlation exceeds it
F32_PEAK = 67e12    # H100 SXM: f32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12  # H100 SXM: device memory bytes/s

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


def expect_refusals(what, refusals):
    """Each call must raise its exception before any launch."""
    for name, (exc, call) in refusals.items():
        try:
            call()
        except exc:
            continue
        raise RuntimeError(f"FAILED: {what} accepted {name}")
    print(f"{what} refuses: {', '.join(refusals)}")


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
    expect_refusals("warp_fwd", refusals)

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
    expect_refusals("warp_bwd", refusals)
    return results


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time one H100 SXM could take for work
    of `flops` f32 operations that moves `nbytes` bytes."""
    t_ops = flops / F32_PEAK * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def warp_work(B, H, W, C, D, k):
    """(FLOPs, bytes) of each warp kernel at one site. A multiply-add is 2
    FLOPs; the dense products dominate, plus the logits, the weighted sum
    and the bilinear blend (7 per block value); each input is read once and
    each output written once, as 4-byte floats."""
    N, k2 = B * H * W, k * k
    dense = 2 * N * k2 * C * D
    small = 2 * N * (D * k2 + k2 * C) + 7 * N * k2 * C
    ins = N * C + 2 * N + N * D + k2 * C * D + D * k2 + k2
    return {
        "warp_fwd": (dense + small, 4 * (ins + N * C)),
        "warp_bwd_pos": (2 * dense + 2 * small + 4 * N * D * k2,
                         4 * (ins + N * C + N * C + 2 * N + N * D + D * k2
                              + k2)),
        "warp_bwd_w1": (dense + 7 * N * k2 * C,
                        4 * (N * C + 2 * N + N * D + k2 * C * D)),
    }


CORR_CASES = [  # name, B, Ns, Nt, C, exact ties
    ("relu3_1 B=8 4096x4096 C256", 8, 4096, 4096, 256, False),
    ("relu4_1 B=8 1024x1024 C512", 8, 1024, 1024, 512, False),
    ("ragged B=3 Ns=1000 Nt=777 C3", 3, 1000, 777, 3, False),
    ("duplicated and zero rows B=2 4096x4096 C256", 2, 4096, 4096, 256,
     True),
]


def corr_inputs(B, Ns, Nt, C, ties, seed, device):
    """Unit-norm ReLU features, as the correctness loss feeds the kernel.
    With `ties`, a quarter of the source rows repeat one of 32 rows and
    every 97th is zero; half the target rows copy one of the 32 and every
    7th is zero: equal maxima, as DeepFashion's white side bands give."""
    rng = np.random.RandomState(seed)
    s = np.maximum(rng.randn(B, Ns, C), 0.0)
    t = np.maximum(rng.randn(B, Nt, C), 0.0)
    if ties:
        for b in range(B):
            rows = np.maximum(rng.randn(32, C), 0.0)
            dup = np.flatnonzero(rng.rand(Ns) < 0.25)
            s[b, dup] = rows[rng.randint(0, 32, dup.size)]
            t[b, ::2] = rows[rng.randint(0, 32, t[b, ::2].shape[0])]
        s[:, ::97] = 0.0
        t[:, 1::7] = 0.0

    def unit(x):
        return torch.from_numpy((x / (np.sqrt((x * x).sum(-1, keepdims=True))
                                      + 1e-8)).astype(np.float32)).to(device)

    return unit(s), unit(t)


def corr_work(B, Ns, Nt, C):
    """(FLOPs, bytes): the products and one comparison per pair; reading
    both inputs, writing cmax (4 bytes) and argmax (8 bytes) per target."""
    return (2 * B * Ns * Nt * C + B * Ns * Nt,
            4 * B * (Ns + Nt) * C + 12 * B * Nt)


def phase_corr_kernel(device):
    """The max-correlation kernel against `max_corr_plain`: cmax within
    CORR_ATOL; argmax equal wherever the plain correlation's top two differ
    by more than CORR_ATOL, and everywhere in the tie case; the plain
    correlation at the kernel's argmax within CORR_ATOL of cmax everywhere."""
    from gfla_tpu_torch.ops import max_corr

    results = {}
    for i, (name, B, Ns, Nt, C, ties) in enumerate(CORR_CASES):
        s, t = corr_inputs(B, Ns, Nt, C, ties, 40 + i, device)
        cmax, amax = max_corr.max_corr(s, t)
        want_max, want_idx = max_corr.max_corr_plain(s, t)
        torch.cuda.synchronize()
        check(cmax.dtype == torch.float32 and amax.dtype == torch.int64
              and tuple(amax.shape) == (B, Nt), f"{name}: output types")
        err = (cmax - want_max).abs().max().item()
        check(err <= CORR_ATOL, f"{name}: cmax off by {err:.3e}")
        decided = at_err = 0
        for b in range(B):
            corr = s[b] @ t[b].T                                  # (Ns, Nt)
            top2 = corr.topk(2, dim=0).values
            sure = (top2[0] - top2[1]) > CORR_ATOL
            same = amax[b] == want_idx[b]
            check(bool(same[sure].all()), f"{name}: argmax differs where "
                  f"the top two are more than {CORR_ATOL:g} apart")
            if ties:
                check(bool(same.all()), f"{name}: argmax differs at a tie")
            decided += int(sure.sum())
            at = corr.gather(0, amax[b][None]).squeeze(0)
            at_err = max(at_err, (at - cmax[b]).abs().max().item())
        check(at_err <= CORR_ATOL, f"{name}: the correlation at the kernel's "
              f"argmax is {at_err:.3e} off cmax")
        ms = cuda_ms(lambda: max_corr.max_corr(s, t))
        plain_ms = cuda_ms(lambda: max_corr.max_corr_plain(s, t))
        library_ms = cuda_ms(lambda: torch.bmm(t, s.mT).max(-1))
        bound_ms, bound_by = bound(*corr_work(B, Ns, Nt, C))
        print(f"corr kernel {name}: cmax max_abs_err={err:.3e} (tol "
              f"{CORR_ATOL:g}); argmax equal at all {decided} of {B * Nt} "
              f"rows with a top-two gap > {CORR_ATOL:g}"
              + (" and at every tie" if ties else "")
              + f"; correlation at the kernel's argmax within {at_err:.3e}; "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bmm+max "
              f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by})")
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, work=corr_work(B, Ns, Nt,
                                                                   C))
    s, t = corr_inputs(1, 64, 32, 8, False, 49, device)
    refusals = {
        "bfloat16": (TypeError, lambda: max_corr.max_corr(s.bfloat16(),
                                                          t.bfloat16())),
        "non-contiguous": (ValueError, lambda: max_corr.max_corr(
            s.mT.contiguous().mT, t)),
        "mismatched channels": (ValueError, lambda: max_corr.max_corr(
            s, t[..., :4].contiguous())),
    }
    expect_refusals("max_corr", refusals)
    return results


ATTN_CASES = [  # name, N, k, C, D, negative slope
    ("k=5 site N=32768 C128", 8 * 64 * 64, 5, 128, 128, 0.1),
    ("k=3 site N=8192 C256", 8 * 32 * 32, 3, 256, 128, 0.1),
    ("ragged N=1000 k=3 C21 D42", 1000, 3, 21, 42, 0.1),
    ("ragged N=1000 k=3 C21 D42 ReLU", 1000, 3, 21, 42, 0.0),
]
ATTN_OUTPUTS = ("d_bs", "d_bt", "d_hpre", "dW2", "db1", "db2")


def attn_inputs(N, k, C, D, seed, device):
    """Blocks, weights in gfla_tpu's layout, and an output cotangent. b1
    sets every pre-activation 6 sigma to either side of the activation's
    kink, so that f32 rounding cannot put one unit on different branches in
    the kernel and the plain twin: of 4 M units of N(0, sigma^2), one lands
    within the ~1e-6 rounding of 0 in a typical draw, and its d_hpre then
    differs by 0.9 |d_h|, through d_bs, d_bt and db1."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    k2 = k * k
    sigma = 0.05 * np.sqrt(2 * k2 * C)  # std of bt.W1t + bs.W1s
    b1 = 6 * sigma * np.where(np.arange(D) % 2 == 0, 1.0, -1.0)
    return ((t(rng.randn(N, k2, C)), t(rng.randn(N, k2, C)),
             t(rng.randn(k2, 2 * C, D) * 0.05), t(b1 + rng.randn(D) * 0.1),
             t(rng.randn(D, k2) * 0.01), t(rng.randn(k2) * 0.1)),
            t(rng.randn(N, C)))


def attn_work(N, k, C, D):
    """(FLOPs, bytes) of the forward and the backward kernel: the dense
    layer over [bt || bs] (twice in the backward, recomputed and
    transposed), logits, weighted sum and their gradients; each input read
    once, each output written once."""
    k2 = k * k
    dense = 2 * N * 2 * k2 * C * D
    weights = 2 * k2 * C * D + D + D * k2 + k2
    fwd = (dense + 2 * N * (D * k2 + k2 * C),
           4 * (2 * N * k2 * C + weights + N * C))
    bwd = (2 * dense + 2 * N * (3 * D * k2 + 2 * k2 * C),
           4 * (2 * N * k2 * C + N * C + weights
                + 2 * N * k2 * C + N * D + D * k2 + D + k2))
    return fwd, bwd


def phase_attn_kernel(device):
    """Both attention-math kernels against their plain twins: the forward
    and each of the six backward outputs within BWD_REL x its max |value|."""
    from gfla_tpu_torch.ops import attn_math

    results = {}
    for i, (name, N, k, C, D, slope) in enumerate(ATTN_CASES):
        args, g = attn_inputs(N, k, C, D, 50 + i, device)
        out = attn_math.attn_math_fwd(*args, slope)
        want = attn_math.attn_math_plain(*args, slope)
        got_b = attn_math.attn_math_bwd(args[0], args[1], g, *args[2:], slope)
        want_b = attn_math.attn_math_bwd_plain(args[0], args[1], g, *args[2:],
                                               slope)
        torch.cuda.synchronize()
        errs, faults = [], []
        for what, a, b in zip(("out",) + ATTN_OUTPUTS, (out, *got_b),
                              (want, *want_b)):
            err = (a - b).abs().max().item()
            tol = BWD_REL * b.abs().max().item()
            if not (bool(torch.isfinite(a).all()) and err <= tol):
                faults.append(f"{what} {err:.3e} > {tol:.3e}")
            errs.append(err)
        check(not faults, f"{name}: kernel vs plain: {', '.join(faults)}")
        fwd_ms = cuda_ms(lambda: attn_math.attn_math_fwd(*args, slope),
                         iters=10)
        fwd_plain = cuda_ms(lambda: attn_math.attn_math_plain(*args, slope),
                            iters=10)
        bwd_ms = cuda_ms(lambda: attn_math.attn_math_bwd(
            args[0], args[1], g, *args[2:], slope), iters=10)
        bwd_plain = cuda_ms(lambda: attn_math.attn_math_bwd_plain(
            args[0], args[1], g, *args[2:], slope), iters=10)
        dw1_ms = cuda_ms(lambda: attn_math.attn_math_dw1(
            args[0], args[1], want_b[2]), iters=10)
        (f_ops, f_bytes), (b_ops, b_bytes) = attn_work(N, k, C, D)
        print(f"attn-math {name}: max_abs_err out={errs[0]:.3e} "
              + " ".join(f"{o}={e:.3e}" for o, e in zip(ATTN_OUTPUTS,
                                                        errs[1:]))
              + f" (tol {BWD_REL:g} x max|value|); forward kernel "
              f"{fwd_ms:.4f} ms plain {fwd_plain:.4f} ms bound "
              f"{bound(f_ops, f_bytes)[0]:.4f} ms; backward kernel "
              f"{bwd_ms:.4f} ms plain {bwd_plain:.4f} ms bound "
              f"{bound(b_ops, b_bytes)[0]:.4f} ms; dW1 matmul outside "
              f"{dw1_ms:.4f} ms")
        results[name] = dict(
            fwd=dict(err=errs[0], ms=fwd_ms, plain_ms=fwd_plain,
                     work=(f_ops, f_bytes)),
            bwd=dict(err=max(errs[1:]), ms=bwd_ms, plain_ms=bwd_plain,
                     work=(b_ops, b_bytes)))
    args, g = attn_inputs(40, 3, 8, 16, 59, device)
    refusals = {
        "C > 512": (ValueError, lambda: attn_math.attn_math_fwd(
            *attn_inputs(4, 3, 520, 16, 59, device)[0])),
        "bfloat16": (TypeError, lambda: attn_math.attn_math_fwd(
            args[0].bfloat16(), *args[1:])),
        "non-contiguous": (ValueError, lambda: attn_math.attn_math_fwd(
            args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])),
        "g of the wrong shape": (ValueError, lambda: attn_math.attn_math_bwd(
            args[0], args[1], g[:20], *args[2:])),
    }
    expect_refusals("attn_math", refusals)
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
    return dict(launches=launches, task=task, request=requests[0])


def launch_counts():
    from gfla_tpu_torch.ops import attn_math, max_corr, warp

    return {"warp_fwd": warp.launches, "warp_bwd_pos": warp.bwd_pos_launches,
            "warp_bwd_w1": warp.bwd_w1_launches,
            "max_corr": max_corr.launches,
            "attn_math_fwd": attn_math.fwd_launches,
            "attn_math_bwd": attn_math.bwd_launches}


def reset_launch_counts():
    from gfla_tpu_torch.ops import attn_math, max_corr, warp

    warp.launches = warp.bwd_pos_launches = warp.bwd_w1_launches = 0
    max_corr.launches = 0
    attn_math.fwd_launches = attn_math.bwd_launches = 0


def only(counts, **expected):
    """True if `counts` holds `expected` and 0 for every other kernel."""
    return counts == {name: expected.get(name, 0) for name in counts}


def switches(**env):
    """The GFLA_* switches for one phase, restored when it ends."""
    return mock.patch.dict(os.environ, env)


def plain_warp():
    """The plain path: the warp as `warp_fwd_plain`, differentiated by
    autograd, so neither kernel nor WarpFunction is on it."""
    from gfla_tpu_torch.ops import warp

    return mock.patch.object(warp, "warp_fwd", warp.warp_fwd_plain)


def nets(task):
    """The task's trained networks: G, and D where the task has one."""
    out = {"G": task.net_g}
    if hasattr(task, "net_d"):
        out["D"] = task.net_d
    return out


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
    for module in (*nets(task).values(), task.vgg):
        module.double()
    with plain_warp():
        task.train_step({k: v.double() for k, v in batch.items()})
    grads = {tag: s["grads"] for tag, s in snapshot(task).items()}
    del task
    torch.cuda.empty_cache()
    return grads


def check_step_pair(what, logs_a, snap_a, logs_b, snap_b, exact, lrs,
                    masked=True, grad_rel=GRAD_F64_REL, pair_rel=None):
    """Two steps from one state, a (kernel path, card) against b (plain path,
    CPU): losses within TRAIN_LOSS_REL; each gradient of a within
    `grad_rel` x its tensor's largest exact |grad| of the exact (float64)
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
    gradient and is held to 2 lr only. With `pair_rel`, each gradient of a
    that the f64 step does not find 0 is also held to b's, within
    `pair_rel` x that largest exact |grad|."""
    faults = []
    loss_rel = pair_worst = 0.0
    for name, want in logs_b.items():
        got, want = float(logs_a[name]), float(want)
        rel = abs(got - want) / max(abs(want), 1e-30)
        if not (np.isfinite(got) and rel <= TRAIN_LOSS_REL):
            faults.append(f"loss {name} {got} vs {want}")
        loss_rel = max(loss_rel, rel)
    worst = [0.0, 0.0]
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
            g64 = ex.get(name)  # None: a head the losses do not reach
            top = 0.0 if g64 is None else g64.abs().max().item()
            if top <= 1e-9 * scale:  # exactly 0 in f64
                skipped += 1
                continue
            grads = [side[tag]["grads"][name].double()
                     for side in (snap_a, snap_b)]
            sides = [(g - g64).abs().max().item() for g in grads]
            rounding = max(sides)
            if sides[0] > grad_rel * top:
                faults.append(f"{tag} {name} grad off the f64 one by "
                              f"{sides[0] / top:.3e} of its max {top:.3e}")
            if pair_rel is not None:
                pair_err = (grads[0] - grads[1]).abs().max().item() / top
                pair_worst = max(pair_worst, pair_err)
                if pair_err > pair_rel:
                    faults.append(f"{tag} {name} grad off the other path's by "
                                  f"{pair_err:.3e} of its max {top:.3e}")
            worst = [max(r, e / top) for r, e in zip(worst, sides)]
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
    pair_note = ("" if pair_rel is None else
                 f"; path a's gradients within {pair_worst:.3e} of path b's "
                 f"x each tensor's max (bound {pair_rel:g})")
    print(f"{what}: losses within {loss_rel:.3e} rel; gradients within "
          f"{worst[0]:.3e} and {worst[1]:.3e} of each tensor's max of "
          f"the f64 step's{pair_note}; {rule}; "
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


def compare_steps(what, state, batch, lrs, to_cpu=False,
                  path_a=contextlib.nullcontext, path_b=plain_warp,
                  grad_rel=GRAD_F64_REL, pair_rel=None):
    """One step of `state` on path a (the kernel path) against one on path b
    (the plain path) or, with `to_cpu`, one on the card against one on the
    CPU, both held against a float64 step by check_step_pair; card and CPU
    convolutions round differently all through G, so that pair is not
    masked. `path_a`/`path_b` give the context each step runs in;
    `pair_rel` holds a's gradients to b's (check_step_pair)."""
    exact = exact_grads(state, batch)
    a = copy.deepcopy(state)
    with path_a():
        logs_a = a.train_step(batch)
    snap_a = snapshot(a)
    del a
    b = copy.deepcopy(state)
    if to_cpu:
        for module in (*nets(b).values(), b.vgg):
            module.cpu()
        logs_b = b.train_step({k: v.cpu() for k, v in batch.items()})
    else:
        with path_b():
            logs_b = b.train_step(batch)
    snap_b = {tag: {kind: {n: t.to(batch["P1"].device) for n, t in d.items()}
                    for kind, d in s.items()}
              for tag, s in snapshot(b).items()}
    del b
    check_step_pair(what, logs_a, snap_a, logs_b, snap_b, exact, lrs,
                    masked=not to_cpu, grad_rel=grad_rel, pair_rel=pair_rel)


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
    check(only(counts, warp_fwd=2 * TRAIN_STEPS,
               warp_bwd_pos=2 * TRAIN_STEPS, warp_bwd_w1=2 * TRAIN_STEPS),
          f"launches {counts} for {TRAIN_STEPS} steps, expected 2 forward "
          f"and 2 of each backward warp kernel per step, nothing else")

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
    return dict(counts=counts, state=state, batch=batches[0])


def phase_poseflownet():
    """Stage-1 flow pretraining at full width with GFLA_PALLAS_CORR=1, and
    the two-stage protocol from its checkpoint."""
    from gfla_tpu_torch.options import TrainOptions
    from gfla_tpu_torch.tasks import create_task

    ckpt = tempfile.TemporaryDirectory()
    common = ["--dataset_mode=synthetic", "--load_size=256", "--batchSize=8",
              "--gpu_ids=0", f"--checkpoints_dir={ckpt.name}",
              "--name=flow_smoke"]
    opt = TrainOptions().parse(["--model=poseflownet", *common], save=False)
    opt.iters_per_epoch = 1000
    task = create_task(opt)
    fn = task.net_g.flow_net
    check(fn.block0.model[2].out_channels == 32 and fn.encoder_layer == 5
          and fn.encoder3.model[5].out_channels == 256,
          "not the full-width flow net")
    print(f"poseflownet: {sum(p.numel() for p in task.net_g.parameters())} "
          f"parameters")
    batches = [task.prepare_batch(deepfashion_batch(200 + s))
               for s in range(TRAIN_STEPS)]
    state0 = copy.deepcopy(task)
    s0 = snapshot(state0)

    # the main path: TRAIN_STEPS steps through the max-correlation kernel
    with switches(GFLA_PALLAS_CORR="1"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, logs = timed_steps(task, batches)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"poseflownet trained {TRAIN_STEPS} steps: kernel launches {counts}")
    check(only(counts, max_corr=2 * TRAIN_STEPS),
          f"launches {counts}, expected 2 max_corr per step and nothing else")
    for i, step_logs in enumerate(logs):
        check(sorted(step_logs) == sorted(task.loss_names + ["total_G"]),
              f"loss names {sorted(step_logs)}")
        for name, v in step_logs.items():
            check(bool(torch.isfinite(v)), f"step {i + 1}: {name} not finite")
    for i in (0, TRAIN_STEPS - 1):
        print(f"poseflownet losses, step {i + 1}: " + " ".join(
            f"{k} {float(v):.5f}" for k, v in logs[i].items()))
    params = dict(task.net_g.named_parameters())
    unreached = sorted(n for n, p in params.items() if p.grad is None)
    still = [n for n, p in params.items()
             if n not in unreached and torch.equal(p, s0["G"]["params"][n])]
    check(not still, f"parameters unchanged: {still}")
    check(all(n.startswith("flow_net.mask") for n in unreached)
          and all(torch.equal(params[n], s0["G"]["params"][n])
                  for n in unreached),
          f"parameters without a gradient: {unreached}")
    print(f"every parameter the losses reach moved; the {len(unreached)} of "
          f"the mask heads, which no stage-1 loss reaches, did not")
    flows, masks = task.test_step(batches[0])
    check([tuple(f.shape) for f in flows] == [(8, 2, 32, 32), (8, 2, 64, 64)]
          and all(bool(torch.isfinite(f).all()) for f in flows + masks),
          "test_step flows")

    with switches(GFLA_PALLAS_CORR="0"):
        plain = copy.deepcopy(task)
        plain_times, _ = timed_steps(plain, batches[1:])
        del plain

    # the two-stage protocol: stage 2 resumes the stage-1 directory
    task.save(TRAIN_STEPS)
    pose_opt = TrainOptions().parse(["--model=pose", "--continue_train",
                                     *common], save=False)
    pose = create_task(pose_opt)
    init = {n: t.clone() for n, t in pose.net_g.state_dict().items()}
    check(pose.resume(pose_opt.which_iter) == TRAIN_STEPS
          and pose.step == TRAIN_STEPS, "stage 2 did not keep the step")
    saved = task.net_g.state_dict()
    got = pose.net_g.state_dict()
    flow_keys = [n for n in got if n.startswith("flow_net.")]
    check(len(flow_keys) == len(saved)
          and all(torch.equal(got[n], saved[n]) for n in flow_keys),
          "stage 2's flow net is not the saved one")
    check(all(torch.equal(got[n], init[n]) for n in got
              if not n.startswith("flow_net.")),
          "stage 2's source and target nets are not at their init")
    check(not pose.opt_g.state, "stage 2's optimizer is not fresh")
    print(f"two-stage: pose --continue_train loaded the {len(flow_keys)} "
          f"flow_net tensors at step {pose.step}; the other "
          f"{len(got) - len(flow_keys)} kept their init")
    del pose
    ckpt.cleanup()

    state = off_the_kinks(state0)
    del state0
    compare_steps("poseflownet kernel vs scan path, batch 8 at 256x256",
                  state, batches[0], {"G": opt.lr},
                  path_a=lambda: switches(GFLA_PALLAS_CORR="1"),
                  path_b=lambda: switches(GFLA_PALLAS_CORR="0"),
                  grad_rel=FLOW_GRAD_F64_REL, pair_rel=FLOW_PAIR_REL)
    ms = statistics.median(times[1:])
    plain_ms = statistics.median(plain_times)
    print(f"poseflownet step batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(steps {', '.join(f'{t:.1f}' for t in times)}), scan path "
          f"{plain_ms:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in plain_times)}), peak "
          f"{peak:.2f} GiB")
    return counts


def rel_diff(logs_a, logs_b):
    return max(abs(float(logs_a[n]) - float(logs_b[n]))
               / max(abs(float(logs_b[n])), 1e-30) for n in logs_b)


def attention_outputs(task, request):
    """The served image and the output of each ExtractorAttn in it."""
    from gfla_tpu_torch.nn.attention import ExtractorAttn

    outs = []
    hooks = [m.register_forward_hook(lambda mod, args, out: outs.append(out))
             for m in task.net_g.modules() if isinstance(m, ExtractorAttn)]
    img = task.test_step(request)[0]
    for h in hooks:
        h.remove()
    return img, outs


def phase_switches(serve, train):
    """The pose head under GFLA_ATTN_PALLAS=1 and under GFLA_PALLAS_CORR=1:
    the kernels each selects, launched on its path, against the default
    (warp, scan) path."""
    task, request = serve["task"], serve["request"]
    want_img, want_attn = attention_outputs(task, request)
    with switches(GFLA_ATTN_PALLAS="1"):
        reset_launch_counts()
        img, got_attn = attention_outputs(task, request)
        torch.cuda.synchronize()
        serve_counts = launch_counts()
        ms = cuda_ms(lambda: task.test_step(request), iters=10)
    diff = (img - want_img).abs().max().item()
    attn_rel = max((a - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(got_attn, want_attn))
    print(f"GFLA_ATTN_PALLAS=1 serving: launches {serve_counts}; image vs the "
          f"warp path max_abs_diff={diff:.3e} (bound {SLICE_ATOL:g}); both "
          f"ExtractorAttn outputs within {attn_rel:.3e} x their max (bound "
          f"{BWD_REL:g}); {ms:.3f} ms per batch-8 forward")
    check(only(serve_counts, attn_math_fwd=2),
          f"launches {serve_counts}, expected 2 attn_math_fwd, no warp")
    check(diff <= SLICE_ATOL, f"attn-math serving vs warp {diff:.3e}")
    check(len(got_attn) == 2 and attn_rel <= BWD_REL,
          f"ExtractorAttn outputs {attn_rel:.3e} apart")

    state, batch = train["state"], train["batch"]
    want = copy.deepcopy(state).train_step(batch)  # the default path
    counts, rel, ms = {}, {}, {}
    for name, env in (("attn", dict(GFLA_ATTN_PALLAS="1")),
                      ("corr", dict(GFLA_PALLAS_CORR="1"))):
        task = copy.deepcopy(state)
        with switches(**env):
            reset_launch_counts()
            got = task.train_step(batch)
            torch.cuda.synchronize()
            counts[name] = launch_counts()
            times, _ = timed_steps(task, [batch] * 3)
        rel[name] = rel_diff(got, want)
        ms[name] = statistics.median(times)
        del task
        print(f"{env} pose training step: launches {counts[name]}; losses "
              f"within {rel[name]:.3e} rel of the default path (bound "
              f"{TRAIN_LOSS_REL:g}); {ms[name]:.3f} ms per step (steps "
              f"{', '.join(f'{t:.1f}' for t in times)})")
        check(rel[name] <= TRAIN_LOSS_REL, f"{env}: losses {got} vs {want}")
    check(only(counts["attn"], attn_math_fwd=2, attn_math_bwd=2),
          f"GFLA_ATTN_PALLAS=1 launches {counts['attn']}")
    check(only(counts["corr"], warp_fwd=2, warp_bwd_pos=2, warp_bwd_w1=2,
               max_corr=2), f"GFLA_PALLAS_CORR=1 launches {counts['corr']}")
    return dict(serve_attn=serve_counts, train_attn=counts["attn"],
                train_corr=counts["corr"])


def kernel_entry(name, source, replaces, by_path, err, tolerance, ms,
                 plain_ms, work, library_ms, shape):
    bound_ms, bound_by = bound(*work)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err,
            "tolerance": tolerance, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "ms_shape": shape}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from gfla_tpu_torch.runtime import set_tf32

    set_tf32(False)
    with switches(GFLA_ATTN_PALLAS="auto", GFLA_PALLAS_CORR="0"):
        phase_card()
        phase_build()
        kernel = phase_kernel(device)
        bwd = phase_bwd_kernel(device)
        corr = phase_corr_kernel(device)
        attn = phase_attn_kernel(device)
        serve = phase_slice(argv)
        train = phase_train()
        flow = phase_poseflownet()
        switched = phase_switches(serve, train)
    train = train["counts"]
    site = KERNEL_CASES[0]
    work = warp_work(*site[1:7])
    shape = "k=5 B=8 64x64 C=128 D=128"
    _, ms, plain_ms = kernel[site[0]]
    none = None  # no single PyTorch call computes these
    entries = [kernel_entry(
        "warp_fwd", "gfla_tpu_torch/csrc/warp_fwd.cu",
        "gfla_tpu/ops/pallas_warp.py:166",
        {"serve": serve["launches"], "train": train["warp_fwd"],
         "train_corr": switched["train_corr"]["warp_fwd"]},
        max(e for e, _, _ in kernel.values()), f"{KERNEL_ATOL:g} abs", ms,
        plain_ms, work["warp_fwd"], none, shape)]
    for name, part in (("warp_bwd_pos", "pos"), ("warp_bwd_w1", "w1")):
        entries.append(kernel_entry(
            name, "gfla_tpu_torch/csrc/warp_bwd.cu",
            "gfla_tpu/ops/pallas_warp.py:243",
            {"train": train[name],
             "train_corr": switched["train_corr"][name]},
            max(r[part][0] for r in bwd.values()),
            f"{BWD_REL:g} x max|value| of each output",
            bwd[site[0]][part][1], bwd[site[0]][part][2], work[name], none,
            shape))
    c = corr[CORR_CASES[0][0]]
    entries.append(kernel_entry(
        "max_corr", "gfla_tpu_torch/csrc/max_corr.cu",
        "gfla_tpu/ops/pallas_corr.py:36",
        {"poseflownet": flow["max_corr"],
         "train_corr": switched["train_corr"]["max_corr"]},
        max(r["err"] for r in corr.values()), f"{CORR_ATOL:g} abs (cmax)",
        c["ms"], c["plain_ms"], c["work"], c["library_ms"],
        "B=8 Ns=Nt=4096 C=256"))
    a = attn[ATTN_CASES[0][0]]
    for name, part, paths in (
            ("attn_math_fwd", "fwd", ("serve_attn", "train_attn")),
            ("attn_math_bwd", "bwd", ("train_attn",))):
        entries.append(kernel_entry(
            name, f"gfla_tpu_torch/csrc/{name}.cu",
            "gfla_tpu/ops/pallas_attn.py:"
            + ("64" if part == "fwd" else "155"),
            {path: switched[path][name] for path in paths},
            max(r[part]["err"] for r in attn.values()),
            f"{BWD_REL:g} x max|value| of each output", a[part]["ms"],
            a[part]["plain_ms"], a[part]["work"], none,
            "N=32768 k=5 C=128 D=128"))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
