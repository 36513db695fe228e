"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py [test options...]

Phases, each failing the run (non-zero exit) on the first error:
  1. card: CUDA must be present; prints nvidia-smi's name and power limit.
  2. build: compiles the CUDA kernels from gfla_tpu_torch/csrc with nvcc,
     and csrc/jpeg_nvjpeg.cpp (linked with the toolkit's nvJPEG) beside
     them.
  3. kernel: the warp kernel against its plain torch version at both live
     attention sites of the DeepFashion generator, with far-off flows, at
     the sites of a 64x64 input, at a ragged shape (non-square, C and D
     no multiples of 8), at k=7 and at k = 2, 4, 6, 8 and 9 at the k=5 site
     (every k but 3 and 5 runs the kernels' run-time-k instance); k = 10 is
     refused before any launch; max errors and median times of both,
     and of the kernel storing hpre (the pre-activation hidden layer) for
     the backward, held against the plain hpre.
  4. bwd kernel: both backward kernels (per position, from the forward
     kernel's hpre; dW1s) against their plain versions given that hpre in
     the same cases, each of the six outputs within 1e-4 x its max |value|;
     d_flow, dW1s, dW2 and db2 bitwise equal over two launches; median
     times of both. Both refuse float16, and a bf16 source with f32
     weights.
  4b. bf16 kernels: the three kernels' bf16 instances (warp_fwd_bf16.cu,
     warp_bwd_bf16.cu) against their bf16 plain twins at every KERNEL_CASES
     shape, each output by the bf16 rule (BF16_SLACK) against the f32
     result of the same values; d_flow, d_hidden_bt, dW1s, dW2 and db2
     bitwise equal over two launches; median times, bounds at the bf16
     rate.
  5. serve: the full-width pose generator (ngf 64, img_f 512, attention at
     levels 2/3 with kernels 5/3) serves four batch-8 requests of 256x176
     content in 256x256 tensors through PoseTask.test_step; checks shape,
     range, the kernel launch count, the plain-warp path and a CPU run on a
     small input; median ms per forward of both paths.
  5b. bf16 serving: the same weights and requests under
     --compute_dtype=bfloat16: 2 bf16 warp launches a request and no other
     kernel, shape and range, the image against the plain bf16 path and
     both against the f32 image by the bf16 rule; ms per forward beside the
     f32 path's in turns; then under GFLA_ATTN_PALLAS=1: 2 bf16
     attention-math forward launches a request and no other kernel, the
     image against that route's plain bf16 path and the f32 image by the
     bf16 rule.
  6. train: the full-width pose training step (G as in 5, the 4-layer
     spectral-norm ResDiscriminator, VGG19, six G losses, two Adams) takes
     four batch-8 steps through the kernels: finite losses, every parameter
     moved, u stored by the two D passes and not by the G-loss pass, 2
     launches of each kernel per step; a checkpoint save/resume gives the
     same next step; one step against the plain path from one state and
     one card step against a CPU step at 2x64x64, gradients held against a
     float64 step; median ms per step of both paths and the peak memory.
  6b. bf16 train: four full-width batch-8 steps under
     --compute_dtype=bfloat16 through the bf16 warp kernels (2 launches of
     each a step, nothing else): finite losses, every parameter moved and
     f32, u computed in bf16 by the two D passes and stored in f32; one
     step on the kernel path against the plain bf16 path from one state,
     losses within 1e-2 rel, each tensor's gradient directly against the
     plain path's by cosine and norm ratio (BF16_STEP_HOLD), both paths'
     gradients against the f32 step's by the bf16 rule on each network's
     mean; save/resume; ms per step and peak memory beside the f32 step's.
  7. corr kernel: the max-correlation kernel against its plain scan at both
     sites of the correctness loss, at a ragged shape and with duplicated
     and zero rows (exact ties); cmax also against the float64 maximum;
     median ms of the kernel, the scan and one unchunked torch.bmm + max,
     the yardstick the port never calls.
  8. attn-math kernels: the math-fused forward (also storing hpre) and
     the backward from that hpre against their plain twins at both
     attention sites, a ragged shape and a ReLU; the backward's outputs
     bitwise equal over two launches; median ms of each, the plain
     backward timed given hpre and recomputing it.
  8b. bf16 attn-math kernels: their bf16 instances (attn_math_fwd_bf16.cu,
     attn_math_bwd_bf16.cu) against the bf16 plain twins at both pose
     sites, ShapeNet's and a ragged shape: each output by the bf16 rule, the
     f32 hpre within 1e-4 x max of the twin's, all six backward outputs
     bitwise equal over two launches; median ms and the bound at the bf16
     rate.
  9. poseflownet: stage-1 flow pretraining at full width, batch 8, with
     GFLA_PALLAS_CORR=1: four steps, 2 max-correlation launches each;
     finite losses; every parameter the losses reach moved; one step
     against the scan path from one state (float64 rule as in 6); a save,
     then the pose task's --continue_train on it starts its flow net from
     it (the two-stage protocol); median ms per step of both paths.
 10. switches: the pose head under GFLA_ATTN_PALLAS=1 (serving, one training
     step) and GFLA_PALLAS_CORR=1 (one training step): the kernels each
     setting selects, and agreement with the default path; one bf16 step
     under GFLA_ATTN_PALLAS=1 (2 + 2 bf16 attention-math launches) from
     6b's state against that route's plain bf16 path (losses within 1e-2,
     BF16_STEP_HOLD; 6b's f32 step for the bf16 rule), its peak memory; one
     f32 step at --kernel_size 2=4,3=9 (k=4 and k=9 on the warp kernels'
     run-time instance) against the plain path by phase 6's rule.
 11. disk data: a DeepFashion-layout tree (16 images of 256x176 a phase, 24
     train and 8 test pairs) and a Market-layout one (128x64) written
     through nvJPEG (image_io.encode_jpeg) and decoded back (PSNR >= 35 dB
     each; the same decode queued behind a busy stream bitwise equal;
     nvJPEG's pixels against PIL's on a committed fixture); three
     full-width batch-8 pose steps from each through the training CLI's
     entry point with --eval_iters_freq=2 --display_freq=2 (and
     --profile_iters=1 for fashion): train.py's held-out batch, never in a
     training batch, evaluated (finite SSIM, PSNR, L1), the logs, PNGs
     and trace written, the launches counted; the serving CLI writes the
     test pairs' _vis.jpg through nvJPEG and one decodes back; market
     serving on the kernels against the plain warp; each prepared image
     against its source picture; decode and prepare_batch ms per batch
     beside the step time.
 12. shapenet serve: the full-width ShapeNet generator (the task's defaults:
     ngf 64, img_f 512, layers 3, one attention level, k=3 at 64x64x128;
     the flow net fusing the 21-channel viewpoint code at its bottleneck)
     serves four batch-8 requests of uint8 256x256 images and raw labels in
     the HDF5 dataset's layout through the task's prepare_batch and
     test_step: 1 warp-forward launch a request and nothing else, shape and
     range, the plain-warp path, a layers-1 generator on the card against
     the CPU at 2x64x64; ms per forward of both paths.
 13. shapenet sweep: ShapeNetTask.run_test over two batch-8 test batches
     (P2 (8, 18, 256, 256, 3), BP2 (8, 18, 2), the paths): 288 _vis.jpg
     through nvJPEG, named as gfla_tpu names them, 1 launch a view.
 14. shapenet train: four full-width batch-8 D-then-G steps (as 6, with 1
     launch of each warp kernel a step); the kernel path against the plain
     path from one state, a layers-1 generator's step on the card against
     the CPU's at 2x64x64, both against a float64 step.
 15. shapenetflow: four full-width stage-1 steps with GFLA_PALLAS_CORR=1, 1
     max-correlation launch a step; the shapenet task's --continue_train
     then loads every flow_net tensor of that directory.
 16. shapenet bf16: the same weights and requests under
     --compute_dtype=bfloat16 (1 bf16 warp launch a request; the image by
     the bf16 rule), one step (1 launch of each bf16 warp kernel) against
     the plain bf16 path by BF16_STEP_HOLD; ms beside f32.
 17. dance serve, face serve: the full-width animation generator (ngf 64,
     img_f 512, layers 3; per frame 4 ExtractorAttn sites: the previous and
     the reference stream at k=5 on 64x64x128 and k=3 on 32x32x256) through
     the serving CLI's run_test: two consecutive 6-frame chunks of a batch-1
     clip of the synthetic video dataset, the last frame and skeleton
     carried: 24 warp-forward launches a chunk and nothing else, 12 _vis
     and 12 _gt PNGs under gfla_tpu's names; the 12 frames on the kernels
     against the plain path; the same generator on a 64x64 clip on the card
     against the CPU; ms per batch-2 chunk forward of both paths.
 18. dance train, face train: four full-width chunk steps (batch 2 x 6
     frames at 256x256: G over the chunk, D and D_V, the folded losses) as
     in 6, with 24 launches of each warp kernel a step; every parameter of
     G, D and D_V moved; save/resume; one step on the kernel path against
     the plain path from one state (losses within TRAIN_LOSS_REL, each
     network's gradient within ANIM_GRAD_REL in relative L2); ms per step,
     peak memory.
 19. dance switches: one dance step under GFLA_ATTN_PALLAS=1 (24 launches
     of each attention-math kernel) and one under GFLA_PALLAS_CORR=1 (4
     max-correlation launches beside the warp's 24 + 24 + 24), each against
     the default path.
 20. dance disk, face disk: a dance tree (iPER layout, 3 sequences x 14
     frames a phase, 256x256) and a face tree (FaceForensics layout, 240x320
     frames) written through nvJPEG, the skeleton JSONs and landmark files
     from numpy; three full-width batch-2 x 6-frame dance steps through the
     training CLI's entry point (24 launches of each warp kernel a step,
     every parameter of G, D and D_V moved); the serving CLI's run_test over
     each head's test sequences (24 forward launches a chunk, gfla_tpu's
     file names, the carry reset at each sequence's first chunk, the
     stitch's line for each sequence: dance's mp4 where cv2 imports, face's
     with cv2 hidden, the line that says no mp4 was written); each prepared
     frame against its source picture; the face structure, Canny included,
     on the card bitwise equal to the CPU's on the same nvJPEG pixels; on
     the committed
     fixture tests/fixtures/face_q75_240x320, the share of Canny pixels
     nvJPEG's and PIL's decodes disagree on (at most 2% of those either
     marks); host sample ms, device prepare_batch ms a chunk, and the dance
     step from disk beside phase 18's.
The HDF5 store itself is not read on the card, whose Python has no h5py:
the ShapeNet phases feed batches in the dataset's layout to the task's own
prepare_batch and run_test, and the reader is held against gfla_tpu's on
the CPU (tests/test_torch_port_shapenet.py).
The switches are set per phase with mock.patch.dict, so none leaks into the
next; every other phase runs with GFLA_ATTN_PALLAS=auto, GFLA_PALLAS_CORR=0.
Each phase's wall time follows it on a line of its own. A timing takes 20
launches after 3 warm-up ones, or fewer (at least 5) once they add up to
300 ms.
All six f32 kernels multiply on the tensor cores as split-f32 products
(three TF32 products per f32 product): their bound is taken at 495 / 3
TFLOP/s, with the FP32 cores' 67 TFLOP/s bound beside it. The five bf16
instances (the warp's three, the attention math's two) multiply bf16
operands: their bound is taken at the dense bf16 rate, 989 TFLOP/s.
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

KERNEL_ATOL = 1e-4  # f32, TF32 off: the summation order differs, and the
                    # split-f32 products drop ~2^-22 of each term
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
TF32_PEAK = 495e12  # H100 SXM: dense TF32 FLOP/s of the tensor cores
TF32X3_PEAK = TF32_PEAK / 3  # f32 work as split-f32 products: three TF32
                    # products per f32 product (csrc/mma_tf32x3.cuh)
HBM_RATE = 3.35e12  # H100 SXM: device memory bytes/s
BF16_PEAK = 989e12  # H100 SXM: dense bf16 FLOP/s of the tensor cores
TIMING_MS = 300.0   # a timing's launches stop here once there are 5
# bf16: each bf16 kernel against its bf16 plain twin on the same inputs, and
# both against the f32 result of the same values (the plain twin in f32):
# the kernel's error there at most 2x the twin's + BF16_SLACK x max|f32|,
# and kernel vs twin within a tolerance x max|f32|: BF16_OUT_REL for the
# output, hpre and d_source (one bf16 ulp is 3.9e-3 of the largest value;
# the kernel and the twin sum in other orders, so a rounding may land one
# ulp apart), BF16_GRAD_REL for the other gradients, whose sums cancel
BF16_SLACK = 1e-3
BF16_OUT_REL = 1e-2
BF16_GRAD_REL = 3e-2
SERVE_BF16_REL = 5e-2  # the served image, kernel vs plain bf16 path: the
                       # kernels' one-ulp differences carried through the
                       # decoder's bf16 convs and norms (read: 1.96e-2)
BF16_LOSS_REL = 1e-2   # bf16 step, kernel vs plain path: each loss
# bf16 step, kernel vs plain path, each network's gradients tensor by
# tensor: cosine floor, the whole network's cosine floor, norm ratio band.
# A max error cannot hold them: the warp kernels' one-ulp differences
# carried through the rest of the step leave a G tensor up to 38% of its
# max apart on the two paths. Read at the seeded init: G's 172 tensors at
# cosine 0.9587 (attention's W1) and up, median 0.99977, norm ratios
# 0.901-1.039, the whole network 0.999999; D's 26 at 1.00000 (its fake
# images are ~1e-3). G's tensor floor and band stand 2.4x further from 1
# than its readings; the others, read at 1 within 1e-6, at 1e-5 to 1e-3.
BF16_STEP_HOLD = {"G": (0.9, 0.99999, (0.75, 1.33)),
                  "D": (0.9999, 0.99999, (0.999, 1.001))}
# The ShapeNet step's generator has gradients that bf16 rounding dominates:
# the target net grows from the viewpoint code tiled to 8x8, and the biases
# of its first two blocks (and of the flow net's deepest encoder) get
# gradients that sum to nearly 0 over the image. Read on an H100: kernel
# and plain bf16 paths at cosine 0.34-0.75 on those five tensors, every
# other G tensor above the floor of 0.9; the plain path's own at 0.31-0.85
# with the f32 step's on the five. A
# tensor outside BF16_STEP_HOLD whose plain bf16 gradient is itself at a
# cosine below BF16_RESOLVED with the f32 step's is held by the bf16 rule
# against f32 instead (grads_by_rule).
BF16_RESOLVED = 0.9

KERNEL_CASES = [  # name, B, H, W, C, D, k, flow scale (None: far-off)
    ("k=5 site 64x64 C128", 8, 64, 64, 128, 128, 5, 1.5),
    ("k=3 site 32x32 C256", 8, 32, 32, 256, 128, 3, 1.5),
    ("k=5 far-off flows", 8, 64, 64, 128, 128, 5, None),
    ("k=5 site at 64x64 input", 2, 16, 16, 128, 128, 5, 1.5),
    ("k=3 site at 64x64 input", 2, 8, 8, 256, 128, 3, 1.5),
    ("ragged k=3 12x10 C21 D42", 2, 12, 10, 21, 42, 3, 1.5),
    ("ragged k=7 16x12 C22 D40", 2, 16, 12, 22, 40, 7, 1.5),
    ("market k=5 site 32x16 C128", 8, 32, 16, 128, 128, 5, 1.5),
    ("market k=3 site 16x8 C256", 8, 16, 8, 256, 128, 3, 1.5),
    ("shapenet k=3 site 64x64 C128", 8, 64, 64, 128, 128, 3, 1.5),
    ("animation k=5 site 64x64 C128 B2", 2, 64, 64, 128, 128, 5, 1.5),
    ("animation k=3 site 32x32 C256 B2", 2, 32, 32, 256, 128, 3, 1.5),
    # --kernel_size at the pose k=5 site: the kernels' run-time instance
    ("kernel size k=2 at the k=5 site", 8, 64, 64, 128, 128, 2, 1.5),
    ("kernel size k=4 at the k=5 site", 8, 64, 64, 128, 128, 4, 1.5),
    ("kernel size k=6 at the k=5 site", 8, 64, 64, 128, 128, 6, 1.5),
    ("kernel size k=8 at the k=5 site", 8, 64, 64, 128, 128, 8, 1.5),
    ("kernel size k=9 at the k=5 site", 8, 64, 64, 128, 128, 9, 1.5),
]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` by CUDA events, after warm-up: `iters`
    launches, or fewer (never under 5) once they add up to TIMING_MS."""
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
        if len(times) >= 5 and sum(times) >= TIMING_MS:
            break
    return statistics.median(times)


def timed(phase, *args):
    """`phase(*args)`, and a line with its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def phase_card():
    from gfla_tpu_torch.runtime import card_line

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")


def phase_build():
    """The kernel library and the nvJPEG library, every nvcc at once."""
    from gfla_tpu_torch.ops._build import (build, load_jpeg_library,
                                           load_library)

    t0 = time.perf_counter()
    build(verbose=True)
    load_library()
    load_jpeg_library()
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
        got_h, hpre = warp.warp_fwd_with_hpre(*args, k)
        want_hpre = warp.warp_fwd_plain(*args, k, with_hpre=True)[1]
        torch.cuda.synchronize()
        err_h = (hpre - want_hpre).abs().max().item()
        tol_h = BWD_REL * want_hpre.abs().max().item()
        ms = cuda_ms(lambda: warp.warp_fwd(*args, k))
        ms_hpre = cuda_ms(lambda: warp.warp_fwd_with_hpre(*args, k))
        plain_ms = cuda_ms(lambda: warp.warp_fwd_plain(*args, k))
        work = warp_work(B, H, W, C, D, k)["warp_fwd"]
        print(f"kernel {name}: B={B} max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (tol {KERNEL_ATOL:g} abs) "
              f"kernel {ms:.4f} ms, storing hpre {ms_hpre:.4f} ms (hpre "
              f"max_abs_err={err_h:.3e}, tol {tol_h:.3e} = {BWD_REL:g} x "
              f"max|value|) plain {plain_ms:.4f} ms bound "
              f"{bound(*work, TF32X3_PEAK)[0]:.4f} ms (tensor cores as 3 "
              f"TF32 products; {bound(*work)[0]:.4f} ms on the FP32 cores)")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= KERNEL_ATOL, f"{name}: kernel vs plain {err:.3e}")
        check(torch.equal(got_h, got), f"{name}: the output moved when "
              f"hpre is stored")
        check(err_h <= tol_h, f"{name}: hpre vs plain {err_h:.3e}")
        results[name] = (err, ms, plain_ms)

    # what the wrapper refuses on a CUDA tensor, before any launch
    args = warp_inputs(1, 8, 8, 16, 32, 3, 1.0, 9, device)
    refusals = {
        "k = 10": (ValueError, lambda: warp.warp_fwd(
            *warp_inputs(1, 8, 8, 16, 32, 10, 1.0, 9, device), 10)),
        "D > 256": (ValueError, lambda: warp.warp_fwd(
            *warp_inputs(1, 8, 8, 16, 320, 3, 1.0, 9, device), 3)),
        "non-contiguous": (ValueError, lambda: warp.warp_fwd(
            args[0].transpose(1, 2), *args[1:], 3)),
        "float16": (TypeError, lambda: warp.warp_fwd(
            args[0].detach().half(), *args[1:], 3)),
        "a bfloat16 source with float32 weights": (TypeError,
            lambda: warp.warp_fwd(args[0].detach().bfloat16(), *args[1:],
                                  3)),
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
    """Both backward kernels, the per-position one from the forward
    kernel's hpre, against warp_bwd_pos_plain/warp_bwd_w1_plain given that
    hpre, at the two live sites, with far-off flows and at ragged shapes:
    each of the six outputs within BWD_REL x its max |value|; d_flow,
    dW1s, dW2 and db2 bitwise equal over two launches (d_source is added up
    by vector reductions in no fixed order)."""
    from gfla_tpu_torch.ops import warp

    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(KERNEL_CASES):
        args = warp_inputs(B, H, W, C, D, k, scale, 20 + i, device)
        src, flow, _, w1s, w2, b2 = args
        g = torch.from_numpy(np.random.RandomState(30 + i).randn(
            B, H, W, C).astype(np.float32)).to(device)
        hpre = warp.warp_fwd_with_hpre(*args, k)[1]
        got = warp.warp_bwd(src, flow, hpre, w1s, w2, b2, g, k)
        again = warp.warp_bwd(src, flow, hpre, w1s, w2, b2, g, k)
        want = warp.warp_bwd_plain(*args, g, k, hpre=hpre)
        torch.cuda.synchronize()
        errs = []
        for out, a, b in zip(BWD_OUTPUTS, got, want):
            err = (a - b).abs().max().item()
            bound = BWD_REL * b.abs().max().item()
            check(bool(torch.isfinite(a).all()), f"{name}: {out} non-finite")
            check(err <= bound, f"{name}: {out} kernel vs plain {err:.3e} > "
                  f"{bound:.3e}")
            errs.append(err)
        fixed = [out for out, a, b in zip(BWD_OUTPUTS, got, again)
                 if out != "d_source"]
        moved = [out for out, a, b in zip(BWD_OUTPUTS, got, again)
                 if out != "d_source" and not torch.equal(a, b)]
        check(not moved, f"{name}: {moved} differ between two launches")
        d_hpre = want[2]
        pos_ms = cuda_ms(lambda: warp.warp_bwd_pos(
            src, flow, hpre, w1s, w2, b2, g, k), iters=10)
        pos_plain = cuda_ms(lambda: warp.warp_bwd_pos_plain(
            *args, g, k, hpre=hpre), iters=10)
        w1_ms = cuda_ms(lambda: warp.warp_bwd_w1(src, flow, d_hpre, k),
                        iters=10)
        w1_plain = cuda_ms(lambda: warp.warp_bwd_w1_plain(
            src, flow, d_hpre, k), iters=10)
        work = warp_work(B, H, W, C, D, k)
        print(f"backward {name}: max_abs_err "
              + " ".join(f"{o}={e:.3e}" for o, e in zip(BWD_OUTPUTS, errs))
              + f" (tol {BWD_REL:g} x max|value|); {', '.join(fixed)} "
              f"bitwise equal over two launches; per-position kernel "
              f"{pos_ms:.4f} ms plain {pos_plain:.4f} ms bound "
              f"{bound_pair(work['warp_bwd_pos'])}; dW1s kernel "
              f"{w1_ms:.4f} ms plain {w1_plain:.4f} ms bound "
              f"{bound_pair(work['warp_bwd_w1'])}")
        results[name] = dict(pos=(max(errs[:3] + errs[4:]), pos_ms, pos_plain),
                             w1=(errs[3], w1_ms, w1_plain))

    args = warp_inputs(1, 8, 8, 16, 32, 3, 1.0, 9, device)
    src, flow, hidden_bt, w1s, w2, b2 = args
    hpre = hidden_bt.reshape(64, 32)
    g = torch.zeros(1, 8, 8, 16, device=device)
    refusals = {
        "g of the wrong shape": (ValueError, lambda: warp.warp_bwd(
            src, flow, hpre, w1s, w2, b2, g[:, :4], 3)),
        "non-contiguous g": (ValueError, lambda: warp.warp_bwd(
            src, flow, hpre, w1s, w2, b2, g.transpose(1, 2), 3)),
        "hpre of the wrong shape": (ValueError, lambda: warp.warp_bwd(
            src, flow, hidden_bt, w1s, w2, b2, g, 3)),
        "float64 d_hpre": (ValueError, lambda: warp.warp_bwd_w1(
            src, flow, hidden_bt.double(), 3)),
        "float16": (TypeError, lambda: warp.warp_bwd(
            src.half(), flow, hpre, w1s.half(), w2.half(), b2, g.half(), 3)),
    }
    expect_refusals("warp_bwd", refusals)
    return results


def bound(flops, nbytes, peak=F32_PEAK):
    """(bound_ms, bound_by): the least time one H100 SXM could take for work
    of `flops` f32 operations that moves `nbytes` bytes, on the unit whose
    rate for that work is `peak`: the FP32 cores, or for the two kernels
    that multiply on the tensor cores, TF32X3_PEAK."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_pair(work):
    """A kernel's bound on the tensor cores as split-f32 products, with
    the FP32 cores' beside it, as text."""
    ms, by = bound(*work, TF32X3_PEAK)
    return (f"{ms:.4f} ms ({by}, tensor cores as 3 TF32 products; "
            f"{bound(*work)[0]:.4f} ms on the FP32 cores)")


def warp_work(B, H, W, C, D, k):
    """(FLOPs, bytes) of each warp kernel at one site. A multiply-add is 2
    FLOPs; the dense products dominate, plus the logits, the weighted sum
    and the bilinear blend (7 per block value); each input is read once and
    each output written once, as 4-byte floats. The per-position backward
    starts from the forward's hpre (an input of hidden_bt's size), so it
    has one dense product, d_block = d_hpre W1s^T; a backward that
    recomputes hpre, as gfla_tpu's does, has a second."""
    N, k2 = B * H * W, k * k
    dense = 2 * N * k2 * C * D
    small = 2 * N * (D * k2 + k2 * C) + 7 * N * k2 * C
    ins = N * C + 2 * N + N * D + k2 * C * D + D * k2 + k2
    return {
        "warp_fwd": (dense + small, 4 * (ins + N * C)),
        "warp_bwd_pos": (dense + 2 * small + 4 * N * D * k2,
                         4 * (ins + N * C + N * C + 2 * N + N * D + D * k2
                              + k2)),
        "warp_bwd_w1": (dense + 7 * N * k2 * C,
                        4 * (N * C + 2 * N + N * D + k2 * C * D)),
    }


def warp_work_bf16(B, H, W, C, D, k):
    """(FLOPs, bytes) of each bf16 warp kernel at one site: warp_work's
    operations, and bytes with the source, g, the output, W1s and W2 in bf16
    and the flow, hidden_bt, hpre, d_hpre, d_source, d_flow and the weight
    gradients in f32."""
    N, k2 = B * H * W, k * k
    ops = {name: w[0] for name, w in warp_work(B, H, W, C, D, k).items()}
    fwd_in = 2 * N * C + 8 * N + 4 * N * D + 2 * k2 * C * D + 2 * D * k2 \
        + 4 * k2
    return {
        "warp_fwd": (ops["warp_fwd"], fwd_in + 2 * N * C),
        "warp_bwd_pos": (ops["warp_bwd_pos"],
                         fwd_in + 2 * N * C + 4 * N * C + 8 * N + 4 * N * D
                         + 4 * D * k2 + 4 * k2),
        "warp_bwd_w1": (ops["warp_bwd_w1"],
                        2 * N * C + 8 * N + 4 * N * D + 4 * k2 * C * D),
    }


def bf16_rule(what, kernel, plain, f32, tol):
    """The bf16 rule (see BF16_SLACK): returns the kernel's max abs error
    against its plain twin and that error x max|f32|^-1."""
    kernel, plain = kernel.float(), plain.float()
    top = max(f32.abs().max().item(), 1e-30)
    e_kernel = (kernel - f32).abs().max().item()
    e_plain = (plain - f32).abs().max().item()
    err = (kernel - plain).abs().max().item()
    check(bool(torch.isfinite(kernel).all()), f"{what}: non-finite")
    check(e_kernel <= 2 * e_plain + BF16_SLACK * top,
          f"{what}: {e_kernel / top:.3e} of max|f32| off the f32 result, "
          f"its plain twin {e_plain / top:.3e}")
    check(err <= tol * top, f"{what}: kernel vs plain {err / top:.3e} > "
          f"{tol:g} x max|f32|")
    return err, err / top


BF16_FWD = ("out", "hpre")


def phase_bf16_kernels(device):
    """The warp's three bf16 kernels (warp_fwd_bf16.cu, warp_bwd_bf16.cu)
    against their bf16 plain twins at every KERNEL_CASES shape, from bf16
    source, W1s, W2 and g: each output by the bf16 rule against the f32
    result of the same values; d_flow, d_hidden_bt, dW1s, dW2 and db2 bitwise
    equal over two launches; median ms of each kernel and twin, and the
    bound at the tensor cores' bf16 rate."""
    from gfla_tpu_torch.ops import warp

    bf = torch.bfloat16
    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(KERNEL_CASES):
        src, flow, hbt, w1s, w2, b2 = warp_inputs(B, H, W, C, D, k, scale,
                                                  40 + i, device)
        args = (src.to(bf), flow, hbt, w1s.to(bf), w2.to(bf), b2)
        wide = (args[0].float(), flow, hbt, args[3].float(),
                args[4].float(), b2)  # the same values, computed in f32
        g = torch.from_numpy(np.random.RandomState(50 + i).randn(
            B, H, W, C).astype(np.float32)).to(device).to(bf)
        out, hpre = warp.warp_fwd_with_hpre(*args, k)
        plain = warp.warp_fwd_plain(*args, k, with_hpre=True)
        f32 = warp.warp_fwd_plain(*wide, k, with_hpre=True)
        check(out.dtype == bf and hpre.dtype == torch.float32,
              f"{name}: bf16 forward gave {out.dtype}, hpre {hpre.dtype}")
        got = warp.warp_bwd(args[0], flow, hpre, args[3], args[4], b2, g, k)
        again = warp.warp_bwd(args[0], flow, hpre, args[3], args[4], b2, g,
                              k)
        want = warp.warp_bwd_plain(*args, g, k, hpre=hpre)
        f32_bwd = warp.warp_bwd_plain(*wide, g.float(), k, hpre=f32[1])
        torch.cuda.synchronize()
        errs = {}
        for out_name, a, b, f in zip(BF16_FWD + BWD_OUTPUTS,
                                     (out, hpre, *got), (*plain, *want),
                                     (*f32, *f32_bwd)):
            tol = (BF16_OUT_REL if out_name in ("out", "hpre", "d_source")
                   else BF16_GRAD_REL)
            errs[out_name] = bf16_rule(f"bf16 {name} {out_name}", a, b, f,
                                       tol)
        moved = [o for o, a, b in zip(BWD_OUTPUTS, got, again)
                 if o != "d_source" and not torch.equal(a, b)]
        check(not moved, f"bf16 {name}: {moved} differ between two launches")
        d_hpre = got[2]
        ms = {
            "fwd": (cuda_ms(lambda: warp.warp_fwd(*args, k)),
                    cuda_ms(lambda: warp.warp_fwd_plain(*args, k))),
            "pos": (cuda_ms(lambda: warp.warp_bwd_pos(
                args[0], flow, hpre, args[3], args[4], b2, g, k), iters=10),
                    cuda_ms(lambda: warp.warp_bwd_pos_plain(
                        *args, g, k, hpre=hpre), iters=10)),
            "w1": (cuda_ms(lambda: warp.warp_bwd_w1(args[0], flow, d_hpre, k),
                           iters=10),
                   cuda_ms(lambda: warp.warp_bwd_w1_plain(args[0], flow,
                                                          d_hpre, k),
                           iters=10)),
        }
        work = warp_work_bf16(B, H, W, C, D, k)
        bounds = {part: bound(*work[kern], BF16_PEAK) for part, kern in (
            ("fwd", "warp_fwd"), ("pos", "warp_bwd_pos"),
            ("w1", "warp_bwd_w1"))}
        print(f"bf16 kernels {name}: B={B} kernel vs bf16 plain twin, "
              f"x max|f32|: " + " ".join(
                  f"{o}={rel:.3e}" for o, (_, rel) in errs.items())
              + " (tol out, hpre, d_source "
              f"{BF16_OUT_REL:g}, others {BF16_GRAD_REL:g}; each within 2x "
              f"the twin's error against f32 + {BF16_SLACK:g}); "
              + "; ".join(f"{part} kernel {ms[part][0]:.4f} ms plain "
                          f"{ms[part][1]:.4f} ms bound {bounds[part][0]:.4f} "
                          f"ms ({bounds[part][1]}, bf16 989 TFLOP/s)"
                          for part in ms))
        results[name] = {part: (max(errs[o][0] for o in outs), *ms[part])
                         for part, outs in (
                             ("fwd", BF16_FWD),
                             ("pos", ("d_source", "d_flow", "d_hidden_bt",
                                      "dW2", "db2")),
                             ("w1", ("dW1s",)))}
    return results


CORR_CASES = [  # name, B, Ns, Nt, C, exact ties
    ("relu3_1 B=8 4096x4096 C256", 8, 4096, 4096, 256, False),
    ("relu4_1 B=8 1024x1024 C512", 8, 1024, 1024, 512, False),
    ("ragged B=3 Ns=1000 Nt=777 C3", 3, 1000, 777, 3, False),
    ("duplicated and zero rows B=2 4096x4096 C256", 2, 4096, 4096, 256,
     True),
    ("market relu3_1 B=8 512x512 C256", 8, 512, 512, 256, False),
    ("market relu4_1 B=8 128x128 C512", 8, 128, 128, 512, False),
    ("animation relu3_1 B=12 4096x4096 C256", 12, 4096, 4096, 256, False),
    ("animation relu4_1 B=12 1024x1024 C512", 12, 1024, 1024, 512, False),
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
        decided = at_err = err64 = 0
        for b in range(B):
            corr = s[b] @ t[b].T                                  # (Ns, Nt)
            exact = (s[b].double() @ t[b].double().T).max(0).values
            err64 = max(err64, (cmax[b] - exact).abs().max().item())
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
        bound_ms, bound_by = bound(*corr_work(B, Ns, Nt, C), TF32X3_PEAK)
        fp32_bound_ms = bound(*corr_work(B, Ns, Nt, C))[0]
        print(f"corr kernel {name}: cmax max_abs_err={err:.3e} (tol "
              f"{CORR_ATOL:g}), {err64:.3e} off the float64 maximum; argmax "
              f"equal at all {decided} of {B * Nt} "
              f"rows with a top-two gap > {CORR_ATOL:g}"
              + (" and at every tie" if ties else "")
              + f"; correlation at the kernel's argmax within {at_err:.3e}; "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bmm+max "
              f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}, "
              f"tensor cores as 3 TF32 products; {fp32_bound_ms:.4f} ms on "
              f"the FP32 cores)")
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
    ("shapenet k=3 site N=32768 C128", 8 * 64 * 64, 3, 128, 128, 0.1),
    ("animation k=5 site N=8192 C128", 2 * 64 * 64, 5, 128, 128, 0.1),
    ("animation k=3 site N=2048 C256", 2 * 32 * 32, 3, 256, 128, 0.1),
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
    """(FLOPs, bytes) of the forward kernel, of the backward kernel, and of
    the backward gfla_tpu's kernel computes. Each has the dense layer over
    [bt || bs] once: the forward's product, the backward's d_[bt || bs] =
    d_hpre W1^T, since it starts from the forward's hpre; the recomputing
    backward has it twice. Plus the logits, the weighted sum and their
    gradients on the FP32 cores; each input read once, each output written
    once, as 4-byte floats: the forward reads bs and bt, the backward bs, g
    and hpre (bt only for dW1, outside the kernel) and writes d_bs, d_bt and
    d_hpre."""
    k2 = k * k
    dense = 2 * N * 2 * k2 * C * D
    weights = 2 * k2 * C * D + D + D * k2 + k2
    sums = D * k2 + D + k2
    small = 2 * N * (3 * D * k2 + 2 * k2 * C)
    fwd = (dense + 2 * N * (D * k2 + k2 * C),
           4 * (2 * N * k2 * C + weights + N * C))
    bwd = (dense + small,
           4 * (N * k2 * C + N * C + N * D + weights + 2 * N * k2 * C
                + N * D + sums))
    recompute = (2 * dense + small,
                 4 * (2 * N * k2 * C + N * C + weights + 2 * N * k2 * C
                      + N * D + sums))
    return fwd, bwd, recompute


def phase_attn_kernel(device):
    """Both attention-math kernels against their plain twins, the backward
    from the forward kernel's hpre: the forward, hpre and each of the six
    backward outputs within BWD_REL x its max |value|; the forward's output
    unchanged when it stores hpre; all six backward outputs bitwise equal
    over two launches (the sums over positions are added in a fixed order,
    the rest written once with no atomics). Returns the results, and the
    inputs of the cases ATTN_BF16_CASES names, for phase 8b."""
    from gfla_tpu_torch.ops import attn_math

    results, kept = {}, {}
    for i, (name, N, k, C, D, slope) in enumerate(ATTN_CASES):
        args, g = attn_inputs(N, k, C, D, 50 + i, device)
        if any(name == c[0] for c in ATTN_BF16_CASES):
            kept[name] = (args, g)
        bs, bt, w1, b1, w2, b2 = args
        out = attn_math.attn_math_fwd(*args, slope)
        out_h, hpre = attn_math.attn_math_fwd_with_hpre(*args, slope)
        want, want_h = attn_math.attn_math_plain(*args, slope, with_hpre=True)
        got_b = attn_math.attn_math_bwd(bs, bt, g, w1, b1, w2, b2, slope,
                                        hpre)
        again = attn_math.attn_math_bwd(bs, bt, g, w1, b1, w2, b2, slope,
                                        hpre)
        want_b = attn_math.attn_math_bwd_plain(bs, bt, g, w1, b1, w2, b2,
                                               slope, hpre)
        torch.cuda.synchronize()
        errs, faults = [], []
        for what, a, b in zip(("out", "hpre") + ATTN_OUTPUTS,
                              (out, hpre, *got_b), (want, want_h, *want_b)):
            err = (a - b).abs().max().item()
            tol = BWD_REL * b.abs().max().item()
            if not (bool(torch.isfinite(a).all()) and err <= tol):
                faults.append(f"{what} {err:.3e} > {tol:.3e}")
            errs.append(err)
        check(not faults, f"{name}: kernel vs plain: {', '.join(faults)}")
        check(torch.equal(out_h, out), f"{name}: the output moved when hpre "
              f"is stored")
        moved = [o for o, a, b in zip(ATTN_OUTPUTS, got_b, again)
                 if not torch.equal(a, b)]
        check(not moved, f"{name}: {moved} differ between two launches")
        fwd_ms = cuda_ms(lambda: attn_math.attn_math_fwd(*args, slope),
                         iters=10)
        fwd_hpre_ms = cuda_ms(lambda: attn_math.attn_math_fwd_with_hpre(
            *args, slope), iters=10)
        fwd_plain = cuda_ms(lambda: attn_math.attn_math_plain(*args, slope),
                            iters=10)
        bwd_ms = cuda_ms(lambda: attn_math.attn_math_bwd(
            bs, bt, g, w1, b1, w2, b2, slope, hpre), iters=10)
        bwd_plain = cuda_ms(lambda: attn_math.attn_math_bwd_plain(
            bs, bt, g, w1, b1, w2, b2, slope, hpre), iters=10)
        bwd_recompute = cuda_ms(lambda: attn_math.attn_math_bwd_plain(
            bs, bt, g, w1, b1, w2, b2, slope), iters=10)
        dw1_ms = cuda_ms(lambda: attn_math.attn_math_dw1(bs, bt, want_b[2]),
                         iters=10)
        fwd_work, bwd_work, recompute_work = attn_work(N, k, C, D)
        print(f"attn-math {name}: max_abs_err out={errs[0]:.3e} "
              f"hpre={errs[1]:.3e} "
              + " ".join(f"{o}={e:.3e}" for o, e in zip(ATTN_OUTPUTS,
                                                        errs[2:]))
              + f" (tol {BWD_REL:g} x max|value|); backward outputs bitwise "
              f"equal over two launches; forward kernel {fwd_ms:.4f} ms, "
              f"storing hpre {fwd_hpre_ms:.4f} ms, plain {fwd_plain:.4f} ms, "
              f"bound {bound_pair(fwd_work)}; backward kernel from hpre "
              f"{bwd_ms:.4f} ms, plain given hpre {bwd_plain:.4f} ms, plain "
              f"recomputing hpre {bwd_recompute:.4f} ms, bound "
              f"{bound_pair(bwd_work)} (recomputing: "
              f"{bound_pair(recompute_work)}); dW1 matmul outside "
              f"{dw1_ms:.4f} ms")
        results[name] = dict(
            fwd=dict(err=max(errs[:2]), ms=fwd_ms, plain_ms=fwd_plain,
                     work=fwd_work),
            bwd=dict(err=max(errs[2:]), ms=bwd_ms, plain_ms=bwd_plain,
                     work=bwd_work))
    args, g = attn_inputs(40, 3, 8, 16, 59, device)
    bs, bt, w1, b1, w2, b2 = args
    hpre = attn_math.attn_math_fwd_with_hpre(*args)[1]
    refusals = {
        "C > 512": (ValueError, lambda: attn_math.attn_math_fwd(
            *attn_inputs(4, 3, 520, 16, 59, device)[0])),
        "bfloat16 blocks with float32 weights": (
            TypeError, lambda: attn_math.attn_math_fwd(bs.bfloat16(),
                                                       *args[1:])),
        "non-contiguous": (ValueError, lambda: attn_math.attn_math_fwd(
            bs.transpose(0, 1).contiguous().transpose(0, 1), *args[1:])),
        "g of the wrong shape": (ValueError, lambda: attn_math.attn_math_bwd(
            bs, bt, g[:20], w1, b1, w2, b2, 0.1, hpre)),
        "no hpre": (ValueError, lambda: attn_math.attn_math_bwd(
            bs, bt, g, w1, b1, w2, b2)),
        "hpre of the wrong shape": (ValueError, lambda: attn_math.attn_math_bwd(
            bs, bt, g, w1, b1, w2, b2, 0.1, hpre[:, :8].contiguous())),
    }
    expect_refusals("attn_math", refusals)
    return results, kept


ATTN_BF16_CASES = [  # name, N, k, C, D (LeakyReLU 0.1), cases of ATTN_CASES
    ("k=5 site N=32768 C128", 8 * 64 * 64, 5, 128, 128),
    ("k=3 site N=8192 C256", 8 * 32 * 32, 3, 256, 128),
    ("shapenet k=3 site N=32768 C128", 8 * 64 * 64, 3, 128, 128),
    ("ragged N=1000 k=3 C21 D42", 1000, 3, 21, 42),
]


def attn_work_bf16(N, k, C, D):
    """(FLOPs, bytes) of the bf16 forward (storing hpre) and backward
    kernels: attn_work's operations, and bytes with the blocks, g, the
    weights and d_bs, d_bt, d_hpre in bf16, hpre and the sums in f32."""
    k2 = k * k
    fwd_ops, bwd_ops, _ = (w[0] for w in attn_work(N, k, C, D))
    weights = 2 * (2 * k2 * C * D + D + D * k2 + k2)
    fwd = 2 * (2 * N * k2 * C + N * C) + weights + 4 * N * D
    bwd = (2 * (N * k2 * C + N * C) + 4 * N * D + weights
           + 2 * (2 * N * k2 * C + N * D) + 4 * (D * k2 + D + k2))
    return (fwd_ops, fwd), (bwd_ops, bwd)


def phase_attn_bf16_kernels(inputs):
    """The attention-math kernels' bf16 instances (attn_math_fwd_bf16.cu,
    attn_math_bwd_bf16.cu) against their bf16 plain twins at the pose
    sites, ShapeNet's and a ragged shape, from bf16 blocks, weights and g
    (phase 8's `inputs` of the same cases, rounded): the output by the bf16
    rule, the f32 hpre within BWD_REL x max of the twin's (f32 sums of the
    same bf16 products), the output unchanged when hpre is stored; the
    backward from the kernel's hpre, each of its six outputs by the bf16
    rule and bitwise equal over two launches; median ms of each kernel and
    twin, the bound at the bf16 rate."""
    from gfla_tpu_torch.ops import attn_math

    bf = torch.bfloat16
    results = {}
    for name, N, k, C, D in ATTN_BF16_CASES:
        args32, g32 = inputs.pop(name)
        args = tuple(t.to(bf) for t in args32)
        g = g32.to(bf)
        wide = tuple(t.float() for t in args)  # the same values in f32
        out, hpre = attn_math.attn_math_fwd_with_hpre(*args)
        out_only = attn_math.attn_math_fwd(*args)
        plain, plain_h = attn_math.attn_math_plain(*args, with_hpre=True)
        f32, f32_h = attn_math.attn_math_plain(*wide, with_hpre=True)
        check(out.dtype == bf and hpre.dtype == torch.float32,
              f"bf16 attn-math {name}: forward gave {out.dtype}, hpre "
              f"{hpre.dtype}")
        bs, bt, w1, b1, w2, b2 = args
        got = attn_math.attn_math_bwd(bs, bt, g, w1, b1, w2, b2, 0.1, hpre)
        again = attn_math.attn_math_bwd(bs, bt, g, w1, b1, w2, b2, 0.1, hpre)
        want = attn_math.attn_math_bwd_plain(bs, bt, g, w1, b1, w2, b2, 0.1,
                                             hpre)
        f32_b = attn_math.attn_math_bwd_plain(*wide[:2], g.float(), *wide[2:],
                                              0.1, f32_h)
        torch.cuda.synchronize()
        check(torch.equal(out_only, out), f"bf16 attn-math {name}: the "
              f"output moved when hpre is stored")
        err_h = (hpre - plain_h).abs().max().item()
        tol_h = BWD_REL * plain_h.abs().max().item()
        check(err_h <= tol_h, f"bf16 attn-math {name}: hpre vs plain "
              f"{err_h:.3e} > {tol_h:.3e}")
        errs = {"out": bf16_rule(f"bf16 attn-math {name} out", out, plain,
                                 f32, BF16_OUT_REL)}
        for o, a, b, f in zip(ATTN_OUTPUTS, got, want, f32_b):
            check(a.dtype == b.dtype, f"bf16 attn-math {name}: {o} in "
                  f"{a.dtype}, the twin's {b.dtype}")
            errs[o] = bf16_rule(f"bf16 attn-math {name} {o}", a, b, f,
                                BF16_OUT_REL if o == "d_bs"
                                else BF16_GRAD_REL)
        moved = [o for o, a, b in zip(ATTN_OUTPUTS, got, again)
                 if not torch.equal(a, b)]
        check(not moved, f"bf16 attn-math {name}: {moved} differ between two "
              f"launches")
        ms = {
            "fwd": (cuda_ms(lambda: attn_math.attn_math_fwd_with_hpre(*args),
                            iters=10),
                    cuda_ms(lambda: attn_math.attn_math_plain(
                        *args, with_hpre=True), iters=10)),
            "bwd": (cuda_ms(lambda: attn_math.attn_math_bwd(
                bs, bt, g, w1, b1, w2, b2, 0.1, hpre), iters=10),
                    cuda_ms(lambda: attn_math.attn_math_bwd_plain(
                        bs, bt, g, w1, b1, w2, b2, 0.1, hpre), iters=10)),
        }
        work = dict(zip(("fwd", "bwd"), attn_work_bf16(N, k, C, D)))
        bounds = {part: bound(*work[part], BF16_PEAK) for part in work}
        print(f"bf16 attn-math {name}: kernel vs bf16 plain twin, x "
              f"max|f32|: " + " ".join(
                  f"{o}={rel:.3e}" for o, (_, rel) in errs.items())
              + f" (tol out, d_bs {BF16_OUT_REL:g}, others "
              f"{BF16_GRAD_REL:g}; each within 2x the twin's error against "
              f"f32 + {BF16_SLACK:g}); hpre max_abs_err={err_h:.3e} (tol "
              f"{tol_h:.3e}); backward outputs bitwise equal over two "
              f"launches; "
              + "; ".join(f"{part} kernel {ms[part][0]:.4f} ms plain "
                          f"{ms[part][1]:.4f} ms bound {bounds[part][0]:.4f} "
                          f"ms ({bounds[part][1]}, bf16 989 TFLOP/s)"
                          for part in ms))
        results[name] = {
            "fwd": dict(err=errs["out"][0], ms=ms["fwd"][0],
                        plain_ms=ms["fwd"][1], work=work["fwd"]),
            "bwd": dict(err=max(errs[o][0] for o in ATTN_OUTPUTS),
                        ms=ms["bwd"][0], plain_ms=ms["bwd"][1],
                        work=work["bwd"])}
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
    return dict(launches=launches, task=task, request=requests[0],
                requests=requests)


def phase_serve_bf16(serve, extra_args):
    """Serving under --compute_dtype=bfloat16: the same weights and requests
    as phase_slice through PoseTask.test_step, the bf16 warp kernel launched
    twice a request and nothing else; the image against the plain bf16 path
    and both against the f32 output by the bf16 rule; ms per forward beside
    the f32 path's, in turns. Then the same under GFLA_ATTN_PALLAS=1: the
    bf16 attention-math forward launched twice a request and nothing else,
    the image against that route's plain bf16 path and the f32 image, and
    the share of each ExtractorAttn output's values that differ there."""
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    opt = TestOptions().parse(
        ["--model=pose", "--dataset_mode=synthetic", "--load_size=256",
         "--batchSize=8", "--gpu_ids=0", "--compute_dtype=bfloat16",
         *extra_args], save=False)
    task, f32_task = create_task(opt), serve["task"]
    task.net_g.load_state_dict(f32_task.net_g.state_dict())
    requests = serve["requests"]
    reset_launch_counts()
    outs = [task.test_step(batch) for batch in requests]
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"bf16 served {len(requests)} requests: launches {counts}")
    check(only(counts, warp_fwd_bf16=2 * len(requests)),
          f"bf16 serving launched {counts}, expected 2 warp_fwd_bf16 a "
          f"request and nothing else")
    for img, flows, masks in outs:
        check(tuple(img.shape) == (8, 3, 256, 256)
              and img.dtype == torch.float32, f"bf16 image {img.shape} "
              f"{img.dtype}")
        check(bool(torch.isfinite(img).all()), "bf16: non-finite output")
        check(img.min().item() >= -1 and img.max().item() <= 1,
              "bf16: output outside [-1, 1]")
    with plain_warp():
        plain_img = task.test_step(requests[0])[0]
    f32_img = f32_task.test_step(requests[0])[0]
    err, rel = bf16_rule("bf16 serving", outs[0][0], plain_img, f32_img,
                         SERVE_BF16_REL)
    top = f32_img.abs().max().item()
    print(f"bf16 serving: kernel vs plain bf16 path max_abs_diff={err:.3e} "
          f"= {rel:.3e} x max|f32 image| (bound {SERVE_BF16_REL:g}); off the "
          f"f32 image by {(outs[0][0] - f32_img).abs().max().item() / top:.3e}"
          f" (kernel) and {(plain_img - f32_img).abs().max().item() / top:.3e}"
          f" (plain) of its max {top:.3e}")
    times = {"f32": [], "bf16": []}
    for path in ("f32", "bf16", "bf16", "f32"):
        run = task if path == "bf16" else f32_task
        times[path].append(cuda_ms(lambda: run.test_step(requests[1]),
                                   iters=10))
    with plain_warp():
        plain_ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    print(f"bf16 forward batch 8 at 256x256: kernel path "
          f"{', '.join(f'{t:.3f}' for t in times['bf16'])} ms, plain bf16 "
          f"path {plain_ms:.3f} ms; f32 kernel path "
          f"{', '.join(f'{t:.3f}' for t in times['f32'])} ms (in turns)")
    with switches(GFLA_ATTN_PALLAS="1"):
        reset_launch_counts()
        attn_outs = [task.test_step(batch)[0] for batch in requests]
        torch.cuda.synchronize()
        attn_counts = launch_counts()
        reset_launch_counts()
        with plain_attn_math():
            attn_plain, sites_plain = attention_outputs(task, requests[0])
        torch.cuda.synchronize()
        plain_counts = launch_counts()
        _, sites = attention_outputs(task, requests[0])
        attn_ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    differ = [(a != b).float().mean().item() for a, b in zip(sites,
                                                              sites_plain)]
    site_rel = [((a.float() - b.float()).abs().max()
                 / b.float().abs().max()).item()
                for a, b in zip(sites, sites_plain)]
    print(f"bf16 served {len(requests)} requests under GFLA_ATTN_PALLAS=1: "
          f"launches {attn_counts}")
    check(only(attn_counts, attn_math_fwd_bf16=2 * len(requests)),
          f"bf16 GFLA_ATTN_PALLAS=1 serving launched {attn_counts}, expected "
          f"2 attn_math_fwd_bf16 a request and nothing else")
    check(only(plain_counts), f"the plain bf16 GFLA_ATTN_PALLAS=1 path "
          f"launched {plain_counts}")
    for img in attn_outs:
        check(tuple(img.shape) == (8, 3, 256, 256)
              and bool(torch.isfinite(img).all())
              and img.min().item() >= -1 and img.max().item() <= 1,
              "bf16 GFLA_ATTN_PALLAS=1: image shape, finiteness or range")
    attn_err, attn_rel = bf16_rule("bf16 GFLA_ATTN_PALLAS=1 serving",
                                   attn_outs[0], attn_plain, f32_img,
                                   SERVE_BF16_REL)
    print(f"bf16 GFLA_ATTN_PALLAS=1 serving: kernel vs plain bf16 path "
          f"max_abs_diff={attn_err:.3e} = {attn_rel:.3e} x max|f32 image| "
          f"(bound {SERVE_BF16_REL:g}); off the f32 image by "
          f"{(attn_outs[0] - f32_img).abs().max().item() / top:.3e} (kernel) "
          f"and {(attn_plain - f32_img).abs().max().item() / top:.3e} "
          f"(plain); {attn_ms:.3f} ms per batch-8 forward; the "
          f"ExtractorAttn outputs, kernel vs plain: "
          + ", ".join(f"{100 * d:.3f}% of values differ, max "
                      f"{r:.3e} x max" for d, r in zip(differ, site_rel)))
    check(len(sites) == len(sites_plain) == 2,
          f"bf16 GFLA_ATTN_PALLAS=1: {len(sites)} ExtractorAttn outputs")
    return dict(launches=counts["warp_fwd_bf16"], err=err,
                ms=statistics.median(times["bf16"]),
                attn_launches=attn_counts["attn_math_fwd_bf16"])


def launch_counts():
    from gfla_tpu_torch.ops import attn_math, max_corr, warp

    return {"warp_fwd": warp.launches, "warp_bwd_pos": warp.bwd_pos_launches,
            "warp_bwd_w1": warp.bwd_w1_launches,
            "warp_fwd_bf16": warp.bf16_launches,
            "warp_bwd_pos_bf16": warp.bf16_bwd_pos_launches,
            "warp_bwd_w1_bf16": warp.bf16_bwd_w1_launches,
            "max_corr": max_corr.launches,
            "attn_math_fwd": attn_math.fwd_launches,
            "attn_math_bwd": attn_math.bwd_launches,
            "attn_math_fwd_bf16": attn_math.bf16_fwd_launches,
            "attn_math_bwd_bf16": attn_math.bf16_bwd_launches}


def reset_launch_counts():
    from gfla_tpu_torch.ops import attn_math, max_corr, warp

    warp.launches = warp.bwd_pos_launches = warp.bwd_w1_launches = 0
    warp.bf16_launches = warp.bf16_bwd_pos_launches = 0
    warp.bf16_bwd_w1_launches = 0
    max_corr.launches = 0
    attn_math.fwd_launches = attn_math.bwd_launches = 0
    attn_math.bf16_fwd_launches = attn_math.bf16_bwd_launches = 0


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


def plain_attn_math():
    """The GFLA_ATTN_PALLAS=1 route's plain path: the attention math as
    `attn_math_plain`, differentiated by autograd."""
    from gfla_tpu_torch.ops import attn_math

    return mock.patch.object(attn_math, "attn_math", attn_math.attn_math_plain)


def nets(task):
    """The task's trained networks: G, and D and D_V where the task has
    them."""
    out = {"G": task.net_g}
    if hasattr(task, "net_d"):
        out["D"] = task.net_d
    if hasattr(task, "net_d_v"):
        out["D_V"] = task.net_d_v
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
        task.train_step({k: v.double() if v.is_floating_point() else v
                         for k, v in batch.items()})
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
    """A copy of `task` whose flow heads' biases (of each flow net) are
    seeded fractions in
    [0.3, 0.7]. At the seeded init the flows are nearly 0, so every sample
    of the warp and of the correctness loss's resampler sits on an integer
    coordinate, where floor() makes the gradient jump; the last bits of a
    float32 flow then decide the side, and no two summation orders (f32 vs
    f64, card vs CPU) agree there. Between integers both are smooth."""
    task = copy.deepcopy(task)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, head in task.net_g.named_modules():
            if name.startswith("flow_net") \
                    and name.rsplit(".", 1)[-1].startswith("output"):
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


def train_opt(*extra, model="pose", dataset="synthetic", ckpt=None):
    """The training CLI's options at full width, batch 8, checkpoints in
    `ckpt` or a new temporary directory (returned beside them, for the
    caller to clean)."""
    from gfla_tpu_torch.options import TrainOptions

    ckpt = ckpt or tempfile.TemporaryDirectory()
    opt = TrainOptions().parse(
        [f"--model={model}", f"--dataset_mode={dataset}", "--load_size=256",
         "--batchSize=8", "--gpu_ids=0", f"--checkpoints_dir={ckpt.name}",
         *extra], save=False)
    opt.iters_per_epoch = 1000
    return opt, ckpt


def train_main_path(task, opt, batches, what, still_ok=(), **launches):
    """The main path of a training phase: TRAIN_STEPS steps of `task`,
    counted (`launches`, and no other kernel) and timed, with the peak
    memory; finite losses; every parameter moved but those named by a
    prefix in `still_ok` whose gradient is None or exactly 0, every
    parameter and buffer still f32; u computed in the task's dtype by D(real) and D(fake)
    (step 1's D passes, recorded inside each call) and stored, in f32, by
    them alone; the plain path's time per step from the state reached;
    a save, then resume, gives the same next step. Returns (counts, times,
    plain_times, peak)."""
    from gfla_tpu_torch.tasks import create_task

    s0 = snapshot(task)
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
    print(f"{what}trained {TRAIN_STEPS} steps: kernel launches {counts}")
    check(only(counts, **launches), f"{what}launches {counts} for "
          f"{TRAIN_STEPS} steps, expected {launches} and nothing else")

    for i, step_logs in enumerate(logs):
        check(sorted(step_logs) == sorted(task.loss_names + ["total_G"]),
              f"loss names {sorted(step_logs)}")
        for name, v in step_logs.items():
            check(bool(torch.isfinite(v)),
                  f"{what}step {i + 1}: {name} not finite")
    for i in (0, TRAIN_STEPS - 1):
        print(f"{what}losses, step {i + 1}: " + " ".join(
            f"{k} {float(v):.5f}" for k, v in logs[i].items()))
    for tag, net in nets(task).items():
        still = [n for n, p in net.named_parameters()
                 if torch.equal(p, s0[tag]["params"][n])
                 and not (n.startswith(still_ok)
                          and (p.grad is None or not p.grad.any()))]
        check(not still, f"{what}{tag}: parameters unchanged: {still}")
        kinds = {t.dtype for t in (*net.parameters(), *net.buffers())}
        check(kinds == {torch.float32}, f"{what}{tag}: state in {kinds}")
    check([flag for flag, _ in u_seen] == [True, True, False],
          f"{what}D passes of step 1: update_stats {[f for f, _ in u_seen]}")
    u0, (_, u_real), (_, u_fake), (_, u_gen) = s0["D"]["u"], *u_seen
    spectral = [n for n in u0 if u0[n].numel() > 1]  # 1 output: u is 1
    for n in spectral:
        check(u_real[n].dtype == task.dtype
              and not torch.equal(u_real[n].float(), u0[n])
              and not torch.equal(u_fake[n], u_real[n]),
              f"{what}the D step left {n} unchanged, or not in {task.dtype}")
        check(torch.equal(u_gen[n], u_fake[n])
              and torch.equal(u_after["D"]["u"][n], u_fake[n].float()),
              f"{what}the G-loss pass stored {n}")
    print(f"{what}u: D(real) and D(fake) each stored a new u, computed in "
          f"{task.dtype}, in the {len(spectral)} spectral convs with more "
          f"than one output; the G-loss pass stored none")

    # the plain path's time per step, from the state the main path reached
    plain = copy.deepcopy(task)
    with plain_warp():
        plain_times, _ = timed_steps(plain, batches[1:TRAIN_STEPS])
    del plain

    # checkpoint round trip: the resumed task's next step equals this one's
    task.save(TRAIN_STEPS)
    resumed = create_task(opt)
    check(resumed.resume("latest") == TRAIN_STEPS, f"{what}resume step")
    want = task.train_step(batches[TRAIN_STEPS])
    got = resumed.train_step(batches[TRAIN_STEPS])
    ckpt_rel = rel_diff(got, want)
    print(f"{what}checkpoint save/resume at step {TRAIN_STEPS}: next-step "
          f"losses within {ckpt_rel:.3e} rel (bound {CKPT_REL:g})")
    check(ckpt_rel <= CKPT_REL, f"{what}resumed step {got} vs {want}")
    return counts, times, plain_times, peak


def phase_train():
    """The full-width pose training step (D then G) through the kernels."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--name=train_smoke")
    task = create_task(opt)
    check(task.net_g.source.block0.model[2].out_channels == 64
          and task.net_d.block0.model[1].weight_orig.shape[0] == 32
          and task.net_d.layers == 4, "not the full-width train config")
    lrs = {"G": opt.lr, "D": opt.lr * opt.ratio_g2d}
    batches = [task.prepare_batch(deepfashion_batch(100 + s))
               for s in range(TRAIN_STEPS + 1)]
    state0 = copy.deepcopy(task)
    counts, times, plain_times, peak = train_main_path(
        task, opt, batches, "", warp_fwd=2 * TRAIN_STEPS,
        warp_bwd_pos=2 * TRAIN_STEPS, warp_bwd_w1=2 * TRAIN_STEPS)
    del task
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
    return dict(counts=counts, state=state, batch=batches[0], ms=ms,
                peak=peak)


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    return (a @ b).item() / (na * nb) if na and nb else 0.0


def grads_by_rule(what, kernel, plain, f32, resolved=None):
    """One step's gradients on the kernel path against the plain bf16 path
    directly, each tensor by its cosine and norm ratio and each network by
    its concatenated cosine (BF16_STEP_HOLD), the flow net's and the
    attention's printed apart; and both against the f32 step's by the bf16
    rule's first clause on each network's mean over tensors. A tensor whose
    f32 gradient is rounding only (a conv bias feeding an instance norm)
    is left out: of the direct hold where its f32 gradient's norm is below
    1e-2 of the plain path's, of the mean where its max is below 1e-5 of
    the network's. With `resolved`, a cosine: a tensor outside the direct
    hold whose gradient bf16 does not resolve, the plain bf16 path's own at
    a cosine below `resolved` with the f32 step's, is held by the bf16
    rule's first clause on its own instead (the kernel path's max error
    against the f32 gradient at most 2x the plain path's + BF16_SLACK x its
    max): two bf16 computations of a gradient that bf16 rounding dominates
    need not point alike."""
    for tag in f32:
        grads = {side: s[tag]["grads"] for side, s in (
            ("f32", f32), ("kernel", kernel), ("plain", plain))}
        scale = max(g.abs().max().item() for g in grads["f32"].values())
        rows, errs = {}, []
        for name, g32 in grads["f32"].items():
            gk, gp = grads["kernel"][name], grads["plain"][name]
            if g32.abs().max().item() > 1e-5 * scale:
                top = g32.abs().max().item()
                errs.append([(g - g32).abs().max().item() / top
                             for g in (gk, gp)])
            if g32.norm().item() > 1e-2 * gp.norm().item() and (
                    gk.norm().item() or gp.norm().item()):
                rows[name] = (cosine(gk, gp),
                              gk.norm().item() / max(gp.norm().item(), 1e-30),
                              (gk - gp).abs().max().item()
                              / max(gp.abs().max().item(), 1e-30))
        groups = {"flow net": [n for n in rows if n.startswith("flow_net.")],
                  "attention": [n for n in rows if ".attn" in n],
                  "all": list(rows)}
        for group, names in groups.items():
            if not names:
                continue
            cos = [rows[n][0] for n in names]
            ratio = [rows[n][1] for n in names]
            print(f"{what}: {tag} {group} gradients, kernel vs plain path, "
                  f"{len(names)} tensors: cosine min {min(cos):.5f} "
                  f"({min(names, key=lambda n: rows[n][0])}) median "
                  f"{statistics.median(cos):.5f}, norm ratio "
                  f"{min(ratio):.4f}-{max(ratio):.4f}, max error up to "
                  f"{max(rows[n][2] for n in names):.3e} of the plain "
                  f"path's max")
        floor, whole_floor, band = BF16_STEP_HOLD[tag]
        bad = [(n, *rows[n][:2]) for n in rows
               if rows[n][0] < floor or not band[0] <= rows[n][1] <= band[1]]
        for name, c_kernel, ratio in list(bad):
            g32 = grads["f32"][name]
            gk, gp = grads["kernel"][name], grads["plain"][name]
            if resolved is None or cosine(gp, g32) >= resolved:
                continue
            top = g32.abs().max().item()
            e_k, e_p = ((g - g32).abs().max().item() / top for g in (gk, gp))
            print(f"{what}: {tag} {name}: kernel vs plain path at cosine "
                  f"{c_kernel:.4f}, norm ratio {ratio:.4f}; bf16 does not "
                  f"resolve it (cosine with the f32 gradient "
                  f"{cosine(gp, g32):.4f} on the plain path, "
                  f"{cosine(gk, g32):.4f} on the kernel path); off the f32 "
                  f"gradient by {e_k:.3e} (kernel path) and {e_p:.3e} (plain "
                  f"path) of its max")
            if e_k <= 2 * e_p + BF16_SLACK:
                bad.remove((name, c_kernel, ratio))
        check(not bad, f"{what}: {tag} gradients unheld {bad}")
        whole = cosine(*(torch.cat([grads[side][n].flatten() for n in rows])
                         for side in ("kernel", "plain")))
        print(f"{what}: {tag} whole network cosine {whole:.6f} (floor "
              f"{whole_floor}, tensor floor {floor}, band {band[0]:.3f}-"
              f"{band[1]:.3f}; {len(grads['f32']) - len(rows)} tensors of "
              f"rounding only left out)")
        check(whole >= whole_floor, f"{what}: {tag} whole cosine {whole}")
        e_kernel, e_plain = np.mean(errs, axis=0)
        print(f"{what}: {tag} gradients off the f32 step's by "
              f"{e_kernel:.3e} (kernel path) and {e_plain:.3e} (plain path) "
              f"of each tensor's max, mean over {len(errs)} tensors")
        check(e_kernel <= 2 * e_plain + BF16_SLACK,
              f"{what}: {tag} gradients {e_kernel:.3e} vs {e_plain:.3e}")


def phase_train_bf16(train):
    """Four full-width batch-8 pose steps under --compute_dtype=bfloat16
    through the bf16 warp kernels (train_main_path's checks, 2 launches of
    each bf16 kernel a step); one step on the kernel path against the plain
    bf16 path from one state, both against the f32 step; ms per step and
    peak memory beside the f32 step's of phase_train. Returns the counts,
    and the state, batch and f32 step's snapshot for attn_bf16_step."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--compute_dtype=bfloat16", "--name=train_bf16")
    task = create_task(opt)
    check(task.vgg.conv1_1.weight.dtype == torch.bfloat16,
          "bf16: VGG19 not cast once at set-up")
    batches = [task.prepare_batch(deepfashion_batch(200 + s))
               for s in range(TRAIN_STEPS + 1)]
    state0 = copy.deepcopy(task)
    counts, times, plain_times, peak = train_main_path(
        task, opt, batches, "bf16 ", warp_fwd_bf16=2 * TRAIN_STEPS,
        warp_bwd_pos_bf16=2 * TRAIN_STEPS, warp_bwd_w1_bf16=2 * TRAIN_STEPS)
    del task
    ckpt.cleanup()

    # one step from one state: kernel vs plain bf16 path, both vs f32
    state = off_the_kinks(state0)
    del state0
    f32 = copy.deepcopy(state)
    f32.dtype = torch.float32
    f32.vgg.float()
    f32.train_step(batches[0])
    snap32 = snapshot(f32)
    del f32
    sides = []
    for path in (contextlib.nullcontext, plain_warp):
        side = copy.deepcopy(state)
        with path():
            side_logs = side.train_step(batches[0])
        sides.append((side_logs, snapshot(side)))
        del side
    loss_rel = rel_diff(sides[0][0], sides[1][0])
    print(f"bf16 kernel vs plain path, batch 8 at 256x256: losses within "
          f"{loss_rel:.3e} rel (bound {BF16_LOSS_REL:g})")
    check(loss_rel <= BF16_LOSS_REL, f"bf16 step losses {sides}")
    grads_by_rule("bf16 kernel vs plain path", sides[0][1], sides[1][1],
                  snap32)
    del sides

    ms = statistics.median(times[1:])
    print(f"bf16 train step batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(steps {', '.join(f'{t:.1f}' for t in times)}), plain bf16 path "
          f"{statistics.median(plain_times):.3f} ms, peak {peak:.2f} GiB; "
          f"f32 step {train['ms']:.3f} ms, peak {train['peak']:.2f} GiB "
          f"(phase_train)")
    return dict(counts=counts, state=state, batch=batches[0], snap32=snap32,
                peak=peak)


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


def phase_switches(serve, train, train_bf16):
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
                train_corr=counts["corr"],
                train_attn_bf16=attn_bf16_step(train_bf16),
                train_kernel_size=kernel_size_step())


def attn_bf16_step(train_bf16):
    """One full-width batch-8 pose step under --compute_dtype=bfloat16 and
    GFLA_ATTN_PALLAS=1 through the bf16 attention-math kernels (2 launches
    of each, nothing else), against that route's plain bf16 path from
    phase_train_bf16's state and batch: losses within BF16_LOSS_REL,
    gradients by BF16_STEP_HOLD and both paths against phase_train_bf16's
    f32 step by the bf16 rule (grads_by_rule; the f32 step ran the f32 warp
    kernels, the same function in f32); the kernel path's peak memory."""
    state = train_bf16.pop("state")
    batch = train_bf16.pop("batch")
    snap32 = train_bf16.pop("snap32")
    sides = []
    with switches(GFLA_ATTN_PALLAS="1"):
        for path in (contextlib.nullcontext, plain_attn_math):
            side = copy.deepcopy(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            with path():
                t0 = time.perf_counter()
                side_logs = side.train_step(batch)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t0
            sides.append((side_logs, snapshot(side), launch_counts(), step_s,
                          torch.cuda.max_memory_allocated() / 2**30))
            del side
    del state
    counts = sides[0][2]
    loss_rel = rel_diff(sides[0][0], sides[1][0])
    print(f"bf16 GFLA_ATTN_PALLAS=1 pose step, batch 8 at 256x256: launches "
          f"{counts}; losses within {loss_rel:.3e} rel of the plain bf16 "
          f"path (bound {BF16_LOSS_REL:g}); first step {sides[0][3]:.3f} s "
          f"(plain path {sides[1][3]:.3f} s); peak {sides[0][4]:.2f} GiB "
          f"(plain path {sides[1][4]:.2f} GiB; the warp route's bf16 step "
          f"{train_bf16['peak']:.2f} GiB, phase_train_bf16)")
    check(only(counts, attn_math_fwd_bf16=2, attn_math_bwd_bf16=2),
          f"bf16 GFLA_ATTN_PALLAS=1 step launches {counts}")
    check(only(sides[1][2]), f"the plain bf16 GFLA_ATTN_PALLAS=1 step "
          f"launched {sides[1][2]}")
    check(loss_rel <= BF16_LOSS_REL, f"bf16 GFLA_ATTN_PALLAS=1 step losses "
          f"{sides[0][0]} vs {sides[1][0]}")
    grads_by_rule("bf16 GFLA_ATTN_PALLAS=1 kernel vs plain path",
                  sides[0][1], sides[1][1], snap32)
    return counts


def kernel_size_step():
    """One full-width batch-8 f32 pose step at --kernel_size 2=4,3=9 (k=4
    on 64x64x128, k=9 on 32x32x256: the warp kernels' run-time instance)
    through the warp kernels (2 launches of each), against the plain path
    from one state by phase 6's rule (compare_steps)."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--kernel_size=2=4,3=9", "--name=kernel_size")
    state = create_task(opt)
    g = state.net_g
    check(g.target.attn1.kernel_size == 4 and g.target.attn0.kernel_size == 9,
          f"--kernel_size 2=4,3=9 gave {g.target.attn1.kernel_size}, "
          f"{g.target.attn0.kernel_size}")
    lrs = {"G": opt.lr, "D": opt.lr * opt.ratio_g2d}
    state = off_the_kinks(state)
    batch = state.prepare_batch(deepfashion_batch(400))
    task = copy.deepcopy(state)
    reset_launch_counts()
    t0 = time.perf_counter()
    logs = task.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = launch_counts()
    del task
    print(f"--kernel_size 2=4,3=9 pose step, batch 8 at 256x256: launches "
          f"{counts}; losses " + " ".join(f"{n} {float(v):.5f}"
                                          for n, v in logs.items())
          + f"; first step {step_s:.3f} s")
    check(only(counts, warp_fwd=2, warp_bwd_pos=2, warp_bwd_w1=2),
          f"--kernel_size 2=4,3=9 launches {counts}")
    check(all(bool(torch.isfinite(v)) for v in logs.values()),
          f"--kernel_size 2=4,3=9: losses {logs}")
    compare_steps("--kernel_size 2=4,3=9 kernel vs plain path, batch 8 at "
                  "256x256", state, batch, lrs)
    ckpt.cleanup()
    return counts


DISK_PSNR_MIN = 35.0   # dB: nvJPEG encode + decode at quality 75, each image
FIXTURE_MEAN_ABS = 0.1  # levels: nvJPEG's planes, upsampled and converted
FIXTURE_MAX_ABS = 4     # as libjpeg does, vs PIL's pixels on the committed
                        # fixture: only the inverse DCT differs (an H100:
                        # mean 0.0192, max 2, 1.62% of values differ)
PREPARED_MEAN_ABS = 0.05  # a prepared image vs its source picture, mean
                        # |diff| in [-1, 1]: JPEG at quality 75 (>= 35 dB,
                        # <= 0.03); another picture differs by ~0.2-0.4
DISK_IMAGES = 16        # images in each phase of each tree
DISK_PAIRS = {"train": 24, "test": 8}  # 3 batches of 8: 1 held out, 2 trained
DISK_STEPS = 3
DISK_BATCH = 8          # the trainer's and the server's batch
DISK_LOAD = 256         # --load_size (market's apply_defaults sets 128x64)
FIXTURE = "tests/fixtures/pil_q75_96x64"


def disk_images(n, H, W, seed):
    """`n` seeded uint8 (H, W, 3) pictures: a vertical colour gradient and
    one soft-edged ellipse (a ~4 pixel edge), smooth as photographs are."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    out = []
    for _ in range(n):
        c0, c1 = rng.uniform(40, 215, 3), rng.uniform(40, 215, 3)
        t = (yy / H)[..., None]
        img = c0 * (1 - t) + c1 * t
        cy, cx = rng.uniform(0.35, 0.65) * H, rng.uniform(0.35, 0.65) * W
        ry, rx = rng.uniform(0.2, 0.35) * H, rng.uniform(0.15, 0.3) * W
        r = np.sqrt(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2)
        a = np.clip((1.0 - r) * min(ry, rx) / 4.0, 0, 1)[..., None]
        img = img * (1 - a) + rng.uniform(40, 215, 3) * a
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def write_disk_tree(root, prefix, H, W, seed, device):
    """A DeepFashion- (prefix fasion) or Market-layout (market) tree of
    DISK_IMAGES images a phase, encoded on the card by image_io.encode_jpeg;
    keypoints in the image's own frame (a sixth missing); DISK_PAIRS
    distinct pairs. Returns {path: source array}."""
    import csv

    from gfla_tpu_torch.data.image_io import encode_jpeg

    rng = np.random.RandomState(seed)
    sources = {}
    for p, phase in enumerate(("train", "test")):
        os.makedirs(os.path.join(root, phase))
        names, rows = [], []
        for i, img in enumerate(disk_images(DISK_IMAGES, H, W, seed + p)):
            name = f"{phase}{i:02d}.jpg"
            path = os.path.join(root, phase, name)
            with open(path, "wb") as f:
                f.write(encode_jpeg(torch.from_numpy(img).to(device)))
            sources[path] = img
            kp = np.stack([rng.randint(0, H, 18), rng.randint(0, W, 18)], 1)
            kp[rng.rand(18) < 1 / 6] = -1
            names.append(name)
            rows.append([name, str(kp[:, 0].tolist()),
                         str(kp[:, 1].tolist())])
        with open(os.path.join(root, f"{prefix}-annotation-{phase}.csv"),
                  "w", newline="") as f:
            writer = csv.writer(f, delimiter=":")
            writer.writerow(["name", "keypoints_y", "keypoints_x"])
            writer.writerows(rows)
        every = [(a, b) for a in range(DISK_IMAGES) for b in range(DISK_IMAGES)
                 if a != b]
        chosen = rng.permutation(len(every))[:DISK_PAIRS[phase]]
        with open(os.path.join(root, f"{prefix}-pairs-{phase}.csv"), "w",
                  newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["from", "to"])
            writer.writerows([names[every[c][0]], names[every[c][1]]]
                             for c in chosen)
    return sources


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def host_ms(fn, iters=10, warmup=2):
    """Median milliseconds of `fn()` by the host clock, synchronised: for
    work that is partly on the host (nvJPEG's Huffman decode)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def cli_run(what):
    """Run a CLI in-process with its stdout captured: its lines are
    returned; on a failure they are printed before the error."""
    import io

    buf = io.StringIO()
    lines = []
    try:
        with contextlib.redirect_stdout(buf):
            yield lines
    except BaseException:
        print(f"{what} output:\n{buf.getvalue()[-6000:]}")
        raise
    finally:
        lines.extend(buf.getvalue().splitlines())


def pair_paths(batch):
    return list(zip(batch["P1_path"], batch["P2_path"]))


def train_from_disk(what, args, steps, task_cls=None, paths=pair_paths,
                    initial=None):
    """`python -m gfla_tpu_torch.train` in-process on a tree: returns its
    output lines, the launch counts, the task, the paths of each batch it
    prepared in order (`paths` of the host batch; (P1, P2) pairs for the
    pose task, the default `task_cls`), and each step's synchronised
    ms. A list given as `initial` receives the new task's snapshot."""
    import gfla_tpu_torch.train.__main__ as train_cli
    from gfla_tpu_torch.tasks.pose import PoseTask

    task_cls = task_cls or PoseTask
    tasks, prepared, step_ms = [], [], []
    prepare, train_step = task_cls.prepare_batch, task_cls.train_step
    create_task = train_cli.create_task

    def recording_prepare(self, batch):
        prepared.append(paths(batch))
        return prepare(self, batch)

    def timed_step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(self, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def capture(opt, device=None):
        tasks.append(create_task(opt, device))
        if initial is not None:
            initial.append(snapshot(tasks[-1]))
        return tasks[-1]

    with mock.patch.object(task_cls, "prepare_batch", recording_prepare), \
            mock.patch.object(task_cls, "train_step", timed_step), \
            mock.patch.object(train_cli, "create_task", capture), \
            cli_run(what) as lines:
        reset_launch_counts()
        check(train_cli.main(args) == 0, f"{what}: exit code")
        torch.cuda.synchronize()
        counts = launch_counts()
    check(len(step_ms) == steps, f"{what}: {len(step_ms)} steps")
    return lines, counts, tasks[0], prepared, step_ms


def serve_from_disk(what, args):
    """`python -m gfla_tpu_torch.test` in-process: output lines, counts."""
    import gfla_tpu_torch.test as test_cli

    with cli_run(what) as lines:
        reset_launch_counts()
        test_cli.main(args)
        torch.cuda.synchronize()
        counts = launch_counts()
    return lines, counts


def eval_lines(lines):
    """{iteration: {metric: value}} of the trainer's held-out lines."""
    out = {}
    for line in lines:
        if line.startswith("(epoch:") and "ssim:" in line:
            head, tail = line.split(") ", 1)
            fields = tail.split()
            out[int(head.split("iters: ")[1])] = {
                k.rstrip(":"): float(v)
                for k, v in zip(fields[::2], fields[1::2])}
    return out


def phase_disk_data(device):
    """The pose head from files: DeepFashion- and Market-layout trees
    written here through nvJPEG, decoded back, trained and served through
    the two CLIs' entry points (in-process, so the launches are counted)."""
    from gfla_tpu_torch.data import collate, get_dataset_class
    from gfla_tpu_torch.data import image_io
    from gfla_tpu_torch.data.resample import resample_images
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task
    from gfla_tpu_torch.train.evaluate import holdout_indices

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.TemporaryDirectory()
    trees = {"fashion": (os.path.join(work.name, "fashion"), "fasion",
                         256, 176),
             "market": (os.path.join(work.name, "market"), "market",
                        128, 64)}
    t0 = time.perf_counter()
    sources = {}
    for i, (root, prefix, H, W) in enumerate(trees.values()):
        sources.update(write_disk_tree(root, prefix, H, W, 70 + 10 * i,
                                       device))
    check(image_io.nvjpeg_encodes == len(sources), "encodes not on nvJPEG")

    # the round trip, and nvJPEG's pixels against PIL's
    paths = sorted(sources)
    datas = [np.fromfile(p, np.uint8) for p in paths]
    decoded = image_io.decode_jpeg_batch(datas, device, paths)
    torch.cuda.synchronize()
    psnrs = [psnr(img.cpu().numpy(), sources[p])
             for img, p in zip(decoded, paths)]
    fixture = np.fromfile(os.path.join(here, FIXTURE + ".jpg"), np.uint8)
    want = np.load(os.path.join(here, FIXTURE + ".npy")).astype(np.int16)
    got = image_io.decode_jpeg_batch([fixture], device, [FIXTURE])[0]
    diff = np.abs(got.cpu().numpy().astype(np.int16) - want)
    print(f"disk: wrote {len(sources)} JPEGs through nvJPEG in "
          f"{time.perf_counter() - t0:.2f} s; encode+decode PSNR min "
          f"{min(psnrs):.2f} dB mean {np.mean(psnrs):.2f} (bound "
          f"{DISK_PSNR_MIN:g} per image); nvJPEG vs PIL on {FIXTURE}.jpg: "
          f"mean |diff| {diff.mean():.4f} levels, max {diff.max()}, "
          f"{(diff > 0).mean() * 100:.2f}% of values differ (bounds: mean "
          f"{FIXTURE_MEAN_ABS:g}, max {FIXTURE_MAX_ABS})")
    check(min(psnrs) >= DISK_PSNR_MIN, f"round-trip PSNR {min(psnrs):.2f}")
    # the same decode queued behind ~0.1 s of work on the caller's stream,
    # as a batch is decoded while the previous training step runs
    x = torch.randn(4096, 4096, device=device)
    y = torch.empty_like(x)
    for _ in range(40):
        torch.mm(x, x, out=y)
    behind = image_io.decode_jpeg_batch(datas, device, paths)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(behind, decoded)),
          "the decode behind a busy stream differs from the decode alone")
    print(f"disk: the {len(paths)} images decoded behind ~40 queued 4096^3 "
          f"products equal the ones decoded alone")
    del x, y, behind
    try:
        image_io.decode_jpeg_batch([np.zeros(64, np.uint8)], device,
                                   ["broken.jpg"])
        refused = ""
    except ValueError as err:
        refused = str(err)
    check("nvJPEG" in refused and "broken.jpg" in refused,
          f"64 zero bytes: {refused or 'decoded'}")
    print(f"decode_jpeg_batch refuses a file that is no JPEG: {refused}")
    check(got.shape == want.shape and diff.mean() <= FIXTURE_MEAN_ABS
          and diff.max() <= FIXTURE_MAX_ABS,
          f"nvJPEG vs PIL |diff| mean {diff.mean():.4f} max {diff.max()}")

    counts = {}
    for mode, (root, prefix, H, W) in trees.items():
        name = f"disk_{mode}"
        ckpt = os.path.join(work.name, "ckpt")
        common = [f"--dataset_mode={mode}", f"--dataroot={root}",
                  "--gpu_ids=0", f"--batchSize={DISK_BATCH}",
                  f"--load_size={DISK_LOAD}", f"--checkpoints_dir={ckpt}",
                  f"--name={name}"]
        train_args = [*common, "--model=pose",
                      f"--max_iters={DISK_STEPS}", "--eval_iters_freq=2",
                      "--display_freq=2", "--print_freq=1"]
        if mode == "fashion":  # the trace, and the loader's two workers
            train_args += ["--profile_iters=1"]
        else:
            train_args += ["--nThreads=0"]
        decodes = image_io.nvjpeg_decodes
        lines, train_counts, task, prepared, step_ms = train_from_disk(
            f"{mode} train", train_args, DISK_STEPS)
        decodes = image_io.nvjpeg_decodes - decodes
        print(f"{mode} train from disk: launches {train_counts}; nvJPEG "
              f"decodes {decodes}")
        for line in lines:
            if line.startswith(("held out", "dataset [", "(epoch:",
                                "profiler trace")):
                print(f"  {line}")
        # held out: train.py's indices, evaluated, never trained on
        pairs = list(task_pairs(root, prefix))
        held = holdout_indices(len(pairs), DISK_BATCH, 0)
        check(f"held out {DISK_BATCH} samples for eval (indices "
              f"{held.tolist()})"
              in lines, f"{mode}: held-out line")
        held_pairs = [pairs[i] for i in held]
        check(prepared.count(held_pairs) == 1,
              f"{mode}: the held-out batch was prepared "
              f"{prepared.count(held_pairs)} times")
        trained = [b for b in prepared if b != held_pairs]
        check(len(trained) == DISK_STEPS and not any(
            set(b) & set(held_pairs) for b in trained),
            f"{mode}: a held-out pair reached a training batch")
        evals = eval_lines(lines)
        check(list(evals) == [2] and all(
            np.isfinite(v) for v in evals[2].values())
            and sorted(evals[2]) == ["l1", "psnr", "ssim"],
            f"{mode}: held-out evaluation {evals}")
        run = os.path.join(ckpt, name)
        images = sorted(os.listdir(os.path.join(run, "web", "images")))
        check(os.path.exists(os.path.join(run, "eval_log.txt"))
              and len(images) == 8
              and all(n.startswith("iter00000002_") for n in images)
              and os.path.exists(os.path.join(run, "web", "index.html")),
              f"{mode}: logs and visuals {images}")
        check(decodes == 2 * DISK_BATCH * (DISK_STEPS + 1),
              f"{mode}: {decodes} nvJPEG decodes")
        if mode == "fashion":
            trace = os.path.join(run, "profile", "trace_3.json")
            check(os.path.getsize(trace) > 0, "no profiler trace")
            check(task.net_d.layers == 4, "fashion: not the 4-layer D")
        else:
            check(task.net_d.layers == 3 and task.opt.load_size == (128, 64)
                  and task.opt.angle == (-5, 5), "market: not its config")
        check(only(train_counts, warp_fwd=2 * DISK_STEPS + 2 * 2,
                   warp_bwd_pos=2 * DISK_STEPS, warp_bwd_w1=2 * DISK_STEPS),
              f"{mode} train launches {train_counts}: expected 2 forward "
              f"and 2 of each backward a step, 2 forwards for the "
              f"evaluation and 2 for the visuals")
        counts[f"{'disk' if mode == 'fashion' else mode}_train"] = \
            train_counts

        # serve the test pairs from the last checkpoint
        results = os.path.join(work.name, "results")
        encodes = image_io.nvjpeg_encodes
        lines, serve_counts = serve_from_disk(
            f"{mode} serve", [*common, "--model=pose", "--which_iter=3",
                              f"--results_dir={results}", "--nThreads=0"])
        encodes = image_io.nvjpeg_encodes - encodes
        vis = sorted(n for n in os.listdir(os.path.join(results, name))
                     if n.endswith("_vis.jpg"))
        back = image_io.decode_jpeg_batch(
            [np.fromfile(os.path.join(results, name, vis[0]), np.uint8)],
            device, [vis[0]])[0]
        hw = (DISK_LOAD, DISK_LOAD) if mode == "fashion" else (128, 64)
        n_test = DISK_PAIRS["test"]
        print(f"{mode} serve from disk: launches {serve_counts}; "
              f"{len(vis)} _vis.jpg by nvJPEG ({encodes} encodes); "
              f"{vis[0]} decodes to {tuple(back.shape)}")
        check(f"wrote {n_test} results to {os.path.join(results, name)}"
              in lines and len(vis) == n_test and encodes == n_test
              and tuple(back.shape) == (*hw, 3), f"{mode}: served files")
        check(only(serve_counts, warp_fwd=2 * n_test // DISK_BATCH),
              f"{mode} serve launches {serve_counts}")
        counts[f"{'disk' if mode == 'fashion' else mode}_serve"] = \
            serve_counts

        # the host's share: decode and prepare_batch against the step
        opt = TestOptions().parse(common[:3] + ["--gpu_ids=0"], save=False)
        dataset = get_dataset_class(mode)(opt)
        batch = collate([dataset[i] for i in range(DISK_BATCH)])
        decode_ms = host_ms(lambda: image_io.decode_jpeg_batch(
            batch["P1"], device, batch["P1_path"]))  # DISK_BATCH images
        prepare_ms = host_ms(lambda: task.prepare_batch(batch))
        # each prepared image against its source array, warped the same way
        prepared = task.prepare_batch(batch)
        for key in ("P1", "P2"):
            src = torch.stack([torch.from_numpy(sources[os.path.join(
                root, "test", name)]) for name in batch[f"{key}_path"]])
            want = resample_images(
                list(src.to(device)), prepared[key].shape[2:],
                torch.from_numpy(batch[f"{key}_inv"]).to(device))
            err = (prepared[key].permute(0, 2, 3, 1) - want).abs().mean(
                dim=(1, 2, 3))
            check(err.max().item() <= PREPARED_MEAN_ABS,
                  f"{mode}: prepared {key} off its sources by "
                  f"{err.max().item():.4f} mean")
        print(f"{mode}: each prepared P1 and P2 within "
              f"{err.max().item():.4f} mean |diff| of its source picture, "
              f"warped alike (bound {PREPARED_MEAN_ABS:g})")
        step = statistics.median(step_ms[1:])
        print(f"{mode} from disk: decode {decode_ms:.3f} ms per batch of 8 "
              f"images, prepare_batch {prepare_ms:.3f} ms per batch "
              f"({2 * DISK_BATCH} decodes, warp-resize, heatmaps), train step {step:.3f} ms "
              f"(steps {', '.join(f'{t:.1f}' for t in step_ms)}): the host "
              f"pass is {prepare_ms / (prepare_ms + step) * 100:.1f}% of a "
              f"step from disk if not overlapped")
        if mode == "market":  # kernel path vs plain warp, serving
            serve_task = create_task(opt)
            serve_task.net_g.load_state_dict(task.net_g.state_dict())
            request = serve_task.prepare_batch(batch)
            img = serve_task.test_step(request)[0]
            with plain_warp():
                plain_img = serve_task.test_step(request)[0]
            diff = (img - plain_img).abs().max().item()
            print(f"market serving, kernel path vs plain path: "
                  f"max_abs_diff={diff:.3e} (bound {SLICE_ATOL:g})")
            check(diff <= SLICE_ATOL, f"market kernel vs plain {diff:.3e}")
            del serve_task
        del task
    work.cleanup()
    return counts


SHAPENET = ["--model=shapenet", "--dataset_mode=shapenet", "--load_size=256",
            "--batchSize=8", "--gpu_ids=0"]
# the smallest ShapeNet generator: its target grows from an 8x8 seed to
# 8 * 2^(layers + 2) pixels, so a 64x64 input takes one layer, attending at
# 32x32
SHAPENET_SMALL = ["--load_size=64", "--layers=1", "--attn_layer=1",
                  "--kernel_size=1=3"]
SHAPENET_B, SHAPENET_SIZE, SHAPENET_SITE = 8, 256, 64
SWEEP_VIEWS, SWEEP_BATCHES = 18, 2
# Parameters a ShapeNet step leaves as they are, in gfla_tpu as here: the
# source net's last encoder, whose 32x32 features no attention level reads
# at --attn_layer=2 (no gradient), and the scale of the instance norm over
# the target code tiled to 8x8, whose normalised input is exactly 0 (a
# gradient of exactly 0, so Adam's step is 0)
SHAPENET_STILL = ("source.encoder1.", "target.block0.model.0.weight")


def shapenet_batch(seed, B=None, size=None, views=0):
    """A batch in the ShapeNet dataset's layout: random uint8 images as the
    HDF5 store holds them, and viewpoint labels (azimuth / 10, elevation)
    drawn as gfla_tpu's bench.py draws them (bench.py:154-163). With
    `views`, a test batch: each source's sweep of `views` azimuths as
    targets, P2 (B, views, H, W, 3), BP2 (B, views, 2), and the paths."""
    B, size = B or SHAPENET_B, size or SHAPENET_SIZE
    rng = np.random.RandomState(seed)

    def images(*lead):
        return rng.randint(0, 256, (*lead, size, size, 3)).astype(np.uint8)

    def labels(n):
        return np.stack([rng.randint(0, 18, n) * 2,
                         rng.randint(0, 3, n) * 10], axis=1).astype(np.int32)

    if not views:
        return {"P1": images(B), "P2": images(B), "BP1": labels(B),
                "BP2": labels(B)}
    names = [f"car{seed}x{i}" for i in range(B)]
    azimuths = [2 * v for v in range(views)]  # range(0, 360, 20) / 10
    return {"P1": images(B), "BP1": labels(B), "P2": images(B, views),
            "BP2": np.array([[[a, 0] for a in azimuths]] * B, np.int32),
            "P1_path": [f"{n}_0_0" for n in names],
            "P2_path": [[f"{n}_{a}_0" for a in azimuths] for n in names]}


def shapenet_full_width(g):
    """The task's own defaults: ngf 64, one attention level (2) of kernel 3
    over 128 channels, the flow net's bottleneck fusing 256 + 21."""
    attn = getattr(g.target, "attn1", None)
    return (g.source.block0.model[2].out_channels == 64
            and attn is not None and attn.kernel_size == 3
            and attn.fully_connect_layer[0].in_channels == 2 * 128
            and not hasattr(g.target, "attn0")
            and g.flow_net.cat.model[0].model[2].in_channels == 256 + 21)


def check_images(what, outs, B, size, site):
    for img, flows, masks in outs:
        check(tuple(img.shape) == (B, 3, size, size)
              and img.dtype == torch.float32, f"{what}: image {img.shape}")
        check(bool(torch.isfinite(img).all()), f"{what}: non-finite image")
        check(img.min().item() >= -1 and img.max().item() <= 1,
              f"{what}: image outside [-1, 1]")
        check([tuple(f.shape) for f in flows] == [(B, 2, site, site)]
              and [tuple(m.shape) for m in masks] == [(B, 1, site, site)],
              f"{what}: flow shapes {[f.shape for f in flows]}")


def phase_shapenet_serve():
    """The full-width ShapeNet generator serves four batch-8 requests at
    256x256 through ShapeNetTask.test_step: one warp-forward launch a
    request and nothing else; shape and range; the image against the plain
    warp path, and a small generator's on the card against the CPU's;
    ms per forward of both paths."""
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    torch.cuda.empty_cache()  # start from an empty allocator cache
    task = create_task(TestOptions().parse(SHAPENET, save=False))
    g = task.net_g
    check(shapenet_full_width(g), "not the full-width shapenet config")
    print(f"shapenet generator: {sum(p.numel() for p in g.parameters())} "
          f"parameters on {task.device}")
    requests = [task.prepare_batch(shapenet_batch(seed)) for seed in range(4)]
    reset_launch_counts()
    outs = [task.test_step(batch) for batch in requests]
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"shapenet served {len(requests)} requests: launches {counts}")
    check(only(counts, warp_fwd=len(requests)),
          f"shapenet serving launched {counts}, expected 1 warp_fwd a "
          f"request and nothing else")
    check_images("shapenet serving", outs, SHAPENET_B, SHAPENET_SIZE,
                 SHAPENET_SITE)
    with plain_warp():
        plain_img = task.test_step(requests[0])[0]
    diff = (outs[0][0] - plain_img).abs().max().item()
    print(f"shapenet kernel path vs plain path: max_abs_diff={diff:.3e} "
          f"(bound {SLICE_ATOL:g})")
    check(diff <= SLICE_ATOL, f"shapenet kernel path vs plain path {diff:.3e}")

    small = create_task(TestOptions().parse(SHAPENET + SHAPENET_SMALL,
                                            save=False))
    request = small.prepare_batch(shapenet_batch(7, B=2, size=64))
    card_img = small.test_step(request)[0].cpu()
    cpu = copy.copy(small)
    cpu.net_g = copy.deepcopy(small.net_g).cpu()
    cpu_img = cpu.test_step({k: v.cpu() for k, v in request.items()})[0]
    diff_cpu = (card_img - cpu_img).abs().max().item()
    print(f"shapenet card vs CPU at 2x64x64 (layers 1): max_abs_diff="
          f"{diff_cpu:.3e} (bound {CPU_ATOL:g})")
    check(diff_cpu <= CPU_ATOL, f"shapenet card vs CPU {diff_cpu:.3e}")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with plain_warp():
        plain_ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    ms_again = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    print(f"shapenet forward batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(again {ms_again:.3f}), plain path {plain_ms:.3f} ms, peak "
          f"{peak:.0f} MiB")
    return dict(task=task, requests=requests, launches=counts["warp_fwd"],
                ms=ms)


def phase_shapenet_sweep(serve):
    """ShapeNetTask.run_test, the serving CLI's pass, over two batch-8
    test batches in the dataset's test layout: every source at all 18
    azimuths of its sweep, 288 _vis.jpg through nvJPEG, named as gfla_tpu
    names them; one warp-forward launch a view of a batch."""
    from gfla_tpu_torch.data import image_io

    task = serve["task"]
    work = tempfile.TemporaryDirectory()
    opt = copy.copy(task.opt)
    opt.results_dir, opt.name = work.name, "sweep"
    loader = [shapenet_batch(300 + i, views=SWEEP_VIEWS)
              for i in range(SWEEP_BATCHES)]
    want = sorted(f"{src}_2_{tgt}_vis.jpg" for batch in loader
                  for src, tgts in zip(batch["P1_path"], batch["P2_path"])
                  for tgt in tgts)
    encodes = image_io.nvjpeg_encodes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launch_counts()
    n = task.run_test(opt, loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    encodes = image_io.nvjpeg_encodes - encodes
    out = os.path.join(work.name, "sweep")
    names = sorted(os.listdir(out))
    back = image_io.decode_jpeg_batch(
        [np.fromfile(os.path.join(out, names[0]), np.uint8)], task.device,
        [names[0]])[0]
    views = SWEEP_VIEWS * SWEEP_BATCHES
    print(f"shapenet sweep: run_test wrote {n} _vis.jpg ({encodes} nvJPEG "
          f"encodes) for {SWEEP_BATCHES} batches of {SHAPENET_B} sources at "
          f"{SWEEP_VIEWS} azimuths in {seconds:.2f} s; launches {counts}; "
          f"{names[0]} decodes to {tuple(back.shape)}")
    check(n == len(want) == views * SHAPENET_B and names == want
          and encodes == n, f"shapenet sweep wrote {n}: {names[:3]}")
    check(tuple(back.shape) == (SHAPENET_SIZE, SHAPENET_SIZE, 3),
          f"shapenet sweep image {tuple(back.shape)}")
    check(only(counts, warp_fwd=views),
          f"shapenet sweep launched {counts}, expected {views} warp_fwd")
    work.cleanup()
    return counts["warp_fwd"]


def phase_shapenet_train():
    """Four full-width batch-8 ShapeNet D-then-G steps through the kernels
    (train_main_path: one launch of each warp kernel a step); one step on
    the kernel path against the plain path from one state, and a small
    generator's step on the card against the CPU's, both held against a
    float64 step."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--name=shapenet_train", model="shapenet",
                          dataset="shapenet")
    task = create_task(opt)
    check(shapenet_full_width(task.net_g) and task.net_d.layers == 4,
          "not the full-width shapenet config")
    lrs = {"G": opt.lr, "D": opt.lr * opt.ratio_g2d}
    batches = [task.prepare_batch(shapenet_batch(100 + s))
               for s in range(TRAIN_STEPS + 1)]
    state0 = copy.deepcopy(task)
    counts, times, plain_times, peak = train_main_path(
        task, opt, batches, "shapenet ", still_ok=SHAPENET_STILL,
        warp_fwd=TRAIN_STEPS, warp_bwd_pos=TRAIN_STEPS,
        warp_bwd_w1=TRAIN_STEPS)
    still = [n for n, p in task.net_g.named_parameters()
             if torch.equal(p, state0.net_g.get_parameter(n))]
    print(f"shapenet: left unmoved (no gradient, or exactly 0): {still}")
    del task
    ckpt.cleanup()

    state = off_the_kinks(state0)
    del state0
    compare_steps("shapenet kernel vs plain path, batch 8 at 256x256", state,
                  batches[0], lrs)
    small_opt, small_ckpt = train_opt(
        "--name=shapenet_small", *SHAPENET_SMALL, model="shapenet",
        dataset="shapenet")
    small = off_the_kinks(create_task(small_opt))
    compare_steps("shapenet card vs CPU at 2x64x64 (layers 1)", small,
                  small.prepare_batch(shapenet_batch(7, B=2, size=64)), lrs,
                  to_cpu=True)
    del small
    small_ckpt.cleanup()
    ms = statistics.median(times[1:])
    print(f"shapenet train step batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(steps {', '.join(f'{t:.1f}' for t in times)}), plain path "
          f"{statistics.median(plain_times):.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in plain_times)}), peak "
          f"{peak:.2f} GiB")
    return dict(counts=counts, state=state, batch=batches[0], ms=ms,
                peak=peak)


def phase_shapenetflow():
    """Stage 1 of the two-stage protocol: four full-width batch-8
    shapenetflow steps with GFLA_PALLAS_CORR=1, one max-correlation launch
    a step; then the shapenet task resumes that directory and loads every
    flow_net tensor, the rest at its init and the optimizers fresh."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--name=views", model="shapenetflow",
                          dataset="shapenet")
    task = create_task(opt)
    fn = task.net_g.flow_net
    check(fn.block0.model[2].out_channels == 32 and fn.encoder_layer == 5
          and fn.cat.model[0].model[2].in_channels == 256 + 21,
          "not the full-width shapenet flow net")
    print(f"shapenetflow: {sum(p.numel() for p in task.net_g.parameters())} "
          f"parameters")
    batches = [task.prepare_batch(shapenet_batch(400 + s))
               for s in range(TRAIN_STEPS)]
    s0 = snapshot(task)
    with switches(GFLA_PALLAS_CORR="1"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, logs = timed_steps(task, batches)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"shapenetflow trained {TRAIN_STEPS} steps: launches {counts}")
    check(only(counts, max_corr=TRAIN_STEPS),
          f"launches {counts}, expected 1 max_corr a step and nothing else")
    for i, step_logs in enumerate(logs):
        check(sorted(step_logs) == sorted(task.loss_names + ["total_G"])
              and all(bool(torch.isfinite(v)) for v in step_logs.values()),
              f"shapenetflow step {i + 1}: losses {step_logs}")
    print("shapenetflow losses, step 1: " + " ".join(
        f"{k} {float(v):.5f}" for k, v in logs[0].items()))
    params = dict(task.net_g.named_parameters())
    unreached = sorted(n for n, p in params.items() if p.grad is None)
    still = [n for n, p in params.items()
             if n not in unreached and torch.equal(p, s0["G"]["params"][n])]
    check(not still and all(n.startswith("flow_net.mask")
                            for n in unreached),
          f"shapenetflow: unchanged {still}, no gradient {unreached}")
    with switches(GFLA_PALLAS_CORR="0"):
        plain = copy.deepcopy(task)
        plain_times, _ = timed_steps(plain, batches[1:])
        del plain

    task.save(TRAIN_STEPS)
    stage2_opt, _ = train_opt("--name=views", "--continue_train",
                              model="shapenet", dataset="shapenet",
                              ckpt=ckpt)
    stage2 = create_task(stage2_opt)
    init = {n: t.clone() for n, t in stage2.net_g.state_dict().items()}
    check(stage2.resume(stage2_opt.which_iter) == TRAIN_STEPS,
          "stage 2 did not keep the step")
    saved, got = task.net_g.state_dict(), stage2.net_g.state_dict()
    flow_keys = [n for n in got if n.startswith("flow_net.")]
    check(sorted(flow_keys) == sorted(saved)
          and all(torch.equal(got[n], saved[n]) for n in flow_keys),
          "stage 2's flow net is not the saved one")
    check(all(torch.equal(got[n], init[n]) for n in got
              if not n.startswith("flow_net.")),
          "stage 2's source and target nets are not at their init")
    check(not stage2.opt_g.state and not stage2.opt_d.state,
          "stage 2's optimizers are not fresh")
    print(f"two-stage: shapenet --continue_train loaded the "
          f"{len(flow_keys)} flow_net tensors at step {stage2.step}; the "
          f"other {len(got) - len(flow_keys)} kept their init")
    del stage2
    ckpt.cleanup()
    print(f"shapenetflow step batch 8 at 256x256: kernel path "
          f"{statistics.median(times[1:]):.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in times)}), scan path "
          f"{statistics.median(plain_times):.3f} ms, peak {peak:.2f} GiB")
    return counts


def phase_shapenet_bf16(serve, train):
    """The ShapeNet head under --compute_dtype=bfloat16: the f32 weights
    serve the same four requests (one bf16 warp-forward launch a request
    and nothing else; the image against the plain bf16 path and the f32
    image by the bf16 rule; ms beside f32, in turns), and one training
    step on the kernel path (one launch of each bf16 warp kernel) against
    the plain bf16 path from one state by BF16_STEP_HOLD, both against the
    f32 step; ms per step beside the f32 step's."""
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    task = create_task(TestOptions().parse(
        SHAPENET + ["--compute_dtype=bfloat16"], save=False))
    f32_task, requests = serve["task"], serve["requests"]
    task.net_g.load_state_dict(f32_task.net_g.state_dict())
    reset_launch_counts()
    outs = [task.test_step(batch) for batch in requests]
    torch.cuda.synchronize()
    serve_counts = launch_counts()
    print(f"shapenet bf16 served {len(requests)} requests: launches "
          f"{serve_counts}")
    check(only(serve_counts, warp_fwd_bf16=len(requests)),
          f"shapenet bf16 serving launched {serve_counts}")
    check_images("shapenet bf16 serving", outs, SHAPENET_B, SHAPENET_SIZE,
                 SHAPENET_SITE)
    with plain_warp():
        plain_img = task.test_step(requests[0])[0]
    f32_img = f32_task.test_step(requests[0])[0]
    err, rel = bf16_rule("shapenet bf16 serving", outs[0][0], plain_img,
                         f32_img, SERVE_BF16_REL)
    times = {"f32": [], "bf16": []}
    for path in ("f32", "bf16", "bf16", "f32"):
        run = task if path == "bf16" else f32_task
        times[path].append(cuda_ms(lambda: run.test_step(requests[1]),
                                   iters=10))
    print(f"shapenet bf16 serving: kernel vs plain bf16 path "
          f"{rel:.3e} x max|f32 image| (bound {SERVE_BF16_REL:g}); forward "
          f"batch 8 at 256x256: bf16 "
          f"{', '.join(f'{t:.3f}' for t in times['bf16'])} ms, f32 "
          f"{', '.join(f'{t:.3f}' for t in times['f32'])} ms (in turns)")
    del task

    opt, ckpt = train_opt("--compute_dtype=bfloat16", "--name=shapenet_bf16",
                          model="shapenet", dataset="shapenet")
    state = off_the_kinks(create_task(opt))
    ckpt.cleanup()
    batch = state.prepare_batch(shapenet_batch(500))
    f32 = copy.deepcopy(state)
    f32.dtype = torch.float32
    f32.vgg.float()
    f32.train_step(batch)
    snap32 = snapshot(f32)
    del f32
    sides = []
    for path in (contextlib.nullcontext, plain_warp):
        side = copy.deepcopy(state)
        reset_launch_counts()
        with path():
            side_logs = side.train_step(batch)
        torch.cuda.synchronize()
        sides.append((side_logs, snapshot(side), launch_counts()))
        del side
    train_counts = sides[0][2]
    print(f"shapenet bf16 step: launches {train_counts}")
    check(only(train_counts, warp_fwd_bf16=1, warp_bwd_pos_bf16=1,
               warp_bwd_w1_bf16=1), f"shapenet bf16 step launched "
          f"{train_counts}")
    check(only(sides[1][2]), f"plain bf16 step launched {sides[1][2]}")
    loss_rel = rel_diff(sides[0][0], sides[1][0])
    print(f"shapenet bf16 kernel vs plain path, batch 8 at 256x256: losses "
          f"within {loss_rel:.3e} rel (bound {BF16_LOSS_REL:g})")
    check(loss_rel <= BF16_LOSS_REL, f"shapenet bf16 step losses {sides}")
    grads_by_rule("shapenet bf16 kernel vs plain path", sides[0][1],
                  sides[1][1], snap32, resolved=BF16_RESOLVED)
    step_times, _ = timed_steps(state, [batch] * 3)
    ms = statistics.median(step_times)
    print(f"shapenet bf16 train step batch 8 at 256x256: {ms:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in step_times)}); f32 step "
          f"{train['ms']:.3f} ms, peak {train['peak']:.2f} GiB "
          f"(phase_shapenet_train)")
    return dict(serve=serve_counts["warp_fwd_bf16"], train=train_counts)


ANIM_T = 6         # frames a chunk (--max_frames_per_gpu)
ANIM_SITES = 4     # ExtractorAttn sites a frame: 2 levels x (previous,
                   # reference)
ANIM_LAUNCHES = ANIM_SITES * ANIM_T  # each warp kernel's launches a chunk
ANIM_SIZE, ANIM_SMALL = 256, 64
ANIM_GRAD_REL = 1e-2  # kernel vs plain path, one step from one state: each
                      # network's gradient, relative L2 difference (a check
                      # for gross faults; the losses are held at
                      # TRAIN_LOSS_REL)


def anim_args(kind, *extra):
    """The CLIs' options for an animation head at full width, 256x256."""
    return [f"--model={kind}", "--dataset_mode=synthetic_video",
            f"--load_size={ANIM_SIZE}", "--gpu_ids=0",
            f"--n_frames_pre_load_test={ANIM_T}",
            f"--n_frames_total={ANIM_T}", *extra]


def anim_clips(opt, B, first=0):
    """Host batches of B clips each of the synthetic video dataset."""
    from gfla_tpu_torch.data import collate, get_dataset_class

    dataset = get_dataset_class(opt.dataset_mode)(opt)
    return [collate([dataset[(first + b * B + i) % len(dataset)]
                     for i in range(B)]) for b in range(4)]


def anim_full_width(g, kind):
    """The task's defaults: ngf 64, attention at levels 2 and 3 (k=5 over
    128 channels at 64x64, k=3 over 256 at 32x32), two streams a level."""
    t = g.target
    flow = g.flow_net if kind == "face" else g.flow_net_reference
    return (g.source_previous.block0.model[2].out_channels == 64
            and all(getattr(t, f"attn{s}{i}").kernel_size == k
                    and getattr(t, f"attn{s}{i}").fully_connect_layer[0]
                    .in_channels == 2 * c
                    for s in ("_p", "_r")
                    for i, k, c in ((0, 3, 256), (1, 5, 128)))
            and flow.output1.out_channels == (4 if kind == "face" else 2))


def check_clip(what, frames, B, T, size):
    check(tuple(frames.shape) == (B, T, 3, size, size)
          and frames.dtype == torch.float32, f"{what}: frames {frames.shape}")
    check(bool(torch.isfinite(frames).all()), f"{what}: non-finite frames")
    check(frames.min().item() >= -1 and frames.max().item() <= 1,
          f"{what}: frames outside [-1, 1]")


def stream(task, batches, path=contextlib.nullcontext):
    """test_step over prepared chunks, the carry passed along."""
    carry, frames = None, []
    with path():
        for batch in batches:
            gen, carry = task.test_step(batch, *(carry or (None, None)))
            frames.append(gen)
    return torch.cat(frames, dim=1)


def phase_anim_serve(kind):
    """The serving CLI's path of an animation head at full width: run_test
    over two consecutive 6-frame chunks of one batch-1 clip, the last frame
    and skeleton carried into the second; 24 warp-forward launches a chunk
    and nothing else; 12 _vis and 12 _gt PNGs under gfla_tpu's names; the
    frames on the kernels against the plain path; a 64x64 clip on the card
    against the CPU; ms per batch-2 chunk forward of both paths."""
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    torch.cuda.empty_cache()
    work = tempfile.TemporaryDirectory()
    opt = TestOptions().parse(anim_args(
        kind, f"--results_dir={work.name}", f"--name={kind}_serve"),
        save=False)
    task = create_task(opt)
    check(anim_full_width(task.net_g, kind), f"not the full-width {kind}")
    print(f"{kind} generator: {sum(p.numel() for p in task.net_g.parameters())}"
          f" parameters on {task.device}")
    loader = anim_clips(opt, 1)[:2]
    reset_launch_counts()
    n = task.run_test(opt, loader)
    torch.cuda.synchronize()
    counts = launch_counts()
    out = os.path.join(work.name, f"{kind}_serve", "seq")
    names = sorted(os.listdir(out))
    want = sorted(f"{os.path.splitext(p)[0]}_{s}.png" for b in loader
                  for p in b["gen_paths"][0] for s in ("vis", "gt"))
    print(f"{kind} served 2 chunks of {ANIM_T} frames (batch 1): {n} frames, "
          f"launches {counts}, {len(names)} files")
    check(only(counts, warp_fwd=2 * ANIM_LAUNCHES),
          f"{kind} serving launched {counts}, expected "
          f"{ANIM_LAUNCHES} warp_fwd a chunk and nothing else")
    check(n == 2 * ANIM_T and names == want, f"{kind} wrote {names[:4]}")
    work.cleanup()

    chunks = [task.prepare_batch(b) for b in loader]
    frames = stream(task, chunks)
    check_clip(f"{kind} serving", frames, 1, 2 * ANIM_T, ANIM_SIZE)
    plain = stream(task, chunks, plain_warp)
    diff = (frames - plain).abs().max().item()
    print(f"{kind} 12 streamed frames, kernel path vs plain path: "
          f"max_abs_diff={diff:.3e} (bound {SLICE_ATOL:g})")
    check(diff <= SLICE_ATOL, f"{kind} kernel path vs plain path {diff:.3e}")

    small_opt = TestOptions().parse(anim_args(
        kind, f"--load_size={ANIM_SMALL}", "--n_frames_pre_load_test=3"),
        save=False)
    small = [task.prepare_batch(b) for b in anim_clips(small_opt, 2)[:2]]
    card = stream(task, small).cpu()
    cpu = copy.copy(task)
    cpu.net_g = copy.deepcopy(task.net_g).cpu()
    cpu_frames = stream(cpu, [{k: v.cpu() for k, v in b.items()}
                              for b in small])
    diff_cpu = (card - cpu_frames).abs().max().item()
    print(f"{kind} card vs CPU, 2 chunks of 3 frames at 2x{ANIM_SMALL}x"
          f"{ANIM_SMALL}: "
          f"max_abs_diff={diff_cpu:.3e} (bound {CPU_ATOL:g})")
    check(diff_cpu <= CPU_ATOL, f"{kind} card vs CPU {diff_cpu:.3e}")
    del cpu

    request = task.prepare_batch(anim_clips(opt, 2)[0])
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: task.test_step(request), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with plain_warp():
        plain_ms = cuda_ms(lambda: task.test_step(request), iters=5,
                           warmup=2)
    ms_again = cuda_ms(lambda: task.test_step(request), iters=5, warmup=1)
    print(f"{kind} chunk forward batch 2 x {ANIM_T} frames at 256x256: "
          f"kernel path {ms:.3f} ms (again {ms_again:.3f}), plain path "
          f"{plain_ms:.3f} ms, peak {peak:.0f} MiB")
    return dict(task=task, launches=counts["warp_fwd"], ms=ms)


def phase_anim_train(kind):
    """Four full-width chunk steps (batch 2 x 6 frames at 256x256) through
    train_main_path (24 launches of each warp kernel a step; finite losses;
    every parameter of G, D and D_V moved; D's u; save/resume; the plain
    path's time), then one step on the kernel path against the plain path
    from one state: losses within TRAIN_LOSS_REL, each network's gradient
    within ANIM_GRAD_REL in relative L2."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt(f"--name={kind}_train", "--batchSize=2",
                          f"--n_frames_total={ANIM_T}", model=kind,
                          dataset="synthetic_video")
    task = create_task(opt)
    check(anim_full_width(task.net_g, kind) and task.net_d.layers == 4,
          f"not the full-width {kind} config")
    batches = [task.prepare_batch(b) for b in anim_clips(opt, 2)]
    batches.append(batches[0])
    state0 = copy.deepcopy(task)
    counts, times, plain_times, peak = train_main_path(
        task, opt, batches, f"{kind} ", warp_fwd=ANIM_LAUNCHES * TRAIN_STEPS,
        warp_bwd_pos=ANIM_LAUNCHES * TRAIN_STEPS,
        warp_bwd_w1=ANIM_LAUNCHES * TRAIN_STEPS)
    del task
    ckpt.cleanup()

    state = off_the_kinks(state0)
    del state0
    sides = []
    for path in (contextlib.nullcontext, plain_warp):
        side = copy.deepcopy(state)
        with path():
            logs = side.train_step(batches[0])
        sides.append((logs, snapshot(side)))
        del side
    loss_rel = rel_diff(*(logs for logs, _ in sides))
    grad_rel = {}
    for tag in sides[0][1]:
        a, b = (torch.cat([g.flatten() for g in snap[tag]["grads"].values()])
                for _, snap in sides)
        grad_rel[tag] = ((a - b).norm() / b.norm()).item()
    print(f"{kind} kernel vs plain path, one step b2 x {ANIM_T} frames at "
          f"256x256: losses within {loss_rel:.3e} rel (bound "
          f"{TRAIN_LOSS_REL:g}); gradients within "
          + ", ".join(f"{t} {r:.3e}" for t, r in grad_rel.items())
          + f" in relative L2 (bound {ANIM_GRAD_REL:g})")
    check(loss_rel <= TRAIN_LOSS_REL, f"{kind} step losses {sides[0][0]} vs "
          f"{sides[1][0]}")
    check(max(grad_rel.values()) <= ANIM_GRAD_REL,
          f"{kind} step gradients {grad_rel}")
    ms = statistics.median(times[1:])
    print(f"{kind} train step b2 x {ANIM_T} frames at 256x256: kernel path "
          f"{ms:.3f} ms (steps {', '.join(f'{t:.1f}' for t in times)}), "
          f"plain path {statistics.median(plain_times):.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in plain_times)}), peak "
          f"{peak:.2f} GiB")
    return dict(counts=counts, state=state, batch=batches[0], ms=ms,
                peak=peak)


def phase_anim_switches(train):
    """One dance step under GFLA_ATTN_PALLAS=1 (24 launches of each
    attention-math kernel, no warp) and one under GFLA_PALLAS_CORR=1 (the
    warp's 24 + 24 + 24, and 4 max-correlation launches: the previous and
    the reference stream's correctness at two layers), each against the
    default path's step from the same state."""
    state, batch = train["state"], train["batch"]
    want = copy.deepcopy(state).train_step(batch)
    opt = state.opt
    # the correctness losses are, per level, mean(exp(-cs / cmax)) - 1/e,
    # near 0 at the init: each is held relative to the size of the terms
    # that the - 1/e cancels, lambda_correct / e per level (the kernel's
    # cmax moves them by ~1e-6 of that); every other loss to its own value
    scale = {name: opt.lambda_correct * len(opt.attn_layer) / np.e
             for name in ("correctness_p", "correctness_r")}
    counts = {}
    for name, env in (("attn", dict(GFLA_ATTN_PALLAS="1")),
                      ("corr", dict(GFLA_PALLAS_CORR="1"))):
        task = copy.deepcopy(state)
        with switches(**env):
            reset_launch_counts()
            got = task.train_step(batch)
            torch.cuda.synchronize()
            counts[name] = launch_counts()
            times, _ = timed_steps(task, [batch] * 2)
        rel = {n: abs(float(got[n]) - float(w))
               / max(abs(float(w)), scale.get(n, 0.0), 1e-30)
               for n, w in want.items()}
        worst = max(rel, key=rel.get)
        del task
        print(f"{env} dance step: launches {counts[name]}; losses within "
              f"{rel[worst]:.3e} rel of the default path ({worst}; bound "
              f"{TRAIN_LOSS_REL:g}; correctness_p {rel['correctness_p']:.3e},"
              f" correctness_r {rel['correctness_r']:.3e} of "
              f"{scale['correctness_p']:.3f}); "
              f"{statistics.median(times):.3f} ms per step (steps "
              f"{', '.join(f'{t:.1f}' for t in times)})")
        check(rel[worst] <= TRAIN_LOSS_REL,
              f"{env}: losses {got} vs {want}")
    check(only(counts["attn"], attn_math_fwd=ANIM_LAUNCHES,
               attn_math_bwd=ANIM_LAUNCHES),
          f"GFLA_ATTN_PALLAS=1 dance launches {counts['attn']}")
    check(only(counts["corr"], warp_fwd=ANIM_LAUNCHES,
               warp_bwd_pos=ANIM_LAUNCHES, warp_bwd_w1=ANIM_LAUNCHES,
               max_corr=4),
          f"GFLA_PALLAS_CORR=1 dance launches {counts['corr']}")
    return dict(dance_train_attn=counts["attn"],
                dance_train_corr=counts["corr"])


VIDEO_SEQS, VIDEO_FRAMES = 3, 14   # sequences and frames a phase of a tree
FACE_FRAME = (240, 320)            # the face tree's frames: not 256x256


def face_landmarks(rng, H, W):
    """68 iBUG-ordered landmarks (x, y) of a frontal cartoon face filling
    about half of an H x W frame, jittered: the jaw, brows, nose, eyes and
    the outer and inner lips."""
    cx, cy = W * rng.uniform(0.45, 0.55), H * rng.uniform(0.5, 0.58)
    s = min(H, W) / 256.0 * rng.uniform(0.9, 1.1)
    pts = np.zeros((68, 2))
    a = np.pi - np.pi * np.arange(17) / 16.0
    pts[:17] = np.stack([cx + 70 * s * np.cos(a), cy + 93 * s * np.sin(a)], 1)
    pts[[0, 16], 1] = cy - 5 * s
    for k, sign in ((17, -1.0), (22, 1.0)):
        t = np.linspace(0, 1, 5)
        x0, x1 = cx + sign * 52 * s, cx + sign * 14 * s
        xs = x0 + (x1 - x0) * t if sign < 0 else x1 + (x0 - x1) * t
        pts[k:k + 5] = np.stack([xs, cy - (48 + 5 * np.sin(np.pi * t)) * s],
                                1)
    pts[27:31] = np.stack([np.full(4, cx), cy + (-25 + 13 * np.arange(4)) * s],
                          1)
    pts[31:36] = np.stack([cx + (-12 + 6 * np.arange(5)) * s,
                           np.full(5, cy + 20 * s)], 1)
    ang = np.array([np.pi, 2, 1, 0, -1, -2]) * np.pi / 3
    ang[0] = np.pi
    for k, ex in ((36, cx - 32 * s), (42, cx + 32 * s)):
        pts[k:k + 6] = np.stack([ex + 14 * s * np.cos(ang),
                                 cy - 22 * s - 6 * s * np.sin(ang)], 1)
    a = np.pi + 2 * np.pi * np.arange(12) / 12
    pts[48:60] = np.stack([cx + 24 * s * np.cos(a),
                           cy + 45 * s - 10 * s * np.sin(a)], 1)
    a = np.array([4, 3, 2, 1, 0, -1, -2, -3]) * np.pi / 4
    pts[60:68] = np.stack([cx + 17 * s * np.cos(a),
                           cy + 45 * s - 5 * s * np.sin(a)], 1)
    return pts + rng.uniform(-1.5, 1.5, pts.shape)


def face_frame(rng, pts, H, W):
    """uint8 (H, W, 3): a background gradient, the face's skin, eyes and
    lips as hard-edged polygons (the port's fill_poly), and noise."""
    from gfla_tpu_torch.data.raster import fill_poly

    yy = np.mgrid[:H, :W][0][..., None] / H
    img = rng.uniform(30, 220, 3) * (1 - yy) + rng.uniform(30, 220, 3) * yy
    img = img.astype(np.uint8)
    for idx, colour in ((range(17), rng.uniform(140, 230, 3)),
                        (range(36, 42), (40, 40, 60)),
                        (range(42, 48), (40, 40, 60)),
                        (range(48, 60), rng.uniform(120, 220, 3))):
        mask = np.zeros((H, W), np.uint8)
        fill_poly(mask, pts[list(idx)].astype(np.int32), 1)
        img[mask > 0] = np.asarray(colour, np.uint8)
    noise = rng.randint(-6, 7, img.shape)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def dance_joints(rng, H, W, k):
    """(k, 3) OpenPose rows (x, y, confidence) of a standing figure in an
    H x W frame, jittered; one joint in six missing (all 0) and one past
    the frame's edge."""
    y = np.linspace(0.15, 0.9, k) * H + rng.uniform(-8, 8, k)
    x = W / 2 + rng.uniform(-0.3, 0.3, k) * W
    rows = np.stack([x, y, np.ones(k)], 1)
    rows[rng.rand(k) < 1 / 6] = 0
    rows[rng.randint(k), 0] = W + rng.uniform(2, 20)
    return rows


def write_video_tree(root, kind, H, W, seed, device, seqs=VIDEO_SEQS,
                     frames=VIDEO_FRAMES):
    """A dance (iPER layout: `{phase}_256/train_A`, `train_video2d` with
    17-joint and `train_alphapose` with 18-joint skeleton JSONs) or face
    (FaceForensics layout: `{phase}_data`, `{phase}_keypoints` with
    68-point txt files) tree of H x W frames, train and test, encoded by
    image_io.encode_jpeg on `device` (nvJPEG on the card, PIL on the CPU).
    A dance frame now and then has no person. Returns {path: picture}."""
    from gfla_tpu_torch.data import openpose_utils
    from gfla_tpu_torch.data.image_io import encode_jpeg

    rng = np.random.RandomState(seed)
    sources = {}
    for phase in ("train", "test"):
        for s in range(seqs):
            seq = f"seq_{s:03d}"
            if kind == "dance":
                base = os.path.join(root, f"{phase}_256")
                dirs = [os.path.join(base, d, seq) for d in
                        ("train_A", "train_video2d", "train_alphapose")]
            else:
                dirs = [os.path.join(root, f"{phase}_{d}", seq)
                        for d in ("data", "keypoints")]
            for d in dirs:
                os.makedirs(d)
            for t in range(frames):
                name = f"frame_{t:05d}"
                if kind == "dance":
                    clean = dance_joints(rng, H, W, 17)
                    noise = dance_joints(rng, H, W, 18)
                    img = disk_images(1, H, W, seed * 1000 + s * 100 + t)[0]
                    pose = clean[:, 1::-1].T.astype(int)  # (2, 17) (y, x)
                    openpose_utils.draw_joint(
                        img, np.clip(pose, 0, [[H - 1], [W - 1]]),
                        openpose_utils.LIMB_SEQ_HUMAN36M_17, radius=4)
                    empty = rng.rand() < 0.1
                    for d, rows in ((dirs[1], clean), (dirs[2], noise)):
                        people = [] if empty else [
                            {"pose_keypoints_2d": rows.ravel().tolist()}]
                        with open(os.path.join(d, name + ".json"), "w") as f:
                            json.dump({"people": people}, f)
                else:
                    pts = face_landmarks(rng, H, W)
                    img = face_frame(rng, pts, H, W)
                    np.savetxt(os.path.join(dirs[1], name + ".txt"), pts,
                               delimiter=",", fmt="%.3f")
                path = os.path.join(dirs[0], name + ".jpg")
                with open(path, "wb") as f:
                    f.write(encode_jpeg(torch.from_numpy(img).to(device)))
                sources[path] = img
    return sources


VIDEO_STEPS = 3         # dance steps from disk: one 6-frame chunk each
FACE_FIXTURE = "tests/fixtures/face_q75_240x320"
CANNY_SHARE_MAX = 0.02  # Canny pixels nvJPEG's and PIL's decodes disagree
                        # on, of those either marks as edge, on the fixture


def video_paths(batch):
    return [list(paths) for paths in batch["gen_paths"]]


def video_serve(kind, args):
    """The serving CLI's `main` in-process over a tree's test sequences:
    its output lines, the launch counts, and each chunk's (first frame,
    whether the carry was reset) in order."""
    from gfla_tpu_torch.tasks.animation import AnimationTaskBase

    test_step = AnimationTaskBase.test_step
    chunks = []

    def recording_step(self, batch, pre_image=None, pre_skeleton=None):
        chunks.append(pre_image is None)
        return test_step(self, batch, pre_image, pre_skeleton)

    with mock.patch.object(AnimationTaskBase, "test_step", recording_step):
        lines, counts = serve_from_disk(f"{kind} serve from disk", args)
    return lines, counts, chunks


def check_streamed(kind, results, tree_root, lines, counts, resets,
                   has_cv2):
    """gfla_tpu's file names for every frame of every test sequence, one
    ref_ref each, the carry reset at each sequence's first chunk only, 24
    warp-forward launches a chunk and nothing else, and the stitch's line
    for each sequence (an mp4 where cv2 imports, else the line saying it
    was not written) after its frames."""
    frames_dir = os.path.join(tree_root, "test_256", "train_A") \
        if kind == "dance" else os.path.join(tree_root, "test_data")
    seqs = sorted(os.listdir(frames_dir))
    chunks = -(-VIDEO_FRAMES // ANIM_T)
    for seq in seqs:
        names = sorted(os.listdir(os.path.join(results, seq)))
        want = sorted([f"frame_{t:05d}_{s}.png" for t in range(VIDEO_FRAMES)
                       for s in ("vis", "gt")] + ["ref_ref.png"])
        check(names == want, f"{kind} {seq}: wrote {names[:5]}...")
    check(resets == ([True] + [False] * (chunks - 1)) * len(seqs),
          f"{kind}: carry resets {resets}")
    check(only(counts, warp_fwd=ANIM_LAUNCHES * chunks * len(seqs)),
          f"{kind} serving from disk launched {counts}")
    stitched = [line for line in lines if line.startswith(
        "write video" if has_cv2 else "write2video: no cv2 here")]
    check(len(stitched) == len(seqs) and all(
        os.path.join(results, seq) in line
        for seq, line in zip(seqs, stitched)),
        f"{kind}: the stitch printed {stitched}")
    done = [i for i, line in enumerate(lines) if line.startswith("wrote ")]
    check(done and lines.index(stitched[-1]) < done[0],
          f"{kind}: the stitch's line is not before the frame count")
    print(f"{kind} streamed {len(seqs)} test sequences of {VIDEO_FRAMES} "
          f"frames from disk ({chunks} chunks of {ANIM_T} each, padded): "
          f"launches {counts}; {len(resets)} chunks, the carry reset at "
          f"each sequence's first; {2 * VIDEO_FRAMES + 1} files a sequence; "
          f"the stitch said: {stitched[0]}")


def phase_video_disk(device, synthetic_ms):
    """dance disk, face disk: the animation heads from trees on disk,
    written here through nvJPEG (numpy skeletons and landmarks), trained
    (dance) and served (both) through the two CLIs' entry points; the
    prepared frames against their sources; the device face structure, Canny
    included, bitwise against the CPU's on the same decoded pixels; nvJPEG
    against PIL under Canny on a committed fixture; host sample, device
    prepare and step times. `synthetic_ms`: phase 18's ms per chunk step
    on the synthetic clips."""
    from gfla_tpu_torch.data import collate, get_dataset_class, image_io
    from gfla_tpu_torch.data.raster import canny_l1
    from gfla_tpu_torch.data.resample import (
        convert_l,
        pil_resize,
        resample_images,
    )
    from gfla_tpu_torch.options import TestOptions, TrainOptions
    from gfla_tpu_torch.tasks.animation import (
        CANNY_HIGH,
        CANNY_LOW,
        AnimationTaskBase,
        face_structure,
    )
    from gfla_tpu_torch.tasks.animation import prepare_batch as prepare

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.TemporaryDirectory()
    trees = {"dance": (os.path.join(work.name, "dance"), ANIM_SIZE,
                       ANIM_SIZE),
             "face": (os.path.join(work.name, "face"), *FACE_FRAME)}
    t0 = time.perf_counter()
    encodes = image_io.nvjpeg_encodes
    sources = {}
    for i, (kind, (root, H, W)) in enumerate(trees.items()):
        sources.update(write_video_tree(root, kind, H, W, 90 + i, device))
    check(image_io.nvjpeg_encodes - encodes == len(sources),
          "video frames not encoded on nvJPEG")
    print(f"video disk: wrote a dance tree ({ANIM_SIZE}x{ANIM_SIZE}) and a "
          f"face tree ({FACE_FRAME[0]}x{FACE_FRAME[1]}), {VIDEO_SEQS} "
          f"sequences x {VIDEO_FRAMES} frames a phase each, {len(sources)} "
          f"JPEGs through nvJPEG, in {time.perf_counter() - t0:.2f} s")
    ckpt = os.path.join(work.name, "ckpt")
    common = {kind: [f"--model={kind}", f"--dataset_mode={kind}",
                     f"--dataroot={root}", "--gpu_ids=0",
                     f"--load_size={ANIM_SIZE}", f"--checkpoints_dir={ckpt}",
                     f"--name={kind}_disk",
                     f"--n_frames_pre_load_test={ANIM_T}"]
              for kind, (root, _, _) in trees.items()}
    counts = {}

    # dance: three full-width batch-2 chunk steps through the training CLI
    initial = []
    lines, train_counts, task, prepared, step_ms = train_from_disk(
        "dance train from disk",
        [*common["dance"], "--batchSize=2", f"--n_frames_total={ANIM_T}",
         f"--max_iters={VIDEO_STEPS}", "--print_freq=1"], VIDEO_STEPS,
        task_cls=AnimationTaskBase, paths=video_paths, initial=initial)
    for line in lines:
        if line.startswith(("dataset [", "(epoch:")):
            print(f"  {line}")
    check(only(train_counts, warp_fwd=ANIM_LAUNCHES * VIDEO_STEPS,
               warp_bwd_pos=ANIM_LAUNCHES * VIDEO_STEPS,
               warp_bwd_w1=ANIM_LAUNCHES * VIDEO_STEPS),
          f"dance train from disk launched {train_counts}, expected "
          f"{ANIM_LAUNCHES} of each warp kernel a step")
    check(anim_full_width(task.net_g, "dance") and task.net_d.layers == 4,
          "dance from disk: not the full-width configuration")
    for tag, net in nets(task).items():
        still = [n for n, p in net.named_parameters()
                 if torch.equal(p, initial[0][tag]["params"][n])]
        check(not still, f"dance from disk {tag}: parameters unchanged: "
                         f"{still}")
    losses = [line for line in lines if line.startswith("(epoch:")]
    check(len(losses) == VIDEO_STEPS and "nan" not in " ".join(losses),
          f"dance from disk: loss lines {losses}")
    check(len(prepared) == VIDEO_STEPS and all(
        len(b) == 2 and all(len(clip) == ANIM_T for clip in b)
        for b in prepared), f"dance from disk prepared {prepared}")
    counts["dance_disk_train"] = train_counts
    print(f"dance from disk: {VIDEO_STEPS} steps, launches {train_counts}; "
          f"every parameter of G, D and D_V moved")

    # both heads: the serving CLI over the test sequences
    # (face's with cv2 hidden: the line a machine without cv2 prints)
    import importlib.util

    has_cv2 = importlib.util.find_spec("cv2") is not None
    print(f"cv2 {'imports' if has_cv2 else 'does not import'} here")
    results = os.path.join(work.name, "results")
    for kind, (root, _, _) in trees.items():
        args = [*common[kind], f"--results_dir={results}", "--nThreads=0"]
        if kind == "dance":
            args.append(f"--which_iter={VIDEO_STEPS}")
        hide = mock.patch.dict(sys.modules, {"cv2": None}) \
            if kind == "face" else contextlib.nullcontext()
        with hide:
            lines, serve_counts, resets = video_serve(kind, args)
        check_streamed(kind, os.path.join(results, f"{kind}_disk"), root,
                       lines, serve_counts, resets,
                       has_cv2 and kind == "dance")
        counts[f"{kind}_disk_serve"] = serve_counts

    # each prepared frame against its source picture (phase 11's rule),
    # and the face structure on the card against the CPU's
    for kind, (root, _, _) in trees.items():
        opt = TestOptions().parse(common[kind], save=False)
        dataset = get_dataset_class(kind)(opt)
        batch = collate([dataset[0]])
        dev = prepare(batch, device, opt)
        src = torch.stack([torch.from_numpy(sources[p])
                           for p in batch["gen_paths"][0]]).to(device)
        want = resample_images(list(src), (ANIM_SIZE, ANIM_SIZE),
                               torch.from_numpy(batch["P_all_inv"][0])
                               .to(device))
        err = (dev["P_all"][0].permute(0, 2, 3, 1) - want).abs().mean(
            dim=(1, 2, 3)).max().item()
        print(f"{kind}: each prepared frame within {err:.4f} mean |diff| "
              f"of its source picture (bound {PREPARED_MEAN_ABS:g})")
        check(err <= PREPARED_MEAN_ABS, f"{kind}: prepared frames {err:.4f}")
        if kind != "face":
            continue
        decoded = image_io.decode_jpeg_batch(batch["P_all"][0], device,
                                             batch["gen_paths"][0])
        args = [torch.from_numpy(batch[k][0]) for k in
                ("edges", "labels", "dist")]
        on_card = face_structure(*(a.to(device) for a in args), decoded,
                                 True).cpu()
        on_cpu = face_structure(*args, [d.cpu() for d in decoded], True)
        background = (on_card[..., 0] > 0).sum() - (args[0] > 0).sum()
        apart = (on_card != on_cpu).flatten(0, -2).sum(0).tolist()
        print(f"face structure {tuple(on_card.shape)} on the card vs the "
              f"CPU on the same nvJPEG pixels: values apart by channel "
              f"{apart} (bitwise: all 0); {int(background)} Canny pixels "
              f"beyond the curves")
        check(torch.equal(on_card, on_cpu) and background > 0,
              f"face structure: card and CPU differ in {apart}")
    fixture = np.fromfile(os.path.join(here, FACE_FIXTURE + ".jpg"),
                          np.uint8)
    pil = torch.from_numpy(np.load(os.path.join(here, FACE_FIXTURE +
                                                ".npy"))).to(device)
    nv = image_io.decode_jpeg_batch([fixture], device, [FACE_FIXTURE])[0]
    edges = [canny_l1(pil_resize(convert_l(img)[..., None],
                                 (ANIM_SIZE, ANIM_SIZE), "bicubic")[..., 0],
                      CANNY_LOW, CANNY_HIGH) for img in (nv, pil)]
    union = (edges[0] | edges[1]).sum().item()
    share = (edges[0] ^ edges[1]).sum().item() / max(union, 1)
    print(f"Canny on {FACE_FIXTURE}.jpg, nvJPEG's decode vs PIL's: "
          f"{share * 100:.3f}% of the {union} pixels either marks as edge "
          f"differ (bound {CANNY_SHARE_MAX * 100:g}%)")
    check(union > 0 and share <= CANNY_SHARE_MAX,
          f"Canny nvJPEG vs PIL {share:.4f}")

    # times: a worker's sample, the device prepare, the step from disk
    for kind in trees:
        opt = TrainOptions().parse(
            [*common[kind], "--batchSize=2", f"--n_frames_total={ANIM_T}"],
            save=False)
        dataset = get_dataset_class(kind)(opt)
        t0 = time.perf_counter()
        samples = [dataset[i % len(dataset)] for i in range(4)]
        sample_ms = (time.perf_counter() - t0) * 1e3 / len(samples)
        batch = collate(samples[:2])
        prepare_ms = host_ms(lambda: prepare(batch, device, opt))
        print(f"{kind} from disk: host sample {sample_ms:.1f} ms (one "
              f"{ANIM_T}-frame clip, a loader worker's __getitem__), device "
              f"prepare_batch {prepare_ms:.3f} ms per batch-2 chunk ("
              f"{2 * ANIM_T + (2 if kind == 'dance' else 0)} decodes, "
              f"warp-resize, "
              f"{'heatmaps' if kind == 'dance' else 'grey, bicubic, Canny'})")
    step = statistics.median(step_ms[1:])
    print(f"dance chunk step from disk {step:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}) beside the synthetic "
          f"clips' {synthetic_ms:.3f} ms (phase 18)")
    del task
    work.cleanup()
    return counts


def task_pairs(root, prefix):
    """The (from, to) names of a tree's training pairs, in file order."""
    import csv

    with open(os.path.join(root, f"{prefix}-pairs-train.csv")) as f:
        return [(row["from"], row["to"]) for row in csv.DictReader(f)]


def site_cases(head, cases, results, unpack, work_of, peak=TF32X3_PEAK):
    """{case: max_abs_err, ms, plain_ms, bound_ms} of the cases in `cases`
    whose name starts with `head` (a dataset's attention sites), from each
    case's result as `unpack` reads it: (err, ms, plain_ms)."""
    out = {}
    for case in cases:
        if case[0].startswith(head):
            err, ms, plain_ms = unpack(results[case[0]])
            out[case[0]] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound(*work_of(case), peak)[0]}
    return out


def both_cases(cases, results, unpack, work_of, peak=TF32X3_PEAK):
    """site_cases of market's, ShapeNet's and the animation heads' sites,
    and of the other kernel sizes at the pose k=5 site."""
    return {head: site_cases(head, cases, results, unpack, work_of, peak)
            for head in ("market", "shapenet", "animation", "kernel size")}


UNITS = {TF32X3_PEAK: "tensor cores, 3 TF32 products per f32 product: "
                      "165 TFLOP/s",
         BF16_PEAK: "tensor cores, dense bf16: 989 TFLOP/s"}


def kernel_entry(name, source, replaces, by_path, err, tolerance, ms,
                 plain_ms, work, library_ms, shape, cases=None,
                 peak=TF32X3_PEAK):
    """One entry of the `kernels` line. The f32 kernels multiply by
    split-f32 products, so their bound is taken at TF32X3_PEAK, the bf16
    instances' at BF16_PEAK; the bound on the FP32 cores stands beside it.
    `cases`: both_cases' times at market's, ShapeNet's and the animation
    heads' shapes."""
    cases = cases or {}
    bound_ms, bound_by = bound(*work, peak)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err,
            "tolerance": tolerance, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_unit": UNITS[peak],
            "bound_ms_fp32_cores": bound(*work)[0],
            "library_ms": library_ms, "ms_shape": shape,
            "market_cases": cases.get("market", {}),
            "shapenet_cases": cases.get("shapenet", {}),
            "animation_cases": cases.get("animation", {}),
            "kernel_size_cases": cases.get("kernel size", {}),
            **({"pose_k3_cases": cases["pose_k3"]}
               if "pose_k3" in cases else {})}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from gfla_tpu_torch.runtime import set_tf32

    set_tf32(False)
    with switches(GFLA_ATTN_PALLAS="auto", GFLA_PALLAS_CORR="0"):
        timed(phase_card)
        timed(phase_build)
        kernel = timed(phase_kernel, device)
        bwd = timed(phase_bwd_kernel, device)
        bf16 = timed(phase_bf16_kernels, device)
        corr = timed(phase_corr_kernel, device)
        attn, attn_inputs_kept = timed(phase_attn_kernel, device)
        attn_bf16 = timed(phase_attn_bf16_kernels, attn_inputs_kept)
        del attn_inputs_kept
        serve = timed(phase_slice, argv)
        serve_bf16 = timed(phase_serve_bf16, serve, argv)
        train = timed(phase_train)
        train_bf16 = timed(phase_train_bf16, train)
        flow = timed(phase_poseflownet)
        switched = timed(phase_switches, serve, train, train_bf16)
        disk = timed(phase_disk_data, device)
        sn_serve = timed(phase_shapenet_serve)
        sn_sweep = timed(phase_shapenet_sweep, sn_serve)
        sn_train = timed(phase_shapenet_train)
        sn_flow = timed(phase_shapenetflow)
        sn_bf16 = timed(phase_shapenet_bf16, sn_serve, sn_train)
        anim = {}
        for kind in ("dance", "face"):
            anim[f"{kind}_serve"] = timed(phase_anim_serve, kind)["launches"]
            anim_train = timed(phase_anim_train, kind)
            anim[f"{kind}_train"] = anim_train["counts"]
            if kind == "dance":
                anim_switched = timed(phase_anim_switches, anim_train)
                dance_ms = anim_train["ms"]
            del anim_train
        video = timed(phase_video_disk, device, dance_ms)
    train = train["counts"]
    shapenet = {"shapenet_serve": sn_serve["launches"],
                "shapenet_sweep": sn_sweep}
    site = KERNEL_CASES[0]
    work = warp_work(*site[1:7])
    shape = "k=5 B=8 64x64 C=128 D=128"
    _, ms, plain_ms = kernel[site[0]]
    none = None  # no single PyTorch call computes these
    entries = [kernel_entry(
        "warp_fwd", "gfla_tpu_torch/csrc/warp_fwd.cu",
        "gfla_tpu/ops/pallas_warp.py:166",
        {"serve": serve["launches"], "train": train["warp_fwd"],
         "train_corr": switched["train_corr"]["warp_fwd"],
         **{path: c["warp_fwd"] for path, c in disk.items()},
         **shapenet, "shapenet_train": sn_train["counts"]["warp_fwd"],
         "dance_serve": anim["dance_serve"],
         "face_serve": anim["face_serve"],
         **{path: anim[path]["warp_fwd"]
            for path in ("dance_train", "face_train")},
         "dance_train_corr": anim_switched["dance_train_corr"]["warp_fwd"],
         "train_kernel_size": switched["train_kernel_size"]["warp_fwd"],
         **{path: c["warp_fwd"] for path, c in video.items()}},
        max(e for e, _, _ in kernel.values()), f"{KERNEL_ATOL:g} abs", ms,
        plain_ms, work["warp_fwd"], none, shape,
        both_cases(KERNEL_CASES, kernel, lambda r: r,
                   lambda c: warp_work(*c[1:7])["warp_fwd"]))]
    for name, part in (("warp_bwd_pos", "pos"), ("warp_bwd_w1", "w1")):
        entries.append(kernel_entry(
            name, "gfla_tpu_torch/csrc/warp_bwd.cu",
            "gfla_tpu/ops/pallas_warp.py:243",
            {"train": train[name],
             "train_corr": switched["train_corr"][name],
             **{path: c[name] for path, c in disk.items()
                if path.endswith("_train")},
             "shapenet_train": sn_train["counts"][name],
             **{path: anim[path][name]
                for path in ("dance_train", "face_train")},
             "dance_train_corr": anim_switched["dance_train_corr"][name],
             "train_kernel_size": switched["train_kernel_size"][name],
             "dance_disk_train": video["dance_disk_train"][name]},
            max(r[part][0] for r in bwd.values()),
            f"{BWD_REL:g} x max|value| of each output",
            bwd[site[0]][part][1], bwd[site[0]][part][2], work[name], none,
            shape, both_cases(
                KERNEL_CASES, bwd, lambda r, part=part: r[part],
                lambda c, name=name: warp_work(*c[1:7])[name])))
    work16 = warp_work_bf16(*site[1:7])
    for name, part, source, replaces, paths in (
            ("warp_fwd_bf16", "fwd", "warp_fwd_bf16.cu", "166",
             {"serve_bf16": serve_bf16["launches"],
              "train_bf16": train_bf16["counts"]["warp_fwd_bf16"],
              "shapenet_serve_bf16": sn_bf16["serve"],
              "shapenet_train_bf16": sn_bf16["train"]["warp_fwd_bf16"]}),
            ("warp_bwd_pos_bf16", "pos", "warp_bwd_bf16.cu", "243",
             {"train_bf16": train_bf16["counts"]["warp_bwd_pos_bf16"],
              "shapenet_train_bf16": sn_bf16["train"]["warp_bwd_pos_bf16"]}),
            ("warp_bwd_w1_bf16", "w1", "warp_bwd_bf16.cu", "243",
             {"train_bf16": train_bf16["counts"]["warp_bwd_w1_bf16"],
              "shapenet_train_bf16": sn_bf16["train"]["warp_bwd_w1_bf16"]})):
        kern = name.removesuffix("_bf16")
        entries.append(kernel_entry(
            name, f"gfla_tpu_torch/csrc/{source}",
            f"gfla_tpu/ops/pallas_warp.py:{replaces}", paths,
            max(r[part][0] for r in bf16.values()),
            f"{BF16_OUT_REL:g} (out, hpre, d_source), {BF16_GRAD_REL:g} "
            f"(other gradients) x max|f32 value| against the bf16 plain twin",
            bf16[site[0]][part][1], bf16[site[0]][part][2], work16[kern],
            none, shape, both_cases(
                KERNEL_CASES, bf16, lambda r, part=part: r[part],
                lambda c, kern=kern: warp_work_bf16(*c[1:7])[kern],
                BF16_PEAK), peak=BF16_PEAK))
    c = corr[CORR_CASES[0][0]]
    entries.append(kernel_entry(
        "max_corr", "gfla_tpu_torch/csrc/max_corr.cu",
        "gfla_tpu/ops/pallas_corr.py:36",
        {"poseflownet": flow["max_corr"],
         "train_corr": switched["train_corr"]["max_corr"],
         "shapenetflow": sn_flow["max_corr"],
         "dance_train_corr": anim_switched["dance_train_corr"]["max_corr"]},
        max(r["err"] for r in corr.values()), f"{CORR_ATOL:g} abs (cmax)",
        c["ms"], c["plain_ms"], c["work"], c["library_ms"],
        "B=8 Ns=Nt=4096 C=256",
        {"market": site_cases(
            "market", CORR_CASES, corr,
            lambda r: (r["err"], r["ms"], r["plain_ms"]),
            lambda c: corr_work(*c[1:5])),
         # ShapeNet's correctness loss reads relu3_1 at 256x256, the shape
         # of the first case
         "shapenet": {CORR_CASES[0][0]: dict(
             max_abs_err=c["err"], ms=c["ms"], plain_ms=c["plain_ms"],
             bound_ms=bound(*c["work"], TF32X3_PEAK)[0])},
         # the animation heads' loss reads both layers over B * T = 12
         # frames
         "animation": site_cases(
             "animation", CORR_CASES, corr,
             lambda r: (r["err"], r["ms"], r["plain_ms"]),
             lambda c: corr_work(*c[1:5]))}))
    a = attn[ATTN_CASES[0][0]]
    for name, part, paths in (
            ("attn_math_fwd", "fwd", ("serve_attn", "train_attn")),
            ("attn_math_bwd", "bwd", ("train_attn",))):
        entries.append(kernel_entry(
            name, f"gfla_tpu_torch/csrc/{name}.cu",
            "gfla_tpu/ops/pallas_attn.py:"
            + ("64" if part == "fwd" else "155"),
            {**{path: switched[path][name] for path in paths},
             "dance_train_attn": anim_switched["dance_train_attn"][name]},
            max(r[part]["err"] for r in attn.values()),
            f"{BWD_REL:g} x max|value| of each output", a[part]["ms"],
            a[part]["plain_ms"], a[part]["work"], none,
            "N=32768 k=5 C=128 D=128",
            {head: site_cases(
                head, ATTN_CASES, attn,
                lambda r, part=part: (r[part]["err"], r[part]["ms"],
                                      r[part]["plain_ms"]),
                lambda c, part=part: attn_work(*c[1:5])[
                    0 if part == "fwd" else 1])
             for head in ("shapenet", "animation")}))
    a = attn_bf16[ATTN_BF16_CASES[0][0]]
    for name, part, paths in (
            ("attn_math_fwd_bf16", "fwd",
             {"serve_bf16_attn": serve_bf16["attn_launches"],
              "train_bf16_attn":
                  switched["train_attn_bf16"]["attn_math_fwd_bf16"]}),
            ("attn_math_bwd_bf16", "bwd",
             {"train_bf16_attn":
                  switched["train_attn_bf16"]["attn_math_bwd_bf16"]})):
        entries.append(kernel_entry(
            name, f"gfla_tpu_torch/csrc/{name}.cu",
            "gfla_tpu/ops/pallas_attn.py:"
            + ("64" if part == "fwd" else "155"), paths,
            max(r[part]["err"] for r in attn_bf16.values()),
            f"{BF16_OUT_REL:g} (out, d_bs), {BF16_GRAD_REL:g} (other "
            f"gradients) x max|f32 value| against the bf16 plain twin",
            a[part]["ms"], a[part]["plain_ms"], a[part]["work"], none,
            "N=32768 k=5 C=128 D=128",
            {"pose_k3": site_cases(
                "k=3", ATTN_BF16_CASES, attn_bf16,
                lambda r, part=part: (r[part]["err"], r[part]["ms"],
                                      r[part]["plain_ms"]),
                lambda c, part=part: attn_work_bf16(*c[1:5])[
                    0 if part == "fwd" else 1], BF16_PEAK),
             "shapenet": site_cases(
                "shapenet", ATTN_BF16_CASES, attn_bf16,
                lambda r, part=part: (r[part]["err"], r[part]["ms"],
                                      r[part]["plain_ms"]),
                lambda c, part=part: attn_work_bf16(*c[1:5])[
                    0 if part == "fwd" else 1], BF16_PEAK)},
            peak=BF16_PEAK))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
