"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py [test options...]

Phases, each failing the run (non-zero exit) on the first error:
  1. card: CUDA must be present; prints nvidia-smi's name and power limit.
  2. build: compiles the CUDA kernels from gfla_tpu_torch/csrc with nvcc.
  3. kernel: the warp kernel against its plain torch version at both live
     attention sites of the DeepFashion generator and with far-off flows;
     max errors and median times of both.
  4. slice: the full-width pose generator (ngf 64, img_f 512, attention at
     levels 2/3 with kernels 5/3) serves four batch-8 requests of 256x176
     content in 256x256 tensors through PoseTask.test_step; checks shape,
     range, the kernel launch count, the plain-warp path and a CPU run on a
     small input; median ms per forward of both paths.
Extra arguments go to the test options, e.g. `--checkpoints_dir DIR --name N
--which_iter latest` to serve an original-GFLA `latest_net_G.pth` instead of
the seeded random init. The last line is the JSON device record.
"""

from __future__ import annotations

import copy
import json
import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch

KERNEL_ATOL = 1e-4  # f32, TF32 off: only the summation order differs
SLICE_ATOL = 1e-3   # the same, carried through ~20 conv/norm layers
CPU_ATOL = 1e-3     # card vs CPU on a small input: cuDNN vs CPU convs
FLOW_FAR = 2.5      # far-off flows reach +-2.5 H


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

    cases = [  # name, B, H, W, C, D, k, flow scale (None: far-off)
        ("k=5 site 64x64 C128", 8, 64, 64, 128, 128, 5, 1.5),
        ("k=3 site 32x32 C256", 8, 32, 32, 256, 128, 3, 1.5),
        ("k=5 far-off flows", 8, 64, 64, 128, 128, 5, None),
    ]
    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(cases):
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
        "requires_grad": (NotImplementedError, lambda: warp.warp_fwd(
            args[0].requires_grad_(), *args[1:], 3)),
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
    from gfla_tpu_torch.ops import warp
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
    warp.launches = 0
    outs = [task.test_step(batch) for batch in requests]
    torch.cuda.synchronize()
    launches = warp.launches
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

    with mock.patch.object(warp, "warp_fwd", warp.warp_fwd_plain):
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
    with mock.patch.object(warp, "warp_fwd", warp.warp_fwd_plain):
        plain_ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    ms_again = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    print(f"forward batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(again {ms_again:.3f}), plain path {plain_ms:.3f} ms, "
          f"peak {peak:.0f} MiB")
    return launches


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
    launches = phase_slice(argv)
    err = max(e for e, _, _ in kernel.values())
    _, ms, plain_ms = kernel["k=5 site 64x64 C128"]
    print(json.dumps({"kernels": [{
        "name": "warp_fwd", "route": "cuda",
        "source": "gfla_tpu_torch/csrc/warp_fwd.cu",
        "replaces": "gfla_tpu/ops/pallas_warp.py:166",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "ms_shape": "k=5 B=8 64x64 C=128 D=128"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
