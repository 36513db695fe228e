"""Card times of the warp's three kernels at chosen kernel sizes, and of the
bf16 attention math's dW1 product.

    python3 gfla_tpu_torch/tools/kernel_times.py [--root DIR] [--ks 1,3,5,7]
        [--iters N] [--dw1]

Imports gfla_tpu_torch from `--root` (default: the checkout this file lies
in), so that two trees, say a commit and its parent unpacked with `git
archive`, can be timed on one card in one command, each in its own
process; run them in the order parent, change, change, parent and compare
only within one call. For each k of `--ks` at the pose k=5 site's shape
(B=8, 64x64, C=128, D=128, flows of scale 1.5), and for k=3 at the pose
k=3 site (B=8, 32x32, C=256), it times the warp's forward kernel, its
per-position backward kernel (from the forward's hpre) and its dW1s kernel,
in f32 and in bf16, through the wrappers: the median of `--iters` launches
by CUDA events after 3 warm-up launches. With `--dw1` it also times
`attn_math_dw1` (the dW1 product outside the attention-math backward
kernel) in bf16 at the pose sites, the device memory it allocates beyond
its inputs and its output, and, beside it, one `torch.mm` of the bf16
operands with an f32 result where the installed PyTorch has one (a
comparison only; the port does not call it). Needs one CUDA card. Prints
the card line and one JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
K5_SITE = (8, 64, 64, 128, 128)  # B, H, W, C, D
K3_SITE = (8, 32, 32, 256, 128)


def cuda_ms(torch, fn, iters):
    for _ in range(3):
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


def warp_times(torch, k, site, dtype, iters):
    """ms of the forward (storing hpre), per-position and dW1s kernels."""
    from gfla_tpu_torch.ops import warp
    from gfla_tpu_torch.ops.local_attn import target_stream

    B, H, W, C, D = site
    rng = np.random.RandomState(k)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).cuda().to(dt)

    src, tgt = t(rng.randn(B, H, W, C), dtype), t(rng.randn(B, H, W, C))
    flow = t(rng.randn(B, H, W, 2) * 1.5)
    w1 = t(rng.randn(k * k, 2 * C, D) * 0.05)
    b1, w2 = t(rng.randn(D) * 0.1), t(rng.randn(D, k * k) * 0.1, dtype)
    b2 = t(rng.randn(k * k) * 0.1)
    hidden_bt = target_stream(tgt, w1, b1, k)
    w1s = w1[:, C:, :].reshape(k * k * C, D).to(dtype).contiguous()
    g = t(rng.randn(B, H, W, C), dtype)
    args = (src, flow, hidden_bt, w1s, w2, b2)
    out, hpre = warp.warp_fwd_with_hpre(*args, k)
    d_hpre = t(rng.randn(B, H * W, D) * 1e-3)
    ms = {
        "fwd": cuda_ms(torch, lambda: warp.warp_fwd_with_hpre(*args, k),
                       iters),
        "pos": cuda_ms(torch, lambda: warp.warp_bwd_pos(
            src, flow, hpre, w1s, w2, b2, g, k), iters),
        "w1": cuda_ms(torch, lambda: warp.warp_bwd_w1(src, flow, d_hpre, k),
                      iters),
    }
    finite = bool(torch.isfinite(out).all()) and bool(
        torch.isfinite(hpre).all())
    return ms, finite


def dw1_times(torch, site_k, iters):
    """attn_math_dw1 in bf16: ms, the memory it allocates beyond its inputs
    and output, and a bf16 torch.mm with an f32 result beside it."""
    from gfla_tpu_torch.ops import attn_math

    (B, H, W, C, D), k = site_k
    N, k2 = B * H * W, k * k
    rng = np.random.RandomState(7)
    bf = torch.bfloat16

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda(
            ).to(bf)

    bs, bt, d_hpre = t(N, k2, C), t(N, k2, C), t(N, D)
    res = {"N": N, "k": k, "C": C, "D": D}
    want = attn_math.attn_math_dw1(bs, bt, d_hpre)
    res["ms"] = cuda_ms(torch, lambda: attn_math.attn_math_dw1(
        bs, bt, d_hpre), iters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = attn_math.attn_math_dw1(bs, bt, d_hpre)
    torch.cuda.synchronize()
    res["temp_MB"] = (torch.cuda.max_memory_allocated() - base
                      - out.numel() * out.element_size()) / 1e6
    del out

    def mm32():
        a = torch.mm(bt.reshape(N, k2 * C).t(), d_hpre,
                     out_dtype=torch.float32).reshape(k2, C, D)
        b = torch.mm(bs.reshape(N, k2 * C).t(), d_hpre,
                     out_dtype=torch.float32).reshape(k2, C, D)
        return torch.cat([a, b], dim=1)

    try:
        got = mm32()
    except (TypeError, RuntimeError) as exc:
        res["mm_out_f32"] = f"not available: {type(exc).__name__}"
        return res
    res["mm_out_f32_ms"] = cuda_ms(torch, mm32, iters)
    res["mm_out_f32_max_rel_diff"] = (
        (got - want).abs().max() / want.abs().max()).item()
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(ROOT))
    parser.add_argument("--ks", default="1,3,5,7")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--dw1", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import gfla_tpu_torch
    from gfla_tpu_torch.runtime import card_line, set_tf32

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    set_tf32(False)
    print(card_line())
    print(json.dumps({"root": args.root,
                      "package": str(Path(gfla_tpu_torch.__file__).parent)}))
    cases = [(int(k), K5_SITE) for k in args.ks.split(",")] + [(3, K3_SITE)]
    for k, site in cases:
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            ms, finite = warp_times(torch, k, site, dtype, args.iters)
            print(json.dumps({"kernel": "warp", "k": k, "site": site,
                              "dtype": name, "ms": ms, "finite": finite}))
            if not finite:
                return 1
    if args.dw1:
        for site_k in ((K5_SITE, 5), (K3_SITE, 3)):
            print(json.dumps({"kernel": "attn_math_dw1", "dtype": "bf16",
                              **dw1_times(torch, site_k, args.iters)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
