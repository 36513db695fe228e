"""Where the time of the tensor-core kernels goes, by timing variants.

    python3 -m gfla_tpu_torch.tools.kernel_split [--iters N]

The card's counters cannot be read from every machine, so this splits a
kernel's time by building it several times with `-DGFLA_SPLIT=<n>`: each
value leaves one part of the kernel out (csrc/warp_fwd.cu, csrc/warp_bwd.cu
and csrc/max_corr.cu say which), and the time that goes missing is that
part's share. Every variant is compiled from the source in the package by its own
nvcc process into its own library under build/, launched at the shapes of
the main paths and timed by CUDA events; the variants' outputs are wrong by
design and are not checked. Needs one CUDA card and nvcc. Prints one table
per kernel and site, and the same as one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys

import torch

from gfla_tpu_torch.ops._build import (BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc,
                                       _run_all)
from gfla_tpu_torch.runtime import card_line

WARP_VARIANTS = {0: "whole kernel", 1: "without the product",
                 2: "without the gather of the product's operand",
                 3: "without the weighted sum of the output"}
CORR_VARIANTS = {0: "whole kernel", 1: "tile copies and splits, no product",
                 2: "product without the (max, argmax) fold"}
BWD_VARIANTS = {0: "whole kernel", 1: "without the product",
                2: "without the footprint cells (dots, loads, copies, blend)",
                3: "without the reductions into d_source"}
WARP_SITES = [("k=5 B=8 64x64 C=128 D=128", 8, 64, 64, 128, 128, 5),
              ("k=3 B=8 32x32 C=256 D=128", 8, 32, 32, 256, 128, 3)]
CORR_SITES = [("relu3_1 B=8 4096x4096 C=256", 8, 4096, 4096, 256),
              ("relu4_1 B=8 1024x1024 C=512", 8, 1024, 1024, 512)]


def build_variants():
    """One library per (source, GFLA_SPLIT value), all compiled at once."""
    out_dir = BUILD_DIR / "kernel_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = [(stem, n) for stem, variants in (("warp_fwd", WARP_VARIANTS),
                                             ("warp_bwd", BWD_VARIANTS),
                                             ("max_corr", CORR_VARIANTS))
            for n in variants]
    paths = {job: out_dir / f"{job[0]}_{job[1]}.so" for job in jobs}
    _run_all([[nvcc, *NVCC_FLAGS, f"-DGFLA_SPLIT={n}", "-shared", "-o",
               str(paths[stem, n]), str(CSRC / f"{stem}.cu")]
              for stem, n in jobs])
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for (stem, n), path in paths.items():
        lib = ctypes.CDLL(str(path))
        if stem == "warp_fwd":
            lib.gfla_warp_fwd.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float,
                                                              p]
        elif stem == "warp_bwd":
            lib.gfla_warp_bwd_pos.argtypes = [p] * 12 + [i] * 6 + [
                ctypes.c_float, p]
            lib.gfla_warp_bwd_w1.argtypes = [p] * 5 + [i] * 6 + [p]
            for fn in (lib.gfla_warp_bwd_pos_scratch,
                       lib.gfla_warp_bwd_w1_scratch):
                fn.argtypes = [i] * 4
                fn.restype = ctypes.c_longlong
        else:
            lib.gfla_max_corr_splits.argtypes = [i, i, i]
            lib.gfla_max_corr.argtypes = [p] * 6 + [i] * 5 + [p]
        libs[stem, n] = lib
    return libs


def cuda_ms(fn, iters):
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


def must(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def time_warp(libs, iters):
    rows = []
    dev = torch.device("cuda", 0)
    for name, B, H, W, C, D, k in WARP_SITES:
        g = torch.Generator(device=dev).manual_seed(0)

        def rand(*shape, scale=1.0):
            return torch.randn(*shape, device=dev, generator=g) * scale

        src, flow = rand(B, H, W, C), rand(B, H, W, 2, scale=1.5)
        hbt, w1s = rand(B * H * W, D), rand(k * k * C, D, scale=0.05)
        w2, b2 = rand(D, k * k, scale=0.1), rand(k * k, scale=0.1)
        out = torch.empty_like(src)
        stream = torch.cuda.current_stream().cuda_stream
        for n, label in WARP_VARIANTS.items():
            lib = libs["warp_fwd", n]

            def launch():
                must(lib.gfla_warp_fwd(
                    src.data_ptr(), flow.data_ptr(), hbt.data_ptr(),
                    w1s.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                    out.data_ptr(), None, B, H, W, C, D, k, 0.1, stream),
                    f"warp_fwd variant {n}")

            rows.append(dict(kernel="warp_fwd", site=name, variant=n,
                             what=label, ms=cuda_ms(launch, iters)))
    return rows


def time_bwd(libs, iters):
    """Both backward kernels of csrc/warp_bwd.cu, from a random hpre and
    d_hpre, at the two warp sites."""
    rows = []
    dev = torch.device("cuda", 0)
    for name, B, H, W, C, D, k in WARP_SITES:
        g = torch.Generator(device=dev).manual_seed(2)

        def rand(*shape, scale=1.0):
            return torch.randn(*shape, device=dev, generator=g) * scale

        N = B * H * W
        src, flow = rand(B, H, W, C), rand(B, H, W, 2, scale=1.5)
        hpre, w1s = rand(N, D), rand(k * k * C, D, scale=0.05)
        w2, b2 = rand(D, k * k, scale=0.1), rand(k * k, scale=0.1)
        cot, d_hpre = rand(B, H, W, C), rand(N, D)
        d_src, d_flow = torch.zeros_like(src), torch.empty_like(flow)
        d_hbt, dw2b2 = torch.empty_like(hpre), torch.empty(D * k * k + k * k,
                                                          device=dev)
        dw1s = torch.empty_like(w1s)
        stream = torch.cuda.current_stream().cuda_stream
        launches = {"warp_bwd_pos": {}, "warp_bwd_w1": {}}
        for n in BWD_VARIANTS:
            lib = libs["warp_bwd", n]
            pos_part = torch.empty(lib.gfla_warp_bwd_pos_scratch(N, C, D, k),
                                   device=dev)
            w1_part = torch.empty(lib.gfla_warp_bwd_w1_scratch(N, C, D, k),
                                  device=dev)

            def pos(lib=lib, part=pos_part, n=n):
                must(lib.gfla_warp_bwd_pos(
                    src.data_ptr(), flow.data_ptr(), hpre.data_ptr(),
                    w1s.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                    cot.data_ptr(), d_src.data_ptr(), d_flow.data_ptr(),
                    d_hbt.data_ptr(), part.data_ptr(), dw2b2.data_ptr(),
                    B, H, W, C, D, k, 0.1, stream),
                    f"warp_bwd_pos variant {n}")

            def w1(lib=lib, part=w1_part, n=n):
                must(lib.gfla_warp_bwd_w1(
                    src.data_ptr(), flow.data_ptr(), d_hpre.data_ptr(),
                    part.data_ptr(), dw1s.data_ptr(), B, H, W, C, D, k,
                    stream), f"warp_bwd_w1 variant {n}")

            launches["warp_bwd_pos"][n] = pos
            launches["warp_bwd_w1"][n] = w1
        for kernel, by_variant in launches.items():
            for n, fn in by_variant.items():
                rows.append(dict(kernel=kernel, site=name, variant=n,
                                 what=BWD_VARIANTS[n], ms=cuda_ms(fn, iters)))
    return rows


def time_corr(libs, iters):
    rows = []
    dev = torch.device("cuda", 0)
    for name, B, Ns, Nt, C in CORR_SITES:
        g = torch.Generator(device=dev).manual_seed(1)
        s = torch.nn.functional.normalize(
            torch.randn(B, Ns, C, device=dev, generator=g).relu(), dim=-1)
        t = torch.nn.functional.normalize(
            torch.randn(B, Nt, C, device=dev, generator=g).relu(), dim=-1)
        cmax = torch.empty(B, Nt, device=dev)
        amax = torch.empty(B, Nt, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for n, label in CORR_VARIANTS.items():
            lib = libs["max_corr", n]
            splits = lib.gfla_max_corr_splits(B, Ns, Nt)
            part_v = torch.empty(splits * B * Nt, device=dev)
            part_i = torch.empty(splits * B * Nt, dtype=torch.int32,
                                 device=dev)

            def launch():
                must(lib.gfla_max_corr(
                    s.data_ptr(), t.data_ptr(), part_v.data_ptr(),
                    part_i.data_ptr(), cmax.data_ptr(), amax.data_ptr(), B,
                    Ns, Nt, C, splits, stream), f"max_corr variant {n}")

            rows.append(dict(kernel="max_corr", site=name, variant=n,
                             what=label, ms=cuda_ms(launch, iters)))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_split: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    libs = build_variants()
    rows = (time_warp(libs, args.iters) + time_bwd(libs, args.iters)
            + time_corr(libs, args.iters))
    torch.cuda.synchronize()
    whole = {}
    for row in rows:
        key = (row["kernel"], row["site"])
        if row["variant"] == 0:
            whole[key] = row["ms"]
            print(f"{row['kernel']} at {row['site']}")
        print(f"  {row['what']:<48} {row['ms']:8.4f} ms  "
              f"({whole[key] - row['ms']:+.4f} ms missing)")
    print(json.dumps({"kernel_split": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
