"""Where the time of the tensor-core kernels goes, by timing variants.

    python3 -m gfla_tpu_torch.tools.kernel_split [--iters N] [--only SRC,..]
        [--compute_dtype bfloat16]

The card's counters cannot be read from every machine, so this splits a
kernel's time by building it several times with `-DGFLA_SPLIT=<n>`: each
value leaves one part of the kernel out (each source under csrc/ says
which), and the time that goes missing is that part's share. `--only`
takes some of the sources: warp_fwd, warp_bwd, max_corr, attn_math_fwd,
attn_math_bwd. With `--compute_dtype bfloat16`, warp_fwd and warp_bwd are
their bf16 instances (warp_fwd_bf16.cu, warp_bwd_bf16.cu), fed bf16 values;
the other sources have none. The attention-math kernels are two or three launches
behind one entry point; the whole of each is also traced once with
torch.profiler, which gives each kernel's own time. Every variant is compiled from the source in the package by its own
nvcc process into its own library under build/, launched at the shapes of
the main paths and timed by CUDA events; the variants' outputs are wrong by
design and are not checked. Needs one CUDA card and nvcc. Prints one table
per kernel and site, and the same as one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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
ATTN_FWD_VARIANTS = {0: "whole kernel", 1: "without the product",
                     2: "without the tile copies and splits",
                     3: "without the weighted sum of the output"}
ATTN_BWD_VARIANTS = {0: "whole kernel", 1: "without the product",
                     2: "without the tile copies and splits",
                     3: "without the product's epilogue (+ attn g, stores)",
                     4: "without the d_attn read of the blocks"}
SOURCES = {"warp_fwd": WARP_VARIANTS, "warp_bwd": BWD_VARIANTS,
           "max_corr": CORR_VARIANTS, "attn_math_fwd": ATTN_FWD_VARIANTS,
           "attn_math_bwd": ATTN_BWD_VARIANTS}
ATTN_SITES = [("k=5 N=32768 C=128 D=128", 8 * 64 * 64, 5, 128, 128),
              ("k=3 N=8192 C=256 D=128", 8 * 32 * 32, 3, 256, 128)]
WARP_SITES = [("k=5 B=8 64x64 C=128 D=128", 8, 64, 64, 128, 128, 5),
              ("k=3 B=8 32x32 C=256 D=128", 8, 32, 32, 256, 128, 3)]
CORR_SITES = [("relu3_1 B=8 4096x4096 C=256", 8, 4096, 4096, 256),
              ("relu4_1 B=8 1024x1024 C=512", 8, 1024, 1024, 512)]


BF16_SOURCES = ("warp_fwd", "warp_bwd")  # sources with bf16 instances


def build_variants(stems, suffix=""):
    """One library per (source, GFLA_SPLIT value), all compiled at once;
    with suffix "_bf16", warp_fwd and warp_bwd are their bf16 instances."""
    out_dir = BUILD_DIR / "kernel_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = [(stem, n) for stem in stems for n in SOURCES[stem]]
    files = {stem: stem + (suffix if stem in BF16_SOURCES else "")
             for stem in stems}
    paths = {job: out_dir / f"{files[job[0]]}_{job[1]}.so" for job in jobs}
    _run_all([[nvcc, *NVCC_FLAGS, f"-DGFLA_SPLIT={n}", "-shared", "-o",
               str(paths[stem, n]), str(CSRC / f"{files[stem]}.cu")]
              for stem, n in jobs])
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for (stem, n), path in paths.items():
        lib = ctypes.CDLL(str(path))
        if stem == "warp_fwd":
            lib.warp_fwd = getattr(lib, f"gfla_warp_fwd{suffix}")
            lib.warp_fwd.argtypes = [p] * 9 + [i] * 6 + [ctypes.c_float, p]
        elif stem == "warp_bwd":
            lib.warp_bwd_pos = getattr(lib, f"gfla_warp_bwd_pos{suffix}")
            lib.warp_bwd_pos.argtypes = [p] * 12 + [i] * 6 + [
                ctypes.c_float, p]
            lib.warp_bwd_w1 = getattr(lib, f"gfla_warp_bwd_w1{suffix}")
            lib.warp_bwd_w1.argtypes = [p] * 5 + [i] * 6 + [p]
            lib.pos_scratch = getattr(lib,
                                      f"gfla_warp_bwd_pos_scratch{suffix}")
            lib.w1_scratch = getattr(lib, f"gfla_warp_bwd_w1_scratch{suffix}")
            for fn in (lib.pos_scratch, lib.w1_scratch):
                fn.argtypes = [i] * 4
                fn.restype = ctypes.c_longlong
        elif stem == "max_corr":
            lib.gfla_max_corr_splits.argtypes = [i, i, i]
            lib.gfla_max_corr.argtypes = [p] * 6 + [i] * 5 + [p]
        elif stem == "attn_math_fwd":
            lib.gfla_attn_math_fwd.argtypes = [p] * 9 + [i] * 4 + [
                ctypes.c_float, p]
            lib.gfla_attn_math_fwd_scratch.argtypes = [i] * 4
            lib.gfla_attn_math_fwd_scratch.restype = ctypes.c_longlong
        else:
            lib.gfla_attn_math_bwd.argtypes = [p] * 11 + [i] * 4 + [
                ctypes.c_float, p]
            lib.gfla_attn_math_bwd_scratch.argtypes = [i, i, i]
            lib.gfla_attn_math_bwd_scratch.restype = ctypes.c_longlong
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


def _values(bf16):
    """For the bf16 instances: (the source, W2 and g in bf16, W1s and d_hpre
    as bf16 values held in f32), as the wrappers hand them over."""
    if not bf16:
        return (lambda t: t), (lambda t: t)
    return (lambda t: t.bfloat16()), (lambda t: t.bfloat16().float())


def time_warp(libs, iters, bf16=False):
    rows = []
    dev = torch.device("cuda", 0)
    cast, wide = _values(bf16)
    for name, B, H, W, C, D, k in WARP_SITES:
        g = torch.Generator(device=dev).manual_seed(0)

        def rand(*shape, scale=1.0):
            return torch.randn(*shape, device=dev, generator=g) * scale

        src, flow = cast(rand(B, H, W, C)), rand(B, H, W, 2, scale=1.5)
        hbt, w1s = rand(B * H * W, D), wide(rand(k * k * C, D, scale=0.05))
        w2, b2 = cast(rand(D, k * k, scale=0.1)), rand(k * k, scale=0.1)
        out = torch.empty_like(src)
        stream = torch.cuda.current_stream().cuda_stream
        for n, label in WARP_VARIANTS.items():
            lib = libs["warp_fwd", n]

            def launch():
                must(lib.warp_fwd(
                    src.data_ptr(), flow.data_ptr(), hbt.data_ptr(),
                    w1s.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                    out.data_ptr(), None, None, B, H, W, C, D, k, 0.1,
                    stream),
                    f"warp_fwd variant {n}")

            rows.append(dict(kernel="warp_fwd", site=name, variant=n,
                             what=label, ms=cuda_ms(launch, iters)))
    return rows


def time_bwd(libs, iters, bf16=False):
    """Both backward kernels of csrc/warp_bwd.cu, from a random hpre and
    d_hpre, at the two warp sites."""
    rows = []
    dev = torch.device("cuda", 0)
    cast, wide = _values(bf16)
    for name, B, H, W, C, D, k in WARP_SITES:
        g = torch.Generator(device=dev).manual_seed(2)

        def rand(*shape, scale=1.0):
            return torch.randn(*shape, device=dev, generator=g) * scale

        N = B * H * W
        src, flow = cast(rand(B, H, W, C)), rand(B, H, W, 2, scale=1.5)
        hpre, w1s = rand(N, D), wide(rand(k * k * C, D, scale=0.05))
        w2, b2 = cast(rand(D, k * k, scale=0.1)), rand(k * k, scale=0.1)
        cot, d_hpre = cast(rand(B, H, W, C)), wide(rand(N, D))
        d_src = torch.zeros_like(src, dtype=torch.float32)
        d_flow = torch.empty_like(flow)
        d_hbt, dw2b2 = torch.empty_like(hpre), torch.empty(D * k * k + k * k,
                                                          device=dev)
        dw1s = torch.empty_like(w1s)
        stream = torch.cuda.current_stream().cuda_stream
        launches = {"warp_bwd_pos": {}, "warp_bwd_w1": {}}
        for n in BWD_VARIANTS:
            lib = libs["warp_bwd", n]
            pos_part = torch.empty(lib.pos_scratch(N, C, D, k),
                                   device=dev)
            w1_part = torch.empty(lib.w1_scratch(N, C, D, k),
                                  device=dev)

            def pos(lib=lib, part=pos_part, n=n):
                must(lib.warp_bwd_pos(
                    src.data_ptr(), flow.data_ptr(), hpre.data_ptr(),
                    w1s.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                    cot.data_ptr(), d_src.data_ptr(), d_flow.data_ptr(),
                    d_hbt.data_ptr(), part.data_ptr(), dw2b2.data_ptr(),
                    B, H, W, C, D, k, 0.1, stream),
                    f"warp_bwd_pos variant {n}")

            def w1(lib=lib, part=w1_part, n=n):
                must(lib.warp_bwd_w1(
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


def attn_inputs(N, k, C, D, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=g) * scale

    k2 = k * k
    w1 = rand(k2, 2 * C, D, scale=0.05)
    return dict(bs=rand(N, k2, C), bt=rand(N, k2, C), w1=w1,
                w1t=w1.reshape(-1, D).t().contiguous(), b1=rand(D, scale=0.1),
                w2=rand(D, k2, scale=0.01), b2=rand(k2, scale=0.1),
                hpre=rand(N, D), g=rand(N, C))


def time_attn(libs, iters, stems):
    """The attention-math forward (serving: no hpre store) and the backward
    from a random hpre, at the two attention sites."""
    rows = []
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    for name, N, k, C, D in ATTN_SITES:
        x = attn_inputs(N, k, C, D, dev, 3)
        k2 = k * k
        out = torch.empty(N, C, device=dev)
        d_bs, d_bt = torch.empty_like(x["bs"]), torch.empty_like(x["bt"])
        d_hpre = torch.empty(N, D, device=dev)
        sums = torch.empty(D * k2 + D + k2, device=dev)
        for stem in stems:
            for n, label in SOURCES[stem].items():
                lib = libs[stem, n]
                if stem == "attn_math_fwd":
                    scratch = torch.empty(
                        lib.gfla_attn_math_fwd_scratch(N, k2, C, D),
                        device=dev)

                    def launch(lib=lib, n=n, scratch=scratch):
                        must(lib.gfla_attn_math_fwd(
                            *(x[t].data_ptr() for t in ("bs", "bt", "w1t",
                                                        "b1", "w2", "b2")),
                            out.data_ptr(), None, scratch.data_ptr(), N, k2,
                            C, D, 0.1, stream), f"attn_math_fwd variant {n}")
                else:
                    scratch = torch.empty(
                        lib.gfla_attn_math_bwd_scratch(N, k2, D), device=dev)

                    def launch(lib=lib, n=n, scratch=scratch):
                        must(lib.gfla_attn_math_bwd(
                            *(x[t].data_ptr() for t in ("bs", "hpre", "g",
                                                        "w1", "w2", "b2")),
                            d_bs.data_ptr(), d_bt.data_ptr(),
                            d_hpre.data_ptr(), scratch.data_ptr(),
                            sums.data_ptr(), N, k2, C, D, 0.1, stream),
                            f"attn_math_bwd variant {n}")
                rows.append(dict(kernel=stem, site=name, variant=n,
                                 what=label, ms=cuda_ms(launch, iters)))
                if n == 0:
                    rows.extend(profile_parts(launch, stem, name, iters))
    return rows


def profile_parts(fn, stem, site, iters):
    """Each CUDA kernel's mean time over `iters` calls of fn, by
    torch.profiler, as rows of variant "kernel"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        ms = evt.device_time_total / 1e3 / iters
        name = re.search(r"(\w+)(<[^>]*>)?\(", evt.key)
        if ms > 0:
            rows.append(dict(kernel=stem, site=site, variant="kernel",
                             what=name.group(1) if name else evt.key[:40],
                             ms=ms))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--only", default=None,
                        help="comma-separated sources to split")
    parser.add_argument("--compute_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16: the warp kernels' bf16 instances")
    args = parser.parse_args(argv)
    bf16 = args.compute_dtype == "bfloat16"
    only = args.only or ",".join(BF16_SOURCES if bf16 else SOURCES)
    stems = [s for s in only.split(",") if s]
    unknown = set(stems) - set(SOURCES)
    if unknown:
        parser.error(f"unknown sources {sorted(unknown)}")
    if bf16 and set(stems) - set(BF16_SOURCES):
        parser.error(f"no bf16 instances of "
                     f"{sorted(set(stems) - set(BF16_SOURCES))}")
    if not torch.cuda.is_available():
        print("kernel_split: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    libs = build_variants(stems, "_bf16" if bf16 else "")
    rows = []
    if "warp_fwd" in stems:
        rows += time_warp(libs, args.iters, bf16)
    if "warp_bwd" in stems:
        rows += time_bwd(libs, args.iters, bf16)
    if "max_corr" in stems:
        rows += time_corr(libs, args.iters)
    attn = [s for s in stems if s.startswith("attn_math")]
    if attn:
        rows += time_attn(libs, args.iters, attn)
    torch.cuda.synchronize()
    whole = {}
    for row in rows:
        key = (row["kernel"], row["site"])
        if row["variant"] == 0:
            whole[key] = row["ms"]
            print(f"{row['kernel']} at {row['site']}")
        if row["variant"] == "kernel":
            print(f"  kernel {row['what']:<41} {row['ms']:8.4f} ms")
            continue
        print(f"  {row['what']:<48} {row['ms']:8.4f} ms  "
              f"({whole[key] - row['ms']:+.4f} ms missing)")
    print(json.dumps({"kernel_split": rows,
                      "compute_dtype": args.compute_dtype}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
