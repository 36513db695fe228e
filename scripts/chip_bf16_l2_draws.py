"""Draws of chip_smoke.py's BF16_L2 clause (phase 20b) on one card.

    python3 scripts/chip_bf16_l2_draws.py [--kind face] [--draws 24]
        [--out build/bf16_l2_draws.json]

Builds phase 20b's full-width bf16 task of the head (`--kind`, batch 2 x 6
frames at 256x256, seeded weights and clips), moves its flow heads off the
floor's kinks (`chip_smoke.off_the_kinks`), takes the f32 step once, and
then `--draws` bf16 steps from that one state on each path, in turns: the
kernel path (the bf16 warp kernels) and the plain path (the warp's plain
twin). For every G tensor the clause reads (numel > 1, resolved by the
plain path: L2 distance to the f32 gradient at most BF16_L2[0] of its
norm) it writes each draw's relative L2 distance to the f32 gradient on
both paths, d_kernel and d_plain (and d_kernel with the gradient scaled by
1.5, phase 20b's first planted fault), and each small tensor's gradients
(up to 64 values), to the JSON file; it prints, for the tensors with the largest
d_kernel - 2 d_plain, both distributions and that value over the paired
draws. The two paths start from one state and one batch in every draw, so
what varies is each path's order of summation (the kernels' vector
reductions, cuDNN's algorithms). Needs CUDA.
"""

import argparse
import contextlib
import copy
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def rel_l2(g, g32):
    return (g - g32).norm().item() / g32.norm().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="face", choices=("dance", "face"))
    ap.add_argument("--draws", type=int, default=24)
    ap.add_argument("--out", default="build/bf16_l2_draws.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_bf16_l2_draws: CUDA is not available", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    from gfla_tpu_torch.runtime import set_tf32
    from gfla_tpu_torch.tasks import create_task

    set_tf32(False)
    t0 = time.perf_counter()
    with cs.switches(GFLA_ATTN_PALLAS="auto", GFLA_PALLAS_CORR="0"):
        cs.phase_card()
        cs.phase_build()
        opt, ckpt = cs.train_opt(f"--name={args.kind}_draws", "--batchSize=2",
                                 f"--n_frames_total={cs.ANIM_T}", cs.ANIM_BF16,
                                 model=args.kind, dataset="synthetic_video")
        task = create_task(opt)
        batch = task.prepare_batch(cs.anim_clips(opt, 2)[0])
        state = cs.off_the_kinks(task)
        del task
        ckpt.cleanup()
        f32 = copy.deepcopy(state)
        f32.dtype = torch.float32
        f32.vgg.float()
        f32.train_step(batch)
        g32 = cs.snapshot(f32)["G"]["grads"]
        del f32
        names, d = None, {"kernel": [], "plain": [], "kernel_x1.5": []}
        small = {"kernel": [], "plain": []}
        for draw in range(args.draws):
            for side, path in (("kernel", contextlib.nullcontext),
                               ("plain", cs.plain_warp)):
                work = copy.deepcopy(state)
                with path():
                    work.train_step(batch)
                grads = cs.snapshot(work)["G"]["grads"]
                del work
                if names is None:  # the clause's tensors, as grads_by_rule
                    names = [n for n, g in g32.items() if g.numel() > 1
                             and g.norm().item() > 1e-2
                             * grads[n].norm().item()]
                d[side].append([rel_l2(grads[n], g32[n]) for n in names])
                if side == "kernel":  # phase 20b's first planted fault
                    d["kernel_x1.5"].append([rel_l2(1.5 * grads[n], g32[n])
                                             for n in names])
                small[side].append({n: grads[n].flatten().tolist()
                                    for n in names if grads[n].numel() <= 64})
            print(f"draw {draw}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    resolved = [i for i, n in enumerate(names)
                if max(dp[i] for dp in d["plain"]) <= cs.BF16_L2[0]]
    clause = {names[i]: [dk[i] - 2 * dp[i] for dk, dp in
                         zip(d["kernel"], d["plain"])] for i in resolved}
    worst = sorted(clause, key=lambda n: -max(clause[n]))[:8]
    for n in worst:
        i = names.index(n)
        dk = [row[i] for row in d["kernel"]]
        dp = [row[i] for row in d["plain"]]
        print(f"{n} ({g32[n].numel()} values): d_kernel min "
              f"{min(dk):.4e} median {statistics.median(dk):.4e} max "
              f"{max(dk):.4e}; d_plain min {min(dp):.4e} median "
              f"{statistics.median(dp):.4e} max {max(dp):.4e}; d_kernel - "
              f"2 d_plain max {max(clause[n]):.4e} (bound "
              f"{cs.BF16_L2[1]:g})")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(kind=args.kind, draws=args.draws, names=names,
                       numel=[g32[n].numel() for n in names],
                       d_kernel=d["kernel"], d_plain=d["plain"],
                       d_kernel_x15=d["kernel_x1.5"],
                       f32_small={n: g32[n].flatten().tolist() for n in names
                                  if g32[n].numel() <= 64},
                       small=small, card=torch.cuda.get_device_name(0)), f)
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
