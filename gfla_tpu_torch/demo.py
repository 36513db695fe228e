"""Demo entry point of the port (root demo.py's counterpart):

    python -m gfla_tpu_torch.demo [test options]

is `python -m gfla_tpu_torch.test` with `--phase val` added when no phase
is given: the pose head writes its vis, ref, gt and all panels.

    python -m gfla_tpu_torch.demo --walkthrough [--gpu_ids=0] [--work=DIR]

runs the original's demo notebook as a script, each step echoed as a
cell: the card, the kernel build, the assets, a tiny pose training on
synthetic data, its val-phase panels, and the metrics CLI on them (on
fallback weights when assets/ lacks them). It runs on the card unless
`--gpu_ids=-1`; its files go under DIR (default: gfla_tpu_torch_demo in
the temporary directory), the scores in DIR/eval.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cell(n, title, cmd=None):
    print(f"\n[{n}] {title}", flush=True)
    if cmd is not None:
        print("    $", " ".join(cmd), flush=True)
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO)
        if res.returncode != 0:
            print(f"    cell [{n}] FAILED (rc={res.returncode})")
            sys.exit(res.returncode)
        print(f"    (cell [{n}]: {time.perf_counter() - t0:.1f} s)",
              flush=True)


def stage_for_metrics(demo_dir: str, gt_dir: str, gen_dir: str) -> int:
    """Copy the val-phase panels into the metrics CLI's layout: each
    `{src}_2_{tgt}_vis.jpg` into gen_dir as is, each `{src}_2_{tgt}_gt.jpg`
    into gt_dir as `{tgt}.jpg`. Returns the number of generated images."""
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(gen_dir, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(demo_dir)):
        if f.endswith("_vis.jpg"):
            shutil.copyfile(os.path.join(demo_dir, f),
                            os.path.join(gen_dir, f))
            n += 1
        elif f.endswith("_gt.jpg"):
            tgt = f.split("_2_")[-1][: -len("_gt.jpg")] + ".jpg"
            shutil.copyfile(os.path.join(demo_dir, f),
                            os.path.join(gt_dir, tgt))
    return n


def walkthrough(work: Optional[str] = None, gpu_ids: str = "0") -> None:
    """The notebook's cells on the port; the scores go to `work`/eval."""
    from gfla_tpu_torch.metrics.inception import assets_dir
    from gfla_tpu_torch.runtime import card_line, select_device

    work = work or os.path.join(tempfile.gettempdir(), "gfla_tpu_torch_demo")
    device = select_device(gpu_ids)
    py = sys.executable
    ck, out = os.path.join(work, "ckpt"), os.path.join(work, "results")
    gpu = f"--gpu_ids={gpu_ids}"

    _cell(1, "Environment — the notebook's `nvidia-smi` cell")
    if device.type == "cuda":
        import torch

        print(f"    {card_line()}\n    torch {torch.__version__} cuda "
              f"{torch.version.cuda}, {torch.cuda.get_device_name(device)}")
    else:
        print("    --gpu_ids=-1: the CPU, every kernel's plain twin")

    _cell(2, "Build — the notebook's `setup.sh` CUDA cell")
    if device.type == "cuda":
        from gfla_tpu_torch.ops._build import build

        build(verbose=False)
        print("    built the kernels and the nvJPEG library with nvcc")
    else:
        print("    nothing to build on the CPU")

    # the perceptual losses read <repo>/assets, the metrics $GFLA_ASSETS_DIR
    wanted = (os.path.join(REPO, "assets", "vgg19_features.npz"),
              os.path.join(assets_dir(), "inception_v3.npz"),
              os.path.join(assets_dir(), "lpips_alex.npz"))
    have = [p for p in wanted if os.path.exists(p)]
    _cell(3, "Assets — the notebook's `download.sh` cell")
    print(f"    present: {have or 'none'}; without them the losses and the "
          "scores\n    run on seeded fallback weights, stamped "
          "FALLBACK-WEIGHTS (scripts/convert_*_weights.py write them)")

    _cell(4, "Pose demo, part 1 — train a tiny model on synthetic data",
          [py, "-m", "gfla_tpu_torch.train", "--name=demo", "--model=pose",
           "--dataset_mode=synthetic", "--load_size=64", "--batchSize=2",
           "--max_iters=20", "--print_freq=5", f"--checkpoints_dir={ck}",
           gpu])

    _cell(5, "Pose demo, part 2 — write {src}_2_{tgt}_vis.jpg panels",
          [py, "-m", "gfla_tpu_torch.demo", "--name=demo", "--model=pose",
           "--dataset_mode=synthetic", "--load_size=64", "--batchSize=2",
           f"--checkpoints_dir={ck}", f"--results_dir={out}",
           "--max_dataset_size=4", gpu])

    demo_dir = os.path.join(out, "demo")
    gt_dir, gen_dir = os.path.join(work, "gt"), os.path.join(work, "gen")
    for d in (gt_dir, gen_dir):  # no statistics.npz of an earlier run
        shutil.rmtree(d, ignore_errors=True)
    n = stage_for_metrics(demo_dir, gt_dir, gen_dir)
    print(f"    staged {n} panels from {demo_dir}")

    _cell(6, "Quantitative check — the metrics CLI on the demo outputs",
          [py, "-m", "gfla_tpu_torch.metrics", f"--gt_path={gt_dir}",
           f"--distorated_path={gen_dir}", f"--fid_real_path={gt_dir}",
           "--name=demo_walkthrough", f"--out_dir={work}/eval",
           "--allow_fallback_weights", gpu])

    print("\n[7] The animation and view-synthesis heads follow the same shape "
          "with\n    --model=dance, face or shapenet (README.md).")
    print("\nwalkthrough OK")


def main(args=None) -> int:
    args = list(sys.argv[1:] if args is None else args)
    flags = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    flags.add_argument("--walkthrough", action="store_true")
    flags.add_argument("--work", default=None)
    flags.add_argument("--gpu_ids", default="0")
    flags.add_argument("--phase", default=None)
    known, _ = flags.parse_known_args(args)
    if known.walkthrough:
        walkthrough(known.work, known.gpu_ids)
        return 0
    if known.phase is None:
        args += ["--phase", "val"]
    from gfla_tpu_torch import test

    return test.main(args)


if __name__ == "__main__":
    main()
