"""Training entry point (`python -m gfla_tpu_torch.train`), CLI-compatible
with the original train.py:

    python -m gfla_tpu_torch.train --model=pose --dataset_mode=synthetic \
        --gpu_ids=0 --name=NAME --checkpoints_dir=DIR --niter=N

takes `--niter` iterations (or `--max_iters`), prints the losses every
`--print_freq` iterations, saves `latest_net_{G,D}.pth` every
`--save_latest_freq` and `{iter}_net_{G,D}.pth` every `--save_iters_freq`
and at the end, and resumes from `--which_iter` with `--continue_train`.
`--model=poseflownet` trains the stage-1 flow head, which has no D; a later
`--model=pose --continue_train` with the same `--name` starts the pose
generator's flow net from it (the two-stage protocol).
`--gpu_ids=-1` runs on the CPU; `--remat` recomputes the pose generator's
forward in the backward. Counterpart of gfla_tpu's train.py without its
visualizer, held-out evaluation and profiler trace: it prints one line at
the start naming the `--display_freq`, `--eval_iters_freq` and
`--profile_iters` settings that would act in gfla_tpu and are not honoured
here, and it refuses gfla_tpu's multi-device flags.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gfla_tpu_torch.data import get_dataset_class, train_batches
from gfla_tpu_torch.options import (
    TrainOptions,
    refuse_parallel_flags,
    unhonoured_train_flags,
)
from gfla_tpu_torch.runtime import card_line, select_device, set_tf32
from gfla_tpu_torch.tasks import create_task


def main(args=None) -> int:
    opt = TrainOptions().parse(args)
    refuse_parallel_flags(opt)
    device = select_device(opt.gpu_ids)
    if device.type == "cuda":
        set_tf32(False)  # float32 training, as gfla_tpu's float32 path
        print(card_line())
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)
    dataset = get_dataset_class(opt.dataset_mode)(opt)
    n_batches = len(dataset) // opt.batchSize
    if n_batches == 0:
        raise SystemExit(f"dataset has {len(dataset)} samples, fewer than "
                         f"batchSize={opt.batchSize}; reduce --batchSize")
    if not opt.iters_per_epoch:
        opt.iters_per_epoch = n_batches
    print(f"dataset [{opt.dataset_mode}] created: {len(dataset)} samples, "
          f"{n_batches} iters/epoch")
    task = create_task(opt, device)

    start_iter = 0
    if opt.continue_train:
        step = task.resume(opt.which_iter)
        if step is None:
            print("no checkpoint found; training from scratch")
        else:
            start_iter = step
            print(f"resumed from iteration {start_iter}")

    max_iters = opt.max_iters or opt.niter * opt.iters_per_epoch
    ignored = unhonoured_train_flags(opt, start_iter, max_iters)
    if ignored:
        print("not honoured yet (ROADMAP.md, queue 1, item 2): "
              + ", ".join(ignored))
    batches = train_batches(dataset, opt.batchSize,
                            shuffle=not opt.serial_batches,
                            seed=opt.seed + start_iter)
    iters = start_iter
    t_last = time.perf_counter()
    while iters < max_iters:
        logs = task.train_step(task.prepare_batch(next(batches)))
        iters += 1
        if iters % opt.print_freq == 0 or iters == start_iter + 1:
            logs = {k: float(v) for k, v in logs.items()}
            dt = (time.perf_counter() - t_last) / max(1, opt.print_freq)
            t_last = time.perf_counter()
            print(f"(epoch: {iters // opt.iters_per_epoch}, iters: {iters}, "
                  f"time: {dt:.3f}) "
                  + " ".join(f"{k}: {v:.3f}" for k, v in logs.items()),
                  flush=True)
        if iters % opt.save_iters_freq == 0:
            task.save(iters, numbered=True)
        elif iters % opt.save_latest_freq == 0:
            task.save(iters, numbered=False)
    task.save(iters, numbered=True)
    print(f"training finished at iteration {iters}")
    return 0


if __name__ == "__main__":
    main()
