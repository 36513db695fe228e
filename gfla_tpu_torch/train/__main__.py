"""Training entry point (`python -m gfla_tpu_torch.train`), CLI-compatible
with the original train.py:

    python -m gfla_tpu_torch.train --model=pose --dataset_mode=fashion \
        --dataroot=DIR --gpu_ids=0 --name=NAME --checkpoints_dir=DIR --niter=N

takes `--niter` epochs of iterations (or `--max_iters`) from the dataset
(`fashion` and `market` read a DeepFashion or Market-1501 tree, `synthetic`
makes its samples, `synthetic_video` its clips for `--model=dance|face`,
which take one optimizer step per chunk of an iteration's clip), and, as
gfla_tpu's train.py does:
- holds out one batch of samples when `--eval_iters_freq` is set and the
  dataset has two batches, and prints and logs its SSIM, PSNR and L1 every
  `--eval_iters_freq` iterations (`eval_log.txt`);
- prints and logs the losses every `--print_freq` (`loss_log.txt`);
- writes the visuals every `--display_freq` (`web/images/`);
- traces `--profile_iters` steps from the third with torch.profiler
  (`profile/`, a Chrome trace);
- saves `latest_net_{G,D}.pth` every `--save_latest_freq` and
  `{iter}_net_{G,D}.pth` every `--save_iters_freq` and at the end, and
  resumes from `--which_iter` with `--continue_train`.
All of it goes under `{checkpoints_dir}/{name}`; the animation heads save
`net_D_V` beside G and D. `--model=poseflownet` trains
the stage-1 flow head, which has no D; a later `--model=pose
--continue_train` with the same `--name` starts the pose generator's flow
net from it (the two-stage protocol). `--gpu_ids=-1` runs on the CPU;
`--remat` recomputes the generator's forward (each frame's, for the
animation heads) in the backward.
gfla_tpu's multi-device flags are refused.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gfla_tpu_torch.data import (
    collate,
    get_dataset_class,
    infinite,
    make_loader,
)
from gfla_tpu_torch.options import TrainOptions, refuse_parallel_flags
from gfla_tpu_torch.runtime import card_line, select_device, set_tf32
from gfla_tpu_torch.tasks import create_task
from gfla_tpu_torch.train.evaluate import (
    current_visuals,
    evaluate_held_out,
    holdout_indices,
)
from gfla_tpu_torch.utils.visualizer import Visualizer


def _start_trace(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, device, path: str, note: str = "") -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}{note}")


def main(args=None) -> int:
    opt = TrainOptions().parse(args)
    refuse_parallel_flags(opt)
    device = select_device(opt.gpu_ids)
    if device.type == "cuda":
        set_tf32(False)  # f32 work stays f32 (TF32 off), in either dtype
        print(card_line())
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)
    dataset = get_dataset_class(opt.dataset_mode)(opt)
    holdout = None
    if opt.eval_iters_freq:
        holdout = holdout_indices(len(dataset), opt.batchSize, opt.seed)
        if holdout is None:
            print(f"WARNING: dataset too small ({len(dataset)} samples) to "
                  f"hold out a val batch of {opt.batchSize}; eval will reuse "
                  "training data")
        else:
            print(f"held out {len(holdout)} samples for eval (indices "
                  f"{holdout.tolist()})")
    loader = make_loader(dataset, opt, train=True, exclude=holdout)
    if len(loader) == 0:
        raise SystemExit(f"dataset has {len(dataset)} samples, fewer than "
                         f"batchSize={opt.batchSize}; reduce --batchSize")
    if not opt.iters_per_epoch:
        opt.iters_per_epoch = len(loader)
    print(f"dataset [{opt.dataset_mode}] created: {len(dataset)} samples, "
          f"{len(loader)} iters/epoch")
    task = create_task(opt, device)
    visualizer = Visualizer(opt)

    start_iter = 0
    if opt.continue_train:
        step = task.resume(opt.which_iter)
        if step is None:
            print("no checkpoint found; training from scratch")
        else:
            start_iter = step
            print(f"resumed from iteration {start_iter}")

    max_iters = opt.max_iters or opt.niter * opt.iters_per_epoch
    batches = infinite(loader)
    batch = task.prepare_batch(next(batches))
    eval_batch = batch  # when no batch can be held out
    if holdout is not None:
        eval_batch = task.prepare_batch(
            collate([dataset[int(i)] for i in holdout]))
    trace_at = start_iter + 2 if opt.profile_iters else -1
    trace_path = os.path.join(opt.checkpoints_dir, opt.name, "profile",
                              f"trace_{trace_at + 1}.json")
    prof = None
    iters = start_iter
    t_last = time.perf_counter()
    while iters < max_iters:
        if iters == trace_at:
            prof = _start_trace(device)
        logs = task.train_step(batch)
        iters += 1
        if prof is not None and iters == trace_at + opt.profile_iters:
            _stop_trace(prof, device, trace_path)
            prof = None
        if iters % opt.print_freq == 0 or iters == start_iter + 1:
            logs = {k: float(v) for k, v in logs.items()}
            dt = (time.perf_counter() - t_last) / max(1, opt.print_freq)
            t_last = time.perf_counter()
            visualizer.print_current_errors(iters // opt.iters_per_epoch,
                                            iters, logs, dt)
        if opt.display_freq and iters % opt.display_freq == 0:
            visualizer.display_current_results(
                current_visuals(task, batch), iters)
        if opt.eval_iters_freq and iters % opt.eval_iters_freq == 0:
            evals = evaluate_held_out(task, eval_batch)
            if evals:
                visualizer.print_current_eval(iters // opt.iters_per_epoch,
                                              iters, evals)
        if iters % opt.save_iters_freq == 0:
            task.save(iters, numbered=True)
        elif iters % opt.save_latest_freq == 0:
            task.save(iters, numbered=False)
        if iters < max_iters:
            batch = task.prepare_batch(next(batches))
    if prof is not None:
        _stop_trace(prof, device, trace_path,
                    f" (truncated at iteration {iters})")
    task.save(iters, numbered=True)
    print(f"training finished at iteration {iters}")
    return 0


if __name__ == "__main__":
    main()
