"""The training loop of `python -m gfla_tpu_torch.train`, as gfla_tpu's
train.py runs it, on one rank's device (the CLI's `main` sets up the world
and starts one rank per device; see its docstring)."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gfla_tpu_torch import parallel
from gfla_tpu_torch.data import (
    collate,
    get_dataset_class,
    infinite,
    make_loader,
)
from gfla_tpu_torch.runtime import card_line, set_tf32
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


def train(device: torch.device, opt) -> int:
    """The training loop on this rank's `device` (every rank runs it, in a
    world set up by `main`; with `--spatial` it enters the bands here)."""
    main_rank = parallel.is_main()
    log = print if main_rank else (lambda *a, **k: None)
    if device.type == "cuda":
        set_tf32(False)  # f32 work stays f32 (TF32 off), in either dtype
        log(card_line())
    if (opt.spatial or 1) > 1:
        parallel.init_bands(opt.spatial, opt.halo)
        log(f"spatial partitioning: {opt.spatial} row shards, halo "
            f"{opt.halo}")
    at = parallel.data_world()  # a spatial group's ranks share its data
    first = parallel.first_group()  # evaluates and writes the visuals
    np.random.seed(opt.seed + at.rank)
    torch.manual_seed(opt.seed + at.rank)
    dataset = get_dataset_class(opt.dataset_mode)(opt)
    holdout = None
    if opt.eval_iters_freq:
        holdout = holdout_indices(len(dataset), opt.batchSize, opt.seed)
        if holdout is None:
            log(f"WARNING: dataset too small ({len(dataset)} samples) to "
                f"hold out a val batch of {opt.batchSize}; eval will reuse "
                "training data")
        else:
            log(f"held out {len(holdout)} samples for eval (indices "
                f"{holdout.tolist()})")
    loader = make_loader(dataset, opt, train=True, exclude=holdout)
    if len(loader) == 0:
        raise SystemExit(f"dataset has {len(dataset)} samples, fewer than "
                         f"batchSize={opt.batchSize} a host over "
                         f"{at.nodes} host(s); reduce --batchSize")
    if not opt.iters_per_epoch:
        opt.iters_per_epoch = len(loader)
    log(f"dataset [{opt.dataset_mode}] created: {len(dataset)} samples, "
        f"{len(loader)} iters/epoch")
    task = create_task(opt, device)
    visualizer = Visualizer(opt)

    start_iter = 0
    if opt.continue_train:
        step = task.resume(opt.which_iter)
        if step is None:
            log("no checkpoint found; training from scratch")
        else:
            start_iter = step
            log(f"resumed from iteration {start_iter}")
    # a rank that found no checkpoint would start again at 0, with fresh
    # optimizer state, and drift from the others or take other steps
    parallel.same_everywhere(
        start_iter, "--continue_train resumed at different iterations (on "
        "several hosts --checkpoints_dir must be a folder they share)")
    parallel.replicate_(
        getattr(task, name) for name in ("net_g", "net_d", "net_d_v")
        if hasattr(task, name))

    max_iters = opt.max_iters or opt.niter * opt.iters_per_epoch
    batches = infinite(loader)
    batch = task.prepare_batch(next(batches))
    eval_batch = batch  # when no batch can be held out
    if holdout is not None and first:
        eval_batch = task.prepare_batch(
            collate([dataset[int(i)] for i in holdout]))
    trace_at = start_iter + 2 if opt.profile_iters and main_rank else -1
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
            # every rank: the mean over the global batch
            logs = {k: float(v)
                    for k, v in parallel.allreduce_mean(logs).items()}
            dt = (time.perf_counter() - t_last) / max(1, opt.print_freq)
            t_last = time.perf_counter()
            visualizer.print_current_errors(iters // opt.iters_per_epoch,
                                            iters, logs, dt)
        if opt.display_freq and iters % opt.display_freq == 0 and first:
            visualizer.display_current_results(
                current_visuals(task, batch), iters)
        if opt.eval_iters_freq and iters % opt.eval_iters_freq == 0 \
                and first:
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
    log(f"training finished at iteration {iters}")
    return 0
