"""Optimizers and learning-rate policies (counterpart of
gfla_tpu/train/state.py; the original's pose_model.py:82-90 and
base_function.py:211-224).

Adam with betas (0, 0.999) and eps 1e-8, its learning rate a multiple of the
base rate given by a step-indexed policy: the scheduler is stepped once per
iteration, so the rate at step n is optax's `schedule(n)` in gfla_tpu
(epoch = step // iters_per_epoch).
"""

from __future__ import annotations

from typing import Callable

import torch


def lr_multiplier(policy: str = "lambda", niter: int = 5_000_000,
                  niter_decay: int = 0, iter_count: int = 1,
                  iters_per_epoch: int = 1000,
                  lr_decay_iters: int = 50) -> Callable[[int], float]:
    """step -> learning-rate multiplier. lambda: 1 - max(0, epoch + 2 +
    iter_count - niter) / (niter_decay + 1), clipped to [0, 1]; step: 0.1
    every lr_decay_iters epochs; exponent: 0.95 every epoch."""
    if policy == "lambda":
        def mult(step):
            epoch = step // iters_per_epoch
            m = 1.0 - max(0.0, (epoch + 2 + iter_count - niter)
                          / float(niter_decay + 1))
            return min(max(m, 0.0), 1.0)
    elif policy == "step":
        def mult(step):
            return 0.1 ** (step // (lr_decay_iters * iters_per_epoch))
    elif policy == "exponent":
        def mult(step):
            return 0.95 ** (step // iters_per_epoch)
    else:
        raise NotImplementedError(f"lr policy [{policy}] not implemented")
    return mult


def make_optimizer(params, lr: float, policy: str = "lambda",
                   **schedule_kw):
    """(Adam(betas=(0, 0.999), eps=1e-8), LambdaLR under `policy`)."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.0, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lr_multiplier(policy, **schedule_kw))
    return opt, sched
