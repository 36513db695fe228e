"""Task registry of the port (counterpart of gfla_tpu/tasks/__init__.py).
Only the pose head is ported so far, for serving and training."""

from __future__ import annotations

from gfla_tpu_torch.tasks.pose import PoseTask

TASKS = {"pose": PoseTask}


def get_task_class(name: str):
    if name not in TASKS:
        raise KeyError(f"unknown model '{name}'; the port has {sorted(TASKS)}")
    return TASKS[name]


def create_task(opt, device=None):
    return get_task_class(opt.model)(opt, device)
