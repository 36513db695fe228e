"""Task registry of the port (counterpart of gfla_tpu/tasks/__init__.py):
the pose head, for serving and training, and its stage-1 flow pretraining
head, poseflownet."""

from __future__ import annotations

from gfla_tpu_torch.tasks.pose import PoseTask
from gfla_tpu_torch.tasks.poseflownet import PoseFlowNetTask

TASKS = {"pose": PoseTask, "poseflownet": PoseFlowNetTask}


def get_task_class(name: str):
    if name not in TASKS:
        raise KeyError(f"unknown model '{name}'; the port has {sorted(TASKS)}")
    return TASKS[name]


def create_task(opt, device=None):
    return get_task_class(opt.model)(opt, device)
