"""Task registry of the port (counterpart of gfla_tpu/tasks/__init__.py):
the pose head and the ShapeNet novel-view head, for serving and training,
their stage-1 flow pretraining heads, poseflownet and shapenetflow, and the
recurrent animation heads, dance and face, and the keypoint head, the
Motion Extraction Net."""

from __future__ import annotations

from gfla_tpu_torch.tasks.animation import DanceTask, FaceTask
from gfla_tpu_torch.tasks.keypoint import KeypointTask
from gfla_tpu_torch.tasks.pose import PoseTask
from gfla_tpu_torch.tasks.poseflownet import PoseFlowNetTask
from gfla_tpu_torch.tasks.shapenet import ShapeNetFlowTask, ShapeNetTask

TASKS = {"pose": PoseTask, "poseflownet": PoseFlowNetTask,
         "shapenet": ShapeNetTask, "shapenetflow": ShapeNetFlowTask,
         "dance": DanceTask, "face": FaceTask, "keypoint": KeypointTask}


def get_task_class(name: str):
    if name not in TASKS:
        raise KeyError(f"unknown model '{name}'; the port has {sorted(TASKS)}")
    return TASKS[name]


def create_task(opt, device=None):
    return get_task_class(opt.model)(opt, device)
