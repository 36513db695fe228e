"""ShapeNet novel-view synthesis (counterpart of gfla_tpu/tasks/shapenet.py,
the original's shapenet_model.py and shapenetflow_model.py).

The viewpoint labels arrive raw, (B, 2) ints (azimuth / 10, elevation), and
are one-hot coded on the device (`labels_to_semantic`): azimuth // 2 over 18
classes, then elevation // 10 over 3, a (B, 21, 1, 1) code in place of the
pose heatmaps. A test batch's (B, V, 2) sweep and (B, V, ...) targets give
their view 0 to a step; `run_test` serves every view.

* ShapeNetTask is the pose head's training and serving (tasks/pose.py: the
  D-then-G step, the six G losses, two Adams, `--compute_dtype`) on
  ShapeNetGenerator, with one attention level (2, kernel 3) by default: at
  256x256 its ExtractorAttn warps the 64x64x128 source features.
* ShapeNetFlowTask is stage-1 flow pretraining (tasks/poseflownet.py:
  correctness x 20 + regularization x 0.01, G only, float32 whatever
  `--compute_dtype` says) on ShapeNetFlowNetGenerator, whose checkpoint a
  later `--model=shapenet --continue_train` loads into its flow net.
"""

from __future__ import annotations

import torch

from gfla_tpu_torch.tasks.pose import PoseTask
from gfla_tpu_torch.tasks.poseflownet import PoseFlowNetTask
from gfla_tpu_torch.tasks.testing import run_test_shapenet


def labels_to_semantic(bp: torch.Tensor, label_nc_h: int = 18,
                       label_nc_v: int = 3) -> torch.Tensor:
    """(B, 2) int labels -> (B, label_nc_h + label_nc_v, 1, 1) float32 on
    their device (shapenet_model.py:116-127): one-hot of azimuth // 2, then
    of elevation // 10; an index out of range gives a zero row, as
    jax.nn.one_hot does."""
    h = bp[:, 0].long() // 2
    v = bp[:, 1].long() // 10
    code = torch.cat([
        h[:, None] == torch.arange(label_nc_h, device=bp.device),
        v[:, None] == torch.arange(label_nc_v, device=bp.device)], dim=1)
    return code.float()[:, :, None, None]


def _label_nc(opt):
    return getattr(opt, "label_nc_h", 18), getattr(opt, "label_nc_v", 3)


def viewpoint_batch(batch, label_nc):
    """A prepared batch with its integer labels one-hot coded, in the
    images' dtype: (B, 2) as they are, a (B, V, 2) sweep by its view 0, as a
    5-D P2 is."""
    out = dict(batch)
    for key in ("BP1", "BP2"):
        bp = out.get(key)
        if bp is not None and not bp.is_floating_point():
            out[key] = labels_to_semantic(bp if bp.dim() == 2 else bp[:, 0],
                                          *label_nc).to(out["P1"].dtype)
    if out.get("P2") is not None and out["P2"].dim() == 5:
        out["P2"] = out["P2"][:, 0]
    return out


class ShapeNetTask(PoseTask):
    generator = "shapenet"

    @staticmethod
    def modify_options(parser, is_train=True):
        """gfla_tpu's flags for this head (tasks/shapenet.py:46-67): the
        pose head's, with one attention level, 2, of kernel 3."""
        PoseTask.modify_options(parser, is_train)
        parser.set_defaults(attn_layer=[2], kernel_size={"2": 3},
                            netG="shapenet")
        return parser

    @staticmethod
    def structure_nc(opt) -> int:
        return sum(_label_nc(opt))

    def test_step(self, batch):
        return super().test_step(viewpoint_batch(batch, _label_nc(self.opt)))

    def train_step(self, batch):
        return super().train_step(viewpoint_batch(batch,
                                                  _label_nc(self.opt)))

    def run_test(self, opt, loader) -> int:
        return run_test_shapenet(self, opt, loader)


class ShapeNetFlowTask(PoseFlowNetTask):
    generator = "shapenetflow"
    structure_nc = staticmethod(ShapeNetTask.structure_nc)

    @staticmethod
    def modify_options(parser, is_train=True):
        """gfla_tpu's flags for this head (tasks/shapenet.py:184-197)."""
        PoseFlowNetTask.modify_options(parser, is_train)
        parser.set_defaults(attn_layer=[2], kernel_size={"2": 3},
                            netG="shapenetflow")
        return parser

    def test_step(self, batch):
        return super().test_step(viewpoint_batch(batch, _label_nc(self.opt)))

    def train_step(self, batch):
        return super().train_step(viewpoint_batch(batch,
                                                  _label_nc(self.opt)))
