"""The keypoint head, the Motion Extraction Net (counterpart of
gfla_tpu/tasks/keypoint.py, the original's keypoint_model.py).

G is KPInput2DGenerator at its one width (17 joints, 256 channels, 4
layers: a receptive field of 81 frames), trained on the mean squared error
between the denoised and the ground-truth H36M-17 sequences by one Adam
with betas (0, 0.999) under `--lr_policy`. There is no D. `--lambda_mpjpe`
is parsed and, as in gfla_tpu, never multiplies the loss. The head runs in
float32 whatever `--compute_dtype` says, as gfla_tpu's, which never reads
the flag.

Batches keep gfla_tpu's (B, T, 34) layout, channels [y..., x...]; the net
is NCT, so the task transposes at its edge. Checkpoints are
`{iter}_net_G.pth` with the original's `kp_input.*` keys.

Under `--spatial=S` the batch has no rows to split: gfla_tpu's
`shard_batch_spatial` puts every array of rank < 4 on its data axis alone,
replicated over the spatial one. So here the S ranks of a spatial group
load the same rows (the loader shards by data index) and take the same
step; the dropouts draw from a generator seeded from `--seed`, the step
and the data index (`dropout_seed`), so that they drop the same entries,
and the gradient averaged over the world is the data-parallel gradient
over its N / S data indices.
"""

from __future__ import annotations

import numpy as np
import torch

from gfla_tpu_torch import parallel
from gfla_tpu_torch.models import define_g
from gfla_tpu_torch.models.keypoint_net import init_kp_weights
from gfla_tpu_torch.runtime import select_device
from gfla_tpu_torch.tasks.pose import PoseTask
from gfla_tpu_torch.tasks.poseflownet import PoseFlowNetTask
from gfla_tpu_torch.tasks.testing import run_test_keypoint
from gfla_tpu_torch.train.state import make_optimizer


def dropout_seed(seed: int, data_index: int, step: int) -> int:
    """The seed of the dropouts' generator for step `step` on a rank of
    data index `data_index` (the same on the S ranks of its spatial
    group): a function of the step, as gfla_tpu's dropout key is
    (`PRNGKey(step)`, tasks/keypoint.py:71), so a resumed run draws what
    the uninterrupted one would."""
    return (seed * 1_000_003 + step) * 1_009 + data_index


class KeypointTask:
    loss_names = ["mpjpe"]
    model_names = ["G"]

    @staticmethod
    def modify_options(parser, is_train=True):
        """gfla_tpu's flags for this head (gfla_tpu/tasks/keypoint.py:22-30)."""
        add = parser.add_argument
        add("--netG", type=str, default="kpinput2d")
        add("--init_type", type=str, default="orthogonal")
        add("--lambda_mpjpe", type=float, default=1000)
        add("--write_image", action="store_true", default=False)
        add("--n_frames_pre_load", type=int, default=6)
        add("--start_frame", type=int, default=0)
        return parser

    def __init__(self, opt, device: torch.device | None = None):
        self.opt = opt
        self.device = device if device is not None \
            else select_device(opt.gpu_ids)
        self.net_g = define_g(
            "kpinput2d", structure_nc=getattr(opt, "structure_nc", 17),
            channels=getattr(opt, "kp_channels", 256),
            layers=getattr(opt, "kp_layers", 4))
        init_kp_weights(self.net_g, torch.Generator().manual_seed(
            getattr(opt, "seed", 0)))
        self.net_g.to(self.device)
        self.dropout = torch.Generator(device=self.device)
        self.net_g.kp_input.seed_dropout(self.dropout)
        self.data_index = parallel.data_world().rank
        self.is_train = getattr(opt, "isTrain", False)
        if not self.is_train:
            self.net_g.eval()
            return
        self.opt_g, self.sched_g = make_optimizer(
            self.net_g.parameters(), opt.lr, policy=opt.lr_policy,
            niter=opt.niter, niter_decay=opt.niter_decay,
            iter_count=opt.iter_count,
            iters_per_epoch=max(1, getattr(opt, "iters_per_epoch", 1000)))
        self.step = 0
        self.net_g.train()

    load_checkpoint = PoseTask.load_checkpoint
    train_state = PoseFlowNetTask.train_state
    save = PoseFlowNetTask.save
    resume = PoseFlowNetTask.resume

    def prepare_batch(self, batch):
        """The host batch's arrays on the task's device, as they are."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def forward(self, input_data: torch.Tensor) -> torch.Tensor:
        """(B, T, 34) -> (B, T - 80, 34) through the NCT net."""
        return self.net_g(input_data.transpose(1, 2)).transpose(1, 2)

    def test_step(self, batch) -> torch.Tensor:
        """The eval-mode forward (no dropout), also between training
        steps."""
        training = self.net_g.training
        self.net_g.eval()
        try:
            with torch.inference_mode():
                return self.forward(batch["input_data"])
        finally:
            self.net_g.train(training)

    def train_step(self, batch):
        """One step on a prepared batch (gfla_tpu's _train_step_impl):
        mean((out - gt)^2), logged as mpjpe and total_G. The dropouts
        draw from `dropout_seed` of this step."""
        self.dropout.manual_seed(dropout_seed(
            getattr(self.opt, "seed", 0), self.data_index, self.step))
        out = self.forward(batch["input_data"])
        loss = torch.mean((out - batch["gt_data"]) ** 2)
        self.opt_g.zero_grad(set_to_none=True)
        loss.backward()
        parallel.step(self.opt_g)
        self.sched_g.step()
        self.step += 1
        loss = loss.detach()
        return {"mpjpe": loss, "total_G": loss}

    def run_test(self, opt, loader) -> int:
        return run_test_keypoint(self, opt, loader)
