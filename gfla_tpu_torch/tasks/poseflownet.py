"""Stage-1 flow pretraining (counterpart of gfla_tpu/tasks/poseflownet.py,
the original's poseflownet_model.py).

G is PoseFlowNetGenerator alone, built as gfla_tpu builds it: ngf 32,
img_f 256, 5 encoder levels, instance norm, LeakyReLU, flows and masks at the
attention levels (2 and 3 by default, 32x32 and 64x64 at 256x256), spectral
norm with `--use_spect_g`. The loss is the sampling correctness of the flows
(x `--lambda_correct`, 20) plus their affine regularization
(x `--lambda_regularization`, 0.01), and one Adam with betas (0, 0.999)
takes the step. There is no D. Checkpoints are `{iter}_net_G.pth`, keyed
`flow_net.*`, so that `--model=pose --continue_train` on the same name
starts stage 2 from them (PoseTask.resume).

The VGG19 features come from the images alone, so they are computed without
grad; the correctness loss's max-correlation then needs no backward in a
step. With GFLA_PALLAS_CORR=1 it runs the CUDA kernel (ops/max_corr.py).
"""

from __future__ import annotations

import torch

from gfla_tpu_torch.losses import (
    MultiAffineRegularizationLoss,
    PerceptualCorrectness,
)
from gfla_tpu_torch.models import define_g
from gfla_tpu_torch.models.vgg import load_vgg19
from gfla_tpu_torch.nn.norms import init_weights
from gfla_tpu_torch.options import StoreDictKeyPair, StoreList
from gfla_tpu_torch.runtime import select_device
from gfla_tpu_torch.tasks.pose import prepare_batch
from gfla_tpu_torch.train import checkpoint
from gfla_tpu_torch.train.state import make_optimizer

# the flow net's fixed widths, as in gfla_tpu and in PoseGenerator.flow_net
FLOW_NET = dict(ngf=32, img_f=256, encoder_layer=5, norm_type="instance",
                activation="LeakyReLU")


class PoseFlowNetTask:
    loss_names = ["correctness", "regularization"]
    model_names = ["G"]

    @staticmethod
    def modify_options(parser, is_train=True):
        """gfla_tpu's flags and defaults for this head
        (gfla_tpu/tasks/poseflownet.py:28-42)."""
        add = parser.add_argument
        add("--netG", type=str, default="poseflownet")
        add("--init_type", type=str, default="orthogonal")
        add("--attn_layer", action=StoreList, metavar="VAL1,VAL2...",
            default=[2, 3])
        add("--kernel_size", action=StoreDictKeyPair,
            metavar="KEY1=VAL1,KEY2=VAL2...", default={"2": 5, "3": 3})
        add("--lambda_correct", type=float, default=20.0)
        add("--lambda_regularization", type=float, default=0.01)
        add("--use_spect_g", action="store_true", default=False)
        return parser

    def __init__(self, opt, device: torch.device | None = None):
        # runs in float32 whatever --compute_dtype says, as gfla_tpu's
        # poseflownet task, which never reads the flag
        self.opt = opt
        self.device = device if device is not None \
            else select_device(opt.gpu_ids)
        self.attn_layer = [int(a) for a in opt.attn_layer]
        self.net_g = define_g(
            "poseflownet", image_nc=opt.image_nc,
            structure_nc=opt.structure_nc, attn_layer=tuple(self.attn_layer),
            use_spect=getattr(opt, "use_spect_g", False), **FLOW_NET)
        init_weights(self.net_g,
                     torch.Generator().manual_seed(getattr(opt, "seed", 0)))
        self.net_g.to(self.device)
        self.is_train = getattr(opt, "isTrain", False)
        if not self.is_train:
            self.net_g.eval()
            return
        self.vgg = load_vgg19().to(self.device)
        self.correctness = PerceptualCorrectness(self.vgg)
        self.regularization = MultiAffineRegularizationLoss(
            {int(k): int(v) for k, v in opt.kernel_size.items()})
        self.opt_g, self.sched_g = make_optimizer(
            self.net_g.parameters(), opt.lr, policy=opt.lr_policy,
            niter=opt.niter, niter_decay=opt.niter_decay,
            iter_count=opt.iter_count,
            iters_per_epoch=max(1, getattr(opt, "iters_per_epoch", 1000)))
        self.step = 0
        self.net_g.train()

    def prepare_batch(self, batch):
        return prepare_batch(batch, self.device)

    def test_step(self, batch):
        """Eval-mode forward; returns (flows, masks)."""
        with torch.inference_mode():
            return self.net_g(batch["P1"], batch["BP1"], batch["BP2"])

    def train_step(self, batch):
        """One G step on a prepared batch (gfla_tpu's _train_step_impl).
        Returns the losses as 0-dim tensors: `loss_names` plus `total_G`."""
        opt = self.opt
        p1, p2 = batch["P1"], batch["P2"]
        flows, _ = self.net_g(p1, batch["BP1"], batch["BP2"])
        with torch.no_grad():
            p2_feats, p1_feats = self.vgg(p2), self.vgg(p1)
        logs = {
            "correctness": self.correctness(
                p2, p1, flows, self.attn_layer, target_feats=p2_feats,
                source_feats=p1_feats) * opt.lambda_correct,
            "regularization": self.regularization(flows)
            * opt.lambda_regularization,
        }
        total = logs["correctness"] + logs["regularization"]
        self.opt_g.zero_grad(set_to_none=True)
        total.backward()
        self.opt_g.step()
        self.sched_g.step()
        self.step += 1
        logs = {k: v.detach() for k, v in logs.items()}
        logs["total_G"] = total.detach()
        return logs

    def train_state(self):
        """Optimizer and scheduler states, for the checkpoint side file."""
        return {"opt_g": self.opt_g.state_dict(),
                "sched_g": self.sched_g.state_dict()}

    def save(self, step: int, numbered: bool = True):
        return checkpoint.save_checkpoint(
            self.opt.checkpoints_dir, self.opt.name, step, {"G": self.net_g},
            self.train_state(), numbered)

    def resume(self, which_iter: str = "latest"):
        """Load G and its optimizer state of `which_iter`; returns the step,
        or None when nothing is saved."""
        state, step = checkpoint.load_checkpoint(
            self.opt.checkpoints_dir, self.opt.name, {"G": self.net_g},
            which_iter)
        if step is None:
            return None
        self.step = step
        if state is not None:
            self.opt_g.load_state_dict(state["opt_g"])
            self.sched_g.load_state_dict(state["sched_g"])
            self.step = int(state["step"])
        return self.step
