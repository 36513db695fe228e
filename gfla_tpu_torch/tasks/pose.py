"""Pose-guided person image generation (counterpart of gfla_tpu/tasks/pose.py).

Builds the networks exactly as gfla_tpu does: G is the pose generator
(instance norm, LeakyReLU, ngf 64, img_f 512, layers 3, attention at levels
2 and 3 with kernels 5 and 3, spectral-normed with `--use_spect_g`); in
train mode D is the spectral-norm ResDiscriminator (4 layers, 3 for market;
ndf 32, img_f 128), with the frozen VGG19, the six G losses and two Adams,
betas (0, 0.999), D lr = 0.1 G lr.

`train_step` is gfla_tpu's step (tasks/pose.py:190-284, the original's
pose_model.py:130-196) in its order: one G forward (recomputed in the
backward under `--remat`); a D step on the detached fake, D(real) then
D(fake), each storing its spectral-norm u; the G losses against the updated
D, which iterates u without storing it; the G backward and Adam step. Serving runs G in eval mode under `torch.inference_mode()`.
Checkpoints are the original GFLA's per-network files, `{iter}_net_G.pth`
and `{iter}_net_D.pth`.

`--compute_dtype=bfloat16` follows gfla_tpu's mixed precision
(tasks/pose.py:97-99, 145-181): G and D run in bf16 through
`train.precision.cast_call` from the f32 parameters, which keep their f32
gradients, Adam state and checkpoints; their outputs come back in f32, and
the spectral-norm u they store is kept in f32. The frozen VGG19 is cast to
bf16 once, here, as gfla_tpu casts its parameters.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gfla_tpu_torch.data.image_io import decode_jpeg_batch
from gfla_tpu_torch.data.pose_utils import encode_heatmaps
from gfla_tpu_torch.data.resample import resample_images, resize_like_pil
from gfla_tpu_torch.losses import (
    MultiAffineRegularizationLoss,
    PerceptualCorrectness,
    adversarial_loss,
    l1_loss,
    vgg_content_style_loss,
)
from gfla_tpu_torch.models import define_d, define_g
from gfla_tpu_torch.models.vgg import load_vgg19
from gfla_tpu_torch.nn.norms import init_weights, recompute_keeping_u
from gfla_tpu_torch.options import (
    StoreDictKeyPair,
    StoreList,
    add_spect_d_flags,
    resolve_use_spect_d,
)
from gfla_tpu_torch.runtime import select_device
from gfla_tpu_torch.tasks.testing import run_test_pose
from gfla_tpu_torch.train import checkpoint
from gfla_tpu_torch.train.precision import cast_call, compute_dtype
from gfla_tpu_torch.train.state import make_optimizer


def prepare_batch(batch, device, load_size):
    """Host batch -> device NCHW tensors in channels_last memory. A
    file-backed pose batch (JPEG bytes, 2x3 inverse matrices) is decoded on
    the device and warped and resized to `load_size` in one batched pass; a
    ShapeNet batch's stored uint8 pixels, (B, H, W, 3) or a test sweep's
    (B, V, H, W, 3), are resized there as PIL resizes them; a synthetic
    batch's NHWC float images move as they are. Heatmaps are encoded on the
    device from the (B, K, 2) keypoints; ShapeNet's viewpoint labels, (B, 2)
    or (B, V, 2) ints, move as they are, for the task to one-hot."""
    dev = {}
    if "P1_inv" in batch:
        n = len(batch["P1"])
        images = decode_jpeg_batch(batch["P1"] + batch["P2"], device,
                                   batch["P1_path"] + batch["P2_path"])
        inverse = torch.from_numpy(np.concatenate(
            [batch["P1_inv"], batch["P2_inv"]])).to(device)
        hw = (load_size, load_size) if isinstance(load_size, int) \
            else tuple(load_size)
        both = resample_images(images, hw, inverse).permute(0, 3, 1, 2)
        dev["P1"], dev["P2"] = both[:n], both[n:]
    else:
        for key in ("P1", "P2"):
            img = torch.from_numpy(batch[key]).to(device)
            if img.dtype == torch.uint8:
                img = resize_like_pil(img, load_size)
            dev[key] = img.movedim(-1, -3)
    if "KP1" not in batch:
        for key in ("BP1", "BP2"):
            dev[key] = torch.from_numpy(batch[key]).to(device)
        return dev
    H, W = dev["P1"].shape[2:]
    for kp, bp in (("KP1", "BP1"), ("KP2", "BP2")):
        cords = torch.from_numpy(batch[kp]).to(device)
        dev[bp] = encode_heatmaps(cords, H, W).permute(0, 3, 1, 2)
    return dev


class PoseTask:
    loss_names = [
        "app_gen", "correctness_gen", "content_gen", "style_gen",
        "regularization", "ad_gen", "dis_img_gen",
    ]
    model_names = ["G", "D"]
    generator = "pose"

    @staticmethod
    def modify_options(parser, is_train=True):
        """The pose head's flags and re-defaults (gfla_tpu/tasks/pose.py:50-75,
        the original's pose_model.py:20-47)."""
        add = parser.add_argument
        add("--attn_layer", action=StoreList, metavar="VAL1,VAL2...",
            default=[2, 3])
        add("--kernel_size", action=StoreDictKeyPair,
            metavar="KEY1=VAL1,KEY2=VAL2...", default={"2": 5, "3": 3})
        add("--layers", type=int, default=3)
        add("--netG", type=str, default="pose")
        add("--netD", type=str, default="res")
        add("--init_type", type=str, default="orthogonal")
        add("--ratio_g2d", type=float, default=0.1)
        add("--lambda_rec", type=float, default=5.0)
        add("--lambda_g", type=float, default=2.0)
        add("--lambda_correct", type=float, default=5.0)
        add("--lambda_style", type=float, default=500.0)
        add("--lambda_content", type=float, default=0.5)
        add("--lambda_regularization", type=float, default=0.0025)
        add("--use_spect_g", action="store_true", default=False)
        add_spect_d_flags(parser)
        add("--save_input", action="store_true", default=False)
        return parser

    def __init__(self, opt, device: torch.device | None = None):
        self.opt = opt
        self.device = device if device is not None \
            else select_device(opt.gpu_ids)
        self.dtype = compute_dtype(getattr(opt, "compute_dtype", "float32"))
        kz = {str(k): int(v) for k, v in opt.kernel_size.items()}
        self.net_g = define_g(
            self.generator, image_nc=opt.image_nc,
            structure_nc=self.structure_nc(opt), output_nc=opt.image_nc,
            ngf=getattr(opt, "ngf", 64), img_f=getattr(opt, "img_f", 512),
            layers=opt.layers,
            num_blocks=2, norm_type="instance", activation="LeakyReLU",
            attn_layer=tuple(int(a) for a in opt.attn_layer),
            extractor_kz=kz, use_spect=getattr(opt, "use_spect_g", False),
        )
        gen = torch.Generator().manual_seed(getattr(opt, "seed", 0))
        init_weights(self.net_g, gen)
        self.net_g.to(self.device)
        self.is_train = getattr(opt, "isTrain", False)
        if not self.is_train:
            self.net_g.eval()
            return
        self.attn_layer = [int(a) for a in opt.attn_layer]
        d_layers = getattr(opt, "d_layers", None) or (
            3 if opt.dataset_mode == "market" else 4)
        self.net_d = define_d(
            "res", ndf=getattr(opt, "ndf", 32),
            img_f=getattr(opt, "d_img_f", 128), layers=d_layers,
            use_spect=resolve_use_spect_d(opt))
        init_weights(self.net_d, gen)
        self.net_d.to(self.device)
        self.vgg = load_vgg19().to(self.device, self.dtype)
        self.correctness = PerceptualCorrectness(self.vgg)
        self.regularization = MultiAffineRegularizationLoss(
            {int(k): int(v) for k, v in opt.kernel_size.items()})
        okw = dict(policy=opt.lr_policy, niter=opt.niter,
                   niter_decay=opt.niter_decay, iter_count=opt.iter_count,
                   iters_per_epoch=max(1, getattr(opt, "iters_per_epoch",
                                                  1000)))
        self.opt_g, self.sched_g = make_optimizer(
            self.net_g.parameters(), opt.lr, **okw)
        self.opt_d, self.sched_d = make_optimizer(
            self.net_d.parameters(), opt.lr * opt.ratio_g2d, **okw)
        self.step = 0
        self.net_g.train()
        self.net_d.train()

    @staticmethod
    def structure_nc(opt) -> int:
        """Channels of the pose code G takes: the heatmaps."""
        return opt.structure_nc

    def load_checkpoint(self) -> bool:
        """Load `{checkpoints_dir}/{name}/{which_iter}_net_G.pth`, a state
        dict in the original GFLA's layout, with strict key matching."""
        opt = self.opt
        path = os.path.join(opt.checkpoints_dir, opt.name,
                            f"{opt.which_iter}_net_G.pth")
        if not os.path.exists(path):
            print("WARNING: no checkpoint found; using random init")
            return False
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        self.net_g.load_state_dict(sd, strict=True)
        print(f"loaded checkpoint {path}")
        return True

    def prepare_batch(self, batch):
        return prepare_batch(batch, self.device, self.opt.load_size)

    def test_step(self, batch):
        """Eval-mode forward, also between training steps (no spectral-norm
        u is stored); returns (img_gen, flows, masks)."""
        training = self.net_g.training
        self.net_g.eval()
        try:
            with torch.inference_mode():
                return cast_call(self.net_g, self.dtype, batch["P1"],
                                 batch["BP1"], batch["BP2"])
        finally:
            self.net_g.train(training)

    def run_test(self, opt, loader) -> int:
        """The serving CLI's pass over the test set (tasks/testing.py)."""
        return run_test_pose(self, opt, loader)

    def g_forward(self, p1, bp1, bp2):
        """G's training forward. With `--remat` it is recomputed in the
        backward instead of keeping its activations, as gfla_tpu wraps it in
        jax.checkpoint (tasks/pose.py:201-205). The recomputation starts
        from the spectral-norm u the forward started from and leaves the u
        the forward stored, so the step's values and gradients are those of
        the step without it."""
        if not getattr(self.opt, "remat", False):
            return cast_call(self.net_g, self.dtype, p1, bp1, bp2)
        return recompute_keeping_u(
            self.net_g, lambda *a: cast_call(self.net_g, self.dtype, *a),
            p1, bp1, bp2)

    def d_forward(self, x, update_stats):
        """D's logits in f32, computed in the compute dtype."""
        return cast_call(self.net_d, self.dtype, x, update_stats=update_stats)

    # ------------------------------------------------------------------
    def train_step(self, batch):
        """One D-then-G step on a prepared batch. Returns the losses as
        0-dim tensors: `loss_names` plus `total_G`."""
        opt = self.opt
        p1, bp1, p2, bp2 = batch["P1"], batch["BP1"], batch["P2"], batch["BP2"]
        img_gen, flows, _ = self.g_forward(p1, bp1, bp2)

        # D step on the detached fake; each pass stores its power iteration
        self.net_d.requires_grad_(True)
        self.opt_d.zero_grad(set_to_none=True)
        d_real = self.d_forward(p2, update_stats=True)
        d_fake = self.d_forward(img_gen.detach(), update_stats=True)
        loss_d = 0.5 * (adversarial_loss(d_real, True, True, opt.gan_mode)
                        + adversarial_loss(d_fake, False, True, opt.gan_mode))
        loss_d.backward()
        self.opt_d.step()
        self.sched_d.step()

        # G losses against the updated D, frozen and not storing u
        self.net_d.requires_grad_(False)
        with torch.no_grad():
            p2_feats = self.vgg(p2)
        logs = {
            "app_gen": l1_loss(img_gen, p2) * opt.lambda_rec,
            "correctness_gen": self.correctness(
                p2, p1, flows, self.attn_layer, target_feats=p2_feats)
            * opt.lambda_correct,
            "ad_gen": adversarial_loss(
                self.d_forward(img_gen, update_stats=False), True, False,
                opt.gan_mode) * opt.lambda_g,
            "regularization": self.regularization(flows)
            * opt.lambda_regularization,
        }
        content, style = vgg_content_style_loss(self.vgg, img_gen, p2,
                                                fy=p2_feats)
        logs["content_gen"] = content * opt.lambda_content
        logs["style_gen"] = style * opt.lambda_style
        total = sum(logs.values())
        self.opt_g.zero_grad(set_to_none=True)
        total.backward()
        self.opt_g.step()
        self.sched_g.step()
        self.step += 1
        logs = {k: v.detach() for k, v in logs.items()}
        logs["dis_img_gen"] = loss_d.detach()
        logs["total_G"] = total.detach()
        return logs

    def train_state(self):
        """Optimizer and scheduler states, for the checkpoint side file."""
        return {"opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(),
                "sched_g": self.sched_g.state_dict(),
                "sched_d": self.sched_d.state_dict()}

    def save(self, step: int, numbered: bool = True):
        return checkpoint.save_checkpoint(
            self.opt.checkpoints_dir, self.opt.name, step,
            {"G": self.net_g, "D": self.net_d}, self.train_state(), numbered)

    def resume(self, which_iter: str = "latest"):
        """Load G, D and the optimizer state of `which_iter`; returns the
        step, or None when nothing is saved. A stage-1 poseflownet directory
        loads its `flow_net.*` into G's flow net, leaves the rest of G and
        D at their init and keeps its step, with fresh optimizers (the
        two-stage protocol)."""
        state, step = checkpoint.load_checkpoint(
            self.opt.checkpoints_dir, self.opt.name,
            {"G": self.net_g, "D": self.net_d}, which_iter)
        if step is None:
            return None
        self.step = step
        if state is not None:
            self.opt_g.load_state_dict(state["opt_g"])
            self.opt_d.load_state_dict(state["opt_d"])
            self.sched_g.load_state_dict(state["sched_g"])
            self.sched_d.load_state_dict(state["sched_d"])
            self.step = int(state["step"])
        return self.step
