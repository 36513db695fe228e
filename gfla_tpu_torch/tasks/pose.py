"""Pose-guided person image generation, serving path (counterpart of
gfla_tpu/tasks/pose.py).

Builds the generator exactly as gfla_tpu does (instance norm, LeakyReLU,
ngf 64, img_f 512, layers 3, attention at levels 2 and 3 with kernels 5 and 3)
and serves it in eval mode under `torch.inference_mode()`. Checkpoints are the
original GFLA's per-network files, `{which_iter}_net_G.pth`. The
discriminator, losses and the training step are not ported yet.
"""

from __future__ import annotations

import os

import torch

from gfla_tpu_torch.data.pose_utils import encode_heatmaps
from gfla_tpu_torch.models import define_g
from gfla_tpu_torch.nn.norms import init_weights
from gfla_tpu_torch.options import StoreDictKeyPair, StoreList, add_spect_d_flags
from gfla_tpu_torch.runtime import select_device


class PoseTask:
    model_names = ["G"]

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
        if getattr(opt, "compute_dtype", "float32") != "float32":
            raise NotImplementedError(
                f"--compute_dtype={opt.compute_dtype}: the port serves in "
                "float32; the warp kernel has no bfloat16 variant yet")
        if getattr(opt, "use_spect_g", False):
            raise NotImplementedError("--use_spect_g: spectral norm is not "
                                      "ported yet")
        self.opt = opt
        self.device = device if device is not None \
            else select_device(opt.gpu_ids)
        kz = {str(k): int(v) for k, v in opt.kernel_size.items()}
        self.net_g = define_g(
            "pose", image_nc=opt.image_nc, structure_nc=opt.structure_nc,
            output_nc=opt.image_nc, ngf=getattr(opt, "ngf", 64),
            img_f=getattr(opt, "img_f", 512), layers=opt.layers,
            num_blocks=2, norm_type="instance", activation="LeakyReLU",
            attn_layer=tuple(int(a) for a in opt.attn_layer),
            extractor_kz=kz,
        )
        init_weights(self.net_g,
                     torch.Generator().manual_seed(getattr(opt, "seed", 0)))
        self.net_g.to(self.device).eval()

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
        """Host batch (numpy NHWC images, (B, K, 2) keypoints) -> device NCHW
        tensors in channels_last memory; heatmaps are encoded on the device."""
        dev = {}
        for key in ("P1", "P2"):
            img = torch.from_numpy(batch[key]).to(self.device)
            dev[key] = img.permute(0, 3, 1, 2)
        H, W = dev["P1"].shape[2:]
        for kp, bp in (("KP1", "BP1"), ("KP2", "BP2")):
            cords = torch.from_numpy(batch[kp]).to(self.device)
            dev[bp] = encode_heatmaps(cords, H, W).permute(0, 3, 1, 2)
        return dev

    def test_step(self, batch):
        """Eval-mode forward; returns (img_gen, flows, masks)."""
        with torch.inference_mode():
            return self.net_g(batch["P1"], batch["BP1"], batch["BP2"])
