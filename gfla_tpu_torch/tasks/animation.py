"""The recurrent animation heads, dance (a person) and face (counterpart of
gfla_tpu/tasks/animation.py; the original's dance_model.py and
face_model.py).

A training batch is a clip: P_all (B, N, 3, H, W), BP_all (B, N, nc, H, W)
and the reference pair. `train_step` cuts it into chunks of
`--max_frames_per_gpu` frames (truncated backpropagation through time) and
takes one optimizer step a chunk, each chunk starting from the previous
chunk's last generated frame (detached), last skeleton and last ground truth;
the first starts from the reference pair. A chunk's step
(`train_chunk`, gfla_tpu's `_chunk_step_impl`) in its order:

* one G forward over the chunk's T frames (`models.generators`'s frame
  recurrence; each frame under torch.utils.checkpoint with `--remat`);
* the D update on the detached frames, under one Adam over D and D_V at
  0.1x the G rate: D(real) then D(fake) on frame i_d, then D_V(real) then
  D_V(fake) on the F = `--frames_D_V` frames from s_d, each storing its
  spectral-norm u. D_V is dance's TemporalDiscriminator over the clip, or
  face's ResDiscriminator over the F - 1 frame differences
  window[f] - window[f + 1], concatenated along channels;
* the G losses with the frame axis folded into the batch (B * T, in (b, t)
  order): L1, VGG content and style (each x T), the correctness of the
  reference stream's flows warping the reference image and of the previous
  stream's warping the ground-truth previous frames (dance) or the
  generated ones, detached (face), per frame and summed (`frames=T`,
  weighted by `mask_step` with `--use_mask`), the affine regularization of
  each stream (x T), and the adversarial terms against the updated D (frame
  i_g) and D_V (window from s_g), which iterate u without storing it;
* the G backward and Adam step.
In a data-parallel run each gradient is averaged over the ranks just before
its Adam step (gfla_tpu_torch.parallel), once a chunk; in the data x
spatial mode (`--spatial`) each rank's batch is its row band of every clip
and image (`prepare_batch`), every module and loss band-aware, and the
carry between chunks stays on the band. The four indices
are drawn from a torch.Generator seeded from `--seed` and the step count
(gfla_tpu draws them with jax.random from the step), so every rank draws
the same ones, or passed in. Checkpoints are `{iter}_net_{G,D,D_V}.pth`.
Serving (`test_step`, `run_test`) generates chunk after chunk, the last
frame and skeleton carried into the next.

`--compute_dtype=bfloat16` follows gfla_tpu's mixed precision
(tasks/animation.py:160-161, 227-260): G over the chunk, D and D_V run in
bf16 through `train.precision.cast_call` from the f32 parameters, which keep
their f32 gradients, Adam state and checkpoints; their outputs (frames,
flows, masks, logits) come back in f32, and so the carry between chunks,
and the spectral-norm u they store is kept in f32. Under `--remat` each
frame is recomputed on the same bf16 copies (`nn.norms.recompute_keeping_u`).
The frozen VGG19 is cast to bf16 once, here. Serving (`test_step`) runs G's
f32 parameters whatever the flag says, as gfla_tpu's animation test step
does (tasks/animation.py:495-514).
"""

from __future__ import annotations

import numpy as np
import torch

from gfla_tpu_torch import parallel
from gfla_tpu_torch.data.animation_data import DIST_MAX
from gfla_tpu_torch.data.image_io import decode_images, decode_jpeg_batch
from gfla_tpu_torch.data.pose_utils import encode_heatmaps
from gfla_tpu_torch.data.raster import canny_l1
from gfla_tpu_torch.data.resample import (
    convert_l,
    pil_affine,
    pil_resize,
    resample_images,
)
from gfla_tpu_torch.losses import (
    MultiAffineRegularizationLoss,
    PerceptualCorrectness,
    adversarial_loss,
    l1_loss,
    vgg_content_style_loss,
)
from gfla_tpu_torch.models import define_d, define_g
from gfla_tpu_torch.models.vgg import load_vgg19
from gfla_tpu_torch.nn.norms import init_weights
from gfla_tpu_torch.options import (
    StoreDictKeyPair,
    StoreList,
    add_spect_d_flags,
    resolve_use_spect_d,
)
from gfla_tpu_torch.runtime import select_device
from gfla_tpu_torch.tasks.pose import PoseTask
from gfla_tpu_torch.tasks.testing import run_test_animation
from gfla_tpu_torch.train import checkpoint
from gfla_tpu_torch.train.precision import cast_call, compute_dtype
from gfla_tpu_torch.train.state import make_optimizer

BLACK, WHITE = (0.0, 0.0, 0.0), (255.0, 255.0, 255.0)
CANNY_LOW, CANNY_HIGH = 100, 200  # face_dataset.py's cv2.Canny thresholds
# uint8 levels and clipped distances as float32, made by numpy as gfla_tpu's
# datasets make them; looked up on the device, where torch divides by a
# scalar as a product with its reciprocal, a last bit off the quotient
RGB_LEVELS = torch.from_numpy(np.arange(256, dtype=np.float32) / 255.0)
DIST_LEVELS = torch.from_numpy(
    np.clip(np.arange(DIST_MAX + 1, dtype=np.float32) / 3, 0, 255)
    .astype(np.float32) / 255.0)


def prepare_batch(batch, device, opt=None):
    """Host clip batch -> device tensors, (B, T, C, H, W) and (B, C, H, W).
    The synthetic clips' arrays move as they are; the file-backed datasets'
    frames are decoded and warp-resized here (`prepare_video_batch`). Over
    row bands (the data x spatial mode) each keeps the rank's band of its
    rows."""
    if isinstance(batch.get("P_all"), list):
        return prepare_video_batch(batch, device, opt)
    out = {key: torch.from_numpy(value).to(device).movedim(-1, -3)
           for key, value in batch.items()
           if isinstance(value, np.ndarray) and value.dtype == np.float32}
    return {key: _band_rows(t) if t.dim() >= 4 else t
            for key, t in out.items()}


def _band(rows: int):
    """(the rank's band's rows, its first row) of an image of `rows` rows:
    the whole image without bands."""
    b = parallel.bands()
    if b is None:
        return rows, 0
    return rows // b.size, b.first_row(rows // b.size)


def _band_rows(t, dim: int = -2):
    """The rank's band of `t`'s rows along `dim` (all of them without
    bands)."""
    h, row0 = _band(t.shape[dim])
    return t.narrow(dim, row0, h)


def _bicubic_at(greys, size):
    """uint8 (H0, W0) grey images on one device -> uint8 (N, H, W) at
    `size`: PIL's resize(BICUBIC), one resize per input size."""
    out = torch.empty((len(greys), *size), dtype=torch.uint8,
                      device=greys[0].device)
    for shape in sorted({tuple(g.shape) for g in greys}):
        idx = [i for i, g in enumerate(greys) if tuple(g.shape) == shape]
        out[idx] = pil_resize(torch.stack([greys[i] for i in idx])[..., None],
                              size, "bicubic")[..., 0]
    return out


def _grey_at(images, size):
    """Decoded uint8 (H0, W0, 3) frames -> uint8 (N, H, W) grey at `size`:
    PIL's convert("L") then resize(BICUBIC)."""
    return _bicubic_at([convert_l(img) for img in images], size)


def prepare_masks(batch, device, size):
    """dance's --use_mask masks -> float32 (B, T, 1, H, W) on `device`:
    each read as PIL reads it in grey (`decode_images`), resized to `size` by
    PIL's bicubic, warped by PIL's bilinear affine transform with black fill
    (`pil_affine`, the frame's augmentation matrix), / 255 as numpy
    divides: gfla_tpu's `transform_image(..., normalize=False)` channel 0
    (gfla_tpu/data/animation_data.py:313-317)."""
    B, T = len(batch["mask_all"]), len(batch["mask_all"][0])
    grey = _bicubic_at(decode_images(
        [d for clip in batch["mask_all"] for d in clip],
        [f"the mask of {p}" for clip in batch["gen_paths"] for p in clip],
        device, "L"), size)
    inverse = torch.from_numpy(batch["mask_inv"].reshape(B * T, 6))
    warped = pil_affine(grey[..., None], inverse.to(device), 0)
    return RGB_LEVELS.to(device)[warped.long()].reshape(B, T, 1, *size)


def face_structure(edges, labels, dist, images, canny: bool):
    """The face dataset's 16 structure channels (face_dataset.py:143-229 of
    the original) on the device: the curves (uint8 (..., H, W), 0 or 255)
    joined by the Canny edges of each frame's grey image where no part label
    lies, the parts' distances (int16 (..., H, W, 14)) as clip(d / 3, 0,
    255) / 255, and the labels -> float32 (..., H, W, 16), or 2 channels
    without distances. `images` are the decoded frames, one per (..., )."""
    edge = edges > 0
    if canny:
        grey = _grey_at(images, tuple(edges.shape[-2:]))
        background = canny_l1(grey, CANNY_LOW, CANNY_HIGH).reshape(edge.shape)
        edge = edge | (background & (labels == 0))
    layers = [edge.to(torch.float32)[..., None]]
    if dist is not None:
        layers.append(DIST_LEVELS.to(dist.device)[dist.long()])
    layers.append(labels.to(torch.float32)[..., None])
    return torch.cat(layers, -1)


def prepare_video_batch(batch, device, opt):
    """A dance or face batch (data/animation_data.py's keys) -> the task's
    device batch: every frame and reference image decoded in one
    `decode_jpeg_batch` (nvJPEG on the card) and warp-resized and normalised
    by `resample_images` (black fill, white for --sub_dataset=fashion);
    dance's heatmaps encoded from the joints (missing at 0) beside the drawn
    limbs, as gfla_tpu's train.py does, or its host maps moved; face's
    structure built by `face_structure`, the reference being the first
    frame; dance's --use_mask masks by `prepare_masks`. Everything after
    the decode is the same code on every device. Over row bands the
    frames, masks and face's structure (whose Canny edges read the
    neighbouring rows) are built whole, then each keeps the rank's band;
    dance's heatmaps are encoded for the band's rows alone, from their
    global coordinates, beside its drawn limbs' band."""
    frames = batch["P_all"]
    B, T = len(frames), len(frames[0])
    H, W = ((opt.load_size, opt.load_size) if isinstance(opt.load_size, int)
            else tuple(opt.load_size))
    datas = [d for clip in frames for d in clip]
    names = [p for paths in batch["gen_paths"] for p in paths]
    inverse = [batch["P_all_inv"].reshape(B * T, 2, 3)]
    if "ref_image" in batch:
        datas += batch["ref_image"]
        names += batch["ref_path"]
        inverse.append(batch["ref_inv"])
    decoded = decode_jpeg_batch(datas, device, names)
    inverse = torch.from_numpy(np.concatenate(inverse)).to(device)
    fill = WHITE if getattr(opt, "sub_dataset", "iper") == "fashion" \
        else BLACK
    images = resample_images(decoded, (H, W), inverse, fill).movedim(-1, -3)

    def dev(key):
        return torch.from_numpy(batch[key]).to(device)

    h, row0 = _band(H)
    b = parallel.bands()
    if b is not None and "KP_all" in batch \
            and batch["KP_all"].shape[1] % b.size:
        # gfla_tpu's shard_batch_spatial shards its axis 1 and asserts this
        raise SystemExit(f"--spatial {b.size}: the batch's KP_all "
                         f"{batch['KP_all'].shape} has T = "
                         f"{batch['KP_all'].shape[1]} on axis 1, which does "
                         f"not divide by {b.size}")
    out = {"P_all": _band_rows(images[:B * T].reshape(B, T, 3, H, W))}
    if "ref_image" in batch:  # dance
        out["ref_image"] = _band_rows(images[B * T:])
        for key, kp, rgb in (("BP_all", "KP_all", "BP_all_rgb"),
                             ("ref_skeleton", "ref_KP", "ref_rgb")):
            if kp in batch:
                maps = torch.cat([
                    encode_heatmaps(dev(kp), h, W, missing_value=0.0,
                                    row0=row0),
                    RGB_LEVELS.to(device)[_band_rows(dev(rgb), -3).long()]],
                    -1)
            else:
                maps = _band_rows(dev(key), -3)
            out[key] = maps.movedim(-1, -3)
    else:  # face
        bp = _band_rows(face_structure(
            dev("edges"), dev("labels"),
            dev("dist") if "dist" in batch else None, decoded,
            not getattr(opt, "no_canny_edge", False)).movedim(-1, -3))
        out.update(BP_all=bp, ref_image=out["P_all"][:, 0],
                   ref_skeleton=bp[:, 0])
    if "mask_all" in batch:
        out["mask_all"] = _band_rows(prepare_masks(batch, device, (H, W)))
    for key in ("gen_kps_clean", "gen_kps_noise"):
        if key in batch:
            out[key] = dev(key)
    return out


def fold(a):
    """(B, T, ...) -> (B * T, ...), in (b, t) order."""
    return a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])


class AnimationTaskBase:
    kind = "dance"
    loss_names = [
        "app_gen", "correctness_p", "correctness_r", "content_gen",
        "style_gen", "regularization_p", "regularization_r",
        "ad_gen", "dis_img_gen", "ad_gen_v", "dis_img_gen_v",
    ]
    model_names = ["G", "D", "D_V"]

    @classmethod
    def modify_options(cls, parser, is_train=True):
        """gfla_tpu's flags for these heads (tasks/animation.py:79-112)."""
        add = parser.add_argument
        add("--attn_layer", action=StoreList, metavar="VAL1,VAL2...",
            default=[2, 3])
        add("--kernel_size", action=StoreDictKeyPair,
            metavar="KEY1=VAL1,KEY2=VAL2...", default={"2": 5, "3": 3})
        add("--layers", type=int, default=3)
        add("--netG", type=str, default=cls.kind)
        add("--netD", type=str, default="res")
        add("--netD_V", type=str,
            default="temporal" if cls.kind == "dance" else "res")
        add("--init_type", type=str, default="orthogonal")
        add("--ratio_g2d", type=float, default=0.1)
        add("--lambda_rec", type=float, default=5.0)
        add("--lambda_g", type=float, default=2.0)
        add("--lambda_correct", type=float, default=5.0)
        add("--lambda_style", type=float, default=500.0)
        add("--lambda_content", type=float, default=0.5)
        add("--lambda_regularization", type=float, default=0.0025)
        add("--frames_D_V", type=int, default=6 if cls.kind == "dance" else 3)
        add("--max_frames_per_gpu", type=int, default=6)
        add("--n_frames_total", type=int, default=12)
        add("--max_t_step", type=int, default=1)
        add("--n_frames_pre_load_test", type=int, default=6)
        add("--start_frame", type=int, default=0)
        add("--use_mask", action="store_true", default=False)
        add("--use_spect_g", action="store_true", default=False)
        add_spect_d_flags(parser)
        add("--write_ext", type=str, default="png")
        return parser

    def __init__(self, opt, device: torch.device | None = None):
        self.opt = opt
        self.dtype = compute_dtype(getattr(opt, "compute_dtype", "float32"))
        self.is_train = getattr(opt, "isTrain", False)
        F = opt.frames_D_V
        if self.is_train and F > opt.max_frames_per_gpu:
            raise ValueError(
                f"--frames_D_V={F} (temporal-D window) cannot exceed "
                f"--max_frames_per_gpu={opt.max_frames_per_gpu} (frames "
                "generated per chunk)")
        if self.kind == "dance" and F < 5:
            raise ValueError(
                f"--frames_D_V={F} is below the temporal discriminator's "
                "minimum of 5 (two 3-D encoders each shrink the time axis "
                "by 2)")
        self.device = device if device is not None \
            else select_device(opt.gpu_ids)
        kz = {str(k): int(v) for k, v in opt.kernel_size.items()}
        self.attn_layer = [int(a) for a in opt.attn_layer]
        self.net_g = define_g(
            self.kind, image_nc=opt.image_nc, structure_nc=opt.structure_nc,
            output_nc=opt.image_nc, ngf=getattr(opt, "ngf", 64),
            img_f=getattr(opt, "img_f", 512), layers=opt.layers,
            num_blocks=2, norm_type="instance", activation="LeakyReLU",
            attn_layer=tuple(self.attn_layer), extractor_kz=kz,
            use_spect=getattr(opt, "use_spect_g", False))
        gen = torch.Generator().manual_seed(getattr(opt, "seed", 0))
        init_weights(self.net_g, gen)
        self.net_g.to(self.device)
        if not self.is_train:
            self.net_g.eval()
            return
        dkw = dict(ndf=getattr(opt, "ndf", 32),
                   img_f=getattr(opt, "d_img_f", 128),
                   layers=getattr(opt, "d_layers", 4),
                   use_spect=resolve_use_spect_d(opt))
        self.net_d = define_d("res", **dkw)
        if self.kind == "dance":
            self.net_d_v = define_d("temporal", input_length=F, **dkw)
        else:
            self.net_d_v = define_d("res", input_nc=3 * (F - 1), **dkw)
        for net in (self.net_d, self.net_d_v):
            init_weights(net, gen)
            net.to(self.device)
        self.vgg = load_vgg19().to(self.device, self.dtype)
        self.correctness = PerceptualCorrectness(self.vgg)
        self.regularization = MultiAffineRegularizationLoss(
            {int(k): v for k, v in kz.items()})
        self.use_mask = getattr(opt, "use_mask", False)
        if self.use_mask and self.kind == "dance":
            opt.lambda_correct = 2.0  # dance_model.py:115-117
        okw = dict(policy=opt.lr_policy, niter=opt.niter,
                   niter_decay=opt.niter_decay, iter_count=opt.iter_count,
                   iters_per_epoch=max(1, getattr(opt, "iters_per_epoch",
                                                  1000)))
        self.opt_g, self.sched_g = make_optimizer(
            self.net_g.parameters(), opt.lr, **okw)
        self.opt_d, self.sched_d = make_optimizer(
            [*self.net_d.parameters(), *self.net_d_v.parameters()],
            opt.lr * opt.ratio_g2d, **okw)
        self.step = 0  # optimizer steps: one a chunk
        self.tail_warned = False
        for net in (self.net_g, self.net_d, self.net_d_v):
            net.train()

    load_checkpoint = PoseTask.load_checkpoint

    def prepare_batch(self, batch):
        return prepare_batch(batch, self.device, self.opt)

    # ------------------------------------------------------------------
    def test_step(self, batch, pre_image=None, pre_skeleton=None):
        """Eval-mode frames of the clip in `batch` (B, T, 3, H, W), from the
        previous image and skeleton given (the reference pair if None);
        returns (frames, (last frame, last skeleton)), the carry into the
        next chunk."""
        training = self.net_g.training
        self.net_g.eval()
        try:
            with torch.inference_mode():
                gen = self.net_g(batch["BP_all"], batch["ref_image"],
                                 batch["ref_skeleton"], pre_image,
                                 pre_skeleton)[0]
        finally:
            self.net_g.train(training)
        return gen, (gen[:, -1], batch["BP_all"][:, -1])

    def run_test(self, opt, loader) -> int:
        """The serving CLI's pass (tasks/testing.py)."""
        return run_test_animation(self, opt, loader)

    # ------------------------------------------------------------------
    def draw_indices(self, T: int):
        """(i_d, s_d, i_g, s_g): D's frame and window, then G's, from a
        generator seeded by `--seed` and the step count."""
        gen = torch.Generator().manual_seed(
            getattr(self.opt, "seed", 0) * 1_000_003 + self.step)
        windows = max(1, T - self.opt.frames_D_V + 1)
        return tuple(int(torch.randint(0, n, (), generator=gen))
                     for n in (T, windows, T, windows))

    def dv_input(self, frames, start: int):
        """D_V's input from the F frames of (B, T, 3, H, W) from `start`:
        the clip (dance), or the frame differences along channels (face)."""
        window = frames[:, start:start + self.opt.frames_D_V]
        if self.kind == "dance":
            return window
        return torch.cat([window[:, f] - window[:, f + 1]
                          for f in range(window.shape[1] - 1)], dim=1)

    def train_chunk(self, chunk, indices=None):
        """One optimizer step over one chunk: P_step and BP_step
        (B, T, C, H, W), ref_image, ref_skeleton, pre_image, pre_skeleton,
        pre_gt_image (B, C, H, W), optionally mask_step (B, T, 1, H, W).
        Returns (logs, carry)."""
        opt = self.opt
        p_step = chunk["P_step"]
        T = p_step.shape[1]
        i_d, s_d, i_g, s_g = indices or self.draw_indices(T)
        gen, flows, _, prev = cast_call(
            self.net_g, self.dtype, chunk["BP_step"], chunk["ref_image"],
            chunk["ref_skeleton"], chunk["pre_image"], chunk["pre_skeleton"],
            remat=getattr(opt, "remat", False))
        fake = gen.detach()

        # D and D_V on the detached frames; each pass stores its u
        for net in (self.net_d, self.net_d_v):
            net.requires_grad_(True)
        self.opt_d.zero_grad(set_to_none=True)
        d_real = cast_call(self.net_d, self.dtype, p_step[:, i_d],
                           update_stats=True)
        d_fake = cast_call(self.net_d, self.dtype, fake[:, i_d],
                           update_stats=True)
        loss_d = 0.5 * (adversarial_loss(d_real, True, True, opt.gan_mode)
                        + adversarial_loss(d_fake, False, True, opt.gan_mode))
        dv_real = cast_call(self.net_d_v, self.dtype,
                            self.dv_input(p_step, s_d), update_stats=True)
        dv_fake = cast_call(self.net_d_v, self.dtype,
                            self.dv_input(fake, s_d), update_stats=True)
        loss_dv = 0.5 * (adversarial_loss(dv_real, True, True, opt.gan_mode)
                         + adversarial_loss(dv_fake, False, True,
                                            opt.gan_mode))
        (loss_d + loss_dv).backward()
        parallel.step(self.opt_d)
        self.sched_d.step()

        # G losses, the frame axis folded into the batch
        for net in (self.net_d, self.net_d_v):
            net.requires_grad_(False)
        gen_f, gt_f = fold(gen), fold(p_step)
        with torch.no_grad():
            gt_feats = self.vgg(gt_f)
            ref_feats = {name: f.repeat_interleave(T, dim=0) for name, f in
                         self.vgg(chunk["ref_image"]).items()}
        if self.kind == "dance":  # the ground-truth previous frames
            prev_src = torch.cat([chunk["pre_gt_image"][:, None],
                                  p_step[:, :-1]], dim=1)
        else:  # the generated ones
            prev_src = prev.detach()
        mask = fold(chunk["mask_step"]) if self.use_mask \
            and chunk.get("mask_step") is not None else None
        flow_p = [fold(f) for f in flows[0::2]]
        flow_r = [fold(f) for f in flows[1::2]]
        content, style = vgg_content_style_loss(self.vgg, gen_f, gt_f,
                                                fy=gt_feats)
        logs = {
            "app_gen": l1_loss(gen_f, gt_f) * T * opt.lambda_rec,
            "content_gen": content * T * opt.lambda_content,
            "style_gen": style * T * opt.lambda_style,
            "correctness_p": self.correctness(
                gt_f, fold(prev_src), flow_p, self.attn_layer, mask,
                frames=T, target_feats=gt_feats) * opt.lambda_correct,
            "correctness_r": self.correctness(
                gt_f, None, flow_r, self.attn_layer, mask, frames=T,
                target_feats=gt_feats, source_feats=ref_feats)
            * opt.lambda_correct,
            "regularization_p": self.regularization(flow_p) * T
            * opt.lambda_regularization,
            "regularization_r": self.regularization(flow_r) * T
            * opt.lambda_regularization,
            "ad_gen": adversarial_loss(
                cast_call(self.net_d, self.dtype, gen[:, i_g],
                          update_stats=False), True, False,
                opt.gan_mode) * opt.lambda_g,
            "ad_gen_v": adversarial_loss(
                cast_call(self.net_d_v, self.dtype, self.dv_input(gen, s_g),
                          update_stats=False),
                True, False, opt.gan_mode) * opt.lambda_g,
        }
        total = sum(logs.values())
        self.opt_g.zero_grad(set_to_none=True)
        total.backward()
        parallel.step(self.opt_g)
        self.sched_g.step()
        self.step += 1
        logs = {k: v.detach() for k, v in logs.items()}
        logs.update(dis_img_gen=loss_d.detach(), dis_img_gen_v=loss_dv.detach(),
                    total_G=total.detach())
        return logs, (fake[:, -1], chunk["BP_step"][:, -1], p_step[:, -1])

    def train_step(self, batch, indices=None):
        """One iteration over a clip: a step per chunk of
        `--max_frames_per_gpu` frames, the carry detached between chunks;
        the logs averaged over chunks. Trailing frames that fill no chunk
        are dropped, with one warning. `indices`, one tuple a chunk,
        replaces the drawn ones."""
        p, bp, masks = batch["P_all"], batch["BP_all"], batch.get("mask_all")
        N = p.shape[1]
        T = min(self.opt.max_frames_per_gpu, N)
        if N % T and not self.tail_warned:
            self.tail_warned = True
            print(f"animation: dropping {N % T} trailing frame(s) — "
                  f"n_frames_total={N} is not a multiple of "
                  f"max_frames_per_gpu={T}")
        carry = (batch["ref_image"], batch["ref_skeleton"],
                 batch["ref_image"])
        total = {}
        starts = range(0, N - N % T, T)
        for c, s in enumerate(starts):
            chunk = {"P_step": p[:, s:s + T], "BP_step": bp[:, s:s + T],
                     "ref_image": batch["ref_image"],
                     "ref_skeleton": batch["ref_skeleton"],
                     "pre_image": carry[0], "pre_skeleton": carry[1],
                     "pre_gt_image": carry[2]}
            if masks is not None:
                chunk["mask_step"] = masks[:, s:s + T]
            logs, carry = self.train_chunk(
                chunk, indices[c] if indices else None)
            for k, v in logs.items():
                total[k] = total[k] + v if k in total else v
        return {k: v / len(starts) for k, v in total.items()}

    # ------------------------------------------------------------------
    def nets(self):
        return {"G": self.net_g, "D": self.net_d, "D_V": self.net_d_v}

    def train_state(self):
        """Optimizer and scheduler states and the chunk count, for the
        checkpoint side file."""
        return {"opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(),
                "sched_g": self.sched_g.state_dict(),
                "sched_d": self.sched_d.state_dict(),
                "chunk_steps": self.step}

    def save(self, step: int, numbered: bool = True):
        return checkpoint.save_checkpoint(
            self.opt.checkpoints_dir, self.opt.name, step, self.nets(),
            self.train_state(), numbered)

    def resume(self, which_iter: str = "latest"):
        """Load G, D, D_V and the optimizer state of `which_iter`; returns
        the iteration, or None when nothing is saved."""
        state, step = checkpoint.load_checkpoint(
            self.opt.checkpoints_dir, self.opt.name, self.nets(), which_iter)
        if step is None:
            return None
        if state is not None:
            self.opt_g.load_state_dict(state["opt_g"])
            self.opt_d.load_state_dict(state["opt_d"])
            self.sched_g.load_state_dict(state["sched_g"])
            self.sched_d.load_state_dict(state["sched_d"])
            self.step = int(state["chunk_steps"])
            step = int(state["step"])
        return step


class DanceTask(AnimationTaskBase):
    kind = "dance"


class FaceTask(AnimationTaskBase):
    kind = "face"
