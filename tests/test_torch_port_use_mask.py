"""`--use_mask` for the dance head (the iPER person masks) against gfla_tpu
and PIL, on the CPU.

gfla_tpu reads a frame's `train_C` mask with PIL (`Image.open(...)
.convert("L").convert("RGB")`), resizes it to the load size by PIL's
bicubic, warps it by PIL's bilinear affine transform with the clip's
augmentation matrix and black fill, and keeps channel 0 / 255
(gfla_tpu/data/animation_data.py:313-317, data/affine.py:56-66). The port
decodes the mask (`data.image_io.decode_images`: nvJPEG or its own PNG
reader, PIL's grey conversion) and runs `data/resample.py`'s `pil_resize`
and `pil_affine` in `prepare_batch`, on the card there. Held:
- `pil_affine` bitwise against PIL's `Image.transform(AFFINE, BILINEAR)` on
  uint8 grey and RGB images: rotations, shifts and scales about the centre,
  arbitrary matrices reaching outside the image, the identity, fills 0, 128
  and 255, odd, even and non-square sizes; and `affine.image_inverse`
  with it bitwise against gfla_tpu's `apply_affine`;
- the dance dataset's `mask_all` after the port's `prepare_batch` bitwise
  gfla_tpu's, on a tree whose masks are grey PNGs, RGB PNGs and JPEGs
  (chip_smoke.write_video_tree); the flag silently ignored where gfla_tpu
  ignores it (FashionVideo, the test phase, face);
The masked f32 chunk step against gfla_tpu's (the correctness losses
weighted by the masks, `lambda_correct` 2.0 as gfla_tpu sets it) is
tests/test_torch_port_animation_train.py::test_chunk_step_matches_gfla_tpu
[dance]; `--use_mask` through the training CLI, in bf16, is
tests/test_torch_port_animation.py::test_clis_train_and_stream_dance_bf16.
"""

import argparse
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from gfla_tpu.data.affine import apply_affine
from gfla_tpu.data.animation_data import DanceDataset as JaxDance
from gfla_tpu.data.animation_data import FaceDataset as JaxFace
from gfla_tpu_torch.data import collate
from gfla_tpu_torch.data.affine import image_inverse, inverse_affine_matrix
from gfla_tpu_torch.data.animation_data import DanceDataset, FaceDataset
from gfla_tpu_torch.data.resample import pil_affine
from gfla_tpu_torch.tasks.animation import prepare_batch

LOAD = 64
SEQS, FRAMES = 3, 7
MASK_FORMATS = ("L", "RGB", "JPEG")


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the other test workers share these cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _picture(rng, H, W, C):
    """uint8 (H, W, C): smooth gradients, a hard-edged block and noise."""
    yy, xx = np.mgrid[:H, :W]
    img = np.stack([(xx * 7 + yy * 3 + 40 * c) % 256 for c in range(C)], -1)
    img[H // 4:H // 2, W // 3:2 * W // 3] = 255
    return np.clip(img + rng.randint(-20, 21, img.shape), 0, 255).astype(
        np.uint8)


AFFINE_CASES = {  # H, W, C, matrix (a dict: a draw about the centre), fill
    "identity": (16, 12, 1, [1, 0, 0, 0, 1, 0], 0),
    "rotate-left": (33, 33, 1, dict(angle=-4.7, shift=(0, 0), scale=1.0), 0),
    "rotate-shift-scale": (64, 64, 3,
                           dict(angle=3.1, shift=(5.5, -2.25), scale=0.97), 0),
    "shift-out-white": (31, 20, 3,
                        dict(angle=0.0, shift=(-15, 9), scale=1.0), 255),
    "zoom-grey-fill": (40, 64, 1,
                       dict(angle=-30.0, shift=(1.0, 1.0), scale=1.7), 128),
    "shrink": (25, 18, 3, dict(angle=12.0, shift=(0.3, 0.7), scale=0.55), 0),
    "shear-beyond": (20, 30, 3, [1.3, 0.4, -8.0, -0.2, 0.9, 6.5], 255),
    "flip-reach": (17, 23, 1, [-1.0, 0.05, 30.0, 0.1, -1.2, 25.0], 0),
}


@pytest.mark.parametrize("case", list(AFFINE_CASES))
def test_pil_affine_matches_pil(case):
    H, W, C, matrix, fill = AFFINE_CASES[case]
    rng = np.random.RandomState(len(case))
    img = _picture(rng, H, W, C)
    if isinstance(matrix, dict):
        matrix = inverse_affine_matrix((W * 0.5 + 0.5, H * 0.5 + 0.5),
                                       matrix["angle"], matrix["shift"],
                                       matrix["scale"])
    mode = "L" if C == 1 else "RGB"
    pil = Image.fromarray(img[..., 0] if C == 1 else img, mode)
    want = np.asarray(pil.transform(
        (W, H), Image.AFFINE, matrix, resample=Image.BILINEAR,
        fillcolor=fill if C == 1 else (fill,) * 3)).reshape(H, W, C)
    got = pil_affine(torch.from_numpy(img)[None],
                     torch.tensor([matrix], dtype=torch.float64), fill)[0]
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if case != "identity":
        assert not np.array_equal(want, img)  # the warp moved something


@pytest.mark.parametrize("affine", [
    dict(angle=4.2, shift=(0.0, 0.0), scale=1.0),
    dict(angle=-2.5, shift=(11.0, -3.5), scale=1.015)])
def test_image_inverse_is_apply_affines(affine):
    """The mask's matrix about the resized image's centre, as gfla_tpu's
    `apply_affine` builds it, through `pil_affine`: PIL's pixels."""
    H, W = 48, 40
    img = _picture(np.random.RandomState(3), H, W, 3)
    want = np.asarray(apply_affine(Image.fromarray(img), affine["angle"],
                                   affine["shift"], affine["scale"],
                                   fill=(0, 0, 0)))
    got = pil_affine(torch.from_numpy(img)[None],
                     torch.from_numpy(image_inverse((H, W), affine))[None])
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("masks") / "dance")
    chip_smoke.write_video_tree(root, "dance", 72, 56, 3, "cpu", seqs=SEQS,
                                frames=FRAMES, mask_formats=MASK_FORMATS)
    return root


def _opt(root, phase="train", **over):
    opt = argparse.Namespace(
        dataroot=root, phase=phase, isTrain=phase == "train",
        load_size=LOAD, n_frames_total=4, max_frames_per_gpu=2, max_t_step=2,
        n_frames_pre_load_test=3, start_frame=0, seed=7, use_mask=True,
        angle=None, shift=None, scale=None, old_size=None,
        sub_dataset="iper", no_device_encode=False, no_canny_edge=False,
        no_dist_map=False)
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def test_dance_masks_match_gfla_tpu(tree):
    """Each training sample's mask_all after the port's prepare_batch
    (B, T, 1, H, W) is gfla_tpu's (T, H, W, 1), bitwise, for each mask
    format, under the augmentation draws both datasets make alike."""
    want_ds = JaxDance(JaxDance.apply_defaults(_opt(tree), True))
    got_opt = DanceDataset.apply_defaults(_opt(tree), True)
    got_ds = DanceDataset(got_opt)
    assert got_opt.angle == (-5, 5)  # iPER's rotation draw
    for i in range(2 * SEQS):
        want = want_ds[i % SEQS]["mask_all"]
        got = prepare_batch(collate([got_ds[i % SEQS]]), "cpu", got_opt)
        mask = got["mask_all"]
        assert mask.dtype == torch.float32
        assert tuple(mask.shape) == (1, want.shape[0], 1, LOAD, LOAD)
        np.testing.assert_array_equal(mask[0].permute(0, 2, 3, 1).numpy(),
                                      want, err_msg=f"sample {i}")
        assert 0.0 < want.mean() < 1.0 and np.unique(want).size > 2


@pytest.mark.parametrize("case", ["fashion", "test-phase", "face"])
def test_use_mask_is_ignored_where_gfla_tpu_ignores_it(tree, case):
    if case == "face":
        face = str(Path(tree).parent / "face")
        chip_smoke.write_video_tree(face, "face", 60, 80, 4, "cpu", seqs=1,
                                    frames=3)
        want = JaxFace(JaxFace.apply_defaults(_opt(face), True))[0]
        got = FaceDataset(FaceDataset.apply_defaults(_opt(face), True))[0]
    else:
        phase, over = (("train", dict(sub_dataset="fashion"))
                       if case == "fashion" else ("test", {}))
        want = JaxDance(JaxDance.apply_defaults(
            _opt(tree, phase, **over), phase == "train"))[0]
        got = DanceDataset(DanceDataset.apply_defaults(
            _opt(tree, phase, **over), phase == "train"))[0]
    assert "mask_all" not in want and "mask_all" not in got
