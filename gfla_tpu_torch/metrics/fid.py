"""FID, the Frechet Inception Distance (gfla_tpu/metrics/fid.py): Inception
pool3 features of the generated and the real images, their mean and
covariance (the real set's cached as statistics.npz beside it), and the
Frechet distance by scipy's matrix square root in float64 on the host.

Each image is decoded on the device (nvJPEG on the card), resized to
299x299 by PIL's bilinear arithmetic (`resample.pil_resize`, bitwise
PIL's), scaled to [0, 1] and run through the network in batches. gfla_tpu
pads its last batch with zero images to keep one compiled shape and drops
their features; the network is in inference mode, so the padding changes
no feature, and the port leaves it out.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Sequence

import numpy as np
import torch
from scipy import linalg

from gfla_tpu_torch.data.image_io import read_images
from gfla_tpu_torch.data.resample import pil_resize
from gfla_tpu_torch.metrics.inception import load_inception_params
from gfla_tpu_torch.metrics.reconstruction import get_image_list
from gfla_tpu_torch.runtime import select_device, tf32_off

SIZE = 299


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # gfla_tpu passes disp=False, which SciPy 1.18 removed; the matrix is
    # the same either way
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            warnings.warn(f"FID sqrtm has imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


class FID:
    """gfla_tpu's FID class (fid.py:47-130) on `device`: the first card
    unless given, f32 with TF32 off."""

    def __init__(self, batch_size: int = 64, allow_fallback: bool = False,
                 device=None):
        self.batch_size = batch_size
        self.device = select_device("0") if device is None \
            else torch.device(device)
        net, self.has_weights = load_inception_params()
        self.net = net.to(self.device)
        self.fallback = not self.has_weights
        if self.fallback:
            msg = ("inception_v3.npz asset missing — FID values would use a "
                   "deterministic random feature net and are NOT comparable "
                   "to published numbers. Run "
                   "scripts/convert_inception_weights.py once.")
            if not allow_fallback:
                raise RuntimeError(
                    msg + " Pass --allow_fallback_weights (CLI) or "
                    "allow_fallback=True to proceed anyway; outputs will "
                    "be stamped FALLBACK-WEIGHTS.")
            warnings.warn(msg)

    @torch.no_grad()
    def features(self, images: Sequence[torch.Tensor]) -> torch.Tensor:
        """uint8 (H, W, 3) images on the device -> (B, 2048) float32: PIL's
        bilinear resize to 299x299, / 255, the network."""
        x = torch.stack([pil_resize(img, (SIZE, SIZE)) for img in images])
        x = (x.float() / 255.0).permute(0, 3, 1, 2)
        with tf32_off():
            return self.net(x)

    def get_activations(self, image_list: List[str],
                        verbose=False) -> np.ndarray:
        acts = []
        bs = self.batch_size
        for s in range(0, len(image_list), bs):
            chunk = image_list[s:s + bs]
            acts.append(self.features(read_images(chunk, self.device))
                        .cpu().numpy())
            if verbose:
                print(f"\rFID activations {s + len(chunk)}/{len(image_list)}",
                      end="", flush=True)
        if verbose:
            print()
        return np.concatenate(acts)

    def calculate_activation_statistics(self, image_list, verbose=False):
        act = self.get_activations(image_list, verbose)
        return act.mean(axis=0), np.cov(act, rowvar=False)

    def compute_statistics_of_path(self, path: str, verbose=False,
                                   cache: bool = True):
        """The real set's statistics, cached as statistics.npz in its
        directory and read from there when present."""
        npz = os.path.join(path, "statistics.npz") if os.path.isdir(path) \
            else None
        if npz and os.path.exists(npz):
            with np.load(npz) as f:
                return f["mu"], f["sigma"]
        mu, sigma = self.calculate_activation_statistics(
            sorted(get_image_list(path)), verbose)
        if npz and cache:
            try:
                np.savez(npz, mu=mu, sigma=sigma)
            except OSError:
                pass
        return mu, sigma

    def calculate_from_disk(self, generated_path: str, gt_path: str,
                            verbose: bool = True) -> float:
        m1, s1 = self.compute_statistics_of_path(gt_path, verbose)
        m2, s2 = self.calculate_activation_statistics(
            sorted(get_image_list(generated_path)), verbose)
        fid = calculate_frechet_distance(m1, s1, m2, s2)
        if verbose:
            print(f"FID: {fid:.4f}")
        return fid
