"""Adversarial GAN losses, nsgan | lsgan | hinge (counterpart of
gfla_tpu/losses/adversarial.py; the original's external_function.py:82-119).
`outputs` are raw discriminator logit maps; over row bands (the data x
spatial mode) each mean is the whole map's (`parallel.band_mean`)."""

from __future__ import annotations

import torch

from gfla_tpu_torch import parallel

_EPS = 1e-7


def adversarial_loss(outputs, is_real: bool, for_dis: bool = False,
                     gan_mode: str = "lsgan"):
    """Scalar GAN loss. lsgan: MSE against the 1/0 label. hinge: D
    mean(relu(1 -+ x)), G -mean(x). nsgan: BCE of sigmoid(outputs), as
    gfla_tpu computes it."""
    if gan_mode == "hinge":
        if for_dis:
            x = -outputs if is_real else outputs
            return parallel.band_mean(torch.relu(1.0 + x))
        return -parallel.band_mean(outputs)
    if gan_mode == "lsgan":
        label = 1.0 if is_real else 0.0
        return parallel.band_mean((outputs - label) ** 2)
    if gan_mode == "nsgan":
        p = torch.sigmoid(outputs).clamp(_EPS, 1.0 - _EPS)
        return -parallel.band_mean(torch.log(p) if is_real
                                   else torch.log(1.0 - p))
    raise NotImplementedError(f"gan mode [{gan_mode}] not implemented")
