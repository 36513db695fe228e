"""Loss layer of the port (counterpart of gfla_tpu/losses)."""

from gfla_tpu_torch.losses.adversarial import adversarial_loss
from gfla_tpu_torch.losses.affine_reg import (
    AffineRegularizationLoss,
    MultiAffineRegularizationLoss,
)
from gfla_tpu_torch.losses.perceptual import (
    PerceptualCorrectness,
    gram_matrix,
    l1_loss,
    vgg_content_style_loss,
)

__all__ = [
    "adversarial_loss",
    "AffineRegularizationLoss",
    "MultiAffineRegularizationLoss",
    "PerceptualCorrectness",
    "gram_matrix",
    "l1_loss",
    "vgg_content_style_loss",
]
