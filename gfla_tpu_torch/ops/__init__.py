"""Tensor ops of the port: plain-torch composites and the CUDA kernel
wrappers beside them."""

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """gfla_tpu's accumulation type (`_acc`, losses/perceptual.py:29-32):
    f32 for bf16 and f32 values, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)
