"""Tensor ops of the port: plain-torch composites and the CUDA kernel
wrappers beside them."""

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """gfla_tpu's accumulation type (`_acc`, losses/perceptual.py:29-32):
    f32 for bf16 and f32 values, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def widen(x: torch.Tensor) -> torch.Tensor:
    """bf16 values widened to f32, exactly; other types as they are."""
    return x.float() if x.dtype == torch.bfloat16 else x


def at_bf16(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to bf16 (held in f32) when a kernel computes in bf16
    (`dtype`), at a point where gfla_tpu's bf16 kernel body rounds; x itself
    otherwise."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x
