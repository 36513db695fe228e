"""Streaming max-correlation: the CUDA kernel and its plain twin.

Counterpart of gfla_tpu/ops/pallas_corr.py (`max_corr_pallas`): for every
target row t_j, the max over source rows of <s_i, t_j> and the first index
that reaches it, without the (Ns x Nt) correlation in memory. `max_corr`
launches csrc/max_corr.cu on a CUDA tensor and runs `max_corr_plain`, the
chunked scan of gfla_tpu's default path (losses/perceptual.py:66-115), on a
CPU tensor. Ties go to the first index in both, as in gfla_tpu.
"""

from __future__ import annotations

import torch

from gfla_tpu_torch.ops._build import (
    check_launch,
    load_library,
    on_kernel_device,
)

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it
# to show that the correctness loss went through the kernel).
launches = 0


def max_corr_plain(source_norm, target_norm, chunk: int = 2048):
    """Running (max, argmax) over source chunks of <s_i, t_j>:
    (B,Ns,C) x (B,Nt,C) -> (B,Nt) values and int64 source indices. Ties go
    to the first index: the first maximum within a chunk, a strict > across
    chunks."""
    B, Ns, _ = source_norm.shape
    cmax = amax = None
    for base in range(0, Ns, chunk):
        corr = source_norm[:, base:base + chunk] @ target_norm.transpose(1, 2)
        m, a = corr.max(dim=1)                                   # (B, Nt)
        a = a + base
        if cmax is None:
            cmax, amax = m, a
        else:
            take = m > cmax
            cmax = torch.where(take, m, cmax)
            amax = torch.where(take, a, amax)
    return cmax, amax


def _check_inputs(s, t):
    for name, x in (("source", s), ("target", t)):
        if x.dtype != torch.float32:
            raise TypeError(f"max_corr: the CUDA kernel takes float32, {name} "
                            f"is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"max_corr: {name} must be contiguous")
        if x.dim() != 3:
            raise ValueError(f"max_corr: {name} must be (B, N, C), got "
                             f"{tuple(x.shape)}")
    if t.device != s.device:
        raise ValueError(f"max_corr: target is on {t.device}, source on "
                         f"{s.device}")
    (B, Ns, C), (Bt, Nt, Ct) = s.shape, t.shape
    if (B, C) != (Bt, Ct):
        raise ValueError(f"max_corr: source {tuple(s.shape)} and target "
                         f"{tuple(t.shape)} differ in batch or channels")
    if min(B, Ns, Nt, C) < 1:
        raise ValueError("max_corr: empty input")
    if max(B * Ns, B * Nt) * C >= 2**31:
        raise ValueError("max_corr: tensor too large for 32-bit indexing")


def _launch(s, t):
    global launches
    _check_inputs(s, t)
    lib = load_library()
    B, Ns, C = s.shape
    Nt = t.shape[1]
    cmax = s.new_empty(B, Nt)
    amax = torch.empty(B, Nt, dtype=torch.int64, device=s.device)
    with torch.cuda.device(s.device):
        n_splits = lib.gfla_max_corr_splits(B, Ns, Nt)
        part_v = s.new_empty(n_splits * B * Nt)
        part_i = torch.empty(n_splits * B * Nt, dtype=torch.int32,
                             device=s.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gfla_max_corr(s.data_ptr(), t.data_ptr(), part_v.data_ptr(),
                                part_i.data_ptr(), cmax.data_ptr(),
                                amax.data_ptr(), B, Ns, Nt, C, n_splits,
                                stream)
    check_launch(lib, err, "max_corr")
    launches += 1
    return cmax, amax


def max_corr(source_norm, target_norm):
    """(B,Ns,C) x (B,Nt,C) -> (cmax (B,Nt) float32, argmax (B,Nt) int64):
    the kernel on CUDA tensors, `max_corr_plain` on CPU tensors."""
    if on_kernel_device(source_norm, "max_corr"):
        return _launch(source_norm, target_norm)
    return max_corr_plain(source_norm, target_norm)
