"""Device selection, float32 math policy and the card line."""

from __future__ import annotations

import contextlib
import shutil
import subprocess

import torch


def select_device(gpu_ids: str) -> torch.device:
    """--gpu_ids semantics: -1 is the CPU, N is cuda:N. Asking for CUDA where
    there is none raises; the port never moves to the CPU on its own."""
    ids = [int(x) for x in str(gpu_ids).split(",") if x.strip()]
    if not ids or ids[0] < 0:
        return torch.device("cpu")
    if len(ids) > 1:
        raise NotImplementedError(
            f"--gpu_ids={gpu_ids}: the port runs on one device; multi-GPU is "
            "not ported yet")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--gpu_ids={gpu_ids} asks for cuda:{ids[0]}, but CUDA is not "
            "available; pass --gpu_ids=-1 to run on the CPU")
    if ids[0] >= torch.cuda.device_count():
        raise RuntimeError(f"--gpu_ids={gpu_ids}: only "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", ids[0])


def set_tf32(enabled: bool) -> None:
    """Set both TF32 switches explicitly: cuBLAS matmuls default to full
    float32 but cuDNN convolutions default to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


@contextlib.contextmanager
def tf32_off():
    """Both TF32 switches off inside the block, restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    set_tf32(False)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, one line per card."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    proc = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (proc.stdout or proc.stderr).strip()
