"""Device selection (one device, or the devices of a host's ranks), the
float32 math policy and the card line."""

from __future__ import annotations

import contextlib
import shutil
import subprocess
from typing import List

import torch


def select_devices(gpu_ids: str, mesh_devices: int = 0
                   ) -> List[torch.device]:
    """The devices of this host's ranks. `--gpu_ids` lists CUDA ids (the
    original GFLA's multi-GPU interface) or -1 for the CPU;
    `--mesh_devices=N` (gfla_tpu's) takes the first N listed ids, or
    cuda:0..N-1 when one id is listed, as gfla_tpu's mesh takes the first N
    devices; 0 takes every listed id. On the CPU, N ranks share it. Asking
    for CUDA where there is none, or for more cards than there are, raises:
    the port never moves to the CPU on its own."""
    ids = [int(x) for x in str(gpu_ids).split(",") if x.strip()]
    if mesh_devices < 0:
        raise ValueError(f"--mesh_devices={mesh_devices}")
    if not ids or ids[0] < 0:
        return [torch.device("cpu")] * max(1, mesh_devices)
    if mesh_devices > len(ids) > 1:
        raise RuntimeError(f"--mesh_devices={mesh_devices} asks for more "
                           f"cards than --gpu_ids={gpu_ids} lists")
    if mesh_devices > len(ids):
        ids = list(range(mesh_devices))
    elif mesh_devices:
        ids = ids[:mesh_devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--gpu_ids={gpu_ids} asks for cuda:{ids[0]}, but CUDA is not "
            "available; pass --gpu_ids=-1 to run on the CPU")
    count = torch.cuda.device_count()
    if max(ids) >= count or len(set(ids)) < len(ids):
        raise RuntimeError(f"--gpu_ids={gpu_ids} --mesh_devices="
                           f"{mesh_devices} asks for cuda:{ids}; there are "
                           f"{count} CUDA device(s)")
    return [torch.device("cuda", i) for i in ids]


def select_device(gpu_ids: str) -> torch.device:
    """--gpu_ids semantics for one device: -1 is the CPU, N (or the first
    of a list) is cuda:N."""
    return select_devices(gpu_ids)[0]


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
