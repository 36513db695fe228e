"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

On first CUDA use, every `gfla_tpu_torch/csrc/*.cu` is compiled for Hopper
(`sm_90a`), one nvcc process per source, all started together, and the
objects are linked into one shared library with a plain C interface under
`build/gfla_tpu_torch/` at the repo root. The file name carries a hash of the
sources, so an edited kernel is rebuilt and a current one is loaded as is.
Importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gfla_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (nvcc on PATH or /usr/local/cuda)")


def _sources():
    cu = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return cu, digest.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gfla_warp_fwd.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float, p]
    lib.gfla_warp_fwd.restype = i
    lib.gfla_warp_bwd_pos.argtypes = [p] * 12 + [i] * 6 + [ctypes.c_float, p]
    lib.gfla_warp_bwd_pos.restype = i
    lib.gfla_warp_bwd_w1.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.gfla_warp_bwd_w1.restype = i
    lib.gfla_warp_bwd_pos_scratch.argtypes = [i, i, i, i]
    lib.gfla_warp_bwd_pos_scratch.restype = ctypes.c_longlong
    lib.gfla_warp_bwd_w1_scratch.argtypes = [i, i, i, i]
    lib.gfla_warp_bwd_w1_scratch.restype = ctypes.c_longlong
    lib.gfla_max_corr_splits.argtypes = [i, i, i]
    lib.gfla_max_corr_splits.restype = i
    lib.gfla_max_corr.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.gfla_max_corr.restype = i
    lib.gfla_attn_math_fwd.argtypes = [p] * 9 + [i] * 4 + [ctypes.c_float, p]
    lib.gfla_attn_math_fwd.restype = i
    lib.gfla_attn_math_fwd_scratch.argtypes = [i, i, i, i]
    lib.gfla_attn_math_fwd_scratch.restype = ctypes.c_longlong
    lib.gfla_attn_math_bwd.argtypes = [p] * 11 + [i] * 4 + [ctypes.c_float,
                                                            p]
    lib.gfla_attn_math_bwd.restype = i
    lib.gfla_attn_math_bwd_scratch.argtypes = [i, i, i]
    lib.gfla_attn_math_bwd_scratch.restype = ctypes.c_longlong
    lib.gfla_cuda_error_string.argtypes = [i]
    lib.gfla_cuda_error_string.restype = ctypes.c_char_p
    return lib


def on_kernel_device(tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (its caller then runs the
    plain twin); raises for any other device."""
    if tensor.device.type == "cpu":
        return False
    if tensor.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tensor.device}")
    return True


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error: a refused launch never
    runs, and no later synchronize would report it."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.gfla_cuda_error_string(err).decode()}")


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of any failure.
    Returns their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
    return "".join(outs)


@functools.cache
def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library. With `verbose`,
    ptxas reports registers, shared memory and spills per kernel."""
    sources, digest = _sources()
    target = BUILD_DIR / f"libgfla_kernels_{digest}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        ptxas = ["-Xptxas", "-v"] if verbose else []
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
            objs = [Path(tmp_dir) / f"{src.stem}.o" for src in sources]
            out = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj),
                             str(src)] for src, obj in zip(sources, objs)])
            tmp = Path(tmp_dir) / target.name
            out += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              str(tmp), *map(str, objs)]])
            os.replace(tmp, target)  # atomic: concurrent builds race safely
        if verbose:
            print(out, end="")
            print(f"nvcc built {target.name} from {len(sources)} sources in "
                  f"{time.perf_counter() - t0:.1f} s")
    return _bind(ctypes.CDLL(str(target)))
