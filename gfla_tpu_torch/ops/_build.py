"""Build the package's CUDA sources with nvcc and bind them with ctypes.

On first CUDA use, every `gfla_tpu_torch/csrc/*.cu` is compiled for Hopper
(`sm_90a`), one nvcc process per source, all started together (the bf16
instances, `warp_*_bf16.cu` and `attn_math_*_bf16.cu`, are sources of their
own), and the
objects are linked into one shared library with a plain C interface under
`build/gfla_tpu_torch/` at the repo root. `csrc/jpeg_nvjpeg.cpp`, host code
that calls nvJPEG, is built beside it into a library of its own, linked with
the toolkit's `-lnvjpeg`, so that the kernels never need nvJPEG. Each file
name carries a hash of its sources, so an edited source is rebuilt and a
current one is loaded as is. The ranks of a data-parallel run share the
build directory: the first to need a library builds it under a file lock
while the others wait on the lock, then load what it built, so a host runs
one batch of nvcc processes, not one a rank (a collective would hang: the
first kernel call can come inside rank 0's evaluation, which the other
ranks skip). Importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import fcntl
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
    for suffix in ("", "_bf16"):  # warp_*.cu and their bf16 instances
        fwd = getattr(lib, f"gfla_warp_fwd{suffix}")
        fwd.argtypes = [p] * 9 + [i] * 6 + [ctypes.c_float, p]
        pos = getattr(lib, f"gfla_warp_bwd_pos{suffix}")
        pos.argtypes = [p] * 12 + [i] * 6 + [ctypes.c_float, p]
        w1 = getattr(lib, f"gfla_warp_bwd_w1{suffix}")
        w1.argtypes = [p] * 5 + [i] * 6 + [p]
        for fn in (fwd, pos, w1):
            fn.restype = i
    lib.gfla_warp_fwd_scratch.argtypes = [i, i]
    lib.gfla_warp_fwd_scratch.restype = ctypes.c_longlong
    lib.gfla_warp_bwd_pos_scratch.argtypes = [i, i, i, i]
    lib.gfla_warp_bwd_pos_scratch.restype = ctypes.c_longlong
    lib.gfla_warp_bwd_w1_scratch.argtypes = [i, i, i, i]
    lib.gfla_warp_bwd_w1_scratch.restype = ctypes.c_longlong
    lib.gfla_max_corr_splits.argtypes = [i, i, i]
    lib.gfla_max_corr_splits.restype = i
    lib.gfla_max_corr.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.gfla_max_corr.restype = i
    for suffix in ("", "_bf16"):  # attn_math_*.cu and their bf16 instances
        fwd = getattr(lib, f"gfla_attn_math_fwd{suffix}")
        fwd.argtypes = [p] * 9 + [i] * 4 + [ctypes.c_float, p]
        bwd = getattr(lib, f"gfla_attn_math_bwd{suffix}")
        bwd.argtypes = [p] * 11 + [i] * 4 + [ctypes.c_float, p]
        fwd.restype = bwd.restype = i
    lib.gfla_attn_math_fwd_scratch.argtypes = [i, i, i, i]
    lib.gfla_attn_math_fwd_scratch.restype = ctypes.c_longlong
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


JPEG_SOURCE = CSRC / "jpeg_nvjpeg.cpp"


def _jpeg_target() -> Path:
    digest = hashlib.sha256(JPEG_SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgfla_jpeg_{digest}.so"


def build(verbose: bool = False, kernels: bool = True,
          jpeg: bool = True) -> None:
    """Compile what is missing of the kernel library and (with `jpeg`) the
    nvJPEG library, every nvcc process started together. With `verbose`,
    ptxas reports registers, shared memory and spills per kernel."""
    sources, digest = _sources()
    kernel_target = BUILD_DIR / f"libgfla_kernels_{digest}.so"
    jpeg_target = _jpeg_target()
    if not (kernels and not kernel_target.exists()
            or jpeg and not jpeg_target.exists()):
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        # another process may have built them while this one waited
        _build_missing(sources, kernel_target, jpeg_target,
                       kernels and not kernel_target.exists(),
                       jpeg and not jpeg_target.exists(), verbose)


def _build_missing(sources, kernel_target: Path, jpeg_target: Path,
                   kernels: bool, jpeg: bool, verbose: bool) -> None:
    if not (kernels or jpeg):
        return
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = Path(tmp_dir)
        objs = [tmp / f"{src.stem}.o" for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)] if kernels else []
        if jpeg:
            lib_dir = Path(nvcc).resolve().parents[1] / "lib64"
            cmds.append([nvcc, "-std=c++17", "-O2", "-Xcompiler", "-fPIC",
                         "-shared", "-o", str(tmp / jpeg_target.name),
                         str(JPEG_SOURCE), f"-L{lib_dir}", "-lnvjpeg",
                         "-Xlinker", f"-rpath={lib_dir}"])
        out = _run_all(cmds)
        if kernels:
            out += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              str(tmp / kernel_target.name),
                              *map(str, objs)]])
            # atomic: concurrent builds race safely
            os.replace(tmp / kernel_target.name, kernel_target)
        if jpeg:
            os.replace(tmp / jpeg_target.name, jpeg_target)
    if verbose:
        print(out, end="")
        built = ([f"{kernel_target.name} from {len(sources)} sources"]
                 if kernels else []) + ([jpeg_target.name] if jpeg else [])
        print(f"nvcc built {' and '.join(built)} in "
              f"{time.perf_counter() - t0:.1f} s")


@functools.cache
def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    build(verbose, jpeg=False)
    return _bind(ctypes.CDLL(str(BUILD_DIR / (
        f"libgfla_kernels_{_sources()[1]}.so"))))


def _bind_jpeg(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    size_p, int_p = ctypes.POINTER(size), ctypes.POINTER(i)
    lib.gfla_jpeg_create.argtypes = [ctypes.POINTER(p)]
    lib.gfla_jpeg_info.argtypes = [p, p, size, int_p, int_p, int_p, int_p]
    lib.gfla_jpeg_decode.argtypes = [p, p, size, i, p, p, p, i, i, i, p]
    lib.gfla_jpeg_encode.argtypes = [p, p, i, i, i, p, size_p]
    lib.gfla_jpeg_encode_fetch.argtypes = [p, p, size_p, p]
    for fn in (lib.gfla_jpeg_create, lib.gfla_jpeg_info, lib.gfla_jpeg_decode,
               lib.gfla_jpeg_encode, lib.gfla_jpeg_encode_fetch):
        fn.restype = i
    lib.gfla_jpeg_constants.argtypes = [int_p]
    lib.gfla_jpeg_constants.restype = None
    lib.gfla_jpeg_cuda_error_string.argtypes = [i]
    lib.gfla_jpeg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_jpeg_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the nvJPEG library; raises if the
    toolkit has no nvJPEG to link."""
    build(verbose, kernels=False)
    return _bind_jpeg(ctypes.CDLL(str(_jpeg_target())))
