"""Source stream of the fused local-attention warp: CUDA kernel + plain twin.

`warp_fwd` is the counterpart of gfla_tpu's `attn_warp_core` forward
(gfla_tpu/ops/pallas_warp.py:421-453). On a CUDA tensor it launches the
hand-written kernel in `csrc/warp_fwd.cu`, or raises; on a CPU tensor it runs
`warp_fwd_plain`, the same function in plain torch. It never falls back from
the kernel to the plain version.

Layouts follow gfla_tpu: source (B,H,W,C); flow (B,H,W,2) as (x, y);
hidden_bt (B,H*W,D), the target-stream dense term including b1;
w1s (k*k*C, D), the source half of the first projection; w2 (D, k*k);
b2 (k*k,). Returns (B,H,W,C).
"""

from __future__ import annotations

import torch

from gfla_tpu_torch.ops.block_extract import block_extract

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it to
# show that the serving path went through the kernel).
launches = 0

MAX_D = 256      # one thread per hidden unit
MAX_C = 1024     # keeps the shared-memory tile within the 227 KB per block
KERNEL_SIZES = (1, 3, 5, 7)


def warp_fwd_plain(source, flow, hidden_bt, w1s, w2, b2, kernel_size: int,
                   negative_slope: float = 0.1):
    """The kernel's function in plain torch: gather, blend, matmul, softmax,
    weighted sum."""
    k = kernel_size
    B, H, W, C = source.shape
    blocks = block_extract(source, flow, k).reshape(B, H * W, k * k, C)
    hidden = blocks.reshape(B, H * W, k * k * C) @ w1s + hidden_bt
    hidden = torch.nn.functional.leaky_relu(hidden, negative_slope)
    attn = torch.softmax(hidden @ w2 + b2, dim=-1)            # (B,HW,k²)
    out = torch.einsum("bnk,bnkc->bnc", attn, blocks) / float(k * k)
    return out.reshape(B, H, W, C)


def _check_kernel_inputs(source, flow, hidden_bt, w1s, w2, b2, k):
    tensors = dict(source=source, flow=flow, hidden_bt=hidden_bt, w1s=w1s,
                   w2=w2, b2=b2)
    for name, t in tensors.items():
        if t.device != source.device:
            raise ValueError(f"warp_fwd: {name} is on {t.device}, source on "
                             f"{source.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"warp_fwd: the CUDA kernel takes float32, "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"warp_fwd: {name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise NotImplementedError(
            "warp_fwd: the CUDA kernel is forward-only (serving); its "
            "backward kernel and autograd.Function come with the training "
            "slice (ROADMAP.md queue 1). Run under torch.inference_mode() "
            "or torch.no_grad().")
    if source.dim() != 4:
        raise ValueError(f"warp_fwd: source must be (B,H,W,C), got "
                         f"{tuple(source.shape)}")
    B, H, W, C = source.shape
    D = w1s.shape[-1]
    if k not in KERNEL_SIZES:
        raise ValueError(f"warp_fwd: kernel_size {k} not in {KERNEL_SIZES}")
    if not 1 <= D <= MAX_D or not 1 <= C <= MAX_C:
        raise ValueError(f"warp_fwd: the CUDA kernel takes 1 <= D <= {MAX_D} "
                         f"and 1 <= C <= {MAX_C}, got D={D}, C={C}")
    if B * H * W * max(C, D) >= 2**31:
        raise ValueError("warp_fwd: tensor too large for 32-bit indexing")
    expected = dict(flow=(B, H, W, 2), hidden_bt=(B, H * W, D),
                    w1s=(k * k * C, D), w2=(D, k * k), b2=(k * k,))
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"warp_fwd: {name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")


def warp_fwd(source, flow, hidden_bt, w1s, w2, b2, kernel_size: int,
             negative_slope: float = 0.1):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    global launches
    if source.device.type == "cpu":
        return warp_fwd_plain(source, flow, hidden_bt, w1s, w2, b2,
                              kernel_size, negative_slope)
    if source.device.type != "cuda":
        raise ValueError(f"warp_fwd: no kernel for device {source.device}")
    _check_kernel_inputs(source, flow, hidden_bt, w1s, w2, b2, kernel_size)
    from gfla_tpu_torch.ops._build import load_library

    lib = load_library()
    B, H, W, C = source.shape
    out = torch.empty_like(source)
    with torch.cuda.device(source.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gfla_warp_fwd(
            source.data_ptr(), flow.data_ptr(), hidden_bt.data_ptr(),
            w1s.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            B, H, W, C, w1s.shape[-1], kernel_size, float(negative_slope),
            stream)
    if err != 0:
        raise RuntimeError(f"warp_fwd kernel launch failed: "
                           f"{lib.gfla_cuda_error_string(err).decode()}")
    launches += 1
    return out
