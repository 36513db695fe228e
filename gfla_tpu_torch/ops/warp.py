"""Source stream of the fused local-attention warp: CUDA kernels + plain twins.

`warp_fwd` is the counterpart of gfla_tpu's `attn_warp_core`
(gfla_tpu/ops/pallas_warp.py:420-487), forward and backward. When an input
requires grad it runs through `WarpFunction`, whose forward is the forward
kernel (csrc/warp_fwd.cu), which then also stores the pre-activation hidden
layer hpre for the backward, and whose backward is `warp_bwd`: the two
backward kernels of csrc/warp_bwd.cu, which start from that hpre instead of
recomputing it. On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it runs the plain torch twin of the same
function (`warp_fwd_plain`, `warp_bwd_plain`). Nothing falls back from a
kernel to a plain version.

Layouts follow gfla_tpu: source (B,H,W,C); flow (B,H,W,2) as (x, y);
hidden_bt (B,H*W,D), the target-stream dense term including b1;
w1s (k*k*C, D), the source half of the first projection; w2 (D, k*k);
b2 (k*k,). Returns (B,H,W,C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gfla_tpu_torch.ops._build import (
    check_launch,
    load_library,
    on_kernel_device,
)
from gfla_tpu_torch.ops.block_extract import block_extract, patch_index

# Kernel launches since each count was last set to 0 (chip_smoke.py reads
# them to show that the serving and training paths went through the kernels).
launches = 0          # warp_fwd.cu
bwd_pos_launches = 0  # warp_bwd.cu, per-position kernel (+ dW2/db2 reduce)
bwd_w1_launches = 0   # warp_bwd.cu, dW1s kernel (+ its reduce)

MAX_D = 256      # one thread per hidden unit
MAX_C = 1024     # keeps the shared-memory tile within the 227 KB per block
KERNEL_SIZES = (1, 3, 5, 7)


def warp_fwd_plain(source, flow, hidden_bt, w1s, w2, b2, kernel_size: int,
                   negative_slope: float = 0.1, with_hpre: bool = False):
    """The kernel's function in plain torch: gather, blend, matmul, softmax,
    weighted sum. With `with_hpre`, (out, hpre): hpre (B*H*W, D) is the
    pre-activation hidden layer, which the backward starts from."""
    k = kernel_size
    B, H, W, C = source.shape
    blocks = block_extract(source, flow, k).reshape(B, H * W, k * k, C)
    hpre = blocks.reshape(B, H * W, k * k * C) @ w1s + hidden_bt
    hidden = F.leaky_relu(hpre, negative_slope)
    attn = torch.softmax(hidden @ w2 + b2, dim=-1)            # (B,HW,k²)
    out = torch.einsum("bnk,bnkc->bnc", attn, blocks) / float(k * k)
    out = out.reshape(B, H, W, C)
    return (out, hpre.reshape(B * H * W, -1)) if with_hpre else out


def block_extract_bwd(source, flow, d_blocks, k):
    """Transpose of block_extract: d_blocks (B,N,k²,C) -> d_source through
    the four clamped taps (edge bands fold onto the border, gfla_tpu's
    `_fold_pad`), and d_flow (B,H,W,2) = (d_wx, d_wy) from the fractional
    weights (pallas_warp.py:340-347)."""
    B, H, W, C = source.shape
    flat, wy, wx = patch_index(flow, H, W, k)                  # (B,H,W,k+1,k+1)
    patch = torch.gather(source.reshape(B, H * W, C), 1,
                         flat.reshape(B, -1, 1).expand(-1, -1, C))
    patch = patch.reshape(B, H, W, k + 1, k + 1, C)
    tl, tr = patch[..., :k, :k, :], patch[..., :k, 1:, :]
    bl, br = patch[..., 1:, :k, :], patch[..., 1:, 1:, :]
    db = d_blocks.reshape(B, H, W, k, k, C)
    wy = wy[..., None, None, None]
    wx = wx[..., None, None, None]
    d_wy = (db * ((1 - wx) * (bl - tl) + wx * (br - tr))).sum((3, 4, 5))
    d_wx = (db * ((1 - wy) * (tr - tl) + wy * (br - bl))).sum((3, 4, 5))
    d_patch = source.new_zeros(B, H, W, k + 1, k + 1, C)
    d_patch[..., :k, :k, :] += (1 - wy) * (1 - wx) * db
    d_patch[..., :k, 1:, :] += (1 - wy) * wx * db
    d_patch[..., 1:, :k, :] += wy * (1 - wx) * db
    d_patch[..., 1:, 1:, :] += wy * wx * db
    base = torch.arange(B, device=source.device)[:, None, None, None, None]
    d_source = source.new_zeros(B * H * W, C).index_add_(
        0, (flat + base * (H * W)).reshape(-1), d_patch.reshape(-1, C))
    return d_source.reshape(B, H, W, C), torch.stack([d_wx, d_wy], dim=-1)


def warp_bwd_pos_plain(source, flow, hidden_bt, w1s, w2, b2, g,
                       kernel_size: int, negative_slope: float = 0.1,
                       hpre=None):
    """What the per-position backward kernel computes, in plain torch:
    (d_source, d_flow, d_hidden_bt, dW2, db2), plus the block cotangents
    d_blocks (B,H*W,k*k,C) that the kernel keeps on chip. gfla_tpu's
    `_bwd_kernel` math (pallas_warp.py:286-347). Given the forward's `hpre`
    (B*H*W, D), as the kernel is, it starts from it (`hidden_bt` is then not
    read); without it, it recomputes hpre from the blocks, as gfla_tpu
    does."""
    k = kernel_size
    k2 = k * k
    B, H, W, C = source.shape
    N = H * W
    blocks = block_extract(source, flow, k).reshape(B, N, k2, C)
    if hpre is None:
        hpre = blocks.reshape(B, N, k2 * C) @ w1s + hidden_bt
    else:
        hpre = hpre.reshape(B, N, -1)
    hidden = F.leaky_relu(hpre, negative_slope)
    attn = torch.softmax(hidden @ w2 + b2, dim=-1)             # (B,N,k²)
    g = g.reshape(B, N, C)
    d_attn = torch.einsum("bnkc,bnc->bnk", blocks, g) / float(k2)
    d_logits = attn * (d_attn - (attn * d_attn).sum(-1, keepdim=True))
    dw2 = torch.einsum("bnd,bnk->dk", hidden, d_logits)
    db2 = d_logits.sum((0, 1))
    d_h = d_logits @ w2.t()
    d_hpre = torch.where(hpre >= 0, d_h, d_h * negative_slope)
    d_blocks = ((d_hpre @ w1s.t()).reshape(B, N, k2, C)
                + (attn / float(k2))[..., None] * g[:, :, None, :])
    d_source, d_flow = block_extract_bwd(source, flow, d_blocks, k)
    return d_source, d_flow, d_hpre, dw2, db2, d_blocks


def warp_bwd_w1_plain(source, flow, d_hpre, kernel_size: int):
    """What the dW1s kernel computes, in plain torch: sum over positions of
    block^T d_hpre -> (k*k*C, D)."""
    k = kernel_size
    B, H, W, C = source.shape
    blocks = block_extract(source, flow, k).reshape(B * H * W, k * k * C)
    return blocks.t() @ d_hpre.reshape(B * H * W, -1)


def warp_bwd_plain(source, flow, hidden_bt, w1s, w2, b2, g, kernel_size: int,
                   negative_slope: float = 0.1, hpre=None):
    """The backward in plain torch: (d_source, d_flow, d_hidden_bt, dW1s,
    dW2, db2), as gfla_tpu's `_core_bwd` returns them; from the forward's
    `hpre` when given (see `warp_bwd_pos_plain`)."""
    d_source, d_flow, d_hpre, dw2, db2, _ = warp_bwd_pos_plain(
        source, flow, hidden_bt, w1s, w2, b2, g, kernel_size, negative_slope,
        hpre)
    dw1s = warp_bwd_w1_plain(source, flow, d_hpre, kernel_size)
    return d_source, d_flow, d_hpre, dw1s, dw2, db2


def _check_kernel_inputs(source, flow, hidden, w1s, w2, b2, k, g=None):
    """`hidden` is hidden_bt (B, H*W, D) for the forward kernel and, with the
    cotangent g, the forward's hpre (B*H*W, D) for the backward."""
    hidden_name = "hidden_bt" if g is None else "hpre"
    tensors = {"source": source, "flow": flow, hidden_name: hidden,
               "w1s": w1s, "w2": w2, "b2": b2}
    if g is not None:
        tensors["g"] = g
    for name, t in tensors.items():
        if t.device != source.device:
            raise ValueError(f"warp: {name} is on {t.device}, source on "
                             f"{source.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"warp: the CUDA kernels take float32, "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"warp: {name} must be contiguous")
    if source.dim() != 4:
        raise ValueError(f"warp: source must be (B,H,W,C), got "
                         f"{tuple(source.shape)}")
    B, H, W, C = source.shape
    D = w1s.shape[-1]
    if k not in KERNEL_SIZES:
        raise ValueError(f"warp: kernel_size {k} not in {KERNEL_SIZES}")
    if not 1 <= D <= MAX_D or not 1 <= C <= MAX_C:
        raise ValueError(f"warp: the CUDA kernels take 1 <= D <= {MAX_D} "
                         f"and 1 <= C <= {MAX_C}, got D={D}, C={C}")
    if B * H * W * max(C, D) >= 2**31:
        raise ValueError("warp: tensor too large for 32-bit indexing")
    expected = {"flow": (B, H, W, 2),
                hidden_name: (B, H * W, D) if g is None else (B * H * W, D),
                "w1s": (k * k * C, D), "w2": (D, k * k), "b2": (k * k,)}
    if g is not None:
        expected["g"] = (B, H, W, C)
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"warp: {name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")


def _launch_fwd(source, flow, hidden_bt, w1s, w2, b2, k, slope,
                with_hpre=False):
    global launches
    _check_kernel_inputs(source, flow, hidden_bt, w1s, w2, b2, k)
    lib = load_library()
    B, H, W, C = source.shape
    D = w1s.shape[-1]
    out = torch.empty_like(source)
    hpre = source.new_empty(B * H * W, D) if with_hpre else None
    with torch.cuda.device(source.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gfla_warp_fwd(
            source.data_ptr(), flow.data_ptr(), hidden_bt.data_ptr(),
            w1s.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if hpre is None else hpre.data_ptr(), B, H, W, C, D, k,
            float(slope), stream)
    check_launch(lib, err, "warp_fwd")
    launches += 1
    return (out, hpre) if with_hpre else out


def _launch_bwd_pos(source, flow, hpre, w1s, w2, b2, g, k, slope):
    global bwd_pos_launches
    _check_kernel_inputs(source, flow, hpre, w1s, w2, b2, k, g)
    lib = load_library()
    B, H, W, C = source.shape
    N = B * H * W
    D = w1s.shape[-1]
    k2 = k * k
    d_source = torch.zeros_like(source)  # reduction target
    d_flow = torch.empty_like(flow)
    d_hpre = source.new_empty(B, H * W, D)
    dw2b2 = source.new_empty(D * k2 + k2)
    part = source.new_empty(lib.gfla_warp_bwd_pos_scratch(N, C, D, k))
    with torch.cuda.device(source.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gfla_warp_bwd_pos(
            source.data_ptr(), flow.data_ptr(), hpre.data_ptr(),
            w1s.data_ptr(), w2.data_ptr(), b2.data_ptr(), g.data_ptr(),
            d_source.data_ptr(), d_flow.data_ptr(), d_hpre.data_ptr(),
            part.data_ptr(), dw2b2.data_ptr(), B, H, W, C, D, k,
            float(slope), stream)
    check_launch(lib, err, "warp_bwd_pos")
    bwd_pos_launches += 1
    return (d_source, d_flow, d_hpre, dw2b2[:D * k2].view(D, k2),
            dw2b2[D * k2:])


def _launch_bwd_w1(source, flow, d_hpre, k):
    global bwd_w1_launches
    B, H, W, C = source.shape
    D = d_hpre.shape[-1]
    for name, t, shape in (("source", source, source.shape),
                           ("flow", flow, (B, H, W, 2)),
                           ("d_hpre", d_hpre, (B, H * W, D))):
        if (t.device != source.device or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"warp_bwd_w1: {name} must be a contiguous "
                             f"float32 {tuple(shape)} on {source.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if k not in KERNEL_SIZES or not 1 <= D <= MAX_D or not 1 <= C <= MAX_C:
        raise ValueError(f"warp_bwd_w1: kernel_size {k}, C={C}, D={D} out of "
                         f"range")
    lib = load_library()
    dw1s = source.new_empty(k * k * C, D)
    part = source.new_empty(lib.gfla_warp_bwd_w1_scratch(B * H * W, C, D, k))
    with torch.cuda.device(source.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gfla_warp_bwd_w1(
            source.data_ptr(), flow.data_ptr(), d_hpre.data_ptr(),
            part.data_ptr(), dw1s.data_ptr(), B, H, W, C, D, k, stream)
    check_launch(lib, err, "warp_bwd_w1")
    bwd_w1_launches += 1
    return dw1s


def warp_bwd_pos(source, flow, hpre, w1s, w2, b2, g, kernel_size: int,
                 negative_slope: float = 0.1):
    """Per-position backward kernel on CUDA tensors, plain version on CPU
    tensors: (d_source, d_flow, d_hidden_bt, dW2, db2) from the forward's
    hpre (B*H*W, D); g is (B,H,W,C)."""
    if on_kernel_device(source, "warp_bwd_pos"):
        return _launch_bwd_pos(source, flow, hpre, w1s, w2, b2, g,
                               kernel_size, negative_slope)
    return warp_bwd_pos_plain(source, flow, None, w1s, w2, b2, g,
                              kernel_size, negative_slope, hpre)[:5]


def warp_bwd_w1(source, flow, d_hpre, kernel_size: int):
    """dW1s kernel on CUDA tensors, plain version on CPU tensors."""
    if on_kernel_device(source, "warp_bwd_w1"):
        return _launch_bwd_w1(source, flow, d_hpre, kernel_size)
    return warp_bwd_w1_plain(source, flow, d_hpre, kernel_size)


def warp_bwd(source, flow, hpre, w1s, w2, b2, g, kernel_size: int,
             negative_slope: float = 0.1):
    """The backward from the forward's hpre (B*H*W, D): (d_source, d_flow,
    d_hidden_bt, dW1s, dW2, db2), through the two backward kernels on CUDA
    tensors, plain on CPU tensors."""
    d_source, d_flow, d_hpre, dw2, db2 = warp_bwd_pos(
        source, flow, hpre, w1s, w2, b2, g, kernel_size, negative_slope)
    dw1s = warp_bwd_w1(source, flow, d_hpre, kernel_size)
    return d_source, d_flow, d_hpre, dw1s, dw2, db2


def warp_fwd_with_hpre(source, flow, hidden_bt, w1s, w2, b2,
                       kernel_size: int, negative_slope: float = 0.1):
    """(out, hpre): the forward kernel, which also stores the pre-activation
    hidden layer hpre (B*H*W, D), on CUDA tensors (one launch); the plain
    version on CPU tensors."""
    if on_kernel_device(source, "warp_fwd"):
        return _launch_fwd(source, flow, hidden_bt, w1s, w2, b2, kernel_size,
                           negative_slope, with_hpre=True)
    return warp_fwd_plain(source, flow, hidden_bt, w1s, w2, b2, kernel_size,
                          negative_slope, with_hpre=True)


class WarpFunction(torch.autograd.Function):
    """The warp with its hand-written backward: forward `warp_fwd_with_hpre`
    (kernel, or plain twin on the CPU), which saves hpre in place of
    hidden_bt; backward `warp_bwd` from that hpre. Counterpart of the custom
    VJP `attn_warp_core` (pallas_warp.py:420-487), whose backward recomputes
    hpre."""

    @staticmethod
    def forward(ctx, source, flow, hidden_bt, w1s, w2, b2, kernel_size,
                negative_slope):
        inputs = [t.contiguous() for t in (source, flow, hidden_bt, w1s, w2,
                                           b2)]
        out, hpre = warp_fwd_with_hpre(*inputs, kernel_size, negative_slope)
        source, flow, _, w1s, w2, b2 = inputs
        ctx.save_for_backward(source, flow, hpre, w1s, w2, b2)
        ctx.kernel_size = kernel_size
        ctx.negative_slope = negative_slope
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = warp_bwd(*ctx.saved_tensors, g.contiguous(), ctx.kernel_size,
                         ctx.negative_slope)
        return (*grads, None, None)


def warp_fwd(source, flow, hidden_bt, w1s, w2, b2, kernel_size: int,
             negative_slope: float = 0.1):
    """Kernel on CUDA tensors, plain version on CPU tensors. Differentiable:
    when grad is on and an input requires it, the call goes through
    `WarpFunction`, whose backward is `warp_bwd`."""
    tensors = (source, flow, hidden_bt, w1s, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return WarpFunction.apply(*tensors, kernel_size, negative_slope)
    if on_kernel_device(source, "warp_fwd"):
        return _launch_fwd(*tensors, kernel_size, negative_slope)
    return warp_fwd_plain(*tensors, kernel_size, negative_slope)
