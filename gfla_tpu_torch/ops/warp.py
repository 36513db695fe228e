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

The kernels take every kernel size k >= 1, as gfla_tpu's Pallas warp does
(`fused_warp_eligible`, pallas_warp.py:56-89, sets no limit on k): compiled
instances for k = 3 and 5, a run-time-k instance for the other k up to 9,
and from k = WIDE_K the wide instances, which keep nothing sized by k on
chip (each wrapper counts their launches apart).

Layouts follow gfla_tpu: source (B,H,W,C); flow (B,H,W,2) as (x, y);
hidden_bt (B,H*W,D), the target-stream dense term including b1;
w1s (k*k*C, D), the source half of the first projection; w2 (D, k*k);
b2 (k*k,). Returns (B,H,W,C).

Element types follow gfla_tpu's `_compute_dtype` (pallas_warp.py:435-438):
a float32 source runs the f32 kernels, a bfloat16 source their bf16
instances (csrc/warp_fwd_bf16.cu, csrc/warp_bwd_bf16.cu), which read the
source, g and W2 in bf16, round to bf16 where gfla_tpu's kernel body does
and accumulate in f32; the wrapper hands them W1s widened to f32. W1s and W2
are in the source's type; flow, b2 and hidden_bt are taken in f32, as
gfla_tpu's `_core_fwd` casts them, and hpre is f32. The plain twins round at
the same points. The backward's outputs are f32, as the kernels leave them;
`WarpFunction` casts each gradient to its input's type, as `_core_bwd` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gfla_tpu_torch.ops import at_bf16, widen
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
bf16_launches = 0          # warp_fwd_bf16.cu
bf16_bwd_pos_launches = 0  # warp_bwd_bf16.cu, per-position kernel
bf16_bwd_w1_launches = 0   # warp_bwd_bf16.cu, dW1s kernel
# ... and of the wide instances (k >= WIDE_K), in the same sources
wide_launches = wide_bwd_pos_launches = wide_bwd_w1_launches = 0
bf16_wide_launches = bf16_wide_bwd_pos_launches = 0
bf16_wide_bwd_w1_launches = 0

MAX_D = 256      # one thread per hidden unit
MAX_C = 1024     # keeps the shared-memory tile within the 227 KB per block
WIDE_K = 10      # the wide instances take k from here up
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _blocks(source, flow, k):
    """The blended blocks (B,H*W,k*k,C): blended in f32 from the widened
    source (gfla_tpu's `_prep` pads it in f32), rounded to the source's type
    (pallas_warp.py:183)."""
    B, H, W, C = source.shape
    return at_bf16(block_extract(widen(source), widen(flow), k),
                   source.dtype).reshape(B, H * W, k * k, C)


def warp_fwd_plain(source, flow, hidden_bt, w1s, w2, b2, kernel_size: int,
                   negative_slope: float = 0.1, with_hpre: bool = False):
    """The kernel's function in plain torch: gather, blend, matmul, softmax,
    weighted sum. With `with_hpre`, (out, hpre): hpre (B*H*W, D) is the
    pre-activation hidden layer, which the backward starts from. A bf16
    source rounds the blocks, the hidden layer before W2 and the attention
    weights to bf16 (pallas_warp.py:183-200); products of those bf16 values
    are summed in f32, and the output is bf16."""
    k = kernel_size
    B, H, W, C = source.shape
    cdt = source.dtype
    blocks = _blocks(source, flow, k)
    hpre = blocks.reshape(B, H * W, k * k * C) @ widen(w1s) + hidden_bt
    hidden = F.leaky_relu(hpre, negative_slope)
    attn = torch.softmax(at_bf16(hidden, cdt) @ widen(w2) + widen(b2),
                         dim=-1)                              # (B,HW,k²)
    out = torch.einsum("bnk,bnkc->bnc", at_bf16(attn, cdt),
                       blocks) / float(k * k)
    out = out.reshape(B, H, W, C).to(cdt)
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
    does. A bf16 source rounds g, the hidden layer before W2, d_logits
    before W2^T, d_hpre and d_blocks to bf16 (pallas_warp.py:286-319, 467);
    the outputs are f32."""
    k = kernel_size
    k2 = k * k
    B, H, W, C = source.shape
    N = H * W
    cdt = source.dtype
    w1s, w2 = widen(w1s), widen(w2)
    blocks = _blocks(source, flow, k)
    if hpre is None:
        hpre = blocks.reshape(B, N, k2 * C) @ w1s + hidden_bt
    else:
        hpre = hpre.reshape(B, N, -1)
    hidden = F.leaky_relu(hpre, negative_slope)
    attn = torch.softmax(at_bf16(hidden, cdt) @ w2 + widen(b2),
                         dim=-1)                               # (B,N,k²)
    g = at_bf16(widen(g), cdt).reshape(B, N, C)
    d_attn = torch.einsum("bnkc,bnc->bnk", blocks, g) / float(k2)
    d_logits = attn * (d_attn - (attn * d_attn).sum(-1, keepdim=True))
    dw2 = torch.einsum("bnd,bnk->dk", hidden, d_logits)
    db2 = d_logits.sum((0, 1))
    d_h = at_bf16(d_logits, cdt) @ w2.t()
    d_hpre = at_bf16(torch.where(hpre >= 0, d_h, d_h * negative_slope), cdt)
    d_blocks = at_bf16((d_hpre @ w1s.t()).reshape(B, N, k2, C)
                       + (attn / float(k2))[..., None] * g[:, :, None, :],
                       cdt)
    d_source, d_flow = block_extract_bwd(widen(source), widen(flow), d_blocks,
                                         k)
    return d_source, d_flow, d_hpre, dw2, db2, d_blocks


def warp_bwd_w1_plain(source, flow, d_hpre, kernel_size: int):
    """What the dW1s kernel computes, in plain torch: sum over positions of
    block^T d_hpre -> (k*k*C, D), f32 (the blocks in the source's type)."""
    k = kernel_size
    B, H, W, C = source.shape
    blocks = _blocks(source, flow, k).reshape(B * H * W, k * k * C)
    return blocks.t() @ widen(d_hpre).reshape(B * H * W, -1)


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


def _check_sizes(name, N, C, D, k):
    """What every warp kernel takes: any k >= 1, C and D within the
    kernels' tiles, and every tensor and scratch they index (N x C, N x D,
    N x (k+1)^2, k^2 C x D) within 32-bit indexing."""
    if k < 1:
        raise ValueError(f"{name}: kernel_size must be >= 1, got {k}")
    if not 1 <= D <= MAX_D or not 1 <= C <= MAX_C:
        raise ValueError(f"{name}: the CUDA kernels take 1 <= D <= {MAX_D} "
                         f"and 1 <= C <= {MAX_C}, got D={D}, C={C}")
    if N * max(C, D, (k + 1) ** 2) >= 2**31 or k * k * C * D >= 2**31:
        raise ValueError(f"{name}: tensor too large for 32-bit indexing")


def _count(name, bf16, k):
    """Adds one to the launch count of kernel `name` ("", "bwd_pos_",
    "bwd_w1_") in its type and instance."""
    counter = (("bf16_" if bf16 else "") + ("wide_" if k >= WIDE_K else "")
               + name + "launches")
    globals()[counter] += 1


def _check_kernel_inputs(source, flow, hidden, w1s, w2, b2, k, g=None):
    """`hidden` is hidden_bt (B, H*W, D) for the forward kernel and, with the
    cotangent g, the forward's hpre (B*H*W, D) for the backward. The source
    is float32 or bfloat16; W1s, W2 and g are in its type; flow, b2 and
    hidden_bt or hpre are float32."""
    hidden_name = "hidden_bt" if g is None else "hpre"
    tensors = {"source": source, "flow": flow, hidden_name: hidden,
               "w1s": w1s, "w2": w2, "b2": b2}
    if g is not None:
        tensors["g"] = g
    if source.dtype not in KERNEL_DTYPES:
        raise TypeError(f"warp: the CUDA kernels take a float32 or bfloat16 "
                        f"source, got {source.dtype}")
    for name, t in tensors.items():
        if t.device != source.device:
            raise ValueError(f"warp: {name} is on {t.device}, source on "
                             f"{source.device}")
        want = (source.dtype if name in ("source", "w1s", "w2", "g")
                else torch.float32)
        if t.dtype != want:
            raise TypeError(f"warp: with a {source.dtype} source the CUDA "
                            f"kernels take {name} in {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"warp: {name} must be contiguous")
    if source.dim() != 4:
        raise ValueError(f"warp: source must be (B,H,W,C), got "
                         f"{tuple(source.shape)}")
    B, H, W, C = source.shape
    D = w1s.shape[-1]
    _check_sizes("warp", B * H * W, C, D, k)
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
    _check_kernel_inputs(source, flow, hidden_bt, w1s, w2, b2, k)
    lib = load_library()
    B, H, W, C = source.shape
    D = w1s.shape[-1]
    out = torch.empty_like(source)
    hpre = hidden_bt.new_empty(B * H * W, D) if with_hpre else None
    n_scratch = lib.gfla_warp_fwd_scratch(B * H * W, k)  # the wide logits
    scratch = hidden_bt.new_empty(n_scratch) if n_scratch else None
    bf16 = source.dtype == torch.bfloat16
    entry = lib.gfla_warp_fwd_bf16 if bf16 else lib.gfla_warp_fwd
    w1s = widen(w1s)  # the kernels' W1s ring is f32; the values stay bf16
    with torch.cuda.device(source.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(
            source.data_ptr(), flow.data_ptr(), hidden_bt.data_ptr(),
            w1s.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if hpre is None else hpre.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, H, W, C, D,
            k, float(slope), stream)
    check_launch(lib, err, "warp_fwd")
    _count("", bf16, k)
    return (out, hpre) if with_hpre else out


def _launch_bwd_pos(source, flow, hpre, w1s, w2, b2, g, k, slope):
    _check_kernel_inputs(source, flow, hpre, w1s, w2, b2, k, g)
    lib = load_library()
    bf16 = source.dtype == torch.bfloat16
    entry = lib.gfla_warp_bwd_pos_bf16 if bf16 else lib.gfla_warp_bwd_pos
    w1s = widen(w1s)  # the kernels' W1s ring is f32; the values stay bf16
    B, H, W, C = source.shape
    N = B * H * W
    D = w1s.shape[-1]
    k2 = k * k
    d_source = torch.zeros_like(source, dtype=torch.float32)  # reduced into
    d_flow = torch.empty_like(flow)
    d_hpre = hpre.new_empty(B, H * W, D)
    dw2b2 = hpre.new_empty(D * k2 + k2)
    part = hpre.new_empty(lib.gfla_warp_bwd_pos_scratch(N, C, D, k))
    with torch.cuda.device(source.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(
            source.data_ptr(), flow.data_ptr(), hpre.data_ptr(),
            w1s.data_ptr(), w2.data_ptr(), b2.data_ptr(), g.data_ptr(),
            d_source.data_ptr(), d_flow.data_ptr(), d_hpre.data_ptr(),
            part.data_ptr(), dw2b2.data_ptr(), B, H, W, C, D, k,
            float(slope), stream)
    check_launch(lib, err, "warp_bwd_pos")
    _count("bwd_pos_", bf16, k)
    return (d_source, d_flow, d_hpre, dw2b2[:D * k2].view(D, k2),
            dw2b2[D * k2:])


def _launch_bwd_w1(source, flow, d_hpre, k):
    B, H, W, C = source.shape
    D = d_hpre.shape[-1]
    if source.dtype not in KERNEL_DTYPES:
        raise TypeError(f"warp_bwd_w1: the CUDA kernels take a float32 or "
                        f"bfloat16 source, got {source.dtype}")
    for name, t, shape in (("source", source, source.shape),
                           ("flow", flow, (B, H, W, 2)),
                           ("d_hpre", d_hpre, (B, H * W, D))):
        want = source.dtype if name == "source" else torch.float32
        if (t.device != source.device or t.dtype != want
                or not t.is_contiguous() or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"warp_bwd_w1: {name} must be a contiguous "
                             f"{want} {tuple(shape)} on {source.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _check_sizes("warp_bwd_w1", B * H * W, C, D, k)
    lib = load_library()
    bf16 = source.dtype == torch.bfloat16
    entry = lib.gfla_warp_bwd_w1_bf16 if bf16 else lib.gfla_warp_bwd_w1
    dw1s = d_hpre.new_empty(k * k * C, D)
    part = d_hpre.new_empty(lib.gfla_warp_bwd_w1_scratch(B * H * W, C, D, k))
    with torch.cuda.device(source.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(
            source.data_ptr(), flow.data_ptr(), d_hpre.data_ptr(),
            part.data_ptr(), dw1s.data_ptr(), B, H, W, C, D, k, stream)
    check_launch(lib, err, "warp_bwd_w1")
    _count("bwd_w1_", bf16, k)
    return dw1s


def warp_bwd_pos(source, flow, hpre, w1s, w2, b2, g, kernel_size: int,
                 negative_slope: float = 0.1):
    """Per-position backward kernel on CUDA tensors, plain version on CPU
    tensors: (d_source, d_flow, d_hidden_bt, dW2, db2), f32, from the
    forward's hpre (B*H*W, D); g is (B,H,W,C) in the source's type."""
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
    hidden_bt; backward `warp_bwd` from that hpre, each gradient cast to its
    input's type. Counterpart of the custom VJP `attn_warp_core`
    (pallas_warp.py:420-487), whose backward recomputes hpre."""

    @staticmethod
    def forward(ctx, source, flow, hidden_bt, w1s, w2, b2, kernel_size,
                negative_slope):
        ctx.dtypes = [t.dtype for t in (source, flow, hidden_bt, w1s, w2, b2)]
        inputs = [t.contiguous() for t in (source, widen(flow), hidden_bt,
                                           w1s, w2, widen(b2))]
        out, hpre = warp_fwd_with_hpre(*inputs, kernel_size, negative_slope)
        source, flow, _, w1s, w2, b2 = inputs
        ctx.save_for_backward(source, flow, hpre, w1s, w2, b2)
        ctx.kernel_size = kernel_size
        ctx.negative_slope = negative_slope
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors  # once: --remat's recompute allows one
        grads = warp_bwd(*saved, g.to(saved[0].dtype).contiguous(),
                         ctx.kernel_size, ctx.negative_slope)
        return (*(d.to(t) for d, t in zip(grads, ctx.dtypes)), None, None)


def warp_fwd(source, flow, hidden_bt, w1s, w2, b2, kernel_size: int,
             negative_slope: float = 0.1):
    """Kernel on CUDA tensors, plain version on CPU tensors. Differentiable:
    when grad is on and an input requires it, the call goes through
    `WarpFunction`, whose backward is `warp_bwd`."""
    tensors = (source, flow, hidden_bt, w1s, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return WarpFunction.apply(*tensors, kernel_size, negative_slope)
    tensors = (source, widen(flow), hidden_bt, w1s, w2, widen(b2))
    if on_kernel_device(source, "warp_fwd"):
        return _launch_fwd(*tensors, kernel_size, negative_slope)
    return warp_fwd_plain(*tensors, kernel_size, negative_slope)
