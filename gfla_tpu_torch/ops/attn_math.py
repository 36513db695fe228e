"""Local-attention math over gathered blocks: CUDA kernels and plain twins.

Counterpart of gfla_tpu/ops/pallas_attn.py (`attn_math_fused`, forward and
backward), the `GFLA_ATTN_PALLAS=1` route of ops/local_attn.py. Given the
gathered source and target blocks bs, bt (N, k*k, C) and the ExtractorAttn
weights in gfla_tpu's layout, w1 (k*k, 2C, D) with channels
[target || source], b1 (D,), w2 (D, k*k), b2 (k*k,):

    hidden = LeakyReLU(bt . W1t + bs . W1s + b1)
    attn   = softmax(hidden . W2 + b2)
    out    = (1/k^2) sum_m attn_m * bs_m                      -> (N, C)

`attn_math` launches csrc/attn_math_fwd.cu on CUDA tensors and runs
`attn_math_plain` on CPU tensors; when an input requires grad it goes
through `AttnMathFunction`, whose backward is `attn_math_bwd`
(csrc/attn_math_bwd.cu, or `attn_math_bwd_plain` on the CPU) plus dW1 as
one matrix product over the saved blocks (`attn_math_dw1`), which gfla_tpu
also forms outside its kernel. Nothing falls back from a kernel to a plain
version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gfla_tpu_torch.ops._build import (
    check_launch,
    load_library,
    on_kernel_device,
)

# Kernel launches since each count was last set to 0 (chip_smoke.py reads
# them to show that the GFLA_ATTN_PALLAS=1 route went through the kernels).
fwd_launches = 0  # attn_math_fwd.cu
bwd_launches = 0  # attn_math_bwd.cu (+ its reduction of the weight sums)

MAX_D = 256  # one thread per hidden unit
MAX_C = 512  # two (32 x C) rows of blocks stay within 227 KB of shared memory


def split_w1(w1):
    """(k², 2C, D) -> target half W1t and source half W1s, each (k²·C, D)
    (gfla_tpu's `_split_w1`)."""
    k2, c2, d = w1.shape
    c = c2 // 2
    return (w1[:, :c, :].reshape(k2 * c, d), w1[:, c:, :].reshape(k2 * c, d))


def _hidden_pre(bs, bt, w1, b1):
    N = bs.shape[0]
    w1t, w1s = split_w1(w1)
    return bt.reshape(N, -1) @ w1t + bs.reshape(N, -1) @ w1s + b1


def attn_math_plain(bs, bt, w1, b1, w2, b2, negative_slope: float = 0.1):
    """The forward kernel's function in plain torch."""
    hidden = F.leaky_relu(_hidden_pre(bs, bt, w1, b1), negative_slope)
    attn = torch.softmax(hidden @ w2 + b2, dim=-1)               # (N, k²)
    return torch.einsum("nk,nkc->nc", attn, bs) / float(bs.shape[1])


def attn_math_bwd_plain(bs, bt, g, w1, b1, w2, b2,
                        negative_slope: float = 0.1):
    """What the backward kernel computes, in plain torch: (d_bs, d_bt,
    d_hpre, dW2, db1, db2), as gfla_tpu's `_bwd_kernel` (pallas_attn.py:
    155-228) does."""
    N, k2, C = bs.shape
    w1t, w1s = split_w1(w1)
    hpre = _hidden_pre(bs, bt, w1, b1)
    hidden = F.leaky_relu(hpre, negative_slope)
    attn = torch.softmax(hidden @ w2 + b2, dim=-1)
    d_attn = torch.einsum("nkc,nc->nk", bs, g) / float(k2)
    d_logits = attn * (d_attn - (attn * d_attn).sum(-1, keepdim=True))
    dw2 = hidden.t() @ d_logits
    d_h = d_logits @ w2.t()
    d_hpre = torch.where(hpre >= 0, d_h, d_h * negative_slope)
    d_bt = (d_hpre @ w1t.t()).reshape(N, k2, C)
    d_bs = ((d_hpre @ w1s.t()).reshape(N, k2, C)
            + (attn / float(k2))[..., None] * g[:, None, :])
    return d_bs, d_bt, d_hpre, dw2, d_hpre.sum(0), d_logits.sum(0)


def attn_math_dw1(bs, bt, d_hpre):
    """dW1 (k², 2C, D) = [bt || bs]^T d_hpre, summed over positions: two
    matrix products, as gfla_tpu's einsums outside its kernel
    (pallas_attn.py:291-298)."""
    N, k2, C = bs.shape
    dw1t = (bt.reshape(N, k2 * C).t() @ d_hpre).reshape(k2, C, -1)
    dw1s = (bs.reshape(N, k2 * C).t() @ d_hpre).reshape(k2, C, -1)
    return torch.cat([dw1t, dw1s], dim=1)


def _check_inputs(bs, bt, w1, b1, w2, b2, g=None):
    tensors = dict(bs=bs, bt=bt, w1=w1, b1=b1, w2=w2, b2=b2)
    if g is not None:
        tensors["g"] = g
    for name, t in tensors.items():
        if t.device != bs.device:
            raise ValueError(f"attn_math: {name} is on {t.device}, bs on "
                             f"{bs.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"attn_math: the CUDA kernels take float32, "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"attn_math: {name} must be contiguous")
    if bs.dim() != 3:
        raise ValueError(f"attn_math: bs must be (N, k*k, C), got "
                         f"{tuple(bs.shape)}")
    N, k2, C = bs.shape
    D = w1.shape[-1]
    if not 1 <= D <= MAX_D or not 1 <= C <= MAX_C or N < 1:
        raise ValueError(f"attn_math: the CUDA kernels take 1 <= D <= "
                         f"{MAX_D}, 1 <= C <= {MAX_C} and N >= 1, got D={D}, "
                         f"C={C}, N={N}")
    if N * k2 * C >= 2**31 or N * D >= 2**31:
        raise ValueError("attn_math: tensor too large for 32-bit indexing")
    expected = dict(bt=(N, k2, C), w1=(k2, 2 * C, D), b1=(D,), w2=(D, k2),
                    b2=(k2,))
    if g is not None:
        expected["g"] = (N, C)
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"attn_math: {name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")


def _launch_fwd(bs, bt, w1, b1, w2, b2, slope):
    global fwd_launches
    _check_inputs(bs, bt, w1, b1, w2, b2)
    lib = load_library()
    N, k2, C = bs.shape
    D = w1.shape[-1]
    w1t, w1s = (w.contiguous() for w in split_w1(w1))
    out = bs.new_empty(N, C)
    with torch.cuda.device(bs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gfla_attn_math_fwd(
            bs.data_ptr(), bt.data_ptr(), w1t.data_ptr(), w1s.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            N, k2, C, D, float(slope), stream)
    check_launch(lib, err, "attn_math_fwd")
    fwd_launches += 1
    return out


def _launch_bwd(bs, bt, g, w1, b1, w2, b2, slope):
    global bwd_launches
    _check_inputs(bs, bt, w1, b1, w2, b2, g)
    lib = load_library()
    N, k2, C = bs.shape
    D = w1.shape[-1]
    w1t, w1s = (w.contiguous() for w in split_w1(w1))
    d_bs = torch.empty_like(bs)
    d_bt = torch.empty_like(bt)
    d_hpre = bs.new_empty(N, D)
    sums = bs.new_empty(D * k2 + D + k2)
    part = bs.new_empty(lib.gfla_attn_math_bwd_scratch(N, k2, D))
    with torch.cuda.device(bs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gfla_attn_math_bwd(
            bs.data_ptr(), bt.data_ptr(), g.data_ptr(), w1t.data_ptr(),
            w1s.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            d_bs.data_ptr(), d_bt.data_ptr(), d_hpre.data_ptr(),
            part.data_ptr(), sums.data_ptr(), N, k2, C, D, float(slope),
            stream)
    check_launch(lib, err, "attn_math_bwd")
    bwd_launches += 1
    return (d_bs, d_bt, d_hpre, sums[:D * k2].view(D, k2),
            sums[D * k2:D * k2 + D], sums[D * k2 + D:])


def attn_math_fwd(bs, bt, w1, b1, w2, b2, negative_slope: float = 0.1):
    """Forward kernel on CUDA tensors, plain version on CPU tensors; not
    differentiable (see `attn_math`)."""
    if on_kernel_device(bs, "attn_math_fwd"):
        return _launch_fwd(bs, bt, w1, b1, w2, b2, negative_slope)
    return attn_math_plain(bs, bt, w1, b1, w2, b2, negative_slope)


def attn_math_bwd(bs, bt, g, w1, b1, w2, b2, negative_slope: float = 0.1):
    """Backward kernel on CUDA tensors, plain version on CPU tensors:
    (d_bs, d_bt, d_hpre, dW2, db1, db2); g is (N, C)."""
    if on_kernel_device(bs, "attn_math_bwd"):
        return _launch_bwd(bs, bt, g, w1, b1, w2, b2, negative_slope)
    return attn_math_bwd_plain(bs, bt, g, w1, b1, w2, b2, negative_slope)


class AttnMathFunction(torch.autograd.Function):
    """The attention math with its hand-written backward. Counterpart of the
    custom VJP `attn_math_fused` (pallas_attn.py:124-309)."""

    @staticmethod
    def forward(ctx, bs, bt, w1, b1, w2, b2, negative_slope):
        inputs = [t.contiguous() for t in (bs, bt, w1, b1, w2, b2)]
        ctx.save_for_backward(*inputs)
        ctx.negative_slope = negative_slope
        return attn_math_fwd(*inputs, negative_slope)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        bs, bt, w1, b1, w2, b2 = ctx.saved_tensors
        d_bs, d_bt, d_hpre, dw2, db1, db2 = attn_math_bwd(
            bs, bt, g.contiguous(), w1, b1, w2, b2, ctx.negative_slope)
        return (d_bs, d_bt, attn_math_dw1(bs, bt, d_hpre), db1, dw2, db2,
                None)


def attn_math(bs, bt, w1, b1, w2, b2, negative_slope: float = 0.1):
    """(N, k², C) blocks -> (N, C). Kernel on CUDA tensors, plain version on
    CPU tensors; when grad is on and an input requires it, the call goes
    through `AttnMathFunction`. Inputs are made contiguous first (a conv
    weight in channels_last memory gives a strided w1)."""
    tensors = (bs, bt, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return AttnMathFunction.apply(*tensors, negative_slope)
    return attn_math_fwd(*(t.contiguous() for t in tensors), negative_slope)
