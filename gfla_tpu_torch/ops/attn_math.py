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
through `AttnMathFunction`, whose forward also keeps the pre-activation
hidden layer hpre = [bt || bs] . W1 + b1 (the forward kernels store it on
the way, in the same call) and whose backward is `attn_math_bwd` from
that hpre (csrc/attn_math_bwd.cu, or `attn_math_bwd_plain` on the CPU) plus
dW1 as one matrix product over the saved blocks (`attn_math_dw1`), which
gfla_tpu also forms outside its kernel. gfla_tpu's backward recomputes hpre;
the plain twin still does when it is not given one. Nothing falls back from
a kernel to a plain version.

Element types follow gfla_tpu's kernels, which compute in the blocks' type:
f32 blocks run the f32 kernels; bf16 blocks (under `--compute_dtype=
bfloat16`, with every parameter in bf16) run their bf16 instances
(csrc/attn_math_{fwd,bwd}_bf16.cu). In bf16, as gfla_tpu's kernel bodies
(pallas_attn.py:64-82, 155-228), products of bf16 values are summed in f32,
and hpre, the logits, the softmax, d_attn, d_logits, d_h and d_hpre are
f32; values are rounded to bf16 only where gfla_tpu rounds them: the hidden
layer before W2, the attention weights before the weighted sum, d_hpre
before W1^T and dW1, and the outputs. db1 is summed from the f32 d_hpre,
and dW2, db1, db2 and dW1 are f32 sums that `AttnMathFunction` casts to
each parameter's type, as gfla_tpu's backward returns them.
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

# Kernel launches since each count was last set to 0 (chip_smoke.py reads
# them to show that the GFLA_ATTN_PALLAS=1 route went through the kernels).
fwd_launches = 0  # attn_math_fwd.cu
bwd_launches = 0  # attn_math_bwd.cu (+ its reduction of the weight sums)
bf16_fwd_launches = 0  # attn_math_fwd_bf16.cu
bf16_bwd_launches = 0  # attn_math_bwd_bf16.cu

MAX_D = 256  # the widest hidden layer the kernels accept
MAX_C = 512  # the widest blocks the kernels accept
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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


def attn_math_plain(bs, bt, w1, b1, w2, b2, negative_slope: float = 0.1,
                    with_hpre: bool = False):
    """The forward kernel's function in plain torch. With `with_hpre`,
    (out, hpre): hpre (N, D) is the pre-activation hidden layer, which the
    backward starts from. In bf16 (module docstring) the products
    attn_m * bs_m of bf16 values (exact in f32) are summed in f32, and the
    sum is rounded to bf16 and divided by k² in bf16: gfla_tpu's
    `jnp.sum(attn.astype(bf16) * bs, axis=1) / k2` (pallas_attn.py:81) as
    XLA runs it, keeping the products in f32 (bitwise equal to its
    interpreted kernel; rounding each product too leaves a third of the
    outputs one bf16 step off it)."""
    cdt = bs.dtype
    hpre = _hidden_pre(widen(bs), widen(bt), widen(w1), widen(b1))
    hidden = F.leaky_relu(hpre, negative_slope)
    attn = torch.softmax(at_bf16(hidden, cdt) @ widen(w2) + widen(b2),
                         dim=-1)                                 # (N, k²)
    if cdt == torch.bfloat16:
        prods = at_bf16(attn, cdt)[..., None] * bs.float()        # exact
        out = prods.sum(1).to(cdt) / float(bs.shape[1])
    else:
        out = torch.einsum("nk,nkc->nc", attn, bs) / float(bs.shape[1])
    return (out, hpre) if with_hpre else out


def attn_math_bwd_plain(bs, bt, g, w1, b1, w2, b2,
                        negative_slope: float = 0.1, hpre=None):
    """What the backward kernel computes, in plain torch: (d_bs, d_bt,
    d_hpre, dW2, db1, db2), as gfla_tpu's `_bwd_kernel` (pallas_attn.py:
    155-228) does. Given the forward's `hpre` (N, D) it starts from it, as
    the kernel does; without it, it recomputes hpre from the blocks, as
    gfla_tpu does. In bf16 (module docstring) d_bs, d_bt and d_hpre are
    bf16 and dW2, db1, db2 f32 sums; db1 is summed before d_hpre is
    rounded."""
    N, k2, C = bs.shape
    cdt = bs.dtype
    w1t, w1s = (widen(w) for w in split_w1(w1))
    if hpre is None:
        hpre = _hidden_pre(widen(bs), widen(bt), widen(w1), widen(b1))
    hidden = at_bf16(F.leaky_relu(hpre, negative_slope), cdt)
    attn = torch.softmax(hidden @ widen(w2) + widen(b2), dim=-1)
    g = widen(g)
    d_attn = torch.einsum("nkc,nc->nk", widen(bs), g) / float(k2)
    d_logits = attn * (d_attn - (attn * d_attn).sum(-1, keepdim=True))
    dw2 = hidden.t() @ d_logits
    d_h = d_logits @ widen(w2).t()
    d_hpre = torch.where(hpre >= 0, d_h, d_h * negative_slope)
    db1 = d_hpre.sum(0)
    d_hpre = at_bf16(d_hpre, cdt)
    d_bt = (d_hpre @ w1t.t()).reshape(N, k2, C)
    d_bs = ((d_hpre @ w1s.t()).reshape(N, k2, C)
            + (attn / float(k2))[..., None] * g[:, None, :])
    return (d_bs.to(cdt), d_bt.to(cdt), d_hpre.to(cdt), dw2, db1,
            d_logits.sum(0))


def attn_math_dw1(bs, bt, d_hpre):
    """dW1 (k², 2C, D) = [bt || bs]^T d_hpre, summed over positions: two
    matrix products, as gfla_tpu's einsums outside its kernel
    (pallas_attn.py:291-298). bf16 operands are widened first, so the
    product is summed in f32 on any device, as gfla_tpu's
    `preferred_element_type=f32`; the result is f32."""
    N, k2, C = bs.shape
    d_hpre = widen(d_hpre)
    dw1t = (widen(bt).reshape(N, k2 * C).t() @ d_hpre).reshape(k2, C, -1)
    dw1s = (widen(bs).reshape(N, k2 * C).t() @ d_hpre).reshape(k2, C, -1)
    return torch.cat([dw1t, dw1s], dim=1)


def _check_inputs(bs, bt, w1, b1, w2, b2, g=None, hpre=None):
    """bs is float32 or bfloat16; every other input is in its type but
    hpre, which is float32."""
    if bs.dtype not in KERNEL_DTYPES:
        raise TypeError(f"attn_math: the CUDA kernels take float32 or "
                        f"bfloat16 blocks, got {bs.dtype}")
    tensors = dict(bs=bs, bt=bt, w1=w1, b1=b1, w2=w2, b2=b2)
    if g is not None:
        tensors["g"] = g
        tensors["hpre"] = hpre
    for name, t in tensors.items():
        if t is None:
            raise ValueError(f"attn_math: the backward kernel starts from "
                             f"the forward's {name}; it is missing")
        if t.device != bs.device:
            raise ValueError(f"attn_math: {name} is on {t.device}, bs on "
                             f"{bs.device}")
        want = torch.float32 if name == "hpre" else bs.dtype
        if t.dtype != want:
            raise TypeError(f"attn_math: with {bs.dtype} blocks the CUDA "
                            f"kernels take {name} in {want}, got {t.dtype}")
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
        expected.update(g=(N, C), hpre=(N, D))
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"attn_math: {name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")


def _launch_fwd(bs, bt, w1, b1, w2, b2, slope, with_hpre=False):
    global fwd_launches, bf16_fwd_launches
    _check_inputs(bs, bt, w1, b1, w2, b2)
    lib = load_library()
    N, k2, C = bs.shape
    D = w1.shape[-1]
    bf16 = bs.dtype == torch.bfloat16
    if bf16:  # the bf16 product reads W1 as it lies
        entry, w1k = lib.gfla_attn_math_fwd_bf16, w1
    else:  # the f32 product takes W1 depth-innermost, as wgmma takes TF32
        entry = lib.gfla_attn_math_fwd
        w1k = w1.reshape(k2 * 2 * C, D).t().contiguous()
    out = bs.new_empty(N, C)
    hpre = bs.new_empty(N, D, dtype=torch.float32) if with_hpre else None
    scratch = bs.new_empty(lib.gfla_attn_math_fwd_scratch(N, k2, C, D),
                           dtype=torch.float32)
    with torch.cuda.device(bs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(
            bs.data_ptr(), bt.data_ptr(), w1k.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if hpre is None else hpre.data_ptr(), scratch.data_ptr(), N,
            k2, C, D, float(slope), stream)
    check_launch(lib, err, "attn_math_fwd")
    if bf16:
        bf16_fwd_launches += 1
    else:
        fwd_launches += 1
    return (out, hpre) if with_hpre else out


def _launch_bwd(bs, bt, hpre, g, w1, b1, w2, b2, slope):
    global bwd_launches, bf16_bwd_launches
    _check_inputs(bs, bt, w1, b1, w2, b2, g, hpre)
    lib = load_library()
    N, k2, C = bs.shape
    D = w1.shape[-1]
    bf16 = bs.dtype == torch.bfloat16
    entry = lib.gfla_attn_math_bwd_bf16 if bf16 else lib.gfla_attn_math_bwd
    d_bs = torch.empty_like(bs)
    d_bt = torch.empty_like(bt)
    d_hpre = bs.new_empty(N, D)
    sums = bs.new_empty(D * k2 + D + k2, dtype=torch.float32)
    scratch = bs.new_empty(lib.gfla_attn_math_bwd_scratch(N, k2, D),
                           dtype=torch.float32)
    with torch.cuda.device(bs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(
            bs.data_ptr(), hpre.data_ptr(), g.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), d_bs.data_ptr(), d_bt.data_ptr(),
            d_hpre.data_ptr(), scratch.data_ptr(), sums.data_ptr(), N, k2, C,
            D, float(slope), stream)
    check_launch(lib, err, "attn_math_bwd")
    if bf16:
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return (d_bs, d_bt, d_hpre, sums[:D * k2].view(D, k2),
            sums[D * k2:D * k2 + D], sums[D * k2 + D:])


def attn_math_fwd(bs, bt, w1, b1, w2, b2, negative_slope: float = 0.1):
    """Forward kernel on CUDA tensors, plain version on CPU tensors; not
    differentiable (see `attn_math`)."""
    if on_kernel_device(bs, "attn_math_fwd"):
        return _launch_fwd(bs, bt, w1, b1, w2, b2, negative_slope)
    return attn_math_plain(bs, bt, w1, b1, w2, b2, negative_slope)


def attn_math_fwd_with_hpre(bs, bt, w1, b1, w2, b2,
                            negative_slope: float = 0.1):
    """(out, hpre): the forward kernel, which also stores the pre-activation
    hidden layer hpre (N, D), on CUDA tensors (one launch); the plain
    version on CPU tensors."""
    if on_kernel_device(bs, "attn_math_fwd"):
        return _launch_fwd(bs, bt, w1, b1, w2, b2, negative_slope,
                           with_hpre=True)
    return attn_math_plain(bs, bt, w1, b1, w2, b2, negative_slope,
                           with_hpre=True)


def attn_math_bwd(bs, bt, g, w1, b1, w2, b2, negative_slope: float = 0.1,
                  hpre=None):
    """Backward kernel on CUDA tensors, from the forward's `hpre` (N, D),
    which it needs; plain version on CPU tensors, which recomputes hpre
    when it is not given: (d_bs, d_bt, d_hpre, dW2, db1, db2); g is
    (N, C)."""
    if on_kernel_device(bs, "attn_math_bwd"):
        return _launch_bwd(bs, bt, hpre, g, w1, b1, w2, b2, negative_slope)
    return attn_math_bwd_plain(bs, bt, g, w1, b1, w2, b2, negative_slope,
                               hpre)


class AttnMathFunction(torch.autograd.Function):
    """The attention math with its hand-written backward: forward
    `attn_math_fwd_with_hpre` (kernel, or plain twin on the CPU), which
    saves hpre; backward `attn_math_bwd` from it, each gradient cast to its
    input's type. Counterpart of the custom VJP `attn_math_fused`
    (pallas_attn.py:124-309), whose backward recomputes hpre."""

    @staticmethod
    def forward(ctx, bs, bt, w1, b1, w2, b2, negative_slope):
        inputs = [t.contiguous() for t in (bs, bt, w1, b1, w2, b2)]
        out, hpre = attn_math_fwd_with_hpre(*inputs, negative_slope)
        ctx.save_for_backward(*inputs, hpre)
        ctx.negative_slope = negative_slope
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        bs, bt, w1, b1, w2, b2, hpre = ctx.saved_tensors
        d_bs, d_bt, d_hpre, dw2, db1, db2 = attn_math_bwd(
            bs, bt, g.to(bs.dtype).contiguous(), w1, b1, w2, b2,
            ctx.negative_slope, hpre)
        grads = (d_bs, d_bt, attn_math_dw1(bs, bt, d_hpre), db1, dw2, db2)
        return (*(d.to(t.dtype) for d, t in zip(
            grads, (bs, bt, w1, b1, w2, b2))), None)


def attn_math(bs, bt, w1, b1, w2, b2, negative_slope: float = 0.1):
    """(N, k², C) blocks -> (N, C). Kernel on CUDA tensors, plain version on
    CPU tensors; when grad is on and an input requires it, the call goes
    through `AttnMathFunction`. Inputs are made contiguous first (a conv
    weight in channels_last memory gives a strided w1)."""
    tensors = (bs, bt, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return AttnMathFunction.apply(*tensors, negative_slope)
    return attn_math_fwd(*(t.contiguous() for t in tensors), negative_slope)
