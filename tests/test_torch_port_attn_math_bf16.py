"""The attention math in bfloat16 (GFLA_ATTN_PALLAS=1 under
`--compute_dtype=bfloat16`) against gfla_tpu, on the CPU.

gfla_tpu's `attn_math_fused` computes in the blocks' type: given bf16
blocks and parameters its Pallas kernels (pallas_attn.py:64-82, 155-228)
sum every product in f32, keep hpre, the logits, the softmax, d_attn,
d_logits, d_h and d_hpre in f32, and round to bf16 only the hidden layer
before W2, the attention weights before the weighted sum, the weighted sum
before its division by k^2, d_hpre before W1^T and dW1, and the outputs.
The port's plain twins (`attn_math_plain`, `attn_math_bwd_plain`,
`attn_math_dw1`), which the bf16 CUDA kernels are held against on the card,
round at the same points. Here they run through `AttnMathFunction` against
gfla_tpu's custom VJP with its kernels interpreted, in bf16 and in f32, on
seeded values that bf16 represents, by tests/test_torch_port_bf16.py's rule:
each result's error against gfla_tpu's f32 result is at most 2x gfla_tpu's
own bf16 error there + 1e-3 x max|f32|, and it is within OUT_TOL (the output
and d_bs) or GRAD_TOL (the other gradients) x max|f32| of gfla_tpu's bf16
result. gfla_tpu is run once for all cases, in a module fixture. The f32
twins are held bitwise to the formulas they had before the bf16 points were
added.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gfla_tpu.ops.pallas_attn import attn_math_fused
from gfla_tpu_torch.ops import attn_math

BF16 = torch.bfloat16
SLACK = 1e-3     # the rule's absolute slack, x max|f32 result|
OUT_TOL = 1e-2   # the output and d_bs (one bf16 ulp: 3.9e-3 of the max)
GRAD_TOL = 3e-2  # the other gradients, where sums cancel
NAMES = ("out", "d_bs", "d_bt", "dW1", "db1", "dW2", "db2")
CASES = {  # N, k, C, D
    "k3": (256, 3, 16, 32),
    "k5": (128, 5, 16, 32),
}


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_values(a):
    """float32 copies of `a` that bf16 represents exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float(
        ).numpy()


def _inputs(N, k, C, D, seed):
    """bs, bt, w1, b1, w2, b2 and the output cotangent g."""
    rng = np.random.RandomState(seed)
    k2 = k * k
    return [_bf16_values(a) for a in (
        rng.randn(N, k2, C), rng.randn(N, k2, C),
        rng.randn(k2, 2 * C, D) * 0.1, rng.randn(D) * 0.1,
        rng.randn(D, k2) * 0.3, rng.randn(k2) * 0.1, rng.randn(N, C))]


@pytest.fixture(scope="module")
def gfla():
    """gfla_tpu's output and six gradients for every case, in bf16 and f32,
    its kernels interpreted."""
    results = {}
    for case, (N, k, C, D) in CASES.items():
        a = _inputs(N, k, C, D, seed=N + k)
        for dt in (jnp.float32, jnp.bfloat16):
            args = [jnp.asarray(x, dt) for x in a[:6]]
            out, vjp = jax.vjp(
                lambda *xs: attn_math_fused(*xs, 0.1, True), *args)
            grads = vjp(jnp.asarray(a[6], dt))
            results[case, dt] = [np.asarray(jnp.asarray(x, jnp.float32))
                                 for x in (out, *grads)]
    return results


def _port(case, dtype):
    N, k, C, D = CASES[case]
    a = _inputs(N, k, C, D, seed=N + k)
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in a[:6]]
    out = attn_math.attn_math(*leaves)
    out.backward(torch.from_numpy(a[6]).to(dtype))
    return [out.detach(), *(x.grad for x in leaves)]


def _rule(port, ref, f32, tol, what):
    port = port.float().numpy()
    assert port.shape == ref.shape == f32.shape, what
    assert np.isfinite(port).all(), what
    top = max(np.abs(f32).max(), 1e-30)
    e_port = np.abs(port - f32).max() / top
    e_ref = np.abs(ref - f32).max() / top
    e_dir = np.abs(port - ref).max() / top
    assert e_port <= 2 * e_ref + SLACK, (what, e_port, e_ref)
    assert e_dir <= tol, (what, e_dir, tol)


@pytest.mark.parametrize("case", CASES)
def test_attn_math_bf16_forward_matches_pallas(gfla, case):
    out = _port(case, BF16)[0]
    assert out.dtype == BF16
    _rule(out, gfla[case, jnp.bfloat16][0], gfla[case, jnp.float32][0],
          OUT_TOL, "out")


@pytest.mark.parametrize("case", CASES)
def test_attn_math_bf16_grads_match_pallas(gfla, case):
    """The six gradients through AttnMathFunction (the forward's hpre, the
    backward twin, dW1 outside it), each in its input's type."""
    port = _port(case, BF16)
    for name, p, r, f in zip(NAMES[1:], port[1:], gfla[case, jnp.bfloat16][1:],
                             gfla[case, jnp.float32][1:]):
        assert p.dtype == BF16, name
        _rule(p, r, f, OUT_TOL if name == "d_bs" else GRAD_TOL, name)


def test_attn_math_bf16_twin_rounds_where_gfla_tpu_rounds():
    """hpre is f32 (the f32-summed products of the bf16 values plus b1);
    the output, d_bs, d_bt and d_hpre are bf16; dW2, db1 and db2 are f32
    sums, db1 over the f32 d_hpre before it is rounded."""
    N, k, C, D = CASES["k3"]
    a = [torch.from_numpy(x) for x in _inputs(N, k, C, D, seed=7)]
    bs, bt, w1, b1, w2, b2, g = (x.to(BF16) for x in a)
    out, hpre = attn_math.attn_math_plain(bs, bt, w1, b1, w2, b2,
                                          with_hpre=True)
    assert out.dtype == BF16 and hpre.dtype == torch.float32
    w1t, w1s = attn_math.split_w1(a[2])
    want = (a[1].reshape(N, -1) @ w1t + a[0].reshape(N, -1) @ w1s + a[3])
    torch.testing.assert_close(hpre, want, rtol=1e-6, atol=1e-6)
    assert not torch.equal(hpre, hpre.to(BF16).float())  # not rounded
    d_bs, d_bt, d_hpre, dw2, db1, db2 = attn_math.attn_math_bwd_plain(
        bs, bt, g, w1, b1, w2, b2, hpre=hpre)
    for name, t in (("d_bs", d_bs), ("d_bt", d_bt), ("d_hpre", d_hpre)):
        assert t.dtype == BF16, name
    for name, t in (("dW2", dw2), ("db1", db1), ("db2", db2)):
        assert t.dtype == torch.float32, name
    # db1 sums the unrounded d_hpre: the rounded one's sum is off it
    assert not torch.equal(db1, d_hpre.float().sum(0))
    torch.testing.assert_close(db1, d_hpre.float().sum(0), rtol=0,
                               atol=1e-2 * db1.abs().max().item())
    dw1 = attn_math.attn_math_dw1(bs, bt, d_hpre)
    assert dw1.dtype == torch.float32
    want = torch.cat([
        (a[1].reshape(N, -1).t() @ d_hpre.float()).reshape(k * k, C, D),
        (a[0].reshape(N, -1).t() @ d_hpre.float()).reshape(k * k, C, D)], 1)
    torch.testing.assert_close(dw1, want, rtol=0, atol=0)


def _old_f32(bs, bt, g, w1, b1, w2, b2, slope=0.1):
    """The f32 twins as they were before the bf16 points were added."""
    N, k2, C = bs.shape
    w1t, w1s = attn_math.split_w1(w1)
    hpre = bt.reshape(N, -1) @ w1t + bs.reshape(N, -1) @ w1s + b1
    hidden = F.leaky_relu(hpre, slope)
    attn = torch.softmax(hidden @ w2 + b2, dim=-1)
    out = torch.einsum("nk,nkc->nc", attn, bs) / float(k2)
    d_attn = torch.einsum("nkc,nc->nk", bs, g) / float(k2)
    d_logits = attn * (d_attn - (attn * d_attn).sum(-1, keepdim=True))
    dw2 = hidden.t() @ d_logits
    d_h = d_logits @ w2.t()
    d_hpre = torch.where(hpre >= 0, d_h, d_h * slope)
    d_bt = (d_hpre @ w1t.t()).reshape(N, k2, C)
    d_bs = ((d_hpre @ w1s.t()).reshape(N, k2, C)
            + (attn / float(k2))[..., None] * g[:, None, :])
    dw1 = torch.cat([
        (bt.reshape(N, k2 * C).t() @ d_hpre).reshape(k2, C, -1),
        (bs.reshape(N, k2 * C).t() @ d_hpre).reshape(k2, C, -1)], dim=1)
    return out, hpre, (d_bs, d_bt, d_hpre, dw2, d_hpre.sum(0),
                       d_logits.sum(0)), dw1


def test_attn_math_f32_is_bitwise_unchanged():
    N, k, C, D = CASES["k5"]
    bs, bt, w1, b1, w2, b2, g = (torch.from_numpy(x) for x in _inputs(
        N, k, C, D, seed=11))
    out, hpre, bwd, dw1 = _old_f32(bs, bt, g, w1, b1, w2, b2)
    got_out, got_hpre = attn_math.attn_math_plain(bs, bt, w1, b1, w2, b2,
                                                  with_hpre=True)
    assert torch.equal(got_out, out) and torch.equal(got_hpre, hpre)
    for from_hpre in (hpre, None):
        got = attn_math.attn_math_bwd_plain(bs, bt, g, w1, b1, w2, b2,
                                            hpre=from_hpre)
        for a, b in zip(got, bwd):
            assert a.dtype == torch.float32 and torch.equal(a, b)
    assert torch.equal(attn_math.attn_math_dw1(bs, bt, bwd[2]), dw1)
    leaves = [t.clone().requires_grad_() for t in (bs, bt, w1, b1, w2, b2)]
    attn_math.attn_math(*leaves).backward(g)
    for leaf, want in zip(leaves, (bwd[0], bwd[1], dw1, bwd[4], bwd[3],
                                   bwd[5])):
        assert torch.equal(leaf.grad, want)


def test_attn_math_kernel_inputs_take_bf16_with_an_f32_hpre():
    """The kernels' type rule: blocks, g and parameters in one type, f32 or
    bf16, and hpre f32."""
    N, k, C, D = 8, 3, 8, 16
    bs, bt, w1, b1, w2, b2, g = (torch.from_numpy(x).to(BF16) for x in
                                 _inputs(N, k, C, D, seed=3))
    hpre = torch.zeros(N, D)
    attn_math._check_inputs(bs, bt, w1, b1, w2, b2)
    attn_math._check_inputs(bs, bt, w1, b1, w2, b2, g, hpre)
    with pytest.raises(TypeError, match="hpre"):
        attn_math._check_inputs(bs, bt, w1, b1, w2, b2, g, hpre.to(BF16))
    with pytest.raises(TypeError, match="w1"):
        attn_math._check_inputs(bs, bt, w1.float(), b1, w2, b2)
    with pytest.raises(TypeError, match="blocks"):
        attn_math._check_inputs(*(t.half() for t in (bs, bt, w1, b1, w2,
                                                     b2)))
