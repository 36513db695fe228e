"""The local-attention warp at kernel sizes from 2 to 13 against gfla_tpu,
on the CPU, and the wrappers' checks at every k.

gfla_tpu's warp kernel takes any k (`fused_warp_eligible`,
pallas_warp.py:56-88, sets no limit; `--kernel_size 2=4` parses for every
head), and its block offsets are i - k//2, so an even block reaches one row
and column further up and left than down and right. The port's warp
kernels take every k too, odd or even (from k = 10 their wide instances);
their plain twins, which the kernels are held against on the card, run
here at k = 2, 4, 6, 9, 10 and 13 through
`local_attn_warp` (the forward) and `warp_fwd` (WarpFunction: the gradients
to source, flow, hidden_bt, W1s, W2 and b2) against gfla_tpu's fused op and
custom VJP with its Pallas kernels interpreted, at a shape its tiles take
(H*W a multiple of 128, C and D multiples of 128): f32 within
tests/test_torch_port_ops.py's 2e-5 (the output) and
tests/test_torch_port_warp_bwd.py's 1e-4 x max|value| (the gradients); bf16
by tests/test_torch_port_bf16.py's rule against gfla_tpu's bf16 and f32
results. At k = 9 gfla_tpu's interpreted kernel is not its own function:
its 16-wide aligned column slab (pallas_warp.py:95-101) cannot hold a
10-column footprint that starts past column 6 of it, and its output leaves
its XLA composition by 0.031 (7% of max) where the port's stays within
2e-7; so from k = 9 up the port's whole op (`local_attn_warp` and its
gradients to source, target, flow and the four weights) is held against
gfla_tpu's composition (`use_pallas=False`). Nor is that composition a bf16
reference there: it blends at bf16 flow coordinates, and its bf16 results
sit 3.5-40% of max off its f32 ones (d_flow the furthest), the port's
0.6-1.1%. So from k = 9 up the bf16 results are held by the rule's first
clause and, at k = 9, within the same tolerances of gfla_tpu's f32
composition. At k = 10 and 13 these inputs' logits grow with k^2 C and
bf16 rounding moves both sides' results far more: the port's 0.7-9.5% of
max off f32 over seeds, gfla_tpu's composition 4-58% (the port 2-30x
nearer), so there the bf16 results are held by the first clause alone. No
block size takes the composite route: the wrappers' own checks take every
k (k = 11 and 16 here) and refuse only k < 1 and sizes past 32-bit
indexing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfla_tpu.ops.local_attn import (
    local_attn_warp as gfla_local_attn_warp,
)
from gfla_tpu.ops.pallas_warp import attn_warp_core, local_attn_warp_fused
from gfla_tpu_torch.ops import local_attn, warp
from gfla_tpu_torch.ops.local_attn import local_attn_warp, target_stream

BF16 = torch.bfloat16
ATOL = RTOL = 2e-5  # f32 output
GRAD_REL = 1e-4     # f32 gradients, x max|value|
SLACK = 1e-3        # the bf16 rule (tests/test_torch_port_bf16.py)
OUT_TOL = 1e-2
GRAD_TOL = 3e-2
NAMES = ("out", "d_source", "d_flow", "d_hidden_bt", "dW1s", "dW2", "db2")
OP_NAMES = ("out", "d_source", "d_target", "d_flow", "dW1", "db1", "dW2",
            "db2")
LEAVES = ("source", "target", "flow", "w1", "b1", "w2", "b2")
KERNEL_K = 8  # the widest k at which gfla_tpu's kernel is its function
KS = (2, 4, 6, 9, 10, 13)  # 10 and 13: the kernels' wide instances
SHAPE = (1, 8, 16, 128)  # B, H, W, C
D = 128


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_values(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float(
        ).numpy()


def _inputs(k, seed):
    b, h, w, c = SHAPE
    rng = np.random.RandomState(seed)
    return {n: _bf16_values(v) for n, v in dict(
        source=rng.randn(b, h, w, c), target=rng.randn(b, h, w, c),
        flow=rng.randn(b, h, w, 2) * 2.0, w1=rng.randn(k * k, 2 * c, D) * 0.05,
        b1=rng.randn(D) * 0.1, w2=rng.randn(D, k * k) * 0.1,
        b2=rng.randn(k * k) * 0.1, r=rng.randn(b, h, w, c)).items()}


def _tdt(dt):
    return BF16 if dt == jnp.bfloat16 else torch.float32


def _gfla(a, k, dt):
    """gfla_tpu in `dt`: the fused op's output, and jax.grad of
    sum(out * r) through `attn_warp_core`, its kernels interpreted; above
    KERNEL_K its composition's output and gradients to LEAVES."""
    j = {n: jnp.asarray(v, dt) for n, v in a.items()}
    if k > KERNEL_K:
        def op(*xs):
            out = gfla_local_attn_warp(*xs[:3], k, *xs[3:], use_pallas=False)
            return jnp.sum(out.astype(jnp.float32) * jnp.asarray(a["r"])), out

        (_, out), grads = jax.jit(jax.value_and_grad(  # jitted: ~5x faster
            op, argnums=tuple(range(7)), has_aux=True))(
                *(j[n] for n in LEAVES))
        return [np.asarray(jnp.asarray(x, jnp.float32))
                for x in (out, *grads)]
    out = local_attn_warp_fused(j["source"], j["target"], j["flow"], k,
                                j["w1"], j["b1"], j["w2"], j["b2"],
                                interpret=True)
    c = SHAPE[-1]
    hbt = target_stream(*(torch.from_numpy(a[n]).to(_tdt(dt))
                          for n in ("target", "w1", "b1")), k)
    args = (j["source"], j["flow"], jnp.asarray(hbt.numpy()),
            j["w1"][:, c:, :].reshape(k * k * c, -1), j["w2"], j["b2"])

    def loss(*xs):
        o = attn_warp_core(*xs, k, 0.1, True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(a["r"]))

    grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (out, *grads)]


def _port(a, k, dt):
    """The port on the default route: the output, and the gradients of
    sum(out * r) through `warp.warp_fwd` (WarpFunction); above KERNEL_K
    through the whole op, to LEAVES."""
    t = {n: torch.from_numpy(v).to(dt) for n, v in a.items()}
    if k > KERNEL_K:
        leaves = [t[n].requires_grad_() for n in LEAVES]
        out = local_attn_warp(*leaves[:3], k, *leaves[3:])
        (out.float() * torch.from_numpy(a["r"])).sum().backward()
        return [out.detach().float().numpy(),
                *(x.grad.float().numpy() for x in leaves)]
    out = local_attn_warp(t["source"], t["target"], t["flow"], k, t["w1"],
                          t["b1"], t["w2"], t["b2"])
    c = SHAPE[-1]
    xs = [t["source"], t["flow"], target_stream(t["target"], t["w1"],
                                                t["b1"], k),
          t["w1"][:, c:, :].reshape(k * k * c, -1), t["w2"], t["b2"]]
    xs = [x.detach().requires_grad_() for x in xs]
    (warp.warp_fwd(*xs, k).float() * torch.from_numpy(a["r"])).sum(
        ).backward()
    return [out.detach().float().numpy(),
            *(x.grad.float().numpy() for x in xs)]


@pytest.fixture(scope="module")
def gfla_f32():
    """gfla_tpu's f32 results at every k below, shared by both types."""
    return {k: _gfla(_inputs(k, k), k, jnp.float32) for k in KS}


@pytest.mark.parametrize("k", KS)
def test_warp_f32_at_kernel_size_matches_pallas(gfla_f32, k):
    port = _port(_inputs(k, k), k, torch.float32)
    np.testing.assert_allclose(port[0], gfla_f32[k][0], rtol=RTOL, atol=ATOL)
    names = NAMES if k <= KERNEL_K else OP_NAMES
    assert len(port) == len(gfla_f32[k]) == len(names)
    for name, p, w in zip(names[1:], port[1:], gfla_f32[k][1:]):
        np.testing.assert_allclose(p.reshape(w.shape), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("k", KS)
def test_warp_bf16_at_kernel_size_matches_pallas(gfla_f32, k):
    a = _inputs(k, k)
    ref = _gfla(a, k, jnp.bfloat16)
    port = _port(a, k, BF16)
    names = NAMES if k <= KERNEL_K else OP_NAMES
    assert len(port) == len(ref) == len(names)
    for name, p, r, f in zip(names, port, ref, gfla_f32[k]):
        p = p.reshape(f.shape)
        top = max(np.abs(f).max(), 1e-30)
        e_port = np.abs(p - f).max() / top
        e_ref = np.abs(r - f).max() / top
        e_dir = np.abs(p - r).max() / top
        assert np.isfinite(p).all(), name
        assert e_port <= 2 * e_ref + SLACK, (name, e_port, e_ref)
        tol = OUT_TOL if name in ("out", "d_source") else GRAD_TOL
        if k <= 9:
            assert (e_dir if k <= KERNEL_K else e_port) <= tol, (
                name, e_dir, e_port, tol)


@pytest.mark.parametrize("k", [4, 9, 11, 16])
def test_warp_kernel_checks_take_kernel_sizes_to_9(k):
    """`_check_kernel_inputs` (both kernels' wrappers) takes k = 4 and 9,
    and past 9, where the wide instances run, k = 11 and 16; it refuses
    k = 0 and a k whose k^2 C x D W1s passes 32-bit indexing before any
    kernel is asked."""
    b, h, w, c = 1, 4, 4, 8
    d = 16
    source = torch.zeros(b, h, w, c)
    flow = torch.zeros(b, h, w, 2)
    args = dict(w1s=torch.zeros(k * k * c, d), w2=torch.zeros(d, k * k),
                b2=torch.zeros(k * k))
    warp._check_kernel_inputs(source, flow, torch.zeros(b, h * w, d),
                              args["w1s"], args["w2"], args["b2"], k)
    warp._check_kernel_inputs(source, flow, torch.zeros(b * h * w, d),
                              args["w1s"], args["w2"], args["b2"], k,
                              g=torch.zeros(b, h, w, c))
    warp._check_sizes("warp_bwd_w1", b * h * w, c, d, k)
    with pytest.raises(ValueError, match="kernel_size"):
        warp._check_kernel_inputs(
            source, flow, torch.zeros(b, h * w, d), torch.zeros(0, d),
            torch.zeros(d, 0), torch.zeros(0), 0)
    with pytest.raises(ValueError, match="kernel_size"):
        warp._launch_bwd_w1(source, flow, torch.zeros(b, h * w, d), 0)
    with pytest.raises(ValueError, match="32-bit"):
        warp._check_sizes("warp", b * h * w, 1024, 256, 91)


def test_wide_kernel_takes_no_composite_route(monkeypatch):
    """Above k = 9 the default route sends no call to the composite: on a
    CPU tensor the warp's plain twin, which takes any k, computes it (within
    2e-5 of the composite, no launch counted), and on a CUDA tensor the
    wrapper's check takes it (k = 11 and 16) for the wide instances;
    GFLA_ATTN_PALLAS=0 is the one setting that selects the composite."""
    rng = np.random.RandomState(0)
    b, h, w, c = 1, 6, 6, 8
    for k in (11, 16):
        t = dict(source=rng.randn(b, h, w, c), target=rng.randn(b, h, w, c),
                 flow=rng.randn(b, h, w, 2),
                 w1=rng.randn(k * k, 2 * c, 16) * 0.1,
                 b1=rng.randn(16) * 0.1, w2=rng.randn(16, k * k) * 0.1,
                 b2=rng.randn(k * k) * 0.1)
        t = {n: torch.from_numpy(v.astype(np.float32)) for n, v in t.items()}
        args = (t["source"], t["target"], t["flow"], k, t["w1"], t["b1"],
                t["w2"], t["b2"])
        monkeypatch.setenv("GFLA_ATTN_PALLAS", "0")
        want = local_attn_warp(*args)
        monkeypatch.setenv("GFLA_ATTN_PALLAS", "auto")
        counts = [name for name in dir(warp) if name.endswith("launches")]
        before = {name: getattr(warp, name) for name in counts}
        calls = []
        with monkeypatch.context() as m:
            m.setattr(local_attn, "_composite", lambda *a: calls.append(a))
            got = local_attn_warp(*args)
        assert not calls
        assert {name: getattr(warp, name) for name in counts} == before
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
        w1s = t["w1"][:, c:, :].reshape(k * k * c, 16)
        warp._check_kernel_inputs(t["source"], t["flow"],
                                  torch.zeros(b, h * w, 16), w1s, t["w2"],
                                  t["b2"], k)
