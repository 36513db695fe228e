"""The attention-math route (GFLA_ATTN_PALLAS=1) against gfla_tpu, on the CPU.

The plain twins of csrc/attn_math_fwd.cu and csrc/attn_math_bwd.cu are held
against gfla_tpu's Pallas kernels `_attn_math_pallas` and
`_attn_math_bwd_pallas` in interpret mode, at N that no tile divides: the
forward and each of the six gradients (blocks, weights, biases) within
2e-4 x its largest |value| (f32; sums in other orders); the backward from
the forward's saved hpre, as the kernels run it, in the ReLU case too.
`local_attn_warp`
under GFLA_ATTN_PALLAS=0 and =1 matches gfla_tpu's under the same setting,
output and the gradients to source, target, flow and the four weights; and
each setting selects the route gfla_tpu selects.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import gfla_tpu.ops.local_attn as jax_local_attn
from gfla_tpu.ops import pallas_attn, pallas_warp
from gfla_tpu.ops.pallas_attn import _attn_math_bwd_pallas, _attn_math_pallas
from gfla_tpu_torch.ops import attn_math, local_attn, warp

REL = 2e-4
NAMES = ("source", "target", "flow", "w1", "b1", "w2", "b2")


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _blocks(N, k, C, D, seed):
    rng = np.random.RandomState(seed)
    k2 = k * k
    arrays = [rng.randn(N, k2, C), rng.randn(N, k2, C),
              rng.randn(k2, 2 * C, D) * 0.1, rng.randn(D) * 0.1,
              rng.randn(D, k2) * 0.3, rng.randn(k2) * 0.1, rng.randn(N, C)]
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("N,k,C,D", [
    pytest.param(100, 3, 8, 16, id="k3"),
    pytest.param(37, 5, 5, 12, id="k5-ragged"),
    pytest.param(130, 3, 16, 32, id="k3-two-tiles"),
])
def test_attn_math_matches_pallas(N, k, C, D):
    """Forward and backward plain twins, and the autograd Function built on
    them, against the interpreted Pallas kernels."""
    bs, bt, w1, b1, w2, b2, g = _blocks(N, k, C, D, N + k)
    jargs = [jnp.asarray(a) for a in (bs, bt, w1, b1, w2, b2)]
    want_out = _attn_math_pallas(*jargs, 0.1, interpret=True)
    want = _attn_math_bwd_pallas(jargs[0], jargs[1], jnp.asarray(g),
                                 *jargs[2:], 0.1, interpret=True)
    t = [torch.from_numpy(a) for a in (bs, bt, w1, b1, w2, b2)]
    _close(attn_math.attn_math_plain(*t).numpy(), want_out, what="out")
    d_bs, d_bt, d_hpre, dw2, db1, db2 = attn_math.attn_math_bwd_plain(
        t[0], t[1], torch.from_numpy(g), *t[2:])
    dw1 = attn_math.attn_math_dw1(t[0], t[1], d_hpre)
    names = ("d_bs", "d_bt", "dW1", "db1", "dW2", "db2")
    for name, got, w in zip(names, (d_bs, d_bt, dw1, db1, dw2, db2), want):
        _close(got.numpy(), w, what=name)

    leaves = [x.clone().requires_grad_() for x in t]
    before = (attn_math.fwd_launches, attn_math.bwd_launches)
    out = attn_math.attn_math(*leaves)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    assert (attn_math.fwd_launches, attn_math.bwd_launches) == before
    for name, x, w in zip(("d_bs", "d_bt", "dW1", "db1", "dW2", "db2"),
                          leaves, want):
        _close(x.grad.numpy(), w, what=f"autograd {name}")


@pytest.mark.parametrize("N,k,C,D,slope", [
    pytest.param(70, 3, 8, 16, 0.1, id="k3"),
    pytest.param(37, 5, 5, 12, 0.1, id="k5-ragged"),
    pytest.param(50, 3, 6, 10, 0.0, id="k3-relu"),
])
def test_attn_math_bwd_from_hpre_matches_recompute_and_pallas(N, k, C, D,
                                                               slope):
    """The backward kernels start from the forward's hpre; so does the plain
    twin given `hpre=`: bitwise equal to the twin that recomputes it (the
    same products), and within REL of each output's max of gfla_tpu's
    interpreted `_attn_math_bwd_pallas`, which recomputes."""
    bs, bt, w1, b1, w2, b2, g = _blocks(N, k, C, D, 3 * N + k)
    jargs = [jnp.asarray(a) for a in (bs, bt, w1, b1, w2, b2)]
    want = _attn_math_bwd_pallas(jargs[0], jargs[1], jnp.asarray(g),
                                 *jargs[2:], slope, interpret=True)
    t = [torch.from_numpy(a) for a in (bs, bt, w1, b1, w2, b2)]
    g = torch.from_numpy(g)
    out, hpre = attn_math.attn_math_plain(*t, slope, with_hpre=True)
    assert tuple(hpre.shape) == (N, D)
    assert torch.equal(out, attn_math.attn_math_plain(*t, slope))
    given = attn_math.attn_math_bwd(t[0], t[1], g, *t[2:], slope, hpre)
    again = attn_math.attn_math_bwd_plain(t[0], t[1], g, *t[2:], slope)
    names = ("d_bs", "d_bt", "d_hpre", "dW2", "db1", "db2")
    for name, a, b in zip(names, given, again):
        assert torch.equal(a, b), name
    d_bs, d_bt, d_hpre, dw2, db1, db2 = given
    dw1 = attn_math.attn_math_dw1(t[0], t[1], d_hpre)
    for name, got, w in zip(("d_bs", "d_bt", "dW1", "db1", "dW2", "db2"),
                            (d_bs, d_bt, dw1, db1, dw2, db2), want):
        _close(got.numpy(), w, what=name)


@pytest.mark.parametrize("slope", [0.1, 0.0], ids=["leaky", "relu"])
def test_attn_math_function_saves_hpre(slope):
    """On CPU tensors AttnMathFunction keeps the forward's hpre (N, D) for
    its backward, as on the card, launches nothing, and its gradients match
    gfla_tpu's custom VJP over the interpreted Pallas kernels."""
    N, k, C, D = 45, 3, 7, 9
    bs, bt, w1, b1, w2, b2, g = _blocks(N, k, C, D, 11)
    jargs = [jnp.asarray(a) for a in (bs, bt, w1, b1, w2, b2)]
    out_j, vjp = jax.vjp(lambda *a: pallas_attn.attn_math_fused(
        *a, slope, True), *jargs)
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (bs, bt, w1, b1, w2, b2)]
    before = (attn_math.fwd_launches, attn_math.bwd_launches)
    out = attn_math.attn_math(*leaves, slope)
    saved = out.grad_fn.saved_tensors
    hpre = attn_math.attn_math_plain(*(x.detach() for x in leaves), slope,
                                     with_hpre=True)[1]
    assert any(tuple(x.shape) == (N, D) and torch.equal(x, hpre)
               for x in saved)
    out.backward(torch.from_numpy(g))
    assert (attn_math.fwd_launches, attn_math.bwd_launches) == before
    _close(out.detach().numpy(), out_j, rel=2e-5, what="out")
    for name, x, w in zip(("d_bs", "d_bt", "dW1", "db1", "dW2", "db2"),
                          leaves, want):
        _close(x.grad.numpy(), w, what=name)


def test_attn_math_function_gradcheck_f64():
    rng = np.random.RandomState(9)
    N, k2, C, D = 7, 9, 3, 5
    args = [rng.randn(N, k2, C), rng.randn(N, k2, C),
            rng.randn(k2, 2 * C, D) * 0.3, rng.randn(D) * 0.1,
            rng.randn(D, k2) * 0.3, rng.randn(k2) * 0.1]
    args = [torch.from_numpy(a).requires_grad_() for a in args]
    assert torch.autograd.gradcheck(
        lambda *x: attn_math.AttnMathFunction.apply(*x, 0.1), args,
        eps=1e-6, atol=1e-6)


def test_attn_math_refuses_devices_without_a_kernel():
    x = torch.zeros(4, 9, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attn_math.attn_math_fwd(x, x, torch.zeros(9, 16, 4, device="meta"),
                                x[0, 0, :4], x[0, :4, :9].t(), x[0, 0, :9])


def _warp_inputs(k, seed, b=2, h=8, w=8, c=8, d=16):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return dict(
        source=rng.randn(b, h, w, c).astype(f32),
        target=rng.randn(b, h, w, c).astype(f32),
        flow=(rng.randn(b, h, w, 2) * 1.5).astype(f32),
        w1=(rng.randn(k * k, 2 * c, d) * 0.2).astype(f32),
        b1=(rng.randn(d) * 0.1).astype(f32),
        w2=(rng.randn(d, k * k) * 0.3).astype(f32),
        b2=(rng.randn(k * k) * 0.1).astype(f32),
    ), rng.randn(b, h, w, c).astype(f32)


@pytest.mark.parametrize("env,k", [("0", 3), ("1", 3), ("1", 5)])
def test_local_attn_warp_under_switch_matches_jax(monkeypatch, env, k):
    monkeypatch.setenv("GFLA_ATTN_PALLAS", env)
    a, g = _warp_inputs(k, seed=int(env) * 10 + k)

    def f(*args):
        return jax_local_attn.local_attn_warp(*args[:3], k, *args[3:])

    out_j, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in NAMES))
    want = vjp(jnp.asarray(g))
    t = {n: torch.from_numpy(a[n]).requires_grad_() for n in NAMES}
    out = local_attn.local_attn_warp(t["source"], t["target"], t["flow"], k,
                                     t["w1"], t["b1"], t["w2"], t["b2"])
    out.backward(torch.from_numpy(g))
    _close(out.detach().numpy(), out_j, rel=2e-5, what="out")
    for name, w in zip(NAMES, want):
        _close(t[name].grad.numpy(), w, what=f"d {name}")


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_attn_math_route_takes_any_slope(monkeypatch, slope):
    """Under GFLA_ATTN_PALLAS=1 a ReLU or a LeakyReLU of another slope goes
    to the attention-math route with that slope, and matches gfla_tpu's
    composition with the same activation: output and every gradient."""
    monkeypatch.setenv("GFLA_ATTN_PALLAS", "1")
    a, g = _warp_inputs(3, seed=31 + int(slope * 10))
    seen = []
    real = attn_math.attn_math

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(attn_math, "attn_math", spy)
    act = nn.ReLU() if slope == 0.0 else nn.LeakyReLU(slope)
    j_act = jax.nn.relu if slope == 0.0 else (
        lambda x: jax.nn.leaky_relu(x, slope))

    def f(*args):
        return jax_local_attn.local_attn_warp(*args[:3], 3, *args[3:],
                                              activation=j_act)

    out_j, vjp = jax.vjp(f, *(jnp.asarray(a[n]) for n in NAMES))
    want = vjp(jnp.asarray(g))
    t = {n: torch.from_numpy(a[n]).requires_grad_() for n in NAMES}
    out = local_attn.local_attn_warp(t["source"], t["target"], t["flow"], 3,
                                     t["w1"], t["b1"], t["w2"], t["b2"],
                                     activation=act)
    out.backward(torch.from_numpy(g))
    assert seen == [slope]
    _close(out.detach().numpy(), out_j, rel=2e-5, what="out")
    for name, w in zip(NAMES, want):
        _close(t[name].grad.numpy(), w, what=f"d {name}")


def _spy(calls, name, result):
    def fn(*args, **kwargs):
        calls.append(name)
        return result(*args)
    return fn


@pytest.mark.parametrize("env,activation,return_attn,port,gfla", [
    ("0", None, False, "composite", "composite"),
    ("1", None, False, "attn_math", "attn_math"),
    ("1", nn.ReLU(), False, "attn_math", "composite"),
    ("1", None, True, "composite", "composite"),
    ("warp", None, False, "warp", "warp"),
    ("auto", None, False, "warp", "warp on the accelerator"),
])
def test_switch_selects_gfla_tpu_route(monkeypatch, env, activation,
                                       return_attn, port, gfla):
    """Which route each GFLA_ATTN_PALLAS value selects, in both packages.
    gfla_tpu's `auto` takes the warp kernel on its accelerator and the XLA
    composition on the CPU; the port takes the warp route on every device
    (its CPU twin is plain torch), so the accelerator case is shown with
    gfla_tpu's backend check patched. Under `1` gfla_tpu fuses only
    LeakyReLU(0.1); the port's kernel takes any slope, so ReLU stays on it
    (its values: test_attn_math_route_takes_any_slope)."""
    monkeypatch.setenv("GFLA_ATTN_PALLAS", env)
    B, H, W, C, D, k = 1, 16, 16, 128, 128, 3  # eligible for the fused warp
    rng = np.random.RandomState(0)
    a = {"source": rng.randn(B, H, W, C), "target": rng.randn(B, H, W, C),
         "flow": rng.randn(B, H, W, 2), "w1": rng.randn(k * k, 2 * C, D),
         "b1": rng.randn(D), "w2": rng.randn(D, k * k), "b2": rng.randn(k * k)}
    a = {n: v.astype(np.float32) for n, v in a.items()}

    calls = []
    zeros = lambda *args: torch.zeros(B, H, W, C)  # noqa: E731
    monkeypatch.setattr(local_attn, "_composite", _spy(
        calls, "composite", lambda *args: (torch.zeros(B, H, W, k * k),
                                           zeros()) if return_attn
        else zeros()))
    monkeypatch.setattr(attn_math, "attn_math", _spy(
        calls, "attn_math", lambda *args: torch.zeros(B * H * W, C)))
    monkeypatch.setattr(warp, "warp_fwd", _spy(calls, "warp", zeros))
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    act = activation if activation is not None else nn.LeakyReLU(0.1)
    local_attn.local_attn_warp(t["source"], t["target"], t["flow"], k,
                               t["w1"], t["b1"], t["w2"], t["b2"],
                               activation=act, return_attn=return_attn)
    assert calls == [port]

    jcalls = []
    monkeypatch.setattr(pallas_attn, "attn_math_fused", _spy(
        jcalls, "attn_math", lambda *args: jnp.zeros((B * H * W, C))))
    monkeypatch.setattr(pallas_warp, "local_attn_warp_fused", _spy(
        jcalls, "warp", lambda *args: jnp.zeros((B, H, W, C))))
    if env == "auto":
        monkeypatch.setattr(jax_local_attn, "_warp_default_ok", lambda: True)
    j_act = None if activation is None else jax.nn.relu
    jax_local_attn.local_attn_warp(
        *(jnp.asarray(a[n]) for n in ("source", "target", "flow")), k,
        *(jnp.asarray(a[n]) for n in ("w1", "b1", "w2", "b2")),
        activation=j_act, return_attn=return_attn)
    assert (jcalls or ["composite"]) == [gfla.split()[0]]
    if env == "auto":  # on the CPU gfla_tpu takes the composition
        monkeypatch.undo()
        assert not jax_local_attn._warp_default_ok()
