"""The port's training slice against gfla_tpu, on the CPU.

Same inputs (seeded numpy) and the same weights (gfla_tpu's variables carried
across with gfla_tpu_torch.convert) go through both packages in f32:
spectral-norm conv, ResDiscriminator, VGG19, gaussian_resample, each loss,
Adam under the three learning-rate policies, and one whole D-then-G step at
32x32 with ngf 16 and img_f 64. Tolerances: 1e-4 x the largest |value| for
modules and gradients (sums in other orders, f32; 1e-6 or better observed),
1e-4 relative for the step's losses; updated parameters by the masked rule
(1e-6 abs where |grad| > 1e-3 x the tensor's max |grad|, 2 lr everywhere),
since Adam's first step with beta1 = 0 is about lr * sign(grad) and an entry
whose gradient is nearly 0 may move either way.
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gfla_tpu.data import encode_heatmaps as jax_encode_heatmaps
from gfla_tpu.losses import MultiAffineRegularizationLoss as JaxAffine
from gfla_tpu.losses import PerceptualCorrectness as JaxCorrectness
from gfla_tpu.losses import adversarial_loss as jax_adversarial_loss
from gfla_tpu.losses import vgg_content_style_loss as jax_content_style
from gfla_tpu.losses.perceptual import _chunked_max_correlation
from gfla_tpu.models.discriminators import ResDiscriminator as JaxResD
from gfla_tpu.models.generators import PoseGenerator as JaxPoseGenerator
from gfla_tpu.models.vgg import VGG19 as JaxVGG19
from gfla_tpu.nn import norms as jnorms
from gfla_tpu.ops.gaussian_resample import gaussian_resample as jax_resample
from gfla_tpu.tasks import create_task as jax_create_task
from gfla_tpu.train.state import make_optimizer as jax_make_optimizer
from gfla_tpu_torch import convert
from gfla_tpu_torch.losses import (
    MultiAffineRegularizationLoss,
    PerceptualCorrectness,
    adversarial_loss,
    vgg_content_style_loss,
)
from gfla_tpu_torch.losses.perceptual import MaxCorrelation
from gfla_tpu_torch.models import define_d, define_g
from gfla_tpu_torch.models.vgg import VGG19
from gfla_tpu_torch.nn.norms import SpectralConv2d, SpectralConvTranspose2x
from gfla_tpu_torch.ops.gaussian_resample import gaussian_resample
from gfla_tpu_torch.tasks.pose import PoseTask
from gfla_tpu_torch.train.state import make_optimizer

REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the other test workers share these cores, where
    torch's default of one thread a core oversubscribes them many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _noise(tree, seed, scale=1.0):
    """Every leaf replaced by seeded noise: kernels N(0, scale^2/fan_in),
    vectors N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten(tree)
    leaves = []
    for leaf in flat:
        noise = np.asarray(rng.randn(*leaf.shape), np.float32)
        if leaf.ndim >= 2 and leaf.shape[0] != 1:
            noise *= scale / np.sqrt(np.prod(leaf.shape[:-1]))
        elif leaf.ndim < 2:
            noise *= 0.1
        leaves.append(noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _load(module, sd, prefix=""):
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                            if k.startswith(prefix)}, strict=True)
    return module


# ---------------------------------------------------------------------------
# spectral norm and the discriminator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("update", [True, False])
def test_spectral_conv_matches_flax(update):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 10, 12, 5).astype(np.float32)
    r = rng.randn(2, 5, 6, 6).astype(np.float32)
    jmod = jnorms.Conv2d(6, (4, 4), (2, 2), 1, use_spect=True)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _noise(v["params"], 2)
    stats = _noise(v["batch_stats"], 3)

    def f(p, x):
        out, new = jmod.apply({"params": p, "batch_stats": stats}, x,
                              update_stats=update, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(r)), (out, new)

    (_, (out_j, new_j)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    sd = {}
    convert._conv(params, "c", sd, stats)
    port = _load(SpectralConv2d(5, 6, 4, 2, 1), sd, "c.")
    xt = _nchw(x).requires_grad_()
    out = port(xt, update_stats=update)
    (out * _nchw(r)).sum().backward()
    _close(_nhwc(out), out_j, what="out")
    _close(_nhwc(xt.grad), gx, what="d x")
    _close(port.weight_orig.grad.permute(2, 3, 1, 0).numpy(),
           gp["Conv_0"]["kernel"], what="d kernel")
    _close(port.bias.grad.numpy(), gp["Conv_0"]["bias"], what="d bias")
    u_j = new_j["batch_stats"]["SpectralNorm_0"]["Conv_0/kernel/u"]
    _close(port.weight_u.numpy(), np.asarray(u_j).reshape(-1), what="u")
    if not update:  # iterated but not stored, in both
        _close(port.weight_u.numpy(), sd["c.weight_u"].numpy(), rel=0)


@pytest.mark.parametrize("update", [True, False])
def test_spectral_conv_transpose_matches_flax(update):
    rng = np.random.RandomState(14)
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    r = rng.randn(2, 10, 12, 7).astype(np.float32)
    jmod = jnorms.ConvTranspose2x(7, use_spect=True)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _noise(v["params"], 15)
    stats = _noise(v["batch_stats"], 16)

    def f(p, x):
        out, new = jmod.apply({"params": p, "batch_stats": stats}, x,
                              update_stats=update, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(r)), (out, new)

    (_, (out_j, new_j)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    sd, grads = {}, {}
    convert._conv_transpose(params, "c", sd, stats)
    convert._conv_transpose(gp, "c", grads, stats)
    port = _load(SpectralConvTranspose2x(4, 7), sd, "c.")
    xt = _nchw(x).requires_grad_()
    out = port(xt, update_stats=update)
    (out * _nchw(r)).sum().backward()
    _close(_nhwc(out), out_j, what="out")
    _close(_nhwc(xt.grad), gx, what="d x")
    _close(port.weight_orig.grad.numpy(), grads["c.weight_orig"].numpy(),
           what="d kernel")
    _close(port.bias.grad.numpy(), grads["c.bias"].numpy(), what="d bias")
    u_j = new_j["batch_stats"]["SpectralNorm_0"]["ConvTranspose_0/kernel/u"]
    _close(port.weight_u.numpy(), np.asarray(u_j).reshape(-1), what="u")


SPECT_G = dict(image_nc=3, structure_nc=18, output_nc=3, ngf=16, img_f=64,
               layers=3, num_blocks=2, norm_type="instance",
               activation="LeakyReLU", attn_layer=(2, 3),
               extractor_kz={"2": 5, "3": 3}, use_spect=True)


@pytest.fixture(scope="module")
def spectral_generator():
    """gfla_tpu's spectral-norm PoseGenerator at 32x32 with noise params and
    u, and its inputs."""
    rng = np.random.RandomState(17)
    p1 = np.tanh(rng.randn(2, H, W, 3)).astype(np.float32)
    bp1, bp2 = (rng.rand(2, H, W, 18).astype(np.float32) for _ in "ab")
    r = rng.randn(2, H, W, 3).astype(np.float32)
    jmod = JaxPoseGenerator(**SPECT_G)
    v = jax.jit(jmod.init)(jax.random.PRNGKey(0), *(
        jnp.asarray(a) for a in (p1, bp1, bp2)))
    return (jmod, _noise(v["params"], 18), _noise(v["batch_stats"], 19),
            (p1, bp1, bp2, r))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_spectral_generator_matches_flax(spectral_generator, train):
    """--use_spect_g at 32x32, ngf 16, img_f 64: the image, flows and masks,
    and the u of every spectral conv, stored in train mode and left as it
    was in eval mode; in train mode also the gradients of the source image
    and of every parameter."""
    jmod, params, stats, (p1, bp1, bp2, r) = spectral_generator
    args = tuple(jnp.asarray(a) for a in (p1, bp1, bp2))

    def f(p, p1):
        (img, flows, masks), new = jmod.apply(
            {"params": p, "batch_stats": stats}, p1, *args[1:], train=train,
            update_stats=train, mutable=["batch_stats"])
        return jnp.sum(img * jnp.asarray(r)), (img, flows, masks, new)

    if train:
        (_, (img_j, flows_j, masks_j, new_j)), (gp, gx) = jax.jit(
            jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
                params, args[0])
    else:
        _, (img_j, flows_j, masks_j, new_j) = jax.jit(f)(params, args[0])
    port = define_g("pose", **SPECT_G)
    port.load_state_dict(convert.pose_generator_state_dict(
        params, batch_stats=stats), strict=True)
    port.train(train)
    x = _nchw(p1).requires_grad_()
    img, flows, masks = port(x, _nchw(bp1), _nchw(bp2))
    _close(_nhwc(img), img_j, what="img")
    for a, b in zip(flows + masks, list(flows_j) + list(masks_j)):
        _close(_nhwc(a), b, what="flow/mask")
    want_u = convert.pose_generator_state_dict(
        params, batch_stats=new_j["batch_stats"])
    got = port.state_dict()
    keys = [k for k in got if k.endswith("weight_u")]
    assert len(keys) == 54  # every block conv and the Jump/Output aliases
    for key in keys:
        _close(got[key].numpy(), want_u[key].numpy(), what=key)
    if not train:
        return
    (img * _nchw(r)).sum().backward()
    _close(_nhwc(x.grad), gx, what="d source image")
    # held at the scale of the net's largest gradient: a conv bias feeding
    # an instance norm has an exact gradient of 0, and f32 rounding as its
    # gradient in both packages (the whole step's test holds the rest)
    want_g = convert.pose_generator_state_dict(gp, batch_stats=stats)
    scale = max(np.abs(want_g[n].numpy()).max()
                for n, _ in port.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=0, atol=REL * scale,
                                   err_msg=f"d {name}")


@pytest.fixture(scope="module")
def discriminator_pair():
    jmod = JaxResD(ndf=8, img_f=32, layers=3, use_spect=True)
    x0 = jnp.zeros((1, 32, 32, 3))
    v = jmod.init(jax.random.PRNGKey(0), x0)
    params = _noise(v["params"], 4, scale=2.0)
    stats = _noise(v["batch_stats"], 5)
    sd = convert.res_discriminator_state_dict(params, stats, layers=3)
    port = define_d("res", ndf=8, img_f=32, layers=3, use_spect=True)
    port.load_state_dict(sd, strict=True)
    return jmod, params, stats, port


@pytest.mark.parametrize("update", [True, False])
def test_res_discriminator_matches_flax(discriminator_pair, update):
    jmod, params, stats, port = discriminator_pair
    port = copy.deepcopy(port)
    x = np.tanh(np.random.RandomState(6).randn(2, 32, 32, 3)).astype(
        np.float32)

    def f(x):
        out, new = jmod.apply({"params": params, "batch_stats": stats}, x,
                              update_stats=update, mutable=["batch_stats"])
        return jnp.sum(out * out), (out, new)

    (_, (out_j, new_j)), gx = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    out = port(xt, update_stats=update)
    (out * out).sum().backward()
    assert out.shape == (2, 1, 4, 4)
    _close(_nhwc(out), out_j, what="logits")
    _close(_nhwc(xt.grad), gx, what="d x")
    want = convert.res_discriminator_state_dict(
        params, new_j["batch_stats"], layers=3)
    got = port.state_dict()
    for key in want:
        if key.endswith("weight_u"):
            _close(got[key].numpy(), want[key].numpy(), what=key)


def test_res_discriminator_state_dict_has_the_original_keys(
        discriminator_pair):
    port = discriminator_pair[3]
    keys = set(port.state_dict())
    assert {"block0.model.1.weight_orig", "block0.model.3.weight_u",
            "block0.shortcut.1.weight_v", "encoder1.model.3.bias",
            "conv.weight_orig", "conv.weight_u"} <= keys
    assert not any(k.endswith(".weight") for k in keys)
    nospect = define_d("res", ndf=8, img_f=32, layers=3, use_spect=False)
    assert "block0.model.1.weight" in nospect.state_dict()
    assert "conv.weight_orig" in nospect.state_dict()  # always spectral


# ---------------------------------------------------------------------------
# VGG19, gaussian_resample and the losses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg_pair():
    jparams = jax.jit(JaxVGG19().init)(jax.random.PRNGKey(3),
                                       jnp.zeros((1, 32, 32, 3)))
    vgg = VGG19()
    vgg.load_state_dict(convert.vgg19_state_dict(jparams), strict=True)
    return jparams, vgg.eval()


def test_vgg19_features_match_flax(vgg_pair):
    jparams, vgg = vgg_pair
    x = np.tanh(np.random.RandomState(7).randn(2, 32, 32, 3)).astype(
        np.float32)
    want = JaxVGG19().apply(jparams, jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    got = vgg(xt)
    assert sorted(got) == sorted(want) and len(got) == 16
    for name in want:
        _close(_nhwc(got[name]), want[name], what=name)
    got["relu3_1"].sum().backward()
    gx = jax.grad(lambda x: JaxVGG19().apply(jparams, x)["relu3_1"].sum())(
        jnp.asarray(x))
    _close(_nhwc(xt.grad), gx, what="d x")
    assert all(p.grad is None for p in vgg.parameters())


@pytest.mark.parametrize("k,dil,sigma,scale", [
    (4, 1, 2.0, 1.5),    # the correctness loss's configuration
    (2, 2, 5.0, 3.0),
    (4, 1, 2.0, 40.0),   # far off the image: edge-clamped taps
])
def test_gaussian_resample_matches_jax(k, dil, sigma, scale):
    rng = np.random.RandomState(k + dil)
    src = rng.randn(2, 7, 9, 3).astype(np.float32)
    flow = (rng.randn(2, 7, 9, 2) * scale).astype(np.float32)
    r = rng.randn(2, 7, 9, 3).astype(np.float32)

    def f(s, fl):
        return jnp.sum(jax_resample(s, fl, k, dil, sigma) * r)

    want = jax_resample(jnp.asarray(src), jnp.asarray(flow), k, dil, sigma)
    gs, gf = jax.grad(f, argnums=(0, 1))(jnp.asarray(src), jnp.asarray(flow))
    st = torch.from_numpy(src).requires_grad_()
    ft = torch.from_numpy(flow).requires_grad_()
    out = gaussian_resample(st, ft, k, dil, sigma)
    (out * torch.from_numpy(r)).sum().backward()
    _close(out.detach().numpy(), want, what="out")
    _close(st.grad.numpy(), gs, what="d source")
    _close(ft.grad.numpy(), gf, what="d flow")


@pytest.mark.parametrize("gan_mode", ["lsgan", "hinge", "nsgan"])
def test_adversarial_loss_matches_jax(gan_mode):
    x = np.random.RandomState(8).randn(2, 1, 4, 4).astype(np.float32)
    for is_real in (True, False):
        for for_dis in (True, False):
            want = jax_adversarial_loss(jnp.asarray(x), is_real, for_dis,
                                        gan_mode)
            got = adversarial_loss(torch.from_numpy(x), is_real, for_dis,
                                   gan_mode)
            _close(got.numpy(), want, what=f"{is_real} {for_dis}")


def test_content_style_loss_matches_jax(vgg_pair):
    jparams, vgg = vgg_pair
    rng = np.random.RandomState(9)
    x, y = (np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32)
            for _ in "xy")

    def f(x):
        c, s = jax_content_style(jparams, x, jnp.asarray(y))
        return c + 100.0 * s, (c, s)

    (_, (c_j, s_j)), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    c, s = vgg_content_style_loss(vgg, xt, _nchw(y))
    (c + 100.0 * s).backward()
    _close(c.detach().numpy(), c_j, what="content")
    _close(s.detach().numpy(), s_j, what="style")
    _close(_nhwc(xt.grad), gx, what="d x")


def test_max_correlation_ties_and_grads_match_jax():
    """Several chunks, duplicated source rows (ties go to the first index)
    and an all-zero target row."""
    rng = np.random.RandomState(10)
    s = rng.randn(2, 37, 6).astype(np.float32)
    s[:, 20] = s[:, 3]
    s[:, 30] = s[:, 3]
    t = rng.randn(2, 11, 6).astype(np.float32)
    t[:, 4] = s[:, 3] * 2.0
    t[:, 5] = 0.0
    g = rng.randn(2, 11).astype(np.float32)

    def f(s, t):
        return jnp.sum(_chunked_max_correlation(s, t, 8) * g)

    want = _chunked_max_correlation(jnp.asarray(s), jnp.asarray(t), 8)
    ds_j, dt_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(t))
    st = torch.from_numpy(s).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    out = MaxCorrelation.apply(st, tt, 8)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach().numpy(), want, what="cmax")
    _close(st.grad.numpy(), ds_j, what="d source")
    _close(tt.grad.numpy(), dt_j, what="d target")
    assert st.grad[:, 3].abs().sum() > 0
    assert st.grad[:, 20].abs().sum() == st.grad[:, 30].abs().sum() == 0


@pytest.mark.parametrize("flow_sizes", [((4, 4), (8, 8)), ((8, 8), (16, 16))],
                         ids=["at-feature-size", "nearest-resized"])
def test_correctness_loss_matches_jax(vgg_pair, flow_sizes):
    jparams, vgg = vgg_pair
    rng = np.random.RandomState(11)
    tgt, src = (np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32)
                for _ in "ts")
    flows = [(rng.randn(2, h, w, 2) * 1.5).astype(np.float32)
             for h, w in flow_sizes]

    def f(flows):
        return JaxCorrectness(jparams)(jnp.asarray(tgt), jnp.asarray(src),
                                       flows, [2, 3])

    want, gf = jax.value_and_grad(f)([jnp.asarray(x) for x in flows])
    ft = [_nchw(x).requires_grad_() for x in flows]
    got = PerceptualCorrectness(vgg)(_nchw(tgt), _nchw(src), ft, [2, 3])
    got.backward()
    _close(got.detach().numpy(), want, what="loss")
    for a, b in zip(ft, gf):
        _close(_nhwc(a.grad), b, what="d flow")


def test_affine_regularization_matches_jax():
    rng = np.random.RandomState(12)
    flows = [(rng.randn(2, h, h, 2) * 2).astype(np.float32) for h in (8, 16)]
    kz = {2: 5, 3: 3}
    want, gf = jax.value_and_grad(lambda f: JaxAffine(kz)(f))(
        [jnp.asarray(x) for x in flows])
    ft = [_nchw(x).requires_grad_() for x in flows]
    got = MultiAffineRegularizationLoss(kz)(ft)
    got.backward()
    _close(got.detach().numpy(), want, what="loss")
    for a, b in zip(ft, gf):
        _close(_nhwc(a.grad), b, what="d flow")


@pytest.mark.parametrize("policy,kw", [
    ("lambda", dict(niter=3, niter_decay=4, iters_per_epoch=2)),
    ("step", dict(iters_per_epoch=1, lr_decay_iters=2)),
    ("exponent", dict(iters_per_epoch=2)),
])
def test_adam_and_lr_policies_match_optax(policy, kw):
    """Eight Adam steps under each policy: the learning rate at step n is
    optax's schedule(n), and the parameters follow optax's."""
    rng = np.random.RandomState(13)
    grads = rng.randn(8, 5).astype(np.float32) + 2.0 * np.sign(
        rng.randn(8, 5)).astype(np.float32)
    p0 = rng.randn(5).astype(np.float32)
    tx = jax_make_optimizer(1e-2, policy=policy, **kw)
    pj, state = jnp.asarray(p0), None
    state = tx.init(pj)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = make_optimizer([param], 1e-2, policy=policy, **kw)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        param.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(pj),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------

H = W = 32


def _opt(**over):
    opt = argparse.Namespace(
        model="pose", dataset_mode="synthetic", phase="train", isTrain=True,
        batchSize=2, load_size=H, old_size=(H, W), structure_nc=18,
        image_nc=3, layers=3, attn_layer=[2, 3], ngf=16, img_f=64,
        kernel_size={"2": 5, "3": 3}, use_spect_g=False, no_spect_d=False,
        lr=1e-4, lr_policy="lambda", niter=100, niter_decay=0, iter_count=1,
        iters_per_epoch=10, gan_mode="lsgan", ratio_g2d=0.1,
        lambda_rec=5.0, lambda_g=2.0, lambda_correct=5.0, lambda_style=500.0,
        lambda_content=0.5, lambda_regularization=0.0025,
        compute_dtype="float32", seed=0, gpu_ids="-1")
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _batch(seed):
    rng = np.random.RandomState(seed)
    kp = rng.rand(2, 2, 18, 2).astype(np.float32) * (H - 1)
    return {"P1": (rng.rand(2, H, W, 3) * 2 - 1).astype(np.float32),
            "P2": (rng.rand(2, H, W, 3) * 2 - 1).astype(np.float32),
            "BP1": np.asarray(jax_encode_heatmaps(jnp.asarray(kp[0]), H, W)),
            "BP2": np.asarray(jax_encode_heatmaps(jnp.asarray(kp[1]), H, W))}


def _port_batch(b):
    return {k: _nchw(v).contiguous(memory_format=torch.channels_last)
            for k, v in b.items()}


def _port_sds(task_j, state):
    g = convert.pose_generator_state_dict(jax.device_get(state.params_g))
    d = convert.res_discriminator_state_dict(
        jax.device_get(state.params_d), jax.device_get(state.stats_d),
        layers=4)
    return g, d


@pytest.fixture(scope="module")
def step_pair():
    """gfla_tpu's pose task and one step of it, and the port's task
    holding the same state before the step."""
    opt = _opt()
    task_j = jax_create_task(opt)
    batch = _batch(0)
    state = task_j.init_state(jax.random.PRNGKey(0),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    g_sd, d_sd = _port_sds(task_j, state)
    task = PoseTask(opt)
    task.net_g.load_state_dict(g_sd, strict=True)
    task.net_d.load_state_dict(d_sd, strict=True)
    task.vgg.load_state_dict(convert.vgg19_state_dict(
        jax.device_get(task_j.vgg_params)), strict=True)
    state2, logs_j = task_j.train_step(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return task_j, jax.device_get(state2), jax.device_get(logs_j), task, batch


def _grads(net):
    return {n: p.grad.detach().clone() for n, p in net.named_parameters()}


@pytest.fixture(scope="module")
def exact_grads(step_pair):
    """The port's step in float64 from the same state: the exact gradients
    that each f32 gradient is judged against."""
    task = copy.deepcopy(step_pair[3])
    for module in (task.net_g, task.net_d, task.vgg):
        module.double()
    task.train_step({k: v.double()
                     for k, v in _port_batch(step_pair[4]).items()})
    return _grads(task.net_g), _grads(task.net_d)


def test_train_step_matches_gfla_tpu(step_pair, exact_grads):
    """Losses and u against gfla_tpu's step; gradients and updated
    parameters against gfla_tpu's and the exact (f64) ones.

    Adam's first step with beta1 = 0 is lr * g / (|g| + eps): its sign
    follows the gradient's however small, so the updated parameters are
    held by the masked rule, and only where f32 resolves the gradient:
    - a tensor whose exact gradient is 0 (a conv bias that feeds an
      instance norm) gets f32 roundoff as its gradient in both packages and
      is held to 2 lr only;
    - a tensor where gfla_tpu's own f32 gradient is off the exact one by
      more than 1e-3 of its largest entry (at 32x32, the two norm biases
      around the flow net's 1x1 bottleneck, where gfla_tpu's is 10x the
      exact one) is held by the port's gradient against the exact one, to
      1e-3 of its largest entry, as every other tensor with a gradient is.
    """
    task_j, state2, logs_j, task, batch = step_pair
    task = copy.deepcopy(task)
    logs = task.train_step(_port_batch(batch))
    assert sorted(logs) == sorted(PoseTask.loss_names + ["total_G"])
    for name, want in logs_j.items():
        got = float(logs[name])
        assert np.isfinite(got)
        assert abs(got - float(want)) <= REL * abs(float(want)), (
            name, got, float(want))

    g_want, d_want = _port_sds(task_j, state2)
    d_got = task.net_d.state_dict()
    for key in d_want:
        if key.endswith("weight_u"):
            _close(d_got[key].numpy(), d_want[key].numpy(), what=key)

    # beta1 = 0: optax's first moment after one step is the gradient
    g_ref = convert.pose_generator_state_dict(
        jax.device_get(state2.opt_state_g[0].mu))
    d_ref = convert.res_discriminator_state_dict(
        jax.device_get(state2.opt_state_d[0].mu),
        jax.device_get(state2.stats_d), layers=4)
    unresolved = []
    for net, want, ref, exact, lr in (
            (task.net_g, g_want, g_ref, exact_grads[0], 1e-4),
            (task.net_d, d_want, d_ref, exact_grads[1], 1e-5)):
        scale = max(g.abs().max().item() for g in exact.values())
        for name, p in net.named_parameters():
            got, w = p.detach(), want[name]
            assert (got - w).abs().max() <= 2 * lr, name
            g64 = exact[name]
            top = g64.abs().max().item()
            if top <= 1e-9 * scale:  # exactly 0 in f64
                continue
            assert (p.grad.double() - g64).abs().max() <= 1e-3 * top, name
            if (ref[name].double() - g64).abs().max() > 1e-3 * top:
                unresolved.append(name)
                continue
            big = g64.abs() > 1e-3 * top
            assert (got - w)[big].abs().max() <= 1e-6, name
    assert len(unresolved) <= 2, unresolved


def test_checkpoint_resume_continues_the_run(step_pair, tmp_path):
    """save -> --continue_train -> the next step equals the uninterrupted
    run's."""
    task = copy.deepcopy(step_pair[3])
    task.opt = _opt(checkpoints_dir=str(tmp_path), name="exp")
    b1, b2 = _port_batch(_batch(1)), _port_batch(_batch(2))
    task.train_step(b1)
    task.save(1)
    names = sorted(p.name for p in (tmp_path / "exp").iterdir())
    assert names == ["1_net_D.pth", "1_net_G.pth", "1_train_state.pth",
                     "latest", "latest_net_D.pth", "latest_net_G.pth",
                     "latest_train_state.pth"]
    want = task.train_step(b2)

    torch.manual_seed(123)  # a fresh init, overwritten by the resume
    resumed = PoseTask(_opt(checkpoints_dir=str(tmp_path), name="exp",
                            seed=5))
    resumed.vgg.load_state_dict(task.vgg.state_dict())
    assert resumed.resume("latest") == 1
    assert resumed.sched_g.last_epoch == 1
    got = resumed.train_step(b2)
    for name in want:
        assert torch.allclose(got[name], want[name], rtol=1e-6, atol=0), name
    for a, b in zip(resumed.net_d.state_dict().values(),
                    task.net_d.state_dict().values()):
        assert torch.allclose(a, b, rtol=0, atol=1e-7)


def test_partial_load_reports_what_it_skipped():
    from gfla_tpu_torch.train.checkpoint import partial_load

    port = define_d("res", ndf=8, img_f=32, layers=2, use_spect=True)
    sd = dict(port.state_dict())
    sd["module.block0.model.1.bias"] = sd.pop("block0.model.1.bias") + 1
    sd["extra.weight"] = torch.zeros(1)
    sd["conv.weight_orig"] = torch.zeros(1, 16, 3, 3)
    loaded, skipped = partial_load(port, sd)
    assert "block0.model.1.bias" in loaded
    assert "extra.weight" in skipped
    assert any(s.startswith("conv.weight_orig (shape") for s in skipped)
    assert torch.equal(port.block0.model[1].bias, sd[
        "module.block0.model.1.bias"])
