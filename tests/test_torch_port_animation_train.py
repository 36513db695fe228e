"""The animation heads' training (dance, face) against gfla_tpu, on the CPU.

Small sizes: 64x64 clips, batch 2, 3 frames a chunk for face and 5 for
dance (the temporal discriminator's minimum), G at ngf 8, img_f 32, layers 3
with both attention levels (k=5 at 16x16, k=3 at 8x8), the flow nets at
their fixed widths (their bottleneck 2x2, so no instance norm gives an exact
0), D and D_V at ndf 8, img_f 16, 3 layers. gfla_tpu's state is made from
the port's seeded init with gfla_tpu's own converters (dance's D_V from
gfla_tpu's init with the port's, since gfla_tpu's converter reorders its
fold), the flow heads moved off the resampler's kinks. Held:
- one chunk step of each head against gfla_tpu's `_chunk_step_impl`, its
  four random indices drawn by gfla_tpu and passed to the port: the 11
  logged losses and total_G within 1e-4 relative; every G, D and D_V
  gradient within 1e-4 x its net's largest of gfla_tpu's (Adam's first
  moment, beta1 = 0); D's and D_V's stored u within 1e-5; the carry (last
  generated frame, last skeleton, last ground truth) within 1e-4;
- face's `train_step` over a 2-chunk clip against gfla_tpu's, the second chunk
  starting from the first's carry: the averaged losses within 1e-4
  relative, every stored u within 1e-5, and each parameter reached within
  what two Adam steps can part where |grad| is near Adam's eps
  (ADAM_TWO_STEPS lr; ROADMAP.md "Not faults"), at lr 1e-6 (LR);
- `--remat` equal to the step without it, u included, with and without
  `--use_spect_g` (port only; the spectral generator's u through the
  frames is held against gfla_tpu in test_torch_port_animation.py);
- save and resume: the resumed task's next step within 1e-5 of the
  uninterrupted one's.
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfla_tpu.convert import convert_dance_generator as jax_convert_dance
from gfla_tpu.convert import convert_face_generator as jax_convert_face
from gfla_tpu.convert import convert_res_discriminator as jax_convert_res
from gfla_tpu.tasks import create_task as jax_create_task
from gfla_tpu.tasks.animation import AnimationTrainState
from gfla_tpu_torch import convert
from gfla_tpu_torch.tasks.animation import DanceTask, FaceTask

H = 64
B = 2
FRAMES = {"face": 3, "dance": 5}
NC = {"face": 16, "dance": 20}
ATTN = (2, 3)
KZ = {"2": 5, "3": 3}
D_LAYERS = 3
REL = 1e-4
# A small learning rate: Adam's first step parts two f32 summation orders by
# up to 2 lr where |grad| is near its eps (ROADMAP.md, "Not faults"), and at
# 1e-4 that moved the second chunk's correctness_p 1.1e-4 relative apart;
# at 1e-6 the second chunk starts from the same weights to f32, so the
# two-chunk test holds what it is for, the carry
LR = 1e-6
# Two Adam steps with beta1 = 0 move an entry by at most lr (the first,
# lr * g / (|g| + eps)) + sqrt((1 - 0.999^2) / (1 - 0.999)) lr (the second,
# lr * g2 / sqrt(v2 / (1 - 0.999^2)), v2 >= 0.001 g2^2); where |g| is near
# eps two summation orders may take either sign, so two runs part by at most
# twice that
ADAM_TWO_STEPS = 2 * (1 + np.sqrt((1 - 0.999**2) / (1 - 0.999)))


@pytest.fixture(scope="module", autouse=True)
def two_threads_full_xla():
    """Two intra-op threads (the other test workers share these cores), and
    XLA's optimizations back on for this module: the session turns most of
    them off (tests/conftest.py), which leaves gfla_tpu's chunk step ~12 s
    a run on the CPU against 0.8 s with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    disabled = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)
    yield
    jax.config.update("jax_disable_most_optimizations", disabled)
    torch.set_num_threads(n)


def _opt(kind, **over):
    T = FRAMES[kind]
    opt = argparse.Namespace(
        model=kind, dataset_mode="synthetic_video", phase="train",
        isTrain=True, batchSize=B, load_size=H, structure_nc=NC[kind],
        image_nc=3, layers=3, attn_layer=list(ATTN), kernel_size=dict(KZ),
        ngf=8, img_f=32, ndf=8, d_img_f=16, d_layers=D_LAYERS,
        use_spect_g=False, no_spect_d=False, lr=LR, lr_policy="lambda",
        niter=100, niter_decay=0, iter_count=1, iters_per_epoch=10,
        gan_mode="lsgan", ratio_g2d=0.1, lambda_rec=5.0, lambda_g=2.0,
        lambda_correct=5.0, lambda_style=500.0, lambda_content=0.5,
        lambda_regularization=0.0025, frames_D_V=T, max_frames_per_gpu=T,
        n_frames_total=T, use_mask=False, seed=0, gpu_ids="-1",
        compute_dtype="float32", remat=False)
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _clip(kind, frames, seed):
    """A clip in gfla_tpu's layout, (B, N, H, W, C)."""
    rng = np.random.RandomState(seed)
    nc = NC[kind]
    return {"P_all": np.tanh(rng.randn(B, frames, H, H, 3)),
            "BP_all": rng.rand(B, frames, H, H, nc),
            "ref_image": np.tanh(rng.randn(B, H, H, 3)),
            "ref_skeleton": rng.rand(B, H, H, nc)}


def _f32(batch):
    return {k: np.asarray(v, np.float32) for k, v in batch.items()}


def _port(batch):
    """gfla_tpu's layout -> the port's, (B, N, C, H, W) and (B, C, H, W)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).movedim(-1, -3)
            for k, v in _f32(batch).items()}


def _first_chunk(batch):
    return {"P_step": batch["P_all"], "BP_step": batch["BP_all"],
            "ref_image": batch["ref_image"],
            "ref_skeleton": batch["ref_skeleton"],
            "pre_image": batch["ref_image"],
            "pre_skeleton": batch["ref_skeleton"],
            "pre_gt_image": batch["ref_image"]}


def _off_the_kinks(task, seed=33):
    """The flow heads' biases to seeded fractions in [0.3, 0.7] and their
    kernels to small seeded noise: at the init the flows are ~0, every tap
    of the warp and of the resampler on an integer coordinate, where
    floor() makes two summation orders part."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, head in task.net_g.named_modules():
            if name.split(".")[-1].startswith("output") \
                    and "flow_net" in name:
                head.bias.copy_(0.3 + 0.4 * torch.rand(head.bias.shape,
                                                       generator=gen))
                fan_in = head.weight[0].numel()
                head.weight.copy_(torch.randn(head.weight.shape,
                                              generator=gen)
                                  * 0.3 / fan_in ** 0.5)
    return task


def _g_params(kind, task):
    """The port's G as gfla_tpu's params (gfla_tpu's converter)."""
    fn = jax_convert_face if kind == "face" else jax_convert_dance
    return fn(task.net_g.state_dict(), layers=3, attn_layer=ATTN)


def _g_state_dict(kind, params):
    fn = getattr(convert, f"{kind}_generator_state_dict")
    return fn(params, layers=3, attn_layer=ATTN)


def _dv_state_dict(kind, params, stats):
    if kind == "dance":
        return convert.temporal_discriminator_state_dict(params, stats,
                                                         layers=D_LAYERS)
    return convert.res_discriminator_state_dict(params, stats,
                                                layers=D_LAYERS)


def _pair(kind, seed=0, **over):
    """The port's task at its seeded init (flow heads off the kinks), and
    gfla_tpu's task and state holding the same weights, VGG19 included."""
    opt = _opt(kind, seed=seed, **over)
    task = _off_the_kinks((FaceTask if kind == "face" else DanceTask)(opt))
    task_j = jax_create_task(_opt(kind, seed=seed, **over))
    task.vgg.load_state_dict(convert.vgg19_state_dict(
        jax.device_get(task_j.vgg_params)), strict=True)
    d = jax_convert_res(task.net_d.state_dict(), layers=D_LAYERS)
    if kind == "face":
        dv = jax_convert_res(task.net_d_v.state_dict(), layers=D_LAYERS)
    else:  # gfla_tpu's init, carried into the port
        clip = jnp.zeros((B, opt.frames_D_V, H, H, 3), jnp.float32)
        dv = jax.device_get(jax.jit(task_j.net_d_v.init)(
            jax.random.PRNGKey(seed), clip))
        task.net_d_v.load_state_dict(_dv_state_dict(
            kind, dv["params"], dv["batch_stats"]), strict=True)
    params_g = _g_params(kind, task)
    params_d = {"D": d["params"], "D_V": dv["params"]}
    state = AnimationTrainState(
        step=jnp.zeros((), jnp.int32), params_g=params_g, params_d=params_d,
        stats_g={},
        stats_d={"D": d["batch_stats"], "D_V": dv["batch_stats"]},
        opt_state_g=task_j.tx_g.init(params_g),
        opt_state_d=task_j.tx_d.init(params_d))
    return task, task_j, jax.device_get(state)


def _indices(rng, T, F):
    """gfla_tpu's four draws from `rng` (tasks/animation.py:285-290)."""
    k = jax.random.split(rng, 4)
    w = max(1, T - F + 1)
    return tuple(int(jax.random.randint(key, (), 0, n))
                 for key, n in zip(k, (T, w, T, w)))


def _dev(tree):
    """On the first device, committed: the test session has 8 CPU
    devices, and a jit's cache tells committed inputs from uncommitted
    ones, which would compile gfla_tpu's chunk step again for train_step's
    second chunk (its carry is a jit output)."""
    return jax.device_put(tree, jax.devices()[0])


def _chunk_step(task_j, state, chunk, rng):
    """gfla_tpu's chunk step, compiled once: its train_step reuses it."""
    if task_j._chunk_step is None:
        task_j._chunk_step = jax.jit(task_j._chunk_step_impl)
    return jax.device_get(task_j.train_chunk(_dev(state), _dev(chunk),
                                             _dev(rng)))


def _chunk_pair(kind):
    task, task_j, state = _pair(kind)
    batch = _f32(_clip(kind, FRAMES[kind], 1))
    rng = jax.random.PRNGKey(5)
    state2, logs_j, carry_j = _chunk_step(task_j, state,
                                          _first_chunk(batch), rng)
    return kind, task, task_j, state, state2, logs_j, carry_j, batch, \
        _indices(rng, FRAMES[kind], FRAMES[kind])


@pytest.fixture(scope="module")
def face_pair():
    return _chunk_pair("face")


@pytest.fixture(scope="module")
def dance_pair():
    return _chunk_pair("dance")


@pytest.fixture(params=["face", "dance"])
def chunk_pair(request):
    return request.getfixturevalue(f"{request.param}_pair")


def _nets(task):
    return {"G": task.net_g, "D": task.net_d, "D_V": task.net_d_v}


def _hold_grads(kind, task, state2):
    mu_g = state2.opt_state_g[0].mu
    mu_d = state2.opt_state_d[0].mu
    want = {"G": _g_state_dict(kind, mu_g),
            "D": convert.res_discriminator_state_dict(
                mu_d["D"], state2.stats_d["D"], layers=D_LAYERS),
            "D_V": _dv_state_dict(kind, mu_d["D_V"], state2.stats_d["D_V"])}
    for tag, net in _nets(task).items():
        grads = want[tag]
        scale = max(g.abs().max().item() for k, g in grads.items()
                    if not k.endswith(("weight_u", "weight_v")))
        n = 0
        for name, p in net.named_parameters():
            assert p.grad is not None, (tag, name)
            np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                       rtol=0, atol=REL * scale,
                                       err_msg=f"{tag} d {name}")
            n += 1
        assert n == len(list(net.parameters())) > 0


def _hold_u(kind, task, state2):
    want = {"D": convert.res_discriminator_state_dict(
                state2.params_d["D"], state2.stats_d["D"], layers=D_LAYERS),
            "D_V": _dv_state_dict(kind, state2.params_d["D_V"],
                                  state2.stats_d["D_V"])}
    held = 0
    for tag, ref in want.items():
        sd = _nets(task)[tag].state_dict()
        for key in (k for k in sd if k.endswith("weight_u")):
            np.testing.assert_allclose(sd[key].numpy(), ref[key].numpy(),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{tag} {key}")
            held += 1
    return held


def _hold_logs(logs, logs_j, task):
    assert sorted(logs) == sorted(type(task).loss_names + ["total_G"])
    for name, want in logs_j.items():
        got, want = float(logs[name]), float(want)
        assert np.isfinite(got) and abs(got - want) <= REL * abs(want), (
            name, got, want)


def test_chunk_step_matches_gfla_tpu(chunk_pair):
    kind, task, _, _, state2, logs_j, carry_j, batch, idx = chunk_pair
    task = copy.deepcopy(task)
    logs, carry = task.train_chunk(_first_chunk(_port(batch)), idx)
    _hold_logs(logs, logs_j, task)
    _hold_grads(kind, task, state2)
    assert _hold_u(kind, task, state2) == 2 * (3 * D_LAYERS + 1)
    for got, want in zip(carry, carry_j):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-4)
    assert task.step == 1


def test_train_step_over_two_chunks_matches_gfla_tpu(face_pair):
    """A clip of two chunks of face (dance's carry is the same code):
    gfla_tpu's train_step splits its rng per chunk; the same draws go to
    the port's chunks."""
    kind, task, task_j, state, _, _, _, _, _ = face_pair
    T = FRAMES[kind]
    task = copy.deepcopy(task)
    batch = _f32(_clip(kind, 2 * T, 2))
    rng = jax.random.PRNGKey(9)
    state2, logs_j = task_j.train_step(_dev(state), _dev(batch), _dev(rng))
    state2, logs_j = jax.device_get((state2, logs_j))
    indices = []
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        indices.append(_indices(sub, T, T))
    logs = task.train_step(_port(batch), indices)
    _hold_logs(logs, logs_j, task)
    assert task.step == 2 and int(state2.step) == 2
    _hold_u(kind, task, state2)
    lr = {"G": LR, "D": LR * 0.1, "D_V": LR * 0.1}
    want = {"G": _g_state_dict(kind, state2.params_g),
            "D": convert.res_discriminator_state_dict(
                state2.params_d["D"], state2.stats_d["D"], layers=D_LAYERS),
            "D_V": _dv_state_dict(kind, state2.params_d["D_V"],
                                  state2.stats_d["D_V"])}
    for tag, net in _nets(task).items():
        for name, p in net.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), want[tag][name].numpy(), rtol=0,
                atol=ADAM_TWO_STEPS * lr[tag], err_msg=f"{tag} {name}")


@pytest.mark.parametrize("spect", [False, True], ids=["plain", "spect_g"])
def test_remat_keeps_the_chunk_step(spect):
    """--remat recomputes each frame in the backward: losses, gradients and
    every stored u as without it (within 1e-6 x max), the frames'
    forwards run twice."""
    opt = _opt("face", use_spect_g=spect)
    base = FaceTask(opt)
    remat = copy.deepcopy(base)
    remat.opt = _opt("face", use_spect_g=spect, remat=True)
    chunk = _first_chunk(_port(_f32(_clip("face", 3, 7))))
    calls = []
    target = remat.net_g.target.forward
    remat.net_g.target.forward = lambda *a: calls.append(1) or target(*a)
    got, _ = remat.train_chunk(chunk, (0, 0, 1, 0))
    want, _ = base.train_chunk(chunk, (0, 0, 1, 0))
    assert len(calls) == 2 * 3
    for name in want:
        assert abs(float(got[name]) - float(want[name])) <= 1e-6 * abs(
            float(want[name])), name
    for tag, net in _nets(base).items():
        other = _nets(remat)[tag]
        for (name, p), q in zip(net.named_parameters(),
                                other.parameters()):
            scale = p.grad.abs().max().item()
            assert (p.grad - q.grad).abs().max().item() <= 1e-6 * scale, name
        for (name, b), c in zip(net.named_buffers(), other.buffers()):
            assert torch.allclose(b, c, rtol=0, atol=1e-6), name


def test_save_and_resume(tmp_path, kind="face"):
    """The resumed task's next step equals the uninterrupted task's within
    1e-5 relative: G, D and D_V, both Adams, the schedulers and the chunk
    count."""
    opt = _opt(kind, checkpoints_dir=str(tmp_path), name="exp",
               n_frames_total=2 * FRAMES[kind], lr=1e-4)
    task = (FaceTask if kind == "face" else DanceTask)(opt)
    task.train_step(_port(_f32(_clip(kind, 2 * FRAMES[kind], 3))))
    task.save(1)
    names = sorted(p.name for p in (tmp_path / "exp").iterdir())
    assert {"1_net_G.pth", "1_net_D.pth", "1_net_D_V.pth",
            "1_train_state.pth"} <= set(names)
    resumed = (FaceTask if kind == "face" else DanceTask)(opt)
    assert resumed.resume("latest") == 1 and resumed.step == 2
    batch = _port(_f32(_clip(kind, 2 * FRAMES[kind], 4)))
    want = task.train_step(batch)
    got = resumed.train_step(batch)
    for name in want:
        assert abs(float(got[name]) - float(want[name])) <= 1e-5 * abs(
            float(want[name])), name
