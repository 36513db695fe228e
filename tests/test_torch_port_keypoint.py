"""The port's keypoint head (the Motion Extraction Net) against gfla_tpu's,
on the CPU.

Same inputs (seeded numpy) and the same weights (gfla_tpu's variables
carried across with gfla_tpu_torch.convert) go through both packages in
f32:
- LayerNormAll, ADALN1d and the full-width KPInput2DGenerator (17 joints,
  256 channels, 4 layers) in eval mode at B=2, T=86: atol 1e-5 + rtol 1e-5;
- the train-mode forward and every parameter's gradient under the same
  dropout masks (flax's Dropout intercepted to apply numpy masks, the
  port's dropouts swapped by chip_smoke.fixed_dropout): within 1e-4 in
  relative L2;
- two KeypointTask steps from one state (gfla_tpu's, its parameters
  seeded noise, so that every tensor has resolved gradients: at the
  orthogonal 0.02 init the ADALN MLPs' are ~1e-8) under the same masks:
  each loss within 1e-5 relative, the parameters by the masked rule of
  test_torch_port_train.py (1e-6 where gfla_tpu's gradient is resolved:
  above 1e-3 x its tensor's max and 1e-6; 2 lr a step everywhere), since
  Adam's first step with beta1 = 0 is about lr * sign(grad);
- the T < 15 refusal, with gfla_tpu's message;
- kp_generator_state_dict, and the original GFLA's layout
  (torch_ref.build_kp_input_sd) loading with strict=True, its forward
  equal to gfla_tpu's through convert_kp_generator (1e-5 x max |out|);
- the datasets: KeypointDataset's training samples bitwise over 16 draws
  from one seed, its test samples, the detector-score branch,
  KeypointTestDataset on a JSON tree with an empty frame, and camera.py;
- run_test_keypoint: gfla_tpu's JSON names, the coordinates within 1e-4
  px, and (fed the same outputs) --write_image's skeletons bitwise;
- evaluate_held_out's kp_mse and kp_mse_identity; the options namespace;
  both CLIs in-process: two steps, a resume, then the test run.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import torch_ref as tr
from gfla_tpu.convert import convert_kp_generator
from gfla_tpu.data import camera as jax_camera
from gfla_tpu.data import keypoint_data as jax_kp_data
from gfla_tpu.models.keypoint_net import ADALN1d as JaxADALN
from gfla_tpu.models.keypoint_net import KPInput2DGenerator as JaxKPG
from gfla_tpu.models.keypoint_net import LayerNormAll as JaxLN
from gfla_tpu.tasks import create_task as jax_create_task
from gfla_tpu_torch import convert
from gfla_tpu_torch.data import camera, keypoint_data
from gfla_tpu_torch.data import collate as port_collate
from gfla_tpu_torch.models.keypoint_net import (
    ADALN1d,
    KPInput2DGenerator,
    LayerNormAll,
)
from gfla_tpu_torch.tasks.keypoint import KeypointTask
from gfla_tpu_torch.train.evaluate import evaluate_held_out

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5        # eval forwards: atol and rtol
GRAD_REL = 1e-4   # train-mode forward and gradients: relative L2
LOSS_REL = 1e-5   # task steps: each loss, relative
MASK_REL = 1e-3   # parameters held tight: |grad| > 1e-3 x tensor max ...
ADAM_FLOOR = 1e-6  # ... and > 100 x Adam's eps
PARAM_ATOL = 1e-6
B, T, C = 2, 86, 256
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the other test workers share these cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _opt(**over):
    opt = argparse.Namespace(
        model="keypoint", dataset_mode="keypoint", phase="train",
        isTrain=True, batchSize=B, structure_nc=17, lr=LR,
        lr_policy="lambda", niter=100, niter_decay=0, iter_count=1,
        iters_per_epoch=10, seed=0, gpu_ids="-1")
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _batch(seed, t=T):
    rng = np.random.RandomState(seed)
    return {"input_data": rng.randn(B, t, 34).astype(np.float32) * 0.5,
            "gt_data": rng.randn(B, t - 80, 34).astype(np.float32) * 0.5}


def _noise(tree, seed):
    """Every leaf replaced by seeded noise: kernels N(0, 1/fan_in), vectors
    N(0, 0.1^2), the norms' scales 1 + that."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        noise = rng.randn(*leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            noise /= np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            noise *= 0.1
            if "scale" in jax.tree_util.keystr(path):
                noise += 1.0
        leaves.append(noise)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _nct(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 2, 1)))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@contextlib.contextmanager
def flax_masks(masks):
    """flax's Dropout calls, in order, apply the given (B, C, t) masks as
    x * mask / keep (in flax's (B, t, C) layout) instead of drawing."""
    it = iter(masks)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) \
                and context.method_name == "__call__":
            mask = jnp.asarray(next(it).transpose(0, 2, 1))
            return args[0] * mask / (1.0 - context.module.rate)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        yield
    assert next(it, None) is None, "masks left over"


def _port_net(params):
    net = KPInput2DGenerator()
    net.load_state_dict(convert.kp_generator_state_dict(params), strict=True)
    return net


@pytest.fixture(scope="module")
def noise_params():
    v = JaxKPG().init({"params": jax.random.PRNGKey(1),
                       "dropout": jax.random.PRNGKey(2)},
                      jnp.zeros((B, T, 34)), train=False)
    return _noise(v["params"], 3)


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------

def test_layer_norms_match_flax():
    rng = np.random.RandomState(4)
    x = rng.randn(B, 40, C).astype(np.float32) * 3 + 1
    feature = rng.randn(B, C).astype(np.float32)
    ln = JaxLN(C)
    p = _noise(ln.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 5)
    port = LayerNormAll(C)
    port.load_state_dict({"weight": torch.from_numpy(p["scale"][:, None]),
                          "bias": torch.from_numpy(p["bias"][:, None])})
    _close(port(_nct(x)).detach().numpy().transpose(0, 2, 1),
           ln.apply({"params": p}, jnp.asarray(x)), "LayerNormAll")

    ada = JaxADALN(C)
    p = _noise(ada.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(feature))["params"], 6)
    port = ADALN1d(C, C)
    sd = {}
    for name, key in (("mlp_shared", "mlp_shared.0"),
                      ("mlp_gamma", "mlp_gamma"), ("mlp_beta", "mlp_beta")):
        sd[f"{key}.weight"] = torch.from_numpy(p[name]["kernel"].T.copy())
        sd[f"{key}.bias"] = torch.from_numpy(p[name]["bias"])
    port.load_state_dict(sd, strict=True)
    got = port(_nct(x), torch.from_numpy(feature)).detach().numpy()
    _close(got.transpose(0, 2, 1),
           ada.apply({"params": p}, jnp.asarray(x), jnp.asarray(feature)),
           "ADALN1d")


def test_generator_eval_forward_matches_flax(noise_params):
    x = _batch(7)["input_data"]
    want = JaxKPG().apply({"params": noise_params}, jnp.asarray(x),
                          train=False)
    net = _port_net(noise_params).eval()
    with torch.no_grad():
        got = net(_nct(x)).numpy().transpose(0, 2, 1)
    assert got.shape == (B, T - 80, 34)
    _close(got, want, "KPInput2DGenerator eval")


def test_train_forward_and_grads_under_the_same_masks(noise_params):
    batch = _batch(8)
    masks = chip_smoke.kp_dropout_masks(B, T, np.random.RandomState(9))
    gen = JaxKPG()

    def loss_fn(p):
        out = gen.apply({"params": p}, jnp.asarray(batch["input_data"]),
                        train=True)
        return jnp.mean((out - jnp.asarray(batch["gt_data"])) ** 2), out

    with flax_masks(masks):
        (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(noise_params)
    net = _port_net(noise_params).train()
    with chip_smoke.fixed_dropout(net, masks):
        out = net(_nct(batch["input_data"]))
    loss = torch.mean((out.transpose(1, 2) - torch.from_numpy(
        batch["gt_data"])) ** 2)
    loss.backward()
    assert _rel_l2(out.detach().numpy().transpose(0, 2, 1), out_j) \
        <= GRAD_REL
    assert abs(loss.item() - float(loss_j)) <= LOSS_REL * float(loss_j)
    want = convert.kp_generator_state_dict(jax.device_get(grads_j))
    named = dict(net.named_parameters())
    assert sorted(named) == sorted(want)
    for name, g in want.items():
        assert _rel_l2(named[name].grad.numpy(), g) <= GRAD_REL, name
    # the masks matter: without them the port's own dropout differs
    with torch.no_grad():
        assert not torch.allclose(net(_nct(batch["input_data"])), out)


@pytest.fixture(scope="module")
def jax_task():
    task = jax_create_task(_opt())
    b = {k: jnp.asarray(v) for k, v in _batch(10).items()}
    return task, task.init_state(jax.random.PRNGKey(0), b)


def test_two_task_steps_match_gfla_tpu(jax_task):
    task, state = jax_task
    state = state.replace(params_g=_noise(state.params_g, 19))
    port = KeypointTask(_opt(), torch.device("cpu"))
    port.net_g.load_state_dict(convert.kp_generator_state_dict(
        jax.device_get(state.params_g)), strict=True)
    rng = np.random.RandomState(11)
    resolved = None
    for step in range(2):
        batch = _batch(12 + step)
        masks = chip_smoke.kp_dropout_masks(B, T, rng)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(p):
            out = task.net_g.apply({"params": p}, jb["input_data"],
                                   train=True)
            return jnp.mean((out - jb["gt_data"]) ** 2)

        with flax_masks(masks):
            grads = jax.jit(jax.grad(loss_fn))(state.params_g)
        with flax_masks(masks):
            state, logs_j = jax.jit(task._train_step_impl)(
                state, jb, jax.random.PRNGKey(0))
        with chip_smoke.fixed_dropout(port.net_g, masks):
            logs = port.train_step(port.prepare_batch(batch))
        for k in ("mpjpe", "total_G"):
            want = float(logs_j[k])
            assert abs(float(logs[k]) - want) <= LOSS_REL * want, (step, k)
        grads = convert.kp_generator_state_dict(jax.device_get(grads))
        params = convert.kp_generator_state_dict(
            jax.device_get(state.params_g))
        tight = {n: (g.abs() > MASK_REL * g.abs().max()) &
                 (g.abs() > ADAM_FLOOR) for n, g in grads.items()}
        resolved = tight if resolved is None else {
            n: resolved[n] & tight[n] for n in tight}
        for n, p in port.net_g.named_parameters():
            diff = (p.detach() - params[n]).abs()
            assert diff.max() <= 2 * LR * (step + 1) + 1e-7, (step, n)
            assert resolved[n].any(), (step, n)
            assert diff[resolved[n]].max() <= PARAM_ATOL, (step, n)
    assert port.step == 2 and int(state.step) == 2


def test_short_input_is_refused_as_gfla_tpu_refuses_it(noise_params):
    x = np.zeros((1, 14, 34), np.float32)
    with pytest.raises(ValueError, match="T >= 15") as want:
        JaxKPG().apply({"params": noise_params}, jnp.asarray(x),
                       train=False)
    net = _port_net(noise_params).eval()
    with pytest.raises(ValueError, match="T >= 15") as got:
        net(_nct(x))
    assert str(got.value) == str(want.value)
    from gfla_tpu_torch.models.keypoint_net import feature_length

    assert feature_length(15, 3) == 1 and feature_length(14, 3) == 0


def test_state_dict_layouts(noise_params):
    sd = convert.kp_generator_state_dict(noise_params)
    back = convert_kp_generator(sd)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(
                {"kp_input": noise_params["kp_input"]})[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    assert sd["kp_input.expand_ln.weight"].shape == (C, 1)

    # the original GFLA's layout loads strictly, and serves as gfla_tpu's
    orig, _ = tr.build_kp_input_sd(seed=13)
    orig = {k: v.float() for k, v in orig.items()}
    net = KPInput2DGenerator().eval()
    net.load_state_dict(orig, strict=True)
    x = _batch(14)["input_data"]
    want = JaxKPG().apply({"params": convert_kp_generator(orig)},
                          jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(_nct(x)).numpy().transpose(0, 2, 1)
    # build_kp_input_sd draws N(0, 0.15^2) weights whatever the fan-in, so
    # the outputs reach ~150 from sums that cancel; held at TOL x max |out|
    want = np.asarray(want)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    root = tmp_path_factory.mktemp("h36m")
    subprocess.run([sys.executable, str(REPO / "scripts" /
                                        "make_synth_h36m_keypoints.py"),
                    "--out", str(root), "--frames", "120", "--cameras", "2"],
                   check=True, capture_output=True, timeout=300)
    # a detector archive in the detectron layout: a score channel
    data = np.load(root / "data_2d_h36m_synth_noisy.npz",
                   allow_pickle=True)["positions_2d"].item()
    rng = np.random.RandomState(15)
    scored = {s: {a: [np.concatenate([c, rng.rand(*c.shape[:2], 1)
                                      .astype(np.float32)], -1)
                      for c in cams] for a, cams in acts.items()}
              for s, acts in data.items()}
    np.savez_compressed(root / "data_2d_h36m_detectron_pt_coco.npz",
                        positions_2d=scored)
    return root


def _data_opt(npz, phase, detectron=False, **over):
    name = "data_2d_h36m_detectron_pt_coco.npz" if detectron \
        else "data_2d_h36m_synth_noisy.npz"
    return _opt(phase=phase, isTrain=phase == "train", seed=5, t_step=1,
                n_frames_pre_load=6, n_receptive=81,
                gt_path=str(npz / "data_2d_h36m_gt.npz"),
                input_path=str(npz / name), **over)


def _equal_samples(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("detectron", [False, True],
                         ids=["synthetic", "detectron-scores"])
@pytest.mark.parametrize("phase", ["train", "test"])
def test_keypoint_dataset_matches_gfla_tpu(npz, phase, detectron):
    opt = _data_opt(npz, phase, detectron)
    want = jax_kp_data.KeypointDataset(opt)
    got = keypoint_data.KeypointDataset(opt)
    assert got.data_list == want.data_list
    assert len(got) == (20 if phase == "train" else 4)
    for i in range(16 if phase == "train" else len(want)):
        g, w = got[i % len(got)], want[i % len(want)]
        _equal_samples(g, w)
        if phase == "train":
            assert g["input_data"].shape == (86, 34)
            assert g["gt_data"].shape == (6, 34)


def test_apply_defaults_match_gfla_tpu():
    for cls in ("KeypointDataset", "KeypointTestDataset"):
        got = getattr(keypoint_data, cls).apply_defaults(
            argparse.Namespace(), True)
        want = getattr(jax_kp_data, cls).apply_defaults(
            argparse.Namespace(), True)
        assert vars(got) == vars(want)


def _alphapose_tree(root, seqs=2, frames=7, size=64):
    """{root}/test_alphapose/<seq>/<frame>.json: OpenPose-18 rows with
    missing joints and one past the edge, one frame without a person."""
    rng = np.random.RandomState(16)
    for s in range(seqs):
        d = root / "test_alphapose" / f"clip{s}"
        d.mkdir(parents=True)
        for t in range(frames):
            rows = chip_smoke.dance_joints(rng, size, size, 18)
            people = [] if t == 2 + s else [
                {"pose_keypoints_2d": rows.ravel().tolist()}]
            (d / f"clip{s}_{t:04d}.json").write_text(
                json.dumps({"people": people}))
    return root


@pytest.fixture(scope="module")
def alphapose(tmp_path_factory):
    return _alphapose_tree(tmp_path_factory.mktemp("alphapose"))


def _test_opt(root, **over):
    return _opt(phase="test", isTrain=False, dataroot=str(root),
                load_size=64, n_receptive=81, batchSize=1, **over)


def test_keypoint_test_dataset_matches_gfla_tpu(alphapose):
    opt = _test_opt(alphapose)
    want = jax_kp_data.KeypointTestDataset(opt)
    got = keypoint_data.KeypointTestDataset(opt)
    assert len(got) == len(want) == 2
    for i in range(len(got)):
        _equal_samples(got[i], want[i])
        assert got[i]["input_data"].shape == (7 + 80, 34)
    # the frame without a person is zeros
    assert not got[0]["input_data"][40 + 2].any()


def test_camera_matches_gfla_tpu():
    assert camera.H36M_INTRINSICS == jax_camera.H36M_INTRINSICS
    assert camera.H36M_EXTRINSICS == jax_camera.H36M_EXTRINSICS
    got, want = camera.init_cameras_param(), jax_camera.init_cameras_param()
    assert sorted(got) == sorted(want)
    for s in want:
        for cg, cw in zip(got[s], want[s]):
            assert sorted(cg) == sorted(cw)
            for k in cw:
                assert np.array_equal(cg[k], cw[k]), (s, k)
    rng = np.random.RandomState(17)
    px = rng.rand(5, 17, 2).astype(np.float32) * 1000
    q = rng.randn(5, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.randn(5, 3)
    x3 = rng.randn(5, 17, 3) + [0, 0, 5]
    intr = got["S1"][0]["intrinsic"][None].repeat(5, 0)
    cam = want["S9"][1]
    for name, args in (
            ("normalize_screen_coordinates", (px, 1000, 1002)),
            ("image_coordinates", (px / 500 - 1, 1000, 1002)),
            ("qrot", (q, v)), ("qinverse", (q,)),
            ("world_to_camera", (x3, cam["orientation"],
                                 cam["translation"])),
            ("camera_to_world", (x3, cam["orientation"],
                                 cam["translation"])),
            ("project_to_2d", (x3, intr)),
            ("project_to_2d_linear", (x3, intr))):
        assert np.array_equal(getattr(camera, name)(*args),
                              getattr(jax_camera, name)(*args)), name


# ---------------------------------------------------------------------------
# serving, evaluation, options and the CLIs
# ---------------------------------------------------------------------------

def _port_task(params, **over):
    task = KeypointTask(_opt(**over), torch.device("cpu"))
    task.net_g.load_state_dict(convert.kp_generator_state_dict(params),
                               strict=True)
    return task


def _jax_prepare(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def _run_gfla_tpu_test(jtask, state, opt, loader, monkeypatch):
    """gfla_tpu's run_test_keypoint with its image writer captured."""
    import gfla_tpu.tasks.testing as jax_testing

    saved = {}
    monkeypatch.setattr(jax_testing, "_save",
                        lambda path, img: saved.__setitem__(path, img))
    jax_testing.run_test_keypoint(jtask, opt, state, loader, _jax_prepare)
    return saved


def test_run_test_keypoint_matches_gfla_tpu(alphapose, noise_params,
                                            tmp_path, monkeypatch):
    from gfla_tpu.data import collate as jax_collate
    from gfla_tpu_torch.tasks.testing import run_test_keypoint

    opt = _test_opt(alphapose, write_image=True, name="kp")
    dataset = keypoint_data.KeypointTestDataset(opt)
    loader = [port_collate([dataset[i]]) for i in range(len(dataset))]
    # the synthetic-name fallback on a batch without paths
    loader.append({"input_data": loader[0]["input_data"]})
    jtask = jax_create_task(_opt(isTrain=False))
    state = jtask.init_state(jax.random.PRNGKey(0),
                             _jax_prepare(loader[0]))
    state = state.replace(params_g=noise_params)
    port = _port_task(noise_params, isTrain=False)

    opt.results_dir = str(tmp_path / "port")
    n = run_test_keypoint(port, opt, loader)
    opt.results_dir = str(tmp_path / "gfla_tpu")
    jax_loader = [jax_collate([dataset[i]]) for i in range(len(dataset))]
    jax_loader.append({"input_data": loader[0]["input_data"]})
    saved = _run_gfla_tpu_test(jtask, state, opt, jax_loader, monkeypatch)
    got_dir, want_dir = tmp_path / "port" / "kp", tmp_path / "gfla_tpu" / "kp"
    names = sorted(os.listdir(want_dir))
    assert n == len(names) == 3 * 7
    assert any(name.startswith("seq14_f0") for name in names)
    pngs = sorted(p for p in os.listdir(got_dir) if p.endswith(".png"))
    assert sorted(os.listdir(got_dir)) == sorted(names + pngs)
    assert sorted(os.path.join(str(want_dir), p) for p in pngs) \
        == sorted(saved)
    for name in names:
        got = json.loads((got_dir / name).read_text())
        want = json.loads((want_dir / name).read_text())
        g = np.asarray(got["people"][0]["pose_keypoints_2d"])
        w = np.asarray(want["people"][0]["pose_keypoints_2d"])
        assert g.shape == w.shape == (51,)
        assert np.abs(g - w).max() <= 1e-4, name

    # fed the port's outputs, gfla_tpu writes the same JSONs and skeletons
    class Fed:
        def test_step(self, state, batch):
            return port.test_step(port.prepare_batch(
                {"input_data": np.array(batch["input_data"])})).numpy()

    opt.results_dir = str(tmp_path / "fed")
    saved = _run_gfla_tpu_test(Fed(), state, opt, jax_loader, monkeypatch)
    for name in names:
        assert (got_dir / name).read_text() == \
            (tmp_path / "fed" / "kp" / name).read_text(), name
    for png in pngs:
        with Image.open(got_dir / png) as img:
            pixels = np.asarray(img)
        want = saved[str(tmp_path / "fed" / "kp" / png)]
        assert pixels.dtype == want.dtype and np.array_equal(pixels, want)
    assert len(pngs) == 3 * 7 and saved


def test_evaluate_held_out_matches_gfla_tpu(jax_task):
    from train import evaluate_held_out as jax_evaluate

    jtask, state = jax_task
    port = _port_task(jax.device_get(state.params_g))
    batch = _batch(18)
    want = jax_evaluate(jtask, state, _jax_prepare(batch))
    got = evaluate_held_out(port, port.prepare_batch(batch))
    assert sorted(got) == sorted(want) == ["kp_mse", "kp_mse_identity"]
    assert got["kp_mse_identity"] == want["kp_mse_identity"]
    assert abs(got["kp_mse"] - want["kp_mse"]) <= LOSS_REL * want["kp_mse"]
    from gfla_tpu_torch.train.evaluate import current_visuals

    assert current_visuals(port, port.prepare_batch(batch)) == {}


@pytest.mark.parametrize("mode,dataset", [("train", "keypoint"),
                                          ("test", "keypoint"),
                                          ("test", "keypointtest")])
def test_options_parse_like_gfla_tpu(monkeypatch, tmp_path, mode, dataset):
    from gfla_tpu.options.options import TestOptions as JaxTestOptions
    from gfla_tpu.options.options import TrainOptions as JaxTrainOptions
    from gfla_tpu_torch.options import TestOptions, TrainOptions

    flags = ["--model=keypoint", f"--dataset_mode={dataset}",
             "--lambda_mpjpe=10", "--n_frames_pre_load=8", "--write_image",
             f"--checkpoints_dir={tmp_path}"]
    if dataset == "keypoint":
        flags += ["--t_step=2", "--gt_path=gt.npz", "--input_path=in.npz"]
    monkeypatch.setattr(sys, "argv", [f"{mode}.py", *flags])
    jax_cls, port_cls = ((JaxTrainOptions, TrainOptions) if mode == "train"
                         else (JaxTestOptions, TestOptions))
    want = vars(jax_cls().parse(save=False))
    got = vars(port_cls().parse(flags, save=False))
    assert got == want
    assert got["structure_nc"] == 17 and got["netG"] == "kpinput2d"


def test_clis_train_resume_and_serve(npz, alphapose, tmp_path, capsys):
    """Two steps through the training CLI (kp_mse lines, checkpoints), a
    resume for a third, then the serving CLI with --write_image on the
    AlphaPose tree: gfla_tpu's file names."""
    import gfla_tpu_torch.test as test_cli
    import gfla_tpu_torch.train.__main__ as train_cli

    ckpt = tmp_path / "ckpt"
    common = ["--model=keypoint", "--gpu_ids=-1", "--nThreads=0",
              f"--checkpoints_dir={ckpt}", "--name=kp"]
    train = [*common, "--dataset_mode=keypoint",
             f"--gt_path={npz / 'data_2d_h36m_gt.npz'}",
             f"--input_path={npz / 'data_2d_h36m_synth_noisy.npz'}",
             "--batchSize=4", "--eval_iters_freq=1", "--print_freq=1",
             "--display_freq=1"]
    assert train_cli.main([*train, "--max_iters=2"]) == 0
    assert train_cli.main([*train, "--max_iters=3", "--continue_train"]) == 0
    out = capsys.readouterr().out
    assert "resumed from iteration 2" in out
    run = ckpt / "kp"
    for name in ("2_net_G.pth", "3_net_G.pth", "latest_net_G.pth"):
        assert (run / name).exists(), name
    assert not list(run.glob("*_net_D.pth"))
    evals = (run / "eval_log.txt").read_text().splitlines()
    assert len(evals) == 3 and all("kp_mse_identity:" in e for e in evals)
    losses = [line for line in out.splitlines()
              if line.startswith("(epoch:") and "mpjpe:" in line]
    assert len(losses) == 3 and "nan" not in " ".join(losses)

    res = tmp_path / "res"
    assert test_cli.main([*common, "--dataset_mode=keypointtest",
                          f"--dataroot={alphapose}", "--load_size=64",
                          f"--results_dir={res}", "--write_image"]) == 14
    assert "loaded checkpoint" in capsys.readouterr().out
    names = sorted(os.listdir(res / "kp"))
    frames = sorted(p.stem for p in alphapose.glob("test_alphapose/*/*"))
    assert names == sorted([f"{f}_keypoints.json" for f in frames]
                           + [f"{f}_skeleton_out.png" for f in frames])
