"""Data parallelism (gfla_tpu_torch.parallel) on the CPU: gloo ranks held
against one rank and against gfla_tpu.

One 2-rank world (tests/torch_port_ranks.py, 2 torch threads a rank) runs
every rank-side step once, in a module fixture bounded at RANKS_TIMEOUT;
this process runs the same steps as one rank on the whole batch. Held:
- the loader's shard: every rank's sample indices for 3 epochs, with the
  held-out batch excluded, in worlds built from torchrun's variables (one
  host of 2 ranks, 2 hosts of 1 rank), equal to gfla_tpu's
  `DataLoader(shard=...)._index_batches()` split into contiguous blocks;
  where gfla_tpu's hosts would take a different number of batches, every
  rank takes the last host's number; the workers' seeds;
- the masked correctness loss (frames=3) on 2 ranks, each with its half of
  a batch whose masks differ between the halves and the global mask sums:
  the mean of the ranks' losses and their flow gradients within 1e-5 of
  gfla_tpu's `_layer_loss` on the whole batch, eager, where the mean of
  per-half ratios is not;
- one pose step, one masked dance chunk and one keypoint step (SGD in
  place of Adam, so that each gradient is the step) on 2 ranks against one
  rank on the same global batch, by gfla_tpu's rule
  (tests/test_train.py::test_8dev_equals_1dev: under 0.5% of a network's
  entries above 2e-4 of its largest |gradient|, none above 0.1); total_G
  within 1e-4; the two ranks' gradients and dance's drawn frame indices
  equal;
- one pose step under --compute_dtype=bfloat16 on 2 ranks against one
  rank by test_torch_port_bf16.py's step rule (cosine and norm ratio);
- parameters, buffers (spectral-norm u) and Adam state bitwise equal on
  both ranks after 2 steps, also with --remat and --use_spect_g;
- a save on 2 ranks, a resume on 2 ranks: the next step equal to the
  uninterrupted run's; ranks that resumed at different iterations all
  stop;
- the training CLI with `--gpu_ids=-1 --mesh_devices=2` writes one set of
  checkpoints and one loss log.
One step on one rank is held against gfla_tpu by test_torch_port_train.py,
test_torch_port_animation_train.py and test_torch_port_keypoint.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_port_bf16 as bf16_rule
import torch_port_ranks as ranks
from gfla_tpu.data.loader import DataLoader as JaxLoader
from gfla_tpu.losses.perceptual import PerceptualCorrectness as JaxCorrectness
from gfla_tpu_torch import parallel
from gfla_tpu_torch.data.loader import make_loader
from gfla_tpu_torch.train.evaluate import holdout_indices

RANKS_TIMEOUT = 120  # s: a hung rank fails the fixture, not the session


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the other test workers share these cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Each rank's results of torch_port_ranks.rank_steps on 2 gloo
    ranks."""
    out = tmp_path_factory.mktemp("ranks")
    parallel.spawn(ranks.rank_steps, [torch.device("cpu")] * 2, str(out),
                   timeout=RANKS_TIMEOUT)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


# --- devices and worlds -----------------------------------------------------

def test_devices_of_a_hosts_ranks(monkeypatch):
    """--gpu_ids lists and --mesh_devices (select_devices); torchrun's
    variables (env_world); no group, no collective (a world of one)."""
    from gfla_tpu_torch.runtime import select_devices

    cpu, cuda = torch.device("cpu"), (lambda i: torch.device("cuda", i))
    assert select_devices("-1") == [cpu]
    assert select_devices("-1", 3) == [cpu] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert select_devices("0") == [cuda(0)]
    assert select_devices("0", 2) == [cuda(0), cuda(1)]
    assert select_devices("0,1,2,3") == [cuda(i) for i in range(4)]
    assert select_devices("3,1", 1) == [cuda(3)]
    for ids, n in (("0,1", 3), ("0", 5), ("4", 0), ("1,1", 0)):
        with pytest.raises(RuntimeError):
            select_devices(ids, n)
    for var in parallel.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        parallel.env_world()
    assert not parallel.active() and parallel.world() == parallel.World()
    grad = torch.randn(3, 4)
    p = torch.nn.Parameter(torch.zeros(3, 4))
    p.grad = grad.clone()
    parallel.allreduce_grads([p])
    logs = {"a": torch.tensor(1.5)}
    assert torch.equal(p.grad, grad) and parallel.allreduce_mean(logs) is logs


# --- the loader's shard ----------------------------------------------------

class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


WORLDS = {  # name: (samples, batchSize, nThreads, [(rank, local_rank)], L)
    "one_host_two_ranks": (37, 4, 2, [(0, 0), (1, 1)], 2),
    "two_hosts_one_rank": (37, 4, 2, [(0, 0), (1, 0)], 1),
    "two_hosts_uneven": (15, 4, 0, [(0, 0), (1, 0)], 1),
}


@pytest.mark.parametrize("name", list(WORLDS))
def test_loader_shard_matches_gfla_tpu(name, monkeypatch):
    n, batch, workers, places, local = WORLDS[name]
    seed, size = 3, len(places)
    holdout = holdout_indices(n, batch, seed) if n >= 2 * batch else None
    opt = type("Opt", (), dict(batchSize=batch, nThreads=workers, seed=seed,
                               serial_batches=False))()
    got = {}
    for rank, local_rank in places:
        env = dict(RANK=rank, WORLD_SIZE=size, LOCAL_RANK=local_rank,
                   LOCAL_WORLD_SIZE=local, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=29500)
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        at = parallel.env_world()
        monkeypatch.setattr(parallel, "_world", at)
        loader = make_loader(_Sized(n), opt, train=True, exclude=holdout)
        assert loader.worker_init_fn.seed == \
            seed + 7919 * at.node + workers * at.local_rank
        got[rank] = [loader.batch_sampler.index_batches(e) for e in range(3)]
        assert len(loader) == len(got[rank][0])
    hosts = size // local
    for rank, local_rank in places:
        node = rank // local
        jl = JaxLoader(_Sized(n), batch, shuffle=True, drop_last=True,
                       num_workers=0, seed=seed,
                       shard=(node, hosts) if hosts > 1 else None)
        jl.exclude = holdout
        # every host takes as many batches as the last, which holds fewest
        fewest = (n - (0 if holdout is None else len(holdout))) // hosts
        for epoch in range(3):
            jl._epoch = epoch
            want = jl._index_batches()[:fewest // batch]
            rows = batch // local
            want = [b[local_rank * rows:(local_rank + 1) * rows]
                    for b in want]
            assert [b.tolist() for b in got[rank][epoch]] == \
                [b.tolist() for b in want], (rank, epoch)
            if holdout is not None:
                assert not set(np.concatenate(want)) & set(holdout)
    lengths = {len(g[0]) for g in got.values()}
    assert len(lengths) == 1
    if name == "two_hosts_uneven":  # gfla_tpu's hosts: 2 and 1 batches
        assert lengths == {1}


# --- the masked correctness loss -------------------------------------------

def test_masked_correctness_is_the_global_ratio(world2):
    x = ranks.masked_inputs()
    T, n = ranks.MASK_T, 2

    def jax_loss(flow):
        return JaxCorrectness(None)._layer_loss(
            jnp.asarray(x["target"].permute(0, 2, 3, 1).numpy()),
            jnp.asarray(x["source"].permute(0, 2, 3, 1).numpy()), flow,
            jnp.asarray(x["mask"].permute(0, 2, 3, 1).numpy()), False, T)

    flow = jnp.asarray(x["flow"].permute(0, 2, 3, 1).numpy())
    want, d_flow = jax.value_and_grad(jax_loss)(flow)
    want = float(want)
    d_flow = np.asarray(d_flow).transpose(0, 3, 1, 2)
    means = [r["masked"]["mean"] for r in world2]
    assert means[0] == means[1]
    assert abs(means[0] - want) <= 1e-5 * abs(want)
    assert abs(float(sum(r["masked"]["loss"] for r in world2)) / n
               - want) <= 1e-5 * abs(want)
    # the averaged gradient: each rank's flow rows, over the world size
    got = np.concatenate([r["masked"]["d_flow"].numpy() / n for r in world2])
    np.testing.assert_allclose(got, d_flow, rtol=0,
                               atol=1e-5 * np.abs(d_flow).max())
    # the fault this guards against: the mean of each half's own ratio
    halves = [ranks.masked_loss(r, n)["loss"].item() for r in range(n)]
    assert abs(np.mean(halves) - want) > 1e-3 * abs(want)


# --- steps on 2 ranks against 1 ---------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    return {"pose": ranks.pose_sgd(), "dance": ranks.dance_sgd(),
            "keypoint": ranks.kp_sgd(),
            "pose_bf16": ranks.pose_sgd(dtype="bfloat16")}


@pytest.mark.parametrize("kind", ["pose", "dance", "keypoint"])
def test_two_ranks_step_as_one(kind, world2, one_rank):
    want = one_rank[kind]
    got = [r[kind] for r in world2]
    assert got[0]["logs"] == got[1]["logs"]
    assert got[0]["logs"].keys() == want["logs"].keys()
    np.testing.assert_allclose(got[0]["logs"]["total_G"],
                               want["logs"]["total_G"], rtol=1e-4)
    for tag in want["grads"]:
        for name, g in got[0]["grads"][tag].items():
            assert torch.equal(g, got[1]["grads"][tag][name]), (tag, name)
        chip_smoke.dp_rule(f"{kind} {tag}", want["grads"][tag],
                           got[0]["grads"][tag])
    if kind == "dance":  # drawn from --seed and the step: the same on all
        assert got[0]["indices"] == got[1]["indices"] == want["indices"]


def test_two_ranks_bf16_step_as_one(world2, one_rank):
    """--compute_dtype=bfloat16: the 2-rank pose step against the 1-rank
    one by the bf16 step rule of test_torch_port_bf16.py (cosine and norm
    ratio, tensor by tensor and a network whole, on the tensors with a
    gradient in f32), the f32 masters' gradients all-reduced."""
    want = one_rank["pose_bf16"]
    got = [r["pose_bf16"] for r in world2]
    assert got[0]["logs"] == got[1]["logs"]
    np.testing.assert_allclose(got[0]["logs"]["total_G"],
                               want["logs"]["total_G"],
                               rtol=bf16_rule.LOSS_REL)
    for tag, g32 in one_rank["pose"]["grads"].items():
        scale = max(g.abs().max().item() for g in g32.values())
        live = [n for n, g in g32.items() if g.abs().max() > 1e-5 * scale]
        for name, g in got[0]["grads"][tag].items():
            assert g.dtype == torch.float32
            assert torch.equal(g, got[1]["grads"][tag][name]), (tag, name)
        assert not bf16_rule._unheld(got[0]["grads"][tag],
                                     want["grads"][tag], live,
                                     *bf16_rule.STEP_HOLD[tag]), tag


# --- replicas, save and resume ---------------------------------------------

@pytest.mark.parametrize("case", ["adam", "remat"])
def test_replicas_equal_after_two_steps(case, world2):
    a, b = (r[case]["replica"] for r in world2)
    assert a.keys() == b.keys()
    assert any(k.endswith("weight_u") for k in a)
    assert any(k.endswith("exp_avg_sq") for k in a)
    if case == "remat":  # --use_spect_g: G's u too
        assert any(k.startswith("G.") and k.endswith("weight_u") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_on_two_ranks_continues(world2):
    for r in world2:
        got = r["adam"]
        assert got["resumed_at"] == 2
        assert got["resumed_logs"] == got["next_logs"]
        for k, v in got["next_replica"].items():
            assert torch.equal(got["resumed_replica"][k], v), k


# --- the training CLI --------------------------------------------------------

def test_ranks_that_resumed_apart_all_stop(world2):
    """The --continue_train guard (parallel.same_everywhere): where the
    ranks resumed at different iterations, every rank raises, so that
    none waits for the others."""
    for rank, r in enumerate(world2):
        assert r["apart"] == f"resumed: 0 to 1 over the ranks, {rank} on " \
                             f"rank {rank}"


def test_training_cli_on_two_cpu_ranks(tmp_path, monkeypatch, capfd):
    """`python -m gfla_tpu_torch.train ... --mesh_devices=2`, its main
    in-process: the ranks it spawns bounded at RANKS_TIMEOUT, 2 threads
    each. One set of checkpoints and one loss log, rank 0's (a resume on 2
    ranks is test_resume_on_two_ranks_continues)."""
    import gfla_tpu_torch.train.__main__ as train_cli

    monkeypatch.setattr(parallel, "spawn", functools.partial(
        parallel.spawn, timeout=RANKS_TIMEOUT))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # each rank's threads
    assert train_cli.main([
        "--gpu_ids=-1", "--mesh_devices=2", "--model=pose",
        "--dataset_mode=synthetic", "--load_size=32", "--batchSize=2",
        "--nThreads=0", "--print_freq=1", "--max_iters=1",
        f"--checkpoints_dir={tmp_path}", "--name=dp"]) == 0
    out = capfd.readouterr().out
    assert "data parallel: 2 ranks on ['cpu', 'cpu'], 1 rows each" in out
    assert out.count("training finished at iteration 1") == 1
    run = tmp_path / "dp"
    assert sorted(p.name for p in run.glob("*_net_*.pth")) == [
        "1_net_D.pth", "1_net_G.pth", "latest_net_D.pth", "latest_net_G.pth"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dp"]
    log = (run / "loss_log.txt").read_text().splitlines()
    steps = [line for line in log if line.startswith("(epoch:")]
    assert [s.split(",")[1] for s in steps] == [" iters: 1"]
    assert sum(line.startswith("=====") for line in log) == 1
