"""Data parallelism over ranks, one process a device (counterpart of
gfla_tpu/parallel/__init__.py's data axis, `make_mesh`, `shard_batch` and
`replicate_state`, and of gfla_tpu/runtime.py's `init_distributed`).

gfla_tpu shards each global batch over a 1-axis ('data',) mesh, replicates
the parameters and the optimizer state, and lets XLA insert the all-reduce
that makes every device apply the gradient of the global-batch mean. The
port runs one process a device, a rank:
- each rank loads only its rows of the global batch (data/loader.py: the
  node's strided slice of the epoch order, then the rank's contiguous rows
  of each node batch);
- `replicate_` broadcasts rank 0's parameters and buffers once, after the
  build and any resume;
- each optimizer step goes through `step`, which first replaces every
  gradient of the optimizer's parameters by its mean over the ranks
  (`allreduce_grads`), so that each rank applies the same update to its
  identical copy.

The all-reduce is an explicit call after `backward()`, not
DistributedDataParallel's hooks: each step is D then G with two optimizers,
G's loss calls D with D frozen, the animation heads run many G forwards a
step, `--remat` recomputes through `nn.norms.recompute_keeping_u`, and bf16
swaps every parameter for a copy (`train.precision.cast_call`). DDP's hooks
and buffer broadcasts fight all four; one call before each `.step()` is
exact in every case.

Every function here is a no-op while no process group exists, so a
single-device run is what it was before this module. With a group of one,
the collectives run and change no bit. The group is NCCL's on CUDA and
gloo's on the CPU (the tests run CPU ranks), each with an explicit timeout,
so that a rank that stops calling collectives fails the others instead of
hanging them.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks. Nodes (hosts) hold
    `local_size` ranks each; a node is gfla_tpu's host (its process)."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1

    @property
    def node(self) -> int:
        return self.rank // self.local_size

    @property
    def nodes(self) -> int:
        return self.size // self.local_size


_world = World()


def world() -> World:
    return _world


def active() -> bool:
    """True while this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def is_main() -> bool:
    """Rank 0: the one that prints, logs and writes checkpoints."""
    return _world.rank == 0


def env_world() -> World:
    """The world torchrun's environment describes (`--distributed`), as
    gfla_tpu's init_distributed reads the JAX coordinator variables."""
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed joins the world that torchrun describes, but "
            f"{', '.join(missing)} {'is' if len(missing) == 1 else 'are'} "
            f"not set; launch with torchrun, or use --mesh_devices=N on one "
            f"host")
    return World(*(int(os.environ[v]) for v in TORCHRUN_VARS[:4]))


def init_world(at: World, device: torch.device,
               store: Optional[dist.Store] = None) -> World:
    """Join the process group as `at` describes, on `device`: NCCL on a
    CUDA device (made the current device first), gloo on the CPU. The
    ranks meet at `store`, or where torchrun's variables say."""
    global _world
    if at.size % at.local_size or not 0 <= at.local_rank < at.local_size \
            or not 0 <= at.rank < at.size:
        raise ValueError(f"not a world of equal nodes: {at}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=None if store else "env://",
                            store=store, rank=at.rank, world_size=at.size,
                            timeout=TIMEOUT)
    _world = at
    return at


def close_world() -> None:
    """Leave the process group, if any; the process is a world of one
    again."""
    global _world
    if active():
        dist.destroy_process_group()
    _world = World()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(local_rank: int, fn: Callable, devices: Sequence, port: int,
              args: tuple) -> None:
    n = len(devices)
    store = dist.TCPStore("127.0.0.1", port, None, False, TIMEOUT)
    init_world(World(local_rank, n, local_rank, n), devices[local_rank],
               store)
    try:
        fn(devices[local_rank], *args)
    finally:
        close_world()


def spawn(fn: Callable, devices: Sequence[torch.device], *args,
          timeout: Optional[float] = None) -> None:
    """`fn(device, *args)` on one rank per device of this host, each in a
    process of its own started by spawn, joined in one world at a store
    this process holds on a port of 127.0.0.1 for as long as they run (so
    that no other process can take the port between its choice and the
    ranks' meeting). Returns when all have ended; if one fails, the others
    are stopped and the error is raised here, as it is (stopping them all
    first) when `timeout` seconds pass. `fn` must be importable by
    name."""
    store = dist.TCPStore("127.0.0.1", 0, None, True, TIMEOUT,
                          wait_for_workers=False)
    ranks = torch.multiprocessing.start_processes(
        _run_rank, args=(fn, list(devices), store.port, args),
        nprocs=len(devices), join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ranks.join(None if deadline is None
                         else max(0.0, deadline - time.monotonic())):
        if deadline is not None and time.monotonic() >= deadline:
            for proc in ranks.processes:
                proc.kill()
                proc.join()
            raise TimeoutError(f"{len(devices)} ranks of {fn.__name__} "
                               f"still running after {timeout} s; stopped")


def barrier() -> None:
    if not active():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _one_bucket(tensors: Sequence[torch.Tensor],
                collective: Callable[[torch.Tensor], None]) -> None:
    """`collective` on all of `tensors` at once, through one flat float32
    buffer in their order, copied back."""
    kinds = {t.dtype for t in tensors}
    if kinds != {torch.float32}:
        raise TypeError(f"one bucket holds float32 tensors, not {kinds}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def allreduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Each parameter's gradient replaced by its mean over the ranks: one
    bucket in the parameters' order, summed, divided by the world size.
    Call it after `backward()` and before the optimizer's `step()`.
    Parameters without a gradient (None on every rank alike) are left
    out."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    size = _world.size

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(size)

    with torch.no_grad():
        _one_bucket(grads, mean)


def step(optimizer: torch.optim.Optimizer) -> None:
    """`optimizer.step()` on the gradient of the global-batch mean: the
    gradients of its parameters averaged over the ranks first. Every task
    steps its optimizers through this."""
    allreduce_grads(p for group in optimizer.param_groups
                    for p in group["params"])
    optimizer.step()


def allreduce_mean(tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """0-dim tensors (a step's logs) averaged over the ranks, in one
    collective; the same dict when there is no group."""
    if not active():
        return tensors
    names = list(tensors)
    flat = torch.stack([tensors[k].detach().float().reshape(())
                        for k in names])
    dist.all_reduce(flat)
    flat.div_(_world.size)
    return dict(zip(names, flat.unbind()))


def allreduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks in place, outside autograd (the masked
    correctness loss's global denominators); `t` itself."""
    if active():
        with torch.no_grad():
            dist.all_reduce(t)
    return t


def same_everywhere(value: int, what: str) -> None:
    """Raise on every rank, so that none goes on to wait for the others,
    unless the integer `value` is the same on all of them."""
    if not active():
        return
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    bounds = torch.tensor([value, -value], dtype=torch.int64, device=device)
    dist.all_reduce(bounds, op=dist.ReduceOp.MAX)
    high, low = int(bounds[0]), -int(bounds[1])
    if high != low:
        raise RuntimeError(f"{what}: {low} to {high} over the ranks, "
                           f"{value} on rank {_world.rank}")


def replicate_(modules: Iterable[torch.nn.Module]) -> None:
    """Every parameter and buffer of `modules` set to rank 0's, one bucket
    a module (gfla_tpu's `replicate_state`)."""
    if not active():
        return
    with torch.no_grad():
        for module in modules:
            tensors = [*module.parameters(), *module.buffers()]
            if tensors:
                _one_bucket(tensors, lambda flat: dist.broadcast(flat, 0))
