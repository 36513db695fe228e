"""Data parallelism over ranks, one process a device (counterpart of
gfla_tpu/parallel/__init__.py's data axis, `make_mesh`, `shard_batch` and
`replicate_state`, and of gfla_tpu/runtime.py's `init_distributed`), and
the spatial axis of its data x spatial mode (`make_mesh_2d`,
`shard_batch_spatial`, `enable_spatial_halo`; see "The spatial axis"
below).

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
    again, without bands."""
    global _world, _bands
    if active():
        dist.destroy_process_group()
    _world = World()
    _bands = None


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


# --- the spatial axis -------------------------------------------------------
#
# gfla_tpu's data x spatial mode (train.py --spatial=S) reshapes its devices
# to a (dp, S) mesh and shards every image's rows over the second axis;
# GSPMD then partitions each op, and the attention gather is a hand-written
# halo exchange (block_extract.py:75-153). The port runs the same program by
# hand: rank i is data index i // S and band i % S of its spatial group
# (ranks S * (i // S) ... S * (i // S) + S - 1), which loads the same rows
# of the global batch; every activation on a rank is its band, rows
# [s * h, (s + 1) * h) of an image of S * h rows (so a tensor's band rows
# give its global geometry). The modules read `bands()`:
# - a convolution, a reflection pad and the attention's edge pad take the
#   rows they need from the neighbouring bands (`pad_rows`), padding at the
#   image's top and bottom edges only;
# - a reduction over the image (instance norm, a loss mean, a Gram matrix)
#   sums its band partials over the spatial group (`band_sum`);
# - the correctness loss's source features are gathered whole
#   (`gather_rows`).
# Each of the three collectives is differentiable, with the sum over the
# spatial group as its adjoint: `band_sum`'s backward all-reduces the
# cotangent, `gather_rows`' keeps the rank's rows of the summed cotangent,
# and `pad_rows`' sends each halo row's cotangent back to the band it came
# from. Every rank seeds its own copy of the loss with 1, so each rank's
# gradients are S times its band's share, and `allreduce_grads`' mean over
# the world is then exactly the single-device gradient of the global batch:
# no other factor goes in. The data axis needs no group of its own: the
# gradients, the logs and the checkpoints go over the world, where the S
# ranks of a spatial group hold the same logs and the same parameters.

@dataclasses.dataclass(frozen=True)
class Bands:
    """This rank's band: `index` of `size` over every image's rows, in the
    spatial group `group`; `halo`, the attention gathers' halo rows
    (--halo)."""

    index: int
    size: int
    halo: int
    group: object = dataclasses.field(default=None, compare=False)

    @property
    def top(self) -> bool:
        """The band holds the image's first row."""
        return self.index == 0

    @property
    def bottom(self) -> bool:
        """The band holds the image's last row."""
        return self.index == self.size - 1

    def first_row(self, rows: int) -> int:
        """The global index of the first row of a band of `rows` rows."""
        return self.index * rows


_bands: Optional[Bands] = None


def bands() -> Optional[Bands]:
    """This rank's band, or None outside the data x spatial mode."""
    return _bands


def init_bands(spatial: int, halo: int) -> Bands:
    """Enter the data x spatial mode in the world this process belongs to
    (gfla_tpu's `make_mesh_2d(size // spatial, spatial)` and
    `enable_spatial_halo(mesh, "spatial", halo)`): one spatial group of
    `spatial` consecutive ranks for each data index, every group created on
    every rank in the same order, as `dist.new_group` asks."""
    global _bands
    size, rank = _world.size, _world.rank
    if spatial < 2 or size % spatial:
        raise ValueError(f"{spatial} bands do not split a world of {size}")
    mine = None
    for first in range(0, size, spatial):
        group = dist.new_group(list(range(first, first + spatial)),
                               timeout=TIMEOUT)
        if first <= rank < first + spatial:
            mine = group
    _bands = Bands(rank % spatial, spatial, halo, mine)
    return _bands


def data_world() -> World:
    """The world of data indices: this process's place among the spatial
    groups (each group one member), or `world()` without bands. A spatial
    group stays on one host (options.spatial_layout)."""
    if _bands is None:
        return _world
    s = _bands.size
    return World(_world.rank // s, _world.size // s, _world.local_rank // s,
                 _world.local_size // s)


def first_group() -> bool:
    """The ranks that evaluate and write the visuals: rank 0, or with
    bands rank 0's spatial group, whose members each run their band."""
    return data_world().rank == 0


band_collectives = 0  # the spatial group's collectives this process issued


def _collect(t: torch.Tensor) -> list:
    """Every band's `t` (contiguous, the same shape on each), in band
    order."""
    global band_collectives
    band_collectives += 1
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_bands.size)]
    dist.all_gather(parts, t, group=_bands.group)
    return parts


def _sum_over_bands(t: torch.Tensor) -> torch.Tensor:
    global band_collectives
    band_collectives += 1
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=_bands.group)
    return t


class _BandSum(torch.autograd.Function):
    """The sum over the spatial group; its adjoint is the same sum."""

    @staticmethod
    def forward(ctx, x):
        return _sum_over_bands(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over_bands(g)


class _GatherRows(torch.autograd.Function):
    """Every band's rows along `dim`, in order; the adjoint sums the
    cotangent over the group and keeps this band's rows (a reduce-scatter,
    written as an all-reduce and a slice so that gloo runs it too)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.rows = dim, x.shape[dim]
        return torch.cat(_collect(x), dim)

    @staticmethod
    def backward(ctx, g):
        return (_sum_over_bands(g).narrow(
            ctx.dim, _bands.index * ctx.rows, ctx.rows), None)


class _Halo(torch.autograd.Function):
    """(the `top` rows above this band, the `bottom` rows below it): the
    previous band's last rows and the next band's first, along `dim`; at
    the image's top and bottom, where there is no neighbour, zeros. One
    all-gather of each band's first `bottom` and last `top` rows; the
    adjoint all-gathers the cotangents and adds each into the rows it came
    from."""

    @staticmethod
    def forward(ctx, x, top, bottom, dim):
        n = x.shape[dim]
        ctx.top, ctx.bottom, ctx.dim, ctx.shape = top, bottom, dim, x.shape
        parts = _collect(torch.cat([x.narrow(dim, 0, bottom),
                                    x.narrow(dim, n - top, top)], dim))
        s = _bands.index
        shape = list(x.shape)
        shape[dim] = top
        above = (parts[s - 1].narrow(dim, bottom, top) if s > 0
                 else x.new_zeros(shape))
        shape[dim] = bottom
        below = (parts[s + 1].narrow(dim, 0, bottom) if s < _bands.size - 1
                 else x.new_zeros(shape))
        return above, below

    @staticmethod
    def backward(ctx, g_above, g_below):
        top, bottom, dim = ctx.top, ctx.bottom, ctx.dim
        parts = _collect(torch.cat([g_above, g_below], dim))
        s, n = _bands.index, ctx.shape[dim]
        grad = g_above.new_zeros(ctx.shape)
        if s < _bands.size - 1:  # our last rows were the next band's above
            grad.narrow(dim, n - top, top).add_(parts[s + 1].narrow(
                dim, 0, top))
        if s > 0:  # our first rows were the previous band's below
            grad.narrow(dim, 0, bottom).add_(parts[s - 1].narrow(
                dim, top, bottom))
        return grad, None, None, None


def band_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the spatial group (differentiable), or `x` itself
    without bands."""
    return x if _bands is None else _BandSum.apply(x)


def band_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of the whole image's `x` from this band's: `x.mean()`
    without bands, else the band sums summed over the group, over S times
    the band's count. As gfla_tpu's `jnp.mean`, which sums a bf16 `x` in
    f32 and rounds once (GSPMD all-reduces the f32 partials before that
    rounding), each band sums in at least f32, the group sums those, and
    the mean is rounded to `x`'s type at the end."""
    if _bands is None:
        return x.mean()
    acc = torch.promote_types(x.dtype, torch.float32)
    total = band_sum(x.sum(dtype=acc))
    return (total / (x.numel() * _bands.size)).to(x.dtype)


def gather_rows(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The whole image's `x` from every band's rows along `dim`
    (differentiable), or `x` itself without bands."""
    return x if _bands is None else _GatherRows.apply(x, dim)


def whole(tree):
    """Every 4-D tensor of `tree` (a tensor, or a dict, list or tuple of
    them) gathered whole along its rows, outside autograd: the
    evaluation's and the visuals' outputs and inputs. `tree` itself
    without bands."""
    if _bands is None:
        return tree
    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(whole(v) for v in tree)
    if torch.is_tensor(tree) and tree.dim() == 4:
        with torch.no_grad():
            return torch.cat(_collect(tree), 2)
    return tree


def _edge(x, rows, mode, dim, first):
    """`rows` rows beyond the image's first (or last) row of `x`'s band, as
    `mode` pads: zeros, replicate (the edge row) or reflect (the rows
    inside, mirrored about the edge row)."""
    n = x.shape[dim]
    if mode == "zeros":
        shape = list(x.shape)
        shape[dim] = rows
        return x.new_zeros(shape)
    if mode == "replicate":
        edge = x.narrow(dim, 0 if first else n - 1, 1)
        shape = list(x.shape)
        shape[dim] = rows
        return edge.expand(shape)
    if mode == "reflect":
        return x.narrow(dim, 1 if first else n - 1 - rows, rows).flip(dim)
    raise ValueError(f"pad_rows: no mode {mode!r}")


def pad_rows(x: torch.Tensor, top: int, bottom: int, mode: str = "zeros",
             dim: int = 2) -> torch.Tensor:
    """This band of `x` (rows along `dim`) with `top` rows above and
    `bottom` below it: the neighbouring bands' rows (the halo exchange),
    and at the image's top and bottom edges the rows `mode` pads there
    (zeros, replicate or reflect), as the single-device op pads the whole
    image. A band must hold at least as many rows as it lends (more than
    it pads, for reflect)."""
    b = _bands
    n = x.shape[dim]
    if max(top, bottom) > n or (mode == "reflect" and max(top, bottom) >= n):
        raise ValueError(f"pad_rows: a band of {n} rows cannot lend "
                         f"{top} and {bottom} rows ({mode})")
    if not top and not bottom:
        return x
    above, below = _Halo.apply(x, top, bottom, dim)
    if b.top:
        above = _edge(x, top, mode, dim, True)
    if b.bottom:
        below = _edge(x, bottom, mode, dim, False)
    return torch.cat([above, x, below], dim)
