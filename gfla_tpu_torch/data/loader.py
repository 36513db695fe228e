"""Batches for the port's trainer and serving CLI, on
torch.utils.data.DataLoader (counterpart of gfla_tpu/data/loader.py:117-291).

The batch order is gfla_tpu's: the `exclude` set (the trainer's held-out
samples) is removed, each epoch is shuffled by RandomState(seed + epoch)
unless the loader is serial, and training drops the short tail. In a
data-parallel run (gfla_tpu_torch.parallel) each training rank loads only
its rows: its node takes the strided slice `idx[node::nodes]` of the epoch
order, as gfla_tpu's per-host shard does (gfla_tpu/data/loader.py:176-178),
and batches it by `--batchSize`; the node's L ranks split each node batch
into L contiguous blocks, as gfla_tpu's mesh splits a host's batch over its
devices. `--nThreads` worker processes, started by spawn and kept across
epochs, build the samples; each reseeds the dataset's augmentation
RandomState with seed + 7919 x node + its worker id, as gfla_tpu's workers
do, plus nThreads x the local rank, so that no two ranks share a stream.
In the data x spatial mode the shard is the data index's
(`parallel.data_world`): the ranks of one spatial group load the same rows
with the same streams, and each keeps its band (tasks/pose.py).
`collate` stacks the arrays and keeps the JPEG byte arrays (1-D uint8, of
any length) and the paths as lists.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch.utils.data

from gfla_tpu_torch import parallel


def _is_bytes(value) -> bool:
    return (isinstance(value, np.ndarray) and value.dtype == np.uint8
            and value.ndim == 1)


def collate(samples: List[Dict]) -> Dict:
    """Stack array fields; keep byte arrays and other fields as lists."""
    out = {}
    for key, first in samples[0].items():
        values = [s[key] for s in samples]
        stack = isinstance(first, np.ndarray) and not _is_bytes(first)
        out[key] = np.stack(values) if stack else values
    return out


class EpochBatchSampler(torch.utils.data.Sampler):
    """gfla_tpu's `DataLoader._index_batches`, one epoch per iteration.

    `shard` = (node, nodes, local_rank, local_size): the node's strided
    slice of the epoch order, batched, and the local rank's block of
    `batch_size // local_size` rows of each batch. Every node takes as many
    batches an epoch as the last node has, which holds the fewest samples,
    so that all ranks take the same number of steps (gfla_tpu's hosts can
    differ by one batch there)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int = 0,
                 exclude: Optional[np.ndarray] = None,
                 shard: Optional[Tuple[int, int, int, int]] = None):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.exclude = exclude
        self.shard = shard or (0, 1, 0, 1)
        local_size = self.shard[3]
        if batch_size % local_size or (shard and not drop_last):
            raise ValueError(f"a shard {shard} of batches of {batch_size}: "
                             "the batch must split evenly over the node's "
                             "ranks, and the tail must be dropped")
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        idx = np.arange(self.n)
        if self.exclude is not None:
            idx = idx[~np.isin(idx, self.exclude)]
        return idx

    def index_batches(self, epoch: int) -> List[np.ndarray]:
        idx = self._indices()
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        node, nodes, local_rank, local_size = self.shard
        idx = idx[node::nodes]
        batches = [idx[s:s + self.batch_size]
                   for s in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        rows = self.batch_size // local_size
        return [b[local_rank * rows:(local_rank + 1) * rows]
                for b in batches[:len(self)]]

    def __iter__(self) -> Iterator[List[int]]:
        batches = self.index_batches(self.epoch)
        self.epoch += 1
        return iter([b.tolist() for b in batches])

    def __len__(self) -> int:
        n = len(self._indices()) // self.shard[1]  # the last node's share
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)


class _ReseedWorker:
    """worker_init_fn: the worker's own augmentation stream."""

    def __init__(self, seed: int):
        self.seed = seed

    def __call__(self, worker_id: int) -> None:
        seed = (self.seed + worker_id) % (2**31)
        np.random.seed(seed)
        info = torch.utils.data.get_worker_info()
        if hasattr(info.dataset, "rng"):
            info.dataset.rng = np.random.RandomState(seed)


def make_loader(dataset, opt, train: bool,
                exclude: Optional[np.ndarray] = None
                ) -> torch.utils.data.DataLoader:
    """The loader gfla_tpu's create_dataloader makes: shuffled unless
    `--serial_batches`, drop_last in training, `--nThreads` workers; in
    training, this rank's shard of each batch (gfla_tpu_torch.parallel's
    world of data indices)."""
    workers = max(0, getattr(opt, "nThreads", 2))
    seed = getattr(opt, "seed", 0)
    at = parallel.data_world()
    shard = (at.node, at.nodes, at.local_rank, at.local_size) \
        if train and at.size > 1 else None
    sampler = EpochBatchSampler(len(dataset), opt.batchSize,
                                shuffle=not opt.serial_batches,
                                drop_last=train, seed=seed, exclude=exclude,
                                shard=shard)
    worker_seed = seed + 7919 * at.node + workers * at.local_rank \
        if shard else seed
    return torch.utils.data.DataLoader(
        dataset, batch_sampler=sampler, collate_fn=collate,
        num_workers=workers, worker_init_fn=_ReseedWorker(worker_seed),
        multiprocessing_context="spawn" if workers else None,
        persistent_workers=workers > 0)


def infinite(loader) -> Iterator[Dict]:
    """Batches with no end, epoch after epoch."""
    while True:
        yield from loader
