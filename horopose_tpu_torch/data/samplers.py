"""Samplers, collation and the batch loader.

Port of `horopose_tpu/data/samplers.py`. The samplers draw the same index
streams as the JAX ones (`PartialSampler` the same `RandomState(808)`
permutations). `collate` stacks samples into the JAX `DataLoader`'s
nested layout with CPU tensors in place of numpy arrays, so a batch can be
pinned and copied to the card without a staging copy.

`DataLoader` keeps the JAX constructor's arguments and its `len`,
`drop_last` and `batch_size` semantics on top of
`torch.utils.data.DataLoader`: worker processes (persistent across
epochs; `num_workers=0` loads in the calling process), `collate` as the
collate function, and optionally pinned batches. The JAX loader's thread
mode (`use_processes=False`) has no counterpart: the workers here are
always processes, each on one intra-op thread, and they never touch the
card. Each sample is loaded as `dataset[(worker_seed, epoch, index)]`
(see `data/dream.py`), so its augmentation draws are the same whichever
worker loads it: batches do not depend on `num_workers`.
"""

from __future__ import annotations

import multiprocessing
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


class PartialSampler:
    """Random subset of epoch_size indices per epoch."""

    def __init__(self, ds, epoch_size: Optional[int], seed: int = 808):
        self.n_items = len(ds)
        self.epoch_size = min(epoch_size, self.n_items) if epoch_size \
            else self.n_items
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return self.epoch_size

    def __iter__(self) -> Iterator[int]:
        return iter(self._rng.permutation(self.n_items)[:self.epoch_size]
                    .tolist())


class WeightedRandomSampler:
    """Sample indices with replacement proportionally to weights."""

    def __init__(self, weights, num_samples: int, seed: int = 808):
        self.weights = np.asarray(weights, np.float64)
        self.weights = self.weights / self.weights.sum()
        self.num_samples = num_samples
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        return iter(self._rng.choice(
            len(self.weights), size=self.num_samples, replace=True,
            p=self.weights).tolist())


class ListSampler:
    """Fixed index replay."""

    def __init__(self, ids: Sequence[int]):
        self.ids = list(ids)

    def __len__(self):
        return len(self.ids)

    def __iter__(self):
        return iter(self.ids)


def collate(samples: List[Dict]) -> Dict:
    """Stack a list of sample dicts (recursively) into batched CPU
    tensors."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], dict):
            out[key] = collate(vals)
        else:
            out[key] = torch.from_numpy(np.stack([np.asarray(v)
                                                  for v in vals]))
    return out


def _one_thread(worker_id: int) -> None:
    """Worker set-up: one intra-op thread, as many workers share the
    host's cores."""
    torch.set_num_threads(1)


class _EpochBatches:
    """The batch sampler: each pass draws the sampler's indices for the
    next epoch and cuts them into batches of (seed, epoch, index) keys.

    It holds what it reads and no reference to its `DataLoader`. With one,
    the loader, the torch loader and its worker iterator would form a
    cycle that only a garbage collection frees; there the index queues'
    finalizers run before the iterator's, stop the feeder threads that
    carry each worker its stop sentinel, and every worker waits out
    torch's 5 s join timeout."""

    def __init__(self, sampler, n_items: int, batch_size: int,
                 drop_last: bool, worker_seed: int):
        self.sampler = sampler
        self.n_items = n_items
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.worker_seed = worker_seed
        self.epoch = 0

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else self.n_items
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        indices = list(iter(self.sampler)) if self.sampler is not None \
            else list(range(self.n_items))
        for i in range(0, len(indices), self.batch_size):
            chunk = indices[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            yield [(self.worker_seed, epoch, int(j)) for j in chunk]


class DataLoader:
    """Batches of `dataset` in worker processes, `prefetch` batches ahead.

    drop_last defaults True for training (every step sees a full batch);
    eval pads the final batch instead where it needs one (see pad_batch).
    Each pass over the loader is one epoch of its augmentation stream
    (`epoch` counts the passes).
    """

    def __init__(self, dataset, batch_size: int, sampler=None,
                 num_workers: int = 4, drop_last: bool = True,
                 prefetch: int = 4, worker_seed: int = 808,
                 start_method: str = "fork", pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(0, int(num_workers))
        self.drop_last = drop_last
        self.worker_seed = worker_seed
        self._batches = _EpochBatches(sampler, len(dataset), batch_size,
                                      drop_last, worker_seed)
        workers = {}
        if self.num_workers:
            # "fork" (the default) starts workers without re-importing
            # torch; they run PIL, numpy and torch's CPU ops on one thread
            # each and never touch the card, so forking a parent that has
            # initialised CUDA is safe. "spawn" and "forkserver" pickle the
            # dataset (the decode cache pickles by path).
            workers = dict(
                multiprocessing_context=multiprocessing.get_context(
                    start_method),
                worker_init_fn=_one_thread, persistent_workers=True,
                prefetch_factor=max(1, -(-int(prefetch) // self.num_workers)))
        self._torch = torch.utils.data.DataLoader(
            dataset, batch_sampler=self._batches, collate_fn=collate,
            num_workers=self.num_workers, pin_memory=pin_memory, **workers)

    @property
    def epoch(self) -> int:
        """The passes over the loader so far: the next pass's epoch."""
        return self._batches.epoch

    @epoch.setter
    def epoch(self, value: int):
        self._batches.epoch = int(value)

    def __len__(self):
        return len(self._batches)

    def __iter__(self):
        return iter(self._torch)

    def close(self):
        """Stop the worker processes now: each gets its stop sentinel and
        is joined. Dropping the last reference to the loader does the same
        through torch's iterator finalizer."""
        # torch keeps the iterator of persistent workers only
        iterator = getattr(self._torch, "_iterator", None)
        if iterator is not None:
            iterator._shutdown_workers()
        self._torch = None


def pad_batch(batch: Dict, target: int):
    """Pad a (possibly short) batch of tensors to `target` along axis 0 by
    repeating the last element; returns (padded_batch, n_valid)."""
    def pad(x):
        if isinstance(x, dict):
            return {k: pad(v) for k, v in x.items()}
        n = x.shape[0]
        if n == target:
            return x
        return torch.cat([x, x[-1:].expand(target - n, *x.shape[1:])])

    first = next(iter(batch.values()))
    n_valid = first.shape[0] if not isinstance(first, dict) else \
        next(iter(first.values())).shape[0]
    return pad(batch), n_valid
