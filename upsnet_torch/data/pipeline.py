"""Input pipeline: bucketed batches built by ``torch.utils.data`` workers.

The port of ``upsnet_tpu/data/pipeline.py``, with the JAX package's sampling
semantics and the reference's machinery (a ``DataLoader`` whose worker
processes build the samples, SURVEY.md §3.1):

  * the index stream is one shuffle a epoch from ``RandomState(seed +
    epoch)``, sharded by (host, num_hosts);
  * the sample at stream position p draws its scale and flip from
    ``_per_sample_rng(seed + 17, p)``, so it does not depend on the number of
    workers;
  * samples are grouped by bucket shape, a batch being one static shape,
    full batches only unless ``drop_last`` is False.

So ``make_loader`` yields the same arrays, in the same order, as the JAX
``make_loader`` for the same dataset and seed, whatever the worker count.

Workers are ``spawn``-ed: they start from a fresh interpreter, build samples
with numpy and cv2 only, and never touch the card, whatever the parent has
initialised. A sample crosses to the parent as CPU tensors in shared memory
and is collated there with numpy. With ``num_workers=0`` the samples are
built in the thread that iterates (the trainer's prefetch thread,
``data/wire.py``). Closing the iterator (or leaving a ``for`` loop early)
shuts the workers down.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader

WORKER_EXIT_S = 30.0  # a terminated worker's exit; one still alive after it is killed


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}


def _per_sample_rng(seed: int, pos: int) -> np.random.RandomState:
    """Deterministic decorrelated RNG for stream position ``pos`` (the JAX
    package's splitmix-style scramble)."""
    z = (seed * 0x9E3779B9 + pos * 0x85EBCA6B + 0xC2B2AE35) & 0xFFFFFFFF
    z ^= z >> 16
    z = (z * 0x45D9F3B) & 0xFFFFFFFF
    z ^= z >> 13
    return np.random.RandomState(z & 0x7FFFFFFF)


class _PositionSamples(torch.utils.data.Dataset):
    """Map-style view of the stream: item ``(pos, index)`` is the dataset's
    sample ``index`` drawn with position ``pos``'s RNG."""

    def __init__(self, dataset, seed: int):
        self.ds = dataset
        self.seed = seed

    def __getitem__(self, item):
        pos, index = item
        return self.ds.sample(int(index), _per_sample_rng(self.seed + 17, pos))


class _Positions:
    """The sampler: ``(pos, index)`` pairs of the loader's index stream."""

    def __init__(self, loader: "Loader"):
        self.loader = loader

    def __iter__(self):
        return enumerate(self.loader._index_stream())


def _to_tensors(sample: dict) -> dict:
    """A worker's sample as CPU tensors, which cross to the parent through
    shared memory rather than a pipe."""
    out = {}
    for k, v in sample.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    return out


class Loader:
    """Bucketed batches of ``dataset`` (``len`` and ``sample(i, rng)``),
    ``batch_size`` a batch. ``epochs=None`` streams forever. ``prefetch`` is
    the number of samples each worker builds ahead."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1, prefetch: int = 2,
                 drop_last: bool = True, epochs: int | None = None, num_workers: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epochs = epochs
        self.num_workers = max(0, int(num_workers))

    def _index_stream(self):
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            idx = np.arange(len(self.ds))
            if self.shuffle:
                np.random.RandomState(self.seed + epoch).shuffle(idx)
            yield from idx[self.host_id::self.num_hosts]
            epoch += 1

    def _bucket_stream(self, samples):
        """Group a sample stream by bucket shape; collate full batches (and,
        unless ``drop_last``, the partial ones at the end)."""
        pending: dict[tuple, list] = {}
        for s in samples:
            key = s["images"].shape
            pending.setdefault(key, []).append(s)
            if len(pending[key]) == self.batch_size:
                yield collate(pending.pop(key))
        if not self.drop_last:
            for group in pending.values():
                for start in range(0, len(group), self.batch_size):
                    yield collate(group[start:start + self.batch_size])

    def __iter__(self):
        workers = self.num_workers > 0
        loader = DataLoader(
            _PositionSamples(self.ds, self.seed), batch_size=None, sampler=_Positions(self),
            num_workers=self.num_workers, collate_fn=_to_tensors,
            multiprocessing_context="spawn" if workers else None,
            prefetch_factor=self.prefetch if workers else None,
            # the loader's own seed draw, so that the global generator is not touched
            generator=torch.Generator().manual_seed(self.seed))
        it = iter(loader)
        try:
            yield from self._bucket_stream(
                {k: v.numpy() for k, v in s.items()} for s in it)
        finally:  # the end or an early close: stop the workers and reap them now
            shutdown = getattr(it, "_shutdown_workers", None)
            if shutdown is not None:
                shutdown()
                # torch joins each worker for a few seconds and then terminates
                # it without a join: a worker slow to exit (a loaded host)
                # would outlive the loader, so join what it terminated
                for w in getattr(it, "_workers", ()):
                    w.join(timeout=WORKER_EXIT_S)
                    if w.is_alive():
                        w.kill()
                        w.join()


def make_loader(dataset, batch_size: int, num_workers: int = 0, **kw) -> Loader:
    """The loader of ``dataset``: ``num_workers`` worker processes build the
    samples (none: the iterating thread does)."""
    return Loader(dataset, batch_size, num_workers=num_workers, **kw)
