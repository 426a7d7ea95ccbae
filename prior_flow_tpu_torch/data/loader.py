"""The batch loader and the copy of its batches to the card (counterpart of
``prior_flow_tpu/data/loader.py``).

``DataLoader`` yields the JAX loader's batch sequence, bitwise: each epoch
shuffled by a generator keyed by (seed, epoch) alone, each shard its
slice of that order, the last short batch dropped or kept, an infinite
stream that resumes at any batch (``start_batch``), and each ``iter()``
one epoch further. Underneath it is a ``torch.utils.data.DataLoader``: a
batch sampler yields each batch's (epoch, index) pairs, worker processes
read and augment the samples, and batches come back as tensors, in pinned
memory when a card is present. The workers come from a fork server (a
process started clean, with one thread), not forked from the process
that trains: that one holds threads (the card's, the pin thread), and a
fork copies whatever locks they hold.

The epoch travels with each index. A worker process holds a copy of the
dataset made when the stream started, so a ``set_epoch`` in the parent
would never reach it; the worker sets its copy's epoch from the key of
the sample it reads, and a sample's augmentation draws stay keyed by
(aug_seed, epoch, index) whatever the worker count.

``device_prefetch`` copies batch k+1 to the card on a stream of its own
while step k runs (``prior_flow_tpu/data/loader.py:149``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch.utils.data import Dataset, Sampler


def _stack_batch(samples):
    """Per-sample tuples -> one tensor per array column (NHWC images), a
    list per other column (``prior_flow_tpu/data/loader.py:22``)."""
    out = []
    for col in zip(*samples):
        if isinstance(col[0], np.ndarray):
            out.append(torch.from_numpy(np.stack(col, axis=0)))
        else:
            out.append(list(col))
    return tuple(out)


class _EpochKeyed(Dataset):
    """The dataset read by (epoch, index) keys: the epoch is set on the
    copy that reads the sample."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, key):
        epoch, index = key
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        return self.dataset[index]


class _BatchKeys(Sampler):
    """Each batch's (epoch, index) keys from ``start_batch`` on, over
    ``epochs`` epochs (-1: without end)."""

    def __init__(self, loader: "DataLoader", start_batch: int, epochs: int):
        self.loader = loader
        self.start_batch = start_batch
        self.epochs = epochs

    def __iter__(self):
        n, bs = len(self.loader), self.loader.batch_size
        e, first = divmod(self.start_batch, n)
        end = None if self.epochs < 0 else e + self.epochs
        while end is None or e < end:
            idx = self.loader._epoch_indices(e)
            for i in range(first, n):
                yield [(e, int(j)) for j in idx[i * bs:(i + 1) * bs]]
            first = 0
            e += 1


class DataLoader:
    """Shuffling batch loader over an indexable dataset; ``num_workers``
    worker processes (0: read in the calling process), ``prefetch``
    batches ahead per worker."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int = 1234, prefetch: int = 2,
                 shard_index: int = 0, num_shards: int = 1):
        """``shard_index`` / ``num_shards``: this process reads its
        1/num_shards slice of every epoch's order."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = max(1, num_shards)
        self.seed = seed
        self._epochs_started = 0

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int):
        """One epoch's index order, keyed by (seed, epoch) only
        (``prior_flow_tpu/data/loader.py:62``)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, int(epoch)]))
            rng.shuffle(idx)
        if self.num_shards > 1:
            per = len(idx) // self.num_shards
            idx = idx[self.shard_index * per:(self.shard_index + 1) * per]
        return idx

    def _stream(self, epochs: int = 1, start_batch: int = 0) -> Iterator:
        """The batches of ``epochs`` epochs (-1: without end) from global
        batch ``start_batch`` on (epoch start_batch // len(self), batch
        start_batch % len(self) within it)."""
        if len(self) == 0:
            raise ValueError(
                f"DataLoader has 0 batches: dataset of {len(self.dataset)} "
                f"samples, batch_size={self.batch_size}, "
                f"drop_last={self.drop_last}")
        workers = self.num_workers
        loader = torch.utils.data.DataLoader(
            _EpochKeyed(self.dataset),
            batch_sampler=_BatchKeys(self, start_batch, epochs),
            num_workers=workers, collate_fn=_stack_batch,
            pin_memory=torch.cuda.is_available(),
            prefetch_factor=self.prefetch if workers else None,
            multiprocessing_context="forkserver" if workers else None)
        it = iter(loader)
        try:
            yield from it
        finally:
            # a closed stream stops its worker processes at once
            if hasattr(it, "_shutdown_workers"):
                it._shutdown_workers()

    def __iter__(self) -> Iterator:
        """One epoch per call; the k-th ``iter()`` replays epoch k."""
        epoch = self._epochs_started
        self._epochs_started += 1
        return self._stream(epochs=1, start_batch=epoch * len(self))

    def infinite(self, start_batch: int = 0) -> Iterator:
        """The stream without end, from global batch ``start_batch`` on: a
        run resumed at step k reads the batches an uninterrupted run read
        from step k."""
        return self._stream(epochs=-1, start_batch=start_batch)


def device_prefetch(iterator, device, size: int = 2):
    """The batches of ``iterator`` (tuples of tensors and lists) on
    ``device``, ``size`` ahead. On a card each copy is issued with
    ``non_blocking=True`` on a stream of its own, and the compute stream
    waits for it only when the batch is used; the host batch (pinned) is
    held until then, so its buffer is not reused while its copy runs."""
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    it = iter(iterator)

    def put(batch):
        if side is None:
            return batch, tuple(x.to(device) if torch.is_tensor(x) else x
                                for x in batch), None
        with torch.cuda.stream(side):
            out = tuple(x.to(device, non_blocking=True)
                        if torch.is_tensor(x) else x for x in batch)
            done = torch.cuda.Event()
            done.record(side)
        return batch, out, done

    buf = []
    for batch in it:
        buf.append(put(batch))
        if len(buf) == size:
            break
    while buf:
        # ``host`` stays referenced until the next batch is handed out
        host, out, done = buf.pop(0)
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for x in out:
                if torch.is_tensor(x):
                    x.record_stream(stream)
        yield out
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
