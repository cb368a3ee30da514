"""Multiprocess prefetching batch loader (port of
``deepinteraction_tpu/data/loader.py``), single process.

Worker processes run the numpy host pipeline (``pipeline.build_sample``:
point and sweep loading, the matrices, the augmentations, the JPEG bytes)
and return numpy arrays and bytes; a thread in the parent keeps
``prefetch`` batches in flight. ``ops/images.py::to_device`` then moves a
batch to the device and runs the image stage there (the JPEGs are decoded
on the card).

Across ranks (``process_index`` of ``process_count``, as the JAX loader
has them; ``parallel/input.py`` has the rules) every rank sees the same
globally shuffled index list: train takes this rank's
``process_shard_indices``, trimmed so that every rank runs the same number
of batches; eval takes the stride shard, each rank padding its own last
batch. ``batch_size`` is then the rank's local batch.

The parent has CUDA initialised, so the workers are spawned, not forked.
A spawned process imports the program's main module before it runs
anything, so a program that starts a pool keeps its main module light:
the CLIs (``tools/test.py``, ``train.py``, ``benchmark.py``) import torch
and the model inside ``main()``, and their workers import numpy and this
package's host modules only. Spawned workers that imported torch and the model held the
``fusion_base`` CLI's first batch for 23.8 s on an H100 host (72 ms with
no workers).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Dict, Iterator, Optional

from ..parallel.input import process_shard_indices
from .pipeline import collate

_WORKER_DS = None


def _init_worker(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _load_one(args):
    # workers hold the dataset as it was when the pool started, so the epoch
    # travels with every index (per-epoch augmentation seeds)
    epoch, i = args
    _WORKER_DS.epoch = epoch
    return _WORKER_DS[i]


class DataLoader:
    """Iterates batches of ``batch_size`` samples over ``num_workers``
    spawned processes (0: in this process).

    Train drops the last partial batch (static batch shapes); eval pads the
    final batch by repeating its last sample and reports ``pad_count``.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self._pool = None

    def _ensure_pool(self):
        if self.num_workers > 0 and self._pool is None:
            self._pool = mp.get_context("spawn").Pool(self.num_workers, initializer=_init_worker,
                                                      initargs=(self.dataset,))

    def epoch(self, epoch: int = 0, shuffle: Optional[bool] = None) -> Iterator[Dict]:
        train = self.dataset.train
        self.dataset.epoch = epoch
        shuffle = train if shuffle is None else shuffle
        idx = self.dataset.epoch_indices(epoch, shuffle)
        bs = self.batch_size
        idx = process_shard_indices(idx, bs, self.process_index, self.process_count, drop_last=train)
        if train:
            batches = [(list(idx[i * bs : (i + 1) * bs]), 0) for i in range(len(idx) // bs)]
        else:
            batches = []
            for i in range(0, len(idx), bs):
                chunk = list(idx[i : i + bs])
                pad = bs - len(chunk)
                batches.append((chunk + [chunk[-1]] * pad, pad))

        def finish(samples, pad):
            batch = collate(samples)
            if not train:
                batch["pad_count"] = pad
            return batch

        if self.num_workers == 0:
            for ids, pad in batches:
                yield finish([self.dataset[int(i)] for i in ids], pad)
            return

        self._ensure_pool()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

        def submit_all():
            for ids, pad in batches:
                q.put(([self._pool.apply_async(_load_one, ((epoch, int(i)),)) for i in ids], pad))
            q.put(None)

        t = threading.Thread(target=submit_all, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            async_res, pad = item
            yield finish([r.get() for r in async_res], pad)
        t.join()

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

