"""Multiprocess prefetching input pipeline.

Counterpart of ``lightningfastspeech2_tpu/data/loader.py``. The reference
feeds training from ``DataLoader(num_workers=cpu_count)`` (reference
``litfass/fastspeech2/fastspeech2.py:42,114,1308-1323``) because per-item
prosody extraction would otherwise starve the accelerator. Here a
spawn-based process pool computes ``dataset[i]`` and the collation off the
critical path, with a bounded number of ready batches in flight.

- **spawn, not fork**: the parent may hold a CUDA context, which a forked
  child cannot use. Each worker is a fresh interpreter that unpickles the
  dataset and extracts its features on the loader's ``device``, given
  explicitly (``cuda`` by default; each worker opens its own context).
- **one job = one collated batch**: items are computed and padded to their
  static bucket inside the worker, so the parent only forwards ready
  arrays.
- **deterministic order**: batches are yielded in submission order
  (futures consumed FIFO), so a prefetched run sees the same batch sequence
  as ``batch_index_stream`` read synchronously.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer
from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device

# worker-process globals, set once by _worker_init
_WORKER_DS = None
_WORKER_BUCKETER = None


def batch_index_stream(
    n: int,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = None,
    lengths: Optional[np.ndarray] = None,
) -> Iterator[List[int]]:
    """Yields per-batch index lists; the single source of truth for batch
    order (shared by a synchronous iterator and the prefetch loader).

    ``lengths`` enables length-sorted batching (reference
    ``sort_by_duration``, datasets.py:884-886): items are ordered by
    length, then whole batches are shuffled, keeping length-local batches
    for low padding waste.
    """
    if n < batch_size:
        raise ValueError(
            f"dataset has {n} usable utterances but batch_size={batch_size}; "
            "check the corpus path / length filters"
        )
    order = np.arange(n)
    if lengths is not None:
        order = np.argsort(np.asarray(lengths))
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        idx = order.copy()
        if shuffle and lengths is None:
            rng.shuffle(idx)
        elif shuffle:
            starts = np.arange(0, n, batch_size)
            rng.shuffle(starts)
            idx = np.concatenate([order[s : s + batch_size] for s in starts])
        for s in range(0, n - batch_size + 1, batch_size):
            yield [int(i) for i in idx[s : s + batch_size]]
        epoch += 1


def _worker_init(payload: bytes, seed: int, counter, device: str) -> None:
    # deprioritize workers: their feature extraction must not starve the
    # main process's launch thread (the JAX package measured 547 ms step
    # stalls with 3 un-niced workers on 4 cores against 25 ms with none)
    try:
        os.nice(10)
    except OSError:
        pass
    global _WORKER_DS, _WORKER_BUCKETER
    _WORKER_DS, _WORKER_BUCKETER = pickle.loads(payload)
    _WORKER_DS.device = device
    with counter.get_lock():
        rank = int(counter.value)
        counter.value += 1
    # per-worker augmentation stream (torch DataLoader worker-seed analog)
    _WORKER_DS.rng = np.random.default_rng([seed, rank])


def _produce_batch(indices: List[int]) -> Dict[str, Any]:
    items = [_WORKER_DS[i] for i in indices]
    return _WORKER_DS.collate(items, _WORKER_BUCKETER)


class PrefetchLoader:
    """Iterator of collated batches computed by a process pool on
    ``device``; keeps up to ``prefetch`` batches in flight."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        bucketer: Optional[Bucketer] = None,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = None,
        sort_by_length: bool = False,
        num_workers: int = 2,
        prefetch: int = 4,
        device: DeviceLike = None,
    ):
        self.device = str(resolve_device(device))
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucketer = bucketer or Bucketer(
            dataset.cfg.max_phones, dataset.cfg.max_frames
        )
        self.shuffle = shuffle
        self.seed = seed
        self.epochs = epochs
        self.sort_by_length = sort_by_length
        # leave >=2 cores for the main process, whose launch thread must
        # not wait on worker feature extraction
        core_cap = max(1, (os.cpu_count() or 4) - 2)
        self.num_workers = max(1, min(num_workers, core_cap))
        self.prefetch = max(1, prefetch)
        self._pool: Optional[ProcessPoolExecutor] = None

    def _ensure_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            ctx = mp.get_context("spawn")
            payload = pickle.dumps((self.dataset, self.bucketer))
            counter = ctx.Value("i", 0)
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=ctx,
                initializer=_worker_init,
                initargs=(payload, self.seed, counter, self.device),
            )
        return self._pool

    def index_stream(self) -> Iterator[List[int]]:
        """The batch index lists this loader's batches are made of, in
        order."""
        lengths = None
        if self.sort_by_length:
            lengths = np.asarray(
                [int(e.durations.sum()) for e in self.dataset.entries]
            )
        return batch_index_stream(
            len(self.dataset), self.batch_size, self.shuffle, self.seed,
            self.epochs, lengths,
        )

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        stream = self.index_stream()
        pool = self._ensure_pool()
        pending = []
        try:
            for _ in range(self.prefetch):
                idx = next(stream, None)
                if idx is None:
                    break
                pending.append(pool.submit(_produce_batch, idx))
            while pending:
                fut = pending.pop(0)
                idx = next(stream, None)
                if idx is not None:
                    pending.append(pool.submit(_produce_batch, idx))
                yield fut.result()
        finally:
            for fut in pending:
                fut.cancel()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
