"""Host-side batch assembly in background threads.

The part of ``jolineedle_tpu/train/batching.py`` that REINFORCE uses: the
``Prefetcher``, which overlaps host batch assembly (PIL decode, numpy
padding) with the device's work on the previous batches. The supervised
batch builders wait for the supervised trainer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class Prefetcher:
    """Background-thread batch producer with a bounded queue.

    ``num_workers`` > 1 assembles batches from several threads (PIL decode
    and numpy slicing release the GIL) — the reference's DataLoader worker
    count (reference: main.py ``--num-workers``). When ``pick_work`` is
    given, it is called under an internal lock to draw the next work item
    (e.g. sample indices) and ``make_batch(work)`` runs in parallel; without
    it, ``make_batch()`` itself must be thread-safe for num_workers > 1.
    Batch order is non-deterministic across workers, which is fine for
    shuffled training. An exception in ``make_batch`` or ``pick_work`` is
    raised by the ``next()`` that would have returned that batch.
    """

    def __init__(
        self,
        make_batch,
        n_prefetch: int = 2,
        num_workers: int = 1,
        pick_work=None,
    ):
        num_workers = max(1, int(num_workers))
        self._queue: queue.Queue = queue.Queue(
            maxsize=max(n_prefetch, num_workers)
        )
        self._make_batch = make_batch
        self._pick_work = pick_work
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._active = num_workers
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                if self._pick_work is not None:
                    with self._lock:
                        work = self._pick_work()
                    batch = self._make_batch(work)
                else:
                    batch = self._make_batch()
            except StopIteration:
                # End-of-stream sentinel only once EVERY worker has drained,
                # so late batches from other workers are not cut off.
                with self._lock:
                    self._active -= 1
                    last = self._active == 0
                if last:
                    self._queue.put(None)
                return
            except Exception as exc:
                # Handed to the consumer, which raises it: a worker that died
                # silently would leave next() waiting forever.
                batch = exc
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        # Drain so workers blocked on a full queue observe the stop flag,
        # then join: no worker may still be inside make_batch (touching the
        # dataset) when the caller proceeds to eval/validation.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=30.0)
