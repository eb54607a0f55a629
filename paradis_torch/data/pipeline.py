"""Host → device batching with background-thread prefetch.

The port's counterpart of ``paradis_tpu/data/pipeline.py``: the same
``collate`` functions, the same seeded epoch order
(``np.random.default_rng(seed)`` shuffling ``arange(len(dataset))`` once an
epoch, so both packages visit the same samples in the same order) and the
same two threads, assemble (dataset samples → one numpy batch) and place
(numpy batch → tensors on the loader's device).  ``"index"`` (prediction
batches) stays a numpy array on the host.

On a CUDA device the place thread fills a pinned host buffer from each
array, copies it to the card with ``non_blocking=True`` on the loader's own
stream and records an event after the copies.  The consumer makes its
current (compute) stream wait on that event before it yields the batch, and
marks each tensor as used by that stream (``record_stream``), so the caching
allocator does not hand the batch's memory to a later copy while a step
still reads it.  The pinned buffers come from PyTorch's caching host
allocator, which records the copy on its stream and does not hand a buffer
out again before that copy has completed: a buffer is never refilled under a
copy in flight, and after the first batches no new page-locked memory is
allocated.  On the CPU the place stage wraps the arrays without a copy
(``torch.from_numpy``).

A worker's exception is raised in the consumer.  When the consumer stops
early (a validation limit) the workers see the stop flag within
``_POLL_S`` and end, dropping what they hold; the iteration ends when they
have (a worker finishes the sample it is assembling first).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from paradis_torch import resolve_device

_POLL_S = 0.1  # how often a blocked worker looks at the stop flag
_JOIN_S = 60.0  # the longest the consumer waits for a worker's sample in flight


def collate(samples: list[tuple]) -> dict:
    """Stack dataset samples into a training batch dict."""
    xs, ys, forcings, consts = zip(*samples)
    return {
        "input": np.stack(xs),
        "target": np.stack(ys),
        "forcings": np.stack(forcings),
        "constants": np.stack(consts),
    }


def collate_prediction(samples: list[tuple]) -> dict:
    idxs, xs, forcings, consts = zip(*samples)
    return {
        "index": np.asarray(idxs, np.int64),
        "input": np.stack(xs),
        "forcings": np.stack(forcings),
        "constants": np.stack(consts),
    }


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """``q.put(item)`` unless ``stop`` is set first; whether it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            pass
    return False


class BatchLoader:
    """Iterable over shuffled, prefetched batches of an ERA5Dataset, as
    tensors on ``device`` (``cuda`` unless the caller passes another).

    ``rows`` (over several ranks, ``distributed.local_batch_slice``): the
    rows of each global batch of ``batch_size`` this rank loads.  Every rank
    walks the same seeded global order, so rank r's samples of a batch are
    rows ``rows`` of the one-process run's batch
    (``paradis_tpu/data/pipeline.py:68-91``).  ``block`` (over spatial axes,
    ``(rows, cols)`` of ``sphere.partition.RankGrid``): the rank's latitudes and
    longitudes of every field, cut on the host before the copy to the device
    (the layouts of ``batch_shardings``: ``input`` / ``constants``
    ``[B,H,W,·]``, ``target`` / ``forcings`` ``[B,S,H,W,·]``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 device=None, rows: slice | None = None,
                 block: tuple[slice, slice] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = rows if rows is not None else slice(None)
        self.block = block
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchLoader on a CUDA device and none is available; "
                               "pass device='cpu' to load onto the CPU")
        self._stream = None  # the copy stream, made on first use on a card
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        self._collate = (
            collate_prediction if getattr(dataset, "prediction_stage", False) else collate
        )

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        return order

    def _place(self, batch: dict) -> tuple[dict, torch.cuda.Event | None]:
        """Host batch → tensors on the device, and the event after the copies
        (None on the CPU)."""
        if self.device.type != "cuda":
            return {k: v if k == "index" else torch.from_numpy(v)
                    for k, v in batch.items()}, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in batch.items():
                if k == "index":
                    out[k] = v
                    continue
                pinned = torch.from_numpy(v).pin_memory()
                out[k] = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def __iter__(self) -> Iterator[dict]:
        """Two-stage prefetch pipeline: assemble → place on the device.

        Sample assembly (store decode, normalization, forcings) and the
        host → device copy run in separate threads, so each overlaps the
        other and the device step.
        """
        order = self._epoch_order()
        self._epoch += 1
        n_batches = len(self)
        q_host: queue.Queue = queue.Queue(maxsize=self.prefetch)
        q_dev: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def assemble_worker():
            try:
                for b in range(n_batches):
                    idxs = order[b * self.batch_size : (b + 1) * self.batch_size][self.rows]
                    batch = self._collate([self.dataset[int(i)] for i in idxs])
                    if self.block is not None:
                        batch = {k: v if k == "index" else
                                 np.ascontiguousarray(v[..., self.block[0], self.block[1], :])
                                 for k, v in batch.items()}
                    if not _put(q_host, batch, stop):
                        return
                _put(q_host, None, stop)
            except Exception as e:  # surface worker errors in the consumer
                _put(q_host, e, stop)

        def place_worker():
            try:
                while not stop.is_set():
                    try:
                        item = q_host.get(timeout=_POLL_S)
                    except queue.Empty:
                        continue
                    if item is None or isinstance(item, Exception):
                        _put(q_dev, item, stop)
                        return
                    if not _put(q_dev, self._place(item), stop):
                        return
            except Exception as e:
                _put(q_dev, e, stop)

        workers = [threading.Thread(target=assemble_worker, daemon=True),
                   threading.Thread(target=place_worker, daemon=True)]
        for w in workers:
            w.start()
        try:
            while True:
                item = q_dev.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                batch, event = item
                if event is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(event)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(compute)
                yield batch
        finally:
            stop.set()
            # no worker outlives the iteration: one still running when the
            # process ends can abort it at the interpreter's shutdown
            for w in workers:
                w.join(_JOIN_S)
