"""Batching and host → device prefetch (counterpart of the JAX package's
``data/batching.py``).

The host only slices raw numpy windows into batches; preprocessing runs on
the device.  :func:`prefetch_to_device` overlaps the copy of the next
batches with compute on the current one: a background thread stages each
batch in pinned host memory and copies it with ``non_blocking`` on a side
CUDA stream, and the consumer's stream waits on the copy's event.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch


def batch_iterator(arrays: Dict[str, np.ndarray], batch_size: int,
                   shuffle: bool = False, seed: int = 0,
                   drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Yield dict batches from equally sized host arrays."""
    n = len(next(iter(arrays.values())))
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_last else n
    for s in range(0, stop, batch_size):
        sel = idx[s:s + batch_size]
        yield {k: v[sel] for k, v in arrays.items()}


def multimodal_batch_iterator(eeg: np.ndarray, spec: np.ndarray,
                              y: np.ndarray, batch_size: int,
                              shuffle: bool = False, seed: int = 0
                              ) -> Iterator[Dict[str, np.ndarray]]:
    """The combined EEG + spectrogram dataset's batches (one ``y``)."""
    return batch_iterator({"eeg": eeg, "spec": spec, "y": y}, batch_size,
                          shuffle, seed)


def _stage(batch: Dict[str, Any], dev: torch.device,
           stream: Optional["torch.cuda.Stream"], sync_transfers: bool):
    """(batch on ``dev``, the event its copies end with or None).  Copy
    the batch's arrays to ``dev``: on CUDA through pinned host
    buffers with ``non_blocking`` copies on ``stream``, ending with a
    recorded event (waited on here when ``sync_transfers``); on the CPU as
    tensors (copies of the arrays when ``sync_transfers``, since the
    caller may then reuse its buffers)."""
    if dev.type != "cuda":
        return {k: (torch.tensor(v) if sync_transfers else torch.as_tensor(v))
                if isinstance(v, np.ndarray) else v
                for k, v in batch.items()}, None
    out = {}
    with torch.cuda.stream(stream):
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                out[k] = v
                continue
            host = torch.empty(v.shape, pin_memory=True, dtype=(
                torch.from_numpy(np.empty(0, v.dtype)).dtype))
            host.numpy()[...] = v
            out[k] = host.to(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    if sync_transfers:
        event.synchronize()
    return out, event


def prefetch_to_device(iterator: Iterable[Dict[str, np.ndarray]],
                       size: int = 2,
                       device: Optional[Union[str, torch.device]] = None,
                       sync_transfers: bool = False
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Background-thread prefetcher: keeps up to ``size`` batches staged
    on ``device`` (default ``cuda``) ahead of the consumer.

    Producer exceptions re-raise in the consumer instead of hanging it,
    and closing or abandoning the generator stops the producer and
    releases its staged batches.  On CUDA each yielded batch is ready for
    the consumer's current stream (which waits on the copy's event; the
    tensors are recorded on that stream for the caching allocator).
    ``sync_transfers=True`` makes the producer block until each batch's
    copy has landed before it asks ``iterator`` for the next one, so the
    iterator may reuse its host buffers."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    done, err = object(), object()

    def enqueue(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            for batch in iterator:
                if not enqueue(_stage(batch, dev, stream, sync_transfers)):
                    return
        except BaseException as e:          # noqa: BLE001 — re-raised below
            enqueue((err, e))
            return
        enqueue(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if item[0] is err:
                raise item[1]
            batch, event = item
            if event is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(cur)
            yield batch
    finally:
        stop.set()
        # drain until the producer is gone: one pass races a producer
        # blocked in put(); give up after ~5 s if it is stuck upstream of
        # put() (a daemon thread) rather than hang the consumer
        deadline = time.monotonic() + 5.0
        while t.is_alive() and time.monotonic() < deadline:
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.1)
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
