"""Batch prefetch: load ahead on a thread, and stage onto the card.

Port of ``vision_semantic_segmentation_tpu/train/prefetch.py`` (the role of
the reference's ``DataLoader(num_workers, pin_memory)``, ref
data/build.py:95-103).  A background thread pulls batches from any
iterable into a bounded queue, so decode and transforms run while the card
trains on the previous batch.  With a CUDA ``device`` the thread also stages
each batch: it copies the arrays into pinned host memory and starts their
copies to the card on a side stream, as ``runtime/replay.py``'s
:class:`~..runtime.replay.StagedWindow` does for frame windows; the
consumer gets a ``StagedWindow`` and orders its stream after the copies
with ``wait()``.  Ordering is preserved exactly; worker exceptions re-raise
on the consumer; iteration is re-startable (one thread per epoch).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..runtime.replay import StagedWindow

_SENTINEL = object()


def stage_batch(batch: Dict[str, np.ndarray], device: torch.device,
                stream: Optional["torch.cuda.Stream"] = None) -> StagedWindow:
    """Host arrays -> tensors on ``device``: through pinned memory and
    ``stream`` (copies still in flight; call ``wait()``) when given, else
    plain copies."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if stream is None:
        return StagedWindow({k: t.to(device) for k, t in host.items()})
    pinned = {k: t.pin_memory() for k, t in host.items()}
    with torch.cuda.stream(stream):
        arrays = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
        ready = torch.cuda.Event()
        ready.record(stream)
    return StagedWindow(arrays, ready=ready, pinned=pinned)


class PrefetchLoader:
    """Wrap a batch iterable with a depth-bounded background prefetcher.

    ``device``: None yields the host batches; a device yields
    :class:`StagedWindow` batches on it (pinned copies on a side stream for
    a CUDA device).
    """

    def __init__(self, loader: Iterable, depth: int = 2, device: Optional[DeviceLike] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth
        self.device = torch.device(device) if device is not None else None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None and self.device.type == "cuda" else None)

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        set_epoch = getattr(self.loader, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if self.device is not None:
                        batch = stage_batch(batch, self.device, self._stream)
                    if not put(batch):
                        return  # consumer abandoned iteration
            except BaseException as exc:  # noqa: BLE001 - re-raised by the consumer
                put(exc)
                return
            put(_SENTINEL)

        thread = threading.Thread(target=worker, daemon=True, name="prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # early exit: release a producer blocked on the full queue and
            # reap the thread, or every abandoned epoch leaks both
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=10.0)
