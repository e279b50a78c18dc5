"""Host->device input pipeline utilities (the JAX package's
``data/pipeline.py``).

- :func:`device_prefetch` keeps N batches in flight on the card so the
  host-side batch assembly overlaps device compute (the analogue of
  DataLoader ``prefetch_factor``, ViT_dataloader.py:74-87): each batch is
  copied from pinned host memory on a copy stream of its own, and the
  consumer's stream waits for that copy before it uses the tensors.
- :func:`host_shard` slices each batch down to this process's share for
  multi-process training; :func:`as_device_batches` with a mesh slices it
  to the rank's rows and prefetches them.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..utils import profiling


class _PinnedPool:
    """Pinned host buffers for the copies in flight.  A buffer is handed out
    again only after the event recorded behind its last copy has completed;
    at most ``limit`` sets exist, so the host waits on the oldest copy rather
    than pinning more memory (pinning costs more than the copy)."""

    def __init__(self, limit: int):
        self.limit = limit
        self.sets: collections.deque = collections.deque()  # (buffers, event)

    def take(self) -> dict:
        for _ in range(len(self.sets)):
            buffers, event = self.sets.popleft()
            if event.query():
                return buffers
            self.sets.append((buffers, event))
        if len(self.sets) < self.limit:
            return {}
        buffers, event = self.sets.popleft()
        with profiling.span("data.prefetch_wait"):
            event.synchronize()
        return buffers

    def give(self, buffers: dict, event: torch.cuda.Event) -> None:
        self.sets.append((buffers, event))


def _staged(buffers: dict, key: str, src: torch.Tensor) -> torch.Tensor:
    """``src`` copied into the pinned buffer ``buffers[key]`` (grown as
    needed), as a view of ``src``'s shape."""
    buf = buffers.get(key)
    if buf is None or buf.dtype != src.dtype or buf.numel() < src.numel():
        buf = buffers[key] = torch.empty(src.numel(), dtype=src.dtype, pin_memory=True)
    view = buf[: src.numel()].view(src.shape)
    view.copy_(src)
    return view


def device_prefetch(
    loader: Iterable[Mapping], *, size: int = 2, device=None
) -> Iterator[dict]:
    """Batches of ``loader`` (dicts of arrays) as tensors on ``device`` (the
    card unless the caller asks for the CPU), ``size`` of them staged
    ahead.  On the CPU the batches pass through as tensors, in order."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in loader:
            yield {k: torch.as_tensor(v) for k, v in batch.items()}
        return

    copy_stream = torch.cuda.Stream(dev)
    pool = _PinnedPool(limit=size + 1)

    def put(batch):
        buffers = pool.take()
        out = {}
        with torch.cuda.stream(copy_stream):
            for key, value in batch.items():
                src = torch.as_tensor(np.ascontiguousarray(value))
                out[key] = _staged(buffers, key, src).to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        pool.give(buffers, event)
        return out, event

    def ready(staged):
        out, event = staged
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(event)
        for t in out.values():
            t.record_stream(consumer)  # allocated on the copy stream
        return out

    # the span "data.prefetch": the generator's own work between two yields
    queue: collections.deque = collections.deque()
    it = iter(loader)
    with profiling.span("data.prefetch"):
        for batch in it:
            queue.append(put(batch))
            if len(queue) == size:
                break
    while queue:
        with profiling.span("data.prefetch"):
            out = queue.popleft()
            for batch in it:
                queue.append(put(batch))
                break
            out = ready(out)
        yield out


def host_shard(
    batch: Mapping, *, process_index: int | None = None, process_count: int | None = None
) -> dict:
    """Slice the global batch to this process's contiguous shard.  The
    index and count default to ``torch.distributed``'s rank and world size
    when it is initialised, else 0 and 1."""
    dist = torch.distributed
    initialised = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if initialised else 0
    if process_count is None:
        process_count = dist.get_world_size() if initialised else 1
    if process_count == 1:
        return dict(batch)
    from ..parallel.mesh import contiguous_rows

    return {k: v[contiguous_rows(v.shape[0], process_index, process_count,
                                 f"process count {process_count}")]
            for k, v in batch.items()}


def as_device_batches(
    loader: Iterable[Mapping], *, mesh=None, prefetch: int = 2, device=None
) -> Iterator[dict]:
    """Loader -> device batches (:func:`device_prefetch`).  Under ``mesh``
    (:func:`..parallel.make_mesh`) each global batch is cut to this rank's
    rows (:func:`..parallel.mesh.host_rows`) on the host and prefetched to
    the mesh's device."""
    if mesh is None:
        yield from device_prefetch(loader, size=prefetch, device=device)
        return
    from ..parallel.mesh import host_rows

    yield from device_prefetch((host_rows(mesh, batch) for batch in loader), size=prefetch,
                               device=mesh.device)
