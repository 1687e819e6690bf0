"""Host→device input prefetch: a producer thread and double buffering.

Counterpart of ``ps_tpu/data/prefetch.py``. ``threaded_source`` is copied
as it is. ``device_prefetch`` keeps ``depth`` batches in flight; where the
reference's overlap came from ``jax.device_put`` being asynchronous, on the
card each placement runs on a side CUDA stream: the copies come from
pinned host memory with ``non_blocking=True``
(:func:`ps_tpu_torch.kv.store.to_device`), and the
consumer's stream waits on that copy's event only when the batch is handed
out (``record_stream`` tells the allocator the consumer's stream uses it),
so batch N+1 lands while step N runs. On the CPU a placement is a plain
``.to(device)``.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Iterable, Iterator, Optional

import torch

from ps_tpu_torch.api import current_context
from ps_tpu_torch.kv.store import to_device


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (dict, tuple, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _tensors(v)


def device_prefetch(batches: Iterable, place: Optional[Callable] = None,
                    depth: int = 2) -> Iterator:
    """Yield device-resident batches with ``depth`` placements in flight.

    Args:
      batches: host-side batch iterable (e.g. a data generator).
      place: host→device placement, e.g. ``store.shard_batch``. Default:
        a non-blocking copy from pinned memory to the device of the runtime
        :func:`ps_tpu_torch.init` created.
      depth: batches resident ahead of consumption (2 = double buffering).
    """
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    device = torch.device(current_context().device)
    if place is None:
        place = functools.partial(to_device, device=device, non_blocking=True)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def ready(placed, event):
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in _tensors(placed):
                if t.is_cuda:
                    t.record_stream(consumer)
        return placed

    buf = collections.deque()
    for item in batches:
        if stream is None:
            buf.append((place(item), None))
        else:
            with torch.cuda.stream(stream):
                placed = place(item)
            buf.append((placed, stream.record_event()))
        if len(buf) >= depth:
            yield ready(*buf.popleft())
    while buf:
        yield ready(*buf.popleft())


def threaded_source(batches: Iterable, capacity: int = 2) -> Iterator:
    """Run a host batch generator in a producer thread behind a bounded
    queue, overlapping generation with training. With CPU-heavy synthetic
    generators this turns ``gen + step`` per iteration into
    ``max(gen, step)``; on a single-core host the generator remains the
    floor — a real input stack spreads it over many loader processes.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=capacity)
    _END = object()

    def produce():
        try:
            for item in batches:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
