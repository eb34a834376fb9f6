"""Background input preparation for the training and eval loops (port of
`opus_pllm_tpu/utils/prefetch.py`: `prefetch_to_device` :28).

What stalls a device step loop is the host work of producing the next
batch: tokenization, numpy collation, disk reads, the copy to the device
(the role of torch's DataLoader workers in the reference's trainers).
`prefetch_to_device` runs that work on a background thread and keeps up
to `size` prepared batches ahead of the consumer, so the loop's iterator
does not wait on it. The producer only prepares and places batches; the
steps stay on the consumer's thread. An exception in the producer is
raised at the consumer's next `next()`; a consumer that stops early (a
step that raises, a partial loop) releases the thread, which then exits
instead of blocking on a full queue.

Spans (`utils.observability`): `prefetch.produce` on the producer thread
around producing and placing each item, `prefetch.wait` on the
consumer's around each wait for the next one.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from ..core.util import to_device
from .observability import span

_END = object()


def prefetch_to_device(batches: Iterable, size: int = 2,
                       place: Optional[Callable] = None,
                       device=None) -> Iterator:
    """Iterate `batches` on a background thread, staging each with `place`
    (default: `core.util.to_device`, every tensor and array of the batch
    to `device`, None: CUDA) and keeping up to `size` staged batches
    ahead. Yields in order; re-raises the producer's errors. `place` runs
    on the producer thread."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    place = place or (lambda b: to_device(b, device))
    q: "queue.Queue" = queue.Queue(maxsize=size)
    err: list = []
    abandoned = threading.Event()

    def put(item) -> None:
        # a bounded put that gives up once the consumer is gone, so the
        # thread never blocks forever holding staged batches
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def produce():
        try:
            it = iter(batches)
            while True:
                with span("prefetch.produce"):
                    b = next(it, _END)
                    if b is _END:
                        return
                    staged = place(b)
                put(staged)
                if abandoned.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — raised at the consumer
            err.append(e)
        finally:
            put(_END)

    t = threading.Thread(target=produce, daemon=True,
                         name="opus-pllm-prefetch")
    t.start()
    try:
        while True:
            with span("prefetch.wait"):
                item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        abandoned.set()
