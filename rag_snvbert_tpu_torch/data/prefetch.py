"""Host-side batch prefetching: overlap numpy batch assembly with device
steps.

The reference overlaps host work with GPU compute via DataLoader worker
processes + pin_memory (src/dataset/embedding_rag_dataset.py:609-645,
SURVEY.md section 7 "host I/O ... keep off the critical path with
prefetch").  Here a single daemon thread runs the window-major batch
generator (pure numpy, which releases the GIL in its hot ops) a few items
ahead of the device stream; CUDA's asynchronous launches do the rest.

Copy of rag_snvbert_tpu/data/prefetch.py.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

from ..utils.timing import span

T = TypeVar("T")

_SENTINEL = object()


def prefetch_iter(it: Iterable[T], size: int = 2,
                  transform: Callable[[T], T] | None = None, *,
                  wait_span: str) -> Iterator[T]:
    """Iterate ``it`` on a background thread, keeping up to ``size`` items
    ready.  Exceptions from the producer re-raise at the consumer.

    ``transform`` runs on the producer thread — the hook for issuing
    host->device transfers (torch copies may be issued from any thread) so the copy
    overlaps the previous device step instead of sitting on the critical
    path between steps.

    ``wait_span``: the consumer's wait on the queue is a
    ``utils.timing.span`` of that name, one per item taken (and one for
    the end of the stream, where the consumer reaches it).
    """
    q: queue.Queue = queue.Queue(maxsize=size)

    def produce():
        try:
            for item in it:
                q.put(item if transform is None else transform(item))
        except BaseException as e:  # surfaced on the consumer side
            q.put((_SENTINEL, e))
            return
        q.put((_SENTINEL, None))

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    while True:
        with span(wait_span):
            item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
            if item[1] is not None:
                raise item[1]
            return
        yield item
