"""Background-thread batch prefetching (the port's copy of
``fact_clip_tpu/data/prefetch.py``).

Overlaps host-side batch assembly (file IO, padding) with device compute: the
loader thread keeps ``depth`` assembled batches queued while the card
consumes the previous ones.
"""

from __future__ import annotations

import queue
import threading


class PrefetchIterator:
    """Wrap any batch iterable; assemble batches on a worker thread."""

    _SENTINEL = object()

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = max(1, depth)

    def __len__(self):
        return len(self.iterable)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err = []

        def worker():
            try:
                for item in self.iterable:
                    q.put(item)
            except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]


def prefetch(iterable, depth: int = 2):
    return PrefetchIterator(iterable, depth)
