"""Background-thread prefetch of training batches.

Counterpart of ``pafuse_tpu/runtime/__init__.py::PrefetchingLoader``: a
sampler's ``next_epoch`` runs on a daemon thread that keeps up to ``depth``
assembled batches queued, so host batch assembly overlaps the device step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class PrefetchingLoader:
    """Runs ``sampler.next_epoch()`` on a background thread; other
    attributes are the sampler's."""

    _SENTINEL = object()

    def __init__(self, sampler, depth: int = 2):
        self.sampler = sampler
        self.depth = depth

    def next_epoch(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        error = []

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has left the
            # epoch early, so the thread never blocks on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in self.sampler.next_epoch():
                    if not put(item):
                        return
            except BaseException as e:  # raised again in the consumer
                error.append(e)
            finally:
                put(self._SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    break
                yield item
        finally:
            stop.set()
            t.join()
        if error:
            raise error[0]

    def __getattr__(self, name):
        return getattr(self.sampler, name)
