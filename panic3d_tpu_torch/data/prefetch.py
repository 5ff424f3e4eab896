"""Background-thread input pipeline, a copy of panic3d_tpu/data/prefetch.py
(pure Python).

Role of the reference's DataLoader worker processes (training data fetch,
training_loop_v0.py:329-347): a depth-bounded queue of READY device
batches. The worker thread runs the host-side batch assembly (dataset
indexing or the synthetic batch's draws, collate) and the copy to the
card from pinned memory, so the card does not wait on input between steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class _Stop:
    pass


class Prefetcher:
    """Wraps an iterator; `prepare` runs in the worker thread per item.

    depth bounds host memory (depth+1 batches in flight). Exceptions in
    the worker surface on the consuming thread at the next __next__.
    """

    def __init__(self, it: Iterator, prepare: Optional[Callable] = None,
                 depth: int = 2):
        self._it = it
        self._prepare = prepare or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                out = self._prepare(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(out, timeout=0.25)
                        break
                    except queue.Full:
                        continue
            self._q.put(_Stop())
        except BaseException as e:  # surfaced to the consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _Stop):
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()
        # drain so the worker's blocked put wakes up
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # join (bounded): a daemon thread killed mid-copy at interpreter
        # exit can take the runtime's teardown down with it
        self._thread.join(timeout=10)
