"""Host-side batch prefetching.

Counterpart of `svcc23_fastsvc_tpu/data/prefetch.py`. `PrefetchIterator`
runs a batcher in a daemon thread that fills a bounded queue, so batches
b+1..b+depth are assembled while batch b trains; `BatcherPool` runs N
seeded batchers in N threads into one queue (numpy's slice copies release
the GIL).

Two additions keep the port's `--resume` exact with the thread running
ahead of the steps (the trainer checkpoints its batcher's random state):

- the thread starts at the first `next`, not at construction, so a resume
  can set the batcher's state first;
- `state`, a callable given by the caller, is read after each batch is
  made and queued with it. `PrefetchIterator.state` is then the state that
  belongs to the first batch not yet taken, which is what a checkpoint
  saves; `close` stops the thread and gives that state back through
  `restore`, so the batcher stands where the steps left it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional


class PrefetchIterator:
    """`source`'s items, made up to `depth` ahead in a daemon thread. An
    exception in the thread is raised at the `next` that would have
    returned the item it stopped."""

    def __init__(self, source: Iterable, depth: int = 2, *,
                 state: Optional[Callable] = None,
                 restore: Optional[Callable] = None):
        self._source = source
        self._depth = depth
        self._state_fn = state
        self._restore = restore
        # the state of the first item not yet taken
        self.state = state() if state is not None else None
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._done = object()
        self._err: Optional[BaseException] = None

    def _start(self):
        self._q = queue.Queue(maxsize=self._depth)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                st = self._state_fn() if self._state_fn is not None else None
                self._q.put((item, st))
                if self._stop.is_set():
                    return
        except Exception as e:  # surfaced on next()
            self._err = e
        finally:
            self._q.put((self._done, None))

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._thread is None:
            if self._stop.is_set():
                raise StopIteration
            self._start()
        item, st = self._q.get()
        if item is self._done:
            self._q.put((item, st))  # later calls end the same way
            if self._err is not None:
                raise self._err
            raise StopIteration
        if self._state_fn is not None:
            self.state = st
        return item

    def close(self):
        """Stop the thread, drop the queued items, and hand the state of
        the first item not taken to `restore`."""
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
                try:  # free a slot for a blocked put, which then sees stop
                    self._q.get(timeout=0.05)
                except queue.Empty:
                    pass
            self._thread = None
        if self._restore is not None and self.state is not None:
            self._restore(self.state)


class BatcherPool:
    """N producer threads, each draining its own seeded batcher
    (`make_batcher(seed + 7919 * t)`) into one queue. Each thread's stream
    is reproducible; their interleave is not, and training batches are
    i.i.d. crops, so order carries no meaning. It queues ahead itself, so
    the trainer does not wrap it in a `PrefetchIterator`."""

    is_prefetching = True

    def __init__(self, make_batcher, *, n_threads: int = 3, depth: int = 8,
                 seed: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._threads = []
        for t in range(n_threads):
            th = threading.Thread(target=self._fill,
                                  args=(make_batcher(seed + 7919 * t),),
                                  daemon=True)
            th.start()
            self._threads.append(th)

    def _fill(self, batcher):
        for item in batcher:
            if self._stop.is_set():
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        for th in self._threads:
            while th.is_alive():
                try:
                    self._q.get(timeout=0.05)
                except queue.Empty:
                    pass
        self._threads = []
