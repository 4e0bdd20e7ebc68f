"""Pluggable parallel runners (reference ``include/jxl/parallel_runner.h``
C ABI, ``lib/threads/thread_parallel_runner.cc``,
``resizable_parallel_runner.cc``).

The reference routes every data-parallel host loop through a caller-
supplied runner callback; here the same seam is a tiny Runner protocol:

    runner.run(n_tasks, fn[, init])  # fn(task_index, thread_index)

Device (TPU) parallelism is XLA's job — these runners cover HOST-side
section work: group parse/assembly, byte splicing, per-image batch fan-
out. ``set_default_runner`` swaps the implementation process-wide, the
way the C API threads a JxlParallelRunner through encoder/decoder
options.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor


class SequentialRunner:
    """JxlParallelRunner default: run everything inline on the caller
    thread (parallel_runner.h 'NULL runner' semantics)."""

    num_threads = 1

    def run(self, n_tasks: int, fn, init=None) -> None:
        if init is not None:
            init(1)
        for i in range(n_tasks):
            fn(i, 0)

    def map(self, fn, items):
        return [fn(it) for it in items]


class ThreadRunner:
    """thread_parallel_runner.cc: a persistent worker pool; tasks are
    dispatched with the worker's thread index (for per-thread caches)."""

    def __init__(self, num_threads: int | None = None):
        self.num_threads = max(1, num_threads or
                               min(8, os.cpu_count() or 1))
        self._pool = ThreadPoolExecutor(self.num_threads)
        self._local = threading.local()
        self._next = iter(range(1 << 62))
        self._lock = threading.Lock()

    def _thread_index(self) -> int:
        idx = getattr(self._local, "idx", None)
        if idx is None:
            with self._lock:
                idx = next(self._next)
            self._local.idx = idx
        return idx % self.num_threads

    def _on_worker(self) -> bool:
        return getattr(self._local, "in_pool", False)

    def _mark(self, fn):
        # pool workers are dedicated threads: flag them permanently so
        # NESTED run/map calls execute inline instead of queueing into
        # the same pool — outer tasks waiting on inner futures that can
        # never be scheduled is a hard deadlock once the outer fan-out
        # reaches the worker count (seen: e9's 4 candidate encodes each
        # blocking on their per-group tokenize map)
        def call(it):
            self._local.in_pool = True
            return fn(it)
        return call

    def run(self, n_tasks: int, fn, init=None) -> None:
        if init is not None:
            init(self.num_threads)
        if n_tasks <= 1 or self._on_worker():
            for i in range(n_tasks):
                fn(i, 0)
            return
        list(self._pool.map(
            self._mark(lambda i: fn(i, self._thread_index())),
            range(n_tasks)))

    def map(self, fn, items):
        items = list(items)
        if len(items) <= 1 or self._on_worker():
            return [fn(it) for it in items]
        return list(self._pool.map(self._mark(fn), items))

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


class ResizableRunner(ThreadRunner):
    """resizable_parallel_runner.cc: worker count adjustable at runtime
    (the reference uses it to scale with the image size)."""

    def set_num_threads(self, n: int) -> None:
        n = max(1, n)
        if n == self.num_threads:
            return
        old = self._pool
        self._pool = ThreadPoolExecutor(n)
        self.num_threads = n
        old.shutdown(wait=False)

    @staticmethod
    def suggested_threads(xsize: int, ysize: int) -> int:
        """JxlResizableParallelRunnerSuggestThreads: one worker per
        ~1 MP of image, capped by the host core count."""
        mp = (xsize * ysize) / 1e6
        return max(1, min(int(mp + 0.5), os.cpu_count() or 1))


_default = None
_default_lock = threading.Lock()


def default_runner():
    """Process-wide runner used by the host-parallel paths (decoder
    group fan-out, batch APIs); ThreadRunner unless overridden."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = ThreadRunner()
    return _default


def set_default_runner(runner) -> None:
    """Swap the process-wide runner (the JxlDecoderSetParallelRunner /
    JxlEncoderSetParallelRunner seam)."""
    global _default
    _default = runner
