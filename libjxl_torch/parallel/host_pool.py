"""Process pool for the host stage of the serving decode.

``api/decoder.decode_many`` runs the host half of its device decode
(codestream parse + native AC decode + class staging,
``_device_decode_inputs``) here, one whole stream a task on its own
interpreter; streams the device does not take are decoded here with
``decode``. The Python steps between the native calls hold the GIL, so
threads of one process do not scale with the cores, and processes do:
PERF.md section 5 has ``chip_smoke.py``'s times of the stage on the pool
and on threads.

A task's staging (``FrameRecon`` / ``FrameReconVar``) comes back in
place: the worker writes every array of ``SHARED_MIN`` bytes or more
into one POSIX shared-memory segment of its own (``_Segment``; the
native class staging writes straight into it), and the result message
carries the segment's name, each such array's place in it and the rest
of the result by pickle. The parent maps the segment, unlinks it at
once and views the arrays in place (``_receive``); the mapping goes
with the last view. A worker that cannot reserve the segment's bytes
(``/dev/shm`` full) returns its staging by pickle instead. Segments are
named after the parent's pid (``_prefix``), and the pool's start and
``shutdown`` unlink any such segment left over (a worker killed
mid-task). ``map_decode_inputs.shared_frames`` counts the frames whose
staging came back in a segment.

Workers hide the CUDA card (``CUDA_VISIBLE_DEVICES=""``) before anything
there touches CUDA, so they never create a context on the parent's
card, and filter on the host in float64 at every frame size; the
native host libraries are built in the parent before the pool spawns,
so the workers only load them. The pool persists across calls
(spawn + imports cost seconds; a serving process pays them once).
"""

from __future__ import annotations

import itertools
import mmap
import os
from concurrent.futures import ProcessPoolExecutor
from typing import NamedTuple

import _posixshmem
import numpy as np

_pool: ProcessPoolExecutor | None = None
_pool_size = 0


# the trace context of the span that spawned this worker, where the
# parent's span recorder was on (``utils/prof.py``)
_setup_ctx: tuple | None = None
# in a worker, the prefix of its results' segments (``_prefix`` of the
# parent); None elsewhere, where results stay as they are
_shm_prefix: str | None = None
_shm_count = itertools.count()

# an array of this many bytes or more travels in the segment
SHARED_MIN = 1 << 16
SHM_DIR = "/dev/shm"
_ALIGN = 64
_MAP_FLAGS = mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0)


def _prefix(pid: int) -> str:
    """The name prefix of the segments of the pool of process ``pid``."""
    return f"jxlt_{pid}_"


def _worker_init(ctx: tuple | None = None,
                 shm_prefix: str | None = None) -> None:
    # The parent owns the card; workers only ever run host-side
    # numpy/C. Importing torch does not initialise CUDA, and CUDA reads
    # this variable when it first initialises, so no worker can see the
    # card. decode_many decodes every stream whose filters belong on the
    # card in the parent, so workers filter on the host at every size.
    global _setup_ctx, _shm_prefix
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from libjxl_torch.config import config
    config.device_filters = False
    _setup_ctx = ctx
    _shm_prefix = shm_prefix


class _Leaf(NamedTuple):
    """An array of a result left in its segment: its byte offset there,
    dtype (``dtype.str``) and shape."""

    offset: int
    dtype: str
    shape: tuple


class _Shared(NamedTuple):
    """A result handed over in place: its segment's name (without the
    leading slash) and size, and the result with each array that lies
    in the segment replaced by its ``_Leaf``."""

    name: str
    size: int
    result: tuple


def _map_leaves(obj, fn):
    """``obj`` (tuples, named tuples and dicts of arrays) with ``fn``
    applied to each array or ``_Leaf``."""
    if isinstance(obj, (np.ndarray, _Leaf)):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_leaves(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_leaves(v, fn) for v in obj))
    if isinstance(obj, tuple):
        return tuple(_map_leaves(v, fn) for v in obj)
    return obj


def _unlink(name: str) -> None:
    try:
        _posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        pass


class _Segment:
    """The shared-memory segment of one task's result, in a worker.

    ``alloc`` is the ``alloc`` of ``_device_decode_inputs``: it lays the
    arrays of ``SHARED_MIN`` bytes or more out in one new segment, whose
    bytes it reserves (``posix_fallocate``) before anything is written,
    and makes the others private. Where the reservation fails, every
    array is private and the result goes back by pickle. ``pack`` makes
    the result message; ``close`` unmaps the segment here and unlinks it
    unless it was handed over."""

    def __init__(self, prefix: str):
        self.name = f"{prefix}{os.getpid()}_{next(_shm_count)}"
        self.size = 0
        self.mm: mmap.mmap | None = None
        self._addr = 0
        self._created = self._handed = False

    def alloc(self, specs: list) -> list:
        nbytes = [int(np.prod(shape)) * np.dtype(dt).itemsize
                  for shape, dt in specs]
        offsets, size = [], 0
        for n in nbytes:
            offsets.append(size if n >= SHARED_MIN else None)
            if n >= SHARED_MIN:
                size += -(-n // _ALIGN) * _ALIGN
        if not size or not self._open(size):
            return [np.empty(shape, dt) for shape, dt in specs]
        return [np.empty(shape, dt) if off is None else
                np.ndarray(shape, dt, buffer=self.mm, offset=off)
                for (shape, dt), off in zip(specs, offsets)]

    def _open(self, size: int) -> bool:
        fd = _posixshmem.shm_open("/" + self.name,
                                  os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        self._created = True
        try:
            try:
                # every page now, so that a full /dev/shm fails here and
                # not as a fault on a write
                os.posix_fallocate(fd, 0, size)
            except OSError:
                return False
            self.mm = mmap.mmap(fd, size, flags=_MAP_FLAGS)
        finally:
            os.close(fd)
        self.size = size
        view = np.frombuffer(self.mm, np.uint8)
        self._addr = view.ctypes.data
        del view
        return True

    def pack(self, result):
        """The message that carries ``result`` back: a ``_Shared`` where
        its arrays lie in the segment, else ``result`` itself."""
        if self.mm is None or result is None:
            return result

        def leaf(a: np.ndarray):
            at = a.__array_interface__["data"][0] - self._addr
            if 0 <= at < self.size and a.flags.c_contiguous:
                return _Leaf(at, a.dtype.str, a.shape)
            return a

        fr, key, lf = result
        self._handed = True
        return _Shared(self.name, self.size, (_map_leaves(fr, leaf), key, lf))

    def close(self) -> None:
        if self.mm is not None:
            try:
                self.mm.close()
            except BufferError:
                pass        # an array still views it: unmapped with it
            self.mm = None
        if self._created and not self._handed:
            _unlink(self.name)


def _receive(res):
    """A task's result in this process: a handed-over segment is mapped,
    unlinked at once and its arrays viewed in place."""
    if not isinstance(res, _Shared):
        return res
    fd = _posixshmem.shm_open("/" + res.name, os.O_RDWR, 0o600)
    try:
        _unlink(res.name)
        mm = mmap.mmap(fd, res.size, flags=_MAP_FLAGS)
    finally:
        os.close(fd)
    map_decode_inputs.shared_frames += 1
    fr, key, lf = res.result

    def view(x):
        if isinstance(x, _Leaf):
            return np.ndarray(x.shape, x.dtype, buffer=mm, offset=x.offset)
        return x

    return _map_leaves(fr, view), key, lf


def _sweep() -> None:
    """Unlink every segment of this process's pool left in ``SHM_DIR``."""
    prefix = _prefix(os.getpid())
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return
    for name in names:
        if name.startswith(prefix):
            _unlink(name)


def _decode_inputs(data: bytes):
    """``_device_decode_inputs`` of one stream as a worker returns it:
    in a segment of its own where this process is a pool worker."""
    seg = _Segment(_shm_prefix) if _shm_prefix else None
    try:
        return seg.pack(_stage(data, seg)) if seg else _stage(data, None)
    finally:
        if seg:
            seg.close()


def _stage(data: bytes, seg: _Segment | None):
    from libjxl_torch.api.decoder import _device_decode_inputs
    from libjxl_torch.core.fields import FormatError
    try:
        return _device_decode_inputs(data, alloc=seg and seg.alloc)
    except FormatError:
        return None


def _decode_inputs_task(data: bytes, ctx: tuple | None = None):
    """``_decode_inputs`` of one stream (None: the general path). With
    the caller's trace context ``ctx``, returns (that, this worker's
    spans) instead."""
    if ctx is None:
        return _decode_inputs(data)
    from libjxl_torch.utils import prof
    return prof.task(ctx, "host.task", _decode_inputs, data)


def _decode_inputs_chunk(streams: list, ctx: tuple | None) -> list:
    return [_decode_inputs_task(data, ctx) for data in streams]


def get_pool(workers: int) -> ProcessPoolExecutor:
    """Persistent spawn-context pool of ``workers`` processes (created on
    first use, and anew when another size is asked for)."""
    global _pool, _pool_size
    if _pool is not None and _pool_size == workers:
        return _pool
    if _pool is not None:
        _pool.shutdown(wait=False, cancel_futures=True)
    import multiprocessing as mp

    from libjxl_torch.utils import host_stage, native, prof

    with prof.stage("host_pool.spawn", workers=workers):
        # one build in the parent; the workers load the built libraries
        native.get_lib()
        host_stage.get_lib()
        _sweep()
        # spawn, not fork: the parent may hold a live CUDA context whose
        # locks/threads do not survive fork.
        _pool = ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn"),
            initializer=_worker_init,
            initargs=(prof.context(), _prefix(os.getpid())))
    _pool_size = workers
    return _pool


def _warm_task(_):
    from libjxl_torch.utils import prof
    # under a traced parent, the span waits in this worker for the
    # first traced task to carry it back
    was = prof.enabled
    prof.enable(was or _setup_ctx is not None)
    try:
        with prof.stage("host.import", parent=_setup_ctx):
            # pays the import cost, and loads the native libraries
            import libjxl_torch.api.decoder  # noqa: F401
            from libjxl_torch.utils import host_stage, native
            native.available()
            host_stage.get_lib()
    finally:
        prof.enable(was)
    return os.getpid()


def warm(workers: int) -> None:
    """Spin the workers up and pay their import cost now."""
    pool = get_pool(workers)
    n = _pool_size
    list(pool.map(_warm_task, range(n), chunksize=1))


def map_decode_inputs(streams, workers: int) -> list:
    """``_device_decode_inputs`` over a batch on the process pool.

    Returns one entry per stream (None where the stream needs the
    general path), its arrays in place in the segments the workers
    wrote. Raises whatever the pool raises; the segments of the
    results not taken then are unlinked as they come."""
    from libjxl_torch.utils import prof

    pool = get_pool(workers)
    # up to 4 streams a task once every worker has two tasks (fewer
    # round trips); one a task below that, so that no worker idles
    cs = max(1, min(4, len(streams) // (2 * _pool_size)))
    ctx = prof.context()
    futs = [pool.submit(_decode_inputs_chunk, streams[i:i + cs], ctx)
            for i in range(0, len(streams), cs)]

    def results(fut):
        for res in fut.result():
            if ctx is not None:
                res, spans = res
                prof.extend(spans)
            yield res

    def discard(fut):
        if fut.cancelled() or fut.exception() is not None:
            return
        for res in fut.result():
            res = res[0] if ctx is not None else res
            if isinstance(res, _Shared):
                _unlink(res.name)

    out = []
    try:
        for fut in futs:
            out += [_receive(res) for res in results(fut)]
    except BaseException:
        for fut in futs:
            fut.add_done_callback(discard)
        raise
    return out


map_decode_inputs.shared_frames = 0


def shutdown() -> None:
    global _pool, _pool_size
    if _pool is not None:
        _pool.shutdown(wait=False, cancel_futures=True)
        _pool = None
        _pool_size = 0
    _sweep()
