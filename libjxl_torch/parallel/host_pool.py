"""Process pool for the host stage of the serving decode.

``api/decoder.decode_many`` runs the host half of its device decode
(codestream parse + native AC decode, ``_device_decode_inputs``) here,
one whole stream a task on its own interpreter, and gets the staging
arrays (``FrameRecon`` / ``FrameReconVar``, whose coefficients travel
sparse) back by pickle; streams the device does not take are decoded
here with ``decode``. The Python steps between the native calls hold
the GIL, so threads of one process do not scale with the cores, and
processes do: PERF.md section 5 has ``chip_smoke.py``'s times of the
stage on the pool and on threads.

Workers hide the CUDA card (``CUDA_VISIBLE_DEVICES=""``) before anything
there touches CUDA, so they never create a context on the parent's
card, and filter on the host in float64 at every frame size; the
native host library is built in the parent before the pool spawns, so
the workers only load it. The pool persists across calls
(spawn + imports cost seconds; a serving process pays them once).
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor

_pool: ProcessPoolExecutor | None = None
_pool_size = 0


# the trace context of the span that spawned this worker, where the
# parent's span recorder was on (``utils/prof.py``)
_setup_ctx: tuple | None = None


def _worker_init(ctx: tuple | None = None) -> None:
    # The parent owns the card; workers only ever run host-side
    # numpy/C. Importing torch does not initialise CUDA, and CUDA reads
    # this variable when it first initialises, so no worker can see the
    # card. decode_many decodes every stream whose filters belong on the
    # card in the parent, so workers filter on the host at every size.
    global _setup_ctx
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from libjxl_torch.config import config
    config.device_filters = False
    _setup_ctx = ctx


def _decode_inputs(data: bytes):
    from libjxl_torch.api.decoder import _device_decode_inputs
    from libjxl_torch.core.fields import FormatError
    try:
        return _device_decode_inputs(data)
    except FormatError:
        return None


def _decode_inputs_task(data: bytes, ctx: tuple | None = None):
    """``_device_decode_inputs`` of one stream (None: the general path).
    With the caller's trace context ``ctx``, returns (that, this worker's
    spans) instead."""
    if ctx is None:
        return _decode_inputs(data)
    from libjxl_torch.utils import prof
    return prof.task(ctx, "host.task", _decode_inputs, data)


def get_pool(workers: int) -> ProcessPoolExecutor:
    """Persistent spawn-context pool of ``workers`` processes (created on
    first use, and anew when another size is asked for)."""
    global _pool, _pool_size
    if _pool is not None and _pool_size == workers:
        return _pool
    if _pool is not None:
        _pool.shutdown(wait=False, cancel_futures=True)
    import multiprocessing as mp

    from libjxl_torch.utils import native, prof

    with prof.stage("host_pool.spawn", workers=workers):
        # one build in the parent; the workers load the built library
        native.get_lib()
        # spawn, not fork: the parent may hold a live CUDA context whose
        # locks/threads do not survive fork.
        ctx = prof.context()
        _pool = ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn"),
            initializer=_worker_init, initargs=(ctx,) if ctx else ())
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
            # pays the import cost, and loads the native library
            import libjxl_torch.api.decoder  # noqa: F401
            from libjxl_torch.utils import native
            native.available()
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
    general path). Raises whatever the pool raises."""
    from libjxl_torch.utils import prof

    pool = get_pool(workers)
    # up to 4 streams a task once every worker has two tasks (fewer
    # round trips); one a task below that, so that no worker idles
    cs = max(1, min(4, len(streams) // (2 * _pool_size)))
    ctx = prof.context()
    if ctx is None:
        return list(pool.map(_decode_inputs_task, streams, chunksize=cs))
    out = []
    for res, spans in pool.map(_decode_inputs_task, streams,
                               [ctx] * len(streams), chunksize=cs):
        prof.extend(spans)
        out.append(res)
    return out


def shutdown() -> None:
    global _pool, _pool_size
    if _pool is not None:
        _pool.shutdown(wait=False, cancel_futures=True)
        _pool = None
        _pool_size = 0
