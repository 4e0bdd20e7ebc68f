"""The port's span recorder: what each layer did, when, and on whose
behalf.

A span is a name, a start and an end in ns on ``time.time_ns()`` (the
clock of the profiler's host events, so spans line up with a
``torch.profiler`` trace of the card), its id, the id of the span that
caused it, the id of its call (the root span of a ``decode_many`` or
``encode_lossless_many``), pid and tid, and a few integer attributes.
Each thread keeps its own stack of open spans; work handed to another
thread or process takes its caller's ``context()`` as an explicit
parent. Finished spans stay in memory, up to ``CAP`` (past it a span is
dropped and counted in ``dropped``), until ``drain()`` takes them.

``JXLT_PROF`` turns it on at import and ``enable()`` at run time;
while it is off, ``stage`` returns one shared no-op context manager and
records nothing.

Usage:
    from libjxl_torch.utils import prof
    with prof.stage("acs") as sp:
        ...
        sp.set(blocks=n)
    prof.dump()     # total and self time by name
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import NamedTuple

enabled = os.environ.get("JXLT_PROF", "") not in ("", "0")

CAP = 1 << 17          # spans kept until drained
dropped = 0            # spans lost past CAP, since the process started

_spans: list = []
_lock = threading.Lock()
_local = threading.local()
_pid = os.getpid()
_seq = itertools.count(1)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int        # 0: none
    call: int          # id of the root span of its call
    pid: int
    tid: int
    attrs: dict | None


def _new_id() -> int:
    # unique across the (spawned) processes of one host: the pid in the
    # high bits
    return (_pid << 32) | next(_seq)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _keep(batch) -> None:
    global dropped
    with _lock:
        room = max(0, CAP - len(_spans))
        _spans.extend(batch[:room])
        dropped += max(0, len(batch) - room)


class _Open:
    """A span while it runs; ``set`` adds integer attributes."""
    __slots__ = ("name", "parent", "call", "id", "attrs", "start_ns")

    def __init__(self, name: str, parent, attrs: dict):
        self.name, self.parent, self.attrs = name, parent, attrs or None

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)

    def __enter__(self):
        self.id = _new_id()
        st = _stack()
        if self.parent is not None:
            parent, call = self.parent
        elif st:
            parent, call = st[-1].id, st[-1].call
        else:
            parent, call = 0, 0
        self.parent, self.call = parent, call or self.id
        st.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        _stack().pop()
        _keep([Span(self.name, self.start_ns, end, self.id, self.parent,
                    self.call, _pid, threading.get_native_id(), self.attrs)])


class _Noop:
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP = _Noop()


def stage(name: str, parent: tuple | None = None, **attrs):
    """A span around a ``with`` block. ``parent``: a ``context()`` from
    another thread or process; by default the innermost open span of
    this thread."""
    if not enabled:
        return NOOP
    return _Open(name, parent, attrs)


def enable(on: bool = True) -> None:
    global enabled
    enabled = bool(on)


def context() -> tuple | None:
    """(span id, call id) of this thread's innermost open span, to give
    work on another thread or process as its parent; (0, 0) with none
    open; None while the recorder is off."""
    if not enabled:
        return None
    st = _stack()
    return (st[-1].id, st[-1].call) if st else (0, 0)


def drain() -> list:
    """The finished spans (``Span``), oldest first; the buffer is
    cleared."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


def extend(spans) -> None:
    """Add spans recorded in another process (a pool task's)."""
    _keep(list(spans))


def task(ctx: tuple, name: str, fn, *args, **attrs):
    """In a pool worker: ``fn(*args)`` under a span ``name`` whose parent
    is the caller's ``ctx``, the recorder on for its length. Returns
    (result, the spans this process holds, drained)."""
    was = enabled
    enable(True)
    try:
        with stage(name, parent=ctx, **attrs):
            out = fn(*args)
    finally:
        enable(was)
    return out, drain()


def totals(spans) -> dict:
    """{name: (total s, self s, count)}, by total time. Self time is a
    span's time less the part of it that its children cover."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out: dict = {}
    for s in spans:
        covered, reach = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        t, own, n = out.get(s.name, (0.0, 0.0, 0))
        dt = s.end_ns - s.start_ns
        out[s.name] = (t + dt / 1e9, own + (dt - covered) / 1e9, n + 1)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def dump(header: str = "", spans=None) -> None:
    """Print total and self time by name, of ``spans`` or of what the
    recorder holds (left in place)."""
    if spans is None:
        with _lock:
            spans = list(_spans)
    if header:
        print(f"== {header} ==", flush=True)
    for k, (t, own, n) in totals(spans).items():
        print(f"  {k:<28} {t:8.3f}s  self {own:8.3f}s  x{n}", flush=True)
