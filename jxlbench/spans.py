"""The port's own spans in a traced run: read from its span recorder,
split into set-up and window, and used to name the device's idle gaps.

The recorder is ``RECORDER``: a module with ``enable(on)`` and
``drain()``, whose spans carry ``name``, ``start_ns`` and ``end_ns`` on
``time.time_ns()`` (the clock of the profiler's events), ``id``,
``parent`` and ``call``, and integer ``attrs``. The readers of program
spans call ``arm()`` when they are imported: the harness imports a
cell's per-layer readers before its set-up, and only in a traced run,
so the recorder records the set-up and the window of traced runs only.
A program without such a recorder gives no spans, and the readers
nothing."""

from __future__ import annotations

import importlib

from jxlbench.tracing import CALL_SPAN

RECORDER = "libjxl_torch.utils.prof"


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        mod = importlib.import_module(RECORDER)
    except ImportError:
        return None
    if not (callable(getattr(mod, "enable", None)) and
            callable(getattr(mod, "drain", None))):
        return None
    return mod


def arm() -> None:
    """Turn the program's recorder on (see the module's docstring)."""
    rec = recorder()
    if rec is not None:
        rec.enable(True)


def collect(run):
    """(set-up spans, window spans) of a traced run, drained from the
    recorder once: spans that end before the window's first call are
    set-up. Sets ``run.setup_spans`` and ``run.summary.program_spans``
    and names the summary's idle gaps by the program spans
    (``name_gaps``). None without a trace or a recorder."""
    if hasattr(run, "setup_spans"):
        return run.setup_spans, run.summary.program_spans
    rec = recorder()
    if rec is None or not run.trace or run.summary is None or \
            not run.summary.spans:
        return None
    spans = rec.drain()
    w0 = run.summary.spans[0][0]
    run.setup_spans = [s for s in spans if s.end_ns / 1e3 < w0]
    run.summary.program_spans = [s for s in spans if s.end_ns / 1e3 >= w0]
    name_gaps(run.summary, spans)
    return run.setup_spans, run.summary.program_spans


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def union_us(spans, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] that the spans cover."""
    total, reach = 0.0, lo
    for a, b in sorted((s.start_ns / 1e3, s.end_ns / 1e3) for s in spans):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def window_pct(run, name: str) -> float | None:
    """Share of the traced window that spans ``name`` cover."""
    got = collect(run)
    if got is None or run.summary.window_us <= 0:
        return None
    spans = named(got[1], name)
    if not spans:
        return None
    w0 = run.summary.spans[0][0]
    return 100.0 * union_us(spans, w0, w0 + run.summary.window_us) / \
        run.summary.window_us


def ms_per_mp(run, name: str) -> float | None:
    """Time of every span ``name`` in the window, summed, in ms over the
    megapixels of the calls that returned."""
    got = collect(run)
    mp = sum(c.mp for c in run.ok_calls)
    if got is None or mp <= 0:
        return None
    spans = named(got[1], name)
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / mp


def _depths(spans) -> dict:
    """{span id: number of its ancestors among ``spans``}."""
    parent = {s.id: s.parent for s in spans}
    depth: dict = {}
    for sid in parent:
        chain = []
        while sid in parent and sid not in depth:
            chain.append(sid)
            sid = parent[sid]
        d = depth.get(sid, -1)
        for c in reversed(chain):
            d += 1
            depth[c] = d
    return depth


def name_gaps(summary, spans) -> None:
    """Name each of ``summary``'s idle gaps after the deepest program
    span open at its midpoint (of several at that depth, the one that
    ends last: the one its caller waits for); a gap under none keeps the
    harness's name. The gaps are those of ``tracing.summarise``: between
    the union of the device's busy intervals, inside the window."""
    w0, w1 = summary.spans[0][0], max(e for _, e in summary.spans)
    merged: list = []
    for e in summary.events:
        s, t = max(e.start_us, w0), min(e.end_us, w1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((0.5 * (a + b), b - a) for a, b in
                   zip(edges[0::2], edges[1::2]) if b > a))
    depth = _depths(spans)
    todo = sorted(spans, key=lambda s: s.start_ns)
    active: list = []
    k, named_gaps = 0, []
    for mid, us in gaps:
        while k < len(todo) and todo[k].start_ns / 1e3 <= mid:
            active.append(todo[k])
            k += 1
        active = [s for s in active if s.end_ns / 1e3 >= mid]
        if active:
            what = max(active, key=lambda s: (depth[s.id], s.end_ns)).name
        elif any(s <= mid <= e for s, e in summary.spans):
            what = CALL_SPAN
        else:
            what = "between calls"
        named_gaps.append((us, what))
    named_gaps.sort(reverse=True)
    summary.gaps = named_gaps
