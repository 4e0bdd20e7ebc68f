"""The traced run's reading of the device: ``torch.profiler`` over the
measured window, summarised in memory (no trace file is written).

The harness opens a ``record_function`` span named ``jxlbench.call`` around
every call of the loop; device events are the profiler's CUDA kernels,
copies and sets. The summary gives the union of the device's busy
intervals, the traced window (first span start to last span end), device
time by operation name, and the idle gaps between busy intervals, each
named by the harness span that was open during it."""

from __future__ import annotations

from dataclasses import dataclass, field

CALL_SPAN = "jxlbench.call"


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    end_us: float


@dataclass
class TraceSummary:
    events: list                      # DeviceEvent, sorted by start
    spans: list                       # (start_us, end_us) of the calls
    window_us: float
    busy_us: float
    by_name: dict = field(default_factory=dict)   # name -> (count, us)
    gaps: list = field(default_factory=list)      # (us, what the host did)

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    @property
    def window_s(self) -> float:
        return self.window_us / 1e6

    def kernel_us(self, substring: str) -> tuple[int, float]:
        """Launches and device microseconds of the operations whose name
        contains ``substring``."""
        n, us = 0, 0.0
        for name, (c, t) in self.by_name.items():
            if substring in name:
                n += c
                us += t
        return n, us

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((t / 1e6, name) for name, (_, t) in
                      self.by_name.items()), reverse=True)[:top]
        return {"device_ops": [[name, s] for s, name in ops],
                "idle_gaps": [[what, us / 1e6] for us, what in
                              self.gaps[:top]]}


def summarise(events, spans) -> TraceSummary:
    """``events``: DeviceEvents; ``spans``: the (start, end) microseconds
    of every call span, on the profiler's clock."""
    spans = sorted(spans)
    if not spans:
        raise ValueError("no call spans in the trace")
    w0, w1 = spans[0][0], max(e for _, e in spans)
    evs = sorted((e for e in events if e.end_us > w0 and e.start_us < w1),
                 key=lambda e: e.start_us)
    by_name: dict = {}
    merged: list = []
    for e in evs:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + (e.end_us - e.start_us))
        s, t_end = max(e.start_us, w0), min(e.end_us, w1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t_end)
        else:
            merged.append([s, t_end])
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            inside = any(s <= mid <= e for s, e in spans)
            gaps.append((b - a, CALL_SPAN if inside else "between calls"))
    gaps.sort(reverse=True)
    return TraceSummary(events=evs, spans=spans, window_us=w1 - w0,
                        busy_us=busy, by_name=by_name, gaps=gaps)


def from_profiler(prof) -> TraceSummary:
    """Summarise a finished ``torch.profiler.profile`` from its raw
    kineto events. (``prof.events()`` builds a Python tree of every host
    operation first, which takes minutes for a window of many calls.)"""
    from torch.autograd import DeviceType

    events, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name, dev = e.name(), e.device_type()
        if name == CALL_SPAN:
            # the span is also mirrored onto the device's timeline as an
            # annotation; only the host's copy is a span
            if dev == DeviceType.CPU:
                t0 = e.start_ns() / 1e3
                spans.append((t0, t0 + e.duration_ns() / 1e3))
        elif dev == DeviceType.CUDA:
            t0 = e.start_ns() / 1e3
            events.append(DeviceEvent(name, t0, t0 + e.duration_ns() / 1e3))
    return summarise(events, spans)
