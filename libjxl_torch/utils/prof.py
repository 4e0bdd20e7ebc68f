"""Lightweight stage timing for roofline profiling.

Enabled by JXLT_PROF=1 (zero overhead otherwise).  The reference tracks
per-layer bit totals in AuxOut (enc_aux_out.h:19-106); this is the
wall-clock analog used to produce ROOFLINE*.md stage tables.

Usage:
    from libjxl_torch.utils import prof
    with prof.stage("acs"):
        ...
    prof.report()   # {"acs": (seconds, calls), ...} sorted by time
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

enabled = os.environ.get("JXLT_PROF", "") not in ("", "0")

times: dict = defaultdict(float)
counts: dict = defaultdict(int)
_depth = [0]


@contextmanager
def stage(name: str):
    if not enabled:
        yield
        return
    _depth[0] += 1
    label = ("." * (_depth[0] - 1)) + name
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _depth[0] -= 1
        times[label] += dt
        counts[label] += 1


def reset() -> None:
    times.clear()
    counts.clear()


def report() -> dict:
    return {k: (round(v, 4), counts[k])
            for k, v in sorted(times.items(), key=lambda kv: -kv[1])}


def dump(header: str = "") -> None:
    if header:
        print(f"== {header} ==", flush=True)
    for k, (t, n) in report().items():
        print(f"  {k:<28} {t:8.3f}s  x{n}", flush=True)
