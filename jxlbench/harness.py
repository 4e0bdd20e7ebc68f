"""One run of one cell: set-up, the measured closed loop, the metrics,
the check of the outputs against the plain reference, and the result.

The loop driver of the cell's traffic (``drivers/<driver>.py``) supplies
``setup(run)``, ``call(run, k)``, ``release(run)``, ``check(run)`` and
``close(run)``; every metric is a reader in ``metrics/<name>.py`` with a
``read(run)`` that returns a number or None (nothing to read), and may
name the program's counters it needs in ``COUNTERS``."""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from jxlbench import tracing
from jxlbench.registry import resolve_attr


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), or since the
    harness was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclass
class CallRecord:
    """One call of the loop: host-clock start and end, the items it
    handed in (images or frames, each a dict with at least ``h`` and
    ``w``; encodes add ``bytes``) and whether it returned."""
    t0: float
    t1: float
    items: list
    ok: bool = True

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0

    @property
    def mp(self) -> float:
        return sum(it["h"] * it["w"] for it in self.items) / 1e6


@dataclass
class Check:
    name: str
    value: float
    limit: float


@dataclass
class Run:
    """What the driver and the readers see of one run."""
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    state: dict = field(default_factory=dict)
    calls: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    summary: object = None
    kind: str = ""

    @property
    def ok_calls(self) -> list:
        return [c for c in self.calls if c.ok]

    @property
    def window_s(self) -> float:
        return self.calls[-1].t1 - self.calls[0].t0 if self.calls else 0.0

    @property
    def items(self) -> list:
        return [it for c in self.ok_calls for it in c.items]

    def peaks(self) -> dict | None:
        """The card's published peaks (``roofline/peaks.json``), or None
        for a card that the table does not name."""
        for name, p in self.cell.peaks().items():
            if name in self.kind:
                return p
        return None

    def roofline(self, kernel: str):
        return self.cell.roofline(kernel)


def _read_counters(spec: dict) -> dict:
    out = {}
    for name, path in spec.items():
        v = resolve_attr(path)
        out[name] = list(v) if isinstance(v, (list, tuple)) else v
    return out


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, list):
            out[k] = [a - b for a, b in zip(v, before[k])]
        else:
            out[k] = v - before[k]
    return out


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def _loop(run: Run, driver) -> None:
    import torch

    t_start = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        with torch.profiler.record_function(tracing.CALL_SPAN):
            try:
                items = driver.call(run, k)
                ok = True
            except Exception as e:      # a call that raises counts as failed
                print(f"call {k} raised {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                items, ok = run.state.get("last_items", []), False
        t1 = time.perf_counter()
        run.calls.append(CallRecord(t0, t1, items, ok))
        k += 1
        if t1 - t_start >= run.seconds:
            break


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> tuple[dict, list]:
    """Run ``cell`` once; returns (result line, checks). The caller
    looks for forbidden packages once this has returned (the check
    imports the reference after the window)."""
    import torch

    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              device=device)
    if device.startswith("cuda"):
        run.kind = torch.cuda.get_device_name(0)
    driver = cell.driver()
    wanted = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: cell.metric(m["name"]) for m in wanted
               if m["name"] != "setup_s"}
    counter_spec = {}
    for mod in readers.values():
        counter_spec.update(getattr(mod, "COUNTERS", {}))
    try:
        driver.setup(run)
        _sync(device)
        setup_s = process_age_s()
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        before = _read_counters(counter_spec)
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device.startswith("cuda"):
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                _loop(run, driver)
                _sync(device)
        else:
            _loop(run, driver)
        _sync(device)
        peak = (torch.cuda.max_memory_allocated() if device.startswith(
            "cuda") else 0)
        run.counters = _delta(_read_counters(counter_spec), before)
        if trace:
            run.summary = tracing.from_profiler(prof)
            del prof
        metrics = {}
        for m in wanted:
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        driver.release(run)
        checks = driver.check(run)
    finally:
        driver.close(run)
    attempted = sum(len(c.items) for c in run.calls)
    failed = sum(len(c.items) for c in run.calls if not c.ok)
    correct = bool(attempted and not failed and
                   all(np.isfinite(c.value) and c.value <= c.limit
                       for c in checks))
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": run.kind or device, "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    if trace and run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.summary is not None:
        result["breakdown"] = run.summary.breakdown()
    result["calls"] = len(run.calls)
    result["call_ms"] = [round(c.latency_s * 1e3, 1) for c in run.calls]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks
