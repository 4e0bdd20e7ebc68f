"""Arithmetic that the metric readers (``jxlbench/metrics/``) share."""

from __future__ import annotations

import numpy as np


def p95_ms(latencies_s: list) -> float | None:
    """95th percentile (linear interpolation) of call latencies, in ms."""
    if not latencies_s:
        return None
    return float(np.percentile(np.asarray(latencies_s) * 1e3, 95))


def rate_mp_s(run) -> float | None:
    """Megapixels of every call that returned, over the window."""
    if not run.ok_calls or run.window_s <= 0:
        return None
    return sum(c.mp for c in run.ok_calls) / run.window_s


def device_ms_per_mp(run) -> float | None:
    mp = sum(c.mp for c in run.ok_calls)
    if run.summary is None or mp <= 0 or run.summary.busy_us <= 0:
        return None
    return run.summary.busy_us / 1e3 / mp


def idle_pct(run) -> float | None:
    s = run.summary
    if s is None or s.window_us <= 0 or s.busy_us <= 0:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)


def roofline_pct(run, kernel_substring: str, costs) -> float | None:
    """Share of the kernels' device time that their bound needs: the sum
    over launches of max(bytes / bandwidth, flops / peak) over the sum
    of their measured times. ``costs`` are the (bytes, flops) of every
    launch the window made; None where the card's peaks are unknown or
    the kernel never ran."""
    peaks = run.peaks()
    if run.summary is None or peaks is None or not costs:
        return None
    n, us = run.summary.kernel_us(kernel_substring)
    if n == 0 or us <= 0:
        return None
    bound_s = sum(max(b / peaks["hbm_bytes_per_s"],
                      f / peaks["fp32_flops_per_s"]) for b, f in costs)
    return 100.0 * bound_s / (us / 1e6)
