"""Each metric reader on a synthetic run: calls on the host clock, a
synthetic profiler event list and counter deltas."""

import pytest

from jxlbench import registry
from jxlbench.harness import CallRecord, Run
from jxlbench.tracing import DeviceEvent, summarise

BENCH = registry.benchmark()
CELL = registry.resolve("e7_decode_4k")
ENC = registry.resolve("lossless_4k_batch")
H, W = 2160, 3840


def _decode_run(trace=True) -> Run:
    run = Run(cell=CELL, seed=1, seconds=1.0, trace=trace, device="cuda",
              kind="NVIDIA H100 80GB HBM3")
    frame = dict(h=H, w=W, gab=True, epf_iters=1)
    # two calls of 2 frames: 0.0-0.5 s and 0.5-1.0 s
    run.calls = [CallRecord(0.0, 0.5, [frame, frame]),
                 CallRecord(0.5, 1.0, [frame, frame])]
    # device busy 0.1-0.2 s and 0.6-0.7 s (an overlapping pair inside);
    # the kernels take 0.2 ms (Gaborish) and 0.3 ms (EPF) a frame
    ev = [DeviceEvent("void gab_kernel(float const*)", 1e5, 1e5 + 200),
          DeviceEvent("void gab_kernel(float const*)", 1.1e5, 1.1e5 + 200),
          DeviceEvent("void epf_plus_kernel<1>(...)", 1.2e5, 1.2e5 + 300),
          DeviceEvent("void epf_plus_kernel<1>(...)", 1.3e5, 1.3e5 + 300),
          DeviceEvent("Memcpy DtoH", 1e5, 2e5),
          DeviceEvent("void gab_kernel(float const*)", 6e5, 6e5 + 200),
          DeviceEvent("void gab_kernel(float const*)", 6.1e5, 6.1e5 + 200),
          DeviceEvent("void epf_plus_kernel<1>(...)", 6.2e5, 6.2e5 + 300),
          DeviceEvent("void epf_plus_kernel<1>(...)", 6.3e5, 6.3e5 + 300),
          DeviceEvent("Memcpy DtoH", 6e5, 7e5)]
    run.summary = summarise(ev, [(0.0, 5e5), (5e5, 1e6)])
    run.counters = {"decode_many.device_frames": 4,
                    "gaborish_filter.launches": 4,
                    "epf_filter.launches": 4}
    return run


def _read(name, run):
    return run.cell.metric(name).read(run)


def test_summary_union_and_gaps():
    s = _decode_run().summary
    assert s.busy_us == pytest.approx(2e5)
    assert s.window_us == pytest.approx(1e6)
    assert s.kernel_us("gab_kernel") == (4, pytest.approx(800))
    gaps = dict((round(us), what) for us, what in s.gaps)
    assert gaps[round(4e5)] == "jxlbench.call"


def test_decode_readers():
    run = _decode_run()
    mp = 4 * H * W / 1e6
    assert _read("device_frames_pct.decode", run) == pytest.approx(100)
    assert _read("filter_launches_per_frame.decode", run) == 2
    assert _read("device_ms_per_mp.decode", run) == pytest.approx(200 / mp)
    assert _read("device_idle_pct.decode", run) == pytest.approx(80)
    assert _read("call_p95_ms.decode", run) == pytest.approx(500)
    g = 4 * max(24 * H * W / 3.35e12, 33 * H * W / 6.7e13)
    assert _read("gaborish_roofline.decode", run) == \
        pytest.approx(100 * g / 800e-6)
    e = 4 * max((24 * H * W + 4 * 270 * 480) / 3.35e12, 105 * H * W / 6.7e13)
    assert _read("epf_roofline.decode", run) == \
        pytest.approx(100 * e / 1200e-6)


def test_end_to_end_readers():
    run = _decode_run(trace=False)
    assert _read("decode_mp_s", run) == pytest.approx(4 * H * W / 1e6)


def test_readers_find_nothing_without_a_trace_or_a_card():
    run = _decode_run()
    run.summary = None
    for name in ("device_ms_per_mp.decode", "device_idle_pct.decode",
                 "gaborish_roofline.decode", "epf_roofline.decode"):
        assert _read(name, run) is None
    run = _decode_run()
    run.kind = "some other card"
    assert _read("gaborish_roofline.decode", run) is None
    assert _read("device_idle_pct.decode", run) is not None


def test_encode_readers():
    run = Run(cell=ENC, seed=1, seconds=1.0, trace=True, device="cuda",
              kind="NVIDIA H100 80GB HBM3")
    img = dict(h=H, w=W, c=3, bytes=14_000_000)
    run.calls = [CallRecord(0.0, 1.0, [img, img])]
    run.summary = summarise(
        [DeviceEvent("pack_chunks_kernel(uint4 const*)", 1e5, 1e5 + 100),
         DeviceEvent("pack_chunks_kernel(uint4 const*)", 3e5, 3e5 + 100)],
        [(0.0, 1e6)])
    assert _read("window_mp_s.encode", run) == pytest.approx(2 * H * W / 1e6)
    assert _read("bpp", run) == pytest.approx(8 * 14e6 / (H * W))
    chunks = 135 * 3 * 65536 // 128
    b = 4 * chunks * 128 + 14_000_000 + 4 * chunks
    assert _read("pack_roofline.encode", run) == \
        pytest.approx(100 * 2 * b / 3.35e12 / 200e-6)
    assert _read("device_idle_pct.encode", run) == pytest.approx(99.98)


def test_from_profiler_reads_the_call_spans():
    """The traced run's reading of a real profiler (host only here): one
    span a call, on the profiler's clock, and no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from jxlbench.tracing import CALL_SPAN, from_profiler

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function(CALL_SPAN):
                torch.ones(64).sum()
    s = from_profiler(prof)
    assert len(s.spans) == 3
    assert all(b > a for a, b in s.spans)
    assert s.window_us >= sum(b - a for a, b in s.spans)
    assert s.events == [] and s.busy_us == 0
