"""The readers of the port's spans (``jxlbench/spans.py`` and the metrics
that use it) on synthetic spans and summaries, and a traced run of each
cell on the CPU at a small size, where the readers read the port's own
spans."""

from __future__ import annotations

import sys
import types

import pytest

from jxlbench import registry, spans as S
from jxlbench.harness import CallRecord, Run, run_cell
from jxlbench.tests.test_jxlbench_faults import (
    _small_decode_cell, _small_encode_cell,
)
from jxlbench.tracing import CALL_SPAN, DeviceEvent, summarise
from libjxl_torch.utils import prof

DEC = registry.resolve("e7_decode_4k")
ENC = registry.resolve("lossless_4k_batch")
H, W = 2160, 3840
MS = 1_000_000          # ns


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    prof.enable(False)
    prof.drain()


class _Recorder:
    def __init__(self, spans):
        self.spans = spans

    def enable(self, on):
        pass

    def drain(self):
        out, self.spans = self.spans, []
        return out


def _sp(name, t0_ms, t1_ms, sid, parent=0, call=1, **attrs):
    return prof.Span(name, t0_ms * MS, t1_ms * MS, sid, parent, call, 1, 1,
                     attrs or None)


def _decode_run(monkeypatch, spans) -> Run:
    """Two calls of 2 4K frames, 0-500 ms and 500-1000 ms; the card busy
    100-200 ms and 600-700 ms."""
    run = Run(cell=DEC, seed=1, seconds=1.0, trace=True, device="cuda",
              kind="NVIDIA H100 80GB HBM3")
    frame = dict(h=H, w=W, gab=True, epf_iters=1)
    run.calls = [CallRecord(0.0, 0.5, [frame, frame]),
                 CallRecord(0.5, 1.0, [frame, frame])]
    run.summary = summarise([DeviceEvent("Memcpy HtoD", 1e5, 2e5),
                             DeviceEvent("Memcpy DtoH", 6e5, 7e5)],
                            [(0.0, 5e5), (5e5, 1e6)])
    monkeypatch.setattr(S, "recorder", lambda: _Recorder(spans))
    return run


# set-up: spawn at -900 ms, the last worker ready at -100 ms; call 1 with
# two tasks under its host wait, call 2 with one
DECODE_SPANS = [
    _sp("host_pool.spawn", -900, -850, 90, call=90),
    _sp("host.import", -800, -300, 91, parent=90, call=90),
    _sp("host.import", -700, -100, 92, parent=90, call=90),
    _sp("decode_many", 0, 480, 1, call=1),
    _sp("decode_many.host_wait", 10, 95, 2, parent=1, call=1),
    _sp("host.task", 20, 80, 3, parent=2, call=1),
    _sp("host.ac_decode", 30, 60, 4, parent=3, call=1, threads=8),
    _sp("host.task", 20, 90, 5, parent=2, call=1),
    _sp("host.stage_out", 40, 70, 6, parent=5, call=1),
    _sp("decode_many.device", 95, 100, 7, parent=1, call=1),
    _sp("decode_many.fetch", 200, 470, 8, parent=1, call=1),
    _sp("decode_many", 510, 990, 11, call=11),
    _sp("decode_many.host_wait", 520, 600, 12, parent=11, call=11),
    _sp("host.task", 530, 570, 13, parent=12, call=11),
    _sp("host.ac_decode", 540, 560, 14, parent=13, call=11),
]


def test_gaps_take_the_deepest_span_that_ends_last(monkeypatch):
    run = _decode_run(monkeypatch, list(DECODE_SPANS))
    setup, window = S.collect(run)
    assert [s.id for s in setup] == [90, 91, 92]
    assert len(window) == len(DECODE_SPANS) - 3
    assert run.setup_spans is setup and run.summary.program_spans is window
    # 0-100 ms: mid 50 ms under both tasks, at depth 3 the AC decode and
    # the staging, which ends last; 200-600: mid 400 in the first call's
    # fetch; 700-1000: mid 850 in the second call's decode_many alone
    assert sorted(run.summary.gaps) == sorted([
        (1e5, "host.stage_out"), (4e5, "decode_many.fetch"),
        (3e5, "decode_many")])
    # collected once
    assert S.collect(run) == (setup, window)


def test_gaps_outside_program_spans_keep_the_harness_names(monkeypatch):
    spans = [_sp("decode_many", 100, 150, 1)]     # inside busy time
    run = _decode_run(monkeypatch, spans)
    run.summary = summarise([DeviceEvent("k", 1e5, 2e5),
                             DeviceEvent("k", 6e5, 7e5)],
                            [(0.0, 3e5), (5e5, 1e6)])
    S.collect(run)
    assert sorted(run.summary.gaps) == sorted([
        (1e5, CALL_SPAN), (4e5, "between calls"), (3e5, CALL_SPAN)])


def test_decode_readers(monkeypatch):
    run = _decode_run(monkeypatch, list(DECODE_SPANS))
    mp = 4 * H * W / 1e6

    def read(name):
        return DEC.metric(name).read(run)

    # host waits 10-95 and 520-600 ms of the 1000 ms window
    assert read("host_wait_pct.decode") == pytest.approx(16.5)
    assert read("ac_decode_ms_per_mp.decode") == pytest.approx(50 / mp)
    # 85 - 70 and 80 - 40 ms: the median of two
    assert read("pool_transfer_ms.decode") == pytest.approx(27.5)
    assert read("pool_start_s.decode") == pytest.approx(0.8)


def test_encode_readers(monkeypatch):
    run = Run(cell=ENC, seed=1, seconds=1.0, trace=True, device="cuda",
              kind="NVIDIA H100 80GB HBM3")
    img = dict(h=H, w=W, c=3, bytes=14_000_000)
    run.calls = [CallRecord(0.0, 1.0, [img, img])]
    run.summary = summarise([DeviceEvent("k", 1e5, 2e5)], [(0.0, 1e6)])
    spans = [_sp("encode_lossless_many", 0, 990, 1),
             _sp("encode.splice", 300, 700, 2, parent=1, images=1),
             _sp("encode.splice", 500, 900, 3, parent=1, images=1),
             _sp("encode.wait", 600, 950, 4, parent=1),
             _sp("encode.wait", 960, 1100, 5, parent=1)]   # past the window
    monkeypatch.setattr(S, "recorder", lambda: _Recorder(spans))
    mp = 2 * H * W / 1e6
    assert ENC.metric("splice_ms_per_mp.encode").read(run) == \
        pytest.approx(800 / mp)
    assert ENC.metric("encode_wait_pct.encode").read(run) == \
        pytest.approx(39.0)


def test_readers_find_nothing_without_spans(monkeypatch):
    """A program without a span recorder: every reader gives None and
    raises nothing; so without a trace, or with no such span."""
    names = ["host_wait_pct.decode", "ac_decode_ms_per_mp.decode",
             "pool_transfer_ms.decode", "pool_start_s.decode"]
    run = _decode_run(monkeypatch, list(DECODE_SPANS))
    monkeypatch.setattr(S, "recorder", lambda: None)
    assert all(DEC.metric(n).read(run) is None for n in names)
    run = _decode_run(monkeypatch, list(DECODE_SPANS))
    run.trace, run.summary = False, None
    assert all(DEC.metric(n).read(run) is None for n in names)
    run = _decode_run(monkeypatch, [_sp("decode_many", 0, 480, 1)])
    assert all(DEC.metric(n).read(run) is None for n in names)
    assert all(ENC.metric(n).read(run) is None for n in
               ("splice_ms_per_mp.encode", "encode_wait_pct.encode"))


def test_recorder_without_enable_and_drain_is_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "fake_prof",
                        types.SimpleNamespace(stage=None))
    monkeypatch.setattr(S, "RECORDER", "fake_prof")
    assert S.recorder() is None
    S.arm()                                 # and arming does nothing


def _names(res) -> set:
    return {what for what, _ in res["breakdown"]["idle_gaps"]}


def test_traced_decode_run_reads_the_ports_spans(scratch_root):
    prof.enable(False)
    prof.drain()
    cell = _small_decode_cell(str(scratch_root))
    res, _ = run_cell(cell, 2**33 + 5, 1.0, trace=True, device="cpu")
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("host_wait_pct.decode", "ac_decode_ms_per_mp.decode",
                 "pool_transfer_ms.decode", "pool_start_s.decode"):
        assert m[name]["value"] > 0, name
    assert m["host_wait_pct.decode"]["value"] < 100
    program = {"decode_many", "decode_many.host_wait", "host.task",
               "host.parse", "host.ac_decode", "host.stage_out",
               "decode_many.device", "decode_many.fetch"}
    assert _names(res) <= program | {CALL_SPAN, "between calls"}
    assert _names(res) & program


def test_traced_encode_run_reads_the_ports_spans(scratch_root):
    prof.enable(False)
    prof.drain()
    cell = _small_encode_cell(str(scratch_root))
    res, _ = run_cell(cell, 2**33 + 5, 1.0, trace=True, device="cpu")
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["splice_ms_per_mp.encode"]["value"] > 0
    assert 0 < m["encode_wait_pct.encode"]["value"] < 100
    assert _names(res) & {"encode_lossless_many", "encode.upload",
                          "encode.probe", "encode.device", "encode.wait",
                          "encode.splice"}
    # untraced, the readers are not loaded and the recorder stays off
    prof.enable(False)
    res, _ = run_cell(cell, 2**33 + 5, 0.5, trace=False, device="cpu")
    assert not prof.enabled and prof.drain() == []
    assert set(res["metrics"]) == {"bpp", "setup_s"}
