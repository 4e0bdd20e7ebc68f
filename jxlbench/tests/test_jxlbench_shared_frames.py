"""The reader of ``shared_frames_pct.decode`` on synthetic runs: the host
pool's counter ``map_decode_inputs.shared_frames`` over the frames
handed in; nothing with no frames or against a program without the
counter."""

import importlib.util
import os

import pytest

from jxlbench import registry
from jxlbench.tests.test_jxlbench_metrics import _decode_run

NAME = "shared_frames_pct.decode"
COUNTER = "map_decode_inputs.shared_frames"


def _read(run):
    return run.cell.metric(NAME).read(run)


def test_counter_over_the_frames_handed_in():
    run = _decode_run()
    assert COUNTER in run.cell.metric(NAME).COUNTERS
    run.counters[COUNTER] = 3
    assert _read(run) == pytest.approx(75)
    run.counters[COUNTER] = 4
    assert _read(run) == pytest.approx(100)


def test_nothing_without_frames_or_the_counter():
    run = _decode_run()
    run.counters[COUNTER] = 0
    run.calls = []
    assert _read(run) is None
    assert _read(_decode_run()) is None


def test_a_program_without_the_counter_names_none(monkeypatch):
    from libjxl_torch.parallel import host_pool
    monkeypatch.delattr(host_pool.map_decode_inputs, "shared_frames")
    path = os.path.join(registry.ROOT, "jxlbench", "metrics", NAME + ".py")
    spec = importlib.util.spec_from_file_location("shared_frames_bare", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.COUNTERS == {}
    assert mod.read(_decode_run()) is None
