"""The reader of ``pinned_reuse_pct.decode`` on synthetic runs: frames
fetched into page-locked blocks the host cache already held, over the
frames handed in; nothing with no frames or against a program without
the counters; and its entry resolves in every decode cell."""

import importlib.util
import os

import pytest

from jxlbench import registry
from jxlbench.tests.test_jxlbench_metrics import _decode_run

NAME = "pinned_reuse_pct.decode"
FRAMES = "decode_many.pinned_frames"
NEW = "decode_many.pinned_new_blocks"


def _read(run):
    return run.cell.metric(NAME).read(run)


def test_reused_blocks_over_the_frames_handed_in():
    run = _decode_run()
    assert set(run.cell.metric(NAME).COUNTERS) == {FRAMES, NEW}
    run.counters.update({FRAMES: 4, NEW: 1})
    assert _read(run) == pytest.approx(75)
    run.counters.update({FRAMES: 4, NEW: 0})
    assert _read(run) == pytest.approx(100)
    # frames that came back pageable count as not reused
    run.counters.update({FRAMES: 2, NEW: 0})
    assert _read(run) == pytest.approx(50)


def test_nothing_without_frames_or_the_counters():
    run = _decode_run()
    run.counters.update({FRAMES: 0, NEW: 0})
    run.calls = []
    assert _read(run) is None
    assert _read(_decode_run()) is None
    run = _decode_run()
    run.counters[FRAMES] = 4
    assert _read(run) is None


@pytest.mark.parametrize("counter", ["pinned_frames", "pinned_new_blocks"])
def test_a_program_without_the_counters_names_none(monkeypatch, counter):
    from libjxl_torch.api import decoder
    monkeypatch.delattr(decoder.decode_many, counter)
    path = os.path.join(registry.ROOT, "jxlbench", "metrics", NAME + ".py")
    spec = importlib.util.spec_from_file_location("pinned_reuse_bare", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.COUNTERS == {}
    assert mod.read(_decode_run()) is None


def test_the_entry_resolves_in_the_decode_cells():
    entry = [m for m in registry.benchmark()["per_layer"]
             if m["name"] == NAME]
    assert len(entry) == 1
    assert entry[0]["source"] == "program_counter"
    assert entry[0]["moves"] == "decode_mp_s"
    for cell in entry[0]["workloads"]:
        c = registry.resolve(cell)
        assert NAME in [m["name"] for m in c.per_layer]
        assert "decode_mp_s" in [m["name"] for m in c.end_to_end]
        assert callable(c.metric(NAME).read)
    assert set(entry[0]["workloads"]) == {
        w["name"] for w in registry.benchmark()["workloads"]
        if w["traffic"].startswith("decode")}
