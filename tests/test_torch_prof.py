"""The port's span recorder (``libjxl_torch/utils/prof.py``) and the spans
of the serving decode and the lossless serving encode, on the CPU.

* Spans nest per thread, take an explicit parent across threads and
  processes, are capped, drained, and recorded not at all while off.
* Spans are stamped on the clock of the profiler's host events.
* ``decode_many``'s pool tasks bring their spans back under the caller's
  ``decode_many.host_wait``; ``encode_lossless_many`` splices under its
  root on its threads. Outputs are the same with the recorder on and
  off."""
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libjxl_torch.utils import prof  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def recorder_off():
    prof.enable(False)
    prof.drain()
    yield
    prof.enable(False)
    prof.drain()


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nested_spans_take_their_parent_and_call():
    prof.enable(True)
    with prof.stage("root", images=2) as root:
        with prof.stage("child") as child:
            with prof.stage("leaf") as leaf:
                leaf.set(bytes=7)
        with prof.stage("sibling"):
            pass
    got = _by_name(prof.drain())
    r, c, lf, sib = (got[n][0] for n in ("root", "child", "leaf",
                                         "sibling"))
    assert r.parent == 0 and r.call == r.id == root.id
    assert c.parent == r.id and c.id == child.id
    assert lf.parent == c.id and sib.parent == r.id
    assert {s.call for s in (r, c, lf, sib)} == {r.id}
    assert r.attrs == {"images": 2} and lf.attrs == {"bytes": 7}
    assert c.attrs is None
    assert r.start_ns <= c.start_ns <= lf.start_ns <= lf.end_ns <= \
        c.end_ns <= sib.start_ns <= sib.end_ns <= r.end_ns
    assert {s.pid for s in (r, c, lf)} == {os.getpid()}
    assert lf.tid == threading.get_native_id()


def test_explicit_parent_on_a_pool_thread():
    """A thread's stack is its own: a span opened on an executor thread
    takes the parent it is given, and the caller's stack is untouched."""
    prof.enable(True)

    def work(ctx, k):
        assert prof.context() == (0, 0)     # nothing open on this thread
        with prof.stage("work", parent=ctx, k=k):
            with prof.stage("inner"):
                time.sleep(0.001)
        return threading.get_native_id()

    with prof.stage("root") as root:
        ctx = prof.context()
        assert ctx == (root.id, root.id)
        with ThreadPoolExecutor(3) as ex:
            tids = set(ex.map(work, [ctx] * 6, range(6)))
        assert prof.context() == ctx
    got = _by_name(prof.drain())
    assert len(got["work"]) == 6 and len(got["inner"]) == 6
    work_ids = {s.id for s in got["work"]}
    assert all(s.parent == root.id and s.call == root.id
               for s in got["work"])
    assert all(s.parent in work_ids and s.call == root.id
               for s in got["inner"])
    assert {s.tid for s in got["work"]} == tids
    assert threading.get_native_id() not in tids


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not prof.enabled
    a, b = prof.stage("x"), prof.stage("y", parent=(1, 1), n=3)
    assert a is b is prof.NOOP
    with a as sp:
        sp.set(bytes=1)
    assert prof.context() is None
    assert prof.drain() == []


def test_enable_turns_the_recorder_on_and_off_at_run_time():
    prof.enable(True)
    with prof.stage("on"):
        pass
    prof.enable(False)
    with prof.stage("off"):
        pass
    assert [s.name for s in prof.drain()] == ["on"]


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(prof, "CAP", 5)
    prof.enable(True)
    before = prof.dropped
    for _ in range(8):
        with prof.stage("s"):
            pass
    prof.extend([prof.Span("x", 0, 1, 1, 0, 1, 1, 1, None)] * 2)
    assert prof.dropped - before == 5
    assert len(prof.drain()) == 5
    with prof.stage("s"):
        pass
    assert len(prof.drain()) == 1 and prof.dropped - before == 5


def test_drain_returns_oldest_first_and_clears():
    prof.enable(True)
    for name in ("a", "b", "c"):
        with prof.stage(name):
            pass
    assert [s.name for s in prof.drain()] == ["a", "b", "c"]
    assert prof.drain() == []


def test_totals_and_self_time():
    """Self time is the span's time less the union of its children's."""
    S = prof.Span
    spans = [S("root", 0, 100, 1, 0, 1, 1, 1, None),
             S("kid", 10, 40, 2, 1, 1, 1, 1, None),
             S("kid", 30, 50, 3, 1, 1, 1, 2, None),    # overlaps the first
             S("grandkid", 12, 20, 4, 2, 1, 1, 1, None)]
    t = prof.totals(spans)
    assert list(t) == ["root", "kid", "grandkid"]
    assert t["root"] == pytest.approx((100e-9, 60e-9, 1))
    assert t["kid"] == pytest.approx((50e-9, 42e-9, 2))
    assert t["grandkid"] == pytest.approx((8e-9, 8e-9, 1))


def test_dump_prints_the_operators_view(capsys):
    prof.enable(True)
    with prof.stage("outer"):
        with prof.stage("inner"):
            pass
    prof.dump("stages")
    out = capsys.readouterr().out
    assert "== stages ==" in out and "outer" in out and "self" in out
    assert len(prof.drain()) == 2        # dump leaves the spans in place


def test_many_threads_lose_no_span():
    """More threads than cores, a short switch interval: every span is
    kept or counted as dropped, and each keeps its own thread's parent."""
    prof.enable(True)
    n_threads, per = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(_):
            for _ in range(per):
                with prof.stage("outer") as o:
                    with prof.stage("inner") as i:
                        pass
                    assert i.parent == o.id
            return True

        with ThreadPoolExecutor(n_threads) as ex:
            assert all(ex.map(work, range(n_threads), timeout=120))
    finally:
        sys.setswitchinterval(old)
    spans = prof.drain()
    assert len(spans) == 2 * n_threads * per
    outer = {s.id: s.tid for s in spans if s.name == "outer"}
    assert len(outer) == n_threads * per
    assert all(outer[s.parent] == s.tid for s in spans
               if s.name == "inner")


def test_spans_share_the_profilers_clock():
    """A recorder span and a ``record_function`` span opened together
    start within 5 ms of each other on the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prof.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.stage("ours"):
            with record_function("theirs"):
                torch.ones(16).sum()
    ours = prof.drain()[0]
    theirs = [e for e in p.profiler.kineto_results.events()
              if e.name() == "theirs"]
    assert theirs
    assert abs(theirs[0].start_ns() - ours.start_ns) < 5e6


# the serving decode on a 2-worker pool


def _fixture(name: str) -> bytes:
    with open(os.path.join(REPO, "tests", "data", name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def streams():
    """A variable-block, a DCT8 and a 16-bit DCT8 stream, and one that
    takes the general path."""
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    img = np.arange(40 * 56 * 3, dtype=np.uint8).reshape(40, 56, 3)
    return [_fixture("torch_vardct_var/graphics_256x320_e7.jxl"),
            _fixture("torch_vardct/rgb16_301x517.jxl"),
            _fixture("torch_vardct_var/graphics_256x320_e7.jxl"),
            encode_lossless(img, EncodeOptions(effort=2))]


@pytest.fixture(scope="module")
def traced_pool():
    """A 2-worker pool spawned while the recorder is on, and the spans of
    its start."""
    from libjxl_torch.parallel import host_pool
    host_pool.shutdown()
    prof.enable(True)
    try:
        host_pool.warm(2)
        spans = prof.drain()
    finally:
        prof.enable(False)
    yield host_pool, spans
    host_pool.shutdown()


def test_decode_many_spans_come_back_from_the_workers(streams, traced_pool):
    from libjxl_torch.api.decoder import decode_many
    host_pool, start = traced_pool
    spawn = _by_name(start)["host_pool.spawn"]
    assert len(spawn) == 1 and spawn[0].attrs == {"workers": 2}

    prof.enable(True)
    got = decode_many(streams, workers=2, device="cpu")
    spans = prof.drain()
    prof.enable(False)
    by = _by_name(spans)
    root, = by["decode_many"]
    wait, = by["decode_many.host_wait"]
    assert root.call == root.id and root.attrs == {"streams": 4}
    assert wait.parent == root.id
    assert all(s.call == root.id for n, ss in by.items()
               if n != "host.import" for s in ss)
    tasks = by["host.task"]
    assert len(tasks) == 4
    assert all(t.parent == wait.id and t.pid != os.getpid() for t in tasks)
    assert wait.start_ns <= min(t.start_ns for t in tasks)
    assert max(t.end_ns for t in tasks) <= wait.end_ns
    task_ids = {t.id for t in tasks}
    ac = by["host.ac_decode"]
    assert len(ac) == 3                     # the general-path stream has none
    assert all(s.parent in task_ids and s.pid != os.getpid() for s in ac)
    assert all(s.attrs["threads"] >= 1 and s.attrs["groups"] >= 1
               for s in ac)
    assert len(by["host.parse"]) == 4 and len(by["host.stage_out"]) == 3
    # the workers' start, carried back by their first traced tasks
    imports = by.get("host.import", [])
    assert imports and all(s.parent == spawn[0].id for s in imports)
    assert len(by["decode_many.device"]) == 2      # var and 16-bit chunks
    # one fetch of both chunks, one wait; on the CPU nothing is pinned
    fetch, = by["decode_many.fetch"]
    assert fetch.attrs == {"bytes": sum(a.nbytes for a in got[:3]),
                           "pinned": 0}
    assert len(by["decode_many.host_fallback"]) == 1

    # the same pixels with the recorder off, and no spans
    again = decode_many(streams, workers=2, device="cpu")
    assert prof.drain() == []
    for a, b in zip(got, again, strict=True):
        np.testing.assert_array_equal(a, b)


def test_untraced_pool_task_is_unchanged(streams, traced_pool):
    """Off, a task takes the stream alone and returns the staging alone."""
    from libjxl_torch.api.decoder import _device_decode_inputs
    host_pool, _ = traced_pool
    got = host_pool._decode_inputs_task(streams[1])
    want = _device_decode_inputs(streams[1])
    assert type(got) is tuple and len(got) == 3 and got[1] == want[1]
    (res, spans) = host_pool._decode_inputs_task(streams[1], (5, 5))
    assert res[1] == want[1] and spans[-1].name == "host.task"
    assert spans[-1].parent == 5 and spans[-1].call == 5


# the lossless serving encode


def test_encode_lossless_many_splices_under_its_root():
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless_many
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (300, 280, 3), dtype=np.uint8)
            for _ in range(3)]
    opts = EncodeOptions(use_device=True, entropy="prefix-device")
    plain = encode_lossless_many(imgs, opts, device="cpu")
    assert prof.drain() == []
    prof.enable(True)
    traced = encode_lossless_many(imgs, opts, device="cpu")
    spans = prof.drain()
    prof.enable(False)
    assert traced == plain
    by = _by_name(spans)
    root, = by["encode_lossless_many"]
    assert root.attrs == {"images": 3} and root.tid == \
        threading.get_native_id()
    for name in ("encode.upload", "encode.probe", "encode.device",
                 "encode.wait"):
        assert by[name] and all(s.parent == root.id and s.call == root.id
                                for s in by[name]), name
    splice = by["encode.splice"]
    assert splice and all(s.parent == root.id and s.call == root.id
                          for s in splice)
    assert all(s.tid != root.tid for s in splice)
    assert sum(s.attrs["images"] for s in splice) == 3
    assert sum(s.attrs["bytes"] for s in splice) == sum(map(len, plain))
    assert all(s.attrs["threads"] >= 1 for s in splice)
