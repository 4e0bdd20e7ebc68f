"""The port's process-pool host stage (``libjxl_torch/parallel/
host_pool.py``) against the in-process one, on the CPU.

The staging arrays are the same whether ``_device_decode_inputs`` runs
in-process or on a worker, ``decode_many`` (whose host stage always runs
on the pool) gives the pixels of the in-process staging, and a worker
has the CUDA card hidden and never initialises CUDA. The staging comes
back in place, in a shared-memory segment a worker wrote, or by pickle
where the segment cannot be reserved; no segment outlives its result."""
import mmap
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libjxl_torch.api import decoder as port  # noqa: E402
from libjxl_torch.parallel import host_pool  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture(name: str) -> bytes:
    with open(os.path.join(REPO, "tests", "data", name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def streams():
    """A variable-block, a DCT8 and a 16-bit DCT8 stream."""
    return [_fixture("torch_vardct_var/graphics_256x320_e7.jxl"),
            _fixture("torch_vardct/rgb16_301x517.jxl"),
            _fixture("torch_vardct_var/graphics_256x320_e7.jxl")]


@pytest.fixture(scope="module")
def pool():
    host_pool.warm(2)
    yield host_pool
    host_pool.shutdown()


def _leaves(fr):
    for name, v in zip(fr._fields, fr):
        if name == "classes":
            for s in sorted(v):
                for a in v[s]:
                    yield f"{name}[{s}]", np.asarray(a)
        else:
            yield name, np.asarray(v)


def test_pool_matches_inprocess_staging(streams, pool):
    got = pool.map_decode_inputs(streams, workers=2)
    assert len(got) == len(streams)
    for data, g in zip(streams, got):
        want = port._device_decode_inputs(data)
        assert g is not None and g[1] == want[1]
        assert type(g[0]) is type(want[0])
        for (n, a), (_, b) in zip(_leaves(g[0]), _leaves(want[0]),
                                  strict=True):
            assert a.dtype == b.dtype, n
            np.testing.assert_array_equal(a, b, err_msg=n)
    assert got[0][1][7] == "var" and len(got[1][1]) == 7


def test_decode_many_with_process_pool(streams, pool):
    """decode_many on the pool gives, bit for bit, the pixels of the
    staging done in this process, chunked as decode_many chunks."""
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    from libjxl_torch.models.vardct_decode import (
        decode_frames_device, decode_frames_device_var,
    )
    img = np.arange(40 * 56 * 3, dtype=np.uint8).reshape(40, 56, 3)
    batch = streams + [encode_lossless(img, EncodeOptions(effort=2))]
    before = port.decode_many.device_frames
    got = port.decode_many(batch, workers=2, device="cpu")
    assert port.decode_many.device_frames - before == 3
    (v0, key, lf), (d, key16, lf16), (v1, _, _) = [
        port._device_decode_inputs(s) for s in streams]
    want = decode_frames_device_var([v0, v1], lf, key[4], key[5], key[0],
                                    key[1], device="cpu")
    want.insert(1, decode_frames_device(
        [d], lf16, key16[4], key16[5], key16[0], key16[1],
        maxval=(1 << key16[6]) - 1, device="cpu")[0])
    for a, b in zip(got, want + [img], strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_workers_hide_the_card(streams, pool):
    p = pool.get_pool(2)
    pool.map_decode_inputs(streams, workers=2)
    seen = [p.submit(os.getenv, "CUDA_VISIBLE_DEVICES") for _ in range(4)]
    assert [f.result() for f in seen] == [""] * 4
    inits = [p.submit(torch.cuda.is_initialized) for _ in range(4)]
    assert [f.result() for f in inits] == [False] * 4


def test_pool_of_another_size_is_made_anew(pool):
    first = pool.get_pool(2)
    assert pool.get_pool(2) is first
    other = pool.get_pool(1)
    assert other is not first and pool._pool_size == 1
    pool.get_pool(2)


# the hand-off in place: each result's arrays of 64 KB or more come back
# in a shared-memory segment the worker wrote and this process maps


def _segments(prefix: str) -> list:
    return [n for n in os.listdir(host_pool.SHM_DIR) if n.startswith(prefix)]


def _mapped(prefix: str) -> list:
    with open("/proc/self/maps") as f:
        return [line for line in f if prefix in line]


@pytest.fixture(scope="module")
def large():
    """A var frame and a DCT8 frame, each with arrays of 64 KB or more."""
    return [_fixture("torch_vardct_var/ragged_1001x1503_e5.jxl"),
            _fixture("torch_vardct/ragged_1001x1503.jxl")]


def _assert_same_staging(got, want):
    assert got[1] == want[1] and type(got[0]) is type(want[0])
    for (n, a), (_, b) in zip(_leaves(got[0]), _leaves(want[0]),
                              strict=True):
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_shared_frames_counts_var_and_dct8_frames(large, pool):
    import gc
    prefix = host_pool._prefix(os.getpid())
    before = host_pool.map_decode_inputs.shared_frames
    got = pool.map_decode_inputs(large, workers=2)
    assert host_pool.map_decode_inputs.shared_frames - before == 2
    assert got[0][1][7] == "var" and len(got[1][1]) == 7
    for data, g in zip(large, got):
        _assert_same_staging(g, port._device_decode_inputs(data))
    # the big arrays are views of the mapped segments, which are already
    # unlinked; the mappings go with the last view
    assert isinstance(got[0][0].dc.base, mmap.mmap)
    assert isinstance(got[1][0].coeff_idx.base, mmap.mmap)
    assert not _segments(prefix) and _mapped(prefix)
    del got, g
    gc.collect()
    assert not _mapped(prefix)


def test_no_segment_is_left_after_shutdown(large):
    """A segment of the pool's prefix that no result took (a worker
    killed mid-task) is unlinked by shutdown(), and by the pool's start."""
    import _posixshmem
    prefix = host_pool._prefix(os.getpid())
    for swept_by in ("shutdown", "start"):
        fd = _posixshmem.shm_open(f"/{prefix}0_lost", os.O_CREAT | os.O_RDWR,
                                  0o600)
        os.close(fd)
        assert _segments(prefix)
        if swept_by == "shutdown":
            host_pool.shutdown()
        else:
            host_pool.map_decode_inputs(large[:1], workers=2)
        assert not _segments(prefix)
    host_pool.shutdown()
    assert not _segments(prefix)


def test_results_not_taken_are_unlinked(large, pool):
    """A batch whose first task raises: map_decode_inputs raises, and the
    segment of the result it did not take is unlinked when it comes."""
    import time
    prefix = host_pool._prefix(os.getpid())
    with pytest.raises(Exception):
        pool.map_decode_inputs([None, large[0]], workers=2)
    # until the other task's result has come (the executor's own table
    # of work not yet answered), then a moment for its callbacks
    deadline = time.monotonic() + 60
    while pool._pool._pending_work_items and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.5)
    assert not pool._pool._pending_work_items
    assert not _segments(prefix)
    # the pool still serves
    assert pool.map_decode_inputs(large[:1], workers=2)[0] is not None


def test_packer_in_process_hands_over_and_falls_back(large, monkeypatch,
                                                     request):
    """The worker's packer run here: a segment that ``_receive`` maps and
    counts; with the reservation failing (a full /dev/shm), the staging
    itself, leaf for leaf, not counted, and no segment left."""
    import errno
    prefix = host_pool._prefix(os.getpid())
    monkeypatch.setattr(host_pool, "_shm_prefix", prefix)
    request.addfinalizer(host_pool._sweep)
    want = port._device_decode_inputs(large[0])
    count = host_pool.map_decode_inputs.shared_frames
    msg = host_pool._decode_inputs(large[0])
    assert isinstance(msg, host_pool._Shared) and _segments(prefix)
    _assert_same_staging(host_pool._receive(msg), want)
    assert host_pool.map_decode_inputs.shared_frames == count + 1
    assert not _segments(prefix)

    def full(fd, offset, length):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(os, "posix_fallocate", full)
    msg = host_pool._decode_inputs(large[0])
    assert not isinstance(msg, host_pool._Shared) and not _segments(prefix)
    got = host_pool._receive(msg)
    assert got is msg
    _assert_same_staging(got, want)
    assert host_pool.map_decode_inputs.shared_frames == count + 1


_NO_TRACKER = """
import gc, os, sys
from libjxl_torch.parallel import host_pool
streams = [open(p, "rb").read() for p in sys.argv[1:]]
got = host_pool.map_decode_inputs(streams, 2)
assert host_pool.map_decode_inputs.shared_frames == len(streams)
del got
gc.collect()
host_pool.shutdown()
prefix = host_pool._prefix(os.getpid())
assert not [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]
print("done")
"""


def test_no_resource_tracker_warning():
    import subprocess
    import sys
    paths = [os.path.join(REPO, "tests", "data", p) for p in (
        "torch_vardct_var/ragged_1001x1503_e5.jxl",
        "torch_vardct/ragged_1001x1503.jxl")]
    proc = subprocess.run([sys.executable, "-c", _NO_TRACKER, *paths],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "done"
    assert "resource_tracker" not in proc.stderr
    assert "leaked" not in proc.stderr
