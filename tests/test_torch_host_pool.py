"""The port's process-pool host stage (``libjxl_torch/parallel/
host_pool.py``) against the in-process one, on the CPU.

The staging arrays are the same whether ``_device_decode_inputs`` runs
in-process or on a worker, ``decode_many`` (whose host stage always runs
on the pool) gives the pixels of the in-process staging, and a worker
has the CUDA card hidden and never initialises CUDA."""
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
