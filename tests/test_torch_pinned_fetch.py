"""The fetch of decoded frames (``models/vardct_decode.fetch_frames``):
each frame of a chunk on a CUDA device is copied into a page-locked
block of its own from torch's host cache and handed out as a numpy view
of it.

* On the CPU a chunk comes back as it always did (views of the tensor's
  own array, uint8 or uint16), and the pinned counters stay where they
  were; a chunk whose blocks cannot be pinned comes back pageable.
* On the card (skipped without one): for DCT8, variable-block,
  recompressed-JPEG and 16-bit chunks the fetched frames equal
  ``.cpu().numpy()`` bit for bit, each in page-locked memory; frames
  kept from one call are untouched by the next two of the same shapes;
  the counters count the frames.

Imports no JAX, so the card tests run with
``python -m pytest --noconftest -m gpu tests/test_torch_pinned_fetch.py``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_e7 import one_torch_thread  # noqa: E402,F401
from libjxl_torch.api import decoder as port  # noqa: E402
from libjxl_torch.models import vardct_decode as vd  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
COUNTERS = ("pinned_frames", "pinned_new_blocks")


def _stream(name: str) -> bytes:
    sub = "torch_vardct_var" if "_e5" in name or "_e7" in name else \
        "torch_vardct"
    with open(os.path.join(DATA, sub, name), "rb") as f:
        return f.read()


def _counters() -> tuple:
    return tuple(getattr(port.decode_many, c) for c in COUNTERS)


def _pageable(t: torch.Tensor) -> np.ndarray:
    """The fetch as it was: one pageable array, 16-bit viewed as such."""
    arr = t.cpu().numpy()
    return arr.view(np.uint16) if t.dtype == torch.int16 else arr


def _chunk(dtype, k=3, h=5, w=7) -> torch.Tensor:
    gen = torch.Generator().manual_seed(k * h * w)
    return torch.randint(-2**15, 2**15, (k, h, w, 3), generator=gen,
                         dtype=torch.int32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16])
def test_cpu_chunk_comes_back_as_before(dtype):
    a, b = _chunk(dtype), _chunk(dtype, k=2, h=4, w=9)
    got = vd.fetch_frames([a, b])
    assert (got.pinned, got.new_blocks) == (0, 0)
    for t, frames in zip((a, b), got.frames, strict=True):
        want = _pageable(t)
        assert len(frames) == len(t)
        for k, f in enumerate(frames):
            assert f.dtype == (np.uint16 if dtype == torch.int16
                               else np.uint8)
            np.testing.assert_array_equal(f, want[k])
            # a view of the tensor's own memory, as .cpu().numpy() gives
            assert np.shares_memory(f, want)


class _CardLike(torch.Tensor):
    """A CPU tensor that says it is on a CUDA device."""

    @property
    def is_cuda(self):
        return True


def test_a_block_that_cannot_be_pinned_falls_back(monkeypatch):
    empty = torch.empty

    def no_pinning(*args, pin_memory=False, **kw):
        if pin_memory:
            raise RuntimeError("no page-locked memory")
        return empty(*args, **kw)

    monkeypatch.setattr(torch, "empty", no_pinning)
    monkeypatch.setattr(torch.cuda, "host_memory_stats",
                        lambda: {"num_host_alloc": 0})
    t = _chunk(torch.uint8)
    got = vd.fetch_frames([t.as_subclass(_CardLike)])
    assert (got.pinned, got.new_blocks) == (0, 0)
    for k, f in enumerate(got.frames[0]):
        np.testing.assert_array_equal(f, t[k].numpy())


def test_decode_many_on_cpu_leaves_the_pinned_counters(one_torch_thread):
    """A 16-bit DCT8 stream and an 8-bit variable-block one: two chunks
    of one fetch."""
    streams = [_stream("rgb16_301x517.jxl"),
               _stream("graphics_256x320_e7.jxl")]
    before, frames0 = _counters(), port.decode_many.device_frames
    got = port.decode_many(streams, workers=1, device="cpu")
    assert port.decode_many.device_frames == frames0 + 2
    assert _counters() == before
    want = port.decode_many(streams, workers=1, device="cpu", fetch=False)
    assert [g.dtype for g in got] == [np.uint16, np.uint8]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, _pageable(w))


# --- on the card -------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.init()       # the host cache's stats are empty before it
    return torch.device("cuda")


def _jpeg_streams(n: int, h: int = 333, w: int = 517) -> list:
    """Recompressed 4:2:0 JPEGs of ``n`` images of one size."""
    from jxlbench.corpus.jpeg_writer import baseline_jpeg
    from jxlbench.images import dead_leaves
    from libjxl_torch.jpeg.transcode import encode_jpeg
    return [encode_jpeg(baseline_jpeg(dead_leaves(5, i, h, w).numpy(),
                                      80 + 5 * i)) for i in range(n)]


KINDS = {
    "dct8": lambda: [_stream("ragged_1001x1503.jxl")] * 2,
    "var": lambda: [_stream("mix512_photo_e7_d1.jxl"),
                    _stream("mix512_graphics_e7_d1.jxl")],
    "jpeg420": lambda: _jpeg_streams(2),
    "16bit": lambda: [_stream("rgb16_301x517.jxl")] * 2,
}


def _pinned(a: np.ndarray) -> bool:
    return torch.from_numpy(a.view(np.uint8)).is_pinned()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pinned_fetch_equals_pageable_on_card(kind):
    dev = _card()
    streams = KINDS[kind]()
    frames0 = port.decode_many.device_frames
    allocs0 = torch.cuda.host_memory_stats()["num_host_alloc"]
    pinned0, new0 = _counters()
    got = port.decode_many(streams, workers=2, device=dev)
    assert port.decode_many.device_frames == frames0 + len(streams)
    pinned, new = _counters()
    assert pinned == pinned0 + len(streams)
    assert new - new0 == \
        torch.cuda.host_memory_stats()["num_host_alloc"] - allocs0
    assert 0 <= new - new0 <= len(streams)
    want = port.decode_many(streams, workers=2, device=dev, fetch=False)
    for g, w in zip(got, want, strict=True):
        w = _pageable(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        assert _pinned(g)
    # the device programs' own fetch
    prepped = [port._device_decode_inputs(s) for s in streams]
    _, key, lf = prepped[0]
    h, w, _, _, gab, epf_iters, bits = key[:7]
    fn = {("var",): vd.decode_frames_device_var,
          ("jpeg420",): vd.decode_frames_device_jpeg}.get(
              key[7:8], vd.decode_frames_device)
    assert (fn is vd.decode_frames_device) == (kind in ("dct8", "16bit"))
    args = ([p[0] for p in prepped], lf, gab, epf_iters, h, w)
    kw = dict(maxval=(1 << bits) - 1, device=dev)
    direct = fn(*args, **kw)
    chunk = fn(*args, **kw, fetch=False)
    for g, w in zip(direct, _pageable(chunk), strict=True):
        np.testing.assert_array_equal(g, w)
        assert _pinned(g)


@pytest.mark.gpu
def test_kept_frames_survive_later_calls_on_card():
    dev = _card()
    a, b = KINDS["var"]()
    kept = port.decode_many([a, a], workers=2, device=dev)
    copies = [k.copy() for k in kept]
    later = [port.decode_many([b, b], workers=2, device=dev)
             for _ in range(2)]
    assert not np.array_equal(copies[0], later[-1][0])
    for k, c in zip(kept, copies):
        np.testing.assert_array_equal(k, c)
        assert not any(np.shares_memory(k, f) for call in later
                       for f in call)
    # frames of one call do not share a block either
    assert not np.shares_memory(kept[0], kept[1])


@pytest.mark.gpu
def test_unpinnable_blocks_come_back_pageable_on_card(monkeypatch):
    dev = _card()
    streams = KINDS["var"]()
    want = port.decode_many(streams, workers=2, device=dev)
    empty = torch.empty

    def no_pinning(*args, pin_memory=False, **kw):
        if pin_memory:
            raise RuntimeError("no page-locked memory")
        return empty(*args, **kw)

    monkeypatch.setattr(torch, "empty", no_pinning)
    before = _counters()
    got = port.decode_many(streams, workers=2, device=dev)
    assert _counters() == before
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
        assert not _pinned(g)
