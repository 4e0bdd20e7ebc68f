"""The device route of recompressed JPEGs in ``decode_many``: 4:2:0 YCbCr
frames, every block DCT8, each with its own RAW quant tables.

* ``decode_many`` on the CPU against the plain reference
  (``jxlbench/ref/jpeg_recompressed.py``) within the benchmark cell's
  limits, and against the port's host decode within 1, on small JPEGs of
  odd sizes (partial MCUs, partial groups, mirrored edges) at three
  qualities that share one chunk (each frame's tables);
* against the JAX package's decode of the same streams (its host path:
  ``color/xyb.py`` chroma_upsample and ycbcr_to_rgb) within the cell's
  limits;
* against libjpeg-turbo's decode of the source JPEG (through PIL), which
  shares no code with the port;
* the native AC decode of subsampled frames equals the Python token
  decode bit for bit;
* streams the route does not take keep the host route;
* the chroma upsampling and YCbCr kernel equals its plain version, on
  the card (skipped without one).

Only the JAX package's comparison imports JAX, inside its test: the card
test runs with
``python -m pytest --noconftest -m gpu tests/test_torch_jpeg_device.py``.
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_e7 import one_torch_thread  # noqa: E402,F401
from libjxl_torch.api import decoder as port  # noqa: E402

SHAPE = (333, 517)
QUALITIES = (75, 90, 95)
# the benchmark cell's limits (jxlbench/configs/jpeg_recompressed_420.json)
MAX_DIFF, MISMATCH = 1, 0.004


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth regions and edges with sensor noise: a small dead-leaves
    image of the benchmark's generator."""
    from jxlbench.images import dead_leaves
    return dead_leaves(seed, 0, h, w, None, "cpu").numpy()


def _jpeg(img: np.ndarray, quality: int, subsampling: int = 2,
          progressive: bool = False) -> bytes:
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality,
                              subsampling=subsampling,
                              progressive=progressive)
    return buf.getvalue()


@pytest.fixture(scope="module")
def jpegs():
    """(JPEG bytes, recompressed stream) at each quality, one image."""
    from libjxl_torch.jpeg.transcode import encode_jpeg
    img = _photo(*SHAPE, seed=17)
    out = []
    for q in QUALITIES:
        jb = _jpeg(img, q)
        out.append((jb, encode_jpeg(jb)))
    return out


@pytest.fixture(scope="module")
def device_outputs(jpegs):
    before = (port.decode_many.jpeg_frames, port.decode_many.device_frames)
    outs = port.decode_many([s for _, s in jpegs], workers=2, device="cpu")
    after = (port.decode_many.jpeg_frames, port.decode_many.device_frames)
    return outs, [a - b for a, b in zip(after, before)]


def _diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


def test_decode_many_takes_the_device_route(device_outputs):
    outs, counted = device_outputs
    assert counted == [len(QUALITIES)] * 2
    for o in outs:
        assert o.shape == SHAPE + (3,) and o.dtype == np.uint8


def test_decode_many_matches_the_reference(jpegs, device_outputs):
    from jxlbench.ref.jpeg_recompressed import decode_region, frame_info
    for (_, s), got in zip(jpegs, device_outputs[0]):
        info = frame_info(s)
        assert (info["xgroups"], info["ygroups"]) == (3, 2)
        want, box = decode_region(s, 0, 0, info["xgroups"], info["ygroups"])
        assert box == (0, SHAPE[0], 0, SHAPE[1])
        d = _diff(got, want)
        assert d.max() <= MAX_DIFF and (d > 0).mean() <= MISMATCH


def test_reference_region_matches_the_whole_frame(jpegs):
    """A region of AC groups equals the whole frame's decode inside its
    compared box (the margin covers the upsampling's reach)."""
    from jxlbench.ref.jpeg_recompressed import decode_region, frame_info
    s = jpegs[1][1]
    info = frame_info(s)
    whole, _ = decode_region(s, 0, 0, info["xgroups"], info["ygroups"])
    part, (y0, y1, x0, x1) = decode_region(s, 1, 0, 1, 1)
    assert (y0, y1, x0, x1) == (0, 254, 258, 510)
    np.testing.assert_array_equal(part[y0:y1, x0 - 256:x1 - 256],
                                  whole[y0:y1, x0:x1])


def test_decode_many_matches_the_host_decode(jpegs, device_outputs):
    for (_, s), got in zip(jpegs, device_outputs[0]):
        assert _diff(got, port.decode(s, device="cpu")).max() <= 1


@pytest.mark.parametrize("k", range(len(QUALITIES)),
                         ids=[f"q{q}" for q in QUALITIES])
def test_decode_many_matches_the_jax_package(k, jpegs, device_outputs):
    """The JAX package's decode of the same stream (the reference this
    port is held to): within the cell's limits, max 1 and a mismatch
    share of 0.004."""
    from libjxl_tpu.api.decoder import decode as jax_decode

    want = np.asarray(jax_decode(jpegs[k][1]))
    got = device_outputs[0][k]
    assert want.shape == got.shape and want.dtype == np.uint8
    d = _diff(got, want)
    assert d.max() <= MAX_DIFF and (d > 0).mean() <= MISMATCH, \
        (int(d.max()), float((d > 0).mean()))


def test_decode_many_near_libjpeg_turbo(jpegs, device_outputs):
    """libjpeg-turbo's own decode of the source JPEG (its integer IDCT
    and upsampling): within 6, and more than 1 apart in at most 5%."""
    Image = pytest.importorskip("PIL.Image")
    for (jb, _), got in zip(jpegs, device_outputs[0]):
        want = np.asarray(Image.open(io.BytesIO(jb)).convert("RGB"))
        d = _diff(got, want)
        assert d.max() <= 6 and (d > 1).mean() <= 0.05


def test_traced_decode_counts_and_marks_the_jpeg_frames(jpegs):
    """The counter counts the frames of the route, and their host spans
    (in the pool's workers) carry ``jpeg=1``."""
    from libjxl_torch.utils import prof
    prof.enable(True)
    prof.drain()
    before = port.decode_many.jpeg_frames
    try:
        port.decode_many([s for _, s in jpegs[:2]], workers=2, device="cpu")
        spans = prof.drain()
    finally:
        prof.enable(False)
    assert port.decode_many.jpeg_frames - before == 2
    for name in ("host.ac_decode", "host.stage_out"):
        got = [sp for sp in spans if sp.name == name]
        assert len(got) == 2, name
        assert all(sp.attrs["jpeg"] == 1 for sp in got), name


def _frame_decoder(stream: bytes):
    """The port's frame decoder past the AC global section of
    ``stream``, and its AC sections."""
    from libjxl_torch.api.codestream import parse_codestream
    from libjxl_torch.api.container import extract_codestream
    from libjxl_torch.core.toc import ac_group_index
    from libjxl_torch.utils.bits import BitReader
    from libjxl_torch.vardct.frame_dec import VarDCTFrameDecoder
    meta, frames = parse_codestream(extract_codestream(stream))
    fr = frames[0]
    fd = fr.dims
    dec = VarDCTFrameDecoder(fr.header, meta.m, fd)
    dec.decode_dc_global(BitReader(fr.sections[0]))
    for g in range(fd.num_dc_groups):
        dec.decode_dc_group(BitReader(fr.sections[1 + g]), g)
    dec.finalize_dc()
    dec.decode_ac_global(BitReader(fr.sections[1 + fd.num_dc_groups]))
    secs = {g: (fr.sections[ac_group_index(0, g, fd.num_groups,
                                           fd.num_dc_groups)], 0)
            for g in range(fd.num_groups)}
    return dec, secs


@pytest.mark.parametrize("subsampling", [2, 1], ids=["420", "422"])
@pytest.mark.parametrize("threads", [1, 3])
def test_native_subsampled_ac_equals_python(subsampling, threads):
    from libjxl_torch.jpeg.transcode import encode_jpeg
    from libjxl_torch.utils.bits import BitReader
    from libjxl_torch.utils.host_stage import subsampled_planes_shapes
    stream = encode_jpeg(_jpeg(_photo(291, 557, seed=3), 88, subsampling))
    dec, secs = _frame_decoder(stream)
    assert not dec.is_444 and len(secs) == 6
    specs = subsampled_planes_shapes(dec)
    planes = [np.full(shape, 7, dt) for shape, dt in specs]
    assert dec.decode_ac_frame_native(secs) is None      # no planes given
    got = dec.decode_ac_frame_native(secs, n_threads=threads, planes=planes)
    assert got is planes
    # the plain twin: the Python token decode in JPEG mode
    py, _ = _frame_decoder(stream)
    py.jpeg_mode = True
    py.jpeg_coeffs = [np.zeros(shape, np.int64) for shape, _ in specs]
    for g, (sec, _) in secs.items():
        py.decode_ac_group([BitReader(sec)], g, 1)
    for c in range(3):
        np.testing.assert_array_equal(planes[c], py.jpeg_coeffs[c])


def test_native_subsampled_ac_rejects_a_corrupt_section():
    from libjxl_torch.core.fields import FormatError
    from libjxl_torch.jpeg.transcode import encode_jpeg
    from libjxl_torch.utils.host_stage import subsampled_planes_shapes
    stream = encode_jpeg(_jpeg(_photo(300, 400, seed=4), 90))
    dec, secs = _frame_decoder(stream)
    sec, start = secs[0]
    secs[0] = (sec[:len(sec) // 2], start)
    planes = [np.empty(s, d) for s, d in subsampled_planes_shapes(dec)]
    with pytest.raises(FormatError):
        dec.decode_ac_frame_native(secs, planes=planes)


def _host_routed(kind: str) -> bytes:
    from libjxl_torch.jpeg.transcode import encode_jpeg
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
    img = _photo(96, 128, seed=5)
    if kind == "jpeg444":
        return encode_jpeg(_jpeg(img, 90, subsampling=0))
    if kind == "jpeg422":
        return encode_jpeg(_jpeg(img, 90, subsampling=1))
    if kind == "progressive":
        return encode_lossy(img, LossyOptions(distance=1.0, effort=3,
                                              progressive=True))
    assert kind == "alpha"
    rgba = np.concatenate([img, img[:, :, :1]], axis=-1)
    return encode_lossy(rgba, LossyOptions(distance=1.0, effort=3))


@pytest.mark.parametrize("kind", ["jpeg444", "jpeg422", "progressive",
                                  "alpha"])
def test_other_streams_keep_the_host_route(kind):
    data = _host_routed(kind)
    assert port._device_decode_inputs(data) is None
    before = port.decode_many.jpeg_frames, port.decode_many.device_frames
    got = port.decode_many([data], workers=2, device="cpu")[0]
    assert (port.decode_many.jpeg_frames,
            port.decode_many.device_frames) == before
    np.testing.assert_array_equal(got, port.decode(data, device="cpu"))


def test_xyb_stream_with_own_tables_keeps_the_host_route(monkeypatch):
    """An XYB frame that signals its own AC tables stays on the host: the
    per-frame tables are the JPEG route's only."""
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
    from libjxl_torch.vardct.quant_weights import DequantMatrices
    data = encode_lossy(_photo(64, 96, seed=6),
                        LossyOptions(distance=1.0, effort=3))
    assert port._device_decode_inputs(data) is not None
    decode_tables = DequantMatrices.decode

    def own_tables(self, r, mfd=None):
        decode_tables(self, r, mfd)
        self.encodings_default = False

    monkeypatch.setattr(DequantMatrices, "decode", own_tables)
    assert port._device_decode_inputs(data) is None


def test_ycbcr_plain_edges():
    """The plain version at the smallest sizes: a 1x1 chroma sample
    upsamples to itself, and odd sizes cut the last row and column."""
    from libjxl_torch.models.ycbcr_kernel import ycbcr420_to_rgb8_ref
    y = torch.full((1, 3, 3), 0.25)
    c = torch.tensor([[[0.1, -0.1], [0.0, 0.2]]])
    out = ycbcr420_to_rgb8_ref(y, c, -c, 3, 3)
    assert out.shape == (1, 3, 3, 3) and out.dtype == torch.uint8
    one = ycbcr420_to_rgb8_ref(y[:, :1, :1], c[:, :1, :1], c[:, :1, :1], 1,
                               1)
    yv = 0.25 + 128 / 255
    want = [yv + 1.402 * 0.1, yv + (-0.114 * 1.772 - 0.299 * 1.402) / 0.587
            * 0.1, yv + 1.772 * 0.1]
    assert one[0, 0, 0].tolist() == [round(v * 255) for v in want]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(3024, 4032), (333, 517), (1, 1), (2, 9)])
def test_ycbcr_kernel_matches_plain_on_card(h, w):
    from libjxl_torch.models.ycbcr_kernel import (
        ycbcr420_to_rgb8, ycbcr420_to_rgb8_ref,
    )
    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(h * 7919 + w)
    k = 3
    # the IDCT's planes: padded to 8x8 blocks (chroma to 16 pixels)
    ys, xs = -(-h // 16) * 16, -(-w // 16) * 16
    y = torch.rand((k, ys, xs), generator=gen) - 0.5
    cb = (torch.rand((k, ys // 2, xs // 2), generator=gen) - 0.5) * 0.6
    cr = (torch.rand((k, ys // 2, xs // 2), generator=gen) - 0.5) * 0.6
    y, cb, cr = (t.to(dev) for t in (y, cb, cr))
    before = ycbcr420_to_rgb8.launches
    got = ycbcr420_to_rgb8(y, cb, cr, h, w)
    torch.cuda.synchronize()
    assert ycbcr420_to_rgb8.launches == before + 1
    want = ycbcr420_to_rgb8_ref(y, cb, cr, h, w)
    assert got.shape == (k, h, w, 3)
    assert torch.equal(got, want)
