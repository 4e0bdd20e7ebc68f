"""The port's remaining public entry points against the JAX package's on
the CPU, on images made from a numpy seed:

* ``params.compress`` gives the JAX package's bytes for lossless (host,
  and ``use_device=True``, the pack kernel's path) and lossy (host and
  device) parameters;
* ``api.encoder_api.Encoder`` gives its bytes for pixel frames (lossless
  with a box, lossy, an animation) and a JPEG frame;
* ``api.events.StreamingDecoder`` fed in chunks emits the same events
  with equal payloads and frames, and ``flush()`` of a partial stream
  gives the same image;
* the host I/O and metadata modules (``extras.io``, ``extras.exr``,
  ``extras.gain_map``, ``extras.color_description``,
  ``color.compressed_icc``, ``utils.brotli``) write and read the same
  bytes and values;
* ``graft_entry.entry()`` computes what ``__graft_entry__.entry()``
  computes under JAX: ``payload`` and ``wide`` equal, ``q_ac`` and
  ``q_dc`` equal but for values whose float64 lies within 1e-3 (or one
  float32 spacing) of a .5 boundary, counted and printed.
"""
import enum
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_e7 import one_torch_thread, photo  # noqa: E402,F401
from libjxl_torch.config import config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = photo(96, 128, 5)
BOUNDARY_TOL = 1e-3      # chip_smoke.py's E7_TOL["boundary"]


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _pair(mod: str):
    """The port's and the JAX package's module ``mod``."""
    return (importlib.import_module(f"libjxl_torch.{mod}"),
            importlib.import_module(f"libjxl_tpu.{mod}"))


PARAMS = [dict(distance=0.0), dict(distance=0.0, effort=2),
          dict(distance=0.0, use_device=True),
          dict(distance=1.0, effort=3), dict(distance=2.0, effort=5),
          dict(distance=1.0, effort=3, use_device=True)]


@pytest.mark.parametrize("kw", PARAMS,
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_compress_matches_reference(kw):
    port, ref = _pair("params")
    got = port.compress(IMG, port.CompressParams(**kw))
    assert got == ref.compress(IMG, ref.CompressParams(**kw))
    if kw["distance"] == 0.0:
        from libjxl_torch.api.decoder import decode
        assert np.array_equal(decode(got, device="cpu"), IMG)


def test_compress_device_options():
    """``use_device=True`` resolves to the pack kernel's entropy path for
    lossless and to the device program for lossy."""
    port, _ = _pair("params")
    p = port.CompressParams(distance=0.0, use_device=True)
    assert p.to_encode_options().entropy == "prefix-device"
    assert port.CompressParams(distance=1.0, use_device=True) \
        .to_lossy_options().use_device


def _encoders(kind: str, mod):
    """An Encoder of ``mod`` (an encoder_api module) filled for ``kind``."""
    e = mod.Encoder(have_animation=kind == "animation")
    if kind == "lossless":
        e.add_frame(IMG)
        e.add_box("Exif", b"\x00\x00\x00\x00MM\x00*")
    elif kind == "lossy":
        e.add_frame(IMG, mod.FrameSettings(lossless=False, distance=1.0))
    elif kind == "animation":
        for i in range(3):
            f = IMG.copy()
            f[:, 10 * i:10 * i + 10] = 0
            e.add_frame(f, mod.FrameSettings(duration=2, effort=2))
    else:
        e.add_jpeg_frame(_jpeg())
    return e


def _jpeg() -> bytes:
    pytest.importorskip("PIL")
    from test_jpeg import _jpeg_bytes
    return _jpeg_bytes(shape=(64, 80), quality=90)


@pytest.mark.parametrize("kind", ["lossless", "lossy", "animation", "jpeg"])
def test_encoder_api_matches_reference(kind):
    port, ref = _pair("api.encoder_api")
    got = _encoders(kind, port).output()
    assert got == _encoders(kind, ref).output()
    if kind == "jpeg":
        from libjxl_torch.jpeg.transcode import decode_to_jpeg
        assert decode_to_jpeg(got) == _jpeg()


def _norm(p):
    """An event payload in a form that compares across the packages."""
    if isinstance(p, np.ndarray):
        return ("array", p.dtype.str, p.shape, p.tobytes())
    if isinstance(p, enum.Enum):
        return (type(p).__name__, p.name, p.value)
    if isinstance(p, (list, tuple)):
        return tuple(_norm(x) for x in p)
    if isinstance(p, dict):
        return {k: _norm(v) for k, v in p.items()}
    if hasattr(p, "__dict__"):
        return (type(p).__name__, _norm(vars(p)))
    return p


def _events(mod, data: bytes, chunk: int) -> list:
    dec = mod.StreamingDecoder()
    seen = []
    for i in range(0, len(data), chunk):
        dec.feed(data[i:i + chunk])
        seen += [(_norm(e), _norm(p)) for e, p in dec.process()]
    return seen


@pytest.fixture(scope="module")
def event_streams():
    from libjxl_tpu.api.container import wrap_container
    from libjxl_tpu.api.encoder import EncodeOptions, encode_lossless
    from libjxl_tpu.api.encoder_api import Encoder, FrameSettings
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
    lossless = encode_lossless(IMG, EncodeOptions(effort=2))
    anim = Encoder(have_animation=True)
    for i in range(3):
        anim.add_frame(np.roll(IMG, 7 * i, axis=1),
                       FrameSettings(duration=1, effort=2))
    return dict(
        lossless=lossless,
        lossy=encode_lossy(IMG, LossyOptions(distance=1.0, effort=3)),
        animation=anim.output(),
        boxed=wrap_container(lossless, extra_boxes=[
            (b"Exif", b"\x00\x00\x00\x00MM\x00*")]))


@pytest.mark.parametrize("kind", ["lossless", "lossy", "animation", "boxed"])
def test_streaming_decoder_matches_reference(event_streams, kind):
    port, ref = _pair("api.events")
    data = event_streams[kind]
    got = _events(port, data, 97)
    assert got == _events(ref, data, 97)
    names = [e[1] for e, _ in got]
    assert names[-1] == "SUCCESS" and "FULL_IMAGE" in names


def test_streaming_decoder_flush_matches_reference():
    """A two-group lossy stream cut in its last AC group renders."""
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
    port, ref = _pair("api.events")
    img = photo(120, 300, 6)
    data = encode_lossy(img, LossyOptions(distance=1.0, effort=3))
    out = []
    for mod in (port, ref):
        dec = mod.StreamingDecoder()
        dec.feed(data[:len(data) * 9 // 10])
        dec.process()
        out.append(dec.flush())
    assert out[0] is not None and out[0].shape[:2] == img.shape[:2]
    assert np.array_equal(out[0], out[1])


@pytest.mark.parametrize("ext", [".ppm", ".pgm", ".pam", ".pfm", ".pgx",
                                 ".exr", ".npy", ".png"])
def test_image_io_matches_reference(tmp_path, ext):
    port, ref = _pair("extras.io")
    if ext == ".png":
        pytest.importorskip("PIL")
    img = IMG
    if ext == ".pgm":
        img = IMG[:, :, 1]
    elif ext == ".pam":
        img = np.concatenate([IMG, IMG[:, :, :1]], axis=2)
    elif ext == ".pfm":
        img = IMG.astype(np.float32) / 255
    elif ext == ".pgx":
        img = IMG[:, :, 0]
    paths = [str(tmp_path / f"{who}{ext}") for who in ("port", "ref")]
    port.save_image(paths[0], img)
    ref.save_image(paths[1], img)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    if ext != ".npy":
        got, want = port.load_image(paths[0]), ref.load_image(paths[0])
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_load_image_without_pil_raises(tmp_path, monkeypatch):
    """Where PIL is missing (the card machine), a PNG is refused with the
    reference's ValueError; PNM still loads."""
    pytest.importorskip("PIL")
    port, _ = _pair("extras.io")
    png, ppm = str(tmp_path / "a.png"), str(tmp_path / "a.ppm")
    port.save_image(png, IMG)
    port.save_image(ppm, IMG)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="PIL unavailable"):
        port.load_image(png)
    assert np.array_equal(port.load_image(ppm), IMG)


def test_load_image_decodes_jxl_on_the_device(tmp_path):
    """A .jxl input decodes through the port's decode() on
    config.device."""
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    port, _ = _pair("extras.io")
    path = tmp_path / "a.jxl"
    path.write_bytes(encode_lossless(IMG, EncodeOptions(effort=2)))
    assert np.array_equal(port.load_image(str(path)), IMG)


def test_streaming_input_matches_reference(tmp_path):
    port, ref = _pair("extras.io")
    path = str(tmp_path / "a.ppm")
    port.save_image(path, IMG)
    assert np.array_equal(port.open_image_chunked(path)[10:20],
                          ref.open_image_chunked(path)[10:20])


@pytest.mark.parametrize("pixel_type", ["half", "float"])
def test_exr_matches_reference(pixel_type):
    port, ref = _pair("extras.exr")
    img = (np.random.default_rng(0).random((37, 53, 3)) * 4).astype(
        np.float32)
    data = port.write_exr(img, pixel_type=pixel_type)
    assert data == ref.write_exr(img, pixel_type=pixel_type)
    assert np.array_equal(port.read_exr(data), ref.read_exr(data))


def test_gain_map_matches_reference():
    port, ref = _pair("extras.gain_map")
    blobs = []
    for mod, hdr in ((port, "libjxl_torch"), (ref, "libjxl_tpu")):
        ce = importlib.import_module(f"{hdr}.core.headers").ColorEncoding
        b = mod.GainMapBundle(jhgm_version=0,
                              gain_map_metadata=b"iso21496-metadata",
                              color_encoding=ce.srgb(gray=False),
                              alt_icc=b"", gain_map=b"\xff\x0a payload")
        blobs.append(mod.write_gain_map_bundle(b))
        assert mod.gain_map_bundle_size(b) == len(blobs[-1])
    assert blobs[0] == blobs[1]
    back = port.read_gain_map_bundle(blobs[0])
    assert back.gain_map == b"\xff\x0a payload"


def test_compressed_icc_and_brotli_match_reference():
    port, ref = _pair("color.compressed_icc")
    icc = (b"\x00\x00\x02\x00lcms\x040\x00\x00mntrRGB XYZ "
           + bytes(range(256)) * 3)
    comp = port.icc_profile_encode(icc)
    assert comp == ref.icc_profile_encode(icc)
    assert port.icc_profile_decode(comp) == icc
    b_port, b_ref = _pair("utils.brotli")
    assert b_port.available() == b_ref.available()
    if b_port.available():
        data = bytes(range(256)) * 20
        packed = b_port.compress(data, quality=9)
        assert packed == b_ref.compress(data, quality=9)
        assert b_port.decompress(packed) == data


@pytest.mark.parametrize("desc", ["RGB_D65_202_Rel_PeQ", "Gra_D65_Rel_SRG",
                                  "RGB_D65_SRG_Rel_g0.454550",
                                  "RGB_D65_SRG_Rel_Lin"])
def test_color_description_matches_reference(desc):
    port, ref = _pair("extras.color_description")
    got, want = (m.parse_color_description(desc) for m in (port, ref))
    assert _norm(got) == _norm(want)


def test_graft_entry_matches_reference():
    """The port's graft entry on the CPU against ``__graft_entry__`` run
    under JAX: the lossless outputs equal; a quantized value may differ by
    1 only where its float64 value lies on a .5 boundary (float32 on both
    sides: the port's cube root is correctly rounded, JAX's is not)."""
    from libjxl_torch.graft_entry import entry
    from libjxl_torch.vardct.dct import dct_matrix
    from libjxl_torch.vardct.quant_weights import DequantMatrices
    sys.path.insert(0, REPO)
    try:
        graft = importlib.import_module("__graft_entry__")
    finally:
        sys.path.remove(REPO)
    fn_ref, args_ref = graft.entry()
    want = [np.asarray(x) for x in
            jax.jit(fn_ref, static_argnums=(1, 2))(*args_ref)]
    fn, args = entry(device="cpu")
    assert args[1:] == args_ref[1:]
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(args_ref[0]))
    got = [x.numpy() for x in fn(*args)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(got[2], want[2])      # payload
    np.testing.assert_array_equal(got[3], want[3])      # wide

    # the float64 values before rounding
    rgb = args[0].numpy().astype(np.float64) / 255.0
    lin = np.where(rgb <= 0.04045, rgb / 12.92,
                   ((rgb + 0.055) / 1.055) ** 2.4)
    opsin = np.array([[0.30, 1.0 - 0.078 - 0.30, 0.078],
                      [0.23, 1.0 - 0.078 - 0.23, 0.078],
                      [0.24342268924547819, 0.20476744424496821,
                       1.0 - 0.24342268924547819 - 0.20476744424496821]])
    bias = 0.0037930732552754493
    g = np.cbrt(np.einsum("ij,gjhw->gihw", opsin, lin) + bias) \
        - np.cbrt(bias)
    y = 0.5 * (g[:, 0] + g[:, 1])
    xyb = np.stack([0.5 * (g[:, 0] - g[:, 1]), y, g[:, 2] - y], 1)
    blocks = xyb.reshape(4, 3, 32, 8, 32, 8).transpose(0, 1, 2, 4, 3, 5)
    m8 = dct_matrix(8)
    stored = (m8 @ blocks @ m8.T).swapaxes(-1, -2)    # (4, 3, 32, 32, 8, 8)
    step = (DequantMatrices().tables[0].reshape(3, 64) / 64.0).astype(
        np.float32).astype(np.float64)
    ac64 = stored.reshape(4, 3, 1024, 64) / step[None, :, None, :]
    dc64 = stored[..., 0, 0] * np.array([512.0, 2048.0, 1024.0])[
        None, :, None, None]
    for name, g, w, v in (("q_ac", got[0], want[0], ac64),
                          ("q_dc", got[1], want[1], dc64)):
        off = g != w
        a = np.abs(v[off])
        dist = np.abs(a - np.floor(a) - 0.5)
        tol = np.maximum(BOUNDARY_TOL, np.spacing(a.astype(np.float32)))
        print(f"graft entry {name}: {int(off.sum())} of {g.size} values "
              f"differ from the JAX package's, each within "
              f"{float(dist.max(initial=0.0))!r} of a .5 boundary")
        assert np.abs(g[off].astype(int) - w[off].astype(int)).max(
            initial=0) <= 1
        assert (dist <= tol).all(), (name, a[dist > tol][:5])
        assert off.sum() <= 1e-3 * g.size
