"""The port's variable-block VarDCT serving decode against the JAX package
on the CPU.

* ``_device_decode_inputs`` on an effort-5 and an effort-7 stream gives
  the reference's per-frame dict and key, field for field and class for
  class (synthetic frames of every AC strategy are in
  ``test_torch_vardct_var_classes.py``);
* ``decode_many`` on "cpu" over a mix of effort-7, effort-5, DCT8 and
  lossless streams is within +-1 per 8-bit sample of the JAX package's
  ``decode_many`` with ``config.device_filters = True`` (+-4 per 16-bit
  sample, as for DCT8 frames);
* a stream that signals its own AC tables is decoded on the host;
* the small committed var fixtures are what their maker makes.
"""
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_var_frames import dense_class  # noqa: E402
from libjxl_torch.api import decoder as port  # noqa: E402
from libjxl_tpu.api import decoder as ref  # noqa: E402
from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "torch_vardct_var")


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _photo(seed: int, h: int, w: int, bits: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([
        xx * 255 // w + rng.integers(0, 12, (h, w)),
        yy * 255 // h + rng.integers(0, 12, (h, w)),
        (xx + yy) * 255 // (h + w) + rng.integers(0, 12, (h, w)),
    ], -1).clip(0, 255)
    if bits == 16:
        return (img * 256 + rng.integers(0, 256, img.shape)).astype(
            np.uint16)
    return img.astype(np.uint8)


def _stream(seed, h, w, effort, bits=8, gab=1, epf=3, distance=1.0):
    return encode_lossy(_photo(seed, h, w, bits), LossyOptions(
        distance=distance, effort=effort, gaborish=gab, epf=epf))


@pytest.fixture
def jax_device_decode():
    """The JAX package's decode_many on its device program."""
    from libjxl_tpu.config import config
    old = config.device_filters
    config.device_filters = True
    yield ref.decode_many
    config.device_filters = old


def _assert_inputs_equal(got, want):
    assert set(got._fields) == set(want)
    for name in got._fields:
        a, b = getattr(got, name), want[name]
        if name == "classes":
            assert sorted(a) == sorted(b)
            for s in a:
                for x, y in zip(dense_class(s, a[s]), b[s], strict=True):
                    assert x.dtype == y.dtype and x.shape == y.shape, s
                    np.testing.assert_array_equal(x, y, err_msg=str(s))
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("name,classes", [
    ("graphics_256x320_e7.jxl", (0, 1, 2, 4, 5, 6, 7, 12, 13, 14, 15, 16,
                                 17)),
    ("ragged_1001x1503_e5.jxl", None)])
def test_device_decode_inputs_equal_reference(name, classes):
    data = _fixture(name)
    got, key, lf = port._device_decode_inputs(data)
    want, key_r, _ = ref._device_decode_inputs(data)
    assert key == key_r and key[7] == "var"
    assert classes is None or key[8] == classes
    assert lf.gab and lf.epf_iters == key[5]
    _assert_inputs_equal(got, want)


# ---- decode_many ---------------------------------------------------------

def test_decode_many_mixed_batch_matches_jax(jax_device_decode):
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    e7 = _fixture("graphics_256x320_e7.jxl")
    e5 = _stream(40, 96, 128, effort=5, epf=2)
    dct8 = _stream(41, 96, 128, effort=3)
    img = _photo(42, 40, 56)
    lossless = encode_lossless(img, EncodeOptions(effort=2))
    assert port._device_decode_inputs(e5)[1][7] == "var"
    assert len(port._device_decode_inputs(dct8)[1]) == 7
    batch = [e7, e5, dct8, lossless, e5]
    before = port.decode_many.device_frames
    got = port.decode_many(batch, workers=2, device="cpu")
    assert port.decode_many.device_frames - before == 4
    want = jax_device_decode(batch)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype == np.uint8 and g.shape == r.shape
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
    np.testing.assert_array_equal(got[3], img)
    np.testing.assert_array_equal(got[1], got[4])
    assert np.abs(got[0].astype(int)
                  - port.decode(e7).astype(int)).max() <= 1


def test_var_frames_of_other_classes_share_a_chunk(monkeypatch):
    """Var frames of one shape, filter setting and bit depth go to the
    device as one chunk whatever their strategy classes."""
    from libjxl_torch.models import vardct_decode
    names = ["mix512_photo_e5_d1.jxl", "mix512_photo_e7_d2.jxl",
             "mix512_graphics_e5_d2.jxl"]
    batch = [_fixture(n) for n in names]
    keys = [port._device_decode_inputs(d)[1] for d in batch]
    assert len({k[:8] for k in keys}) == 1
    assert len({k[8] for k in keys}) == 3
    chunks = []
    run = vardct_decode.decode_frames_device_var

    def recording(inputs, *a, **k):
        chunks.append(len(inputs))
        return run(inputs, *a, **k)

    monkeypatch.setattr(vardct_decode, "decode_frames_device_var",
                        recording)
    got = port.decode_many(batch, workers=2, device="cpu")
    assert chunks == [3]
    for g, data in zip(got, batch):
        assert np.abs(g.astype(int) - port.decode(data).astype(int)).max() \
            <= 1


def test_decode_many_16bit_var(jax_device_decode):
    data = _stream(50, 64, 96, effort=5, bits=16)
    assert port._device_decode_inputs(data)[1][6:8] == (16, "var")
    got = port.decode_many([data, data], workers=2, device="cpu")
    want = jax_device_decode([data, data])
    assert got[0].dtype == want[0].dtype == np.uint16
    assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 4
    assert np.abs(got[0].astype(int)
                  - port.decode(data).astype(int)).max() <= 4


def test_fetch_false_var_frame():
    from libjxl_torch.models.vardct_decode import decode_frames_device_var
    data = _stream(55, 48, 80, effort=5, epf=1)
    fr, key, lf = port._device_decode_inputs(data)
    got = decode_frames_device_var([fr], lf, key[4], key[5], key[0], key[1],
                                   device="cpu")
    t = port.decode_many([data], workers=2, device="cpu", fetch=False)[0]
    assert isinstance(t, torch.Tensor) and t.shape == (48, 80, 3)
    np.testing.assert_array_equal(t.numpy(), got[0])


# ---- streams with their own AC tables go to the host ---------------------

def test_encodings_default_follows_the_stream():
    from libjxl_torch.utils.bits import BitReader
    from libjxl_torch.vardct.quant_weights import (
        DequantMatrices, default_matrices,
    )
    m = DequantMatrices()
    m.decode(BitReader(b"\x01"))
    assert m.encodings_default
    # not all default, then every table in mode 0 (the library's)
    m.decode(BitReader(bytes(7)))
    assert not m.encodings_default
    assert m.tables is default_matrices()


@pytest.mark.parametrize("effort", [3, 5])
def test_stream_with_own_tables_decodes_on_the_host(effort, monkeypatch):
    from libjxl_torch.vardct.quant_weights import DequantMatrices
    data = _stream(60 + effort, 64, 96, effort=effort)
    assert port._device_decode_inputs(data) is not None
    decode_tables = DequantMatrices.decode

    def own_tables(self, r, mfd=None):
        decode_tables(self, r, mfd)
        self.encodings_default = False

    monkeypatch.setattr(DequantMatrices, "decode", own_tables)
    assert port._device_decode_inputs(data) is None
    # the table decode is patched in this process only: stage here
    from libjxl_torch.parallel import host_pool
    monkeypatch.setattr(host_pool, "map_decode_inputs", lambda streams, _: [
        port._device_decode_inputs(s) for s in streams])
    before = port.decode_many.device_frames
    got = port.decode_many([data], workers=2, device="cpu")[0]
    assert port.decode_many.device_frames == before
    np.testing.assert_array_equal(got, port.decode(data))


# ---- fixtures ------------------------------------------------------------

def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_var_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_var_fixture_manifest_matches_files():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    maker = _maker()
    assert set(manifest) == set(maker.SPECS)
    total = 0
    for name, m in manifest.items():
        data = _fixture(name)
        total += len(data)
        assert hashlib.sha256(data).hexdigest() == m["sha256"]
        assert m["effort"] == maker.SPECS[name][4]
    assert total <= 1_000_000


@pytest.mark.parametrize("name", ["ragged_1001x1503_e5.jxl",
                                  "mix512_photo_e5_d2.jxl"])
def test_small_var_fixtures_are_what_the_maker_makes(name):
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        m = json.load(f)[name]
    data = _maker().encode(name)
    assert data == _fixture(name)
    key = port._device_decode_inputs(data)[1]
    assert key == (m["h"], m["w"], -(-m["h"] // 8), -(-m["w"] // 8),
                   bool(m["gab"]), m["epf_iters"], m["bits"], "var",
                   tuple(m["classes"]))
