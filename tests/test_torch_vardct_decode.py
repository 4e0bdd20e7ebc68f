"""The port's VarDCT serving decode against the JAX package on the CPU.

* ``_device_decode_inputs`` gives the reference's ``FrameRecon``, field
  for field;
* ``decode_many`` on "cpu" (the kernels' plain versions) is within +-1
  per 8-bit sample of the JAX package's ``decode_many`` with
  ``config.device_filters = True`` (its device program, float32 like
  the port's); 16-bit output is held to +-4, because the float32
  pipeline's rounding reaches a few 16-bit steps: the JAX package's own
  device decode of ``rgb16_301x517.jxl`` differs from its host decode
  by 3;
* the port's host ``decode`` equals the JAX package's exactly;
* the committed stream fixtures are what their maker makes.
"""
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from libjxl_torch.api import decoder as port  # noqa: E402
from libjxl_tpu.api import decoder as ref  # noqa: E402
from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "torch_vardct")


def _photo(seed: int, h: int, w: int, bits: int = 8) -> np.ndarray:
    """Gradients plus noise (the image of tests/test_vardct_encoder.py's
    device decode test)."""
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


def _stream(seed, h, w, gab, epf, bits=8, distance=1.0, effort=3):
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


def test_device_decode_inputs_equal_reference():
    data = _stream(1, 120, 200, 1, 3)
    got, key, lf = port._device_decode_inputs(data)
    want, key_r, _ = ref._device_decode_inputs(data)
    assert key == key_r == (120, 200, 15, 25, True, 3, 8)
    assert lf.gab and lf.epf_iters == 3
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("h,w", [(120, 200), (264, 392)])
def test_decode_many_matches_jax_device_decode(h, w, jax_device_decode):
    streams = [_stream(10 + i, h, w, gab, epf)
               for i, (gab, epf) in enumerate([(1, 3), (1, 2), (0, 1)])]
    batch = streams + streams[:1]
    before = port.decode_many.device_frames
    got = port.decode_many(batch, workers=2, device="cpu")
    assert port.decode_many.device_frames - before == len(batch)
    want = jax_device_decode(batch)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype == np.uint8 and g.shape == (h, w, 3)
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
    np.testing.assert_array_equal(got[0], got[-1])


def test_decode_many_16bit(jax_device_decode):
    data = _stream(20, 64, 96, 1, 3, bits=16)
    got = port.decode_many([data, data], workers=2, device="cpu")
    want = jax_device_decode([data, data])
    assert got[0].dtype == want[0].dtype == np.uint16
    assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 4
    host = port.decode(data)
    assert np.abs(got[0].astype(int) - host.astype(int)).max() <= 4


def test_fetch_false_returns_the_device_tensor():
    """decode_many(fetch=False) gives the tensor that
    decode_frames_device fetches."""
    from libjxl_torch.models.vardct_decode import decode_frames_device
    data = _stream(25, 48, 80, 1, 2)
    fr, key, lf = port._device_decode_inputs(data)
    h, w, _, _, gab, epf_iters, bits = key
    got = decode_frames_device([fr, fr], lf, gab, epf_iters, h, w,
                               device="cpu")
    t = port.decode_many([data], workers=2, device="cpu", fetch=False)[0]
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
    assert len(got) == 2 and got[0].shape == (48, 80, 3)
    np.testing.assert_array_equal(t.numpy(), got[0])
    np.testing.assert_array_equal(got[0], got[1])


def test_decode_many_sends_other_streams_to_the_host():
    """A lossless (modular) stream is not the device program's shape: it
    decodes on the host, next to a device frame."""
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    img = _photo(30, 40, 56)
    lossless = encode_lossless(img, EncodeOptions(effort=2))
    lossy = _stream(31, 40, 56, 1, 1)
    before = port.decode_many.device_frames
    got = port.decode_many([lossless, lossy], workers=2, device="cpu")
    assert port.decode_many.device_frames - before == 1
    np.testing.assert_array_equal(got[0], img)
    assert np.abs(got[1].astype(int)
                  - port.decode(lossy).astype(int)).max() <= 1
    assert port.decode_many([], workers=2, device="cpu") == []


def test_host_decode_equals_jax_decode():
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    img = _photo(50, 70, 90)
    lossless = encode_lossless(img, EncodeOptions(effort=3))
    lossy = _stream(51, 70, 90, 1, 3)
    for data in (lossless, lossy):
        np.testing.assert_array_equal(port.decode(data), ref.decode(data))
    np.testing.assert_array_equal(port.decode(lossless), img)


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_manifest_matches_files():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == set(_maker().SPECS)
    total = 0
    for name, m in manifest.items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        total += len(data)
        assert hashlib.sha256(data).hexdigest() == m["sha256"]
        _, key, _ = port._device_decode_inputs(data)
        assert key == (m["h"], m["w"], -(-m["h"] // 8), -(-m["w"] // 8),
                       bool(m["gab"]), m["epf_iters"], m["bits"])
    assert total <= 1_500_000


@pytest.mark.parametrize("name", ["ragged_1001x1503.jxl",
                                  "rgb16_301x517.jxl"])
def test_small_fixtures_are_what_the_maker_makes(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        assert _maker().encode(name) == f.read()
