"""The port's ``decode()`` with its restoration filters on the device,
against the JAX package on the CPU.

* with ``config.device_filters = True`` the port's ``decode`` (the
  kernels' plain versions on "cpu", the frame kept on the device and its
  colour output computed there) is within +-1 per 8-bit sample of the
  JAX package's ``decode`` with its own ``device_filters = True``;
* on both sides of the 4 MP threshold (the policy monkeypatched in both
  packages, as ``tests/test_robust_decode.py`` does) the port takes the
  JAX package's side: below it the two host decodes are equal, above it
  the two device decodes are within +-1;
* banded decode (``decode_rows``) equals whole-frame decode bit for bit
  with the policy on;
* ``decode_many`` filters each frame with its own loop-filter constants
  (a stream that signals non-default ones shares no chunk with one that
  does not);
* importing the port leaves TF32 off.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import libjxl_torch.config as port_config  # noqa: E402
import libjxl_tpu.config as ref_config  # noqa: E402
from libjxl_torch.api import decoder as port  # noqa: E402
from libjxl_torch.render import filters_torch as FT  # noqa: E402
from libjxl_tpu.api import decoder as ref  # noqa: E402
from libjxl_tpu.core import frame_header as ref_fh  # noqa: E402
from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAR_FIXTURE = os.path.join(REPO, "tests", "data", "torch_vardct_var",
                           "graphics_256x320_e7.jxl")


def _photo(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([
        xx * 255 // w + rng.integers(0, 12, (h, w)),
        yy * 255 // h + rng.integers(0, 12, (h, w)),
        (xx + yy) * 255 // (h + w) + rng.integers(0, 12, (h, w)),
    ], -1).clip(0, 255).astype(np.uint8)


def _stream(seed, h, w, gab=1, epf=3) -> bytes:
    return encode_lossy(_photo(seed, h, w), LossyOptions(
        distance=1.0, effort=3, gaborish=gab, epf=epf))


def _custom(lf) -> None:
    """Non-default loop-filter constants, each exact in float16 as a
    stream carries them."""
    lf.gab_custom = True
    lf.gab_x_weight1, lf.gab_x_weight2 = 0.125, 0.0625
    lf.gab_y_weight1, lf.gab_y_weight2 = 0.09375, 0.03125
    lf.gab_b_weight1, lf.gab_b_weight2 = 0.25, 0.0
    lf.epf_sharp_custom = True
    lf.epf_sharp_lut = (0.0, 0.25, 0.375, 0.5, 0.75, 1.0, 1.5, 2.0)
    lf.epf_weight_custom = True
    lf.epf_channel_scale = (24.0, 8.0, 2.0)
    lf.epf_pass1_zeroflush, lf.epf_pass2_zeroflush = 0.5, 0.625
    lf.epf_sigma_custom = True
    lf.epf_quant_mul = 0.75
    lf.epf_pass0_sigma_scale = 0.5
    lf.epf_pass2_sigma_scale = 4.0
    lf.epf_border_sad_mul = 0.5


def _custom_stream(seed, h, w) -> bytes:
    """A stream whose frame header signals the constants of ``_custom``:
    the JAX encoder's header writer is wrapped for one encode."""
    visit = ref_fh.FrameHeader.visit

    def custom_visit(self, v, *a, **k):
        if not v.is_reading:
            _custom(self.loop_filter)
        return visit(self, v, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_fh.FrameHeader, "visit", custom_visit)
    try:
        return _stream(seed, h, w)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def streams():
    with open(VAR_FIXTURE, "rb") as f:
        var = f.read()
    return dict(dct8=_stream(1, 120, 200), var=var,
                custom=_custom_stream(2, 120, 200))


@pytest.fixture
def device_filters_on():
    old = (port_config.config.device_filters,
           ref_config.config.device_filters)
    port_config.config.device_filters = True
    ref_config.config.device_filters = True
    yield
    port_config.config.device_filters, ref_config.config.device_filters = \
        old


def _within(got, want, tol=1):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= tol


def test_custom_stream_signals_its_constants(streams):
    from libjxl_torch.api.codestream import parse_codestream
    lf = parse_codestream(streams["custom"])[1][0].header.loop_filter
    assert lf.gab_custom and lf.epf_sharp_custom and lf.epf_sigma_custom
    assert lf.epf_channel_scale == (24.0, 8.0, 2.0)
    assert lf.epf_border_sad_mul == 0.5


@pytest.mark.parametrize("name", ["dct8", "var", "custom"])
def test_device_decode_matches_jax(name, streams, device_filters_on,
                                   monkeypatch):
    """The resident path: one whole-frame restore, then the colour
    output on the device."""
    data = streams[name]
    calls = []
    restore = FT.restore

    def spy(x, *a, **k):
        calls.append(tuple(x.shape))
        return restore(x, *a, **k)

    monkeypatch.setattr(FT, "restore", spy)
    got = port.decode(data, device="cpu")
    assert calls == [(3,) + got.shape[:2]]
    _within(got, ref.decode(data))


def test_policy_matches_reference_threshold():
    old = (port_config.config.device_filters,
           ref_config.config.device_filters)
    try:
        for v in (None, True, False):
            port_config.config.device_filters = v
            ref_config.config.device_filters = v
            for n in (None, 1, (4 << 20) - 1, 4 << 20, 3840 * 2160):
                assert port_config.device_filters_enabled(n) == \
                    ref_config.device_filters_enabled(n), (v, n)
    finally:
        port_config.config.device_filters, \
            ref_config.config.device_filters = old
    assert port_config.device_filters_enabled((4 << 20) - 1) is False
    assert port_config.device_filters_enabled(4 << 20) is True


@pytest.mark.parametrize("side", ["below", "above"])
def test_decode_takes_the_reference_side_of_the_threshold(side, streams,
                                                          monkeypatch):
    on = side == "above"
    assert port_config.config.device_filters is None     # auto mode
    monkeypatch.setattr(port_config, "device_filters_enabled",
                        lambda n=None: on)
    monkeypatch.setattr(ref_config, "device_filters_enabled",
                        lambda n=None: on)
    for name in ("dct8", "var"):
        got = port.decode(streams[name], device="cpu")
        want = ref.decode(streams[name])
        if on:
            _within(got, want)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h", [700, 515])
def test_banded_decode_equals_whole_frame(h, monkeypatch):
    """515 rows: the last band has 3 rows, fewer than the 8-row halo."""
    data = _stream(3, h, 420)
    monkeypatch.setattr(port_config, "device_filters_enabled",
                        lambda n=None: True)
    windows = []
    restore = FT.restore

    def spy(x, *a, **k):
        windows.append(x.shape[1])
        return restore(x, *a, **k)

    monkeypatch.setattr(FT, "restore", spy)
    full = port.decode(data, device="cpu")
    n_whole = len(windows)
    bands = list(port.decode_rows(data, device="cpu"))
    got = np.concatenate([b for _, b in bands], axis=0)
    np.testing.assert_array_equal(got, full)
    # both ran the filters in the same band windows
    assert n_whole == len(bands) == -(-h // 256)
    assert windows[:n_whole] == windows[n_whole:]


def test_decode_many_filters_each_frame_with_its_own_constants(streams):
    """A stream with custom constants and one with the defaults, of one
    shape and filter setting, in one call: each equals its decode
    alone."""
    plain, custom = streams["dct8"], streams["custom"]
    k_plain = port._device_decode_inputs(plain)
    k_custom = port._device_decode_inputs(custom)
    assert k_plain[1] == k_custom[1]
    assert k_plain[2] != k_custom[2]
    got = port.decode_many([plain, custom, plain], workers=2, device="cpu")
    for g, data in zip(got, (plain, custom, plain)):
        alone = port.decode_many([data], workers=2, device="cpu")[0]
        np.testing.assert_array_equal(g, alone)
    # the constants matter: the custom frame under the default ones
    from libjxl_torch.models.vardct_decode import decode_frames_device
    fr, key, _ = k_custom
    other = decode_frames_device([fr], k_plain[2], key[4], key[5], key[0],
                                 key[1], device="cpu")[0]
    assert np.abs(other.astype(int) - got[1].astype(int)).max() > 1
    _within(got[1], ref.decode(custom))


def test_import_leaves_tf32_off():
    code = ("import torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "torch.backends.cudnn.allow_tf32 = True\n"
            "import libjxl_torch\n"
            "print(torch.backends.cuda.matmul.allow_tf32,"
            " torch.backends.cudnn.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False"]
