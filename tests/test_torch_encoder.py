"""The port's lossless serving encode against the JAX package on the CPU:
codestreams byte-identical to libjxl_tpu's, and each one decoding to its
input exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from libjxl_tpu.api import encoder as ref  # noqa: E402
from libjxl_torch.api import encoder as port  # noqa: E402
from libjxl_torch.api.decoder import decode_exact  # noqa: E402

CPU = "cpu"
PREFIX = port.EncodeOptions(use_device=True, entropy="prefix-device")


def _photo(seed, h, w):
    """The photo of tests/test_baseline_configs.py (BASELINE config 5)."""
    r = np.random.default_rng(seed)
    return np.clip(
        np.cumsum(r.integers(-2, 3, (h, w, 3)), axis=1) +
        np.cumsum(r.integers(-2, 3, (h, w, 3)), axis=0), 0, 255) \
        .astype(np.uint8)


def _image(seed, h, w, c, bits=8):
    """A smooth random walk in h, w with c channels of ``bits`` bits."""
    rng = np.random.default_rng(seed)
    hi = (1 << bits) - 1
    step = max(1, hi >> 6)
    img = np.cumsum(rng.integers(-step, step + 1, (h, w, c)), axis=1)
    img += np.cumsum(rng.integers(-step, step + 1, (h, w, c)), axis=0)
    return np.clip(img + hi // 2, 0, hi).astype(
        np.uint8 if bits == 8 else np.uint16)


def test_two_pass_single_image():
    """tests/test_encoder.py::test_lossless_prefix_device_roundtrip's
    image, through encode_lossless (pass 1, host code, pass 2)."""
    rng = np.random.default_rng(9)
    img = np.clip(np.cumsum(rng.integers(-3, 4, (300, 420, 3)), axis=1),
                  0, 255).astype(np.uint8)
    got = port.encode_lossless(img, PREFIX, device=CPU)
    assert got == ref.encode_lossless(img, PREFIX)
    assert decode_exact([got], [img]) == [True]


def test_config5_batch():
    """tests/test_baseline_configs.py::test_config5_batch_lossless: 8
    images of 512x512 in one shape-group of two sub-batches."""
    imgs = [_photo(10 + i, 512, 512) for i in range(8)]
    got = port.encode_lossless_many(imgs, PREFIX, device=CPU)
    assert got == ref.encode_lossless_many(imgs, PREFIX)
    assert all(decode_exact(got, imgs))


def _sections(stream):
    from libjxl_tpu.api.container import extract_codestream
    from libjxl_tpu.api.decoder import parse_codestream
    _, frames = parse_codestream(extract_codestream(stream))
    return [bytes(s) for s in frames[0].sections]


def test_mixed_batch_codestreams():
    """Shape-groups of RGB, RGBA, gray, gray+alpha, 8 and 16 bits, with
    two same-shape images stacked into one sub-batch. 1- and 3-channel
    streams equal the JAX package's; 2- and 4-channel ones declare the
    alpha channel in their headers (the reference's device headers
    declare none) and equal the reference's sections."""
    imgs = [
        _image(61, 110, 190, 3), _image(62, 100, 150, 4),
        _image(63, 90, 300, 1)[:, :, 0], _image(64, 110, 190, 3),
        _image(65, 60, 140, 2), _image(66, 80, 130, 3, 16),
        _image(67, 70, 90, 4, 16),
    ]
    got = port.encode_lossless_many(imgs, PREFIX, device=CPU)
    want = ref.encode_lossless_many(imgs, PREFIX)
    for im, g, w in zip(imgs, got, want):
        if im.ndim == 2 or im.shape[2] == 3:
            assert g == w
        else:
            assert g != w and _sections(g) == _sections(w)
    assert all(decode_exact(got, imgs))
