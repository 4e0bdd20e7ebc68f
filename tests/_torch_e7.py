"""Shared pieces of the port's effort 5-7 encode tests: the test image of
``tests/test_vardct_encoder.py``, the fallback gate that a stream which
is not byte-equal to the JAX package's must meet, and a fixture that
runs a module's torch work on one thread. Imports no JAX, so the card
tests use it too."""
import numpy as np
import pytest


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """``tests/test_vardct_encoder._img``: gradients plus uniform noise in
    [0, 20), from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3 + yy) % 256, (yy * 2) % 256, (xx + yy) % 256],
                   -1).astype(int)
    img += rng.integers(0, 20, img.shape)
    return img.clip(0, 255).astype(np.uint8)


def acs_of(data: bytes) -> tuple:
    """The (strategy, anchor) maps the stream's frame codes."""
    from libjxl_torch.api.decoder import _decode_prefilter
    _, dec, _ = _decode_prefilter(data)
    return np.array(dec.acs_raw), np.array(dec.acs_anchor)


def distance(img: np.ndarray, data: bytes, device="cpu") -> float:
    """The port's butteraugli distance of the stream's host decode."""
    from libjxl_torch.api.decoder import decode
    from libjxl_torch.metrics.butteraugli import butteraugli_distance_srgb
    return butteraugli_distance_srgb(img, decode(data)[:, :, :3],
                                     device=device)


def equal_or_gate(img: np.ndarray, got: bytes, want: bytes) -> str:
    """"equal" when ``got`` is ``want`` byte for byte; else asserts the
    fallback gate (the same ACS map, the size within 1%, the port's
    butteraugli distance of the decoded image within 0.05 of
    ``want``'s) and returns "gate"."""
    if got == want:
        return "equal"
    for a, b in zip(acs_of(got), acs_of(want)):
        np.testing.assert_array_equal(a, b)
    assert abs(len(got) / len(want) - 1.0) <= 0.01, (len(got), len(want))
    dg, dw = distance(img, got), distance(img, want)
    assert abs(dg - dw) <= 0.05, (dg, dw)
    return "gate"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the module's torch work on one thread: pytest-xdist runs one
    test process per core, and torch's thread pool in each of them would
    otherwise spin against the others'. Restores the count afterwards."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
