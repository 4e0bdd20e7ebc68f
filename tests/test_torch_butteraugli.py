"""The port's butteraugli (``libjxl_torch/metrics/butteraugli.py``) against
the JAX package's on the CPU, the same float32 inputs on both sides:

* the diffmap within 1e-4 x its max of JAX's, at a size with the 2x
  sub-resolution level (64x96) and an odd size without it (13x21);
* ``butteraugli_distance`` and ``butteraugli_distance_srgb`` within 1e-4
  relative; ``compute_distance_p`` equal on equal input;
* the division trap the port avoids: torch computes a Python number
  over a tensor as the tensor's reciprocal times the number, which is
  not the float32 quotient; ``rdiv`` and ``tdiv`` are.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_e7 import one_torch_thread  # noqa: E402,F401
from libjxl_torch.metrics import butteraugli as port  # noqa: E402
from libjxl_tpu.metrics import butteraugli as ref  # noqa: E402


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.03, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("h,w", [(64, 96), (13, 21)])
@pytest.mark.parametrize("hf_asymmetry", [1.0, 0.8])
def test_diffmap_matches_jax(h, w, hf_asymmetry):
    a, b = _pair(h, w, h * w)
    want = np.asarray(ref.butteraugli_diffmap(a, b,
                                              hf_asymmetry=hf_asymmetry))
    got = port.butteraugli_diffmap(a, b, hf_asymmetry=hf_asymmetry,
                                   device="cpu")
    assert got.dtype == torch.float32 and got.shape == (h, w)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * want.max()


@pytest.mark.parametrize("h,w", [(64, 96), (13, 21)])
def test_distance_matches_jax(h, w):
    a, b = _pair(h, w, 7)
    want = ref.butteraugli_distance(a, b)
    got = port.butteraugli_distance(a, b, device="cpu")
    assert abs(got - want) <= 1e-4 * want
    # tensor inputs stay on their own device
    assert port.butteraugli_distance(torch.from_numpy(a),
                                     torch.from_numpy(b)) == got


def test_distance_srgb_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (48, 72, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-6, 7, a.shape), 0,
                255).astype(np.uint8)
    want = ref.butteraugli_distance_srgb(a, b)
    got = port.butteraugli_distance_srgb(a, b, device="cpu")
    assert abs(got - want) <= 1e-4 * want


def test_compute_distance_p_equal():
    dm = np.random.default_rng(4).random((37, 53)).astype(np.float32)
    assert port.compute_distance_p(dm) == ref.compute_distance_p(dm)
    assert port.compute_distance_p(torch.from_numpy(dm), 6.0) == \
        ref.compute_distance_p(dm, 6.0)


def test_number_over_tensor_is_not_a_true_division():
    t = torch.from_numpy(np.random.default_rng(6).uniform(
        0.1, 10.0, 1_000_000).astype(np.float32))
    want = np.float32(0.7) / t.numpy()
    assert ((0.7 / t).numpy() != want).sum() > 1000   # the trap
    np.testing.assert_array_equal(port.rdiv(0.7, t).numpy(), want)
    np.testing.assert_array_equal(port.tdiv(t, 0.7).numpy(),
                                  t.numpy() / np.float32(0.7))
