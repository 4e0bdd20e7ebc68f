"""libjxl_torch.ops.modular_ops against libjxl_tpu.ops.modular_ops on the
CPU: the same numpy-seeded inputs through both, integer outputs equal
with no tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libjxl_torch.ops import modular_ops as P  # noqa: E402
from libjxl_tpu.ops import modular_ops as R  # noqa: E402

CHANNELS = [1, 3, 4]
BITS = [8, 16]


def _pixels(seed, shape, bits):
    rng = np.random.default_rng(seed)
    hi = (1 << bits) - 1
    # a smooth ramp plus noise, with some saturated runs at both ends
    ramp = np.cumsum(rng.integers(-(hi >> 5) - 1, (hi >> 5) + 2, shape),
                     axis=-1)
    return np.clip(ramp + hi // 2, 0, hi).astype(np.int32)


def _eq(jax_out, torch_out):
    a = np.asarray(jax_out).astype(np.int64)
    b = torch_out.numpy().astype(np.int64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits", BITS)
def test_ycocg_forward_inverse(bits):
    x = _pixels(1 + bits, (2, 3, 17, 29), bits)
    fwd = P.fwd_ycocg(torch.from_numpy(x))
    _eq(R.fwd_ycocg(jnp.asarray(x)), fwd)
    _eq(R.inv_ycocg(R.fwd_ycocg(jnp.asarray(x))), P.inv_ycocg(fwd))
    np.testing.assert_array_equal(P.inv_ycocg(fwd).numpy(), x)


@pytest.mark.parametrize("bits", BITS)
def test_clamped_gradient(bits):
    rng = np.random.default_rng(bits)
    n, w, l = (rng.integers(-(1 << bits), 1 << bits, (5, 64))
               .astype(np.int32) for _ in range(3))
    _eq(R.clamped_gradient(jnp.asarray(n), jnp.asarray(w), jnp.asarray(l)),
        P.clamped_gradient(torch.from_numpy(n), torch.from_numpy(w),
                           torch.from_numpy(l)))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("c", CHANNELS)
def test_gradient_residuals_and_pack_signed(c, bits):
    x = _pixels(10 * c + bits, (3, c, 19, 23), bits)
    res = P.gradient_residuals(torch.from_numpy(x))
    _eq(R.gradient_residuals(jnp.asarray(x)), res)
    _eq(R.pack_signed(R.gradient_residuals(jnp.asarray(x))),
        P.pack_signed(res))
    # 2-D planes take the same edge rules
    _eq(R.gradient_residuals(jnp.asarray(x[0, 0])),
        P.gradient_residuals(torch.from_numpy(x[0, 0])))


def test_floor_log2_full_uint32_range():
    rng = np.random.default_rng(3)
    v = np.concatenate([
        np.array([0, 1, 2, 3, 15, 16, 17, (1 << 19) - 1, 1 << 19,
                  (1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.uint64),
        (np.uint64(1) << rng.integers(0, 32, 500).astype(np.uint64))
        + rng.integers(0, 1 << 20, 500).astype(np.uint64),
    ]).astype(np.uint32)
    _eq(R.floor_log2(jnp.asarray(v)),
        P.floor_log2(torch.from_numpy(v.astype(np.int64))))


@pytest.mark.parametrize("bits", BITS)
def test_hybrid_uint_tokenize(bits):
    rng = np.random.default_rng(bits)
    hi = (1 << 12) if bits == 8 else (1 << 19) - 1
    v = np.minimum(rng.geometric(0.002 if bits == 16 else 0.05, 4000) - 1,
                   hi).astype(np.uint32)
    v[:3] = [0, 15, hi]
    got = P.hybrid_uint_tokenize(torch.from_numpy(v.astype(np.int64)))
    for a, b in zip(R.hybrid_uint_tokenize(jnp.asarray(v)), got):
        _eq(a, b)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("c", CHANNELS)
def test_token_histogram(c, bits):
    x = _pixels(20 * c + bits, (2, c, 32, 32), bits)
    packed = R.pack_signed(R.gradient_residuals(jnp.asarray(x)))
    tok = np.array(R.hybrid_uint_tokenize(packed)[0])
    mask = np.random.default_rng(c).random((2, 1, 32, 32)) < 0.7
    # the reference takes the mask at the tokens' shape; the port
    # broadcasts it
    _eq(R.token_histogram(jnp.asarray(tok),
                          jnp.asarray(np.broadcast_to(mask, tok.shape))),
        P.token_histogram(torch.from_numpy(tok), torch.from_numpy(mask)))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("c", CHANNELS)
def test_image_to_groups_roundtrip(c, bits):
    img = _pixels(30 * c + bits, (c, 45, 70), bits)
    groups, mask = P.image_to_groups(torch.from_numpy(img), 32)
    g_ref, m_ref = R.image_to_groups(jnp.asarray(img), 32)
    _eq(g_ref, groups)
    _eq(m_ref, mask)
    _eq(R.groups_to_image(g_ref, 45, 70, 32),
        P.groups_to_image(groups, 45, 70, 32))
    np.testing.assert_array_equal(
        P.groups_to_image(groups, 45, 70, 32).numpy(), img)
