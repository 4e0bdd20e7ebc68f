"""The port's pack kernel wrapper and plain version against the JAX
package: ``pack_chunks_ref`` equals the Pallas kernel (interpret mode on
the CPU) and the portable XLA packer, bit for bit. The CUDA kernel itself
is held against ``pack_chunks_ref`` on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libjxl_torch.models import pack_kernel as PK  # noqa: E402
from libjxl_torch.models.lossless import (  # noqa: E402
    prefix_state_to_device, random_prefix_state,
)


def _random_code(rng):
    """(code_bits, code_len, kernel LUT) of a random prefix code."""
    cst = random_prefix_state(rng)
    return (cst["lut_bits"], cst["lut_len"],
            prefix_state_to_device(cst, "cpu"))


def _chunks(bits, cn, seed):
    """(cn*T,) residuals + validity with the border patterns real images
    have: a valid prefix, a fully invalid chunk, an all-zero chunk."""
    rng = np.random.default_rng(seed)
    n = cn * PK.T
    hi = (1 << 12) if bits == 8 else (1 << 19) - 1
    v = np.minimum(rng.geometric(0.2 if bits == 8 else 0.001, n) - 1,
                   hi).astype(np.uint32)
    v[PK.T:2 * PK.T:3] = hi
    valid = np.ones(n, bool)
    valid[PK.T // 2:PK.T] = False
    valid[(cn - 1) * PK.T:] = False
    v[2 * PK.T:3 * PK.T] = 0
    return v, valid, rng


@pytest.mark.parametrize("bits", [8, 16])
def test_pack_ref_matches_pallas_and_xla(bits):
    from libjxl_tpu.models.lossless import _pack_buffers_xla
    from libjxl_tpu.models.pack_kernel import CB, pack_chunks_tpu

    cn = CB  # one Pallas grid step
    v, valid, rng = _chunks(bits, cn, 42 + bits)
    code_bits, code_len, lut = _random_code(rng)
    sent = np.uint32(0xFFFFFFFF)
    vs = np.where(valid, v, sent).reshape(cn, PK.T)

    buf_p, cb_p = PK.pack_chunks_ref(torch.from_numpy(vs.view(np.int32)),
                                     lut)
    buf_p = buf_p.numpy().view(np.uint32)
    cb_p = cb_p.numpy()

    buf_k, cb_k = pack_chunks_tpu(jnp.asarray(vs), jnp.asarray(lut.numpy()),
                                  interpret=True)
    np.testing.assert_array_equal(np.asarray(cb_k), cb_p)
    np.testing.assert_array_equal(np.asarray(buf_k), buf_p)

    buf_x, cb_x = _pack_buffers_xla(
        jnp.asarray(np.where(valid, v, 0)), jnp.asarray(valid),
        jnp.asarray(code_bits), jnp.asarray(code_len))
    np.testing.assert_array_equal(np.asarray(cb_x), cb_p)
    np.testing.assert_array_equal(np.asarray(buf_x), buf_p)


@pytest.mark.parametrize("cn", [1, 3, 300])
def test_pack_ref_any_chunk_count(cn):
    """No padding to 256-chunk blocks: any Cn, same as the XLA packer."""
    from libjxl_tpu.models.lossless import _pack_buffers_xla

    v, valid, rng = _chunks(8, cn, cn)
    code_bits, code_len, lut = _random_code(rng)
    vs = np.where(valid, v, np.uint32(0xFFFFFFFF)).reshape(cn, PK.T)
    buf_p, cb_p = PK.pack_chunks(torch.from_numpy(vs.view(np.int32)), lut)
    buf_x, cb_x = _pack_buffers_xla(
        jnp.asarray(np.where(valid, v, 0)), jnp.asarray(valid),
        jnp.asarray(code_bits), jnp.asarray(code_len))
    np.testing.assert_array_equal(np.asarray(cb_x), cb_p.numpy())
    np.testing.assert_array_equal(np.asarray(buf_x),
                                  buf_p.numpy().view(np.uint32))


def test_pack_chunks_on_cpu_runs_plain_version_and_counts_nothing():
    v, valid, rng = _chunks(16, 4, 5)
    vs = torch.from_numpy(
        np.where(valid, v, np.uint32(0xFFFFFFFF)).view(np.int32)
        .reshape(4, PK.T))
    lut = _random_code(rng)[2]
    before = PK.pack_chunks.launches
    got = PK.pack_chunks(vs, lut)
    want = PK.pack_chunks_ref(vs, lut)
    assert PK.pack_chunks.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pack_chunks_rejects_bad_input():
    lut = torch.zeros(96, dtype=torch.int32)
    ok = torch.zeros((2, PK.T), dtype=torch.int32)
    bad = [
        (torch.zeros((2, 64), dtype=torch.int32), lut),
        (torch.zeros((2, PK.T), dtype=torch.int64), lut),
        (torch.zeros((2, 2 * PK.T), dtype=torch.int32)[:, ::2], lut),
        (ok, torch.zeros(95, dtype=torch.int32)),
        (ok, torch.zeros(96, dtype=torch.int64)),
        (ok.to("meta"), lut.to("meta")),
    ]
    for v, t in bad:
        with pytest.raises(ValueError):
            PK.pack_chunks(v, t)
