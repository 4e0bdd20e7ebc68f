"""The port's restoration filters against the JAX package on the CPU.

The plain float32 versions of the Gaborish and EPF kernels
(``libjxl_torch/models/filter_kernels.py``, reached through
``render/filters_torch.py`` on CPU tensors) against the ``xp=jax.numpy``
math of ``libjxl_tpu/render/filters.py`` and against the Pallas kernels
run in interpret mode, at the default loop-filter constants and at
non-default ones (Gaborish weights, EPF sharpness LUT, channel scales,
sigma scales, border multiplier), as a stream may signal them.
Tolerance: 1e-5 absolute, the tolerance of
``tests/test_butteraugli.py`` for the Pallas filters (float32 summation
order differs; XYB values are below 1 in magnitude).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from libjxl_torch.models import filter_kernels as K  # noqa: E402
from libjxl_torch.render import filters_torch as FT  # noqa: E402
from libjxl_tpu.core.frame_header import LoopFilter  # noqa: E402
from libjxl_tpu.render import filters as F  # noqa: E402
from libjxl_tpu.render import filters_jax as FJ  # noqa: E402

TOL = 1e-5
# 1, 2 and 3 pixels wide or high: the mirror reflects more than once
SHAPES = [(1, 7), (7, 1), (2, 9), (3, 5), (5, 3), (1, 1), (37, 61)]


def _inputs(seed: int, h: int, w: int):
    """XYB in [-0.12, 0.18], raw quant 1..39 and EPF sharpness 4 with a
    patch of sharpness 0 (its inv_sigma is below K_MIN_SIGMA)."""
    rng = np.random.default_rng(seed)
    xyb = ((rng.random((3, h, w)) - 0.4) * 0.3).astype(np.float32)
    yb, xb = -(-h // 8), -(-w // 8)
    rq = rng.integers(1, 40, (yb, xb)).astype(np.int32)
    sh = np.full((yb, xb), 4, np.int32)
    sh[yb // 2:, :(xb + 1) // 2] = 0
    return xyb, rq, sh


def _lf(gab=True, epf_iters=3):
    lf = LoopFilter()
    lf.gab = gab
    lf.epf_iters = epf_iters
    return lf


# non-default loop-filter constants, one group at a time and all at once
# (each exact in float16, as a stream carries them)
VARIANTS = dict(
    gab_weights=dict(gab_custom=True, gab_x_weight1=0.125,
                     gab_x_weight2=0.0625, gab_y_weight1=0.09375,
                     gab_y_weight2=0.03125, gab_b_weight1=0.25,
                     gab_b_weight2=0.0),
    sharp_lut=dict(epf_sharp_custom=True, epf_sharp_lut=(
        0.0, 0.25, 0.375, 0.5, 0.75, 1.0, 1.5, 2.0)),
    channel_scale=dict(epf_weight_custom=True,
                       epf_channel_scale=(24.0, 8.0, 2.0)),
    sigma_scales=dict(epf_sigma_custom=True, epf_quant_mul=0.75,
                      epf_pass0_sigma_scale=0.5, epf_pass2_sigma_scale=4.0),
    border_sad_mul=dict(epf_sigma_custom=True, epf_border_sad_mul=0.5),
)
VARIANTS["all"] = {k: v for d in list(VARIANTS.values()) for k, v in
                   d.items()}


def _lf_custom(variant, gab=True, epf_iters=3):
    lf = _lf(gab, epf_iters)
    for k, v in VARIANTS[variant].items():
        setattr(lf, k, v)
    return lf


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("pad", [1, 3, 4, 9])
def test_mirror_pad_matches_numpy_symmetric(n, pad):
    a = np.arange(2 * n * 3 * n).reshape(2, n, 3 * n)
    got = K.mirror_pad(_t(a), pad).numpy()
    want = np.pad(a, ((0, 0), (pad, pad), (pad, pad)), mode="symmetric")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_gaborish_plain_matches_jax(shape):
    xyb, _, _ = _inputs(1, *shape)
    lf = _lf()
    got = FT.gaborish(_t(xyb), FT.lf_params(lf, "cpu")).numpy()
    want = np.asarray(F.gaborish(jnp.asarray(xyb), FJ.lf_params(lf),
                                 xp=jnp))
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("pass_id", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_epf_plain_matches_jax(pass_id, shape):
    xyb, rq, sh = _inputs(2 + pass_id, *shape)
    lf = _lf()
    lfp, lfj = FT.lf_params(lf, "cpu"), FJ.lf_params(lf)
    inv = FT.compute_sigma(lfp, _t(rq), _t(sh), 0.005)
    inv_j = F.compute_sigma(lfj, None, None, jnp.asarray(rq),
                            jnp.asarray(sh), jnp.float32(0.005), xp=jnp)
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), rtol=1e-6)
    step = (FT.epf_step0, FT.epf_step1, FT.epf_step2)[pass_id]
    step_j = (F.epf_step0, F.epf_step1, F.epf_step2)[pass_id]
    got = step(_t(xyb), inv, lfp).numpy()
    want = np.asarray(step_j(jnp.asarray(xyb), inv_j, lfj, xp=jnp))
    assert np.abs(got - want).max() <= TOL
    # the patch below K_MIN_SIGMA passes through
    skip = np.repeat(np.repeat(inv.numpy(), 8, 0), 8, 1)[:shape[0], :shape[1]]
    skip = skip < K.K_MIN_SIGMA
    np.testing.assert_array_equal(got[:, skip], xyb[:, skip])


@pytest.mark.parametrize("gab,epf_iters", [(True, 3), (True, 2), (False, 1),
                                           (True, 0)])
def test_restore_matches_jax_program(gab, epf_iters):
    """The whole chain against the reference's jitted XLA program."""
    xyb, rq, sh = _inputs(7, 45, 70)
    lf = _lf(gab, epf_iters)
    got = FT.restore(_t(xyb), _t(rq), _t(sh), 0.004,
                     FT.lf_params(lf, "cpu"), gab, epf_iters).numpy()
    want = np.asarray(FJ._restore(jnp.asarray(xyb), jnp.asarray(rq),
                                  jnp.asarray(sh), jnp.float32(0.004),
                                  FJ.lf_params(lf), gab, epf_iters))
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("gab,epf_iters", [(True, 3), (False, 2)])
def test_restore_matches_pallas_interpret(gab, epf_iters):
    """The chain against the TPU kernels in the Pallas interpreter, as
    tests/test_butteraugli.py runs them."""
    import libjxl_tpu.models.pallas_filters as PF

    xyb, rq, sh = _inputs(9, 72, 136)
    lf = _lf(gab, epf_iters)
    got = FT.restore(_t(xyb), _t(rq), _t(sh), 0.005,
                     FT.lf_params(lf, "cpu"), gab, epf_iters).numpy()
    inv_sig = F.compute_sigma(lf, None, None, rq, sh, 0.005)
    sig_pix = F._upsample8(np.asarray(inv_sig, np.float32), 72, 136)
    orig = PF.pl.pallas_call
    PF.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        want = np.asarray(PF.restore_pallas(
            jnp.asarray(xyb), jnp.asarray(sig_pix),
            PF.static_lf_params(lf), gab, epf_iters))
    finally:
        PF.pl.pallas_call = orig
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("maxval", [255, 65535])
def test_output_int_matches_jax(maxval):
    xyb, _, _ = _inputs(11, 33, 47)
    xyb[1] += 0.4          # around mid-grey, where sRGB is steep
    got = FT.output_int(_t(xyb), 255.0, maxval).numpy()
    if maxval > 255:
        got = got.view(np.uint16)
    want = np.asarray(FJ._output_int(jnp.asarray(xyb), jnp.float32(255.0),
                                     maxval))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_wrappers_check_their_inputs():
    x = torch.zeros((3, 16, 16))
    sig = torch.zeros((2, 2))
    before = (K.gaborish_filter.launches, K.epf_filter.launches)
    with pytest.raises(ValueError):
        K.gaborish_filter(x.double(), (1,) * 3, (0,) * 3, (0,) * 3)
    with pytest.raises(ValueError):
        K.gaborish_filter(torch.zeros((4, 16, 16)), (1,) * 3, (0,) * 3,
                          (0,) * 3)
    with pytest.raises(ValueError):
        K.gaborish_filter(torch.zeros((3, 16, 32))[:, :, ::2], (1,) * 3,
                          (0,) * 3, (0,) * 3)
    with pytest.raises(ValueError):
        K.epf_filter(x, sig, 3, (1, 1, 1), 1.0, 1.0)
    with pytest.raises(ValueError):
        K.epf_filter(x, torch.zeros((1, 2)), 1, (1, 1, 1), 1.0, 1.0)
    with pytest.raises(ValueError):
        K.epf_filter(x.to("meta"), sig.to("meta"), 1, (1, 1, 1), 1.0, 1.0)
    # a CPU tensor runs the plain version and launches nothing
    K.epf_filter(x, sig, 1, (1, 1, 1), 1.0, 1.0)
    assert (K.gaborish_filter.launches, K.epf_filter.launches) == before


@pytest.mark.parametrize("variant", ["gab_weights", "all"])
@pytest.mark.parametrize("shape", [(2, 9), (37, 61)])
def test_gaborish_plain_matches_jax_custom_constants(variant, shape):
    xyb, _, _ = _inputs(21, *shape)
    lf = _lf_custom(variant)
    got = FT.gaborish(_t(xyb), FT.lf_params(lf, "cpu")).numpy()
    want = np.asarray(F.gaborish(jnp.asarray(xyb), FJ.lf_params(lf),
                                 xp=jnp))
    assert np.abs(got - want).max() <= TOL
    default = FT.gaborish(_t(xyb), FT.lf_params(_lf(), "cpu")).numpy()
    assert np.abs(got - default).max() > 100 * TOL


@pytest.mark.parametrize("variant", ["sharp_lut", "channel_scale",
                                     "sigma_scales", "border_sad_mul",
                                     "all"])
@pytest.mark.parametrize("pass_id", [0, 1, 2])
def test_epf_plain_matches_jax_custom_constants(pass_id, variant):
    xyb, rq, sh = _inputs(22 + pass_id, 37, 61)
    sh[:2] = 7          # the LUT's last entry too
    lf = _lf_custom(variant)
    lfp, lfj = FT.lf_params(lf, "cpu"), FJ.lf_params(lf)
    inv = FT.compute_sigma(lfp, _t(rq), _t(sh), 0.005)
    inv_j = F.compute_sigma(lfj, None, None, jnp.asarray(rq),
                            jnp.asarray(sh), jnp.float32(0.005), xp=jnp)
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), rtol=1e-6)
    step = (FT.epf_step0, FT.epf_step1, FT.epf_step2)[pass_id]
    step_j = (F.epf_step0, F.epf_step1, F.epf_step2)[pass_id]
    got = step(_t(xyb), inv, lfp).numpy()
    want = np.asarray(step_j(jnp.asarray(xyb), inv_j, lfj, xp=jnp))
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_restore_matches_jax_program_custom_constants(variant):
    xyb, rq, sh = _inputs(23, 45, 70)
    lf = _lf_custom(variant)
    got = FT.restore(_t(xyb), _t(rq), _t(sh), 0.004,
                     FT.lf_params(lf, "cpu"), True, 3).numpy()
    want = np.asarray(FJ._restore(jnp.asarray(xyb), jnp.asarray(rq),
                                  jnp.asarray(sh), jnp.float32(0.004),
                                  FJ.lf_params(lf), True, 3))
    assert np.abs(got - want).max() <= TOL
    default = FT.restore(_t(xyb), _t(rq), _t(sh), 0.004,
                         FT.lf_params(_lf(), "cpu"), True, 3).numpy()
    assert np.abs(got - default).max() > 100 * TOL


@pytest.mark.parametrize("gab,epf_iters", [(True, 3), (False, 2)])
def test_restore_matches_pallas_interpret_custom_constants(gab, epf_iters):
    import libjxl_tpu.models.pallas_filters as PF

    xyb, rq, sh = _inputs(24, 72, 136)
    lf = _lf_custom("all", gab, epf_iters)
    got = FT.restore(_t(xyb), _t(rq), _t(sh), 0.005,
                     FT.lf_params(lf, "cpu"), gab, epf_iters).numpy()
    inv_sig = F.compute_sigma(lf, None, None, rq, sh, 0.005)
    sig_pix = F._upsample8(np.asarray(inv_sig, np.float32), 72, 136)
    orig = PF.pl.pallas_call
    PF.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        want = np.asarray(PF.restore_pallas(
            jnp.asarray(xyb), jnp.asarray(sig_pix),
            PF.static_lf_params(lf), gab, epf_iters))
    finally:
        PF.pl.pallas_call = orig
    assert np.abs(got - want).max() <= TOL
