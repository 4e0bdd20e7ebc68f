"""The port's effort >= 5 device front end, ACS cost grids and transform
(``libjxl_torch/models/vardct_heuristics.py``, ``vardct_transform.py``)
against the JAX package's on the CPU. Each stage gets the JAX package's
inputs to that stage:

* ``front_device``: the padded XYB and the pre-Gaborish plane within
  1e-5 absolute, the quant field within 1e-5 relative, and the integer
  global scale and raw quant field the host derives from it equal;
* ``acs_grids_device``: every cell of every grid within 1e-4 relative,
  but for the cells ``FLIPS`` names, where one Y value lies on a
  rounding step in float64 and rounds the other way in the two float32
  DCTs (each within 1e-3, its flip shown); and the ACS map the host
  merge pass chooses from the grids equal;
* ``transform_quantize_device``: the quantized coefficients and the CfL
  maps equal, the DC grid within 1e-5, and the device cache the loop
  reads holding each class at its exact count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_e7 import one_torch_thread, photo  # noqa: E402,F401
from libjxl_torch.models import vardct_heuristics as TH  # noqa: E402
from libjxl_torch.models import vardct_transform as TT  # noqa: E402
from libjxl_tpu.models import vardct_heuristics as JH  # noqa: E402
from libjxl_tpu.models import vardct_transform as JT  # noqa: E402
from libjxl_tpu.vardct.adaptive_quant import (  # noqa: E402
    compute_global_scale_and_quant, initial_quant_dc,
)
from libjxl_tpu.vardct.enc_acs import choose_acs  # noqa: E402
from libjxl_tpu.vardct.frame_dec import Quantizer  # noqa: E402
from libjxl_tpu.vardct.quant_weights import DequantMatrices  # noqa: E402
from libjxl_torch.vardct.ac_strategy import (  # noqa: E402
    COVERED_X, COVERED_Y,
)
from libjxl_torch.vardct.dct import dct_matrix  # noqa: E402
from libjxl_torch.vardct.enc_acs import _thresholds  # noqa: E402

CASES = {"120x168_d1": (120, 168, 1.0, True),
         "64x96_d5": (64, 96, 5.0, True),
         "64x72_d0.4": (64, 72, 0.4, False)}
STRATEGIES = (0, 4, 6, 7, 5, 10, 11, 18, 19, 20)
# (case, strategy, grid (0 cost, 1 loss), cell) of each grid cell where
# one Y value rounds the other way in the two float32 DCTs: at 120x168
# d1 a DCT16X32 cost cell holds a Y value of 2.5000007 in float64
FLIPS = {("120x168_d1", 11, 0, (2, 2))}


def _y_step_distance(j, s, cy, cx):
    """How near a rounding step the Y values of the cell (cy, cx) of
    strategy ``s`` lie before rounding, in float64 (the smallest distance
    from a .5 boundary or the dead-zone threshold), as
    ``enc_acs.strategy_rate_loss`` quantizes them."""
    nby, nbx = COVERED_Y[s], COVERED_X[s]
    rows, cols = nby * 8, nbx * 8
    win = j["xyb_p"][1, cy * rows:(cy + 1) * rows,
                     cx * cols:(cx + 1) * cols].astype(np.float64)
    coef = dct_matrix(rows) @ win @ dct_matrix(cols).T
    stored = (coef.T if rows >= cols else coef).reshape(-1)
    qf = j["rq"][cy * nby:(cy + 1) * nby, cx * nbx:(cx + 1) * nbx].max()
    table = DequantMatrices().table_for_strategy(s)[1].reshape(-1)
    val = np.abs(stored * (j["quant"].scale / table) * qf)
    dist = np.minimum(np.abs(val - np.floor(val) - 0.5),
                      np.abs(val - _thresholds(nby, nbx, True)))
    return dist[nby * nbx:].min()


@pytest.fixture(scope="module")
def jax_stages():
    """Per case: the JAX package's front end, grids, ACS choice and
    transform, with what each was given."""
    out = {}
    for name, (h, w, d, gab) in CASES.items():
        img = photo(h, w, 2)
        yb, xb = -(-h // 8), -(-w // 8)
        qf, xyb_p, pre = (np.asarray(a) for a in JH.front_device(
            jnp.asarray(img), d, gab, h=h, w=w, yb=yb, xb=xb))
        gs, qdc, rq = compute_global_scale_and_quant(initial_quant_dc(d),
                                                     qf)
        quant = Quantizer(gs, qdc)
        grids = JH.acs_grids_device(jnp.asarray(xyb_p), rq,
                                    DequantMatrices(), quant, d, STRATEGIES)
        acs, anchors, rq2 = choose_acs(
            xyb_p.astype(np.float64), rq, DequantMatrices(), quant, d,
            try_small=True, try_64=True, try_32=True, grids=grids)
        tq = JT.transform_quantize_device(
            jnp.asarray(xyb_p), acs, anchors, rq2, DequantMatrices(), quant,
            1.25 ** (3 if d > 2.5 else 1))
        out[name] = dict(img=img, d=d, gab=gab, qf=qf, xyb_p=xyb_p, pre=pre,
                         gs=gs, rq=rq, quant=quant, grids=grids, acs=acs,
                         anchors=anchors, rq2=rq2, tq=tq)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_front_device_matches_jax(name, jax_stages):
    j = jax_stages[name]
    h, w, d, gab = CASES[name]
    qf, xyb_p, pre = (a.numpy() for a in TH.front_device(
        j["img"], d, gab, h, w, -(-h // 8), -(-w // 8), device="cpu"))
    assert np.abs(xyb_p - j["xyb_p"]).max() <= 1e-5
    assert np.abs(pre - j["pre"]).max() <= 1e-5
    assert np.abs(qf - j["qf"]).max() <= 1e-5 * np.abs(j["qf"]).max()
    gs, _, rq = compute_global_scale_and_quant(initial_quant_dc(d), qf)
    assert gs == j["gs"]
    np.testing.assert_array_equal(rq, j["rq"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_acs_grids_match_jax(name, jax_stages):
    j = jax_stages[name]
    got = TH.acs_grids_device(torch.from_numpy(j["xyb_p"].copy()), j["rq"],
                              DequantMatrices(), j["quant"], j["d"],
                              STRATEGIES)
    assert sorted(got) == sorted(j["grids"])
    for s, pair in j["grids"].items():
        for g, (a, b) in enumerate(zip(got[s], pair)):
            assert a.shape == b.shape
            off = np.abs(a - b) / np.abs(b)
            flips = {(name, s, g, tuple(int(i) for i in c))
                     for c in np.argwhere(off > 1e-4)}
            # a cell whose float32 DCT puts one Y value on the other side
            # of a rounding step moves by that value's rate and error
            assert flips <= FLIPS, sorted(flips - FLIPS)
            for *_, (cy, cx) in flips:
                assert off[cy, cx] <= 1e-3, (s, g, cy, cx)
                assert _y_step_distance(j, s, cy, cx) <= 1e-5, (s, cy, cx)
    acs, anchors, rq2 = choose_acs(
        j["xyb_p"].astype(np.float64), j["rq"], DequantMatrices(),
        j["quant"], j["d"], try_small=True, try_64=True, try_32=True,
        grids=got)
    np.testing.assert_array_equal(acs, j["acs"])
    np.testing.assert_array_equal(anchors, j["anchors"])
    np.testing.assert_array_equal(rq2, j["rq2"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_quantize_matches_jax(name, jax_stages):
    j = jax_stages[name]
    want = j["tq"]
    got = TT.transform_quantize_device(
        torch.from_numpy(j["xyb_p"].copy()), j["acs"], j["anchors"],
        j["rq2"], DequantMatrices(), j["quant"],
        1.25 ** (3 if j["d"] > 2.5 else 1))
    assert sorted(got["blocks_q"]) == sorted(want["blocks_q"])
    for k, blk in want["blocks_q"].items():
        np.testing.assert_array_equal(got["blocks_q"][k]["q"], blk["q"])
        assert got["blocks_q"][k]["strategy"] == blk["strategy"]
    np.testing.assert_array_equal(got["ytox"], want["ytox"])
    np.testing.assert_array_equal(got["ytob"], want["ytob"])
    assert np.abs(got["dc_float"] - want["dc_float"]).max() <= 1e-5
    # the loop's device data: each class at its exact count
    cache = got["dev_cache"]
    np.testing.assert_array_equal(cache["dc_float"].numpy(),
                                  got["dc_float"].astype(np.float32))
    for s, (coefs, by0, bx0) in ((k, v) for k, v in cache.items()
                                 if isinstance(k, int)):
        sel = j["anchors"] & (j["acs"] == s)
        assert coefs.shape[0] == by0.shape[0] == int(sel.sum())
        assert sel[by0.numpy(), bx0.numpy()].all()
        jraw, *_, n = want["dev_cache"][s]
        assert n == coefs.shape[0]
        assert np.abs(coefs.numpy() - np.asarray(jraw)[:n]).max() <= 1e-5
