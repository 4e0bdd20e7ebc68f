"""The port's butteraugli loop (``libjxl_torch/models/vardct_loop.py``) and
scorers (``libjxl_torch/vardct/enc_roundtrip.py``) against the JAX
package's on the CPU, built from the JAX package's first pass of the
effort-7 device encode of the 120x168 image at distance 1 (Gaborish, one
EPF pass):

* ``LoopState.block_sums(qf)``, for the first-pass field and a
  perturbed one, each block within 1e-3 relative; its pre-filter
  reconstruction within 1e-4;
* ``epf_candidate_errs`` on the JAX package's reconstruction, each block
  within 1e-4 relative, for both candidate sets and every EPF pass
  count;
* the host path's scorer ``roundtrip_block_sums``, each block within
  1e-3 relative.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_e7 import one_torch_thread, photo  # noqa: E402,F401
from libjxl_torch.models import vardct_loop as TL  # noqa: E402
from libjxl_torch.vardct import enc_roundtrip as TR  # noqa: E402
from libjxl_torch.vardct import frame_enc as port  # noqa: E402
from libjxl_tpu.models import vardct_loop as JL  # noqa: E402
from libjxl_tpu.vardct import enc_roundtrip as JR  # noqa: E402
from libjxl_tpu.vardct import frame_enc as ref  # noqa: E402
from libjxl_tpu.color.xyb import srgb_to_linear  # noqa: E402

IMG = photo(120, 168, 1)
H, W = IMG.shape[:2]
D = 1.0


def _first_pass(mod, use_device):
    """The iterated encode's first pass: (state, aux)."""
    aux = {}
    base = mod.LossyOptions(distance=D, effort=7, use_device=use_device)
    base._aux, base._in_iteration, base._recon_only = aux, True, True
    if mod is ref:
        ref.encode_lossy(IMG, base)
    else:
        port.encode_lossy(IMG, base, device="cpu")
    return aux.pop("recon_state"), aux


def _orig_f32():
    return np.asarray(srgb_to_linear(np.moveaxis(
        IMG.astype(np.float64) / 255.0, -1, 0)), np.float32)


def _port_aux(aux):
    """The JAX package's first-pass products in the port's host cache
    form: each class's raw coefficients at its exact count."""
    cc = {"dc_float": aux["coef_cache"]["dc_float"]}
    for s, (raws, _, _, _, n) in aux["coef_cache"]["dev"].items():
        if n:
            raws = np.asarray(raws)[:n]
            cc[int(s)] = {c: raws[:, c] for c in range(3)}
    return dict(coef_cache=cc, acs=aux["acs"], anchors=aux["anchors"])


@pytest.fixture(scope="module")
def loop():
    state, aux = _first_pass(ref, True)
    x_qm_mul = 1.25 ** (state["x_qm_scale"] - 2)
    qf = aux["qf_field"].copy()
    qf2 = qf * np.random.default_rng(0).uniform(0.8, 1.25, qf.shape)
    js = JL.LoopState(state, aux, _orig_f32(), D, x_qm_mul, H, W,
                      orig_u8=IMG)
    ts = TL.LoopState(state, _port_aux(aux), _orig_f32(), D, x_qm_mul, H, W,
                      orig_u8=IMG, device="cpu")
    xyb, shim = js.recon_prefilter(qf)
    return dict(state=state, aux=aux, qf=(qf, qf2), js=js, ts=ts,
                xyb=np.asarray(xyb), shim=shim,
                opsin=np.asarray(aux["opsin"]))


@pytest.mark.parametrize("which", [0, 1])
def test_block_sums_match_jax(which, loop):
    qf = loop["qf"][which]
    want = loop["js"].block_sums(qf)
    got = loop["ts"].block_sums(qf)
    assert got.shape == want.shape == (-(-H // 8), -(-W // 8))
    assert (np.abs(got - want) <= 1e-3 * np.abs(want)).all()


def test_recon_prefilter_matches_jax(loop):
    xyb, shim = loop["ts"].recon_prefilter(loop["qf"][0])
    assert xyb.shape == (3, H, W)
    assert np.abs(xyb.numpy() - loop["xyb"]).max() <= 1e-4
    np.testing.assert_array_equal(shim.raw_quant, loop["shim"].raw_quant)
    np.testing.assert_array_equal(shim.epf_sharpness,
                                  loop["shim"].epf_sharpness)
    assert shim.quantizer.scale == loop["shim"].quantizer.scale


@pytest.mark.parametrize("epf_iters", [1, 2, 3])
@pytest.mark.parametrize("steps", [(0, 2, 7), (0, 4)])
def test_epf_candidate_errs_match_jax(steps, epf_iters, loop):
    state = dict(loop["state"], epf_iters=epf_iters)
    args = (loop["xyb"], loop["shim"])
    want = JR.epf_candidate_errs(*args, JL.state_lf(state), loop["opsin"],
                                 steps)
    got = TR.epf_candidate_errs(*args, TL.state_lf(state), loop["opsin"],
                                steps, device="cpu")
    assert got.shape == want.shape == (len(steps), -(-H // 8), -(-W // 8))
    assert (np.abs(got - want) <= 1e-4 * np.abs(want)).all()


def test_host_scorer_matches_jax():
    jstate, _ = _first_pass(ref, False)
    tstate, _ = _first_pass(port, False)
    want = JR.roundtrip_block_sums(jstate, _orig_f32(), H, W)
    got = TR.roundtrip_block_sums(tstate, _orig_f32(), H, W, device="cpu")
    assert (np.abs(got - want) <= 1e-3 * np.abs(want)).all()
    # the loop state's device cache gives its host cache's sums
    state, aux = _first_pass(port, True)
    a = TL.LoopState(state, aux, _orig_f32(), D, 1.0, H, W, device="cpu")
    host = copy.copy(aux)
    host["coef_cache"] = {"dc_float": aux["coef_cache"]["dc_float"]}
    for s, (coefs, _, _) in ((k, v) for k, v in
                             aux["coef_cache"]["dev"].items()
                             if isinstance(k, int)):
        host["coef_cache"][s] = {c: coefs[:, c].numpy() for c in range(3)}
    b = TL.LoopState(state, host, _orig_f32(), D, 1.0, H, W, device="cpu")
    qf = aux["qf_field"]
    np.testing.assert_array_equal(a.block_sums(qf), b.block_sums(qf))
