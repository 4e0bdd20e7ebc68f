"""CUDA kernels of the PyTorch port against their plain PyTorch versions,
on the card. Skipped where no CUDA card is present.

This file imports no JAX, so it runs on a machine that has only PyTorch
and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("cn", [1, 7, 256, 4099])
def test_pack_kernel_matches_plain_on_card(bits, cn):
    from libjxl_torch.models.lossless import (
        prefix_state_to_device, random_prefix_state,
    )
    from libjxl_torch.models.pack_kernel import (
        T, pack_chunks, pack_chunks_ref,
    )
    dev = _card()
    rng = np.random.default_rng(100 * bits + cn)
    hi = (1 << 12) if bits == 8 else (1 << 19) - 1
    v = np.minimum(rng.geometric(0.05, (cn, T)) - 1, hi).astype(np.int64)
    v[0, T // 2:] = -1                     # sentinel suffix
    if cn > 2:
        v[-1] = -1                         # all-invalid chunk
        v[cn // 2] = 0                     # all-zero chunk
    v[cn // 3, ::3] = hi                   # the largest residual
    vt = torch.from_numpy(v.astype(np.int32)).to(dev)
    lut = prefix_state_to_device(random_prefix_state(rng), dev)
    before = pack_chunks.launches
    buf_k, cb_k = pack_chunks(vt, lut)
    torch.cuda.synchronize()
    assert pack_chunks.launches == before + 1
    buf_r, cb_r = pack_chunks_ref(vt, lut)
    assert torch.equal(cb_k, cb_r)
    assert torch.equal(buf_k, buf_r)


@pytest.mark.gpu
def test_pack_kernel_rejects_bad_input_on_card():
    from libjxl_torch.models.pack_kernel import pack_chunks
    dev = _card()
    lut = torch.zeros(96, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pack_chunks(torch.zeros((4, 64), dtype=torch.int32, device=dev), lut)
    with pytest.raises(ValueError):
        pack_chunks(torch.zeros((4, 128), dtype=torch.int64, device=dev),
                    lut)
    with pytest.raises(ValueError):
        pack_chunks(torch.zeros((4, 256), dtype=torch.int32,
                                device=dev)[:, ::2], lut)


def _filter_inputs(seed: int, h: int, w: int, dev, sigma_extra: int = 0,
                   patch=None):
    """XYB in [-0.12, 0.18] and a per-block inv_sigma, ``sigma_extra``
    columns wider than the image needs, with a patch below K_MIN_SIGMA
    (sharpness 0 gives -1e4): ``patch`` = (y0, y1, x0, x1) in blocks, by
    default the lower left quarter."""
    from libjxl_torch.models.filter_kernels import K_MIN_SIGMA
    rng = np.random.default_rng(seed)
    xyb = ((rng.random((3, h, w)) - 0.4) * 0.3).astype(np.float32)
    yb, xb = -(-h // 8), -(-w // 8)
    inv = -rng.uniform(0.05, 3.0, (yb, xb + sigma_extra)).astype(np.float32)
    if patch is None:
        inv[yb // 2:, :(xb + 1) // 2] = -1e4
    else:
        inv[patch[0]:patch[1], patch[2]:patch[3]] = -1e4
    assert (inv < K_MIN_SIGMA).any()
    return (torch.from_numpy(xyb).to(dev), torch.from_numpy(inv).to(dev))


# (h, w[, extra inv_sigma columns, pass-through patch in blocks]). EPF0
# and EPF1 give each warp a strip of 32 columns of which 26 (EPF0) or 28
# (EPF1) are output, put 4 strips side by side in a block, and walk runs
# of 32 (EPF0) or 16 (EPF1) rows: the shapes at and one pixel past a
# strip and run and a block, a width of 30, a frame whose inner tiles
# copy 16-byte pieces without the mirror, a wider inv_sigma and a
# pass-through patch across a run border (y 32) and a strip border
# (x 26 and 28).
FILTER_SHAPES = [(1, 7), (3, 5), (2, 1), (37, 61), (270, 481),
                 (32, 26), (33, 27), (16, 28), (17, 29), (32, 30),
                 (32, 104), (33, 105), (16, 112), (17, 113), (200, 300),
                 (70, 90, 5, None), (96, 120, 0, (3, 5, 3, 4))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FILTER_SHAPES)
@pytest.mark.parametrize("which", ["gab", 0, 1, 2])
def test_filter_kernels_match_plain_on_card(shape, which):
    """Gaborish and EPF passes 0/1/2 against their plain versions, within
    1e-5 (float32 summation and FMA order differ)."""
    from libjxl_torch.models.filter_kernels import (
        epf_filter, epf_ref, gaborish_filter, gaborish_ref,
    )
    dev = _card()
    x, inv = _filter_inputs(shape[0] * 1000 + shape[1], *shape[:2], dev,
                            *shape[2:])
    if which == "gab":
        w = ((0.7, 0.72, 0.8), (0.05, 0.06, 0.04), (0.025, 0.01, 0.01))
        before = gaborish_filter.launches
        got = gaborish_filter(x, *w)
        torch.cuda.synchronize()
        assert gaborish_filter.launches == before + 1
        want = gaborish_ref(x, *w)
    else:
        args = (inv, which, (40.0, 5.0, 3.5), 1.65 * 0.9, 1.65 * 0.9 * 2 / 3)
        before = epf_filter.pass_launches[which]
        got = epf_filter(x, *args)
        torch.cuda.synchronize()
        assert epf_filter.pass_launches[which] == before + 1
        want = epf_ref(x, *args)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("gab,epf_iters", [(False, 0), (True, 3)])
def test_decode_frames_device_var_card_matches_cpu(gab, epf_iters):
    """Variable-block reconstruction of frames that use all 27 AC
    strategies on the card against the same on the CPU (the kernels'
    plain versions), within +-1 per sample."""
    from libjxl_torch.core.frame_header import LoopFilter
    from libjxl_torch.models.filter_kernels import gaborish_filter
    from libjxl_torch.models.vardct_decode import decode_frames_device_var
    from _torch_var_frames import synthetic_frames
    dev = _card()
    frames = synthetic_frames()
    before = gaborish_filter.launches
    got = decode_frames_device_var(frames, LoopFilter(), gab, epf_iters,
                                   256, 256, device=dev)
    assert gaborish_filter.launches - before == (len(frames) if gab else 0)
    want = decode_frames_device_var(frames, LoopFilter(), gab, epf_iters,
                                    256, 256, device="cpu")
    for g, r in zip(got, want, strict=True):
        assert g.shape == r.shape == (256, 256, 3)
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
