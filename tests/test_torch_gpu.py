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


def _custom_lf(gab=True, epf_iters=3):
    """A loop filter with non-default Gaborish weights, EPF sharpness
    LUT, channel scales, sigma scales and border multiplier."""
    from libjxl_torch.core.frame_header import LoopFilter
    lf = LoopFilter()
    lf.gab, lf.epf_iters = gab, epf_iters
    lf.gab_x_weight1, lf.gab_x_weight2 = 0.125, 0.0625
    lf.gab_y_weight1, lf.gab_y_weight2 = 0.09375, 0.03125
    lf.gab_b_weight1, lf.gab_b_weight2 = 0.25, 0.0
    lf.epf_sharp_lut = (0.0, 0.25, 0.375, 0.5, 0.75, 1.0, 1.5, 2.0)
    lf.epf_channel_scale = (24.0, 8.0, 2.0)
    lf.epf_quant_mul = 0.75
    lf.epf_pass0_sigma_scale, lf.epf_pass2_sigma_scale = 0.5, 4.0
    lf.epf_border_sad_mul = 0.5
    return lf


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(37, 61), (270, 481)])
@pytest.mark.parametrize("gab,epf_iters", [(True, 3), (False, 2)])
def test_restore_custom_constants_on_card_matches_plain(shape, gab,
                                                        epf_iters):
    """The kernels with non-default loop-filter constants against their
    plain versions, within 1e-5."""
    from libjxl_torch.render.filters_torch import lf_params, restore
    dev = _card()
    rng = np.random.default_rng(shape[0])
    h, w = shape
    xyb = ((rng.random((3, h, w)) - 0.4) * 0.3).astype(np.float32)
    rq = rng.integers(1, 40, (-(-h // 8), -(-w // 8))).astype(np.int32)
    sh = rng.integers(0, 8, rq.shape).astype(np.int32)
    lf = _custom_lf(gab, epf_iters)
    out = {}
    for d in (dev, torch.device("cpu")):
        out[d.type] = restore(
            torch.from_numpy(xyb).to(d), torch.from_numpy(rq).to(d),
            torch.from_numpy(sh).to(d), 0.005, lf_params(lf, d), gab,
            epf_iters).cpu()
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-5


def _fixture(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.gpu
@pytest.mark.parametrize("path,tol", [
    ("tests/data/torch_vardct_var/graphics_256x320_e7.jxl", 1),
    ("tests/data/torch_vardct/rgb16_301x517.jxl", 4)])
def test_decode_device_filters_on_card_match_host(path, tol, monkeypatch):
    """decode() with its filters on the card (device_filters True: the
    frame stays on the card for the colour output; auto above the
    threshold: the band windows) against the float64 host filters; the
    banded path equals decode_rows on the card bit for bit."""
    import libjxl_torch.config as C
    from libjxl_torch.api.decoder import decode, decode_rows
    from libjxl_torch.models.filter_kernels import (
        epf_filter, gaborish_filter,
    )
    dev = _card()
    data = _fixture(path)
    monkeypatch.setattr(C.config, "device_filters", False)
    host = decode(data)
    monkeypatch.setattr(C.config, "device_filters", True)
    before = (gaborish_filter.launches, epf_filter.launches)
    resident = decode(data, device=dev)
    assert (gaborish_filter.launches, epf_filter.launches) > before
    assert resident.dtype == host.dtype and resident.shape == host.shape
    assert np.abs(resident.astype(int) - host.astype(int)).max() <= tol
    monkeypatch.setattr(C.config, "device_filters", None)
    monkeypatch.setattr(C, "device_filters_enabled", lambda n=None: True)
    banded = decode(data, device=dev)
    rows = np.concatenate([b for _, b in decode_rows(data, device=dev)])
    np.testing.assert_array_equal(banded, rows)
    assert np.abs(banded.astype(int) - host.astype(int)).max() <= tol


@pytest.mark.gpu
def test_device_encode_on_card_matches_host():
    """The e3 device encode on the card gives the host encoder's bytes on
    a 256x320 photo."""
    from bench import make_image
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
    dev = _card()
    img = make_image(7, 256, 320)
    got = encode_lossy(img, LossyOptions(distance=1.0, effort=3,
                                         use_device=True), device=dev)
    assert got == encode_lossy(img, LossyOptions(distance=1.0, effort=3))


@pytest.mark.gpu
@pytest.mark.parametrize("setting", [False, None])
def test_decode_many_host_routed_4mp_on_card(setting, monkeypatch):
    """A 4 MP progressive stream (host-routed) through decode_many on the
    card: with device_filters False it comes back from the pool, whose
    workers filter on the host; in auto mode it decodes in this process
    with its filters on the card. Each equals decode() with the same
    setting."""
    import libjxl_torch.config as C
    from libjxl_torch.api.decoder import decode, decode_many
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
    dev = _card()
    h = w = 2048
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h,
                    (xx + yy) * 255 // (h + w)], -1)
    img = (img + rng.integers(0, 6, img.shape)).clip(0, 255).astype(np.uint8)
    data = encode_lossy(img, LossyOptions(distance=1.0, effort=3,
                                          progressive=True, gaborish=1))
    monkeypatch.setattr(C.config, "device_filters", setting)
    got = decode_many([data], workers=2, device=dev)[0]
    np.testing.assert_array_equal(got, decode(data, device=dev))


@pytest.mark.gpu
def test_device_encode_program_on_card_equals_cpu():
    """The e3 device program on the card gives the CPU's float32 values
    bit for bit: the XYB image, the DCT and every output (quantized AC,
    DC, CfL maps) of a 1001x1503 photo."""
    from bench import make_image
    from libjxl_torch.models import vardct_pipeline as VP
    from libjxl_torch.vardct.frame_enc import (
        LossyOptions, _falcon_device_scalars,
    )
    dev = _card()
    img = make_image(23, 1001, 1503)
    sc = _falcon_device_scalars(img.shape, LossyOptions(
        distance=1.0, effort=3, use_device=True))
    px = torch.from_numpy(img[None])
    got = {}
    for d in (dev, torch.device("cpu")):
        xyb = VP.srgb_to_xyb_device(px.to(d).permute(0, 3, 1, 2))
        args = [torch.from_numpy(np.asarray(a, np.float32)).to(d)
                for a in sc[:6]]
        got[d.type] = [xyb, VP.dct_stored(xyb, *sc[6:10])] + list(
            VP._frame_body(px.to(d), *args, *sc[6:]))
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_diffmap_4k_on_card_matches_cpu():
    """The butteraugli diffmap of a 3840x2160 pair on the card within 1e-3
    of its max of the same float32 program on the CPU (cuDNN's blurs and
    the card's exp/log round differently)."""
    from _torch_e7 import photo
    from libjxl_torch.color.xyb import srgb_to_linear
    from libjxl_torch.metrics.butteraugli import butteraugli_diffmap
    dev = _card()
    img = photo(2160, 3840, 5)
    rng = np.random.default_rng(5)
    out = np.clip(img.astype(int) + rng.integers(-5, 6, img.shape), 0,
                  255).astype(np.uint8)
    a, b = (np.asarray(srgb_to_linear(np.moveaxis(x, -1, 0) / 255.0),
                       np.float32) for x in (img, out))
    got = butteraugli_diffmap(a, b, hf_asymmetry=0.8, device=dev).cpu()
    want = butteraugli_diffmap(a, b, hf_asymmetry=0.8, device="cpu")
    assert (got - want).abs().max() <= 1e-3 * want.max()


@pytest.mark.gpu
@pytest.mark.parametrize("gab,epf_iters", [(True, 1), (True, 3), (False, 2)])
def test_scorer_filters_on_card_match_plain(gab, epf_iters, monkeypatch):
    """The loop scorer's filtered image (Gaborish and EPF through the hand
    kernels on the card) within 1e-5 of ``filters_torch.restore``'s plain
    path on the CPU."""
    from libjxl_torch.models.vardct_loop import state_lf
    from libjxl_torch.render import filters_torch as FT
    from libjxl_torch.vardct.enc_roundtrip import score
    dev = _card()
    h, w = 270, 481
    rng = np.random.default_rng(epf_iters)
    xyb = ((rng.random((3, h, w)) - 0.4) * 0.3).astype(np.float32)
    orig = rng.random((3, h, w)).astype(np.float32)
    rq = rng.integers(1, 40, (-(-h // 8), -(-w // 8))).astype(np.int32)
    sharp = np.full(rq.shape, 4, np.int32)
    lf = state_lf(dict(gab=gab, epf_iters=epf_iters))
    seen = []
    restore = FT.restore

    def spy(*a, **k):
        seen.append(restore(*a, **k))
        return seen[-1]

    monkeypatch.setattr(FT, "restore", spy)
    t = (lambda a, d: torch.from_numpy(a).to(d))
    score(t(xyb, dev), t(orig, dev), t(rq, dev), t(sharp, dev), 0.7,
          FT.lf_params(lf, dev), gab, epf_iters, h, w)
    want = restore(t(xyb, "cpu"), t(rq, "cpu"), t(sharp, "cpu"), 0.7,
                   FT.lf_params(lf, "cpu"), gab, epf_iters)
    assert seen[0].is_cuda
    assert (seen[0].cpu() - want).abs().max() <= 1e-5


@pytest.mark.gpu
def test_e7_encode_on_card_meets_gate():
    """The effort-7 device encode (front end, grids, transform and the
    butteraugli loop on the card) of a 256x320 photo equals the same
    program's stream on the CPU or meets the fallback gate."""
    from _torch_e7 import equal_or_gate, photo
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
    dev = _card()
    img = photo(256, 320, 9)
    opts = LossyOptions(distance=1.0, effort=7, use_device=True)
    equal_or_gate(img, encode_lossy(img, opts, device=dev),
                  encode_lossy(img, opts, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(1080, 1920), (509, 333)])
@pytest.mark.parametrize("gab,epf_iters", [(True, 3), (False, 2)])
def test_restore_sharded_on_card_equals_whole_frame(h, w, gab, epf_iters):
    """The row-sharded filters on a 4-slot mesh of the card (the halo
    exchange, one launch per shard and pass) equal the whole-frame
    filters on the card bit for bit, custom constants included."""
    from libjxl_torch.models.filter_kernels import epf_filter, gaborish_filter
    from libjxl_torch.parallel.mesh import make_mesh
    from libjxl_torch.parallel.shard_filters import restore_sharded_padded
    from libjxl_torch.render.filters_torch import restore_device
    dev = _card()
    rng = np.random.default_rng(h)
    xyb = ((rng.random((3, h, w)) - 0.4) * 0.3).astype(np.float32)
    rq = rng.integers(1, 40, (-(-h // 8), -(-w // 8))).astype(np.int32)
    sh = rng.integers(0, 8, rq.shape).astype(np.int32)
    lf = _custom_lf(gab, epf_iters)
    mesh = make_mesh(4, dev)
    g0, e0 = gaborish_filter.launches, epf_filter.launches
    got = restore_sharded_padded(xyb, lf, rq, sh, 0.005, mesh=mesh)
    assert gaborish_filter.launches - g0 == 4 * int(gab)
    assert epf_filter.launches - e0 == 4 * epf_iters
    want = restore_device(xyb, lf, rq, sh, 0.005, fetch=False, device=dev)
    assert got.device == want.device
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_sharded_pack_on_card_gives_unsharded_stream(monkeypatch):
    """The two-pass lossless encode with its groups sharded over a 4-slot
    mesh of the card (one pack launch per shard) gives the unsharded
    stream."""
    import libjxl_torch.config as C
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    from libjxl_torch.models.pack_kernel import pack_chunks
    dev = _card()
    rng = np.random.default_rng(5)
    img = np.clip(np.cumsum(rng.integers(-3, 4, (1000, 1024, 3)), axis=1),
                  0, 255).astype(np.uint8)
    opts = EncodeOptions(use_device=True, entropy="prefix-device")
    base = encode_lossless(img, opts, device=dev)
    monkeypatch.setattr(C.config, "shard_encode", True)
    monkeypatch.setattr(C.config, "mesh_slots", 4)
    before = pack_chunks.launches
    got = encode_lossless(img, opts, device=dev)
    assert pack_chunks.launches - before == 4
    assert got == base
