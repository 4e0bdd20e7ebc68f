"""The port's multi-device path on an 8-slot mesh of the CPU, against its
own unsharded path and against the JAX package on its 8 virtual CPU
devices (``tests/conftest.py``).

* The two-pass lossless encode (``encode_lossless``, prefix-device) with
  ``config.shard_encode``: 16 groups of 128 px, 2 a slot, give the
  unsharded bytes and the JAX package's with its own ``shard_encode``,
  and decode exactly; a group count that 8 does not divide takes the
  unsharded route, as in the reference.
* ``restore_sharded`` (the halo exchange) is the whole-frame ``restore``
  bit for bit and within 1e-5 of JAX's ``restore_sharded`` (ROADMAP's
  filter tolerance; JAX mirrors the frame edge into its halo and sums in
  another order), at EPF passes 1-3 and custom loop-filter constants.
* ``restore_sharded_padded`` at heights that need no pad, a pad of 1-3
  rows (bumped by one 8*n step), a longer pad, and on an image too small
  for the halo (the unsharded route).
* The sharded VarDCT e3 encode of a 200x168 image gives the unsharded
  bytes and JAX's.
* ``decode()`` with ``config.shard_decode`` gives ``decode()``'s pixels.
* ``graft_entry.dryrun_multichip(8)``.

Each sharded case reads a counter of its branch: a byte-identity test
passes trivially when the branch is never reached.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_e7 import one_torch_thread  # noqa: E402,F401

import libjxl_torch.config as port_config  # noqa: E402
import libjxl_tpu.config as ref_config  # noqa: E402
from libjxl_torch.parallel import mesh as M  # noqa: E402
from libjxl_torch.parallel import shard_filters as SF  # noqa: E402
from libjxl_torch.render import filters_torch as FT  # noqa: E402
from libjxl_tpu.core.frame_header import LoopFilter  # noqa: E402

TOL = 1e-5
SLOTS = 8


def _img(seed, h, w):
    rng = np.random.default_rng(seed)
    return np.clip(np.cumsum(rng.integers(-3, 4, (h, w, 3)), axis=1),
                   0, 255).astype(np.uint8)


@pytest.fixture
def shard(monkeypatch):
    """Set a sharding flag on both packages' configs, on an 8-slot CPU
    mesh for the port (restored after the test)."""
    assert len(jax.devices()) == SLOTS
    monkeypatch.setattr(port_config.config, "mesh_slots", SLOTS)

    def on(flag: str, value: bool = True):
        monkeypatch.setattr(port_config.config, flag, value)
        monkeypatch.setattr(ref_config.config, flag, value)
    return on


def test_make_mesh_deals_slots_and_splits_groups():
    mesh = M.make_mesh(SLOTS, "cpu")
    assert mesh.size == SLOTS
    assert set(mesh.slots) == {torch.device("cpu")}
    assert M.make_mesh(device="cpu").size == 1
    a = np.arange(16 * 3).reshape(16, 3).astype(np.uint16)
    before = M.shard_groups.calls
    parts = M.shard_groups(mesh, a)
    assert M.shard_groups.calls == before + 1
    assert [p.shape[0] for p in parts] == [2] * SLOTS
    np.testing.assert_array_equal(torch.cat(parts).numpy(), a)
    with pytest.raises(ValueError):
        M.shard_groups(mesh, a[:12])
    from libjxl_tpu.parallel.mesh import pad_groups_to_multiple
    for g in (5, 8, 13):
        got, n = M.pad_groups_to_multiple(a[:g], SLOTS)
        want, m = pad_groups_to_multiple(a[:g], SLOTS)
        assert n == m and np.array_equal(got, want)


@pytest.mark.parametrize("h,w,sharded", [(512, 512, True),
                                         (500, 300, False)])
def test_sharded_lossless_two_pass(shard, h, w, sharded):
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    from libjxl_tpu.api import encoder as ref
    from libjxl_tpu.utils.oracle import oracle_available, oracle_decode

    img = _img(1, h, w)
    kw = dict(use_device=True, entropy="prefix-device", group_size_shift=0)
    base = encode_lossless(img, EncodeOptions(**kw), device="cpu")
    shard("shard_encode")
    before = M.shard_groups.calls
    got = encode_lossless(img, EncodeOptions(**kw), device="cpu")
    assert M.shard_groups.calls == before + int(sharded)
    assert got == base
    assert got == ref.encode_lossless(img, ref.EncodeOptions(**kw))
    if oracle_available():
        np.testing.assert_array_equal(oracle_decode(got).pixels, img)
    else:
        from libjxl_torch.api.decoder import decode
        np.testing.assert_array_equal(decode(got, device="cpu"), img)


def _filter_inputs(seed, h, w):
    rng = np.random.default_rng(seed)
    xyb = rng.normal(0, 0.2, (3, h, w)).astype(np.float32)
    yb = -(-h // 8)
    rq = rng.integers(1, 60, (yb, w // 8)).astype(np.int32)
    sh = rng.integers(0, 8, (yb, w // 8)).astype(np.int32)
    return xyb, rq, sh


def _lf(gab, epf_iters, custom=False):
    lf = LoopFilter()
    lf.gab = gab
    lf.epf_iters = epf_iters
    if custom:
        # non-default constants, each exact in float16 as a stream
        # carries them (tests/test_torch_filters.py's "all" variant)
        for k, v in dict(
                gab_custom=True, gab_x_weight1=0.125, gab_x_weight2=0.0625,
                gab_y_weight1=0.09375, gab_y_weight2=0.03125,
                gab_b_weight1=0.25, gab_b_weight2=0.0,
                epf_sharp_custom=True,
                epf_sharp_lut=(0.0, 0.25, 0.375, 0.5, 0.75, 1.0, 1.5, 2.0),
                epf_weight_custom=True, epf_channel_scale=(24.0, 8.0, 2.0),
                epf_sigma_custom=True, epf_quant_mul=0.75,
                epf_pass0_sigma_scale=0.5, epf_pass2_sigma_scale=4.0,
                epf_border_sad_mul=0.5).items():
            setattr(lf, k, v)
    return lf


@pytest.mark.parametrize("gab,epf_iters,custom", [
    (True, 1, False), (False, 2, False), (True, 3, False), (True, 3, True)])
def test_restore_sharded_matches_jax_and_whole_frame(gab, epf_iters, custom):
    from libjxl_tpu.parallel.shard_filters import restore_sharded

    h, w = 8 * 8 * SLOTS, 128
    xyb, rq, sh = _filter_inputs(3 + epf_iters, h, w)
    lf = _lf(gab, epf_iters, custom)
    mesh = M.make_mesh(SLOTS, "cpu")
    before = SF.restore_sharded.calls
    got = SF.restore_sharded(xyb, lf, rq, sh, 0.0009, mesh=mesh)
    assert SF.restore_sharded.calls == before + 1
    whole = FT.restore_device(xyb, lf, rq, sh, 0.0009, fetch=False,
                              device="cpu")
    assert torch.equal(got, whole)
    want = restore_sharded(xyb, lf, rq, sh, 0.0009)
    assert np.abs(got.numpy() - want).max() <= TOL
    # the constants matter: the default filters give another image
    if custom:
        default = FT.restore_device(xyb, _lf(gab, epf_iters), rq, sh,
                                    0.0009, device="cpu")
        assert np.abs(got.numpy() - default).max() > 100 * TOL


# (height, sharded, the reference's padded filters off its own
# whole-frame filters): no pad; a pad of 3 rows, bumped to 67 (shards of
# 72 rows, the last one 5); a pad of 12 (the last shard 52 rows); a pad
# of 1, bumped to 65 (6 shards of 32 rows, the last 31, and 2 slots with
# nothing to filter); too small for the halo (the unsharded
# restore_device). Where H is not a multiple of 8 and the pad reaches
# past the last block, the reference filters a mirror pad whose sigma
# and border planes are not mirrored (edge-padded blocks, 8-periodic
# borders): its last rows move by more than 1e-3. The port filters no
# pad, so it is held to the reference's whole-frame filters.
@pytest.mark.parametrize("h,sharded,ref_off", [
    (512, True, False), (509, True, True), (500, True, False),
    (191, True, True), (60, False, False)])
def test_restore_sharded_padded(h, sharded, ref_off):
    from libjxl_tpu.parallel.shard_filters import restore_sharded_padded
    from libjxl_tpu.render.filters_jax import restore_device

    xyb, rq, sh = _filter_inputs(h, h, 64)
    lf = _lf(True, 3)
    mesh = M.make_mesh(SLOTS, "cpu")
    before = SF.restore_sharded.calls
    got = SF.restore_sharded_padded(xyb, lf, rq, sh, 0.0009, mesh=mesh)
    assert SF.restore_sharded.calls == before + int(sharded)
    whole = FT.restore_device(xyb, lf, rq, sh, 0.0009, fetch=False,
                              device="cpu")
    assert torch.equal(got, whole)
    want = np.asarray(restore_device(xyb, lf, rq, sh, 0.0009))
    assert np.abs(got.numpy() - want).max() <= TOL
    ref = restore_sharded_padded(xyb, lf, rq, sh, 0.0009)
    assert (np.abs(ref - want).max() > 1e-3) == ref_off


def test_exchange_halo_takes_neighbour_rows():
    x = torch.arange(5 * 40 * 2, dtype=torch.float32).reshape(5, 40, 2)
    shards = [x[:, :16], x[:, 16:32], x[:, 32:]]
    out, tops = SF._exchange_halo(shards, 4)
    assert tops == [0, 4, 4]
    assert torch.equal(out[0], x[:, :20])
    assert torch.equal(out[1], x[:, 12:36])
    assert torch.equal(out[2], x[:, 28:])
    # a shorter last shard lends what it has
    out, _ = SF._exchange_halo([x[:, :32], x[:, 32:]], 16)
    assert torch.equal(out[0], x) and torch.equal(out[1], x[:, 16:])


def test_sharded_vardct_encode(shard):
    from libjxl_torch.models.vardct_pipeline import \
        encode_lossy_frame_device_sharded as sharded_encode
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
    from libjxl_tpu.vardct import frame_enc as ref

    img = _img(7, 200, 168)          # partial blocks + partial tiles
    kw = dict(distance=1.0, effort=3, use_device=True)
    base = encode_lossy(img, LossyOptions(**kw), device="cpu")
    shard("shard_encode")
    before = sharded_encode.calls
    got = encode_lossy(img, LossyOptions(**kw), device="cpu")
    assert sharded_encode.calls == before + 1
    assert got == base
    assert got == ref.encode_lossy(img, ref.LossyOptions(**kw))


def test_sharded_decode_equals_resident_decode(shard, monkeypatch):
    from libjxl_torch.api.decoder import decode
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy

    data = encode_lossy(_img(9, 384, 160),
                        LossyOptions(distance=2.0, effort=5))
    monkeypatch.setattr(port_config.config, "device_filters", True)
    base = decode(data, device="cpu")
    shard("shard_decode")
    before = SF.restore_sharded.calls
    got = decode(data, device="cpu")
    assert SF.restore_sharded.calls == before + 1
    np.testing.assert_array_equal(got, base)


def test_dryrun_multichip():
    from libjxl_torch.graft_entry import dryrun_multichip
    before = (M.shard_groups.calls, SF.restore_sharded.calls)
    dryrun_multichip(SLOTS, device="cpu")
    assert M.shard_groups.calls > before[0]
    assert SF.restore_sharded.calls > before[1]
    assert port_config.config.shard_encode is False
    assert port_config.config.mesh_slots is None
