"""The port's twin of the repo's ``__graft_entry__.entry()``: one encode
step of the codec's device half on a batch of groups.

* the VarDCT step (``models/vardct_pipeline.vardct_encode_device``):
  sRGB -> XYB, the 8x8 DCT as two GEMMs, quantization;
* the modular lossless step (``models/lossless.encode_groups_device``):
  YCoCg RCT, clamped-gradient residuals, packing, token histogram.

Run it as ``fn(*example_args)`` with ``fn, example_args = entry()``.
"""

from __future__ import annotations

import numpy as np
import torch

from libjxl_torch.config import resolve_device


def entry(device=None):
    """Returns (fn, example_args): ``fn(groups, h, w)`` runs both steps on
    the groups' device and returns (q_ac, q_dc, payload, wide); the
    example is the seed-0 (4, 3, 256, 256) int32 groups of a 512x512
    image on ``device`` (default ``config.device``)."""
    from libjxl_torch.models.lossless import encode_groups_device
    from libjxl_torch.models.vardct_pipeline import vardct_encode_device
    from libjxl_torch.vardct.quant_weights import DequantMatrices

    dev = resolve_device(device)
    table = DequantMatrices().tables[0].reshape(3, 64)
    dequant_step = torch.tensor(table / 64.0, dtype=torch.float32,
                                device=dev)
    inv_dc_step = torch.tensor([512.0, 2048.0, 1024.0], dtype=torch.float32,
                               device=dev)

    def fn(groups, h, w):
        q_ac, q_dc = vardct_encode_device(groups.to(torch.uint8),
                                          dequant_step, inv_dc_step)
        payload, wide = encode_groups_device(groups, h, w, gx=2,
                                             use_rct=True)
        # the reference's out16 layout: the low 16 bits as uint16
        return q_ac, q_dc, payload, (wide & 0xFFFF).to(torch.uint16)

    rng = np.random.default_rng(0)
    groups = torch.tensor(rng.integers(0, 256, (4, 3, 256, 256)),
                          dtype=torch.int32, device=dev)
    return fn, (groups, 512, 512)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The twin of ``__graft_entry__.dryrun_multichip``: the production
    multi-device steps on an ``n_devices``-slot mesh of ``device``
    (default ``config.device``; the slots are dealt over its visible
    devices, so one card or the CPU holds them all), each against its
    unsharded run at tiny shapes:

    * the two-pass lossless encode (``encode_lossless``, prefix-device)
      with the group axis sharded (``config.shard_encode``): the same
      bytes, decoded exactly;
    * the halo-exchange filters (``parallel/shard_filters``): the
      whole-frame filters' output bit for bit;
    * the sharded VarDCT encode (row bands, one a slot): the same bytes;
    * ``decode()`` with its filters row-sharded (``config.shard_decode``):
      the same pixels.

    Raises AssertionError on a difference, or when a sharded branch did
    not run."""
    from libjxl_torch.api.decoder import decode
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    from libjxl_torch.config import config
    from libjxl_torch.core.frame_header import LoopFilter
    from libjxl_torch.models.vardct_pipeline import \
        encode_lossy_frame_device_sharded
    from libjxl_torch.parallel.mesh import make_mesh, shard_groups
    from libjxl_torch.parallel.shard_filters import restore_sharded
    from libjxl_torch.render.filters_torch import restore_device
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy

    dev = resolve_device(device)
    mesh = make_mesh(n_devices, dev)
    if mesh.size < 2:
        raise ValueError(f"a dry run needs 2 slots or more, got {mesh.size}")
    rng = np.random.default_rng(0)

    def smooth(h, w):
        return np.clip(np.cumsum(rng.integers(-3, 4, (h, w, 3)), axis=1),
                       0, 255).astype(np.uint8)

    saved = (config.shard_encode, config.shard_decode, config.mesh_slots,
             config.device_filters)

    def both(flag: str, fn, counter):
        """(unsharded, sharded) results of ``fn()``, and whether the
        sharded run went through ``counter``'s branch."""
        setattr(config, flag, False)
        base = fn()
        setattr(config, flag, True)
        before = counter.calls
        sharded = fn()
        if counter.calls == before:
            raise AssertionError(f"{flag}: the sharded branch did not run")
        return base, sharded

    try:
        config.mesh_slots = n_devices
        # lossless: 128px groups (group_size_shift=0), n of them
        img = smooth(128, 128 * n_devices)
        opts = EncodeOptions(use_device=True, entropy="prefix-device",
                             group_size_shift=0)
        base, sharded = both("shard_encode", lambda: encode_lossless(
            img, opts, device=dev), shard_groups)
        assert base == sharded, "sharded lossless stream differs"
        assert np.array_equal(decode(sharded, device=dev), img)

        # the halo-exchange filters (decode side, rows sharded)
        h, w = 8 * 8 * n_devices, 64
        xyb = rng.normal(0, 0.2, (3, h, w)).astype(np.float32)
        rq = rng.integers(1, 60, (h // 8, w // 8)).astype(np.int32)
        shp = rng.integers(0, 8, (h // 8, w // 8)).astype(np.int32)
        lf = LoopFilter()
        lf.gab = True
        lf.epf_iters = 2
        out = restore_sharded(xyb, lf, rq, shp, 0.0009, mesh=mesh)
        whole = restore_device(xyb, lf, rq, shp, 0.0009, fetch=False,
                               device=mesh.slots[0])
        assert torch.equal(out, whole), "sharded filters differ"

        # the VarDCT encode, row bands one a slot
        vimg = smooth(24 * n_devices, 168)
        vopts = LossyOptions(distance=1.0, effort=3, use_device=True)
        base, sharded = both("shard_encode", lambda: encode_lossy(
            vimg, vopts, device=dev), encode_lossy_frame_device_sharded)
        assert base == sharded, "sharded VarDCT stream differs"

        # decode() with row-sharded restoration filters
        data = encode_lossy(smooth(16 * 8 * max(2, n_devices), 160),
                            LossyOptions(distance=2.0, effort=5))
        config.device_filters = True
        base, sharded = both("shard_decode", lambda: decode(
            data, device=dev), restore_sharded)
        assert np.array_equal(base, sharded), "sharded decode differs"
    finally:
        (config.shard_encode, config.shard_decode, config.mesh_slots,
         config.device_filters) = saved
