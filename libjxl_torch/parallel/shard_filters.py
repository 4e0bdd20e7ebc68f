"""Sharded restoration filters with a halo exchange (port of
``libjxl_tpu/parallel/shard_filters.py``).

The decode render pipeline's cross-group border problem
(low_memory_render_pipeline.h:62-84, dec_group_border.h:19) maps to a
row-sharded image on a mesh: each shard needs HALO rows of its vertical
neighbours before running the Gaborish + EPF stencils. The neighbours'
rows are copied onto the shard's device (the reference's
``jax.lax.ppermute`` ring), each widened shard runs the whole-frame
filters (``render/filters_torch.restore``: the Gaborish/EPF kernels on a
CUDA device, their plain versions on the CPU), and the halo is cropped.

The frame's own edges are not padded: the first shard takes no rows
above it and the last none below, so the kernels mirror each pass at the
frame edge exactly as the whole-frame run does, and the output is that
run's bit for bit. (The reference gives the boundary shards a mirror of
their own edge rows; filtering a mirror sums each pixel's neighbours in
the other order, which moves the rows next to the edge by an ulp.)
"""

from __future__ import annotations

import numpy as np
import torch

HALO = 16  # rows: covers gaborish(1) + EPF0(3) + EPF1(2) + EPF2(1)
#            rounded to 2 block rows so the sigma plane shards evenly


def _exchange_halo(shards: list, halo: int = HALO) -> tuple:
    """Widen each (..., rows, W) shard by ``halo`` rows of its vertical
    neighbours, copied onto its device: the bottom rows of the shard
    above and the top rows of the shard below (fewer where that shard is
    the frame's last and shorter). The first shard gets nothing above
    and the last nothing below: the frame edge stays the shard's edge.
    Returns (widened shards, rows added above each)."""
    out, tops = [], []
    for i, x in enumerate(shards):
        parts = [x]
        top = 0
        if i > 0:
            above = shards[i - 1][..., -halo:, :].to(x.device)
            parts.insert(0, above)
            top = above.shape[-2]
        if i + 1 < len(shards):
            parts.append(shards[i + 1][..., :halo, :].to(x.device))
        out.append(torch.cat(parts, dim=-2) if len(parts) > 1 else x)
        tops.append(top)
    return out, tops


def restore_sharded_padded(xyb, lf, raw_quant, epf_sharpness,
                           quant_scale: float, mesh=None) -> torch.Tensor:
    """restore_sharded for arbitrary heights, with the reference's shard
    layout: H padded to a multiple of 8*n (a 1-3 row pad bumped by one
    8*n step), one shard per slot of the padded height. The pad itself
    is not filtered: the shard that holds the frame's last row ends
    there (shards wholly inside the pad hold nothing and launch
    nothing). Images too small for the halo (H + pad < HALO * n) or for
    the pad (pad > H) are filtered whole on the mesh's first slot
    (``restore_device``'s run), where the reference runs its
    single-device filters. Returns the (3, H, W) float32 result on the
    mesh's first slot."""
    from libjxl_torch.parallel.mesh import make_mesh

    mesh = mesh or make_mesh()
    n = mesh.size
    h = xyb.shape[1]
    step = 8 * n
    p = (-h) % step
    if 0 < p < 4:
        p += step
    rows = h if h + p < HALO * n or p > h else (h + p) // n
    return _restore_rows(xyb, lf, raw_quant, epf_sharpness, quant_scale,
                         mesh, rows)


def restore_sharded(xyb, lf, raw_quant, epf_sharpness, quant_scale: float,
                    mesh=None) -> torch.Tensor:
    """Run Gaborish + EPF with the image row-sharded over ``mesh``
    (default: one slot per visible device of ``config.device``).

    xyb: (3, H, W) with H a multiple of 8*n_slots (callers pad);
    raw_quant/epf_sharpness: (H/8, W/8) block planes; numpy, or tensors
    on any device. Returns the (3, H, W) float32 result, concatenated on
    the mesh's first slot."""
    from libjxl_torch.parallel.mesh import make_mesh

    mesh = mesh or make_mesh()
    n = mesh.size
    if xyb.shape[1] % (8 * n):
        raise ValueError(f"pad H ({xyb.shape[1]}) to a multiple of 8*{n}")
    return _restore_rows(xyb, lf, raw_quant, epf_sharpness, quant_scale,
                         mesh, xyb.shape[1] // n)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))


def _restore_rows(xyb, lf, raw_quant, epf_sharpness, quant_scale: float,
                  mesh, rows: int) -> torch.Tensor:
    """The filters of the rows ``[i*rows, (i+1)*rows)`` of the frame on
    slot ``i`` (``rows`` a multiple of 8, or H: one shard), cut at the
    frame's last row. Every shard starts at a multiple of 8 rows, so its
    block sigma field and its 8-periodic ``sad_mul`` border plane equal
    the global ones. ``restore_sharded.calls`` counts the runs of more
    than one shard."""
    from libjxl_torch.render.filters_torch import lf_params, restore

    h = xyb.shape[1]
    bounds = [(a, min(a + rows, h)) for a in range(0, h, rows)]
    if len(bounds) > mesh.size:
        raise ValueError(f"{len(bounds)} row shards for {mesh.size} slots")
    slots = mesh.slots[:len(bounds)]
    x = _tensor(xyb).to(torch.float32)
    rq, shp = _tensor(raw_quant), _tensor(epf_sharpness)
    # block-unit planes: halo in block rows (HALO pixel rows / 8)
    blk = [(a // 8, -(-b // 8)) for a, b in bounds]
    xs, tops = _exchange_halo([x[:, a:b].to(s)
                               for (a, b), s in zip(bounds, slots)])
    rqs, _ = _exchange_halo([rq[a:b].to(s) for (a, b), s in zip(blk, slots)],
                            HALO // 8)
    shs, _ = _exchange_halo([shp[a:b].to(s)
                             for (a, b), s in zip(blk, slots)], HALO // 8)
    restore_sharded.calls += int(len(bounds) > 1)
    out = []
    for (a, b), s, xw, r, sh, top in zip(bounds, slots, xs, rqs, shs, tops):
        f = restore(xw.contiguous(), r.contiguous(), sh.contiguous(),
                    float(quant_scale), lf_params(lf, s), bool(lf.gab),
                    int(lf.epf_iters))
        out.append(f[:, top:top + b - a].to(slots[0]))
    return torch.cat(out, dim=1)


restore_sharded.calls = 0
