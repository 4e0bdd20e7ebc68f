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
