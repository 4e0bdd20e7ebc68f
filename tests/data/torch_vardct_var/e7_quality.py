"""PSNR and butteraugli distance of the effort 5-7 lossy encodes that
``chip_smoke.py``'s e7 phase drives, run on the CPU.

The smoke encodes the jobs of ``chip_smoke.E7_JOBS`` (three 3840x2160
``bench.make_image`` photos at distance 1 and 2, effort 7 and 5, and a
ragged 1001x1503 image at distance 5, effort 7) with ``use_device=True``
on the card, decodes the streams on the card and holds each to a PSNR
floor and a butteraugli ceiling. This script runs the same encodes on
the CPU (``device="cpu"``: the same torch program), decodes each stream
with the port's host decoder (float64 filters) and prints, per job, the
stream's size, its PSNR (8-bit RGB, over all samples) and the port's
butteraugli distance of the decode (on the CPU), from which the smoke's
floors and ceilings are set.

Run from the repository root on a machine with 8 cores and some 30 GB
of memory (about ten minutes); it uses no card:

    python tests/data/torch_vardct_var/e7_quality.py
"""

from __future__ import annotations

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def _job(args):
    name, seed, h, w, d, effort = args
    from bench import make_image
    from chip_smoke import psnr
    from libjxl_torch.api.decoder import decode
    from libjxl_torch.config import config
    from libjxl_torch.metrics.butteraugli import butteraugli_distance_srgb
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy

    config.device_filters = False
    img = make_image(seed, h, w)
    data = encode_lossy(img, LossyOptions(distance=d, effort=effort,
                                          use_device=True), device="cpu")
    out = decode(data)[:, :, :3]
    return (name, len(data), psnr(out, img),
            butteraugli_distance_srgb(img, out, device="cpu"))


def main() -> None:
    sys.path.insert(0, os.getcwd())
    from chip_smoke import E7_JOBS
    with ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as ex:
        rows = list(ex.map(_job, E7_JOBS))
    for name, size, p, dist in rows:
        print(f"{name}: {size} bytes, PSNR {p} dB, butteraugli {dist}")
    print("floors (PSNR dB, butteraugli):",
          {name: (p, dist) for name, _, p, dist in rows})
    print(f"lowest PSNR {min(r[2] for r in rows)}; "
          f"highest butteraugli {max(r[3] for r in rows)}; "
          f"numpy {np.__version__}")


if __name__ == "__main__":
    main()
