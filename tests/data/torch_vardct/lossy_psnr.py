"""PSNR of the lossy encode that ``chip_smoke.py`` drives, run on the CPU.

The smoke encodes 8 ``bench.make_image`` photos at 3840x2160 (seeds 0-7)
with ``encode_lossy_many(imgs, LossyOptions(distance=1.0, effort=3,
use_device=True))`` and one ragged 1001x1503 image (seed 23) with
``encode_lossy``, decodes the streams on the card and holds each to a
PSNR floor against its input. This script runs the same encode on the
CPU (``device="cpu"``: the same torch program), decodes each stream with
the port's host decoder (float64 filters) and prints each image's PSNR
(8-bit RGB, over all samples) and the lowest, from which the smoke's
floor is set.

Run from the repository root (a few minutes; about 6 GB of memory):

    python tests/data/torch_vardct/lossy_psnr.py
"""

from __future__ import annotations

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

PHOTO_SEEDS = range(8)
RAGGED_SEED = 23


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def _host_psnr(job) -> float:
    from libjxl_torch.api.decoder import decode
    from libjxl_torch.config import config
    config.device_filters = False
    stream, img = job
    return psnr(decode(stream), img)


def main() -> None:
    sys.path.insert(0, os.getcwd())
    from bench import make_image
    from libjxl_torch.vardct.frame_enc import (
        LossyOptions, encode_lossy, encode_lossy_many,
    )
    opts = LossyOptions(distance=1.0, effort=3, use_device=True)
    imgs = [make_image(s, 2160, 3840) for s in PHOTO_SEEDS]
    ragged = make_image(RAGGED_SEED, 1001, 1503)
    streams = encode_lossy_many(imgs, opts, device="cpu")
    streams.append(encode_lossy(ragged, opts, device="cpu"))
    imgs.append(ragged)
    with ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as ex:
        values = list(ex.map(_host_psnr, zip(streams, imgs)))
    names = [f"photo{s}" for s in PHOTO_SEEDS] + ["ragged"]
    for name, s, v in zip(names, streams, values):
        print(f"{name}: {len(s)} bytes, PSNR {v} dB")
    print(f"lowest PSNR {min(values)} dB")


if __name__ == "__main__":
    main()
