"""Host decode for the port (``libjxl_tpu/api/decoder.py``).

The port encodes on the device and decodes on the host: ``decode`` is
``libjxl_tpu``'s jax-free host decoder. ``decode_exact`` checks many
streams against their images in spawned worker processes, because the
decoder reads prefix-coded modular streams symbol by symbol in Python
(several microseconds a symbol).
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from libjxl_tpu.api.decoder import decode


def _decodes_exactly(job) -> bool:
    stream, img = job
    out = decode(stream)
    return out.size == img.size and np.array_equal(out.reshape(img.shape),
                                                   img)


def decode_exact(streams, images, workers: int = 4) -> list:
    """One bool per stream: does ``decode`` give back its image exactly.
    Runs in up to ``workers`` spawned processes."""
    jobs = list(zip(streams, images))
    with ProcessPoolExecutor(
            max_workers=max(1, min(workers, len(jobs))),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_decodes_exactly, jobs))
