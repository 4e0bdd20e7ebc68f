"""Make the VarDCT stream fixtures of the PyTorch port's decode path.

The machine with the card has no JAX, so the port cannot make VarDCT
streams there; these are encoded here by the JAX package's host encoder
and committed. Every stream is DCT8 4:4:4 (effort 3) with Gaborish
forced on, so the device decode runs Gaborish and the EPF passes its
key names. ``manifest.json`` lists each stream's shape, bit depth,
(gab, epf_iters) key and sha256.

Run from the repository root (about a minute on a CPU):

    JAX_PLATFORMS=cpu python tests/data/torch_vardct/make_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# name: (seed, h, w, bits, LossyOptions fields)
SPECS = {
    "photo4k_d1_a.jxl": (0, 2160, 3840, 8, dict(distance=1.0, epf=3)),
    "photo4k_d1_b.jxl": (1, 2160, 3840, 8, dict(distance=1.0, epf=3)),
    "photo4k_d2_a.jxl": (2, 2160, 3840, 8, dict(distance=2.0, epf=2)),
    "photo4k_d2_b.jxl": (3, 2160, 3840, 8, dict(distance=2.0, epf=2)),
    "ragged_1001x1503.jxl": (4, 1001, 1503, 8, dict(distance=1.0, epf=3)),
    "rgb16_301x517.jxl": (5, 301, 517, 16, dict(distance=1.0, epf=2)),
}
SMALL = ("ragged_1001x1503.jxl", "rgb16_301x517.jxl")


def image(name: str) -> np.ndarray:
    """The fixture's source image: ``bench.make_image`` (a gradient plus
    0..7 noise), widened to 16 bits with 8 bits of noise below."""
    from bench import make_image
    seed, h, w, bits, _ = SPECS[name]
    img = make_image(seed, h, w)
    if bits == 16:
        rng = np.random.default_rng(seed)
        img = img.astype(np.uint16) * 256 + rng.integers(
            0, 256, img.shape, dtype=np.uint16)
    return img


def encode(name: str) -> bytes:
    """The fixture's stream, from the JAX package's host encoder."""
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
    opts = LossyOptions(effort=3, gaborish=1, **SPECS[name][4])
    return encode_lossy(image(name), opts)


def main() -> None:
    manifest = {}
    for name, (seed, h, w, bits, opts) in SPECS.items():
        data = encode(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = dict(h=h, w=w, bits=bits, gab=1,
                              epf_iters=opts["epf"], bytes=len(data),
                              sha256=hashlib.sha256(data).hexdigest())
        print(name, len(data), flush=True)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    import jax
    jax.config.update("jax_platforms", "cpu")
    main()
