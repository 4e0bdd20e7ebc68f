"""Make the variable-block VarDCT stream fixtures of the PyTorch port's
decode path.

The machine with the card has no JAX, so the port cannot make VarDCT
streams there; these are encoded here by the JAX package's host encoder
and committed. Every stream is a variable-block encode (effort 5 or 7:
merged DCT16-DCT64 and rectangular transforms, and at effort 7 the 8x8
specials IDENTITY, DCT2, DCT4x8/DCT8x4 and AFV) with Gaborish forced on
and its EPF iteration count forced, so the device decode runs the
filter passes the manifest names. ``manifest.json`` lists each stream's
shape, bit depth, effort, (gab, epf_iters), the AC strategy classes it
uses and its sha256.

Run from the repository root (about ten minutes on a CPU, most of it
the effort-7 4K encode; name fixtures to make only those):

    JAX_PLATFORMS=cpu python tests/data/torch_vardct_var/make_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# name: (source, seed, h, w, effort, distance, epf)
SPECS = {
    "photo4k_e5_d1.jxl": ("photo", 10, 2160, 3840, 5, 1.0, 3),
    "photo4k_e5_d2.jxl": ("photo", 11, 2160, 3840, 5, 2.0, 2),
    "photo4k_e7_d1.jxl": ("photo", 12, 2160, 3840, 7, 1.0, 1),
    "ragged_1001x1503_e5.jxl": ("photo", 13, 1001, 1503, 5, 1.0, 3),
    "graphics_256x320_e7.jxl": ("graphics", 1, 256, 320, 7, 2.0, 3),
}
# eight distinct 512x512 streams with one shape and one filter setting
# but different strategy classes: decode_many takes them as one chunk
for _i, (_src, _e, _d) in enumerate(
        (src, e, d) for src in ("photo", "graphics") for e in (5, 7)
        for d in (1.0, 2.0)):
    SPECS[f"mix512_{_src}_e{_e}_d{int(_d)}.jxl"] = (_src, 20 + _i, 512,
                                                     512, _e, _d, 2)
SMALL = ("ragged_1001x1503_e5.jxl",)


def graphics(seed: int, h: int, w: int) -> np.ndarray:
    """Flat rectangles on a light ground with one-pixel strokes: the
    effort-7 strategy search picks the 8x8 specials on such edges."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 245, np.uint8)
    for _ in range(40):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        hh, ww = rng.integers(4, h // 3), rng.integers(4, w // 3)
        img[y0:y0 + hh, x0:x0 + ww] = rng.integers(0, 256, 3)
    for _ in range(60):
        y, x = rng.integers(0, h), rng.integers(0, w - 20)
        img[y, x:x + rng.integers(3, 20)] = 0
        y, x = rng.integers(0, h - 20), rng.integers(0, w)
        img[y:y + rng.integers(3, 20), x] = 0
    return img


def image(name: str) -> np.ndarray:
    """The fixture's source image: ``bench.make_image`` (a gradient plus
    0..7 noise) for a photo, else ``graphics``."""
    from bench import make_image
    source, seed, h, w = SPECS[name][:4]
    return make_image(seed, h, w) if source == "photo" else \
        graphics(seed, h, w)


def encode(name: str) -> bytes:
    """The fixture's stream, from the JAX package's host encoder."""
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
    _, _, _, _, effort, distance, epf = SPECS[name]
    return encode_lossy(image(name), LossyOptions(
        distance=distance, effort=effort, gaborish=1, epf=epf))


def main(names) -> None:
    from libjxl_tpu.api.decoder import _device_decode_inputs
    path = os.path.join(HERE, "manifest.json")
    manifest = {}
    if os.path.exists(path):
        with open(path) as f:
            manifest = json.load(f)
    for name in names:
        _, _, h, w, effort, _, epf = SPECS[name]
        data = encode(name)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        key = _device_decode_inputs(data)[1]
        manifest[name] = dict(h=h, w=w, bits=8, effort=effort, gab=1,
                              epf_iters=epf, classes=list(key[8]),
                              bytes=len(data),
                              sha256=hashlib.sha256(data).hexdigest())
        print(name, len(data), key, flush=True)
        with open(path, "w") as f:
            json.dump({n: manifest[n] for n in SPECS if n in manifest}, f,
                      indent=1)
            f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    import jax
    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:] or list(SPECS))
