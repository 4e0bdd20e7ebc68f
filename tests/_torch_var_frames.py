"""Synthetic variable-block frames for the port's tests: four 256x256
frames whose AC strategy classes cover all 27 strategies, from a seed;
and the port's sparse classes in the JAX package's dense form. Imports
no JAX, so the card tests use it too."""
import os

import numpy as np

from libjxl_torch.api.decoder import _device_decode_inputs
from libjxl_torch.models.vardct_decode import FrameReconVar
from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sparse(q, qf, fy, fx):
    flat = q.ravel()
    idx = np.flatnonzero(flat)
    return flat[idx], idx, qf, fy, fx


def _tile(rng, grid: int, first: list, fill: list):
    """Anchors (s, by, bx) tiling a grid x grid block frame: each of
    ``first`` at its first free raster position, then ``fill`` at random."""
    free = np.ones((grid, grid), bool)
    out = []

    def place(s, by, bx):
        h, w = COVERED_Y[s], COVERED_X[s]
        if by + h > grid or bx + w > grid or \
                not free[by:by + h, bx:bx + w].all():
            return False
        free[by:by + h, bx:bx + w] = False
        out.append((s, by, bx))
        return True

    for s in first:
        assert any(place(s, by, bx) for by in range(grid)
                   for bx in range(grid)), s
    for by in range(grid):
        for bx in range(grid):
            while free[by, bx]:
                place(int(rng.choice(fill)), by, bx)
    return out


SMALL8 = [0, 1, 2, 3, 12, 13, 14, 15, 16, 17]
TILINGS = [
    [24],                    # DCT256X256: the whole frame
    [25, 25],                # DCT256X128 side by side
    [26, 26],                # DCT128X256 stacked
    [21, 22, 23, 18, 19, 20, 5, 10, 11, 4, 6, 7, 8, 9] + SMALL8,
]


def dense_class(s: int, entry: tuple) -> tuple:
    """The reference's (q, qf, fy, fx) of the port's sparse class entry
    (vals, idx, qf, fy, fx) of strategy ``s``."""
    vals, idx, qf, fy, fx = entry
    q = np.zeros(len(qf) * 3 * COVERED_X[s] * COVERED_Y[s] * 64, vals.dtype)
    q[idx] = vals
    return q.reshape(len(qf), 3, -1), qf, fy, fx


def reference_dict(frame: FrameReconVar) -> dict:
    """The JAX package's per-frame dict of a ``FrameReconVar``."""
    d = frame._asdict()
    d["classes"] = {s: dense_class(s, e) for s, e in frame.classes.items()}
    return d


def synthetic_frames(seed: int = 7, grid: int = 32):
    """Four 256x256 frames, one per tiling, with the quantizer, CfL and
    filter fields of a real stream and random coefficients, as
    ``FrameReconVar`` (``reference_dict`` gives the JAX package's dict)."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(REPO, "tests", "data", "torch_vardct_var",
                           "graphics_256x320_e7.jxl"), "rb") as f:
        base = _device_decode_inputs(f.read())[0]
    frames = []
    for first in TILINGS:
        anchors = _tile(rng, grid, first, SMALL8 + [4, 6, 7])
        raw_quant = np.zeros((grid, grid), np.int32)
        classes: dict = {}
        for s, by, bx in anchors:
            h, w = COVERED_Y[s], COVERED_X[s]
            qf = int(rng.integers(1, 40))
            raw_quant[by:by + h, bx:bx + w] = qf
            size = h * w * 64
            # mostly zeros, with +-1 and +-2 where the bias matters
            q = rng.integers(-4, 5, (3, size)) * (rng.random((3, size))
                                                  < 0.3)
            e = classes.setdefault(s, [[], [], [], []])
            e[0].append(q.astype(np.int16))
            e[1].append(qf)
            e[2].append(by)
            e[3].append(bx)
        dc = np.stack([
            rng.uniform(-0.01, 0.01, (grid, grid)),
            rng.uniform(0.2, 0.6, (grid, grid)),
            rng.uniform(0.2, 0.6, (grid, grid))]).astype(np.float32)
        t = grid // 8
        frames.append(FrameReconVar(
            classes={s: _sparse(np.stack(v[0]), *(np.asarray(a, np.int32)
                                                  for a in v[1:]))
                     for s, v in classes.items()},
            dc=dc, raw_quant=raw_quant,
            sharpness=rng.integers(0, 8, (grid, grid)).astype(np.int32),
            x_cc=rng.uniform(-0.1, 0.1, (t, t)).astype(np.float32),
            b_cc=rng.uniform(0.5, 1.2, (t, t)).astype(np.float32),
            inv_gs=base.inv_gs, dms=base.dms, quant_scale=base.quant_scale,
            intensity=base.intensity))
    strategies = {s for f in frames for s in f.classes}
    assert strategies == set(range(27))
    return frames
