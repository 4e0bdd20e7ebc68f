"""Make ``reference_grids.npz``: the plain reference's decode of every
corpus stream, kept on the check's grid (``drivers/decode_batch.GRID``:
one sample in 13 x 13), so that the check can hold every frame of a
window to the reference without decoding each again.

Run from the repository root after ``make.py`` (numpy only, no card;
a few minutes a 4K stream, one process a stream):
``python3 jxlbench/corpus/reference.py [--jobs N]``."""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def grid_of(name: str) -> tuple[str, np.ndarray]:
    from jxlbench.drivers.decode_batch import GRID
    from jxlbench.ref.vardct import decode_region, frame_info

    with open(os.path.join(HERE, name), "rb") as f:
        data = f.read()
    info = frame_info(data)
    px, box = decode_region(data, 0, 0, info["xgroups"], info["ygroups"])
    if box != (0, info["h"], 0, info["w"]) or px.shape[:2] != box[1::2]:
        raise AssertionError(f"{name}: the whole frame was not decoded")
    return name, px[GRID].copy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--jobs", type=int, default=4)
    args = p.parse_args(argv)
    with open(os.path.join(HERE, "manifest.json")) as f:
        names = sorted(json.load(f))
    # largest first, so the pool ends together
    names.sort(key=lambda n: -os.path.getsize(os.path.join(HERE, n)))
    grids = {}
    with ProcessPoolExecutor(args.jobs) as ex:
        for name, g in ex.map(grid_of, names):
            grids[name] = g
            print(name, g.shape, flush=True)
    np.savez_compressed(os.path.join(HERE, "reference_grids.npz"), **grids)
    return 0


if __name__ == "__main__":
    sys.exit(main())
