"""The check's control: a run whose outputs must come out as not correct.

Each loop driver's ``control(run, grid)`` gives the numbers:
* decode cells (``decode_batch``): the plain reference computed in TF32
  (float32 with 10 mantissa bits, the precision below the configuration's
  float32 with TF32 off) stands in the program's place; each stage's
  output is rounded to TF32 (``ref/vardct.tf32``). Numpy only.
* lossless cells (``encode_lossless_batch``): the guarantee is broken:
  the program encodes each image with its lowest bit cleared, and the
  streams are held to the images as made. Runs the program.

    python3 jxlbench/control.py --workload <cell> --seeds 11,12,13 [--grid]

prints each seed's numbers beside their limits (``--grid``: the decode
control over whole frames on the check's grid, a few minutes a 4K
frame) and exits with 0 when the control failed the check on every
seed."""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_run(cell, seed: int, device: str, grid: bool = False) -> list:
    from jxlbench.harness import Run

    run = Run(cell=cell, seed=seed, seconds=0, trace=False, device=device)
    return cell.driver().control(run, grid)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the check's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--grid", action="store_true")
    args = p.parse_args(argv)
    from jxlbench import registry

    cell = registry.resolve(args.workload)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = control_run(cell, seed, args.device, args.grid)
        ok = all(c.value <= c.limit for c in checks)
        failed_all &= not ok
        print(f"control {args.workload} seed {seed}: " + ", ".join(
            f"{c.name} {c.value!r} limit {c.limit!r}" for c in checks) +
            (" -> passes (the control must fail)" if ok else " -> fails"),
            flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
