"""Run one cell of BENCHMARK.json once and print its result line.

    python3 jxlbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m jxlbench.run`` works too.) Exits with 2 and prints no
result where no CUDA card is present or fewer than the cell asks for;
with 3 where a forbidden package (jax, jaxlib, flax, libjxl_tpu) was
loaded. The last line of standard output is the result; the numbers the
check compared, each with its limit, are the last lines of standard
error and the last key of the result."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _use_checkout_caches() -> None:
    """Kernel build caches at fixed paths inside the checkout (the port
    builds its own kernels into ``libjxl_torch/build/`` already)."""
    base = os.path.join(ROOT, ".jxlbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    _use_checkout_caches()
    from jxlbench import registry

    cell = registry.resolve(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from jxlbench import guard
    from jxlbench.harness import run_cell

    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda")
    result["device"]["power_limit"] = power_limit()
    print(f"{result['calls']} calls in the window, "
          f"{result['attempted']} items, {result['failed']} failed; "
          f"call ms {result['call_ms']}", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}",
              file=sys.stderr)
    sys.stderr.flush()
    # last, after the window, the readers, the check and the close: what
    # any of them loaded is in sys.modules now
    bad = guard.forbidden_loaded()
    if bad:
        print("forbidden packages loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
