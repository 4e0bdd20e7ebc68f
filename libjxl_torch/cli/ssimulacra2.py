"""ssimulacra2_torch — SSIMULACRA 2.1 score CLI (reference
``tools/ssimulacra2_main.cc``)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from libjxl_torch.cli import apply_platform_env
    apply_platform_env()
    p = argparse.ArgumentParser(
        prog="ssimulacra2_torch",
        description="Perceptual quality score: 100 = identical; "
        "negative = extremely distorted. 70+ high, 50+ medium quality.")
    p.add_argument("original")
    p.add_argument("distorted")
    p.add_argument("--bg", type=float, default=0.5,
                   help="background gray level for alpha blending")
    args = p.parse_args(argv)

    from libjxl_torch.extras.io import load_image
    from libjxl_torch.metrics.ssimulacra2 import ssimulacra2

    a = load_image(args.original)
    b = load_image(args.distorted)
    if a.shape[:2] != b.shape[:2]:
        print("image size mismatch", file=sys.stderr)
        return 1
    print(f"{ssimulacra2(a, b, bg=args.bg):.8f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
