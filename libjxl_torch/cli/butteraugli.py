"""butteraugli_torch — perceptual distance CLI (reference
``tools/butteraugli_main.cc``)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from libjxl_torch.cli import apply_platform_env
    apply_platform_env()
    p = argparse.ArgumentParser(prog="butteraugli_torch")
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("--pnorm", type=float, default=3.0)
    p.add_argument("--intensity_target", type=float, default=80.0)
    p.add_argument("--distmap", help="save distance map as .npy")
    args = p.parse_args(argv)

    import numpy as np

    from libjxl_torch.color.xyb import srgb_to_linear
    from libjxl_torch.extras.io import load_image
    from libjxl_torch.metrics.butteraugli import (
        butteraugli_diffmap, compute_distance_p,
    )

    a_u8 = load_image(args.image1)[:, :, :3]
    b_u8 = load_image(args.image2)[:, :, :3]
    if a_u8.shape != b_u8.shape:
        print("image size mismatch", file=sys.stderr)
        return 1
    a = srgb_to_linear(np.moveaxis(a_u8, -1, 0).astype(np.float64) / 255)
    b = srgb_to_linear(np.moveaxis(b_u8, -1, 0).astype(np.float64) / 255)
    # the diffmap comes back as a tensor on config.device: fetch it
    dm = butteraugli_diffmap(
        a.astype(np.float32), b.astype(np.float32),
        intensity_target=args.intensity_target).cpu().numpy()
    print(f"{compute_distance_p(dm, args.pnorm):.6f}")
    print(f"max norm: {dm.max():.6f}", file=sys.stderr)
    if args.distmap:
        np.save(args.distmap, dm)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
