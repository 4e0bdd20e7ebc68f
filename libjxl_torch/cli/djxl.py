"""djxl_torch — JPEG XL decoder CLI (reference ``tools/djxl_main.cc``)."""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    from libjxl_torch.cli import apply_platform_env
    apply_platform_env()
    p = argparse.ArgumentParser(prog="djxl_torch",
                                description="JPEG XL decoder (PyTorch, CUDA)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--num_reps", type=int, default=1)
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    from libjxl_torch.api.decoder import decode
    from libjxl_torch.extras.io import save_image

    with open(args.input, "rb") as f:
        data = f.read()

    # .jpg output = byte-exact JPEG reconstruction (djxl_main.cc)
    if args.output.lower().endswith((".jpg", ".jpeg")):
        from libjxl_torch.jpeg.transcode import decode_to_jpeg
        t0 = time.perf_counter()
        jpg = decode_to_jpeg(data)
        dt = time.perf_counter() - t0
        with open(args.output, "wb") as f:
            f.write(jpg)
        if not args.quiet:
            print(f"Reconstructed original JPEG ({len(jpg)} bytes) in "
                  f"{dt * 1000:.1f} ms", file=sys.stderr)
        return 0

    t0 = time.perf_counter()
    for _ in range(args.num_reps):
        img = decode(data)
    dt = (time.perf_counter() - t0) / args.num_reps
    save_image(args.output, img)
    if not args.quiet:
        h, w = img.shape[:2]
        print(f"Decoded {w}x{h} in {dt * 1000:.1f} ms "
              f"({h * w / dt / 1e6:.2f} MP/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
