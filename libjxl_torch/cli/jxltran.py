"""jxltran_torch — JPEG XL codestream transcoder (reference
``tools/jxltran.cc:312``): container-level operations that never touch
the entropy-coded payload.

  --pack       wrap a raw codestream into the ISOBMFF container
  --extract    pull the raw codestream out of a container file
  --strip      drop metadata boxes (Exif/XMP/jbrd/...) keeping only the
               image itself (a natural extension the reference handles
               via box filters in JxlEncoderAddBox flows)
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from libjxl_torch.cli import apply_platform_env
    apply_platform_env()
    p = argparse.ArgumentParser(prog="jxltran_torch", description=__doc__)
    p.add_argument("input", help="JPEG XL input file")
    p.add_argument("output", help="JPEG XL output file")
    p.add_argument("--pack", action="store_true",
                   help="pack a codestream into the container format")
    p.add_argument("--extract", action="store_true",
                   help="extract the codestream from a container")
    p.add_argument("--strip", action="store_true",
                   help="remove metadata boxes (Exif/xml /jbrd/jumb)")
    args = p.parse_args(argv)
    if args.pack and args.extract:
        print("--pack and --extract are mutually exclusive",
              file=sys.stderr)
        return 1

    from libjxl_torch.api.container import (
        extract_codestream, is_container, parse_boxes, wrap_container,
    )
    from libjxl_torch.core.fields import FormatError

    with open(args.input, "rb") as f:
        data = f.read()
    try:
        if args.strip:
            cs = extract_codestream(data)
            data = wrap_container(cs) if is_container(data) else cs
        if args.pack:
            if is_container(data):
                print("input is already a container file",
                      file=sys.stderr)
                return 1
            extra = []
            data = wrap_container(data, extra_boxes=extra)
        elif args.extract:
            if not is_container(data):
                print("input is already a raw codestream",
                      file=sys.stderr)
                return 1
            data = extract_codestream(data)
    except FormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"Wrote {len(data)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
