"""Make the JPEG files that the card runs recompress (the card machine
has no PIL, so nothing there can write a JPEG).

Four 1024x768 JPEGs of the kinds ``tests/test_jpeg.py`` covers, each a
``bench.make_image`` photo (seeds 30-33) smoothed by a radius-1 gaussian
blur: baseline 4:2:0, progressive 4:2:0, 4:4:4 with a restart marker
every 8 MCUs, and gray. Writes them beside this script with
``manifest.json`` (kind, size, sha256 of each file). Run from the
repository root, where PIL is installed:

    python tests/data/torch_cli/make_jpegs.py
"""
import hashlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from bench import make_image  # noqa: E402
from PIL import Image, ImageFilter  # noqa: E402

H, W = 768, 1024
KINDS = {
    "baseline_420.jpg": dict(quality=85, subsampling=2),
    "progressive_420.jpg": dict(quality=80, subsampling=2,
                                progressive=True),
    "restart_444.jpg": dict(quality=90, subsampling=0,
                            restart_marker_blocks=8),
    "gray.jpg": dict(quality=85, gray=True),
}


def main() -> None:
    manifest = {}
    for seed, (name, kw) in enumerate(KINDS.items(), start=30):
        kw = dict(kw)
        gray = kw.pop("gray", False)
        img = Image.fromarray(make_image(seed, H, W)).filter(
            ImageFilter.GaussianBlur(1))
        if gray:
            img = img.convert("L")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", **kw)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = dict(seed=seed, h=H, w=W, gray=gray, **kw,
                              bytes=len(data),
                              sha256=hashlib.sha256(data).hexdigest())
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
