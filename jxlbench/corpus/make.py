"""Make the committed decode corpus: the images of ``spec.json`` from the
dead-leaves generator, encoded on the card by the entry and options of
the configuration that ``spec.json`` names (``configs/<config>.json``,
its ``encode``).

Run from the repository root on a machine with a card:
``python3 jxlbench/corpus/make.py``. Writes ``<set>/<name>.jxl`` and
``manifest.json`` (source seed and index, shape, the frame's Gaborish
flag and EPF passes, sha256) beside this file, keeping the 4K set within
the spec's byte cap."""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def main() -> int:
    import torch

    from jxlbench.images import dead_leaves
    from jxlbench.ref.vardct import frame_info
    from jxlbench.registry import resolve_attr
    from libjxl_torch.vardct.frame_enc import LossyOptions

    if not torch.cuda.is_available():
        print("no CUDA card: the corpus is encoded on the card",
              file=sys.stderr)
        return 2
    with open(os.path.join(HERE, "spec.json")) as f:
        spec = json.load(f)
    with open(os.path.join(HERE, "..", "configs",
                           spec["config"] + ".json")) as f:
        enc = json.load(f)["encode"]
    encode = resolve_attr(enc["entry"])
    opts = LossyOptions(**enc["options"])
    manifest = {}
    for set_name, s in spec["sets"].items():
        os.makedirs(os.path.join(HERE, set_name), exist_ok=True)
        imgs = [dead_leaves(s["seed"], i, h, w, spec["content"], "cuda")
                .cpu().numpy() for i, (h, w) in enumerate(s["shapes"])]
        t0 = time.perf_counter()
        streams = encode(imgs, opts, workers=enc["workers"], device="cuda")
        print(f"{set_name}: {len(streams)} streams, "
              f"{sum(map(len, streams))} bytes in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for i, ((h, w), data) in enumerate(zip(s["shapes"], streams)):
            name = f"{set_name}/{set_name}_{i:02d}_{w}x{h}.jxl"
            with open(os.path.join(HERE, name), "wb") as f:
                f.write(data)
            info = frame_info(data)
            manifest[name] = dict(set=set_name, seed=s["seed"], index=i,
                                  h=h, w=w, gab=info["gab"],
                                  epf_iters=info["epf_iters"],
                                  bytes=len(data),
                                  sha256=hashlib.sha256(data).hexdigest())
    # keep the folder under the cap: drop 4K streams from the end
    names_4k = sorted(n for n in manifest if manifest[n]["set"] == "4k")
    while sum(m["bytes"] for m in manifest.values()) > spec["max_bytes"] \
            and len(names_4k) > spec["min_4k"]:
        drop = names_4k.pop()
        os.remove(os.path.join(HERE, drop))
        del manifest[drop]
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    total = sum(m["bytes"] for m in manifest.values())
    print(f"manifest: {len(manifest)} streams, {total} bytes, "
          f"{len(names_4k)} at 4K", flush=True)
    return 0 if total <= spec["max_bytes"] else 1


if __name__ == "__main__":
    sys.exit(main())
