"""Make one set of the decode corpus that has a folder of its own: its
streams, ``manifest.json`` and ``reference_grids.npz``, from the set's
``spec.json`` (``jxlbench/corpus/<set>/spec.json``).

The spec names the configuration whose ``encode`` makes the streams
(``configs/<config>.json``), the images (seeded dead-leaves photos of
``jxlbench/images.py`` with the spec's ``content``, at ``shapes``, made
on ``device``), the reference whose ``decode_region`` makes the grids,
and a byte cap. Two kinds of ``encode``:

* ``"source": "jpeg"``: each image becomes a 4:2:0 baseline JPEG at the
  spec's ``qualities`` as libjpeg-turbo makes it (``jpeg_writer.py``,
  numpy), and the entry recompresses it (``encode_jpeg``) on the CPU,
  one process a stream. The JPEGs are not kept.
* otherwise the entry encodes the images with the configuration's
  ``options`` on the card (``encode_lossy_many``), as ``make.py`` does.

A set whose spec says ``"made_at_setup": true`` commits only its
manifest and grids: ``decode_set.py`` makes its streams anew in every
run's set-up (``setup_streams``) and holds each to its sha256.

    python3 jxlbench/corpus/make_set.py <set> [--out DIR] [--jobs N]
        [--grids-only]

``--out`` writes the manifest and the grids (and the streams of a set
that commits them) elsewhere, for instance a card machine's output
folder; ``--grids-only`` makes the grids of the set's committed streams
(the reference is numpy and torch on the CPU, one process a stream, a
few minutes a 12-megapixel stream)."""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# spawned, not forked: the parent may hold torch's threads
_SPAWN = mp.get_context("spawn")


def load_spec(set_dir: str) -> dict:
    with open(os.path.join(set_dir, "spec.json")) as f:
        return json.load(f)


def _config(spec: dict) -> dict:
    with open(os.path.join(ROOT, "jxlbench", "configs",
                           spec["config"] + ".json")) as f:
        return json.load(f)


def stream_name(spec: dict, i: int, h: int, w: int) -> str:
    tag = f"q{spec['qualities'][i]:02d}_" if "qualities" in spec else ""
    return f"{spec['prefix']}_{i:02d}_{tag}{w}x{h}.jxl"


def _jpeg_job(args) -> bytes:
    """Stream ``i`` of a JPEG set: its image (made here where ``img`` is
    None), the JPEG, the recompression."""
    spec, i, img = args
    from jxlbench.corpus.jpeg_writer import baseline_jpeg
    from jxlbench.registry import resolve_attr

    if spec["subsampling"] != 2:
        raise ValueError("the JPEG writer makes 4:2:0 (subsampling 2) only")
    if img is None:
        import torch

        from jxlbench.images import dead_leaves
        torch.set_num_threads(1)
        h, w = spec["shapes"][i]
        img = dead_leaves(spec["seed"], i, h, w, spec["content"],
                          "cpu").numpy()
    encode = resolve_attr(_config(spec)["encode"]["entry"])
    return encode(baseline_jpeg(img, spec["qualities"][i]))


def small_stream(spec: dict, h: int, w: int) -> bytes:
    """One stream of a JPEG set's kind at (h, w), made in this process on
    the CPU: image 0 of the spec's seed at that shape, as a JPEG at the
    spec's first quality, recompressed."""
    from jxlbench.images import dead_leaves

    img = dead_leaves(spec["seed"], 0, h, w, spec["content"], "cpu").numpy()
    return _jpeg_job((dict(spec, shapes=[[h, w]]), 0, img))


def _images(spec: dict, device: str) -> list:
    """The set's images, (h, w, 3) uint8 numpy, made on ``device``."""
    import torch

    from jxlbench.images import dead_leaves
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA card: this set's images are made on "
                         f"{device}")
    return [dead_leaves(spec["seed"], i, h, w, spec["content"], device)
            .cpu().numpy() for i, (h, w) in enumerate(spec["shapes"])]


def make_streams(spec: dict, jobs: int) -> list:
    enc = _config(spec)["encode"]
    n = len(spec["shapes"])
    device = spec.get("device", "cpu")
    if enc.get("source") == "jpeg":
        imgs = [None] * n if device == "cpu" else _images(spec, device)
        with ProcessPoolExecutor(min(jobs, n), mp_context=_SPAWN) as ex:
            return list(ex.map(_jpeg_job,
                               [(spec, i, im) for i, im in enumerate(imgs)]))
    from jxlbench.registry import resolve_attr
    from libjxl_torch.vardct.frame_enc import LossyOptions

    encode = resolve_attr(enc["entry"])
    return encode(_images(spec, "cuda"), LossyOptions(**enc["options"]),
                  workers=enc["workers"], device="cuda")


def stream_names(spec: dict) -> list:
    return [stream_name(spec, i, h, w)
            for i, (h, w) in enumerate(spec["shapes"])]


def setup_streams(set_dir: str, jobs: int) -> dict:
    """The streams of a ``made_at_setup`` set, made anew, by name; each
    checked against the sha256 of the set's manifest."""
    spec = load_spec(set_dir)
    with open(os.path.join(set_dir, "manifest.json")) as f:
        manifest = json.load(f)
    names = stream_names(spec)
    if sorted(names) != sorted(manifest):
        raise RuntimeError(f"{set_dir}: the spec's streams are not the "
                           "manifest's")
    streams = dict(zip(names, make_streams(spec, jobs)))
    for name, data in streams.items():
        if hashlib.sha256(data).hexdigest() != manifest[name]["sha256"]:
            raise RuntimeError(f"corpus stream {name}, made at set-up, does "
                               "not match its sha256")
    return streams


def _grid_job(args):
    data, reference = args
    from jxlbench.drivers.decode_batch import GRID
    from jxlbench.registry import resolve_attr

    info = resolve_attr(reference["frame_info"])(data)
    px, box = resolve_attr(reference["decode_region"])(
        data, 0, 0, info["xgroups"], info["ygroups"])
    if box != (0, info["h"], 0, info["w"]) or px.shape[:2] != box[1::2]:
        raise AssertionError("the whole frame was not decoded")
    return px[GRID].copy()


def make_grids(out_dir: str, streams: dict, spec: dict, jobs: int) -> None:
    """``reference_grids.npz`` in ``out_dir`` of ``streams`` {name:
    bytes}."""
    # largest first, so that the pool ends together
    names = sorted(streams, key=lambda n: -len(streams[n]))
    with ProcessPoolExecutor(min(jobs, len(names)), mp_context=_SPAWN) as ex:
        grids = dict(zip(names, ex.map(
            _grid_job, [(streams[n], spec["reference"]) for n in names])))
    np.savez_compressed(os.path.join(out_dir, "reference_grids.npz"),
                        **grids)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("set")
    p.add_argument("--out")
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--grids-only", action="store_true")
    args = p.parse_args(argv)
    from jxlbench.registry import resolve_attr

    set_dir = os.path.join(HERE, args.set)
    spec = load_spec(set_dir)
    at_setup = spec.get("made_at_setup", False)
    if args.grids_only:
        with open(os.path.join(set_dir, "manifest.json")) as f:
            names = sorted(json.load(f))
        streams = {}
        for n in names:
            with open(os.path.join(set_dir, n), "rb") as f:
                streams[n] = f.read()
        make_grids(set_dir, streams, spec, args.jobs)
        return 0
    out = args.out or set_dir
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    streams = dict(zip(stream_names(spec), make_streams(spec, args.jobs)))
    manifest = {}
    for i, ((h, w), (name, data)) in enumerate(zip(spec["shapes"],
                                                   streams.items())):
        info = resolve_attr(spec["reference"]["frame_info"])(data)
        if not at_setup:
            with open(os.path.join(out, name), "wb") as f:
                f.write(data)
        manifest[name] = dict(seed=spec["seed"], index=i, h=h, w=w,
                              gab=info["gab"], epf_iters=info["epf_iters"],
                              bytes=len(data),
                              sha256=hashlib.sha256(data).hexdigest())
        if "qualities" in spec:
            manifest[name]["jpeg_quality"] = spec["qualities"][i]
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    total = sum(m["bytes"] for m in manifest.values())
    print(f"{args.set}: {len(manifest)} streams, {total} bytes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if total > spec["max_bytes"]:
        print(f"over the cap of {spec['max_bytes']} bytes", file=sys.stderr)
        return 1
    if out != set_dir and not at_setup:
        return 0
    t0 = time.perf_counter()
    make_grids(out, streams, spec, args.jobs)
    print(f"{args.set}: grids in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
