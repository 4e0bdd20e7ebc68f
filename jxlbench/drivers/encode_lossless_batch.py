"""Closed loop of ``encode_lossless_many`` batches of seeded photos.

Traffic keys: ``shape`` (h, w), ``pool`` (images made at set-up on the
device from ``pool_seed``: every run seed encodes the same images, in
its own order), ``batch`` (images a call, drawn by the run's seed
without replacement), ``content`` (dead-leaves parameters), ``check``
``streams``). The check decodes with the plain reference, and holds
sample for sample to the image it was made from: one group, drawn from
the seed, of every distinct stream that the window returned for each
image, and the whole of ``streams`` streams drawn from all of the
window's outputs."""

from __future__ import annotations

import sys

import numpy as np

from jxlbench.drivers.common import DRAWS, RESERVOIR, WARM, Reservoir, rng
from jxlbench.harness import Check
from jxlbench.registry import resolve_attr


def _options(run):
    from libjxl_torch.api.encoder import EncodeOptions
    return EncodeOptions(**run.cell.config["encode"]["options"])


def _encode(run, idx: list, images=None) -> list:
    encode_lossless_many = resolve_attr(run.cell.config["encode"]["entry"])
    imgs = images if images is not None else run.state["images"]
    out = encode_lossless_many([imgs[i] for i in idx], _options(run),
                               device=run.device)
    if len(out) != len(idx) or not all(isinstance(s, bytes) and s
                                       for s in out):
        raise ValueError("the encode returned no stream for some image")
    return out


def setup(run) -> None:
    from jxlbench.images import dead_leaves

    t = run.cell.traffic
    h, w = t["shape"]
    imgs = [dead_leaves(t["pool_seed"], i, h, w, t["content"], run.device)
            .cpu().numpy() for i in range(t["pool"])]
    run.state.update(images=imgs, draws=rng(run.seed, DRAWS),
                     sample=Reservoir(t["check"]["streams"],
                                      rng(run.seed, RESERVOIR)),
                     variants={})
    _encode(run, list(rng(run.seed, WARM).choice(len(imgs), t["batch"],
                                                 replace=False)))


def call(run, k: int) -> list:
    st, t = run.state, run.cell.traffic
    idx = [int(i) for i in st["draws"].choice(len(st["images"]), t["batch"],
                                              replace=False)]
    h, w = t["shape"]
    st["last_items"] = [dict(h=h, w=w, c=3, image=i) for i in idx]
    streams = _encode(run, idx)
    items = [dict(h=h, w=w, c=3, image=i, bytes=len(s))
             for i, s in zip(idx, streams)]
    for i, s in zip(idx, streams):
        st["sample"].offer((i, s))
        # bytes compare by length and memcmp; a dict keyed on the
        # streams would hash each one whole, inside the window
        known = st["variants"].setdefault(i, [])
        if not any(s == v for v in known):
            known.append(s)
    return items


def release(run) -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _differing(img: np.ndarray, data: bytes, group=None) -> int:
    """Samples of ``img`` (of group ``group`` only, when given) that the
    reference's decode of ``data`` gets wrong; all of them where it
    cannot decode the stream."""
    from jxlbench.ref.jxl.core.fields import FormatError
    from jxlbench.ref.lossless import decode

    if group is None:
        box = (slice(None), slice(None))
    else:
        gd = 256
        gx = -(-img.shape[1] // gd)
        y0, x0 = (group // gx) * gd, (group % gx) * gd
        box = (slice(y0, y0 + gd), slice(x0, x0 + gd))
    try:
        out = decode(data, groups=None if group is None else [group])
    except (FormatError, ValueError, IndexError) as e:
        print(f"the reference could not decode a stream: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return img[box].size
    if out.shape != img.shape:
        return img[box].size
    return int(np.count_nonzero(out[box] != img[box]))


def compare(run, streams: list, images=None) -> list:
    """Samples of the images that the reference's decode of ``streams``
    [(image index, bytes)] gets wrong, over the whole of each stream."""
    imgs = run.state["images"] if images is None else images
    differ = sum(_differing(imgs[i], data) for i, data in streams)
    return [Check("samples_differing", float(differ if streams else
                                               float("inf")),
                  float(run.cell.config["limits"]["samples_differing"]))]


def check(run) -> list:
    """One seed-drawn group of every distinct stream of the window, and
    the reservoir's streams whole."""
    from jxlbench.drivers.common import CHECK

    st = run.state
    gen = rng(run.seed, CHECK)
    h, w = run.cell.traffic["shape"]
    n_groups = (-(-h // 256)) * (-(-w // 256))
    differ = 0
    for i in sorted(st["variants"]):
        for data in st["variants"][i]:
            differ += _differing(st["images"][i], data,
                                 int(gen.integers(n_groups)))
    limit = float(run.cell.config["limits"]["samples_differing"])
    return [Check("group_samples_differing",
                  float(differ if st["variants"] else float("inf")), limit),
            Check("stream_samples_differing",
                  compare(run, st["sample"].items)[0].value, limit)]


def control(run, grid: bool = False) -> list:
    """The control: the lossless guarantee broken. The program encodes
    ``check.streams`` images of the pool with the lowest bit of every
    sample cleared; their streams are held to the images as made."""
    from jxlbench.drivers.common import CHECK

    try:
        setup(run)
        imgs = run.state["images"]
        k = run.cell.traffic["check"]["streams"]
        idx = [int(i) for i in rng(run.seed, CHECK).choice(len(imgs), k,
                                                           replace=False)]
        low = [im & np.uint8(0xFE) for im in imgs]
        return compare(run, list(zip(idx, _encode(run, idx, images=low))))
    finally:
        close(run)


def close(run) -> None:
    pass
