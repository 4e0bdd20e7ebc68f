"""Closed loop of ``decode_many`` batches over a set of the corpus that
has a folder of its own (``jxlbench/corpus/<set>/``: its streams,
``manifest.json``, ``reference_grids.npz``, made by
``corpus/make_set.py``; a set made at set-up commits no streams),
checked against the reference the traffic names. The loop, the reservoir, the comparison and the control are
``decode_batch.py``'s.

Traffic keys: ``corpus_dir`` (the set's folder, from the checkout's
root), ``reference`` (the dotted paths of the reference's
``frame_info``, ``decode_region`` and the control's cast ``tf32``),
``batch`` (streams a call), ``replace`` (with replacement: each stream of
a call drawn from the seed; without: every stream of the set
``batch / n`` times, each round in an order drawn from the seed),
``check`` (``per_slot`` and ``groups``, as in ``decode_batch.py``).

The cells of this driver measure ``decode_many``'s device route, so
set-up first decodes one small stream of the set's kind and stops the
run (an exception, so a nonzero exit) where the program does not count
it among its device frames: a program without the route fails at once
instead of timing its host path."""

from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from jxlbench.drivers import decode_batch as _b
from jxlbench.drivers.common import CHECK, DRAWS, RESERVOIR, WARM, \
    Reservoir, rng
from jxlbench.registry import resolve_attr

release = _b.release
close = _b.close


def set_dir(root: str, traffic: dict) -> str:
    return os.path.join(root, traffic["corpus_dir"])


def load_set(path: str) -> tuple[list, list]:
    """(manifest entries, stream bytes) of the set in folder ``path``,
    every stream checked against its sha256. A set whose spec says
    ``made_at_setup`` is made here, one process a stream
    (``corpus/make_set.py``)."""
    from jxlbench.corpus import make_set

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    spec_path = os.path.join(path, "spec.json")
    made = {}
    if os.path.exists(spec_path) and \
            make_set.load_spec(path).get("made_at_setup"):
        made = make_set.setup_streams(path, os.cpu_count() or 1)
    metas, streams = [], []
    for name in sorted(manifest):
        data = made.get(name)
        if data is None:
            with open(os.path.join(path, name), "rb") as f:
                data = f.read()
        if hashlib.sha256(data).hexdigest() != manifest[name]["sha256"]:
            raise RuntimeError(f"corpus stream {name} does not match its "
                               "sha256")
        metas.append(dict(manifest[name], name=name))
        streams.append(data)
    if not streams:
        raise RuntimeError(f"no streams in {path}")
    return metas, streams


PROBE_SHAPE = (256, 256)


def probe_stream(path: str) -> bytes:
    """A small stream of the kind of the set in folder ``path``: one made
    at ``PROBE_SHAPE`` from the spec of a set made at set-up, else the
    set's smallest committed stream."""
    from jxlbench.corpus import make_set

    if os.path.exists(os.path.join(path, "spec.json")):
        spec = make_set.load_spec(path)
        if spec.get("made_at_setup"):
            return make_set.small_stream(spec, *PROBE_SHAPE)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    name = min(sorted(manifest), key=lambda n: manifest[n]["bytes"])
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


def require_device_route(run, stream: bytes) -> None:
    """Raise unless the program's decode entry reconstructs ``stream`` on
    the device (its counter ``device_frames`` counts it)."""
    decode_many = resolve_attr(run.cell.config["decode"]["entry"])
    before = decode_many.device_frames
    decode_many([stream], workers=run.cell.config["decode"].get("workers"),
                device=run.device)
    if decode_many.device_frames != before + 1:
        raise RuntimeError(
            f"{run.cell.name}: the program decodes this set's streams off "
            "decode_many's device route, which the cell measures; it "
            "cannot run this cell")


def draw(traffic: dict, n: int, gen: np.random.Generator) -> list:
    """The stream indices of one call (see the module's docstring)."""
    batch = traffic["batch"]
    if traffic["replace"]:
        return [int(i) for i in gen.choice(n, batch, replace=True)]
    if batch % n:
        raise ValueError(f"a batch of {batch} without replacement needs a "
                         f"multiple of the set's {n} streams")
    return [int(i) for _ in range(batch // n) for i in gen.permutation(n)]


def setup(run) -> None:
    t = run.cell.traffic
    path = set_dir(run.cell.root, t)
    _b._warm_pool(run)
    require_device_route(run, probe_stream(path))
    metas, streams = load_set(path)
    gen = rng(run.seed, RESERVOIR)
    run.state.update(metas=metas, streams=streams, draws=rng(run.seed, DRAWS),
                     slots=[Reservoir(t["check"]["per_slot"], gen)
                            for _ in range(t["batch"])], grids=[])
    # every shape once (loads the kernels), then a full batch drawn apart
    # from the window's draws
    shapes = {}
    for i, m in enumerate(metas):
        shapes.setdefault((m["h"], m["w"]), i)
    _b._decode(run, sorted(shapes.values()))
    _b._decode(run, draw(t, len(streams), rng(run.seed, WARM)))


def call(run, k: int) -> list:
    st = run.state
    idx = draw(run.cell.traffic, len(st["streams"]), st["draws"])
    st["last_items"] = items = _b._items(run, idx)
    outs = _b._decode(run, idx)
    for slot, i, o in zip(st["slots"], idx, outs):
        slot.offer((i, o))
        st["grids"].append((i, o[_b.GRID].copy()))
    return items


def _ref(run, name: str):
    return resolve_attr(run.cell.traffic["reference"][name])


def regions(run, streams: list):
    """One region of each stream index in ``streams``, drawn from the
    run's check stream: (stream index, region, frame info)."""
    frame_info = _ref(run, "frame_info")
    gen = rng(run.seed, CHECK)
    side = run.cell.traffic["check"]["groups"]
    for i in streams:
        info = frame_info(run.state["streams"][i])
        yield i, _b.pick_region(info, gen, side), info


def _decode_regions(run, jobs: list) -> list:
    """The reference's ``decode_region`` of every (stream index, region,
    cast) in ``jobs``, one job a process of a spawned pool."""
    if not jobs:
        return []
    decode_region = _ref(run, "decode_region")
    streams = run.state["streams"]
    n = min(len(jobs), os.cpu_count() or 1)
    with ProcessPoolExecutor(n, mp_context=mp.get_context("spawn")) as ex:
        futs = [ex.submit(decode_region, streams[i], *region, cast=cast)
                for i, region, cast in jobs]
        return [f.result() for f in futs]


def compare(run, frames: list) -> list:
    """The check over ``frames`` [(stream index, the program's pixels)]:
    one region of each, decoded by the reference."""
    picked = list(regions(run, [i for i, _ in frames]))
    refs = _decode_regions(run, [(i, r, None) for i, r, _ in picked])
    pairs = []
    for (_, p), (i, region, info), (ref, box) in zip(frames, picked, refs):
        y0, y1, x0, x1 = box
        pairs.append((np.asarray(p[y0:y1, x0:x1]),
                      ref[_b._box(info, region, box)]))
    return _b.numbers(run, pairs)


def reference_grids(run) -> dict:
    path = os.path.join(set_dir(run.cell.root, run.cell.traffic),
                        "reference_grids.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def compare_grids(run, grids: list) -> list:
    """Every frame's grid [(stream index, grid)] against the reference's
    grid of its stream."""
    ref = reference_grids(run)
    names = [m["name"] for m in run.state["metas"]]
    return _b.numbers(run, [(g, ref[names[i]]) for i, g in grids], "grid_")


def check(run) -> list:
    frames = [f for slot in run.state["slots"] for f in slot.items]
    return compare_grids(run, run.state["grids"]) + compare(run, frames)


def control(run, grid: bool = False) -> list:
    """The control (no program runs): the reference computed in TF32 in
    the program's place, over the streams a run of this seed would sample
    (one region each, or with ``grid`` the whole frames on the grid)."""
    t = run.cell.traffic
    metas, streams = load_set(set_dir(run.cell.root, t))
    run.state.update(metas=metas, streams=streams)
    k = min(len(streams), t["batch"] * t["check"]["per_slot"])
    pick = [int(i) for i in rng(run.seed, DRAWS).choice(len(streams), k,
                                                        replace=False)]
    cast = _ref(run, "tf32")
    if grid:
        # whole frames, one a process
        frame_info = _ref(run, "frame_info")
        whole = []
        for i in pick:
            info = frame_info(streams[i])
            whole.append((i, (0, 0, info["xgroups"], info["ygroups"]),
                          cast))
        ref = reference_grids(run)
        low = _decode_regions(run, whole)
        return _b.numbers(run, [(lo[_b.GRID], ref[metas[i]["name"]])
                                for (i, _, _), (lo, _) in zip(whole, low)],
                          "grid_")
    picked = list(regions(run, pick))
    low = _decode_regions(run, [(i, r, cast) for i, r, _ in picked])
    refs = _decode_regions(run, [(i, r, None) for i, r, _ in picked])
    pairs = []
    for (i, region, info), (lo, _), (ref, box) in zip(picked, low, refs):
        b = _b._box(info, region, box)
        pairs.append((lo[b], ref[b]))
    return _b.numbers(run, pairs)
