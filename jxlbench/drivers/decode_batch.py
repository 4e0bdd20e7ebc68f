"""Closed loop of ``decode_many`` batches over the committed corpus.

Traffic keys: ``corpus`` (the manifest's set), ``batch`` (streams a
call), ``replace`` (draw with replacement), ``check`` (``per_slot``
frames sampled from the window's outputs at each position of a call's
batch, ``groups`` per side of the region the reference decodes in
each). One client hands the port the next batch when the last one
returns.

The check holds every frame of the window, on a grid of one sample in
13 x 13 (``GRID``), to the plain reference's decode of its stream, made
once by ``corpus/reference.py`` and kept in ``corpus/reference_grids.npz``;
and, at every position of the batch (a slot of the device chunk),
``per_slot`` frames drawn from the seed, in a region of ``groups`` x
``groups`` AC groups each, to the reference run after the window on a
pool of processes."""

from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from jxlbench.drivers.common import CHECK, DRAWS, RESERVOIR, WARM, \
    Reservoir, rng
from jxlbench.harness import Check
from jxlbench.registry import resolve_attr

# one sample in 13 x 13: 13 is prime to 8, 16 and 32, so across a frame
# the grid reads every position inside a block and blocks of either
# parity, on and off the diagonal of every varblock
GRID = (slice(6, None, 13), slice(6, None, 13))


def load_corpus(root: str, corpus: str) -> tuple[list, list]:
    """(manifest entries, stream bytes) of one set of the corpus, every
    stream checked against its sha256."""
    base = os.path.join(root, "jxlbench", "corpus")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    metas, streams = [], []
    for name in sorted(manifest):
        m = manifest[name]
        if m["set"] != corpus:
            continue
        with open(os.path.join(base, name), "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != m["sha256"]:
            raise RuntimeError(f"corpus stream {name} does not match its "
                               "sha256")
        metas.append(dict(m, name=name))
        streams.append(data)
    if not streams:
        raise RuntimeError(f"no streams of set {corpus!r} in the corpus")
    return metas, streams


def _decode(run, idx: list) -> list:
    st = run.state
    decode_many = resolve_attr(run.cell.config["decode"]["entry"])
    outs = decode_many([st["streams"][i] for i in idx],
                       workers=run.cell.config["decode"].get("workers"),
                       device=run.device)
    for i, o in zip(idx, outs):
        m = st["metas"][i]
        if not isinstance(o, np.ndarray) or o.shape != (m["h"], m["w"], 3) \
                or o.dtype != np.uint8:
            raise ValueError(f"{m['name']}: got {type(o).__name__} "
                             f"{getattr(o, 'shape', None)}")
    return outs


def _items(run, idx: list) -> list:
    metas = run.state["metas"]
    return [dict(h=metas[i]["h"], w=metas[i]["w"], gab=metas[i]["gab"],
                 epf_iters=metas[i]["epf_iters"], stream=i) for i in idx]


def _warm_pool(run) -> None:
    """Start the port's host pool and have every worker pay its imports:
    rounds of warm tasks go out until each worker has answered one. The
    pool spawns its workers on demand and a spawned worker takes seconds
    to start, so rounds repeat for up to two minutes; a worker left cold
    would pay its imports inside the window."""
    import time

    from libjxl_torch.parallel import host_pool

    n = run.cell.config["decode"].get("workers") or os.cpu_count() or 1
    seen: set = set()
    deadline = time.monotonic() + 120
    while len(seen) < n and time.monotonic() < deadline:
        seen |= set(host_pool.get_pool(n).map(host_pool._warm_task,
                                               range(n), chunksize=1))
        time.sleep(0.05)
    if len(seen) < n:
        raise RuntimeError(f"only {len(seen)} of {n} pool workers warmed up")


def setup(run) -> None:
    t = run.cell.traffic
    metas, streams = load_corpus(run.cell.root, t["corpus"])
    gen = rng(run.seed, RESERVOIR)
    run.state.update(metas=metas, streams=streams, draws=rng(run.seed, DRAWS),
                     slots=[Reservoir(t["check"]["per_slot"], gen)
                            for _ in range(t["batch"])], grids=[])
    _warm_pool(run)
    # every shape once (loads the kernels), then a full batch drawn apart
    # from the window's draws
    shapes = {}
    for i, m in enumerate(metas):
        shapes.setdefault((m["h"], m["w"]), i)
    _decode(run, sorted(shapes.values()))
    w = rng(run.seed, WARM)
    _decode(run, list(w.choice(len(streams), t["batch"],
                               replace=t["replace"])))


def call(run, k: int) -> list:
    st, t = run.state, run.cell.traffic
    idx = [int(i) for i in st["draws"].choice(len(st["streams"]), t["batch"],
                                              replace=t["replace"])]
    st["last_items"] = items = _items(run, idx)
    outs = _decode(run, idx)
    for slot, i, o in zip(st["slots"], idx, outs):
        slot.offer((i, o))
        st["grids"].append((i, o[GRID].copy()))
    return items


def _shutdown_pool() -> None:
    from libjxl_torch.parallel import host_pool

    if host_pool._pool is not None:
        host_pool._pool.shutdown(wait=True, cancel_futures=True)
    host_pool.shutdown()


def release(run) -> None:
    _shutdown_pool()
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def pick_region(info: dict, gen: np.random.Generator, side: int):
    """A block of up to ``side`` x ``side`` AC groups inside one DC group
    (gx0, gy0, ngx, ngy), drawn from ``gen``."""
    per = info["dc_group_dim"] // info["group_dim"]
    ndx = -(-info["xgroups"] // per)
    ndy = -(-info["ygroups"] // per)
    dgx, dgy = int(gen.integers(ndx)), int(gen.integers(ndy))
    out = []
    for d, n in ((dgx, info["xgroups"]), (dgy, info["ygroups"])):
        lo, hi = d * per, min((d + 1) * per, n)
        m = min(side, hi - lo)
        out += [lo + int(gen.integers(hi - lo - m + 1)), m]
    gx0, ngx, gy0, ngy = out
    return gx0, gy0, ngx, ngy


def regions(run, streams: list):
    """One region of each stream index in ``streams``, drawn from the
    run's check stream: (stream index, region, frame info)."""
    from jxlbench.ref.vardct import frame_info

    gen = rng(run.seed, CHECK)
    side = run.cell.traffic["check"]["groups"]
    for i in streams:
        info = frame_info(run.state["streams"][i])
        yield i, pick_region(info, gen, side), info


def numbers(run, pairs, prefix: str = "region_") -> list:
    """The check's numbers over (program pixels, reference pixels) pairs
    of compared boxes: the largest difference and the share of samples
    that differ, named with ``prefix``."""
    worst, differ, total = 0, 0, 0
    for a, b in pairs:
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        worst = max(worst, int(d.max()))
        differ += int(np.count_nonzero(d))
        total += d.size
    limits = run.cell.config["limits"]
    if not total:
        worst = differ = float("inf")
        total = 1
    return [Check(prefix + "max_abs_diff", float(worst),
                  float(limits[prefix + "max_abs_diff"])),
            Check(prefix + "mismatch_share", float(differ / total),
                  float(limits[prefix + "mismatch_share"]))]


def _decode_regions(run, jobs: list) -> list:
    """The reference's ``decode_region`` of every (stream index, region,
    cast) in ``jobs``, one job a process of a spawned pool (the
    reference is numpy; a region takes seconds, mostly its DC groups)."""
    from jxlbench.ref.vardct import decode_region

    if not jobs:
        return []
    streams = run.state["streams"]
    n = min(len(jobs), os.cpu_count() or 1)
    with ProcessPoolExecutor(n, mp_context=mp.get_context("spawn")) as ex:
        futs = [ex.submit(decode_region, streams[i], *region, cast=cast)
                for i, region, cast in jobs]
        return [f.result() for f in futs]


def _box(info: dict, region, box) -> tuple:
    """``box`` (image coordinates) inside the pixels of ``region``."""
    gx0, gy0 = region[:2]
    ry, rx = gy0 * info["group_dim"], gx0 * info["group_dim"]
    y0, y1, x0, x1 = box
    return slice(y0 - ry, y1 - ry), slice(x0 - rx, x1 - rx)


def compare(run, frames: list) -> list:
    """The check over ``frames`` [(stream index, the program's pixels)]:
    one region of each, decoded by the plain reference."""
    picked = list(regions(run, [i for i, _ in frames]))
    refs = _decode_regions(run, [(i, r, None) for i, r, _ in picked])
    pairs = []
    for (_, p), (i, region, info), (ref, box) in zip(frames, picked, refs):
        y0, y1, x0, x1 = box
        pairs.append((np.asarray(p[y0:y1, x0:x1]),
                      ref[_box(info, region, box)]))
    return numbers(run, pairs)


def compare_control(run, streams: list, cast) -> list:
    """The control: the reference computed through ``cast`` put in the
    program's place, over one region of each stream index."""
    picked = list(regions(run, streams))
    low = _decode_regions(run, [(i, r, cast) for i, r, _ in picked])
    refs = _decode_regions(run, [(i, r, None) for i, r, _ in picked])
    pairs = []
    for (i, region, info), (lo, _), (ref, box) in zip(picked, low, refs):
        b = _box(info, region, box)
        pairs.append((lo[b], ref[b]))
    return numbers(run, pairs)


def reference_grids(root: str) -> dict:
    path = os.path.join(root, "jxlbench", "corpus", "reference_grids.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def compare_grids(run, grids: list) -> list:
    """Every frame's grid [(stream index, grid)] against the reference's
    grid of its stream."""
    ref = reference_grids(run.cell.root)
    names = [m["name"] for m in run.state["metas"]]
    return numbers(run, [(g, ref[names[i]]) for i, g in grids], "grid_")


def compare_control_grids(run, streams: list, cast) -> list:
    """The control on the grid: the reference's whole frame computed
    through ``cast`` against the reference's grid, for each stream
    index."""
    from jxlbench.ref.vardct import decode_region, frame_info

    ref = reference_grids(run.cell.root)
    pairs = []
    for i in streams:
        data = run.state["streams"][i]
        info = frame_info(data)
        low, _ = decode_region(data, 0, 0, info["xgroups"], info["ygroups"],
                               cast=cast)
        pairs.append((low[GRID], ref[run.state["metas"][i]["name"]]))
    return numbers(run, pairs, "grid_")


def control(run, grid: bool = False) -> list:
    """The control (no program runs): the reference computed in TF32 in
    the program's place, over the streams a run of this seed would sample
    (one region each, or with ``grid`` the whole frames on the grid)."""
    from jxlbench.ref.vardct import tf32

    metas, streams = load_corpus(run.cell.root, run.cell.traffic["corpus"])
    run.state.update(metas=metas, streams=streams)
    t = run.cell.traffic
    k = min(len(streams), t["batch"] * t["check"]["per_slot"])
    pick = [int(i) for i in rng(run.seed, DRAWS).choice(len(streams), k,
                                                        replace=False)]
    if grid:
        return compare_control_grids(run, pick, tf32)
    return compare_control(run, pick, tf32)


def check(run) -> list:
    frames = [f for slot in run.state["slots"] for f in slot.items]
    return compare_grids(run, run.state["grids"]) + compare(run, frames)


def close(run) -> None:
    _shutdown_pool()
