"""Smoke run of the PyTorch port on one NVIDIA card.

Drives the port's two main paths through their entry points:

* the lossless serving encode ``libjxl_torch.api.encoder.
  encode_lossless_many(imgs, EncodeOptions(use_device=True,
  entropy="prefix-device"))`` on 8 RGB 3840x2160 photos plus a 16-bit
  RGBA image, a ragged gray image and a smooth/noise pair, then decodes
  every stream on the host and requires exact pixels;
* the VarDCT serving decode ``libjxl_torch.api.decoder.decode_many`` on
  two batches: the DCT8 one, 8 3840x2160 streams cycled from the
  committed 4K fixtures (``tests/data/torch_vardct``) plus a ragged and
  a 16-bit stream; and the variable-block one (every effort >= 5
  encode), 8 3840x2160 streams cycled from the committed effort-5 and
  effort-7 4K fixtures (``tests/data/torch_vardct_var``) plus a ragged
  and a small graphics stream, eight distinct 512x512 streams of one
  filter setting and different strategy classes (one chunk) and
  ``profiling/bench_e7_stream.jxl``. The host stage runs on
  decode_many's pool of one process a core. Every output is held
  within +-1 per 8-bit sample (+-4 per 16-bit sample) of the port's
  host ``decode``, and the pool's staging arrays must equal those
  staged in this process bit for bit;
* the single-image decode ``libjxl_torch.api.decoder.decode`` on the 4K
  DCT8 and variable-block fixtures, its restoration filters on the card:
  with ``config.device_filters = True`` (the frame stays on the card for
  the colour output) and in auto mode (4 MP and more: the band windows
  of ``decode_rows``), each held within +-1 of the float64 host filters,
  auto bit for bit equal to ``decode_rows`` on the card;
* ``decode_many`` of two 4K streams its device program does not take
  (progressive), whose filters go to the card in this process;
* the VarDCT lossy encode ``libjxl_torch.vardct.frame_enc.
  encode_lossy_many(imgs, LossyOptions(distance=1.0, effort=3,
  use_device=True))`` on the 8 4K photos, plus ``encode_lossy`` of a
  ragged 1001x1503 image: every stream equal to the same float32
  program's stream on the CPU (its stages compared one by one) and
  against the float64 host encoder, and every stream decoded
  by ``decode_many`` on the card, within +-1 of the host decode and
  above a PSNR floor.

Phases: environment, build (nvcc for sm_90a, one process per kernel
source, all at once, + the native host library), the pack kernel and
the Gaborish/EPF kernels against their plain PyTorch versions at the
shapes of the main paths, the encode path (with launch counts and the
batch rate), its host decode check, the two decode batches (each with
launch counts, the chunks handed to the device, the batch rate, the
host-stage and the device-only time; the var batch also with one
``torch.profiler`` run), their host decode check, the host stage alone
on the pool and on threads, ``decode()`` on the card (launch counts per
header and band window, times next to the host filters'), the
host-routed ``decode_many`` (launches, time on threads against one
``decode`` after another), the lossy encode (the batch rate, the device
program's time, the host half's time, a ``torch.profiler`` run, its
streams against the CPU's and the host encoder's, the round trip
through ``decode_many``), and a check that neither JAX nor the JAX
package was imported. The last two lines are the kernels' JSON record
and ``{"ok": true, "device": ...}``. Any failure raises and exits
non-zero before those lines. The script reaches the codec only through
``libjxl_torch`` (and ``bench.make_image`` for its photos).

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

``python3 chip_smoke.py --filters`` runs only the environment, the build
and the filter kernels against their plain versions, and prints their
records as one JSON line (no main path, no ``ok`` line): copied into
another checkout, it times that checkout's kernels on the same card.
"""

import hashlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

CHUNKS_4K = 135 * 3 * 256 * 256 // 128   # chunks of one 3840x2160 image
PACK_SOURCE = "libjxl_torch/csrc/pack_kernel.cu"
PACK_REPLACES = "libjxl_tpu/models/pack_kernel.py:53"
FILTERS_SOURCE = "libjxl_torch/csrc/filters.cu"
GAB_REPLACES = "libjxl_tpu/models/pallas_filters.py:72"
EPF_REPLACES = "libjxl_tpu/models/pallas_filters.py:85"
FIXTURES = os.path.join("tests", "data", "torch_vardct")
VAR_FIXTURES = os.path.join("tests", "data", "torch_vardct_var")
# the repo's pinned effort-7 stream, with its manifest entry
E7_STREAM = os.path.join("profiling", "bench_e7_stream.jxl")
E7_META = dict(h=768, w=1024, bits=8, gab=1, epf_iters=1, sha256=(
    "38339173bd8ea70e199651b24819d944309e4292a97e7995a3d8790c18a4bbd7"))
DEVICE = "cuda:0"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
FILTER_TOL = 1e-5
# decode() on the card: the 4K DCT8 and variable-block fixtures
DECODE_API = ((FIXTURES, "photo4k_d1_a.jxl"), (VAR_FIXTURES,
                                                 "photo4k_e5_d1.jxl"))
BAND_ROWS = 256                 # decode_rows' band height
# the lossy encode: bench.make_image seeds of the 8 4K photos (those of
# the lossless encode) and of the ragged image; the PSNR floor (8-bit
# RGB, all samples) is set below the lowest that
# tests/data/torch_vardct/lossy_psnr.py measures for these streams when
# it encodes them on the CPU
RAGGED_SEED = 23
PSNR_FLOOR = 40.5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip()


def _residual_chunks(rng, cn: int, hi: int, p: float) -> np.ndarray:
    """(cn, 128) int32 residuals below ``hi`` (and ``hi`` itself), with
    sentinel suffixes, all-invalid chunks and all-zero chunks."""
    v = np.minimum(rng.geometric(p, (cn, 128)) - 1, hi).astype(np.int32)
    v[::97, ::5] = hi
    starts = rng.integers(0, 128, cn)
    suffix = np.arange(128)[None, :] >= starts[:, None]
    v[::13] = np.where(suffix[::13], -1, v[::13])
    v[::101] = -1
    v[::89] = 0
    return v


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernel(dev) -> dict:
    """The pack kernel against pack_chunks_ref on the card, bit for bit,
    for 8-bit and 16-bit residual ranges; returns the 8-bit record."""
    import torch

    from libjxl_torch.models.lossless import (
        prefix_state_to_device, random_prefix_state,
    )
    from libjxl_torch.models.pack_kernel import pack_chunks, pack_chunks_ref

    rec = None
    for bits, hi, p in ((8, 1 << 12, 0.05), (16, (1 << 19) - 1, 0.0005)):
        rng = np.random.default_rng(bits)
        v = torch.from_numpy(_residual_chunks(rng, CHUNKS_4K, hi, p)).to(dev)
        lut = prefix_state_to_device(random_prefix_state(rng), dev)
        buf_k, cb_k = pack_chunks(v, lut)
        torch.cuda.synchronize()
        buf_r, cb_r = pack_chunks_ref(v, lut)
        err = max(int((buf_k.long() - buf_r.long()).abs().max()),
                  int((cb_k.long() - cb_r.long()).abs().max()))
        if not (torch.equal(buf_k, buf_r) and torch.equal(cb_k, cb_r)):
            raise AssertionError(f"pack kernel != plain version ({bits}-bit"
                                 f" residuals, max abs err {err})")
        torch.cuda.synchronize()
        ms = _time_ms(lambda: pack_chunks(v, lut), 50)
        plain_ms = _time_ms(lambda: pack_chunks_ref(v, lut), 5)
        print(f"pack kernel == plain (tolerance: exact), {bits}-bit "
              f"residuals, {CHUNKS_4K} chunks: kernel {ms} ms, "
              f"plain {plain_ms} ms, "
              f"mean chunk bits {float(cb_k.float().mean())}", flush=True)
        if rec is None:
            # each residual read once, each word and chunk count written
            # once (the 96-entry table is negligible)
            nbytes = v.numel() * 4 + buf_k.numel() * 4 + cb_k.numel() * 4
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes", library_ms=None)
            print(f"pack kernel bound: {nbytes} bytes over "
                  f"{HBM_BYTES_PER_S} B/s = {rec['bound_ms']} ms; no single "
                  "PyTorch call computes a prefix-code pack", flush=True)
        del v, buf_k, buf_r
    return rec


def _filter_inputs(rng, h: int, w: int, dev):
    """Random XYB in [-0.12, 0.18] and a per-8x8-block inv_sigma in
    [-3, -0.05] with a patch of -1e4 (below K_MIN_SIGMA: passes through)."""
    import torch
    xyb = ((rng.random((3, h, w)) - 0.4) * 0.3).astype(np.float32)
    yb, xb = -(-h // 8), -(-w // 8)
    inv = -rng.uniform(0.05, 3.0, (yb, xb)).astype(np.float32)
    inv[yb // 2:yb // 2 + max(1, yb // 8), :max(1, xb // 4)] = -1e4
    return torch.from_numpy(xyb).to(dev), torch.from_numpy(inv).to(dev)


# float operations per pixel of each pass, as the plain version counts
# them: Gaborish 11 a channel; per EPF neighbour 11 for the scaled
# abs-diff, 4 for the plus box, 3 for the weight, 7 for the sums (pass 2:
# 11 + 3 + 7), plus 5 a pixel
_FILTER_FLOPS = {"gab": 33, 0: 12 * 25 + 5, 1: 4 * 25 + 5, 2: 4 * 21 + 5}


def phase_filters(dev, card: str) -> dict:
    """Gaborish and EPF passes 0/1/2 against their plain versions on a
    3840x2160 frame (and 1x7, 3x5), each within FILTER_TOL; kernel,
    plain and bound times and the bound's share of the kernel time, and
    for Gaborish the time of the one PyTorch call that computes it (a
    grouped conv2d on the mirror-padded input, which the port never
    calls). Returns the JSON records."""
    import torch
    import torch.nn.functional as tf

    from libjxl_torch.core.frame_header import LoopFilter
    from libjxl_torch.models.filter_kernels import (
        epf_filter, epf_ref, gaborish_filter, gaborish_ref, mirror_pad,
    )
    from libjxl_torch.render.filters_torch import (
        epf_args, gab_weights, lf_params,
    )

    lfp = lf_params(LoopFilter(), dev)
    runs = {"gab": (gaborish_filter, gaborish_ref, gab_weights(lfp))}
    for pid in (0, 1, 2):
        runs[pid] = (epf_filter, epf_ref, (pid,) + epf_args(lfp, pid))
    rng = np.random.default_rng(2160)
    big = _filter_inputs(rng, 2160, 3840, dev)
    small = [_filter_inputs(rng, h, w, dev) for h, w in ((1, 7), (3, 5))]
    out = {}
    for which, (kern, plain, args) in runs.items():
        err = 0.0
        for x, inv in [big] + small:
            a = args if which == "gab" else (inv,) + args
            got = kern(x, *a)
            torch.cuda.synchronize()
            err = max(err, float((got - plain(x, *a)).abs().max()))
        if not err <= FILTER_TOL:
            raise AssertionError(f"filter {which}: kernel != plain version "
                                 f"(max abs err {err} > {FILTER_TOL})")
        x, inv = big
        a = args if which == "gab" else (inv,) + args
        ms = _time_ms(lambda: kern(x, *a), 50)
        plain_ms = _time_ms(lambda: plain(x, *a), 3)
        h, w = x.shape[1:]
        nbytes = 2 * x.numel() * 4 + (0 if which == "gab"
                                      else inv.numel() * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = _FILTER_FLOPS[which] * h * w / FP32_FLOPS * 1e3
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=None)
        rec["bound_share"] = rec["bound_ms"] / ms
        line = (f"filter {which} == plain within {FILTER_TOL} (max abs err "
                f"{err}), 3x2160x3840: kernel {ms} ms, plain {plain_ms} ms, "
                f"bound {rec['bound_ms']} ms ({nbytes} bytes -> {t_bytes} "
                f"ms, {_FILTER_FLOPS[which]} flop/px -> {t_ops} ms, "
                f"{rec['bound_share']} of the kernel time)")
        if which == "gab":
            weight = torch.tensor(args, dtype=torch.float32, device=dev)
            k = torch.zeros((3, 1, 3, 3), dtype=torch.float32, device=dev)
            k[:, 0, 1, 1] = weight[0]
            k[:, 0, 0, 1] = k[:, 0, 2, 1] = k[:, 0, 1, 0] = \
                k[:, 0, 1, 2] = weight[1]
            k[:, 0, 0, 0] = k[:, 0, 0, 2] = k[:, 0, 2, 0] = \
                k[:, 0, 2, 2] = weight[2]
            padded = mirror_pad(x, 1)[None].contiguous()
            conv = tf.conv2d(padded, k, groups=3)[0]
            rec["library_ms"] = _time_ms(
                lambda: tf.conv2d(padded, k, groups=3), 50)
            line += (f"; library F.conv2d(mirror-padded, groups=3) "
                     f"{rec['library_ms']} ms (max abs diff "
                     f"{float((conv - kern(x, *a)).abs().max())})")
        else:
            line += "; library: none (no single PyTorch call is an EPF pass)"
        print(line + f", on {card}", flush=True)
        out[which] = rec
    del big, small
    torch.cuda.empty_cache()
    return out


def load_fixtures(directory: str) -> tuple[dict, dict]:
    """The committed VarDCT streams of ``directory`` (by the name in its
    manifest), each checked against its sha256."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    streams = {}
    for name, m in manifest.items():
        with open(os.path.join(directory, name), "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != m["sha256"]:
            raise AssertionError(f"fixture {name} does not match its sha256")
        streams[name] = data
    return manifest, streams


def decode_batches() -> dict:
    """The two decode batches: label -> (names, streams, manifest). Each
    is 8 3840x2160 streams cycled from the batch's 4K fixtures, then its
    other streams."""
    batches = {}
    for label, directory in (("dct8", FIXTURES), ("var", VAR_FIXTURES)):
        manifest, streams = load_fixtures(directory)
        photos = sorted(n for n in manifest if n.startswith("photo4k"))
        names = [photos[i % len(photos)] for i in range(8)] + sorted(
            n for n in manifest if not n.startswith("photo4k"))
        if label == "var":
            with open(E7_STREAM, "rb") as f:
                streams[E7_STREAM] = f.read()
            if hashlib.sha256(streams[E7_STREAM]).hexdigest() != \
                    E7_META["sha256"]:
                raise AssertionError(f"{E7_STREAM} does not match its "
                                     "sha256")
            manifest[E7_STREAM] = E7_META
            names.append(E7_STREAM)
        batches[label] = (names, [streams[n] for n in names], manifest)
    return batches


def _profile(run, card: str, label: str) -> None:
    """One run under torch.profiler: the device's busy ms (the union of
    its kernels' and copies' time spans), its idle share of the run's
    wall time and the device ops that took the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"profiled {label}: the profiler gave no device events; "
              "busy time and idle share not measured", flush=True)
        return
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for t_start, t_end, name in spans:
        if t_end > end:
            busy_us += t_end - max(t_start, end)
            end = t_end
        n, us = by_name.get(name[:80], (0, 0.0))
        by_name[name[:80]] = (n + 1, us + t_end - t_start)
    top = sorted(((us / 1e3, n, name) for name, (n, us) in by_name.items()),
                 reverse=True)[:10]
    busy_ms = busy_us / 1e3
    print(f"profiled {label}: wall {wall_ms} ms, device busy "
          f"{busy_ms} ms ({len(spans)} device events), idle share "
          f"{1 - busy_ms / wall_ms}; top device ops (ms, count, name): "
          f"{top}, on {card}", flush=True)


def phase_decode_batch(dev, card: str, label: str, batch) -> tuple:
    """One decode batch through decode_many on the card, with the launch
    counts of that run: every frame on the device, the Gaborish and
    per-pass EPF launches those of the streams' headers; then the warm
    batch rate three times, the host stage of its 4K streams one after
    another and their device-only time. Returns (counts, outputs)."""
    import torch

    from libjxl_torch.api.decoder import _device_decode_inputs, decode_many
    from libjxl_torch.models import vardct_decode

    names, streams, manifest = batch
    # the chunks decode_many hands to the device, recorded by name
    chunks = []

    def recording(fn):
        def run(inputs, *a, **k):
            chunks.append((fn.__name__, len(inputs)))
            return fn(inputs, *a, **k)
        return run

    originals = (vardct_decode.decode_frames_device,
                 vardct_decode.decode_frames_device_var)
    vardct_decode.decode_frames_device, \
        vardct_decode.decode_frames_device_var = map(recording, originals)
    decode_many.device_frames = 0
    _reset_filter_counts()
    try:
        t0 = time.perf_counter()
        outs = decode_many(streams, device=dev)
        t_cold = time.perf_counter() - t0
    finally:
        vardct_decode.decode_frames_device, \
            vardct_decode.decode_frames_device_var = originals
    counts = dict(device_frames=decode_many.device_frames,
                  **_filter_counts())
    print(f"{label} decode: {len(streams)} streams in {t_cold} s (cold), "
          f"counts {counts}", flush=True)
    if counts["device_frames"] != len(streams):
        raise AssertionError(f"{label}: decode_many reconstructed "
                             f"{counts['device_frames']} of {len(streams)} "
                             "frames on the device")
    if counts["gaborish"] <= 0 or min(counts["epf_passes"]) <= 0:
        raise AssertionError(f"a filter kernel was not launched: {counts}")
    # one launch a frame of each pass the frame's header asks for
    want = dict(gaborish=sum(manifest[n]["gab"] for n in names),
                epf_passes=[sum(manifest[n]["epf_iters"] >= k for n in names)
                            for k in (3, 1, 2)])
    if [counts["gaborish"], counts["epf_passes"]] != list(want.values()):
        raise AssertionError(f"{label}: filter launches {counts}, want "
                             f"{want}")
    # frames of one shape, filter setting and bit depth share chunks of
    # 8, whatever their strategy classes
    settings: dict = {}
    for n in names:
        m = manifest[n]
        settings.setdefault((m["h"], m["w"], m["gab"], m["epf_iters"],
                             m["bits"]), []).append(n)
    fn = "decode_frames_device_var" if label == "var" else \
        "decode_frames_device"
    want_chunks = sorted((fn, min(8, len(v) - c)) for v in settings.values()
                         for c in range(0, len(v), 8))
    print(f"{label} decode: chunks {chunks}", flush=True)
    if sorted(chunks) != want_chunks:
        raise AssertionError(f"{label}: chunks {sorted(chunks)}, want "
                             f"{want_chunks}")

    mp = sum(manifest[n]["h"] * manifest[n]["w"] for n in names) / 1e6
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = decode_many(streams, device=dev)
        rates.append(mp / (time.perf_counter() - t0))
    if not all(np.array_equal(a, b) for a, b in zip(again, outs)):
        raise AssertionError(f"{label}: a repeated decode gave other pixels")
    print(f"{label} decode batch ({len(streams)} streams, {mp} MP, host "
          f"stage on the pool included): {rates} MP/s (median "
          f"{statistics.median(rates)}), on {card}", flush=True)
    if label == "var":
        _profile(lambda: decode_many(streams, device=dev), card,
                 "warm var batch")

    # device only: the frames' host stage done, the reconstruction from
    # the numpy inputs (their upload included) to the integer image
    t0 = time.perf_counter()
    prepped = [_device_decode_inputs(s) for s in streams[:8]]
    host_ms = (time.perf_counter() - t0) * 1e3
    print(f"{label} host stage (parse + native AC decode), the 8 4K "
          f"streams one after another: {host_ms} ms ({host_ms / 8} ms a "
          f"stream), on {card}", flush=True)
    # what the pool sends back a frame: the nonzero coefficients only
    nnz = sum(len(c[0]) for fr, _, _ in prepped for c in (
        fr.classes.values() if hasattr(fr, "classes") else [fr]))
    total = sum(3 * k[2] * k[3] * 64 for _, k, _ in prepped)
    pickled = sum(len(pickle.dumps(p, protocol=5)) for p in prepped)
    print(f"{label} staging of the 8 4K frames: {nnz} nonzero of {total} "
          f"coefficients ({nnz / total}), {pickled / 8e6} MB pickled a "
          "frame", flush=True)
    groups: dict = {}
    for fr, key, lf in prepped:
        groups.setdefault(key[:8], (lf, []))[1].append(fr)

    def device_only():
        for key, (lf, frs) in groups.items():
            fn = vardct_decode.decode_frames_device_var \
                if key[7:8] == ("var",) else vardct_decode.decode_frames_device
            fn(frs, lf, key[4], key[5], key[0], key[1], (1 << key[6]) - 1,
               dev, fetch=False)

    dev_ms = _time_ms(device_only, 3)
    mp8 = sum(manifest[n]["h"] * manifest[n]["w"] for n in names[:8]) / 1e6
    print(f"{label} device only, the 8 4K frames already parsed "
          f"({mp8} MP): {dev_ms} ms ({mp8 / dev_ms * 1e3} MP/s), "
          f"on {card}", flush=True)
    del prepped, groups
    torch.cuda.empty_cache()
    return counts, outs


def phase_host_check(batches: dict, outputs: dict) -> None:
    """Every decode output within +-1 per 8-bit sample (+-4 per 16-bit
    sample) of the host decode of its stream (float64 filters), which
    runs in spawned workers."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from libjxl_torch.api.decoder import decode
    from libjxl_torch.parallel import host_pool

    distinct = {}
    for names, streams, _ in batches.values():
        distinct.update(zip(names, streams))
    order = sorted(distinct)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=min(len(order), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=host_pool._worker_init) as ex:
        host = dict(zip(order, ex.map(decode, [distinct[n] for n in order])))
    for label, (names, _, manifest) in batches.items():
        worst = {}
        for name, got in zip(names, outputs[label]):
            want = host[name]
            tol = 1 if manifest[name]["bits"] <= 8 else 4
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name}: {got.shape} {got.dtype} "
                                     f"against the host's {want.shape} "
                                     f"{want.dtype}")
            diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
            worst[name] = (int(diff.max()), float((diff > 0).mean()))
            if diff.max() > tol:
                raise AssertionError(f"{name}: device decode differs from "
                                     f"the host decode by {diff.max()} > "
                                     f"{tol}")
        print(f"{label} decode: every output within +-1 (8-bit) / +-4 "
              f"(16-bit) of the host decode (max diff, share of samples "
              f"that differ): {worst}", flush=True)
    print(f"host decode of {len(order)} streams: "
          f"{time.perf_counter() - t0} s", flush=True)


def phase_host_stage(card: str, batches: dict, workers: int) -> None:
    """The host stage of each decode batch alone: on decode_many's pool
    of ``workers`` processes, and for comparison on as many threads of
    this process (not a path of the port), each way in turn, twice. The
    pool's staging arrays must equal, bit for bit, those staged here."""
    from libjxl_torch.api.decoder import _device_decode_inputs
    from libjxl_torch.parallel import host_pool

    for label, (_, streams, _) in batches.items():
        stage: dict = {}
        for way in ("processes", "threads") * 2:
            t0 = time.perf_counter()
            if way == "processes":
                pooled = host_pool.map_decode_inputs(streams, workers)
            else:
                with ThreadPoolExecutor(workers) as ex:
                    here = list(ex.map(_device_decode_inputs, streams))
            stage.setdefault(f"{workers} {way}", []).append(
                (time.perf_counter() - t0) * 1e3)
        print(f"{label} host stage of the batch, alone (ms): {stage}, "
              f"on {card}", flush=True)
        for data, a, b in zip(streams, pooled, here):
            if a[1] != b[1] or not all(
                    np.array_equal(x, y) for x, y in
                    zip(_leaves(a[0]), _leaves(b[0]), strict=True)):
                raise AssertionError(f"{label}: the pool staged other "
                                     "arrays than this process")
        print(f"{label}: the pool's staging equals this process's, bit "
              "for bit", flush=True)


def _filter_counts() -> dict:
    from libjxl_torch.models.filter_kernels import (
        epf_filter, gaborish_filter,
    )
    return dict(gaborish=gaborish_filter.launches,
                epf_passes=list(epf_filter.pass_launches))


def _reset_filter_counts() -> None:
    from libjxl_torch.models.filter_kernels import (
        epf_filter, gaborish_filter,
    )
    gaborish_filter.launches = 0
    epf_filter.launches = 0
    epf_filter.pass_launches = [0, 0, 0]


def phase_decode_api(dev, card: str) -> dict:
    """``decode()`` of a 4K DCT8 and a 4K variable-block fixture with its
    restoration filters on the card: with ``device_filters = True`` (one
    whole-frame launch of each filter the header asks for, the colour
    output on the card) and in auto mode (4 MP and more: one launch a
    256-row band window), each run twice with the counts set to 0 before
    and read after; each output within +-1 of the float64 host filters,
    auto bit for bit equal to ``decode_rows`` on the card. Returns the
    filter launches of the first run of each mode."""
    from libjxl_torch.api.decoder import decode, decode_rows
    from libjxl_torch.config import config

    total = dict(gaborish=0, epf_passes=[0, 0, 0])
    try:
        for directory, name in DECODE_API:
            manifest, streams = load_fixtures(directory)
            m, data = manifest[name], streams[name]
            per_frame = [m["gab"]] + [int(m["epf_iters"] >= k)
                                      for k in (3, 1, 2)]
            config.device_filters = False
            t0 = time.perf_counter()
            host = decode(data)
            host_ms = (time.perf_counter() - t0) * 1e3
            outs, times = {}, {}
            for mode, setting, windows in (
                    ("resident", True, 1),
                    ("auto", None, -(-m["h"] // BAND_ROWS))):
                config.device_filters = setting
                times[mode] = []
                for rep in range(2):
                    _reset_filter_counts()
                    t0 = time.perf_counter()
                    out = decode(data, device=dev)
                    times[mode].append((time.perf_counter() - t0) * 1e3)
                    c = _filter_counts()
                    got = [c["gaborish"]] + c["epf_passes"]
                    if got != [windows * n for n in per_frame]:
                        raise AssertionError(
                            f"decode() {mode} of {name}: launches {got}, "
                            f"want {windows} x {per_frame}")
                    if rep == 0:
                        total["gaborish"] += got[0]
                        total["epf_passes"] = [
                            a + b for a, b in zip(total["epf_passes"],
                                                  got[1:])]
                        print(f"decode() {mode} of {name}: Gaborish and "
                              f"EPF0/1/2 launches {got} ({windows} "
                              f"window(s) x {per_frame})", flush=True)
                diff = np.abs(out.astype(np.int64) - host.astype(np.int64))
                if out.shape != host.shape or diff.max() > 1:
                    raise AssertionError(
                        f"decode() {mode} of {name} differs from the host "
                        f"filters by {diff.max()}")
                outs[mode] = out
                print(f"decode() {mode} of {name}: within +-1 of the host "
                      f"filters (max diff {diff.max()}, share of samples "
                      f"that differ {float((diff > 0).mean())})", flush=True)
            rows = np.concatenate([b for _, b in decode_rows(data,
                                                             device=dev)])
            if not np.array_equal(rows, outs["auto"]):
                raise AssertionError(f"decode() auto of {name} is not "
                                     "decode_rows on the card bit for bit")
            print(f"decode() auto of {name} equals decode_rows on the card "
                  "bit for bit", flush=True)
            print(f"decode() of {name} ({m['h']}x{m['w']}), ms a decode: "
                  f"host float64 filters {host_ms}; device filters "
                  f"resident {times['resident']}, auto (band windows) "
                  f"{times['auto']} (first run of each cold), on {card}",
                  flush=True)
    finally:
        config.device_filters = None
    return total


def phase_host_routed(dev, card: str, photos: list, workers: int) -> None:
    """``decode_many`` of two 4K streams that its device program does not
    take (progressive: two passes) and whose filters the auto policy puts
    on the card: they decode in this process, one thread each, through
    the filter kernels. Their launches, their time against ``decode`` of
    one after the other, and each output equal to ``decode``'s."""
    from libjxl_torch.api.decoder import decode, decode_many
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy_many

    streams = encode_lossy_many(photos[:2], LossyOptions(
        distance=1.0, effort=3, progressive=True, gaborish=1))
    t0 = time.perf_counter()
    alone = [decode(s, device=dev) for s in streams]
    serial_ms = (time.perf_counter() - t0) * 1e3
    decode_many.device_frames = 0
    _reset_filter_counts()
    t0 = time.perf_counter()
    outs = decode_many(streams, workers=workers, device=dev)
    many_ms = (time.perf_counter() - t0) * 1e3
    c = _filter_counts()
    got = [c["gaborish"]] + c["epf_passes"]
    if decode_many.device_frames or got[0] == 0:
        raise AssertionError(f"host-routed decode_many: device program "
                             f"frames {decode_many.device_frames}, filter "
                             f"launches {got}")
    for a, b in zip(outs, alone):
        if not np.array_equal(a, b):
            raise AssertionError("host-routed decode_many differs from "
                                 "decode() on the card")
    print(f"decode_many of 2 host-routed 4K streams (progressive, filters "
          f"on the card in auto mode): {many_ms} ms on 2 threads, decode() "
          f"one after the other {serial_ms} ms; Gaborish and EPF0/1/2 "
          f"launches {got}; outputs equal to decode()'s, on {card}",
          flush=True)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def _quantized(img, opts, dev) -> tuple:
    """The quantized AC (DC slot zeroed), DC and CfL maps that
    ``encode_lossy`` codes for ``img`` with ``opts``; the host encoder's
    float64 DCT coefficients (None on the device path) and the DC
    steps."""
    import copy

    from libjxl_torch.vardct.frame_enc import encode_lossy
    o = copy.copy(opts)
    o._aux, o._recon_only = {}, True
    encode_lossy(img, o, device=dev)
    st = o._aux["recon_state"]
    q_ac = np.array(st["q_ac"], np.int64)
    q_ac[..., 0] = 0
    return ([q_ac] + [np.asarray(st[k], np.int64)
                      for k in ("q_dc", "ytox", "ytob")],
            o._aux.get("stored_dct"),
            st["quantizer"].mul_dc(st["matrices"].dc_quant))


def _dc_before_rounding(stored, mul_dc) -> np.ndarray:
    """(yb, xb, 3) DC values over their steps before rounding, in the
    encoder's order (B less the dequantized Y), in the dtype of
    ``stored`` (yb, xb, 3, 64) and ``mul_dc``."""
    dcx, dcy, dcb = (stored[:, :, c, 0] for c in range(3))
    q_y = np.round(dcy / mul_dc[1])
    return np.stack([dcx / mul_dc[0], dcy / mul_dc[1],
                     (dcb - q_y * mul_dc[1]) / mul_dc[2]], -1)


def encode_drift(dev, name: str, img, opts, got: bytes) -> None:
    """Where the card's device encode of ``img`` departs from the same
    float32 program on the CPU and from the float64 host encoder.

    Card against CPU, stage by stage: the XYB image, the DCT of one XYB
    input, then every output of the program. The card's stream must
    equal the device path's stream on the CPU (the program the tests
    hold to the JAX package's device path byte for byte). The host
    encoder computes in float64, so a value whose float64 lies within a
    float32 rounding of a .5 boundary rounds the other way there (in the
    JAX package too): against it this prints how many quantized values
    differ, the DC values before rounding on both sides where a DC
    differs, and the size ratio, and fails if a value is off by more
    than 1 or the sizes by more than 1%."""
    import torch

    from libjxl_torch.models import vardct_pipeline as VP
    from libjxl_torch.vardct.frame_enc import (
        LossyOptions, _falcon_device_scalars, encode_lossy,
    )

    h, w = img.shape[:2]
    sc = _falcon_device_scalars(img.shape, opts)
    yb, xb = sc[8], sc[9]
    px = torch.from_numpy(np.ascontiguousarray(img[None]))
    xyb = {d: VP.srgb_to_xyb_device(px.to(d).permute(0, 3, 1, 2)).cpu()
           for d in (dev, "cpu")}
    dct = {d: VP.dct_stored(xyb["cpu"].to(d), h, w, yb, xb).cpu()
           for d in (dev, "cpu")}
    outs = {}
    for d in (dev, "cpu"):
        args = [torch.from_numpy(np.asarray(a, np.float32)).to(d)
                for a in sc[:6]]
        outs[d] = [t.cpu() for t in VP._frame_body(px.to(d), *args,
                                                   *sc[6:])]
    n_dct = int((dct[dev] != dct["cpu"]).sum())
    print(f"lossy encode {name}, card against CPU, the same float32 "
          f"program: XYB samples that differ "
          f"{int((xyb[dev] != xyb['cpu']).sum())} of {xyb[dev].numel()}; "
          f"DCT coefficients of one XYB input that differ {n_dct} of "
          f"{dct[dev].numel()} (max abs diff "
          f"{float((dct[dev] - dct['cpu']).abs().max())}); values that "
          f"differ (AC, DC, ytox, ytob) "
          f"{[int((a != b).sum()) for a, b in zip(outs[dev], outs['cpu'])]}",
          flush=True)
    on_cpu = encode_lossy(img, opts, device="cpu")
    print(f"lossy encode {name}: the card's stream "
          f"{'equals' if got == on_cpu else 'differs from'} the device "
          f"path's stream on the CPU ({len(got)} and {len(on_cpu)} bytes)",
          flush=True)
    if got != on_cpu:
        raise AssertionError(f"lossy encode {name}: the card's stream "
                             "differs from the same program's on the CPU")

    host_opts = LossyOptions(distance=opts.distance, effort=opts.effort)
    want = encode_lossy(img, host_opts)
    if got == want:
        print(f"lossy encode {name}: the device stream equals the host "
              f"encoder's ({len(got)} bytes)", flush=True)
        return
    q_dev = _quantized(img, opts, dev)[0]
    q_host, stored64, mul64 = _quantized(img, host_opts, None)
    diffs = [np.abs(a - b) for a, b in zip(q_dev, q_host)]
    ratio = len(got) / len(want)
    print(f"lossy encode {name}: the device stream differs from the host "
          f"encoder's: quantized values that differ (AC, DC, ytox, ytob) "
          f"{[int((d > 0).sum()) for d in diffs]}, by at most "
          f"{[int(d.max()) for d in diffs]}; size ratio {ratio}",
          flush=True)
    # the card's float32 DC before rounding (from the CPU's XYB, equal to
    # the card's where no XYB sample differs), and the host's float64
    dc32 = _dc_before_rounding(dct[dev][0].numpy(),
                               np.asarray(sc[5], np.float32))
    dc64 = _dc_before_rounding(stored64, np.asarray(mul64, np.float64))
    # each DC that differs either has its float64 value next to a .5
    # boundary or is a B value whose block's Y differs (B is coded less
    # the dequantized Y)
    where = list(zip(*np.nonzero(diffs[1])))
    near = [abs(float(dc64[i]) - float(np.floor(dc64[i]) + 0.5))
            for i in where]
    follows = [c == 2 and diffs[1][by, bx, 1] > 0 for by, bx, c in where]
    boundary = [d for d, f in zip(near, follows) if not f]
    print(f"  {len(where)} DC values differ: {len(boundary)} whose float64 "
          f"value lies within {max(boundary, default=0.0)!r} of a .5 "
          f"boundary, {sum(follows)} B values whose block's Y differs",
          flush=True)
    for (by, bx, c), _ in zip(where, range(3)):
        print(f"  DC ({by}, {bx}) channel {'XYB'[c]}: device "
              f"{int(q_dev[1][by, bx, c])} from float32 "
              f"{float(dc32[by, bx, c])!r}, host "
              f"{int(q_host[1][by, bx, c])} from float64 "
              f"{float(dc64[by, bx, c])!r}", flush=True)
    if max(boundary, default=0.0) > 1e-3:
        raise AssertionError(f"lossy encode {name}: a DC value differs from "
                             "the host's away from a rounding boundary")
    if max(int(d.max()) for d in diffs) > 1 or abs(ratio - 1) > 0.01:
        raise AssertionError(f"lossy encode {name}: device and host "
                             "streams drift too far apart")


def phase_lossy_encode(dev, card: str, photos: list, workers: int) -> None:
    """The VarDCT lossy encode on the card: ``encode_lossy_many`` of the 8
    4K photos at distance 1, effort 3, and ``encode_lossy`` of a ragged
    image; the batch rate, the device program's time a 4K image, the
    host half's time and a profiled batch; every stream through
    ``encode_drift``; every stream through ``decode_many`` on
    the card, within +-1 of the float64 host decode and above the PSNR
    floor."""
    import copy
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from bench import make_image

    from libjxl_torch.api.decoder import decode, decode_many
    from libjxl_torch.models import vardct_pipeline as VP
    from libjxl_torch.parallel import host_pool
    from libjxl_torch.vardct.frame_enc import (
        LossyOptions, _falcon_device_scalars, encode_lossy,
        encode_lossy_many,
    )

    opts = LossyOptions(distance=1.0, effort=3, use_device=True)
    ragged = make_image(RAGGED_SEED, 1001, 1503)
    imgs = photos + [ragged]
    t0 = time.perf_counter()
    streams = encode_lossy_many(photos, opts, device=dev)
    t_cold = time.perf_counter() - t0
    streams.append(encode_lossy(ragged, opts, device=dev))
    print(f"lossy encode: 8 4K photos in {t_cold} s (cold), "
          f"{sum(len(s) for s in streams[:8]) * 8 / (8 * 3840 * 2160)} "
          f"bpp, ragged {len(streams[8])} bytes", flush=True)
    mp = sum(im.shape[0] * im.shape[1] for im in photos) / 1e6
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = encode_lossy_many(photos, opts, device=dev)
        rates.append(mp / (time.perf_counter() - t0))
    if again != streams[:8]:
        raise AssertionError("a repeated lossy encode gave other streams")
    print(f"lossy encode batch, 8 x 3840x2160 at d1 e3 (host halves on 3 "
          f"threads included): {rates} MP/s (median "
          f"{statistics.median(rates)}), on {card}", flush=True)
    _profile(lambda: encode_lossy_many(photos, opts, device=dev), card,
             "warm lossy encode batch")
    # the device program alone on uploaded pixels (CUDA events)
    sc = _falcon_device_scalars(photos[0].shape, opts)
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in sc[:6]]
    for b in (1, 4):
        px = torch.from_numpy(np.stack(photos[:b])).to(dev)
        ms = _time_ms(lambda: VP._frame_body(px, *args, *sc[6:]), 3)
        print(f"lossy encode device program (_frame_body), {b} x 4K: {ms} "
              f"ms, {ms / b} ms a 4K image, on {card}", flush=True)
        del px
    torch.cuda.empty_cache()
    # the host half alone (the payload's unpacking, context modelling,
    # tokens, the entropy tail, the DC and AC-metadata streams) of each
    # of 4 4K images on one thread, from payloads the card computed
    payloads = VP.encode_lossy_frame_device_batch(
        np.stack(photos[:4]), *sc[:6], h=sc[6], w=sc[7], yb=sc[8],
        xb=sc[9], x_qm_mul=sc[10], device=dev)
    secs = []
    for im, p in zip(photos, payloads):
        o = copy.copy(opts)
        o._predispatched = p
        t0 = time.perf_counter()
        encode_lossy(im, o, device=dev)
        secs.append(time.perf_counter() - t0)
    print(f"lossy encode host half alone, one 4K image on one thread: "
          f"{secs} s ({[len(p.idx) for p in payloads]} nonzero quantized "
          f"AC values of {sc[8] * sc[9] * 3 * 63} a payload), on {card}",
          flush=True)

    for i, (img, got) in enumerate(zip(imgs, streams)):
        encode_drift(dev, f"photo{i}" if i < 8 else "ragged", img, opts, got)

    decode_many.device_frames = 0
    outs = decode_many(streams, workers=workers, device=dev)
    if decode_many.device_frames != len(streams):
        raise AssertionError(f"decode_many reconstructed "
                             f"{decode_many.device_frames} of "
                             f"{len(streams)} lossy streams on the card")
    with ProcessPoolExecutor(
            max_workers=min(len(streams), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=host_pool._worker_init) as ex:
        host = list(ex.map(decode, streams))
    worst, values = [], []
    for got, want, img in zip(outs, host, imgs):
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        worst.append(int(diff.max()))
        values.append(psnr(got, img))
    print(f"lossy round trip through decode_many on the card: max diff "
          f"from the host decode {worst}; PSNR (dB) {values}, floor "
          f"{PSNR_FLOOR}", flush=True)
    if max(worst) > 1:
        raise AssertionError("a lossy stream's card decode differs from "
                             "its host decode by more than 1")
    if min(values) < PSNR_FLOOR:
        raise AssertionError(f"a lossy round trip is below the PSNR floor "
                             f"{PSNR_FLOOR}: {values}")


def _leaves(frame):
    """The arrays of a FrameRecon or FrameReconVar, in a fixed order."""
    for name, v in zip(frame._fields, frame):
        if name == "classes":
            for s in sorted(v):
                yield from (np.asarray(a) for a in v[s])
        else:
            yield np.asarray(v)


def main_path_images() -> tuple[list, dict]:
    from bench import make_image

    rng = np.random.default_rng(1234)
    photos = [make_image(s, 2160, 3840) for s in range(8)]
    rgb16 = make_image(20, 1024, 1024).astype(np.uint16) * 256
    rgb16 += rng.integers(0, 256, rgb16.shape, dtype=np.uint16)
    h, w, _ = rgb16.shape
    alpha = np.broadcast_to(
        np.linspace(0, 65535, w).astype(np.uint16)[None, :, None],
        (h, w, 1))
    smooth = make_image(22, 1000, 2300)
    extras = dict(
        rgba16=np.concatenate([rgb16, alpha], axis=2),
        gray=make_image(21, 1500, 1000)[:, :, 1],
        smooth=smooth,
        noise=rng.integers(0, 256, smooth.shape, dtype=np.uint8),
    )
    return photos, extras


def phase_decode(jobs: list) -> None:
    """Decode every stream on the host, in spawned worker processes (the
    modular prefix decoder is pure Python), and require exact pixels."""
    from libjxl_torch.api.decoder import decode_exact

    t0 = time.perf_counter()
    ok = decode_exact([s for _, s, _ in jobs], [im for _, _, im in jobs],
                      workers=os.cpu_count() or 1)
    bad = [name for (name, _, _), good in zip(jobs, ok) if not good]
    if bad:
        raise AssertionError(f"streams that do not decode exactly: {bad}")
    print(f"decode: all {len(jobs)} streams decode to their input exactly "
          f"({time.perf_counter() - t0} s on the host)", flush=True)


def build_kernels(sources) -> None:
    """nvcc for each kernel source, all started together; prints each
    -Xptxas -v report."""
    from libjxl_torch.utils.cuda_build import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(build, sources))
    for name, (so_path, report) in zip(sources, built):
        print(f"built {os.path.relpath(so_path)}; nvcc -Xptxas -v:",
              flush=True)
        print(report.strip(), flush=True)
    print(f"kernels built in {time.perf_counter() - t0} s", flush=True)


def filter_records(filters: dict, counts: dict) -> list:
    """The kernels-line records of Gaborish and of each EPF pass, with the
    launches of the decode batches' runs (``counts``; None where they were
    not driven)."""
    recs = [dict(name="gaborish", route="cuda", source=FILTERS_SOURCE,
                 replaces=GAB_REPLACES, launches=counts.get("gaborish"),
                 **filters["gab"])]
    for p in (0, 1, 2):
        launches = counts["epf_passes"][p] if counts else None
        recs.append(dict(name=f"epf{p}", route="cuda", source=FILTERS_SOURCE,
                         replaces=EPF_REPLACES, launches=launches,
                         **filters[p]))
    return recs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    try:
        import libjxl_torch  # noqa: F401
    except ImportError:
        sys.exit("chip_smoke: libjxl_torch is not importable: run the "
                 "script from the root of a checkout of the repository")
    from libjxl_torch.api.encoder import (
        EncodeOptions, encode_lossless, encode_lossless_many, native_lib,
    )
    from libjxl_torch.models.pack_kernel import pack_chunks
    from libjxl_torch.parallel import host_pool

    # 1. environment
    card = card_line()
    print(card, flush=True)
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)}", flush=True)

    if sys.argv[1:] == ["--filters"]:
        build_kernels(("filters",))
        print(json.dumps({"filters": filter_records(
            phase_filters(dev, card), {})}), flush=True)
        return
    if sys.argv[1:]:
        sys.exit(f"chip_smoke: unknown arguments {sys.argv[1:]}")

    # 2. build: one nvcc per kernel source, all started together
    build_kernels(("pack_kernel", "filters"))
    t0 = time.perf_counter()
    native_lib()
    print(f"native host library ready ({time.perf_counter() - t0} s)",
          flush=True)

    # 3. the kernels against their plain versions on the card
    rec = phase_kernel(dev)
    filters = phase_filters(dev, card)

    # 4. the encode path
    photos, extras = main_path_images()
    names = ([f"photo{i}" for i in range(len(photos))]
             + list(extras))
    batch = photos + list(extras.values())
    opts = EncodeOptions(use_device=True, entropy="prefix-device")
    pack_chunks.launches = 0
    t0 = time.perf_counter()
    streams = encode_lossless_many(batch, opts, device=dev)
    t_first = time.perf_counter() - t0
    launches = pack_chunks.launches
    if launches <= 0:
        raise AssertionError("the main path launched no pack kernel")
    print(f"main path: {len(batch)} images in {t_first} s (cold), "
          f"{launches} pack kernel launches", flush=True)
    # trap: the noise image overflows the smooth image's capacity
    # estimate, so it is re-coded with its own code, as when alone
    solo = encode_lossless_many([extras["noise"]], opts, device=dev)[0]
    if solo != streams[names.index("noise")]:
        raise AssertionError("noise image was not re-coded with its own "
                             "code after the capacity overflow")
    two_pass = encode_lossless(extras["rgba16"], opts, device=dev)
    ans = encode_lossless(extras["gray"], EncodeOptions(use_device=True),
                          device=dev)

    rates = []
    mp = sum(im.shape[0] * im.shape[1] for im in photos) / 1e6
    for _ in range(3):
        t0 = time.perf_counter()
        again = encode_lossless_many(photos, opts, device=dev)
        rates.append(mp / (time.perf_counter() - t0))
    if again != streams[:len(photos)]:
        raise AssertionError("a repeated encode gave other streams")
    bpp = sum(len(s) for s in streams[:len(photos)]) * 8 / (mp * 1e6)
    print(f"batch encode, 8 x 3840x2160 RGB8: {rates} MP/s "
          f"(median {statistics.median(rates)}), {bpp} bpp, "
          f"on {card}", flush=True)

    # 5. the decode path: the DCT8 batch, the variable-block batch, their
    # host decode check and both with the process-pool host stage
    batches = decode_batches()
    workers = os.cpu_count() or 1
    t0 = time.perf_counter()
    host_pool.warm(workers)
    print(f"decode_many's host pool of {workers} processes warm in "
          f"{time.perf_counter() - t0} s", flush=True)
    counts, outputs = {}, {}
    for label, dbatch in batches.items():
        counts[label], outputs[label] = phase_decode_batch(dev, card, label,
                                                           dbatch)
    phase_host_check(batches, outputs)
    del outputs
    phase_host_stage(card, batches, workers)

    # 6. decode() with its filters on the card
    counts["decode()"] = phase_decode_api(dev, card)
    phase_host_routed(dev, card, photos, workers)

    # 7. the lossy encode, and its round trip through decode_many
    phase_lossy_encode(dev, card, photos, workers)
    host_pool.shutdown()

    # 8. decode every lossless stream on the host
    jobs = ([(n, s, im) for n, s, im in zip(names, streams, batch)]
            + [("rgba16 two-pass", two_pass, extras["rgba16"]),
               ("gray ans", ans, extras["gray"])])
    phase_decode(jobs)

    # 9. neither jax nor the JAX package was imported
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "libjxl_tpu")]
    if loaded:
        raise AssertionError(f"imported: {loaded}")
    print("jax, libjxl_tpu: not imported", flush=True)

    # 10. results
    print(card_line(), flush=True)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    # the filter launches of both decode batches and of decode()
    both = dict(gaborish=sum(c["gaborish"] for c in counts.values()),
                epf_passes=[sum(c["epf_passes"][p] for c in counts.values())
                            for p in range(3)])
    print(json.dumps({"kernels": [
        dict(name="pack_chunks", route="cuda", source=PACK_SOURCE,
             replaces=PACK_REPLACES, launches=launches, **rec),
    ] + filter_records(filters, both)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
