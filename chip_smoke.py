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
  against the float64 host encoder (each value that differs explained
  as a float64 value on a rounding boundary, or one that follows such a
  value), and every stream decoded by ``decode_many`` on the card,
  within +-1 of the host decode and above a PSNR floor;
* the VarDCT lossy encode at efforts 5-7, ``encode_lossy_many(imgs,
  LossyOptions(distance=1.0, effort=7, use_device=True))`` on photos 0
  and 1, and ``encode_lossy`` of photo 2 at d2 e7, photo 0 at d1 e5 and
  the ragged image at d5 e7 (``E7_JOBS``): the front end, the ACS cost
  grids, the transform and the butteraugli loop on the card, the loop
  and the EPF sharpness search through the Gaborish/EPF kernels; every
  first pass held to the same program on the CPU stage by stage, photo
  0's whole d1 e7 stream to the CPU's (equal, or the fallback gate), and
  every stream through ``decode_many`` on the card within +-1 of the
  host decode and beyond the PSNR and butteraugli values the CPU's
  encode reaches;
* the command-line tools (``libjxl_torch.cli``) through ``main(argv)``
  at 4K on PNM files (``phase_cli``): ``cjxl --device`` at d1 e7, d1 e3
  and d0 giving the lossy phases' streams and an exact lossless one,
  ``djxl`` of the 4K fixtures giving ``decode()``'s output with its
  launches, ``params.compress`` and ``benchmark_xl`` through the pack
  kernel, the committed JPEGs recompressed and given back byte for byte,
  and ``python -m`` processes of the tools that build nothing and give
  the in-process files.

Phases: environment, build (nvcc for sm_90a, one process per kernel
source, all at once, + the native host library), the pack kernel and the
Gaborish/EPF kernels against their plain PyTorch versions at the shapes
of the main paths, the encode path (with launch counts and the batch
rate), its host decode check, the two decode batches (each with launch
counts, the chunks handed to the device, the batch rate, the host-stage
and the device-only time; the var batch also with one ``torch.profiler``
run), their host decode check, the host stage alone on the pool and on
threads, ``decode()`` on the card (launch counts per header and band
window, times next to the host filters'), the host-routed
``decode_many`` (launches, time on threads against one ``decode`` after
another), the lossy encode (the batch rate, the device program's time,
the host half's time, a ``torch.profiler`` run, its streams against the
CPU's and the host encoder's, the round trip through ``decode_many``),
the effort 5-7 encode (the filter launches, the batch rate, the ``prof``
stages, the device stages' CUDA-event times, a ``torch.profiler`` run,
the checks above), the command-line tools (each tool's wall ms and
launches), the host decode of the lossless streams, and a check
that neither JAX nor the JAX package was imported. The later phases
print how far into the run they ended. The last two lines are the kernels' JSON
record and ``{"ok": true, "device": ...}``. Any failure raises and exits
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
# the JPEGs the CLI phase recompresses (made with PIL elsewhere)
JPEG_FIXTURES = os.path.join("tests", "data", "torch_cli")
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
# the effort 5-7 encode (name, make_image seed, h, w, distance, effort):
# photos 0 and 1 at d1 e7 through encode_lossy_many (Gaborish + EPF1),
# photo 2 at d2 e7 (EPF1 + EPF2), photo 0 at d1 e5 (no loop) and the
# ragged image at d5 e7 (EPF0-2, the two-candidate sharpness search);
# each stream's PSNR floor (dB) and butteraugli ceiling: 0.05 beyond
# the values that tests/data/torch_vardct_var/e7_quality.py measures for
# these encodes on the CPU (on the card machine's CPU: 40.5802, 1.5871;
# 40.5784, 1.4905; 39.5642, 1.9787; 40.6236, 1.6440; 37.5690, 2.2589)
E7_JOBS = (("photo0_d1_e7", 0, 2160, 3840, 1.0, 7),
           ("photo1_d1_e7", 1, 2160, 3840, 1.0, 7),
           ("photo2_d2_e7", 2, 2160, 3840, 2.0, 7),
           ("photo0_d1_e5", 0, 2160, 3840, 1.0, 5),
           ("ragged_d5_e7", RAGGED_SEED, 1001, 1503, 5.0, 7))
E7_FLOORS = {"photo0_d1_e7": (40.53, 1.637), "photo1_d1_e7": (40.528, 1.540),
             "photo2_d2_e7": (39.514, 2.028), "photo0_d1_e5": (40.573, 1.694),
             "ragged_d5_e7": (37.519, 2.308)}
E7_TOL = dict(qf=1e-4, grids=1e-3, block_sums=1e-3, boundary=1e-3)


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


def phase_decode_api(dev, card: str) -> tuple:
    """``decode()`` of a 4K DCT8 and a 4K variable-block fixture with its
    restoration filters on the card: with ``device_filters = True`` (one
    whole-frame launch of each filter the header asks for, the colour
    output on the card) and in auto mode (4 MP and more: one launch a
    256-row band window), each run twice with the counts set to 0 before
    and read after; each output within +-1 of the float64 host filters,
    auto bit for bit equal to ``decode_rows`` on the card. Returns the
    filter launches of the first run of each mode, and by fixture name
    the auto output with the launches of its first run."""
    from libjxl_torch.api.decoder import decode, decode_rows
    from libjxl_torch.config import config

    total = dict(gaborish=0, epf_passes=[0, 0, 0])
    autos = {}
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
                        if mode == "auto":
                            autos[name] = got
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
            autos[name] = (outs["auto"], autos[name])
            print(f"decode() of {name} ({m['h']}x{m['w']}), ms a decode: "
                  f"host float64 filters {host_ms}; device filters "
                  f"resident {times['resident']}, auto (band windows) "
                  f"{times['auto']} (first run of each cold), on {card}",
                  flush=True)
    finally:
        config.device_filters = None
    return total, autos


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
    ``encode_lossy`` codes for ``img`` with ``opts``; the encoder's aux
    (the host encoder's float64 padded XYB and 8x8 DCT), the DC steps and
    the encoder's state."""
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
            o._aux, st["quantizer"].mul_dc(st["matrices"].dc_quant), st)


def _dc_before_rounding(stored, mul_dc) -> np.ndarray:
    """(yb, xb, 3) DC values over their steps before rounding, in the
    encoder's order (B less the dequantized Y), in the dtype of
    ``stored`` (yb, xb, 3, 64) and ``mul_dc``."""
    dcx, dcy, dcb = (stored[:, :, c, 0] for c in range(3))
    q_y = np.round(dcy / mul_dc[1])
    return np.stack([dcx / mul_dc[0], dcy / mul_dc[1],
                     (dcb - q_y * mul_dc[1]) / mul_dc[2]], -1)


def _boundary_dist(v, th=None):
    """How far float64 values before rounding lie from where a float32
    rounding can land on the other side: a .5 boundary, or the dead-zone
    threshold ``th`` (zero below it)."""
    a = np.abs(np.asarray(v, np.float64))
    dist = np.abs(a - np.floor(a) - 0.5)
    return dist if th is None else np.minimum(dist, np.abs(a - th))


def _float64_before_rounding(xyb64, acs, anchors, rq, matrices, quant,
                             x_qm_mul: float, ytox, ytob, blocks,
                             tiles) -> tuple:
    """The host encoder's own float64 values before rounding, on the
    padded XYB ``xyb64``: for each anchor (by, bx) in ``blocks``, the
    quantized values' (3, size) inputs (Y from ``transform_all``'s
    coefficients, X and B its residuals against the CfL maps ``ytox`` and
    ``ytob`` as ``finish_chroma`` forms them) and their (3, size)
    dead-zone thresholds; for each 64x64 tile (ty, tx) in ``tiles``, the
    least-squares CfL ratios (x, b) before rounding, from the whole-frame
    8x8 DCT as the encoder computes them."""
    from libjxl_torch.vardct.enc_acs import _thresholds, transform_all
    yb, xb = acs.shape
    cs = 1.0 / 84.0

    def run(acs_, keep):
        cc = {}
        blk, _ = transform_all(xyb64, acs_, keep, rq, matrices, quant,
                               x_qm_mul, coef_cache=cc)
        return blk, cc

    keep = np.zeros((yb, xb), bool)
    for by, bx in blocks:
        keep[by, bx] = True
    blk, cc = run(acs, anchors & keep)
    values = {}
    for s in (k for k in cc if isinstance(k, int)):
        by0, bx0 = np.nonzero(anchors & keep & (acs == s))
        for i, (by, bx) in enumerate(zip(by0, bx0)):
            b = blk[(by, bx)]
            qac = quant.scale * b["qf"]
            fx = ytox[by // 8, bx // 8] * cs
            fb = 1.0 + ytob[by // 8, bx // 8] * cs
            v = np.stack([
                (b["stored_x"] - fx * b["y_rt"]) * (b["inv_table"][0] *
                                                    (qac * x_qm_mul)),
                cc[s][1][i] * (b["inv_table"][1] * qac),
                (b["stored_b"] - fb * b["y_rt"]) * (b["inv_table"][2] *
                                                    qac)])
            th = np.stack([b["th_xb"], _thresholds(b["nby"], b["nbx"], True),
                           b["th_xb"]])
            values[(int(by), int(bx))] = (v, th)
    keep8 = np.zeros((yb, xb), bool)
    for ty, tx in tiles:
        keep8[ty * 8:ty * 8 + 8, tx * 8:tx * 8 + 8] = True
    blk8, _ = run(np.zeros_like(acs), keep8)
    y_rt, sx, sb = (np.zeros((yb, xb, 63)) for _ in range(3))
    for (by, bx), b in blk8.items():
        y_rt[by, bx], sx[by, bx], sb[by, bx] = (
            b["y_rt"][1:], b["stored_x"][1:], b["stored_b"][1:])
    ratios = {}
    for ty, tx in tiles:
        sl = (slice(ty * 8, ty * 8 + 8), slice(tx * 8, tx * 8 + 8))
        yt = y_rt[sl].reshape(-1)
        den = float(yt @ yt)
        ratios[(ty, tx)] = ((sx[sl].reshape(-1) @ yt / den / cs,
                             (sb[sl].reshape(-1) @ yt / den - 1.0) / cs)
                            if den >= 1e-9 else (0.0, 0.0))
    return values, ratios


def _explain(label: str, where, dist, follows, why: str) -> None:
    """Print how many values of ``label`` differ and why; fail on one
    that neither lies within E7_TOL["boundary"] of a rounding boundary in
    float64 (``dist``) nor follows another value that differs
    (``follows``, described by ``why``)."""
    tol = E7_TOL["boundary"]
    alone = [d for d, f in zip(dist, follows) if not f]
    print(f"  {len(where)} {label} values differ: {len(alone)} whose float64 "
          f"value lies within {max(alone, default=0.0)!r} of a rounding "
          f"boundary, {sum(follows)} {why}", flush=True)
    if max(alone, default=0.0) > tol:
        bad = [w for w, d, f in zip(where, dist, follows)
               if not f and d > tol][:3]
        raise AssertionError(f"{label} values differ away from a rounding "
                             f"boundary, e.g. at {bad}")


def _explain_quantized(label: str, xyb64, state: tuple, pairs: dict,
                       cfl: tuple) -> None:
    """Explain, with ``_explain``, each quantized AC value and CfL factor
    where one encode (got) differs from another (want): ``pairs`` maps
    each anchor (by, bx) where they differ to its (got, want) (3, size)
    values; ``cfl`` is ((ytox got, want), (ytob got, want)); ``state`` is
    (acs, anchors, raw quant, matrices, quantizer, x_qm_mul) of the
    encode. A value is explained by its float64 value before rounding
    (``_float64_before_rounding`` on ``xyb64``, against want's CfL maps)
    within E7_TOL["boundary"] of a .5 or dead-zone boundary, or, for X
    and B, by its Y value or its tile's CfL factor differing; a CfL
    factor by its float64 ratio on a .5 boundary, or a Y value of its
    tile differing."""
    (x_got, x_want), (b_got, b_want) = cfl
    diff_x, diff_b = x_got != x_want, b_got != b_want
    tiles = {tuple(int(i) for i in t)
             for t in np.argwhere(diff_x | diff_b)}
    values, ratios = _float64_before_rounding(
        xyb64, *state, ytox=x_want, ytob=b_want, blocks=pairs, tiles=tiles)
    y_tiles = {(by // 8, bx // 8) for (by, bx), (a, b) in pairs.items()
               if (a[1] != b[1]).any()}
    for m, (key, diff) in enumerate((("ytox", diff_x), ("ytob", diff_b))):
        where = [tuple(int(i) for i in t) for t in np.argwhere(diff)]
        _explain(f"{label}{key}", where,
                 [float(_boundary_dist(ratios[t][m])) for t in where],
                 [t in y_tiles for t in where],
                 "of tiles where a Y value differs")
    where, dist, follows = [], [], []
    for (by, bx), (a, b) in pairs.items():
        v, th = values[(by, bx)]
        for c, k in np.argwhere(a != b):
            where.append((by, bx, int(c), int(k)))
            dist.append(float(_boundary_dist(v[c, k], th[c, k])))
            follows.append(c != 1 and bool(
                a[1, k] != b[1, k] or
                (diff_x if c == 0 else diff_b)[by // 8, bx // 8]))
    _explain(f"{label}AC", where, dist, follows,
             "X or B values whose Y or tile CfL factor differs")


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
    differs, and the size ratio. It fails if a value is off by more than
    1, the sizes by more than 1%, or a value differs that neither lies
    within E7_TOL["boundary"] of a rounding boundary in float64 nor
    follows another value that differs: a B DC its block's Y DC, an X or
    B AC value its Y value or its tile's CfL factor, a CfL factor a Y
    value of its tile."""
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
    q_host, aux64, mul64, st = _quantized(img, host_opts, None)
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
    dc64 = _dc_before_rounding(aux64["stored_dct"],
                               np.asarray(mul64, np.float64))
    # each DC that differs either has its float64 value next to a .5
    # boundary or is a B value whose block's Y differs (B is coded less
    # the dequantized Y)
    where = list(zip(*np.nonzero(diffs[1])))
    _explain("DC", where, [float(_boundary_dist(dc64[i])) for i in where],
             [c == 2 and diffs[1][by, bx, 1] > 0 for by, bx, c in where],
             "B values whose block's Y differs")
    for (by, bx, c), _ in zip(where, range(3)):
        print(f"  DC ({by}, {bx}) channel {'XYB'[c]}: device "
              f"{int(q_dev[1][by, bx, c])} from float32 "
              f"{float(dc32[by, bx, c])!r}, host "
              f"{int(q_host[1][by, bx, c])} from float64 "
              f"{float(dc64[by, bx, c])!r}", flush=True)
    # each AC value and CfL factor that differs: its float64 value next
    # to a rounding boundary, or one that follows such a value
    yb, xb = st["raw_quant"].shape
    pairs = {(int(by), int(bx)): (q_dev[0][by, bx], q_host[0][by, bx])
             for by, bx in {(i[0], i[1]) for i in np.argwhere(diffs[0])}}
    _explain_quantized(
        "", aux64["xyb_cache"][0],
        (np.zeros((yb, xb), np.int32), np.ones((yb, xb), bool),
         st["raw_quant"], st["matrices"], st["quantizer"],
         1.25 ** (st["x_qm_scale"] - 2)),
        pairs, ((q_dev[2], q_host[2]), (q_dev[3], q_host[3])))
    if max(int(d.max()) for d in diffs) > 1 or abs(ratio - 1) > 0.01:
        raise AssertionError(f"lossy encode {name}: device and host "
                             "streams drift too far apart")


def phase_lossy_encode(dev, card: str, photos: list, workers: int) -> list:
    """The VarDCT lossy encode on the card: ``encode_lossy_many`` of the 8
    4K photos at distance 1, effort 3, and ``encode_lossy`` of a ragged
    image; the batch rate, the device program's time a 4K image, the
    host half's time and a profiled batch; every stream through
    ``encode_drift``; every stream through ``decode_many`` on
    the card, within +-1 of the float64 host decode and above the PSNR
    floor. Returns the streams (the photos', then the ragged image's)."""
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
    return streams


def _e7_images(photos: list) -> dict:
    """The images of E7_JOBS by name (the 4K photos are the main path's)."""
    from bench import make_image
    return {name: (photos[seed] if h == 2160 else make_image(seed, h, w))
            for name, seed, h, w, _, _ in E7_JOBS}


def _loop_filter(data: bytes):
    """The stream's first frame's loop filter (Gaborish, EPF passes)."""
    from libjxl_torch.api.codestream import parse_codestream
    from libjxl_torch.api.container import extract_codestream
    return parse_codestream(extract_codestream(data))[1][0].header.loop_filter


def _e7_launches(stream: bytes, d: float, effort: int) -> list:
    """The Gaborish and EPF0/1/2 launches of one effort >= 5 encode on the
    card: at effort >= 7 each of the 2 loop iterations filters once, and
    the sharpness search filters with Gaborish once and with the EPF
    chain once per candidate (3, or 2 above distance 4.5)."""
    if effort < 7:
        return [0, 0, 0, 0]
    lf = _loop_filter(stream)
    k = int(lf.epf_iters)
    chains = 2 + ((2 if d > 4.5 else 3) if k > 0 and d >= 0.5 else 0)
    gab = int(lf.gab) * (2 + (1 if k > 0 and d >= 0.5 else 0))
    return [gab] + [chains * int(k >= n) for n in (3, 1, 2)]


def _first_pass_on_card(dev, img, d: float, effort: int) -> tuple:
    """The iterated encode's first pass on the card (``_recon_only``), with
    what each device stage was given and returned: (state, aux, {stage:
    (args, kwargs, result)})."""
    from libjxl_torch.models import vardct_heuristics as TH
    from libjxl_torch.models import vardct_transform as TT
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy

    seen, saved = {}, []
    for mod, fn, key in ((TH, "front_device", "front"),
                         (TH, "acs_grids_device", "grids"),
                         (TT, "transform_quantize_device", "transform")):
        orig = getattr(mod, fn)
        saved.append((mod, fn, orig))

        def spy(*a, _orig=orig, _key=key, **k):
            seen[_key] = (a, k, _orig(*a, **k))
            return seen[_key][2]

        setattr(mod, fn, spy)
    try:
        aux = {}
        o = LossyOptions(distance=d, effort=effort, use_device=True)
        o._aux, o._in_iteration, o._recon_only = aux, True, True
        encode_lossy(img, o, device=dev)
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)
    return aux.pop("recon_state"), aux, seen


def _explain_transform(card: dict, cpu: dict, args: tuple) -> None:
    """Explain each quantized coefficient and CfL factor where the card's
    transform differs from the CPU's (``_explain_quantized`` on the
    transform's inputs ``args``)."""
    pairs = {k: (v["q"], cpu["blocks_q"][k]["q"])
             for k, v in card["blocks_q"].items()
             if (v["q"] != cpu["blocks_q"][k]["q"]).any()}
    if not pairs and np.array_equal(card["ytox"], cpu["ytox"]) and \
            np.array_equal(card["ytob"], cpu["ytob"]):
        return
    xyb_d, *state = args
    _explain_quantized("transform ", xyb_d.cpu().numpy().astype(np.float64),
                       tuple(state), pairs,
                       ((card["ytox"], cpu["ytox"]),
                        (card["ytob"], cpu["ytob"])))


def e7_first_pass_check(dev, card: str, name: str, img, d: float,
                        effort: int) -> dict:
    """The first pass's device stages on the card against the same program
    on the CPU, each given the card's inputs: the quant field within
    E7_TOL["qf"] relative; at effort >= 7 the ACS grids within
    E7_TOL["grids"] of each grid's max and the ACS map chosen from the
    CPU's grids equal; the transform's quantized coefficients and CfL
    maps equal or explained (``_explain_transform``); and the first loop
    iteration's block sums within E7_TOL["block_sums"]. Returns the
    first pass's products for the timings."""
    import torch

    from libjxl_torch.models import vardct_heuristics as TH
    from libjxl_torch.models import vardct_transform as TT
    from libjxl_torch.models.vardct_loop import LoopState
    from libjxl_torch.vardct.enc_acs import choose_acs

    h, w = img.shape[:2]
    state, aux, seen = _first_pass_on_card(dev, img, d, effort)
    a, k, (qf_d, xyb_d, pre_d) = seen["front"]
    qf_c, xyb_c, pre_c = TH.front_device(*a, **dict(k, device="cpu"))
    qf_rel = float((qf_d.cpu() - qf_c).abs().max() / qf_c.abs().max())
    line = (f"e7 phase {name}, the first pass on the card against the CPU: "
            f"quant field max rel diff {qf_rel}, padded XYB max abs diff "
            f"{float((xyb_d.cpu() - xyb_c).abs().max())}")
    if qf_rel > E7_TOL["qf"]:
        raise AssertionError(line)
    out = dict(state=state, aux=aux, front=seen["front"])
    if effort < 7:
        print(line + " (effort 5: the grids and the transform run on the "
              "host)", flush=True)
        return out
    a, _, grids_d = seen["grids"]
    grids_c = TH.acs_grids_device(a[0].cpu(), *a[1:])
    g_rel = max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
                for s in grids_c for x, y in zip(grids_d[s], grids_c[s])
                if y.size)
    xyb_host = aux["xyb_cache"][0]
    acs_c, anc_c, _ = choose_acs(
        xyb_host, a[1], a[2], a[3], d, try_small=True, try_64=True,
        try_32=True, grids=grids_c)
    same_acs = bool(np.array_equal(acs_c, aux["acs"]) and
                    np.array_equal(anc_c, aux["anchors"]))
    a, _, tq_d = seen["transform"]
    tq_c = TT.transform_quantize_device(a[0].cpu(), *a[1:])
    n_q = sum(int((v["q"] != tq_c["blocks_q"][key]["q"]).sum())
              for key, v in tq_d["blocks_q"].items())
    dc_diff = float(np.abs(tq_d["dc_float"] - tq_c["dc_float"]).max())
    # the first loop iteration on the card and on the CPU
    x_qm_mul = 1.25 ** (state["x_qm_scale"] - 2)
    qf = aux["qf_field"].copy()
    ls = LoopState(state, aux, None, d, x_qm_mul, h, w, orig_u8=img,
                   device=dev)
    cpu_aux = dict(aux, coef_cache=dict(aux["coef_cache"], dev={
        s: (v.cpu() if isinstance(v, torch.Tensor) else
            tuple(t.cpu() for t in v))
        for s, v in aux["coef_cache"]["dev"].items()}))
    sums_d = ls.block_sums(qf)
    sums_c = LoopState(state, cpu_aux, None, d, x_qm_mul, h, w,
                       orig_u8=img, device="cpu").block_sums(qf)
    s_rel = float(np.abs(sums_d - sums_c).max() / sums_c.max())
    line += (f"; ACS grids max rel diff {g_rel}, ACS map from the CPU's "
             f"grids {'equal' if same_acs else 'DIFFERENT'}; transform: "
             f"quantized coefficients that differ {n_q} of "
             f"{sum(v['q'].size for v in tq_c['blocks_q'].values())}, "
             f"ytox/ytob that differ "
             f"{int((tq_d['ytox'] != tq_c['ytox']).sum())}/"
             f"{int((tq_d['ytob'] != tq_c['ytob']).sum())}, DC grid max abs "
             f"diff {dc_diff}; first loop iteration's block sums max rel "
             f"diff {s_rel}")
    print(line, flush=True)
    if g_rel > E7_TOL["grids"] or not same_acs or \
            s_rel > E7_TOL["block_sums"] or dc_diff > 1e-4:
        raise AssertionError(f"e7 phase {name}: a first-pass stage on the "
                             "card is off the CPU's")
    _explain_transform(tq_d, tq_c, a)
    out.update(loop=ls, qf=qf, transform=a)
    return out


def phase_lossy_e7(dev, card: str, photos: list, workers: int) -> tuple:
    """The effort 5-7 VarDCT encode on the card (E7_JOBS): photos 0 and 1
    at d1 e7 through ``encode_lossy_many``, the others through
    ``encode_lossy``, the Gaborish/EPF launches of that run (returned for
    the kernels line) checked against the count each stream's loop
    filter implies; the batch rate; the prof stages of one encode; the
    CUDA-event times of the device stages; the device idle share of one
    profiled encode; every stream's first pass against the CPU
    (``e7_first_pass_check``); photo 0's d1 e7 stream against the whole
    encode on the CPU (equal, or the fallback gate: the same ACS map,
    size within 1%, butteraugli within 0.05); every stream through
    ``decode_many`` on the card, within +-1 of the host decode, and
    above its PSNR floor and below its butteraugli ceiling. Returns the
    launches and the streams by job name."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from libjxl_torch.api.decoder import _decode_prefilter, decode, decode_many
    from libjxl_torch.metrics.butteraugli import (
        butteraugli_diffmap, butteraugli_distance_srgb,
    )
    from libjxl_torch.models import vardct_heuristics as TH
    from libjxl_torch.models import vardct_transform as TT
    from libjxl_torch.models.vardct_loop import _loop_step
    from libjxl_torch.parallel import host_pool
    from libjxl_torch.utils import prof
    from libjxl_torch.vardct.enc_roundtrip import linear_clipped
    from libjxl_torch.vardct.frame_enc import (
        LossyOptions, encode_lossy, encode_lossy_many,
    )

    imgs = _e7_images(photos)
    opts = {name: LossyOptions(distance=d, effort=e, use_device=True)
            for name, _, _, _, d, e in E7_JOBS}
    pair = ["photo0_d1_e7", "photo1_d1_e7"]
    mp = sum(imgs[n].shape[0] * imgs[n].shape[1] for n in pair) / 1e6

    # the main run: the launches of the filter kernels, counted from 0
    _reset_filter_counts()
    t0 = time.perf_counter()
    streams = dict(zip(pair, encode_lossy_many(
        [imgs[n] for n in pair], opts[pair[0]], workers=workers,
        device=dev)))
    t_cold = time.perf_counter() - t0
    prof.enabled = True
    stages = {}
    try:
        for name, _, _, _, d, e in E7_JOBS:
            if name in pair:
                continue
            prof.reset()
            t0 = time.perf_counter()
            streams[name] = encode_lossy(imgs[name], opts[name], device=dev)
            stages[name] = dict(seconds=time.perf_counter() - t0,
                                **prof.report())
    finally:
        prof.enabled = False
    counts = _filter_counts()
    got = [counts["gaborish"]] + counts["epf_passes"]
    want = [sum(x) for x in zip(*(
        _e7_launches(streams[name], d, e)
        for name, _, _, _, d, e in E7_JOBS))]
    print(f"e7 phase: Gaborish and EPF0/1/2 launches {got} (from each "
          f"stream's loop filter: {want}); 2 4K photos at d1 e7 in {t_cold} "
          f"s (cold, encode_lossy_many on {workers} threads); sizes "
          f"{ {n: len(v) for n, v in streams.items()} } bytes", flush=True)
    if got != want or not all(got):
        raise AssertionError(f"e7 phase: filter launches {got}, want {want}")
    for name, st in stages.items():
        print(f"e7 phase {name}: {st.pop('seconds')} s alone; prof stages "
              f"(s, calls): {st}, on {card}", flush=True)

    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = encode_lossy_many([imgs[n] for n in pair], opts[pair[0]],
                                  workers=workers, device=dev)
        rates.append(mp / (time.perf_counter() - t0))
    if again != [streams[n] for n in pair]:
        raise AssertionError("e7 phase: a repeated encode gave other "
                             "streams")
    print(f"e7 phase batch, 2 x 3840x2160 at d1 e7 (encode_lossy_many, "
          f"{workers} threads): cold {mp / t_cold} MP/s, warm {rates} MP/s "
          f"(median {statistics.median(rates)}, spread {min(rates)}-"
          f"{max(rates)}), on {card}", flush=True)
    prof.enabled = True
    prof.reset()
    t0 = time.perf_counter()
    encode_lossy(imgs[pair[0]], opts[pair[0]], device=dev)
    rep = prof.report()
    prof.enabled = False
    print(f"e7 phase photo0_d1_e7 alone: {time.perf_counter() - t0} s; prof "
          f"stages (s, calls): {rep}, on {card}", flush=True)
    _profile(lambda: encode_lossy(imgs[pair[0]], opts[pair[0]], device=dev),
             card, "warm e7 encode of photo0_d1_e7")

    # every stream's first pass against the CPU; photo 0's products time
    # the device stages
    checks = {}
    for name, _, _, _, d, e in E7_JOBS:
        checks[name] = e7_first_pass_check(dev, card, name, imgs[name], d, e)
    c0 = checks[pair[0]]
    a, k, _ = c0["front"]
    ms = dict(front_device=_time_ms(lambda: TH.front_device(*a, **k), 3))
    _, targs = TT.device_inputs(*c0["transform"])
    ms["transform_quantize"] = _time_ms(
        lambda: TT.transform_quantize(*targs), 3)
    sargs = c0["loop"].step_args(c0["qf"])
    ms["loop_step"] = _time_ms(lambda: _loop_step(**sargs, score=True), 3)
    lin = linear_clipped(_loop_step(**sargs, score=False))
    orig = sargs["orig_lin"]
    ms["butteraugli_diffmap_4k"] = _time_ms(
        lambda: butteraugli_diffmap(orig, lin, hf_asymmetry=0.8), 3)
    print(f"e7 phase device stages, CUDA-event ms at 3840x2160: {ms}, on "
          f"{card}", flush=True)
    del checks, c0, targs, sargs, lin, orig

    # photo 0 at d1 e7, the whole encode again on the CPU
    t0 = time.perf_counter()
    on_cpu = encode_lossy(imgs[pair[0]], opts[pair[0]], device="cpu")
    cpu_s = time.perf_counter() - t0
    got0 = streams[pair[0]]
    line = (f"e7 phase photo0_d1_e7: the card's stream {len(got0)} bytes, "
            f"the CPU's {len(on_cpu)} ({cpu_s} s on the CPU); size "
            f"difference {len(got0) - len(on_cpu)} bytes")
    if got0 == on_cpu:
        print(line + "; the streams are equal", flush=True)
    else:
        acs = [_decode_prefilter(x)[1] for x in (got0, on_cpu)]
        same = all(np.array_equal(getattr(acs[0], f), getattr(acs[1], f))
                   for f in ("acs_raw", "acs_anchor"))
        dists = [butteraugli_distance_srgb(
            imgs[pair[0]], decode(x, device=dev)[:, :, :3], device=dev)
            for x in (got0, on_cpu)]
        print(line + f"; the streams differ: ACS map "
              f"{'equal' if same else 'DIFFERENT'}, butteraugli of the "
              f"decodes {dists}", flush=True)
        if not same or abs(len(got0) / len(on_cpu) - 1) > 0.01 or \
                abs(dists[0] - dists[1]) > 0.05:
            raise AssertionError("e7 phase photo0_d1_e7: the card's stream "
                                 "fails the fallback gate against the CPU's")

    # the round trip
    names = [n for n, *_ in E7_JOBS]
    decode_many.device_frames = 0
    outs = decode_many([streams[n] for n in names], workers=workers,
                       device=dev)
    if decode_many.device_frames != len(names):
        raise AssertionError(f"decode_many reconstructed "
                             f"{decode_many.device_frames} of {len(names)} "
                             "e7 phase streams on the card")
    with ProcessPoolExecutor(
            max_workers=min(len(names), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=host_pool._worker_init) as ex:
        host = list(ex.map(decode, [streams[n] for n in names]))
    quality = {}
    for name, out, want in zip(names, outs, host):
        diff = int(np.abs(out.astype(np.int64) - want.astype(np.int64)).max())
        quality[name] = (diff, psnr(out, imgs[name]),
                         butteraugli_distance_srgb(imgs[name], out[:, :, :3],
                                                   device=dev))
    print(f"e7 phase round trip through decode_many on the card (max diff "
          f"from the host decode, PSNR dB, butteraugli on the card): "
          f"{quality}; floors and ceilings {E7_FLOORS}", flush=True)
    for name, (diff, p, dist) in quality.items():
        if diff > 1 or p < E7_FLOORS[name][0] or dist > E7_FLOORS[name][1]:
            raise AssertionError(f"e7 phase {name}: round trip {quality[name]}"
                                 f" against {E7_FLOORS[name]}")
    return counts, streams


def _all_counts() -> dict:
    from libjxl_torch.models.pack_kernel import pack_chunks
    return dict(pack=pack_chunks.launches, **_filter_counts())


def _launch_delta(before: dict, after: dict) -> list:
    """[pack, Gaborish, EPF0, EPF1, EPF2] launches between two counts."""
    a = [before["pack"], before["gaborish"]] + before["epf_passes"]
    b = [after["pack"], after["gaborish"]] + after["epf_passes"]
    return [y - x for x, y in zip(a, b)]


def _no_nvcc_env(tmp: str) -> dict:
    """This environment without LIBJXL_TORCH_DEVICE and with no nvcc to be
    found (CUDA_HOME names an empty directory, PATH lists no directory
    that holds nvcc): a kernel that had to be built would raise."""
    env = {k: v for k, v in os.environ.items()
           if k != "LIBJXL_TORCH_DEVICE"}
    env["CUDA_HOME"] = os.path.join(tmp, "no_cuda")
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    return env


def _tool_proc(tool: str, argv: list, env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", f"libjxl_torch.cli.{tool}"] + argv,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _tool_done(name: str, proc: subprocess.Popen, t0: float,
               timeout: float) -> tuple:
    """(stdout, wall ms) of a tool's process; raises unless it exits 0."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{name}: no exit in {timeout} s")
    ms = (time.perf_counter() - t0) * 1e3
    if proc.returncode != 0:
        raise AssertionError(f"{name} exited {proc.returncode}:\n{err}")
    return out, ms


def _built() -> list:
    from libjxl_torch.utils.cuda_build import BUILD_DIR
    return sorted(os.listdir(BUILD_DIR))


def stop_cli(pending: dict) -> None:
    """Stop the CLI phase's 4K ``benchmark_xl`` process if it still runs,
    and remove the phase's temporary directory."""
    import shutil
    proc = pending["proc"]
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()
    shutil.rmtree(pending["tmp"], ignore_errors=True)


def finish_cli(pending: dict) -> None:
    """Read the CLI phase's 4K ``benchmark_xl`` process: its table, its
    bytes the e3 stream's, and no kernel built by any tool's process."""
    out, ms = _tool_done("benchmark_xl 4K", pending["proc"], pending["t0"],
                         600)
    print(f"cli benchmark_xl, photo 0 at 3840x2160 (python -m, {ms} ms "
          f"from its start in the CLI phase to its exit):\n{out}", end="",
          flush=True)
    row = out.splitlines()[2].split()
    if row[0] != "jxl:d1:e3:device" or int(row[2]) != pending["e3_bytes"]:
        raise AssertionError(f"benchmark_xl 4K row {row}: want the e3 "
                             f"stream's {pending['e3_bytes']} bytes")
    if _built() != pending["built"]:
        raise AssertionError("a tool's process built a kernel")
    print(f"cli python -m processes: no kernel built (no nvcc on their "
          f"PATH, the build directory unchanged: {pending['built']})",
          flush=True)


def phase_cli(dev, card: str, photos: list, e3: list, e7: dict,
              autos: dict) -> tuple:
    """The command-line tools and the entry points behind them, at 4K on
    the card, each through ``main(argv)`` in this process (launches
    counted per tool) on files written here (PNM: the card machine has
    no PIL):

    * ``cjxl -d 1 -e 7 --device`` of photo 0 gives the e5-e7 phase's
      stream (``e7``) with the launches its loop filter implies;
      ``cjxl -d 1 -e 3 --device`` gives the e3 phase's (``e3``);
      ``cjxl -d 0 --device`` (the ANS device path) decodes exactly;
    * ``djxl`` of the 4K DCT8 and var fixtures gives ``decode()``'s auto
      output (``autos``) with the same launches;
    * ``params.compress`` with ``use_device=True`` gives
      ``encode_lossless``'s prefix-device stream, through the pack kernel;
    * ``benchmark_xl``: ``jxl:d0:e3:device`` on a 768x512 crop of photo 0
      here (the pack kernel; the host decoder reads prefix streams in
      Python) and ``jxl:d1:e3:device`` on photo 0 at 4K in a process of
      its own, started first (its SSIMULACRA2 is numpy, about 100 s at
      4K) and left running: ``finish_cli`` reads it after the next
      phase, and requires the e3 stream's bytes and an unchanged build
      directory;
    * ``cjxl`` recompresses each committed JPEG and ``djxl`` gives it
      back byte for byte;
    * ``python -m`` processes of ``cjxl`` (the ragged image at d5 e7,
      through the filter kernels) and ``djxl`` (the DCT8 fixture),
      without LIBJXL_TORCH_DEVICE and with no nvcc to be found, give the
      in-process files;
    * ``graft_entry.entry()`` gives the CPU's outputs on the card.

    Returns the launches of the phase's in-process runs, counted from 0,
    and what ``finish_cli`` and ``stop_cli`` take: the running 4K
    ``benchmark_xl`` process and the phase's temporary directory."""
    import tempfile
    from contextlib import redirect_stderr
    from io import StringIO

    from bench import make_image

    from libjxl_torch.api.decoder import decode
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    from libjxl_torch.cli import benchmark_xl
    from libjxl_torch.cli.cjxl import main as cjxl
    from libjxl_torch.cli.djxl import main as djxl
    from libjxl_torch.extras.io import load_image, save_image
    from libjxl_torch.models.pack_kernel import pack_chunks
    from libjxl_torch.params import CompressParams, compress

    def read(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    wall = {}

    def run(label: str, main, argv: list) -> list:
        """main(argv) in this process; returns its launches."""
        before = _all_counts()
        t0 = time.perf_counter()
        with redirect_stderr(StringIO()) as err:
            rc = main(argv)
        wall[label] = (time.perf_counter() - t0) * 1e3
        if rc != 0:
            raise AssertionError(f"{label} exited {rc}: {err.getvalue()}")
        return _launch_delta(before, _all_counts())

    def want_launches(label: str, got: list, want: list) -> None:
        print(f"cli {label}: launches (pack, Gaborish, EPF0/1/2) {got}",
              flush=True)
        if got != want:
            raise AssertionError(f"cli {label}: launches {got}, want {want}")

    # the streams the tools are held to, made before the counts start
    opts = EncodeOptions(use_device=True, entropy="prefix-device")
    want_d0 = encode_lossless(photos[0], opts, device=dev)
    want_crop = encode_lossless(photos[0][:512, :768], opts, device=dev)
    pack_chunks.launches = 0
    _reset_filter_counts()
    pending = dict(tmp=tempfile.mkdtemp(), proc=None, e3_bytes=len(e3[0]))
    tmp = pending["tmp"]
    try:
        def f(name: str) -> str:
            return os.path.join(tmp, name)

        ragged = make_image(RAGGED_SEED, 1001, 1503)
        save_image(f("photo0.ppm"), photos[0])
        save_image(f("ragged.ppm"), ragged)
        save_image(f("crop.ppm"), photos[0][:512, :768])
        pending["built"] = _built()
        env = _no_nvcc_env(tmp)
        pending["t0"] = time.perf_counter()
        pending["proc"] = _tool_proc("benchmark_xl", [
            f("photo0.ppm"), "--codec", "jxl:d1:e3:device"], env)

        # cjxl at 4K on the card
        got = run("cjxl -d 1 -e 7 --device", cjxl, [
            f("photo0.ppm"), f("e7.jxl"), "-d", "1", "-e", "7", "--device"])
        if read(f("e7.jxl")) != e7["photo0_d1_e7"]:
            raise AssertionError("cjxl -d 1 -e 7 --device differs from the "
                                 "e5-e7 phase's stream of photo 0")
        want_launches("cjxl -d 1 -e 7 --device", got,
                      [0] + _e7_launches(e7["photo0_d1_e7"], 1.0, 7))
        got = run("cjxl -d 1 -e 3 --device", cjxl, [
            f("photo0.ppm"), f("e3.jxl"), "-d", "1", "-e", "3", "--device"])
        if read(f("e3.jxl")) != e3[0]:
            raise AssertionError("cjxl -d 1 -e 3 --device differs from the "
                                 "e3 phase's stream of photo 0")
        want_launches("cjxl -d 1 -e 3 --device", got, [0] * 5)
        got = run("cjxl -d 0 --device", cjxl, [
            f("photo0.ppm"), f("d0.jxl"), "-d", "0", "--device"])
        if not np.array_equal(decode(read(f("d0.jxl")), device=dev),
                              photos[0]):
            raise AssertionError("cjxl -d 0 --device does not decode "
                                 "exactly")
        want_launches("cjxl -d 0 --device", got, [0] * 5)
        print(f"cli cjxl of photo 0: -d 1 -e 7 --device and -d 1 -e 3 "
              f"--device give the e7 and e3 phases' streams; -d 0 --device "
              f"({len(read(f('d0.jxl')))} bytes) decodes exactly", flush=True)

        # djxl at 4K: decode() in auto mode, the band windows on the card
        for directory, name in DECODE_API:
            out, launches = autos[name]
            got = run(f"djxl {name}", djxl, [
                os.path.join(directory, name), f(name + ".ppm")])
            if not np.array_equal(load_image(f(name + ".ppm")), out):
                raise AssertionError(f"djxl of {name} differs from decode() "
                                     "in auto mode")
            want_launches(f"djxl {name}", got, [0] + launches)
        print("cli djxl of the 4K DCT8 and var fixtures: decode()'s auto "
              "output, with its launches", flush=True)

        # params.compress: CompressParams(use_device=True) at distance 0
        # takes the pack kernel's entropy path
        before = _all_counts()
        t0 = time.perf_counter()
        data = compress(photos[0], CompressParams(distance=0.0,
                                                  use_device=True))
        wall["params.compress d0 use_device"] = (time.perf_counter()
                                                 - t0) * 1e3
        got = _launch_delta(before, _all_counts())
        print(f"cli params.compress(CompressParams(distance=0, "
              f"use_device=True)) of photo 0: {len(data)} bytes, launches "
              f"{got}", flush=True)
        if data != want_d0 or got[0] <= 0 or any(got[1:]):
            raise AssertionError("params.compress differs from "
                                 "encode_lossless prefix-device, or did not "
                                 f"launch the pack kernel alone: {got}")

        # benchmark_xl, lossless through the pack kernel, here
        before = _all_counts()
        t0 = time.perf_counter()
        table = StringIO()
        rows = benchmark_xl.run_benchmark(
            [benchmark_xl._load(f("crop.ppm"))], ["jxl:d0:e3:device"],
            out=table)
        wall["benchmark_xl jxl:d0:e3:device 768x512"] = (
            time.perf_counter() - t0) * 1e3
        got = _launch_delta(before, _all_counts())
        print(f"cli benchmark_xl, 768x512 crop of photo 0 (launches "
              f"{got}):\n{table.getvalue()}", end="", flush=True)
        if rows[0]["bytes"] != len(want_crop) or rows[0]["psnr"] != 99.99 or \
                got[0] <= 0 or any(got[1:]):
            raise AssertionError(f"benchmark_xl jxl:d0:e3:device: {rows}, "
                                 f"launches {got}")

        # JPEG recompression of the committed JPEGs
        manifest, jpegs = load_fixtures(JPEG_FIXTURES)
        sizes = {}
        for name in sorted(manifest):
            src = os.path.join(JPEG_FIXTURES, name)
            run(f"cjxl {name}", cjxl, [src, f(name + ".jxl")])
            run(f"djxl {name}", djxl, [f(name + ".jxl"), f(name)])
            if read(f(name)) != jpegs[name]:
                raise AssertionError(f"djxl does not give back {name}")
            sizes[name] = (len(jpegs[name]), len(read(f(name + ".jxl"))))
        print(f"cli JPEG recompression (JPEG bytes, JXL bytes): {sizes}; "
              "each given back byte for byte", flush=True)

        # python -m processes: no build, the in-process files
        got = run("cjxl -d 5 -e 7 --device ragged", cjxl, [
            f("ragged.ppm"), f("ragged.jxl"), "-d", "5", "-e", "7",
            "--device"])
        if read(f("ragged.jxl")) != e7["ragged_d5_e7"]:
            raise AssertionError("cjxl of the ragged image at d5 e7 differs "
                                 "from the e5-e7 phase's stream")
        want_launches("cjxl -d 5 -e 7 --device ragged", got,
                      [0] + _e7_launches(e7["ragged_d5_e7"], 5.0, 7))
        name = DECODE_API[0][1]
        procs = {}
        for label, tool, argv, mine, theirs in (
                ("cjxl -d 5 -e 7 --device ragged", "cjxl",
                 [f("ragged.ppm"), f("ragged_p.jxl"), "-d", "5", "-e", "7",
                  "--device"], f("ragged.jxl"), f("ragged_p.jxl")),
                (f"djxl {name}", "djxl",
                 [os.path.join(DECODE_API[0][0], name), f("p.ppm")],
                 f(name + ".ppm"), f("p.ppm"))):
            t0 = time.perf_counter()
            _, ms = _tool_done(label, _tool_proc(tool, argv, env), t0, 300)
            if read(mine) != read(theirs):
                raise AssertionError(f"python -m {label} differs from the "
                                     "in-process run")
            procs[label] = ms
        print(f"cli python -m processes (wall ms; the in-process run's; "
              f"the difference, the process's start-up): "
              f"{ {k: (v, wall[k], v - wall[k]) for k, v in procs.items()} }"
              "; files equal to the in-process runs", flush=True)

        # the graft entry's twin: the same program on the card and the CPU
        from libjxl_torch.graft_entry import entry
        outs = []
        for where in (dev, "cpu"):
            fn, args = entry(device=where)
            outs.append([t.cpu() for t in fn(*args)])
        diffs = [int((a.long() - b.long()).abs().max())
                 for a, b in zip(*outs)]
        print(f"graft_entry.entry() on the card against the CPU: max abs "
              f"diff of q_ac, q_dc, payload, wide {diffs}", flush=True)
        if any(diffs):
            raise AssertionError("graft_entry.entry() differs on the card")
        counts = _all_counts()
        print(f"cli phase: launches (counted from 0) pack "
              f"{counts['pack']}, Gaborish {counts['gaborish']}, EPF0/1/2 "
              f"{counts['epf_passes']}; tool wall ms {wall}, on "
              f"{card_line()}", flush=True)
        return counts, pending
    except BaseException:
        stop_cli(pending)
        raise


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


def filter_records(filters: dict, by_path: dict) -> list:
    """The kernels-line records of Gaborish and of each EPF pass, with the
    launches of the main paths' runs (``by_path``: path name -> counts of
    its run, the decode batches, ``decode()``, the effort 5-7 encode and
    the command-line tools), in all and by path; None where no path was
    driven."""
    def rec(name, replaces, count, timing):
        paths = {k: count(c) for k, c in by_path.items()}
        return dict(name=name, route="cuda", source=FILTERS_SOURCE,
                    replaces=replaces,
                    launches=sum(paths.values()) if paths else None,
                    paths=paths, **timing)

    return ([rec("gaborish", GAB_REPLACES, lambda c: c["gaborish"],
                 filters["gab"])]
            + [rec(f"epf{p}", EPF_REPLACES,
                   lambda c, p=p: c["epf_passes"][p], filters[p])
               for p in (0, 1, 2)])


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

    t_main = time.perf_counter()

    def done(phase: str) -> None:
        print(f"-- {phase}: done {time.perf_counter() - t_main} s into the "
              "run", flush=True)

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

    done("the decode batches")

    # 6. decode() with its filters on the card
    counts["decode()"], autos = phase_decode_api(dev, card)
    phase_host_routed(dev, card, photos, workers)
    done("decode() and the host-routed decode_many")

    # 7. the lossy encode, and its round trip through decode_many: at
    # effort 3, then at efforts 5-7 (whose filter launches join the
    # kernels line)
    e3 = phase_lossy_encode(dev, card, photos, workers)
    done("the effort-3 lossy encode")
    counts["lossy e5-e7"], e7 = phase_lossy_e7(dev, card, photos, workers)
    host_pool.shutdown()
    done("the effort 5-7 lossy encode")

    # 8. the command-line tools and the entry points behind them; their
    # 4K benchmark_xl process runs on through step 9
    counts["cli"], pending = phase_cli(dev, card, photos, e3, e7, autos)
    del autos, e3, e7
    done("the command-line tools in this process")

    # 9. decode every lossless stream on the host
    jobs = ([(n, s, im) for n, s, im in zip(names, streams, batch)]
            + [("rgba16 two-pass", two_pass, extras["rgba16"]),
               ("gray ans", ans, extras["gray"])])
    try:
        phase_decode(jobs)
        done("the host decode of the lossless streams")
        finish_cli(pending)
        done("the 4K benchmark_xl process of the command-line tools")
    finally:
        stop_cli(pending)

    # 10. neither jax nor the JAX package was imported
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "libjxl_tpu")]
    if loaded:
        raise AssertionError(f"imported: {loaded}")
    print("jax, libjxl_tpu: not imported", flush=True)

    # 11. results
    print(card_line(), flush=True)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    # the pack kernel's launches of the lossless encode and of the tools;
    # the filter launches of both decode batches, of decode(), of the
    # effort 5-7 encode and of the tools
    pack_paths = {"lossless encode": launches, "cli": counts["cli"]["pack"]}
    print(json.dumps({"kernels": [
        dict(name="pack_chunks", route="cuda", source=PACK_SOURCE,
             replaces=PACK_REPLACES, launches=sum(pack_paths.values()),
             paths=pack_paths, **rec),
    ] + filter_records(filters, counts)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
