"""Smoke run of the PyTorch port on one NVIDIA card.

Drives the port's main path, the lossless serving encode
``libjxl_torch.api.encoder.encode_lossless_many(imgs, EncodeOptions(
use_device=True, entropy="prefix-device"))``, on 8 RGB 3840x2160 photos
plus a 16-bit RGBA image, a ragged gray image and a smooth/noise pair,
then decodes every stream on the host and requires exact pixels.

Phases: environment, build (nvcc for sm_90a + the native host library),
the pack kernel against its plain PyTorch version at the chunk count of a
4K sub-batch, the main path (with launch counts and the batch rate), the
host decode check, and a check that JAX was never imported. The last two
lines are the kernels' JSON record and ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before those lines. The script
reaches the codec only through ``libjxl_torch`` (and ``bench.make_image``
for its photos).

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

CHUNKS_4K = 135 * 3 * 256 * 256 // 128   # chunks of one 3840x2160 image
PACK_SOURCE = "libjxl_torch/csrc/pack_kernel.cu"
PACK_REPLACES = "libjxl_tpu/models/pack_kernel.py:53"
DEVICE = "cuda:0"


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
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del v, buf_k, buf_r
    return rec


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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    # the port's modules exist only in a checkout of the repository
    from libjxl_torch.api.encoder import (
        EncodeOptions, encode_lossless, encode_lossless_many, native_lib,
    )
    from libjxl_torch.models.pack_kernel import pack_chunks
    from libjxl_torch.utils.cuda_build import build

    # 1. environment
    card = card_line()
    print(card, flush=True)
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    so_path, report = build("pack_kernel")
    print(f"built {os.path.relpath(so_path)} "
          f"({time.perf_counter() - t0} s); nvcc -Xptxas -v:", flush=True)
    print(report.strip(), flush=True)
    t0 = time.perf_counter()
    native_lib()
    print(f"native host library ready ({time.perf_counter() - t0} s)",
          flush=True)

    # 3. the kernel against its plain version on the card
    rec = phase_kernel(dev)

    # 4. the main path
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

    # decode every stream on the host
    jobs = ([(n, s, im) for n, s, im in zip(names, streams, batch)]
            + [("rgba16 two-pass", two_pass, extras["rgba16"]),
               ("gray ans", ans, extras["gray"])])
    phase_decode(jobs)

    # 5. jax stayed out
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print("jax: not imported", flush=True)

    # 6. results
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [dict(
        name="pack_chunks", route="cuda", source=PACK_SOURCE,
        replaces=PACK_REPLACES, launches=launches, **rec)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
