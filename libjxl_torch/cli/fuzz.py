"""Decoder robustness fuzzer (reference ``tools/djxl_fuzzer.cc``,
``tools/fuzzer_corpus.cc`` model, as a CLI harness instead of a
libFuzzer binary).

Strategies per iteration, seeded from valid encoder output:
  * truncation at every byte class (header / TOC / sections)
  * single- and multi-byte corruption (xor, zero, 0xFF)
  * random splices of two valid streams
  * pure random / structured-garbage inputs

Pass = decode() either succeeds or raises FormatError/ValueError;
anything else (segfault can't be caught, other exception types,
hangs beyond --timeout) is a finding and the repro is written next to
the report.

Usage: python -m libjxl_torch.cli.fuzz [-n ITERS] [--seed S]
"""

from __future__ import annotations

import argparse
import random
import signal
import sys

import numpy as np


def _seed_streams(rng: np.random.Generator) -> list:
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy

    img = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (33, 21)).astype(np.uint8)
    return [
        encode_lossless(img, EncodeOptions(effort=2)),
        encode_lossless(img, EncodeOptions(effort=5)),
        encode_lossless(gray, EncodeOptions(effort=2)),
        encode_lossy(img, LossyOptions(distance=1.5, effort=3)),
    ]


def _mutate(data: bytes, py_rng: random.Random) -> bytes:
    kind = py_rng.randrange(5)
    b = bytearray(data)
    if kind == 0:                      # truncate
        return bytes(b[:py_rng.randrange(1, len(b) + 1)])
    if kind == 1:                      # xor a byte
        i = py_rng.randrange(len(b))
        b[i] ^= py_rng.randrange(1, 256)
        return bytes(b)
    if kind == 2:                      # burst corruption
        i = py_rng.randrange(len(b))
        n = min(py_rng.randrange(1, 32), len(b) - i)
        for j in range(i, i + n):
            b[j] = py_rng.randrange(256)
        return bytes(b)
    if kind == 3:                      # splice two prefixes
        cut = py_rng.randrange(len(b))
        return bytes(b[:cut]) + bytes(b[:len(b) - cut])
    sig = b"\xff\x0a" if py_rng.random() < 0.7 else b""
    return sig + py_rng.randbytes(py_rng.randrange(4, 512))


def run_fuzz(iters: int, seed: int, timeout_s: int = 10,
             out=sys.stderr) -> int:
    from libjxl_torch.core.fields import FormatError

    rng = np.random.default_rng(seed)
    py_rng = random.Random(seed)
    seeds = _seed_streams(rng)
    findings = 0

    def _alarm(signum, frame):
        raise TimeoutError("decode hang")

    have_alarm = hasattr(signal, "SIGALRM")
    if have_alarm:
        signal.signal(signal.SIGALRM, _alarm)
    from libjxl_torch.api.decoder import decode
    for i in range(iters):
        data = _mutate(py_rng.choice(seeds), py_rng)
        try:
            if have_alarm:
                signal.alarm(timeout_s)
            decode(data)
        except (FormatError, ValueError):
            pass                        # clean rejection
        except TimeoutError:
            findings += 1
            path = f"fuzz_hang_{i}.jxl"
            open(path, "wb").write(data)
            print(f"[{i}] HANG > {timeout_s}s -> {path}", file=out)
        except Exception as e:  # noqa: BLE001 - the fuzzer's whole point
            findings += 1
            path = f"fuzz_crash_{i}.jxl"
            open(path, "wb").write(data)
            print(f"[{i}] {type(e).__name__}: {e} -> {path}", file=out)
        finally:
            if have_alarm:
                signal.alarm(0)
    print(f"{iters} iterations, {findings} findings", file=out)
    return findings


def main(argv=None) -> int:
    from libjxl_torch.cli import apply_platform_env
    apply_platform_env()
    ap = argparse.ArgumentParser(prog="jxl_fuzz")
    ap.add_argument("-n", "--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=int, default=10)
    args = ap.parse_args(argv)
    return 1 if run_fuzz(args.iters, args.seed, args.timeout) else 0


if __name__ == "__main__":
    sys.exit(main())
