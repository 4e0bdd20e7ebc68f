"""The check catches a broken timed path: each run here skips the look
for a card, drives the rest of a run on the CPU at a small size with the
port's entry point broken underneath, and must come out not correct.

Faults (the cells run on one chip, so no exchange between chips can be
left out): an answer altered where it is produced; half of the batch
left out, the rest's outputs given for it; a step that returns its
state unchanged (the previous call's outputs)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from jxlbench import registry
from jxlbench.harness import run_cell


def _small_decode_cell(root):
    """The 4K decode cell on the corpus's small streams, 2 a call."""
    path = os.path.join(root, "jxlbench/traffic/decode_4k.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(corpus="small", batch=2, check={"per_slot": 1, "groups": 1})
    with open(path, "w") as f:
        json.dump(mix, f)
    cell = registry.resolve("e7_decode_4k", root)
    cell.config["decode"]["workers"] = 2
    return cell


def _small_encode_cell(root):
    path = os.path.join(root, "jxlbench/traffic/photos_4k_batch.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(shape=[300, 520], pool=4, batch=2)
    with open(path, "w") as f:
        json.dump(mix, f)
    return registry.resolve("lossless_4k_batch", root)


def _altered(outs):
    return [np.clip(o.astype(np.int16) + 2, 0, 255).astype(np.uint8)
            if isinstance(o, np.ndarray) else
            o[:len(o) // 2] + bytes([o[len(o) // 2] ^ 0x5A]) +
            o[len(o) // 2 + 1:] for o in outs]


def _half(outs):
    n = len(outs)
    return outs[:n - n // 2] + outs[:n // 2]


class _Stale:
    def __init__(self):
        self.prev = None

    def __call__(self, outs):
        prev, self.prev = self.prev, outs
        return prev if prev is not None and len(prev) == len(outs) else outs


FAULTS = {"altered": lambda: _altered, "half": lambda: _half,
          "stale": _Stale}


def _break(monkeypatch, cell, module, name: str, fault: str) -> None:
    """Replace ``module.name`` by the entry with ``fault`` applied to its
    outputs from the first call of the window on (set-up runs sound)."""
    real = getattr(module, name)
    broken = FAULTS[fault]()
    active = []

    def wrapper(*a, **k):
        out = real(*a, **k)
        return broken(out) if active else out

    # decode_many counts its device frames on the module's global name
    wrapper.device_frames = getattr(real, "device_frames", 0)
    monkeypatch.setattr(module, name, wrapper)
    driver = cell.driver()
    setup = driver.setup

    def setup_then_break(run):
        setup(run)
        active.append(True)

    monkeypatch.setattr(driver, "setup", setup_then_break)


def _sound(cell):
    res, checks = run_cell(cell, 2**33 + 1, 0.5, trace=False, device="cpu")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_decode_fault_is_caught(fault, scratch_root, monkeypatch):
    import libjxl_torch.api.decoder as dec

    cell = _small_decode_cell(str(scratch_root))
    _break(monkeypatch, cell, dec, "decode_many", fault)
    res, checks = run_cell(cell, 2**33 + 1, 1.0, trace=False, device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_encode_fault_is_caught(fault, scratch_root, monkeypatch):
    import libjxl_torch.api.encoder as enc

    cell = _small_encode_cell(str(scratch_root))
    _break(monkeypatch, cell, enc, "encode_lossless_many", fault)
    res, checks = run_cell(cell, 2**33 + 1, 1.0, trace=False, device="cpu")
    assert not res["correct"], res["checks"]


def test_sound_runs_are_correct(scratch_root):
    _sound(_small_decode_cell(str(scratch_root)))
    _sound(_small_encode_cell(str(scratch_root)))
