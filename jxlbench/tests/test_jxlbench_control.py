"""The control comes out not correct at a size a test run holds: the
reference in TF32 in the program's place (decode), and the program's
encode of images whose lowest bit was cleared (lossless)."""

import json
import os

from jxlbench import control, registry


def test_decode_control_fails(scratch_root):
    root = str(scratch_root)
    path = os.path.join(root, "jxlbench/traffic/decode_4k.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(corpus="small", check={"per_slot": 1, "groups": 2})
    with open(path, "w") as f:
        json.dump(mix, f)
    cell = registry.resolve("e7_decode_4k", root)
    checks = control.control_run(cell, 5, "cpu")
    assert any(c.value > c.limit for c in checks), checks


def test_lossless_control_fails(scratch_root):
    root = str(scratch_root)
    path = os.path.join(root, "jxlbench/traffic/photos_4k_batch.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(shape=[300, 520], pool=3, batch=2,
               check={"streams": 1})
    with open(path, "w") as f:
        json.dump(mix, f)
    cell = registry.resolve("lossless_4k_batch", root)
    checks = control.control_run(cell, 5, "cpu")
    assert all(c.value > c.limit for c in checks), checks
