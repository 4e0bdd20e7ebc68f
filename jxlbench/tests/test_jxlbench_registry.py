"""Every cell, configuration, traffic mix, driver, metric and roofline
resolves by name, and a new cell, mix and metric need only new files and
entries."""

from __future__ import annotations

import json
import os
import re

import pytest

from jxlbench import registry
from jxlbench.harness import run_cell
from jxlbench.tests.conftest import add_entry

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = registry.resolve(cell)
    assert c.config["name"] == c.workload["config"]
    for fn in ("setup", "call", "release", "check", "close"):
        assert callable(getattr(c.driver(), fn))
    names = [m["name"] for m in c.end_to_end + c.per_layer]
    assert "setup_s" in names and len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        if m["name"] != "setup_s":
            assert callable(c.metric(m["name"]).read)
    # every per-layer metric moves an end-to-end metric the cell reports
    e2e = {m["name"] for m in c.end_to_end}
    assert all(m["moves"] in e2e for m in c.per_layer)


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    every = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] +
             BENCH["per_layer"])
    for e in every:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    with open(os.path.join(registry.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in layers:
        assert layer in perf, f"layer {layer!r} is not in PERF.md"
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
        assert c["file"].startswith("jxlbench/")


def test_roofline_modules_resolve():
    c = registry.resolve(CELLS[0])
    for kernel in ("gaborish", "epf", "pack"):
        assert callable(c.roofline(kernel).cost)
    assert "H100" in c.peaks()


def test_throwaway_cell_mix_and_metric(scratch_root):
    """A new mix, metric and cell as files and entries only, run on the
    CPU at a small size."""
    root = str(scratch_root)
    with open(os.path.join(root, "jxlbench/traffic/photos_4k_batch.json")) \
            as f:
        mix = json.load(f)
    mix.update(shape=[256, 384], pool=3, batch=2, why="throwaway")
    with open(os.path.join(root, "jxlbench/traffic/tiny_batch.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "jxlbench/metrics/calls_made.encode.py"),
              "w") as f:
        f.write("def read(run):\n    return len(run.calls)\n")
    add_entry(root, "workloads", {"name": "tiny", "config": "lossless_e1",
                                  "traffic": "tiny_batch", "chips": 1,
                                  "why": "throwaway"})
    add_entry(root, "per_layer", {"name": "calls_made.encode", "unit": "1",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "entry", "moves": "bpp",
                                  "workloads": ["tiny"]})
    bench = registry.benchmark(root)
    for m in bench["end_to_end"]:
        if m["name"] == "bpp":
            m["workloads"].append("tiny")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = registry.resolve("tiny", root)
    assert [m["name"] for m in cell.per_layer] == ["calls_made.encode"]
    res, _ = run_cell(cell, 7, 0.5, trace=True, device="cpu")
    assert res["correct"] and res["metrics"]["calls_made.encode"]["value"] >= 1
    res, _ = run_cell(cell, 7, 0.5, trace=False, device="cpu")
    assert set(res["metrics"]) == {"bpp", "setup_s"}
    assert list(res)[-1] == "checks"
