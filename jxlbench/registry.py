"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration and a traffic mix; the configuration's entry
gives its file, the mix is ``jxlbench/traffic/<traffic>.json`` and names
its loop driver ``jxlbench/drivers/<driver>.py``; a metric is
``jxlbench/metrics/<metric>.py`` and a kernel's cost
``jxlbench/roofline/<kernel>.py``. Modules are loaded from their files, so
a later PR adds a cell, mix, metric or kernel by adding files and
entries."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_modules: dict = {}


def load_module(path: str):
    """The module in the Python file ``path``, loaded once."""
    path = os.path.abspath(path)
    if path not in _modules:
        name = "jxlbench_file_" + os.path.relpath(path, ROOT).replace(
            os.sep, "_").replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def resolve_attr(path: str):
    """The object named ``"package.module:attr.attr"``."""
    import importlib

    mod, attr = path.split(":")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    root: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def driver(self):
        return load_module(os.path.join(
            self.root, "jxlbench", "drivers", self.traffic["driver"] + ".py"))

    def metric(self, name: str):
        return load_module(os.path.join(self.root, "jxlbench", "metrics",
                                        name + ".py"))

    def roofline(self, kernel: str):
        return load_module(os.path.join(self.root, "jxlbench", "roofline",
                                        kernel + ".py"))

    def peaks(self) -> dict:
        return _read_json(os.path.join(self.root, "jxlbench", "roofline",
                                       "peaks.json"))


def _applies(metric: dict, cell_name: str) -> bool:
    return cell_name in metric.get("workloads", [cell_name])


def benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload``, with its configuration, traffic and
    the metrics it reports; raises KeyError for an unknown name."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = dict(_read_json(os.path.join(root, configs[w["config"]]["file"])))
    cfg.setdefault("name", w["config"])
    traffic = _read_json(os.path.join(root, "jxlbench", "traffic",
                                      w["traffic"] + ".json"))
    traffic.setdefault("name", w["traffic"])
    return Cell(root=root, workload=w, config=cfg, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)])
