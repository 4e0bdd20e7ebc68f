"""Fixtures of the benchmark's own tests: a throwaway checkout root that
shares the benchmark's files and takes extra entries."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from jxlbench import registry


@pytest.fixture
def scratch_root(tmp_path):
    """A root holding a copy of BENCHMARK.json and of ``jxlbench/traffic``,
    ``configs`` and ``metrics`` (so that a test may add files), the other
    folders of ``jxlbench`` linked."""
    src = os.path.join(registry.ROOT, "jxlbench")
    dst = tmp_path / "jxlbench"
    dst.mkdir()
    for name in os.listdir(src):
        if name in ("traffic", "configs", "metrics"):
            shutil.copytree(os.path.join(src, name), dst / name)
        elif not name.startswith(".") and name != "__pycache__":
            os.symlink(os.path.join(src, name), dst / name)
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"),
                tmp_path / "BENCHMARK.json")
    return tmp_path


def add_entry(root, section: str, entry: dict) -> None:
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench[section].append(entry)
    with open(path, "w") as f:
        json.dump(bench, f)
