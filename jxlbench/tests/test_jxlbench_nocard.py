"""Without a card the harness fails and prints no result; on a card the
cells run (marker ``gpu``, decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from jxlbench import registry


def _run(args, env_extra=None, timeout=600):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "jxlbench/run.py", *args],
                          cwd=registry.ROOT, capture_output=True, text=True,
                          env=env, timeout=timeout)


def test_refuses_without_a_card():
    out = _run(["--workload", "e7_decode_4k", "--seed", "3",
                "--seconds", "1", "--trace", "0"],
               {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_unknown_workload_fails():
    out = _run(["--workload", "nope", "--seed", "3", "--seconds", "1"],
               {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.benchmark()["workloads"]])
def test_cell_runs_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(["--workload", cell, "--seed", "2147483659", "--seconds", "2",
                "--trace", "1"])
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
