"""The import guard compares top-level names whole, and nothing the
benchmark runs imports jax, jaxlib, flax or libjxl_tpu, or reads the
JAX package's scripts and records or the repository's tests."""

import json
import os
import re
import subprocess
import sys

import pytest

from jxlbench import registry
from jxlbench.guard import forbidden_loaded


def test_top_level_names_compared_whole():
    assert forbidden_loaded(["libjxl_torch", "libjxl_torch.api.decoder",
                             "jaxtyping", "flaxen", "jxlbench"]) == []
    assert forbidden_loaded(["jax.numpy", "libjxl_tpu.api", "jaxlib",
                             "flax.linen", "numpy"]) == \
        ["flax", "jax", "jaxlib", "libjxl_tpu"]


def test_benchmark_modules_load_nothing_forbidden():
    """Every module of the harness, its drivers, readers and reference,
    with the port's entry points, in a fresh interpreter."""
    files = []
    base = os.path.join(registry.ROOT, "jxlbench")
    for sub in ("metrics", "roofline", "drivers"):
        files += [os.path.join(base, sub, f) for f in os.listdir(
            os.path.join(base, sub)) if f.endswith(".py")]
    code = (
        "import sys\n"
        "from jxlbench import registry, harness, control, run\n"
        "import jxlbench.ref.vardct, jxlbench.ref.lossless\n"
        "import libjxl_torch.api.decoder, libjxl_torch.api.encoder\n"
        "import libjxl_torch.vardct.frame_enc\n"
        f"for p in {files!r}:\n"
        "    registry.load_module(p)\n"
        "from jxlbench.guard import forbidden_loaded\n"
        "print(forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_file_reads_the_jax_package_records_or_tests():
    pat = re.compile(r"bench[_a-z]*\.py|chip_smoke|BENCH_|profiling/|"
                     r"['\"]tests/|libjxl_tpu\b\.|import libjxl_tpu|"
                     r"from libjxl_tpu|import jax|from jax")
    base = os.path.join(registry.ROOT, "jxlbench")
    for dirpath, _, names in os.walk(base):
        if "tests" in dirpath.split(os.sep):
            continue
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(dirpath, n)) as f:
                    src = f.read()
                hits = pat.findall(src)
                assert not hits, (os.path.join(dirpath, n), hits)


_GUARDED_RUN = r'''
import sys
import torch
from jxlbench import harness, registry, run

root, stub_dir, plant = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
real_run_cell = harness.run_cell


def small_cpu_run(cell, seed, seconds, trace, device="cuda"):
    cell = registry.resolve(cell.name, root)
    driver = cell.driver()
    check = driver.check

    def check_then_load(r):
        out = check(r)
        if plant:
            # what a reference that pulled in JAX would leave behind
            sys.path.insert(0, stub_dir)
            import jax  # noqa: F401
        return out

    driver.check = check_then_load
    return real_run_cell(cell, seed, 0.5, trace, device="cpu")


harness.run_cell = small_cpu_run
sys.exit(run.main(["--workload", "lossless_4k_batch", "--seed", "5",
                   "--seconds", "0.5", "--trace", "0"]))
'''


@pytest.mark.parametrize("plant", [True, False])
def test_a_package_loaded_by_the_check_refuses_the_result(
        plant, scratch_root, tmp_path):
    """The guard looks after the check: a check that loads a module named
    ``jax`` leaves the run with exit code 3 and no result line; the same
    run without it prints its result."""
    from jxlbench.tests.test_jxlbench_faults import _small_encode_cell

    _small_encode_cell(str(scratch_root))
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    out = subprocess.run(
        [sys.executable, "-c", _GUARDED_RUN, str(scratch_root), str(stub),
         "1" if plant else "0"], cwd=registry.ROOT, capture_output=True,
        text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    if plant:
        assert out.returncode == 3, out.stderr[-3000:]
        assert not any(ln.lstrip().startswith("{") for ln in lines)
        assert "forbidden packages loaded: jax" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(lines[-1])["correct"] is True
