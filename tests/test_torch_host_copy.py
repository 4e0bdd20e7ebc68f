"""The port carries its own copy of the JAX package's jax-free host code.

* Each copied module's text equals the original after the
  ``libjxl_tpu`` -> ``libjxl_torch`` rewrite; a short list of modules
  that lost their jax branches is held function by function instead.
* No file of ``libjxl_torch/`` and not ``chip_smoke.py`` imports jax or
  ``libjxl_tpu``.
* The port's native loader survives two processes building at once.
* The copied host encoder gives the JAX package's bytes.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "libjxl_torch")
REF = os.path.join(REPO, "libjxl_tpu")

# copied as they are (relative to the package root)
VERBATIM = """api/codestream api/container api/stats
color/cms color/icc color/icc_profile color/xyb
core/fields core/frame_header core/geometry core/headers core/toc
entropy/alias entropy/ans entropy/histogram entropy/hybrid
entropy/permutation entropy/prefix extras/exif
modular/codec modular/enc_ma modular/frame modular/image modular/predict
modular/transforms modular/tree parallel/runner
render/blending render/enc_patches render/noise render/patches
render/splines render/upsample render/upsample_weights utils/bits
vardct/ac_context vardct/ac_strategy vardct/afv_basis vardct/cfl
vardct/coeff_order vardct/dct vardct/enc_transforms_small
vardct/frame_dec vardct/quant_tables_data vardct/transforms_small
""".split()

# copied without their jax branches: (top-level names whose text
# differs, top-level names dropped); every other name is the original's
EDITED = {
    "api/decoder": ({"decode_vardct_frame", "decode_rows",
                     "_device_decode_inputs", "_decode_unoriented",
                     "decode_many"}, {"_try"}),
    "api/encoder": ({"encode_lossless", "encode_lossless_device",
                     "encode_lossless_many", "encode_lossless_device_prefix",
                     "_prefix_pass1", "_prefix_pass2", "_prefix_upload",
                     "_prefix_fused", "_prefix_assemble",
                     "_assemble_lossless_device"}, set()),
    "render/filters": (set(), set()),
    "render/pipeline": ({"build_render_pipeline"},
                        {"DeviceRestoreStage", "BandedDeviceRestoreStage"}),
    "utils/native": ({"_build", "get_lib"}, set()),
    "config": ({"RuntimeConfig"}, {"device_filters_enabled"}),
    # workers hide the CUDA card instead of pinning jax to the CPU, the
    # native library is built before the spawn, a pool of another size
    # is made anew, a pool failure raises, and the caller always names
    # the number of workers
    "parallel/host_pool": ({"_worker_init", "_decode_inputs_task",
                            "get_pool", "_warm_task", "warm",
                            "map_decode_inputs"}, {"default_workers"}),
    # DequantMatrices.decode records whether the stream signalled the
    # default AC tables (the reference never clears encodings_default)
    "vardct/quant_weights": ({"DequantMatrices"}, set()),
}

# the port's own modules that mirror a reference module's name
PORTED = {"__init__", "models/lossless", "models/pack_kernel",
          "models/vardct_decode", "ops/modular_ops"}


def _read(root, mod):
    with open(os.path.join(root, mod + ".py")) as f:
        return f.read()


def _defs(src: str) -> dict:
    tree = ast.parse(src)
    return {n.name: ast.get_source_segment(src, n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("mod", VERBATIM + sorted(EDITED))
def test_copied_module_matches_reference(mod):
    got = _read(PORT, mod)
    want = _read(REF, mod).replace("libjxl_tpu", "libjxl_torch")
    if mod not in EDITED:
        assert got == want
        return
    differ, dropped = EDITED[mod]
    got_defs, want_defs = _defs(got), _defs(want)
    assert set(want_defs) - set(got_defs) == dropped
    assert differ <= set(got_defs)
    for name in (set(want_defs) & set(got_defs)) - differ:
        assert got_defs[name] == want_defs[name], name


def test_every_shared_module_name_is_accounted_for():
    shared = set()
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), PORT)[:-3]
                rel = rel.replace(os.sep, "/")
                if os.path.exists(os.path.join(REF, rel + ".py")) and \
                        not rel.endswith("/__init__"):
                    shared.add(rel)
    assert shared == set(VERBATIM) | set(EDITED) | PORTED


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            names.update(a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module:
            names.add(n.module)
    return names


def test_no_jax_or_reference_imports():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, fs in os.walk(PORT):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    for path in files:
        bad = {m for m in _imports(path)
               if m.split(".")[0] in ("jax", "jaxlib", "libjxl_tpu")}
        assert not bad, (path, bad)


_BUILD = r"""
import sys
from libjxl_torch.utils import native
native._BUILD_DIR = sys.argv[1]
assert native.get_lib() is not None
print(native._build())
"""


def test_native_library_builds_in_two_processes_at_once(tmp_path):
    """Each process compiles to a file of its own under a lock, so two
    first uses at once both get the library."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    built = sorted(os.listdir(tmp_path))
    assert [f for f in built if f.endswith(".so")] == \
        [os.path.basename(paths.pop())]
    assert not [f for f in built if f.endswith(".tmp")]


def test_native_build_failure_raises_and_is_retried(tmp_path, monkeypatch):
    from libjxl_torch.utils import native
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="bad.cc failed"):
            native.get_lib()


@pytest.mark.parametrize("effort", [1, 3, 7])
def test_host_encoder_copy_matches_reference(effort):
    pytest.importorskip("jax")
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless
    from libjxl_tpu.api import encoder as ref
    rng = np.random.default_rng(effort)
    img = np.clip(np.cumsum(rng.integers(-3, 4, (70, 90, 3)), axis=1)
                  + 128, 0, 255).astype(np.uint8)
    got = encode_lossless(img, EncodeOptions(effort=effort))
    assert got == ref.encode_lossless(img, ref.EncodeOptions(effort=effort))
