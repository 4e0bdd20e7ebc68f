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
metrics/__init__ metrics/_malta_kernels modular/codec modular/enc_ma
modular/fixed_trees modular/frame
modular/image modular/predict modular/transforms modular/tree
parallel/runner render/blending render/enc_dots render/enc_downsample
render/enc_noise render/enc_patches render/noise render/patches
render/splines render/upsample render/upsample_weights utils/bits
utils/debug vardct/ac_context vardct/ac_strategy
vardct/adaptive_quant vardct/afv_basis vardct/cfl vardct/coeff_order
vardct/dct vardct/enc_acs vardct/enc_transforms_small
vardct/quant_tables_data vardct/transforms_small
api/encoder_api api/events cli/fuzz color/compressed_icc
extras/color_description extras/exr extras/gain_map extras/io
jpeg/__init__ jpeg/data jpeg/jbrd jpeg/reader jpeg/transcode jpeg/writer
metrics/ssimulacra2 params utils/brotli
""".split()

# copied without their jax branches: (top-level names whose text
# differs, top-level names dropped); every other name is the original's
EDITED = {
    # decode() and decode_rows() take the device of their filters, and
    # a device-resident frame is fetched with torch; _frame_recon stages
    # a var frame's classes by the native passes of utils/host_stage.py
    # into arrays its caller places (_var_classes is their plain twin)
    "api/decoder": ({"decode_vardct_frame", "decode_rows",
                     "_device_decode_inputs", "_decode_unoriented",
                     "decode_many", "decode", "_frame_to_float",
                     "_frame_recon"},
                    {"_try"}),
    "api/encoder": ({"encode_lossless", "encode_lossless_device",
                     "encode_lossless_many", "encode_lossless_device_prefix",
                     "_prefix_pass1", "_prefix_pass2", "_prefix_upload",
                     "_prefix_fused", "_prefix_assemble",
                     "_assemble_lossless_device"}, set()),
    "render/filters": (set(), set()),
    # the device restore stages run on ctx["device"]; DeviceRestoreStage
    # has no ``keep`` option (the whole-frame stage always leaves its
    # result on the device, the sharded filters' on the mesh's first
    # slot), so build_render_pipeline builds it without one
    "render/pipeline": ({"DeviceRestoreStage", "BandedDeviceRestoreStage",
                         "build_render_pipeline"}, set()),
    "utils/native": ({"_build", "get_lib"}, set()),
    # the port's span recorder: ``stage`` records thread-local spans on
    # the profiler's clock, ``dump`` prints totals computed from them;
    # the stage timer's shared totals (``reset``, ``report``) are gone
    "utils/prof": ({"stage", "dump"}, {"reset", "report"}),
    # the port's device-filter policy does not look at a JAX backend
    "config": ({"RuntimeConfig", "device_filters_enabled"}, set()),
    # workers hide the CUDA card instead of pinning jax to the CPU, the
    # native library is built before the spawn, a pool of another size
    # is made anew, a pool failure raises, and the caller always names
    # the number of workers; results come back in shared-memory
    # segments (_Segment, _receive) that shutdown and the start sweep
    "parallel/host_pool": ({"_worker_init", "_decode_inputs_task",
                            "get_pool", "_warm_task", "warm",
                            "map_decode_inputs", "shutdown", "_Segment",
                            "_receive", "_sweep"}, {"default_workers"}),
    # the device branches call the port's device programs on
    # ``device``, which the iterated encode and the EPF sharpness search
    # pass on to their scorers (and the legacy loop to decode());
    # encode_lossy_many runs the port's batch program at effort <= 4 and
    # each image's whole encode once on its threads at effort >= 5;
    # encode_lossy's shard_encode branch runs on the port's mesh
    "vardct/frame_enc": ({"LossyOptions", "encode_lossy",
                          "encode_lossy_many", "_encode_lossy_iterated",
                          "_encode_lossy_iterated_legacy",
                          "_epf_sharpness_search",
                          "_epf_sharpness_search_state"}, set()),
    # the jitted scorers are plain torch functions (score, epf_errs) on
    # the entry points' ``device``
    "vardct/enc_roundtrip": ({"roundtrip_block_sums", "epf_candidate_errs"},
                             {"_score_jit", "_epf_err_jit"}),
    # DequantMatrices.decode records whether the stream signalled the
    # default AC tables (the reference never clears encodings_default)
    "vardct/quant_weights": ({"DequantMatrices"}, set()),
    # the native AC decode takes a subsampled all-DCT8 frame (a
    # recompressed JPEG's) into the coefficient planes its caller gives;
    # every other method of the class is the original's
    "vardct/frame_dec": ({"VarDCTFrameDecoder.decode_ac_frame_native"},
                         set()),
    # the tools pick their device from LIBJXL_TORCH_DEVICE, not from
    # JAX_PLATFORMS
    "cli/__init__": ({"apply_platform_env"}, set()),
    # the prog and help strings name the port, not the TPU or JAX
    "cli/cjxl": ({"main"}, set()),
    "cli/djxl": ({"main"}, set()),
    "cli/jxlinfo": ({"main"}, set()),
    "cli/jxltran": ({"main"}, set()),
    "cli/ssimulacra2": ({"main"}, set()),
    # the prog string names the port, and the diffmap, a tensor on
    # config.device, is fetched to the host
    "cli/butteraugli": ({"main"}, set()),
    # the diffmap is fetched to the host, and a ":device" spec is read
    # as such (the reference reads it as a distance and fails); the
    # docstring names CUDA
    "cli/benchmark_xl": ({"run_benchmark", "_parse_codec"}, set()),
}

# the port's own modules that mirror a reference module's name
PORTED = {"__init__", "metrics/butteraugli", "models/lossless",
          "models/pack_kernel", "models/vardct_decode",
          "models/vardct_heuristics", "models/vardct_loop",
          "models/vardct_pipeline", "models/vardct_transform",
          "ops/modular_ops", "parallel/mesh", "parallel/multihost",
          "parallel/shard_filters"}


def _read(root, mod):
    with open(os.path.join(root, mod + ".py")) as f:
        return f.read()


def _defs(src: str) -> dict:
    """The text of each top-level function and class, and of each method
    as ``Class.method``."""
    tree = ast.parse(src)
    out = {}
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out[n.name] = ast.get_source_segment(src, n)
        if isinstance(n, ast.ClassDef):
            for m in n.body:
                if isinstance(m, ast.FunctionDef):
                    out[f"{n.name}.{m.name}"] = ast.get_source_segment(src,
                                                                       m)
    return out


@pytest.mark.parametrize("mod", VERBATIM + sorted(EDITED))
def test_copied_module_matches_reference(mod):
    got = _read(PORT, mod)
    want = _read(REF, mod).replace("libjxl_tpu", "libjxl_torch")
    if mod not in EDITED:
        assert got == want
        return
    differ, dropped = EDITED[mod]
    got_defs, want_defs = _defs(got), _defs(want)
    assert {n for n in set(want_defs) - set(got_defs) if "." not in n} \
        == dropped
    assert differ <= set(got_defs)
    # a class listed whole differs in any of its methods; a class with a
    # method listed is held to the original method by method
    skip = differ | {n.split(".")[0] for n in differ if "." in n} | \
        {n for n in want_defs if n.split(".")[0] in differ}
    for name in (set(want_defs) & set(got_defs)) - skip:
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
    listed = set(VERBATIM) | set(EDITED) | PORTED
    assert shared == {m for m in listed if not m.endswith("/__init__")}


# reference modules the port carries under another name, and those it
# does not carry (with the reason)
RENAMED = {"models/pallas_filters": "models/filter_kernels",
           "render/filters_jax": "render/filters_torch"}
NOT_PORTED = {
    # picks a JAX backend; the port names its device in config
    "utils/device",
    # test infrastructure: ctypes to the system libjxl, which no codec
    # path calls; the port's tests use the JAX package's copy
    "utils/oracle",
}


def test_every_reference_module_has_a_counterpart():
    missing = set()
    for root, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REF)[:-3]
                rel = rel.replace(os.sep, "/")
                rel = RENAMED.get(rel, rel)
                if not os.path.exists(os.path.join(PORT, rel + ".py")):
                    missing.add(rel)
    assert missing == NOT_PORTED


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
    rel = {os.path.relpath(f, PORT)[:-3].replace(os.sep, "/") for f in files}
    assert {"metrics/butteraugli", "models/vardct_heuristics",
            "models/vardct_transform", "models/vardct_loop",
            "vardct/enc_roundtrip", "graft_entry", "parallel/mesh",
            "parallel/shard_filters", "parallel/multihost"} <= rel
    assert set(VERBATIM) | set(EDITED) <= rel
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
