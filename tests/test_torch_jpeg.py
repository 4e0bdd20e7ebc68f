"""The port's JPEG recompression against the JAX package's on the CPU.

* For each JPEG of ``tests/test_jpeg.py`` (its ``CONFIGS``, made with
  PIL from a numpy seed) and a multi-group one: the port's parser,
  writer and jbrd box give the reference's bytes, ``encode_jpeg`` gives
  the JAX package's stream, ``decode_to_jpeg`` gives the JPEG back byte
  for byte, and the pixel decode of the recompressed stream equals the
  JAX package's.
* The committed JPEGs that the card runs recompress
  (``tests/data/torch_cli``) are the kinds their manifest names, and the
  port's ``cjxl`` and ``djxl`` on them give the JAX tools' files, the
  original JPEG byte for byte.
"""
import hashlib
import io
import json
import os
from contextlib import redirect_stderr

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("PIL")

from _torch_e7 import one_torch_thread  # noqa: E402,F401
from libjxl_torch.config import config  # noqa: E402
from libjxl_torch.jpeg import jbrd, reader, transcode, writer  # noqa: E402
from libjxl_tpu.jpeg import jbrd as ref_jbrd  # noqa: E402
from libjxl_tpu.jpeg import reader as ref_reader  # noqa: E402
from libjxl_tpu.jpeg import transcode as ref_transcode  # noqa: E402
from test_jpeg import CONFIGS, _jpeg_bytes  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_cli")
CASES = CONFIGS + [dict(shape=(291, 317), quality=88)]


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _ids(cfg: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in cfg.items())


@pytest.mark.parametrize("cfg", CASES, ids=_ids)
def test_parse_write_and_jbrd_match_reference(cfg):
    jb = _jpeg_bytes(**dict(cfg))
    jd = reader.parse_jpeg(jb)
    assert writer.write_jpeg(jd) == jb
    assert jbrd.serialize_jbrd(jd) == \
        ref_jbrd.serialize_jbrd(ref_reader.parse_jpeg(jb))


@pytest.mark.parametrize("cfg", CASES, ids=_ids)
def test_recompression_matches_reference(cfg):
    from libjxl_torch.api.decoder import decode
    from libjxl_tpu.api.decoder import decode as ref_decode
    jb = _jpeg_bytes(**dict(cfg))
    jxl = transcode.encode_jpeg(jb)
    assert jxl == ref_transcode.encode_jpeg(jb)
    assert transcode.decode_to_jpeg(jxl) == jb
    got = decode(jxl, device="cpu")
    want = ref_decode(jxl)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _manifest() -> dict:
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_committed_jpeg_is_its_kind(name):
    m = _manifest()[name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        jb = f.read()
    assert len(jb) == m["bytes"]
    assert hashlib.sha256(jb).hexdigest() == m["sha256"]
    jd = reader.parse_jpeg(jb)
    assert (jd.height, jd.width) == (m["h"], m["w"])
    assert len(jd.components) == (1 if m["gray"] else 3)
    assert jd.progressive == m.get("progressive", False)
    assert (jd.restart_interval > 0) == ("restart_marker_blocks" in m)
    if not m["gray"]:
        # 4:2:0 (subsampling 2): luma sampled 2x2, 4:4:4 (0): 1x1
        f = 2 if m["subsampling"] == 2 else 1
        c = jd.components[0]
        assert (c.h_samp_factor, c.v_samp_factor) == (f, f)


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_cli_recompresses_committed_jpeg(tmp_path, name):
    from libjxl_torch.cli.cjxl import main as cjxl
    from libjxl_torch.cli.djxl import main as djxl
    from libjxl_tpu.cli.cjxl import main as ref_cjxl
    from libjxl_tpu.cli.djxl import main as ref_djxl
    src = os.path.join(FIXTURES, name)
    with open(src, "rb") as f:
        jb = f.read()
    files = {k: str(tmp_path / k) for k in ("a.jxl", "b.jxl", "a.jpg",
                                            "b.jpg")}
    with redirect_stderr(io.StringIO()):
        assert cjxl([src, files["a.jxl"]]) == 0
        assert ref_cjxl([src, files["b.jxl"], "-q"]) == 0
        assert djxl([files["a.jxl"], files["a.jpg"]]) == 0
        assert ref_djxl([files["a.jxl"], files["b.jpg"], "-q"]) == 0
    out = {}
    for k, path in files.items():
        with open(path, "rb") as f:
            out[k] = f.read()
    assert out["a.jxl"] == out["b.jxl"]
    assert len(out["a.jxl"]) < len(jb)
    assert out["a.jpg"] == out["b.jpg"] == jb
