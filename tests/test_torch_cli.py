"""The port's command-line tools against the JAX package's on the CPU.

Each tool runs through ``main(argv)`` of both packages in this process,
on the same files made from a numpy seed; the port runs with
``config.device = "cpu"``:

* ``cjxl`` gives the JAX tool's bytes (lossless host at efforts 1-3,
  ``-d 1 -e 3`` on the host, ``-d 0 --device`` and ``-d 1 -e 3
  --device``); ``-d 1 -e 7 --device`` gives the port's own
  ``encode_lossy`` stream, which ``tests/test_torch_vardct_e7*.py`` hold
  to the JAX package;
* ``djxl`` writes the JAX tool's files (``.ppm``, and ``.png`` where PIL
  is present);
* ``jxlinfo``, ``jxltran``, ``ssimulacra2`` and ``fuzz`` print the same
  and write the same files; ``butteraugli`` and
  ``benchmark_xl.run_benchmark`` give the same bytes, bpp, PSNR and
  SSIMULACRA2, and butteraugli values within 1e-4 relative
  (``tests/test_torch_butteraugli.py``'s bound);
* ``python -m libjxl_torch.cli.cjxl`` and ``djxl`` run with jax and the
  JAX package blocked and ``LIBJXL_TORCH_DEVICE=cpu``.
"""
import io
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_e7 import one_torch_thread, photo  # noqa: E402,F401
from libjxl_torch.config import config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = photo(120, 200, 0)
# cjxl options whose stream is the JAX tool's byte for byte
CJXL_CASES = [["--lossless", "-e", "1"], ["--lossless", "-e", "2"],
              ["--lossless", "-e", "3"], ["-d", "1", "-e", "3"],
              ["-d", "0", "--device"], ["-d", "1", "-e", "3", "--device"]]
BUTTERAUGLI_RTOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The port on the CPU; the JAX package's ANS device path reads an
    undefined module global ``wp_header``, given here the default WP
    header (as ``tests/test_torch_lossless.py`` does)."""
    from libjxl_tpu.api import encoder as ref
    from libjxl_tpu.modular.codec import GroupHeader
    monkeypatch.setattr(ref, "wp_header", GroupHeader().wp_header,
                        raising=False)
    monkeypatch.delenv("LIBJXL_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(config, "device", "cpu")


def _run(main, argv) -> tuple:
    """(return code, stdout, stderr) of ``main(argv)``."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _tools(name: str):
    """The port's and the JAX package's ``main`` of tool ``name``."""
    import importlib
    return (importlib.import_module(f"libjxl_torch.cli.{name}").main,
            importlib.import_module(f"libjxl_tpu.cli.{name}").main)


@pytest.fixture(scope="module")
def ppm(tmp_path_factory):
    from libjxl_torch.extras.io import save_image
    path = str(tmp_path_factory.mktemp("cli") / "in.ppm")
    save_image(path, IMG)
    return path


@pytest.mark.parametrize("opts", CJXL_CASES, ids=" ".join)
def test_cjxl_and_djxl_match_reference(tmp_path, ppm, opts):
    cjxl, cjxl_ref = _tools("cjxl")
    djxl, djxl_ref = _tools("djxl")
    got, want = str(tmp_path / "port.jxl"), str(tmp_path / "ref.jxl")
    assert _run(cjxl, [ppm, got, "-q"] + opts)[0] == 0
    assert _run(cjxl_ref, [ppm, want, "-q"] + opts)[0] == 0
    with open(got, "rb") as a, open(want, "rb") as b:
        data = a.read()
        assert data == b.read()
    exts = [".ppm"]
    try:
        import PIL  # noqa: F401
        exts.append(".png")
    except ImportError:
        pass
    for ext in exts:
        outs = [str(tmp_path / f"{who}{ext}") for who in ("port", "ref")]
        assert _run(djxl, [got, outs[0], "-q"])[0] == 0
        assert _run(djxl_ref, [got, outs[1], "-q"])[0] == 0
        with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
            assert a.read() == b.read(), ext
    if "0" in opts or "--lossless" in opts:
        from libjxl_torch.extras.io import load_image
        assert np.array_equal(load_image(str(tmp_path / "port.ppm")), IMG)


def test_cjxl_e7_device_matches_encode_lossy(tmp_path, ppm):
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
    cjxl, _ = _tools("cjxl")
    out = str(tmp_path / "e7.jxl")
    assert _run(cjxl, [ppm, out, "-d", "1", "-e", "7", "--device",
                       "-q"])[0] == 0
    want = encode_lossy(IMG, LossyOptions(distance=1.0, effort=7,
                                          use_device=True), device="cpu")
    with open(out, "rb") as f:
        assert f.read() == want


@pytest.fixture(scope="module")
def streams():
    """A lossless and a lossy stream of IMG (the JAX package's host
    encoders), and the lossless one in a container with an Exif box."""
    from libjxl_tpu.api.container import wrap_container
    from libjxl_tpu.api.encoder import EncodeOptions, encode_lossless
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
    lossless = encode_lossless(IMG, EncodeOptions(effort=2))
    return dict(lossless=lossless,
                lossy=encode_lossy(IMG, LossyOptions(distance=1.0,
                                                     effort=3)),
                boxed=wrap_container(lossless, extra_boxes=[
                    (b"Exif", b"\x00\x00\x00\x00MM\x00*")]))


@pytest.mark.parametrize("kind", ["lossless", "lossy", "boxed"])
def test_jxlinfo_matches_reference(tmp_path, streams, kind):
    path = tmp_path / "in.jxl"
    path.write_bytes(streams[kind])
    port, ref = _tools("jxlinfo")
    got = _run(port, [str(path), "-v"])
    assert got[0] == 0
    assert got == _run(ref, [str(path), "-v"])


@pytest.mark.parametrize("op", [["--pack"], ["--extract"], ["--strip"],
                                ["--pack", "--strip"]])
@pytest.mark.parametrize("kind", ["lossless", "boxed"])
def test_jxltran_matches_reference(tmp_path, streams, kind, op):
    path = tmp_path / "in.jxl"
    path.write_bytes(streams[kind])
    port, ref = _tools("jxltran")
    outs = [tmp_path / "port.jxl", tmp_path / "ref.jxl"]
    got = _run(port, [str(path), str(outs[0])] + op)
    assert got == _run(ref, [str(path), str(outs[1])] + op)
    if got[0] == 0:
        assert outs[0].read_bytes() == outs[1].read_bytes()


@pytest.fixture(scope="module")
def distorted(tmp_path_factory):
    """IMG and its d2 e3 host round trip, as .ppm files."""
    from libjxl_torch.api.decoder import decode
    from libjxl_torch.extras.io import save_image
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
    d = tmp_path_factory.mktemp("metrics")
    dec = decode(encode_lossy(IMG, LossyOptions(distance=2.0, effort=3)),
                 device="cpu")
    paths = str(d / "a.ppm"), str(d / "b.ppm")
    save_image(paths[0], IMG)
    save_image(paths[1], dec)
    return paths


def test_ssimulacra2_cli_matches_reference(distorted):
    port, ref = _tools("ssimulacra2")
    got = _run(port, list(distorted))
    assert got[0] == 0 and float(got[1]) < 100.0
    assert got == _run(ref, list(distorted))


def test_butteraugli_cli_matches_reference(tmp_path, distorted):
    port, ref = _tools("butteraugli")
    maps = [str(tmp_path / "port.npy"), str(tmp_path / "ref.npy")]
    got = _run(port, list(distorted) + ["--distmap", maps[0]])
    want = _run(ref, list(distorted) + ["--distmap", maps[1]])
    assert got[0] == want[0] == 0
    np.testing.assert_allclose(float(got[1]), float(want[1]),
                               rtol=BUTTERAUGLI_RTOL)
    values = [float(r[2].split(":")[1]) for r in (got, want)]
    np.testing.assert_allclose(*values, rtol=BUTTERAUGLI_RTOL)
    dm, dm_ref = (np.load(m) for m in maps)
    assert dm.shape == dm_ref.shape == IMG.shape[:2]
    assert dm.dtype == dm_ref.dtype == np.float32


def test_benchmark_xl_matches_reference(monkeypatch):
    """The JAX tool reads a ":device" spec's "device" as a distance and
    fails; it is given the port's spec parser (plain Python)."""
    from libjxl_torch.cli import benchmark_xl as port
    from libjxl_tpu.cli import benchmark_xl as ref
    with pytest.raises(ValueError, match="evice"):
        ref._parse_codec("jxl:d0:e3:device")
    monkeypatch.setattr(ref, "_parse_codec", port._parse_codec)
    specs = ["jxl:d0:e2", "jxl:d1:e3", "jxl:d0:e3:device"]
    outs = [io.StringIO(), io.StringIO()]
    got = port.run_benchmark([IMG], specs, out=outs[0])
    want = ref.run_benchmark([IMG], specs, out=outs[1])
    assert [r["codec"] for r in got] == specs
    for g, w in zip(got, want):
        for k in ("codec", "kpixels", "bytes", "bpp", "psnr", "ssimulacra2"):
            assert g[k] == w[k], (g["codec"], k)
        for k in ("max_norm", "pnorm", "qabpp"):
            if g["psnr"] == 99.99 and k != "qabpp":
                # an exact decode: float noise on both sides, below the
                # JAX suite's lossless bound (tests/test_cli.py)
                assert max(g[k], w[k]) < 1e-4, (g["codec"], k)
                continue
            np.testing.assert_allclose(g[k], w[k], rtol=BUTTERAUGLI_RTOL,
                                       err_msg=f"{g['codec']} {k}")
    # the table's rows, without the two timing columns
    heads = [o.getvalue().splitlines()[:2] for o in outs]
    assert heads[0] == heads[1]
    assert got[0]["psnr"] == 99.99 and got[2]["psnr"] == 99.99


def test_benchmark_xl_main_loads_pnm(ppm):
    from libjxl_torch.cli import benchmark_xl as port
    assert np.array_equal(port._load(ppm), IMG)
    assert port.main([ppm, "--codec", "jxl:d0:e2"]) == 0


def test_fuzz_matches_reference():
    from libjxl_torch.cli import fuzz as port
    from libjxl_tpu.cli import fuzz as ref
    outs = [io.StringIO(), io.StringIO()]
    assert port.run_fuzz(12, 3, out=outs[0]) == \
        ref.run_fuzz(12, 3, out=outs[1]) == 0
    assert outs[0].getvalue() == outs[1].getvalue()


def test_platform_env_sets_the_device(monkeypatch):
    from libjxl_torch.cli import apply_platform_env
    monkeypatch.setattr(config, "device", "cuda")
    apply_platform_env()
    assert config.device == "cuda"
    monkeypatch.setenv("LIBJXL_TORCH_DEVICE", "cpu")
    apply_platform_env()
    assert config.device == "cpu"


_BLOCKED_CLI = r"""
import runpy
import sys
sys.modules["jax"] = None          # any import of jax now fails


class _NoReference:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "libjxl_tpu":
            raise ImportError("libjxl_tpu is blocked: " + name)
        return None


sys.meta_path.insert(0, _NoReference())
tool = sys.argv[1]
sys.argv = [tool] + sys.argv[2:]
try:
    runpy.run_module("libjxl_torch.cli." + tool, run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
from libjxl_torch.config import config
assert config.device == "cpu", config.device
"""


@pytest.mark.parametrize("opts", [["-d", "0", "--device"],
                                  ["-d", "1", "-e", "3", "--device"]],
                         ids=" ".join)
def test_cli_subprocess_with_jax_blocked(tmp_path, ppm, opts):
    """``python -m libjxl_torch.cli.cjxl`` and ``djxl`` with jax and the
    JAX package blocked, on the CPU through LIBJXL_TORCH_DEVICE: a .ppm
    round trip, each file equal to the in-process tool's."""
    env = dict(os.environ, LIBJXL_TORCH_DEVICE="cpu")
    jxl, back = str(tmp_path / "out.jxl"), str(tmp_path / "out.ppm")
    for argv in (["cjxl", ppm, jxl, "-q"] + opts, ["djxl", jxl, back, "-q"]):
        proc = subprocess.run([sys.executable, "-c", _BLOCKED_CLI] + argv,
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
    cjxl, _ = _tools("cjxl")
    djxl, _ = _tools("djxl")
    jxl2, back2 = str(tmp_path / "in.jxl"), str(tmp_path / "in.ppm")
    assert _run(cjxl, [ppm, jxl2, "-q"] + opts)[0] == 0
    assert _run(djxl, [jxl2, back2, "-q"])[0] == 0
    for a, b in ((jxl, jxl2), (back, back2)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    if opts[1] == "0":
        from libjxl_torch.extras.io import load_image
        assert np.array_equal(load_image(back), IMG)
