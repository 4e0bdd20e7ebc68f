"""The port's multi-process encode and decode (``parallel/multihost.py``)
over ``torch.distributed``: one gloo group of 2 processes on the CPU
(``tests/_torch_multihost_worker.py``, started once for the module) runs
the lossless and the VarDCT streaming encode and the sharded decode on
the JAX package's multi-host test images (2 DC-group bands, one a
process). Each result equals the port's single-process
``encode_lossless_streaming`` / ``encode_lossy_streaming`` / ``decode``
and the JAX package's, run in this process.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_e7 import one_torch_thread  # noqa: E402,F401

from _torch_multihost_worker import images  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _decode_input() -> tuple:
    """The JAX package's multi-host decode stream: a 1200x320 image at
    d1 e5 (5 group rows), encoded by the JAX package."""
    from libjxl_tpu.vardct.frame_enc import LossyOptions, encode_lossy
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:1200, 0:320]
    img = (np.stack([xx % 256, yy % 256, (xx + yy) % 256], -1)
           + rng.integers(0, 16, (1200, 320, 3))
           ).clip(0, 255).astype(np.uint8)
    return encode_lossy(img, LossyOptions(distance=1.0, effort=5))


@pytest.fixture(scope="module")
def group_out(tmp_path_factory):
    """Start the 2-process group once; returns its output directory."""
    out = tmp_path_factory.mktemp("torch_mh")
    (out / "decode.in").write_bytes(_decode_input())
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "PYTHONPATH")}
    worker = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(r), "2", str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-2000:]
    return out


def test_two_process_lossless_encode(group_out):
    from libjxl_torch.api.encoder import (
        EncodeOptions, encode_lossless_streaming,
    )
    from libjxl_tpu.api import encoder as ref

    img, _ = images()
    multi = (group_out / "lossless.jxl").read_bytes()
    single = b"".join(encode_lossless_streaming(
        img, EncodeOptions(effort=2, group_size_shift=0)))
    assert multi == single
    assert multi == b"".join(ref.encode_lossless_streaming(
        img, ref.EncodeOptions(effort=2, group_size_shift=0)))


def test_two_process_vardct_encode(group_out):
    from libjxl_torch.vardct.frame_enc import (
        LossyOptions, encode_lossy_streaming,
    )
    from libjxl_tpu.vardct import frame_enc as ref

    _, img = images()
    multi = (group_out / "vardct.jxl").read_bytes()
    assert multi == encode_lossy_streaming(
        img, LossyOptions(distance=1.0, effort=3))
    assert multi == ref.encode_lossy_streaming(
        img, ref.LossyOptions(distance=1.0, effort=3))


def test_two_process_decode(group_out):
    from libjxl_torch.api.decoder import decode
    from libjxl_tpu.api import decoder as ref

    data = (group_out / "decode.in").read_bytes()
    multi = np.load(group_out / "decode.npy")
    np.testing.assert_array_equal(multi, decode(data, device="cpu"))
    np.testing.assert_array_equal(multi, ref.decode(data))
