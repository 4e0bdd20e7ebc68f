"""The port's effort 5-7 VarDCT encode against the JAX package on the CPU,
whole streams, on the 120x168 image of ``tests/test_vardct_encoder.py``
at distance 1 (Gaborish and one EPF pass):

* the device path at effort 5, 6 and 7 and the host path at effort 7
  give the JAX package's bytes, but for the host path at effort 7, where
  float32 differences between the libraries move a rounding step and
  the stream meets the fallback gate instead
  (``tests/_torch_e7.equal_or_gate``, ``EXPECT``);
* the JAX suite's own device gates hold for the port, its host path the
  baseline: the device stream at most 1.08x the host stream, a
  butteraugli distance below 3.0, and ``config.device_transform`` on and
  off giving equal streams (tests/test_vardct_encoder.py:519-537,
  606-625);
* ``encode_lossy_many`` runs the device front end once per image (the
  JAX package runs it twice at effort >= 5).

Sibling files hold the other distances, one JAX effort-7 device
compile a file.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_e7 import (  # noqa: E402,F401
    distance, equal_or_gate, one_torch_thread, photo,
)
from libjxl_torch.config import config  # noqa: E402
from libjxl_torch.models import vardct_heuristics as TH  # noqa: E402
from libjxl_torch.vardct import frame_enc as port  # noqa: E402
from libjxl_tpu.vardct import frame_enc as ref  # noqa: E402

IMG = photo(120, 168, 1)
D = 1.0
CASES = [(5, True), (6, True), (7, False), (7, True)]
# what each stream is against the JAX package's: "equal" bytes, or
# "gate", where the fallback gate is allowed (equal bytes pass too)
EXPECT = {
    (5, True): "equal",
    (6, True): "equal",
    # first differing stage: the loop scorer's block sums (2.5e-05
    # relative) move the loop's integer global scale one step
    (7, False): "gate",
    (7, True): "equal",
}


def _enc(mod, effort, use_device, device=None, img=IMG):
    opts = mod.LossyOptions(distance=D, effort=effort, use_device=use_device)
    if mod is ref:
        return ref.encode_lossy(img, opts)
    return port.encode_lossy(img, opts, device=device)


@pytest.fixture(scope="module")
def jax_streams():
    return {c: _enc(ref, *c) for c in CASES}


@pytest.fixture(scope="module")
def port_streams():
    return {c: _enc(port, *c, device="cpu")
            for c in CASES + [(5, False)]}


@pytest.mark.parametrize("effort,use_device", CASES)
def test_stream_matches_jax_or_gate(effort, use_device, jax_streams,
                                    port_streams):
    got = port_streams[(effort, use_device)]
    want = jax_streams[(effort, use_device)]
    kind = equal_or_gate(IMG, got, want)
    assert kind == "equal" or EXPECT[(effort, use_device)] == "gate"


@pytest.mark.parametrize("effort", [5, 7])
def test_device_gates_hold_for_port(effort, port_streams):
    host = port_streams[(effort, False)]
    dev = port_streams[(effort, True)]
    assert len(dev) <= 1.08 * len(host)
    assert distance(IMG, dev) < 3.0


def test_device_transform_on_and_off_equal(port_streams):
    try:
        config.device_transform = False
        off = _enc(port, 7, True, "cpu")
    finally:
        config.device_transform = True
    assert off == port_streams[(7, True)]


def test_encode_lossy_many_runs_each_image_once(monkeypatch):
    imgs = [photo(64, 96, 11), photo(64, 96, 12), photo(48, 80, 13)]
    opts = port.LossyOptions(distance=D, effort=5, use_device=True)
    solo = [port.encode_lossy(im, opts, device="cpu") for im in imgs]
    calls = []
    fn = TH.front_device

    def spy(px, *a, **k):
        calls.append(np.shape(px))
        return fn(px, *a, **k)

    monkeypatch.setattr(TH, "front_device", spy)
    got = port.encode_lossy_many(imgs, opts, workers=2, device="cpu")
    assert got == solo
    assert sorted(calls) == sorted(im.shape for im in imgs)
