"""The port's effort 5-7 VarDCT encode against the JAX package on the CPU,
whole streams, on the 64x96 image of ``tests/test_vardct_encoder.py`` at
distance 5 (Gaborish and three EPF passes, the two-candidate sharpness
search): the device path at effort 5 and 7 and the host path at effort 7
give the JAX package's bytes (``EXPECT``); the device stream is at most
1.08x the port's own host stream (the JAX suite's size gate; its
butteraugli gate is for distance 1). One JAX effort-7 device compile
(see ``test_torch_vardct_e7.py``).
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_e7 import equal_or_gate, one_torch_thread, photo  # noqa: E402,F401
from libjxl_torch.vardct import frame_enc as port  # noqa: E402
from libjxl_tpu.vardct import frame_enc as ref  # noqa: E402

IMG = photo(64, 96, 1)
D = 5.0
CASES = [(5, True), (7, False), (7, True)]
# every stream equals the JAX package's
EXPECT = {c: "equal" for c in CASES}


@pytest.fixture(scope="module")
def port_streams():
    return {c: port.encode_lossy(IMG, port.LossyOptions(
        distance=D, effort=c[0], use_device=c[1]), device="cpu")
        for c in CASES}


@pytest.mark.parametrize("effort,use_device", CASES)
def test_stream_matches_jax_or_gate(effort, use_device, port_streams):
    got = port_streams[(effort, use_device)]
    want = ref.encode_lossy(IMG, ref.LossyOptions(
        distance=D, effort=effort, use_device=use_device))
    kind = equal_or_gate(IMG, got, want)
    assert kind == "equal" or EXPECT[(effort, use_device)] == "gate"


def test_device_size_gate_holds_for_port(port_streams):
    assert len(port_streams[(7, True)]) <= 1.08 * len(
        port_streams[(7, False)])
