"""The port's effort 5-7 VarDCT encode against the JAX package on the CPU,
whole streams, on the 120x168 image of ``tests/test_vardct_encoder.py``
at distance 2 (Gaborish and two EPF passes, the three-candidate
sharpness search): the device path at effort 5 and 7 and the host path
at effort 7 give the JAX package's bytes, but for the device path at
effort 7, whose stream meets the fallback gate instead
(``tests/_torch_e7.equal_or_gate``, ``EXPECT``); the device stream is
at most 1.08x the port's own host stream (the JAX suite's size gate; its
butteraugli gate is for distance 1). One JAX effort-7 device compile
(see ``test_torch_vardct_e7.py``).
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_e7 import equal_or_gate, one_torch_thread, photo  # noqa: E402,F401
from libjxl_torch.vardct import frame_enc as port  # noqa: E402
from libjxl_tpu.vardct import frame_enc as ref  # noqa: E402

IMG = photo(120, 168, 1)
D = 2.0
CASES = [(5, True), (7, False), (7, True)]
# what each stream is against the JAX package's: "equal" bytes, or
# "gate", where the fallback gate is allowed (equal bytes pass too)
EXPECT = {
    (5, True): "equal",
    (7, False): "equal",
    # first differing stage: one quantized coefficient of the final emit,
    # from 1-ulp XYB differences of the correctly rounded cube root
    (7, True): "gate",
}


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
