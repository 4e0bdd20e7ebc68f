"""The port's variable-block reconstruction on synthetic frames that use
every AC strategy 0-26 (``tests/_torch_var_frames.py``), against the JAX
package's ``decode_frames_device_var`` on the CPU: within +-1 per sample,
with the filters off and with Gaborish and three EPF passes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_var_frames import (  # noqa: E402
    reference_dict, synthetic_frames,
)


@pytest.mark.parametrize("gab,epf_iters", [(False, 0), (True, 3)])
def test_decode_frames_device_var_all_strategies(gab, epf_iters):
    from libjxl_torch.core.frame_header import LoopFilter as PortLoopFilter
    from libjxl_torch.models.vardct_decode import decode_frames_device_var
    from libjxl_tpu.core.frame_header import LoopFilter
    from libjxl_tpu.models import vardct_decode as jax_vd
    frames = synthetic_frames()
    got = decode_frames_device_var(frames, PortLoopFilter(), gab, epf_iters,
                                   256, 256, device="cpu")
    want = jax_vd.decode_frames_device_var(
        [reference_dict(f) for f in frames], LoopFilter(), gab, epf_iters, 256,
        256)
    for g, r in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == r.shape == (256, 256, 3)
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 1
        assert 0 < g.mean() < 255
