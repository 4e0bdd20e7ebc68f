"""Where ``decode_many`` decodes the streams its device program does not
take, at the 4 MP size where the device-filter policy turns on in auto
mode.

A progressive stream (more than one pass) is one such stream. Those
whose filters the policy puts on the card decode in the calling process
on ``device``; the others go to the process pool, whose workers filter
on the host whatever the frame size (they hide the card). With
``config.device_filters = False`` a 4 MP stream must therefore come back
from the pool equal to its host decode in this process, and in auto
mode equal to ``decode`` with its filters on ``device``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import libjxl_torch.config as C  # noqa: E402
from libjxl_torch.api import decoder as port  # noqa: E402
from libjxl_torch.parallel import host_pool  # noqa: E402
from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy  # noqa


@pytest.fixture(scope="module")
def stream_4mp():
    h = w = 2048                      # 4 << 20 pixels: the auto threshold
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h,
                    (xx + yy) * 255 // (h + w)], -1)
    img = (img + rng.integers(0, 6, img.shape)).clip(0, 255).astype(np.uint8)
    data = encode_lossy(img, LossyOptions(distance=1.0, effort=3,
                                          progressive=True, gaborish=1,
                                          epf=0))
    # host-routed, and its frame's filters are past the threshold
    assert port._device_decode_inputs(data) is None
    return data


@pytest.fixture
def policy(monkeypatch):
    def set_to(value):
        monkeypatch.setattr(C.config, "device_filters", value)
    return set_to


@pytest.mark.parametrize("setting", [False, None])
def test_host_routed_4mp_stream(setting, stream_4mp, policy):
    policy(setting)
    assert port._stream_filters_on_device(stream_4mp) is (setting is None)
    want = port.decode(stream_4mp, device="cpu")
    got = port.decode_many([stream_4mp], workers=1, device="cpu")[0]
    np.testing.assert_array_equal(got, want)


def test_pool_workers_filter_on_the_host(policy):
    policy(True)
    pool = host_pool.get_pool(1)
    assert pool.submit(_worker_policy).result() == (False, "")


def _worker_policy():
    import os
    return C.config.device_filters, os.environ["CUDA_VISIBLE_DEVICES"]


def test_policy_skips_unfiltered_and_preview_frames(stream_4mp, policy,
                                                   monkeypatch):
    """Only frames with a filter to run count, and never a preview."""
    from libjxl_torch.api.codestream import parse_codestream
    policy(True)
    fr = parse_codestream(stream_4mp)[1][0]
    assert port._filters_on_device(fr.header, fr.dims)
    lf = fr.header.loop_filter
    monkeypatch.setattr(lf, "gab", False)
    monkeypatch.setattr(lf, "epf_iters", 0)
    assert not port._filters_on_device(fr.header, fr.dims)
    monkeypatch.undo()
    policy(True)
    monkeypatch.setattr(fr.header, "nonserialized_is_preview", True,
                        raising=False)
    monkeypatch.setattr(port, "parse_codestream",
                        lambda data: (None, [fr]))
    assert not port._stream_filters_on_device(stream_4mp)
