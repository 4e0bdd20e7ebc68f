"""Runtime configuration of the PyTorch port.

The device is explicit: every function that touches a tensor takes a
``device`` argument, and ``None`` means ``config.device``. Nothing falls
back to the CPU on its own: on a machine without a card, pass "cpu".

Float math runs in true fp32: TF32 is off for matrix products and for
cuDNN convolutions (the latter is on by default in PyTorch).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass
class RuntimeConfig:
    device: str = "cuda"
    # Run decode()'s restoration filters (Gaborish/EPF) in float32 on the
    # device, through the hand kernels (render/filters_torch.py), instead
    # of the float64 host filters. None = auto: on for frames of at least
    # 4 MP, the reference's threshold, so that the port and the JAX
    # package filter every frame size on the same side.
    device_filters: bool | None = None
    # The effort >= 5 device path: run the variable-block forward
    # transforms + quantization on the device (models/vardct_transform)
    # instead of on the host from the fetched XYB plane.
    device_transform: bool = True
    # decode() switches to the banded low-memory decoder above this
    # many pixels (low_memory_render_pipeline.cc spirit): pixel
    # intermediates stay bounded by ~3 group rows. 64 MP default.
    auto_band_pixels: int = 64 << 20


config = RuntimeConfig()


def device_filters_enabled(num_pixels: int | None = None) -> bool:
    """Resolve the device_filters auto default (see RuntimeConfig).

    An explicit True or False wins. In auto mode the device filters run
    for frames of at least 4 MP. The rule is a pure function of the
    frame, so whole-frame and banded decode of one stream always take
    the same path; it never looks at whether a card is present (a caller
    without one passes ``device="cpu"``)."""
    v = config.device_filters
    if v is not None:
        return v
    return num_pixels is None or num_pixels >= (4 << 20)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or the configured default."""
    return torch.device(config.device if device is None else device)
