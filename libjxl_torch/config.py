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
    # decode() switches to the banded low-memory decoder above this
    # many pixels (low_memory_render_pipeline.cc spirit): pixel
    # intermediates stay bounded by ~3 group rows. 64 MP default.
    auto_band_pixels: int = 64 << 20


config = RuntimeConfig()


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or the configured default."""
    return torch.device(config.device if device is None else device)
