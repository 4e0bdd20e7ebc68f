"""Encoder debug-image hook + leveled debug logging (reference
``enc_debug_image.{h,cc}`` DumpImage/DumpHeatmap via
``JxlEncoderSetDebugImageCallback``, and ``base/printf_macros.h``
JXL_DEBUG_V).

Usage::

    from libjxl_torch.utils import debug
    debug.set_debug_image_callback(lambda label, img: ...)
    # or collect into a dict:
    with debug.collect_debug_images() as images:
        encode_lossy(...)
    # images == {"quant_heatmap": (h, w) float array, ...}

Logging: ``JXLT_DEBUG=2`` in the environment (or ``set_level(2)``)
enables ``debug.log(level, msg)`` output up to that verbosity.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

_state = threading.local()
_LEVEL = int(os.environ.get("JXLT_DEBUG", "0") or 0)


def set_level(level: int) -> None:
    global _LEVEL
    _LEVEL = int(level)


def log(level: int, msg: str) -> None:
    """Leveled debug logging (JXL_DEBUG_V analog): printed when the
    configured verbosity is >= level."""
    if _LEVEL >= level:
        print(f"[jxlt:{level}] {msg}", file=sys.stderr)


def set_debug_image_callback(cb) -> None:
    """cb(label: str, image: np.ndarray) — receives encoder
    intermediates (quant-field heatmaps, butteraugli diffmaps); None
    disables. Thread-local, like the stats collector."""
    _state.cb = cb


def dump_image(label: str, image) -> None:
    """Encoder-side hook point (DumpImage/DumpHeatmap analog): no-op
    unless a callback is installed — zero overhead on the hot path."""
    cb = getattr(_state, "cb", None)
    if cb is not None:
        import numpy as np
        cb(label, np.asarray(image))


def active() -> bool:
    return getattr(_state, "cb", None) is not None


@contextlib.contextmanager
def collect_debug_images():
    """Collect all dumped intermediates into the yielded dict."""
    images: dict = {}
    old = getattr(_state, "cb", None)
    _state.cb = lambda label, img: images.__setitem__(label, img)
    try:
        yield images
    finally:
        _state.cb = old
