"""Share of the frames handed to ``decode_many`` in the traced window
that took the device route of recompressed JPEGs (counter
``decode_many.jpeg_frames``). A program without the counter names none,
and this reads nothing."""

from jxlbench.registry import resolve_attr

NAME = "decode_many.jpeg_frames"
PATH = "libjxl_torch.api.decoder:decode_many.jpeg_frames"


def _has_counter() -> bool:
    try:
        resolve_attr(PATH)
    except (ImportError, AttributeError):
        return False
    return True


COUNTERS = {NAME: PATH} if _has_counter() else {}


def read(run):
    frames = len(run.items)
    if not frames or NAME not in run.counters:
        return None
    return 100.0 * run.counters[NAME] / frames
