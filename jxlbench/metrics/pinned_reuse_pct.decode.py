"""Share of the frames handed to ``decode_many`` in the traced window
that its fetch copied into a page-locked block the host cache already
held: frames fetched into page-locked memory (counter
``decode_many.pinned_frames``) less the blocks pinned anew for them
(``decode_many.pinned_new_blocks``), over the frames handed in. A
program without the counters names none, and this reads nothing."""

from jxlbench.registry import resolve_attr

FRAMES = "decode_many.pinned_frames"
NEW = "decode_many.pinned_new_blocks"
PATHS = {name: "libjxl_torch.api.decoder:" + name for name in (FRAMES, NEW)}


def _has_counters() -> bool:
    try:
        for path in PATHS.values():
            resolve_attr(path)
    except (ImportError, AttributeError):
        return False
    return True


COUNTERS = PATHS if _has_counters() else {}


def read(run):
    frames = len(run.items)
    if not frames or FRAMES not in run.counters or NEW not in run.counters:
        return None
    return 100.0 * (run.counters[FRAMES] - run.counters[NEW]) / frames
