"""Share of the frames handed to ``decode_many`` in the traced window
whose staging came back from the host pool in a shared-memory segment
(counter ``map_decode_inputs.shared_frames``). A program without the
counter names none, and this reads nothing."""

from jxlbench.registry import resolve_attr

NAME = "map_decode_inputs.shared_frames"
PATH = "libjxl_torch.parallel.host_pool:map_decode_inputs.shared_frames"


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
