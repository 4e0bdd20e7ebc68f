"""Share of the frames handed to ``decode_many`` in the traced window
that the device reconstructed (counter ``decode_many.device_frames``)."""

COUNTERS = {"decode_many.device_frames":
            "libjxl_torch.api.decoder:decode_many.device_frames"}


def read(run):
    frames = len(run.items)
    if not frames:
        return None
    return 100.0 * run.counters["decode_many.device_frames"] / frames
