"""Gaborish and EPF kernel launches per frame decoded in the traced
window (counters ``gaborish_filter.launches`` and ``epf_filter.launches``;
they count launches on the card only)."""

COUNTERS = {
    "gaborish_filter.launches":
        "libjxl_torch.models.filter_kernels:gaborish_filter.launches",
    "epf_filter.launches":
        "libjxl_torch.models.filter_kernels:epf_filter.launches",
}


def read(run):
    frames = len(run.items)
    if not frames:
        return None
    return (run.counters["gaborish_filter.launches"] +
            run.counters["epf_filter.launches"]) / frames
