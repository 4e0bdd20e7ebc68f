"""Quality metrics (reference ``lib/jxl/butteraugli/``, ``lib/extras/metrics.cc``)."""

from libjxl_torch.metrics.butteraugli import (  # noqa: F401
    butteraugli_diffmap, butteraugli_distance, butteraugli_distance_srgb,
    compute_distance_p,
)
