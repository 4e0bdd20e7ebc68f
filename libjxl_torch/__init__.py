"""libjxl_torch: the JPEG XL engine in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

A port of ``libjxl_tpu`` that mirrors its module names. It imports
``torch`` and never ``jax``; the jax-free host code of ``libjxl_tpu``
(headers, entropy coders, the native host library) is reused as it is.
Functions that touch the device take an explicit ``device`` argument;
``libjxl_torch.config.config.device`` is the default ("cuda").
"""

from libjxl_torch import config  # noqa: F401  (pins the float precision)
