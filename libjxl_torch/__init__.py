"""libjxl_torch: the JPEG XL engine in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

A port of ``libjxl_tpu`` that mirrors its module names. It imports
``torch``, never ``jax``, and nothing of ``libjxl_tpu``: it keeps its own
copy of each jax-free host module it needs (headers, entropy coders, the
host codecs), at the same relative path; the C++ host runtime
``native/jxl_host.cc`` is shared.
Functions that touch the device take an explicit ``device`` argument;
``libjxl_torch.config.config.device`` is the default ("cuda").
"""

from libjxl_torch import config  # noqa: F401  (pins the float precision)
