"""Copies of the JPEG XL host decode modules of ``libjxl_tpu`` (the
repository's reference implementation, which the port is held to), so
that the benchmark's plain reference imports nothing of the program nor
of the JAX package: same relative paths, package prefix rewritten to
``jxlbench.ref.jxl``, ``utils/native.py`` replaced by a stub (Python and
numpy paths only), and one vectorised path added to
``modular/codec.py`` (prefix-coded single-leaf channels). Nothing else
is edited."""
