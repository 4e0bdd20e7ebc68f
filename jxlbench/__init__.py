"""Benchmark of the PyTorch/CUDA port ``libjxl_torch``.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 jxlbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own that the harness finds by the name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its loop
driver, ``drivers/<driver>.py``), ``metrics/<metric>.py`` and
``roofline/<kernel>.py``. Nothing here imports ``jax``, ``jaxlib`` or
``libjxl_tpu``; the plain reference (``ref/``) imports nothing of the port
either.
"""
