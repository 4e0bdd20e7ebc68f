"""The import guard: which forbidden packages a process has loaded.

Names are compared by their top-level part (before the first dot) whole,
so ``libjxl_torch`` is not taken for ``libjxl_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "libjxl_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names of ``modules`` (default ``sys.modules``)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
