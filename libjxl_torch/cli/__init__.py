"""Command-line tools (reference ``tools/``)."""

import os


def apply_platform_env() -> None:
    """Honor ``LIBJXL_TORCH_DEVICE``: when set, it becomes
    ``config.device``. Called by every CLI entry point so
    ``LIBJXL_TORCH_DEVICE=cpu python -m libjxl_torch.cli.cjxl ...`` stays
    off the card; unset, the tools run on ``config.device`` ("cuda")."""
    dev = os.environ.get("LIBJXL_TORCH_DEVICE")
    if not dev:
        return
    from libjxl_torch.config import config
    config.device = dev
