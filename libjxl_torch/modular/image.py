"""Modular image: per-channel int32 planes with subsampling shifts
(reference ``lib/jxl/modular/modular_image.{h,cc}``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Channel:
    plane: np.ndarray            # (h, w) int32
    hshift: int = 0
    vshift: int = 0
    component: int = -1          # source color component (modular lossy
    #                              squeeze quantization; -1 = unknown/luma)

    @property
    def w(self) -> int:
        return self.plane.shape[1]

    @property
    def h(self) -> int:
        return self.plane.shape[0]

    @classmethod
    def create(cls, w: int, h: int, hshift: int = 0, vshift: int = 0
               ) -> "Channel":
        return cls(np.zeros((h, w), dtype=np.int32), hshift, vshift)

    def resize(self, w: int, h: int) -> None:
        self.plane = np.zeros((h, w), dtype=np.int32)


@dataclass
class ModularImage:
    """Channel list + metadata (modular_image.h Image)."""

    w: int
    h: int
    bitdepth: int = 8
    nb_meta_channels: int = 0
    channel: list = field(default_factory=list)

    @classmethod
    def create(cls, w: int, h: int, bitdepth: int, nb_channels: int
               ) -> "ModularImage":
        img = cls(w, h, bitdepth)
        img.channel = [Channel.create(w, h) for _ in range(nb_channels)]
        return img
