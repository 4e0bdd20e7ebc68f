"""Frame/group tiling geometry.

JPEG XL tiles every frame into 8x8 blocks, groups (default 256x256 px) and
DC groups (2048x2048 px = 256x256 blocks); groups are the parallel/shard axis
(reference ``lib/jxl/frame_dimensions.h``, ``doc/format_overview.md:180-222``).
"""

from __future__ import annotations

from dataclasses import dataclass

BLOCK_DIM = 8               # kBlockDim
GROUP_DIM = 256             # default group size (pixels)
DC_GROUP_DIM = GROUP_DIM * BLOCK_DIM  # 2048


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class FrameDimensions:
    """Sizes in pixels/blocks/groups for one frame (frame_dimensions.h:87)."""

    xsize: int                  # frame size in pixels (after upsampling)
    ysize: int
    group_dim: int = GROUP_DIM  # from group_size_shift
    maxhs: int = 0              # chroma subsampling max shifts
    maxvs: int = 0              # (frame_dimensions.h:43: block grid is
                                # padded to the luma sampling multiple)

    @property
    def xsize_blocks(self) -> int:
        return cdiv(self.xsize, BLOCK_DIM << self.maxhs) << self.maxhs

    @property
    def ysize_blocks(self) -> int:
        return cdiv(self.ysize, BLOCK_DIM << self.maxvs) << self.maxvs

    @property
    def xsize_padded(self) -> int:
        return self.xsize_blocks * BLOCK_DIM

    @property
    def ysize_padded(self) -> int:
        return self.ysize_blocks * BLOCK_DIM

    @property
    def xsize_groups(self) -> int:
        return cdiv(self.xsize, self.group_dim)

    @property
    def ysize_groups(self) -> int:
        return cdiv(self.ysize, self.group_dim)

    @property
    def num_groups(self) -> int:
        return self.xsize_groups * self.ysize_groups

    @property
    def dc_group_dim(self) -> int:
        return self.group_dim * BLOCK_DIM

    @property
    def xsize_dc_groups(self) -> int:
        return cdiv(self.xsize_blocks, self.group_dim)

    @property
    def ysize_dc_groups(self) -> int:
        return cdiv(self.ysize_blocks, self.group_dim)

    @property
    def num_dc_groups(self) -> int:
        return self.xsize_dc_groups * self.ysize_dc_groups

    def group_rect(self, group_index: int) -> tuple[int, int, int, int]:
        """(x0, y0, xsize, ysize) of an AC group in pixels."""
        gx = group_index % self.xsize_groups
        gy = group_index // self.xsize_groups
        x0 = gx * self.group_dim
        y0 = gy * self.group_dim
        return (x0, y0, min(self.group_dim, self.xsize - x0),
                min(self.group_dim, self.ysize - y0))

    def dc_group_rect(self, index: int) -> tuple[int, int, int, int]:
        """(x0, y0, xsize, ysize) of a DC group in blocks."""
        gx = index % self.xsize_dc_groups
        gy = index // self.xsize_dc_groups
        x0 = gx * self.group_dim
        y0 = gy * self.group_dim
        return (x0, y0, min(self.group_dim, self.xsize_blocks - x0),
                min(self.group_dim, self.ysize_blocks - y0))
