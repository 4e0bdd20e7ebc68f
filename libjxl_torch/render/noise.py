"""Noise synthesis (reference ``lib/jxl/dec_noise.cc``,
``lib/jxl/render_pipeline/stage_noise.cc``, ``lib/jxl/noise.h``,
``lib/jxl/xorshift128plus-inl.h``).

The bitstream carries an 8-point strength LUT; the decoder generates
deterministic pseudo-random planes (8-lane xorshift128+, seeded per
group tile), convolves them with a 5x5 laplacian-like kernel and adds
them to the XYB channels with intensity-dependent strength."""

from __future__ import annotations

import numpy as np

K_NOISE_PRECISION = 1024.0
_SPLIT_C1 = np.uint64(0x9E3779B97F4A7C15)


def decode_noise(r) -> np.ndarray:
    """DecodeNoise (dec_noise.cc:154-162): 8 x 10-bit LUT values."""
    return np.array([r.read(10) / K_NOISE_PRECISION for _ in range(8)],
                    dtype=np.float32)


def _split_mix64(z: np.uint64) -> np.uint64:
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class Xorshift128Plus:
    """8 independent xorshift128+ streams (xorshift128plus-inl.h)."""

    N = 8

    def __init__(self, seed1, seed2, seed3, seed4):
        with np.errstate(over="ignore"):
            s0 = np.zeros(self.N, np.uint64)
            s1 = np.zeros(self.N, np.uint64)
            s0[0] = _split_mix64(
                np.uint64((int(seed1) << 32) + int(seed2)) + _SPLIT_C1)
            s1[0] = _split_mix64(
                np.uint64((int(seed3) << 32) + int(seed4)) + _SPLIT_C1)
            for i in range(1, self.N):
                s0[i] = _split_mix64(s0[i - 1])
                s1[i] = _split_mix64(s1[i - 1])
        self.s0, self.s1 = s0, s1

    def fill(self) -> np.ndarray:
        """-> 8 uint64 random values; advances state."""
        with np.errstate(over="ignore"):
            s1 = self.s0
            s0 = self.s1
            bits = s1 + s0
            s1 = s1 ^ (s1 << np.uint64(23))
            s1 = s1 ^ s0 ^ (s1 >> np.uint64(18)) ^ (s0 >> np.uint64(5))
            self.s0, self.s1 = s0, s1
        return bits


def _bits_to_floats(batch64: np.ndarray) -> np.ndarray:
    """16 floats in [1, 2) from 8 uint64 (BitsToFloat semantics)."""
    b32 = batch64.view(np.uint32)          # little-endian: lo, hi per u64
    return ((b32 >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)


def _random_plane_rows(rng: Xorshift128Plus, h: int, w: int) -> np.ndarray:
    """RandomImage (dec_noise.cc:58-97): per row, whole 16-float batches
    while x+16 < w, then one final batch for the tail."""
    out = np.empty((h, w), np.float32)
    nfull = (w - 17) // 16 + 1 if w > 16 else 0
    for y in range(h):
        row = np.empty((nfull + 1) * 16, np.float32)
        for i in range(nfull + 1):
            row[i * 16:(i + 1) * 16] = _bits_to_floats(rng.fill())
        out[y] = row[:w]
    return out


def generate_noise_planes(h: int, w: int, group_dim: int,
                          visible_frame_index: int = 1,
                          nonvisible_frame_index: int = 0) -> np.ndarray:
    """(3, h, w) raw noise at the final resolution, seeded per
    group-dim tile (PrepareNoiseInput, dec_noise.cc:120-152)."""
    planes = np.empty((3, h, w), np.float32)
    for y0 in range(0, h, group_dim):
        for x0 in range(0, w, group_dim):
            th = min(group_dim, h - y0)
            tw = min(group_dim, w - x0)
            rng = Xorshift128Plus(visible_frame_index,
                                  nonvisible_frame_index, x0, y0)
            for c in range(3):
                planes[c, y0:y0 + th, x0:x0 + tw] = \
                    _random_plane_rows(rng, th, tw)
    return planes


def _convolve_noise(plane: np.ndarray) -> np.ndarray:
    """ConvolveNoiseStage: 0.16 * (5x5 sum excluding center) - 3.84 *
    center, mirrored borders."""
    h, w = plane.shape
    p = np.pad(plane, 2, mode="symmetric")
    acc = np.zeros_like(plane, dtype=np.float64)
    for dy in range(5):
        for dx in range(5):
            if dy == 2 and dx == 2:
                continue
            acc += p[dy:dy + h, dx:dx + w]
    return (0.16 * acc - 3.84 * plane).astype(np.float32)


def _strength_lut(lut: np.ndarray, v: np.ndarray) -> np.ndarray:
    """StrengthEvalLut + Clamp0ToMax (stage_noise.cc:60-130)."""
    scale = 6  # kNumNoisePoints - 2
    scaled = np.maximum(0.0, v * scale)
    floor = np.floor(scaled)
    frac = scaled - floor
    over = scaled >= scale + 1
    floor = np.where(over, float(scale), floor)
    frac = np.where(over, 1.0, frac)
    fi = floor.astype(np.int32)
    low = lut[fi]
    hi = lut[np.minimum(fi + 1, 7)]
    val = (hi - low) * frac + low
    return np.clip(val, 0.0, 1.0)


def add_noise(xyb: np.ndarray, lut: np.ndarray, group_dim: int,
              base_correlation_x: float = 0.0,
              base_correlation_b: float = 1.0,
              visible_frame_index: int = 1) -> np.ndarray:
    """Apply the full noise pipeline to (3, H, W) XYB in place-ish."""
    _, h, w = xyb.shape
    raw = generate_noise_planes(h, w, group_dim, visible_frame_index)
    rnd = np.stack([_convolve_noise(raw[c]) for c in range(3)]) * 0.22

    in_g = xyb[1] - xyb[0]
    in_r = xyb[1] + xyb[0]
    strength_g = _strength_lut(lut, in_g * 0.5)
    strength_r = _strength_lut(lut, in_r * 0.5)
    k_corr, k_ncorr = 0.9921875, 0.0078125
    red_noise = strength_r * (k_ncorr * rnd[0] + k_corr * rnd[2])
    green_noise = strength_g * (k_ncorr * rnd[1] + k_corr * rnd[2])
    rg = red_noise + green_noise
    out = xyb.copy()
    out[0] += base_correlation_x * rg + (red_noise - green_noise)
    out[1] += rg
    out[2] += base_correlation_b * rg
    return out


def _generate_noise_rows(row0: int, row1: int, w: int, h_total: int,
                         group_dim: int,
                         visible_frame_index: int = 1) -> np.ndarray:
    """Raw noise planes for absolute image rows [row0, row1): the
    per-group Xorshift seeding makes any window reproducible. The three
    channels consume ONE rng stream per group sequentially, so each
    intersecting group is generated at its full whole-frame height and
    sliced — bit-identical to generate_noise_planes."""
    planes = np.empty((3, row1 - row0, w), np.float32)
    g0 = (row0 // group_dim) * group_dim
    for y0 in range(g0, row1, group_dim):
        th = min(group_dim, h_total - y0)
        a = max(y0, row0)
        b = min(y0 + th, row1)
        for x0 in range(0, w, group_dim):
            tw = min(group_dim, w - x0)
            rng = Xorshift128Plus(visible_frame_index, 0, x0, y0)
            for c in range(3):
                tile = _random_plane_rows(rng, th, tw)
                planes[c, a - row0:b - row0, x0:x0 + tw] = \
                    tile[a - y0:b - y0]
    return planes


def add_noise_band(xyb_band: np.ndarray, lut: np.ndarray, group_dim: int,
                   row0: int, h_total: int,
                   base_correlation_x: float = 0.0,
                   base_correlation_b: float = 1.0,
                   visible_frame_index: int = 1) -> np.ndarray:
    """Band-windowed add_noise: bit-identical to the whole-frame result
    on rows [row0, row0+band). The 5x5 noise convolution needs a 2-row
    halo; interior bands use the real neighbor groups' (reproducible)
    raw noise, image edges use the same symmetric mirror as the
    whole-frame path."""
    _, rows, w = xyb_band.shape
    c0 = max(0, row0 - 2)
    c1 = min(h_total, row0 + rows + 2)
    raw = _generate_noise_rows(c0, c1, w, h_total, group_dim,
                               visible_frame_index)

    def conv(plane):
        pt = 2 - (row0 - c0)                 # top mirror only at y=0
        pb = 2 - (c1 - row0 - rows)          # bottom mirror only at y=H
        p = np.pad(plane, ((pt, pb), (2, 2)), mode="symmetric")
        # p rows now cover [row0-2, row0+rows+2) exactly
        acc = np.zeros((rows, w), np.float64)
        for dy in range(5):
            for dx in range(5):
                if dy == 2 and dx == 2:
                    continue
                acc += p[dy:dy + rows, dx:dx + w]
        center = plane[row0 - c0:row0 - c0 + rows]
        return (0.16 * acc - 3.84 * center).astype(np.float32)

    rnd = np.stack([conv(raw[c]) for c in range(3)]) * 0.22
    in_g = xyb_band[1] - xyb_band[0]
    in_r = xyb_band[1] + xyb_band[0]
    strength_g = _strength_lut(lut, in_g * 0.5)
    strength_r = _strength_lut(lut, in_r * 0.5)
    k_corr, k_ncorr = 0.9921875, 0.0078125
    red_noise = strength_r * (k_ncorr * rnd[0] + k_corr * rnd[2])
    green_noise = strength_g * (k_ncorr * rnd[1] + k_corr * rnd[2])
    rg = red_noise + green_noise
    out = xyb_band.copy()
    out[0] += base_correlation_x * rg + (red_noise - green_noise)
    out[1] += rg
    out[2] += base_correlation_b * rg
    return out
