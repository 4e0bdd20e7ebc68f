"""Encoder-side noise modeling: estimation from the image and the
photon-noise ISO model (reference ``lib/jxl/enc_noise.cc:40-382``,
``lib/jxl/enc_photon_noise.cc``).

Vectorized re-design: per-8x8-patch SAD texture scores and Laplacian
noise levels are whole-image array ops (the reference walks pixels);
the 8-point LUT fit keeps the reference's asymmetric quadratic loss +
smoothness regularizer, optimized with plain projected gradient descent
(the problem is 8-dimensional).
"""

from __future__ import annotations

import numpy as np

K_NUM_NOISE_POINTS = 8
K_NOISE_LUT_MAX = 2.0


def _intensity_plane(xyb: np.ndarray) -> np.ndarray:
    # noise model runs on 0.5*(X+Y) (enc_noise.cc:249-255)
    return 0.5 * (xyb[0] + xyb[1])


def _sad_scores(plane: np.ndarray, block_s: int = 8) -> np.ndarray:
    """Per-block texture strength: mean of the smallest half of the SADs
    between each shifted 4x4 window and the center 4x4 patch
    (GetSADScoresForPatches / ROAD, enc_noise.cc:32-67)."""
    h, w = plane.shape
    by, bx = h // block_s, w // block_s
    small = block_s // 2
    offset = (block_s - small) // 2
    blocks = plane[:by * block_s, :bx * block_s] \
        .reshape(by, block_s, bx, block_s).transpose(0, 2, 1, 3)
    center = blocks[:, :, offset:offset + small, offset:offset + small]
    sads = []
    for y0 in range(block_s - small):
        for x0 in range(block_s - small):
            wnd = blocks[:, :, y0:y0 + small, x0:x0 + small]
            sads.append(np.abs(wnd - center).sum(axis=(2, 3)))
    sads = np.stack(sads, axis=-1)            # (by, bx, nSAD)
    k = sads.shape[-1] // 2
    part = np.partition(sads, k - 1, axis=-1)[..., :k]
    return part.mean(axis=-1)


def _laplacian_noise(plane: np.ndarray, block_s: int = 8) -> np.ndarray:
    """Per-block mean |Laplacian| (GetNoiseLevel kernel,
    enc_noise.cc:246-249), with symmetric padding at the plane edge
    (the reference mirrors at block borders; whole-plane filtering uses
    the true neighbors instead — strictly more information)."""
    k = np.array([[-0.25, -1.0, -0.25],
                  [-1.0, 5.0, -1.0],
                  [-0.25, -1.0, -0.25]])
    p = np.pad(plane, 1, mode="symmetric")
    filt = np.zeros_like(plane)
    for dy in range(3):
        for dx in range(3):
            filt += k[dy, dx] * p[dy:dy + plane.shape[0],
                                  dx:dx + plane.shape[1]]
    h, w = plane.shape
    by, bx = h // block_s, w // block_s
    ab = np.abs(filt[:by * block_s, :bx * block_s]) \
        .reshape(by, block_s, bx, block_s)
    return ab.mean(axis=(1, 3))


def estimate_noise(xyb: np.ndarray, quality_coef: float = 1.0
                   ) -> np.ndarray | None:
    """GetNoiseParameter (enc_noise.cc:342-367): returns the 8-entry
    strength LUT, or None when the image should not get synthetic noise
    (strong texture pattern or no noise found)."""
    plane = _intensity_plane(xyb)
    if plane.shape[0] < 16 or plane.shape[1] < 16:
        return None
    sad = _sad_scores(plane)
    # histogram of sad (scaled x256), mode -> threshold
    bins = np.clip((sad * 256).astype(int).ravel(), 0, 255)
    hist = np.bincount(bins, minlength=256)
    threshold = int(hist.argmax()) / 256.0
    if threshold > 0.15 or threshold <= 0.0:
        return None
    flat = sad <= threshold
    if not flat.any():
        return None
    by, bx = sad.shape
    block_means = plane[:by * 8, :bx * 8].reshape(by, 8, bx, 8) \
        .mean(axis=(1, 3))
    noise = _laplacian_noise(plane)
    intensities = block_means[flat]
    levels = noise[flat]
    lut = _fit_lut(intensities, levels)
    if lut is None:
        return None
    lut = np.clip(lut * (quality_coef * 1.4), 0.0, K_NOISE_LUT_MAX)
    if not (lut > 0).any():
        return None
    return lut.astype(np.float32)


def _fit_lut(intensities: np.ndarray, levels: np.ndarray,
             iters: int = 200) -> np.ndarray | None:
    """Asymmetric quadratic fit of the 8-point piecewise-linear LUT
    (LossFunction + OptimizeNoiseParameters, enc_noise.cc:156-226)."""
    n = K_NUM_NOISE_POINTS
    scale = n - 2                       # IndexAndFrac (noise.h:45-55)
    pos = np.clip(intensities * scale, 0.0, scale + 1 - 1e-6)
    idx = np.minimum(pos.astype(int), n - 2)
    frac = pos - idx
    w = np.full(n, float(levels.mean()))
    k_reg, k_asym = 0.005, 1.1
    npts = len(levels)
    lr = 0.5 / max(npts, 1)
    for _ in range(iters):
        val = w[idx] * (1 - frac) + w[idx + 1] * frac
        dist = val - levels
        asym = np.where(dist > 0, k_asym, 1.0)
        g = np.zeros(n)
        np.add.at(g, idx, asym * dist * (1 - frac))
        np.add.at(g, idx + 1, asym * dist * frac)
        dif = w[:-1] - w[1:]
        g[:-1] += k_reg * npts * dif
        g[1:] -= k_reg * npts * dif
        w = np.maximum(w - lr * g, 0.0)
    return w


def photon_noise_lut(iso: float, xsize: int, ysize: int) -> np.ndarray:
    """SimulatePhotonNoise (enc_photon_noise.cc:35-88): the strength LUT
    a 35mm sensor at the given ISO would produce."""
    from libjxl_torch.color.xyb import OPSIN_BIAS

    k_photons = 11260.0
    k_qe = 0.20
    k_prnu = 0.005
    k_read = 3.0
    k_area = 36000.0 * 24000
    bias = OPSIN_BIAS
    bias_cbrt = np.cbrt(bias)
    h18 = 10.0 / iso
    pixel_area = k_area / (xsize * ysize)
    e18 = k_qe * k_photons * h18 * pixel_area
    lut = np.zeros(K_NUM_NOISE_POINTS, np.float32)
    for i in range(K_NUM_NOISE_POINTS):
        y = 2.0 * i / (K_NUM_NOISE_POINTS - 2)
        linear = max(0.0, (y - bias_cbrt) ** 3 + bias)
        electrons = e18 * (linear / 0.18)
        noise = np.sqrt(k_read ** 2 + electrons + (k_prnu * electrons) ** 2)
        linear_noise = noise * (0.18 / e18)
        opsin_derivative = (1.0 / 3) / (np.cbrt(linear - bias) ** 2)
        opsin_noise = linear_noise * opsin_derivative
        lut[i] = np.clip(opsin_noise / (0.22 * np.sqrt(2.0) * 1.13),
                         0.0, K_NOISE_LUT_MAX)
    return lut
