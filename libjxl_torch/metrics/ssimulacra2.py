"""SSIMULACRA 2.1 perceptual metric (reference ``tools/ssimulacra2.cc``).

Structure (ssimulacra2.cc:1-23 design notes): positive-shifted XYB color,
corrected SSIM map (no double gamma term), "ringing" and "blurring"
edge-difference maps; all computed at 6 scales (downsampling happens in
linear RGB), with 1-norm and 4-norm per map per channel, combined by the
published 108-entry weight vector and the nonlinear score mapping.

Pixel math is vectorized numpy (the maps are elementwise + separable
blurs); the hot blur runs through jnp when available.
"""

from __future__ import annotations

import numpy as np

from libjxl_torch.color.xyb import linear_to_xyb, srgb_to_linear

_KC2 = 0.0009
_NUM_SCALES = 6

# ssimulacra2.cc:301-408 (metric definition constants, v2.1)
_WEIGHTS = np.array([
    0.0, 0.0007376606707406586, 0.0, 0.0, 0.0007793481682867309, 0.0,
    0.0, 0.0004371155730107379, 0.0, 1.1041726426657346,
    0.00066284834129271, 0.00015231632783718752, 0.0,
    0.0016406437456599754, 0.0, 1.8422455520539298, 11.441172603757666,
    0.0, 0.0007989109436015163, 0.000176816438078653, 0.0,
    1.8787594979546387, 10.94906990605142, 0.0, 0.0007289346991508072,
    0.9677937080626833, 0.0, 0.00014003424285435884, 0.9981766977854967,
    0.00031949755934435053, 0.0004550992113792063, 0.0, 0.0,
    0.0013648766163243398, 0.0, 0.0, 0.0, 0.0, 0.0, 7.466890328078848,
    0.0, 17.445833984131262, 0.0006235601634041466, 0.0, 0.0,
    6.683678146179332, 0.00037724407979611296, 1.027889937768264,
    225.20515300849274, 0.0, 0.0, 19.213238186143016,
    0.0011401524586618361, 0.001237755635509985, 176.39317598450694,
    0.0, 0.0, 24.43300999870476, 0.28520802612117757,
    0.0004485436923833408, 0.0, 0.0, 0.0, 34.77906344483772,
    44.835625328877896, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0008680556573291698, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0005313191874358747, 0.0, 0.00016533814161379112, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0004179171803251336, 0.0017290828234722833, 0.0,
    0.0020827005846636437, 0.0, 0.0, 8.826982764996862,
    23.19243343998926, 0.0, 95.1080498811086, 0.9863978034400682,
    0.9834382792465353, 0.0012286405048278493, 171.2667255897307,
    0.9807858872435379, 0.0, 0.0, 0.0, 0.0005130064588990679, 0.0,
    0.00010854057858411537])


def _gauss_kernel(sigma: float, radius: int) -> np.ndarray:
    i = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return k / k.sum()


_K15 = _gauss_kernel(1.5, 8)


def _blur(plane: np.ndarray) -> np.ndarray:
    """Separable sigma-1.5 gaussian (ssimulacra2.cc Blur / FastGaussian),
    with in-bounds renormalization at the borders."""
    r = len(_K15) // 2

    def conv(x, axis):
        xm = np.moveaxis(x, axis, -1)
        n = xm.shape[-1]
        padded = np.concatenate(
            [np.zeros(xm.shape[:-1] + (r,)), xm,
             np.zeros(xm.shape[:-1] + (r,))], axis=-1)
        out = np.zeros_like(xm)
        ones = np.concatenate([np.zeros(r), np.ones(n), np.zeros(r)])
        weight = np.zeros(n)
        for j, kv in enumerate(_K15):
            out += kv * padded[..., j:j + n]
            weight += kv * ones[j:j + n]
        out = out / weight
        return np.moveaxis(out, -1, axis)

    return conv(conv(plane, -1), -2)


def _downsample2(img: np.ndarray) -> np.ndarray:
    """2x2 box downsample with edge clamp (ssimulacra2.cc:57-81);
    img is (3, h, w)."""
    _, h, w = img.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    ph, pw = oh * 2, ow * 2
    p = img
    if ph != h:
        p = np.concatenate([p, p[:, -1:, :]], axis=1)
    if pw != w:
        p = np.concatenate([p, p[:, :, -1:]], axis=2)
    return p.reshape(3, oh, 2, ow, 2).mean(axis=(2, 4))


def _positive_xyb(linear: np.ndarray) -> np.ndarray:
    """Linear RGB (3,h,w) -> positive-shifted XYB
    (ssimulacra2.cc MakePositiveXYB:236-247)."""
    xyb = linear_to_xyb(linear)
    x, y, b = xyb[0], xyb[1], xyb[2]
    return np.stack([x * 14.0 + 0.42, y + 0.01, (b - y) + 0.55])


def _quartic(x):
    x = x * x
    return x * x


def _ssim_map(mu1, mu2, s11, s22, s12):
    """(ssimulacra2.cc SSIMMap:142-187): per-channel 1-norm and 4-norm of
    1 - SSIM' (gamma term dropped)."""
    num_m = 1.0 - (mu1 - mu2) ** 2
    num_s = 2.0 * (s12 - mu1 * mu2) + _KC2
    denom_s = (s11 - mu1 * mu1) + (s22 - mu2 * mu2) + _KC2
    d = np.maximum(1.0 - num_m * num_s / denom_s, 0.0)
    one = d.mean(axis=(1, 2))
    four = _quartic(d).mean(axis=(1, 2)) ** 0.25
    out = np.empty(6)
    out[0::2] = one
    out[1::2] = four
    return out


def _edge_diff_map(img1, mu1, img2, mu2):
    """(ssimulacra2.cc EdgeDiffMap:189-222): ringing (distorted edge where
    original smooth) and blurring (original edge where distorted smooth)."""
    d1 = (1.0 + np.abs(img2 - mu2)) / (1.0 + np.abs(img1 - mu1)) - 1.0
    artifact = np.maximum(d1, 0.0)
    detail_lost = np.maximum(-d1, 0.0)
    out = np.empty(12)
    for c in range(3):
        out[c * 4] = artifact[c].mean()
        out[c * 4 + 1] = _quartic(artifact[c]).mean() ** 0.25
        out[c * 4 + 2] = detail_lost[c].mean()
        out[c * 4 + 3] = _quartic(detail_lost[c]).mean() ** 0.25
    return out


def ssimulacra2(orig: np.ndarray, distorted: np.ndarray,
                bg: float = 0.5) -> float:
    """SSIMULACRA 2.1 score (100 = identical; <0 possible for very bad).

    orig/distorted: (h, w, 3|4) uint8/uint16 or float sRGB in [0,1].
    Alpha (4th channel) is blended over a gray background first
    (ssimulacra2.cc:474-477)."""
    imgs = []
    for im in (orig, distorted):
        im = np.asarray(im)
        if im.dtype == np.uint8:
            im = im.astype(np.float64) / 255.0
        elif im.dtype == np.uint16:
            im = im.astype(np.float64) / 65535.0
        else:
            im = im.astype(np.float64)
        if im.ndim == 2:
            im = im[:, :, None]
        if im.shape[2] >= 4:
            a = im[:, :, 3:4]
            im = im[:, :, :3] * a + (1.0 - a) * bg
        elif im.shape[2] == 1:
            im = np.repeat(im, 3, axis=2)
        else:
            im = im[:, :, :3]
        imgs.append(srgb_to_linear(np.moveaxis(im, -1, 0)))
    lin1, lin2 = imgs
    if lin1.shape != lin2.shape:
        raise ValueError("image sizes must match")

    subscores = []   # per scale: (ssim6, edgediff12)
    for scale in range(_NUM_SCALES):
        if lin1.shape[1] < 8 or lin1.shape[2] < 8:
            break
        if scale:
            lin1 = _downsample2(lin1)
            lin2 = _downsample2(lin2)
            if lin1.shape[1] < 8 or lin1.shape[2] < 8:
                break
        img1 = _positive_xyb(lin1)
        img2 = _positive_xyb(lin2)
        s11 = _blur(img1 * img1)
        s22 = _blur(img2 * img2)
        s12 = _blur(img1 * img2)
        mu1 = _blur(img1)
        mu2 = _blur(img2)
        subscores.append((_ssim_map(mu1, mu2, s11, s22, s12),
                          _edge_diff_map(img1, mu1, img2, mu2)))

    ssim = 0.0
    i = 0
    for c in range(3):
        for (avg_ssim, avg_edge) in subscores:
            for n in range(2):
                ssim += _WEIGHTS[i] * abs(avg_ssim[c * 2 + n]); i += 1
                ssim += _WEIGHTS[i] * abs(avg_edge[c * 4 + n]); i += 1
                ssim += _WEIGHTS[i] * abs(avg_edge[c * 4 + n + 2]); i += 1

    ssim *= 0.9562382616834844
    ssim = (2.326765642916932 * ssim - 0.020884521182843837 * ssim * ssim +
            6.248496625763138e-05 * ssim ** 3)
    if ssim > 0:
        return 100.0 - 10.0 * ssim ** 0.6276336467831387
    return 100.0
