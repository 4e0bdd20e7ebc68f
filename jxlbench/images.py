"""Seeded photo-like test images: a dead-leaves model made on the device.

Occluding disks with radii drawn from a power law (p(r) ~ r^-alpha
between ``r_min`` and ``r_max``), each with its own colour and a linear
shading across it, then an optical blur, Gaussian sensor noise and
8-bit quantization. This is the standard synthetic model of natural-image
statistics (Matheron's dead leaves; Lee, Mumford & Huang 2001, "Occlusion
models for natural images"; the dead-leaves chart of ISO 19567-2). Every
parameter comes from a traffic file, so a mix changes the content by data.

The same (seed, index, shape, parameters) gives the same image on one
device type; the work is a few large tensor operations, no loop over
shapes on the host.
"""

from __future__ import annotations

import math

import torch

DEFAULTS = dict(alpha=3.0, r_min=2.0, r_max_frac=0.25, coverage=5.0,
                luma_lo=0.04, luma_hi=0.96, chroma_sigma=0.08,
                shade=0.12, blur_sigma=1.0, noise_sigma=2.0)
_PAIRS_PER_PASS = 1 << 25


def image_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for image ``index`` of run ``seed``."""
    return (int(seed) * 1_000_003 + 7919 * int(index) + 1) % (1 << 63)


def _radii(n: int, p: dict, r_max: float, gen, device) -> torch.Tensor:
    a = p["alpha"] - 1.0      # inverse CDF of r^-alpha on [r_min, r_max]
    lo, hi = p["r_min"] ** -a, r_max ** -a
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    return (lo - u * (lo - hi)) ** (-1.0 / a)


def _mean_area(p: dict, r_max: float) -> float:
    a, rmin = p["alpha"], p["r_min"]
    if abs(a - 3.0) < 1e-9:
        er2 = 2 * math.log(r_max / rmin) / (rmin ** -2 - r_max ** -2)
    else:
        c = (a - 1) / (rmin ** (1 - a) - r_max ** (1 - a))
        er2 = c * (r_max ** (3 - a) - rmin ** (3 - a)) / (3 - a)
    return math.pi * er2


def _front_disk(h, w, cy, cx, r, device) -> torch.Tensor:
    """Index of the last disk covering each pixel (-1 where none does):
    every (disk, bounding-box pixel) pair is made in a few large passes
    and reduced with ``scatter_reduce(amax)``."""
    y0 = (cy - r).floor().clamp(0, h - 1).long()
    y1 = (cy + r).ceil().clamp(0, h - 1).long()
    x0 = (cx - r).floor().clamp(0, w - 1).long()
    x1 = (cx + r).ceil().clamp(0, w - 1).long()
    bh, bw = y1 - y0 + 1, x1 - x0 + 1
    area = bh * bw
    top = torch.full((h * w,), -1, dtype=torch.long, device=device)
    cum = torch.cumsum(area, 0)
    start = 0
    n = r.shape[0]
    while start < n:
        base = int(cum[start - 1]) if start else 0
        stop = int(torch.searchsorted(cum, base + _PAIRS_PER_PASS,
                                      right=True))
        stop = max(stop, start + 1)
        ids = torch.arange(start, stop, device=device)
        a = area[start:stop]
        k = torch.repeat_interleave(ids, a)
        off = torch.cumsum(a, 0) - a
        local = torch.arange(k.shape[0], device=device) - \
            torch.repeat_interleave(off, a)
        py = y0[k] + local // bw[k]
        px = x0[k] + local % bw[k]
        inside = ((py.double() + 0.5 - cy[k]) ** 2 +
                  (px.double() + 0.5 - cx[k]) ** 2) <= r[k] ** 2
        top.scatter_reduce_(0, (py * w + px)[inside], k[inside], "amax")
        start = stop
    return top.view(h, w)


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of (3, H, W) as sums of shifted slices (an exact,
    deterministic order of operations on every device)."""
    if sigma <= 0:
        return x
    rad = max(1, int(math.ceil(3 * sigma)))
    taps = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-rad, rad + 1)]
    s = sum(taps)
    for dim in (1, 2):
        n = x.shape[dim]
        idx = (torch.arange(-rad, n + rad, device=x.device)
               .clamp(0, n - 1))
        p = x.index_select(dim, idx)
        acc = torch.zeros_like(x)
        for i, t in enumerate(taps):
            acc += (t / s) * p.narrow(dim, i, n)
        x = acc
    return x


def dead_leaves(seed: int, index: int, h: int, w: int, params: dict | None
                = None, device="cpu") -> torch.Tensor:
    """One (h, w, 3) uint8 image on ``device``."""
    p = dict(DEFAULTS, **(params or {}))
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(image_seed(seed, index))
    r_max = p["r_max_frac"] * max(h, w)
    n = max(16, int(p["coverage"] * h * w / _mean_area(p, r_max)))
    f64 = dict(generator=gen, device=device, dtype=torch.float64)
    r = _radii(n, p, r_max, gen, device)
    cy = torch.rand(n, **f64) * (h + 2 * r) - r
    cx = torch.rand(n, **f64) * (w + 2 * r) - r
    luma = p["luma_lo"] + (p["luma_hi"] - p["luma_lo"]) * torch.rand(n, **f64)
    col = luma[:, None] + p["chroma_sigma"] * torch.randn(n, 3, **f64)
    shade = p["shade"] * torch.randn(n, 2, **f64)
    top = _front_disk(h, w, cy, cx, r, device)
    bg = top < 0
    k = top.clamp(min=0)
    yy = torch.arange(h, device=device, dtype=torch.float64)[:, None] + 0.5
    xx = torch.arange(w, device=device, dtype=torch.float64)[None, :] + 0.5
    ramp = (shade[k, 0] * (yy - cy[k]) + shade[k, 1] * (xx - cx[k])) / r[k]
    img = col[k].permute(2, 0, 1) + ramp[None]
    img = torch.where(bg[None], torch.full_like(img, 0.5), img)
    img = _blur(img.clamp(0, 1).float(), p["blur_sigma"])
    noise = torch.randn(img.shape, generator=gen, device=device,
                        dtype=torch.float32)
    img = img * 255.0 + p["noise_sigma"] * noise
    return img.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0) \
        .contiguous()
