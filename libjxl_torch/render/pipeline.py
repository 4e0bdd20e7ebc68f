"""Render pipeline stage graph (reference
``render_pipeline/render_pipeline.h`` / ``stage_*.cc``).

The reference models post-reconstruction rendering as an ordered list
of stages, each declaring what it does to the image; the decoder builds
the list from the frame header and runs it. This is the same seam: a
``Stage`` is a named object with ``process(img, ctx)``;
``build_render_pipeline`` assembles the frame's stages in the
dec_cache.cc:142-217 order (restoration filters -> patches -> splines
-> upsampling -> noise), and callers can inspect, wrap, or extend the
list.

ctx: dict with dec (frame decoder state), fh, meta, fd, lf.
"""

from __future__ import annotations

import numpy as np

from libjxl_torch.core.frame_header import FrameFlags


class Stage:
    """One render stage; subclasses set ``name`` and ``process``."""

    name = "stage"

    def process(self, img: np.ndarray, ctx: dict) -> np.ndarray:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<stage {self.name}>"


class GaborishStage(Stage):
    """stage_gaborish.cc: 3x3 smoothing undoing encoder sharpening."""

    name = "gaborish"

    def process(self, img, ctx):
        from libjxl_torch.render.filters import gaborish
        return gaborish(img, ctx["lf"])


class EpfStage(Stage):
    """stage_epf.cc: edge-preserving filter passes."""

    name = "epf"

    def process(self, img, ctx):
        from libjxl_torch.render.filters import (
            compute_sigma, epf_step0, epf_step1, epf_step2,
        )
        dec, lf = ctx["dec"], ctx["lf"]
        inv_sigma = compute_sigma(lf, dec.acs_raw, dec.acs_anchor,
                                  dec.raw_quant, dec.epf_sharpness,
                                  dec.quantizer.scale)
        if lf.epf_iters >= 3:
            img = epf_step0(img, inv_sigma, lf)
        img = epf_step1(img, inv_sigma, lf)
        if lf.epf_iters >= 2:
            img = epf_step2(img, inv_sigma, lf)
        return img


class PatchesStage(Stage):
    """stage_patches.cc: draw the patch dictionary."""

    name = "patches"

    def process(self, img, ctx):
        from libjxl_torch.render.patches import apply_patches
        dec, meta = ctx["dec"], ctx["meta"]
        nec = meta.m.num_extra_channels
        if nec:
            full = np.concatenate(
                [img, np.zeros((nec,) + img.shape[1:], img.dtype)])
        else:
            full = img
        full = apply_patches(full, dec.patches, dec.reference_frames,
                             meta.m.extra_channel_info)
        return full[:3]


class SplinesStage(Stage):
    """stage_splines.cc: draw splines with the frame's correlations."""

    name = "splines"

    def process(self, img, ctx):
        from libjxl_torch.render.splines import render_splines
        dec = ctx["dec"]
        return render_splines(img, dec.splines, dec.cmap.ytox_ratio(0),
                              dec.cmap.ytob_ratio(0))


class UpsampleStage(Stage):
    """stage_upsampling.cc: signaled 2x/4x/8x upsampling."""

    name = "upsample"

    def process(self, img, ctx):
        from libjxl_torch.render.upsample import upsample_image
        fh, meta = ctx["fh"], ctx["meta"]
        shift = fh.upsampling.bit_length() - 1
        return upsample_image(img, shift, meta.transform_data)


class NoiseStage(Stage):
    """stage_noise.cc: synthesize the signaled grain."""

    name = "noise"

    def process(self, img, ctx):
        from libjxl_torch.render.noise import add_noise
        dec, fh, fd = ctx["dec"], ctx["fh"], ctx["fd"]
        h = min(img.shape[1], fd.ysize * fh.upsampling)
        w = min(img.shape[2], fd.xsize * fh.upsampling)
        return add_noise(img[:, :h, :w], dec.noise_lut, fh.group_dim,
                         base_correlation_x=dec.cmap.base_correlation_x,
                         base_correlation_b=dec.cmap.base_correlation_b)


def build_render_pipeline(fh, meta, dec) -> list:
    """Assemble the frame's stage list in dec_cache.cc order."""
    lf = fh.loop_filter
    stages: list = []
    if lf.gab:
        stages.append(GaborishStage())
    if lf.epf_iters > 0:
        stages.append(EpfStage())
    if fh.flags & FrameFlags.PATCHES:
        stages.append(PatchesStage())
    if fh.flags & FrameFlags.SPLINES:
        stages.append(SplinesStage())
    if fh.upsampling > 1:
        stages.append(UpsampleStage())
    if fh.flags & FrameFlags.NOISE:
        stages.append(NoiseStage())
    return stages


def run_render_pipeline(stages, img, ctx: dict):
    """Run the stages in order (RenderPipeline::Run)."""
    for st in stages:
        img = st.process(img, ctx)
    return img


def apply_spot_colors(color: np.ndarray, ec_planes, ec_infos
                      ) -> np.ndarray:
    """stage_spot.cc SpotColorStage: for each SPOT_COLOR extra channel,
    mix = scale * spot_plane; rgb = mix * spot_rgb + (1 - mix) * rgb.
    ``color``: (3, h, w) output-range floats; ``ec_planes``: list of
    (h, w) float planes in [0, 1]."""
    from libjxl_torch.core.headers import ExtraChannelType
    for plane, eci in zip(ec_planes, ec_infos):
        if eci.type != ExtraChannelType.SPOT_COLOR:
            continue
        r, g, b, scale = eci.spot_color
        mix = scale * plane[None, :color.shape[1], :color.shape[2]]
        spot = np.array([r, g, b], color.dtype).reshape(3, 1, 1)
        color = mix * spot + (1.0 - mix) * color
    return color
