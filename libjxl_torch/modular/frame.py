"""Modular frame decoding: stream layout + global/group assembly
(reference ``lib/jxl/dec_modular.cc``, ``lib/jxl/dec_frame.cc:269-560``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libjxl_torch.core.fields import FieldReader, FormatError
from libjxl_torch.core.frame_header import (
    ColorTransform, FrameEncoding, FrameFlags, FrameHeader,
)
from libjxl_torch.core.geometry import FrameDimensions, cdiv
from libjxl_torch.entropy.ans import ANSSymbolReader, decode_histograms
from libjxl_torch.modular.codec import (
    GroupHeader, ModularOptions, decode_modular_channel, modular_decode,
)
from libjxl_torch.modular.image import Channel, ModularImage
from libjxl_torch.modular.tree import decode_tree
from libjxl_torch.utils.bits import BitReader

K_NUM_QUANT_TABLES = 17  # quant_weights.h kNumQuantTables


def stream_id_global() -> int:
    return 0


def stream_id_vardct_dc(fd: FrameDimensions, g: int) -> int:
    return 1 + g


def stream_id_modular_dc(fd: FrameDimensions, g: int) -> int:
    return 1 + fd.num_dc_groups + g


def stream_id_ac_metadata(fd: FrameDimensions, g: int) -> int:
    return 1 + 2 * fd.num_dc_groups + g


def stream_id_quant_table(fd: FrameDimensions, i: int) -> int:
    return 1 + 3 * fd.num_dc_groups + i


def stream_id_modular_ac(fd: FrameDimensions, g: int, pass_id: int) -> int:
    return (1 + 3 * fd.num_dc_groups + K_NUM_QUANT_TABLES +
            fd.num_groups * pass_id + g)


def get_downsampling_bracket(passes, pass_idx: int):
    """(frame_header.h:268-284)."""
    max_shift = 2
    min_shift = 3
    i = 0
    while True:
        for j in range(passes.num_downsample):
            if i == passes.last_pass[j]:
                min_shift = {8: 3, 4: 2, 2: 1, 1: 0}[passes.downsample[j]]
        if i == passes.num_passes - 1:
            min_shift = 0
        if i == pass_idx:
            return min_shift, max_shift
        max_shift = min_shift - 1
        i += 1


class ModularFrameDecoder:
    """(dec_modular.h ModularFrameDecoder)."""

    def __init__(self, frame_header: FrameHeader, metadata,
                 dims: FrameDimensions):
        self.fh = frame_header
        self.metadata = metadata
        self.dims = dims
        self.tree = None
        self.code = None
        self.global_header = GroupHeader()
        self.full_image: ModularImage | None = None
        self.do_color = frame_header.encoding == FrameEncoding.MODULAR

    def decode_global_info(self, r: BitReader) -> None:
        """(dec_modular.cc:209-321)."""
        fh, m, fd = self.fh, self.metadata, self.dims
        is_gray = m.color_encoding.channels == 1
        nb_chans = 3
        if is_gray and fh.color_transform == ColorTransform.NONE:
            nb_chans = 1
        nb_extra = m.num_extra_channels
        has_tree = r.read(1) == 1
        if has_tree:
            self.tree = decode_tree(r)
            self.code = decode_histograms(r, (len(self.tree) + 1) // 2)
        if not self.do_color:
            nb_chans = 0
        gi = ModularImage.create(fd.xsize, fd.ysize,
                                 m.bit_depth.bits_per_sample,
                                 nb_chans + nb_extra)
        if fh.color_transform == ColorTransform.YCBCR:
            for c in range(nb_chans):
                hs = fh.chroma_subsampling.hshift(c)
                vs = fh.chroma_subsampling.vshift(c)
                gi.channel[c] = Channel.create(
                    cdiv(fd.xsize, 1 << hs), cdiv(fd.ysize, 1 << vs), hs, vs)
        for ec in range(nb_extra):
            c = nb_chans + ec
            ecups = fh.extra_channel_upsampling[ec] if \
                fh.extra_channel_upsampling else 1
            up = fh.upsampling
            xs = cdiv(fd.xsize * up, ecups)
            ys = cdiv(fd.ysize * up, ecups)
            shift = (ecups.bit_length() - 1) - (up.bit_length() - 1)
            gi.channel[c] = Channel.create(xs, ys, shift, shift)
        options = ModularOptions(max_chan_size=fd.group_dim,
                                 group_dim=fd.group_dim)
        self.global_header = modular_decode(
            r, gi, group_id=0, options=options,
            global_tree=self.tree, global_code=self.code,
            undo_transforms=False)
        self.full_image = gi

    def decode_group(self, r: BitReader, rect, min_shift: int,
                     max_shift: int, stream_id: int) -> None:
        """(dec_modular.cc:331-...). rect in pixels (x0, y0, w, h)."""
        gi = ModularImage(0, 0, self.full_image.bitdepth)
        fi = self.full_image
        x0, y0, rw, rh = rect
        # First non-meta channel bigger than group_dim starts group coverage.
        c = fi.nb_meta_channels
        while c < len(fi.channel):
            fc = fi.channel[c]
            if fc.w > self.dims.group_dim or fc.h > self.dims.group_dim:
                break
            c += 1
        beginc = c
        selected = []
        for c in range(beginc, len(fi.channel)):
            fc = fi.channel[c]
            shift = min(fc.hshift, fc.vshift)
            if shift > max_shift or shift < min_shift:
                continue
            cx0 = x0 >> fc.hshift
            cy0 = y0 >> fc.vshift
            cw = min(rw >> fc.hshift, fc.w - cx0)
            ch_ = min(rh >> fc.vshift, fc.h - cy0)
            if cw <= 0 or ch_ <= 0:
                continue
            gc = Channel.create(cw, ch_, fc.hshift, fc.vshift)
            gi.channel.append(gc)
            selected.append((c, cx0, cy0, cw, ch_))
        if not gi.channel:
            return
        options = ModularOptions()
        modular_decode(r, gi, group_id=stream_id, options=options,
                       global_tree=self.tree, global_code=self.code,
                       global_header=self.global_header,
                       undo_transforms=True)
        for gidx, (c, cx0, cy0, cw, ch_) in enumerate(selected):
            self.full_image.channel[c].plane[cy0:cy0 + ch_,
                                             cx0:cx0 + cw] = \
                gi.channel[gidx].plane
    def finalize(self) -> ModularImage:
        """Undo global transforms (dec_modular.cc FinalizeDecoding)."""
        fi = self.full_image
        for t in reversed(fi_transforms(fi, self.global_header)):
            t.inverse(fi, self.global_header.wp_header)
        return fi


def fi_transforms(fi, global_header: GroupHeader):
    return global_header.transforms
