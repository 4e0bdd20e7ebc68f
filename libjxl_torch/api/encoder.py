"""Lossless encode entry points of the port (``libjxl_tpu/api/encoder.py``,
the device paths).

The serving path is ``encode_lossless_many(imgs, EncodeOptions(
use_device=True, entropy="prefix-device"))``: same-shape images are
stacked along the group axis in ~4 MP sub-batches; sub-batch 0's
histogram probe gives the prefix code of its whole shape-group, and each
sub-batch is then residual-coded and packed on the device in one pass
(``lossless_pack_fused``). The host builds the code, fetches the dense
words and splices them into sections with the native host library.

The code choice follows the reference rule for rule, so the streams are
byte-identical to ``libjxl_tpu``'s:

* a shape-group whose probe says ``resid_better`` codes every sub-batch
  two-pass, each with the code of its own histogram;
* a sub-batch whose dense words exceed the reference's fixed capacity
  estimate (``_fused_capacity``) is redone two-pass with its own code.

``use_device=False`` delegates to ``libjxl_tpu``'s host encoder.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from itertools import groupby

import numpy as np
import torch

from libjxl_tpu.api import encoder as _ref
from libjxl_tpu.api.encoder import EncodeOptions, _prefix_code_state
from libjxl_tpu.core.fields import FieldWriter
from libjxl_tpu.core.frame_header import (
    ColorTransform, FrameEncoding, FrameHeader,
)
from libjxl_tpu.core.geometry import FrameDimensions
from libjxl_tpu.core.headers import (
    BitDepth, ColorEncoding, CustomTransformData, ExtraChannelInfo,
    ImageMetadata, SizeHeader, write_bundle, write_signature,
)
from libjxl_tpu.core.toc import write_toc
from libjxl_tpu.entropy.ans import write_entropy_codes
from libjxl_tpu.modular.codec import GroupHeader
from libjxl_tpu.modular.predict import PREDICTOR_GRADIENT
from libjxl_tpu.modular.transforms import Transform, TransformId
from libjxl_tpu.modular.tree import TreeNode, write_tree
from libjxl_tpu.utils import native
from libjxl_tpu.utils.bits import BitWriter
from libjxl_torch.config import resolve_device
from libjxl_torch.models.lossless import (
    PACK_NW, PACK_T, chunk_pack_device, encode_image_device,
    encode_image_device_collect, encode_image_device_dispatch,
    frame_groups_host, lossless_hist_device, lossless_pack_fused,
    lossless_tokens_device, prefix_state_to_device, upload_groups,
)


def _hwc(im: np.ndarray) -> np.ndarray:
    return im[:, :, None] if im.ndim == 2 else im


def encode_lossless(pixels: np.ndarray, options: EncodeOptions | None = None,
                    device=None) -> bytes:
    """Encode an (h, w[, c]) uint8/uint16 array to a JXL codestream."""
    options = options or EncodeOptions()
    if isinstance(pixels, np.ndarray) and pixels.dtype.byteorder == ">":
        pixels = pixels.astype(pixels.dtype.newbyteorder("="))
    if not options.use_device:
        return _ref.encode_lossless(pixels, options)
    if options.entropy == "prefix-device":
        return encode_lossless_device_prefix(pixels, options, device)
    return encode_lossless_device(pixels, options, device)


def encode_lossless_device(pixels: np.ndarray,
                           options: EncodeOptions | None = None,
                           device=None) -> bytes:
    """Device residuals + histogram, host rANS emission (entropy="ans")."""
    options = options or EncodeOptions()
    pixels = _hwc(pixels)
    collected = encode_image_device(
        pixels, group_dim=128 << options.group_size_shift,
        use_rct=options.use_rct and pixels.shape[2] >= 3, device=device)
    return _assemble_lossless_device(pixels, options, collected)


def encode_lossless_many(images, options: EncodeOptions | None = None,
                         device=None) -> list:
    """Batch encode (BASELINE config 5, the serving mode); one codestream
    per image, in input order."""
    options = options or EncodeOptions()
    if not options.use_device:
        return [_ref.encode_lossless(im, options) for im in images]
    device = resolve_device(device)
    imgs = [_hwc(im) for im in images]
    if options.entropy != "prefix-device":
        group_dim = 128 << options.group_size_shift
        handles = [encode_image_device_dispatch(
            im, group_dim, options.use_rct and im.shape[2] >= 3, device)
            for im in imgs]
        return [_assemble_lossless_device(
            im, options, encode_image_device_collect(hd))
            for im, hd in zip(imgs, handles)]

    def key(i):
        return imgs[i].shape, str(imgs[i].dtype)

    shape_groups = []
    for _, grp in groupby(sorted(range(len(imgs)), key=key), key=key):
        idxs = list(grp)
        px = imgs[idxs[0]].shape[0] * imgs[idxs[0]].shape[1]
        per = max(1, (4 << 20) // max(px, 1))
        shape_groups.append([idxs[j:j + per]
                             for j in range(0, len(idxs), per)])
    out: list = [None] * len(imgs)
    native_lib()
    # host splicing of sub-batch k overlaps the device work of k+1
    with ThreadPoolExecutor(2) as pool:
        pending = []
        for batches in shape_groups:
            part0 = [imgs[i] for i in batches[0]]
            staged0 = _prefix_upload(part0, options, device)
            groups0, dims = staged0
            payload = lossless_hist_device(
                groups0, dims["h"], dims["w"], gx=dims["gx"],
                per_image=dims["per_image"] if len(part0) > 1 else 0)
            cst = _prefix_code_state(payload.cpu().numpy(),
                                     tuple(groups0.shape), part0[0].dtype)
            if cst["resid_better"]:
                for k, part in enumerate(batches):
                    st = _prefix_pass2(_prefix_pass1(
                        [imgs[i] for i in part], options, device,
                        staged0 if k == 0 else None))
                    pending.append((part, pool.submit(_prefix_assemble, st)))
                continue
            lut = prefix_state_to_device(cst, device)
            for k, part in enumerate(batches):
                st = _prefix_fused([imgs[i] for i in part], options, cst,
                                   lut, staged0 if k == 0 else None, device)
                pending.append((part, pool.submit(_prefix_assemble, st)))
            del staged0, groups0
        for idxs, fut in pending:
            for i, stream in zip(idxs, fut.result()):
                out[i] = stream
    return out


def encode_lossless_device_prefix(pixels: np.ndarray,
                                  options: EncodeOptions | None = None,
                                  device=None) -> bytes:
    """Two-pass encode of one image: residuals + histogram on the device,
    the prefix code on the host, then the words packed on the device."""
    st = _prefix_pass1([pixels], options or EncodeOptions(), device)
    return _prefix_assemble(_prefix_pass2(st))[0]


def _prefix_upload(batch_imgs: list, options: EncodeOptions, device):
    """Stage a same-shape image batch on the device as one stacked group
    tensor (narrow dtype); returns (tensor, dims dict)."""
    imgs = [_hwc(im) for im in batch_imgs]
    h, w, nch = imgs[0].shape
    group_dim = 128 << options.group_size_shift
    devs = [upload_groups(frame_groups_host(im, group_dim)[0], device)
            for im in imgs]
    groups = devs[0] if len(devs) == 1 else torch.cat(devs)
    return groups, dict(h=h, w=w, nch=nch, gx=-(-w // group_dim),
                        per_image=devs[0].shape[0])


def _batch_state(imgs: list, options: EncodeOptions, dims: dict,
                 n_groups_total: int) -> dict:
    return dict(options=options, h=dims["h"], w=dims["w"], nch=dims["nch"],
                n_images=len(imgs),
                bits=8 if imgs[0].dtype == np.uint8 else 16,
                ng=dims["per_image"], n_groups_total=n_groups_total)


def _prefix_pass1(batch_imgs: list, options: EncodeOptions, device=None,
                  staged=None) -> dict:
    """Pass 1 (residuals + histogram) for a batch of same-shape images
    stacked along the group axis; ``staged`` is the batch's
    ``_prefix_upload`` result when it is on the device already."""
    imgs = [_hwc(im) for im in batch_imgs]
    groups, dims = staged or _prefix_upload(imgs, options, device)
    wide, valid, payload = lossless_tokens_device(
        groups, dims["h"], dims["w"], gx=dims["gx"],
        per_image=dims["per_image"] if len(imgs) > 1 else 0)
    st = _batch_state(imgs, options, dims, groups.shape[0])
    st.update(wide=wide, valid=valid, payload=payload,
              groups_shape=tuple(groups.shape), dtype=imgs[0].dtype)
    return st


def _prefix_pass2(st: dict) -> dict:
    """Build the prefix code from pass 1's own histogram and pack the
    words on the device with it. (The reference may instead fetch the
    residuals and pack on the host; the bitstream is the same.)"""
    cst = _prefix_code_state(st["payload"].cpu().numpy(),
                             st["groups_shape"], st["dtype"])
    lut = prefix_state_to_device(cst, st["wide"].device)
    words, chunk_bits = chunk_pack_device(st["wide"], st["valid"], lut)
    out = {k: v for k, v in st.items()
           if k not in ("wide", "valid", "payload")}
    out.update(codes=cst["codes"], words_dev=words,
               chunk_bits_dev=chunk_bits)
    return out


def _fused_capacity(n_tokens: int, n_chunks: int,
                    words_per_token: float) -> int:
    """The reference's dense-word capacity for a fused sub-batch
    (libjxl_tpu/api/encoder.py:_prefix_fused): 1.3x the probe's density
    plus row slack, in 512Ki-word buckets. A sub-batch whose words exceed
    it is re-coded two-pass there, so it is here too."""
    worst = n_chunks * PACK_NW
    est = int(n_tokens * words_per_token * 1.3) + n_chunks * 8 + 8192
    cap_words = min(worst, max(est, 1 << 16))
    return ((cap_words + (1 << 19) - 1) >> 19) << 19


def _prefix_fused(batch_imgs: list, options: EncodeOptions, cst: dict,
                  lut, staged=None, device=None) -> dict:
    """One fused pass for a serving sub-batch with the shape-group's code
    ``cst`` (``lut``: its pack table on the device); ``staged`` is the
    sub-batch's ``_prefix_upload`` result when it is on the device
    already. Returns an assemble-ready state, or the two-pass state when
    the words overflow the reference's capacity estimate."""
    imgs = [_hwc(im) for im in batch_imgs]
    groups, dims = staged or _prefix_upload(imgs, options, device)
    n_tokens = groups.numel()
    cap_words = _fused_capacity(n_tokens, n_tokens // PACK_T,
                                cst["words_per_token"])
    words, chunk_bits = lossless_pack_fused(
        groups, dims["h"], dims["w"], lut, gx=dims["gx"],
        per_image=dims["per_image"] if len(imgs) > 1 else 0)
    if words.shape[0] > cap_words:
        del words, chunk_bits
        return _prefix_pass2(_prefix_pass1(imgs, options, groups.device,
                                           (groups, dims)))
    st = _batch_state(imgs, options, dims, groups.shape[0])
    st.update(codes=cst["codes"], words_dev=words, chunk_bits_dev=chunk_bits)
    return st


def _frame_headers(h: int, w: int, bits: int, nch: int,
                   options: EncodeOptions):
    """Signature, size, metadata and frame header of a lossless modular
    stream; returns (BitWriter, FrameDimensions).

    2 and 4 channels are gray or RGB plus alpha, declared as an extra
    channel as the host encoder does (``_modular_headers``). The
    reference's device paths declare no extra channel, so their 2- and
    4-channel streams do not decode to their input; 1- and 3-channel
    headers are the reference's bit for bit."""
    bw = BitWriter()
    write_signature(bw)
    size = SizeHeader()
    size.set(w, h)
    write_bundle(bw, size)
    depth = BitDepth(bits_per_sample=bits)
    meta = ImageMetadata(
        xyb_encoded=False,
        bit_depth=depth,
        color_encoding=ColorEncoding.srgb(gray=nch <= 2),
        modular_16_bit_buffer_sufficient=bits <= 12,
        extra_channel_info=([ExtraChannelInfo(bit_depth=depth)]
                            if nch in (2, 4) else []),
    )
    write_bundle(bw, meta)
    ctd = CustomTransformData()
    ctd.xyb_encoded = False
    write_bundle(bw, ctd)
    bw.zero_pad_to_byte()
    fh = FrameHeader(encoding=FrameEncoding.MODULAR,
                     color_transform=ColorTransform.NONE,
                     group_size_shift=options.group_size_shift)
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 0
    meta.nonserialized_xsize = w
    meta.nonserialized_ysize = h
    fh.visit(FieldWriter(bw), meta)
    return bw, FrameDimensions(w, h, fh.group_dim)


def _global_bits(codes, use_rct: bool) -> tuple[bytes, int]:
    """DC-global section bits before the group data: tree + codes +
    the global group header (with the RCT when used)."""
    sw = BitWriter()
    sw.write(1, 1)
    sw.write(1, 1)
    write_tree(sw, [TreeNode(-1, 0, 0, 0, PREDICTOR_GRADIENT, 0, 1)])
    write_entropy_codes(sw, codes)
    transforms = ([Transform(id=TransformId.RCT, begin_c=0, rct_type=6)]
                  if use_rct else [])
    GroupHeader(use_global_tree=True, transforms=transforms).write(sw)
    return sw.to_bytes(), sw.bits_written


def _stream(header_bytes: bytes, header_bits: int, fd: FrameDimensions,
            dc_section: bytes, group_sections: list) -> bytes:
    """TOC + sections after the frame header's last bit. With one group
    the DC-global section carries the group data itself."""
    if fd.num_groups == 1:
        sections = [dc_section]
    else:
        sections = ([dc_section] + [b""] * fd.num_dc_groups + [b""]
                    + list(group_sections))
    tw = BitWriter()
    tw.append_packed(header_bytes, header_bits)
    write_toc(tw, [len(s) for s in sections])
    return tw.to_bytes() + b"".join(sections)


def native_lib():
    """The native host library, built on first call. Call it before
    handing work to threads: a thread that asks while another builds is
    told the library is missing."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("the native host library (native/jxl_host.cc) "
                           "is needed to splice device-packed words")
    return lib


def _prefix_assemble(st: dict) -> list:
    """Host half: fetch the dense words and chunk bit counts, splice the
    per-group sections natively, emit headers and TOC. Returns one
    codestream per image of the batch."""
    native_lib()
    options = st["options"]
    h, w, nch = st["h"], st["w"], st["nch"]
    words = st["words_dev"].cpu().numpy().view(np.uint32)
    chunk_bits = st["chunk_bits_dev"].cpu().numpy().astype(np.uint16)
    # chunks start PACK_ROW-word aligned in the dense stream; the splice
    # reads exactly chunk_bits bits of each, so the slack never lands
    nw = ((chunk_bits.astype(np.int64) + 255) >> 8) << 3
    word_start = np.concatenate([[0], np.cumsum(nw)]).astype(np.int64)
    bw, fd = _frame_headers(h, w, st["bits"], nch, options)
    header_bytes, header_bits = bw.to_bytes(), bw.bits_written
    gd = fd.group_dim
    chunks_per_group = nch * gd * gd // PACK_T
    chunks_per_image = st["ng"] * chunks_per_group
    dc_bytes, dc_bits = _global_bits(st["codes"],
                                     options.use_rct and nch >= 3)
    ghw = BitWriter()
    GroupHeader(use_global_tree=True).write(ghw)
    gh_bytes, gh_bits = ghw.to_bytes(), ghw.bits_written

    def section(prefix_bytes: bytes, prefix_nbits: int, i: int, g: int):
        c0 = i * chunks_per_image + g * chunks_per_group
        return native.splice_section(prefix_bytes, prefix_nbits, words,
                                     word_start, chunk_bits, c0,
                                     c0 + chunks_per_group)

    if fd.num_groups == 1:
        return [_stream(header_bytes, header_bits, fd,
                        section(dc_bytes, dc_bits, i, 0), [])
                for i in range(st["n_images"])]
    sw = BitWriter()
    sw.append_packed(dc_bytes, dc_bits)
    sw.zero_pad_to_byte()
    dc_section = sw.to_bytes()
    jobs = [(i, g) for i in range(st["n_images"])
            for g in range(fd.num_groups)]
    # the native splice releases the GIL: thread across groups
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        flat = list(ex.map(lambda ig: section(gh_bytes, gh_bits, *ig),
                           jobs))
    n = fd.num_groups
    return [_stream(header_bytes, header_bits, fd, dc_section,
                    flat[i * n:(i + 1) * n])
            for i in range(st["n_images"])]


def _assemble_lossless_device(pixels: np.ndarray, options: EncodeOptions,
                              collected) -> bytes:
    """Host half of the ANS device path: headers + per-group rANS
    emission of the device residuals (``libjxl_tpu``'s function of the
    same name, which leaves the WP header of its group headers at the
    default)."""
    from libjxl_tpu.entropy.ans import (
        build_entropy_codes_from_histogram, write_tokens_pretokenized,
    )
    from libjxl_tpu.entropy.hybrid import DEFAULT_UINT_CONFIG

    h, w, nch = pixels.shape
    packed, mask, hist = collected
    codes = build_entropy_codes_from_histogram(hist)
    bw, fd = _frame_headers(h, w, 8 if pixels.dtype == np.uint8 else 16,
                            nch, options)

    def group_stream(sw: BitWriter, g: int) -> None:
        gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
        gw_v = min(fd.group_dim, w - gx * fd.group_dim)
        gh_v = min(fd.group_dim, h - gy * fd.group_dim)
        res = native.lossless_group_encode(
            packed[g], gw_v, gh_v, codes.counts[0], codes.slot_starts[0],
            codes.slots[0])
        if res is not None:
            sw.append_packed(*res)
            return
        m = np.broadcast_to(mask[g], packed[g].shape)
        t, nb, b = DEFAULT_UINT_CONFIG.encode_array(packed[g][m])
        write_tokens_pretokenized(sw, t, nb, b, codes)

    def dc_section() -> bytes:
        sw = BitWriter()
        sw.append_packed(*_global_bits(codes, options.use_rct and nch >= 3))
        if fd.num_groups == 1:
            group_stream(sw, 0)
        sw.zero_pad_to_byte()
        return sw.to_bytes()

    def ac_group_section(g: int) -> bytes:
        sw = BitWriter()
        GroupHeader(use_global_tree=True).write(sw)
        group_stream(sw, g)
        sw.zero_pad_to_byte()
        return sw.to_bytes()

    groups = []
    if fd.num_groups > 1:
        native.get_lib()     # build/bind once before the pool
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            groups = list(ex.map(ac_group_section, range(fd.num_groups)))
    return _stream(bw.to_bytes(), bw.bits_written, fd, dc_section(), groups)
