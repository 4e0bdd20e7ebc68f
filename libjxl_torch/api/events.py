"""Event-driven incremental decoder API (reference ``lib/jxl/decode.cc``,
``include/jxl/decode.h``): feed bytes as they arrive, receive events —
BASIC_INFO, COLOR_ENCODING, BOX, FRAME, FULL_IMAGE, SUCCESS — as soon as
enough input is available. Mirrors the JxlDecoder event loop in a
pythonic form (events are returned from :meth:`StreamingDecoder.process`
instead of polled one at a time)."""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from libjxl_torch.api.codestream import (
    read_codec_metadata, read_frame_sections,
)
from libjxl_torch.core.fields import FormatError
from libjxl_torch.core.frame_header import FrameType
from libjxl_torch.utils.bits import BitReader


class DecoderEvent(enum.IntFlag):
    """Event flags (decode.h JxlDecoderStatus event values)."""

    BASIC_INFO = 0x40
    COLOR_ENCODING = 0x100
    PREVIEW_IMAGE = 0x200
    FRAME = 0x400
    FULL_IMAGE = 0x1000
    BOX = 0x4000
    SUCCESS = 0x1_0000


ALL_EVENTS = (DecoderEvent.BASIC_INFO | DecoderEvent.COLOR_ENCODING |
              DecoderEvent.PREVIEW_IMAGE | DecoderEvent.FRAME |
              DecoderEvent.FULL_IMAGE | DecoderEvent.BOX |
              DecoderEvent.SUCCESS)

_CONTAINER_SIG = bytes((0, 0, 0, 0x0C, 0x4A, 0x58, 0x4C, 0x20,
                        0x0D, 0x0A, 0x87, 0x0A))


@dataclass
class BasicInfo:
    xsize: int
    ysize: int
    bits_per_sample: int
    num_color_channels: int
    num_extra_channels: int
    have_animation: bool


class StreamingDecoder:
    """Incremental decoder: ``feed()`` bytes, ``process()`` events.

    Unlike the one-shot :func:`libjxl_torch.api.decoder.decode`, input may
    arrive in arbitrary chunks (network streaming); each event is emitted
    exactly once, as soon as its data is complete. ``rewind()`` restarts
    event emission without re-feeding input (decode.h JxlDecoderRewind);
    ``skip_frames(n)`` suppresses the next n FULL_IMAGE events."""

    def __init__(self, events: DecoderEvent = ALL_EVENTS):
        self.subscribed = events
        self._buf = bytearray()
        self._boxes_done = False      # container layer fully scanned
        self._box_pos = 0             # scan position in the container
        self._is_container = None
        self._cs = bytearray()        # extracted codestream bytes
        self._cs_complete = False
        self._meta = None
        self._hdr_bytes = 0           # consumed codestream prefix
        self._frames = []             # parsed FrameSections
        self._done = False
        self._skip = 0
        # composition state (decoder.decode_frames)
        self._refs = [None] * 4
        self._dc_store = {}
        self._canvas = None
        self._out_format = None       # PixelFormat for FULL_IMAGE bytes
        self.images = []              # decoded (h, w, c) float arrays

    # ---- input ------------------------------------------------------------

    def feed(self, data: bytes) -> None:
        if self._done:
            raise RuntimeError("decoder already finished; rewind() first")
        self._buf.extend(data)

    def rewind(self) -> None:
        data = bytes(self._buf)
        self.__init__(self.subscribed)
        self._buf.extend(data)

    def skip_frames(self, n: int) -> None:
        self._skip += n

    def set_image_out_format(self, fmt) -> None:
        """Request FULL_IMAGE payloads as packed bytes in an external
        pixel format (decode.h JxlDecoderSetImageOutBuffer +
        JxlPixelFormat: uint8/uint16/float16/float32, channel count,
        endianness, row alignment). ``self.images`` keeps the float
        arrays either way."""
        self._out_format = fmt

    def flush(self):
        """Render what has arrived of the CURRENT (incomplete) frame
        (decode.h JxlDecoderFlushImage; dec_frame.cc:735): complete AC
        groups at full quality, missing ones drawn from the upsampled
        DC. Returns an (h, w, c) float array, or None when not even a
        partial image can be produced yet."""
        if self._meta is None:
            return None
        if self._done:
            return self.images[-1] if self.images else None
        from libjxl_torch.api.codestream import read_frame_sections
        from libjxl_torch.api.decoder import _frame_to_float
        r = BitReader(bytes(self._cs[self._hdr_bytes:]))
        try:
            fs = read_frame_sections(r, self._meta, allow_partial=True)
            img, _ = _frame_to_float(self._meta, fs, self._refs,
                                     self._dc_store)
        except (FormatError, ValueError, IndexError):
            return None
        return np.moveaxis(img[:, :self._meta.ysize, :self._meta.xsize],
                           0, -1)

    # ---- event loop --------------------------------------------------------

    def process(self) -> list:
        """Consume as much buffered input as possible; returns a list of
        (DecoderEvent, payload) tuples for newly completed items."""
        events = []
        self._scan_container(events)
        self._parse_headers(events)
        self._parse_frames(events)
        return [(e, p) for (e, p) in events if e & self.subscribed]

    # ---- container layer ---------------------------------------------------

    def _scan_container(self, events) -> None:
        if self._boxes_done:
            return
        if self._is_container is None:
            if len(self._buf) < 12:
                return
            self._is_container = bytes(self._buf[:12]) == _CONTAINER_SIG
            if not self._is_container:
                self._boxes_done = True
                self._cs = self._buf          # bare codestream: alias
                return
            self._box_pos = 0
        import struct
        while True:
            p = self._box_pos
            if len(self._buf) - p < 8:
                return
            size = struct.unpack(">I", self._buf[p:p + 4])[0]
            btype = bytes(self._buf[p + 4:p + 8])
            hdr = 8
            if size == 1:
                if len(self._buf) - p < 16:
                    return
                size = struct.unpack(">Q", self._buf[p + 8:p + 16])[0]
                hdr = 16
            if size == 0:                     # extends to EOF
                if self._cs_complete or btype not in (b"jxlc", b"jxlp"):
                    payload = bytes(self._buf[p + hdr:])
                    self._emit_box(events, btype, payload, final=False)
                    return
                payload = bytes(self._buf[p + hdr:])
                self._append_codestream(btype, payload)
                return                        # stays open until rewind
            if len(self._buf) - p < size:
                return
            payload = bytes(self._buf[p + hdr:p + size])
            self._emit_box(events, btype, payload, final=True)
            self._box_pos = p + size

    def _append_codestream(self, btype: bytes, payload: bytes) -> None:
        if btype == b"jxlp":
            payload = payload[4:]             # sequence number
        self._cs.extend(payload)

    def _emit_box(self, events, btype: bytes, payload: bytes,
                  final: bool) -> None:
        if btype in (b"jxlc", b"jxlp"):
            if btype == b"jxlp":
                idx = int.from_bytes(payload[:4], "big")
                if idx & 0x80000000:
                    self._cs_complete = True
                payload = payload[4:]
            else:
                self._cs_complete = True
            if not isinstance(self._cs, bytearray) or \
                    self._cs is self._buf:
                self._cs = bytearray()
            self._cs.extend(payload)
            return
        events.append((DecoderEvent.BOX, (btype.decode("latin1"), payload)))

    # ---- codestream headers ------------------------------------------------

    def _parse_headers(self, events) -> None:
        if self._meta is not None or not self._cs:
            return
        r = BitReader(bytes(self._cs))
        try:
            meta = read_codec_metadata(r)
        except (FormatError, ValueError, IndexError):
            return
        if r.overflow:
            return
        self._meta = meta
        self._hdr_bytes = r.bits_consumed // 8
        m = meta.m
        events.append((DecoderEvent.BASIC_INFO, BasicInfo(
            meta.xsize, meta.ysize, m.bit_depth.bits_per_sample,
            m.color_encoding.channels, m.num_extra_channels,
            m.have_animation)))
        events.append((DecoderEvent.COLOR_ENCODING, m.color_encoding))

    # ---- frames ------------------------------------------------------------

    def _parse_frames(self, events) -> None:
        if self._meta is None or self._done:
            return
        from libjxl_torch.api.decoder import _blend_frame, _frame_to_float

        meta = self._meta
        if self._canvas is None:
            self._canvas = np.zeros(
                (3 + meta.m.num_extra_channels, meta.ysize, meta.xsize),
                np.float32)
        while not self._done:
            is_preview = (getattr(meta.m, "have_preview", False) and
                          not self._frames)
            r = BitReader(bytes(self._cs[self._hdr_bytes:]))
            try:
                fs = read_frame_sections(r, meta, is_preview=is_preview)
            except (FormatError, ValueError, IndexError, MemoryError):
                return
            if r.overflow:
                return
            self._hdr_bytes += r.bits_consumed // 8
            self._frames.append(fs)
            fh = fs.header
            if is_preview:
                # decode.h JXL_DEC_PREVIEW_IMAGE: emit, don't composite
                img, _ = _frame_to_float(meta, fs, self._refs,
                                         self._dc_store)
                events.append((DecoderEvent.PREVIEW_IMAGE,
                               np.moveaxis(img, 0, -1)))
                continue
            events.append((DecoderEvent.FRAME, fh))
            img, pre_ct = _frame_to_float(meta, fs, self._refs,
                                          self._dc_store)
            if fh.frame_type == FrameType.REFERENCE_ONLY:
                self._refs[fh.save_as_reference] = \
                    pre_ct if fh.save_before_color_transform else img
                continue
            if fh.frame_type == FrameType.DC_FRAME:
                self._dc_store[fh.dc_level] = pre_ct
                continue
            x0 = fh.frame_origin_x0 if fh.custom_size_or_origin else 0
            y0 = fh.frame_origin_y0 if fh.custom_size_or_origin else 0
            self._canvas = _blend_frame(self._canvas, img, fh, x0, y0,
                                        meta, self._refs)
            if fh.save_as_reference != 0:
                self._refs[fh.save_as_reference] = (
                    pre_ct if fh.save_before_color_transform
                    else self._canvas.copy())
            out = np.moveaxis(self._canvas.copy(), 0, -1)
            self.images.append(out)
            if self._skip > 0:
                self._skip -= 1
            else:
                payload = pack_pixels(out, self._out_format) \
                    if self._out_format is not None else out
                events.append((DecoderEvent.FULL_IMAGE, payload))
            if fh.is_last:
                self._done = True
                events.append((DecoderEvent.SUCCESS, None))

    # ---- convenience -------------------------------------------------------

    @property
    def basic_info(self):
        if self._meta is None:
            return None
        m = self._meta.m
        return BasicInfo(self._meta.xsize, self._meta.ysize,
                         m.bit_depth.bits_per_sample,
                         m.color_encoding.channels, m.num_extra_channels,
                         m.have_animation)


@dataclass
class PixelFormat:
    """Output pixel format (decode.h JxlPixelFormat): requested channel
    count, sample type, endianness and row alignment."""

    num_channels: int = 0          # 0 = native channel count
    data_type: str = "uint8"       # uint8|uint16|float16|float32
    endianness: str = "native"     # native|little|big
    align: int = 0                 # row byte alignment (0/1 = packed)


def pack_pixels(img, fmt: PixelFormat) -> bytes:
    """Convert a decoded (h, w, c) float [0,1] image to the requested
    external format (dec_external_image.cc ConvertToExternal): integer
    types are scaled to full range with round-half-away, float types
    pass through; rows are padded to ``align`` bytes."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    nc = fmt.num_channels or c
    if nc > c:
        # gray expands to RGB first, then pad with opaque alpha
        # (ConvertToExternal rules)
        if c == 1 and nc >= 3:
            img = np.repeat(img, 3, axis=2)
            c = 3
        if nc > c:
            img = np.concatenate(
                [img, np.ones((h, w, nc - c), np.float32)], axis=2)
    img = img[:, :, :nc]
    dt = {"uint8": np.uint8, "uint16": np.uint16,
          "float16": np.float16, "float32": np.float32}[fmt.data_type]
    if dt in (np.uint8, np.uint16):
        maxval = 255.0 if dt == np.uint8 else 65535.0
        arr = np.clip(np.floor(img * maxval + 0.5), 0, maxval).astype(dt)
    else:
        arr = img.astype(dt)
    if fmt.endianness in ("little", "big") and arr.dtype.itemsize > 1:
        want = "<" if fmt.endianness == "little" else ">"
        arr = arr.astype(arr.dtype.newbyteorder(want))
    row_bytes = w * nc * arr.dtype.itemsize
    align = max(fmt.align, 1)
    stride = -(-row_bytes // align) * align
    if stride == row_bytes:
        return arr.tobytes()
    out = bytearray(stride * h)
    flat = arr.reshape(h, -1).view(np.uint8)
    for y in range(h):
        out[y * stride:y * stride + row_bytes] = flat[y].tobytes()
    return bytes(out)
