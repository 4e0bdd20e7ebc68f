"""Object-style encoder API (reference ``lib/jxl/encode.cc``,
``include/jxl/encode.h``): an :class:`Encoder` accepts frames (pixels or
JPEG bytes), per-frame settings, and metadata boxes, and assembles the
codestream/container — the JxlEncoder frame-queue model in a pythonic
form."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class _ChunkedFrame:
    """Row-sliceable shim over a chunk callback: the streaming encoder
    pulls pixels one ``pixels[y0:y1]`` band at a time."""

    def __init__(self, xsize: int, ysize: int, get_chunk, dtype):
        self.xsize, self.ysize = xsize, ysize
        self._get = get_chunk
        self._dtype = dtype

    def __len__(self) -> int:
        return self.ysize

    def __getitem__(self, sl):
        y0 = sl.start or 0
        y1 = self.ysize if sl.stop is None else min(sl.stop, self.ysize)
        out = np.asarray(self._get(0, y0, self.xsize, y1 - y0))
        if out.shape[0] != y1 - y0 or out.shape[1] != self.xsize:
            raise ValueError("chunk callback returned wrong shape")
        return out.astype(self._dtype, copy=False)


@dataclass
class FrameSettings:
    """Per-frame options (encode.h JxlEncoderFrameSettings, the commonly
    used subset; everything else keeps the library default)."""

    lossless: bool = True
    distance: float = 1.0
    effort: int = 3
    duration: int = 0           # animation ticks
    name: str = ""
    progressive: bool = False


@dataclass
class Encoder:
    """Queue frames and boxes, then :meth:`output` the file.

    Mirrors the JxlEncoder flow: optional basic info / animation setup,
    ``add_frame`` / ``add_jpeg_frame`` per frame, ``add_box`` for
    metadata (Exif/XMP), ``use_container`` to force the box format."""

    use_container: bool = False
    have_animation: bool = False
    tps: tuple = (10, 1)
    num_loops: int = 0
    collect_stats: bool = False    # JxlEncoderCollectStats
    stats: object = None           # EncoderStats after output()
    _frames: list = field(default_factory=list)
    _boxes: list = field(default_factory=list)
    _jpeg: bytes | None = None

    def add_frame(self, pixels: np.ndarray,
                  settings: FrameSettings | None = None) -> None:
        if self._jpeg is not None:
            raise ValueError("cannot mix JPEG and pixel frames")
        self._frames.append((np.asarray(pixels), settings or
                             FrameSettings()))

    def add_chunked_frame(self, xsize: int, ysize: int, get_chunk,
                          settings: FrameSettings | None = None,
                          dtype=np.uint8) -> None:
        """Chunked frame input (encode.cc:2534
        JxlEncoderChunkedFrameAdapter / JxlChunkedFrameInputSource): the
        frame is supplied by ``get_chunk(x0, y0, w, h) -> (h, w, c)``
        callbacks instead of one array. A lossless frame is encoded
        through the streaming path — chunks are requested one DC-group
        band at a time and the image is never materialized; a lossy
        frame falls back to buffering the full frame first, exactly like
        the reference adapter when streaming is not possible."""
        if self._jpeg is not None:
            raise ValueError("cannot mix JPEG and pixel frames")
        self._frames.append((_ChunkedFrame(xsize, ysize, get_chunk,
                                           dtype), settings or
                             FrameSettings()))

    def add_jpeg_frame(self, jpeg_bytes: bytes) -> None:
        """Lossless JPEG recompression (encode.cc JxlEncoderAddJPEGFrame):
        the output carries a jbrd box for byte-exact reconstruction."""
        if self._frames or self._jpeg is not None:
            raise ValueError("JPEG frame must be the only frame")
        self._jpeg = jpeg_bytes
        self.use_container = True

    def add_box(self, box_type: str, payload: bytes) -> None:
        """Metadata box (Exif/XMP/custom; encode.cc JxlEncoderAddBox)."""
        bt = box_type.encode("latin1")
        if len(bt) != 4:
            raise ValueError("box type must be 4 characters")
        self._boxes.append((bt, payload))
        self.use_container = True

    def output(self) -> bytes:
        if self.collect_stats:
            from libjxl_torch.api.stats import EncoderStats
            self.stats = EncoderStats()
            with self.stats.collect():
                return self._output()
        return self._output()

    def _output(self) -> bytes:
        from libjxl_torch.api.container import wrap_container

        if self._jpeg is not None:
            from libjxl_torch.jpeg.transcode import encode_jpeg
            data = encode_jpeg(self._jpeg)      # container incl. jbrd
            if self._boxes:
                # splice extra boxes before the codestream box
                from libjxl_torch.api.container import (
                    extract_codestream, parse_boxes,
                )
                boxes = parse_boxes(data)
                extra = [(b.type, b.payload) for b in boxes
                         if b.type not in (b"JXL ", b"ftyp", b"jxlc")]
                return wrap_container(extract_codestream(data),
                                      extra_boxes=extra + self._boxes)
            return data
        if not self._frames:
            raise ValueError("no frames queued")

        first_px, first_st = self._frames[0]
        if len(self._frames) == 1 and not self.have_animation:
            cs = self._encode_single(first_px, first_st)
        else:
            cs = self._encode_multi()
        if self.use_container or self._boxes:
            return wrap_container(cs, extra_boxes=self._boxes)
        return cs

    def _encode_single(self, px, st: FrameSettings) -> bytes:
        if isinstance(px, _ChunkedFrame):
            if st.lossless:
                from libjxl_torch.api.encoder import (
                    EncodeOptions, encode_lossless_streaming,
                )
                return b"".join(encode_lossless_streaming(
                    px, EncodeOptions(effort=st.effort)))
            px = px[0:px.ysize]          # buffer: non-streaming fallback
        if st.lossless:
            from libjxl_torch.api.encoder import (
                EncodeOptions, encode_lossless,
            )
            return encode_lossless(px, EncodeOptions(effort=st.effort))
        from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
        return encode_lossy(px, LossyOptions(
            distance=st.distance, effort=st.effort,
            progressive=st.progressive))

    def _encode_multi(self) -> bytes:
        frames = [px for px, _ in self._frames]
        durations = [st.duration or 1 for _, st in self._frames]
        lossless = [st.lossless for _, st in self._frames]
        st0 = self._frames[0][1]
        if any(lossless) and not all(lossless):
            # mixed lossless/lossy frames: the container must stay
            # non-XYB (the reference rejects lossless frames in an
            # xyb_encoded codestream, encode.cc:1573-1576), so lossy
            # frames are coded as lossy MODULAR (squeeze-residual
            # quantization) in the original color space
            from libjxl_torch.api.encoder import (
                EncodeOptions, encode_animation,
            )
            per = [EncodeOptions(effort=st.effort,
                                 distance=0.0 if st.lossless
                                 else max(st.distance, 0.1))
                   for _, st in self._frames]
            return encode_animation(frames, durations,
                                    EncodeOptions(effort=st0.effort),
                                    tps=self.tps, num_loops=self.num_loops,
                                    per_frame_options=per)
        if all(lossless):
            from libjxl_torch.api.encoder import (
                EncodeOptions, encode_animation,
            )
            return encode_animation(frames, durations,
                                    EncodeOptions(effort=st0.effort),
                                    tps=self.tps,
                                    num_loops=self.num_loops)
        from libjxl_torch.vardct.frame_enc import (
            LossyOptions, encode_lossy_animation,
        )
        return encode_lossy_animation(
            frames, durations,
            LossyOptions(distance=st0.distance, effort=st0.effort,
                         progressive=st0.progressive),
            tps=self.tps, num_loops=self.num_loops)
