"""Image file I/O for the tools layer (reference ``lib/extras/dec/decode.cc``
and ``lib/extras/enc/*``): auto-detected decode of PNG/PNM/PGM/PPM/JPEG
etc., and PNG/PNM/NPY encode. PNM is implemented natively; other formats
go through PIL when present."""

from __future__ import annotations

import io
import os
import re

import numpy as np


def _read_pnm(data: bytes) -> np.ndarray:
    """P5 (gray) / P6 (rgb), 8- or 16-bit big-endian."""
    m = re.match(rb"(P[56])\s+(?:#[^\n]*\n\s*)*(\d+)\s+(\d+)\s+(\d+)\s",
                 data)
    if not m:
        raise ValueError("unsupported PNM header")
    kind, w, h, maxval = (m.group(1), int(m.group(2)), int(m.group(3)),
                          int(m.group(4)))
    nch = 3 if kind == b"P6" else 1
    offset = m.end()
    if maxval < 256:
        arr = np.frombuffer(data, np.uint8, w * h * nch, offset)
    else:
        arr = np.frombuffer(data, ">u2", w * h * nch, offset).astype(
            np.uint16)
    return arr.reshape(h, w, nch)


def _write_pnm(img: np.ndarray) -> bytes:
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, nch = img.shape
    kind = b"P6" if nch == 3 else b"P5"
    maxval = 255 if img.dtype == np.uint8 else 65535
    header = b"%s\n%d %d\n%d\n" % (kind, w, h, maxval)
    body = img.astype(">u2").tobytes() if maxval > 255 else \
        img.astype(np.uint8).tobytes()
    return header + body


def _read_pam(data: bytes) -> np.ndarray:
    """P7 PAM (lib/extras/dec/pnm.cc PAM branch): header keywords up to
    ENDHDR, then raw samples (16-bit big-endian above maxval 255)."""
    end = data.index(b"ENDHDR\n") + 7
    fields = {}
    for line in data[:end].decode("latin-1").splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[0] in ("WIDTH", "HEIGHT", "DEPTH",
                                            "MAXVAL"):
            fields[parts[0]] = int(parts[1])
    w, h = fields["WIDTH"], fields["HEIGHT"]
    depth = fields.get("DEPTH", 3)
    maxval = fields.get("MAXVAL", 255)
    if maxval < 256:
        arr = np.frombuffer(data, np.uint8, w * h * depth, end)
    else:
        arr = np.frombuffer(data, ">u2", w * h * depth, end).astype(
            np.uint16)
    return arr.reshape(h, w, depth)


def _write_pam(img: np.ndarray) -> bytes:
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, nch = img.shape
    tupl = {1: "GRAYSCALE", 2: "GRAYSCALE_ALPHA", 3: "RGB",
            4: "RGB_ALPHA"}[nch]
    maxval = 255 if img.dtype == np.uint8 else 65535
    header = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {nch}\n"
              f"MAXVAL {maxval}\nTUPLTYPE {tupl}\nENDHDR\n").encode()
    body = img.astype(">u2").tobytes() if maxval > 255 else \
        img.astype(np.uint8).tobytes()
    return header + body


def _read_pfm(data: bytes) -> np.ndarray:
    """PF/Pf float map (lib/extras/dec/pnm.cc PFM branch): rows are
    stored bottom-up; a negative scale means little-endian."""
    m = re.match(rb"(P[Ff])\s+(\d+)\s+(\d+)\s+(-?[0-9.eE+]+)\s", data)
    if not m:
        raise ValueError("unsupported PFM header")
    nch = 3 if m.group(1) == b"PF" else 1
    w, h = int(m.group(2)), int(m.group(3))
    scale = float(m.group(4))
    dt = "<f4" if scale < 0 else ">f4"
    arr = np.frombuffer(data, dt, w * h * nch, m.end()).astype(np.float32)
    return arr.reshape(h, w, nch)[::-1].copy()


def _write_pfm(img: np.ndarray) -> bytes:
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, nch = img.shape
    if nch not in (1, 3):
        img = img[:, :, :3]
        nch = 3
    kind = b"PF" if nch == 3 else b"Pf"
    f32 = img.astype(np.float32)
    if img.dtype == np.uint8:
        f32 /= 255.0
    elif img.dtype == np.uint16:
        f32 /= 65535.0
    header = b"%s\n%d %d\n-1.0\n" % (kind, w, h)
    return header + f32[::-1].astype("<f4").tobytes()


def _read_pgx(data: bytes) -> np.ndarray:
    """PGX (lib/extras/dec/pgx.cc): 'PG <ML|LM> [+|-]<bits> <w> <h>',
    grayscale raw samples."""
    m = re.match(rb"PG[ \t]+(ML|LM)[ \t]+([+-]?)[ \t]*(\d+)[ \t]+"
                 rb"(\d+)[ \t]+(\d+)[ \t]*[\r\n]", data)
    if not m:
        raise ValueError("unsupported PGX header")
    if m.group(2) == b"-":
        raise ValueError("signed PGX not supported")
    bits = int(m.group(3))
    w, h = int(m.group(4)), int(m.group(5))
    if bits <= 8:
        arr = np.frombuffer(data, np.uint8, w * h, m.end())
    else:
        dt = ">u2" if m.group(1) == b"ML" else "<u2"
        arr = np.frombuffer(data, dt, w * h, m.end()).astype(np.uint16)
    return arr.reshape(h, w, 1)


def _write_pgx(img: np.ndarray) -> bytes:
    if img.ndim == 3:
        img = img[:, :, 0]
    h, w = img.shape
    bits = 8 if img.dtype == np.uint8 else 16
    header = b"PG ML + %d %d %d\n" % (bits, w, h)
    body = img.astype(">u2").tobytes() if bits == 16 else \
        img.astype(np.uint8).tobytes()
    return header + body


def open_image_chunked(path: str) -> np.ndarray:
    """Memory-mapped pixel view for binary PNM inputs (the reference's
    ChunkedPNM streaming input, lib/extras/dec/pnm.cc): P5/P6 rasters
    have a fixed stride, so the file maps directly as an (h, w, c)
    array and the OS pages rows in as the streaming encoder slices
    them — the whole image is never resident. Other formats fall back
    to a full load."""
    with open(path, "rb") as f:
        head = f.read(64)
    if head[:2] not in (b"P5", b"P6"):
        return load_image(path)
    m = re.match(rb"(P[56])\s+(?:#[^\n]*\n\s*)*(\d+)\s+(\d+)\s+(\d+)\s",
                 head)
    if not m:
        return load_image(path)
    kind, w, h, maxval = (m.group(1), int(m.group(2)), int(m.group(3)),
                          int(m.group(4)))
    nch = 3 if kind == b"P6" else 1
    dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    mm = np.memmap(path, dtype=dt, mode="r", offset=m.end(),
                   shape=(h, w, nch))
    return mm


def load_image(path: str) -> np.ndarray:
    """Decode a PNG/PNM/PAM/PFM/PGX/JPEG/... file to (h, w, c)
    uint8/uint16 (float32 for PFM/EXR)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] in (b"P5", b"P6"):
        return _read_pnm(data)
    if data[:2] == b"P7":
        return _read_pam(data)
    if data[:2] in (b"PF", b"Pf"):
        return _read_pfm(data)
    if data[:2] == b"PG":
        return _read_pgx(data)
    if data[:2] == b"\xff\x0a" or data[:12].endswith(b"JXL \r\n\x87\n"):
        from libjxl_torch.api.decoder import decode
        return decode(data)
    if data[:4] == b"\x76\x2f\x31\x01":
        from libjxl_torch.extras.exr import read_exr
        return read_exr(data)              # float32 HDR
    try:
        from PIL import Image
        img = Image.open(io.BytesIO(data))
        if img.mode in ("I;16", "I;16B", "I"):
            return np.asarray(img, dtype=np.uint16)[..., None]
        if img.mode == "L":
            return np.asarray(img, dtype=np.uint8)[..., None]
        if img.mode not in ("RGB", "RGBA"):
            img = img.convert("RGB")
        return np.asarray(img, dtype=np.uint8)
    except ImportError as e:
        raise ValueError(f"cannot decode {path}: PIL unavailable") from e


def save_image(path: str, img: np.ndarray) -> None:
    """Encode to the format implied by the extension."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img2d = img[:, :, 0]
    else:
        img2d = img
    if ext in (".pnm", ".ppm", ".pgm"):
        with open(path, "wb") as f:
            f.write(_write_pnm(img))
        return
    if ext == ".pam":
        with open(path, "wb") as f:
            f.write(_write_pam(img))
        return
    if ext == ".pfm":
        with open(path, "wb") as f:
            f.write(_write_pfm(img))
        return
    if ext == ".pgx":
        with open(path, "wb") as f:
            f.write(_write_pgx(img))
        return
    if ext == ".npy":
        np.save(path, img)
        return
    if ext == ".exr":
        from libjxl_torch.extras.exr import write_exr
        f32 = img.astype(np.float32)
        if img.dtype == np.uint8:
            f32 /= 255.0
        elif img.dtype == np.uint16:
            f32 /= 65535.0
        # float input keeps full precision; integer input fits in half
        ptype = "float" if img.dtype == np.float32 else "half"
        with open(path, "wb") as f:
            f.write(write_exr(f32, pixel_type=ptype))
        return
    from PIL import Image
    if ext in (".jpg", ".jpeg"):
        # lib/extras/enc/jpg.cc analog (quality 90 default, like cjpeg)
        arr = img2d
        if arr.dtype != np.uint8:
            arr = np.clip(arr.astype(np.float64) /
                          (257.0 if arr.dtype == np.uint16 else 1.0),
                          0, 255).astype(np.uint8)
        if arr.ndim == 3 and arr.shape[2] == 4:
            arr = arr[:, :, :3]
        Image.fromarray(arr).save(path, "JPEG", quality=90)
        return
    Image.fromarray(img2d).save(path)


def load_animation(path: str):
    """Decode an animated GIF/APNG/WebP to (frames, durations_ms,
    num_loops); a still image returns a single frame (the reference's
    extras GIF/APNG decoders, lib/extras/dec/gif.cc, apng.cc)."""
    from PIL import Image, ImageSequence
    img = Image.open(path)
    n = getattr(img, "n_frames", 1)
    if n <= 1:
        return [load_image(path)], [0], 0
    frames, durations = [], []
    mode = "RGBA" if "transparency" in img.info or img.mode == "RGBA" \
        else "RGB"
    for frame in ImageSequence.Iterator(img):
        durations.append(int(frame.info.get("duration", 100)))
        frames.append(np.asarray(frame.convert(mode), dtype=np.uint8))
    loops = img.info.get("loop", 0)
    return frames, durations, int(loops)
