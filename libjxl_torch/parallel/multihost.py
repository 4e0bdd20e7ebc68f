"""Multi-process encode and decode over ``torch.distributed`` (port of
``libjxl_tpu/parallel/multihost.py``): the streaming DC-group schedule
sharded across processes.

The reference's streaming encoder already proves the schedule: DC-group
bands are encoded independently with per-band histograms so no global
synchronization is needed (enc_frame.cc:2045-2160; per-DC-group
histogram count at :2074). Across hosts the same schedule maps to
processes: every process encodes only the DC-group row bands it owns,
and the per-section byte blobs, the only data that crosses processes,
are gathered with one ragged allgather. The result is byte-identical to
the single-process streaming encode because every section is
self-contained by construction (api/encoder._StreamingLayout).

The caller initialises the process group (``torch.distributed.
init_process_group``, as ``jax.distributed.initialize`` is the caller's
in the reference), on the gloo backend: the gathers move CPU tensors,
the reference's "Gloo/DCN channel". Each process does its device work
(``decode_multihost``'s restoration filters) on ``config.device``;
several processes may share one card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _process_allgather_bytes(blobs: list[bytes]) -> list[list[bytes]]:
    """Allgather a per-process list of byte blobs.

    Three gathers of CPU tensors: the blob counts, an int32 length
    matrix, then one padded uint8 payload."""
    nproc = dist.get_world_size()

    def gather(t: torch.Tensor) -> np.ndarray:
        out = [torch.empty_like(t) for _ in range(nproc)]
        dist.all_gather(out, t)
        return torch.stack(out).numpy()

    counts = gather(torch.tensor([len(blobs)], dtype=torch.int32))[:, 0]
    max_n = int(counts.max())
    lens = np.zeros(max_n, np.int32)
    lens[:len(blobs)] = [len(b) for b in blobs]
    all_lens = gather(torch.from_numpy(lens))
    max_bytes = int(all_lens.sum(axis=1).max()) or 1
    payload = np.zeros(max_bytes, np.uint8)
    cat = b"".join(blobs)
    payload[:len(cat)] = np.frombuffer(cat, np.uint8)
    all_payload = gather(torch.from_numpy(payload))
    out: list[list[bytes]] = []
    for p in range(nproc):
        pos = 0
        rows = []
        for i in range(int(counts[p])):
            ln = int(all_lens[p, i])
            rows.append(all_payload[p, pos:pos + ln].tobytes())
            pos += ln
        out.append(rows)
    return out


def encode_lossless_multihost(pixels, options=None) -> bytes | None:
    """Encode one huge image across all processes of the group; returns
    the complete codestream on rank 0 (None on the others).

    DC-group row bands (2048 px, the streaming chunk of
    enc_frame.cc:2135) are dealt round-robin to processes; each process
    only materializes and compresses its own bands. Byte-identical to
    ``b"".join(encode_lossless_streaming(pixels, options))``."""
    from libjxl_torch.api.encoder import EncodeOptions, _StreamingLayout

    options = options or EncodeOptions()
    first = np.asarray(pixels[0:1])
    h = len(pixels)
    w = first.shape[1]
    nch = 1 if first.ndim == 2 else first.shape[2]
    pid, nproc = dist.get_rank(), dist.get_world_size()
    lay = _StreamingLayout(h, w, nch, first.dtype, options)
    fd = lay.fd

    mine: list[bytes] = []
    for dcy in range(pid, fd.ysize_dc_groups, nproc):
        mine.extend(lay.dc_band_sections(pixels, dcy))
    gathered = _process_allgather_bytes(mine)

    if pid != 0:
        return None
    # reassemble file order: bands were dealt round-robin by dcy
    cursors = [0] * nproc
    file_sections = [lay.dc_global_section()]
    for dcy in range(fd.ysize_dc_groups):
        p = dcy % nproc
        n = _band_section_count(fd, dcy)
        file_sections.extend(gathered[p][cursors[p]:cursors[p] + n])
        cursors[p] += n
    file_sections.append(b"")       # AC global
    return lay.header_bytes + b"".join(lay.assemble(file_sections))


def _band_section_count(fd, dcy: int) -> int:
    """Sections one DC row band contributes (DC groups + AC groups)."""
    gys = min(fd.ysize_groups, dcy * 8 + 8) - dcy * 8
    return fd.xsize_dc_groups + gys * fd.xsize_groups


def encode_lossy_multihost(pixels, options=None) -> bytes | None:
    """Multi-process VarDCT encode: each process encodes its round-robin
    share of DC-group row bands with the band-local streaming layout
    (vardct/frame_enc.encode_lossy_streaming: per-band AC histogram
    sets, enc_frame.cc:2074), and one ragged allgather moves the section
    bytes + per-band entropy codes to rank 0, which writes headers, the
    merged ACGlobal and the permuted TOC. Byte-identical to the
    single-process streaming encode."""
    import pickle

    from libjxl_torch.vardct.frame_enc import (
        LossyOptions, _lossy_band_sections, _merged_stream_ac_global,
        _stream_assemble, _stream_headers_and_frame,
        _streaming_lossy_check,
    )

    options = options or LossyOptions()
    pixels = np.asarray(pixels)
    _streaming_lossy_check(pixels, options)
    pid, nproc = dist.get_rank(), dist.get_world_size()
    bw, fd = _stream_headers_and_frame(pixels, options)
    nbands = fd.ysize_dc_groups
    sel_bits = (nbands - 1).bit_length() if nbands > 1 else 0
    mine: list[bytes] = []
    for dcy in range(pid, nbands, nproc):
        res = _lossy_band_sections(pixels, dcy, options, sel_bits)
        mine.append(pickle.dumps(
            (dcy, res["sections"], res["num_dc_groups"], res["codes"]),
            protocol=4))
    gathered = _process_allgather_bytes(mine)
    if pid != 0:
        return None
    by_band = {}
    for rows in gathered:
        for blob in rows:
            dcy, secs, nb_dc, codes = pickle.loads(blob)
            by_band[dcy] = (secs, nb_dc, codes)
    dc_global = by_band[0][0][0]
    band_secs = []
    codes_list = []
    for dcy in range(nbands):
        secs, nb_dc, codes = by_band[dcy]
        band_secs.append((secs[1:1 + nb_dc], secs[2 + nb_dc:]))
        codes_list.append(codes)
    ac_global = _merged_stream_ac_global(codes_list, fd)
    return _stream_assemble(bw, fd, dc_global, ac_global, band_secs)


def decode_multihost(data: bytes) -> np.ndarray | None:
    """Multi-process sharded decode: each process renders a contiguous
    window of group rows with the banded decoder (api/decoder.decode_rows
    gy_range: one extra neighbour band per boundary keeps the
    restoration filters halo-exact; the filters run on
    ``config.device`` where the device-filter policy says so), and one
    ragged allgather moves the pixel shards to rank 0. Bit-identical to
    the single-process ``decode(data)``.

    The reference's analog is the AC-group RunOnPool fan-out
    (dec_frame.cc:726) plus the low-memory pipeline's cross-group
    border store (low_memory_render_pipeline.h:62-84); across processes
    the border exchange becomes one redundantly-decoded 256-row band per
    process boundary."""
    import pickle

    from libjxl_torch.api.codestream import parse_codestream
    from libjxl_torch.api.container import extract_codestream
    from libjxl_torch.api.decoder import decode_rows
    from libjxl_torch.config import config

    pid, nproc = dist.get_rank(), dist.get_world_size()
    meta, frames = parse_codestream(extract_codestream(data))
    fd = frames[-1].dims
    n_gy = fd.ysize_groups
    a = pid * n_gy // nproc
    b = (pid + 1) * n_gy // nproc
    gd = fd.group_dim
    chunks = [arr for (y0, arr) in decode_rows(data, gy_range=(a, b),
                                               device=config.device)
              if a * gd <= y0 < b * gd]     # fallback paths yield all
    mine = np.concatenate(chunks, axis=0) if chunks else \
        np.zeros((0, fd.xsize, 3), np.uint8)
    gathered = _process_allgather_bytes([pickle.dumps(mine, protocol=4)])
    if pid != 0:
        return None
    parts = []
    for p in range(nproc):
        arr = pickle.loads(gathered[p][0])
        if arr.shape[0]:
            parts.append(arr)
    return np.concatenate(parts, axis=0)
