"""jxlinfo_torch — codestream/metadata inspector (reference
``tools/jxlinfo.cc``)."""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from libjxl_torch.cli import apply_platform_env
    apply_platform_env()
    p = argparse.ArgumentParser(prog="jxlinfo_torch")
    p.add_argument("input")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from libjxl_torch.api.codestream import parse_codestream
    from libjxl_torch.api.container import (
        extract_codestream, is_container, parse_boxes,
    )
    from libjxl_torch.core.frame_header import FrameEncoding

    with open(args.input, "rb") as f:
        data = f.read()
    if is_container(data):
        print("JPEG XL container (ISOBMFF)")
        for box in parse_boxes(data):
            print(f"  box {box.type.decode('latin1')!r:8} "
                  f"{len(box.data)} bytes")
            if box.type == b"jxli":
                from libjxl_torch.api.container import \
                    decode_frame_index_box
                tnum, tden, recs = decode_frame_index_box(box.data)
                print(f"    frame index: {len(recs)} keyframes, "
                      f"tick {tnum}/{tden}")
                off = 0
                prev_delta = 0
                for k, (offi, ti, fi) in enumerate(recs):
                    off = offi if k == 0 else off + offi
                    print(f"    #{k}: codestream offset {off}, "
                          f"start tick {ti}, +{fi} frame(s)")
    codestream = extract_codestream(data)
    meta, frames = parse_codestream(codestream)
    m = meta.m
    depth = m.bit_depth
    kind = "float" if depth.floating_point_sample else "uint"
    print(f"JPEG XL {'container, ' if is_container(data) else ''}"
          f"{meta.xsize}x{meta.ysize}, {kind}{depth.bits_per_sample}")
    print(f"  color: {'XYB-encoded (lossy)' if m.xyb_encoded else 'original'}"
          f", channels={m.color_encoding.channels}"
          f"{', ICC' if m.color_encoding.want_icc else ''}")
    if m.num_extra_channels:
        for i, eci in enumerate(m.extra_channel_info):
            print(f"  extra channel {i}: type={eci.type} "
                  f"bits={eci.bit_depth.bits_per_sample} "
                  f"name={eci.name!r}")
    if m.have_animation:
        a = m.animation
        print(f"  animation: {a.tps_numerator}/{a.tps_denominator} tps, "
              f"loops={a.num_loops}")
    for i, fr in enumerate(frames):
        fh = fr.header
        enc = "Modular" if fh.encoding == FrameEncoding.MODULAR else "VarDCT"
        print(f"  frame {i}: {enc}, {fr.dims.xsize}x{fr.dims.ysize}, "
              f"{fr.dims.num_groups} groups, "
              f"{fh.passes.num_passes} pass(es)"
              f"{', gaborish' if fh.loop_filter.gab else ''}"
              f"{f', epf={fh.loop_filter.epf_iters}' if fh.loop_filter.epf_iters else ''}"
              f"{', last' if fh.is_last else ''}")
        if args.verbose:
            print(f"    sections: {[len(s) for s in fr.sections]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
