"""Parse cjxl's color-description strings (``-x color_space=...``).

Mirrors ``lib/extras/dec/color_description.cc``: tokens separated by
``_`` are ColorSpace, WhitePoint, Primaries, RenderingIntent and
TransferFunction — e.g. ``RGB_D65_SRG_Rel_SRG`` (sRGB),
``RGB_D65_202_Rel_PeQ`` (Rec.2100 PQ), ``Gra_D65_Rel_SRG`` (gray sRGB),
``RGB_D65_SRG_Rel_g2.2`` (gamma 2.2). XYB descriptions take only a
rendering intent.
"""

from __future__ import annotations

from libjxl_torch.core.headers import (
    ColorEncoding, ColorSpace, CustomTransferFunction, Primaries,
    RenderingIntent, TransferFunction, WhitePoint,
)

_SPACES = {"RGB": ColorSpace.RGB, "Gra": ColorSpace.GRAY,
           "XYB": ColorSpace.XYB, "CS?": ColorSpace.UNKNOWN}
_WHITES = {"D65": WhitePoint.D65, "EER": WhitePoint.E,
           "DCI": WhitePoint.DCI}
_PRIMARIES = {"SRG": Primaries.SRGB, "202": Primaries.BT2100,
              "DCI": Primaries.P3}
_INTENTS = {"Per": RenderingIntent.PERCEPTUAL,
            "Rel": RenderingIntent.RELATIVE,
            "Sat": RenderingIntent.SATURATION,
            "Abs": RenderingIntent.ABSOLUTE}
_TFS = {"709": TransferFunction.BT709, "TF?": TransferFunction.UNKNOWN,
        "Lin": TransferFunction.LINEAR, "SRG": TransferFunction.SRGB,
        "PeQ": TransferFunction.PQ, "DCI": TransferFunction.DCI,
        "HLG": TransferFunction.HLG}


def parse_color_description(desc: str) -> ColorEncoding:
    """Description string -> ColorEncoding (raises ValueError)."""
    toks = desc.split("_")
    it = iter(toks)

    def nxt(what):
        try:
            return next(it)
        except StopIteration:
            raise ValueError(f"color description missing {what}: {desc}")

    cs_tok = nxt("color space")
    if cs_tok not in _SPACES:
        raise ValueError(f"unknown color space {cs_tok!r}")
    ce = ColorEncoding(color_space=_SPACES[cs_tok])
    if ce.color_space == ColorSpace.XYB:
        intent = nxt("rendering intent")
        if intent not in _INTENTS:
            raise ValueError(f"unknown rendering intent {intent!r}")
        ce.rendering_intent = _INTENTS[intent]
        return ce
    wp = nxt("white point")
    if wp == "Cst":
        raise ValueError("custom white point not supported; use a named "
                         "white point (D65/EER/DCI)")
    if wp not in _WHITES:
        raise ValueError(f"unknown white point {wp!r}")
    ce.white_point = _WHITES[wp]
    if ce.color_space != ColorSpace.GRAY:
        pr = nxt("primaries")
        if pr == "Cst":
            raise ValueError("custom primaries not supported; use "
                             "SRG/202/DCI")
        if pr not in _PRIMARIES:
            raise ValueError(f"unknown primaries {pr!r}")
        ce.primaries = _PRIMARIES[pr]
    intent = nxt("rendering intent")
    if intent not in _INTENTS:
        raise ValueError(f"unknown rendering intent {intent!r}")
    ce.rendering_intent = _INTENTS[intent]
    tf = nxt("transfer function")
    if tf.startswith("g"):
        # encoding exponent <= 1 (e.g. g0.45455), stored as gamma * 1e7
        gamma = float(tf[1:])
        if not 0 < gamma <= 1.0:
            raise ValueError(f"invalid gamma {tf!r} (exponent in (0, 1])")
        ce.tf = CustomTransferFunction(
            have_gamma=True, gamma=int(round(gamma * 1e7)))
    elif tf in _TFS:
        ce.tf = CustomTransferFunction(transfer_function=_TFS[tf])
    else:
        raise ValueError(f"unknown transfer function {tf!r}")
    return ce
