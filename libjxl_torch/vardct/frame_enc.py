"""VarDCT lossy encoder: XYB + 8x8 DCT + uniform adaptive-free quantization
(the reference's e1-e3 feature point; ``lib/jxl/enc_frame.cc``,
``enc_group.cc``). Pixel-parallel math is numpy here and torch on the
device paths (``models/vardct_pipeline.py`` at effort <= 4,
``models/vardct_heuristics.py``, ``vardct_transform.py`` and
``vardct_loop.py`` at effort >= 5); bitstream assembly is host-side. The
port's copy of ``libjxl_tpu/vardct/frame_enc.py``: the device branches
run on ``device``, and the butteraugli scorer of the effort >= 7 loop
runs there on the host path too.

Encodes: DC global (quantizer/ctx/cfl defaults), per-DC-group VarDCT DC +
AC metadata modular streams, AC global (default matrices + histograms),
per-group AC token streams. Our decoder and libjxl both accept the
output."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libjxl_torch.core.fields import FieldWriter, write_u32
from libjxl_torch.core.frame_header import (
    ColorTransform, FrameEncoding, FrameHeader,
)
from libjxl_torch.core.geometry import FrameDimensions, cdiv
from libjxl_torch.core.headers import (
    BitDepth, ColorEncoding, CustomTransformData, ImageMetadata, SizeHeader,
    pack_signed, write_bundle, write_signature,
)
from libjxl_torch.core.toc import write_toc
from libjxl_torch.entropy.ans import (
    build_entropy_codes, tokens_to_array, write_entropy_codes, write_tokens,
)
from libjxl_torch.modular.codec import GroupHeader, modular_encode
from libjxl_torch.modular.image import Channel, ModularImage
from libjxl_torch.modular.predict import PREDICTOR_GRADIENT, PREDICTOR_ZERO
from libjxl_torch.modular.tree import TreeNode
from libjxl_torch.utils import prof
from libjxl_torch.utils.bits import BitWriter
from libjxl_torch.vardct.ac_context import BlockCtxMap, zero_density_context
from libjxl_torch.vardct.ac_strategy import natural_order
from libjxl_torch.vardct.coeff_order import K_ORDER_ENC
from libjxl_torch.vardct.dct import coeffs_rc_to_stored, dct2d
from libjxl_torch.vardct.frame_dec import K_GLOBAL_SCALE_DENOM, Quantizer, \
    _GLOBAL_SCALE_DIST, _QUANT_DC_DIST
from libjxl_torch.vardct.quant_weights import DequantMatrices
from libjxl_torch.color.xyb import linear_to_xyb, srgb_to_linear


@dataclass
class LossyOptions:
    distance: float = 1.0
    effort: int = 3
    ec_resampling: int = 1       # extra channels at 1/r (cjxl
                                 # --ec_resampling; must equal
                                 # resampling when both are set)
    resampling: int = 0          # 1/2/4/8 encode at 1/r scale + signal
                                 # upsampling; 0 = auto (2x at d>=10 with
                                 # the reference's distance adjustment,
                                 # enc_frame.cc:104-117)
    faster_decoding: int = 0     # decoding_speed tier 0-4: trade density
                                 # for decode speed (fewer EPF passes,
                                 # no gaborish/32x32 at 4, capped
                                 # histogram counts; enc_frame.cc:
                                 # 316-345, enc_ac_strategy.cc:936,
                                 # enc_ans.cc:1368-1375)
    use_device: bool = False     # device path for color+DCT+quantize
                                 # (the heuristics at effort >= 5)
    color_encoding: object = None  # input/signaled ColorEncoding
                                   # (None=sRGB); PQ/HLG/Rec2020 inputs go
                                   # through the CMS (color/cms.py) into XYB
    intensity_target: float = 0.0  # nits; 0 = default (255, or 10000 PQ)
    splines = None               # render.splines.Splines to embed
    patches = None               # None=auto (detect at effort>=7),
                                 # False=off (enc_patch_dictionary.cc)
    dots = None                  # None=auto (with patches at d>=3),
                                 # False=off, True=force
                                 # (enc_dot_dictionary.cc / cjxl --dots)
    epf: int = -1                # -1=auto from distance; 0-3 force the
                                 # EPF iteration count (cjxl --epf)
    gaborish: int = -1           # -1=auto (on at e>=5); 0/1 force
                                 # (cjxl --gaborish)
    group_order: int = 0         # 1: center-first section order via a
                                 # permuted TOC (cjxl --group_order;
                                 # enc_frame.cc PermuteGlobalTOC)
    center_x: int = -1           # --center_x/--center_y: group-order
    center_y: int = -1           # center (-1 = frame center)
    noise = None                 # 8-entry strength LUT, or "auto" to
                                 # estimate from the image (enc_noise.cc)
    photon_noise_iso: float = 0.0  # >0: synthesize the grain a 35mm
                                   # sensor at this ISO would have
                                   # (enc_photon_noise.cc)
    progressive: bool = False    # 3-pass qprogressive AC (shifts 2,1,0)
    progressive_ac: bool = False   # spectral progressive AC: VLF/LF/full
                                   # passes (num_coefficients 2/3/8,
                                   # enc_frame.cc:264-271)
    qprogressive_ac: bool = False  # 2-pass quant-shift AC (shift 1,0;
                                   # enc_frame.cc:272-277)
    progressive_dc: int = 0      # 1: DC rides a separate LF (DC_FRAME)
                                 # at dc_level 1 (enc_frame.cc
                                 # progressive_dc; decoder
                                 # USE_DC_FRAME path)
    qf_override = None           # explicit float quant field (internal:
                                 # the butteraugli iteration loop)
    _sharpness_field = None      # per-block EPF sharpness (internal:
                                 # ComputeARHeuristics search result)
    _dispatch_only = False       # internal: device serving pipeline
    _predispatched = None        # internal: the device payload
                                 # (models/vardct_pipeline.LossyPayload)
    _aux = None                  # dict filled with qf_field/acs when set
    _in_iteration = False        # internal: inside the butteraugli loop
    _recon_only = False          # internal: stop after quantization and
                                 # stash the recon state in _aux (the
                                 # GetBlockFromEncoder analog — no
                                 # bitstream is emitted)
    _animation = None            # AnimationHeader for multi-frame streams
    _is_last = True              # frame-level: last frame in codestream
    _duration = 0                # frame duration in animation ticks
    _emit_headers = True         # False: emit only the frame sections
    _stream_sel = None           # (sel, nbits): AC-group histogram-set
                                 # selector for the streaming per-band
                                 # histogram layout (enc_frame.cc:2074)
    _sections_only = False       # internal: return the raw section
                                 # list + entropy codes (the streaming/
                                 # multi-host band producer)


def _epf_iters_for(d: float, decoding_speed: int) -> int:
    """EPF pass count from distance, reduced by the decoding-speed tier
    (enc_frame.cc:333-342): tier 2 drops the first threshold, tier >= 3
    disables EPF entirely."""
    if decoding_speed >= 3:
        return 0
    thresholds = (0.7, 1.5, 4.0)[1 if decoding_speed == 2 else 0:]
    return sum(d >= t for t in thresholds)


def _dc_stream_tree(img: ModularImage, group_id: int, fallback_pred: int,
                    effort: int, kind: str = "dc"):
    """MA tree for a DC-group modular sub-stream (DC channels or AC
    metadata). The reference's modular encoder learns one global tree
    over all these streams (enc_modular.cc ComputeEncodingData); we
    learn a compact local tree per stream at effort >= 5, and use the
    reference's PREDEFINED trees at the fast tiers
    (enc_encoding.cc:482-570: kWPFixedDC/kGradientFixedDC for DC,
    kACMeta/kFalconACMeta for the metadata) — a single fallback context
    codes constant quant fields at ~6 bits/block."""
    if effort >= 5:
        try:
            from libjxl_torch.modular.enc_ma import learn_tree
            return learn_tree(
                [(i, ch.plane) for i, ch in enumerate(img.channel)],
                max_leaves=32, group_id=group_id)
        except Exception:  # noqa: BLE001  (degenerate channels)
            pass
    from libjxl_torch.modular.fixed_trees import (
        acmeta_tree, falcon_acmeta_tree, gradient_fixed_dc, wp_fixed_dc,
    )
    total = sum(ch.plane.size for ch in img.channel)
    if kind == "acmeta":
        return falcon_acmeta_tree() if effort <= 3 else acmeta_tree(total)
    if kind == "dc":
        if effort >= 3:
            return wp_fixed_dc(total)
        if effort == 2:
            return gradient_fixed_dc(total)
    return [TreeNode(-1, 0, 0, 0, fallback_pred, 0, 1)]


def encode_lossy(pixels: np.ndarray, options: LossyOptions | None = None,
                 device=None) -> bytes:
    """Encode (h, w, 3) uint8 sRGB to a VarDCT JXL codestream.

    The e3-class heuristics of the reference: adaptive quantization field
    (enc_adaptive_quantization.cc), dead-zone thresholds and Y-roundtrip
    chroma-from-luma (enc_group.cc:329-520, enc_chroma_from_luma.cc).
    With ``options.use_device`` at effort <= 4 the color transform, DCT,
    quantization, CfL and DC run on ``device`` (default
    ``config.device``); at effort >= 5 the front end (XYB, quant field,
    Gaborish inverse) and, inside the effort >= 7 loop, the ACS cost
    grids, the transform and the butteraugli loop. The loop's scorer runs
    on ``device`` without ``use_device`` too."""
    options = options or LossyOptions()
    if pixels.ndim != 3 or pixels.shape[2] < 3:
        raise ValueError("lossy encoder expects RGB input")
    h, w, _ = pixels.shape
    # alpha rides as a (lossless) modular extra channel in the VarDCT
    # frame's modular sub-bitstream (enc_modular.cc:480-520)
    alpha = pixels[:, :, 3].astype(np.int32) if pixels.shape[2] >= 4 \
        else None
    d = max(options.distance, 0.01)
    full_w, full_h = w, h
    # ---- resampling (enc_frame.cc:104-117): encode at 1/r scale and
    # signal fh.upsampling; auto mode turns on 2x at very low bitrates
    # with the reference's distance rebalance
    resample = int(options.resampling)
    if resample <= 0:
        resample = 1
        if d >= 10.0:
            resample = 2
            d = d * 0.25 + 0.25
    elif resample not in (1, 2, 4, 8):
        raise ValueError("resampling must be 1, 2, 4 or 8")
    ec_resample = int(getattr(options, "ec_resampling", 1) or 1)
    if resample > 1 and alpha is not None:
        if ec_resample != resample:
            raise ValueError(
                "resampling with extra channels needs ec_resampling == "
                "resampling (pass --ec_resampling; independent EC scales "
                "are not supported)")
        # encode alpha at 1/r too and signal extra_channel_upsampling
        # (enc_frame.cc DownsampleImage on extra channels)
        from libjxl_torch.render.enc_downsample import downsample_box
        alpha = np.rint(downsample_box(alpha.astype(np.float64),
                                       resample)).astype(np.int32)
    float_samples = False
    if pixels.dtype == np.uint16:
        bits_per_sample = 16
        maxval = 65535.0
    elif pixels.dtype == np.uint8:
        bits_per_sample = 8
        maxval = 255.0
    elif pixels.dtype in (np.float32, np.float16):
        # HDR/float input: samples are SIGNAL values in the (possibly
        # PQ/HLG) color encoding, nominal range [0, 1]
        float_samples = True
        bits_per_sample = 16 if pixels.dtype == np.float16 else 32
        maxval = 1.0
    else:
        raise ValueError("lossy encoder expects uint8/uint16/float input")

    if options.effort >= 7 and not options._in_iteration:
        # butteraugli-iterated refinement (FindBestQuantization,
        # enc_adaptive_quantization.cc:929-1115): delegate BEFORE any
        # front-end compute — the iterated driver's first pass redoes
        # (and caches) every pixel-derived product; its scorer runs on
        # ``device`` on the host path and with the device loop alike
        return _encode_lossy_iterated(pixels, options, device)

    from libjxl_torch.vardct.adaptive_quant import (
        adaptive_quant_field, compute_global_scale_and_quant,
        compute_scale_from_quant, initial_quant_dc,
    )
    from libjxl_torch.vardct.frame_dec import adjust_quant_bias

    # ---- color transform -------------------------------------------------
    from libjxl_torch.core.headers import TransferFunction
    ce_in = options.color_encoding
    intensity = options.intensity_target
    if intensity <= 0:
        if ce_in is not None and not ce_in.tf.have_gamma and \
                ce_in.tf.transfer_function == TransferFunction.PQ:
            intensity = 10000.0
        else:
            intensity = 255.0
    # full-compute device path: e<=4, sRGB uint8 input, no host-side
    # statistics needed (noise="auto" estimates from host XYB)
    use_dev = (options.use_device and options.effort <= 4 and
               ce_in is None and pixels.dtype == np.uint8 and
               not isinstance(options.noise, str) and
               options.qf_override is None and resample == 1)
    # e>=5 device front-end (VERDICT r2 #3 gate lift): XYB + gaborish
    # inverse + adaptive quant field + ACS cost grids run as fused XLA
    # programs (models/vardct_heuristics.py); the host keeps the merge
    # decisions, tokenization and entropy coding. Patch detection is
    # skipped on this path (serving mode).
    use_dev_heur = (options.use_device and options.effort >= 5 and
                    ce_in is None and pixels.dtype == np.uint8 and
                    not isinstance(options.noise, str) and
                    resample == 1)
    # butteraugli-loop iterations: every pixel-derived product (opsin,
    # gaborish inverse, patches, noise LUT) is a pure function of the
    # input and already cached in aux — skip recomputing them all
    cached_iter = (options._aux is not None and options._in_iteration
                   and "xyb_cache" in options._aux)
    if use_dev or use_dev_heur or cached_iter:
        xyb = None
    elif ce_in is None:
        signal = pixels[:, :, :3].astype(np.float64) / maxval
        linear = srgb_to_linear(signal)
        xyb = linear_to_xyb(np.moveaxis(linear, -1, 0))
    else:
        signal = pixels[:, :, :3].astype(np.float64) / maxval
        from libjxl_torch.color.cms import encoding_to_linear_srgb
        lin_srgb = encoding_to_linear_srgb(np.moveaxis(signal, -1, 0),
                                           ce_in, intensity)
        # XYB's internal absolute scale: 1.0 = 255 nits (enc_xyb.cc);
        # the decoder divides by the signaled intensity_target again
        xyb = linear_to_xyb(lin_srgb * (intensity / 255.0))

    # ---- noise model (encoder side) -------------------------------------
    noise_lut = options.noise
    if cached_iter and isinstance(noise_lut, str):
        noise_lut = options._aux.get("noise_cache")
    elif isinstance(noise_lut, str):     # "auto": estimate from the image
        from libjxl_torch.render.enc_noise import estimate_noise
        noise_lut = estimate_noise(xyb)
        if options._aux is not None:
            options._aux["noise_cache"] = noise_lut
    elif noise_lut is None and options.photon_noise_iso > 0:
        from libjxl_torch.render.enc_noise import photon_noise_lut
        noise_lut = photon_noise_lut(options.photon_noise_iso,
                                     full_w, full_h)

    if resample > 1:
        # downsample the opsin (enc_heuristics.cc:409-421); h/w become
        # FRAME-space sizes from here on (headers keep full_w/full_h)
        if xyb is not None:
            from libjxl_torch.render.enc_downsample import downsample_xyb
            xyb = downsample_xyb(np.asarray(xyb), resample)
            h, w = xyb.shape[1], xyb.shape[2]
        else:
            h = -(-h // resample)
            w = -(-w // resample)

    fd = FrameDimensions(w, h, 256)
    xb, yb = fd.xsize_blocks, fd.ysize_blocks

    # ---- patch detection (enc_heuristics.cc:1058-1066; runs on the
    # pre-gaborish opsin, atlas subtracted before the quant field) -----
    will_delegate = (options.effort >= 7 and not options._in_iteration
                     and not options.use_device)
    patches_dict = None
    atlas_frame_bytes = b""
    if (options.effort >= 7 and options.patches is not False and
            not use_dev and not will_delegate and xyb is not None and
            min(h, w) >= 3 * 4):
        from libjxl_torch.render.enc_patches import (
            PATCH_FRAME_REF_ID, build_patch_dictionary,
            find_text_like_patches, pack_patches, quantize_atlas_modular,
            subtract_patches,
        )
        found = find_text_like_patches(np.asarray(xyb, np.float32))
        if options.dots is True or (options.dots is None and d >= 3.0):
            # dots only pay off at low quality (enc_params.h:194
            # kMinButteraugliForDots; enc_dot_dictionary.cc:44) unless
            # forced (cjxl --dots 1)
            from libjxl_torch.render.enc_dots import find_dots
            found.extend(find_dots(xyb))
        if found:
            found, atlas, apos = pack_patches(found)
            chans, atlas_dec = quantize_atlas_modular(atlas)
            num_extra = 1 if alpha is not None else 0
            patches_dict = build_patch_dictionary(found, apos, num_extra)
            xyb = np.asarray(xyb, np.float64).copy()
            subtract_patches(xyb, patches_dict, atlas_dec)
            if options._aux is not None:
                options._aux["patches_cache"] = (patches_dict, chans)
    elif cached_iter and "patches_cache" in options._aux:
        # loop iterations: the detection ran on the first pass and the
        # cached xyb products already have the atlas subtracted
        patches_dict, chans = options._aux["patches_cache"]

    # gaborish is on at hare-class efforts: sharpen now, decoder smooths
    # (enc_heuristics.cc:1134-1144; LoopFilterFromParams)
    use_gab = (options.effort >= 5 and d > 0.5 and
               options.faster_decoding < 4)
    if options.gaborish >= 0:            # cjxl --gaborish 0/1 override
        use_gab = bool(options.gaborish)
    aux = options._aux
    dev_qf = None
    if use_dev:
        xyb_pre_gab = xyb_p = None
    elif aux is not None and options._in_iteration and "xyb_cache" in aux:
        # butteraugli loop: the opsin/gaborish-inverse/pad products are
        # pure functions of the pixels — reuse across iterations
        xyb_p, xyb_pre_gab = aux["xyb_cache"]
        dev_qf = aux.get("dev_qf")
    elif use_dev_heur:
        # the device front end: XYB + Gaborish inverse + AQ field
        # (models/vardct_heuristics.front_device)
        from libjxl_torch.models.vardct_heuristics import front_device
        with prof.stage("front_dispatch"):
            qf_d, xyb_p_d, pre_gab_d = front_device(
                pixels[:, :, :3], float(d), bool(use_gab), h=h, w=w, yb=yb,
                xb=xb, device=device)
        with prof.stage("front_fetch"):
            dev_qf = qf_d.cpu().numpy()
            xyb_p = xyb_p_d.cpu().numpy().astype(np.float64)
        xyb_pre_gab = None          # AQ field already computed on device
        if aux is not None:
            # keep the device tensors: the EPF candidate search and the
            # grids and transform read them on the device
            aux["opsin"] = pre_gab_d[:, :h, :w]
            aux["xyb_cache"] = (xyb_p, xyb_pre_gab)
            aux["dev_qf"] = dev_qf
            aux["y_plane_dev"] = xyb_p_d
    else:
        # the adaptive quant field uses PRE-gaborish values
        # (enc_heuristics.cc:1117 comment); sharpen after computing it
        xyb_pre_gab = np.pad(xyb,
                             ((0, 0), (0, yb * 8 - h), (0, xb * 8 - w)),
                             mode="edge")
        if aux is not None:
            # pre-gaborish, post-feature-subtraction opsin: the AR
            # search compares decoded candidates against this
            aux["opsin"] = np.asarray(xyb, np.float64).copy()
        if use_gab:
            from libjxl_torch.render.filters import gaborish_inverse
            xyb = gaborish_inverse(xyb)
        # pad to block grid (edge replicate)
        xyb_p = np.pad(xyb, ((0, 0), (0, yb * 8 - h), (0, xb * 8 - w)),
                       mode="edge")
        if aux is not None:
            aux["xyb_cache"] = (xyb_p, xyb_pre_gab)

    # ---- quantization field (enc_heuristics.cc:1091-1130) ---------------
    quant_dc_f = initial_quant_dc(d)
    if options.qf_override is not None:
        from libjxl_torch.vardct.adaptive_quant import \
            compute_global_scale_and_quant
        qf_field = options.qf_override
        global_scale, quant_dc_int, raw_quant = \
            compute_global_scale_and_quant(quant_dc_f, qf_field)
    elif options.effort <= 4:
        # Falcon-class: constant field. The reference uses 0.79/d
        # (enc_heuristics.cc:1107), but the global-scale cap rounds the
        # raw field to ~6 quant steps there, landing at +16% size vs
        # libjxl e3 (whose density advantage is its entropy-coding
        # heuristics). 0.70/d rounds to the next step down: ~1.5%
        # smaller than libjxl e3 at d1.0 with butteraugli +0.04.
        # (An e5-class adaptive field was probed in r5: heterogeneous
        # content degrades hard — large_wood BD +7.1 -> +18.4 — the
        # masking field needs the e5 ACS/EPF machinery around it.)
        qf_field = np.full((yb, xb), 0.70 / d, np.float32)
        global_scale, quant_dc_int, raw_quant = compute_scale_from_quant(
            quant_dc_f, 0.70 / d, qf_field)
    else:
        # Hare-class and slower: adaptive field (enc_heuristics.cc:1118-
        # 1126; without gaborish the distance gets a 0.62x correction).
        # The global scale targets the FIELD's median (quantizer.cc:45
        # kQuantFieldTarget=5) so the integer raw-quant keeps resolution
        # when masking pulls the field away from the nominal 0.39/d.
        if dev_qf is not None:
            qf_field = dev_qf
        else:
            qf_field, _ = adaptive_quant_field(
                xyb_pre_gab, d if use_gab else d * 0.62)
        global_scale, quant_dc_int, raw_quant = \
            compute_global_scale_and_quant(quant_dc_f, qf_field)
    from libjxl_torch.utils import debug as _dbg
    if _dbg.active():
        # DumpHeatmaps (enc_adaptive_quantization.cc:738-763)
        _dbg.dump_image("quant_heatmap", np.asarray(qf_field, np.float32))
    quantizer = Quantizer(global_scale, quant_dc_int)
    matrices = DequantMatrices()
    bctx = BlockCtxMap()

    # x_qm_scale from distance (enc_frame.cc:673-678)
    x_qm_scale = 3
    for step in (2.5, 5.5, 9.5):
        if d > step:
            x_qm_scale += 1
    x_qm_mul = 1.25 ** (x_qm_scale - 2)

    inv_gs = quantizer.inv_global_scale
    table = matrices.tables[0].reshape(3, 64).astype(np.float64)  # DCT8
    inv_table = 1.0 / table                        # quant weights

    # ---- quantize Y with dead zone, roundtrip for CfL -------------------
    # thresholds: quadrants of the coefficient block (enc_group.cc:357-360);
    # stored layout is transposed but the quadrant values are symmetric.
    def quadrant_thresholds(t0, t_rest):
        th = np.full((8, 8), t_rest)
        th[:4, :4] = t0
        th[0, 0] = 0.0          # DC slot never thresholded away here
        return th.reshape(64)

    if use_dev:
        # the device program: color + DCT + quantize + CfL + DC
        from libjxl_torch.models.vardct_pipeline import (
            encode_lossy_frame_device, unpack_lossy_outputs,
        )
        mul_dc = quantizer.mul_dc(matrices.dc_quant)
        qac_f = (quantizer.scale *
                 raw_quant.astype(np.float32))
        inv_qac_f = (inv_gs / raw_quant.astype(np.float32))
        payload = options._predispatched
        from libjxl_torch.config import config as _cfg
        mesh = None
        if _cfg.shard_encode and payload is None and \
                not options._dispatch_only:
            from libjxl_torch.parallel.mesh import make_mesh
            mesh = make_mesh(_cfg.mesh_slots, device)
        if mesh is not None and mesh.size > 1:
            # multi-device: the same math over row bands, one a slot
            # (models/vardct_pipeline.encode_lossy_frame_device_sharded)
            from libjxl_torch.models.vardct_pipeline import \
                encode_lossy_frame_device_sharded
            q_ac, q_dc, ytox_map, ytob_map = \
                encode_lossy_frame_device_sharded(
                    pixels, qac_f, inv_qac_f,
                    np.asarray(table, np.float32),
                    quadrant_thresholds(0.56, 0.62).astype(np.float32),
                    quadrant_thresholds(0.58, 0.62).astype(np.float32),
                    np.asarray(mul_dc, np.float32),
                    h=h, w=w, yb=yb, xb=xb, x_qm_mul=x_qm_mul, mesh=mesh)
        else:
            if payload is None:
                payload = encode_lossy_frame_device(
                    pixels[:, :, :3], qac_f, inv_qac_f,
                    np.asarray(table, np.float32),
                    quadrant_thresholds(0.56, 0.62).astype(np.float32),
                    quadrant_thresholds(0.58, 0.62).astype(np.float32),
                    np.asarray(mul_dc, np.float32),
                    h=h, w=w, yb=yb, xb=xb, x_qm_mul=x_qm_mul,
                    device=device)
                if options._dispatch_only:
                    # serving mode: the payload still on the device;
                    # encode_lossy_many fetches it on its host pool
                    return payload
            q_ac, q_dc, ytox_map, ytob_map = unpack_lossy_outputs(
                payload, yb, xb)
        use_acs = False
        acs_map = np.zeros((yb, xb), np.int32)
        acs_anchors = np.ones((yb, xb), bool)
        stored = None
    else:
        # ---- AC strategy gating (hoisted: the device transform path
        # decides whether the whole-frame DCT8 is needed on host) -----
        use_acs = options.effort >= 5 and not (
            options.progressive or options.progressive_ac or
            options.qprogressive_ac)
        from libjxl_torch.config import config as _cfg2
        use_dev_tq = (
            use_dev_heur and use_acs and _cfg2.device_transform and
            aux is not None and aux.get("y_plane_dev") is not None and
            patches_dict is None and options.splines is None and
            noise_lut is None)
        # ---- DCT ------------------------------------------------------------
        if use_dev_tq:
            stored = None            # whole-frame DCT8 lives on device
        elif aux is not None and options._in_iteration and \
                "stored_dct" in aux:
            stored = aux["stored_dct"]
        else:
            blocks = xyb_p.reshape(3, yb, 8, xb, 8).transpose(1, 3, 0, 2, 4)
            from libjxl_torch.vardct.dct import dct_matrix
            m8 = dct_matrix(8)
            coef = (m8 @ blocks) @ m8.T    # batched BLAS, not naive einsum
            stored = coef.transpose(0, 1, 2, 4, 3).reshape(yb, xb, 3, 64)
            if aux is not None:
                aux["stored_dct"] = stored

        thres_y = quadrant_thresholds(0.56, 0.62)
        thres_xb = quadrant_thresholds(0.58, 0.62)

        qac = quantizer.scale * raw_quant.astype(np.float64)   # (yb, xb)
        qm = inv_table                                         # (3, 64)

        def quantize(c, coefs, qm_mul, thres):
            val = coefs * (qm[c][None, None] * (qac[:, :, None] * qm_mul))
            q = np.where(np.abs(val) >= thres[None, None], np.rint(val), 0.0)
            return q.astype(np.int32)

        # ---- AC strategy selection (effort>=5): DCT16/DCT32 merges ----------
        # (use_acs hoisted above the DCT block)
        if use_acs:
            if aux is not None and options._in_iteration and \
                    "acs" in aux:
                # FindBestQuantization holds ACS fixed across quant
                # iterations; only the merged-region field adjustment
                # re-applies to the new field
                from libjxl_torch.vardct.enc_acs import adjust_field_for_acs
                acs_map, acs_anchors = aux["acs"], aux["anchors"]
                raw_quant = adjust_field_for_acs(
                    acs_map, acs_anchors, raw_quant, d)
            else:
                from libjxl_torch.vardct.enc_acs import choose_acs
                try_64 = (options.effort >= 7 and
                          options.faster_decoding < 1)
                try_32 = options.faster_decoding < 4
                grids = None
                y_dev = aux.get("y_plane_dev") if aux is not None else None
                if use_dev_heur and y_dev is not None:
                    # cost grids on device (MXU-batched whole-frame DCTs
                    # per strategy class); host keeps the merge pass
                    from libjxl_torch.models.vardct_heuristics import \
                        acs_grids_device
                    strat = [0, 4, 6, 7]
                    if try_32:
                        strat += [5, 10, 11]
                    if try_64:
                        strat += [18, 19, 20]
                    with prof.stage("acs_grids_dev"):
                        grids = acs_grids_device(
                            y_dev, raw_quant, matrices, quantizer, d,
                            tuple(strat))
                # the 8x8 special transforms are tried at hare (e5) and
                # slower in the reference (enc_ac_strategy.cc:855
                # `speed_tier > kHare -> return`)
                with prof.stage("acs_choose"):
                    acs_map, acs_anchors, raw_quant = choose_acs(
                        xyb_p, raw_quant, matrices, quantizer, d,
                        try_small=options.effort >= 5,
                        try_64=try_64, try_32=try_32, grids=grids)
            qac = quantizer.scale * raw_quant.astype(np.float64)
        else:
            acs_map = np.zeros((yb, xb), np.int32)
            acs_anchors = np.ones((yb, xb), bool)
        if options._aux is not None:
            options._aux.update(qf_field=np.asarray(qf_field, np.float64),
                                acs=acs_map, anchors=acs_anchors)

        if options.effort >= 5:
            # content-adaptive block context model (enc_heuristics.cc
            # FindBestBlockEntropyModel): fewer block contexts = smaller
            # AC context map + denser histograms
            from libjxl_torch.vardct.ac_context import build_block_ctx_map
            custom_bctx = None if options.faster_decoding >= 1 else \
                build_block_ctx_map(d, raw_quant, acs_map)
            if custom_bctx is not None:
                bctx = custom_bctx

        if use_dev_tq:
            # fused device transform+quantize (models/vardct_transform):
            # whole-frame DCT8 CfL + per-class forward DCTs + dead-zone
            # quantization on device; the host receives int16 quantized
            # coefficients and per-anchor DC blocks. Identical math to
            # the host branch below (differential-tested); f32-vs-f64
            # can flip a rare rounding boundary (both streams valid).
            from libjxl_torch.models.vardct_transform import \
                transform_quantize_device
            with prof.stage("transform_dev"):
                tq = transform_quantize_device(
                    aux["y_plane_dev"], acs_map, acs_anchors, raw_quant,
                    matrices, quantizer, x_qm_mul)
            blocks = tq["blocks_q"]
            dc_float_acs = tq["dc_float"]
            ytox_map = tq["ytox"]
            ytob_map = tq["ytob"]
            if options._in_iteration:
                cc = aux.setdefault("coef_cache", {})
                cc.setdefault("dev", tq["dev_cache"])
                cc.setdefault("dc_float", dc_float_acs)
            q_ac = None
        else:
            q_y = quantize(1, stored[:, :, 1], 1.0, thres_y)
            # roundtrip Y (AdjustQuantBias + dequant) for chroma-from-luma
            inv_qac = inv_gs / raw_quant.astype(np.float64)        # (yb, xb)
            y_rt = adjust_quant_bias(q_y.reshape(-1, 64), 1).reshape(yb, xb, 64) * \
                (table[1][None, None] * inv_qac[:, :, None])

            # ---- chroma-from-luma search (per 64x64 tile, least squares,
            # all tiles batched; zero padding adds nothing to the sums) ----
            tx_n = cdiv(xb, 8)
            ty_n = cdiv(yb, 8)
            color_scale = 1.0 / 84.0

            def _tiles(a):
                ap = np.zeros((ty_n * 8, tx_n * 8, a.shape[2]))
                ap[:yb, :xb] = a
                return ap.reshape(ty_n, 8, tx_n, 8, -1).transpose(
                    0, 2, 1, 3, 4).reshape(ty_n, tx_n, -1)

            yt = _tiles(y_rt[:, :, 1:])
            denom = np.einsum("ijk,ijk->ij", yt, yt)
            numx = np.einsum("ijk,ijk->ij", _tiles(stored[:, :, 0, 1:]), yt)
            numb = np.einsum("ijk,ijk->ij", _tiles(stored[:, :, 2, 1:]), yt)
            ok = denom >= 1e-9
            dsafe = np.where(ok, denom, 1.0)
            ytox_map = np.where(ok, np.clip(np.round(
                numx / dsafe / color_scale), -128, 127), 0).astype(np.int32)
            ytob_map = np.where(ok, np.clip(np.round(
                (numb / dsafe - 1.0) / color_scale), -128, 127),
                0).astype(np.int32)

            # unapply CfL (with base_correlation_b = 1.0) and quantize X/B
            fx_full = np.repeat(np.repeat(ytox_map, 8, 0), 8, 1)[:yb, :xb] * \
                color_scale
            fb_full = 1.0 + np.repeat(np.repeat(ytob_map, 8, 0), 8, 1)[:yb, :xb] * \
                color_scale
            if use_acs:
                from libjxl_torch.vardct.enc_acs import finish_chroma, transform_all
                cc = aux.setdefault("coef_cache", {}) \
                    if aux is not None and options._in_iteration else None
                with prof.stage("transform_all"):
                    blocks, dc_float_acs = transform_all(
                        xyb_p, acs_map, acs_anchors, raw_quant, matrices,
                        quantizer, x_qm_mul, coef_cache=cc)
                with prof.stage("finish_chroma"):
                    finish_chroma(blocks, dc_float_acs, fx_full, fb_full,
                                  x_qm_mul, quantizer)
            if use_acs:
                # per-block quantization lives in blocks (finish_chroma);
                # the whole-frame DCT8 q_ac would be dead work here
                q_ac = None
            else:
                x_res = stored[:, :, 0] - fx_full[:, :, None] * y_rt
                b_res = stored[:, :, 2] - fb_full[:, :, None] * y_rt
                q_x = quantize(0, x_res, x_qm_mul, thres_xb)
                q_b = quantize(2, b_res, 1.0, thres_xb)
                q_ac = np.stack([q_x, q_y, q_b], axis=2)       # (yb, xb, 3, 64)

    # ---- progressive pass split (enc_progressive_split.cc:30-80) --------
    # precedence mirrors SetProgressiveMode (enc_frame.cc:278-289):
    # custom (-p composite) > qprogressive > spectral progressive
    spectral_bands = None
    if options.progressive:
        pass_shifts = (2, 1, 0)
    elif options.qprogressive_ac:
        pass_shifts = (1, 0)
    elif options.progressive_ac:
        pass_shifts = (0, 0, 0)
        spectral_bands = (2, 3, 8)   # dc_vlf_lf_full_ac num_coefficients
    else:
        pass_shifts = (0,)

    def _sr0(v, shift):
        neg = (v < 0).astype(np.int64)
        add = (neg << shift) - neg
        return (v.astype(np.int64) + add) >> shift

    if len(pass_shifts) == 1:
        q_passes = [q_ac]
    elif q_ac is None:
        raise ValueError("progressive + ACS search not combined yet")
    elif spectral_bands is not None:
        # spectral split: pass p carries the coefficients whose
        # max(row, col) falls in its band; the decoder sums the passes
        # (all shift 0). The DC slot is skipped by the AC scan order,
        # so masking it in or out is irrelevant.
        ii, jj = np.indices((8, 8))
        band = np.maximum(ii, jj).reshape(64)
        q_passes = []
        prev_nc = 0
        for nc in spectral_bands:
            m = ((band >= prev_nc) & (band < nc)).astype(q_ac.dtype)
            q_passes.append((q_ac * m).astype(np.int32))
            prev_nc = nc
    else:
        q_passes = []
        prev_shift = 0
        for p, sh in enumerate(pass_shifts):
            v = q_ac.astype(np.int64)
            if p > 0:
                v = v - (_sr0(v, prev_shift) << prev_shift)
            q_passes.append(_sr0(v, sh).astype(np.int32))
            prev_shift = sh

    if not use_dev:
        # ---- DC -------------------------------------------------------------
        # decode adds cfl_dc_factors (0, ., 1.0)*dequantized-Y-DC
        # (frame_dec.decode_dc_group), so B stores b_dc - dcy_dequantized.
        mul_dc = quantizer.mul_dc(matrices.dc_quant)
        if use_acs:
            dcx_f, dcy_f, dcb_f = (dc_float_acs[0], dc_float_acs[1],
                                   dc_float_acs[2])
        else:
            dcx_f = stored[:, :, 0, 0]
            dcy_f = stored[:, :, 1, 0]
            dcb_f = stored[:, :, 2, 0]
        q_dc_y = np.round(dcy_f / mul_dc[1]).astype(np.int32)
        dcy_deq = q_dc_y * mul_dc[1]
        q_dc_x = np.round(dcx_f / mul_dc[0]).astype(np.int32)
        q_dc_b = np.round((dcb_f - dcy_deq) / mul_dc[2]).astype(np.int32)
        q_dc = np.stack([q_dc_x, q_dc_y, q_dc_b], axis=-1)     # (yb, xb, 3)

    if options._recon_only:
        # butteraugli-loop fast path: stash everything the roundtrip
        # reconstruction needs (enc_roundtrip.reconstruct_prefilter) and
        # stop — no tokens, no entropy codes, no bitstream
        options._aux["recon_state"] = dict(
            blocks=blocks if use_acs else None,
            q_ac=None if use_acs else q_ac,
            q_dc=q_dc, quantizer=quantizer, matrices=matrices,
            raw_quant=raw_quant, acs=acs_map, anchors=acs_anchors,
            ytox=ytox_map, ytob=ytob_map, x_qm_scale=x_qm_scale,
            gab=use_gab,
            epf_iters=(options.epf if options.epf >= 0 else
                       _epf_iters_for(d, options.faster_decoding)),
            fd=fd, sharpness=options._sharpness_field,
            has_features=(patches_dict is not None or
                          options.splines is not None or
                          noise_lut is not None))
        return b""

    # ---- AC tokens (per pass) -------------------------------------------
    order = natural_order(0)
    num_passes = len(pass_shifts)
    group_tokens = [[[] for _ in range(fd.num_groups)]
                    for _ in range(num_passes)]
    gdb = fd.group_dim // 8
    if use_acs and num_passes > 1:
        raise ValueError("progressive + ACS search not combined yet")

    # custom coefficient scan orders from zero statistics
    # (enc_coeff_order.cc:66-74; not at <=falcon, not for tiny images)
    used_orders = 0
    order_perms: dict = {}
    if (num_passes == 1 and options.effort >= 3 and
            fd.num_groups >= 4):
        # small streams skip custom orders: the permutation signaling
        # (~0.1-0.3 kB) outweighs the token savings below ~4 groups
        # (+1.3-2% BD measured), while 12-group images gain 5-15%
        from libjxl_torch.vardct.ac_strategy import STRATEGY_ORDER as _SO
        from libjxl_torch.vardct.coeff_order import compute_custom_orders
        zc: dict = {}
        if use_acs:
            for (by_, bx_), blk in blocks.items():
                b = _SO[int(acs_map[by_, bx_])]
                z = (np.asarray(blk["q"]) == 0).sum(axis=0)
                if b in zc:
                    zc[b] += z
                else:
                    zc[b] = z.astype(np.int64)
        else:
            zc[0] = (q_passes[0] == 0).sum(axis=(0, 1, 2)).astype(
                np.int64)
        used_orders, custom_orders, order_perms = \
            compute_custom_orders(zc)
        if used_orders & 1:
            order = custom_orders[0]

    if use_acs:
        from libjxl_torch.vardct.ac_strategy import STRATEGY_ORDER
        from libjxl_torch.vardct.enc_acs import tokenize_varblocks_group
        orders = {STRATEGY_ORDER[int(sid)]: natural_order(int(sid))
                  for sid in np.unique(acs_map)}
        if used_orders:
            orders.update({b: o for b, o in custom_orders.items()
                           if b in orders})
        def _tok_one(g):
            gy, gx = g // fd.xsize_groups, g % fd.xsize_groups
            by0, bx0 = gy * gdb, gx * gdb
            return tokenize_varblocks_group(
                blocks, acs_map, acs_anchors, orders, bctx,
                raw_quant, by0, bx0, min(gdb, yb - by0),
                min(gdb, xb - bx0))

        with prof.stage("tokenize"):
            if fd.num_groups > 1:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(min(4, fd.num_groups)) as ex:
                    group_tokens[0] = list(
                        ex.map(_tok_one, range(fd.num_groups)))
            else:
                group_tokens[0] = [_tok_one(0)]
    else:
        with prof.stage("tokenize"):
            for p in range(num_passes):
                qp = q_passes[p]
                for gy in range(fd.ysize_groups):
                    for gx in range(fd.xsize_groups):
                        g = gy * fd.xsize_groups + gx
                        by0, bx0 = gy * gdb, gx * gdb
                        gh = min(gdb, yb - by0)
                        gw = min(gdb, xb - bx0)
                        group_tokens[p][g] = _tokenize_group_dct8(
                            qp[by0:by0 + gh, bx0:bx0 + gw], order, bctx,
                            raw_quant[by0:by0 + gh, bx0:bx0 + gw])

    # native one-call entropy tail (jxlt_entropy_tail): clustering,
    # histograms, context map, uint-config search and per-group rANS
    # emission in C — bit-identical to the Python pipeline below
    # (tests/test_entropy.py::test_native_entropy_tail_bit_identical).
    # The streaming band/multi-host paths keep the Python codes objects
    # (they merge histogram sets across bands).
    native_tail = None
    codes_per_pass = None
    if (num_passes == 1 and not options._sections_only and
            options._stream_sel is None):
        from libjxl_torch.utils import native as _native
        with prof.stage("entropy_tail_native"):
            native_tail = _native.entropy_tail(
                [t if isinstance(t, np.ndarray) else
                 tokens_to_array(t) if len(t) else
                 np.zeros((0, 2), np.int64) for t in group_tokens[0]],
                bctx.num_ac_contexts(),
                6 if options.faster_decoding >= 1 else 24, 11,
                options.effort >= 3)
    if native_tail is None:
        with prof.stage("entropy_codes"):
            codes_per_pass = [build_entropy_codes(
                [t if isinstance(t, np.ndarray) else
                 tokens_to_array(t) if len(t) else
                 np.zeros((0, 2), np.int64)
                 for t in group_tokens[p]],
                num_contexts=bctx.num_ac_contexts(),
                allow_clustering=True,
                histo_shift=11,
                max_clusters=6 if options.faster_decoding >= 1 else 24,
                uint_search=options.effort >= 3)
                for p in range(num_passes)]

    # ---- headers ---------------------------------------------------------
    bw = BitWriter()
    from libjxl_torch.core.headers import ExtraChannelInfo
    eci = [ExtraChannelInfo(
        bit_depth=BitDepth(bits_per_sample=bits_per_sample))] \
        if alpha is not None else []
    meta = ImageMetadata(xyb_encoded=True,
                         bit_depth=BitDepth(
                             bits_per_sample=bits_per_sample,
                             floating_point_sample=float_samples,
                             exponent_bits_per_sample=(
                                 5 if (float_samples and
                                       bits_per_sample == 16) else
                                 8 if float_samples else 0)),
                         color_encoding=(options.color_encoding or
                                         ColorEncoding.srgb(gray=False)),
                         extra_channel_info=eci)
    if intensity != 255.0:
        meta.tone_mapping.intensity_target = intensity
    if options._animation is not None:
        meta.have_animation = True
        meta.animation = options._animation
    if options._emit_headers:
        write_signature(bw)
        size = SizeHeader()
        size.set(full_w, full_h)
        write_bundle(bw, size)
        write_bundle(bw, meta)
        ctd = CustomTransformData()
        ctd.xyb_encoded = True
        write_bundle(bw, ctd)
        if meta.color_encoding.want_icc:
            from libjxl_torch.color.icc import write_encoded_icc
            write_encoded_icc(bw, meta.color_encoding.icc)
        bw.zero_pad_to_byte()

    meta.nonserialized_xsize = full_w
    meta.nonserialized_ysize = full_h
    if patches_dict is not None:
        # the atlas rides as a REFERENCE_ONLY modular-XYB frame right
        # before the main frame (RoundtripPatchFrame)
        from libjxl_torch.api.encoder import (
            EncodeOptions, xyb_reference_frame_bytes,
        )
        from libjxl_torch.render.enc_patches import PATCH_FRAME_REF_ID
        # the atlas inherits the frame effort (RoundtripPatchFrame keeps
        # cparams and only pins Predictor::Gradient) — a learned MA tree
        # on the atlas is worth ~3x density on collage content (r4)
        atlas_frame_bytes = xyb_reference_frame_bytes(
            chans, meta, PATCH_FRAME_REF_ID,
            EncodeOptions(effort=max(3, options.effort), use_rct=False,
                          palette=0, lz77=False))
        bw.write_bytes(atlas_frame_bytes)

    dc_frame_bytes = b""
    if options.progressive_dc:
        # LF frame: the reconstructed DC (exactly what the in-band DC
        # path would decode: quantized DC + base CfL factors) rides a
        # modular-XYB DC_FRAME at dc_level 1; the main frame sets
        # USE_DC_FRAME and omits its DC-modular payload
        from libjxl_torch.api.encoder import (
            EncodeOptions as _EncOpts, _modular_frame_bytes,
        )
        from libjxl_torch.core.frame_header import FrameType
        from libjxl_torch.modular.image import (
            Channel as _Chan, ModularImage as _MImg,
        )
        from libjxl_torch.render.enc_patches import quantize_atlas_modular
        dcy_r = q_dc[:, :, 1].astype(np.float32) * mul_dc[1]
        dcx_r = q_dc[:, :, 0].astype(np.float32) * mul_dc[0]
        dcb_r = q_dc[:, :, 2].astype(np.float32) * mul_dc[2] + dcy_r
        chans, _ = quantize_atlas_modular(np.stack([dcx_r, dcy_r, dcb_r]))
        img_dc = _MImg(xb, yb, 32)
        for ch in chans:
            img_dc.channel.append(_Chan(np.ascontiguousarray(ch)))

        def _dc_customize(f):
            f.frame_type = FrameType.DC_FRAME
            f.dc_level = 1
            f.color_transform = ColorTransform.XYB

        dc_frame_bytes = _modular_frame_bytes(
            img_dc, _EncOpts(effort=3, use_rct=False, palette=0),
            meta, is_last=False, customize=_dc_customize)
        bw.write_bytes(dc_frame_bytes)

    fh = FrameHeader(encoding=FrameEncoding.VARDCT,
                     color_transform=ColorTransform.XYB)
    fh.upsampling = resample
    if alpha is not None and resample > 1:
        fh.extra_channel_upsampling = (ec_resample,)
    fh.is_last = options._is_last
    fh.animation_frame.duration = options._duration
    from libjxl_torch.core.frame_header import FrameFlags
    if patches_dict is not None:
        fh.flags |= FrameFlags.PATCHES
    if options.splines is not None:
        fh.flags |= FrameFlags.SPLINES
    if noise_lut is not None:
        fh.flags |= FrameFlags.NOISE
    if options.progressive_dc:
        fh.flags |= FrameFlags.USE_DC_FRAME
    fh.x_qm_scale = x_qm_scale
    if options.progressive:
        fh.passes.num_passes = 3
        fh.passes.shift = (2, 1, 0)
        fh.passes.num_downsample = 0
    elif options.qprogressive_ac:
        # progressive_passes_dc_quant_ac_full_ac: pass 0 suitable for
        # 2x-downsampled display (enc_frame.cc:272-277)
        fh.passes.num_passes = 2
        fh.passes.shift = (1, 0)
        fh.passes.num_downsample = 1
        fh.passes.downsample = (2,)
        fh.passes.last_pass = (0,)
    elif options.progressive_ac:
        # progressive_passes_dc_vlf_lf_full_ac (enc_frame.cc:264-271)
        fh.passes.num_passes = 3
        fh.passes.shift = (0, 0, 0)
        fh.passes.num_downsample = 2
        fh.passes.downsample = (4, 2)
        fh.passes.last_pass = (0, 1)
    fh.loop_filter.gab = use_gab
    # EPF iterations from distance (enc_frame.cc:333-342): 3 passes
    # (incl. EPF0's 5x5 diamond) from d >= 4
    fh.loop_filter.epf_iters = options.epf if options.epf >= 0 \
        else _epf_iters_for(d, options.faster_decoding)
    meta.nonserialized_xsize = full_w
    meta.nonserialized_ysize = full_h
    fh.visit(FieldWriter(bw), meta)

    # ---- sections --------------------------------------------------------
    def dc_global(sw: BitWriter) -> None:
        from libjxl_torch.api import stats as _st

        # image features come first (ProcessDCGlobal: patches, splines,
        # noise, then the quantizer state)
        if patches_dict is not None:
            from libjxl_torch.render.enc_patches import serialize_patches
            b0 = sw.bits_written
            serialize_patches(sw, patches_dict,
                              1 if alpha is not None else 0)
            _st.record("dictionary", sw.bits_written - b0)
            _st.record("quant", b0 - sw.bits_written)   # net out of quant
        if options.splines is not None:
            from libjxl_torch.render.splines import serialize_splines
            b0 = sw.bits_written
            serialize_splines(sw, options.splines)
            _st.record("splines", sw.bits_written - b0)
            _st.record("quant", b0 - sw.bits_written)
        if noise_lut is not None:
            b0 = sw.bits_written
            for v in noise_lut:
                sw.write(10, int(round(v * 1024)))
            _st.record("noise", sw.bits_written - b0)
            _st.record("quant", b0 - sw.bits_written)
        sw.write(1, 1)                       # DequantMatrices::DecodeDC def.
        write_u32(sw, _GLOBAL_SCALE_DIST, global_scale)
        write_u32(sw, _QUANT_DC_DIST, quant_dc_int)
        from libjxl_torch.vardct.ac_context import write_block_ctx_map
        write_block_ctx_map(sw, bctx)        # default = 1 bit
        sw.write(1, 1)                       # CfL DC default
        # modular global: no global tree. With extra channels present the
        # global image is non-empty, so a GroupHeader follows; channels
        # small enough (<= group_dim) are coded here, larger ones in the
        # per-group AC streams (dec_modular.cc:209-321).
        sw.write(1, 0)                       # has_global_tree = false
        if alpha is not None:
            from libjxl_torch.modular.codec import ModularOptions
            gi = ModularImage(w, h, bits_per_sample)
            gi.channel.append(Channel(alpha))
            modular_encode(sw, gi, group_id=0,
                           options=ModularOptions(
                               max_chan_size=fd.group_dim))

    def _dc_group_geom(g: int):
        gx = g % fd.xsize_dc_groups
        gy = g // fd.xsize_dc_groups
        x0, y0 = gx * fd.group_dim, gy * fd.group_dim   # in blocks
        bwd = min(fd.group_dim, xb - x0)
        bhd = min(fd.group_dim, yb - y0)
        return x0, y0, bwd, bhd

    def _dc_img(g: int) -> ModularImage:
        x0, y0, bwd, bhd = _dc_group_geom(g)
        img = ModularImage(bwd, bhd, 32)
        for src_c in (1, 0, 2):              # stream order [Y, X, B]
            img.channel.append(Channel(
                q_dc[y0:y0 + bhd, x0:x0 + bwd, src_c].copy()))
        return img

    def _am_img(g: int):
        """AC metadata stream image: ytox/ytob tiles, acs+qf entries per
        anchor in raster order, EPF sharpness field."""
        x0, y0, bwd, bhd = _dc_group_geom(g)
        a_sel = acs_anchors[y0:y0 + bhd, x0:x0 + bwd]
        count = int(a_sel.sum())
        cw = (bwd + 7) >> 3
        chh = (bhd + 7) >> 3
        tx0, ty0 = x0 >> 3, y0 >> 3
        am = ModularImage(bwd, bhd, 32)
        am.channel.append(Channel(
            ytox_map[ty0:ty0 + chh, tx0:tx0 + cw].copy(), 3, 3))
        am.channel.append(Channel(
            ytob_map[ty0:ty0 + chh, tx0:tx0 + cw].copy(), 3, 3))
        acs_qf = np.zeros((2, count), np.int32)
        acs_qf[0, :] = acs_map[y0:y0 + bhd, x0:x0 + bwd][a_sel]
        acs_qf[1, :] = raw_quant[y0:y0 + bhd, x0:x0 + bwd][a_sel] - 1
        am.channel.append(Channel(acs_qf))
        # EPF sharpness: per-block field from the AR search when set,
        # else the fast-tier constant 4 (enc_heuristics.cc:907)
        if options._sharpness_field is not None and \
                fh.loop_filter.epf_iters > 0:
            am.channel.append(Channel(np.ascontiguousarray(
                options._sharpness_field[y0:y0 + bhd, x0:x0 + bwd],
                np.int32)))
        else:
            sharp = 4 if fh.loop_filter.epf_iters > 0 else 0
            am.channel.append(Channel(
                np.full((bhd, bwd), sharp, np.int32)))
        return am, count, bwd * bhd

    # e>=5: learn MA trees over the DC channels and AC metadata — the
    # reference includes the VarDCT side streams in its modular tree
    # learning (enc_modular.cc AddVarDCTDC + AddACMetadata). The learns
    # are per-DC-group independent (numpy releases the GIL in the hot
    # reductions), so multi-group frames learn them on a thread pool.
    dc_tree_cache = options._aux.setdefault("dc_trees", {}) \
        if options._aux is not None else {}
    am_tree_cache: dict = {}

    def _learn_dc_tree(g: int) -> None:
        if g not in dc_tree_cache:
            dc_tree_cache[g] = _dc_stream_tree(
                _dc_img(g), 1 + g, PREDICTOR_GRADIENT, options.effort,
                kind="dc")

    def _learn_am_tree(g: int) -> None:
        am, _, _ = _am_img(g)
        am_tree_cache[g] = _dc_stream_tree(
            am, 1 + 2 * fd.num_dc_groups + g, PREDICTOR_ZERO,
            options.effort, kind="acmeta")

    if options.effort >= 5:
        from concurrent.futures import ThreadPoolExecutor
        tasks = [(_learn_am_tree, g) for g in range(fd.num_dc_groups)]
        if not options.progressive_dc:
            tasks += [(_learn_dc_tree, g)
                      for g in range(fd.num_dc_groups)]
        if len(tasks) > 1:
            with prof.stage("dc_trees"), \
                    ThreadPoolExecutor(min(8, len(tasks))) as ex:
                list(ex.map(lambda t: t[0](t[1]), tasks))

    def dc_group(sw: BitWriter, g: int) -> None:
        if not options.progressive_dc:
            # (with USE_DC_FRAME the DC-modular payload is absent;
            # frame_dec.py:161 mirror)
            sw.write(2, 0)                   # extra_precision = 0
            img = _dc_img(g)
            tree_dc = dc_tree_cache.get(g)
            if tree_dc is None:
                tree_dc = dc_tree_cache[g] = _dc_stream_tree(
                    img, 1 + g, PREDICTOR_GRADIENT, options.effort,
                    kind="dc")
            modular_encode(sw, img, group_id=1 + g, tree=tree_dc)
        # Modular DC group: no channels -> nothing.
        am, count, upper = _am_img(g)
        sw.write((upper - 1).bit_length() if upper > 1 else 0, count - 1)
        tree_am = am_tree_cache.get(g)
        if tree_am is None:
            tree_am = _dc_stream_tree(
                am, 1 + 2 * fd.num_dc_groups + g, PREDICTOR_ZERO,
                options.effort, kind="acmeta")
        modular_encode(sw, am, group_id=1 + 2 * fd.num_dc_groups + g,
                       tree=tree_am)

    def ac_global(sw: BitWriter) -> None:
        sw.write(1, 1)                       # dequant matrices all default
        nbits = max((fd.num_groups - 1).bit_length(), 0)
        if nbits:
            sw.write(nbits, 0)               # num_histograms - 1 = 0
        from libjxl_torch.vardct.coeff_order import encode_coeff_orders
        if native_tail is not None:
            encode_coeff_orders(sw, used_orders, order_perms)
            sw.append_packed(native_tail[0], native_tail[1])
            return
        for p in range(num_passes):
            encode_coeff_orders(sw, used_orders if p == 0 else 0,
                                order_perms)
            write_entropy_codes(sw, codes_per_pass[p])

    def ac_group(sw: BitWriter, g: int, p: int = 0) -> None:
        # histogram selector (dec_frame.cc:481): 0 bits when
        # num_histograms == 1; the streaming band layout passes the
        # band's set index + the full-frame selector width
        if options._stream_sel is not None:
            sel, sel_bits = options._stream_sel
            if sel_bits:
                sw.write(sel_bits, sel)
        if native_tail is not None:
            gb, gbits = native_tail[2][g]
            sw.append_packed(gb, gbits)
        else:
            t = group_tokens[p][g]
            arr = t if isinstance(t, np.ndarray) else \
                tokens_to_array(t) if len(t) else \
                np.zeros((0, 2), np.int64)
            write_tokens(sw, arr, codes_per_pass[p])
        # modular AC data (extra channels > group_dim) follows the tokens
        # (enc_group.cc EncodeGroup -> ModularFrameEncoder)
        if alpha is not None and (w > fd.group_dim or h > fd.group_dim):
            from libjxl_torch.modular.frame import (
                get_downsampling_bracket, stream_id_modular_ac,
            )
            mins, maxs = get_downsampling_bracket(fh.passes, p)
            if not (mins <= 0 <= maxs):
                return                       # shift-0 channel not in pass p
            gx = g % fd.xsize_groups
            gy = g // fd.xsize_groups
            x0, y0 = gx * fd.group_dim, gy * fd.group_dim
            gw_ = min(fd.group_dim, w - x0)
            gh_ = min(fd.group_dim, h - y0)
            gi = ModularImage(gw_, gh_, bits_per_sample)
            gi.channel.append(Channel(
                alpha[y0:y0 + gh_, x0:x0 + gw_].copy()))
            modular_encode(sw, gi,
                           group_id=stream_id_modular_ac(fd, g, p))

    from libjxl_torch.api import stats as _stats

    def section(*parts) -> bytes:
        sw = BitWriter()
        for fn, layer in parts:
            b0 = sw.bits_written
            with prof.stage("sec_" + layer):
                fn(sw)
            _stats.record(layer, sw.bits_written - b0)
        b0 = sw.bits_written
        sw.zero_pad_to_byte()
        _stats.record(parts[-1][1], sw.bits_written - b0)
        return sw.to_bytes()

    single = (fd.num_groups == 1 and num_passes == 1 and
              not options._sections_only)
    with prof.stage("write_sections"):
        if single:
            # one section: DCGlobal | DCGroup | ACGlobal | ACGroup,
            # continuous bits, padded only at the very end
            # (enc_frame.cc:1489-1492).
            sections = [section((dc_global, "quant"),
                                (lambda sw: dc_group(sw, 0), "dc"),
                                (ac_global, "ac_histogram"),
                                (lambda sw: ac_group(sw, 0), "ac"))]
        else:
            sections = [section((dc_global, "quant"))]
            for g in range(fd.num_dc_groups):
                sections.append(section(
                    (lambda sw, g=g: dc_group(sw, g), "dc")))
            sections.append(section((ac_global, "ac_histogram")))
            for p in range(num_passes):
                for g in range(fd.num_groups):
                    sections.append(section(
                        (lambda sw, g=g, p=p: ac_group(sw, g, p), "ac")))

    if options._sections_only:
        # streaming/multi-host band producer: hand back the per-section
        # bytes + this band's entropy codes; the caller assembles the
        # frame (headers, merged AC global, permuted TOC)
        return dict(sections=sections, codes=codes_per_pass[0],
                    num_dc_groups=fd.num_dc_groups,
                    num_groups=fd.num_groups)

    toc0 = bw.bits_written
    if options.group_order == 1 and len(sections) > 1:
        # center-first section order (cjxl --group_order/--center_*;
        # enc_frame.cc PermuteGlobalTOC): globals stay first, DC and AC
        # group sections are laid out by distance of the group center
        # from the requested point; the Lehmer-coded TOC permutation
        # maps the decoder back to spec order
        cx = options.center_x if options.center_x >= 0 else w // 2
        cy = options.center_y if options.center_y >= 0 else h // 2

        def center_order(n_groups, gdim, xsg):
            def dist(g):
                gx_, gy_ = g % xsg, g // xsg
                mx = min(max(cx, gx_ * gdim), gx_ * gdim + gdim - 1)
                my = min(max(cy, gy_ * gdim), gy_ * gdim + gdim - 1)
                return (mx - cx) ** 2 + (my - cy) ** 2
            return sorted(range(n_groups), key=dist)

        dc_ord = center_order(fd.num_dc_groups, fd.group_dim * 8,
                              fd.xsize_dc_groups)
        ac_ord = center_order(fd.num_groups, fd.group_dim,
                              fd.xsize_groups)
        file_logical = [0] + [1 + g for g in dc_ord] + \
            [1 + fd.num_dc_groups]
        base = 2 + fd.num_dc_groups
        for p_ in range(num_passes):
            file_logical += [base + p_ * fd.num_groups + g
                             for g in ac_ord]
        perm = np.zeros(len(sections), np.int64)
        for pos, logical in enumerate(file_logical):
            perm[logical] = pos
        sections = [sections[i] for i in file_logical]
        from libjxl_torch.core.toc import write_toc_permuted
        write_toc_permuted(bw, [len(s) for s in sections], perm)
    else:
        write_toc(bw, [len(s) for s in sections])
    if _stats.active() is not None:
        from libjxl_torch.vardct.ac_strategy import NAMES as _ACS_NAMES
        _stats.record("toc", bw.bits_written - toc0)
        # the reference-only patch atlas frame is accounted to the
        # dictionary layer, not the header layer
        _stats.record("dictionary", len(atlas_frame_bytes) * 8)
        _stats.record("header", toc0 - len(atlas_frame_bytes) * 8)
        _stats.record_count("num_base_pixels", full_w * full_h)
        _stats.record_count("num_ac_pixels", w * h)
        for s_id in np.unique(acs_map[acs_anchors]):
            _stats.add_blocks(_ACS_NAMES[int(s_id)],
                              int((acs_map[acs_anchors] == s_id).sum()))
    out = bytearray(bw.to_bytes())
    for s in sections:
        out.extend(s)
    return bytes(out)


def _tile_dist_map(diffmap: np.ndarray, acs: np.ndarray,
                   anchors: np.ndarray, h_w=None,
                   sums: np.ndarray | None = None) -> np.ndarray:
    """Per-block 16th-norm butteraugli distance, uniform over each ACS
    region (enc_adaptive_quantization.cc TileDistMap:768-833).

    ``sums``: optional precomputed per-8x8 sums of diffmap**16 (the
    device scorer's output), in which case ``diffmap`` may be None and
    ``h_w`` carries the image size."""
    yb, xb = acs.shape
    h, w = h_w if h_w is not None else diffmap.shape
    if sums is None:
        pad = np.zeros((yb * 8, xb * 8))
        pad[:h, :w] = diffmap
        v16 = (pad.astype(np.float64) ** 16).reshape(yb, 8, xb, 8)
        sums = v16.sum(axis=(1, 3))                  # per 8x8 tile
    cnt = np.zeros((yb * 8, xb * 8))
    cnt[:h, :w] = 1.0
    cnts = cnt.reshape(yb, 8, xb, 8).sum(axis=(1, 3))
    out = np.zeros((yb, xb))
    from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y
    by0, bx0 = np.nonzero(anchors)
    for by, bx in zip(by0, bx0):
        st = int(acs[by, bx])
        nby, nbx = COVERED_Y[st], COVERED_X[st]
        ssum = sums[by:by + nby, bx:bx + nbx].sum()
        spix = max(cnts[by:by + nby, bx:bx + nbx].sum(), 1.0)
        out[by:by + nby, bx:bx + nbx] = 1.2 * (ssum / spix) ** (1.0 / 16.0)
    return out


def _encode_lossy_iterated(pixels: np.ndarray, options: LossyOptions,
                           device=None) -> bytes:
    """FindBestQuantization (enc_adaptive_quantization.cc:929-1115):
    refine the quant field with roundtrips scored by the butteraugli
    diffmap (``metrics/butteraugli``, on ``device``).

    Like the reference's RoundtripImage/GetBlockFromEncoder
    (enc_adaptive_quantization.cc:840, dec_group.cc:662), iterations
    reconstruct straight from encoder state — the bitstream is emitted
    exactly once, after the field converges and the EPF sharpness
    search has run. Frames with image features (patches/splines/noise)
    take the legacy emit+decode loop, whose scoring includes the
    feature render stages."""
    import copy

    from libjxl_torch.vardct.enc_roundtrip import (
        reconstruct_prefilter, roundtrip_block_sums,
    )

    # our diffmap follows the current butteraugli model whose scale reads
    # higher than the classic scores at matched visual quality; calibrate
    # the loop target so output quality lands at the requested distance
    target = 1.22 * max(options.distance, 0.01)
    maxval = 65535.0 if pixels.dtype == np.uint16 else 255.0
    orig_lin = srgb_to_linear(
        np.moveaxis(pixels[:, :, :3].astype(np.float64) / maxval, -1, 0))

    from libjxl_torch.api import stats as _stats

    aux = {}
    base = copy.copy(options)
    base._aux = aux
    base.qf_override = None
    base._in_iteration = True
    base._recon_only = True
    # first pass computes the field + ACS; qf_override then pins ACS-
    # adjusted values (choose_acs maxing already mirrors AdjustQuantField)
    with prof.stage("first_pass"), _stats.suppress():
        encode_lossy(pixels, base, device=device)
    state = aux.pop("recon_state")
    if state["has_features"]:
        return _encode_lossy_iterated_legacy(pixels, options, aux, device)
    qf = aux["qf_field"].copy()
    init_qf = qf.copy()
    qf_ratio = max(init_qf.max() / max(init_qf.min(), 1e-9), 1.0)
    dev = min(np.sqrt(250.0 / qf_ratio), 2.0)
    asym = dev
    qf_lower = init_qf.min() / (asym * np.sqrt(250.0 / qf_ratio))
    qf_higher = init_qf.max() * (np.sqrt(250.0 / qf_ratio) / asym)

    fd = state["fd"]
    h, w = fd.ysize, fd.xsize
    if (h, w) != pixels.shape[:2]:
        # resampling: score in the downsampled frame space against the
        # downsampled opsin (the reference's heuristics likewise operate
        # on the downsampled image, enc_heuristics.cc:409-421)
        from libjxl_torch.color.xyb import xyb_to_linear
        orig_lin = np.clip(xyb_to_linear(
            np.asarray(aux["opsin"], np.float64)), 0.0, 1.0)
    orig_f32 = np.asarray(orig_lin, np.float32)
    # NB: the reference runs FindBestQuantization only at kitten (e8+)
    # (enc_adaptive_quantization.cc:1282 speed_tier <= kKitten); we keep
    # 2 iterations at e7 deliberately — measured BD-rate vs libjxl e7
    # flips from ~-2% (match-or-beat gate) to +4.4% on photos with 1
    # iteration and +4.8% with none, and the BASELINE quality target
    # outranks the per-image latency cost (the device loop makes an
    # iteration ~0.1 s, models/vardct_loop)
    iters = (6 if options.effort >= 11 else 5 if options.effort >= 10
             else 4 if options.effort >= 9 else 2)
    # use_device: the whole iteration body (requantize + recon + filter
    # + butteraugli) is ONE device program per step; only the field goes
    # up and the block-sum grid comes down (models/vardct_loop). The CfL
    # factor maps stay frozen at first-pass values inside the loop — the
    # final emit recomputes them exactly.
    ls = None
    if options.use_device:
        from libjxl_torch.models.vardct_loop import LoopState
        x_qm_mul = 1.25 ** (state["x_qm_scale"] - 2)
        orig_u8 = pixels[:, :, :3] if (
            pixels.dtype == np.uint8 and (h, w) == pixels.shape[:2]
            and options.color_encoding is None) else None
        ls = LoopState(state, aux, orig_f32, float(options.distance),
                       x_qm_mul, h, w, orig_u8=orig_u8, device=device)
    for i in range(iters):
        with prof.stage("loop_iter"):
            if ls is not None:
                sums = ls.block_sums(qf)
            else:
                sums = roundtrip_block_sums(state, orig_f32, h, w,
                                            device=device)
        tile = _tile_dist_map(None, aux["acs"], aux["anchors"],
                              h_w=(h, w), sums=sums)
        from libjxl_torch.utils import debug as _dbg
        if _dbg.active():
            _dbg.dump_image(f"tile_heatmap_iter{i}", tile)
        diff = tile / target
        scale = 16.0 / max(init_qf.max(), 1e-9)   # ~ one raw-quant step
        if i < 2:
            newqf = np.where(diff > 1.0, qf * diff, qf * diff ** 0.2)
        else:
            newqf = np.where(diff > 1.0, qf * diff, qf)
        # minimum bump where an increase was requested but rounds equal
        bump = (diff > 1.0) & (np.rint(newqf * scale) ==
                               np.rint(qf * scale))
        newqf = np.where(bump, qf + 1.0 / scale, newqf)
        qf = np.clip(newqf, qf_lower, qf_higher)
        if i == 1:
            # don't let the field drop far below the initial guess
            clamp = 0.4 * qf + 0.6 * init_qf
            qf = np.where(qf < clamp, np.minimum(
                np.maximum(clamp, qf_lower), qf_higher), qf)
        _stats.record_count("num_butteraugli_iters", 1)
        if ls is None:
            it = copy.copy(base)
            it.qf_override = qf
            with _stats.suppress():
                encode_lossy(pixels, it, device=device)
            state = aux.pop("recon_state")

    # EPF sharpness search (ComputeARHeuristics, enc_heuristics.cc:
    # 892-1018) on the converged reconstruction; the field doesn't
    # change coefficients, so the single emit below carries it
    field = None
    if options.distance >= 0.5:
        with prof.stage("epf_search"):
            if ls is not None:
                from libjxl_torch.models.vardct_loop import state_lf
                xyb_pre, rdec = ls.recon_prefilter(qf)
                lf = state_lf(state)
            else:
                xyb_pre, rdec, lf = reconstruct_prefilter(state)
            field = _epf_sharpness_search_state(
                xyb_pre, rdec, lf, aux.get("opsin"), options.distance,
                device)
    emit = copy.copy(options)
    emit.qf_override = qf
    emit._aux = aux
    emit._in_iteration = True
    if field is not None:
        emit._sharpness_field = field
    with prof.stage("final_emit"):
        return encode_lossy(pixels, emit, device=device)


def _encode_lossy_iterated_legacy(pixels: np.ndarray,
                                  options: LossyOptions,
                                  aux: dict, device=None) -> bytes:
    """Emit+decode butteraugli loop for feature-bearing frames: the
    roundtrip goes through the full decoder so patches/splines/noise
    render stages participate in the scoring."""
    import copy

    from libjxl_torch.api.decoder import decode
    from libjxl_torch.metrics.butteraugli import butteraugli_diffmap

    target = 1.22 * max(options.distance, 0.01)
    maxval = 65535.0 if pixels.dtype == np.uint16 else 255.0
    orig_lin = srgb_to_linear(
        np.moveaxis(pixels[:, :, :3].astype(np.float64) / maxval, -1, 0))

    from libjxl_torch.api import stats as _stats

    base = copy.copy(options)
    base._aux = aux
    base.qf_override = None
    base._in_iteration = True
    with _stats.suppress():
        data = encode_lossy(pixels, base, device=device)
    qf = aux["qf_field"].copy()
    init_qf = qf.copy()
    qf_ratio = max(init_qf.max() / max(init_qf.min(), 1e-9), 1.0)
    dev = min(np.sqrt(250.0 / qf_ratio), 2.0)
    asym = dev
    qf_lower = init_qf.min() / (asym * np.sqrt(250.0 / qf_ratio))
    qf_higher = init_qf.max() * (np.sqrt(250.0 / qf_ratio) / asym)

    iters = (6 if options.effort >= 11 else 5 if options.effort >= 10
             else 4 if options.effort >= 9 else 2)
    for i in range(iters):
        dec = decode(data, device=device)
        dec_lin = srgb_to_linear(
            np.moveaxis(dec[:, :, :3].astype(np.float64) / maxval, -1, 0))
        dm = butteraugli_diffmap(
            np.asarray(orig_lin, np.float32),
            np.asarray(dec_lin, np.float32), hf_asymmetry=0.8,
            device=device).cpu().numpy()
        tile = _tile_dist_map(dm, aux["acs"], aux["anchors"])
        diff = tile / target
        scale = 16.0 / max(init_qf.max(), 1e-9)   # ~ one raw-quant step
        if i < 2:
            newqf = np.where(diff > 1.0, qf * diff, qf * diff ** 0.2)
        else:
            newqf = np.where(diff > 1.0, qf * diff, qf)
        # minimum bump where an increase was requested but rounds equal
        bump = (diff > 1.0) & (np.rint(newqf * scale) ==
                               np.rint(qf * scale))
        newqf = np.where(bump, qf + 1.0 / scale, newqf)
        qf = np.clip(newqf, qf_lower, qf_higher)
        if i == 1:
            # don't let the field drop far below the initial guess
            clamp = 0.4 * qf + 0.6 * init_qf
            qf = np.where(qf < clamp, np.minimum(
                np.maximum(clamp, qf_lower), qf_higher), qf)
        it = copy.copy(options)
        it.qf_override = qf
        it._aux = aux
        it._in_iteration = True
        _stats.record_count("num_butteraugli_iters", 1)
        last = i == iters - 1
        if last and options.distance >= 0.5:
            with _stats.suppress():
                data = encode_lossy(pixels, it, device=device)
            # EPF sharpness search (ComputeARHeuristics,
            # enc_heuristics.cc:892-1018) on the converged stream; the
            # sharpness field doesn't change coefficients, so one final
            # re-encode emits it
            field = _epf_sharpness_search(data, aux.get("opsin"),
                                          options.distance, device)
            if field is not None:
                it = copy.copy(it)
                it._sharpness_field = field
            data = encode_lossy(pixels, it, device=device)
        elif last:                  # only the emitted stream's bits count
            data = encode_lossy(pixels, it, device=device)
        else:
            with _stats.suppress():
                data = encode_lossy(pixels, it, device=device)
    return data


def _epf_sharpness_search(data: bytes, orig_xyb, d: float, device=None):
    """Per-block EPF sharpness selection (enc_heuristics.cc:892-1018
    ComputeARHeuristics): decode the stream up to the filters once,
    re-run gaborish+EPF locally per candidate uniform sharpness, pick
    per block by weighted L2 error with neighbor hysteresis, then
    re-pick with context-frequency multipliers (the entropy-aware
    second pass). Returns the (yb, xb) field or None when EPF is off
    or nothing beats the default."""
    if orig_xyb is None:
        return None
    from libjxl_torch.api.decoder import _decode_prefilter
    xyb, dec, lf = _decode_prefilter(data)
    return _epf_sharpness_search_state(xyb, dec, lf, orig_xyb, d, device)


def _epf_sharpness_search_state(xyb, dec, lf, orig_xyb, d: float,
                                device=None):
    """Sharpness search body operating on a pre-filter reconstruction +
    decoder state — fed either by a real decode (_decode_prefilter) or
    by the encoder-side roundtrip (enc_roundtrip.reconstruct_prefilter),
    mirroring how ComputeARHeuristics runs on encoder state."""
    if orig_xyb is None:
        return None
    if lf.epf_iters == 0:
        return None
    from libjxl_torch.vardct.enc_roundtrip import epf_candidate_errs
    steps = [0, 4] if d > 4.5 else [0, 2, 7]
    yb, xb = dec.epf_sharpness.shape
    grids = epf_candidate_errs(xyb, dec, lf, orig_xyb, tuple(steps),
                               device=device)
    err = {s: grids[i] for i, s in enumerate(steps)}
    lut = {s: i for i, s in enumerate(steps)}
    favor_none = 0.99                               # kFavorNoSmoothing
    out = np.zeros((yb, xb), np.int32)
    histo = np.zeros((9, 8), np.int64)
    totals = np.ones(9, np.int64)
    for by in range(yb):
        for bx in range(xb):
            top = int(out[by - 1, bx]) if by else 0
            left = int(out[by, bx - 1]) if bx else 0
            bv, be = 0, np.inf
            for s in steps:
                e = err[s][by, bx] * (favor_none if s == 0 else 1.0)
                if e < be:
                    bv, be = s, e
            te, le = err[top][by, bx], err[left][by, bx]
            if be < min(te, le):
                out[by, bx] = bv
            elif te < le:
                out[by, bx] = top
            else:
                out[by, bx] = left
            ctx = lut[top] * 3 + lut[left]
            histo[ctx, out[by, bx]] += 1
            totals[ctx] += 1
    # context-frequency multipliers (:979-997)
    cb = max(0.85970338919928291,
             0.98017198824148288 ** min(5.0, d))
    c5 = 0.1087690359555803
    clamped = min(5.0, max(d, 1e-3))
    mul = {}
    for tv in steps:
        for lv in steps:
            ctx = lut[tv] * 3 + lut[lv]
            for s in steps:
                m = 1.0 / (1.0 + c5 * np.log1p(
                    histo[ctx, s] / totals[ctx]) / clamped)
                mul[(ctx, s)] = m * (cb if s == 0 else 1.0)
    for by in range(yb):
        for bx in range(xb):
            top = int(out[by - 1, bx]) if by else 0
            left = int(out[by, bx - 1]) if bx else 0
            ctx = lut[top] * 3 + lut[left]
            bv, be = 0, np.inf
            for s in steps:
                e = err[s][by, bx] * mul[(ctx, s)]
                if e < be:
                    bv, be = s, e
            out[by, bx] = bv
    return out


def encode_lossy_animation(frames, durations=None,
                           options: LossyOptions | None = None,
                           tps: tuple = (10, 1),
                           num_loops: int = 0) -> bytes:
    """Encode a lossy (VarDCT) animation: REPLACE-blended regular frames
    with per-frame durations (frame_header.h animation semantics; the
    reference's default animation path in enc_frame.cc)."""
    import copy

    options = options or LossyOptions()
    if not frames:
        raise ValueError("animation needs at least one frame")
    first = frames[0]
    if any(f.shape != first.shape or f.dtype != first.dtype
           for f in frames):
        raise ValueError("all frames must have the same shape and dtype")
    from libjxl_torch.core.headers import AnimationHeader
    anim = AnimationHeader(tps_numerator=tps[0], tps_denominator=tps[1],
                           num_loops=num_loops)
    if durations is None:
        durations = [1] * len(frames)
    out = bytearray()
    for i, (f, dur) in enumerate(zip(frames, durations)):
        o = copy.copy(options)
        o._animation = anim
        o._is_last = (i == len(frames) - 1)
        o._duration = int(dur)
        o._emit_headers = (i == 0)
        out.extend(encode_lossy(f, o))
    return bytes(out)


def encode_lossy_many(images, options: LossyOptions | None = None,
                      workers: int = 3, device=None) -> list[bytes]:
    """Serving-mode lossy encode of a batch of images.

    Device path (``use_device`` at effort <= 4): same-shape uint8 RGB
    images run the device program in chunks of 4 on ``device``
    (``models/vardct_pipeline.encode_lossy_frame_device_batch``: one
    program and one fetch of each payload array a chunk); the host
    halves (context modeling + rANS emission) of a chunk run on a small
    thread pool while the device computes the next chunk. Images of
    other shapes are dispatched one by one, then finished on the pool.
    The reference instead parallelizes WITHIN one image (enc_frame.cc
    group loop); a serving host gets more from stream-level overlap.

    At effort >= 5 (and without ``use_device``) each image's whole encode
    runs once, on the ``workers`` threads, with its device stages (and
    the effort >= 7 scorer) on ``device``. (The reference encodes every
    such image twice with ``use_device``: once in its serial dispatch
    phase, whose bytes it drops, and again on its pool.)"""
    import copy
    from concurrent.futures import ThreadPoolExecutor

    if not images:
        return []
    if options is not None and options.use_device and options.effort <= 4:
        d_eff = max(options.distance, 0.01)
        resample_one = (int(options.resampling) == 1 or
                        (int(options.resampling) <= 0 and d_eff < 10.0))
        batchable = (
            len(images) > 1 and options.effort <= 4 and
            options.color_encoding is None and
            not isinstance(options.noise, str) and
            options.qf_override is None and resample_one and
            len({im.shape for im in images}) == 1 and
            images[0].dtype == np.uint8 and images[0].shape[2] == 3)

        def _finish(im, payload):
            if isinstance(payload, bytes):
                return payload       # encoded whole on the host
            o = copy.copy(options)
            o._predispatched = payload
            return encode_lossy(im, o, device=device)

        if batchable:
            from libjxl_torch.models.vardct_pipeline import \
                encode_lossy_frame_device_batch
            s = _falcon_device_scalars(images[0].shape, options)
            (qac_f, inv_qac_f, table, th_y, th_xb, mul_dc,
             h, w, yb, xb, x_qm_mul) = s
            chunk = 4
            futs = []
            with ThreadPoolExecutor(max(1, workers)) as ex:
                for c0 in range(0, len(images), chunk):
                    ch = images[c0:c0 + chunk]
                    with prof.stage("batch_device"):
                        payloads = encode_lossy_frame_device_batch(
                            np.stack(ch), qac_f, inv_qac_f, table, th_y,
                            th_xb, mul_dc, h=h, w=w, yb=yb, xb=xb,
                            x_qm_mul=x_qm_mul, device=device)
                    futs += [ex.submit(_finish, im, p)
                             for im, p in zip(ch, payloads)]
                return [f.result() for f in futs]
        disp = copy.copy(options)
        disp._dispatch_only = True
        pending = [encode_lossy(im, disp, device=device) for im in images]
        with ThreadPoolExecutor(max(1, workers)) as ex:
            return list(ex.map(_finish, images, pending))
    with ThreadPoolExecutor(max(1, workers)) as ex:
        return list(ex.map(
            lambda im: encode_lossy(im, options, device=device), images))


def _falcon_device_scalars(shape, options: LossyOptions):
    """The e<=4 device program's image-independent inputs (constant
    quant field): (qac, inv_qac, table, thres_y, thres_xb, mul_dc,
    h, w, yb, xb, x_qm_mul). Must mirror the encode_lossy e<=4 branch
    exactly — the per-image host finish recomputes them and the two
    must agree."""
    from libjxl_torch.vardct.adaptive_quant import (
        compute_scale_from_quant, initial_quant_dc,
    )
    h, w = shape[:2]
    d = max(options.distance, 0.01)
    fd = FrameDimensions(w, h, 256)
    yb, xb = fd.ysize_blocks, fd.xsize_blocks
    quant_dc_f = initial_quant_dc(d)
    qf_field = np.full((yb, xb), 0.70 / d, np.float32)
    global_scale, quant_dc_int, raw_quant = compute_scale_from_quant(
        quant_dc_f, 0.70 / d, qf_field)
    quantizer = Quantizer(global_scale, quant_dc_int)
    matrices = DequantMatrices()
    x_qm_scale = 3
    for step in (2.5, 5.5, 9.5):
        if d > step:
            x_qm_scale += 1
    x_qm_mul = 1.25 ** (x_qm_scale - 2)
    mul_dc = quantizer.mul_dc(matrices.dc_quant)
    qac_f = quantizer.scale * raw_quant.astype(np.float32)
    inv_qac_f = quantizer.inv_global_scale / raw_quant.astype(np.float32)
    table = matrices.tables[0].reshape(3, 64).astype(np.float32)

    def _thres(t0, t_rest):
        th = np.full((8, 8), t_rest, np.float32)
        th[:4, :4] = t0
        th[0, 0] = 0.0
        return th.reshape(64)

    return (qac_f, inv_qac_f, table, _thres(0.56, 0.62),
            _thres(0.58, 0.62), np.asarray(mul_dc, np.float32),
            h, w, yb, xb, x_qm_mul)


def _tokenize_group_dct8(qp: np.ndarray, order: np.ndarray,
                         bctx: BlockCtxMap, qf: np.ndarray) -> np.ndarray:
    """Vectorized mirror of DecodeACVarBlock over a whole group of DCT8
    blocks (enc_entropy_coder.cc:153): one (N, 2) token array covering
    every (block, channel) in the group's raster/channel order.

    The scalar form (`_tokenize_block`) costs ~0.25 s per MP in the
    profile; here the nzeros prediction, zero-density contexts and
    emit masks are all computed as (gh, gw, 3, 63) array ops."""
    from libjxl_torch.vardct.ac_context import (
        K_COEFF_FREQ_CONTEXT, K_COEFF_NUM_NONZERO_CONTEXT,
        K_NONZERO_BUCKETS, K_ZERO_DENSITY_CONTEXT_COUNT, NUM_ORDERS,
    )
    gh, gw = qp.shape[:2]
    # block context / zero-density offsets (shared with the native path)
    qf_idx0 = np.searchsorted(np.asarray(bctx.qf_thresholds, np.int64),
                              qf.astype(np.int64), side="left") \
        if bctx.qf_thresholds else np.zeros((gh, gw), np.int64)
    cidx0 = np.array([1, 0, 2], np.int64)
    idx0 = (cidx0[None, None] * NUM_ORDERS) * \
        (len(bctx.qf_thresholds) + 1) + qf_idx0[:, :, None]
    idx0 = idx0 * bctx.num_dc_ctxs
    bctx_map = np.asarray(bctx.ctx_map, np.int64)[idx0]  # (gh, gw, 3)
    hoff = bctx.num_ctxs * K_NONZERO_BUCKETS + \
        K_ZERO_DENSITY_CONTEXT_COUNT * bctx_map
    from libjxl_torch.utils import native
    if native.available():
        out = native.tokenize_dct8(
            qp, order, bctx_map, hoff, bctx.num_ctxs,
            np.asarray(K_COEFF_NUM_NONZERO_CONTEXT, np.int32),
            np.asarray(K_COEFF_FREQ_CONTEXT, np.int32))
        if out is not None:
            return out
    vals = qp[:, :, :, order[1:]].astype(np.int64)       # (gh, gw, 3, 63)
    m = vals != 0
    nzeros = m.sum(-1, dtype=np.int64)                   # (gh, gw, 3)
    # nzeros prediction from already-coded neighbours (same group)
    up = np.empty_like(nzeros)
    up[0] = 32
    up[1:] = nzeros[:-1]
    left = np.empty_like(nzeros)
    left[:, 0] = 0
    left[:, 1:] = nzeros[:, :-1]
    predicted = (up + left + 1) >> 1
    predicted[:, 0] = up[:, 0]                           # bx==0: up or 32
    if gh > 0:
        predicted[0, 1:] = left[0, 1:]                   # by==0: left
    # block context: c, qf thresholds (ord_=0, dc_idx=0)
    qf_idx = np.searchsorted(np.asarray(bctx.qf_thresholds, np.int64),
                             qf.astype(np.int64), side="left") \
        if bctx.qf_thresholds else np.zeros((gh, gw), np.int64)
    cidx = np.array([1, 0, 2], np.int64)                 # c ^ 1 | 2
    idx = (cidx[None, None] * NUM_ORDERS) * \
        (len(bctx.qf_thresholds) + 1) + qf_idx[:, :, None]
    idx = idx * bctx.num_dc_ctxs
    block_ctx = np.asarray(bctx.ctx_map, np.int64)[idx]  # (gh, gw, 3)
    nzb = np.where(predicted < 8, predicted, 4 + predicted // 2)
    nz_ctx = nzb * bctx.num_ctxs + block_ctx
    nz_val = nzeros
    # zero-density coefficient tokens
    histo_offset = bctx.num_ctxs * K_NONZERO_BUCKETS + \
        K_ZERO_DENSITY_CONTEXT_COUNT * block_ctx         # (gh, gw, 3)
    prev0 = (nzeros <= 4).astype(np.int64)               # 0 if nzeros>4
    prev = np.empty(vals.shape, np.int64)
    prev[..., 0] = prev0
    prev[..., 1:] = m[..., :-1]
    cums = np.cumsum(m, axis=-1, dtype=np.int64)
    rem = nzeros[..., None] - (cums - m)                 # left before pos
    emit = rem > 0
    knz = np.asarray(K_COEFF_NUM_NONZERO_CONTEXT, np.int64)
    kfr = np.asarray(K_COEFF_FREQ_CONTEXT, np.int64)
    ctx = histo_offset[..., None] + \
        (knz[np.where(emit, rem, 0)] + kfr[None, None, None, 1:64]) * 2 + \
        prev
    tok_val = np.where(vals >= 0, vals << 1, ((-vals) << 1) - 1)
    # assemble: (gh, gw, 3[c-order 1,0,2], 64) rows, masked flatten
    corder = np.array([1, 0, 2])
    all_ctx = np.concatenate(
        [nz_ctx[:, :, corder, None], ctx[:, :, corder]], axis=-1)
    all_val = np.concatenate(
        [nz_val[:, :, corder, None], tok_val[:, :, corder]], axis=-1)
    mask = np.concatenate(
        [np.ones((gh, gw, 3, 1), bool), emit[:, :, corder]], axis=-1)
    out = np.empty((int(mask.sum()), 2), np.int64)
    out[:, 0] = all_ctx[mask]
    out[:, 1] = all_val[mask]
    return out


def _tokenize_block(toks, qcoef, order, nz, bx, by, bctx: BlockCtxMap,
                    qf: int, c: int) -> None:
    """Mirror of DecodeACVarBlock for DCT8 (enc_entropy_coder.cc:153)."""
    vals = qcoef[order[1:]]
    nzeros = int(np.count_nonzero(vals))
    if bx == 0:
        predicted = nz[by - 1, bx] if by > 0 else 32
    elif by == 0:
        predicted = nz[by, bx - 1]
    else:
        predicted = (nz[by - 1, bx] + nz[by, bx - 1] + 1) // 2
    nz[by, bx] = nzeros
    block_ctx = bctx.context(0, qf, 0, c)
    toks.append((bctx.nonzero_context(int(predicted), block_ctx), nzeros))
    if nzeros == 0:
        return
    histo_offset = bctx.zero_density_offset(block_ctx)
    prev = 0 if nzeros > 4 else 1
    left = nzeros
    for k in range(1, 64):
        v = int(vals[k - 1])
        ctx = histo_offset + zero_density_context(left, k, 1, 0, prev)
        toks.append((ctx, pack_signed(v)))
        prev = 1 if v else 0
        left -= prev
        if left == 0:
            break


def _lossy_band_sections(pixels, dcy: int, options, sel_bits: int):
    """Produce one DC-group row band's self-contained sections
    (streaming VarDCT; enc_frame.cc:2045-2160). Returns the dict from
    encode_lossy(_sections_only): band DCGlobal + DC-group sections +
    band ACGlobal (discarded) + AC-group sections, plus the band's
    entropy codes. All products are block/tile-local at effort <= 4,
    so encoding the cropped band equals the full-frame restriction."""
    import copy
    band = np.asarray(pixels[dcy * 2048:(dcy + 1) * 2048])
    o = copy.copy(options)
    o._sections_only = True
    o._stream_sel = (dcy, sel_bits)
    o._emit_headers = False
    return encode_lossy(band, o)


def _merged_stream_ac_global(codes_list, fd) -> bytes:
    """ACGlobal with one histogram SET per DC-group row band
    (enc_frame.cc:2074 shared.num_histograms): the per-band cluster
    tables are concatenated and the context map covers
    num_sets * num_ac_contexts contexts; each AC group section selects
    its band's set with the TOC-independent selector bits."""
    from libjxl_torch.entropy.ans import (
        EntropyEncodingData, write_entropy_codes,
    )
    from libjxl_torch.vardct.coeff_order import encode_coeff_orders

    sw = BitWriter()
    sw.write(1, 1)                       # dequant matrices all default
    nbits = max((fd.num_groups - 1).bit_length(), 0)
    if nbits:
        sw.write(nbits, len(codes_list) - 1)
    encode_coeff_orders(sw, 0, {})       # natural orders (e<=4 tiers)
    merged = EntropyEncodingData()
    merged.use_prefix_code = False
    merged.log_alpha_size = 8
    merged.histo_shift = codes_list[0].histo_shift
    cm = []
    base = 0
    for c in codes_list:
        cm.append(np.asarray(c.context_map, np.int64) + base)
        merged.counts.extend(c.counts)
        merged.uint_configs.extend(c.uint_configs)
        base += c.num_histograms
    if base > 255:
        raise ValueError("merged cluster count exceeds 256; lower "
                         "max_clusters or band count")
    merged.context_map = np.concatenate(cm).astype(np.int32)
    merged.num_histograms = base
    write_entropy_codes(sw, merged)
    sw.zero_pad_to_byte()
    return sw.to_bytes()


def _streaming_lossy_check(pixels, options) -> None:
    if options.effort > 4:
        raise ValueError("streaming VarDCT encode supports effort <= 4 "
                         "(band-local heuristics); got effort "
                         f"{options.effort}")
    if pixels.ndim != 3 or pixels.shape[2] != 3 or \
            pixels.dtype != np.uint8:
        raise ValueError("streaming VarDCT encode expects (h, w, 3) "
                         "uint8")
    if options.use_device or options.resampling not in (0, 1) or \
            options.progressive or options.progressive_ac or \
            options.qprogressive_ac or options.progressive_dc or \
            options.noise is not None or options.splines is not None:
        raise ValueError("streaming VarDCT encode: unsupported option")


def _stream_headers_and_frame(pixels, options):
    """Codestream headers + frame header bits for the streaming layout;
    mirrors encode_lossy's header branch for the supported option set."""
    from libjxl_torch.core.headers import (
        CustomTransformData, ImageMetadata, SizeHeader, write_bundle,
        write_signature,
    )

    h, w, _ = pixels.shape
    bw = BitWriter()
    meta = ImageMetadata(xyb_encoded=True,
                         bit_depth=BitDepth(bits_per_sample=8),
                         color_encoding=(options.color_encoding or
                                         ColorEncoding.srgb(gray=False)))
    write_signature(bw)
    size = SizeHeader()
    size.set(w, h)
    write_bundle(bw, size)
    write_bundle(bw, meta)
    ctd = CustomTransformData()
    ctd.xyb_encoded = True
    write_bundle(bw, ctd)
    bw.zero_pad_to_byte()
    meta.nonserialized_xsize = w
    meta.nonserialized_ysize = h
    d = max(options.distance, 0.01)
    fh = FrameHeader(encoding=FrameEncoding.VARDCT,
                     color_transform=ColorTransform.XYB)
    fh.is_last = True
    x_qm_scale = 3
    for step in (2.5, 5.5, 9.5):
        if d > step:
            x_qm_scale += 1
    fh.x_qm_scale = x_qm_scale
    fh.loop_filter.gab = False           # effort <= 4: no gaborish
    fh.loop_filter.epf_iters = options.epf if options.epf >= 0 \
        else _epf_iters_for(d, options.faster_decoding)
    fh.visit(FieldWriter(bw), meta)
    return bw, FrameDimensions(w, h, 256)


def _stream_assemble(bw, fd, dc_global: bytes, ac_global: bytes,
                     band_secs: list) -> bytes:
    """TOC permutation (ComputePermutationForStreaming,
    enc_frame.cc:1867) + section bytes: file order is [DCGlobal,
    ACGlobal, band 0 sections, band 1 sections, ...]."""
    from libjxl_torch.core.toc import write_toc_permuted

    num_dc = fd.num_dc_groups
    n_sections = 2 + num_dc + fd.num_groups
    perm = np.zeros(n_sections, np.int64)
    file_sections = [dc_global, ac_global]
    perm[0] = 0
    perm[1 + num_dc] = 1
    pos = 2
    for dcy, (dcs, acs) in enumerate(band_secs):
        for dcx, sec in enumerate(dcs):
            perm[1 + dcy * fd.xsize_dc_groups + dcx] = pos
            file_sections.append(sec)
            pos += 1
        g0 = dcy * 8 * fd.xsize_groups
        for i, sec in enumerate(acs):
            perm[2 + num_dc + g0 + i] = pos
            file_sections.append(sec)
            pos += 1
    write_toc_permuted(bw, [len(s) for s in file_sections], perm)
    out = bytearray(bw.to_bytes())
    for s in file_sections:
        out.extend(s)
    return bytes(out)


def encode_lossy_streaming(pixels: np.ndarray,
                           options: LossyOptions | None = None) -> bytes:
    """Spec streaming VarDCT encode (EncodeFrameStreaming,
    enc_frame.cc:2045): DC-group row bands are encoded independently
    with per-band AC histogram sets, laid out band-major behind a
    Lehmer-coded TOC permutation. Encoder pixel state is bounded by one
    2048-row band; the output of the multi-host sharded encoder
    (parallel/multihost.encode_lossy_multihost) is byte-identical."""
    options = options or LossyOptions()
    pixels = np.asarray(pixels)
    _streaming_lossy_check(pixels, options)
    bw, fd = _stream_headers_and_frame(pixels, options)
    nbands = fd.ysize_dc_groups
    sel_bits = (nbands - 1).bit_length() if nbands > 1 else 0
    dc_global = None
    band_secs = []
    codes_list = []
    for dcy in range(nbands):
        res = _lossy_band_sections(pixels, dcy, options, sel_bits)
        secs = res["sections"]
        nb_dc = res["num_dc_groups"]
        if dcy == 0:
            dc_global = secs[0]
        band_secs.append((secs[1:1 + nb_dc], secs[2 + nb_dc:]))
        codes_list.append(res["codes"])
    ac_global = _merged_stream_ac_global(codes_list, fd)
    return _stream_assemble(bw, fd, dc_global, ac_global, band_secs)
