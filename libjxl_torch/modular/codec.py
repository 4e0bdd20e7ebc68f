"""Modular generic codec: GroupHeader + per-channel MA/ANS coding
(reference ``lib/jxl/modular/encoding/encoding.cc``,
``enc_encoding.cc``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from libjxl_torch.core.fields import (
    BitsOffset, FieldReader, FieldWriter, FormatError, Val,
)
from libjxl_torch.core.headers import unpack_signed, pack_signed
from libjxl_torch.entropy.ans import (
    ANSSymbolReader, LZ77Params, build_entropy_codes, decode_histograms,
    tokens_to_array, write_entropy_codes, write_tokens,
)
from libjxl_torch.modular.image import Channel, ModularImage
from libjxl_torch.modular.predict import (
    EXTRA_PROPS_PER_CHANNEL, NUM_NONREF_PROPERTIES, PREDICTOR_GRADIENT,
    PREDICTOR_LEFT, PREDICTOR_TOP,
    PREDICTOR_WEIGHTED, PREDICTOR_ZERO, WPHeader, WPState, clamped_gradient,
    compute_properties_scalar, predict_one, wrap32, _neighbors,
)
from libjxl_torch.modular.transforms import Transform
from libjxl_torch.modular.tree import TreeNode, decode_tree, write_tree, \
    max_property_used
from libjxl_torch.utils.bits import BitReader, BitWriter


@dataclass
class GroupHeader:
    """(encoding.h:32-55)."""

    use_global_tree: bool = False
    wp_header: WPHeader = field(default_factory=WPHeader)
    transforms: list = field(default_factory=list)

    def read(self, r: BitReader) -> None:
        v = FieldReader(r)
        self.use_global_tree = v.bool()
        self.wp_header.visit(v)
        n = v.u32(Val(0), Val(1), BitsOffset(4, 2), BitsOffset(8, 18))
        self.transforms = [Transform() for _ in range(n)]
        for t in self.transforms:
            t.visit(v)

    def write(self, w: BitWriter) -> None:
        v = FieldWriter(w)
        v.bool(self.use_global_tree)
        self.wp_header.visit(v)
        v.u32(Val(0), Val(1), BitsOffset(4, 2), BitsOffset(8, 18),
              len(self.transforms))
        for t in self.transforms:
            t.visit(v)


@dataclass
class ModularOptions:
    max_chan_size: int = 0xFFFFFF
    group_dim: int = 0x7FFFFFFF


def _compute_references(image: ModularImage, chan_idx: int, y: int,
                        num_extra: int) -> np.ndarray:
    """Per-row reference properties (context_predict.h
    PrecomputeReferences); returns (w, num_extra) int64."""
    ch = image.channel[chan_idx]
    refs = np.zeros((ch.w, num_extra), dtype=np.int64)
    offset = 0
    for j in range(chan_idx - 1, -1, -1):
        if offset >= num_extra:
            break
        rch = image.channel[j]
        if rch.w != ch.w or rch.h != ch.h or rch.hshift != ch.hshift or \
                rch.vshift != ch.vshift:
            continue
        rpp = rch.plane[y].astype(np.int64)
        rpprev = rch.plane[y - 1].astype(np.int64) if y else rpp
        v = rpp
        vleft = np.concatenate(([0], rpp[:-1]))
        vtop = rpprev if y else vleft
        vtopleft = np.concatenate(([vleft[0]], rpprev[:-1])) if y else vleft
        # clamped gradient vectorized
        m = np.minimum(vleft, vtop)
        M = np.maximum(vleft, vtop)
        grad = vleft + vtop - vtopleft
        vpred = np.where(vtopleft < m, M, np.where(vtopleft > M, m, grad))
        # PropertyVal (int32) wrap for 32-bit content
        refs[:, offset] = np.abs(v).astype(np.int32)
        refs[:, offset + 1] = v.astype(np.int32)
        refs[:, offset + 2] = np.abs(v - vpred).astype(np.int32)
        refs[:, offset + 3] = (v - vpred).astype(np.int32)
        offset += EXTRA_PROPS_PER_CHANNEL
    return refs


def _reference_planes(image: ModularImage, chan_idx: int, num_refs: int,
                      h: int, w: int) -> np.ndarray:
    """Whole-plane form of _compute_references for the native decode
    path: (num_refs, h, w) int32."""
    out = np.zeros((num_refs, h, w), np.int32)
    ch = image.channel[chan_idx]
    offset = 0
    for j in range(chan_idx - 1, -1, -1):
        if offset >= num_refs:
            break
        rch = image.channel[j]
        if rch.w != ch.w or rch.h != ch.h or rch.hshift != ch.hshift or \
                rch.vshift != ch.vshift:
            continue
        v = rch.plane.astype(np.int64)
        vleft = np.empty_like(v)
        vleft[:, 1:] = v[:, :-1]
        vleft[:, 0] = 0
        vtop = np.empty_like(v)
        vtop[1:] = v[:-1]
        vtop[0] = vleft[0]
        vtopleft = np.empty_like(v)
        vtopleft[1:, 1:] = v[:-1, :-1]
        vtopleft[0] = vleft[0]
        vtopleft[1:, 0] = vleft[1:, 0]
        m = np.minimum(vleft, vtop)
        M = np.maximum(vleft, vtop)
        grad = vleft + vtop - vtopleft
        vpred = np.where(vtopleft < m, M,
                         np.where(vtopleft > M, m, grad))
        out[offset] = np.abs(v)
        out[offset + 1] = v
        out[offset + 2] = np.abs(v - vpred)
        out[offset + 3] = v - vpred
        offset += EXTRA_PROPS_PER_CHANNEL
    return out


def _tree_lookup(tree, props):
    pos = 0
    while True:
        node = tree[pos]
        if node.property == -1:
            return node
        pos = node.lchild if props[node.property] > node.splitval \
            else node.rchild
    # note: reference convention: go to lchild when value > splitval


def _bulk_decode_tokens(reader: ANSSymbolReader, r: BitReader, ctx: int,
                        n: int):
    """Native bulk hybrid-uint decode for a single-context run; returns
    uint32 values or None when the stream shape disqualifies the fast
    path (prefix codes, LZ77, or native lib unavailable)."""
    code = reader.code
    if code.use_prefix_code or code.lz77.enabled:
        return None
    cfg = code.uint_configs[ctx]
    from libjxl_torch.utils import native
    if not native.available():
        return None
    res = native.ans_decode_tokens(
        r._data, r.bits_consumed, n,
        code.alias_symbols[ctx], code.alias_offsets[ctx],
        code.alias_freqs[ctx],
        cfg=(cfg.split_exponent, cfg.msb_in_token, cfg.lsb_in_token),
        check_final=False, state=reader.state)
    if res is None:
        return None
    vals, end_bit, state = res
    r.skip(end_bit - r.bits_consumed)
    reader.state = state
    return vals


def decode_modular_channel(r: BitReader, reader: ANSSymbolReader,
                           context_map, tree, wp_header: WPHeader,
                           image: ModularImage, chan_idx: int,
                           group_id: int) -> None:
    """(encoding.cc DecodeModularChannelMAANS:149-506)."""
    ch = image.channel[chan_idx]
    if ch.w == 0 or ch.h == 0:
        return
    w, h = ch.w, ch.h
    plane = np.zeros((h, w), dtype=np.int64)

    max_prop = max_property_used(tree)
    use_wp = max_prop >= NUM_NONREF_PROPERTIES - 1 or any(
        n.is_leaf and n.predictor == PREDICTOR_WEIGHTED for n in tree)
    num_refs = 0
    if max_prop >= NUM_NONREF_PROPERTIES:
        num_refs = (max_prop - NUM_NONREF_PROPERTIES +
                    EXTRA_PROPS_PER_CHANNEL) // EXTRA_PROPS_PER_CHANNEL * \
            EXTRA_PROPS_PER_CHANNEL

    if len(tree) == 1:
        node = tree[0]
        ctx = int(context_map[node.context])
        if node.predictor in (PREDICTOR_ZERO, PREDICTOR_GRADIENT) and \
                node.predictor_offset == 0 and node.multiplier == 1:
            vals = _bulk_decode_tokens(reader, r, ctx, w * h)
            if vals is not None:
                if node.predictor == PREDICTOR_ZERO:
                    sv = np.where(vals & 1,
                                  -((vals.astype(np.int64) + 1) >> 1),
                                  vals.astype(np.int64) >> 1)
                    ch.plane = sv.reshape(h, w).astype(np.int32)
                else:
                    from libjxl_torch.utils import native
                    ch.plane = native.gradient_reconstruct(
                        vals.reshape(h, w), h, w)
                return

    # Native per-pixel tree-walk decode (DecodeModularChannelMAANS in
    # C++): handles learned trees, WP, reference properties and the
    # LZ77 value window; prefix-code streams and trees with properties
    # >= 32 stay on the python paths below.
    code = reader.code
    if not code.use_prefix_code and max_prop < 32:
        from libjxl_torch.utils import native
        if native.available():
            refs = _reference_planes(image, chan_idx, num_refs, h, w) \
                if num_refs else None
            out32 = np.zeros((h, w), np.int32)
            res = native.modular_generic_decode(
                r._data, r.bits_consumed, reader.state, code, tree,
                out32, refs, chan_idx, group_id, use_wp, wp_header,
                reader=reader)
            if res is not None:
                end_bit, state = res
                r.skip(end_bit - r.bits_consumed)
                reader.state = state
                ch.plane = out32
                return

    if len(tree) == 1:
        node = tree[0]
        ctx = int(context_map[node.context])
        if node.predictor == PREDICTOR_ZERO and node.predictor_offset == 0 \
                and node.multiplier == 1:
            # token stream is context-independent: bulk decode
            for y in range(h):
                for x in range(w):
                    v = reader.read_hybrid_uint_clustered(ctx, r)
                    plane[y, x] = wrap32(unpack_signed(v))
            ch.plane = plane.astype(np.int32)
            return
        if node.predictor == PREDICTOR_GRADIENT and \
                node.predictor_offset == 0 and node.multiplier == 1:
            for y in range(h):
                for x in range(w):
                    left = plane[y, x - 1] if x else (plane[y - 1, x]
                                                     if y else 0)
                    top = plane[y - 1, x] if y else left
                    topleft = plane[y - 1, x - 1] if (x and y) else left
                    guess = clamped_gradient(int(top), int(left),
                                             int(topleft))
                    v = reader.read_hybrid_uint_clustered(ctx, r)
                    plane[y, x] = wrap32(unpack_signed(v) + guess)
            ch.plane = plane.astype(np.int32)
            return
        # single leaf, general predictor
        wp = WPState(wp_header, w, h) if use_wp else None
        for y in range(h):
            for x in range(w):
                left, top, topleft, topright, leftleft, toptop, trr = \
                    _neighbors(plane, x, y, w)
                wp_pred = wp.predict(x, y, w, top, left, topright, topleft,
                                     toptop) if wp else 0
                guess = predict_one(node.predictor, left, top, toptop,
                                    topleft, topright, leftleft, trr, wp_pred)
                v = reader.read_hybrid_uint_clustered(ctx, r)
                val = wrap32(unpack_signed(v) * node.multiplier + guess +
                             node.predictor_offset)
                plane[y, x] = val
                if wp:
                    wp.update_errors(int(val), x, y, w)
        ch.plane = plane.astype(np.int32)
        return

    nprops = max(max_prop + 1, NUM_NONREF_PROPERTIES) + num_refs
    props = [0] * (NUM_NONREF_PROPERTIES + num_refs)
    props[0] = chan_idx
    props[1] = group_id
    wp = WPState(wp_header, w, h) if use_wp else None
    for y in range(h):
        refs = _compute_references(image, chan_idx, y, num_refs) \
            if num_refs else None
        props[2] = y
        prev_grad = 0
        for x in range(w):
            left, top, topleft, topright, leftleft, toptop, trr = \
                compute_properties_scalar(props, plane, x, y, w, prev_grad)
            prev_grad = props[9]
            if wp is not None:
                wp_pred = wp.predict(x, y, w, int(top), int(left),
                                     int(topright), int(topleft), int(toptop),
                                     props, 15)
            else:
                wp_pred = 0
                props[15] = 0
            if refs is not None:
                for k in range(num_refs):
                    props[16 + k] = int(refs[x, k])
            node = _tree_lookup(tree, props)
            ctx = int(context_map[node.context])
            v = reader.read_hybrid_uint_clustered(ctx, r)
            guess = predict_one(node.predictor, int(left), int(top),
                                int(toptop), int(topleft), int(topright),
                                int(leftleft), int(trr), wp_pred)
            val = wrap32(unpack_signed(v) * node.multiplier + guess +
                         node.predictor_offset)
            plane[y, x] = val
            if wp is not None:
                wp.update_errors(int(val), x, y, w)
    ch.plane = plane.astype(np.int32)


def modular_decode(r: BitReader, image: ModularImage, group_id: int = 0,
                   options: ModularOptions | None = None,
                   global_tree=None, global_code=None,
                   global_header: GroupHeader | None = None,
                   undo_transforms: bool = True) -> GroupHeader:
    """(encoding.cc ModularDecode:554-683 + ModularGenericDecompress)."""
    options = options or ModularOptions()
    header = GroupHeader()
    if not image.channel:
        return header
    header.read(r)
    if r.overflow:
        raise FormatError("truncated modular header")
    for t in header.transforms:
        t.meta_apply(image)

    nb_channels = len(image.channel)
    distance_multiplier = 0
    num_chans = 0
    for i, ch in enumerate(image.channel):
        if i >= image.nb_meta_channels and (ch.w > options.max_chan_size or
                                            ch.h > options.max_chan_size):
            break
        if ch.w == 0 or ch.h == 0:
            continue
        distance_multiplier = max(distance_multiplier, ch.w)
        num_chans += 1
    if num_chans == 0:
        return header

    if not header.use_global_tree:
        tree = decode_tree(r)
        code = decode_histograms(r, (len(tree) + 1) // 2)
    else:
        if global_tree is None or global_code is None:
            raise FormatError("global tree requested but unavailable")
        tree = global_tree
        code = global_code

    reader = ANSSymbolReader(code, r, distance_multiplier)
    wp_header = header.wp_header
    for i, ch in enumerate(image.channel):
        if i >= image.nb_meta_channels and (ch.w > options.max_chan_size or
                                            ch.h > options.max_chan_size):
            break
        if ch.w == 0 or ch.h == 0:
            continue
        decode_modular_channel(r, reader, code.context_map, tree,
                               wp_header, image, i, group_id)
        if r.overflow:
            raise FormatError("truncated modular stream")
    if not reader.check_final_state():
        raise FormatError("modular ANS checksum failed")
    if undo_transforms:
        for t in reversed(header.transforms):
            t.inverse(image, header.wp_header)
    return header


# ---------------------------------------------------------------------------
# Encode side
# ---------------------------------------------------------------------------

def encode_modular_channel_tokens(image: ModularImage, chan_idx: int,
                                  group_id: int, tree,
                                  wp_header: WPHeader):
    """Produce (context, value) token pairs for a channel given a tree."""
    ch = image.channel[chan_idx]
    w, h = ch.w, ch.h
    if w == 0 or h == 0:
        return []
    plane = ch.plane.astype(np.int64)
    tokens = []
    max_prop = max_property_used(tree)
    use_wp = max_prop >= NUM_NONREF_PROPERTIES - 1 or any(
        n.is_leaf and n.predictor == PREDICTOR_WEIGHTED for n in tree)
    num_refs = 0
    if max_prop >= NUM_NONREF_PROPERTIES:
        num_refs = (max_prop - NUM_NONREF_PROPERTIES +
                    EXTRA_PROPS_PER_CHANNEL) // EXTRA_PROPS_PER_CHANNEL * \
            EXTRA_PROPS_PER_CHANNEL

    if len(tree) == 1 and not use_wp:
        node = tree[0]
        ctx = node.context
        if node.predictor == PREDICTOR_ZERO and node.predictor_offset == 0 \
                and node.multiplier == 1:
            vals = plane.reshape(-1).astype(np.int32).astype(np.int64)
            packed = np.where(vals >= 0, vals * 2, -vals * 2 - 1)
            return np.stack([np.full(len(packed), ctx, dtype=np.int64),
                             packed], axis=1)
        if node.predictor in (PREDICTOR_GRADIENT, PREDICTOR_LEFT,
                              PREDICTOR_TOP) and \
                node.predictor_offset == 0 and node.multiplier == 1:
            # residuals via vectorized neighbors on the decoded plane
            # (left at x==0 is the pixel above; top at y==0 is left —
            # context_predict.h PixelsWithPosition semantics)
            left = np.zeros_like(plane)
            left[:, 1:] = plane[:, :-1]
            left[1:, 0] = plane[:-1, 0]
            if node.predictor == PREDICTOR_LEFT:
                guess = left
            else:
                top = np.zeros_like(plane)
                top[1:] = plane[:-1]
                top[0] = left[0]
                if node.predictor == PREDICTOR_TOP:
                    guess = top
                else:
                    topleft = np.zeros_like(plane)
                    topleft[1:, 1:] = plane[:-1, :-1]
                    topleft[:, 0] = left[:, 0]
                    topleft[0, 1:] = left[0, 1:]
                    m = np.minimum(top, left)
                    M = np.maximum(top, left)
                    grad = top + left - topleft
                    guess = np.where(topleft < m, M,
                                     np.where(topleft > M, m, grad))
            res = (plane - guess).reshape(-1).astype(
                np.int32).astype(np.int64)
            packed = np.where(res >= 0, res * 2, -res * 2 - 1)
            return np.stack([np.full(len(packed), ctx, dtype=np.int64),
                             packed], axis=1)
    # general scalar path
    props = [0] * (NUM_NONREF_PROPERTIES + num_refs)
    props[0] = chan_idx
    props[1] = group_id
    wp = WPState(wp_header, w, h) if use_wp else None
    for y in range(h):
        refs = _compute_references(image, chan_idx, y, num_refs) \
            if num_refs else None
        props[2] = y
        prev_grad = 0
        for x in range(w):
            left, top, topleft, topright, leftleft, toptop, trr = \
                compute_properties_scalar(props, plane, x, y, w, prev_grad)
            prev_grad = props[9]
            if wp is not None:
                wp_pred = wp.predict(x, y, w, int(top), int(left),
                                     int(topright), int(topleft),
                                     int(toptop), props, 15)
            else:
                wp_pred = 0
                props[15] = 0
            if refs is not None:
                for k in range(num_refs):
                    props[16 + k] = int(refs[x, k])
            node = _tree_lookup(tree, props)
            guess = predict_one(node.predictor, int(left), int(top),
                                int(toptop), int(topleft), int(topright),
                                int(leftleft), int(trr), wp_pred)
            val = int(plane[y, x])
            residual = wrap32(val - guess - node.predictor_offset)
            assert residual % node.multiplier == 0, \
                "value not representable with leaf multiplier"
            tokens.append((node.context, pack_signed(residual //
                                                     node.multiplier)))
            if wp is not None:
                wp.update_errors(val, x, y, w)
    return tokens


def _tree_vector_friendly(tree) -> bool:
    """True when every leaf is expressible by the vectorized tokenizer
    (enc_ma.tokenize_with_tree): multiplier 1, no predictor offset, and
    a predictor from the learn-tree candidate set."""
    from libjxl_torch.modular.predict import (
        PREDICTOR_LEFT, PREDICTOR_TOP,
    )
    ok_preds = {PREDICTOR_ZERO, PREDICTOR_LEFT, PREDICTOR_TOP,
                PREDICTOR_GRADIENT, PREDICTOR_WEIGHTED}
    return all((not n.is_leaf) or
               (n.multiplier == 1 and n.predictor_offset == 0 and
                n.predictor in ok_preds) for n in tree)


def modular_encode(w: BitWriter, image: ModularImage, group_id: int = 0,
                   header: GroupHeader | None = None,
                   tree=None, options: ModularOptions | None = None,
                   global_codes=None) -> None:
    """Self-contained modular stream: header + local tree + channels.

    If ``header.use_global_tree``, ``tree``/``global_codes`` must be the
    global ones and only tokens are written here.
    """
    options = options or ModularOptions()
    header = header or GroupHeader()
    if tree is None:
        tree = [TreeNode(-1, 0, 0, 0, PREDICTOR_GRADIENT, 0, 1)]
    header.write(w)
    # apply transforms meta (assumed already applied to channel data by
    # caller via fwd_* helpers; meta_apply only reshapes channel list)
    token_arrays = []
    nctx = (len(tree) + 1) // 2
    chans = []
    for i, ch in enumerate(image.channel):
        if i >= image.nb_meta_channels and (ch.w > options.max_chan_size or
                                            ch.h > options.max_chan_size):
            break
        if ch.w == 0 or ch.h == 0:
            continue
        chans.append(i)
    if len(tree) > 1 and _tree_vector_friendly(tree) and chans:
        # learned trees (multiplier 1, candidate predictors only) go
        # through the vectorized tokenizer in one all-channels call —
        # the scalar per-pixel walk below is ~50x slower
        from libjxl_torch.modular.enc_ma import tokenize_with_tree
        token_arrays.append(tokenize_with_tree(
            [(i, image.channel[i].plane) for i in chans], tree,
            group_id, header.wp_header))
        chans = []
    for i in chans:
        toks = encode_modular_channel_tokens(image, i, group_id, tree,
                                             header.wp_header)
        token_arrays.append(tokens_to_array(toks))
    if not token_arrays:
        return
    all_tokens = np.concatenate(token_arrays) if token_arrays else \
        np.zeros((0, 2), dtype=np.int64)
    if not header.use_global_tree:
        write_tree(w, tree)
        # native one-call tail (histograms + context map + rANS emit);
        # bit-identical to the Python path (test_entropy.py)
        from libjxl_torch.utils import native
        res = native.entropy_tail([all_tokens], nctx, 64, 13, False)
        if res is not None:
            w.append_packed(res[0], res[1])
            w.append_packed(*res[2][0])
            return
        codes = build_entropy_codes(token_arrays, nctx)
        write_entropy_codes(w, codes)
    else:
        codes = global_codes
    write_tokens(w, all_tokens, codes)
