"""MA tree learning for the modular encoder (reference
``lib/jxl/modular/encoding/enc_ma.cc`` LearnTree / FindBestSplit).

Greedy CART over the context properties: at each node, pick the
(property, splitval) pair that minimizes the summed token entropy of the
two children; leaves also choose the best of a small predictor set.
All property planes are computed vectorized (numpy); the learner works
on a subsample of positions for large images."""

from __future__ import annotations

import numpy as np

from libjxl_torch.modular.predict import (
    PREDICTOR_GRADIENT, PREDICTOR_LEFT, PREDICTOR_TOP, PREDICTOR_WEIGHTED,
    PREDICTOR_ZERO,
)
from libjxl_torch.modular.tree import TreeNode


def _have_wp() -> bool:
    from libjxl_torch.utils import native
    return native.available()


# properties we consider for splits (context_predict.h:508-530 ids);
# p15 (the WP max-error) needs the native WP sweep
N_REF_CHANNELS = 2           # prev-channel properties 16..23


def _split_props():
    base = (0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14)
    base = base + (15,) if _have_wp() else base
    return base + tuple(range(16, 16 + 4 * N_REF_CHANNELS))


def ref_property_planes(planes, chan_idx: int) -> dict:
    """Prev-channel properties 16+ (context_predict.h
    PrecomputeReferences, codec.py:64-93 is the matching decode):
    per reference channel |v|, v, |v - grad|, v - grad at the same
    pixel. Missing references stay 0 (the decoder's default)."""
    h, w = planes[chan_idx].shape
    out = {16 + k: np.zeros((h, w), np.int64)
           for k in range(4 * N_REF_CHANNELS)}
    offset = 0
    for j in range(chan_idx - 1, -1, -1):
        if offset >= 4 * N_REF_CHANNELS:
            break
        rp = planes[j]
        if rp.shape != planes[chan_idx].shape:
            continue
        v = rp.astype(np.int64)
        vleft = np.empty_like(v)
        vleft[:, 1:] = v[:, :-1]
        vleft[:, 0] = 0                 # decode: left of col 0 is 0
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
        vpred = np.where(vtopleft < m, M, np.where(vtopleft > M, m, grad))
        # PropertyVal (int32) wrap for 32-bit content
        out[16 + offset] = np.abs(v).astype(np.int32)
        out[16 + offset + 1] = v.astype(np.int32)
        out[16 + offset + 2] = np.abs(v - vpred).astype(np.int32)
        out[16 + offset + 3] = (v - vpred).astype(np.int32)
        offset += 4
    return out


def _candidate_predictors():
    base = (PREDICTOR_GRADIENT, PREDICTOR_LEFT, PREDICTOR_TOP,
            PREDICTOR_ZERO)
    return base + (PREDICTOR_WEIGHTED,) if _have_wp() else base


_SPLIT_PROPS = None          # resolved lazily
_CANDIDATE_PREDICTORS = None


def _shift(plane, dy, dx):
    """Neighbor plane with the JXL border rules handled separately."""
    h, w = plane.shape
    out = np.zeros_like(plane)
    ys = slice(dy, h) if dy >= 0 else slice(0, h + dy)
    yd = slice(0, h - dy) if dy >= 0 else slice(-dy, h)
    xs = slice(dx, w) if dx >= 0 else slice(0, w + dx)
    xd = slice(0, w - dx) if dx >= 0 else slice(-dx, w)
    out[yd, xd] = plane[ys, xs]
    return out


def neighbor_planes(plane: np.ndarray):
    """Vectorized _neighbors (context_predict.h Predict border rules)."""
    p = plane.astype(np.int64)
    h, w = p.shape
    left = np.zeros_like(p)
    left[:, 1:] = p[:, :-1]
    left[1:, 0] = p[:-1, 0]          # x==0, y>0 -> top
    top = np.zeros_like(p)
    top[1:] = p[:-1]
    top[0] = left[0]
    topleft = np.zeros_like(p)
    topleft[1:, 1:] = p[:-1, :-1]
    topleft[0, :] = left[0, :]
    topleft[1:, 0] = left[1:, 0]
    topright = np.zeros_like(p)
    topright[1:, :-1] = p[:-1, 1:]
    topright[1:, -1] = top[1:, -1]
    topright[0] = top[0]
    leftleft = np.zeros_like(p)
    leftleft[:, 2:] = p[:, :-2]
    leftleft[:, :2] = left[:, :2]
    toptop = np.zeros_like(p)
    toptop[2:] = p[:-2]
    toptop[:2] = top[:2]
    return left, top, topleft, topright, leftleft, toptop


def property_planes(plane: np.ndarray, chan_idx: int, group_id: int,
                    wp_header=None, only=None, need_wp: bool = True):
    """-> dict prop_id -> int64 plane (properties 0..15).

    ``only``: optional set of property ids to materialize (tokenizers
    pass the tree's split properties — most trees use a handful, and
    skipping the rest saves full-plane array builds). ``need_wp``
    False additionally skips the native weighted-predictor pass when
    neither property 15 nor the WP predictor is referenced."""
    p = plane.astype(np.int64)
    h, w = p.shape
    left, top, topleft, topright, leftleft, toptop = neighbor_planes(p)
    wp_pred = wp_prop = None
    if _have_wp() and (need_wp or only is None or 15 in only):
        from libjxl_torch.utils import native
        res = native.wp_plane(plane.astype(np.int32), wp_header)
        if res is not None:
            wp_pred, wp_prop = (r.astype(np.int64) for r in res)

    def want(i):
        return only is None or i in only

    props = {}
    if want(0):
        props[0] = np.full((h, w), chan_idx, np.int64)
    if want(1):
        props[1] = np.full((h, w), group_id, np.int64)
    if want(2):
        props[2] = np.broadcast_to(
            np.arange(h, dtype=np.int64)[:, None], (h, w))
    if want(3):
        props[3] = np.broadcast_to(
            np.arange(w, dtype=np.int64)[None, :], (h, w))
    def w32(a):
        # PropertyVal = int32_t (options.h:18): wrap for 32-bit content
        return a.astype(np.int32).astype(np.int64)

    if want(4):
        props[4] = w32(np.abs(top))
    if want(5):
        props[5] = w32(np.abs(left))
    if want(6):
        props[6] = w32(top)
    if want(7):
        props[7] = w32(left)
    if want(8) or want(9):
        grad = w32(left + top - topleft)
        if want(9):
            props[9] = grad
        if want(8):
            prev_grad = np.zeros_like(grad)
            prev_grad[:, 1:] = grad[:, :-1]   # reset 0 at row starts
            props[8] = w32(left - prev_grad)
    if want(10):
        props[10] = w32(left - topleft)
    if want(11):
        props[11] = w32(topleft - top)
    if want(12):
        props[12] = w32(top - topright)
    if want(13):
        props[13] = w32(top - toptop)
    if want(14):
        props[14] = w32(left - leftleft)
    if wp_prop is not None and want(15):
        props[15] = wp_prop
    return props, {"left": left, "top": top, "topleft": topleft,
                   "topright": topright, "leftleft": leftleft,
                   "toptop": toptop, "wp_pred": wp_pred}


def predictions(nb, predictor: int):
    if predictor == PREDICTOR_WEIGHTED:
        return nb["wp_pred"]
    if predictor == PREDICTOR_ZERO:
        return np.zeros_like(nb["left"])
    if predictor == PREDICTOR_LEFT:
        return nb["left"]
    if predictor == PREDICTOR_TOP:
        return nb["top"]
    if predictor == PREDICTOR_GRADIENT:
        grad = nb["left"] + nb["top"] - nb["topleft"]
        mn = np.minimum(nb["left"], nb["top"])
        mx = np.maximum(nb["left"], nb["top"])
        return np.clip(grad, mn, mx)
    raise ValueError(predictor)


def _entropy_of_tokens(tokens: np.ndarray) -> float:
    """Empirical shannon entropy (bits) of the token ids + raw bits."""
    if tokens.size == 0:
        return 0.0
    counts = np.bincount(tokens)
    counts = counts[counts > 0]
    p = counts / tokens.size
    return float(-(p * np.log2(p)).sum() * tokens.size)


def _tokenize(vals: np.ndarray):
    """packed value -> (token id, nbits) arrays (default hybrid config)."""
    packed = np.where(vals >= 0, 2 * vals, -2 * vals - 1).astype(np.int64)
    small = packed < 16
    n = np.zeros_like(packed)
    v = np.maximum(packed, 1)
    for s in (16, 8, 4, 2, 1):
        m = v >= (1 << s)
        n = np.where(m, n + s, n)
        v = np.where(m, v >> s, v)
    token = np.where(small, packed, 16 + ((n - 4) << 2) +
                     ((packed - (1 << n)) >> np.maximum(n - 2, 0)))
    nbits = np.where(small, 0, n - 2)
    return token, nbits


def _cost(tokens, nbits) -> float:
    return _entropy_of_tokens(tokens) + float(nbits.sum())


def learn_tree(channels, max_leaves: int = 64, sample_limit: int = 1 << 18,
               group_id: int = 0, wp_header=None):
    """channels: list of (chan_idx, plane) forming ONE stream. Returns
    tree nodes in the decode tree layout."""
    return learn_tree_streams([(group_id, channels)], max_leaves,
                              sample_limit, wp_header)


def learn_tree_streams(streams, max_leaves: int = 64,
                       sample_limit: int = 1 << 18, wp_header=None):
    """Learn ONE global MA tree from samples drawn from the actual
    per-group streams (enc_modular.cc ComputeTree / enc_ma.cc
    TreeSamples): ``streams`` is a list of (stream_id, [(chan_idx,
    plane), ...]) exactly as each stream will later be tokenized.
    Properties are computed per stream — local x/y coordinates, the
    stream id as the group-id property, prev-channel references scoped
    to the stream — so the learned splits see the same property
    distributions the tokenizer (and decoder) will produce. Learning on
    whole-image planes instead systematically misroutes contexts on
    multi-group frames (global y splits at >= group_dim are dead, W/N
    continuity across group seams is assumed but absent)."""
    cand = _candidate_predictors()
    split_props = _split_props()

    # Row-block subsampling BEFORE property/residual computation: with
    # a sample budget far below the pixel count, computing full-plane
    # properties just to discard 90% of them dominated tree learning.
    # Blocks of 16 rows (plus a 2-row causal halo whose samples are
    # dropped) are taken at an even stride per plane shape, so
    # same-size channels stay row-aligned for the reference
    # properties; the y property is rewritten with the true rows.
    total = sum(p.size for _, chs in streams for _, p in chs)
    sels: dict = {}

    def _row_sel(h: int, w: int, salt: int):
        key = (h, w, salt)
        if key in sels:
            return sels[key]
        blk = 16
        nblk = -(-h // blk)
        want = max(1, int(nblk * min(1.0, 1.5 * sample_limit / total)))
        stride = max(1, nblk // want)
        # stagger the chosen blocks across streams (salt): with many
        # short per-group planes and a small budget, always taking
        # block 0 would sample ONLY each group's top rows, whose
        # border-degenerate top-neighbors don't represent the stream
        phase = salt % stride
        starts = [b * blk for b in range(phase, nblk, stride)] or [0]
        sels[key] = starts
        return starts

    props_all = []
    resid_by_pred = {}
    for pred in cand:
        resid_by_pred[pred] = []
    full = total <= sample_limit * 2
    for snum, (sid, channels) in enumerate(streams):
        if full:
            chan_planes = [p for _, p in channels]
            subs = [(ci, p, None, None) for ci, p in channels]
        else:
            blk = 16
            subs = []
            for ci, p in channels:
                h, w = p.shape
                starts = _row_sel(h, w, snum)
                segs, keep, ytrue = [], [], []
                for y0 in starts:
                    halo = min(2, y0)
                    rows = min(blk, h - y0)
                    segs.append(p[y0 - halo:y0 + rows])
                    keep.extend([False] * halo + [True] * rows)
                    ytrue.extend(range(y0 - halo, y0 + rows))
                subs.append((ci, np.concatenate(segs, axis=0),
                             np.asarray(keep), np.asarray(ytrue, np.int64)))
            chan_planes = [s[1] for s in subs]
        for pos, (chan_idx, plane, keep, ytrue) in enumerate(subs):
            props, nb = property_planes(plane, chan_idx, sid, wp_header)
            props.update(ref_property_planes(chan_planes, pos))
            if ytrue is not None:
                props[2] = np.broadcast_to(ytrue[:, None], plane.shape)
            if keep is None:
                flat = {k: v.ravel() for k, v in props.items()}
            else:
                flat = {k: v[keep].ravel() for k, v in props.items()}
            props_all.append(flat)
            for pred in cand:
                r = (plane.astype(np.int64) -
                     predictions(nb, pred)).astype(
                         np.int32).astype(np.int64)
                resid_by_pred[pred].append(
                    r.ravel() if keep is None else r[keep].ravel())
    props = {k: np.concatenate([f[k] for f in props_all])
             for k in props_all[0]}
    resid = {p: np.concatenate(v) for p, v in resid_by_pred.items()}
    n = next(iter(resid.values())).size
    if n > sample_limit:
        idx = np.random.default_rng(0).choice(n, sample_limit, replace=False)
        props = {k: v[idx] for k, v in props.items()}
        resid = {p: v[idx] for p, v in resid.items()}

    tok = {}
    for p, v in resid.items():
        tok[p] = _tokenize(v)
    # (P, n) stacked tokens/raw-bit-counts: every histogram/entropy below
    # is batched over all candidate predictors in one numpy call — the
    # per-(leaf, prop, predictor) Python loop was call-overhead-bound
    # (11520 tiny _seg_entropies calls profiled at ~0.9 s per tree)
    n_samp = next(iter(resid.values())).size
    tok_mat = np.stack([tok[p][0] for p in cand])
    nb_mat = np.stack([tok[p][1] for p in cand])
    n_pred = len(cand)
    pidx = np.arange(n_pred)[:, None]
    alphabet = 1 + (int(tok_mat.max()) if tok_mat.size else 0)

    if _have_wp():
        # native greedy learner (jxlt_tree_learn): same presorted-CART
        # search, ~20-50x the numpy version on DC-stream-sized inputs
        from libjxl_torch.utils import native
        props_mat = np.stack([props[p] for p in split_props])
        res = native.tree_learn(tok_mat, nb_mat, props_mat,
                                int(max_leaves))
        if res is not None:
            t_prop, t_sval, t_child, t_pred = res
            nodes = []
            leaf_id = 0
            for i in range(len(t_prop)):
                if t_prop[i] < 0:
                    nodes.append(TreeNode(-1, 0, leaf_id, 0,
                                          cand[int(t_pred[i])], 0, 1))
                    leaf_id += 1
                else:
                    nodes.append(TreeNode(
                        split_props[int(t_prop[i])], int(t_sval[i]),
                        int(t_child[i]), int(t_child[i]) + 1, 0, 0, 1))
            return nodes

    # x*log2(x) table: entropy*n of a histogram is xl[tot] - sum xl[c];
    # a table gather replaces millions of tiny log2 evaluations
    _ar = np.arange(1, n_samp + 1, dtype=np.float64)
    xl = np.concatenate([[0.0], _ar * np.log2(_ar)])

    def _ent_counts(counts: np.ndarray) -> np.ndarray:
        """counts: (..., A) histograms -> (...) shannon bits * n."""
        return xl[counts.sum(axis=-1)] - xl[counts].sum(axis=-1)

    # node: (mask,) grown greedily
    class _Node:
        def __init__(self, mask):
            self.mask = mask
            self.idx = np.flatnonzero(mask)
            self.prop = -1
            self.splitval = 0
            self.left = self.right = None
            self.predictor = PREDICTOR_GRADIENT
            self.cost = None

        def best_pred(self):
            t = tok_mat[:, self.idx]
            hist = np.bincount(
                (pidx * alphabet + t).ravel(),
                minlength=n_pred * alphabet).reshape(n_pred, alphabet)
            costs = _ent_counts(hist) + nb_mat[:, self.idx].sum(axis=1)
            k = int(np.argmin(costs))
            self.cost, self.predictor = float(costs[k]), cand[k]
            return self.cost

    def _best_split(leaf):
        """One pass per prop, batched over predictors: sort the leaf's
        samples by the property, histogram the token ids per threshold
        segment (all predictors in one bincount), and score every
        candidate threshold from prefix sums — same costs/tie-breaks as
        the per-threshold masking original, minus its O(n) re-scan per
        threshold and the per-predictor Python loop."""
        idx = leaf.idx
        m = idx.size
        if m < 256:
            return None
        best = None
        t_leaf = tok_mat[:, idx]
        nb_leaf = nb_mat[:, idx]
        qfrac = np.array((6, 12, 25, 37, 50, 63, 75, 88, 94)) / 100.0
        for prop in split_props:
            vals = props[prop][idx]
            if vals.size == 0:
                continue
            order = np.argsort(vals, kind="stable")
            svals = vals[order]
            # np.percentile('linear') evaluated on the already-sorted
            # values — identical result, no extra partition pass
            qpos = (m - 1) * qfrac
            flo = np.floor(qpos).astype(np.int64)
            frac = qpos - flo
            qv = (svals[flo] * (1 - frac)
                  + svals[np.minimum(flo + 1, m - 1)] * frac)
            qs = np.unique(qv.astype(np.int64))
            cuts = np.searchsorted(svals, qs, side="right")
            # n_right = samples with val <= sv (rchild), n_left = > sv
            valid = (cuts >= 64) & (m - cuts >= 64)
            if not valid.any():
                continue
            seg = np.searchsorted(cuts, np.arange(m), side="right")
            nseg = len(qs) + 1
            t_s = t_leaf[:, order]
            nb_s = nb_leaf[:, order]
            ids = (pidx * nseg + seg[None, :]) * alphabet + t_s
            hist = np.bincount(
                ids.ravel(), minlength=n_pred * nseg * alphabet
            ).reshape(n_pred, nseg, alphabet)
            cum = np.cumsum(hist, axis=1)              # <= sv side
            nb_seg = np.bincount(
                (pidx * nseg + seg[None, :]).ravel(),
                weights=nb_s.ravel(),
                minlength=n_pred * nseg).reshape(n_pred, nseg)
            nb_cum = np.cumsum(nb_seg, axis=1)
            q = len(qs)
            le = cum[:, :q]                            # rchild (<= sv)
            gt = cum[:, -1][:, None, :] - le           # lchild (> sv)
            cr = _ent_counts(le) + nb_cum[:, :q]
            cl = _ent_counts(gt) + (nb_cum[:, -1][:, None]
                                    - nb_cum[:, :q])
            cr_min = cr.min(axis=0)
            cl_min = cl.min(axis=0)
            gains = leaf.cost - (cl_min + cr_min) - 96
            gains = np.where(valid, gains, -np.inf)
            k = int(np.argmax(gains))
            if gains[k] > 0 and (best is None or gains[k] > best[0]):
                best = (float(gains[k]), prop, int(qs[k]))
        return best

    root = _Node(np.ones(next(iter(props.values())).size, bool))
    root.best_pred()
    root.split = _best_split(root)
    leaves = [root]
    while len(leaves) < max_leaves:
        best = None
        for leaf in leaves:
            s = leaf.split
            if s is not None and (best is None or s[0] > best[0]):
                best = (s[0], leaf, s[1], s[2])
        if best is None:
            break
        _, leaf, prop, sv = best
        sel = props[prop] > sv
        leaf.prop = prop
        leaf.splitval = sv
        leaf.left = _Node(leaf.mask & sel)      # lchild: prop > splitval
        leaf.right = _Node(leaf.mask & ~sel)
        leaf.left.best_pred()
        leaf.right.best_pred()
        leaf.left.split = _best_split(leaf.left)
        leaf.right.split = _best_split(leaf.right)
        leaves.remove(leaf)
        leaves += [leaf.left, leaf.right]

    # serialize to the decode layout (dec_ma.cc:107-159): nodes appear in
    # the order the decoder's pending-queue emits them; an internal node
    # at index i with q nodes still pending points at i+q+1 / i+q+2.
    nodes = []
    queue = [root]
    while queue:
        node = queue.pop(0)
        if node.left is None:
            nodes.append(TreeNode(-1, 0, 0, 0, node.predictor, 0, 1))
        else:
            base = len(nodes) + len(queue) + 1
            nodes.append(TreeNode(node.prop, node.splitval, base, base + 1,
                                  0, 0, 1))
            queue.append(node.left)
            queue.append(node.right)
    # leaf context ids follow decode order
    leaf_id = 0
    for n in nodes:
        if n.is_leaf:
            n.lchild = leaf_id
            leaf_id += 1
    return nodes


def tokenize_with_tree(channels, tree, group_id: int,
                       wp_header=None) -> np.ndarray:
    """Vectorized token stream for a learned tree: (N, 2) array of
    (leaf context, packed residual) in decode traversal order (channels
    sequential, row-major). ``channels``: list of (chan_idx, plane)."""
    out = []
    chan_planes = [p for _, p in channels]
    used_props = {n.property for n in tree if not n.is_leaf}
    used_preds = {n.predictor for n in tree if n.is_leaf}
    need_wp = PREDICTOR_WEIGHTED in used_preds or 15 in used_props
    need_refs = any(p >= 16 for p in used_props)
    for pos, (chan_idx, plane) in enumerate(channels):
        props, nb = property_planes(plane, chan_idx, group_id, wp_header,
                                    only=used_props, need_wp=need_wp)
        if need_refs:
            props.update(ref_property_planes(chan_planes, pos))
        preds = {p: predictions(nb, p) for p in used_preds}
        h, w = plane.shape
        ctx = np.zeros((h, w), np.int32)
        pred_id = np.zeros((h, w), np.int32)

        def assign(idx, mask):
            node = tree[idx]
            if node.is_leaf:
                ctx[mask] = node.context
                pred_id[mask] = node.predictor
                return
            sel = props[node.property] > node.splitval
            assign(node.lchild, mask & sel)
            assign(node.rchild, mask & ~sel)

        assign(0, np.ones((h, w), bool))
        resid = plane.astype(np.int64).copy()
        for p, pp in preds.items():
            m = pred_id == p
            resid[m] -= pp[m]
        # residuals wrap to int32 (PackSigned takes pixel_type)
        resid = resid.astype(np.int32).astype(np.int64)
        packed = np.where(resid >= 0, 2 * resid,
                          -2 * resid - 1).astype(np.int64)
        out.append(np.stack([ctx.ravel().astype(np.int64),
                             packed.ravel()], axis=1))
    if not out:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(out)
