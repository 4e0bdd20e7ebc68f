"""Predefined MA trees for the fast effort tiers (reference
``modular/encoding/enc_encoding.cc:482-570`` PredefinedTree +
``MakeFixedTree``): the VarDCT side streams (DC, AC metadata) get
hand-built context trees instead of either learning (slow) or a single
context (fat — a constant quant field costs ~6 bits/block raw).

Node layout matches the decoder's pending-queue emission order (the
same layout ``enc_ma.learn_tree`` serializes to); leaf context ids are
assigned in node order.
"""

from __future__ import annotations

from libjxl_torch.modular.predict import (
    PREDICTOR_GRADIENT, PREDICTOR_LEFT, PREDICTOR_WEIGHTED, PREDICTOR_ZERO,
)
from libjxl_torch.modular.tree import TreeNode

_K_DC_CUTOFFS = (-500, -392, -255, -191, -127, -95, -63, -47, -31, -23,
                 -15, -11, -7, -4, -3, -1, 0, 1, 3, 5, 7, 11, 15, 23, 31,
                 47, 63, 95, 127, 191, 255, 392, 500)
K_GRADIENT_PROP = 9      # N + W - NW (context_predict.h:382)
K_WP_PROP = 15           # WP prediction error property


def _assign_leaf_ids(nodes: list[TreeNode]) -> list[TreeNode]:
    leaf_id = 0
    for n in nodes:
        if n.is_leaf:
            n.lchild = leaf_id
            leaf_id += 1
    return nodes


def make_fixed_tree(prop: int, cutoffs, pred: int, total_pixels: int,
                    bitdepth: int = 8) -> list[TreeNode]:
    """Balanced splits of one property at the given cutoffs
    (enc_encoding.cc:72-110 MakeFixedTree), with the same small-image
    height reduction and >11-bit cutoff scaling."""
    log_px = max(1, total_pixels).bit_length()
    min_gap = 8 * (14 - log_px) if log_px < 14 else 0
    mul = 1 << min(4, bitdepth - 11) if bitdepth > 11 else 1
    nodes = [TreeNode(-1, 0, 0, 0, pred, 0, 1)]
    from collections import deque
    q = deque([(0, len(cutoffs), 0)])
    while q:
        begin, end, pos = q.popleft()
        if begin + min_gap >= end:
            continue
        split = (begin + end) // 2
        base = len(nodes)
        nodes[pos] = TreeNode(prop, int(cutoffs[split]) * mul,
                              base, base + 1, 0, 0, 1)
        nodes.append(TreeNode(-1, 0, 0, 0, pred, 0, 1))
        nodes.append(TreeNode(-1, 0, 0, 0, pred, 0, 1))
        q.append((split + 1, end, base))
        q.append((begin, split, base + 1))
    return _assign_leaf_ids(nodes)


def gradient_fixed_dc(total_pixels: int, bitdepth: int = 8
                      ) -> list[TreeNode]:
    """kGradientFixedDC: gradient-property splits, Gradient leaves."""
    return make_fixed_tree(K_GRADIENT_PROP, _K_DC_CUTOFFS,
                           PREDICTOR_GRADIENT, total_pixels, bitdepth)


def wp_fixed_dc(total_pixels: int, bitdepth: int = 8) -> list[TreeNode]:
    """kWPFixedDC: WP-error-property splits, Weighted leaves."""
    return make_fixed_tree(K_WP_PROP, _K_DC_CUTOFFS, PREDICTOR_WEIGHTED,
                           total_pixels, bitdepth)


def falcon_acmeta_tree() -> list[TreeNode]:
    """kFalconACMeta: a single Left-predictor leaf — constant quant
    fields and ACS maps reduce to zero residuals."""
    return [TreeNode(-1, 0, 0, 0, PREDICTOR_LEFT, 0, 1)]


def acmeta_tree(total_pixels: int) -> list[TreeNode]:
    """kACMeta (enc_encoding.cc:495-541): channel split (CfL x/b ->
    Gradient; ACS+QF row split on y with Left/Zero leaves segmented by
    the left value; EPF -> Zero with top/left splits)."""
    if total_pixels < 1024:
        return [TreeNode(-1, 0, 0, 0, PREDICTOR_LEFT, 0, 1)]

    def S(prop, val, base):
        return TreeNode(prop, val, base, base + 1, 0, 0, 1)

    def L(pred):
        return TreeNode(-1, 0, 0, 0, pred, 0, 1)

    G, Lf, Z = PREDICTOR_GRADIENT, PREDICTOR_LEFT, PREDICTOR_ZERO
    static = [
        S(0, 1, 1),      # 0: c > 1
        S(0, 2, 3),      # 1: c > 2
        S(0, 0, 5),      # 2: c > 0
        S(6, 3, 21),     # 3: EPF channel, top > 3
        S(2, 0, 7),      # 4: ACS+QF, y > 0
        L(G),            # 5: CfL x
        L(G),            # 6: CfL b
        S(7, 5, 9),      # 7: QF row, split by left value
        S(7, 5, 15),     # 8: ACS row, 4 segments by previous value
        S(7, 11, 11),    # 9
        S(7, 3, 13),     # 10
        L(Lf), L(Lf), L(Lf), L(Lf),     # 11-14: QF
        S(7, 11, 17),    # 15
        S(7, 3, 19),     # 16
        L(Z), L(Z), L(Z), L(Z),         # 17-20: ACS
        S(7, 3, 23),     # 21: EPF, left > 3
        S(7, 3, 25),     # 22
        L(Z), L(Z), L(Z), L(Z),         # 23-26: EPF
    ]
    return _requeue(static)


def _requeue(static: list[TreeNode]) -> list[TreeNode]:
    """Re-serialize an arbitrary static node list into the decoder's
    pending-queue emission order (the layout write_tree/decode_tree
    agree on; the reference normalizes its static trees the same way
    via TokenizeTree + decode)."""
    nodes: list[TreeNode] = []
    queue = [0]
    while queue:
        i = queue.pop(0)
        n = static[i]
        if n.is_leaf:
            nodes.append(TreeNode(-1, 0, 0, 0, n.predictor,
                                  n.predictor_offset, n.multiplier))
        else:
            base = len(nodes) + len(queue) + 1
            nodes.append(TreeNode(n.property, n.splitval, base, base + 1,
                                  0, 0, 1))
            queue.append(n.lchild)
            queue.append(n.rchild)
    return _assign_leaf_ids(nodes)
