"""MA-tree representation, bitstream decode/encode
(reference ``lib/jxl/modular/encoding/dec_ma.cc``, ``enc_ma.cc``,
``ma_common.h``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libjxl_torch.core.fields import FormatError
from libjxl_torch.core.headers import pack_signed, unpack_signed
from libjxl_torch.entropy.ans import (
    ANSSymbolReader, build_entropy_codes, decode_histograms,
    tokens_to_array, write_entropy_codes, write_tokens,
)
from libjxl_torch.modular.predict import NUM_PREDICTORS
from libjxl_torch.utils.bits import BitReader, BitWriter

# Tree stream contexts (ma_common.h:13-21)
K_SPLITVAL_CTX = 0
K_PROPERTY_CTX = 1
K_PREDICTOR_CTX = 2
K_OFFSET_CTX = 3
K_MULTIPLIER_LOG_CTX = 4
K_MULTIPLIER_BITS_CTX = 5
K_NUM_TREE_CONTEXTS = 6

K_MAX_TREE_SIZE = 1 << 26


@dataclass
class TreeNode:
    """Decision node (property >= 0) or leaf (property == -1)."""

    property: int = -1
    splitval: int = 0
    lchild: int = 0           # for leaves: leaf context id
    rchild: int = 0
    predictor: int = 0
    predictor_offset: int = 0
    multiplier: int = 1

    # NB: the `property` field shadows the builtin in the class namespace,
    # so these accessors are defined as plain attributes post-hoc below.
    def _is_leaf(self) -> bool:
        return self.property == -1

    def _context(self) -> int:
        return self.lchild


import builtins as _bi
TreeNode.is_leaf = _bi.property(TreeNode._is_leaf)
TreeNode.context = _bi.property(TreeNode._context)


def decode_tree(r: BitReader, tree_size_limit: int = K_MAX_TREE_SIZE
                ) -> list[TreeNode]:
    """Full tree decode: histograms + node stream (dec_ma.cc:163-182)."""
    from libjxl_torch.utils import native
    res = native.decode_tree_native(r._data, r.bits_consumed,
                                    tree_size_limit)
    if res is not None:
        nodes, end_bit = res
        tree = [TreeNode(int(a), int(b), int(c), int(d), int(e), int(f),
                         int(g)) for a, b, c, d, e, f, g in nodes]
        validate_tree(tree)
        r.skip(end_bit - r.bits_consumed)
        return tree
    code = decode_histograms(r, K_NUM_TREE_CONTEXTS)
    reader = ANSSymbolReader(code, r)
    tree = _decode_tree_nodes(r, reader, tree_size_limit)
    if not reader.check_final_state():
        raise FormatError("tree ANS checksum failed")
    return tree


def _decode_tree_nodes(r: BitReader, reader: ANSSymbolReader,
                       tree_size_limit: int) -> list[TreeNode]:
    """(dec_ma.cc:107-159)."""
    tree: list[TreeNode] = []
    leaf_id = 0
    to_decode = 1
    while to_decode > 0:
        if len(tree) > tree_size_limit or r.overflow:
            raise FormatError("tree too large or truncated")
        to_decode -= 1
        prop1 = reader.read_hybrid_uint(K_PROPERTY_CTX, r)
        if prop1 > 256:
            raise FormatError("invalid tree property")
        prop = prop1 - 1
        if prop == -1:
            predictor = reader.read_hybrid_uint(K_PREDICTOR_CTX, r)
            if predictor >= NUM_PREDICTORS:
                raise FormatError("invalid predictor")
            offset = unpack_signed(reader.read_hybrid_uint(K_OFFSET_CTX, r))
            mul_log = reader.read_hybrid_uint(K_MULTIPLIER_LOG_CTX, r)
            if mul_log >= 31:
                raise FormatError("invalid multiplier log")
            mul_bits = reader.read_hybrid_uint(K_MULTIPLIER_BITS_CTX, r)
            if mul_bits >= (1 << (31 - mul_log)) - 1:
                raise FormatError("invalid multiplier")
            multiplier = (mul_bits + 1) << mul_log
            tree.append(TreeNode(-1, 0, leaf_id, 0, predictor, offset,
                                 multiplier))
            leaf_id += 1
            continue
        splitval = unpack_signed(reader.read_hybrid_uint(K_SPLITVAL_CTX, r))
        tree.append(TreeNode(prop, splitval,
                             len(tree) + to_decode + 1,
                             len(tree) + to_decode + 2))
        to_decode += 2
    validate_tree(tree)
    return tree


def validate_tree(tree: list[TreeNode]) -> None:
    """Range-consistency check (dec_ma.cc:39-105), simplified recursion."""
    if not tree:
        return
    import sys
    limits = {}

    def walk(idx: int, depth: int):
        if depth > 2048:
            raise FormatError("tree too tall")
        node = tree[idx]
        if node.is_leaf:
            return
        p = node.property
        lo, hi = limits.get(p, (-(1 << 31), (1 << 31) - 1))
        if lo > node.splitval or hi <= node.splitval:
            raise FormatError("invalid tree split")
        limits[p] = (node.splitval + 1, hi)
        walk(node.lchild, depth + 1)
        limits[p] = (lo, node.splitval)
        walk(node.rchild, depth + 1)
        limits[p] = (lo, hi)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        walk(0, 0)
    finally:
        sys.setrecursionlimit(old)


def num_tree_contexts(tree: list[TreeNode]) -> int:
    return (len(tree) + 1) // 2


def tree_tokens(tree: list[TreeNode]):
    """Serialize tree to (context, value) tokens in decode order
    (enc_ma.cc TreeToTokens equivalent)."""
    tokens = []
    for node in tree:
        if node.is_leaf:
            tokens.append((K_PROPERTY_CTX, 0))
            tokens.append((K_PREDICTOR_CTX, node.predictor))
            tokens.append((K_OFFSET_CTX, pack_signed(node.predictor_offset)))
            mul = node.multiplier
            mul_log = (mul & -mul).bit_length() - 1
            tokens.append((K_MULTIPLIER_LOG_CTX, mul_log))
            tokens.append((K_MULTIPLIER_BITS_CTX, (mul >> mul_log) - 1))
        else:
            tokens.append((K_PROPERTY_CTX, node.property + 1))
            tokens.append((K_SPLITVAL_CTX, pack_signed(node.splitval)))
    return tokens


def write_tree(w: BitWriter, tree: list[TreeNode]) -> None:
    """Histograms + token stream for the tree itself."""
    tokens = tree_tokens(tree)
    arr = tokens_to_array(tokens)
    codes = build_entropy_codes([arr], K_NUM_TREE_CONTEXTS)
    write_entropy_codes(w, codes)
    write_tokens(w, arr, codes)


def max_property_used(tree: list[TreeNode]) -> int:
    m = -1
    for n in tree:
        if not n.is_leaf:
            m = max(m, n.property)
    return m
