"""Encoder statistics / bit accounting (reference ``include/jxl/stats.h``
JxlEncoderStats + ``lib/jxl/enc_aux_out.h`` AuxOut layers).

Usage mirrors JxlEncoderCollectStats: create an :class:`EncoderStats`,
activate it around any encode call, read the totals afterwards::

    stats = EncoderStats()
    with stats.collect():
        data = encode_lossy(img, opts)
    stats.as_dict()["ac_bits"]

Encoders record into the active collector via :func:`record` /
:func:`add_blocks`; collection is thread-local so concurrent serving
threads do not cross-contaminate (the reference aggregates with
JxlEncoderStatsMerge; here each thread collects its own and merges)."""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field, fields

_ACTIVE = threading.local()


# layer names follow enc_aux_out.h:19-106 / stats.h JXL_ENC_STAT_*
@dataclass
class EncoderStats:
    num_base_pixels: int = 0
    num_ac_pixels: int = 0
    header_bits: int = 0
    toc_bits: int = 0
    dictionary_bits: int = 0       # patches
    splines_bits: int = 0
    noise_bits: int = 0
    quant_bits: int = 0            # quantizer + dequant tables
    modular_tree_bits: int = 0
    modular_global_bits: int = 0
    dc_bits: int = 0
    modular_dc_group_bits: int = 0
    control_fields_bits: int = 0   # acs/qf/epf metadata
    coef_order_bits: int = 0
    ac_histogram_bits: int = 0
    ac_bits: int = 0
    modular_ac_group_bits: int = 0
    num_butteraugli_iters: int = 0
    # block-strategy census (stats.h NUM_*_BLOCKS)
    num_blocks: dict = field(default_factory=dict)

    @contextmanager
    def collect(self):
        prev = getattr(_ACTIVE, "stats", None)
        _ACTIVE.stats = self
        try:
            yield self
        finally:
            _ACTIVE.stats = prev

    def merge(self, other: "EncoderStats") -> None:
        """JxlEncoderStatsMerge: element-wise accumulate."""
        for f in fields(self):
            if f.name == "num_blocks":
                for k, v in other.num_blocks.items():
                    self.num_blocks[k] = self.num_blocks.get(k, 0) + v
            else:
                setattr(self, f.name,
                        getattr(self, f.name) + getattr(other, f.name))

    def as_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)
             if f.name != "num_blocks"}
        d["num_blocks"] = dict(self.num_blocks)
        d["total_bits"] = self.total_bits
        return d

    @property
    def total_bits(self) -> int:
        return sum(getattr(self, f.name) for f in fields(self)
                   if f.name.endswith("_bits"))


def active() -> EncoderStats | None:
    return getattr(_ACTIVE, "stats", None)


@contextmanager
def suppress():
    """Pause collection (e.g. around the butteraugli-loop's interim
    roundtrip encodes, whose bits never reach the output stream)."""
    prev = getattr(_ACTIVE, "stats", None)
    _ACTIVE.stats = None
    try:
        yield
    finally:
        _ACTIVE.stats = prev


def record(layer: str, bits: int) -> None:
    """Add ``bits`` to ``layer`` (e.g. "ac", "header") if collecting."""
    st = active()
    if st is not None:
        setattr(st, layer + "_bits", getattr(st, layer + "_bits") + bits)


def record_count(name: str, n: int = 1) -> None:
    st = active()
    if st is not None:
        setattr(st, name, getattr(st, name) + n)


def add_blocks(strategy_name: str, n: int) -> None:
    st = active()
    if st is not None:
        st.num_blocks[strategy_name] = \
            st.num_blocks.get(strategy_name, 0) + n
