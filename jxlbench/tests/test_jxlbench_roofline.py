"""The kernels' byte counts reproduce PERF.md section 6's hand counts at
3840x2160."""

import pytest

from jxlbench import registry

CELL = registry.resolve(registry.benchmark()["workloads"][0]["name"])


def test_gaborish_bytes_at_4k():
    b, f = CELL.roofline("gaborish").cost(2160, 3840)
    assert round(b / 1e6, 1) == 199.1
    assert f == 33 * 2160 * 3840


@pytest.mark.parametrize("pass_id,flops", [(0, 305), (1, 105), (2, 89)])
def test_epf_bytes_at_4k(pass_id, flops):
    b, f = CELL.roofline("epf").cost(2160, 3840, pass_id)
    assert round(b / 1e6, 1) == 199.6
    assert f == flops * 2160 * 3840


def test_pack_bytes_at_4k():
    """At buffer capacity (128 words a chunk) the count is section 6's
    213.2 MB; the metric counts the words at the stream's bits instead."""
    chunks = 135 * 3 * 256 * 256 // 128
    capacity = chunks * 128 * 4
    b, _ = CELL.roofline("pack").cost(2160, 3840, 3, capacity)
    assert round(b / 1e6, 1) == 213.2
    b_real, _ = CELL.roofline("pack").cost(2160, 3840, 3, 14_000_000)
    assert b_real < b
