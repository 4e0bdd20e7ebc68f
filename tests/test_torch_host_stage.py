"""The native class staging of the variable-block serving decode
(``libjxl_torch/utils/host_stage.py``, ``csrc/host_stage.cc``) against
its plain twin ``api/decoder._var_classes``, on the CPU: bit for bit
(values, dtypes, order, the classes' order) on the AC decoder's groups
of committed and freshly encoded var streams, and on run-packed groups
built to hold all 27 strategies, with classes whose values take int32."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_e7 import one_torch_thread  # noqa: E402,F401
from _torch_var_frames import TILINGS, _tile  # noqa: E402
from libjxl_torch.api import decoder as port  # noqa: E402
from libjxl_torch.core.fields import FormatError  # noqa: E402
from libjxl_torch.utils import host_stage  # noqa: E402
from libjxl_torch.vardct.ac_strategy import (  # noqa: E402
    COVERED_X, COVERED_Y,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture(name: str) -> bytes:
    with open(os.path.join(REPO, "tests", "data", "torch_vardct_var", name),
              "rb") as f:
        return f.read()


def _decoder_groups(data: bytes):
    """(run-packed groups in group order, raw quant) as
    ``_device_decode_inputs`` hands them to the staging."""
    dec, _, _, sections = port._parse_for_device(data)
    groups = dec.decode_ac_frame_native(sections)
    return [groups[g] for g in sorted(groups)], dec.raw_quant


def _sixteen_bit_e5() -> bytes:
    from libjxl_torch.vardct.frame_enc import LossyOptions, encode_lossy
    rng = np.random.default_rng(50)
    yy, xx = np.mgrid[0:64, 0:96]
    img = np.stack([xx * 700, yy * 1000, (xx + yy) * 400], -1)
    img = (img + rng.integers(0, 3000, img.shape)).clip(0, 65535)
    return encode_lossy(img.astype(np.uint16), LossyOptions(
        distance=1.0, effort=5, gaborish=1, epf=3))


def _assert_same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for s in want:
        assert len(got[s]) == len(want[s]) == 5
        for name, a, b in zip(("vals", "idx", "qf", "fy", "fx"), got[s],
                              want[s]):
            assert a.dtype == b.dtype and a.shape == b.shape, (s, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{s} {name}")


@pytest.mark.parametrize("stream", ["graphics_256x320_e7.jxl",
                                    "ragged_1001x1503_e5.jxl", "16-bit e5"])
def test_native_staging_equals_var_classes_on_decoded_groups(stream):
    data = _sixteen_bit_e5() if stream == "16-bit e5" else _fixture(stream)
    runs, raw_quant = _decoder_groups(data)
    want = port._var_classes(runs, raw_quant)
    assert len(want) > 1
    _assert_same(host_stage.var_classes(runs, raw_quant), want)
    if stream == "16-bit e5":
        assert port._device_decode_inputs(data)[1][6:8] == (16, "var")


def _synthetic_groups(seed: int):
    """Four 32 x 32-block groups of a 64 x 64-block frame, tiled by the
    tilings of ``tests/_torch_var_frames.py`` (all 27 strategies), in the
    AC decoder's run-packed layout, with random coefficients (about a
    third nonzero) and random raw quant. One class gets a value over
    32767 and one -32768 (both int32 then); one reaches 32767 (int16)."""
    rng = np.random.default_rng(seed)
    grid = 32
    runs = []
    for g, first in enumerate(TILINGS):
        anchors = _tile(rng, grid, first, [0, 1, 2, 3, 4, 6, 7, 12, 13])
        acs = np.full((grid, grid), -1, np.int8)
        anc = np.zeros((grid, grid), np.uint8)
        for s, by, bx in anchors:
            acs[by:by + COVERED_Y[s], bx:bx + COVERED_X[s]] = s
            anc[by, bx] = 1
        ys, xs = np.nonzero(anc)
        cover = [COVERED_X[s] * COVERED_Y[s] * 64 for s in acs[ys, xs]]
        total = sum(cover)
        assert total == grid * grid * 64
        coeffs = rng.integers(-40, 41, (3, total)) * (
            rng.random((3, total)) < 0.3)
        runs.append(((g % 2) * grid, (g // 2) * grid, grid, grid, acs, anc,
                     coeffs.astype(np.int32)))
    # extremes in the mixed group: strategy 5 over int16, 4 at -32768,
    # 6 at 32767 (values at each class's first block)
    _, _, _, _, acs, anc, coeffs = runs[3]
    ys, xs = np.nonzero(anc)
    strat = acs[ys, xs]
    offs = np.cumsum([0] + [COVERED_X[s] * COVERED_Y[s] * 64
                            for s in strat[:-1]])
    for s, v in ((5, 40000), (4, -32768), (6, 32767)):
        coeffs[1, offs[np.flatnonzero(strat == s)[0]] + 3] = v
    raw_quant = rng.integers(1, 200, (2 * grid, 2 * grid)).astype(np.int32)
    return runs, raw_quant


@pytest.mark.parametrize("seed", [3, 11])
def test_native_staging_equals_var_classes_on_all_strategies(seed):
    runs, raw_quant = _synthetic_groups(seed)
    want = port._var_classes(runs, raw_quant)
    assert sorted(want) == list(range(27))
    assert [want[s][0].dtype for s in (4, 5, 6)] == \
        [np.int32, np.int32, np.int16]
    got = host_stage.var_classes(runs, raw_quant)
    _assert_same(got, want)
    # and with the groups' planes as strided views of frame planes, as
    # the AC decoder hands them
    acs = np.zeros((64, 64), np.int8)
    anc = np.zeros((64, 64), np.uint8)
    views = []
    for (bx0, by0, w, h, a, n, c) in runs:
        acs[by0:by0 + h, bx0:bx0 + w] = a
        anc[by0:by0 + h, bx0:bx0 + w] = n
        views.append((bx0, by0, w, h, acs[by0:by0 + h, bx0:bx0 + w],
                      anc[by0:by0 + h, bx0:bx0 + w], c))
    _assert_same(host_stage.var_classes(views, raw_quant), want)


def test_native_staging_fills_the_arrays_it_is_given():
    runs, raw_quant = _synthetic_groups(5)
    counts = host_stage.count_classes(runs)
    out = [np.full(shape, 7, dtype) for shape, dtype in counts.specs()]
    classes = host_stage.fill_classes(counts, raw_quant, out)
    assert [id(a) for s in classes for a in classes[s]] == \
        [id(a) for a in out]
    _assert_same(classes, port._var_classes(runs, raw_quant))
    with pytest.raises(ValueError):
        host_stage.fill_classes(counts, raw_quant, out[:-1])


def test_native_staging_refuses_groups_it_cannot_read():
    runs, raw_quant = _synthetic_groups(5)
    bx0, by0, w, h, acs, anc, coeffs = runs[3]
    short = [(bx0, by0, w, h, acs, anc, coeffs[:, :-64])]
    with pytest.raises(FormatError):
        host_stage.count_classes(short)
    bad = acs.copy()
    bad[np.nonzero(anc)[0][0], np.nonzero(anc)[1][0]] = 27
    with pytest.raises(FormatError):
        host_stage.count_classes([(bx0, by0, w, h, bad, anc, coeffs)])
    counts = host_stage.count_classes(runs)
    with pytest.raises(FormatError):
        host_stage.fill_classes(counts, raw_quant[:40],
                                [np.empty(s, d) for s, d in counts.specs()])
