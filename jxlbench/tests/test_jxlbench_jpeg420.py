"""The recompressed-JPEG cell at a size a test run holds, on the CPU: the
plain reference against the port's host decode, the control (the
reference in TF32) failing the cell's limits, the generic set driver
catching a broken timed path, its reader of the new counter, the
roofline's byte count, the set's sha256 check (of committed streams and
of streams made at set-up), and the JPEG writer against libjpeg-turbo.

A small set of three 4:2:0 streams at 300x520 is made here as
``corpus/make_set.py`` makes the cell's (dead-leaves image, the JPEG of
``corpus/jpeg_writer.py``, ``encode_jpeg``; the reference's grids)."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest

from jxlbench import registry
from jxlbench.control import control_run
from jxlbench.harness import run_cell
from jxlbench.tests.test_jxlbench_faults import FAULTS, _break

CELL = "jpeg420_decode_12mp"
SHAPE = (300, 520)


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    """A set folder like ``corpus/jpeg420``: 3 streams, manifest, grids."""
    from jxlbench.corpus import make_set

    d = tmp_path_factory.mktemp("jpeg420_small")
    with open(os.path.join(registry.ROOT, "jxlbench", "corpus", "jpeg420",
                           "spec.json")) as f:
        spec = json.load(f)
    spec.update(shapes=[list(SHAPE)] * 3, qualities=[75, 90, 95],
                prefix="small", made_at_setup=False, device="cpu")
    with open(d / "spec.json", "w") as f:
        json.dump(spec, f)
    streams = make_set.make_streams(spec, jobs=1)
    manifest = {}
    for i, data in enumerate(streams):
        name = make_set.stream_name(spec, i, *SHAPE)
        (d / name).write_bytes(data)
        manifest[name] = dict(h=SHAPE[0], w=SHAPE[1], gab=False,
                              epf_iters=0, bytes=len(data),
                              sha256=hashlib.sha256(data).hexdigest())
    with open(d / "manifest.json", "w") as f:
        json.dump(manifest, f)
    make_set.make_grids(str(d), dict(zip(make_set.stream_names(spec),
                                         streams)), spec, jobs=1)
    return d


def _cell(root, set_dir, batch=3, groups=1):
    path = os.path.join(root, "jxlbench/traffic/decode_jpeg_12mp.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(corpus_dir=str(set_dir), batch=batch,
               check={"per_slot": 1, "groups": groups})
    with open(path, "w") as f:
        json.dump(mix, f)
    cell = registry.resolve(CELL, root)
    cell.config["decode"]["workers"] = 2
    return cell


def test_reference_matches_the_host_decode(small_set):
    from jxlbench.ref.jpeg_recompressed import decode_region, frame_info
    from libjxl_torch.api.decoder import decode

    for name in sorted(os.listdir(small_set)):
        if not name.endswith(".jxl"):
            continue
        data = (small_set / name).read_bytes()
        info = frame_info(data)
        px, box = decode_region(data, 0, 0, info["xgroups"],
                                info["ygroups"])
        assert box == (0, SHAPE[0], 0, SHAPE[1])
        d = np.abs(px.astype(int) - decode(data, device="cpu").astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 0.004


@pytest.mark.parametrize("grid", [False, True], ids=["regions", "grid"])
def test_control_fails(small_set, scratch_root, grid):
    cell = _cell(str(scratch_root), small_set, groups=2)
    checks = control_run(cell, 5, "cpu", grid)
    assert any(c.value > c.limit for c in checks), checks


def test_sound_run_is_correct_and_takes_the_route(small_set, scratch_root):
    cell = _cell(str(scratch_root), small_set)
    res, _ = run_cell(cell, 2**33 + 1, 1.0, trace=False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] % 3 == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, small_set, scratch_root, monkeypatch):
    import libjxl_torch.api.decoder as dec

    cell = _cell(str(scratch_root), small_set)
    _break(monkeypatch, cell, dec, "decode_many", fault)
    # decode_many counts its JPEG frames on the module's global name too
    dec.decode_many.jpeg_frames = 0
    res, _ = run_cell(cell, 2**33 + 1, 1.0, trace=False, device="cpu")
    assert not res["correct"], res["checks"]


def test_program_without_the_route_stops_at_setup(small_set, scratch_root,
                                                  monkeypatch):
    """A program whose ``decode_many`` sends the set's streams to its host
    path (as a program before the JPEG route did) fails in set-up, before
    the set is loaded or a call is timed."""
    import libjxl_torch.api.decoder as dec
    from jxlbench.drivers import decode_set

    def host_only(streams, workers=None, device=None):
        return [dec.decode(s, device="cpu") for s in streams]

    host_only.device_frames = 0
    monkeypatch.setattr(dec, "decode_many", host_only)
    loaded = []
    monkeypatch.setattr(decode_set, "load_set",
                        lambda path: loaded.append(path))
    cell = _cell(str(scratch_root), small_set)
    with pytest.raises(RuntimeError, match="device route"):
        run_cell(cell, 2**33 + 1, 1.0, trace=False, device="cpu")
    assert not loaded


def test_probe_of_a_set_made_at_setup_takes_the_route(small_set, tmp_path):
    from jxlbench.drivers import decode_set
    from jxlbench.ref.jpeg_recompressed import frame_info
    from libjxl_torch.api.decoder import decode_many

    d = tmp_path / "made"
    d.mkdir()
    spec = json.loads((small_set / "spec.json").read_text())
    (d / "spec.json").write_text(json.dumps(dict(spec, made_at_setup=True)))
    data = decode_set.probe_stream(str(d))
    info = frame_info(data)
    assert (info["h"], info["w"]) == decode_set.PROBE_SHAPE
    before = decode_many.jpeg_frames
    out, = decode_many([data], workers=1, device="cpu")
    assert out.shape == decode_set.PROBE_SHAPE + (3,)
    assert decode_many.jpeg_frames == before + 1


def test_draws_without_replacement_hand_every_stream_each_round():
    from jxlbench.drivers import decode_set

    gen = np.random.default_rng(3)
    got = decode_set.draw({"batch": 8, "replace": False}, 4, gen)
    assert sorted(got[:4]) == sorted(got[4:]) == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        decode_set.draw({"batch": 6, "replace": False}, 4, gen)
    assert len(decode_set.draw({"batch": 8, "replace": True}, 24, gen)) == 8


def test_jpeg_frames_reader():
    from jxlbench.tests.test_jxlbench_metrics import _decode_run

    name, counter = "jpeg_frames_pct.decode", "decode_many.jpeg_frames"
    run = _decode_run()
    reader = run.cell.metric(name)
    assert counter in reader.COUNTERS
    assert reader.read(run) is None         # no counter read
    run.counters[counter] = 2
    assert reader.read(run) == pytest.approx(50)


def test_ycbcr_bytes_at_12mp():
    cell = registry.resolve(CELL)
    b, f = cell.roofline("ycbcr").cost(3024, 4032)
    assert b == 9 * 3024 * 4032 == 109_734_912
    assert round(b / 3.35e12 * 1e6, 1) == 32.8
    assert f == 24 * 3024 * 4032
    b_odd, _ = cell.roofline("ycbcr").cost(333, 517)
    assert b_odd == 7 * 333 * 517 + 8 * 167 * 259


def test_tampered_stream_fails_its_sha256(small_set, tmp_path):
    from jxlbench.drivers import decode_set

    d = tmp_path / "set"
    d.mkdir()
    for name in os.listdir(small_set):
        (d / name).write_bytes((small_set / name).read_bytes())
    decode_set.load_set(str(d))
    name = sorted(n for n in os.listdir(d) if n.endswith(".jxl"))[0]
    data = bytearray((d / name).read_bytes())
    data[len(data) // 2] ^= 1
    (d / name).write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="sha256"):
        decode_set.load_set(str(d))


def test_set_made_at_setup_is_held_to_its_manifest(small_set, tmp_path):
    """A ``made_at_setup`` set commits no streams: ``load_set`` makes
    them and checks each against the manifest's sha256."""
    from jxlbench.drivers import decode_set

    d = tmp_path / "made"
    d.mkdir()
    spec = json.loads((small_set / "spec.json").read_text())
    spec.update(made_at_setup=True, shapes=spec["shapes"][:2],
                qualities=spec["qualities"][:2])
    (d / "spec.json").write_text(json.dumps(spec))
    manifest = json.loads((small_set / "manifest.json").read_text())
    names = sorted(manifest)[:2]
    (d / "manifest.json").write_text(json.dumps(
        {n: manifest[n] for n in names}))
    metas, streams = decode_set.load_set(str(d))
    assert [m["name"] for m in metas] == names
    assert streams == [(small_set / n).read_bytes() for n in names]
    manifest[names[1]]["sha256"] = "0" * 64
    (d / "manifest.json").write_text(json.dumps(
        {n: manifest[n] for n in names}))
    with pytest.raises(RuntimeError, match="sha256"):
        decode_set.load_set(str(d))


@pytest.mark.parametrize("shape", [(1, 1), (17, 9), (37, 53), (300, 520)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_writer_equals_libjpeg_turbo(shape):
    """``corpus/jpeg_writer.py`` writes PIL's (libjpeg-turbo's) 4:2:0
    baseline file byte for byte, on odd sizes (partial MCUs, dummy
    blocks) and over the cell's qualities and beyond."""
    import io

    Image = pytest.importorskip("PIL.Image")
    from jxlbench.corpus.jpeg_writer import baseline_jpeg
    from jxlbench.images import dead_leaves

    h, w = shape
    rng = np.random.default_rng(h * w)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            dead_leaves(11, h * w, max(h, 32), max(w, 32), None, "cpu")
            .numpy()[:h, :w].copy()]
    for img in imgs:
        for q in (10, 50, 75, 80, 85, 90, 95, 100):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=q, subsampling=2)
            assert baseline_jpeg(img, q) == buf.getvalue(), (shape, q)
