"""The port's VarDCT lossy encode against the JAX package on the CPU.

* the host encoder (``use_device=False``) gives the JAX host encoder's
  bytes at efforts 1-6, on a noise image and on a photo of several
  groups with ragged edges;
* the device path (``use_device=True``, ``device="cpu"``: the same torch
  program the card runs) gives the bytes of the JAX package's device
  path at efforts 1-4, and, on a noise image of the shape of
  ``tests/test_vardct_encoder.py``'s device test (120x200, d=1.5, e3),
  where the JAX package's device and host streams agree, its host
  stream;
* ``encode_lossy_many`` on the device gives the per-image streams, for
  one shape (one program a chunk of 4) and for mixed shapes;
* the paths that waited for ROADMAP A5 (effort >= 7, the device path at
  effort >= 5) now encode (their parity tests are
  ``test_torch_vardct_e7*.py``);
* the device program's sRGB curve equals the JAX package's float32 one
  on all 256 values, and its cube root is correctly rounded where
  float32 ``pow(x, 1/3)`` is not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from bench import make_image  # noqa: E402
from libjxl_torch.models import vardct_pipeline as VP  # noqa: E402
from libjxl_torch.vardct import frame_enc as port  # noqa: E402
from libjxl_tpu.vardct import frame_enc as ref  # noqa: E402


def _noise(h=120, w=200, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3)).astype(
        np.uint8)


IMAGES = dict(noise=_noise(), photo=make_image(3, 300, 333))


def _enc(mod, img, device=None, **kw):
    kw.setdefault("distance", 1.5)
    opts = mod.LossyOptions(**kw)
    if device is None:
        return mod.encode_lossy(img, opts)
    return mod.encode_lossy(img, opts, device=device)


@pytest.mark.parametrize("effort", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_host_encode_matches_jax(name, effort):
    img = IMAGES[name]
    assert _enc(port, img, effort=effort) == _enc(ref, img, effort=effort)


@pytest.mark.parametrize("effort", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_device_encode_matches_jax_device(name, effort):
    img = IMAGES[name]
    got = _enc(port, img, "cpu", effort=effort, use_device=True)
    assert got == _enc(ref, img, effort=effort, use_device=True)


def test_device_encode_matches_jax_host_stream():
    """The shape where the JAX package holds its own device stream to its
    host stream (tests/test_vardct_encoder.py)."""
    img = np.random.default_rng(1).integers(0, 255, (120, 200, 3)).astype(
        np.uint8)
    got = _enc(port, img, "cpu", effort=3, use_device=True)
    assert got == _enc(ref, img, effort=3)
    assert got == _enc(port, img, effort=3)


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(VP, name)

    def spy(px, *a, **k):
        calls.append(np.shape(px))
        return fn(px, *a, **k)

    monkeypatch.setattr(VP, name, spy)
    return calls


@pytest.mark.parametrize("n", [3, 5])
def test_encode_lossy_many_same_shape(n, monkeypatch):
    imgs = [make_image(10 + i, 72, 136) for i in range(n)]
    opts = port.LossyOptions(distance=1.0, effort=3, use_device=True)
    solo = [port.encode_lossy(im, opts, device="cpu") for im in imgs]
    calls = _spy(monkeypatch, "encode_lossy_frame_device_batch")
    got = port.encode_lossy_many(imgs, opts, workers=2, device="cpu")
    assert got == solo
    # chunks of 4 images
    assert [c[0] for c in calls] == [min(4, n - c) for c in range(0, n, 4)]
    assert solo[0] == ref.encode_lossy(imgs[0], ref.LossyOptions(
        distance=1.0, effort=3, use_device=True))


def test_encode_lossy_many_mixed_shapes(monkeypatch):
    imgs = [make_image(20, 72, 136), make_image(21, 40, 264)]
    opts = port.LossyOptions(distance=1.0, effort=2, use_device=True)
    solo = [port.encode_lossy(im, opts, device="cpu") for im in imgs]
    calls = _spy(monkeypatch, "encode_lossy_frame_device")
    got = port.encode_lossy_many(imgs, opts, workers=2, device="cpu")
    assert got == solo
    assert calls == [im.shape for im in imgs]


def test_encode_lossy_many_host_path():
    imgs = [make_image(30, 48, 64), _noise(40, 56)]
    opts = port.LossyOptions(distance=2.0, effort=5)
    assert port.encode_lossy_many(imgs, opts, workers=2) == \
        [ref.encode_lossy(im, ref.LossyOptions(distance=2.0, effort=5))
         for im in imgs]


@pytest.mark.parametrize("effort,use_device", [(7, False), (7, True),
                                               (9, False), (5, True),
                                               (6, True)])
def test_a5_paths_raise(effort, use_device):
    """The paths that raised NotImplementedError before A5 was ported
    give a stream of the image's shape."""
    from libjxl_torch.api.decoder import decode
    img = _noise(24, 32)
    data = port.encode_lossy(img, port.LossyOptions(
        effort=effort, use_device=use_device), device="cpu")
    assert decode(data).shape == img.shape


def test_device_payload_is_exact():
    """The payload holds every nonzero AC value at its exact count, and
    unpacks to the arrays of the device program."""
    img = IMAGES["photo"]
    opts = port.LossyOptions(distance=1.0, effort=3, use_device=True)
    opts._dispatch_only = True
    payload = port.encode_lossy(img, opts, device="cpu")
    yb, xb = -(-img.shape[0] // 8), -(-img.shape[1] // 8)
    q_ac, q_dc, ytox, ytob = VP.unpack_lossy_outputs(payload, yb, xb)
    assert len(payload.idx) == np.count_nonzero(q_ac) > 0
    assert not q_ac[..., 0].any()
    assert q_dc.shape == (yb, xb, 3) and ytox.shape == ytob.shape == (
        -(-yb // 8), -(-xb // 8))
    batch = VP.encode_lossy_frame_device_batch(
        np.stack([img, img]), *port._falcon_device_scalars(img.shape, opts),
        device="cpu")
    for p in batch:
        for a, b in zip(VP.unpack_lossy_outputs(p, yb, xb),
                        (q_ac, q_dc, ytox, ytob)):
            np.testing.assert_array_equal(a, b)


def test_srgb_curve_matches_jax():
    import jax.numpy as jnp
    v = jnp.arange(256).astype(jnp.float32) / 255.0
    want = np.asarray(jnp.where(v <= 0.04045, v / 12.92,
                                ((v + 0.055) / 1.055) ** 2.4))
    np.testing.assert_array_equal(VP._srgb_table("cpu").numpy(), want)


def test_cbrt_is_correctly_rounded():
    """torch has no cbrt, and float32 pow(x, 1/3) is an ulp off on part
    of the inputs: the port's cbrt equals the cube root of each float32
    input taken in float64 and rounded once (numpy's cbrt in float64)."""
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.random(200_000).astype(np.float32) * 1.5,
        (10.0 ** rng.uniform(-12, 0, 50_000)).astype(np.float32),
        np.float32([1e-12, 0.0037930734, 1.0, 8.0, 0.125])])
    want = np.cbrt(x.astype(np.float64)).astype(np.float32)
    off = torch.from_numpy(x).pow(1 / 3).numpy() != want
    assert off.sum() > 1000            # the trap is in this sample
    got = VP.cbrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[off], want[off])
