"""libjxl_torch.models.lossless and the port's encode paths against the
JAX package on the CPU: the same numpy-seeded inputs, integer outputs and
codestreams equal with no tolerance."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libjxl_torch.models import lossless as P  # noqa: E402
from libjxl_tpu.models import lossless as R  # noqa: E402

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(seed, h, w, c, bits=8):
    rng = np.random.default_rng(seed)
    hi = (1 << bits) - 1
    step = max(1, hi >> 6)
    img = np.cumsum(rng.integers(-step, step + 1, (h, w, c)), axis=1)
    img += np.cumsum(rng.integers(-step, step + 1, (h, w, c)), axis=0)
    return np.clip(img + hi // 2, 0, hi).astype(
        np.uint8 if bits == 8 else np.uint16)


def _groups(imgs, gd=128):
    groups = np.concatenate([R.frame_groups_host(im, gd)[0] for im in imgs])
    h, w, _ = imgs[0].shape
    return groups, h, w, -(-w // gd), (groups.shape[0] // len(imgs)
                                       if len(imgs) > 1 else 0)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_frame_groups_host(c):
    img = _image(c, 45, 300, c)
    for a, b in zip(R.frame_groups_host(img, 128),
                    P.frame_groups_host(img, 128)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("c,bits,n", [(1, 8, 1), (3, 8, 2), (4, 16, 2),
                                      (3, 16, 1)])
def test_probe_and_pass1_match(c, bits, n):
    imgs = [_image(10 * c + i, 150, 200, c, bits) for i in range(n)]
    groups, h, w, gx, per = _groups(imgs)
    g_t = P.upload_groups(groups, CPU)
    np.testing.assert_array_equal(
        np.asarray(R.lossless_hist_device(jnp.asarray(groups), h, w, gx=gx,
                                          per_image=per)),
        P.lossless_hist_device(g_t, h, w, gx=gx, per_image=per).numpy())
    wide_r, _, valid_r, payload_r = R.lossless_tokens_device(
        jnp.asarray(groups), h, w, gx=gx, per_image=per, out16=bits == 8)
    wide, valid, payload = P.lossless_tokens_device(g_t, h, w, gx=gx,
                                                    per_image=per)
    np.testing.assert_array_equal(np.asarray(wide_r).astype(np.int64),
                                  wide.numpy())
    np.testing.assert_array_equal(np.asarray(valid_r), valid.numpy())
    np.testing.assert_array_equal(np.asarray(payload_r), payload.numpy())


@pytest.mark.parametrize("c,bits,n", [(3, 8, 2), (4, 16, 1)])
def test_pack_fused_matches(c, bits, n):
    imgs = [_image(20 * c + i, 140, 150, c, bits) for i in range(n)]
    groups, h, w, gx, per = _groups(imgs)
    cst = P.random_prefix_state(np.random.default_rng(c))
    dense_r, cb_r = R.lossless_pack_fused(
        jnp.asarray(groups), h, w, jnp.asarray(cst["lut_bits"]),
        jnp.asarray(cst["lut_len"]), gx=gx, per_image=per,
        cap_words=1 << 19)
    dense, cb = P.lossless_pack_fused(P.upload_groups(groups, CPU), h, w,
                                      P.prefix_state_to_device(cst, CPU),
                                      gx=gx, per_image=per)
    np.testing.assert_array_equal(np.asarray(cb_r), cb.numpy())
    dense_r = np.asarray(dense_r)
    np.testing.assert_array_equal(dense_r[:dense.shape[0]], _u32(dense))
    assert not dense_r[dense.shape[0]:].any()


def test_chunk_pack_device_zero_bit_chunks():
    """Chunks with no valid token have 0 bits and 0 rows, so they share
    their start row with the next chunk: the compaction must still place
    every later chunk right, in runs of empty chunks and at the end."""
    rng = np.random.default_rng(11)
    cn = 12
    wide = np.minimum(rng.geometric(0.05, cn * 128) - 1, 4000)
    valid = np.ones(cn * 128, bool)
    for c in (1, 2, 5, 10, 11):
        valid[c * 128:(c + 1) * 128] = False
    valid[3 * 128 + 7:4 * 128] = False
    cst = P.random_prefix_state(rng)
    dense_r, cb_r = R.chunk_pack_device(
        jnp.asarray(wide.astype(np.uint16)), jnp.asarray(valid),
        jnp.asarray(cst["lut_bits"]), jnp.asarray(cst["lut_len"]),
        cap_words=1 << 12)
    dense, cb = P.chunk_pack_device(torch.from_numpy(wide),
                                    torch.from_numpy(valid),
                                    P.prefix_state_to_device(cst, CPU))
    cb_r = np.asarray(cb_r)
    assert (cb_r[[1, 2, 5, 10, 11]] == 0).all()
    np.testing.assert_array_equal(cb_r, cb.numpy())
    dense_r = np.asarray(dense_r)
    assert dense.shape[0] == 8 * int(((cb_r.astype(np.int64) + 255) >> 8)
                                     .sum())
    np.testing.assert_array_equal(dense_r[:dense.shape[0]], _u32(dense))
    assert not dense_r[dense.shape[0]:].any()


def test_prefix_state_to_device():
    from libjxl_tpu.api.encoder import _prefix_code_state
    imgs = [_image(5, 100, 130, 3)]
    groups, h, w, gx, per = _groups(imgs)
    payload = np.asarray(R.lossless_hist_device(jnp.asarray(groups), h, w,
                                                gx=gx))
    cst = _prefix_code_state(payload, groups.shape, np.uint8)
    lut = P.prefix_state_to_device(cst, CPU)
    # the formula chunk_pack_device applies before the TPU kernel
    want = ((cst["lut_len"].astype(np.int32) << 16)
            | cst["lut_bits"].astype(np.int32))[:96]
    assert lut.dtype == torch.int32
    np.testing.assert_array_equal(lut.numpy(), want)


@pytest.mark.parametrize("c,bits", [(1, 8), (3, 8), (3, 16), (4, 8)])
def test_encode_groups_device_matches(c, bits):
    img = _image(30 + c, 160, 290, c, bits)
    groups, h, w, gx, _ = _groups([img])
    payload_r, wide_r = R.encode_groups_device(
        jnp.asarray(groups), h, w, gx=gx, use_rct=c >= 3, out16=bits == 8)
    payload, wide = P.encode_groups_device(P.upload_groups(groups, CPU),
                                           h, w, gx=gx, use_rct=c >= 3)
    np.testing.assert_array_equal(np.asarray(payload_r), payload.numpy())
    np.testing.assert_array_equal(np.asarray(wide_r).astype(np.int64),
                                  wide.numpy())


@pytest.fixture
def ans_reference(monkeypatch):
    """The JAX package's ANS device path (``entropy="ans"``) reads an
    undefined module global ``wp_header`` when it writes group headers;
    give it the default WP header that GroupHeader() carries."""
    from libjxl_tpu.api import encoder as ref
    from libjxl_tpu.modular.codec import GroupHeader
    monkeypatch.setattr(ref, "wp_header", GroupHeader().wp_header,
                        raising=False)
    return ref


def test_ans_device_path_matches(ans_reference):
    from libjxl_tpu.api.decoder import decode
    from libjxl_torch.api import encoder as port
    opts = port.EncodeOptions(use_device=True)
    imgs = [_image(40, 300, 420, 3), _image(41, 130, 270, 1)[:, :, 0],
            _image(42, 200, 150, 3, 16)]
    many = port.encode_lossless_many(imgs, opts, device=CPU)
    assert many == ans_reference.encode_lossless_many(imgs, opts)
    for im, s in zip(imgs, many):
        assert s == port.encode_lossless(im, opts, device=CPU)
        assert np.array_equal(decode(s).reshape(im.shape), im)
    # alpha is declared as an extra channel, so RGBA round-trips
    rgba = _image(43, 140, 300, 4)
    s = port.encode_lossless(rgba, opts, device=CPU)
    assert np.array_equal(decode(s), rgba)


def test_native_library_built_before_worker_threads(monkeypatch):
    """A fresh process builds the native library on first use; the
    serving path must build it before its assemble threads ask for it
    (a thread that asks during another's build is told it is missing)."""
    import time

    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless_many
    from libjxl_torch.utils import native
    so_path = native._build()

    def slow_build():
        time.sleep(0.5)
        return so_path

    monkeypatch.setattr(native, "_build", slow_build)
    monkeypatch.setattr(native, "_lib", None)
    imgs = [_image(70, 60, 80, 3), _image(71, 70, 90, 3)]
    opts = EncodeOptions(use_device=True, entropy="prefix-device")
    want = [encode_lossless_many([im], opts, device=CPU)[0] for im in imgs]
    monkeypatch.setattr(native, "_lib", None)
    assert encode_lossless_many(imgs, opts, device=CPU) == want


def test_use_device_false_runs_host_encoder():
    from libjxl_tpu.api.encoder import encode_lossless as ref_encode
    from libjxl_torch.api.encoder import (
        EncodeOptions, encode_lossless, encode_lossless_many,
    )
    img = _image(50, 90, 110, 3)
    opts = EncodeOptions(effort=2)
    want = ref_encode(img, opts)
    assert encode_lossless(img, opts) == want
    assert encode_lossless_many([img], opts) == [want]


def test_device_is_explicit():
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless_many
    from libjxl_torch.config import config
    assert config.device == "cuda"
    if not torch.cuda.is_available():
        # no silent fallback to the CPU when the default card is missing
        with pytest.raises((RuntimeError, AssertionError)):
            encode_lossless_many(
                [_image(51, 64, 64, 3)],
                EncodeOptions(use_device=True, entropy="prefix-device"))


_BLOCKED = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails


class _NoReference:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "libjxl_tpu":
            raise ImportError("libjxl_tpu is blocked: " + name)
        return None


sys.meta_path.insert(0, _NoReference())
import numpy as np
import libjxl_torch
from libjxl_torch.api.decoder import decode, decode_many
from libjxl_torch.api.encoder import (
    EncodeOptions, encode_lossless, encode_lossless_many,
)
rng = np.random.default_rng(0)
imgs = [np.clip(np.cumsum(rng.integers(-3, 4, (130, 150, 3)), axis=1),
                0, 255).astype(np.uint8) for _ in range(2)]
imgs.append(imgs[0][:, :, 0])
outs = encode_lossless_many(
    imgs, EncodeOptions(use_device=True, entropy="prefix-device"),
    device="cpu")
outs.append(encode_lossless(imgs[0], EncodeOptions(effort=7)))
for im, s in zip(imgs + imgs[:1], outs):
    assert np.array_equal(decode(s).reshape(im.shape), im)
with open("tests/data/torch_vardct/rgb16_301x517.jxl", "rb") as f:
    lossy = f.read()
dev = decode_many([lossy], workers=2, device="cpu")[0]
host = decode(lossy)
assert dev.shape == host.shape == (301, 517, 3)
assert np.abs(dev.astype(int) - host.astype(int)).max() <= 4
assert decode_many.device_frames == 1
from libjxl_torch.config import config
from libjxl_torch.vardct.frame_enc import (
    LossyOptions, encode_lossy, encode_lossy_many,
)
photo = imgs[0]
lossy = encode_lossy_many([photo, photo], LossyOptions(
    effort=3, use_device=True), workers=2, device="cpu")
assert lossy[0] == lossy[1] == encode_lossy(photo, LossyOptions(effort=3))
config.device_filters = True
back = decode(lossy[0], device="cpu")
assert np.abs(back.astype(int) - photo.astype(int)).mean() < 4
assert not [m for m, mod in sys.modules.items()
            if mod is not None and m.split(".")[0] in ("jax", "libjxl_tpu")]
print("ok")
"""


def test_port_runs_with_jax_blocked():
    """The card machine has no JAX, and the port imports nothing of the
    JAX package: it encodes (lossless and lossy, host and device) and
    decodes (host and device filters) with both blocked."""
    for root, _, files in os.walk(os.path.join(REPO, "libjxl_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    src = fh.read()
                assert "import jax" not in src and "from jax" not in src, f
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
