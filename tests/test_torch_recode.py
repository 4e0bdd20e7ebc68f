"""The serving path's choice of prefix code against the JAX package on
the CPU, where a sub-batch's words overflow the capacity estimate made
from the sub-batch before it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

CPU = "cpu"


@pytest.mark.parametrize("order", ["smooth_noise", "noise_smooth"])
def test_capacity_overflow_recodes_like_reference(order):
    """The serving path packs each sub-batch with sub-batch 0's code
    unless the words overflow the reference's capacity estimate (then
    the sub-batch is re-coded with its own histogram), or sub-batch 0
    chose the residual path (then every sub-batch uses its own code).
    Both orders of a smooth and a noise image hit one of these rules, and
    give the same two streams as the JAX package."""
    from bench import make_image
    from libjxl_tpu.api.encoder import encode_lossless_many as ref_many
    from libjxl_torch.api.encoder import EncodeOptions, encode_lossless_many
    smooth = make_image(1, 1024, 2100)
    noise = np.random.default_rng(3).integers(0, 256, smooth.shape,
                                              dtype=np.uint8)
    imgs = [smooth, noise] if order == "smooth_noise" else [noise, smooth]
    opts = EncodeOptions(use_device=True, entropy="prefix-device")
    got = encode_lossless_many(imgs, opts, device=CPU)
    assert got == ref_many(imgs, opts)
    alone = {id(im): encode_lossless_many([im], opts, device=CPU)[0]
             for im in imgs}
    assert got == [alone[id(im)] for im in imgs]
    from libjxl_tpu.utils.oracle import oracle_available
    if oracle_available():
        from libjxl_tpu.utils.oracle import oracle_decode
        for im, s in zip(imgs, got):
            assert np.array_equal(oracle_decode(s).pixels[:, :, :3], im)
    else:
        from libjxl_torch.api.decoder import decode_exact
        assert all(decode_exact(got, imgs, workers=2))
