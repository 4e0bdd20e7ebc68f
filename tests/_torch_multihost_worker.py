"""Worker of ``tests/test_torch_multihost.py``: one process of a gloo
group of ``nproc`` on the CPU, which runs the port's three multi-process
jobs in turn on the images of the JAX package's multi-host tests
(``tests/_multihost_worker.py``) and, on rank 0, writes each result to
``out_dir``: ``lossless.jxl``, ``vardct.jxl`` and ``decode.npy`` (the
decode of ``out_dir/decode.in``).

usage: _torch_multihost_worker.py <port> <rank> <nproc> <out_dir>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from libjxl_torch.config import config  # noqa: E402


def images():
    """The lossless and the VarDCT image of the JAX package's multi-host
    tests: 2348 rows, so 2 DC-group bands."""
    rng = np.random.default_rng(11)
    lossless = np.clip(np.cumsum(rng.integers(-2, 3, (2048 + 300, 320, 3)),
                                 axis=1), 0, 255).astype(np.uint8)
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:2048 + 300, 0:320]
    vardct = (np.stack([xx % 256, yy % 256, (xx + yy) % 256], -1)
              + rng.integers(0, 16, (2348, 320, 3))
              ).clip(0, 255).astype(np.uint8)
    return lossless, vardct


def main() -> None:
    from libjxl_torch.api.encoder import EncodeOptions
    from libjxl_torch.parallel.multihost import (
        decode_multihost, encode_lossless_multihost, encode_lossy_multihost,
    )
    from libjxl_torch.vardct.frame_enc import LossyOptions

    port, rank, nproc, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    config.device = "cpu"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=nproc, rank=rank)
    try:
        lossless, vardct = images()
        out = dict(
            lossless=encode_lossless_multihost(
                lossless, EncodeOptions(effort=2, group_size_shift=0)),
            vardct=encode_lossy_multihost(
                vardct, LossyOptions(distance=1.0, effort=3)))
        with open(os.path.join(out_dir, "decode.in"), "rb") as f:
            decoded = decode_multihost(f.read())
        if rank == 0:
            for name, data in out.items():
                with open(os.path.join(out_dir, name + ".jxl"), "wb") as f:
                    f.write(data)
            np.save(os.path.join(out_dir, "decode.npy"), decoded)
        elif any(v is not None for v in out.values()) or \
                decoded is not None:
            raise AssertionError("a rank other than 0 got a result")
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
