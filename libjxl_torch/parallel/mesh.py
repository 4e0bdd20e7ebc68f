"""Device mesh and sharding helpers (port of
``libjxl_tpu/parallel/mesh.py``).

Groups are THE parallel axis of JPEG XL (256x256 tiles are fully
independent on encode; SURVEY.md §2.2): the sharded paths split the
leading group (or row) axis of a pixel-shaped array over the slots of a
mesh, run the same code on each slot's piece, and combine the results
themselves (a sum for histograms, a concatenation in slot order for
pixels and words), where the reference lets XLA insert the collectives.

A mesh is an ordered list of slots, each naming a ``torch.device``. The
reference's mesh is one slot per ``jax.devices()`` entry; here
``make_mesh(n)`` deals ``n`` slots round-robin over the visible devices,
so several slots may name one device: the code that would put each
shard on its own card then runs every shard on that one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libjxl_torch.config import resolve_device


class Mesh(NamedTuple):
    """The slots of a mesh (``torch.device`` each, in shard order) and
    the name of the axis they split."""

    slots: tuple
    axis: str = "groups"

    @property
    def size(self) -> int:
        return len(self.slots)


def make_mesh(n_slots: int | None = None, device=None,
              axis: str = "groups") -> Mesh:
    """One slot per visible device of ``device``'s type (default
    ``config.device``; the CPU is one device), or ``n_slots`` slots dealt
    round-robin over those devices."""
    kind = resolve_device(device).type
    if kind == "cpu":
        devices = [torch.device("cpu")]
    elif kind == "cuda" and torch.cuda.device_count() > 0:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        raise RuntimeError(f"no visible {kind} device for a mesh")
    n = len(devices) if n_slots is None else int(n_slots)
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n}")
    return Mesh(tuple(devices[i % len(devices)] for i in range(n)), axis)


def shard_groups(mesh: Mesh, arr) -> list:
    """Split a (G, ...) array or tensor along its leading axis into one
    tensor per slot, each on its slot's device; G must be a multiple of
    the mesh size. ``shard_groups.calls`` counts the splits."""
    t = torch.as_tensor(arr)
    if t.shape[0] % mesh.size:
        raise ValueError(f"{t.shape[0]} groups do not split evenly over "
                         f"{mesh.size} slots")
    shard_groups.calls += 1
    return [part.to(slot) for part, slot in
            zip(torch.chunk(t, mesh.size), mesh.slots)]


shard_groups.calls = 0


def pad_groups_to_multiple(arr: np.ndarray, n: int):
    """Pad leading axis to a multiple of n (for even sharding)."""
    g = arr.shape[0]
    pad = (-g) % n
    if pad:
        arr = np.concatenate(
            [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)
    return arr, g
