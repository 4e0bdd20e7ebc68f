"""Pieces the loop drivers share: the seeded random streams of a run and
a reservoir sample of the window's outputs for the check."""

from __future__ import annotations

import numpy as np

# streams of one run's seed: the window's draws, the reservoir, the check
DRAWS, RESERVOIR, CHECK, WARM = 1, 2, 3, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


class Reservoir:
    """A uniform sample of ``k`` of all the outputs offered to it."""

    def __init__(self, k: int, gen: np.random.Generator):
        self.k, self.gen, self.seen, self.items = k, gen, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.gen.integers(self.seen))
        if j < self.k:
            self.items[j] = item
