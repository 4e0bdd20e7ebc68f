"""The dead-leaves generator is deterministic by seed."""

import torch

from jxlbench.images import dead_leaves, image_seed


def test_same_seed_same_image():
    a = dead_leaves(2**33 + 11, 0, 96, 160)
    b = dead_leaves(2**33 + 11, 0, 96, 160)
    assert a.shape == (96, 160, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b)


def test_seed_and_index_change_the_image():
    a = dead_leaves(5, 0, 96, 160)
    assert not torch.equal(a, dead_leaves(6, 0, 96, 160))
    assert not torch.equal(a, dead_leaves(5, 1, 96, 160))


def test_parameters_come_from_the_mix():
    quiet = dead_leaves(5, 0, 96, 160, {"noise_sigma": 0.0, "blur_sigma": 0})
    noisy = dead_leaves(5, 0, 96, 160, {"noise_sigma": 8.0, "blur_sigma": 0})
    d = (quiet.float() - noisy.float()).std()
    assert 6 < d < 10


def test_image_seed_takes_large_seeds():
    assert 0 <= image_seed(2**40 + 3, 15) < 2**63
