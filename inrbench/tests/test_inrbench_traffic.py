"""Seeded inputs repeat exactly, and the seed never changes the work."""

from __future__ import annotations

import torch

from inrbench import traffic as gen


def test_grid_and_shifts():
    g = gen.grid(4, 8, "cpu")
    assert g.shape == (32, 2)
    assert torch.allclose(g[0], torch.tensor([-1 + 1 / 8, -1 + 1 / 4]))
    assert float(g.abs().max()) < 1
    s1 = gen.subpixel_shifts(2**31 + 1, 5, 4, 8, "cpu")
    s2 = gen.subpixel_shifts(2**31 + 1, 5, 4, 8, "cpu")
    assert torch.equal(s1, s2)
    assert float(s1[:, 0].abs().max()) <= 0.5 * 2 / 8
    assert float(s1[:, 1].abs().max()) <= 0.5 * 2 / 4
    assert not torch.equal(s1, gen.subpixel_shifts(7, 5, 4, 8, "cpu"))


def test_weights_repeat_for_a_seed():
    from inrbench.reference import siren
    a = siren.init([2, 16, 1], 30.0, gen.generator(2**40, "cpu"), "cpu")
    b = siren.init([2, 16, 1], 30.0, gen.generator(2**40, "cpu"), "cpu")
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert float(a[0]["w"].abs().max()) <= 1 / 2
    assert float(a[1]["w"].abs().max()) <= (6 / 16) ** 0.5 / 30
