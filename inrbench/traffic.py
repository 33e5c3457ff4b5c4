"""The one traffic generator: every cell's inputs from its traffic file and
the run's seed.

A traffic file is JSON under ``inrbench/traffic/``; its ``loop`` says how
requests are offered (``closed`` or ``fit``) and the rest are parameters
of that loop.  The seed never changes how much work a run holds: it moves
the sampling of the pixel grid and makes the weights, never the sizes.
"""

from __future__ import annotations

import torch


def grid(h: int, w: int, device, dtype=torch.float32):
    """The ``h x w`` pixel-centre grid of ``[-1, 1]^2``, ``[h*w, 2]``, rows
    in raster order, columns (x, y)."""
    ys = (torch.arange(h, device=device, dtype=dtype) + 0.5) * (2.0 / h) - 1
    xs = (torch.arange(w, device=device, dtype=dtype) + 0.5) * (2.0 / w) - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).contiguous()


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def subpixel_shifts(seed: int, n: int, h: int, w: int, device):
    """``[n, 2]`` offsets, each uniform within one pixel of the ``h x w``
    grid (so every request edits a different sampling of the image)."""
    g = generator(seed, device)
    u = torch.rand(n, 2, generator=g, device=device) - 0.5
    return u * torch.tensor([2.0 / w, 2.0 / h], device=device)
