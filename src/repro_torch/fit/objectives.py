"""Fit objectives — order-n supervision targets over the streamed outputs
(port of ``repro.fit.objectives``).

An objective maps ONE block of pipeline outputs (the tuple
``CompiledGradient`` streams for serving: ``y``, then the order-1 gradients
per channel, then the order-2 rows per (channel, input), ... — the
``paper_gradients`` layout) plus a target block to a per-row loss vector.
The fit compiler masks and sums those rows across blocks, so an objective
never sees padding and never reduces across the grid itself.

Objectives are frozen dataclasses: hashable, so they key the compile-fit
cache next to the compiled artifact.  ``min_order`` is the smallest
gradient order whose streamed outputs the objective reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Objective:
    """Base: ``row_loss(outs, target, C, D)`` returns ``[rows]`` losses for
    one block; ``C``/``D`` are the INR's out/in features (fixes where each
    derivative lives in the streamed output tuple)."""
    min_order: int = 0

    def row_loss(self, outs, target, C: int, D: int):
        raise NotImplementedError

    def target_cols(self, C: int, D: int) -> int:
        """Trailing width of one target row (targets arrive ``[N, cols]``)."""
        raise NotImplementedError


@dataclass(frozen=True)
class ValueMSE(Objective):
    """Plain reconstruction: ``|y - t|^2`` summed over channels."""
    min_order: int = 0

    def row_loss(self, outs, target, C: int, D: int):
        return torch.sum((outs[0] - target) ** 2, dim=-1)

    def target_cols(self, C: int, D: int) -> int:
        return C


@dataclass(frozen=True)
class GradMSE(Objective):
    """First-order (Sobel-style) supervision: match the full Jacobian rows.
    Target layout is ``[N, C*D]`` — channel-major, the ``feature_vector``
    column order."""
    min_order: int = 1

    def row_loss(self, outs, target, C: int, D: int):
        dy = torch.cat([outs[1 + c] for c in range(C)], dim=-1)
        return torch.sum((dy - target) ** 2, dim=-1)

    def target_cols(self, C: int, D: int) -> int:
        return C * D


@dataclass(frozen=True)
class LaplacianMSE(Objective):
    """Second-order supervision: match the Laplacian trace
    ``sum_i d2y_c/dx_i^2`` per channel.  Target layout is ``[N, C]``."""
    min_order: int = 2

    def row_loss(self, outs, target, C: int, D: int):
        base = 1 + C                       # order-2 rows start after y + dy
        lap = []
        for c in range(C):
            rows = [outs[base + c * D + i][:, i] for i in range(D)]
            lap.append(sum(rows))
        lap = torch.stack(lap, dim=-1)
        return torch.sum((lap - target) ** 2, dim=-1)

    def target_cols(self, C: int, D: int) -> int:
        return C
