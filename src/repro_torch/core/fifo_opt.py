"""The port's own copy of ``repro.core.fifo_opt`` (the port imports nothing of the
JAX package); keep the two in step.

FIFO depth optimization (paper Sec. 3.2.4, Table IV).

Algorithm, verbatim from the paper:
  1. Build the unconstrained dataflow graph (no WAR edges) and compute its
     longest-path latency — the design's PEAK performance.
  2. One stream at a time, constrain its depth to 2 (the minimum FIFO depth);
     re-estimate latency; if the design deadlocks or latency degrades by more
     than alpha (1%), DISCARD the constraint, else keep it.
  3. Simulate with the accepted constraints and take the observed peak
     occupancy (floored at 2) as the final depth for every stream.

The "before optimization" baseline is the design a developer would ship
without the analysis: every FIFO sized to its full array stream (n_blocks),
which is deadlock-free by construction (paper Table IV compares against
such default/naive sizing).  Since map_to_dataflow allocates FIFOs at
SegmentPlan granularity (fused segments exchange no streams), the observed
unconstrained depths are already near-minimal; naive sizing keeps "before"
meaningful at this granularity.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.config import HardwareConfig
from repro_torch.core.dataflow import DataflowDesign, DataflowGraph


@dataclass
class FifoOptResult:
    latency_peak: int                 # unconstrained longest path
    depths_before: dict[int, int]     # observed, unconstrained sim
    sum_before: int
    latency_before: int
    depths_after: dict[int, int]      # final optimized depths
    sum_after: int
    latency_after: int
    constrained: list[int]            # streams accepted at depth 2

    def summary(self) -> dict:
        return {
            "latency_peak": self.latency_peak,
            "sum_depths_before": self.sum_before,
            "latency_before": self.latency_before,
            "sum_depths_after": self.sum_after,
            "latency_after": self.latency_after,
            "depth_reduction": 1 - self.sum_after / max(self.sum_before, 1),
            "latency_overhead": self.latency_after / max(self.latency_before, 1) - 1,
        }


def optimize_fifo_depths(design: DataflowDesign, *, alpha: float | None = None,
                         min_depth: int = 2,
                         config: HardwareConfig | None = None) -> FifoOptResult:
    """``alpha`` (the latency-degradation budget) resolves: explicit kwarg >
    ``config.fifo_alpha`` > the paper's 1%."""
    if alpha is None:
        alpha = config.fifo_alpha if config is not None else 0.01
    dg = DataflowGraph(design)

    # 1. peak performance (unconstrained = no WAR edges)
    dead, latency_peak, _ = dg.check(None)
    assert not dead, "unconstrained dataflow graph must be acyclic"

    # 'before': naive sizing — every FIFO holds its whole array stream
    depths_before = {s: max(design.streams[s].n_blocks, min_depth)
                     for s in design.streams}
    dead_b, latency_before, _ = dg.check(depths_before)
    if dead_b:
        # full-size depths can still bind when a stream is written more
        # often than its block count (shouldn't happen): bump until clean
        depths_before = {s: d + 1 for s, d in depths_before.items()}
        dead_b, latency_before, _ = dg.check(depths_before)

    # 2. constrain each stream to min_depth if it doesn't hurt latency
    budget = latency_peak * (1 + alpha)
    accepted: dict[int, int] = {}
    constrained: list[int] = []
    for s in design.stream_ids():
        trial = dict(accepted)
        trial[s] = min_depth
        dead_t, lat_t, _ = dg.check(trial)
        if not dead_t and lat_t <= budget:
            accepted[s] = min_depth
            constrained.append(s)

    # 3. observed depths under the accepted constraints
    depths_after = dg.observed_depths(accepted, minimum=min_depth)
    # never exceed an accepted constraint
    for s in constrained:
        depths_after[s] = min_depth
    dead_a, latency_after, _ = dg.check(depths_after)
    if dead_a:
        # conservative fallback: revert to before-depths for offending streams
        depths_after = {s: max(depths_after[s], depths_before[s])
                        for s in depths_after}
        dead_a, latency_after, _ = dg.check(depths_after)
        assert not dead_a

    return FifoOptResult(
        latency_peak=latency_peak,
        depths_before=depths_before,
        sum_before=sum(depths_before.values()),
        latency_before=latency_before,
        depths_after=depths_after,
        sum_after=sum(depths_after.values()),
        latency_after=latency_after,
        constrained=constrained,
    )
