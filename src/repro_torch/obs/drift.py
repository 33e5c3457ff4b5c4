"""Model-vs-measured drift reports (port of ``repro.obs.drift``): when is
the cost oracle wrong about the card?

The compiler *predicts* performance: autoconfig picks hardware parameters
by the dataflow longest-path latency, the region scheduler fuses under
modeled HBM bytes per block, and the FIFO sizing pass guarantees deadlock
freedom for the configured depths.  This module checks those predictions
against what runs:

  * ``build_perf_model(plan, region_plan, config)`` — computed at COMPILE
    time and attached to every ``CompiledGradient`` as ``cg.perf_model``:
    per execution unit (fused region or singleton segment), the oracle's
    predicted row-cycles and modeled HBM bytes per block.  Its integers
    equal the reference's on the same graph.
  * ``drift_report(cg, coords)`` — times each unit on one block of rows,
    one unit at a time (on CUDA with a pair of CUDA events on the current
    stream around each launch, queued behind a spin kernel so that they
    bracket device time; on the CPU with the host clock; the median of
    ``iters``), and emits a ``DriftReport``: predicted-vs-measured share
    ratio per unit (1.0 = the oracle's relative weighting was exact), plus
    per-stream FIFO headroom — high-water occupancy under the configured
    depths against the depths themselves.

High-water occupancy is recomputed here with reads ordered BEFORE writes
at equal node times (a read frees its slot before a same-instant write
lands — the semantics of a depth-d FIFO whose write #n blocks on read
#(n-d)).  Under that ordering ``high_water <= configured depth`` holds by
construction for any non-deadlocked schedule, so a violation in a report is
a modeling bug, not an event-ordering artifact.
(``DataflowGraph.observed_depths`` keeps its writes-first ordering: it
*sizes* FIFOs, so it wants the conservative peak.)
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.dataflow import DataflowGraph, segment_row_cost
from repro_torch.core.executor import _run_region, _run_segment


# ---------------------------------------------------------------------------
# compile-time side: the oracle's per-unit predictions
# ---------------------------------------------------------------------------

def _unit_name(kind, u, plan) -> str:
    if kind == "region":
        segs = ",".join(f"s{s}" for s in u.segments)
        return f"region{u.id}[{segs}]"
    return f"seg{u.id}:{u.kind}"


def _row_bytes(g, nid: int) -> int:
    n = g.nodes[nid]
    cols = 1
    for d in n.shape[1:]:
        cols *= d
    return cols * np.dtype(n.dtype).itemsize


def _unit_hbm_bytes_per_block(plan, kind, u, block: int) -> int:
    """Modeled HBM traffic of ONE unit per pipeline block — the same
    accounting ``regions.region_hbm_bytes_per_block`` sums plan-wide,
    broken out per unit so drift can localize."""
    g = plan.graph
    total = 0
    if kind == "region" and u.fused:
        for i in u.stream_inputs:
            total += block * _row_bytes(g, i)
        for nid, cols in u.broadcast_inputs:
            total += block * cols * np.dtype(g.nodes[nid].dtype).itemsize
        for o in u.outputs:
            total += block * _row_bytes(g, o)
    else:
        seg = u if kind == "seg" else plan.segments[u.segments[0]]
        for i in seg.stream_inputs:
            total += block * _row_bytes(g, i)
        total += block * _row_bytes(g, seg.output)
    return total


def _execution_units(plan, region_plan, config):
    """The one schedule walk (mirrors ``CompiledGradient.resident_block_fn``):
    fused regions dispatch as region launches only with kernel dispatch
    on."""
    if region_plan is not None and config.use_pallas:
        return region_plan.units()
    return [("seg", s) for s in plan.segments]


def build_perf_model(plan, region_plan, config) -> list[dict]:
    """Per-unit predictions, recorded at compile time (cheap and
    deterministic — no timing, no search).  One dict per execution unit:

      name, kind, segments, predicted_row_cycles (per streamed row),
      predicted_cycles_block (x block rows), modeled_hbm_bytes_block
    """
    units = _execution_units(plan, region_plan, config)
    out = []
    for kind, u in units:
        segs = tuple(u.segments) if kind == "region" else (u.id,)
        rc = sum(segment_row_cost(plan, plan.segments[s],
                                  config.mm_parallel_for(s)) for s in segs)
        out.append({
            "name": _unit_name(kind, u, plan),
            "kind": ("FusedRegion" if kind == "region" and u.fused
                     else plan.segments[segs[0]].kind),
            "segments": segs,
            "predicted_row_cycles": int(rc),
            "predicted_cycles_block": int(rc) * config.block,
            "modeled_hbm_bytes_block": _unit_hbm_bytes_per_block(
                plan, kind, u, config.block),
        })
    return out


# ---------------------------------------------------------------------------
# FIFO headroom: configured depth vs runtime high-water occupancy
# ---------------------------------------------------------------------------

def fifo_high_water(design, depths: dict[int, int]) -> dict[int, int]:
    """Peak FIFO occupancy per stream under the schedule the configured
    ``depths`` induce, with reads ordered before writes at equal times
    (see module docstring) — so headroom against ``depths`` is never
    negative for a valid design."""
    dg = DataflowGraph(design)
    dead, _, times = dg.check(depths)
    if dead:
        raise ValueError("cannot measure headroom of a deadlocked design")
    out: dict[int, int] = {}
    for s in design.streams:
        events = [(times[r], 0, -1) for r in dg.reads[s]]
        events += [(times[w], 1, +1) for w in dg.writes[s]]
        events.sort()
        occ = peak = 0
        for (_, _, delta) in events:
            occ += delta
            peak = max(peak, occ)
        out[s] = peak
    return out


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@dataclass
class UnitDrift:
    name: str
    kind: str
    segments: tuple
    predicted_row_cycles: int
    predicted_cycles_block: int
    modeled_hbm_bytes_block: int
    measured_s: float            # median time per block execution
    predicted_share: float       # this unit's fraction of predicted cycles
    measured_share: float        # this unit's fraction of measured time
    drift: float                 # measured_share / predicted_share

    def as_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "segments": list(self.segments),
                "predicted_row_cycles": self.predicted_row_cycles,
                "predicted_cycles_block": self.predicted_cycles_block,
                "modeled_hbm_bytes_block": self.modeled_hbm_bytes_block,
                "measured_s": self.measured_s,
                "predicted_share": self.predicted_share,
                "measured_share": self.measured_share,
                "drift": self.drift}


@dataclass
class FifoHeadroom:
    stream: int
    configured: int
    high_water: int

    @property
    def headroom(self) -> int:
        return self.configured - self.high_water

    def as_dict(self) -> dict:
        return {"stream": self.stream, "configured": self.configured,
                "high_water": self.high_water, "headroom": self.headroom}


@dataclass
class DriftReport:
    order: int | None
    block: int
    units: list[UnitDrift]
    fifo: list[FifoHeadroom]
    dispatches_per_block: int
    total_predicted_cycles: int
    total_measured_s: float
    iters: int
    meta: dict = field(default_factory=dict)

    @property
    def max_drift(self) -> float:
        return max((u.drift for u in self.units), default=1.0)

    @property
    def min_headroom(self) -> int:
        return min((f.headroom for f in self.fifo), default=0)

    def as_dict(self) -> dict:
        return {"order": self.order, "block": self.block,
                "dispatches_per_block": self.dispatches_per_block,
                "total_predicted_cycles": self.total_predicted_cycles,
                "total_measured_s": self.total_measured_s,
                "iters": self.iters,
                "max_drift": self.max_drift,
                "min_headroom": self.min_headroom,
                "units": [u.as_dict() for u in self.units],
                "fifo": [f.as_dict() for f in self.fifo],
                "meta": dict(self.meta)}

    def describe(self) -> str:
        lines = [f"DriftReport(order={self.order}, block={self.block}, "
                 f"{len(self.units)} units, "
                 f"{self.dispatches_per_block} dispatches/block, "
                 f"iters={self.iters})",
                 f"  predicted {self.total_predicted_cycles} row-cycles/"
                 f"block vs measured {self.total_measured_s * 1e6:.1f}us/"
                 f"block; max unit drift {self.max_drift:.2f}x"]
        for u in self.units:
            lines.append(
                f"  {u.name}: predicted {u.predicted_share:.1%} of cycles, "
                f"measured {u.measured_share:.1%} of time "
                f"({u.measured_s * 1e6:.1f}us) -> drift {u.drift:.2f}x, "
                f"hbm/block {u.modeled_hbm_bytes_block}")
        hw = max((f.high_water for f in self.fifo), default=0)
        lines.append(f"  fifo: {len(self.fifo)} streams, max high-water "
                     f"{hw}, min headroom {self.min_headroom} "
                     f"(deadlock margin)")
        return "\n".join(lines)


# clock cycles of the spin kernel queued ahead of a timed unit (~0.5 ms
# on an H100): longer than the host takes to enqueue one unit
_SPIN_CYCLES = 1_000_000


def _timer(device: torch.device):
    """``time(fn) -> seconds`` of one call of ``fn``: CUDA events on the
    current stream around it on the card, the host clock on the CPU.  On
    the card a spin kernel runs first, so the host has enqueued the start
    event, the unit's launches and the end event before the card reaches
    them: the events bracket the unit's device time, not the host's
    launch latency."""
    if device.type == "cuda":
        def time_cuda(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time_cuda

    def time_host(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    return time_host


def drift_report(cg, coords=None, *, iters: int = 3,
                 warmup: int = 1) -> DriftReport:
    """Measure a ``CompiledGradient`` against its own compile-time model.

    Streams one block of ``coords`` (first ``cg.config.block`` rows,
    edge-padded if short; a [-1, 1] grid when omitted) through the
    artifact's execution units one unit at a time, timing each — median of
    ``iters`` after ``warmup`` untimed passes (the first pass also fills the
    unit's input environment and builds the kernels).  On the card each
    timed call sits between two CUDA events on the current stream; on the
    CPU the host clock times it.

    The per-unit drift ratio compares SHARES, not absolutes: the oracle
    predicts row-cycles (its own unit), the measurement is seconds, so the
    comparison is each unit's fraction of the total — a perfectly
    calibrated oracle gives every unit drift 1.0, and a unit with drift 2.0
    costs twice the fraction of time the model claimed.

    FIFO headroom comes from the artifact's (cached) dataflow summary:
    configured depths are the FIFO pass's ``depths_after``; high-water is
    the peak occupancy those depths induce (``fifo_high_water``)."""
    plan, g, cfg = cg.plan, cg.graph, cg.config
    block = cfg.block
    if len(plan.inputs) != 1:
        raise ValueError("drift_report measures single-input (coordinate) "
                         "pipelines")
    in_node = g.nodes[plan.inputs[0]]
    feat = tuple(in_node.shape[1:]) if in_node.shape else ()
    if coords is None:
        n_feat = 1
        for d in feat:
            n_feat *= d
        coords = torch.linspace(-1.0, 1.0, block * n_feat).reshape(
            (block,) + feat)
    coords = torch.as_tensor(coords, device=cg.device)
    xblk = coords[:block]
    if xblk.shape[0] < block:
        edge = xblk[-1:].expand((block - xblk.shape[0],)
                                + tuple(xblk.shape[1:]))
        xblk = torch.cat([xblk, edge])
    xblk = xblk.contiguous()

    units = _execution_units(plan, cg.region_plan, cfg)
    model = getattr(cg, "perf_model", None)
    if model is None:
        model = build_perf_model(plan, cg.region_plan, cfg)
    B = plan.batch

    def run_unit(kind, u, env):
        if kind == "region":
            _run_region(plan, u, env, cg.residents, block, B)
            return
        env[u.output] = _run_segment(plan, u, cg._decisions[u.id], env,
                                     cg.residents, block, B)

    timer = _timer(cg.device)
    env = {in_node.id: xblk}
    measured: list[float] = []
    for kind, u in units:
        for _ in range(max(1, warmup)):
            timer(lambda: run_unit(kind, u, env))
        measured.append(statistics.median(
            timer(lambda: run_unit(kind, u, env))
            for _ in range(max(1, iters))))

    total_pred = sum(m["predicted_cycles_block"] for m in model) or 1
    total_meas = sum(measured) or 1.0
    unit_drifts = []
    for m, meas in zip(model, measured):
        ps = m["predicted_cycles_block"] / total_pred
        ms = meas / total_meas
        unit_drifts.append(UnitDrift(
            name=m["name"], kind=m["kind"], segments=tuple(m["segments"]),
            predicted_row_cycles=m["predicted_row_cycles"],
            predicted_cycles_block=m["predicted_cycles_block"],
            modeled_hbm_bytes_block=m["modeled_hbm_bytes_block"],
            measured_s=meas,
            predicted_share=ps, measured_share=ms,
            drift=ms / ps if ps > 0 else float("inf")))

    df = cg.dataflow_summary()
    configured = df["fifo"].depths_after
    high = fifo_high_water(df["design"], configured)
    fifo = [FifoHeadroom(stream=s, configured=configured[s],
                         high_water=high[s]) for s in sorted(configured)]

    backend = (torch.cuda.get_device_name(cg.device)
               if cg.device.type == "cuda" else "cpu")
    return DriftReport(
        order=cg.order, block=block, units=unit_drifts, fifo=fifo,
        dispatches_per_block=len(cg.dispatch),
        total_predicted_cycles=int(total_pred),
        total_measured_s=float(total_meas), iters=iters,
        meta={"backend": backend, "config": cfg.describe()})
