"""The port's own copy of ``repro.core.autoconfig`` (the port imports nothing
of the JAX package); keep the two in step.  Two differences: the standard
measure hook (``make_apply_batched_measure``) times the port's
``apply_batched`` on the artifact's device, and the reference's CLI smoke is
not copied (``chip_smoke.py`` drives ``config="auto"`` on the card).

Automatic hardware-parameter configuration (paper Sec. 3.2.3-4).

INR-Arch's compiler "automatically configures hardware parameters such as
latency and stream depths to optimize throughput, while ensuring
deadlock-free operation".  This module is that step for the HardwareConfig
space (DESIGN.md §5): ``resolve_config(graph, plan)`` searches

  * the BLOCK granule — one value used for BOTH the execution pipeline and
    the dataflow FIFO model (unifying the old block-8-vs-dataflow-block-64
    split for auto-configured artifacts), and
  * the PER-MM-SEGMENT parallelism — a fixed parallelism budget (the FPGA's
    DSP pool; default = the base config's uniform allocation) redistributed
    across the plan's MatMul / FusedMmAct segments,

using the existing dataflow longest-path latency model (``DataflowGraph``)
as the analytic cost oracle.  Candidates whose deadlock analysis flags a
cycle under safe (naive full-stream) FIFO depths are REJECTED outright; the
winner is re-verified deadlock-free before it is returned.  Since the
dataflow step delays are CALIBRATED in row-cycles (``dataflow.OP_ROW_COST``:
per-block delay = block x per-row op cost), latencies at different block
granules compare directly — the longest path IS the row-cycle count.

On top of the block x MM-parallelism search, the region scheduler adds two
dimensions (DESIGN.md §7):

  * FUSED vs UNFUSED and the REGION CUT POINTS — the unfused base config is
    always scored (the winner is never worse than it), and the greedy cut
    refinement tries forcing a region boundary at each fused-region-internal
    segment, keeping cuts the oracle rewards;
  * the Pallas TILE SHAPE (``bm`` x ``bn``) — analytically neutral in the
    block-granular oracle, so it is searched only under the ``measure``
    hook, re-ranking tile variants of the winner by real wall time.

The analytic search (no ``measure`` hook) is deterministic — greedy
steepest-descent over a finite ladder — so a given graph always resolves to
the same config.  Under a ``measure`` hook it is not: the re-ranking follows
wall times, and near-ties may resolve differently from run to run.  On CUDA
``compile_gradient(config="auto")`` runs the hook by default, and the hook
times ``plan.batch`` rows, where every ``block`` and ``chunk_blocks``
candidate serves one chunk, so those two fields are ranked by host noise.
The compile cache stays coherent either way: the auto request is cached
beside the config it resolved to, so a process resolves it once.

Sharded serving (DESIGN.md §8): a base config with ``n_shards > 1`` makes
every candidate inherit the cross-shard input stream — the dataflow model
inserts one more FIFO edge per pipeline input (an ``xshard`` forwarder at
``xshard_row_cost`` row-cycles per row), so both the latency oracle and
the deadlock rejection account for the host -> shard interconnect hop.
``compile_gradient(config="auto", base_config=...)`` is the front-door
spelling; the serving engine stamps ``n_shards`` on its per-shard config
variants the same way.

An optional ``measure`` hook refines the analytic choice with on-device
timings: given a callable ``config -> seconds``, the block, tile-shape, and
``chunk_blocks`` candidates of the analytic winner are re-ranked by
measured wall time.
``make_apply_batched_measure`` builds the standard hook — it compiles each
candidate config (no re-trace) and times the artifact's real
``apply_batched`` serving path; ``compile_gradient(config="auto")`` feeds it
in by default on CUDA.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.config import DEFAULT_CONFIG, HardwareConfig
from repro_torch.core.dataflow import DataflowGraph, map_to_dataflow
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.segment import (FUSED_MM_ACT, MATMUL, SegmentPlan,
                                build_segment_plan)

# parallelism ladder per MM segment (the paper sweeps 16 and 64) and block
# granule candidates (must divide the plan batch)
MM_LADDER = (8, 16, 32, 64)
BLOCK_CANDIDATES = (8, 16, 32, 64)
# Pallas tile-shape ladder searched under the measure hook; (bm, bn) —
# the current tile leads so that measurement ties keep it
TILE_LADDER = ((128, 128), (256, 128), (128, 256), (256, 256), (512, 128))
# serving-chunk ladder (blocks per jitted lax.map chunk): the latency-vs-
# throughput trade of apply_batched, invisible to the block-granular oracle,
# so it is searched only under the measure hook (current value leads)
CHUNK_LADDER = (16, 32, 64, 128)
# greedy region-cut refinement bound (each accepted cut costs one more
# oracle sweep over the remaining boundaries)
MAX_REGION_CUTS = 4


@dataclass(frozen=True)
class Candidate:
    """One scored point of the search space."""
    block: int
    mm_parallel: tuple[tuple[int, int], ...]   # (segment id, parallelism)
    latency: int                               # oracle longest path
    row_cycles: int                            # == latency (calibrated costs)
    deadlocked: bool
    accepted: bool
    fused: bool = True                         # config.fuse_regions
    region_cuts: tuple[int, ...] = ()          # config.region_cuts


@dataclass(frozen=True)
class AutoConfigResult:
    config: HardwareConfig          # the winner (resolved, deadlock-free)
    predicted_latency: int          # oracle latency of the winner (block steps)
    predicted_row_cycles: int       # granularity-invariant cost of the winner
    baseline_latency: int           # oracle latency of the base config
    baseline_row_cycles: int
    mm_segments: tuple[int, ...]    # segment ids the allocation targeted
    candidates: tuple[Candidate, ...]   # every scored point, in search order

    @property
    def evaluated(self) -> int:
        return len(self.candidates)

    @property
    def rejected(self) -> int:
        return sum(1 for c in self.candidates if c.deadlocked)

    def describe(self) -> str:
        gain = (self.baseline_row_cycles / self.predicted_row_cycles
                if self.predicted_row_cycles else 1.0)
        return (f"autoconfig: {self.config.describe()} | predicted "
                f"{self.predicted_latency} steps ({self.predicted_row_cycles} "
                f"row-cycles, {gain:.2f}x vs default) after "
                f"{self.evaluated} candidates ({self.rejected} "
                f"deadlock-rejected)")


def result_as_dict(res: AutoConfigResult) -> dict:
    """JSON-serializable form of a search record — persisted with the
    artifact so a store-restored artifact keeps its autoconfig provenance."""
    return {
        "config": res.config.as_dict(),
        "predicted_latency": res.predicted_latency,
        "predicted_row_cycles": res.predicted_row_cycles,
        "baseline_latency": res.baseline_latency,
        "baseline_row_cycles": res.baseline_row_cycles,
        "mm_segments": list(res.mm_segments),
        "candidates": [
            {"block": c.block,
             "mm_parallel": [list(p) for p in c.mm_parallel],
             "latency": c.latency, "row_cycles": c.row_cycles,
             "deadlocked": c.deadlocked, "accepted": c.accepted,
             "fused": c.fused, "region_cuts": list(c.region_cuts)}
            for c in res.candidates],
    }


def result_from_dict(d: dict) -> AutoConfigResult:
    """Inverse of ``result_as_dict``."""
    return AutoConfigResult(
        config=HardwareConfig.from_dict(d["config"]),
        predicted_latency=int(d["predicted_latency"]),
        predicted_row_cycles=int(d["predicted_row_cycles"]),
        baseline_latency=int(d["baseline_latency"]),
        baseline_row_cycles=int(d["baseline_row_cycles"]),
        mm_segments=tuple(int(s) for s in d["mm_segments"]),
        candidates=tuple(
            Candidate(block=int(c["block"]),
                      mm_parallel=tuple((int(s), int(p))
                                        for s, p in c["mm_parallel"]),
                      latency=int(c["latency"]),
                      row_cycles=int(c["row_cycles"]),
                      deadlocked=bool(c["deadlocked"]),
                      accepted=bool(c["accepted"]),
                      fused=bool(c.get("fused", True)),
                      region_cuts=tuple(int(s)
                                        for s in c.get("region_cuts", ())))
            for c in d["candidates"]),
    )


# ---------------------------------------------------------------------------
# the analytic oracle
# ---------------------------------------------------------------------------

def _oracle(g: ComputeGraph, plan: SegmentPlan,
            config: HardwareConfig) -> tuple[bool, int]:
    """(deadlocked, longest-path latency) of the dataflow design for one
    config.  Deadlock is checked under NAIVE SAFE DEPTHS (every FIFO holds
    its whole stream) — a config that deadlocks even there has no workable
    FIFO sizing and is rejected; the latency is the unconstrained longest
    path, the paper's peak-performance estimate that FIFO optimization then
    preserves to within alpha."""
    design = map_to_dataflow(g, plan=plan, config=config,
                             block=config.dataflow_block)
    dg = DataflowGraph(design)
    naive = {s: max(design.streams[s].n_blocks, 2) for s in design.streams}
    dead, _, _ = dg.check(naive)
    _, latency, _ = dg.check(None)
    return dead, latency


def predicted_latency(g: ComputeGraph, config: HardwareConfig, *,
                      plan: SegmentPlan | None = None) -> int:
    """Longest-path dataflow latency (block steps) of ``config`` for this
    graph — the quantity autoconfig minimizes, exposed for benchmarks."""
    if plan is None:
        plan = build_segment_plan(g)
    dead, lat = _oracle(g, plan, config)
    if dead:
        raise ValueError("config deadlocks under naive safe FIFO depths")
    return lat


def _mm_segment_ids(plan: SegmentPlan) -> tuple[int, ...]:
    return tuple(s.id for s in plan.segments
                 if s.kind in (MATMUL, FUSED_MM_ACT))


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _resolve_config_impl(g: ComputeGraph, plan: SegmentPlan | None = None,
                   mode: str = "auto", *,
                   base: HardwareConfig | None = None,
                   mm_budget: int | None = None,
                   block_candidates: tuple[int, ...] = BLOCK_CANDIDATES,
                   mm_ladder: tuple[int, ...] = MM_LADDER,
                   tile_ladder: tuple = TILE_LADDER,
                   chunk_ladder: tuple[int, ...] = CHUNK_LADDER,
                   measure=None) -> AutoConfigResult:
    """Pick the HardwareConfig for ``g`` with the dataflow latency oracle.

    ``mode="auto"`` runs the search; ``mode="default"`` scores and returns
    the base config unchanged (useful for baselines).  ``mm_budget`` is the
    total parallelism pool shared by the MM segments — by default the base
    config's uniform allocation (``base.mm_parallel`` x number of MM
    segments), i.e. the same silicon redistributed to the critical path.
    ``measure``, if given, is a callable ``HardwareConfig -> seconds`` used
    to re-rank the analytic winner's block and tile-shape (``bm``/``bn``)
    candidates by real timings (``make_apply_batched_measure`` builds the
    standard hook from the artifact's serving path).

    The search covers block granule x per-MM-segment parallelism x region
    fusion (fused base, UNFUSED base, the ``region_packing="sum"`` v1
    scheduler as an extra floor — liveness packing is never chosen when the
    v1 estimator scores better — and greedy region-cut refinement of the
    winner).  The returned config never scores worse than any of those
    floors on the oracle, and is verified deadlock-free; every scored point
    is in ``.candidates``.  Under ``measure``, the block granule, the tile
    shape, and ``chunk_blocks`` (serving latency vs throughput) are each
    re-ranked by real wall time, current values leading so ties keep them.
    """
    if plan is None:
        plan = build_segment_plan(g)
    base = (base if base is not None else DEFAULT_CONFIG).resolved()
    batch = plan.batch or base.block
    base = base.clamped(batch)
    mm_segs = _mm_segment_ids(plan)
    log: list[Candidate] = []
    seen: dict[tuple, Candidate] = {}

    def score(config: HardwareConfig) -> Candidate:
        # memoized: the greedy ladder revisits configs (e.g. the winner is
        # re-scored at acceptance); each unique point costs one oracle call
        key = (config.dataflow_block, config.mm_parallel,
               config.mm_parallel_per_segment, config.fuse_regions,
               config.region_cuts, config.region_packing,
               config.vmem_budget, config.bm, config.bn)
        c = seen.get(key)
        if c is None:
            dead, lat = _oracle(g, plan, config)
            c = Candidate(block=config.dataflow_block,
                          mm_parallel=config.mm_parallel_per_segment,
                          latency=lat, row_cycles=lat,
                          deadlocked=dead, accepted=False,
                          fused=config.fuse_regions,
                          region_cuts=config.region_cuts)
            seen[key] = c
            log.append(c)
        return c

    base_cand = score(base)
    if base_cand.deadlocked:
        raise ValueError("base config deadlocks under naive safe FIFO "
                         "depths; no baseline to improve on")
    # the unfused default is the floor the winner must never fall below —
    # unless it deadlocks, in which case the fused base stands in (only
    # deadlock-free candidates may ever be chosen or set the floor)
    unfused_base = base.replace(fuse_regions=False, region_cuts=())
    unfused_cand = score(unfused_base) if base.fuse_regions else base_cand
    if unfused_cand.deadlocked:
        unfused_base, unfused_cand = base, base_cand
    # the v1 (sum-packed) region scheduler is one more floor: liveness
    # packing must never score worse than the v1 estimator it replaces
    floors = [(base_cand.row_cycles, 0, base, base_cand),
              (unfused_cand.row_cycles, 1, unfused_base, unfused_cand)]
    if base.fuse_regions and base.region_packing != "sum":
        sum_base = base.replace(region_packing="sum")
        sum_cand = score(sum_base)
        if not sum_cand.deadlocked:
            floors.append((sum_cand.row_cycles, 2, sum_base, sum_cand))

    def finish(chosen: HardwareConfig) -> AutoConfigResult:
        final = score(chosen)
        assert not final.deadlocked, "chosen config must be deadlock-free"
        log[log.index(final)] = dataclasses.replace(final, accepted=True)
        return AutoConfigResult(
            config=chosen, predicted_latency=final.latency,
            predicted_row_cycles=final.row_cycles,
            baseline_latency=base_cand.latency,
            baseline_row_cycles=base_cand.row_cycles,
            mm_segments=mm_segs, candidates=tuple(log))

    if mode == "default" or not mm_segs:
        return finish(base)
    if mode != "auto":
        raise ValueError(f"unknown autoconfig mode {mode!r}")

    budget = mm_budget if mm_budget is not None \
        else base.mm_parallel * len(mm_segs)
    ladder = tuple(sorted(set(mm_ladder)))
    blocks = tuple(b for b in sorted(set(block_candidates))
                   if batch % b == 0) or (base.block,)

    best = None                            # (row_cycles, block, config)
    for blk in blocks:
        found = _allocate_mm(base, blk, mm_segs, budget, ladder, score)
        if found is None:
            continue                       # every allocation deadlocked
        cfg, cand = found
        key = (cand.row_cycles, blk)
        if best is None or key < (best[0], best[1]):
            best = (cand.row_cycles, blk, cfg)

    floors.sort(key=lambda f: (f[0], f[1]))
    floor = floors[0][0]
    if best is None or best[0] > floor:
        # the search never beats the floors: keep the best of them
        # (deterministic tie-break: base > unfused > sum-packed)
        chosen = floors[0][2]
    else:
        chosen = best[2]

    if chosen.fuse_regions:
        chosen = _refine_region_cuts(plan, chosen, score)

    if measure is not None:
        # each unique config is timed at most once across both re-ranks
        timed_cache: dict[HardwareConfig, float] = {}

        def timed(cfg: HardwareConfig) -> float:
            t = timed_cache.get(cfg)
            if t is None:
                t = timed_cache[cfg] = measure(cfg)
            return t

    if measure is not None and len(blocks) > 1:
        # on-device refinement: same MM allocation, re-rank block granules
        # by measured wall time.  Only deadlock-free variants are timed —
        # the measure hook must never promote a config the deadlock
        # analysis would reject (the chosen config itself is always a
        # survivor, so the pool is never empty).
        variants = [chosen.replace(block=b, dataflow_block=b)
                    for b in blocks]
        safe = [v for v in variants if not score(v).deadlocked]
        if safe:
            chosen = min(safe, key=lambda v: (timed(v), v.block))
    if measure is not None and len(tile_ladder) > 1:
        # tile shapes are invisible to the block-granular oracle: searched
        # purely by measurement; the current tile is listed first so a
        # wall-time tie keeps it
        tiles = [(chosen.bm, chosen.bn)]
        tiles += [t for t in tile_ladder if t != tiles[0]]
        variants = [chosen.replace(bm=bm_, bn=bn_) for bm_, bn_ in tiles]
        best_i = min(range(len(variants)),
                     key=lambda i: (timed(variants[i]), i))
        chosen = variants[best_i]
    if measure is not None and len(chunk_ladder) > 1:
        # chunk_blocks trades serving latency (small chunks retire sooner)
        # against throughput (big chunks amortize the lax.map dispatch);
        # purely a host-pipeline knob, invisible to the oracle, so it is
        # searched only by measurement — current value first so a wall-time
        # tie keeps it
        chunks = [chosen.chunk_blocks]
        chunks += [c for c in chunk_ladder if c != chunks[0]]
        variants = [chosen.replace(chunk_blocks=c) for c in chunks]
        best_i = min(range(len(variants)),
                     key=lambda i: (timed(variants[i]), i))
        chosen = variants[best_i]

    return finish(chosen)


def resolve_config(g: ComputeGraph, plan: SegmentPlan | None = None,
                   mode: str = "auto", **kw) -> AutoConfigResult:
    """Pick the HardwareConfig with the dataflow latency oracle — see
    ``_resolve_config_impl`` for the search itself and every parameter.
    This wrapper is the telemetry boundary: the whole search runs under a
    ``compile.autoconfig`` span, and the searched/candidate counts land on
    the obs registry (``autoconfig_searches`` / ``autoconfig_candidates``)."""
    from repro_torch.obs.metrics import counter
    from repro_torch.obs.tracing import TRACER
    with TRACER.span("compile.autoconfig", cat="compile", mode=mode) as sp:
        res = _resolve_config_impl(g, plan, mode, **kw)
        sp.set(candidates=len(res.candidates),
               predicted_row_cycles=res.predicted_row_cycles)
    counter("autoconfig_searches", "resolve_config invocations").inc()
    counter("autoconfig_candidates",
            "configs scored by the autoconfig oracle").inc(
        len(res.candidates))
    return res


def _refine_region_cuts(plan: SegmentPlan, chosen: HardwareConfig,
                        score) -> HardwareConfig:
    """Greedy region-cut refinement: try forcing a region boundary at each
    segment internal to a fused region of the current schedule; keep the cut
    that most reduces the oracle latency, repeat (bounded) while improving.
    Deterministic — ties break toward the lowest segment id."""
    from repro_torch.core.regions import build_region_plan
    cur = score(chosen)
    for _ in range(MAX_REGION_CUTS):
        rplan = build_region_plan(plan, chosen)
        boundaries = [sid for r in rplan.fused_regions()
                      for sid in r.segments[:-1]]
        best_step = None                   # (latency, sid, config, cand)
        for sid in boundaries:
            trial = chosen.replace(
                region_cuts=chosen.region_cuts + (sid,))
            cand = score(trial)
            if cand.deadlocked:
                continue
            if cand.latency < cur.latency and (
                    best_step is None
                    or (cand.latency, sid) < (best_step[0], best_step[1])):
                best_step = (cand.latency, sid, trial, cand)
        if best_step is None:
            return chosen
        _, _, chosen, cur = best_step
    return chosen


def _allocate_mm(base: HardwareConfig, blk: int, mm_segs, budget: int,
                 ladder, score):
    """Greedy parallelism allocation at one block granule: start every MM
    segment at the ladder floor, then repeatedly promote the segment whose
    promotion most reduces the oracle latency, while the total stays within
    budget.  Deadlocked candidates are rejected (never promoted into).
    Deterministic: ties break toward the lowest segment id.  Returns
    ``(config, candidate)`` for the final allocation, or None when even the
    floor allocation deadlocks or exceeds the budget."""
    floor = ladder[0]
    alloc = {sid: floor for sid in mm_segs}
    if floor * len(mm_segs) > budget:
        return None

    def to_config(a) -> HardwareConfig:
        return base.replace(
            block=blk, dataflow_block=blk,
            mm_parallel_per_segment=tuple(sorted(a.items())))

    cur = score(to_config(alloc))
    if cur.deadlocked:
        return None
    while True:
        best_step = None                   # (latency, sid, level, candidate)
        for sid in mm_segs:
            i = ladder.index(alloc[sid])
            if i + 1 >= len(ladder):
                continue
            nxt = ladder[i + 1]
            if sum(alloc.values()) - alloc[sid] + nxt > budget:
                continue
            trial = dict(alloc)
            trial[sid] = nxt
            cand = score(to_config(trial))
            if cand.deadlocked:
                continue                   # rejected by deadlock analysis
            if cand.latency < cur.latency and (
                    best_step is None or
                    (cand.latency, sid) < (best_step[0], best_step[1])):
                best_step = (cand.latency, sid, nxt, cand)
        if best_step is None:
            return to_config(alloc), cur
        _, sid, nxt, cur = best_step
        alloc[sid] = nxt


# ---------------------------------------------------------------------------
# the standard measure hook: real apply_batched timings
# ---------------------------------------------------------------------------

def make_apply_batched_measure(g: ComputeGraph,
                               plan: SegmentPlan | None = None, *,
                               device=None, rows: int | None = None,
                               warmup: int = 1, iters: int = 3):
    """Build a ``measure`` hook that compiles each candidate config (back
    half of the compiler only — no re-trace) on ``device`` and times the
    artifact's REAL ``apply_batched`` serving path on a zero batch of
    ``rows`` rows (default: the plan batch): the median of ``iters`` calls
    after ``warmup``, each ended by ``torch.cuda.synchronize()`` on CUDA.
    Every timed candidate leaves a ``compile.autoconfig.measure`` span (its
    config and ms) on the tracer.  ``compile_gradient(config="auto")``
    passes this hook by default on CUDA."""
    import time

    import torch

    from repro_torch.core.executor import torch_dtype
    from repro_torch.kernels.common import resolve_device
    from repro_torch.obs.tracing import TRACER

    if plan is None:
        plan = build_segment_plan(g)
    device = resolve_device(device)
    inp = g.nodes[plan.inputs[0]]
    n = rows if rows is not None else (plan.batch or inp.shape[0])
    coords = torch.zeros((n,) + tuple(inp.shape[1:]),
                         dtype=torch_dtype(inp.dtype), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def measure(config: HardwareConfig) -> float:
        from repro_torch.core.pipeline import compile_from_graph
        with TRACER.span("compile.autoconfig.measure", cat="compile",
                         config=config.describe()) as sp:
            cg = compile_from_graph(g, config=config, plan=plan,
                                    device=device)
            for _ in range(max(1, warmup)):
                cg.apply_batched(coords)
                sync()
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                cg.apply_batched(coords)
                sync()
                times.append(time.perf_counter() - t0)
            t = sorted(times)[len(times) // 2]
            sp.set(ms=t * 1e3)
        return t
    return measure
