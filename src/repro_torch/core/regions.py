"""The port's own copy of ``repro.core.regions`` (the port imports nothing of the
JAX package); keep the two in step.

Region scheduler — fuse adjacent segments into VMEM-resident megakernels.

The SegmentPlan (DESIGN.md §3) partitions the gradient graph into stream
kernels, but the executor still dispatches every segment as its own Pallas
call — each segment boundary round-trips a full ``(block, N)`` intermediate
through HBM, the exact data movement the paper's FIFO streams exist to
eliminate.  This module adds the fusion layer on top (DESIGN.md §7):

    SegmentPlan --build_region_plan--> RegionPlan --+--> executor (1 Pallas
                                                    |      call per region)
                                                    +--> codegen (1 fn/region)
                                                    +--> dataflow (intra-region
                                                           FIFOs collapse)

A ``FusedRegion`` is a maximal contiguous run of plan segments that

  * are all REGION-EXPRESSIBLE — StreamChain with a fused_chain spec,
    MatMul / FusedMmAct with a streamed 2-D lhs and resident rhs (exactly
    the segments the standalone Pallas kernels accept);
  * are CONNECTED — each joining segment consumes at least one tensor
    produced inside the region (fusing it removes >= 1 HBM round-trip);
  * fit the VMEM BUDGET — the region's working set at the ``bm`` row tile
    stays within ``HardwareConfig.vmem_budget``.  The working set is sized
    by a LIVENESS analysis (``region_packing="live"``, the default): each
    step output is charged only from its defining step to its last use, so
    the bound is the peak *live* bytes, not the sum of every output — and
    when even the live peak overflows, the scheduler COLUMN-TILES wide runs
    of steps at ``bn`` (see ``kernels.region.TileGroup``) before giving up
    and cutting.  ``region_packing="sum"`` restores the PR 5 estimator
    (every step output held for the whole region) as the conservative
    floor autoconfig scores against;
  * respect the config's explicit ``region_cuts`` (the cut points
    autoconfig searches).

Buffering segments and inexpressible chains become singleton regions that
keep the classic per-segment dispatch.  The greedy schedule is deterministic
for a given (plan, config), so region ids are stable targets, the compile
cache stays coherent, and the emitted source / dataflow mapping / executor
all derive from the same RegionPlan.

Row-constant resident chain extras are classified as ``bcast_rows``: they
enter the megakernel as one ``[1, C]`` VMEM row (broadcast on chip) instead
of a dispatcher-materialized ``[block, C]`` HBM operand — bit-identical and
strictly less HBM traffic.  Resident extras that are NOT row-constant keep
the streamed-broadcast fallback (``broadcast_inputs``).

One deliberate divergence: the region plan describes the SCHEDULE, and the
emitted source / dataflow mapping always follow it, but the executor engages
the region megakernel only when ``use_pallas`` resolves True — an
interpreted run (CPU default) executes segment-by-segment (identical
numerics, nothing to fuse), and ``cg.dispatch`` records that per-segment
interpretation.  This mirrors the pre-region behavior, where the emitted
source named Pallas kernels in its docstrings while an interpreted artifact
dispatched none of them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.config import HardwareConfig
from repro_torch.core.segment import (BUFFERING, FUSED_MM_ACT, MATMUL, STREAM_CHAIN,
                                Segment, SegmentPlan, _p, segment_dispatch)

CHAIN = "chain"
MM = "mm"
CONCAT = "concat"

FUSED_REGION = "FusedRegion"
REGION_KERNEL = "region"


# ---------------------------------------------------------------------------
# per-segment lowering: Segment -> region-kernel step (or None)
# ---------------------------------------------------------------------------

def _lower_segment(plan: SegmentPlan, seg: Segment):
    """Lower one segment to a region-kernel step tuple, or None when the
    segment is not expressible inside the megakernel (the region scheduler
    then makes it a singleton with the classic dispatch)."""
    g = plan.graph
    kernel = segment_dispatch(plan, seg)
    if kernel == "fused_chain":
        spec = seg.meta["chain"]
        return (CHAIN, seg.output, spec.x, spec.steps, spec.extras)
    if kernel == "stream_matmul":
        mm = g.nodes[seg.nodes[0]]
        return (MM, seg.output, mm.inputs[0], mm.inputs[1], None, 1.0, False)
    if kernel == "siren_layer":
        mm = g.nodes[seg.meta["mm"]]
        return (MM, seg.output, mm.inputs[0], mm.inputs[1],
                seg.meta["bias"], seg.meta["w0"], seg.meta["apply_sin"])
    if seg.kind == BUFFERING and len(seg.nodes) == 1:
        # a last-axis Concat of streamed 2-D tensors is row-wise — it
        # streams like an elementwise step (the filter bank's feature
        # assembly), so it need not cut the region
        n = g.nodes[seg.nodes[0]]
        if (n.op == "Concat" and len(n.shape) == 2
                and _p(n, "dimension") in (1, -1)
                and all(i not in plan.resident
                        and len(g.nodes[i].shape) == 2 for i in n.inputs)):
            return (CONCAT, seg.output, tuple(n.inputs))
    return None


# ---------------------------------------------------------------------------
# the region IR
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedRegion:
    """One execution unit of the region plan: a run of >= 1 segments.

    ``stream_inputs``    — external streamed tensors, read from HBM per block.
    ``broadcast_inputs`` — ``(node id, cols)`` resident chain extras the
                           dispatcher broadcasts to block shape (streamed
                           fallback for extras that are NOT row-constant).
    ``bcast_rows``       — ``(node id, row cols)`` row-constant resident
                           chain extras passed to the kernel as one
                           ``[1, C]`` VMEM row each (broadcast on chip,
                           no per-block HBM traffic).
    ``resident_inputs``  — whole-tensor VMEM operands (weights, biases).
    ``outputs``          — tensors leaving the region (consumed by another
                           region or graph outputs), written to HBM once.
    ``spec``             — the lowered ``RegionKernelSpec`` for fused
                           (multi-segment) regions; None for singletons,
                           which dispatch through the classic per-segment
                           path.
    ``meta``             — ``vmem_bytes`` (the packing estimate), and
                           ``col_tiles`` (max column tiles over the spec's
                           tile groups; 1 = untiled).
    """
    id: int
    segments: tuple[int, ...]
    stream_inputs: tuple[int, ...]
    broadcast_inputs: tuple[tuple[int, int], ...]
    resident_inputs: tuple[int, ...]
    outputs: tuple[int, ...]
    bcast_rows: tuple[tuple[int, int], ...] = ()
    spec: object = None
    meta: dict = field(default_factory=dict, compare=False)

    @property
    def fused(self) -> bool:
        return len(self.segments) > 1 and self.spec is not None

    @property
    def col_tiles(self) -> int:
        """Max column tiles across the region's tile groups (1 = untiled)."""
        return self.meta.get("col_tiles", 1)

    def describe(self, plan: SegmentPlan) -> str:
        segs = "+".join(f"s{s}" for s in self.segments)
        tag = "fused" if self.fused else \
            plan.segments[self.segments[0]].kind
        tiles = f" x{self.col_tiles}bn" if self.col_tiles > 1 else ""
        return (f"region{self.id}[{tag}{tiles}] {segs} "
                f"in={len(self.stream_inputs)}"
                f"+{len(self.bcast_rows) + len(self.broadcast_inputs)} "
                f"out={len(self.outputs)}")


@dataclass(eq=False)
class RegionPlan:
    plan: SegmentPlan
    regions: list[FusedRegion]
    region_of: dict[int, int]          # segment id -> region id
    config: HardwareConfig

    def fused_regions(self) -> list[FusedRegion]:
        return [r for r in self.regions if r.fused]

    def units(self) -> list[tuple[str, object]]:
        """Execution units in plan order: ``("region", FusedRegion)`` for
        fused regions, ``("seg", Segment)`` for singletons — the ONE
        schedule walk executor, codegen, and dataflow all share."""
        return [("region", r) if r.fused
                else ("seg", self.plan.segments[r.segments[0]])
                for r in self.regions]

    def counts(self) -> dict:
        fused = self.fused_regions()
        return {"regions": len(self.regions), "fused": len(fused),
                "segments_fused": sum(len(r.segments) for r in fused),
                "dispatches": len(self.regions)}

    def peak_vmem_bytes(self) -> int:
        """Largest fused-region working set of the plan (the number the
        ``regions --check`` gate tracks); 0 when nothing fused."""
        fused = self.fused_regions()
        if not fused:
            return 0
        return max(region_vmem_bytes(self.plan, r, self.config)
                   for r in fused)

    def describe(self) -> str:
        c = self.counts()
        lines = [f"RegionPlan: {c['regions']} regions ({c['fused']} fused "
                 f"covering {c['segments_fused']} segments) over "
                 f"{len(self.plan.segments)} segments"]
        lines += ["  " + r.describe(self.plan) for r in self.regions]
        return "\n".join(lines)

    # -- invariants --------------------------------------------------------
    def validate(self):
        plan = self.plan
        covered = [s for r in self.regions for s in r.segments]
        assert covered == [s.id for s in plan.segments], \
            "regions must cover every segment exactly once, in plan order"
        budget = self.config.vmem_budget
        cuts = set(self.config.region_cuts)
        for r in self.regions:
            if not r.fused:
                continue
            assert r.spec is not None
            assert region_vmem_bytes(plan, r, self.config) <= budget, \
                (r.id, "region exceeds the VMEM budget")
            # a forced cut is never fused across
            assert not any(s in cuts for s in r.segments[:-1]), \
                (r.id, "region fuses across a config cut point")
            # every member past the first consumes something from the region
            produced: set[int] = set()
            for sid in r.segments:
                seg = plan.segments[sid]
                if produced:
                    assert any(i in produced for i in seg.stream_inputs), \
                        (r.id, sid, "disconnected segment in region")
                produced.add(seg.output)
        return True


# ---------------------------------------------------------------------------
# byte accounting (the VMEM budget + the HBM-traffic model the benchmark
# and the dataflow mapping report)
# ---------------------------------------------------------------------------

def _row_bytes(g, nid: int) -> int:
    """Bytes of ONE row (axis-0 slice) of a streamed tensor."""
    n = g.nodes[nid]
    itemsize = np.dtype(n.dtype).itemsize
    if not n.shape:
        return itemsize
    return max(1, n.size // n.shape[0]) * itemsize


def _whole_bytes(g, nid: int) -> int:
    n = g.nodes[nid]
    return n.size * np.dtype(n.dtype).itemsize


def _is_row_extra(plan: SegmentPlan, nid: int) -> bool:
    """True when a resident chain extra is the same for every streamed row,
    so one ``[1, C]`` copy in VMEM broadcasts bit-identically on chip."""
    n = plan.graph.nodes[nid]
    return (nid in plan.rowconst or len(n.shape) <= 1
            or (len(n.shape) >= 2 and n.shape[0] == 1))


def _row_cols(plan: SegmentPlan, nid: int) -> int:
    n = plan.graph.nodes[nid]
    return n.shape[-1] if n.shape else 1


def _region_io(plan: SegmentPlan, members, consumers=None):
    """(stream_inputs, bcast_rows, broadcast_inputs, resident_inputs,
    outputs, steps) of a would-be region, or None when the members cannot
    share one kernel (conflicting streamed-broadcast shapes).  ``consumers``
    is the graph consumer map — pass it when calling in a loop (building it
    is O(graph))."""
    g = plan.graph
    if consumers is None:
        consumers = g.consumers()
    node_set = {n for seg, _ in members for n in seg.nodes}
    produced = {seg.output for seg, _ in members}
    stream_in: list[int] = []
    rows: dict[int, int] = {}          # row-const resident extras -> row cols
    bcast: dict[int, int] = {}         # streamed-broadcast fallback -> cols
    res_in: list[int] = []
    steps = []

    def want_stream(nid):
        if nid not in produced and nid not in stream_in:
            stream_in.append(nid)

    def want_res(nid):
        if nid not in res_in:
            res_in.append(nid)

    for seg, step in members:
        steps.append(step)
        if step[0] == CHAIN:
            _, out, x, chain_steps, extras = step
            want_stream(x)
            cols = g.nodes[out].shape[-1]
            for e in extras:
                if e in produced:
                    continue
                if e in plan.resident:
                    if _is_row_extra(plan, e):
                        rows[e] = _row_cols(plan, e)
                    else:
                        if bcast.get(e, cols) != cols:
                            return None        # one extra, two block shapes
                        bcast[e] = cols
                else:
                    want_stream(e)
        elif step[0] == CONCAT:
            _, out, xs = step
            for i in xs:
                want_stream(i)
        else:
            _, out, x, w, bias, _, _ = step
            want_stream(x)
            want_res(w)
            if bias is not None:
                want_res(bias)

    outputs = [seg.output for seg, _ in members
               if seg.output in g.outputs
               or any(c not in node_set for c in consumers[seg.output])]
    return (tuple(stream_in), tuple(sorted(rows.items())),
            tuple(sorted(bcast.items())), tuple(res_in),
            tuple(outputs), tuple(steps))


# ---------------------------------------------------------------------------
# column tiling: find runs of wide steps evaluable bn columns at a time
# ---------------------------------------------------------------------------

def _step_operands(step):
    """Streamed-value operands of one step (resident w/bias excluded)."""
    if step[0] == CHAIN:
        return (step[2],) + tuple(step[4])
    if step[0] == CONCAT:
        return tuple(step[2])
    return (step[2],)


def _node_width(g, nid: int) -> int:
    n = g.nodes[nid]
    return n.shape[-1] if n.shape else 1


def plan_col_tiles(plan: SegmentPlan, io, config: HardwareConfig) -> tuple:
    """Find column-tilable runs of the step program: maximal contiguous runs
    of steps with one shared output width ``W > bn`` whose outputs are
    consumed ONLY by later members or by the immediately following "reducer"
    MM (which contracts the ``W`` axis).  Such a run evaluates ``bn``
    columns at a time with the reducer accumulating partial products, so the
    wide intermediates cost ``bm*bn`` VMEM instead of ``bm*W`` —
    see ``kernels.region.TileGroup`` for the execution contract."""
    from repro_torch.kernels.region import TileGroup
    g = plan.graph
    bn = config.bn
    stream_in, rows, bcast, res_in, outputs, steps = io
    out_set = set(outputs)
    groups = []
    i = 0
    while i < len(steps):
        W = _node_width(g, steps[i][1])
        if W <= bn:
            i += 1
            continue
        # grow a run of width-W steps starting at i
        members: list[int] = []
        j = i
        while j < len(steps):
            step = steps[j]
            out = step[1]
            if members and step[0] == MM and step[2] in members:
                break                          # reducer candidate
            if step[0] == CONCAT:
                break                          # operand widths differ: untilable
            if _node_width(g, out) != W or out in out_set:
                break
            ok = True
            if step[0] == CHAIN:
                for op in _step_operands(step):
                    if op in members:
                        continue
                    if _node_width(g, op) not in (1, W):
                        ok = False
                        break
            else:                              # member MM: w cols sliced
                if step[2] in members:
                    ok = False                  # lhs must stay external
                else:
                    wn = g.nodes[step[3]]
                    ok = len(wn.shape) == 2 and wn.shape[1] == W
            if not ok:
                break
            members.append(out)
            j += 1
        valid = bool(members) and j < len(steps)
        if valid:
            red = steps[j]
            valid = (red[0] == MM and red[2] in members
                     and len(g.nodes[red[3]].shape) == 2
                     and g.nodes[red[3]].shape[0] == W)
        if valid:
            # member outputs must not escape past the reducer
            mset = set(members)
            for later in steps[j + 1:]:
                if any(op in mset for op in _step_operands(later)):
                    valid = False
                    break
        if valid:
            groups.append(TileGroup(members=tuple(members),
                                    reducer=red[1], width=W, bn=bn))
            i = j + 1
        else:
            i += 1
    return tuple(groups)


# ---------------------------------------------------------------------------
# VMEM packing: size the working set by peak LIVE bytes
# ---------------------------------------------------------------------------

def _vmem_estimate(plan: SegmentPlan, io, config: HardwareConfig,
                   tiles=(), packing: str | None = None) -> int:
    """Working-set bytes of a region at the ``bm`` row tile.

    Fixed charges (live for the whole region): streamed inputs and region
    outputs double-buffered (Pallas pipelines the next tile while
    computing), one ``[1, C]`` row per row-const extra, streamed-broadcast
    fallbacks double-buffered, whole resident weights.

    Intermediates: ``packing="sum"`` holds EVERY step output live for the
    whole region (the PR 5 bound); ``packing="live"`` (default) walks the
    step program charging each output only from its defining step to its
    last use — the peak of that walk is what competes for the budget, so it
    is never above the sum bound.  Members of a column-tiled run are
    charged at ``bm * min(bn, W)`` (one tile at a time)."""
    g = plan.graph
    if packing is None:
        packing = config.region_packing
    stream_in, rows, bcast, res_in, outputs, steps = io
    bm = config.bm
    fixed = 0
    for nid in stream_in:
        fixed += 2 * bm * _row_bytes(g, nid)
    for nid, cols in rows:
        fixed += cols * np.dtype(g.nodes[nid].dtype).itemsize
    for nid, cols in bcast:
        fixed += 2 * bm * cols * np.dtype(g.nodes[nid].dtype).itemsize
    for nid in res_in:
        fixed += _whole_bytes(g, nid)
    for nid in outputs:
        fixed += 2 * bm * _row_bytes(g, nid)

    if packing == "sum":
        return fixed + sum(bm * _row_bytes(g, s[1]) for s in steps)

    # liveness walk: out defined at its step, freed after its last use
    tiled_width: dict[int, int] = {}
    last_use: dict[int, int] = {}
    reducer_idx: dict[int, int] = {}
    for idx, step in enumerate(steps):
        reducer_idx[step[1]] = idx
    for group in tiles:
        for m in group.members:
            tiled_width[m] = min(group.bn, group.width)
            last_use[m] = reducer_idx[group.reducer]
    for idx, step in enumerate(steps):
        for op in _step_operands(step):
            if op in reducer_idx and op not in tiled_width:
                last_use[op] = idx

    out_set = set(outputs)             # charged in fixed, skip in the walk
    live: dict[int, int] = {}
    peak = 0
    for idx, step in enumerate(steps):
        out = step[1]
        if out not in out_set:
            itemsize = np.dtype(g.nodes[out].dtype).itemsize
            width = tiled_width.get(out)
            nbytes = (bm * width * itemsize if width is not None
                      else bm * _row_bytes(g, out))
            live[out] = nbytes
        peak = max(peak, sum(live.values()))
        for nid in [n for n, lu in last_use.items() if lu == idx]:
            live.pop(nid, None)
    return fixed + peak


def _pack_region(plan: SegmentPlan, io, config: HardwareConfig):
    """(vmem estimate, tile groups) for a would-be region: untiled when it
    fits the budget (or under ``"sum"`` packing, which never tiles — it is
    the PR 5 floor), column-tiled otherwise when a tilable run exists."""
    est = _vmem_estimate(plan, io, config)
    if config.region_packing == "sum" or est <= config.vmem_budget:
        return est, ()
    tiles = plan_col_tiles(plan, io, config)
    if not tiles:
        return est, ()
    return _vmem_estimate(plan, io, config, tiles=tiles), tiles


def region_vmem_bytes(plan: SegmentPlan, region: FusedRegion,
                      config: HardwareConfig, consumers=None) -> int:
    """VMEM working-set estimate of a built region (validation + reporting).
    Regions built by ``build_region_plan`` carry the estimate in
    ``meta["vmem_bytes"]``; re-deriving is the fallback for hand-built ones."""
    est = region.meta.get("vmem_bytes")
    if est is not None:
        return est
    members = [(plan.segments[sid], _lower_segment(plan, plan.segments[sid]))
               for sid in region.segments]
    io = _region_io(plan, members, consumers)
    assert io is not None
    return _pack_region(plan, io, config)[0]


def segment_hbm_bytes_per_block(plan: SegmentPlan, block: int) -> int:
    """HBM traffic of ONE pipeline block under per-segment dispatch: every
    segment reads its streamed inputs and writes its output."""
    g = plan.graph
    total = 0
    for seg in plan.segments:
        for i in seg.stream_inputs:
            total += block * _row_bytes(g, i)
        total += block * _row_bytes(g, seg.output)
    return total


def region_hbm_bytes_per_block(plan: SegmentPlan, rplan: RegionPlan,
                               block: int) -> int:
    """HBM traffic of ONE pipeline block under region dispatch: fused
    regions read only region inputs and write only region outputs —
    intra-region tensors never leave VMEM.  Row-const extras
    (``bcast_rows``) charge nothing per block: one ``[1, C]`` row is read
    once for the whole stream, not per block."""
    g = plan.graph
    total = 0
    for r in rplan.regions:
        if r.fused:
            for i in r.stream_inputs:
                total += block * _row_bytes(g, i)
            for nid, cols in r.broadcast_inputs:
                total += block * cols * np.dtype(g.nodes[nid].dtype).itemsize
            for o in r.outputs:
                total += block * _row_bytes(g, o)
        else:
            seg = plan.segments[r.segments[0]]
            for i in seg.stream_inputs:
                total += block * _row_bytes(g, i)
            total += block * _row_bytes(g, seg.output)
    return total


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def build_region_plan(plan: SegmentPlan,
                      config: HardwareConfig | None = None) -> RegionPlan:
    """Greedily merge adjacent expressible, connected segments into
    FusedRegions under the config's VMEM budget and cut points.  With
    ``fuse_regions=False`` every segment is a singleton region (the classic
    per-segment pipeline, byte-for-byte)."""
    if config is None:
        config = plan.config
    if config is None:
        from repro_torch.core.config import DEFAULT_CONFIG
        config = DEFAULT_CONFIG
    regions: list[FusedRegion] = []
    region_of: dict[int, int] = {}
    cuts = set(config.region_cuts)
    consumers = plan.graph.consumers()     # built once, shared by every trial
    cur: list = []                         # [(Segment, step)]

    def singleton(seg: Segment) -> FusedRegion:
        return FusedRegion(
            id=len(regions), segments=(seg.id,),
            stream_inputs=seg.stream_inputs, broadcast_inputs=(),
            resident_inputs=seg.resident_inputs, outputs=(seg.output,),
            spec=None)

    def flush():
        nonlocal cur
        if not cur:
            return
        if len(cur) == 1:
            r = singleton(cur[0][0])
        else:
            io = _region_io(plan, cur, consumers)
            stream_in, rows, bcast, res_in, outputs, steps = io
            est, tiles = _pack_region(plan, io, config)
            from repro_torch.kernels.region import RegionKernelSpec
            spec = RegionKernelSpec(
                steps=steps,
                stream_inputs=stream_in + tuple(n for n, _ in bcast),
                residents=res_in, outputs=outputs,
                bcast_rows=tuple(n for n, _ in rows),
                tile_groups=tiles)
            col_tiles = max((t.n_tiles for t in tiles), default=1)
            r = FusedRegion(
                id=len(regions), segments=tuple(s.id for s, _ in cur),
                stream_inputs=stream_in, broadcast_inputs=bcast,
                resident_inputs=res_in, outputs=outputs,
                bcast_rows=rows, spec=spec,
                meta={"vmem_bytes": est, "col_tiles": col_tiles})
        for sid in r.segments:
            region_of[sid] = r.id
        regions.append(r)
        cur = []

    for seg in plan.segments:
        step = _lower_segment(plan, seg) if config.fuse_regions else None
        if step is None:
            flush()
            r = singleton(seg)
            region_of[seg.id] = r.id
            regions.append(r)
            continue
        if cur:
            produced = {s.output for s, _ in cur}
            trial = cur + [(seg, step)]
            io = _region_io(plan, trial, consumers)
            joinable = (cur[-1][0].id not in cuts
                        and any(i in produced for i in seg.stream_inputs)
                        and io is not None
                        and _pack_region(plan, io, config)[0]
                        <= config.vmem_budget)
            if not joinable:
                flush()
        cur.append((seg, step))
    flush()

    rplan = RegionPlan(plan=plan, regions=regions, region_of=region_of,
                       config=config)
    rplan.validate()
    return rplan


# ---------------------------------------------------------------------------
# dispatch planning at region granularity (the executor's invocation log)
# ---------------------------------------------------------------------------

def region_dispatch_table(plan: SegmentPlan,
                          rplan: RegionPlan) -> list[tuple]:
    """One entry per KERNEL INVOCATION of a block step: fused regions
    contribute a single ``(region id, "FusedRegion", "region[s..]")`` entry,
    singletons keep the classic ``(segment id, kind, kernel)``."""
    out = []
    for r in rplan.regions:
        if r.fused:
            segs = f"s{r.segments[0]}-s{r.segments[-1]}"
            tiles = f" x{r.col_tiles}bn" if r.col_tiles > 1 else ""
            out.append((r.id, FUSED_REGION,
                        f"{REGION_KERNEL}[{len(r.segments)} segs "
                        f"{segs}{tiles}]"))
        else:
            seg = plan.segments[r.segments[0]]
            out.append((seg.id, seg.kind, segment_dispatch(plan, seg)))
    return out


def region_row_cost(plan: SegmentPlan, region: FusedRegion,
                    mm_parallel_for) -> int:
    """Row-cycles one region charges per streamed row (the dataflow oracle's
    per-op calibrated cost, summed over the region's steps) — see
    ``dataflow.OP_ROW_COST``."""
    from repro_torch.core.dataflow import segment_row_cost
    return sum(segment_row_cost(plan, plan.segments[sid],
                                mm_parallel_for(sid))
               for sid in region.segments)


# ---------------------------------------------------------------------------
# gradient checkpoint cuts (the fit path, DESIGN.md §11): score
# checkpoint-vs-buffer per execution unit with the SAME byte model the VMEM
# packer uses, so autoconfig and the fit compiler share one cost oracle
# ---------------------------------------------------------------------------

def unit_act_row_bytes(plan: SegmentPlan, kind: str, unit) -> int:
    """Per-row bytes of every activation a unit materializes on the forward
    pass — what reverse-mode autodiff buffers for the backward sweep when
    the unit is NOT checkpointed."""
    g = plan.graph
    if kind == "region":
        return sum(_row_bytes(g, step[1]) for step in unit.spec.steps)
    return sum(_row_bytes(g, n) for n in unit.nodes)


def unit_boundary_row_bytes(plan: SegmentPlan, kind: str, unit) -> int:
    """Per-row bytes of a unit's boundary tensors (streamed inputs +
    outputs) — the ONLY residual a checkpointed unit keeps: the backward
    sweep recomputes the interior from the boundary."""
    g = plan.graph
    if kind == "region":
        ins, outs = unit.stream_inputs, unit.outputs
    else:
        ins, outs = unit.stream_inputs, (unit.output,)
    return (sum(_row_bytes(g, n) for n in ins)
            + sum(_row_bytes(g, n) for n in outs))


def plan_fit_checkpoints(plan: SegmentPlan, units, config: HardwareConfig,
                         *, budget: int | None = None) -> tuple[int, ...]:
    """Choose which execution units RECOMPUTE their interior on the backward
    sweep (gradient checkpoint cuts) instead of buffering it.

    Greedy under the liveness/VMEM byte model: charge each unit
    ``block * unit_act_row_bytes`` of backward-sweep buffering; while the
    total exceeds the budget (default ``config.vmem_budget``), cut the unit
    with the largest saving (activation bytes minus the boundary residual it
    must keep anyway).  Deterministic for a given (plan, units, config), so
    autoconfig can score checkpoint-vs-buffer per region like any other
    schedule decision.  Returns sorted unit indices."""
    if budget is None:
        budget = config.vmem_budget
    rows = config.block
    act = [rows * unit_act_row_bytes(plan, kind, u) for kind, u in units]
    keep = [rows * unit_boundary_row_bytes(plan, kind, u)
            for kind, u in units]
    total = sum(act)
    cuts: list[int] = []
    for i in sorted(range(len(units)), key=lambda i: keep[i] - act[i]):
        if total <= budget or act[i] <= keep[i]:
            break
        cuts.append(i)
        total -= act[i] - keep[i]
    return tuple(sorted(cuts))


def fit_backward_bytes(plan: SegmentPlan, units, config: HardwareConfig,
                       checkpoints=()) -> int:
    """Modeled backward-sweep buffering of ONE block under the given
    checkpoint cuts: buffered units charge their full activations,
    checkpointed units only their boundary residual.  This is the
    O(block x depth) term of the fit peak-memory model (the ``fit``
    benchmark's gate tracks it)."""
    rows = config.block
    cut = set(checkpoints)
    total = 0
    for i, (kind, u) in enumerate(units):
        per_row = (unit_boundary_row_bytes(plan, kind, u) if i in cut
                   else unit_act_row_bytes(plan, kind, u))
        total += rows * per_row
    return total
