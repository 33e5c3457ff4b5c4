"""The port's own copy of ``repro.core.dataflow`` (the port imports nothing of the
JAX package); keep the two in step.  One difference: ``load_op_row_cost``
takes an explicit path, since the reference's default file is a CPU
calibration of the reference.

Dataflow architecture model + deadlock analysis (paper Secs. 3.1, 3.2.3).

The ComputeGraph is mapped onto the INR-Arch dataflow architecture:
  * every tensor edge becomes an ARRAY STREAM (a FIFO of blocks);
  * every op becomes a stream KERNEL with a characteristic FIFO access
    pattern (streaming / buffering / MM);
  * nodes with multiple consumers get a COPY_STREAM multicaster that writes
    each block to its outputs ROUND-ROBIN (paper's one-producer-one-consumer
    rule — and the source of the Fig. 5 deadlock).

From the mapped design we build the paper's DATAFLOW GRAPH (Fig. 6): nodes
are FIFO read/write steps, edges are happens-before relations:
  (a) intra-process program order           (trace order; depth-independent)
  (b) read-after-write: write#n -> read#n   (depth-independent)
  (c) write-after-read: read#(n-d) -> write#n for a FIFO of depth d
A deadlock is exactly a cycle; latency is the longest path (with per-edge
delays); observed FIFO depths come from peak occupancy under the node times.

TPU adaptation: FIFO granularity is a BLOCK of the array stream (default 64
elements = the paper's batch dimension) rather than one scalar per cycle —
see DESIGN.md §2.  The analysis itself is granularity-invariant for the
regular access patterns these kernels produce.

Step delays are CALIBRATED in row-cycles: a block step charges
``block x per-row cost`` from the ``OP_ROW_COST`` table below (elementwise 1,
transcendental 2, MM ``ceil(K / parallelism)`` per emitted row), so latencies
at different block granules are directly comparable — no post-hoc row-cycle
normalization (the quantity autoconfig minimizes IS the longest path).

With a RegionPlan (``core/regions.py``), fused regions map to ONE process
each: intra-region tensors get no FIFO at all (they live in the megakernel's
VMEM values — the on-chip streams of the paper's FIFO-connected PEs), and the
region charges the sum of its member segments' row costs per block step.

Under a SHARDED serving mesh (``config.n_shards > 1``, DESIGN.md §8) the
host -> shard interconnect hop is modeled as one more FIFO edge per
pipeline input: the Input source writes a HOST-side stream, and an
``xshard`` process forwards each block onto the device-side stream at the
calibrated per-row cost — the measured ``XSHARD_ROW_COST`` when
``load_op_row_cost`` has installed one, else ``config.xshard_row_cost``.  The deadlock analysis
and the latency oracle both see that edge, so ``config="auto"`` stays
honest about the cross-shard stream instead of pretending queries
materialize on-device for free.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.config import HardwareConfig
from repro_torch.core.graph import ComputeGraph, Node
# op taxonomy lives with the SegmentPlan now; re-exported for compatibility
from repro_torch.core.segment import (BUFFERING, BUFFERING_OPS, FUSED_MM_ACT,
                                MATMUL, MM_OPS, STREAMING_OPS, STREAM_CHAIN,
                                SegmentPlan, build_segment_plan)

# ---------------------------------------------------------------------------
# calibrated per-op block-step costs (row-cycles per streamed row).
#
# The paper's HLS kernels are pipelined at II=1 per element for elementwise
# streams; transcendentals (sin/cos/exp/...) occupy the deeper VPU pipeline,
# which the reference measured at ~2x an add/mul on its TPU interpret + jnp
# microbenchmarks; the card's own table is
# ``results/torch_op_row_cost.json`` (``scripts/torch_row_cost_calibrate.py``,
# loaded only through ``load_op_row_cost``).  MM emits one output row every
# ``ceil(K / parallelism)`` cycles (the paper's DSP initiation interval).
# Ops missing from the table cost 1.  Buffering moves are charged 1 per row.
# ---------------------------------------------------------------------------

OP_ROW_COST = {
    "Sin": 2, "Cos": 2, "Exp": 2, "Log": 2, "Tanh": 2, "Sigmoid": 2,
    "Erf": 2, "Rsqrt": 2, "Sqrt": 2, "Pow": 2, "IntPow": 1,
}

# the analytic defaults above, kept so a calibrated table can be undone
_ANALYTIC_OP_ROW_COST = dict(OP_ROW_COST)

# MM row cost is ``ceil(K * MM_ROW_COST_PER_K / parallelism)``; 1.0 is the
# analytic default (one DSP op per contraction element), a calibration
# (the reference's scripts/row_cost_calibrate.py) replaces it with the
# measured per-K cost relative to an elementwise add.
MM_ROW_COST_PER_K = 1.0

# calibrated host -> shard interconnect hop (row-cycles per row).  None =
# use ``config.xshard_row_cost`` (the static default); calibration measures
# a real device_put per row over the Add unit and swaps the measured value
# in for every config.
XSHARD_ROW_COST: int | None = None


def op_row_cost(op: str) -> int:
    return OP_ROW_COST.get(op, 1)


def load_op_row_cost(path) -> dict:
    """Swap in a CALIBRATED per-op cost table (the JSON a row-cost
    calibration writes: ``op_row_cost``, ``mm_row_cost_per_k``,
    ``xshard_row_cost``) in place of the analytic defaults.  Explicit —
    never loaded at import, and ``path`` has no default: a calibration
    belongs to the device it was measured on.  Returns the active table;
    ``reset_op_row_cost`` restores the analytic one."""
    import json
    import pathlib
    global MM_ROW_COST_PER_K, XSHARD_ROW_COST
    d = json.loads(pathlib.Path(path).read_text())
    OP_ROW_COST.update({str(k): max(1, int(round(float(v))))
                        for k, v in d.get("op_row_cost", {}).items()})
    if d.get("mm_row_cost_per_k") is not None:
        MM_ROW_COST_PER_K = max(1e-6, float(d["mm_row_cost_per_k"]))
    if d.get("xshard_row_cost") is not None:
        XSHARD_ROW_COST = max(1, int(round(float(d["xshard_row_cost"]))))
    return dict(OP_ROW_COST)


def reset_op_row_cost():
    """Restore the analytic OP_ROW_COST / MM / xshard defaults."""
    global MM_ROW_COST_PER_K, XSHARD_ROW_COST
    OP_ROW_COST.clear()
    OP_ROW_COST.update(_ANALYTIC_OP_ROW_COST)
    MM_ROW_COST_PER_K = 1.0
    XSHARD_ROW_COST = None


def segment_row_cost(plan: SegmentPlan, seg, mm_parallel: int) -> int:
    """Row-cycles one segment charges per streamed row: the sum of its ops'
    calibrated costs; MM segments add the initiation interval
    ``ceil(K / mm_parallel)`` for the contraction."""
    g = plan.graph
    if seg.kind in (MATMUL, FUSED_MM_ACT):
        mm = g.nodes[seg.meta.get("mm", seg.nodes[0])]
        lhs = g.nodes[mm.inputs[0]]
        kk = lhs.shape[-1] if lhs.shape else 1
        cost = max(1, math.ceil(kk * MM_ROW_COST_PER_K / max(1, mm_parallel)))
        for nid in seg.nodes:
            if g.nodes[nid].op not in MM_OPS:
                cost += op_row_cost(g.nodes[nid].op)
        return cost
    if seg.kind == STREAM_CHAIN:
        return sum(op_row_cost(g.nodes[n].op) for n in seg.nodes)
    return 1                                   # buffering: one move per row


@dataclass
class Step:
    """One program-order step of a process: FIFO ops happening together."""
    reads: tuple = ()        # ((stream_id, index), ...)
    writes: tuple = ()       # ((stream_id, index), ...)
    delay: int = 1           # latency charged AFTER this step


@dataclass
class Stream:
    id: int
    src: str                 # tensor identity: "n{node}" producer
    n_blocks: int
    block_bytes: int
    producer: str = ""
    consumer: str = ""


@dataclass
class Process:
    name: str
    steps: list[Step] = field(default_factory=list)


@dataclass
class DataflowDesign:
    processes: list[Process]
    streams: dict[int, Stream]

    def stream_ids(self):
        return list(self.streams)

    def sum_depths(self, depths: dict[int, int]) -> int:
        return sum(depths.values())

    def fifo_bytes(self, depths: dict[int, int]) -> int:
        return sum(self.streams[s].block_bytes * d for s, d in depths.items())


# ---------------------------------------------------------------------------
# ComputeGraph -> DataflowDesign
# ---------------------------------------------------------------------------

def _n_blocks(node: Node, block: int) -> int:
    return max(1, math.ceil(node.size / block))


def map_to_dataflow(g: ComputeGraph, *, block: int | None = None,
                    mm_parallel: int | None = None, dtype_bytes: int = 4,
                    plan: SegmentPlan | None = None,
                    config: HardwareConfig | None = None,
                    region_plan=None) -> DataflowDesign:
    """Map a SegmentPlan onto the dataflow architecture.

    Processes and streams are derived from the SAME plan the executor runs
    and the codegen emits (DESIGN.md §3): one process per segment (a fused
    stream kernel), one array stream per inter-segment tensor USE, plus
    Input sources, copy_stream multicasters for fan-out, and output sinks.
    Intra-segment tensors never touch a FIFO — they live in the kernel.

    With a region plan (built automatically when ``config.fuse_regions``),
    the mapping is REGION-granular: each fused region is one process, its
    intra-region FIFO edges collapse to zero-cost on-chip streams (no FIFO
    exists for them), and the region charges its members' summed row cost
    per block step (DESIGN.md §7).

    Hardware parameters resolve in precedence order: explicit ``block`` /
    ``mm_parallel`` kwargs (a uniform override, what the table sweeps use) >
    ``config`` (``dataflow_block`` and per-MM-segment parallelism) > the
    parallelism stamped on the plan's segments > legacy defaults (64/64)."""
    if plan is None:
        plan = build_segment_plan(g, config=config)
    if config is None:
        config = plan.config
    if block is None:
        block = config.dataflow_block if config is not None else 64
    if region_plan is None and config is not None and config.fuse_regions:
        from repro_torch.core.regions import build_region_plan
        region_plan = build_region_plan(plan, config)

    def seg_mm_parallel(seg) -> int:
        if mm_parallel is not None:
            return mm_parallel
        if config is not None:
            return config.mm_parallel_for(seg.id)
        return seg.meta.get("mm_parallel") or 64

    # execution units: fused regions are ONE process; everything else is a
    # per-segment process exactly as before
    if region_plan is not None:
        units = region_plan.units()
    else:
        units = [("seg", s) for s in plan.segments]

    streams: dict[int, Stream] = {}
    procs: list[Process] = []
    sid = 0

    def new_stream(node: Node) -> int:
        nonlocal sid
        s = Stream(sid, f"n{node.id}", _n_blocks(node, block),
                   block * dtype_bytes)
        streams[s.id] = s
        sid += 1
        return s.id

    def unit_node_order(kind, u) -> list[int]:
        if kind == "seg":
            return list(u.nodes)
        return [n for sid_ in u.segments for n in plan.segments[sid_].nodes]

    def unit_outputs(kind, u) -> list[int]:
        return [u.output] if kind == "seg" else list(u.outputs)

    # every USE of a produced tensor outside its unit gets its own stream
    # (the paper's one-producer-one-consumer rule); uses are keyed so each
    # consuming (unit, node, slot) / sink occurrence is distinct
    use_lists: dict[int, list[tuple]] = {}     # tensor node -> ordered uses
    unit_uses: dict[int, list[tuple]] = {k: [] for k in range(len(units))}
    for uid, (kind, u) in enumerate(units):
        order_nodes = unit_node_order(kind, u)
        node_set = set(order_nodes)
        for nid in order_nodes:
            for slot, i in enumerate(g.nodes[nid].inputs):
                if i in plan.resident or i in node_set:
                    continue               # residents are on-chip, not FIFOs
                key = ("unit", uid, nid, slot)
                use_lists.setdefault(i, []).append(key)
                unit_uses[uid].append(key)
    # dedupe can leave the same node as MULTIPLE graph outputs (e.g.
    # symmetric mixed partials) — each occurrence needs a stream.  Resident
    # (const-derived) outputs never flow through a FIFO: the host reads them
    # from resident memory, so they get neither a stream nor a sink.
    for j, o in enumerate(g.outputs):
        if o not in plan.resident:
            use_lists.setdefault(o, []).append(("sink", j))

    # allocate streams producer-side: direct, or through a copy_stream
    # process that writes each block to its outputs ROUND-ROBIN (paper
    # Sec. 3.1.2 — and the source of the Fig. 5 deadlock)
    producer_stream: dict[int, int] = {}       # tensor -> stream it WRITES
    use_stream: dict[tuple, int] = {}          # use key -> stream it READS
    pos = {nid: k for k, nid in enumerate(g.topo_order())}
    for t in sorted(use_lists, key=pos.get):
        node = g.nodes[t]
        uses = use_lists[t]
        if len(uses) == 1:
            s = new_stream(node)
            producer_stream[t] = s
            use_stream[uses[0]] = s
        else:
            s_in = new_stream(node)
            outs = [new_stream(node) for _ in uses]
            producer_stream[t] = s_in
            for key, s in zip(uses, outs):
                use_stream[key] = s
            cp = Process(f"copy{t}")
            for i in range(_n_blocks(node, block)):
                cp.steps.append(Step(reads=((s_in, i),), delay=0))
                for o in outs:
                    cp.steps.append(Step(writes=((o, i),), delay=0))
            cp.steps.append(Step(delay=block))
            procs.append(cp)

    # Input sources feed the pipeline.  On a sharded mesh the source is the
    # HOST: its blocks cross the interconnect through one more FIFO edge —
    # an xshard forwarder charging the calibrated per-row hop cost — before
    # they reach the device-side input stream the kernels read.
    n_shards = config.n_shards if config is not None else 1
    for nid in plan.inputs:
        if nid not in producer_stream:
            continue                           # unused input: no stream
        node = g.nodes[nid]
        p = Process(f"Input{nid}")
        s = producer_stream[nid]
        nb_in = _n_blocks(node, block)
        if n_shards > 1:
            s_host = new_stream(node)          # host side of the interconnect
            xp = Process(f"xshard{nid}")
            hop_rows = (XSHARD_ROW_COST if XSHARD_ROW_COST is not None
                        else config.xshard_row_cost)
            hop = block * max(1, hop_rows)
            for i in range(nb_in):
                p.steps.append(Step(writes=((s_host, i),), delay=block))
                xp.steps.append(Step(reads=((s_host, i),),
                                     writes=((s, i),), delay=hop))
            procs.append(xp)
        else:
            for i in range(nb_in):
                p.steps.append(Step(writes=((s, i),), delay=block))
        procs.append(p)

    # one process per unit (segment, or fused region)
    for uid, (kind, u) in enumerate(units):
        ins = [use_stream[k] for k in unit_uses[uid]]
        out_streams: list[tuple[int, int]] = []     # (stream, n_blocks)
        for o in unit_outputs(kind, u):
            out_s = producer_stream.get(o)
            if out_s is not None:
                out_streams.append((out_s, _n_blocks(g.nodes[o], block)))
        nbs = [streams[s].n_blocks for s in ins]

        if kind == "region":
            # fused region: ONE streaming process — block i in, block i out,
            # per-block delay = summed member row costs x block rows.  The
            # megakernel holds intra-region tensors in VMEM, so they have no
            # streams at all (they were never in use_lists).  A COLUMN-TILED
            # region (meta["col_tiles"] = ceil(N / bn) > 1) is still one
            # process, but each block runs that many INNER iterations: the
            # read happens before the first tile, the write after the last,
            # and the per-block delay splits evenly across the tiles.
            cost = sum(segment_row_cost(plan, plan.segments[sid_],
                                        seg_mm_parallel(plan.segments[sid_]))
                       for sid_ in u.segments)
            tiles = max(1, u.meta.get("col_tiles", 1))
            sub = max(1, math.ceil(block * cost / tiles))
            p = Process(f"region{u.id}")
            nb_out_max = max((nb for _, nb in out_streams), default=0)
            nb = max([nb_out_max] + nbs)
            for i in range(nb):
                rd = tuple((s, i) for s, b in zip(ins, nbs) if i < b)
                wr = tuple((s, i) for s, b in out_streams if i < b)
                if tiles == 1:
                    p.steps.append(Step(reads=rd, writes=wr,
                                        delay=block * cost))
                else:
                    p.steps.append(Step(reads=rd, delay=sub))
                    for _ in range(tiles - 2):
                        p.steps.append(Step(delay=sub))
                    p.steps.append(Step(writes=wr, delay=sub))
            if p.steps:
                procs.append(p)
            continue

        seg = u
        outs = [s for s, _ in out_streams]
        nb_out = out_streams[0][1] if out_streams \
            else _n_blocks(g.nodes[seg.output], block)
        name = "+".join(g.nodes[n].op for n in seg.nodes) + str(seg.nodes[0])
        p = Process(name)

        if seg.kind in (MATMUL, FUSED_MM_ACT):
            # buffer every streamed operand fully (round-robin across them),
            # then emit output blocks at the MM initiation interval
            for i in range(max(nbs, default=0)):
                rd = tuple((s, i) for s, nb in zip(ins, nbs) if i < nb)
                p.steps.append(Step(reads=rd, delay=block))
            ii = block * segment_row_cost(plan, seg, seg_mm_parallel(seg))
            for i in range(nb_out):
                p.steps.append(Step(writes=tuple((s, i) for s in outs),
                                    delay=ii))
        elif seg.kind == BUFFERING:
            for i in range(max(nbs, default=0)):
                rd = tuple((s, i) for s, nb in zip(ins, nbs) if i < nb)
                p.steps.append(Step(reads=rd, delay=block))
            for i in range(nb_out):
                p.steps.append(Step(writes=tuple((s, i) for s in outs),
                                    delay=block))
        else:
            # StreamChain: read block i from every input, write block i —
            # the whole fused chain costs one step per block
            cost = block * segment_row_cost(plan, seg, seg_mm_parallel(seg))
            nb = max([nb_out] + nbs)
            for i in range(nb):
                rd = tuple((s, i) for s, b in zip(ins, nbs) if i < b)
                wr = tuple((s, i) for s in outs) if i < nb_out else ()
                p.steps.append(Step(reads=rd, writes=wr, delay=cost))
        if p.steps:
            procs.append(p)

    # sinks
    for j, o in enumerate(g.outputs):
        if o in plan.resident:
            continue
        s = use_stream[("sink", j)]
        p = Process(f"sink{j}")
        for i in range(streams[s].n_blocks):
            p.steps.append(Step(reads=((s, i),), delay=block))
        procs.append(p)

    for p in procs:
        for st in p.steps:
            for (s, i) in st.writes:
                streams[s].producer = p.name
            for (s, i) in st.reads:
                streams[s].consumer = p.name
    return DataflowDesign(procs, streams)


# ---------------------------------------------------------------------------
# the dataflow (happens-before) graph
# ---------------------------------------------------------------------------

class DataflowGraph:
    """Paper Fig. 6: nodes = FIFO-op steps; edges = happens-before.

    Construction is two-phase, mirroring the paper: the UNCONSTRAINED graph
    (intra-process order + RAW) is built once; WAR edges are added per
    depth assignment and can be swapped cheaply while searching depths.
    """

    def __init__(self, design: DataflowDesign):
        self.design = design
        self.n = 0
        self.node_of_step: list[list[int]] = []
        self.base_edges: list[tuple[int, int, int]] = []   # (u, v, delay)
        # per stream: ordered node id of write#i / read#i
        self.writes: dict[int, list[int]] = {s: [] for s in design.streams}
        self.reads: dict[int, list[int]] = {s: [] for s in design.streams}
        self._build()

    def _build(self):
        d = self.design
        for p in d.processes:
            prev = None
            prev_delay = 0
            for st in p.steps:
                nid = self.n
                self.n += 1
                if prev is not None:
                    self.base_edges.append((prev, nid, prev_delay))
                for (s, i) in st.writes:
                    w = self.writes[s]
                    assert len(w) == i, (p.name, s, i, len(w))
                    w.append(nid)
                for (s, i) in st.reads:
                    r = self.reads[s]
                    assert len(r) == i, (p.name, s, i, len(r))
                    r.append(nid)
                prev = nid
                prev_delay = st.delay
        # RAW: write#n -> read#n
        for s in d.streams:
            for w, r in zip(self.writes[s], self.reads[s]):
                self.base_edges.append((w, r, 1))

    def war_edges(self, depths: dict[int, int]) -> list[tuple[int, int, int]]:
        """WAR: write#n depends on read#(n-d) for FIFO depth d."""
        out = []
        for s, d in depths.items():
            ws, rs = self.writes[s], self.reads[s]
            for n in range(d, len(ws)):
                if n - d < len(rs):
                    out.append((rs[n - d], ws[n], 0))
        return out

    # -- analyses ------------------------------------------------------

    def _adj(self, extra):
        adj: list[list[tuple[int, int]]] = [[] for _ in range(self.n)]
        indeg = [0] * self.n
        for (u, v, w) in self.base_edges:
            adj[u].append((v, w))
            indeg[v] += 1
        for (u, v, w) in extra:
            adj[u].append((v, w))
            indeg[v] += 1
        return adj, indeg

    def check(self, depths: dict[int, int] | None = None):
        """Kahn topological pass.  Returns (deadlocked, latency, times).

        deadlocked=True  <=> a cycle exists (paper Sec. 3.2.3);
        latency = max completion time over nodes (paper Sec. 3.2.4)."""
        extra = self.war_edges(depths) if depths else []
        adj, indeg = self._adj(extra)
        times = [0] * self.n
        stack = [i for i in range(self.n) if indeg[i] == 0]
        seen = 0
        while stack:
            u = stack.pop()
            seen += 1
            tu = times[u]
            for (v, w) in adj[u]:
                if tu + w > times[v]:
                    times[v] = tu + w
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        deadlocked = seen < self.n
        latency = max(times) if not deadlocked and times else 0
        return deadlocked, latency, times

    def observed_depths(self, depths: dict[int, int] | None = None,
                        minimum: int = 2) -> dict[int, int]:
        """Peak FIFO occupancy per stream under the schedule implied by node
        times (paper: 'actual FIFO depths observed ... in the simulation')."""
        dead, _, times = self.check(depths)
        assert not dead, "cannot observe depths of a deadlocked design"
        out: dict[int, int] = {}
        for s in self.design.streams:
            events = [(times[w], 0, +1) for w in self.writes[s]]
            events += [(times[r], 1, -1) for r in self.reads[s]]
            events.sort()
            occ = peak = 0
            for (_, _, delta) in events:
                occ += delta
                peak = max(peak, occ)
            out[s] = max(peak, minimum)
        return out
