"""The port's own copy of ``repro.core.segment`` (the port imports nothing of the
JAX package); keep the two in step.

SegmentPlan — the mid-end IR between the ComputeGraph and its consumers.

INR-Arch's central compilation step (paper Secs. 3.1, 3.2.5) partitions the
optimized gradient graph into a library of STREAM-KERNEL SEGMENTS: contiguous
1:1 streaming ops fuse into one kernel, while MM and buffering ops form
segment boundaries.  This module computes that partition ONCE and every
consumer layer derives from it:

    ComputeGraph --optimize--> SegmentPlan --+--> streaming_executor (Pallas)
                                             +--> codegen.emit_python (1 fn/segment)
                                             +--> dataflow.map_to_dataflow (FIFOs)

(see DESIGN.md §3 for the full picture).

Segment kinds:
  * ``StreamChain`` — a maximal single-consumer chain of elementwise
    streaming ops; dispatches to ``kernels.fused_chain`` when the chain is
    expressible as a fused-chain spec (one HBM round-trip per block).
  * ``MatMul``     — a lone Mm node; dispatches to ``kernels.stream_matmul``.
  * ``FusedMmAct`` — Mm [+ bias Add] [+ w0 Mul + Sin]: the SIREN layer
    pattern; dispatches to ``kernels.siren_layer`` (the sine is applied to
    the MXU accumulator tile before it ever reaches HBM).
  * ``Buffering``  — T / Permute / Reshape / Sum / ... (whole-tensor ops);
    always interpreted, always a segment boundary.

Invariants (checked by ``SegmentPlan.validate``):
  * every non-Const node is an Input, a resident, or in EXACTLY one segment;
  * every segment has exactly one output tensor — its last node (all other
    nodes are single-consumer internals), so inter-segment stream edges are
    one-producer / per-consumer-use, exactly the paper's FIFO discipline;
  * the segment DAG is acyclic and ``plan.segments`` is a topological order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.config import HardwareConfig
from repro_torch.core.graph import ComputeGraph, Node

# ---------------------------------------------------------------------------
# op taxonomy (paper Sec. 3.1: streaming / buffering / MM kernels).
# dataflow.py re-exports these; segment.py is the canonical home.
# ---------------------------------------------------------------------------

# ops that stream block-by-block with no buffering (1:1 or N:1)
STREAMING_OPS = {
    "Sin", "Cos", "Mul", "Add", "Sub", "Div", "Neg", "Exp", "Log", "Tanh",
    "Pow", "IntPow", "Convert", "Select", "Maximum", "Minimum", "Identity",
    "Rsqrt", "Sqrt", "Abs", "Sign", "Sigmoid", "Erf", "Broadcast",
}
# ops that must buffer their whole input before producing output
BUFFERING_OPS = {"T", "Permute", "Reshape", "Sum", "Max", "Concat", "Slice",
                 "Pad"}
# matrix multiply: buffers the streamed operand, then emits output blocks
MM_OPS = {"Mm"}


def _p(node: Node, key, default=None):
    return dict(node.params).get(key, default)


# ---------------------------------------------------------------------------
# resident / row-const classification (moved here from executor.py so it is
# computed once per plan and shared by executor, codegen and dataflow)
# ---------------------------------------------------------------------------

def classify_residents(g: ComputeGraph):
    """Split nodes into const-derived (resident) and stream-carried."""
    resident: set[int] = set()
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.op == "Const":
            resident.add(nid)
        elif n.op == "Input":
            continue
        elif n.inputs and all(i in resident for i in n.inputs):
            resident.add(nid)
    streamed = [nid for nid in g.topo_order() if nid not in resident]
    return resident, streamed


def row_const_residents(g: ComputeGraph, resident: set[int]) -> set[int]:
    """Residents whose rows (axis 0) are all identical, so slicing [:block]
    is valid.  Provenance-based — a weight whose dim0 merely COINCIDES with
    the batch size must never be sliced.  Typical members: the all-ones
    cotangent seed of reverse mode and everything derived from it."""
    rc: set[int] = set()
    elementwise = {"Sin", "Cos", "Mul", "Add", "Sub", "Div", "Neg", "Exp",
                   "Log", "Tanh", "Rsqrt", "Sqrt", "Abs", "Sign", "Sigmoid",
                   "Erf", "IntPow", "Pow", "Maximum", "Minimum", "Select",
                   "Convert", "Identity"}

    def arg_ok(i, out_rank):
        """Operand is row-const, or broadcasts without touching axis 0."""
        return i in rc or len(g.nodes[i].shape) < out_rank

    for nid in g.topo_order():
        if nid not in resident:
            continue
        n = g.nodes[nid]
        rank = len(n.shape)
        if n.op == "Const":
            if rank == 0 or (n.const is not None and n.shape and n.shape[0] > 0
                             and bool(np.all(n.const == n.const[:1]))):
                rc.add(nid)
        elif n.op == "Broadcast":
            bdims = tuple(_p(n, "broadcast_dimensions", ()))
            if 0 not in bdims:
                rc.add(nid)                     # axis 0 is freshly broadcast
            elif bdims and bdims[0] == 0 and n.inputs[0] in rc:
                rc.add(nid)                     # operand axis0 (row-const) maps up
        elif n.op == "Pad":
            pc = _p(n, "padding_config", ())
            if pc and tuple(pc[0]) == (0, 0, 0) and n.inputs[0] in rc:
                rc.add(nid)
        elif n.op == "Slice":
            if n.inputs and n.inputs[0] in rc:
                rc.add(nid)
        elif n.op == "Mm":
            if n.inputs and n.inputs[0] in rc:
                rc.add(nid)                     # identical lhs rows -> identical out rows
        elif n.op == "Sum":
            axes = tuple(_p(n, "axes", ()))
            if n.inputs and n.inputs[0] in rc and 0 not in axes:
                rc.add(nid)
        elif n.op in elementwise and n.inputs:
            if all(arg_ok(i, rank) for i in n.inputs):
                rc.add(nid)
    return rc


def scalar_const_value(g: ComputeGraph, nid: int):
    """Static Python float of a size-1 Const node, else None.  Used to bake
    w0-style scale factors into kernel bodies at plan time."""
    n = g.nodes.get(nid)
    if n is None or n.op != "Const" or n.const is None or n.size != 1:
        return None
    return float(np.ravel(n.const)[0])


# ---------------------------------------------------------------------------
# the plan IR
# ---------------------------------------------------------------------------

STREAM_CHAIN = "StreamChain"
MATMUL = "MatMul"
FUSED_MM_ACT = "FusedMmAct"
BUFFERING = "Buffering"


@dataclass(frozen=True)
class Segment:
    """One stream-kernel segment: a contiguous run of IR nodes executed as a
    unit.  ``nodes`` is in topological order; the LAST node is the segment's
    single output tensor."""
    id: int
    kind: str                         # StreamChain | MatMul | FusedMmAct | Buffering
    nodes: tuple[int, ...]
    stream_inputs: tuple[int, ...]    # external streamed producers, first-use order
    resident_inputs: tuple[int, ...]  # resident operands, first-use order
    meta: dict = field(default_factory=dict, compare=False)

    @property
    def output(self) -> int:
        return self.nodes[-1]

    def describe(self, g: ComputeGraph) -> str:
        ops = "+".join(g.nodes[n].op for n in self.nodes)
        return f"seg{self.id}[{self.kind}] {ops} -> n{self.output}"


@dataclass(frozen=True)
class StreamEdge:
    """A tensor flowing between segments (an array-stream / FIFO in the
    dataflow mapping).  ``src`` is the producing segment id, or -1 when the
    tensor is a graph Input."""
    src: int
    dst: int
    node: int                         # producer node id (tensor identity)


@dataclass(eq=False)
class SegmentPlan:
    # eq=False: plans compare and hash BY IDENTITY, so a plan object can key
    # caches directly (executor._GRAPH_CACHE holds the plan it compiled —
    # a freed plan's id() can be recycled; the object itself cannot)
    graph: ComputeGraph
    segments: list[Segment]
    edges: list[StreamEdge]
    resident: set[int]
    rowconst: set[int]
    inputs: tuple[int, ...]           # Input node ids, ordered by idx param
    batch: int | None
    segment_of: dict[int, int]        # node id -> segment id
    config: HardwareConfig | None = None   # hardware config stamped on the plan

    # -- queries -----------------------------------------------------------
    def segment(self, sid: int) -> Segment:
        return self.segments[sid]

    def resident_order(self) -> list[int]:
        return [nid for nid in self.graph.topo_order() if nid in self.resident]

    def counts_by_kind(self) -> dict[str, int]:
        c: dict[str, int] = {}
        for s in self.segments:
            c[s.kind] = c.get(s.kind, 0) + 1
        return c

    def describe(self) -> str:
        lines = [f"SegmentPlan: {len(self.segments)} segments "
                 f"({self.counts_by_kind()}), {len(self.edges)} stream edges, "
                 f"{len(self.resident)} residents ({len(self.rowconst)} row-const)"]
        lines += ["  " + s.describe(self.graph) for s in self.segments]
        return "\n".join(lines)

    # -- invariants --------------------------------------------------------
    def validate(self):
        g = self.graph
        covered: list[int] = [n for s in self.segments for n in s.nodes]
        assert len(covered) == len(set(covered)), "segments overlap"
        want = {nid for nid, n in g.nodes.items()
                if nid not in self.resident and n.op != "Input"}
        assert set(covered) == want, (set(covered) ^ want)
        for s in self.segments:
            for n in s.nodes:
                assert n not in self.resident
        # plan order is a topological order of the segment DAG
        pos = {s.id: k for k, s in enumerate(self.segments)}
        for e in self.edges:
            if e.src >= 0:
                assert pos[e.src] < pos[e.dst], (e, "plan order not topological")
        return True


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

def _sole_consumer(g: ComputeGraph, consumers, nid: int):
    """The unique consumer of nid, or None if nid fans out / is an output
    (fan-out tensors must leave the segment as a stream)."""
    if nid in g.outputs:
        return None
    cs = consumers[nid]
    return cs[0] if len(cs) == 1 else None


def _bias_like(g: ComputeGraph, nid: int, out_shape, rowconst) -> bool:
    """Resident operand usable as the siren_layer bias vector [N]."""
    shape = g.nodes[nid].shape
    n_cols = out_shape[-1] if out_shape else 1
    if shape == (n_cols,) or shape == (1, n_cols):
        return True
    return nid in rowconst and shape == tuple(out_shape)


def _match_fused_mm_act(g, mm: Node, consumers, resident, rowconst):
    """Greedy SIREN-layer epilogue match starting at a streamed Mm:
    Mm [-> Add(bias)] [-> Mul(w0 scalar) -> Sin | -> Sin].  Every absorbed
    intermediate must be single-consumer (its value never leaves the fused
    kernel).  Returns (nodes, meta) — nodes == [mm.id] when nothing fused."""
    nodes = [mm.id]
    meta = {"mm": mm.id, "bias": None, "w0": 1.0, "apply_sin": False}
    if len(mm.inputs) != 2 or mm.inputs[1] not in resident:
        return nodes, meta                      # weight must be resident
    if len(g.nodes[mm.inputs[1]].shape) != 2 or len(mm.shape) != 2:
        return nodes, meta
    cur = mm.id

    c = _sole_consumer(g, consumers, cur)
    if c is not None and g.nodes[c].op == "Add" and g.nodes[c].shape == mm.shape:
        others = [i for i in g.nodes[c].inputs if i != cur]
        if len(others) == 1 and others[0] in resident and \
                _bias_like(g, others[0], mm.shape, rowconst):
            nodes.append(c)
            meta["bias"] = others[0]
            cur = c

    c = _sole_consumer(g, consumers, cur)
    if c is not None:
        cn = g.nodes[c]
        if cn.op == "Sin" and cn.shape == mm.shape:
            nodes.append(c)
            meta["apply_sin"] = True
        elif cn.op == "Mul" and cn.shape == mm.shape:
            others = [i for i in cn.inputs if i != cur]
            w0 = scalar_const_value(g, others[0]) if len(others) == 1 else None
            c2 = _sole_consumer(g, consumers, c)
            if (w0 is not None and c2 is not None
                    and g.nodes[c2].op == "Sin" and g.nodes[c2].shape == mm.shape):
                # commit the scale only together with the sine — siren_layer
                # computes sin(w0 * (x@W + b)); a bare scale is a StreamChain
                nodes.extend([c, c2])
                meta["w0"] = w0
                meta["apply_sin"] = True
    return nodes, meta


def _grow_stream_chain(g, start: Node, consumers, resident, assigned):
    """Maximal single-consumer run of same-shape streaming ops from start.
    Expressibility as a fused_chain spec is checked separately (the chain is
    still ONE segment even when it must be interpreted)."""
    from repro_torch.kernels.fused_chain import build_chain_spec
    nodes = [start.id]
    cur = start.id
    while True:
        c = _sole_consumer(g, consumers, cur)
        if c is None:
            break
        cn = g.nodes[c]
        if (c in resident or c in assigned or cn.op not in STREAMING_OPS
                or cn.shape != g.nodes[cur].shape):
            # `c in assigned`: two chains converging on one binary op — the
            # first (in topo order) claimed it; this one ends at the edge
            break
        cand = nodes + [c]
        # never extend an expressible chain past expressibility: that would
        # force the whole segment onto the interpreter
        if (build_chain_spec(g, cand, resident=resident) is None
                and build_chain_spec(g, nodes, resident=resident) is not None):
            break
        nodes = cand
        cur = c
    spec = build_chain_spec(g, nodes, resident=resident)
    return nodes, {"chain": spec}


def apply_hardware_config(plan: SegmentPlan,
                          config: HardwareConfig) -> SegmentPlan:
    """Stamp a HardwareConfig onto a plan: every MatMul / FusedMmAct segment
    carries its own MM parallelism in ``seg.meta['mm_parallel']`` (read by the
    executor's kernel dispatch and the dataflow latency model), and the plan
    records the config it was configured for.  Segment ids are deterministic
    for a given graph, so per-segment overrides in the config address stable
    targets.

    Returns the same plan, mutated in place, when the plan is unconfigured
    (``plan.config is None``) or already configured identically; a plan that
    carries a DIFFERENT config is never touched — a shallow copy with fresh
    segment metas is stamped and returned instead, so artifacts compiled
    earlier from the same plan object keep the parallelism they were
    compiled with."""
    if plan.config is not None and plan.config != config:
        import dataclasses
        segments = [dataclasses.replace(s, meta=dict(s.meta))
                    for s in plan.segments]
        plan = SegmentPlan(
            graph=plan.graph, segments=segments, edges=list(plan.edges),
            resident=plan.resident, rowconst=plan.rowconst,
            inputs=plan.inputs, batch=plan.batch,
            segment_of=plan.segment_of)
    for s in plan.segments:
        if s.kind in (MATMUL, FUSED_MM_ACT):
            s.meta["mm_parallel"] = config.mm_parallel_for(s.id)
    plan.config = config
    return plan


def build_segment_plan(g: ComputeGraph, *,
                       config: HardwareConfig | None = None) -> SegmentPlan:
    """Partition an optimized ComputeGraph into typed segments (the paper's
    stream-kernel library instance for this graph).  With ``config``, MM
    segments carry their parallelism (``apply_hardware_config``)."""
    resident, _ = classify_residents(g)
    rowconst = row_const_residents(g, resident)
    consumers = g.consumers()
    order = g.topo_order()

    input_nodes = sorted((n for n in g.nodes.values() if n.op == "Input"),
                         key=lambda n: _p(n, "idx", 0))
    batch = None
    if input_nodes and input_nodes[0].shape:
        batch = input_nodes[0].shape[0]

    assigned: set[int] = set()
    raw: list[tuple[str, list[int], dict]] = []
    for nid in order:
        if nid in resident or nid in assigned:
            continue
        n = g.nodes[nid]
        if n.op == "Input":
            continue
        if n.op in MM_OPS:
            nodes, meta = _match_fused_mm_act(g, n, consumers, resident, rowconst)
            kind = FUSED_MM_ACT if len(nodes) > 1 else MATMUL
            raw.append((kind, nodes, meta if kind == FUSED_MM_ACT else {}))
        elif n.op in STREAMING_OPS:
            nodes, meta = _grow_stream_chain(g, n, consumers, resident,
                                             assigned)
            raw.append((STREAM_CHAIN, nodes, meta))
        else:
            # buffering / unknown ops: singleton boundary segments
            raw.append((BUFFERING, [nid], {}))
        assigned.update(raw[-1][1])

    # order segments by the topo position of their OUTPUT (last) node: every
    # external operand of a segment precedes its last node, so this is a
    # topological order of the segment DAG
    pos = {nid: k for k, nid in enumerate(order)}
    raw.sort(key=lambda t: pos[t[1][-1]])

    segments: list[Segment] = []
    segment_of: dict[int, int] = {}
    for sid, (kind, nodes, meta) in enumerate(raw):
        node_set = set(nodes)
        s_in: list[int] = []
        r_in: list[int] = []
        for nid in nodes:
            for i in g.nodes[nid].inputs:
                if i in node_set:
                    continue
                if i in resident:
                    if i not in r_in:
                        r_in.append(i)
                elif i not in s_in:
                    s_in.append(i)
        segments.append(Segment(sid, kind, tuple(nodes), tuple(s_in),
                                tuple(r_in), meta))
        for nid in nodes:
            segment_of[nid] = sid

    edges = [StreamEdge(segment_of.get(src, -1), seg.id, src)
             for seg in segments for src in seg.stream_inputs]

    plan = SegmentPlan(
        graph=g, segments=segments, edges=edges, resident=resident,
        rowconst=rowconst,
        inputs=tuple(n.id for n in input_nodes), batch=batch,
        segment_of=segment_of,
    )
    plan.validate()
    if config is not None:
        apply_hardware_config(plan, config)
    return plan


# ---------------------------------------------------------------------------
# dispatch planning (shared by executor and benchmarks): which Pallas kernel
# implements each segment, decided statically from the plan
# ---------------------------------------------------------------------------

INTERPRET = "interpret"


def segment_dispatch(plan: SegmentPlan, seg: Segment) -> str:
    """Kernel name for a segment: 'stream_matmul' | 'siren_layer' |
    'fused_chain' | 'interpret' (reference fallback)."""
    g = plan.graph
    if seg.kind == MATMUL:
        mm = g.nodes[seg.nodes[0]]
        lhs, rhs = (g.nodes[i] for i in mm.inputs)
        if (len(mm.shape) == 2 and len(lhs.shape) == 2 and len(rhs.shape) == 2
                and mm.inputs[0] not in plan.resident
                and mm.inputs[1] in plan.resident):
            return "stream_matmul"
        return INTERPRET
    if seg.kind == FUSED_MM_ACT:
        mm = g.nodes[seg.meta["mm"]]
        if len(g.nodes[mm.inputs[0]].shape) == 2 and \
                mm.inputs[0] not in plan.resident:
            return "siren_layer"
        return INTERPRET
    if seg.kind == STREAM_CHAIN:
        spec = seg.meta.get("chain")
        if spec is not None and len(g.nodes[seg.output].shape) == 2:
            return "fused_chain"
        return INTERPRET
    return INTERPRET


def dispatch_table(plan: SegmentPlan) -> list[tuple[int, str, str]]:
    """[(segment id, kind, kernel)] — the plan-level dispatch log."""
    return [(s.id, s.kind, segment_dispatch(plan, s)) for s in plan.segments]
