"""Graph executors on torch tensors (port of ``repro.core.executor``).

* ``reference_executor`` evaluates the ComputeGraph op by op in topological
  order, materializing every intermediate (the buffered execution).
* ``_run_segment`` / ``_run_region`` execute one unit of the SegmentPlan /
  RegionPlan over the rows of one call (a block, or a chunk of
  ``chunk_blocks`` blocks as one launch); ``core.pipeline.CompiledGradient``
  drives them.  A unit dispatches to its kernel wrapper (``fused_chain``,
  ``stream_matmul``, ``siren_layer``, ``region``), which launches the CUDA
  kernel for CUDA tensors and runs its plain version for CPU tensors; the
  ``interpret`` decision evaluates the unit node by node.

``streaming_executor`` is the thin compile-or-hit wrapper over
``core.pipeline.compile_from_graph``; ``buffered_peak_bytes``,
``buffered_total_bytes`` and ``streaming_peak_bytes`` are the analytic
memory accounting (the paper's Table I memory column: bytes of the
model, not readings of the device).

``_eval_node`` keeps lax semantics (``broadcast_in_dim``, strided ``slice``,
``pad`` with lo/hi/interior), so it computes what the reference computes on
the same graph.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import ComputeGraph, Node
from repro_torch.core.segment import (SegmentPlan, build_segment_plan,
                                      classify_residents, _p)
from repro_torch.kernels.common import fp32_strict


def torch_dtype(dtype) -> torch.dtype:
    """IR dtype string ('float32', 'int32', 'bool', ...) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).removeprefix("torch.")
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


def _broadcast_in_dim(x, shape, bdims):
    view = [1] * len(shape)
    for i, d in enumerate(bdims):
        view[d] = x.shape[i]
    return x.reshape(view).expand(tuple(shape))


def _pad(x, value, config):
    """lax.pad: per dim (lo, hi, interior); negative lo/hi crop."""
    v = float(value)
    for d, (_, _, interior) in enumerate(config):
        n = x.shape[d]
        if interior and n > 1:
            shape = list(x.shape)
            shape[d] = n + (n - 1) * interior
            out = x.new_full(shape, v)
            idx = [slice(None)] * x.dim()
            idx[d] = slice(None, None, interior + 1)
            out[tuple(idx)] = x
            x = out
    pads = []
    for lo, hi, _ in reversed(config):
        pads += [lo, hi]
    return F.pad(x, pads, value=v) if any(pads) else x


def _eval_node(node: Node, args, block_b: int | None = None, *,
               device=None):
    """Evaluate one IR node given operand values (``device`` places the
    operand-free ``Iota``)."""
    op = node.op
    shape = node.shape
    if block_b is not None and len(shape) > 0:
        shape = (block_b, *shape[1:])
    if op == "Mm":
        return args[0] @ args[1]
    if op == "T":
        return args[0].permute(*reversed(range(args[0].dim())))
    if op == "Permute":
        return args[0].permute(*_p(node, "permutation"))
    if op == "Sin":
        return torch.sin(args[0])
    if op == "Cos":
        return torch.cos(args[0])
    if op == "Mul":
        return args[0] * args[1]
    if op == "Add":
        return args[0] + args[1]
    if op == "Sub":
        return args[0] - args[1]
    if op == "Div":
        return args[0] / args[1]
    if op == "Neg":
        return -args[0]
    if op == "Exp":
        return torch.exp(args[0])
    if op == "Log":
        return torch.log(args[0])
    if op == "Tanh":
        return torch.tanh(args[0])
    if op == "Rsqrt":
        return torch.rsqrt(args[0])
    if op == "Sqrt":
        return torch.sqrt(args[0])
    if op == "Abs":
        return torch.abs(args[0])
    if op == "Sign":
        return torch.sign(args[0])
    if op == "Sigmoid":
        return torch.sigmoid(args[0])
    if op == "Erf":
        return torch.erf(args[0])
    if op == "IntPow":
        return torch.pow(args[0], int(_p(node, "y")))
    if op == "Pow":
        return torch.pow(args[0], args[1])
    if op == "Maximum":
        return torch.maximum(args[0], args[1])
    if op == "Minimum":
        return torch.minimum(args[0], args[1])
    if op == "Select":
        # the reference executor's operand order: where(args0, args1, args2)
        return torch.where(args[0], args[1], args[2])
    if op == "Convert":
        return args[0].to(torch_dtype(node.dtype))
    if op == "Identity":
        return args[0]
    if op == "Broadcast":
        return _broadcast_in_dim(args[0], shape,
                                 _p(node, "broadcast_dimensions", ()))
    if op == "Reshape":
        return args[0].reshape(shape)
    if op == "Sum":
        axes = tuple(_p(node, "axes"))
        return torch.sum(args[0], dim=axes) if axes else args[0]
    if op == "Max":
        axes = tuple(_p(node, "axes"))
        return torch.amax(args[0], dim=axes) if axes else args[0]
    if op == "Concat":
        return torch.cat(list(args), dim=_p(node, "dimension"))
    if op == "Slice":
        start = list(_p(node, "start_indices"))
        limit = list(_p(node, "limit_indices"))
        strides = _p(node, "strides") or [1] * len(start)
        if block_b is not None and args[0].dim():
            # batch dim is never sliced in a streamable graph
            start[0], limit[0] = 0, args[0].shape[0]
        return args[0][tuple(slice(s, e, st)
                             for s, e, st in zip(start, limit, strides))]
    if op == "Pad":
        return _pad(args[0], args[1], _p(node, "padding_config"))
    if op == "Iota":
        d = _p(node, "dimension", 0)
        ar = torch.arange(shape[d], device=device,
                          dtype=torch_dtype(node.dtype))
        return _broadcast_in_dim(ar, shape, (d,))
    raise NotImplementedError(f"executor: op {op} ({node.params})")


def const_tensor(node: Node, device) -> torch.Tensor:
    return torch.as_tensor(node.const, device=device).to(
        torch_dtype(node.dtype))


def reference_executor(g: ComputeGraph):
    """Returns f(*inputs) evaluating the graph op by op (buffered), on the
    device of the first input."""
    order = g.topo_order()
    fp32_strict()

    def f(*inputs):
        device = inputs[0].device if inputs else torch.device("cpu")
        env: dict[int, torch.Tensor] = {}
        for nid in order:
            n = g.nodes[nid]
            if n.op == "Input":
                env[nid] = inputs[_p(n, "idx")]
            elif n.op == "Const":
                env[nid] = const_tensor(n, device)
            else:
                env[nid] = _eval_node(n, [env[i] for i in n.inputs],
                                      device=device)
        return tuple(env[o] for o in g.outputs)
    return f


def check_streamable(g: ComputeGraph) -> bool:
    """Every stream-carried tensor must keep the batch dim in axis 0."""
    resident, streamed = classify_residents(g)
    inputs = [n for n in g.nodes.values() if n.op == "Input"]
    if not inputs:
        return False
    B = inputs[0].shape[0] if inputs[0].shape else None
    if B is None:
        return False
    for nid in streamed:
        n = g.nodes[nid]
        if n.op == "Input":
            if not n.shape or n.shape[0] != B:
                return False
            continue
        if not n.shape or n.shape[0] != B:
            return False
        # batch dim must not be contracted/permuted away
        if n.op == "Mm":
            lhs = g.nodes[n.inputs[0]]
            if lhs.id not in resident and lhs.shape[0] != B:
                return False
        if n.op in ("T",):
            return False                      # transposing batch out of axis 0
        if n.op == "Permute":
            perm = _p(n, "permutation")
            if perm and perm[0] != 0:
                return False
        if n.op == "Slice":
            start = _p(n, "start_indices")
            inp = g.nodes[n.inputs[0]]
            if start and (start[0] != 0 or
                          _p(n, "limit_indices")[0] != inp.shape[0]):
                return False
        if n.op == "Pad":
            pc = _p(n, "padding_config")
            if pc and tuple(pc[0]) != (0, 0, 0):
                return False
    return True


class ResidentEnv(dict):
    """A resident environment (node id -> tensor) that keeps, per
    row-constant resident, the contiguous ``[rows, ...]`` block a call of
    ``rows`` rows reads it as: built at first use for the largest row count
    seen so far, and handed to a call of fewer rows as its leading rows.
    An artifact sees a full chunk and remainders, so each block is built
    about once and costs a launch no host time after that."""

    def __init__(self, residents=()):
        super().__init__(residents)
        self._blocks: dict[int, torch.Tensor] = {}

    def row_block(self, nid: int, rows: int) -> torch.Tensor:
        """Row-constant resident ``nid`` (equal rows) as ``rows`` rows: its
        row 0 broadcast, contiguous."""
        have = self._blocks.get(nid)
        if have is None or have.shape[0] < rows:
            a = self[nid]
            have = self._blocks[nid] = a[:1].expand(
                rows, *a.shape[1:]).contiguous()
        return have if have.shape[0] == rows else have[:rows]


def _resident_val(plan: SegmentPlan, res_env: ResidentEnv, i: int, rows: int,
                  B: int):
    """Resident ``i`` as a call of ``rows`` rows reads it.  A row-constant
    resident with the trace batch B as its dim 0 has equal rows, so it
    serves any row count (a chunk may hold more rows than B) as a block of
    its row 0.  Weights (even if dim0 == B) stay whole."""
    a = res_env[i]
    if i in plan.rowconst and a.dim() and a.shape[:1] == (B,):
        return res_env.row_block(i, rows)
    return a


def _run_segment(plan: SegmentPlan, seg, kernel: str, env,
                 res_env: ResidentEnv, rows: int, B: int):
    """Execute one segment on ``rows`` rows; returns the segment's output."""
    g = plan.graph

    def val(i):
        if i in plan.resident:
            return _resident_val(plan, res_env, i, rows, B)
        return env[i]

    if kernel == "stream_matmul":
        from repro_torch.kernels.stream_matmul import stream_matmul
        mm = g.nodes[seg.nodes[0]]
        return stream_matmul(env[mm.inputs[0]], res_env[mm.inputs[1]],
                             mm_parallel=seg.meta.get("mm_parallel"))

    if kernel == "siren_layer":
        from repro_torch.kernels.siren_layer import siren_layer
        mm = g.nodes[seg.meta["mm"]]
        x = env[mm.inputs[0]]
        w = res_env[mm.inputs[1]]
        b = None
        if seg.meta["bias"] is not None:
            # bias is (N,), (1, N), or a row-const (B, N): one row is the vector
            b = res_env[seg.meta["bias"]]
            b = b[0] if b.dim() == 2 else b
        return siren_layer(x, w, b, w0=seg.meta["w0"],
                           apply_sin=seg.meta["apply_sin"],
                           mm_parallel=seg.meta.get("mm_parallel"))

    if kernel == "fused_chain":
        from repro_torch.kernels.fused_chain import fused_chain
        spec = seg.meta["chain"]
        x = val(spec.x)
        extras = [val(e) for e in spec.extras]
        return fused_chain(x, spec.program, extras)

    # reference fallback: interpret the segment node by node
    local: dict[int, torch.Tensor] = {}
    node_set = set(seg.nodes)
    for nid in seg.nodes:
        n = g.nodes[nid]
        args = [local[i] if i in node_set else val(i) for i in n.inputs]
        local[nid] = _eval_node(n, args, block_b=rows,
                                device=args[0].device if args else None)
    return local[seg.output]


def _run_region(plan: SegmentPlan, region, env, res_env: ResidentEnv,
                rows: int, B: int):
    """Execute one FusedRegion on ``rows`` rows through the region kernel:
    intermediates stay inside the launch; region outputs are assigned into
    ``env``."""
    from repro_torch.kernels.region import region_call
    outs = region_call(region.spec,
                       *region_operands(plan, region, env, res_env, rows, B))
    for nid, o in zip(region.outputs, outs):
        env[nid] = o


def region_operands(plan: SegmentPlan, region, env, res_env: ResidentEnv,
                    rows: int, B: int):
    """``(stream, rows, residents, out_info)`` of one region on ``rows``
    rows, as ``region_call`` takes them."""
    g = plan.graph
    spec = region.spec
    stream = [env[nid] for nid in region.stream_inputs]
    for nid, cols in region.broadcast_inputs:
        a = _resident_val(plan, res_env, nid, rows, B)
        stream.append(torch.broadcast_to(a, (rows, cols)).contiguous())
    row_ops = []
    for nid, cols in region.bcast_rows:
        # row-const resident extra: ONE [1, C] row broadcasts in the kernel
        a = res_env[nid]
        if a.dim() >= 2:
            a = a[:1].reshape(1, a.shape[-1])
        elif a.dim() == 1:
            a = a[None, :]
        else:
            a = a.reshape(1, 1)
        row_ops.append(a)
    bias_ids = {s[4] for s in spec.steps if s[0] == "mm" and s[4] is not None}
    residents = []
    for nid in region.resident_inputs:
        a = res_env[nid]
        if nid in bias_ids and a.dim() == 2:
            # bias is (1, N) or a row-const (B, N): one row is the vector
            a = a[0]
        residents.append(a)
    out_info = tuple((g.nodes[o].shape[-1], g.nodes[o].dtype)
                     for o in region.outputs)
    return stream, row_ops, residents, out_info


# per-graph compile cache for the thin wrapper below: repeat calls with the
# same (graph, plan, HardwareConfig, device) reuse the CompiledGradient
# artifact.  Keyed by object identity — the key holds the graph AND plan
# objects themselves (SegmentPlan hashes by identity), never id() ints: a
# cached entry keeps its plan alive, so a freed plan's recycled id can never
# alias a different plan's artifact.  Mutating a graph after executing it
# through this path is unsupported (go through
# core.pipeline.compile_from_graph).
_GRAPH_CACHE: dict[tuple, object] = {}


def streaming_executor(g: ComputeGraph, block: int | None = None, *,
                       plan: SegmentPlan | None = None,
                       use_pallas: bool | None = None,
                       dispatch_log: list | None = None,
                       config=None, device=None):
    """Returns f(*inputs) that executes the SegmentPlan as a block pipeline.

    Thin wrapper over the compile-once / serve-many layer: the graph is
    compiled into a ``core.pipeline.CompiledGradient`` on ``device`` (CUDA
    unless the caller passes "cpu") — residents computed once — or fetched
    from the per-graph cache, and the artifact's ``apply`` is returned.

    Hardware parameters come from ``config`` (a ``HardwareConfig``); the
    ``block`` / ``use_pallas`` kwargs are conveniences folded into it.
    ``dispatch_log``, if given, receives one ``(id, kind, kernel)`` entry
    per kernel invocation of a pass: with ``config.fuse_regions`` (the
    default) and kernel dispatch on, a fused region logs a single
    ``(region id, "FusedRegion", "region[...]")`` entry and every other
    segment its ``(segment id, kind, kernel)``; with ``use_pallas=False``
    the log is per-segment ``interpret`` entries."""
    from repro_torch.core.config import as_hardware_config
    from repro_torch.core.pipeline import compile_from_graph
    from repro_torch.kernels.common import resolve_device
    from repro_torch.obs.metrics import counter

    device = resolve_device(device)
    cfg = as_hardware_config(config, block=block,
                             use_pallas=use_pallas).resolved()
    key = (g, plan, cfg, device)
    cg = _GRAPH_CACHE.get(key)
    if cg is None:
        counter("graph_cache_misses",
                "streaming_executor per-graph cache misses").inc()
        cg = compile_from_graph(g, config=cfg, plan=plan, device=device)
        _GRAPH_CACHE[key] = cg
    else:
        counter("graph_cache_hits",
                "streaming_executor per-graph cache hits").inc()
    if dispatch_log is not None:
        dispatch_log.extend(cg.dispatch)
    return cg.apply


# ---------------------------------------------------------------------------
# analytic memory accounting (paper Table I "Memory" analogue)
# ---------------------------------------------------------------------------

def _nbytes(node: Node) -> int:
    return node.size * np.dtype(node.dtype).itemsize


def buffered_peak_bytes(g: ComputeGraph) -> int:
    """Liveness-based peak memory of the buffered schedule (an OPTIMISTIC
    baseline: real eager frameworks do not pack this tightly).  Parameters
    (Const nodes) are never freed."""
    order = g.topo_order()
    last_use: dict[int, int] = {}
    for t, nid in enumerate(order):
        for i in g.nodes[nid].inputs:
            last_use[i] = t
    for o in g.outputs:
        last_use[o] = len(order)
    live = 0
    peak = 0
    for t, nid in enumerate(order):
        live += _nbytes(g.nodes[nid])
        peak = max(peak, live)
        for i in g.nodes[nid].inputs:
            if last_use.get(i) == t and g.nodes[i].op != "Const":
                live -= _nbytes(g.nodes[i])
    return peak


def buffered_total_bytes(g: ComputeGraph) -> int:
    """Sum of every tensor in the graph — the eager-framework analogue the
    paper's CPU/GPU baselines exhibit (each kernel allocates its output;
    intermediates are not liveness-packed within the op stream)."""
    return sum(_nbytes(n) for n in g.nodes.values())


def streaming_peak_bytes(g: ComputeGraph, design, depths: dict[int, int], *,
                         plan: SegmentPlan | None = None) -> int:
    """Residents + FIFO memory (depths x block bytes) — the dataflow memory.

    Derived from the same SegmentPlan that executes and maps to FIFOs, so the
    accounting sees exactly the segments that run.  Row-constant residents
    (reverse-mode seeds and their derivatives) store ONE row — their content
    is identical across the batch, so the dataflow design re-broadcasts a
    single block."""
    if plan is None:
        plan = build_segment_plan(g)
    resident_ids, rc = plan.resident, plan.rowconst
    res = 0
    for i in resident_ids:
        n = g.nodes[i]
        b = _nbytes(n)
        if i in rc and n.shape and n.shape[0] > 1:
            b //= n.shape[0]
        res += b
    fifo = design.fifo_bytes(depths)
    return res + fifo
