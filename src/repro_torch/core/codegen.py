"""Code generation (port of ``repro.core.codegen``; paper Sec. 3.2.5,
contribution 5).

The paper's compiler emits HLS C++ from the optimized graph + FIFO depths.
The reference emits a self-contained Python/JAX module from the
SegmentPlan; the port emits the same module in torch (DESIGN.md §3):

  * ONE FUNCTION PER EXECUTION UNIT — a fused region inlines every member
    segment (the source analogue of one region launch), and every other
    segment keeps its own function, mirroring the paper's stream-kernel
    library;
  * a ``pipeline(consts, *inputs)`` entry point whose per-block step wires
    the unit functions together in plan order (a loop over
    ``BATCH // BLOCK`` blocks), with the HardwareConfig recorded as
    ``HARDWARE_CONFIG``;
  * the emitted source is returned as a string AND can be exec-loaded, so
    the artifact is inspectable exactly like generated HLS code.

Each op is written as ``core.executor._eval_node`` computes it (the same
torch calls; ``broadcast_in_dim``, strided ``slice`` and ``pad`` through
helpers copied into the module), so the exec-loaded module equals the
interpreted executor bit for bit on the CPU.  The op set is the
reference's: any other op raises ``NotImplementedError("codegen: <op>")``
where the reference's does.  The module imports ``torch`` only and
launches no kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.config import HardwareConfig
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.segment import (SegmentPlan, build_segment_plan,
                                      segment_dispatch, _p)

_OP_EXPR = {
    "Mm": "{0} @ {1}",
    "T": "{0}.permute(*reversed(range({0}.dim())))",
    "Sin": "torch.sin({0})",
    "Cos": "torch.cos({0})",
    "Mul": "{0} * {1}",
    "Add": "{0} + {1}",
    "Sub": "{0} - {1}",
    "Div": "{0} / {1}",
    "Neg": "-{0}",
    "Exp": "torch.exp({0})",
    "Log": "torch.log({0})",
    "Tanh": "torch.tanh({0})",
    "Rsqrt": "torch.rsqrt({0})",
    "Sqrt": "torch.sqrt({0})",
    "Abs": "torch.abs({0})",
    "Sigmoid": "torch.sigmoid({0})",
    "Maximum": "torch.maximum({0}, {1})",
    "Minimum": "torch.minimum({0}, {1})",
    "Select": "torch.where({0}, {1}, {2})",
    "Identity": "{0}",
    "Pow": "torch.pow({0}, {1})",
}

# helpers the emitted module defines for itself: ``_bshape`` rewrites the
# trace batch to the incoming block's rows; ``_broadcast_in_dim``,
# ``_slice`` and ``_pad`` are ``core.executor``'s lax semantics
_HELPERS = '''\
def _bshape(shape, ref):
    # rewrite static batch dim to the incoming block's batch
    if shape and ref.dim() and shape[0] == BATCH:
        return (ref.shape[0],) + tuple(shape[1:])
    return tuple(shape)


def _broadcast_in_dim(x, shape, bdims):
    view = [1] * len(shape)
    for i, d in enumerate(bdims):
        view[d] = x.shape[i]
    return x.reshape(view).expand(tuple(shape))


def _slice(x, start, limit, strides, stream):
    start, limit = list(start), list(limit)
    if stream and x.dim():
        # the batch dim is never sliced in a streamable graph
        start[0], limit[0] = 0, x.shape[0]
    return x[tuple(slice(s, e, st) for s, e, st in zip(start, limit, strides))]


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
'''


# the emitted module's first line (the store tells the port's source.py
# from the reference's JAX one by it)
SOURCE_HEADER = ('"""Auto-generated by repro_torch.core.codegen — INR-Arch '
                 'pipeline.')


def _expr(node, args, stream: bool = True):
    """``node`` as a torch expression of ``args``.  ``stream``: the node
    runs on a block of rows (its batch dim is the block's, as
    ``_eval_node(..., block_b=rows)`` runs it); else it is a resident,
    computed at its traced shape."""
    op = node.op
    if op in _OP_EXPR:
        return _OP_EXPR[op].format(*args)
    if op == "Permute":
        return f"{args[0]}.permute(*{tuple(_p(node, 'permutation'))})"
    if op == "IntPow":
        return f"torch.pow({args[0]}, {int(_p(node, 'y'))})"
    if op == "Convert":
        return f"{args[0]}.to(torch.{node.dtype})"
    shape = (f"_bshape({node.shape!r}, {args[0]})" if stream
             else repr(tuple(node.shape)))
    if op == "Broadcast":
        return (f"_broadcast_in_dim({args[0]}, {shape}, "
                f"{tuple(_p(node, 'broadcast_dimensions', ()))})")
    if op == "Reshape":
        return f"{args[0]}.reshape({shape})"
    if op == "Sum":
        axes = tuple(_p(node, "axes"))
        return f"torch.sum({args[0]}, dim={axes})" if axes else args[0]
    if op == "Slice":
        start = list(_p(node, "start_indices"))
        limit = list(_p(node, "limit_indices"))
        strides = list(_p(node, "strides") or [1] * len(start))
        return (f"_slice({args[0]}, {start}, {limit}, {strides}, "
                f"{stream})")
    if op == "Pad":
        pc = [tuple(c) for c in _p(node, "padding_config")]
        return f"_pad({args[0]}, {args[1]}, {pc})"
    if op == "Concat":
        return f"torch.cat([{', '.join(args)}], dim={_p(node, 'dimension')})"
    raise NotImplementedError(f"codegen: {op}")


def _seg_fn_name(seg) -> str:
    return f"seg{seg.id}_{seg.kind.lower()}"


def _emit_nodes(L, g: ComputeGraph, plan: SegmentPlan, nodes, node_set,
                blk_ref: str, B: int):
    """Emit one ``v{nid} = ...`` line per IR node (shared by the segment and
    region emitters)."""
    for nid in nodes:
        n = g.nodes[nid]
        args = []
        for i in n.inputs:
            if i in node_set or i not in plan.resident:
                args.append(f"v{i}")
                continue
            a = f"_r[{i}]"
            if i in plan.rowconst and g.nodes[i].shape[:1] == (B,):
                # row-const residents: one row broadcast to the block's
                # rows (they may exceed the trace batch); weights stay whole
                a = f"_rows({a}, {blk_ref}.shape[0])"
            args.append(a)
        L.append(f"    v{nid} = {_expr(n, args)}")


def _emit_segment(L, g: ComputeGraph, plan: SegmentPlan, seg, B: int):
    """One function per segment: streams in, one tensor out."""
    params = ", ".join(["_r"] + [f"v{i}" for i in seg.stream_inputs])
    ops = "+".join(g.nodes[n].op for n in seg.nodes)
    kernel = segment_dispatch(plan, seg)
    L.append(f"def {_seg_fn_name(seg)}({params}):")
    L.append(f'    """{seg.kind}: {ops} -> n{seg.output} '
             f'[dispatch: {kernel}]."""')
    blk_ref = f"v{seg.stream_inputs[0]}"
    _emit_nodes(L, g, plan, seg.nodes, set(seg.nodes), blk_ref, B)
    L.append(f"    return v{seg.output}")
    L.append("")


def _region_fn_name(region) -> str:
    return f"region{region.id}"


def _emit_region(L, g: ComputeGraph, plan: SegmentPlan, region, B: int):
    """One function per FUSED region: the region launch's source analogue —
    every member segment inlined, intermediates never leave the function,
    streams in, the region's outputs out."""
    params = ", ".join(["_r"] + [f"v{i}" for i in region.stream_inputs])
    segs = "+".join(f"s{s}" for s in region.segments)
    tiles = region.meta.get("col_tiles", 1)
    tiled = (f", column-tiled x{tiles} (reduction carried across bn tiles)"
             if tiles > 1 else "")
    L.append(f"def {_region_fn_name(region)}({params}):")
    L.append(f'    """FusedRegion {segs}: one region launch, intermediates '
             f'on chip{tiled} [dispatch: region]."""')
    blk_ref = f"v{region.stream_inputs[0]}"
    nodes = [n for sid in region.segments
             for n in plan.segments[sid].nodes]
    _emit_nodes(L, g, plan, nodes, set(nodes), blk_ref, B)
    outs = ", ".join(f"v{o}" for o in region.outputs)
    L.append(f"    return ({outs},)")
    L.append("")


def emit_python(g: ComputeGraph, *, block: int | None = None,
                name: str = "generated",
                depths: dict | None = None,
                plan: SegmentPlan | None = None,
                config: HardwareConfig | None = None,
                region_plan=None) -> str:
    """Emit a Python/torch module implementing the optimized graph, one
    function per execution unit: fused regions (when the config enables the
    region scheduler) become one function each, and every remaining
    segment keeps its own function.  The region structure follows the
    SCHEDULE (``config.fuse_regions``), independent of ``use_pallas``, as
    in the reference.  The emitted source records the HardwareConfig it was
    compiled for (``HARDWARE_CONFIG``), the way the paper's generated HLS
    bakes in its configured hardware parameters."""
    if plan is None:
        plan = build_segment_plan(g, config=config)
    if config is None:
        config = plan.config
    if block is None:
        block = config.block if config is not None else 8
    if region_plan is None and config is not None and config.fuse_regions:
        from repro_torch.core.regions import build_region_plan
        region_plan = build_region_plan(plan, config)
    order = g.topo_order()
    B = plan.batch
    consts = [nid for nid in order
              if nid in plan.resident and g.nodes[nid].op == "Const"]

    L: list[str] = []
    L.append(SOURCE_HEADER)
    L.append(f'graph: {len(g.nodes)} nodes / {g.n_edges} edges;')
    L.append(f'plan: {len(plan.segments)} segments {plan.counts_by_kind()};')
    if region_plan is not None and region_plan.fused_regions():
        c = region_plan.counts()
        L.append(f'regions: {c["regions"]} units, {c["fused"]} fused '
                 f'covering {c["segments_fused"]} segments;')
    if config is not None:
        L.append(f'hardware config: {config.describe()}')
    if depths is not None:
        L.append(f'optimized FIFO sum-depth: {sum(depths.values())} blocks')
    L.append('"""')
    L.append("import torch")
    L.append("import torch.nn.functional as F")
    L.append("")
    L.append("BLOCK = %d" % block)
    L.append("BATCH = %d" % B)
    if config is not None:
        L.append(f"HARDWARE_CONFIG = {config.as_dict()!r}")
    L.append("")
    L.append(_HELPERS)
    L.append("")
    L.append("def _rows(a, rows):")
    L.append("    # a row-constant resident (equal rows) as `rows` rows")
    L.append("    return a[:1].expand(rows, *a.shape[1:]).contiguous()")
    L.append("")

    # residents
    L.append("def residents(consts):")
    L.append('    """Precompute const-derived tensors (weights stay on '
             'chip)."""')
    for i, nid in enumerate(consts):
        L.append(f"    v{nid} = consts[{i}]")
    for nid in order:
        if nid not in plan.resident or g.nodes[nid].op == "Const":
            continue
        n = g.nodes[nid]
        args = [f"v{i}" for i in n.inputs]
        L.append(f"    v{nid} = {_expr(n, args, stream=False)}")
    rlist = plan.resident_order()
    # contiguous, as the compiled artifact keeps its residents (the
    # reference emits ``return (,)`` for a graph without residents)
    L.append(f"    return tuple(v.contiguous() for v in "
             f"({''.join('v%d, ' % i for i in rlist)}))")
    L.append("")
    L.append(f"_RESIDENT_IDS = {tuple(rlist)}")
    L.append("")

    # one function per execution unit — the stream-kernel library for this
    # graph: fused regions inline their member segments (DESIGN.md §7)
    units = (region_plan.units() if region_plan is not None
             else [("seg", s) for s in plan.segments])
    for kind, u in units:
        if kind == "region":
            _emit_region(L, g, plan, u, B)
        else:
            _emit_segment(L, g, plan, u, B)

    # per-block wiring: calls unit functions in plan (topological) order.
    # resident (const-derived) outputs never stream — pipeline() returns
    # them straight from resident memory, as the dataflow mapping models
    streamed_outs = [o for o in g.outputs if o not in plan.resident]
    L.append("def pipeline_step(res, *xblk):")
    L.append('    """One pipeline step: wire every unit over one block."""')
    L.append("    _r = dict(zip(_RESIDENT_IDS, res))")
    for nid in plan.inputs:
        L.append(f"    v{nid} = xblk[{_p(g.nodes[nid], 'idx')}]")

    for kind, u in units:
        args = ", ".join(["_r"] + [f"v{i}" for i in u.stream_inputs])
        if kind == "region":
            outs_l = ", ".join(f"v{o}" for o in u.outputs)
            L.append(f"    {outs_l}, = {_region_fn_name(u)}({args})"
                     if len(u.outputs) == 1 else
                     f"    {outs_l} = {_region_fn_name(u)}({args})")
        else:
            L.append(f"    v{u.output} = {_seg_fn_name(u)}({args})")
    outs = ", ".join(f"v{o}" for o in streamed_outs)
    L.append(f"    return ({outs},)")
    L.append("")

    L.append("def pipeline(consts, *inputs):")
    L.append('    """Streaming execution: blocks flow through the units."""')
    L.append("    res = residents(consts)")
    if streamed_outs:
        L.append("    nb = BATCH // BLOCK")
        L.append("    steps = [pipeline_step(res, *(x[i * BLOCK:(i + 1) * "
                 "BLOCK] for x in inputs)) for i in range(nb)]")
        L.append("    outs = [torch.cat(col) for col in zip(*steps)]")
    final = []
    k = 0
    for o in g.outputs:
        if o in plan.resident:
            final.append(f"res[{rlist.index(o)}]")
        else:
            final.append(f"outs[{k}]")
            k += 1
    L.append(f"    return ({', '.join(final)},)")
    L.append("")
    return "\n".join(L)


def load_generated(src: str):
    """exec the emitted module; returns (pipeline_fn, namespace)."""
    ns: dict = {}
    exec(compile(src, "<inr-arch-codegen>", "exec"), ns)
    return ns["pipeline"], ns


def graph_consts(g: ComputeGraph, plan: SegmentPlan | None = None, *,
                 device=None):
    """The Const leaves ``residents(consts)`` takes, in its order, as
    tensors on ``device`` (the CPU when None)."""
    from repro_torch.core.executor import const_tensor
    resident_ids = (plan.resident if plan is not None
                    else build_segment_plan(g).resident)
    device = torch.device("cpu") if device is None else torch.device(device)
    return [const_tensor(g.nodes[nid], device) for nid in g.topo_order()
            if nid in resident_ids and g.nodes[nid].op == "Const"]
