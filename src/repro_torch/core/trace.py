"""Computation-graph extraction with ``make_fx`` (port of ``repro.core.trace``).

The paper walks PyTorch's autograd graph; the port traces the
(nested-gradient) function with ``torch.fx.experimental.proxy_tensor.make_fx``
and converts the aten graph to the ComputeGraph IR, so the raw chain-rule
redundancy is visible to the optimization passes.  The conversion produces
the reference's graph shapes:

  * ``aten.t`` / ``permute`` become ``Permute`` (``optimize`` turns them
    into ``T``);
  * Python scalars such as ``w0`` become shape-``()`` ``Const`` nodes, so
    the planner bakes them into kernels as it does in the reference;
  * implicit broadcasts become explicit ``Broadcast`` nodes (a bias ``[N]``
    goes through ``Broadcast (N,) -> (1, N)``, ``broadcast_dimensions=(1,)``),
    so the planner recognizes it as a bias;
  * ``detach`` / ``alias`` / ``lift_fresh_copy`` / ``clone`` map to their
    operand without a node (the passes never remove an ``Identity``, and a
    chain holding one could not be fused).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core.graph import ComputeGraph

# aten op (overload packet name) -> IR op name, for ops whose operands map
# one to one; names follow the paper (Mm, Permute, ...) as trace.PRIM_MAP
PRIM_MAP = {
    "mm": "Mm",
    "sin": "Sin", "cos": "Cos", "neg": "Neg", "exp": "Exp", "log": "Log",
    "tanh": "Tanh", "rsqrt": "Rsqrt", "sqrt": "Sqrt", "abs": "Abs",
    "sign": "Sign", "sigmoid": "Sigmoid", "erf": "Erf",
    "mul": "Mul", "add": "Add", "sub": "Sub", "div": "Div",
    "maximum": "Maximum", "minimum": "Minimum", "where": "Select",
}
_BINARY = {"Mul", "Add", "Sub", "Div", "Maximum", "Minimum", "Select"}
_PASSTHROUGH = {"detach", "alias", "lift_fresh_copy", "clone"}

# monotonic tracer-invocation counter (tests assert deltas)
TRACE_CALLS = 0


def _np_dtype(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def extract_graph(fn, *example_args) -> ComputeGraph:
    """Trace ``fn`` at the given example tensors and convert to
    ComputeGraph.  Tensors ``fn`` closes over (weights, gradient seeds)
    become ``Const`` nodes."""
    global TRACE_CALLS
    TRACE_CALLS += 1
    gm = make_fx(fn)(*example_args)
    g = ComputeGraph()
    env: dict = {}           # fx node -> IR node id
    consts: dict = {}        # get_attr target -> IR node id

    def meta(node):
        v = node.meta["val"]
        return tuple(v.shape), _np_dtype(v.dtype)

    def scalar(v, dtype):
        arr = np.asarray(v, dtype=dtype)
        return g.add("Const", (), arr.dtype, const=arr)

    def operand(a, dtype):
        return env[a] if isinstance(a, torch.fx.Node) else scalar(a, dtype)

    def broadcast_to_rank(nid, rank):
        """Rank-promote a lower-rank operand as jnp does: leading 1s, with
        broadcast_dimensions naming its axes in the output."""
        shape = g.nodes[nid].shape
        if not shape or len(shape) >= rank:
            return nid
        pad = rank - len(shape)
        out = (1,) * pad + tuple(shape)
        return g.add("Broadcast", out, g.nodes[nid].dtype, (nid,),
                     (("broadcast_dimensions", tuple(range(pad, rank))),
                      ("shape", out)))

    idx = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            shape, dt = meta(node)
            env[node] = g.add("Input", shape, dt, params=(("idx", idx),))
            idx += 1
        elif node.op == "get_attr":
            if node.target not in consts:
                t = getattr(gm, node.target).detach().cpu()
                arr = t.numpy().copy()
                consts[node.target] = g.add("Const", arr.shape, arr.dtype,
                                            const=arr)
            env[node] = consts[node.target]
        elif node.op == "call_function":
            env[node] = _convert(g, node, meta, operand, broadcast_to_rank)
        elif node.op == "output":
            outs = node.args[0]
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            g.outputs = [env[o] for o in outs]
    g.prune_dead()
    return g


def _convert(g, node, meta, operand, broadcast_to_rank) -> int:
    name = node.target.overloadpacket.__name__
    if name in _PASSTHROUGH:
        return operand(node.args[0], None)
    shape, dt = meta(node)
    if name in ("add", "sub") and node.kwargs.get("alpha", 1) != 1:
        raise NotImplementedError(f"extract_graph: {node.target} with alpha")
    if name == "t" or name == "permute":
        src = operand(node.args[0], dt)
        if name == "t":
            if len(shape) < 2:
                return src
            perm = (1, 0)
        else:
            perm = tuple(int(d) % len(shape) for d in node.args[1])
        return g.add("Permute", shape, dt, (src,),
                     (("permutation", perm),))
    if name == "pow" and not isinstance(node.args[1], torch.fx.Node):
        y = node.args[1]
        src = operand(node.args[0], dt)
        if float(y).is_integer():
            return g.add("IntPow", shape, dt, (src,), (("y", int(y)),))
        return g.add("Pow", shape, dt, (src, operand(y, dt)))
    if name == "expand":
        src = operand(node.args[0], dt)
        rank = len(g.nodes[src].shape)
        return g.add("Broadcast", shape, dt, (src,),
                     (("broadcast_dimensions",
                       tuple(range(len(shape) - rank, len(shape)))),
                      ("shape", shape)))
    if name in ("view", "reshape", "_unsafe_view"):
        return g.add("Reshape", shape, dt, (operand(node.args[0], dt),),
                     (("new_sizes", shape),))
    op = PRIM_MAP.get(name)
    if op is None:
        raise NotImplementedError(f"extract_graph: no IR op for {node.target}")
    ins = [operand(a, dt) for a in node.args]
    if op in _BINARY:
        ins = [broadcast_to_rank(i, len(shape)) for i in ins]
    return g.add(op, shape, dt, tuple(ins))
