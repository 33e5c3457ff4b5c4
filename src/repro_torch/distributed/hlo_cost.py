"""Per-rank cost of a step, counted from the dispatcher (port of
``repro.distributed.hlo_cost``).

The reference parses XLA's optimized HLO and walks its call graph,
multiplying each while body by its trip count.  torch has no HLO: a step
runs eagerly, op by op, so this module records every aten op that reaches
the dispatcher under ``CostMode`` (a ``TorchDispatchMode``: its kind, its
tensor operands and results by identity, their bytes) and applies the
reference's rules to that list.  Each layer runs in a Python loop, so
every op is seen as many times as it runs and there are no trip counts to
multiply.  Under ``FakeTensorMode`` nothing is computed or allocated, and
a step of any size is counted in seconds.

The numbers are per rank: one process stands for rank 0 of the process
group (``launch/dryrun.py`` runs a fake group of 256 or 512 ranks), and a
sharded step hands its kernels the rank's local tensors.

  * flops            — matrix products (``mm``, ``addmm``, ``bmm``,
                       ``baddbmm``): 2 * |result| * K; the port's custom
                       ops (``repro_torch::flash_attention_fwd`` and the
                       rest) and any other op ``torch.utils.flop_counter``
                       has a formula for: that formula; reductions: the
                       elements of the input; transcendental elementwise
                       ops: 4 * |result|; every other op: |result|
  * bytes_raw        — every op's operand and result bytes
  * bytes_streamed   — the same, less the elementwise ops whose result has
                       at most one consumer (the reference's rule: such an
                       op streams through registers in a fused pipeline)
  * collective bytes — per collective type, operand bytes per rank
  * param collectives — beyond the reference's record: the collectives
                       whose operand is a parameter block, or a copy of
                       one (``CostMode(watch=blocks)``: a view, clone,
                       cast, ``copy_``, concatenation or collective of a
                       watched tensor is watched too), their count and
                       operand bytes

Views and aliases (``view``, ``expand``, ``t``, ``permute``, ``slice``,
``select``, ``alias``, ``detach`` and the rest), allocations without a
write (``empty``) and queries that return no tensor cost nothing.  A
DTensor op is left to DTensor, which turns it into ops on the rank's
local tensors; those are counted.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")

# (namespace, op) -> (collective, index of the operand argument, index of
# the result argument or None for the op's return value)
_COLLECTIVE_OPS = {
    ("c10d", "allreduce_"): ("all-reduce", 0, 0),
    ("c10d", "allgather_"): ("all-gather", 1, 0),
    ("c10d", "_allgather_base_"): ("all-gather", 1, 0),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1, 0),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1, 0),
    ("c10d", "alltoall_"): ("all-to-all", 1, 0),
    ("c10d", "alltoall_base_"): ("all-to-all", 1, 0),
    ("_c10d_functional", "all_reduce"): ("all-reduce", 0, None),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 0, None),
    ("_c10d_functional", "reduce_scatter_tensor"):
        ("reduce-scatter", 0, None),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 0, None),
}

# ops that move no data and do no arithmetic (besides every op whose
# schema returns an alias of an input without writing it: a view); a
# wait returns the tensor it waited on
_FREE_OPS = {
    "view", "_unsafe_view", "expand", "t", "permute", "slice", "select",
    "alias", "detach", "transpose", "unsqueeze", "squeeze", "as_strided",
    "split", "split_with_sizes", "unbind", "lift_fresh", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "arange", "wait_tensor",
}

_DOTS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1}   # -> index of A

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "var", "std", "var_mean", "std_mean", "linalg_vector_norm", "norm",
    "any", "all", "cumsum", "cumprod", "logsumexp", "_softmax",
    "_log_softmax", "nll_loss_forward", "count_nonzero",
}
# reductions that take an exp of every input element on the way
_EXP_REDUCTIONS = {"logsumexp", "_softmax", "_log_softmax"}

_TRANSCENDENTAL = {
    "sin", "cos", "exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
    "tanh", "rsqrt", "sqrt", "pow", "sigmoid", "erf", "erfinv", "silu",
    "gelu", "softplus", "atan2", "tanh_backward", "sigmoid_backward",
    "silu_backward", "gelu_backward", "softplus_backward",
}

# elementwise ops: a result with at most one consumer streams (the
# reference's _ELEMENTWISE: arithmetic, compare, select, convert, copy,
# concatenate, pad, reverse)
_ELEMENTWISE = _TRANSCENDENTAL | {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "sign", "floor", "ceil", "round", "trunc", "reciprocal", "square",
    "_to_copy", "copy", "clone", "eq", "ne", "lt", "le", "gt", "ge",
    "where", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "clamp",
    "clamp_min", "clamp_max", "cat", "constant_pad_nd", "flip", "remainder",
    "fmod", "masked_fill", "fill", "zero", "zeros", "ones", "full",
    "zeros_like", "ones_like", "full_like", "scalar_tensor", "lerp",
    "addcmul", "addcdiv", "isfinite", "isnan", "threshold_backward",
    "_softmax_backward_data", "_log_softmax_backward_data", "repeat",
    "repeat_interleave", "relu", "new_zeros", "new_ones", "new_full",
    "stack", "tril", "triu", "select_backward", "slice_backward",
}
# a copy into (a view of) an existing tensor: the reference's
# dynamic-update-slice, read the update and write it
_UPDATES = {"copy_"}
# reads of rows by index: the reference's gather / dynamic-slice
_GATHERS = {"index", "index_select", "gather", "embedding"}
# ops whose result holds their operands' values as they are: a copy of a
# watched tensor is watched
_COPIES = {"clone", "_to_copy", "copy_", "cat", "stack"}


def type_bytes(dtype: torch.dtype, shape=()) -> int:
    """Bytes of a ``shape`` array of ``dtype`` (one element: ``shape=()``)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes an op touches in ``t``: its elements times the item size, a
    dimension broadcast with stride 0 counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= int(size)
    return n * t.dtype.itemsize


@dataclass
class Cost:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes_raw: float = 0.0
    bytes_streamed: float = 0.0
    collectives: dict = field(default_factory=lambda: {
        c: {"count": 0.0, "bytes": 0.0} for c in COLLECTIVES})
    by_kind: dict = field(default_factory=dict)      # kind -> streamed bytes
    # beyond the reference's record: the matrix products' and custom ops'
    # share of ``flops`` (what ``FlopCounterMode`` counts), the calls of
    # each custom op and the shapes of their first operand, and the ops
    # seen
    dot_flops: float = 0.0
    kernel_calls: dict = field(default_factory=collections.Counter)
    kernel_shapes: dict = field(default_factory=dict)
    n_ops: int = 0
    param_collectives: dict = field(default_factory=lambda: {
        "count": 0.0, "bytes": 0.0})

    def _bk(self, kind: str, nbytes: float):
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + nbytes

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    def as_dict(self) -> dict:
        top = dict(sorted(self.by_kind.items(), key=lambda kv: -kv[1])[:12])
        return {"flops": self.flops, "transcendentals": self.transcendentals,
                "bytes_raw": self.bytes_raw,
                "bytes_streamed": self.bytes_streamed,
                "collective_bytes": self.collective_bytes,
                "collectives": self.collectives, "bytes_by_kind_top": top}


@dataclass
class _Op:
    kind: str                 # the aten name, the custom op's, "dot",
    #                           "reduce", "dus", "gather" or the collective
    rule: str                 # dot | custom | collective | reduce |
    #                           update | gather | elementwise | generic
    flops: float
    transcendentals: float
    obytes: int               # operand bytes
    rbytes: int               # result bytes
    operands: list            # producers (op indices) of tensor operands
    cbytes: int = 0           # a collective's operand bytes
    shape: tuple = ()         # a custom op's first operand's shape
    carries: bool = False     # a collective whose operand is watched


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _written(func, args, kwargs) -> list:
    """The tensors an in-place op writes (its mutable arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            out += _tensors(v)
    return out


class CostMode(TorchDispatchMode):
    """Records every op run under it; ``cost()`` applies the rules.  Enter
    it inside ``FakeTensorMode`` to count a step without running it.
    ``watch``: tensors (a step's parameter blocks) whose collectives are
    counted apart (``Cost.param_collectives``), with their views and
    copies, by identity (fake tensors share no storage to compare)."""

    def __init__(self, watch=()):
        super().__init__()
        self.ops: list[_Op] = []
        self._producer = torch.utils.weak.WeakIdKeyDictionary()
        self._watched = torch.utils.weak.WeakIdKeyDictionary(
            {t: True for t in watch})

    def _watch(self, sources, results):
        """Watch ``results`` where any of ``sources`` is watched."""
        if any(t in self._watched for t in sources):
            for t in results:
                self._watched[t] = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor turns the op into ops on local tensors: count those
            return NotImplemented
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not outs and not _written(func, args, kwargs) and (
                ns, name) not in _COLLECTIVE_OPS:
            return          # a query: a dtype, a number, a device
        if (name in _FREE_OPS or _is_view(func)) and ns in (
                "aten", "prim", "_c10d_functional"):
            # a view is its base's value: its consumers are the producer's
            self._watch(ins[:1], outs)
            src = self._producer.get(ins[0]) if ins else None
            for t in outs:
                if src is None:
                    self._producer.pop(t, None)
                else:
                    self._producer[t] = src
            return
        idx = len(self.ops)
        operands = [self._producer[t] for t in ins if t in self._producer]
        base = name[:-1] if name.endswith("_") and name not in _UPDATES \
            and (ns, name) not in _COLLECTIVE_OPS else name
        obytes = sum(tensor_bytes(t) for t in ins)
        rbytes = sum(tensor_bytes(t) for t in outs)
        relems = sum(t.numel() for t in outs)
        op = _Op(base, "generic", float(relems), 0.0, obytes, rbytes,
                 operands)
        if (ns, name) in _COLLECTIVE_OPS:
            kind, i_in, i_out = _COLLECTIVE_OPS[ns, name]
            src = args[i_in] if i_in < len(args) else None
            dst = out if i_out is None else (
                args[i_out] if i_out < len(args) else None)
            op.rule, op.kind, op.flops = "collective", kind, 0.0
            op.carries = any(t in self._watched for t in _tensors(src))
            op.obytes = sum(tensor_bytes(t) for t in _tensors(src))
            op.rbytes = sum(tensor_bytes(t) for t in _tensors(dst))
            op.cbytes = op.obytes or op.rbytes
            outs = _tensors(dst) + outs
            self._watch(_tensors(src), outs)
        elif ns == "aten" and base in _DOTS:
            a = args[_DOTS[base]]
            op.rule, op.kind = "dot", "dot"
            op.flops = 2.0 * relems * a.shape[-1]
        elif func._overloadpacket in flop_registry:
            op.rule = "custom" if ns != "aten" else "dot"
            op.kind = name if ns != "aten" else "dot"
            op.shape = tuple(ins[0].shape) if ins else ()
            op.flops = float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        elif base in _REDUCTIONS:
            n_in = float(ins[0].numel()) if ins else 0.0
            op.rule, op.kind, op.flops = "reduce", "reduce", n_in
            if base in _EXP_REDUCTIONS:
                op.transcendentals = n_in
                op.flops = 5.0 * n_in
        elif base in _UPDATES:
            upd = tensor_bytes(ins[1]) if len(ins) > 1 else rbytes
            op.rule, op.kind, op.flops = "update", "dus", 0.0
            op.obytes, op.rbytes = upd, upd
        elif base in _GATHERS:
            op.rule, op.kind, op.flops = "gather", "gather", 0.0
            op.obytes = rbytes
        elif base in _ELEMENTWISE:
            op.rule = "elementwise"
            if base in _TRANSCENDENTAL:
                op.transcendentals = float(relems)
                op.flops = 4.0 * relems
        elif ns != "aten":
            # a custom op without a flop formula: its bytes only
            op.rule, op.kind, op.flops = "custom", name, 0.0
            op.shape = tuple(ins[0].shape) if ins else ()
        self.ops.append(op)
        for t in outs + _written(func, args, kwargs):
            self._producer[t] = idx
        if base in _COPIES or name in _COPIES:
            self._watch(ins, outs + _written(func, args, kwargs))

    def cost(self) -> Cost:
        """The rules applied to the ops recorded so far."""
        consumers = collections.Counter(p for op in self.ops
                                        for p in op.operands)
        c = Cost(n_ops=len(self.ops))
        for i, op in enumerate(self.ops):
            c.flops += op.flops
            c.transcendentals += op.transcendentals
            traffic = op.obytes + op.rbytes
            c.bytes_raw += traffic
            if op.rule in ("dot", "custom"):
                c.dot_flops += op.flops
            if op.rule == "custom":
                c.kernel_calls[op.kind] += 1
                c.kernel_shapes.setdefault(op.kind, set()).add(op.shape)
            if op.rule == "collective":
                c.collectives[op.kind]["count"] += 1
                c.collectives[op.kind]["bytes"] += op.cbytes
                if op.carries:
                    c.param_collectives["count"] += 1
                    c.param_collectives["bytes"] += op.cbytes
            if op.rule == "elementwise" and consumers[i] <= 1:
                continue            # streams through on a fused pipeline
            c.bytes_streamed += traffic
            c._bk("ew:" + op.kind if op.rule in ("elementwise", "generic")
                  else op.kind, traffic)
        return c


def analyze_cost(fn, *args, **kwargs) -> tuple[Cost, object]:
    """(the ``Cost`` of ``fn(*args, **kwargs)``, its result)."""
    with CostMode() as mode:
        result = fn(*args, **kwargs)
    return mode.cost(), result


def analyze(fn, *args, **kwargs) -> dict:
    """The reference's cost dict (``Cost.as_dict``) of one call of ``fn``:
    run it under ``CostMode`` (inside ``FakeTensorMode`` to count without
    computing)."""
    return analyze_cost(fn, *args, **kwargs)[0].as_dict()
