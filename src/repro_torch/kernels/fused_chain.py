"""fused_chain — a StreamChain segment as one CUDA kernel (``csrc/fused_chain.cu``).

Port of ``repro.kernels.fused_chain``.  The chain is a static list of
``(op, operand)`` steps: unary ops, ``scale``/``offset`` by a baked constant,
and binary ops against extra operands of the chain's shape:
    [("sin", None), ("scale", 30.0), ("mul", None)]

``eval_chain`` is the plain PyTorch version; the CPU path and the region
kernel's plain version evaluate chains through it, as the CUDA kernels share
one ``eval_chain`` device function.  ``ChainSpec`` / ``build_chain_spec`` are
the reference's planner half, copied as they are.

The launch path is short because the main path launches ``fused_chain`` per
8-row block, far more often than any other kernel: a plan segment's chain is
encoded once (``ChainSpec.program``, made by ``chain_program``), and a call
checks and packs only its tensors (``launch_args``) into one block that the
C launcher reads.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from repro_torch.kernels.common import (ABI, check_cuda_f32, check_launch,
                                        load_library, stream_handle)

UNARY = {
    "sin": torch.sin, "cos": torch.cos, "exp": torch.exp, "tanh": torch.tanh,
    # |x| with jnp.abs's derivative: 1 at 0, not torch.abs's 0
    "neg": torch.neg, "abs": lambda x: x * torch.where(x >= 0, 1.0, -1.0),
    # max(x, 0), as the reference's jnp.maximum: autograd splits ties evenly
    "relu": lambda x: torch.maximum(x, x.new_zeros(())),
    "sigmoid": torch.sigmoid, "silu": lambda x: x * torch.sigmoid(x),
    "square": torch.square,
}
BINARY = {"mul", "add", "sub", "div", "max", "min"}

# chain op -> opcode of csrc/abi.cuh (ChainOp)
OPCODES = {name: i for i, name in enumerate(
    ["sin", "cos", "exp", "tanh", "neg", "abs", "relu", "sigmoid", "silu",
     "square", "scale", "offset", "mul", "add", "sub", "div", "max", "min"])}
assert len(OPCODES) == ABI["n_chain_ops"]


def eval_chain(h, chain, extras=()):
    """Apply a static chain of (op, operand) steps to ``h`` (float32).

    ``extras`` holds one float32 tensor per BINARY step, in step order;
    operands broadcast against ``h``."""
    ei = 0
    for op, operand in chain:
        if op in UNARY:
            h = UNARY[op](h)
        elif op == "scale":
            h = h * operand
        elif op == "offset":
            h = h + operand
        elif op in BINARY:
            other = extras[ei]
            ei += 1
            if op == "mul":
                h = h * other
            elif op == "add":
                h = h + other
            elif op == "sub":
                h = h - other
            elif op == "max":
                h = torch.maximum(h, other)
            elif op == "min":
                h = torch.minimum(h, other)
            else:
                h = h / other
        else:
            raise ValueError(f"fused_chain: unknown op {op}")
    return h


def encode_chain(chain) -> tuple[list[int], list[float]]:
    """Opcodes and baked constants of a chain, as the kernels read them."""
    if len(chain) > ABI["max_chain"]:
        raise ValueError(f"fused_chain: {len(chain)} steps exceed the "
                         f"kernel's {ABI['max_chain']}")
    ops, vals = [], []
    for op, operand in chain:
        if op not in OPCODES:
            raise ValueError(f"fused_chain: unknown op {op}")
        ops.append(OPCODES[op])
        vals.append(float(operand) if op in ("scale", "offset") else 0.0)
    return ops, vals


# the blocks rt_fused_chain reads (csrc/fused_chain.cu): a chain's
# ChainProgram (steps, binary steps, opcodes, constants) and a call's
# ChainCall (x, out, R, C, then each extra's pointer, row and column stride)
_PROGRAM = struct.Struct(f"<ii{ABI['max_chain']}i{ABI['max_chain']}f")
_CALLS = [struct.Struct("<QQii" + "Qqq" * n)
          for n in range(ABI["max_extra"] + 1)]


@dataclass(frozen=True)
class ChainProgram:
    """A chain encoded for the kernel: its steps, its count of binary steps
    and the ChainProgram block of ``csrc/fused_chain.cu`` (``encode_chain``'s
    opcodes and baked constants)."""
    steps: tuple
    n_bin: int
    blob: bytes


def chain_program(chain) -> ChainProgram:
    """Encode ``chain`` for the kernel; raises as ``encode_chain`` does.
    ``ChainSpec.program`` keeps one per plan segment."""
    steps = tuple(map(tuple, chain))
    ops, vals = encode_chain(steps)
    pad = ABI["max_chain"] - len(ops)
    n_bin = sum(1 for op, _ in steps if op in BINARY)
    return ChainProgram(steps, n_bin, _PROGRAM.pack(
        len(ops), n_bin, *ops, *[0] * pad, *vals, *[0.0] * pad))


def _check_arity(n_bin: int, extras) -> None:
    if n_bin != len(extras):
        raise ValueError(f"fused_chain: {n_bin} binary steps, "
                         f"{len(extras)} extras")


def launch_args(prog: ChainProgram, x: torch.Tensor, extras,
                device: int) -> list:
    """Check a launch's operands as the wrapper does for CUDA tensors on
    the current device ``device`` (its index), and return the ChainCall
    fields: x's pointer, 0 for out's, R, C, then each extra's pointer and
    its strides as broadcast to ``x`` (0 where it broadcasts)."""
    _check_arity(prog.n_bin, extras)
    if x.dim() != 2:
        raise ValueError(f"fused_chain: x must be [R, C], got {tuple(x.shape)}")
    if prog.n_bin > ABI["max_extra"]:
        raise ValueError(f"fused_chain: {prog.n_bin} extras exceed the "
                         f"kernel's {ABI['max_extra']}")
    if x.get_device() != device:
        raise ValueError(f"fused_chain: tensors on {x.device}, current "
                         f"device is cuda:{device}")
    if x.dtype != torch.float32:
        raise TypeError(f"fused_chain: x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_chain: x must be contiguous")
    shape = x.shape
    if shape[0] * shape[1] >= 1 << 31:
        raise ValueError(f"fused_chain: {tuple(shape)} exceeds the kernel's "
                         f"32-bit element index")
    args = [x.data_ptr(), 0, shape[0], shape[1]]
    for k, e in enumerate(extras):
        if e.get_device() != device or e.dtype != torch.float32:
            raise TypeError(f"fused_chain: extra {k} must be float32 on "
                            f"{x.device}")
        args.append(e.data_ptr())
        # an extra of x's shape (every extra of the SIREN plans) has its own
        # strides; expand, which costs more host time, only for the others
        args += e.stride() if e.shape == shape else e.expand(shape).stride()
    return args


def fused_chain(x: torch.Tensor, chain, extras=()):
    """Apply ``chain`` to ``x`` [R, C]; each extra broadcasts to ``x``'s
    shape.  ``chain`` is a list of ``(op, operand)`` steps, or a
    ``ChainProgram`` (the executor passes ``ChainSpec.program``), which
    spares encoding it on every call.  CPU tensors take the plain version;
    CUDA tensors the kernel."""
    prog = chain if type(chain) is ChainProgram else None
    if not x.is_cuda:
        steps = chain if prog is None else prog.steps
        _check_arity(sum(1 for op, _ in steps if op in BINARY), extras)
        if x.device.type == "cpu":
            return eval_chain(x.float(), steps, extras).to(x.dtype)
        raise ValueError(f"fused_chain: unsupported device {x.device}")
    if prog is None:
        prog = chain_program(chain)
    args = launch_args(prog, x, extras, torch.cuda.current_device())
    out = torch.empty_like(x)
    if not args[2] * args[3]:
        return out
    args[1] = out.data_ptr()
    rc = load_library().rt_fused_chain(prog.blob, _CALLS[prog.n_bin].pack(
        *args), stream_handle(x.device))
    check_launch(rc, "fused_chain")
    return out


def launch_floor(x: torch.Tensor) -> None:
    """Launch an empty kernel on the grid and block ``fused_chain`` takes
    for ``x`` [R, C] (CUDA): the floor under one of its launches.  Not
    counted."""
    check_cuda_f32("launch_floor", x.device, x=x)
    rc = load_library().rt_launch_floor(x.shape[0], x.shape[1],
                                        stream_handle(x.device))
    if rc:
        raise RuntimeError(f"launch_floor: CUDA error {rc}")


# ---------------------------------------------------------------------------
# chain-spec builder: SegmentPlan StreamChain nodes -> a fused_chain call
# (copied from the reference as it is)
# ---------------------------------------------------------------------------

# IR op -> kernel unary name
_IR_UNARY = {"Sin": "sin", "Cos": "cos", "Exp": "exp", "Tanh": "tanh",
             "Neg": "neg", "Abs": "abs", "Sigmoid": "sigmoid"}
# IR op -> kernel binary name
_IR_BINARY = {"Mul": "mul", "Add": "add", "Sub": "sub", "Div": "div",
              "Maximum": "max", "Minimum": "min"}


@dataclass(frozen=True)
class ChainSpec:
    """A StreamChain segment lowered to one ``fused_chain`` invocation.

    ``steps`` is the kernel's static ``chain`` argument; ``extras`` holds the
    producer node id feeding each binary step's second operand, in order.
    ``x`` is the primary streamed input the chain starts from."""
    x: int
    steps: tuple
    extras: tuple[int, ...]

    @cached_property
    def program(self) -> ChainProgram:
        """``steps`` encoded for the kernel, once per spec (not in the
        reference: the executor launches a segment once per block)."""
        return chain_program(self.steps)


def _scalar_const(g, nid):
    """Static float of a size-1 Const node, else None (local duplicate of
    core.segment.scalar_const_value — kernels must not import core)."""
    n = g.nodes.get(nid)
    if n is None or n.op != "Const" or n.const is None:
        return None
    if int(np.prod(n.shape)) != 1:
        return None
    return float(np.ravel(n.const)[0])


def build_chain_spec(g, node_ids, *, resident):
    """Lower an ordered run of elementwise IR nodes to a ChainSpec, or None
    when any node is not expressible by the fused_chain kernel (the caller
    then interprets the segment node-by-node).

    Expressible ops: the _IR_UNARY map, IntPow(y=2) as square, and
    Mul/Add/Sub/Div — with a size-1 Const operand baked in as scale/offset,
    otherwise as a binary step streaming the second operand.  Sub/Div require
    the chain value in the left slot (the kernel computes ``h op other``)."""
    if not node_ids:
        return None
    steps: list = []
    extras: list[int] = []
    prev = None
    x = None
    for nid in node_ids:
        n = g.nodes[nid]
        if prev is None:
            streamed = [i for i in n.inputs if i not in resident]
            primary = streamed[0] if streamed else (n.inputs[0] if n.inputs
                                                    else None)
            if primary is None:
                return None
        else:
            primary = prev
            if primary not in n.inputs:
                return None
        if n.op in _IR_UNARY:
            steps.append((_IR_UNARY[n.op], None))
        elif n.op == "IntPow":
            if dict(n.params).get("y") != 2:
                return None
            steps.append(("square", None))
        elif n.op in _IR_BINARY:
            if len(n.inputs) != 2:
                return None
            slot = 0 if n.inputs[0] == primary else 1
            other = n.inputs[1 - slot]
            v = _scalar_const(g, other)
            if v is not None and n.op == "Mul":
                steps.append(("scale", v))
            elif v is not None and n.op == "Add":
                steps.append(("offset", v))
            elif v is not None and n.op == "Sub" and slot == 0:
                steps.append(("offset", -v))
            elif v is not None and n.op == "Div" and slot == 0 and v != 0.0:
                steps.append(("scale", 1.0 / v))
            else:
                if n.op in ("Sub", "Div") and slot != 0:
                    return None             # other - h / other / h: no kernel op
                if other not in resident and g.nodes[other].shape != n.shape:
                    return None             # streamed extra must match blocks
                steps.append((_IR_BINARY[n.op], None))
                extras.append(other)
        else:
            return None
        if prev is None:
            x = primary
        prev = nid
    return ChainSpec(x=x, steps=tuple(steps), extras=tuple(extras))
