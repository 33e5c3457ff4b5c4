"""region — a whole FusedRegion as ONE CUDA launch (``csrc/region.cu``).

Port of ``repro.kernels.region.region_call``.  A region is a run of
StreamChain / MatMul / FusedMmAct segments (scheduled by
``core/regions.py``) described by a static ``RegionKernelSpec``: a program of
steps evaluated in order against a node-id -> value environment.

  * ``("chain", out, x, chain_steps, extra_ids)`` — ``eval_chain`` of
    ``env[x]`` with the binary operands ``env[extra_ids[k]]``;
  * ``("mm", out, x, w, bias, w0, apply_sin)`` — ``env[x] @ w [+ bias]
    [-> sin(w0 *)]``;
  * ``("concat", out, xs)`` — a last-axis concat of region values;

plus ``bcast_rows`` (row-constant operands passed as one ``[1, C]`` row)
and ``tile_groups`` (runs of wide steps evaluated ``bn`` columns at a time,
the closing "reducer" mm accumulating partial products across tiles).

``region_call_stacked`` (port of ``region_call_stacked``) runs one spec over
K weight lanes in one launch: every operand is a ``[K, ...]`` stack.

The plain version (``region_call_plain``: ``_eval_steps`` / ``_eval_group``
/ ``_eval_mm``) follows the reference line by line.  The CUDA kernel is one
compiled-once interpreter: ``lower`` turns a spec, once per spec and operand
widths, into an int32 instruction table (tile groups unrolled into
per-tile instructions) and a float table that stay on the device, with every
intermediate given a liveness-packed slot of a per-CTA workspace.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.common import (ABI, cdiv, check_cuda_f32,
                                        check_launch, load_library,
                                        stream_handle)
from repro_torch.kernels.fused_chain import encode_chain, eval_chain

CHAIN = "chain"
MM = "mm"
CONCAT = "concat"


@dataclass(frozen=True)
class TileGroup:
    """One column-tiled run inside a region's step program.

    ``members`` — node ids of the group's step outputs, in step order; every
    member step has output width ``width`` and its output is consumed only
    by later members or the reducer.
    ``reducer`` — node id of the terminating MM step's output: the MM whose
    streamed operand is the last member; its ``width``-long K reduction is
    carried across column tiles as a running accumulator.
    ``width`` / ``bn`` — the shared member width and the column tile; the
    group evaluates in ``ceil(width / bn)`` tiles (last tile ragged).
    """
    members: tuple[int, ...]
    reducer: int
    width: int
    bn: int

    @property
    def n_tiles(self) -> int:
        return -(-self.width // self.bn)


@dataclass(frozen=True)
class RegionKernelSpec:
    """Static description of one region megakernel.

    ``steps``         — evaluation program, in segment plan order.
    ``stream_inputs`` — node ids read block-by-block, in argument order.
    ``bcast_rows``    — node ids of row-constant operands passed as one
                        ``[1, C]`` row each.
    ``residents``     — node ids of whole-tensor operands (weights, biases).
    ``outputs``       — node ids written back, one output tensor each.
    ``tile_groups``   — column-tiled runs of the step program.
    """
    steps: tuple
    stream_inputs: tuple[int, ...]
    residents: tuple[int, ...]
    outputs: tuple[int, ...]
    bcast_rows: tuple[int, ...] = ()
    tile_groups: tuple[TileGroup, ...] = ()

    @property
    def n_stream(self) -> int:
        return len(self.stream_inputs)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _eval_mm(x, w, bias, w0, apply_sin):
    h = x @ w
    if bias is not None:
        h = h + bias
    if apply_sin:
        h = torch.sin(w0 * h)
    return h


def _eval_group(env, res, group: TileGroup, member_steps, reducer_step):
    """Evaluate one column-tiled run: members ``bn`` columns at a time, the
    reducer accumulating partial K products across tiles."""
    W, bn = group.width, group.bn
    members = set(group.members)
    _, r_out, r_x, r_w, r_bias, r_w0, r_sin = reducer_step
    wfull = res[r_w]
    acc = None
    for lo in range(0, W, bn):
        hi = min(W, lo + bn)
        tenv = {}

        def tile_val(nid):
            if nid in tenv:
                return tenv[nid]
            v = env[nid]
            # operands of a tiled step are either full-width (slice the
            # tile) or per-row scalars / [1,1] rows (broadcast whole)
            if v.shape[-1] == W:
                return v[..., lo:hi]
            return v

        for step in member_steps:
            if step[0] == CHAIN:
                _, out, x, chain_steps, extra_ids = step
                extras = [tile_val(e) for e in extra_ids]
                tenv[out] = eval_chain(tile_val(x), chain_steps, extras)
            else:
                _, out, x, w, bias, w0, apply_sin = step
                if x in members:
                    raise ValueError("member MM lhs must be external")
                b = res[bias][lo:hi] if bias is not None else None
                tenv[out] = _eval_mm(env[x], res[w][:, lo:hi], b,
                                     w0, apply_sin)
        part = tenv[r_x] @ wfull[lo:hi, :]
        acc = part if acc is None else acc + part
    if r_bias is not None:
        acc = acc + res[r_bias]
    if r_sin:
        acc = torch.sin(r_w0 * acc)
    env[r_out] = acc


def _group_bounds(spec: RegionKernelSpec, i: int):
    """(group, n members) when step ``i`` opens a tile group, else None."""
    for g in spec.tile_groups:
        if g.members[0] == spec.steps[i][1]:
            reducer = spec.steps[i + len(g.members)]
            if reducer[1] != g.reducer or reducer[0] != MM:
                raise ValueError(f"region: malformed tile group {g}")
            return g, len(g.members)
    return None


def _eval_steps(env, res, spec: RegionKernelSpec):
    """Walk the step program, detouring through ``_eval_group`` for each
    column-tiled run (group steps are contiguous, reducer last)."""
    i = 0
    steps = spec.steps
    while i < len(steps):
        step = steps[i]
        found = _group_bounds(spec, i)
        if found is not None:
            group, n = found
            _eval_group(env, res, group, steps[i:i + n], steps[i + n])
            i += n + 1
            continue
        if step[0] == CHAIN:
            _, out, x, chain_steps, extra_ids = step
            env[out] = eval_chain(env[x], chain_steps,
                                  [env[e] for e in extra_ids])
        elif step[0] == MM:
            _, out, x, w, bias, w0, apply_sin = step
            env[out] = _eval_mm(env[x], res[w],
                                res[bias] if bias is not None else None,
                                w0, apply_sin)
        elif step[0] == CONCAT:
            _, out, xs = step
            env[out] = torch.cat([env[x] for x in xs], dim=-1)
        else:
            raise ValueError(f"region: unknown step kind {step[0]!r}")
        i += 1


def region_call_plain(spec: RegionKernelSpec, stream, rows, residents,
                      out_info):
    env = {nid: a.float() for nid, a in zip(spec.stream_inputs, stream)}
    env.update((nid, a.float()) for nid, a in zip(spec.bcast_rows, rows))
    res = {nid: a.float() for nid, a in zip(spec.residents, residents)}
    _eval_steps(env, res, spec)
    return tuple(env[nid].to(_dtype(dt)).contiguous()
                 for nid, (_, dt) in zip(spec.outputs, out_info))


def _dtype(dt) -> torch.dtype:
    return dt if isinstance(dt, torch.dtype) else getattr(torch, str(dt))


# ---------------------------------------------------------------------------
# lowering a spec to the CUDA interpreter's program
# ---------------------------------------------------------------------------

_ROWS = ABI["region_rows"]
_INSTR = ABI["region_instr_ints"]
_FLAG_SIN, _FLAG_ACC, _FLAG_EPI = 1, 2, 4
# dynamic shared memory one CTA may use (bytes): the card's 227 KB less the
# kernel's static arrays (csrc/abi.cuh RT_SMEM_BYTES - RT_SMEM_STATIC)
_SMEM_BYTES = ABI["smem_dynamic_bytes"]
_RED_FLOATS = ABI["region_red_floats"]


@dataclass(frozen=True, eq=False)
class RegionProgram:
    """A spec lowered for ``csrc/region.cu``: instructions (int32, ``_INSTR``
    ints each, then the chains' opcodes), float constants, the per-CTA
    workspace size and the width of each output."""
    prog: np.ndarray
    consts: np.ndarray
    n_instr: int
    ws_floats: int
    out_cols: tuple[int, ...]

    @property
    def in_smem(self) -> bool:
        return 4 * (_RED_FLOATS + self.ws_floats) <= _SMEM_BYTES

    def flops(self, rows: int) -> int:
        """Operations one launch does on ``rows`` rows: 2 K N per row for an
        mm, one per element for each chain op."""
        table = self.prog[:self.n_instr * _INSTR].reshape(self.n_instr, _INSTR)
        total = 0
        for ins in table:
            total += rows * int(ins[1]) * (int(ins[2]) if ins[0] == 0
                                           else 2 * int(ins[2]))
        return total


@functools.lru_cache(maxsize=512)
def lower(spec: RegionKernelSpec, stream_cols: tuple, row_cols: tuple,
          res_shapes: tuple) -> RegionProgram:
    """Lower ``spec`` for operands of the given widths (stream inputs, rows)
    and shapes (residents): tile groups unroll into per-tile instructions,
    concat steps into column copies, and every intermediate gets a
    workspace slot that is reused once the value is dead."""
    ns, nb, nr = len(stream_cols), len(row_cols), len(res_shapes)
    res_ptr = {nid: ns + nb + i for i, nid in enumerate(spec.residents)}
    res_shape = dict(zip(spec.residents, res_shapes))
    out_ptr = {nid: ns + nb + nr + o for o, nid in enumerate(spec.outputs)}
    width: dict = {}
    glob: dict = {}                        # value -> (pointer, row stride)
    for i, (nid, c) in enumerate(zip(spec.stream_inputs, stream_cols)):
        width[nid], glob[nid] = c, (i, c)
    for j, (nid, c) in enumerate(zip(spec.bcast_rows, row_cols)):
        width[nid], glob[nid] = c, (ns + j, 0)

    # abstract instructions over values; an operand is (value, column offset)
    instrs: list[tuple] = []

    def chain(out, coff, cols, x, ops, extras):
        instrs.append((CHAIN, (out, coff), cols, x, ops, tuple(extras)))

    def mm(out, x, w, k0, n0, K, N, bias, w0, flags):
        if w not in res_ptr or (bias is not None and bias not in res_ptr):
            raise ValueError(f"region: mm operands {w}, {bias} must be "
                             f"residents")
        instrs.append((MM, (out, 0), N, x, (w, k0, n0, K, bias, float(w0),
                                            flags)))

    def chain_cols(operands):
        widths = {width[k] for k, _ in operands}
        cols = max(widths)
        if not widths <= {1, cols}:
            raise ValueError(f"region: chain operand widths {sorted(widths)}")
        return cols

    def emit_group(group, member_steps, red):
        W, bn = group.width, group.bn
        _, r_out, r_x, r_w, r_bias, r_w0, r_sin = red
        K_full, N_red = res_shape[r_w]
        if K_full != W:
            raise ValueError(f"region: reducer weight {res_shape[r_w]} does "
                             f"not contract width {W}")
        width[r_out] = N_red
        los = list(range(0, W, bn))
        for t, lo in enumerate(los):
            hi = min(W, lo + bn)
            local = {}

            def tile_op(nid, lo=lo, local=local):
                if nid in local:
                    return (local[nid], 0)
                return (nid, lo) if width[nid] == W else (nid, 0)

            for step in member_steps:
                key = (step[1], lo)
                width[key] = hi - lo
                if step[0] == CHAIN:
                    _, out, x, chain_steps, extra_ids = step
                    chain(key, 0, hi - lo, tile_op(x), chain_steps,
                          [tile_op(e) for e in extra_ids])
                else:
                    _, out, x, w, bias, w0, sin = step
                    mm(key, (x, 0), w, 0, lo, res_shape[w][0], hi - lo,
                       bias, w0, _FLAG_EPI | (_FLAG_SIN if sin else 0))
                local[step[1]] = key
            last = t == len(los) - 1
            flags = ((_FLAG_ACC if t else 0) | (_FLAG_EPI if last else 0)
                     | (_FLAG_SIN if r_sin else 0))
            mm(r_out, tile_op(r_x), r_w, lo, 0, hi - lo, N_red,
               r_bias if last else None, r_w0, flags)

    steps = spec.steps
    i = 0
    while i < len(steps):
        step = steps[i]
        found = _group_bounds(spec, i)
        if found is not None:
            group, n = found
            emit_group(group, steps[i:i + n], steps[i + n])
            i += n + 1
            continue
        if step[0] == CHAIN:
            _, out, x, chain_steps, extra_ids = step
            ops = [(x, 0)] + [(e, 0) for e in extra_ids]
            width[out] = chain_cols(ops)
            chain(out, 0, width[out], (x, 0), chain_steps, ops[1:])
        elif step[0] == MM:
            _, out, x, w, bias, w0, sin = step
            K, N = res_shape[w]
            width[out] = N
            mm(out, (x, 0), w, 0, 0, K, N, bias, w0,
               _FLAG_EPI | (_FLAG_SIN if sin else 0))
        elif step[0] == CONCAT:
            _, out, xs = step
            width[out] = sum(width[x] for x in xs)
            off = 0
            for x in xs:
                chain(out, off, width[x], (x, 0), (), ())
                off += width[x]
        else:
            raise ValueError(f"region: unknown step kind {step[0]!r}")
        i += 1
    missing = [o for o in spec.outputs if o not in width]
    if missing:
        raise ValueError(f"region: outputs {missing} are never computed")

    # liveness-packed workspace slots for every value that is neither a
    # kernel operand nor an output
    def in_ws(key):
        return key not in glob and key not in out_ptr

    def reads(ins):
        if ins[0] == CHAIN:
            return [ins[3][0]] + [k for k, _ in ins[5]]
        return [ins[3][0]] + ([ins[1][0]] if ins[4][6] & _FLAG_ACC else [])

    last_use = {}
    for idx, ins in enumerate(instrs):
        for k in [ins[1][0]] + reads(ins):
            last_use[k] = idx
    slots: dict = {}
    live: list[tuple[int, int, object]] = []   # (offset, size, value)
    ws_floats = 0
    for idx, ins in enumerate(instrs):
        out = ins[1][0]
        if in_ws(out) and out not in slots:
            size = _ROWS * width[out]
            off = 0
            for o, s, _ in sorted(live, key=lambda t: t[0]):
                if o - off >= size:
                    break
                off = max(off, o + s)
            live.append((off, size, out))
            slots[out] = off
            ws_floats = max(ws_floats, off + size)
        live = [t for t in live if last_use[t[2]] > idx]

    def view(operand, cols):
        key, coff = operand
        cs = 0 if (width[key] == 1 and cols > 1) else 1
        if cs and coff + cols > width[key]:
            raise ValueError(f"region: operand {key} of width {width[key]} "
                             f"read at columns {coff}:{coff + cols}")
        if key in glob:
            ptr, ld = glob[key]
            return [0, ptr, ld, coff, cs]
        if key in out_ptr:
            return [0, out_ptr[key], width[key], coff, cs]
        return [1, slots[key], width[key], coff, cs]

    table = np.zeros((len(instrs), _INSTR), np.int32)
    op_ints: list[int] = []
    consts: list[float] = []
    base = len(instrs) * _INSTR
    for idx, ins in enumerate(instrs):
        row = table[idx]
        if ins[0] == CHAIN:
            _, out, cols, x, chain_steps, extras = ins
            if len(extras) > ABI["max_extra"]:
                raise ValueError(f"region: chain with {len(extras)} extras")
            ops, vals = encode_chain(chain_steps)
            fields = [0, cols, len(ops), base + len(op_ints), len(consts),
                      len(extras)] + view(out, cols) + view(x, cols)
            for e in extras:
                fields += view(e, cols)
            op_ints += ops
            consts += vals
        else:
            _, out, N, x, (w, k0, n0, K, bias, w0, flags) = ins
            xv = view(x, K)
            xv[4] = 1
            fields = ([1, N, K, res_ptr[w], res_shape[w][1], k0, n0,
                       res_ptr[bias] if bias is not None else -1, flags,
                       len(consts)] + view(out, N) + xv)
            consts.append(w0)
        row[:len(fields)] = fields
    prog = np.concatenate([table.ravel(), np.asarray(op_ints, np.int32)])
    return RegionProgram(prog=prog,
                         consts=np.asarray(consts or [0.0], np.float32),
                         n_instr=len(instrs), ws_floats=ws_floats,
                         out_cols=tuple(width[o] for o in spec.outputs))


@functools.lru_cache(maxsize=512)
def _device_program(prog: RegionProgram, device: torch.device):
    """The program's tables on ``device``, uploaded once per program (a
    program hashes by identity, and ``lower`` returns one per spec)."""
    return (torch.from_numpy(prog.prog).to(device),
            torch.from_numpy(prog.consts).to(device))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _check_arity(name, spec: RegionKernelSpec, stream, rows, residents):
    if len(stream) != len(spec.stream_inputs) or not stream:
        raise ValueError(f"{name}: {len(stream)} stream inputs for "
                         f"{spec.stream_inputs}")
    if len(rows) != len(spec.bcast_rows):
        raise ValueError(f"{name}: {len(rows)} rows for {spec.bcast_rows}")
    if len(residents) != len(spec.residents):
        raise ValueError(f"{name}: {len(residents)} residents for "
                         f"{spec.residents}")


def _lowered(name, spec: RegionKernelSpec, stream_cols, row_cols,
             res_shapes, out_info) -> RegionProgram:
    """The spec's program for one lane's operand widths; ``out_info`` must
    name its float32 outputs."""
    prog = lower(spec, stream_cols, row_cols, res_shapes)
    if tuple(c for c, _ in out_info) != prog.out_cols:
        raise ValueError(f"{name}: out_info {out_info} vs computed widths "
                         f"{prog.out_cols}")
    if any(_dtype(dt) != torch.float32 for _, dt in out_info):
        raise TypeError(f"{name}: outputs must be float32, got {out_info}")
    return prog


def _pointers(name, tensors) -> list[int]:
    if len(tensors) > ABI["max_ptrs"]:
        raise ValueError(f"{name}: {len(tensors)} tensors exceed the "
                         f"kernel's {ABI['max_ptrs']}")
    return [a.data_ptr() for a in tensors]


def region_call(spec: RegionKernelSpec, stream, rows, residents, out_info):
    """Execute one region over ``[R, C]`` streamed inputs.

    ``stream``    — tensors aligned with ``spec.stream_inputs`` (all [R, Ci]).
    ``rows``      — ``[1, Ci]`` tensors aligned with ``spec.bcast_rows``.
    ``residents`` — tensors aligned with ``spec.residents`` (whole tensors).
    ``out_info``  — ``(cols, dtype)`` per ``spec.outputs`` entry.

    CPU tensors take the plain version; CUDA tensors the kernel.  Returns
    one tensor per output."""
    _check_arity("region", spec, stream, rows, residents)
    dev = stream[0].device
    if dev.type == "cpu":
        return region_call_plain(spec, stream, rows, residents, out_info)
    if dev.type != "cuda":
        raise ValueError(f"region: unsupported device {dev}")
    R = stream[0].shape[0]
    named = {}
    for k, a in enumerate(stream):
        if a.dim() != 2 or a.shape[0] != R:
            raise ValueError(f"region: stream input {k} must be [{R}, C], "
                             f"got {tuple(a.shape)}")
        named[f"stream{k}"] = a
    for k, a in enumerate(rows):
        if a.dim() != 2 or a.shape[0] != 1:
            raise ValueError(f"region: row {k} must be [1, C], got "
                             f"{tuple(a.shape)}")
        named[f"row{k}"] = a
    for k, a in enumerate(residents):
        if a.dim() not in (1, 2):
            raise ValueError(f"region: resident {k} must be 1-D or 2-D")
        named[f"resident{k}"] = a
    check_cuda_f32("region", dev, **named)
    prog = _lowered("region", spec, tuple(a.shape[1] for a in stream),
                    tuple(a.shape[1] for a in rows),
                    tuple(tuple(a.shape) for a in residents), out_info)
    outs = tuple(torch.empty((R, c), device=dev, dtype=torch.float32)
                 for c in prog.out_cols)
    ptrs = _pointers("region", (*stream, *rows, *residents, *outs))
    if R == 0:
        return outs
    prog_d, consts_d = _device_program(prog, dev)
    gws = None
    if not prog.in_smem:
        gws = torch.empty(cdiv(R, _ROWS) * prog.ws_floats, device=dev,
                          dtype=torch.float32)
    lib = load_library()
    rc = lib.rt_region(prog_d.data_ptr(), consts_d.data_ptr(), prog.n_instr,
                       len(ptrs), (ctypes.c_longlong * len(ptrs))(*ptrs),
                       None, 1, R, prog.ws_floats,
                       gws.data_ptr() if gws is not None else None,
                       stream_handle(dev))
    check_launch(rc, "region")
    return outs


# ---------------------------------------------------------------------------
# K weight lanes in one launch
# ---------------------------------------------------------------------------

def lane_strides(shapes) -> list[int]:
    """The per-lane element stride of each contiguous ``[K, ...]`` operand
    of a stacked launch, in pointer-table order: lane k of a stack starts
    ``k * prod(shape[1:])`` elements after lane 0."""
    return [math.prod(tuple(s)[1:]) for s in shapes]


def region_call_stacked_plain(spec: RegionKernelSpec, stream, rows,
                              residents, out_info):
    """Lane by lane through ``region_call_plain``; ``[K, R, cols]`` out."""
    lanes = [region_call_plain(spec, [a[k] for a in stream],
                               [a[k] for a in rows],
                               [a[k] for a in residents], out_info)
             for k in range(stream[0].shape[0])]
    return tuple(torch.stack(col) for col in zip(*lanes))


def region_call_stacked(spec: RegionKernelSpec, stream, rows, residents,
                        out_info):
    """Execute one region over K stacked weight lanes in ONE launch.

    ``stream``    — ``[K, R, Ci]`` tensors aligned with ``spec.stream_inputs``.
    ``rows``      — ``[K, 1, Ci]`` tensors aligned with ``spec.bcast_rows``.
    ``residents`` — ``[K, ...]`` stacked whole tensors per ``spec.residents``.
    ``out_info``  — ``(cols, dtype)`` per output; returns ``[K, R, cols]``.

    Lane k of the result is ``region_call`` on lane k's operands (on the
    card bit for bit: every CTA runs the single-lane kernel's arithmetic).
    CPU tensors take the plain version; CUDA tensors the kernel."""
    _check_arity("region_stacked", spec, stream, rows, residents)
    if stream[0].dim() != 3:
        raise ValueError(f"region_stacked: stream input 0 must be [K, R, C], "
                         f"got {tuple(stream[0].shape)}")
    K, R = stream[0].shape[:2]
    if not 0 < K <= ABI["max_lanes"]:
        raise ValueError(f"region_stacked: {K} lanes (1..{ABI['max_lanes']})")
    named = {}
    for k, a in enumerate(stream):
        if a.dim() != 3 or a.shape[:2] != (K, R):
            raise ValueError(f"region_stacked: stream input {k} must be "
                             f"[{K}, {R}, C], got {tuple(a.shape)}")
        named[f"stream{k}"] = a
    for k, a in enumerate(rows):
        if a.dim() != 3 or a.shape[:2] != (K, 1):
            raise ValueError(f"region_stacked: row {k} must be [{K}, 1, C], "
                             f"got {tuple(a.shape)}")
        named[f"row{k}"] = a
    for k, a in enumerate(residents):
        if a.dim() not in (2, 3) or a.shape[0] != K:
            raise ValueError(f"region_stacked: resident {k} must be [{K}, N] "
                             f"or [{K}, M, N], got {tuple(a.shape)}")
        named[f"resident{k}"] = a
    dev = stream[0].device
    if dev.type == "cpu":
        return region_call_stacked_plain(spec, stream, rows, residents,
                                         out_info)
    if dev.type != "cuda":
        raise ValueError(f"region_stacked: unsupported device {dev}")
    check_cuda_f32("region_stacked", dev, **named)
    prog = _lowered("region_stacked", spec, tuple(a.shape[2] for a in stream),
                    tuple(a.shape[2] for a in rows),
                    tuple(tuple(a.shape[1:]) for a in residents), out_info)
    outs = tuple(torch.empty((K, R, c), device=dev, dtype=torch.float32)
                 for c in prog.out_cols)
    tensors = (*stream, *rows, *residents, *outs)
    ptrs = _pointers("region_stacked", tensors)
    if R == 0:
        return outs
    strides = lane_strides(a.shape for a in tensors)
    prog_d, consts_d = _device_program(prog, dev)
    gws = None
    if not prog.in_smem:
        gws = torch.empty(K * cdiv(R, _ROWS) * prog.ws_floats, device=dev,
                          dtype=torch.float32)
    lib = load_library()
    rc = lib.rt_region(
        prog_d.data_ptr(), consts_d.data_ptr(), prog.n_instr, len(ptrs),
        (ctypes.c_longlong * len(ptrs))(*ptrs),
        (ctypes.c_longlong * len(strides))(*strides), K, R, prog.ws_floats,
        gws.data_ptr() if gws is not None else None, stream_handle(dev))
    check_launch(rc, "region_stacked")
    return outs
