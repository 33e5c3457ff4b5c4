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
compiled-once interpreter: ``lower`` turns a spec, once per spec, operand
widths and cluster width C, into an int32 instruction table (tile groups
unrolled into per-tile instructions) and a float table that stay on the
device, with every intermediate given a liveness-packed slot of a per-CTA
workspace.  ``plan_region`` picks one of two designs by the launch's
shape (``launch_cluster``): when few tiles leave most SMs idle, each 8-row
tile runs on a cluster of C CTAs, each owning a column block of every value
(``block_cols``); when the tiles fill the card on their own (the stacked
launch), each CTA owns every column of ``rows`` rows and a cluster of
``row_cluster`` CTAs shares each weight chunk of its ring (``rows_design``).
Every mm sums in an order fixed by its shape (``split_of``), so neither the
design nor its widths change the bits.

``region_bwd_call`` (port of ``_region_bwd_call``) is the region's vjp for
the fit path, on ``csrc/region_bwd.cu``: ``lower_bwd`` adds a backward
table beside the forward one; ``region_bwd_plain`` is autograd through the
plain region; ``region_grad_fn`` wraps forward and backward in a
``torch.autograd.Function``.
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
                                        refuse_dtensor, stream_handle)
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
_IO = ABI["region_bwd_io_ints"]
# the weight ring (csrc/region_steps.cuh): stages of this many floats each
_RING_FLOATS = ABI["region_wring"] * ABI["region_wstage_floats"]
CLUSTER_WIDTHS = (16, 8, 4, 2, 1)   # CTAs per row tile a launch may take
# the row-cluster design (csrc/region.cu): rows per CTA it is built for, its
# row cluster (one CTA where a lane has one tile), the stages of its ring
# and the smallest and largest stage the planner takes (16 and 32 rows of a
# 256-column block)
TILE_ROWS = (8, 16, 32)
TWO_PER_SM_ROWS = (8, 16)   # tiles built to run two CTAs per SM
ROW_CLUSTER = ABI["row_cluster"]
RING_STAGES = ABI["rows_stages"]
STAGE_FLOATS = 4096
MAX_STAGE_FLOATS = 8192
# columns of one mm column block of the row-cluster design
_ROWS_BLOCK = ABI["rows_consumers"] // ABI["row_groups"] * ABI["col_tile"]
_CHUNK = ABI["chunk_ints"]
# dynamic shared memory of a CTA that shares its SM with another
# (csrc/region.cu::rows_two_per_sm: the runtime reserves 1 KB per CTA)
_TWO_PER_SM_BYTES = ABI["sm_smem_bytes"] // 2 - 1024 - ABI["smem_static"]
_RING = 20   # an mm instruction's flag: its weights go through the ring


def block_cols(width: int, cluster: int) -> int:
    """Columns of a ``width``-wide value each CTA of a ``cluster``-wide
    cluster owns (CTA q owns ``[q cw, (q + 1) cw)``)."""
    return -(-width // cluster)


def split_of(cols: int) -> int:
    """The partial sums of an mm output element with ``cols`` output
    columns (``csrc/region_steps.cuh::split_of``): its K sum runs as
    ``ks`` fma chains over k = q, q + ks, ..., added in order q = 0..ks-1.
    A function of the shape alone, never of the cluster or the rows."""
    pw = 1
    while pw < cols and pw < ABI["region_threads"]:
        pw <<= 1
    return min(32, ABI["region_threads"] // pw)


def _round4(n: int) -> int:
    return max(4, -(-n // 4) * 4)


def rows_ldx(K: int) -> int:
    """x's row stride in the row-cluster design's x buffer for an mm of
    depth K (``csrc/region.cu::rows_ldx``): K + 4 rounded so that the rows a
    warp reads at once start in different banks; K itself when K is not a
    multiple of 4."""
    return K if K % 4 else -(-K // 8) * 8 + 4


def ring_step(N: int, ldw: int, n0: int) -> bool:
    """Whether the row-cluster design streams an mm's weights through its
    ring: one fma chain per output and rows of whole 16-byte granules
    (``launch_program`` checks that the tensors are 16-byte aligned)."""
    return split_of(N) == 1 and (N | ldw | n0) % 4 == 0


@dataclass(frozen=True, eq=False)
class RegionProgram:
    """A spec lowered for ``csrc/region.cu``: instructions (int32,
    ``_INSTR`` ints each, then the chains' opcodes), float constants, the
    per-CTA workspace size, the gathered-x buffer and the width of each
    output.  ``cluster`` > 1: column clusters of that many CTAs per 8-row
    tile, each value's column block in a slot.  ``cluster`` == 1: row
    clusters of ``row_cluster`` CTAs of ``rows`` rows each, every value
    whole (slot rows padded to ``rows_ldx(width)``, so an mm reads x in
    place; the x buffer holds only the x that cannot be), a weight ring of
    ``RING_STAGES`` stages of ``stage_floats`` floats whose chunks the table
    after the opcodes lists (``chunks``), and ``red_floats`` floats of
    partial sums for the narrow mm steps."""
    prog: np.ndarray
    consts: np.ndarray
    n_instr: int
    ws_floats: int
    out_cols: tuple[int, ...]
    cluster: int = 1
    xs_floats: int = 4
    rows: int = 8
    row_cluster: int = 1
    stage_floats: int = STAGE_FLOATS
    red_floats: int = 4
    chunk_off: int = 0
    n_chunks: int = 0

    @property
    def staging_bytes(self) -> int:
        """Shared memory besides the workspace: partial sums, x, the ring."""
        if self.cluster > 1:
            return 4 * (_RED_FLOATS + self.xs_floats + _RING_FLOATS)
        return 4 * (self.red_floats + self.xs_floats
                    + RING_STAGES * self.stage_floats)

    @property
    def in_smem(self) -> bool:
        return self.staging_bytes + 4 * self.ws_floats <= _SMEM_BYTES

    @functools.cached_property
    def table_ints(self) -> int:
        """Ints of the program a launch copies into shared memory: all of
        it on a cluster launch with room to spare (every step decodes its
        instruction there instead of waiting on L2), else none."""
        return _staged_ints(self)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA of a launch."""
        return _smem_bytes(self)

    def flops(self, rows: int) -> int:
        """Operations one launch does on ``rows`` rows: 2 K N per row for an
        mm, one per element for each chain op."""
        return _flops(self.table, rows)

    @property
    def table(self) -> np.ndarray:
        """The instruction table, one row of ``_INSTR`` ints each."""
        return self.prog[:self.n_instr * _INSTR].reshape(self.n_instr, _INSTR)

    @property
    def chunks(self) -> np.ndarray:
        """The row-cluster ring's chunks in the order rank 0 issues them:
        pointer-table index, element offset from the lane's tensor, rows,
        columns, W's row stride."""
        return self.prog[self.chunk_off:self.chunk_off
                         + self.n_chunks * _CHUNK].reshape(-1, _CHUNK)

    @property
    def design(self) -> tuple[int, ...]:
        """The row-cluster launch's layout as ``rt_region`` takes it
        (``csrc/region.cu::RowsLayout``)."""
        return (self.rows, self.row_cluster, self.red_floats, self.xs_floats,
                self.stage_floats, self.chunk_off, self.n_chunks)

    def ctas(self, R: int) -> int:
        """CTAs per lane of a launch over ``R`` rows."""
        if self.cluster > 1:
            return cdiv(R, _ROWS) * self.cluster
        return cdiv(cdiv(R, self.rows), self.row_cluster) * self.row_cluster

    def l2_weight_bytes(self, R: int, lanes: int = 1) -> int:
        """Weight bytes one launch over ``lanes`` x ``R`` rows reads from L2
        (16-byte aligned weights): every mm's W slice once per 8-row tile
        (column clusters: each CTA its columns), in the row-cluster design
        a ring step's once per cluster and a narrow one's once per 8 rows."""
        tiles = cdiv(R, _ROWS)
        clusters = cdiv(R, self.rows * self.row_cluster)
        total = 0
        for ins in self.table:
            if ins[0] == 1:
                total += 4 * int(ins[1]) * int(ins[2]) * (
                    clusters if ins[_RING] else tiles)
        return lanes * total

    @property
    def per_sm(self) -> int:
        """CTAs of a row-cluster launch one SM holds (its instantiation's
        register cap follows)."""
        return 2 if (self.rows in TWO_PER_SM_ROWS
                     and self.smem_bytes <= _TWO_PER_SM_BYTES) else 1

    def describe(self) -> str:
        """The launch design, as the chip run prints it."""
        if self.cluster > 1:
            return (f"column clusters of C={self.cluster} CTAs per 8-row "
                    f"tile, {self.smem_bytes} B/CTA")
        return (f"row clusters: {self.rows} rows/CTA, Cr={self.row_cluster}, "
                f"register tile {self.rows // ABI['row_groups']} rows x "
                f"{ABI['col_tile']} columns, {RING_STAGES} ring stages of "
                f"{4 * self.stage_floats} B, {self.smem_bytes} B/CTA, "
                f"{self.per_sm} CTA(s)/SM"
                + ("" if self.in_smem else ", workspace in global memory"))


@dataclass(frozen=True)
class _Abstract:
    """A spec unrolled into abstract instructions over values (tile groups
    per tile, concats per operand): an operand is ``(value, column offset)``.
    ``glob`` maps the kernel operands among the values (stream inputs and
    bcast rows) to ``(pointer index, row stride)``."""
    instrs: tuple
    width: dict
    glob: dict
    res_ptr: dict
    res_shape: dict


def _abstract(spec: RegionKernelSpec, stream_cols: tuple, row_cols: tuple,
              res_shapes: tuple) -> _Abstract:
    ns, nb = len(stream_cols), len(row_cols)
    res_ptr = {nid: ns + nb + i for i, nid in enumerate(spec.residents)}
    res_shape = dict(zip(spec.residents, res_shapes))
    width: dict = {}
    glob: dict = {}                        # value -> (pointer, row stride)
    for i, (nid, c) in enumerate(zip(spec.stream_inputs, stream_cols)):
        width[nid], glob[nid] = c, (i, c)
    for j, (nid, c) in enumerate(zip(spec.bcast_rows, row_cols)):
        width[nid], glob[nid] = c, (ns + j, 0)

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
    return _Abstract(instrs=tuple(instrs), width=width, glob=glob,
                     res_ptr=res_ptr, res_shape=res_shape)


def _viewer(width: dict, locate):
    """``view(operand, cols) -> 5 ints`` (space, index, row stride, column
    offset, column stride) for ``locate(value) -> (space, index, row
    stride)``; a width-1 value read ``cols`` wide broadcasts its column."""
    def view(operand, cols):
        key, coff = operand
        cs = 0 if (width[key] == 1 and cols > 1) else 1
        if cs and coff + cols > width[key]:
            raise ValueError(f"region: operand {key} of width {width[key]} "
                             f"read at columns {coff}:{coff + cols}")
        return [*locate(key), coff, cs]
    return view


def _encode(ab: _Abstract, view, base: int):
    """The instruction table (``_INSTR`` ints per instruction), the chains'
    opcodes (at ``base`` ints into the program) and the float constants."""
    table = np.zeros((len(ab.instrs), _INSTR), np.int32)
    op_ints: list[int] = []
    consts: list[float] = []
    for idx, ins in enumerate(ab.instrs):
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
            fields = ([1, N, K, ab.res_ptr[w], ab.res_shape[w][1], k0, n0,
                       ab.res_ptr[bias] if bias is not None else -1, flags,
                       len(consts)] + view(out, N) + xv)
            consts.append(w0)
        table[idx, :len(fields)] = fields
    return table, op_ints, consts


def _reads(ins):
    if ins[0] == CHAIN:
        return [ins[3][0]] + [k for k, _ in ins[5]]
    return [ins[3][0]] + ([ins[1][0]] if ins[4][6] & _FLAG_ACC else [])


def _flops(table: np.ndarray, rows: int) -> int:
    """2 K N per row for an mm, one per element for each chain op."""
    total = 0
    for ins in table:
        total += rows * int(ins[1]) * (int(ins[2]) if ins[0] == 0
                                       else 2 * int(ins[2]))
    return total


def _mm_widths(ab: _Abstract):
    """The widest K and N of the program's mm instructions."""
    mms = [ins for ins in ab.instrs if ins[0] == MM]
    return (max((ins[4][3] for ins in mms), default=1),
            max((ins[2] for ins in mms), default=1))


@functools.lru_cache(maxsize=512)
def lower(spec: RegionKernelSpec, stream_cols: tuple, row_cols: tuple,
          res_shapes: tuple, cluster: int = 1, rows: int = _ROWS,
          row_cluster: int = 1,
          stage_floats: int = STAGE_FLOATS) -> RegionProgram:
    """Lower ``spec`` for operands of the given widths (stream inputs, rows)
    and shapes (residents), on column clusters of ``cluster`` CTAs per
    8-row tile or (``cluster`` == 1) on row clusters of ``row_cluster`` CTAs
    of ``rows`` rows with a ring of ``RING_STAGES`` x ``stage_floats``: tile
    groups unroll into per-tile instructions, concat steps into column
    copies, and every intermediate gets a workspace slot of its column
    block (``block_cols``) that is reused once the value is dead."""
    if cluster > 1 and rows != _ROWS:
        raise ValueError(f"region: column clusters take {_ROWS}-row tiles")
    if rows not in TILE_ROWS:
        raise ValueError(f"region: {rows} rows per CTA (one of {TILE_ROWS})")
    if not 1 <= row_cluster <= ROW_CLUSTER:
        raise ValueError(f"region: {row_cluster} CTAs per row cluster "
                         f"(1..{ROW_CLUSTER})")
    ab = _abstract(spec, stream_cols, row_cols, res_shapes)
    instrs, width, glob = ab.instrs, ab.width, ab.glob
    nbase = len(stream_cols) + len(row_cols) + len(res_shapes)
    out_ptr = {nid: nbase + o for o, nid in enumerate(spec.outputs)}

    # liveness-packed workspace slots for every value that is neither a
    # kernel operand nor an output
    def in_ws(key):
        return key not in glob and key not in out_ptr

    last_use = {}
    for idx, ins in enumerate(instrs):
        for k in [ins[1][0]] + _reads(ins):
            last_use[k] = idx
    def slot_ld(w):
        """A value's row stride in its slot: its column block on column
        clusters, all of it (rows_ldx: x read in place) on row clusters."""
        return block_cols(w, cluster) if cluster > 1 else rows_ldx(w)

    slots: dict = {}
    live: list[tuple[int, int, object]] = []   # (offset, size, value)
    ws_floats = 0
    for idx, ins in enumerate(instrs):
        out = ins[1][0]
        if in_ws(out) and out not in slots:
            size = rows * slot_ld(width[out])
            off = 0
            for o, s, _ in sorted(live, key=lambda t: t[0]):
                if o - off >= size:
                    break
                off = max(off, o + s)
            live.append((off, size, out))
            slots[out] = off
            ws_floats = max(ws_floats, off + size)
        live = [t for t in live if last_use[t[2]] > idx]

    def locate(key):
        if key in glob:
            return (0, *glob[key])
        if key in out_ptr:
            return (0, out_ptr[key], width[key])
        return (1, slots[key], slot_ld(width[key]))

    table, op_ints, consts = _encode(ab, _viewer(width, locate),
                                     len(instrs) * _INSTR)
    chunks = _ring_chunks(table, stage_floats) if cluster == 1 else []
    prog = np.concatenate([table.ravel(), np.asarray(op_ints, np.int32),
                           np.asarray(chunks, np.int32).ravel()])
    max_k = _mm_widths(ab)[0]
    if cluster == 1:   # x buffer for the mm steps that cannot read x in place
        max_k = max([int(ins[2]) for ins in table
                     if ins[0] == 1 and not _in_place(ins[15:20], ins[2])],
                    default=1)
    # partial sums of the narrow mm steps (split_of(N) > 1), 8 rows at a time
    red = max([split_of(ins[2]) * _ROWS * min(ins[2], ABI["region_threads"])
               for ins in instrs
               if ins[0] == MM and split_of(ins[2]) > 1], default=0)
    return RegionProgram(prog=prog,
                         consts=np.asarray(consts or [0.0], np.float32),
                         n_instr=len(instrs), ws_floats=ws_floats,
                         out_cols=tuple(width[o] for o in spec.outputs),
                         cluster=cluster,
                         xs_floats=(_round4(_ROWS * max_k) if cluster > 1
                                    else _round4(rows * rows_ldx(max_k))),
                         rows=rows, row_cluster=row_cluster,
                         stage_floats=stage_floats, red_floats=_round4(red),
                         chunk_off=table.size + len(op_ints),
                         n_chunks=len(chunks))


def _in_place(v, K) -> bool:
    """Whether a row-cluster mm reads its x [rows, K] where it lies (a
    workspace slot, 16-byte aligned rows), as ``csrc/region.cu::
    rows_mm_step`` decides; else it copies x into the x buffer."""
    return v[0] == 1 and v[4] == 1 and (int(v[2]) | int(v[3]) | int(K)) % 4 == 0


def _ring_chunks(table: np.ndarray, stage_floats: int) -> list:
    """Flag the mm instructions whose weights the row-cluster design streams
    through its ring (``table[:, _RING]``) and list their chunks in program
    order: per column block of at most ``_ROWS_BLOCK`` columns, rows [k, k +
    kr) of W[k0:k0+K, n0:n0+N] with kr = ``stage_floats`` / the first
    block's width, rounded down to a multiple of 4 (``MRing::chunk_rows``)."""
    chunks = []
    for ins in table:
        N, K, w, ldw, k0, n0 = (int(a) for a in ins[1:7])
        if ins[0] != 1 or not ring_step(N, ldw, n0):
            continue
        ins[_RING] = 1
        kr = (stage_floats // min(N, _ROWS_BLOCK)) & ~3
        for c0 in range(0, N, _ROWS_BLOCK):
            cols = min(_ROWS_BLOCK, N - c0)
            for k in range(0, K, kr):
                chunks.append((w, (k0 + k) * ldw + n0 + c0, min(kr, K - k),
                               cols, ldw))
    return chunks


@dataclass(frozen=True, eq=False)
class RegionBwdProgram:
    """A spec lowered for ``csrc/region_bwd.cu`` on clusters of ``cluster``
    CTAs: the forward table (every value in its own workspace slot), the
    backward table beside it, the chains' opcodes, then ``n_io`` io entries
    at ``io_off``; float constants; the per-CTA workspace (values and sin
    arguments, then the cotangent slots from ``cot_off``, each a column
    block); the gathered x and dpre buffers; and the layout of the flat
    parameter cotangent: ``part_offsets`` per bcast row then per resident,
    of ``part_floats`` floats in all."""
    prog: np.ndarray
    consts: np.ndarray
    n_instr: int
    io_off: int
    n_io: int
    ws_floats: int
    cot_off: int
    out_cols: tuple[int, ...]
    part_offsets: tuple[int, ...]
    part_floats: int
    cluster: int = 1
    xs_floats: int = 4
    ds_floats: int = 4

    @property
    def staging_bytes(self) -> int:
        """Shared memory besides the workspace: partial sums, x, dpre and
        the ring (none on a one-CTA cluster)."""
        return 4 * (_RED_FLOATS + self.xs_floats + self.ds_floats
                    + (_RING_FLOATS if self.cluster > 1 else 0))

    @property
    def in_smem(self) -> bool:
        """Whether the workspace fits in shared memory beside the
        staging buffers."""
        return self.staging_bytes + 4 * self.ws_floats <= _SMEM_BYTES

    @functools.cached_property
    def table_ints(self) -> int:
        return _staged_ints(self)

    @property
    def smem_bytes(self) -> int:
        return _smem_bytes(self)

    def flops(self, rows: int) -> int:
        """Operations one launch does on ``rows`` rows: the forward's
        (``RegionProgram.flops``), then 4 K N per row for an mm's dx and dW
        and two per element for each chain op's pullback."""
        table = self.prog[:self.n_instr * _INSTR].reshape(self.n_instr,
                                                          _INSTR)
        return 3 * _flops(table, rows)


def _table_bytes(prog) -> int:
    return 4 * (_round4(prog.prog.size) + prog.consts.size)


def _staged_ints(prog) -> int:
    """``prog.prog.size`` when a launch of ``prog`` copies its tables (and
    constants) into shared memory, else 0: only cluster launches, whose
    steps wait on each other, and only beside a workspace in shared
    memory with room left."""
    room = _SMEM_BYTES - prog.staging_bytes - 4 * prog.ws_floats
    if prog.cluster > 1 and prog.in_smem and _table_bytes(prog) <= room:
        return int(prog.prog.size)
    return 0


def _smem_bytes(prog) -> int:
    """Dynamic shared memory of one CTA of a launch of ``prog``."""
    return (prog.staging_bytes
            + (4 * prog.ws_floats if prog.in_smem else 0)
            + (_table_bytes(prog) if prog.table_ints else 0))


@functools.lru_cache(maxsize=512)
def lower_bwd(spec: RegionKernelSpec, stream_cols: tuple, row_cols: tuple,
              res_shapes: tuple, cluster: int = 1) -> RegionBwdProgram:
    """Lower ``spec``'s backward for operands of the given widths and
    shapes.  The forward table is ``lower``'s with every value (outputs
    too) in its own workspace slot, since the reverse walk reads them all;
    each mm with a sin epilogue gets a slot for its argument.  The backward
    table gives each instruction the cotangent views of its output and
    operands (one slot per value, kernel operands included) and, for an mm,
    where its weight's and bias's cotangents start in the flat parameter
    cotangent.  Every slot holds its value's column block on clusters of
    ``cluster`` CTAs."""
    ab = _abstract(spec, stream_cols, row_cols, res_shapes)
    max_k, max_n = _mm_widths(ab)
    if max_n + 1 > ABI["region_wstage_floats"]:
        raise ValueError(f"region_bwd: mm width {max_n} exceeds the weight "
                         f"ring's stage")
    instrs, width, glob = ab.instrs, ab.width, ab.glob
    n = len(instrs)
    ns, nb, nr = len(stream_cols), len(row_cols), len(res_shapes)
    n_out = len(spec.outputs)

    ws_floats = 0

    def alloc(cols):
        nonlocal ws_floats
        size = _ROWS * block_cols(cols, cluster)
        ws_floats += size
        return ws_floats - size

    slots: dict = {}
    for ins in instrs:
        out = ins[1][0]
        if out not in glob and out not in slots:
            slots[out] = alloc(width[out])
    pre = {idx: alloc(ins[2]) for idx, ins in enumerate(instrs)
           if ins[0] == MM
           and ins[4][6] & (_FLAG_EPI | _FLAG_SIN) == _FLAG_EPI | _FLAG_SIN}
    cot_off = ws_floats
    cot = {key: alloc(width[key]) for key in (*glob, *slots)}

    offsets, part = [], 0
    for c in row_cols:
        offsets.append(part)
        part += c
    for shape in res_shapes:
        offsets.append(part)
        part += math.prod(shape)
    res_off = {nid: offsets[nb + i] for i, nid in enumerate(spec.residents)}

    def locate(key):
        if key in glob:
            return (0, *glob[key])
        return (1, slots[key], block_cols(width[key], cluster))

    table, op_ints, consts = _encode(ab, _viewer(width, locate), 2 * n * _INSTR)
    cview = _viewer(width, lambda key: (1, cot[key],
                                        block_cols(width[key], cluster)))
    btable = np.zeros((n, _INSTR), np.int32)
    for idx, ins in enumerate(instrs):
        if ins[0] == CHAIN:
            _, out, cols, x, _, extras = ins
            fields = cview(out, cols) + cview(x, cols)
            for e in extras:
                fields += cview(e, cols)
        else:
            _, out, N, x, (w, _, _, K, bias, _, _) = ins
            xv = cview(x, K)
            xv[4] = 1
            fields = cview(out, N) + xv + [
                pre.get(idx, -1), res_off[w],
                res_off[bias] if bias is not None else -1]
        btable[idx, :len(fields)] = fields

    io: list[int] = []
    for o, nid in enumerate(spec.outputs):
        io += [0, ns + nb + nr + o, width[nid], cot[nid]]
    for j, nid in enumerate(spec.stream_inputs):
        io += [1, ns + nb + nr + n_out + j, width[nid], cot[nid]]
    for j, nid in enumerate(spec.bcast_rows):
        io += [2, offsets[j], width[nid], cot[nid]]
    io_off = 2 * n * _INSTR + len(op_ints)
    prog = np.concatenate([table.ravel(), btable.ravel(),
                           np.asarray(op_ints, np.int32),
                           np.asarray(io, np.int32)])
    return RegionBwdProgram(
        prog=prog, consts=np.asarray(consts or [0.0], np.float32),
        n_instr=n, io_off=io_off, n_io=len(io) // _IO, ws_floats=ws_floats,
        cot_off=cot_off, out_cols=tuple(width[o] for o in spec.outputs),
        part_offsets=tuple(offsets), part_floats=part, cluster=cluster,
        xs_floats=_round4(_ROWS * max_k), ds_floats=_round4(_ROWS * max_n))


def launch_cluster(n_tiles: int, fits, sms: int) -> int:
    """The cluster width C of a launch over ``n_tiles`` 8-row tiles, chosen
    by shape: the widest C of ``CLUSTER_WIDTHS`` whose ``n_tiles * C`` CTAs
    the card's ``sms`` SMs hold in one wave and whose workspace ``fits(C)``
    in shared memory (one tile: C = 16); else, while the tiles alone fit
    one wave, the widest C that does, its workspace in global memory; else
    (many tiles fill the card on their own) the narrowest C that fits,
    or the widest.  C = 1 means the row-cluster design (``rows_design``)."""
    for C in CLUSTER_WIDTHS:
        if n_tiles * C <= sms and fits(C):
            return C
    for C in CLUSTER_WIDTHS:
        if n_tiles * C <= sms:
            return C
    for C in reversed(CLUSTER_WIDTHS):
        if fits(C):
            return C
    return CLUSTER_WIDTHS[0]


def rows_design(spec: RegionKernelSpec, stream_cols: tuple, row_cols: tuple,
                res_shapes: tuple, R: int) -> RegionProgram:
    """The row-cluster program for ``R`` rows per lane: two CTAs per SM
    where the workspace of 16 (else 8) rows leaves each of them room for the
    ring's stages of at least ``STAGE_FLOATS``; else one CTA per SM with the
    most rows (``TILE_ROWS``) that do.  The stages are as large as fit,
    up to ``MAX_STAGE_FLOATS`` (larger chunks pay the ring's per-chunk wait
    and release fewer times); clusters of ``ROW_CLUSTER`` CTAs (fewer when a
    lane has fewer tiles); 8 rows with the workspace in global memory when
    nothing fits."""
    def at(rows, stage_floats):
        return lower(spec, stream_cols, row_cols, res_shapes, 1, rows,
                     max(1, min(ROW_CLUSTER, cdiv(R, rows))), stage_floats)

    def fitted(rows, budget):
        prog = at(rows, STAGE_FLOATS)
        ring = 4 * RING_STAGES   # bytes of the ring per float of a stage
        room = budget - 4 * prog.ws_floats - prog.staging_bytes \
            + ring * STAGE_FLOATS
        stage = min(MAX_STAGE_FLOATS, room // ring // 1024 * 1024)
        return at(rows, stage) if stage >= STAGE_FLOATS else None

    for rows, budget in [*((r, _TWO_PER_SM_BYTES)
                           for r in sorted(TWO_PER_SM_ROWS, reverse=True)),
                         *((r, _SMEM_BYTES)
                           for r in sorted(TILE_ROWS, reverse=True))]:
        prog = fitted(rows, budget)
        if prog is not None:
            return prog
    return at(_ROWS, STAGE_FLOATS)


@functools.lru_cache(maxsize=1024)
def plan_region(spec: RegionKernelSpec, stream_cols: tuple, row_cols: tuple,
                res_shapes: tuple, R: int, lanes: int,
                sms: int) -> RegionProgram:
    """The program of a launch over ``lanes`` x ``R`` rows on a card of
    ``sms`` SMs: column clusters of the width ``launch_cluster`` picks, or
    the row-cluster design when the tiles fill the card on their own."""
    def at(C):
        if C == 1:
            return rows_design(spec, stream_cols, row_cols, res_shapes, R)
        return lower(spec, stream_cols, row_cols, res_shapes, C)
    return at(launch_cluster(lanes * cdiv(R, _ROWS),
                             lambda C: at(C).in_smem, sms))


@functools.lru_cache(maxsize=1024)
def plan_region_bwd(spec: RegionKernelSpec, stream_cols: tuple,
                    row_cols: tuple, res_shapes: tuple, n_tiles: int,
                    sms: int) -> RegionBwdProgram:
    """``lower_bwd`` at the cluster width ``launch_cluster`` picks."""
    def at(C):
        return lower_bwd(spec, stream_cols, row_cols, res_shapes, C)
    return at(launch_cluster(n_tiles, lambda C: at(C).in_smem, sms))


def _staged_consts(prog) -> int:
    return int(prog.consts.size) if prog.table_ints else 0


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=512)
def _device_program(prog, device: torch.device):
    """A ``RegionProgram``'s or ``RegionBwdProgram``'s tables on ``device``,
    uploaded once per program (a program hashes by identity, and ``lower``
    / ``lower_bwd`` return one per spec)."""
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


def _operand_names(name, R, stream, rows, residents) -> dict:
    """The operands of a single-lane launch by name, once their shapes are
    checked: stream inputs [R, C], rows [1, C], residents 1-D or 2-D."""
    named = {}
    for k, a in enumerate(stream):
        if a.dim() != 2 or a.shape[0] != R:
            raise ValueError(f"{name}: stream input {k} must be [{R}, C], "
                             f"got {tuple(a.shape)}")
        named[f"stream{k}"] = a
    for k, a in enumerate(rows):
        if a.dim() != 2 or a.shape[0] != 1:
            raise ValueError(f"{name}: row {k} must be [1, C], got "
                             f"{tuple(a.shape)}")
        named[f"row{k}"] = a
    for k, a in enumerate(residents):
        if a.dim() not in (1, 2):
            raise ValueError(f"{name}: resident {k} must be 1-D or 2-D")
        named[f"resident{k}"] = a
    return named


def _lowered(name, spec: RegionKernelSpec, stream_cols, row_cols,
             res_shapes, out_info, R, lanes, dev) -> RegionProgram:
    """The spec's program for one lane's operand widths, planned for a
    launch over ``lanes`` x ``R`` rows; ``out_info`` must name its float32
    outputs."""
    prog = plan_region(spec, stream_cols, row_cols, res_shapes, R, lanes,
                       sm_count(dev.index))
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


def launch_program(name, prog: RegionProgram, tensors, strides, lanes: int,
                   R: int, dev) -> None:
    """Launch ``prog`` over ``lanes`` x ``R`` rows with the pointer table
    ``tensors`` (stream inputs, rows, residents, outputs), lane k of tensor
    i at ``k * strides[i]`` elements (``strides`` None for one lane), and
    count it under ``name``."""
    ptrs = _pointers(name, tensors)
    if R == 0:
        return
    for i in {int(i) for i in prog.chunks[:, 0]}:
        # bulk copies move 16-byte granules between 16-byte aligned addresses
        if ptrs[i] % 16 or (strides and strides[i] % 4):
            raise ValueError(f"{name}: weight operand {i} is not 16-byte "
                             f"aligned in every lane")
    prog_d, consts_d = _device_program(prog, dev)
    gws = None
    if not prog.in_smem:
        gws = torch.empty(lanes * prog.ctas(R) * prog.ws_floats, device=dev,
                          dtype=torch.float32)
    lib = load_library()
    rc = lib.rt_region(
        prog_d.data_ptr(), consts_d.data_ptr(), prog.n_instr, len(ptrs),
        (ctypes.c_longlong * len(ptrs))(*ptrs),
        (ctypes.c_longlong * len(strides))(*strides) if strides else None,
        lanes, R, prog.ws_floats, prog.xs_floats, prog.table_ints,
        _staged_consts(prog), prog.cluster,
        (ctypes.c_int * len(prog.design))(*prog.design),
        gws.data_ptr() if gws is not None else None, stream_handle(dev))
    check_launch(rc, name)


def region_call(spec: RegionKernelSpec, stream, rows, residents, out_info):
    """Execute one region over ``[R, C]`` streamed inputs.

    ``stream``    — tensors aligned with ``spec.stream_inputs`` (all [R, Ci]).
    ``rows``      — ``[1, Ci]`` tensors aligned with ``spec.bcast_rows``.
    ``residents`` — tensors aligned with ``spec.residents`` (whole tensors).
    ``out_info``  — ``(cols, dtype)`` per ``spec.outputs`` entry.

    CPU tensors take the plain version; CUDA tensors the kernel.  Returns
    one tensor per output."""
    refuse_dtensor("region", stream, rows, residents)
    _check_arity("region", spec, stream, rows, residents)
    dev = stream[0].device
    if dev.type == "cpu":
        return region_call_plain(spec, stream, rows, residents, out_info)
    if dev.type != "cuda":
        raise ValueError(f"region: unsupported device {dev}")
    R = stream[0].shape[0]
    check_cuda_f32("region", dev,
                   **_operand_names("region", R, stream, rows, residents))
    prog = _lowered("region", spec, tuple(a.shape[1] for a in stream),
                    tuple(a.shape[1] for a in rows),
                    tuple(tuple(a.shape) for a in residents), out_info,
                    R, 1, dev)
    outs = tuple(torch.empty((R, c), device=dev, dtype=torch.float32)
                 for c in prog.out_cols)
    launch_program("region", prog, (*stream, *rows, *residents, *outs),
                   None, 1, R, dev)
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
    CPU tensors take the plain version; CUDA tensors the kernel.  Once the
    tiles fill the card (the fleets' K = 8 x 8,192 rows), the launch takes
    the row-cluster design (``rows_design``): each CTA runs every column of
    8-32 rows, and a cluster of CTAs on adjacent row tiles of one lane
    shares each weight chunk, copied once from L2 into all their shared
    memories (``csrc/region.cu``)."""
    refuse_dtensor("region_stacked", stream, rows, residents)
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
                    tuple(tuple(a.shape[1:]) for a in residents), out_info,
                    R, K, dev)
    outs = tuple(torch.empty((K, R, c), device=dev, dtype=torch.float32)
                 for c in prog.out_cols)
    tensors = (*stream, *rows, *residents, *outs)
    launch_program("region_stacked", prog, tensors,
                   lane_strides(a.shape for a in tensors), K, R, dev)
    return outs


# ---------------------------------------------------------------------------
# the backward: the fit path's differentiable region call
# ---------------------------------------------------------------------------

def region_bwd_plain(spec: RegionKernelSpec, stream, rows, residents, cots):
    """The region's vjp by ``torch.autograd.grad`` through
    ``region_call_plain``: the reference kernel body's replay under
    ``jax.vjp``.  Returns ``(d_stream, d_rows, d_residents)``, each a tuple
    of float32 tensors shaped like its operands (zeros where an operand
    does not reach an output)."""
    ns, nb = len(stream), len(rows)
    with torch.enable_grad():
        ops = [a.detach().float().requires_grad_(True)
               for a in (*stream, *rows, *residents)]
        outs = region_call_plain(spec, ops[:ns], ops[ns:ns + nb],
                                 ops[ns + nb:],
                                 [(c.shape[1], torch.float32) for c in cots])
        grads = torch.autograd.grad(outs, ops,
                                    grad_outputs=[c.float() for c in cots],
                                    allow_unused=True)
    flat = tuple(torch.zeros_like(o) if g is None else g
                 for g, o in zip(grads, ops))
    return flat[:ns], flat[ns:ns + nb], flat[ns + nb:]


def region_bwd_call(spec: RegionKernelSpec, stream, rows, residents, cots):
    """The vjp of ``region_call`` at ``(stream, rows, residents)`` for the
    output cotangents ``cots`` ([R, C_out] per ``spec.outputs`` entry).

    Returns ``(d_stream, d_rows, d_residents)``: per-row ``[R, C]`` stream
    cotangents, and ``[1, C]`` row and resident-shaped cotangents summed
    over all rows.  CPU tensors take the plain version; CUDA tensors the
    kernel (one ``region_bwd`` launch, and one ``region_bwd_reduce``
    launch when ``R`` spans more than one row tile)."""
    refuse_dtensor("region_bwd", stream, rows, residents, cots)
    _check_arity("region_bwd", spec, stream, rows, residents)
    if len(cots) != len(spec.outputs):
        raise ValueError(f"region_bwd: {len(cots)} cotangents for "
                         f"{spec.outputs}")
    dev = stream[0].device
    if dev.type == "cpu":
        return region_bwd_plain(spec, stream, rows, residents, cots)
    if dev.type != "cuda":
        raise ValueError(f"region_bwd: unsupported device {dev}")
    R = stream[0].shape[0]
    named = _operand_names("region_bwd", R, stream, rows, residents)
    named.update((f"cot{k}", a) for k, a in enumerate(cots))
    check_cuda_f32("region_bwd", dev, **named)
    n_tiles = cdiv(R, _ROWS)
    prog = plan_region_bwd(spec, tuple(a.shape[1] for a in stream),
                           tuple(a.shape[1] for a in rows),
                           tuple(tuple(a.shape) for a in residents),
                           max(n_tiles, 1), sm_count(dev.index))
    want = tuple((R, c) for c in prog.out_cols)
    if tuple(tuple(c.shape) for c in cots) != want:
        raise ValueError(f"region_bwd: cotangents "
                         f"{[tuple(c.shape) for c in cots]}, want {want}")
    d_stream = tuple(torch.empty_like(a) for a in stream)
    flat = torch.empty(prog.part_floats, device=dev, dtype=torch.float32)
    if R:
        part = flat if n_tiles == 1 else torch.empty(
            n_tiles * prog.part_floats, device=dev, dtype=torch.float32)
        gws = None
        if not prog.in_smem:
            gws = torch.empty(n_tiles * prog.cluster * prog.ws_floats,
                              device=dev, dtype=torch.float32)
        ptrs = _pointers("region_bwd",
                         (*stream, *rows, *residents, *cots, *d_stream))
        prog_d, consts_d = _device_program(prog, dev)
        lib = load_library()
        rc = lib.rt_region_bwd(
            prog_d.data_ptr(), consts_d.data_ptr(), prog.n_instr, prog.io_off,
            prog.n_io, len(ptrs), (ctypes.c_longlong * len(ptrs))(*ptrs), R,
            prog.ws_floats, prog.cot_off, prog.xs_floats, prog.ds_floats,
            prog.table_ints, _staged_consts(prog), prog.cluster,
            gws.data_ptr() if gws is not None else None,
            prog.part_floats, part.data_ptr(), stream_handle(dev))
        check_launch(rc, "region_bwd")
        if n_tiles > 1:
            rc = lib.rt_region_bwd_reduce(part.data_ptr(), n_tiles,
                                          prog.part_floats, flat.data_ptr(),
                                          stream_handle(dev))
            check_launch(rc, "region_bwd_reduce")
    else:
        flat.zero_()
    shapes = [(1, a.shape[1]) for a in rows] + [tuple(a.shape)
                                                for a in residents]
    grads = tuple(flat[off:off + math.prod(shape)].view(shape)
                  for off, shape in zip(prog.part_offsets, shapes))
    return d_stream, grads[:len(rows)], grads[len(rows):]


class _RegionGrad(torch.autograd.Function):
    """``region_call`` forward, ``region_bwd_call`` backward, over the flat
    operand tuple ``(*stream, *rows, *residents)``."""

    @staticmethod
    def forward(ctx, spec, out_info, n_stream, n_rows, *ops):
        ctx.spec, ctx.ns, ctx.nb = spec, n_stream, n_rows
        ctx.save_for_backward(*ops)
        return region_call(spec, list(ops[:n_stream]),
                           list(ops[n_stream:n_stream + n_rows]),
                           list(ops[n_stream + n_rows:]), out_info)

    @staticmethod
    def backward(ctx, *cots):
        ops = ctx.saved_tensors
        ns, nb = ctx.ns, ctx.nb
        d_stream, d_rows, d_res = region_bwd_call(
            ctx.spec, list(ops[:ns]), list(ops[ns:ns + nb]),
            list(ops[ns + nb:]), [c.float().contiguous() for c in cots])
        flat = (*d_stream, *d_rows, *d_res)
        return (None, None, None, None,
                *(d.to(o.dtype) for d, o in zip(flat, ops)))


@functools.lru_cache(maxsize=512)
def region_grad_fn(spec: RegionKernelSpec, out_info: tuple):
    """Differentiable region call for the streamed fitting path, cached per
    ``(spec, out_info)``: a callable over the flat operand tuple
    ``(*stream, *rows, *residents)`` whose forward IS ``region_call``
    (bit-identical to serving) and whose backward is ``region_bwd_call``."""
    ns, nb = len(spec.stream_inputs), len(spec.bcast_rows)
    return functools.partial(_RegionGrad.apply, spec, out_info, ns, nb)
