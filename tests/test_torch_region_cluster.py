"""The cluster split of the region kernels, executed CTA by CTA in numpy.

``csrc/region.cu`` and ``csrc/region_bwd.cu`` run each 8-row tile on a
thread-block cluster of C CTAs: every value is cut into C column blocks of
``block_cols(width, C)`` columns, CTA q keeps block q in its own shared
memory, computes only the output columns it owns, and reads other CTAs'
columns through distributed shared memory; a cluster barrier ends every
step.  ``_Tile`` below runs a program lowered for C (``lower(...,
cluster=C)``, ``lower_bwd(..., cluster=C)``) that way: one workspace per
CTA, started as NaN so a read of a column nobody wrote shows; the forward
writes only its owner's columns; every write of a step is applied at the
step's barrier and no element may be written by two CTAs in one step.  mm
steps sum in the kernels' order (``split_of``: ks fma chains over k = q, q +
ks, ..., added in order), so the results must be the same bit for bit for
every C, and within 1e-4 of the plain version.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core.config import HardwareConfig as JHardwareConfig
from repro.core.pipeline import _trace_graph as j_trace_graph
from repro.core.regions import build_region_plan as j_build_region_plan
from repro.core.segment import build_segment_plan as j_build_segment_plan
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro_torch.kernels import common
from repro_torch.kernels import fused_chain as tfc
from repro_torch.kernels import region as tregion
from test_torch_region_bwd import _op_bwd, _operands, _port_spec, _ties_spec

ROWS = common.ABI["region_rows"]
NI = common.ABI["region_instr_ints"]
NIO = common.ABI["region_bwd_io_ints"]
CLUSTERS = (1, 2, 4, 8, 16)
NAMES = {i: name for name, i in tfc.OPCODES.items()}


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _fma(x, w, acc):
    """fmaf in float32 (the product exact in float64, one more rounding)."""
    return (np.float64(1) * x * w + acc).astype(np.float32)


def _owned(rank, C, v, cols):
    """csrc/region_steps.cuh::owned: the view columns [lo, hi) whose value
    columns CTA ``rank`` owns."""
    space, _, ld, coff, _ = (int(a) for a in v)
    cw = ld if space else -(-ld // C)
    return max(0, rank * cw - coff), min(cols, rank * cw + cw - coff)


class _Tile:
    """One row tile of a program on a cluster of ``prog.cluster`` CTAs."""

    def __init__(self, prog, flat, row0, rows):
        self.prog, self.flat, self.row0, self.rows = prog, flat, row0, rows
        self.C = prog.cluster
        self.ws = np.full((self.C, max(prog.ws_floats, 1)), np.nan,
                          np.float32)
        self.part = None
        self.pending = []

    # -- addressing ----------------------------------------------------------
    def _where(self, v, r, col):
        """(array, index, key, owner) of the view's elements r x col; key
        names the element across the cluster, owner is the CTA that owns
        it (None for a kernel operand read by any CTA)."""
        space, idx, ld, coff, cs = (int(a) for a in v)
        r, cc = np.broadcast_arrays(np.asarray(r), coff + np.asarray(col) * cs)
        if space == 0:
            ix = (self.row0 + r) * ld + cc
            return (self.flat[idx], ix, (2 + idx) * 2 ** 40 + ix,
                    cc // max(1, -(-ld // self.C)))
        q = cc // ld
        local = idx + r * ld + cc - q * ld
        return self.ws, (q, local), q * self.ws.shape[1] + local, q

    def load(self, v, r, col):
        arr, ix, _, _ = self._where(v, r, col)
        return arr[ix].astype(np.float32)

    def gather(self, v, cols):
        """x [8, cols] of a view, zeros past the tile's rows; every column
        must have been written."""
        x = np.zeros((ROWS, cols), np.float32)
        x[:self.rows] = self.load(v, np.arange(self.rows)[:, None],
                                  np.arange(cols)[None, :])
        assert not np.isnan(x).any(), "read of a column nobody wrote"
        return x

    def write(self, rank, v, r, col, val, add=False, own=True):
        arr, ix, key, owner = self._where(v, r, col)
        if own:
            assert (owner == rank).all(), "a CTA wrote a column it does not own"
        self.pending.append((rank, arr, ix, key, val, add))

    def write_part(self, rank, ix, val):
        self.pending.append((rank, self.part, ix, 2 ** 40 - 1 - ix, val,
                             True))

    def barrier(self):
        """Apply the step's writes in order; none may come from two CTAs."""
        seen = {}
        for rank, arr, ix, key, val, add in self.pending:
            for k in np.asarray(key).ravel().tolist():
                assert seen.setdefault(k, rank) == rank, \
                    "two CTAs wrote one element in one step"
            val = np.broadcast_to(np.asarray(val, np.float32),
                                  np.shape(arr[ix]))
            if add:
                np.add.at(arr, ix, val)
            else:
                arr[ix] = val
        self.pending = []

    # -- the forward steps ---------------------------------------------------
    def chain(self, rank, ins):
        cols, n_ops, n_extra = int(ins[1]), int(ins[2]), int(ins[5])
        lo, hi = _owned(rank, self.C, ins[6:11], cols)
        if hi <= lo:
            return
        r, c = np.arange(self.rows)[:, None], np.arange(lo, hi)[None, :]
        h = torch.from_numpy(self.load(ins[11:16], r, c))
        extras = [torch.from_numpy(self.load(ins[16 + 5 * e:21 + 5 * e], r, c))
                  for e in range(n_extra)]
        self.write(rank, ins[6:11], r, c,
                   tfc.eval_chain(h, self.chain_of(ins), extras).numpy())

    def chain_of(self, ins):
        return [(NAMES[int(self.prog.prog[ins[3] + i])],
                 float(self.prog.consts[ins[4] + i])) for i in range(ins[2])]

    def mm(self, rank, ins, pre_slot=-1):
        N, K, w, ldw, k0, n0, b, flags, w0i = (int(a) for a in ins[1:10])
        ov = ins[10:15]
        lo, hi = _owned(rank, self.C, ov, N)
        if hi <= lo:
            return
        x = self.gather(ins[15:20], K)
        wm = self.flat[w].reshape(-1, ldw)[k0:k0 + K, n0 + lo:n0 + hi]
        ks = tregion.split_of(N)
        acc = np.zeros((ROWS, hi - lo, ks), np.float32)
        for k in range(K):
            acc[:, :, k % ks] = _fma(x[:, k:k + 1], wm[k][None, :],
                                     acc[:, :, k % ks])
        h = np.zeros((ROWS, hi - lo), np.float32)
        for q in range(ks):
            h = h + acc[:, :, q]
        r, c = np.arange(self.rows)[:, None], np.arange(lo, hi)[None, :]
        h = h[:self.rows]
        if flags & 2:
            h = self.load(ov, r, c) + h
        if flags & 4:
            if b >= 0:
                h = h + self.flat[b][n0 + lo:n0 + hi]
            if flags & 1:
                if pre_slot >= 0:
                    ld, base = int(ov[2]), rank * int(ov[2]) - int(ov[3])
                    local = pre_slot + r * ld + c - base
                    self.pending.append((rank, self.ws, (
                        np.full(h.shape, rank), local),
                        rank * self.ws.shape[1] + local, h.copy(), False))
                h = np.sin(np.float32(self.prog.consts[w0i]) * h)
        self.write(rank, ov, r, c, h)

    def forward(self, table, pre=None):
        for s, ins in enumerate(table):
            for rank in range(self.C):
                if ins[0] == 0:
                    self.chain(rank, ins)
                else:
                    self.mm(rank, ins, -1 if pre is None else int(pre[s]))
            self.barrier()

    # -- the backward steps --------------------------------------------------
    def _pullback(self, ins, b, r, c):
        """g (x's cotangent) and de (the extras') at elements r x c."""
        n_extra = int(ins[5])
        hs = [self.load(ins[11:16], r, c)]
        ev = [self.load(ins[16 + 5 * e:21 + 5 * e], r, c)
              for e in range(n_extra)]
        chain, e, opnd = self.chain_of(ins), 0, []
        for op, v in chain:
            xe = ev[e] if op in tfc.BINARY else None
            opnd.append(xe)
            e += xe is not None
            hs.append(tfc.eval_chain(
                torch.from_numpy(hs[-1]), [(op, v)],
                [torch.from_numpy(xe)] if xe is not None else []).numpy())
        g = self.load(b[0:5], r, c)
        de = [None] * n_extra
        for i in range(len(chain) - 1, -1, -1):
            op, v = chain[i]
            g, d = _op_bwd(op, hs[i], hs[i + 1], v, opnd[i], g)
            g = np.broadcast_to(g, hs[0].shape).astype(np.float32)
            if d is not None:
                e -= 1
                de[e] = np.broadcast_to(d, hs[0].shape).astype(np.float32)
        return g, de

    def chain_bwd(self, rank, ins, b):
        cols, n_extra = int(ins[1]), int(ins[5])
        lo, hi = _owned(rank, self.C, b[0:5], cols)
        if hi <= lo:
            return
        r, c = np.arange(self.rows)[:, None], np.arange(lo, hi)[None, :]
        g, de = self._pullback(ins, b, r, c)
        self.write(rank, b[5:10], r, c, g, add=True, own=False)
        for k in range(n_extra):
            self.write(rank, b[10 + 5 * k:15 + 5 * k], r, c, de[k], add=True,
                       own=False)

    def chain_bwd_whole(self, ins, b):
        """A chain with a broadcast-column operand, on CTA 0: per row, lane
        l sums columns l, l + 32, ... of a broadcast operand's cotangent,
        then the warp's shfl_down tree adds the lanes."""
        cols, n_extra = int(ins[1]), int(ins[5])
        r, c = np.arange(self.rows)[:, None], np.arange(cols)[None, :]
        g, de = self._pullback(ins, b, r, c)
        for view, val, cs in [(b[5:10], g, ins[15])] + [
                (b[10 + 5 * k:15 + 5 * k], de[k], ins[20 + 5 * k])
                for k in range(n_extra)]:
            if cs:
                self.write(0, view, r, c, val, add=True, own=False)
                continue
            lanes = np.zeros((self.rows, 32), np.float32)
            for col in range(cols):
                lanes[:, col % 32] = lanes[:, col % 32] + val[:, col]
            for off in (16, 8, 4, 2, 1):
                src = np.concatenate([lanes[:, off:], lanes[:, 32 - off:]], 1)
                lanes = lanes + src
            self.write(0, view, r, np.zeros((1, 1), int), lanes[:, :1],
                       add=True, own=False)

    def mm_bwd_dpre(self, rank, ins, b):
        N, n0, flags, w0i = int(ins[1]), int(ins[6]), int(ins[8]), int(ins[9])
        lo, hi = _owned(rank, self.C, b[0:5], N)
        if hi <= lo:
            return
        r, c = np.arange(self.rows)[:, None], np.arange(lo, hi)[None, :]
        g = self.load(b[0:5], r, c)
        if flags & 4 and flags & 1:
            w0 = np.float32(self.prog.consts[w0i])
            ld, base = int(b[2]), rank * int(b[2]) - int(b[3])
            pre = self.ws[rank, int(b[10]) + r * ld + c - base]
            g = (g * np.cos(w0 * pre)) * w0
            self.write(rank, b[0:5], r, c, g)
        if flags & 4 and b[12] >= 0:
            s = np.zeros(hi - lo, np.float32)
            for row in range(self.rows):
                s = s + g[row]
            self.write_part(rank, int(b[12]) + n0 + np.arange(lo, hi), s)

    def mm_bwd_dw_dx(self, rank, ins, b):
        N, K, w, ldw, k0, n0 = (int(a) for a in ins[1:7])
        x, d = self.gather(ins[15:20], K), self.gather(b[0:5], N)
        lo, hi = _owned(rank, self.C, b[0:5], N)
        if hi > lo:
            s = np.zeros((K, hi - lo), np.float32)
            for row in range(ROWS):
                s = _fma(x[row][:, None], d[row, lo:hi][None, :], s)
            ix = (int(b[11]) + (k0 + np.arange(K))[:, None] * ldw + n0
                  + np.arange(lo, hi)[None, :])
            self.write_part(rank, ix, s)
        klo, khi = _owned(rank, self.C, b[5:10], K)
        if khi <= klo:
            return
        wm = self.flat[w].reshape(-1, ldw)[k0 + klo:k0 + khi, n0:n0 + N]
        ks = tregion.split_of(K)
        acc = np.zeros((ROWS, khi - klo, ks), np.float32)
        for n in range(N):
            acc[:, :, n % ks] = _fma(d[:, n:n + 1], wm[:, n][None, :],
                                     acc[:, :, n % ks])
        tot = np.zeros((ROWS, khi - klo), np.float32)
        for q in range(ks):
            tot = tot + acc[:, :, q]
        r = np.arange(self.rows)[:, None]
        self.write(rank, b[5:10], r, np.arange(klo, khi)[None, :],
                   tot[:self.rows], add=True)


def _emulate_cluster(prog, tensors, R):
    """Run a ``lower(..., cluster=C)`` program over R rows, tile by tile;
    outputs are written in place."""
    flat = [t.reshape(-1) for t in tensors]
    table = prog.prog[:prog.n_instr * NI].reshape(prog.n_instr, NI)
    for row0 in range(0, R, ROWS):
        _Tile(prog, flat, row0, min(ROWS, R - row0)).forward(table)


def _emulate_cluster_bwd(prog, tensors, R):
    """Run a ``lower_bwd(..., cluster=C)`` program over R rows (d_stream
    written in place); returns the flat parameter cotangent, each tile's
    partial added in tile order."""
    flat = [t.reshape(-1) for t in tensors]
    n, C = prog.n_instr, prog.cluster
    fwd = prog.prog[:n * NI].reshape(n, NI)
    bwd = prog.prog[n * NI:2 * n * NI].reshape(n, NI)
    io = prog.prog[prog.io_off:prog.io_off + NIO * prog.n_io].reshape(-1, NIO)
    total = np.zeros(prog.part_floats, np.float32)
    for row0 in range(0, R, ROWS):
        rows = min(ROWS, R - row0)
        T = _Tile(prog, flat, row0, rows)
        T.ws[:, prog.cot_off:] = 0
        T.part = np.zeros(prog.part_floats, np.float32)

        def blocks(width):
            cw = -(-width // C)
            for rank in range(C):
                lo = rank * cw
                if width - lo > 0:
                    yield rank, cw, lo, min(cw, width - lo)

        r = np.arange(rows)[:, None]
        for kind, a, W, slot in io:
            if kind == 0:
                for rank, cw, lo, w in blocks(W):
                    u = np.arange(w)[None, :]
                    T.ws[rank, slot + r * cw + u] += \
                        flat[a][(row0 + r) * W + lo + u]
        T.forward(fwd, bwd[:, 10])
        for ins, b in zip(fwd[::-1], bwd[::-1]):
            if ins[0] == 0:
                if ins[15] == 0 or any(ins[20 + 5 * e] == 0
                                       for e in range(ins[5])):
                    T.chain_bwd_whole(ins, b)
                else:
                    for rank in range(C):
                        T.chain_bwd(rank, ins, b)
            else:
                for rank in range(C):
                    T.mm_bwd_dpre(rank, ins, b)
                T.barrier()
                for rank in range(C):
                    T.mm_bwd_dw_dx(rank, ins, b)
            T.barrier()
        for kind, a, W, slot in io:
            for rank, cw, lo, w in blocks(W):
                u = np.arange(w)[None, :]
                src = T.ws[rank, slot + r * cw + u]
                if kind == 1:
                    flat[a][(row0 + r) * W + lo + u] = src
                elif kind == 2:
                    s = np.zeros(w, np.float32)
                    for row in range(rows):
                        s = s + src[row]
                    T.part[a + lo + np.arange(w)] = s
        total = total + T.part
    return total


# -- the regions --------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster_regions():
    """(label, graph, port spec) of the fused regions the reference planner
    builds for a hidden-32 SIREN at orders 1-2, plus the column-tiled
    regions a tight budget forces at hidden 80 (80 = 2 * 32 + 16, so its
    column blocks are ragged at every C)."""
    out = []
    for hidden, layers, order, conf in [
            (32, 2, 1, JHardwareConfig(use_pallas=True)),
            (32, 2, 2, JHardwareConfig(use_pallas=True)),
            (80, 1, 2, JHardwareConfig(use_pallas=True, bn=32,
                                       vmem_budget=120_000))]:
        cfg = JSirenConfig(hidden_features=hidden, hidden_layers=layers)
        f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
        g = j_trace_graph(f, order, 16, (16, 2), "float32")
        plan = j_build_segment_plan(g, config=conf)
        out += [(f"h{hidden}o{order}", g, _port_spec(r.spec))
                for r in j_build_region_plan(plan, conf).fused_regions()]
    assert any(s.tile_groups for _, _, s in out)
    return out


def _hand_specs():
    """Hand-built specs whose widths C does not divide: 3-column inputs,
    N = 2 and N = 4 outputs, a concat at column offset 6, a bcast row, a
    width-1 column broadcast into a chain, and a column-tiled group (a
    reducer accumulating over 3 ragged tiles, bias + sin)."""
    rng = np.random.default_rng(99)
    R, D, H, W, O = 13, 3, 10, 20, 4
    steps = (("mm", 1, 0, 10, 11, 30.0, True),            # [R, H]
             ("chain", 2, 1, (("cos", None), ("mul", None)), (7,)),
             ("concat", 3, (2, 0)),                        # [R, H + D]
             ("mm", 4, 3, 12, None, 1.0, False),           # [R, W]
             ("chain", 5, 4, (("sin", None),), ()),        # member 1
             ("mm", 6, 1, 13, 14, 2.0, True),              # member 2 [R, W]
             ("chain", 8, 5, (("mul", None),), (6,)),      # member 3
             ("mm", 9, 8, 15, 16, 3.0, True),              # reducer [R, O]
             ("mm", 17, 9, 18, None, 1.0, False),          # [R, 1]
             ("chain", 19, 17, (("mul", None), ("sin", None)), (2,)),
             ("mm", 20, 19, 21, None, 1.0, False))         # [R, 2]
    tiled = tregion.RegionKernelSpec(
        steps=steps, stream_inputs=(0,),
        residents=(10, 11, 12, 13, 14, 15, 16, 18, 21),
        outputs=(20, 9, 2), bcast_rows=(7,),
        tile_groups=(tregion.TileGroup(members=(5, 6, 8), reducer=9,
                                       width=W, bn=8),))
    shapes = [(D, H), (H,), (H + D, W), (H, W), (W,), (W, O), (O,), (O, 1),
              (H, 2)]
    ops = ([rng.uniform(-1, 1, (R, D)).astype(np.float32)],
           [rng.uniform(-1, 1, (1, H)).astype(np.float32)],
           [(rng.uniform(-1, 1, s) / np.sqrt(s[0])).astype(np.float32)
            for s in shapes])
    return [("hand", tiled, ops)]


def _cases(cluster_regions, n_rows):
    """(label, spec, stream, rows, residents, cotangents) of every case."""
    out = []
    for k, (label, g, spec) in enumerate(cluster_regions):
        stream, rows, res, cots = _operands(g, spec, n_rows, 50 + k)
        out.append((label, spec, stream, rows, res, cots))
    rng = np.random.default_rng(7)
    for label, spec, (stream, rows, res) in _hand_specs():
        stream = [a[:n_rows] if a.shape[0] >= n_rows else
                  np.resize(a, (n_rows, a.shape[1])) for a in stream]
        prog = tregion.lower(spec, tuple(a.shape[1] for a in stream),
                             tuple(a.shape[1] for a in rows),
                             tuple(a.shape for a in res))
        cots = [rng.standard_normal((n_rows, c)).astype(np.float32)
                for c in prog.out_cols]
        out.append((label, spec, stream, rows, res, cots))
    return out


def _widths(stream, rows, res):
    return (tuple(a.shape[1] for a in stream), tuple(a.shape[1] for a in rows),
            tuple(a.shape for a in res))


@pytest.fixture(scope="module", params=[8, 13])
def forward_runs(request, cluster_regions):
    """Per case: the plain outputs and, per C, the emulated kernel's."""
    n_rows = request.param
    runs = []
    for label, spec, stream, rows, res, _ in _cases(cluster_regions, n_rows):
        out_cols = tregion.lower(spec, *_widths(stream, rows, res)).out_cols
        want = tregion.region_call_plain(
            spec, _t(stream), _t(rows), _t(res),
            [(c, "float32") for c in out_cols])
        got = {}
        for C in CLUSTERS:
            prog = tregion.lower(spec, *_widths(stream, rows, res), C)
            assert prog.cluster == C
            outs = [np.full((n_rows, c), np.nan, np.float32)
                    for c in out_cols]
            _emulate_cluster(prog, stream + rows + res + outs, n_rows)
            got[C] = outs
        runs.append((label, want, got))
    return runs


@pytest.mark.parametrize("C", CLUSTERS)
def test_cluster_forward_matches_plain(forward_runs, C):
    """Every planned region (hidden 32 at orders 1-2, the column-tiled
    hidden-80 one) and the hand-built ragged spec, on C CTAs per tile: the
    plain version's outputs within 1e-4, on a full and a ragged tile."""
    for label, want, got in forward_runs:
        for a, b in zip(got[C], want):
            assert not np.isnan(a).any(), label
            _close(a, b.numpy(), 1e-4)


@pytest.mark.parametrize("C", CLUSTERS[1:])
def test_cluster_forward_bits_do_not_depend_on_c(forward_runs, C):
    """The summation order depends on the step's shape only: C CTAs per
    tile give the C = 1 outputs bit for bit."""
    for label, _, got in forward_runs:
        for a, b in zip(got[C], got[1]):
            np.testing.assert_array_equal(a, b, err_msg=label)


@pytest.fixture(scope="module", params=[8, 13])
def backward_runs(request, cluster_regions):
    n_rows = request.param
    runs = []
    for label, spec, stream, rows, res, cots in _cases(cluster_regions,
                                                      n_rows):
        want = tregion.region_bwd_plain(spec, _t(stream), _t(rows), _t(res),
                                        _t(cots))
        got = {}
        for C in CLUSTERS:
            prog = tregion.lower_bwd(spec, *_widths(stream, rows, res), C)
            d_stream = [np.full_like(a, np.nan) for a in stream]
            flat = _emulate_cluster_bwd(prog, stream + rows + res + cots
                                        + d_stream, n_rows)
            shapes = [(1, a.shape[1]) for a in rows] + [a.shape for a in res]
            grads = [flat[off:off + int(np.prod(s))].reshape(s)
                     for off, s in zip(prog.part_offsets, shapes)]
            got[C] = d_stream + grads
        runs.append((label, [*want[0], *want[1], *want[2]], got))
    return runs


@pytest.mark.parametrize("C", CLUSTERS)
def test_cluster_backward_matches_plain(backward_runs, C):
    """region_bwd's tables on C CTAs per tile (dpre on the own columns, dW
    on the own columns, dx on the own columns of x's cotangent, chains on
    the own columns or whole on CTA 0): every stream, row and resident
    cotangent within 1e-4 of the plain version."""
    for label, want, got in backward_runs:
        for a, b in zip(got[C], want):
            assert not np.isnan(a).any(), label
            _close(a, b.numpy(), 1e-4)


@pytest.mark.parametrize("C", CLUSTERS[1:])
def test_cluster_backward_bits_do_not_depend_on_c(backward_runs, C):
    for label, _, got in backward_runs:
        for a, b in zip(got[C], got[1]):
            np.testing.assert_array_equal(a, b, err_msg=label)


@pytest.mark.parametrize("C", [2, 16])
def test_cluster_backward_broadcast_column_and_ties(C):
    """A chain whose operand is one column broadcast over the others (its
    cotangent sums over every column, on CTA 0), and the ties of relu,
    max, min and abs, on C CTAs: the plain version's cotangents."""
    rng = np.random.default_rng(5)
    R, W = 11, 37
    steps = (("chain", 2, 0, (("mul", None), ("cos", None)), (1,)),
             ("chain", 3, 1, (("sin", None), ("max", None)), (0,)))
    spec = tregion.RegionKernelSpec(steps=steps, stream_inputs=(0, 1),
                                    residents=(), outputs=(2, 3))
    stream = [rng.uniform(-1, 1, (R, W)).astype(np.float32),
              rng.uniform(0.5, 1.5, (R, 1)).astype(np.float32)]
    cots = [rng.standard_normal((R, W)).astype(np.float32) for _ in range(2)]
    ties = _ties_spec(tregion.RegionKernelSpec)
    tie_in = [np.array([[0.0, 0.5, -0.5, 0.25, 0.0, -0.0]], np.float32),
              np.array([[0.0, 0.5, 0.0, 0.5, 1.0, -0.0]], np.float32)]
    tie_cots = [np.full((1, 6), k + 1.0, np.float32) for k in range(4)]
    for spec, stream, cots, tol in [(spec, stream, cots, 1e-5),
                                    (ties, tie_in, tie_cots, 0.0)]:
        R = stream[0].shape[0]
        prog = tregion.lower_bwd(spec, tuple(a.shape[1] for a in stream),
                                 (), (), C)
        d_stream = [np.full_like(a, np.nan) for a in stream]
        _emulate_cluster_bwd(prog, stream + cots + d_stream, R)
        want = tregion.region_bwd_plain(spec, _t(stream), [], [], _t(cots))
        for a, b in zip(d_stream, want[0]):
            _close(a, b.numpy(), tol)


def test_launch_cluster_by_shape():
    """One tile takes the widest cluster; the main path's later chunk-wide
    launch (64 tiles) two CTAs per tile, so 128 CTAs fill 132 SMs; the
    stacked shape (8,192 tiles) one; 125 tiles whose workspace fits only
    split 8 ways keep one wave (C = 1, the workspace in global memory),
    200 such tiles take 8; a workspace that never fits takes 16."""
    def fits_all(C):
        return True

    assert tregion.launch_cluster(1, fits_all, 132) == 16
    assert tregion.launch_cluster(8, fits_all, 132) == 16
    assert tregion.launch_cluster(9, fits_all, 132) == 8
    assert tregion.launch_cluster(64, fits_all, 132) == 2
    assert tregion.launch_cluster(8192, fits_all, 132) == 1
    assert tregion.launch_cluster(125, lambda C: C >= 8, 132) == 1
    assert tregion.launch_cluster(200, lambda C: C >= 8, 132) == 8
    assert tregion.launch_cluster(1, lambda C: False, 132) == 16


def test_split_of_matches_the_kernel_rule():
    assert [tregion.split_of(n) for n in (1, 2, 3, 8, 64, 80, 128, 256,
                                          300)] == [32, 32, 32, 32, 4, 2, 2,
                                                    1, 1]


def test_block_layout_per_cluster(cluster_regions):
    """A value's slot holds its column block: at C = 1 the layout is the
    single-CTA one, and every slot shrinks to ceil(width / C) columns."""
    _, g, spec = cluster_regions[1]
    stream, rows, res, _ = _operands(g, spec, 8, 0)
    widths = _widths(stream, rows, res)
    one = tregion.lower_bwd(spec, *widths)
    assert one.cluster == 1
    last = one
    for C in CLUSTERS[1:]:
        prog = tregion.lower_bwd(spec, *widths, C)
        assert prog.ws_floats < last.ws_floats
        assert prog.ws_floats >= -(-one.ws_floats // C)
        assert (prog.part_floats, prog.xs_floats, prog.ds_floats) == (
            one.part_floats, one.xs_floats, one.ds_floats)
        last = prog


def test_full_width_workspaces_fit_in_shared_memory():
    """The full-width SIREN's planned regions (orders 1-3, the port's own
    planner): split 16 ways, every forward and backward workspace fits in
    one CTA's shared memory beside the staging buffers, where one CTA per
    tile spilled the backward's (and order 3's largest) to global memory."""
    from repro_torch.configs.siren import SirenConfig
    from repro_torch.core.config import HardwareConfig
    from repro_torch.core.executor import (_run_region, _run_segment,
                                           region_operands)
    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.inr.siren import siren_fn, siren_init

    cfg = SirenConfig()
    params = siren_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    coords = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (cfg.batch, 2)).astype(np.float32))
    seen, spilled_at_one = 0, 0
    for order in (1, 2, 3):
        cg = compile_gradient(siren_fn(cfg, params), order, coords,
                              config=HardwareConfig(use_pallas=True),
                              device="cpu")
        plan, block, B = cg.plan, cg.config.block, cg.plan.batch
        env = {plan.inputs[0]: coords[:block]}
        for kind, u in cg.region_plan.units():
            if kind != "region":
                env[u.output] = _run_segment(plan, u, cg._decisions[u.id],
                                             env, cg.residents, block, B)
                continue
            st, rows, res, _ = region_operands(plan, u, env, cg.residents,
                                               block, B)
            widths = (tuple(a.shape[1] for a in st),
                      tuple(a.shape[1] for a in rows),
                      tuple(tuple(a.shape) for a in res))
            for lower in (tregion.lower, tregion.lower_bwd):
                assert lower(u.spec, *widths, 16).in_smem
            spilled_at_one += not tregion.lower_bwd(u.spec, *widths).in_smem
            seen += 1
            _run_region(plan, u, env, cg.residents, block, B)
    assert seen >= 10 and spilled_at_one >= 3
