"""The row-cluster design of the region kernel, executed CTA by CTA in numpy.

When a launch's tiles fill the card on their own (the stacked K = 8 x 8,192
rows of a fleet), ``csrc/region.cu::region_rows_kernel`` runs each CTA on
every column of ``rows`` rows, and a cluster of ``row_cluster`` CTAs on
adjacent row tiles of one lane shares a ring of weight chunks: rank 0 copies
each chunk once into the same stage of every CTA.  ``_emulate_rows`` below
runs a program lowered for that design (``lower(..., 1, rows, row_cluster,
stage_floats)``, a ring of ``RING_STAGES`` stages) that way: one NaN-started workspace, x buffer,
partial-sum buffer and ring per CTA, CTAs past the lane's last row walking
every step and chunk with no rows; each mm step whose weights go through the
ring reads them only from its stage, chunk by chunk in the order the
producer issues them (``RegionProgram.chunks``, the table the kernel's
producer walks); a narrow mm step runs the one-CTA
arithmetic 8 rows at a time with its partial sums through the buffer.  The
outputs must be the 8-row one-CTA emulation's (``_emulate_cluster`` at C =
1) bit for bit, lane by lane through ``lane_strides``, and within 1e-4 of
the plain version.
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
from test_torch_region_bwd import _operands, _port_spec
from test_torch_region_cluster import (_close, _emulate_cluster, _fma,
                                       _hand_specs, _t)

ROWS = common.ABI["region_rows"]
BLOCK = tregion._ROWS_BLOCK
NAMES = {i: name for name, i in tfc.OPCODES.items()}
STAGES = tregion.RING_STAGES
# (rows per CTA, CTAs per cluster, floats per stage)
DESIGNS = [(8, 1, 1024), (16, 2, 2048), (32, 2, 4096), (8, 2, 1024)]


class _RowCta:
    """One CTA of a row cluster: ``rows`` rows (0 past the lane's end) of
    every column, its buffers started as NaN."""

    def __init__(self, prog, flat, row0, rows):
        self.prog, self.flat, self.row0, self.rows = prog, flat, row0, rows
        self.ws = np.full(max(prog.ws_floats, 1), np.nan, np.float32)
        self.xs = np.full(prog.xs_floats, np.nan, np.float32)
        self.red = np.full(prog.red_floats, np.nan, np.float32)
        self.stage = np.full(STAGES * prog.stage_floats, np.nan, np.float32)

    def _ix(self, v, r, col):
        space, idx, ld, coff, cs = (int(a) for a in v)
        r, cc = np.broadcast_arrays(np.asarray(r), coff + np.asarray(col) * cs)
        if space == 0:
            return self.flat[idx], (self.row0 + r) * ld + cc
        assert (cc < ld).all(), "a row tile owns every column"
        return self.ws, idx + r * ld + cc

    def load(self, v, r, col):
        arr, ix = self._ix(v, r, col)
        val = arr[ix].astype(np.float32)
        assert not np.isnan(val).any(), "read of an element nobody wrote"
        return val

    def store(self, v, r, col, val):
        arr, ix = self._ix(v, r, col)
        arr[ix] = val

    def chain(self, ins):
        if not self.rows:
            return
        cols, n_ops, n_extra = int(ins[1]), int(ins[2]), int(ins[5])
        r, c = np.arange(self.rows)[:, None], np.arange(cols)[None, :]
        h = torch.from_numpy(self.load(ins[11:16], r, c))
        extras = [torch.from_numpy(self.load(ins[16 + 5 * e:21 + 5 * e], r, c))
                  for e in range(n_extra)]
        steps = [(NAMES[int(self.prog.prog[ins[3] + i])],
                  float(self.prog.consts[ins[4] + i])) for i in range(n_ops)]
        self.store(ins[6:11], r, c, tfc.eval_chain(h, steps, extras).numpy())

    def gather(self, ins):
        """Where an mm step reads x: in place in its workspace slot, or
        copied into xs at row stride rows_ldx(K), zeros past the tile's
        rows."""
        K = int(ins[2])
        v = ins[15:20]
        if tregion._in_place(v, K):
            self.xsrc = (self.ws, int(v[1]) + int(v[3]), int(v[2]))
            if self.rows:
                x = self.x(K, 0, self.rows)
                assert not np.isnan(x).any(), "read of an element nobody wrote"
            return
        ldx = tregion.rows_ldx(K)
        x = np.zeros((self.prog.rows, K), np.float32)
        if self.rows:
            x[:self.rows] = self.load(v, np.arange(self.rows)[:, None],
                                      np.arange(K)[None, :])
        for r in range(self.prog.rows):
            self.xs[r * ldx:r * ldx + K] = x[r]
        self.xsrc = (self.xs, 0, ldx)

    def x(self, K, r0, n):
        """Rows r0 .. r0 + n of x (past the tile's rows: whatever lies
        there; those rows are never stored)."""
        arr, base, ld = self.xsrc
        return np.stack([arr[base + r * ld:base + r * ld + K]
                         for r in range(r0, r0 + n)])

    def epilogue(self, ins, r0, c0, h):
        """Rows r0.. (only the tile's) of columns [c0, c0 + width) of an mm
        output: accumulate, bias, sin, store."""
        N, n0, b, flags, w0i = (int(ins[1]), int(ins[6]), int(ins[7]),
                                int(ins[8]), int(ins[9]))
        n = min(h.shape[0], self.rows - r0)
        if n <= 0:
            return
        h = h[:n]
        r = r0 + np.arange(n)[:, None]
        c = c0 + np.arange(h.shape[1])[None, :]
        if flags & 2:
            h = self.load(ins[10:15], r, c) + h
        if flags & 4:
            if b >= 0:
                h = h + self.flat[b][n0 + c0:n0 + c0 + h.shape[1]]
            if flags & 1:
                h = np.sin(np.float32(self.prog.consts[w0i]) * h)
        self.store(ins[10:15], r, c, h)

    def mm_narrow(self, ins):
        """The one-CTA arithmetic, 8 rows at a time, W from memory: ks
        partial chains per output, summed in order through red."""
        N, K, w, ldw, k0, n0 = (int(a) for a in ins[1:7])
        ks = tregion.split_of(N)
        wm = self.flat[w].reshape(-1, ldw)[k0:k0 + K, n0:n0 + N]
        for r0 in range(0, self.rows, ROWS):
            x = self.x(K, r0, ROWS)
            for c0 in range(0, N, common.ABI["region_threads"]):
                bw = min(common.ABI["region_threads"], N - c0)
                acc = np.zeros((ROWS, bw, ks), np.float32)
                for k in range(K):
                    acc[:, :, k % ks] = _fma(x[:, k:k + 1],
                                             wm[k, c0:c0 + bw][None, :],
                                             acc[:, :, k % ks])
                if ks == 1:
                    h = acc[:, :, 0]
                else:
                    for q in range(ks):
                        for r in range(ROWS):
                            base = (q * ROWS + r) * bw
                            self.red[base:base + bw] = acc[r, :, q]
                    h = np.zeros((ROWS, bw), np.float32)
                    for q in range(ks):
                        h = h + np.stack([
                            self.red[(q * ROWS + r) * bw:
                                     (q * ROWS + r + 1) * bw]
                            for r in range(ROWS)])
                self.epilogue(ins, r0, c0, h)


def _emulate_rows(prog, tensors, R):
    """Run a row-cluster program over R rows of one lane, cluster by
    cluster; outputs are written in place."""
    flat = [t.reshape(-1) for t in tensors]
    RB, Cr, S, SF = prog.rows, prog.row_cluster, STAGES, prog.stage_floats
    for first in range(0, prog.ctas(R), Cr):
        ctas = [_RowCta(prog, flat, (first + q) * RB,
                        int(np.clip(R - (first + q) * RB, 0, RB)))
                for q in range(Cr)]
        pos = 0
        for s, ins in enumerate(prog.table):
            if ins[0] == 0:
                for c in ctas:
                    c.chain(ins)
                continue
            for c in ctas:
                c.gather(ins)
            N, K, w, ldw, k0, n0 = (int(a) for a in ins[1:7])
            if not ins[tregion._RING]:
                assert not tregion.ring_step(N, ldw, n0)
                for c in ctas:
                    c.mm_narrow(ins)
                continue
            kr = (SF // min(N, BLOCK)) & ~3
            for c0 in range(0, N, BLOCK):
                bw = min(BLOCK, N - c0)
                accs = [np.zeros((RB, bw), np.float32) for _ in ctas]
                for kb in range(0, K, kr):
                    # rank 0 copies the table's next chunk into the same
                    # stage of every CTA
                    cw, off, rows, cols, cld = (int(a) for a in
                                                prog.chunks[pos])
                    assert (cw, off, rows, cols, cld) == (
                        w, (k0 + kb) * ldw + n0 + c0, min(kr, K - kb), bw,
                        ldw)
                    assert rows * cols <= SF and off % 4 == 0
                    slot = (pos % S) * SF
                    chunk = flat[cw][off + np.arange(rows)[:, None] * cld
                                     + np.arange(cols)[None, :]]
                    for c in ctas:
                        c.stage[slot:slot + rows * cols] = chunk.ravel()
                    for c, acc in zip(ctas, accs):
                        if not c.rows:
                            continue
                        x = c.x(K, 0, RB)
                        wst = c.stage[slot:slot + rows * cols].reshape(
                            rows, cols)
                        for k in range(rows):
                            acc[:] = _fma(x[:, kb + k:kb + k + 1],
                                          wst[k][None, :], acc)
                    pos += 1
                for c, acc in zip(ctas, accs):
                    c.epilogue(ins, 0, c0, acc)
        assert pos == prog.n_chunks, "chunks left in the ring"


def _wide_spec():
    """A hand-built spec whose mm steps take the ring: a 3-column input to
    264 columns (x read a float at a time; a full 256-column block and an
    8-column one), a column-tiled group of 132-column members (strided
    weight slices W[:, lo:hi], one bulk copy per row) with its reducer
    W[lo:hi, :], a 300-column step (blocks of 256 and 44), a bcast row and
    a 2-column narrow step."""
    rng = np.random.default_rng(17)
    D, H, M, O = 3, 264, 140, 300
    steps = (("mm", 1, 0, 10, 11, 2.0, True),             # [R, H]
             ("mm", 2, 1, 12, 13, 1.5, True),             # member [R, H]
             ("chain", 3, 2, (("mul", None), ("sin", None)), (7,)),
             ("mm", 4, 3, 14, 15, 1.0, True),             # reducer [R, M]
             ("mm", 5, 4, 16, None, 1.0, False),          # [R, O]
             ("chain", 6, 5, (("cos", None),), ()),
             ("mm", 8, 6, 17, None, 1.0, False))          # [R, 2]
    spec = tregion.RegionKernelSpec(
        steps=steps, stream_inputs=(0,),
        residents=(10, 11, 12, 13, 14, 15, 16, 17), outputs=(8, 5),
        bcast_rows=(7,),
        tile_groups=(tregion.TileGroup(members=(2, 3), reducer=4, width=H,
                                       bn=132),))
    shapes = [(D, H), (H,), (H, H), (H,), (H, M), (M,), (M, O), (O, 2)]
    ops = ([rng.uniform(-1, 1, (40, D)).astype(np.float32)],
           [rng.uniform(-1, 1, (1, H)).astype(np.float32)],
           [(rng.uniform(-1, 1, s) / np.sqrt(s[0])).astype(np.float32)
            for s in shapes])
    return "wide", spec, ops


@pytest.fixture(scope="module")
def row_cases():
    """(label, spec, stream, rows, residents) of every case: the fused
    regions the reference plans for a hidden-32 SIREN at orders 1-2, the
    column-tiled hidden-80 region, the hidden-160 SIREN's order-1 region
    (mm steps of 160 columns through the ring), and the hand-built ragged
    and wide specs."""
    out = []
    for hidden, layers, order, conf in [
            (32, 2, 1, JHardwareConfig(use_pallas=True)),
            (32, 2, 2, JHardwareConfig(use_pallas=True)),
            (80, 1, 2, JHardwareConfig(use_pallas=True, bn=32,
                                       vmem_budget=120_000)),
            (160, 1, 1, JHardwareConfig(use_pallas=True))]:
        cfg = JSirenConfig(hidden_features=hidden, hidden_layers=layers)
        f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
        g = j_trace_graph(f, order, 16, (16, 2), "float32")
        plan = j_build_segment_plan(g, config=conf)
        for k, r in enumerate(j_build_region_plan(plan, conf)
                              .fused_regions()):
            stream, rows, res, _ = _operands(g, r.spec, 40, 70 + k)
            out.append((f"h{hidden}o{order}", _port_spec(r.spec), stream,
                        rows, res))
    for label, spec, (stream, rows, res) in [*_hand_specs(), _wide_spec()]:
        stream = [np.resize(a, (40, a.shape[1])) for a in stream]
        out.append((label, spec, stream, rows, res))
    assert any(s.tile_groups for _, s, _, _, _ in out)
    return out


def _widths(stream, rows, res):
    return (tuple(a.shape[1] for a in stream), tuple(a.shape[1] for a in rows),
            tuple(a.shape for a in res))


def _stack(arrs, K):
    """K lanes of each operand: lane k is lane 0 scaled by 1 + k / 8 (the
    weights differ from lane to lane)."""
    return [np.stack([a * np.float32(1 + k / 8) for k in range(K)])
            for a in arrs]


@pytest.fixture(scope="module", params=DESIGNS,
                ids=lambda d: "rows{}-cr{}-s{}-f{}".format(d[0], d[1], STAGES,
                                                           d[2]))
def row_runs(request, row_cases):
    """Per case and R: the plain outputs, the 8-row one-CTA emulation's and
    the row-cluster emulation's for the design, K = 2 lanes through
    lane_strides."""
    rows_, cr, sf = request.param
    K = 2
    runs = []
    for label, spec, stream, rows, res in row_cases:
        widths = _widths(stream, rows, res)
        prog = tregion.lower(spec, *widths, 1, rows_, cr, sf)
        one = tregion.lower(spec, *widths)
        assert (prog.rows, prog.row_cluster) == (rows_, cr)
        for R in (5, 37):
            st = _stack([a[:R] for a in stream], K)
            rw, rs = _stack(rows, K), _stack(res, K)
            outs = {}
            for key, p in (("rows", prog), ("one", one)):
                outs[key] = [np.full((K, R, c), np.nan, np.float32)
                             for c in p.out_cols]
                tensors = st + rw + rs + outs[key]
                flat = [t.reshape(-1) for t in tensors]
                strides = tregion.lane_strides(t.shape for t in tensors)
                for k in range(K):
                    lane = [f[k * s:] for f, s in zip(flat, strides)]
                    if key == "rows":
                        _emulate_rows(p, lane, R)
                    else:
                        _emulate_cluster(p, lane, R)
            want = tregion.region_call_stacked_plain(
                spec, _t(st), _t(rw), _t(rs),
                [(c, "float32") for c in prog.out_cols])
            runs.append((f"{label} R={R}", want, outs["rows"], outs["one"]))
    return runs


def test_rows_design_matches_plain(row_runs):
    """Every case on the design's row clusters (ragged clusters, CTAs with
    no rows, a tile shorter than 8 rows): the plain version within 1e-4."""
    for label, want, got, _ in row_runs:
        for a, b in zip(got, want):
            assert not np.isnan(a).any(), label
            _close(a, b.numpy(), 1e-4)


def test_rows_design_bits_equal_one_cta_tiles(row_runs):
    """Rows per CTA, CTAs per cluster and stage size do not
    enter the summation order: lane by lane the 8-row one-CTA emulation's
    outputs bit for bit."""
    for label, _, got, one in row_runs:
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a, b, err_msg=label)


def test_wide_steps_take_the_ring(row_cases):
    """The hidden-160 region and the wide hand spec stream their wide mm
    steps through the ring (strided tile-group slices and 256 + 44-column
    blocks included); the hidden-32 regions have none."""
    by_label = {}
    for label, spec, stream, rows, res in row_cases:
        prog = tregion.lower(spec, *_widths(stream, rows, res), 1, 16, 2, 1024)
        by_label.setdefault(label, []).append(prog.chunks)
    assert not any(c.size for c in by_label["h32o1"] + by_label["h32o2"])
    assert any(c.size for c in by_label["h160o1"])
    wide, = by_label["wide"]
    assert set(wide[:, 3].tolist()) >= {256, 8, 132, 140, 44}
    assert (wide[:, 4] != wide[:, 3]).any()        # strided slices


# -- the design a launch gets ------------------------------------------------

@pytest.fixture(scope="module")
def full_width_programs():
    """Operand widths of the full-width SIREN's stacked regions (the port's
    own planner, orders 1-2), as MultiINRArtifact launches them."""
    from repro_torch.configs.siren import SirenConfig
    from repro_torch.core.config import HardwareConfig
    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.inr.siren import siren_fn, siren_init
    from repro_torch.serve import MultiINRArtifact, bind_weights

    cfg = SirenConfig()
    params = siren_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    coords = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (cfg.batch, 2)).astype(np.float32))
    out = {}
    for order in (1, 2):
        base = compile_gradient(siren_fn(cfg, params), order, coords,
                                config=HardwareConfig(use_pallas=True),
                                device="cpu")
        m = MultiINRArtifact(base, [bind_weights(base, params, params)] * 2)
        (region, rows, res, _), = m.stacked_calls
        out[order] = (region.spec, (2,), tuple(r.shape[2] for r in rows),
                      tuple(tuple(r.shape[1:]) for r in res))
    return out


@pytest.mark.parametrize("order", [1, 2])
def test_stacked_fleet_takes_row_clusters(full_width_programs, order):
    """K = 8 x 8,192 rows (1,024 tiles a lane): the row-cluster design, a
    cluster of more than one CTA, its workspace in shared memory beside its
    ring, within the 232,448 bytes one CTA may hold with
    its static arrays (two CTAs per SM at order 1, whose workspace is
    smaller); and the one-CTA design's weight bytes from L2 cut by about
    Cr x rows / 8 (the narrow steps' few KB read as before)."""
    widths = full_width_programs[order]
    prog = tregion.plan_region(*widths, 8192, 8, 132)
    assert prog.cluster == 1 and prog.row_cluster > 1
    assert prog.rows >= 16 and prog.in_smem
    assert prog.per_sm == (2 if order == 1 else 1)
    assert prog.smem_bytes + common.ABI["smem_dynamic_bytes"] <= 2 * 231424
    assert prog.smem_bytes <= common.ABI["smem_dynamic_bytes"]
    one = tregion.lower(*widths)
    cut = one.l2_weight_bytes(8192, 8) / prog.l2_weight_bytes(8192, 8)
    assert cut >= 0.95 * prog.row_cluster * prog.rows / ROWS


@pytest.mark.parametrize("R, lanes, C", [(8, 1, 16), (512, 1, 2), (5, 8, 16),
                                         (100, 8, 1)])
def test_small_launches_keep_column_clusters(full_width_programs, R, lanes,
                                             C):
    """One 8-row tile takes 16-CTA column clusters, 512 rows (64 tiles)
    2-CTA ones, 8 lanes of 5 rows 16; 8 lanes of 100 rows (104 tiles) fill
    the card: row clusters, no wider than a lane's tiles."""
    prog = tregion.plan_region(*full_width_programs[2], R, lanes, 132)
    assert prog.cluster == C
    if C == 1:
        assert prog.row_cluster <= -(-R // prog.rows)
    else:
        assert prog.rows == ROWS and prog.in_smem


def test_rows_design_rule():
    """``rows_design``: two CTAs per SM where 16 (else 8) rows leave each
    room for the ring's stages of at least STAGE_FLOATS, else one CTA per SM
    with the most rows that do; the stages as large as fit up to
    MAX_STAGE_FLOATS; 8 rows in global memory when nothing fits; a lane of
    one tile gets a cluster of one CTA."""
    steps = (("mm", 1, 0, 10, None, 1.0, False),
             ("chain", 2, 1, (("sin", None),), ()),
             ("mm", 3, 2, 11, None, 1.0, False))
    spec = tregion.RegionKernelSpec(steps=steps, stream_inputs=(0,),
                                    residents=(10, 11), outputs=(3,))
    two = common.ABI["sm_smem_bytes"] // 2 - 1024 - common.ABI["smem_static"]
    for width, rows, per_sm, in_smem in [(256, 16, 2, True),
                                         (1024, 8, 2, True),
                                         (2048, 8, 1, True),
                                         (4096, 8, 2, False)]:
        widths = ((4,), (), ((4, width), (width, 4)))
        prog = tregion.rows_design(spec, *widths, 4096)
        assert (prog.rows, prog.per_sm, prog.in_smem) == (rows, per_sm,
                                                          in_smem)
        assert prog.row_cluster == tregion.ROW_CLUSTER
        assert tregion.STAGE_FLOATS <= prog.stage_floats \
            <= tregion.MAX_STAGE_FLOATS
        assert prog.smem_bytes <= (two if per_sm == 2
                                   else common.ABI["smem_dynamic_bytes"])
        assert tregion.rows_design(spec, *widths, 3).row_cluster == 1


def test_lower_takes_row_clusters_of_at_most_two():
    """The kernel's ring serves clusters of one or ``ROW_CLUSTER`` = 2 CTAs
    (``csrc/abi.cuh`` RT_ROW_CLUSTER): ``lower`` refuses a wider one, and
    the launch layout it passes has ``design_ints`` ints."""
    steps = (("mm", 1, 0, 10, None, 1.0, False),)
    spec = tregion.RegionKernelSpec(steps=steps, stream_inputs=(0,),
                                    residents=(10,), outputs=(1,))
    widths = ((4,), (), ((4, 256),))
    assert tregion.ROW_CLUSTER == 2
    for cr in (1, 2):
        prog = tregion.lower(spec, *widths, 1, 16, cr)
        assert len(prog.design) == common.ABI["design_ints"]
        assert prog.design[1] == cr
    for cr in (0, 3):
        with pytest.raises(ValueError, match="row cluster"):
            tregion.lower(spec, *widths, 1, 16, cr)
