"""The port's region backward against the reference's backward megakernel.

``region_bwd_plain`` (autograd through the plain region) is held to the
reference's ``_region_bwd_call`` in Pallas interpret mode on the reference
planner's own region specs.  ``_emulate_bwd`` executes the program that
``lower_bwd`` builds for ``csrc/region_bwd.cu`` in numpy, with the kernel's
per-step rules (dpre in place, per-op chain pullbacks, partial sums per
8-row tile reduced in tile order), and is held to the plain version on
every chain opcode, every broadcast kind, mm flags, concat and tile groups:
a lowering fault shows here although the kernel runs only on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
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
from repro.kernels import region as jregion
from repro_torch.kernels import common
from repro_torch.kernels import fused_chain as tfc
from repro_torch.kernels import region as tregion

ROWS = common.ABI["region_rows"]
NI = common.ABI["region_instr_ints"]
NIO = common.ABI["region_bwd_io_ints"]


def _rng(k=0):
    return np.random.default_rng(4321 + k)


def _close(got, want, tol):
    """allclose with the tolerance scaled by max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _port_spec(spec) -> tregion.RegionKernelSpec:
    return tregion.RegionKernelSpec(
        steps=spec.steps, stream_inputs=spec.stream_inputs,
        residents=spec.residents, outputs=spec.outputs,
        bcast_rows=spec.bcast_rows,
        tile_groups=tuple(tregion.TileGroup(**dataclasses.asdict(t))
                          for t in spec.tile_groups))


@pytest.fixture(scope="module")
def planned_regions():
    """(label, graph, reference spec) for the fused regions the reference
    planner builds for a hidden-32 SIREN at orders 1-2, plus the
    column-tiled region a tight budget forces at hidden 80 (bn = 32)."""
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
        rplan = j_build_region_plan(plan, conf)
        out += [(f"h{hidden}o{order}", g, r.spec)
                for r in rplan.fused_regions()]
    assert any(s.tile_groups for _, _, s in out)
    return out


def _operands(g, spec, n_rows, seed):
    """Numpy operands and output cotangents for a planned region, shaped as
    the executor passes them (biases 1-D)."""
    rng = _rng(seed)

    def width(nid):
        s = g.nodes[nid].shape
        return s[-1] if s else 1

    stream = [rng.uniform(-1, 1, (n_rows, width(n))).astype(np.float32)
              for n in spec.stream_inputs]
    rows = [rng.uniform(-1, 1, (1, width(n))).astype(np.float32)
            for n in spec.bcast_rows]
    bias_ids = {s[4] for s in spec.steps if s[0] == "mm"}
    res = []
    for nid in spec.residents:
        shape = g.nodes[nid].shape
        if nid in bias_ids:
            res.append(rng.uniform(-1, 1, (shape[-1],)).astype(np.float32))
        else:
            res.append((rng.uniform(-1, 1, shape)
                        / np.sqrt(shape[0])).astype(np.float32))
    cots = [rng.standard_normal((n_rows, width(o))).astype(np.float32)
            for o in spec.outputs]
    return stream, rows, res, cots


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


# -- the plain version against the reference kernel --------------------------

@pytest.mark.parametrize("n_rows", [8, 100])
def test_region_bwd_plain_matches_reference(planned_regions, n_rows):
    """region_bwd_plain == the reference's _region_bwd_call (interpret) for
    every stream, row and resident cotangent, on one 8-row tile and on a
    ragged 100 rows (13 tiles, the last of 4 rows)."""
    for k, (label, g, spec) in enumerate(planned_regions):
        stream, rows, res, cots = _operands(g, spec, n_rows, k)
        got = tregion.region_bwd_plain(_port_spec(spec), _t(stream), _t(rows),
                                       _t(res), _t(cots))
        want = jregion._region_bwd_call(
            spec, [jnp.asarray(a) for a in stream],
            [jnp.asarray(a) for a in rows], [jnp.asarray(a) for a in res],
            [jnp.asarray(c) for c in cots], bm=8, interpret=True)
        for part_got, part_want in zip(got, want):
            assert len(part_got) == len(part_want), label
            for a, b in zip(part_got, part_want):
                assert tuple(a.shape) == tuple(b.shape), label
                _close(a.numpy(), np.asarray(b), 1e-5)


TIES = (np.array([[0.0, 0.5, -0.5, 0.25, 0.0, -0.0]], np.float32),
        np.array([[0.0, 0.5, 0.0, 0.5, 1.0, -0.0]], np.float32))


def _ties_spec(spec_cls):
    steps = (("chain", 2, 0, (("relu", None),), ()),
             ("chain", 3, 0, (("max", None),), (1,)),
             ("chain", 4, 0, (("min", None),), (1,)),
             ("chain", 5, 0, (("abs", None),), ()))
    return spec_cls(steps=steps, stream_inputs=(0, 1), residents=(),
                    outputs=(2, 3, 4, 5))


def test_region_bwd_plain_follows_jax_at_ties():
    """relu at exactly 0 and max/min at exact ties split the cotangent
    evenly, and abs passes it unchanged at 0: the reference's rules
    (jnp.maximum, jnp.minimum, jnp.abs under jax.vjp), bit for bit."""
    cots = [np.full((1, 6), k + 1.0, np.float32) for k in range(4)]
    got = tregion.region_bwd_plain(_ties_spec(tregion.RegionKernelSpec),
                                   _t(TIES), [], [], _t(cots))
    want = jregion._region_bwd_call(
        _ties_spec(jregion.RegionKernelSpec), [jnp.asarray(a) for a in TIES],
        [], [], [jnp.asarray(c) for c in cots], bm=8, interpret=True)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the backward program, executed as csrc/region_bwd.cu does ----------------

def _op_bwd(name, h, y, v, x, g):
    """chain_op_bwd of csrc/region_bwd.cu in numpy float32: (dh, dx)."""
    one, half = np.float32(1), np.float32(0.5)
    if name == "sin":
        return g * np.cos(h), None
    if name == "cos":
        return -(g * np.sin(h)), None
    if name == "exp":
        return g * y, None
    if name == "tanh":
        return g * (one - y * y), None
    if name == "neg":
        return -g, None
    if name == "abs":
        return np.where(h >= 0, g, -g), None
    if name == "relu":
        return np.where(h < 0, 0, np.where(h == 0, half * g, g)), None
    if name == "sigmoid":
        return g * (one - y) * y, None
    if name == "silu":
        s = one / (one + np.exp(-h))
        return g * s + (g * h) * ((one - s) * s), None
    if name == "square":
        return g * (np.float32(2) * h), None
    if name == "scale":
        return g * np.float32(v), None
    if name == "offset":
        return g, None
    if name == "mul":
        return g * x, g * h
    if name == "add":
        return g, g
    if name == "sub":
        return g, -g
    if name == "div":
        return g / x, -g * ((h / x) / x)
    tie = np.where(h == x, half * g, g)
    if name == "max":
        return np.where(h < x, 0, tie), np.where(h > x, 0, tie)
    if name == "min":
        return np.where(h > x, 0, tie), np.where(h < x, 0, tie)
    raise ValueError(name)


def _emulate_bwd(prog, tensors, R):
    """Run a ``lower_bwd`` program over R rows; ``tensors`` is the pointer
    table (stream, rows, residents, cotangents, d_stream outputs) as
    float32 arrays, d_stream written in place.  Returns the flat parameter
    cotangent: each 8-row tile's partial, added in tile order.  Value slots
    start as NaN, so a read of a value nobody wrote shows up."""
    names = {i: name for name, i in tfc.OPCODES.items()}
    flat = [t.reshape(-1) for t in tensors]
    n = prog.n_instr
    fwd = prog.prog[:n * NI].reshape(n, NI)
    bwd = prog.prog[n * NI:2 * n * NI].reshape(n, NI)
    io = prog.prog[prog.io_off:prog.io_off + NIO * prog.n_io].reshape(-1, NIO)
    total = np.zeros(prog.part_floats, np.float32)

    for cta in range(-(-R // ROWS)):
        row0, rows = cta * ROWS, min(ROWS, R - cta * ROWS)
        ws = np.full(max(prog.ws_floats, 1), np.nan, np.float32)
        ws[prog.cot_off:] = 0
        part = np.zeros(prog.part_floats, np.float32)

        def index(v, cols, r0=row0):
            space, idx, ld, coff, cs = (int(a) for a in v)
            r = np.arange(rows)[:, None]
            c = np.arange(cols)[None, :]
            if space:
                return ws, idx + coff + r * ld + c * cs
            return flat[idx], r0 * ld + coff + r * ld + c * cs

        def load(v, cols):
            arr, ix = index(v, cols)
            return arr[ix].copy()

        def store(v, cols, val):
            arr, ix = index(v, cols)
            arr[ix] = val

        def add(v, cols, val):
            arr, ix = index(v, cols)
            np.add.at(arr, ix, val.astype(np.float32))

        def chain_of(ins):
            return [(names[int(prog.prog[ins[3] + i])],
                     float(prog.consts[ins[4] + i])) for i in range(ins[2])]

        for kind, a, C, slot in io:
            if kind == 0:
                ws[slot:slot + rows * C] += flat[a][row0 * C:(row0 + rows) * C]
        for ins, b in zip(fwd, bwd):                      # the replay
            if ins[0] == 0:
                cols, n_extra = int(ins[1]), int(ins[5])
                h = torch.from_numpy(load(ins[11:16], cols))
                extras = [torch.from_numpy(load(ins[16 + 5 * e:21 + 5 * e],
                                                cols))
                          for e in range(n_extra)]
                store(ins[6:11], cols,
                      tfc.eval_chain(h, chain_of(ins), extras).numpy())
            else:
                N, K, w, ldw, k0, n0, bi, flags, w0i = (int(v)
                                                        for v in ins[1:10])
                x = load(ins[15:20], K)
                wm = flat[w].reshape(-1, ldw)[k0:k0 + K, n0:n0 + N]
                h = (x.astype(np.float64) @ wm).astype(np.float32)
                if flags & 2:
                    h = load(ins[10:15], N) + h
                if flags & 4:
                    if bi >= 0:
                        h = h + flat[bi][n0:n0 + N]
                    if flags & 1:
                        ws[b[10] + np.arange(rows * N)] = h.ravel()
                        h = np.sin(np.float32(prog.consts[w0i]) * h)
                store(ins[10:15], N, h)
        for ins, b in zip(fwd[::-1], bwd[::-1]):          # the reverse walk
            if ins[0] == 0:
                cols, n_extra = int(ins[1]), int(ins[5])
                hs = [load(ins[11:16], cols)]
                ev = [load(ins[16 + 5 * e:21 + 5 * e], cols)
                      for e in range(n_extra)]
                chain, e = chain_of(ins), 0
                opnd = []
                for op, v in chain:
                    xe = ev[e] if op in tfc.BINARY else None
                    opnd.append(xe)
                    e += xe is not None
                    hs.append(tfc.eval_chain(
                        torch.from_numpy(hs[-1]), [(op, v)],
                        [torch.from_numpy(xe)] if xe is not None else []
                    ).numpy())
                g = load(b[0:5], cols)
                de = [None] * n_extra
                for i in range(len(chain) - 1, -1, -1):
                    op, v = chain[i]
                    g, d = _op_bwd(op, hs[i], hs[i + 1], v, opnd[i], g)
                    g = g.astype(np.float32)
                    if d is not None:
                        e -= 1
                        de[e] = d.astype(np.float32)
                add(b[5:10], cols, g)
                for k in range(n_extra):
                    add(b[10 + 5 * k:15 + 5 * k], cols, de[k])
            else:
                N, K, w, ldw, k0, n0, bi, flags, w0i = (int(v)
                                                        for v in ins[1:10])
                g = load(b[0:5], N)
                if flags & 4 and flags & 1:
                    w0 = np.float32(prog.consts[w0i])
                    pre = ws[b[10] + np.arange(rows * N)].reshape(rows, N)
                    g = (g * np.cos(w0 * pre)) * w0
                    store(b[0:5], N, g)
                if flags & 4 and b[12] >= 0:
                    part[b[12] + n0 + np.arange(N)] += g.sum(0)
                x = load(ins[15:20], K)
                dw = (x.T.astype(np.float64) @ g).astype(np.float32)
                ix = (b[11] + (k0 + np.arange(K))[:, None] * ldw + n0
                      + np.arange(N)[None, :])
                part[ix] += dw
                wm = flat[w].reshape(-1, ldw)[k0:k0 + K, n0:n0 + N]
                add(b[5:10], K, (g.astype(np.float64) @ wm.T))
        for kind, a, C, slot in io:
            if kind == 1:
                flat[a][row0 * C:(row0 + rows) * C] = ws[slot:slot + rows * C]
            elif kind == 2:
                part[a:a + C] = ws[slot:slot + rows * C].reshape(rows, C).sum(0)
        total += part
    return total


def _check_lowering(spec, stream, rows, res, cots, tol):
    """Emulate lower_bwd's program and compare with region_bwd_plain."""
    R = stream[0].shape[0]
    prog = tregion.lower_bwd(spec, tuple(a.shape[1] for a in stream),
                             tuple(a.shape[1] for a in rows),
                             tuple(a.shape for a in res))
    assert prog.out_cols == tuple(c.shape[1] for c in cots)
    d_stream = [np.full_like(a, np.nan) for a in stream]
    grad = _emulate_bwd(prog, stream + rows + res + cots + d_stream, R)
    want = tregion.region_bwd_plain(spec, _t(stream), _t(rows), _t(res),
                                    _t(cots))
    for a, b in zip(d_stream, want[0]):
        _close(a, b.numpy(), tol)
    shapes = [(1, a.shape[1]) for a in rows] + [a.shape for a in res]
    for off, shape, b in zip(prog.part_offsets, shapes,
                             (*want[1], *want[2])):
        size = int(np.prod(shape))
        _close(grad[off:off + size].reshape(shape), b.numpy(), tol)
    return prog


@pytest.mark.parametrize("n_rows", [8, 13])
def test_region_bwd_lowering_matches_plain(planned_regions, n_rows):
    """The backward tables of the planner's real regions (hidden 32,
    orders 1-2, and the column-tiled hidden-80 region) on one tile and on
    a ragged second tile."""
    for k, (label, g, spec) in enumerate(planned_regions):
        stream, rows, res, cots = _operands(g, spec, n_rows, 10 + k)
        _check_lowering(_port_spec(spec), stream, rows, res, cots, 1e-4)


UNARY = ["sin", "cos", "exp", "tanh", "neg", "abs", "relu", "sigmoid",
         "silu", "square"]


@pytest.mark.parametrize("extra_kind", ["streamed", "bcast_row",
                                        "column"])
def test_region_bwd_lowering_every_op(extra_kind):
    """Every chain opcode, with the binary steps' operand streamed
    ([R, C]), a bcast row ([1, C], row stride 0) or one column ([R, 1],
    column stride 0); the chain's x is itself one column in the last
    chain, so its cotangent sums over the columns too."""
    C, R = 6, 11
    rng = _rng(7)
    chain_a = tuple((op, None) for op in UNARY) + (("scale", 0.5),
                                                   ("offset", -0.25))
    chain_b = (("mul", None), ("add", None), ("sub", None), ("div", None),
               ("max", None), ("min", None), ("sin", None))
    x = rng.uniform(-1, 1, (R, C)).astype(np.float32)
    col = rng.uniform(0.5, 1.5, (R, 1)).astype(np.float32)
    if extra_kind == "streamed":
        extra = rng.uniform(0.5, 1.5, (R, C)).astype(np.float32)
    elif extra_kind == "bcast_row":
        extra = rng.uniform(0.5, 1.5, (1, C)).astype(np.float32)
    else:
        extra = rng.uniform(0.5, 1.5, (R, 1)).astype(np.float32)
    steps = (("chain", 2, 0, chain_a, ()),
             ("chain", 3, 2, chain_b, (1,) * 6),
             ("chain", 4, 5, (("mul", None), ("cos", None)), (3,)))
    if extra_kind == "bcast_row":
        spec = tregion.RegionKernelSpec(steps=steps, stream_inputs=(0, 5),
                                        residents=(), outputs=(3, 4),
                                        bcast_rows=(1,))
        stream, rows = [x, col], [extra]
    else:
        spec = tregion.RegionKernelSpec(steps=steps, stream_inputs=(0, 1, 5),
                                        residents=(), outputs=(3, 4))
        stream, rows = [x, extra, col], []
    cots = [rng.standard_normal((R, C)).astype(np.float32) for _ in range(2)]
    _check_lowering(spec, stream, rows, [], cots, 1e-5)


def test_region_bwd_lowering_ties():
    """The kernel's rules at ties and at 0 are the plain version's."""
    cots = [np.full((1, 6), k + 1.0, np.float32) for k in range(4)]
    _check_lowering(_ties_spec(tregion.RegionKernelSpec), list(TIES), [], [],
                    cots, 0.0)


def test_region_bwd_lowering_mm_concat_and_tile_group():
    """mm steps with bias + sin and with neither, a concat, a bcast row,
    and a column-tiled group (a chain member, an mm member with bias + sin,
    a reducer accumulating over 3 ragged tiles with bias + sin); one output
    is also read by a later step."""
    rng = _rng(11)
    R, D, H, W, O = 19, 3, 10, 20, 4
    steps = (("mm", 1, 0, 10, 11, 30.0, True),            # [R, H]
             ("chain", 2, 1, (("cos", None), ("mul", None)), (7,)),
             ("concat", 3, (2, 0)),                        # [R, H + D]
             ("mm", 4, 3, 12, None, 1.0, False),           # [R, W]
             ("chain", 5, 4, (("sin", None),), ()),        # member 1
             ("mm", 6, 1, 13, 14, 2.0, True),              # member 2 [R, W]
             ("chain", 8, 5, (("mul", None),), (6,)),      # member 3
             ("mm", 9, 8, 15, 16, 3.0, True))              # reducer [R, O]
    spec = tregion.RegionKernelSpec(
        steps=steps, stream_inputs=(0,), residents=(10, 11, 12, 13, 14, 15,
                                                    16),
        outputs=(9, 2), bcast_rows=(7,),
        tile_groups=(tregion.TileGroup(members=(5, 6, 8), reducer=9,
                                       width=W, bn=8),))
    stream = [rng.uniform(-1, 1, (R, D)).astype(np.float32)]
    rows = [rng.uniform(-1, 1, (1, H)).astype(np.float32)]
    res = [rng.uniform(-1, 1, s).astype(np.float32) / np.sqrt(s[0])
           for s in [(D, H), (H,), (H + D, W), (H, W), (W,), (W, O), (O,)]]
    cots = [rng.standard_normal((R, c)).astype(np.float32) for c in (O, H)]
    prog = _check_lowering(spec, stream, rows, res, cots, 1e-4)
    fwd = prog.prog[:prog.n_instr * NI].reshape(prog.n_instr, NI)
    mm_flags = [int(f) for f in fwd[fwd[:, 0] == 1][:, 8]]
    assert {1, 3, 7} <= set(mm_flags)  # first, accumulating, last tile
    # the plain version differentiates the tiled and the untiled program
    # alike (up to the order of the reducer's float32 sums)
    untiled = dataclasses.replace(spec, tile_groups=())
    a = tregion.region_bwd_plain(spec, _t(stream), _t(rows), _t(res),
                                 _t(cots))
    b = tregion.region_bwd_plain(untiled, _t(stream), _t(rows), _t(res),
                                 _t(cots))
    for u, v in zip((*a[0], *a[1], *a[2]), (*b[0], *b[1], *b[2])):
        _close(u.numpy(), v.numpy(), 1e-5)


def test_region_bwd_program_layout():
    """Every value keeps its own slot, cotangent slots follow from cot_off,
    and the flat parameter cotangent holds rows, then residents."""
    steps = (("mm", 1, 0, 10, 11, 30.0, True),
             ("chain", 2, 1, (("cos", None),), ()),
             ("mm", 3, 2, 12, None, 1.0, False))
    spec = tregion.RegionKernelSpec(steps=steps, stream_inputs=(0,),
                                    residents=(10, 11, 12), outputs=(3,))
    prog = tregion.lower_bwd(spec, (2,), (), ((2, 6), (6,), (6, 1)))
    # values 1, 2, 3 (6 + 6 + 1 columns), the sin argument of step 0 (6),
    # cotangents of 0, 1, 2, 3 (2 + 6 + 6 + 1)
    assert prog.cot_off == ROWS * (6 + 6 + 1 + 6)
    assert prog.ws_floats == prog.cot_off + ROWS * (2 + 6 + 6 + 1)
    assert prog.part_offsets == (0, 12, 18) and prog.part_floats == 24
    assert prog.n_io == 2 and prog.out_cols == (1,)
    assert prog.flops(8) == 3 * tregion.lower(
        spec, (2,), (), ((2, 6), (6,), (6, 1))).flops(8)


def test_region_bwd_call_checks_operands():
    steps = (("mm", 1, 0, 10, None, 1.0, False),)
    spec = tregion.RegionKernelSpec(steps=steps, stream_inputs=(0,),
                                    residents=(10,), outputs=(1,))
    x, w = torch.rand(8, 3), torch.rand(3, 2)
    with pytest.raises(ValueError):
        tregion.region_bwd_call(spec, [x], [], [w], [])
    with pytest.raises(ValueError):
        tregion.region_bwd_call(spec, [x], [], [], [torch.rand(8, 2)])
    d_stream, d_rows, d_res = tregion.region_bwd_call(
        spec, [x], [], [w], [torch.ones(8, 2)])
    _close(d_stream[0].numpy(), (torch.ones(8, 2) @ w.T).numpy(), 1e-6)
    _close(d_res[0].numpy(), (x.T @ torch.ones(8, 2)).numpy(), 1e-6)
    assert d_rows == ()


def test_region_grad_fn_forward_is_region_call():
    """The differentiable call's forward is region_call bit for bit, its
    gradient region_bwd_call's, and it is cached per (spec, out_info)."""
    steps = (("mm", 1, 0, 10, 11, 30.0, True),
             ("chain", 2, 1, (("cos", None), ("mul", None)), (3,)))
    spec = tregion.RegionKernelSpec(steps=steps, stream_inputs=(0,),
                                    residents=(10, 11), outputs=(2,),
                                    bcast_rows=(3,))
    out_info = ((4, "float32"),)
    call = tregion.region_grad_fn(spec, out_info)
    assert tregion.region_grad_fn(spec, out_info) is call
    rng = _rng(3)
    ops = [torch.from_numpy(a).requires_grad_(True) for a in (
        rng.uniform(-1, 1, (9, 2)).astype(np.float32),
        rng.uniform(-1, 1, (1, 4)).astype(np.float32),
        rng.uniform(-1, 1, (2, 4)).astype(np.float32),
        rng.uniform(-1, 1, (4,)).astype(np.float32))]
    (out,) = call(*ops)
    (want,) = tregion.region_call(spec, [ops[0].detach()],
                                  [ops[1].detach()],
                                  [o.detach() for o in ops[2:]], out_info)
    assert torch.equal(out.detach(), want)
    ct = torch.from_numpy(rng.standard_normal((9, 4)).astype(np.float32))
    grads = torch.autograd.grad(out, ops, ct)
    d_stream, d_rows, d_res = tregion.region_bwd_call(
        spec, [ops[0].detach()], [ops[1].detach()],
        [o.detach() for o in ops[2:]], [ct])
    for a, b in zip(grads, (*d_stream, *d_rows, *d_res)):
        assert torch.equal(a, b)
