"""The port's kernel modules against the reference Pallas kernels.

On the CPU every wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version; here each is held against the reference kernel (Pallas in
interpret mode) on the same numpy inputs, at the tolerances of the
reference's own tests (``tests/test_kernels.py``, ``tests/test_regions.py``):
1e-5 for chains, 2e-4 for the layer products, 1e-4 for regions.  Column-tiled
regions reorder the reducer's K sum, so they are held to a float64 oracle.

The CUDA region kernel interprets a program that ``kernels/region.py``
lowers from a spec; ``_emulate`` below executes that program exactly as
``csrc/region.cu`` does (views, workspace slots, flags), so the lowering is
checked here although the kernel itself runs only on the card.
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
from repro.kernels import fused_chain as jfc
from repro.kernels import region as jregion
from repro.kernels.siren_layer import siren_layer as j_siren_layer
from repro.kernels.stream_matmul import stream_matmul as j_stream_matmul
from repro_torch.kernels import common
from repro_torch.kernels import fused_chain as tfc
from repro_torch.kernels import region as tregion
from repro_torch.kernels.siren_layer import siren_layer
from repro_torch.kernels.stream_matmul import stream_matmul

RNG_SEED = 1234


def _rng(k=0):
    return np.random.default_rng(RNG_SEED + k)


def _close(got, want, tol):
    """allclose with the tolerance scaled by max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# -- fused_chain ---------------------------------------------------------------

UNARY_OPS = ["sin", "cos", "exp", "tanh", "neg", "abs", "relu", "sigmoid",
             "silu", "square"]


@pytest.mark.parametrize("chain", [
    [(op, None) for op in UNARY_OPS],
    [("scale", 0.5), ("mul", None), ("offset", -0.25), ("add", None),
     ("sub", None), ("div", None)],
    [("max", None), ("cos", None), ("min", None), ("scale", 30.0),
     ("sin", None)],
])
@pytest.mark.parametrize("shape", [(8, 256), (13, 2), (8, 1)])
def test_fused_chain_plain_matches_reference(chain, shape):
    """Every op of UNARY / BINARY / scale / offset, on the main path's
    shapes and a ragged one.  The reference's ``ref.fused_chain`` lacks
    max/min, so the chain is held against the reference ``fused_chain``."""
    rng = _rng(len(chain))
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    n_bin = sum(op in tfc.BINARY for op, _ in chain)
    extras = [rng.uniform(0.5, 1.5, shape).astype(np.float32)
              for _ in range(n_bin)]
    want = jfc.fused_chain(jnp.asarray(x), chain,
                           tuple(jnp.asarray(e) for e in extras),
                           interpret=True)
    got = tfc.fused_chain(torch.from_numpy(x), chain,
                          [torch.from_numpy(e) for e in extras])
    _close(got, want, 1e-5)
    _close(tfc.eval_chain(torch.from_numpy(x), chain,
                          [torch.from_numpy(e) for e in extras]), want, 1e-5)


def test_fused_chain_broadcasts_extras_and_checks_arity():
    x = torch.from_numpy(_rng().uniform(-1, 1, (8, 16)).astype(np.float32))
    row = torch.from_numpy(_rng(1).uniform(-1, 1, (1, 16)).astype(np.float32))
    got = tfc.fused_chain(x, [("mul", None)], [row])
    _close(got, (x * row).numpy(), 1e-6)
    with pytest.raises(ValueError):
        tfc.fused_chain(x, [("mul", None)], [])


def test_encode_chain_covers_every_op():
    ops, vals = tfc.encode_chain([(op, None) for op in UNARY_OPS]
                                 + [("scale", 2.0), ("offset", 3.0)]
                                 + [(op, None) for op in sorted(tfc.BINARY)])
    assert sorted(ops) == list(range(common.ABI["n_chain_ops"]))
    assert vals[len(UNARY_OPS):len(UNARY_OPS) + 2] == [2.0, 3.0]
    with pytest.raises(ValueError):
        tfc.encode_chain([("sin", None)] * (common.ABI["max_chain"] + 1))


# -- stream_matmul / siren_layer --------------------------------------------

MM_SHAPES = [(8, 256, 256), (8, 2, 256), (8, 1, 256), (8, 256, 2),
             (8, 256, 1), (13, 37, 5), (3, 130, 70)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_stream_matmul_plain_matches_reference(m, k, n):
    rng = _rng(m * k * n)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = (rng.uniform(-1, 1, (k, n)) / np.sqrt(k)).astype(np.float32)
    want = j_stream_matmul(jnp.asarray(a), jnp.asarray(b), bm=8, bn=128,
                           bk=128, interpret=True, mm_parallel=16)
    _close(stream_matmul(torch.from_numpy(a), torch.from_numpy(b),
                         mm_parallel=16), want, 2e-4)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("apply_sin", [True, False])
def test_siren_layer_plain_matches_reference(m, k, n, apply_sin):
    rng = _rng(m + k + n)
    x = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.uniform(-1, 1, (n,)).astype(np.float32)
    want = j_siren_layer(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         w0=30.0, apply_sin=apply_sin, bm=8, interpret=True)
    got = siren_layer(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), w0=30.0, apply_sin=apply_sin)
    _close(got, want, 2e-4)


def test_reduction_tile_follows_mm_parallel():
    from repro.kernels.stream_matmul import reduction_tile as j_tile
    from repro_torch.kernels.stream_matmul import reduction_tile
    for bk in (8, 32, 128):
        for p in (None, 1, 8, 9, 16, 17, 200):
            assert reduction_tile(bk, p) == j_tile(bk, p)


# -- region ------------------------------------------------------------------

def _port_spec(spec) -> tregion.RegionKernelSpec:
    return tregion.RegionKernelSpec(
        steps=spec.steps, stream_inputs=spec.stream_inputs,
        residents=spec.residents, outputs=spec.outputs,
        bcast_rows=spec.bcast_rows,
        tile_groups=tuple(tregion.TileGroup(**dataclasses.asdict(t))
                          for t in spec.tile_groups))


@pytest.fixture(scope="module")
def planned_regions():
    """(order, graph, region) for every fused region the reference planner
    builds for a hidden-32 SIREN at orders 1-3, plus the column-tiled
    regions a tight budget forces on a hidden-80 SIREN at order 2 (the
    setting of tests/test_regions_v2.py: 80 = 2 * 32 + 16, ragged)."""
    out = []
    for hidden, layers, order, conf in [
            (32, 2, 1, JHardwareConfig(use_pallas=True)),
            (32, 2, 2, JHardwareConfig(use_pallas=True)),
            (32, 2, 3, JHardwareConfig(use_pallas=True)),
            (80, 1, 2, JHardwareConfig(use_pallas=True, bn=32,
                                       vmem_budget=120_000))]:
        cfg = JSirenConfig(hidden_features=hidden, hidden_layers=layers)
        f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
        g = j_trace_graph(f, order, 16, (16, 2), "float32")
        plan = j_build_segment_plan(g, config=conf)
        rplan = j_build_region_plan(plan, conf)
        out += [(order, g, r) for r in rplan.fused_regions()]
    assert any(r.spec.tile_groups for _, _, r in out), \
        "the tight budget must produce a column-tiled region"
    return out


def _region_inputs(g, region, rows_n, seed):
    """Numpy operands for a region, shaped as executor._run_region passes
    them: stream [R, C], rows [1, C], residents whole (biases 1-D)."""
    rng = _rng(seed)
    spec = region.spec

    def width(nid):
        s = g.nodes[nid].shape
        return s[-1] if s else 1

    stream = [rng.uniform(-1, 1, (rows_n, width(n))).astype(np.float32)
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
    out_info = tuple((g.nodes[o].shape[-1], "float32") for o in spec.outputs)
    return stream, rows, res, out_info


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def test_region_plain_matches_reference_kernel(planned_regions):
    """region_call's plain version == the reference megakernel (interpret)
    on the reference planner's own specs; column-tiled specs against a
    float64 evaluation (their reducer sums in another order)."""
    checked = 0
    for k, (order, g, region) in enumerate(planned_regions):
        stream, rows, res, out_info = _region_inputs(g, region, 13, k)
        spec = _port_spec(region.spec)
        got = tregion.region_call(spec, _t(stream), _t(rows), _t(res),
                                  out_info)
        if region.spec.tile_groups:
            untiled = dataclasses.replace(spec, tile_groups=())
            want = tregion.region_call_plain(
                untiled, [torch.from_numpy(a).double() for a in stream],
                [torch.from_numpy(a).double() for a in rows],
                [torch.from_numpy(a).double() for a in res],
                [(c, torch.float64) for c, _ in out_info])
            tol = 1e-4
        else:
            want = jregion.region_call(
                region.spec, [jnp.asarray(a) for a in stream],
                [jnp.asarray(a) for a in rows], [jnp.asarray(a) for a in res],
                tuple((c, jnp.float32) for c, _ in out_info), bm=8,
                interpret=True)
            tol = 1e-4
        for a, b in zip(got, want):
            _close(a, b, tol)
        checked += 1
    assert checked >= 4


def _emulate(prog, tensors, R):
    """Execute a lowered region program as csrc/region.cu does, in numpy.

    ``tensors`` is the pointer table (stream, rows, residents, outputs) as
    flat float32 arrays; outputs are written in place.  The workspace starts
    as NaN so a read of a slot nobody wrote shows up."""
    rows_per, n_ints = common.ABI["region_rows"], common.ABI[
        "region_instr_ints"]
    names = {i: name for name, i in tfc.OPCODES.items()}
    flat = [t.reshape(-1) for t in tensors]

    def index(v, rows, cols, row0):
        space, idx, ld, coff, cs = (int(a) for a in v)
        r = np.arange(rows)[:, None]
        c = np.arange(cols)[None, :]
        if space:
            return None, idx + coff + r * ld + c * cs
        return idx, row0 * ld + coff + r * ld + c * cs

    for cta in range(-(-R // rows_per)):
        row0 = cta * rows_per
        rows = min(rows_per, R - row0)
        ws = np.full(max(prog.ws_floats, 1), np.nan, np.float32)

        def load(v, cols):
            t, ix = index(v, rows, cols, row0)
            return (ws if t is None else flat[t])[ix]

        def store(v, cols, val):
            t, ix = index(v, rows, cols, row0)
            (ws if t is None else flat[t])[ix] = val

        for s in range(prog.n_instr):
            ins = prog.prog[s * n_ints:(s + 1) * n_ints]
            if ins[0] == 0:
                cols, n_ops, op_off, val_off, n_extra = ins[1:6]
                h = torch.from_numpy(load(ins[11:16], cols).copy())
                extras = [torch.from_numpy(
                    load(ins[16 + 5 * e:21 + 5 * e], cols).copy())
                    for e in range(n_extra)]
                chain = [(names[int(prog.prog[op_off + i])],
                          float(prog.consts[val_off + i]))
                         for i in range(n_ops)]
                store(ins[6:11], cols, tfc.eval_chain(h, chain, extras).numpy())
            else:
                N, K, w, ldw, k0, n0, b, flags, w0i = (int(a) for a in ins[1:10])
                x = load(ins[15:20], K)
                wm = flat[w].reshape(-1, ldw)[k0:k0 + K, n0:n0 + N]
                h = (x.astype(np.float64) @ wm).astype(np.float32)
                if flags & 2:
                    h = load(ins[10:15], N) + h
                if flags & 4:
                    if b >= 0:
                        h = h + flat[b][n0:n0 + N]
                    if flags & 1:
                        h = np.sin(prog.consts[w0i] * h)
                store(ins[10:15], N, h)


@pytest.mark.parametrize("n_rows", [8, 13])
def test_region_lowering_matches_plain(planned_regions, n_rows):
    """The instruction tables for the CUDA kernel compute what the plain
    version computes, tile groups and liveness-packed slots included, on a
    full and a ragged second row tile."""
    for k, (order, g, region) in enumerate(planned_regions):
        stream, rows, res, out_info = _region_inputs(g, region, n_rows, k)
        spec = _port_spec(region.spec)
        prog = tregion.lower(spec, tuple(a.shape[1] for a in stream),
                              tuple(a.shape[1] for a in rows),
                              tuple(a.shape for a in res))
        outs = [np.full((n_rows, c), np.nan, np.float32) for c, _ in out_info]
        _emulate(prog, stream + rows + res + outs, n_rows)
        want = tregion.region_call_plain(spec, _t(stream), _t(rows), _t(res),
                                         out_info)
        for a, b in zip(outs, want):
            _close(a, b.numpy(), 1e-4)


def test_region_lowering_packs_slots_and_concat():
    """A hand-built spec with a concat step: the concat copies land in
    column ranges of one value, and dead values' slots are reused."""
    steps = (("mm", 1, 0, 10, 11, 30.0, True),          # [R, 6]
             ("chain", 2, 1, (("cos", None),), ()),      # [R, 6]
             ("chain", 3, 2, (("mul", None),), (4,)),    # * bcast row
             ("concat", 5, (3, 0)),                      # [R, 6 + 3]
             ("mm", 6, 5, 12, None, 1.0, False))         # [R, 2]
    spec = tregion.RegionKernelSpec(steps=steps, stream_inputs=(0,),
                                    residents=(10, 11, 12), outputs=(6,),
                                    bcast_rows=(4,))
    rng = _rng(7)
    stream = [rng.uniform(-1, 1, (11, 3)).astype(np.float32)]
    rows = [rng.uniform(-1, 1, (1, 6)).astype(np.float32)]
    res = [rng.uniform(-1, 1, (3, 6)).astype(np.float32),
           rng.uniform(-1, 1, (6,)).astype(np.float32),
           rng.uniform(-1, 1, (9, 2)).astype(np.float32)]
    prog = tregion.lower(spec, (3,), (6,), ((3, 6), (6,), (9, 2)))
    # values 1, 2, 3, 5 are workspace values; 1 dies at step 2, so 3 reuses
    assert prog.ws_floats < common.ABI["region_rows"] * (6 + 6 + 6 + 9)
    out = np.full((11, 2), np.nan, np.float32)
    _emulate(prog, stream + rows + res + [out], 11)
    want = tregion.region_call_plain(spec, _t(stream), _t(rows), _t(res),
                                     ((2, "float32"),))
    _close(out, want[0].numpy(), 1e-5)


def test_region_call_rejects_malformed_operands(planned_regions):
    _, g, region = planned_regions[0]
    stream, rows, res, out_info = _region_inputs(g, region, 8, 0)
    spec = _port_spec(region.spec)
    with pytest.raises(ValueError):
        tregion.region_call(spec, [], _t(rows), _t(res), out_info)
    with pytest.raises(ValueError):
        tregion.region_call(spec, _t(stream), _t(rows), _t(res)[:-1],
                            out_info)
