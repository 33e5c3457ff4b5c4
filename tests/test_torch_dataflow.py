"""The port's dataflow model, deadlock analysis and FIFO-depth optimisation
(``repro_torch.core.dataflow`` / ``fifo_opt``) against the reference's.

Reference gradient graphs of small SIRENs (hidden 16 / 1 layer and hidden
64 / 2 layers, trace batch 64, orders 1-3) are copied node by node into the
port (``test_torch_planner.port_graph``) and planned on both sides, fused
and unfused, at ``dataflow_block`` 8 and 64.  The model is integer
arithmetic on the same plans, so everything is compared exactly: the
design stream by stream and step by step, the happens-before graph,
``check`` (deadlock verdict, latency, node times) at unconstrained, naive
(whole-stream) and depth-2 FIFOs, ``war_edges``, ``observed_depths`` and
``optimize_fifo_depths``'s result field by field.  The FIFO search of the
one largest case (hidden 64, order 3, unfused, ``dataflow_block`` 8:
~100k steps, about a minute a side in pure Python) is compared in
``test_torch_fifo_large``, a file of its own, to keep this one near a
minute; its design and analyses are compared here like the others.

The reference's own cases (``tests/test_deadlock.py``, ``test_fifo_opt.py``
and ``test_property.py::test_unconstrained_dataflow_is_acyclic``, the last
on seeded random graphs instead of hypothesis) run on both packages.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import config as jconfig
from repro.core import dataflow as jdataflow
from repro.core import fifo_opt as jfifo
from repro.core import graph as jgraph
from repro.core import passes as jpasses
from repro.core import segment as jsegment
from repro.core.pipeline import _trace_graph as j_trace_graph
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro_torch.core import config as tconfig
from repro_torch.core import dataflow as tdataflow
from repro_torch.core import fifo_opt as tfifo
from repro_torch.core import graph as tgraph
from repro_torch.core import passes as tpasses
from repro_torch.core import segment as tsegment
from test_torch_planner import port_graph

PKGS = {
    "reference": dict(config=jconfig, dataflow=jdataflow, fifo=jfifo,
                      graph=jgraph, passes=jpasses, segment=jsegment),
    "port": dict(config=tconfig, dataflow=tdataflow, fifo=tfifo,
                 graph=tgraph, passes=tpasses, segment=tsegment),
}
WIDTHS = {"h16": (16, 1), "h64": (64, 2)}
CASES = [(w, order, fused, db) for w in WIDTHS for order in (1, 2, 3)
         for fused in (True, False) for db in (8, 64)]
LARGE_FIFO = {("h64", 3, False, 8)}  # test_torch_fifo_large


@pytest.fixture(scope="module")
def ref_graphs():
    out = {}
    for name, (hidden, layers) in WIDTHS.items():
        cfg = JSirenConfig(hidden_features=hidden, hidden_layers=layers)
        f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
        for order in (1, 2, 3):
            out[name, order] = j_trace_graph(f, order, 64, (64, 2), "float32")
    return out


@pytest.fixture(scope="module")
def designs(ref_graphs):
    """(reference design, port design) per case, built once."""
    cache = {}

    def get(width, order, fused, db):
        key = (width, order, fused, db)
        if key not in cache:
            gj = ref_graphs[width, order]
            kw = dict(use_pallas=True, fuse_regions=fused, dataflow_block=db)
            jc = jconfig.HardwareConfig(**kw)
            tc = tconfig.HardwareConfig(**kw)
            g = port_graph(gj)
            dj = jdataflow.map_to_dataflow(
                gj, plan=jsegment.build_segment_plan(gj, config=jc), config=jc)
            dt = tdataflow.map_to_dataflow(
                g, plan=tsegment.build_segment_plan(g, config=tc), config=tc)
            cache[key] = (dj, dt, jc, tc)
        return cache[key]
    return get


def _design(d):
    """A design as plain tuples: every stream, then every process's steps."""
    return ([(s.id, s.src, s.n_blocks, s.block_bytes, s.producer, s.consumer)
             for s in d.streams.values()],
            [(p.name, [(st.reads, st.writes, st.delay) for st in p.steps])
             for p in d.processes])


def _depths(d):
    naive = {s: max(d.streams[s].n_blocks, 2) for s in d.streams}
    return {"unconstrained": None, "naive": naive,
            "depth2": {s: 2 for s in d.streams}}


@pytest.mark.parametrize("width,order,fused,db", CASES)
def test_design_and_analyses_match_reference(designs, width, order, fused,
                                             db):
    dj, dt, _, _ = designs(width, order, fused, db)
    assert _design(dt) == _design(dj)
    assert dt.stream_ids() == dj.stream_ids()
    gj, gt = jdataflow.DataflowGraph(dj), tdataflow.DataflowGraph(dt)
    assert (gt.n, gt.base_edges, gt.writes, gt.reads) == \
        (gj.n, gj.base_edges, gj.writes, gj.reads)
    for label, depths in _depths(dj).items():
        got, want = gt.check(depths), gj.check(depths)
        assert got == want, label
        if depths is not None:
            assert gt.war_edges(depths) == gj.war_edges(depths), label
            assert dt.fifo_bytes(depths) == dj.fifo_bytes(depths)
        if not want[0]:
            assert gt.observed_depths(depths) == gj.observed_depths(depths)
    # a fused region is one process: the default SIREN plan fuses whole
    if fused:
        assert sum(p.name.startswith("region") for p in dt.processes) >= 1


@pytest.mark.parametrize("width,order,fused,db",
                         [c for c in CASES if c not in LARGE_FIFO])
def test_fifo_optimisation_matches_reference(designs, width, order, fused,
                                             db):
    dj, dt, jc, tc = designs(width, order, fused, db)
    want = jfifo.optimize_fifo_depths(dj, config=jc)
    got = tfifo.optimize_fifo_depths(dt, config=tc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("alpha", [0.0, 0.01, 0.5])
def test_fifo_alpha_and_min_depth_match_reference(designs, alpha):
    dj, dt, _, _ = designs("h64", 2, False, 64)
    for min_depth in (2, 3):
        want = jfifo.optimize_fifo_depths(dj, alpha=alpha,
                                          min_depth=min_depth)
        got = tfifo.optimize_fifo_depths(dt, alpha=alpha,
                                         min_depth=min_depth)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_segment_row_cost_and_region_row_cost_match_reference(ref_graphs):
    from repro.core.regions import build_region_plan as j_build_region_plan
    from repro.core.regions import region_row_cost as j_region_row_cost
    from repro_torch.core.regions import build_region_plan, region_row_cost
    gj = ref_graphs["h64", 3]
    g = port_graph(gj)
    jc = jconfig.HardwareConfig(use_pallas=True)
    tc = tconfig.HardwareConfig(use_pallas=True)
    pj = jsegment.build_segment_plan(gj, config=jc)
    pt = tsegment.build_segment_plan(g, config=tc)
    for mmp in (8, 16, 64):
        assert [tdataflow.segment_row_cost(pt, s, mmp) for s in pt.segments] \
            == [jdataflow.segment_row_cost(pj, s, mmp) for s in pj.segments]
    rj, rt = j_build_region_plan(pj, jc), build_region_plan(pt, tc)
    assert [region_row_cost(pt, r, tc.mm_parallel_for)
            for r in rt.regions] == \
        [j_region_row_cost(pj, r, jc.mm_parallel_for) for r in rj.regions]


def test_sharded_input_stream_matches_reference(ref_graphs):
    """``n_shards > 1``: one host-side stream and an ``xshard`` forwarder per
    input, on both sides."""
    gj = ref_graphs["h16", 2]
    g = port_graph(gj)
    kw = dict(use_pallas=True, n_shards=4, xshard_row_cost=3)
    jc, tc = jconfig.HardwareConfig(**kw), tconfig.HardwareConfig(**kw)
    dj = jdataflow.map_to_dataflow(gj, config=jc)
    dt = tdataflow.map_to_dataflow(g, config=tc)
    assert _design(dt) == _design(dj)
    assert any(p.name.startswith("xshard") for p in dt.processes)
    assert tdataflow.DataflowGraph(dt).check(None) == \
        jdataflow.DataflowGraph(dj).check(None)


def test_load_op_row_cost_needs_a_path_and_resets(tmp_path):
    import json
    path = tmp_path / "row_cost.json"
    path.write_text(json.dumps({"op_row_cost": {"Sin": 3.4},
                                "mm_row_cost_per_k": 0.5,
                                "xshard_row_cost": 4}))
    with pytest.raises(TypeError):
        tdataflow.load_op_row_cost()
    try:
        table = tdataflow.load_op_row_cost(path)
        assert table["Sin"] == 3 and tdataflow.MM_ROW_COST_PER_K == 0.5
        assert tdataflow.XSHARD_ROW_COST == 4
    finally:
        tdataflow.reset_op_row_cost()
    assert tdataflow.OP_ROW_COST == jdataflow._ANALYTIC_OP_ROW_COST
    assert tdataflow.MM_ROW_COST_PER_K == 1.0
    assert tdataflow.XSHARD_ROW_COST is None


# ---------------------------------------------------------------------------
# tests/test_deadlock.py, on both packages
# ---------------------------------------------------------------------------

def fig5_graph(pkg, n_blocks=8):
    """src -> {Mm(., W), Cos} -> Mul (paper Fig. 5)."""
    g = PKGS[pkg]["graph"].ComputeGraph()
    x = g.add("Input", (n_blocks, 8), "float32", params=(("idx", 0),))
    w = g.add("Const", (8, 8), "float32",
              const=np.zeros((8, 8), np.float32))
    mm = g.add("Mm", (n_blocks, 8), "float32", (x, w))
    cos = g.add("Cos", (n_blocks, 8), "float32", (x,))
    mul = g.add("Mul", (n_blocks, 8), "float32", (mm, cos))
    g.outputs = [mul]
    return g


def _fig5(pkg, n_blocks):
    df = PKGS[pkg]["dataflow"]
    design = df.map_to_dataflow(fig5_graph(pkg, n_blocks), block=8)
    return design, df.DataflowGraph(design)


def _fig6(pkg, paper_order):
    """Paper Fig. 6: the consumer reads B0 A0 A1 A2; the producer writes
    A0 A1 A2 B0 (``paper_order``) or A0 A1 B0 A2."""
    df = PKGS[pkg]["dataflow"]
    streams = {0: df.Stream(0, "A", 3, 4), 1: df.Stream(1, "B", 1, 4)}
    writes = [(0, 0), (0, 1), (0, 2), (1, 0)] if paper_order else \
        [(0, 0), (0, 1), (1, 0), (0, 2)]
    prod = df.Process("producer", [df.Step(writes=(w,)) for w in writes])
    cons = df.Process("consumer", [
        df.Step(reads=((1, 0),)), df.Step(reads=((0, 0),)),
        df.Step(reads=((0, 1),)), df.Step(reads=((0, 2),))])
    design = df.DataflowDesign([prod, cons], streams)
    return design, df.DataflowGraph(design)


@pytest.mark.parametrize("pkg", PKGS)
def test_fig5_default_depths_deadlock(pkg):
    design, dg = _fig5(pkg, 8)
    dead, _, _ = dg.check({s: 2 for s in design.streams})
    assert dead


@pytest.mark.parametrize("pkg", PKGS)
def test_fig5_few_blocks_no_deadlock(pkg):
    design, dg = _fig5(pkg, 2)
    dead, _, _ = dg.check({s: 2 for s in design.streams})
    assert not dead


@pytest.mark.parametrize("pkg", PKGS)
def test_fig5_resolution_by_deepening(pkg):
    design, dg = _fig5(pkg, 8)
    depths = {s: 2 for s in design.streams}
    cos_in = [s for s, st in design.streams.items()
              if st.consumer.startswith("Cos")]
    depths[cos_in[0]] = 8
    dead, lat, _ = dg.check(depths)
    assert not dead and lat > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_unconstrained_never_deadlocks(pkg):
    _, dg = _fig5(pkg, 16)
    dead, _, _ = dg.check(None)
    assert not dead


@pytest.mark.parametrize("pkg", PKGS)
def test_fig6_depth2_deadlock(pkg):
    _, dg = _fig6(pkg, paper_order=True)
    dead, _, _ = dg.check({0: 2, 1: 2})
    assert dead, "paper Fig. 6(d): cycle exists at depth 2"
    # the paper's fix: stream A's depth from 2 to 3
    dead2, _, _ = dg.check({0: 3, 1: 2})
    assert not dead2


@pytest.mark.parametrize("pkg", PKGS)
def test_war_edges_count(pkg):
    _, dg = _fig6(pkg, paper_order=False)
    # stream 0 has 3 writes -> 1 WAR edge at depth 2; stream 1 has 1 -> 0
    assert len(dg.war_edges({0: 2, 1: 2})) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_latency_monotone_in_depth(pkg):
    design, dg = _fig5(pkg, 8)
    _, lat_unc, _ = dg.check(None)
    dead, lat_big, _ = dg.check({s: 64 for s in design.streams})
    assert not dead
    assert lat_big == lat_unc


def test_paper_figures_agree_across_packages():
    for n in (2, 8, 16):
        (dj, gj), (dt, gt) = _fig5("reference", n), _fig5("port", n)
        assert _design(dt) == _design(dj)
        for d in (None, {s: 2 for s in dj.streams}):
            assert gt.check(d) == gj.check(d)
    for paper_order in (True, False):
        (_, gj), (_, gt) = (_fig6("reference", paper_order),
                            _fig6("port", paper_order))
        for d in ({0: 2, 1: 2}, {0: 3, 1: 2}):
            assert gt.check(d) == gj.check(d)
            assert gt.war_edges(d) == gj.war_edges(d)


# ---------------------------------------------------------------------------
# tests/test_fifo_opt.py, on both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def siren_design(ref_graphs):
    """The order-1 gradient of the hidden-64 SIREN at block 64, parallelism
    64, in each package."""
    gj = ref_graphs["h64", 1]
    return {"reference": jdataflow.map_to_dataflow(gj, block=64,
                                                   mm_parallel=64),
            "port": tdataflow.map_to_dataflow(port_graph(gj), block=64,
                                              mm_parallel=64)}


@pytest.mark.parametrize("pkg", PKGS)
def test_optimized_depths_respect_latency_budget(siren_design, pkg):
    res = PKGS[pkg]["fifo"].optimize_fifo_depths(siren_design[pkg],
                                                 alpha=0.01)
    assert res.latency_after <= res.latency_peak * 1.01 + 1


@pytest.mark.parametrize("pkg", PKGS)
def test_optimized_depths_reduce_memory(siren_design, pkg):
    res = PKGS[pkg]["fifo"].optimize_fifo_depths(siren_design[pkg],
                                                 alpha=0.01)
    assert res.sum_after < res.sum_before
    assert res.sum_after <= 0.6 * res.sum_before


@pytest.mark.parametrize("pkg", PKGS)
def test_min_depth_respected(siren_design, pkg):
    res = PKGS[pkg]["fifo"].optimize_fifo_depths(siren_design[pkg])
    assert all(d >= 2 for d in res.depths_after.values())


@pytest.mark.parametrize("pkg", PKGS)
def test_final_design_not_deadlocked(siren_design, pkg):
    res = PKGS[pkg]["fifo"].optimize_fifo_depths(siren_design[pkg])
    dg = PKGS[pkg]["dataflow"].DataflowGraph(siren_design[pkg])
    dead, _, _ = dg.check(res.depths_after)
    assert not dead


@pytest.mark.parametrize("pkg", PKGS)
def test_deterministic(siren_design, pkg):
    opt = PKGS[pkg]["fifo"].optimize_fifo_depths
    a, b = opt(siren_design[pkg]), opt(siren_design[pkg])
    assert a.depths_after == b.depths_after
    assert a.latency_after == b.latency_after


@pytest.mark.parametrize("pkg", PKGS)
def test_alpha_zero_keeps_peak_latency(siren_design, pkg):
    res = PKGS[pkg]["fifo"].optimize_fifo_depths(siren_design[pkg],
                                                 alpha=0.0)
    assert res.latency_after <= res.latency_peak


@pytest.mark.parametrize("pkg", PKGS)
def test_mm_parallelism_tradeoff(ref_graphs, pkg):
    """Table II: lower MM parallelism -> higher latency."""
    gj = ref_graphs["h64", 1]
    g = gj if pkg == "reference" else port_graph(gj)
    df = PKGS[pkg]["dataflow"]
    lats = {}
    for mmp in (64, 16):
        d = df.map_to_dataflow(g, block=64, mm_parallel=mmp)
        _, lats[mmp], _ = df.DataflowGraph(d).check(None)
    assert lats[16] > lats[64]


def test_fifo_cases_agree_across_packages(siren_design):
    for kw in ({}, {"alpha": 0.0}, {"alpha": 0.01}):
        want = jfifo.optimize_fifo_depths(siren_design["reference"], **kw)
        got = tfifo.optimize_fifo_depths(siren_design["port"], **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# test_property.py::test_unconstrained_dataflow_is_acyclic, on seeded
# random graphs (the reference's generator, driven by numpy)
# ---------------------------------------------------------------------------

UNARY = ["Sin", "Cos", "Exp", "Tanh", "Neg", "Abs"]
BINARY = ["Add", "Sub", "Mul", "Maximum", "Minimum"]


def random_graph(pkg, seed):
    """A random well-formed batched graph over one input [B, F], drawn as
    the reference's hypothesis strategy draws it."""
    rng = np.random.default_rng(seed)
    B, F = int(rng.choice([4, 8])), int(rng.choice([3, 5, 8]))
    g = PKGS[pkg]["graph"].ComputeGraph()
    nodes = [g.add("Input", (B, F), "float32", params=(("idx", 0),))]
    shapes = {nodes[0]: (B, F)}
    for _ in range(int(rng.integers(3, 25))):
        kind = rng.choice(["u", "b", "mm"])
        if kind == "u":
            src = nodes[rng.integers(len(nodes))]
            nid = g.add(str(rng.choice(UNARY)), shapes[src], "float32",
                        (src,))
        elif kind == "b":
            src1 = nodes[rng.integers(len(nodes))]
            cands = [n for n in nodes if shapes[n] == shapes[src1]]
            src2 = cands[rng.integers(len(cands))]
            nid = g.add(str(rng.choice(BINARY)), shapes[src1], "float32",
                        (src1, src2))
        else:
            src = nodes[rng.integers(len(nodes))]
            b, f = shapes[src]
            fo = int(rng.choice([2, 4, 6]))
            w = np.random.default_rng(int(rng.integers(10 ** 6))).normal(
                size=(f, fo)).astype(np.float32) * 0.3
            wconst = g.add("Const", (f, fo), "float32", const=w)
            nid = g.add("Mm", (b, fo), "float32", (src, wconst))
        nodes.append(nid)
        shapes[nid] = g.nodes[nid].shape
    g.outputs = [nodes[1:][i] for i in
                 rng.integers(len(nodes) - 1, size=int(rng.integers(1, 4)))]
    return g


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("seed", range(8))
def test_unconstrained_dataflow_is_acyclic(pkg, seed):
    """For any graph, the unconstrained dataflow graph never deadlocks and
    big-enough depths match the unconstrained latency."""
    g = random_graph(pkg, seed)
    block = 2 + seed % 5
    PKGS[pkg]["passes"].optimize(g)
    df = PKGS[pkg]["dataflow"]
    design = df.map_to_dataflow(g, block=block)
    dg = df.DataflowGraph(design)
    dead, lat, _ = dg.check(None)
    assert not dead
    full = {s: design.streams[s].n_blocks + 1 for s in design.streams}
    dead2, lat2, _ = dg.check(full)
    assert not dead2 and lat2 == lat


@pytest.mark.parametrize("seed", range(8))
def test_random_graph_designs_agree_across_packages(seed):
    gj, gt = random_graph("reference", seed), random_graph("port", seed)
    jpasses.optimize(gj)
    tpasses.optimize(gt)
    block = 2 + seed % 5
    dj = jdataflow.map_to_dataflow(gj, block=block)
    dt = tdataflow.map_to_dataflow(gt, block=block)
    assert _design(dt) == _design(dj)
    assert tdataflow.DataflowGraph(dt).check(None) == \
        jdataflow.DataflowGraph(dj).check(None)
