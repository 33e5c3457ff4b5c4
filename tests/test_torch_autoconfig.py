"""The port's autoconfig (``repro_torch.core.autoconfig``), ``config="auto"``
front door, artifact surface, streaming executor and byte accounting against
the reference's.

* The analytic search is integer arithmetic over copied plans: on the
  reference's graphs (``test_torch_planner.port_graph``) the port's
  ``resolve_config`` gives the reference's ``result_as_dict`` exactly,
  candidate by candidate and in order; so does a deterministic fake
  ``measure`` hook.
* ``compile_gradient(config="auto", device="cpu")`` stays analytic on the
  CPU (the measure hook is CUDA's default): its artifact serves within 1e-4
  (relative, and of max|ref|; ``test_torch_pipeline``'s tolerance) of the
  reference's auto artifact and within 1e-5 of max of the port's default
  artifact (the two configs differ only in knobs the CPU plain versions
  never read, or in the block, which only regroups rows).
* ``apply_batched`` at blocks 16, 32 and 64 (N = 300, a ragged remainder)
  against the reference (1e-4) and against the port's per-block walk at
  the same block (1e-5 of max).
* Byte accounting: the reference's ``test_executors.py::
  test_memory_accounting`` quantities, exactly (integer bytes).

The reference's ``tests/test_autoconfig.py`` cases run here on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import autoconfig as JAC
from repro.core import executor as jexecutor
from repro.core import graph as jgraph
from repro.core import pipeline as jpipeline
from repro.core.config import HardwareConfig as JHardwareConfig
from repro.core.dataflow import map_to_dataflow as j_map_to_dataflow
from repro.core.fifo_opt import optimize_fifo_depths as j_optimize_fifo
from repro.core.pipeline import _trace_graph as j_trace_graph
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro.serve import ArtifactStore as JArtifactStore
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import autoconfig as AC
from repro_torch.core import executor as texecutor
from repro_torch.core import pipeline as P
from repro_torch.core import trace
from repro_torch.core.config import DEFAULT_CONFIG, HardwareConfig
from repro_torch.core.dataflow import DataflowGraph, map_to_dataflow
from repro_torch.core.fifo_opt import optimize_fifo_depths
from repro_torch.core.segment import FUSED_MM_ACT, MATMUL, build_segment_plan
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.obs.metrics import counter
from repro_torch.obs.tracing import TRACER
from repro_torch.serve import ArtifactStore
from test_torch_planner import port_graph

N = 300


@pytest.fixture(autouse=True)
def fresh_cache():
    P.clear_compile_cache()
    jpipeline.clear_compile_cache()
    yield
    P.clear_compile_cache()
    jpipeline.clear_compile_cache()


def _port_params(params):
    return params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                            for p in params])


@pytest.fixture(scope="module")
def small_siren():
    """(reference fn, port fn, x [16, 2] as numpy) of a hidden-16 SIREN."""
    cfg = JSirenConfig(hidden_features=16, hidden_layers=1)
    params = j_siren_init(cfg, jax.random.PRNGKey(0))
    tcfg = SirenConfig(hidden_features=16, hidden_layers=1)
    x = np.array(jax.random.uniform(jax.random.PRNGKey(1), (16, 2),
                                    jnp.float32, -1, 1))
    return j_siren_fn(cfg, params), siren_fn(tcfg, _port_params(params)), x


@pytest.fixture(scope="module")
def ref_graphs():
    """Reference gradient graphs: (width, order, trace batch) -> graph."""
    out = {}
    for name, hidden, layers in (("h16", 16, 1), ("h64", 64, 2)):
        cfg = JSirenConfig(hidden_features=hidden, hidden_layers=layers)
        f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
        for order, batch in ((1, 16), (2, 16), (3, 16), (1, 64), (2, 64),
                             (3, 64)):
            if name == "h64" and (batch == 16 or order == 3):
                continue
            out[name, order, batch] = j_trace_graph(f, order, batch,
                                                    (batch, 2), "float32")
    return out


@pytest.fixture(scope="module")
def siren_graph(ref_graphs):
    """The port's copy of the hidden-16 order-2 graph at batch 16."""
    return port_graph(ref_graphs["h16", 2, 16])


def ref_graph(g):
    """The port's graph, node by node, in the reference's IR (the inverse
    of ``port_graph``): the port traces through torch, so its graph has its
    own node ids; the reference's planner and search run on this copy."""
    gj = jgraph.ComputeGraph()
    for nid, n in g.nodes.items():
        gj.nodes[nid] = jgraph.Node(
            n.id, n.op, n.shape, n.dtype, n.inputs, n.params,
            None if n.const is None else np.array(n.const))
    gj.outputs = list(g.outputs)
    gj._next = g._next
    return gj


def _close_scaled(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _close_port(got, want, tol=1e-5):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


# ---------------------------------------------------------------------------
# the analytic search against the reference's
# ---------------------------------------------------------------------------

BASES = {"default": dict(use_pallas=True),
         "unfused": dict(use_pallas=True, fuse_regions=False),
         "sharded": dict(use_pallas=True, n_shards=4),
         "sum": dict(use_pallas=True, region_packing="sum")}
SEARCHES = [(g, "default") for g in (("h16", 1, 16), ("h16", 2, 16),
                                      ("h16", 3, 16), ("h16", 1, 64),
                                      ("h16", 2, 64), ("h16", 3, 64),
                                      ("h64", 1, 64), ("h64", 2, 64))] + \
    [(("h16", 2, 64), b) for b in ("unfused", "sharded", "sum")]


@pytest.mark.parametrize("graph,base", SEARCHES)
def test_resolve_config_matches_reference(ref_graphs, graph, base):
    gj = ref_graphs[graph]
    want = JAC.resolve_config(gj, base=JHardwareConfig(**BASES[base]))
    got = AC.resolve_config(port_graph(gj),
                            base=HardwareConfig(**BASES[base]))
    assert AC.result_as_dict(got) == JAC.result_as_dict(want)
    assert got.describe() == want.describe()
    assert (got.evaluated, got.rejected) == (want.evaluated, want.rejected)
    assert AC.result_from_dict(AC.result_as_dict(got)) == got


@pytest.mark.parametrize("graph", [("h16", 2, 16), ("h64", 2, 64)])
def test_default_mode_and_predicted_latency_match_reference(ref_graphs,
                                                            graph):
    gj = ref_graphs[graph]
    g = port_graph(gj)
    jb, tb = (JHardwareConfig(use_pallas=True, mm_parallel=32),
              HardwareConfig(use_pallas=True, mm_parallel=32))
    want = JAC.resolve_config(gj, mode="default", base=jb)
    got = AC.resolve_config(g, mode="default", base=tb)
    assert AC.result_as_dict(got) == JAC.result_as_dict(want)
    assert got.config == tb
    for kw in (dict(use_pallas=True), dict(use_pallas=True, block=64,
                                           dataflow_block=8)):
        assert AC.predicted_latency(g, HardwareConfig(**kw)) == \
            JAC.predicted_latency(gj, JHardwareConfig(**kw))


def _fake_measure(config) -> float:
    """Deterministic wall times with ties, favouring no one knob."""
    return float((config.block * 7 + config.bn * 3 + config.bm
                  + config.chunk_blocks * 5) % 11)


@pytest.mark.parametrize("graph", [("h16", 2, 64), ("h16", 3, 64),
                                   ("h64", 1, 64)])
def test_fake_measure_picks_the_reference_config(ref_graphs, graph):
    gj = ref_graphs[graph]
    want = JAC.resolve_config(gj, base=JHardwareConfig(use_pallas=True),
                              measure=_fake_measure)
    got = AC.resolve_config(port_graph(gj),
                            base=HardwareConfig(use_pallas=True),
                            measure=_fake_measure)
    assert AC.result_as_dict(got) == JAC.result_as_dict(want)
    plain = AC.resolve_config(port_graph(gj),
                              base=HardwareConfig(use_pallas=True))
    assert got.config != plain.config, "the hook must steer the choice"


def test_apply_batched_measure_hook_times_real_serving(ref_graphs):
    """The standard hook on the CPU: each candidate compiled (no re-trace)
    and served, one ``compile.autoconfig.measure`` span per timed config."""
    g = port_graph(ref_graphs["h16", 1, 64])
    plan = build_segment_plan(g)
    measure = AC.make_apply_batched_measure(g, plan, device="cpu")
    t0 = trace.TRACE_CALLS
    TRACER.clear()
    with TRACER.enabled_scope():
        res = AC.resolve_config(g, plan, base=HardwareConfig(use_pallas=True),
                                measure=measure)
    assert trace.TRACE_CALLS == t0
    timed = [e for e in TRACER.events
             if e.name == "compile.autoconfig.measure"]
    search = [e for e in TRACER.events if e.name == "compile.autoconfig"]
    TRACER.clear()
    assert len(search) == 1 and search[0].args["candidates"] == \
        len(res.candidates)
    # 4 blocks, then 4 more tiles and 3 more chunk sizes of the winner
    assert len(timed) == 11
    assert len({e.args["config"] for e in timed}) == len(timed)
    assert all(e.args["ms"] > 0 for e in timed)
    assert res.config.describe() in {e.args["config"] for e in timed}
    assert not any(c.deadlocked for c in res.candidates if c.accepted)


# ---------------------------------------------------------------------------
# tests/test_autoconfig.py, on the port
# ---------------------------------------------------------------------------

def test_config_is_frozen_hashable_and_normalized():
    a = HardwareConfig(mm_parallel_per_segment=((3, 16), (1, 32)))
    b = HardwareConfig(mm_parallel_per_segment=((1, 32), (3, 16)))
    assert a == b and hash(a) == hash(b), "override order must not matter"
    assert a.mm_parallel_for(1) == 32
    assert a.mm_parallel_for(3) == 16
    assert a.mm_parallel_for(99) == a.mm_parallel
    with pytest.raises(Exception):
        a.block = 4                          # frozen
    with pytest.raises(ValueError):
        HardwareConfig(block=0)
    with pytest.raises(ValueError):
        HardwareConfig(mm_parallel_per_segment=((0, -1),))


def test_plan_carries_mm_parallel_stamps(siren_graph):
    cfg = HardwareConfig(mm_parallel=32).resolved()
    plan = build_segment_plan(siren_graph, config=cfg)
    assert plan.config == cfg
    mm = [s for s in plan.segments if s.kind in (MATMUL, FUSED_MM_ACT)]
    assert mm, "2nd-order SIREN graph has MM segments"
    assert all(s.meta["mm_parallel"] == 32 for s in mm)


def test_recompiling_a_shared_plan_never_restamps_it(siren_graph):
    plan = build_segment_plan(siren_graph)
    a = P.compile_from_graph(siren_graph, plan=plan, device="cpu",
                             config=HardwareConfig(mm_parallel=16,
                                                   use_pallas=False))
    b = P.compile_from_graph(siren_graph, plan=plan, device="cpu",
                             config=HardwareConfig(mm_parallel=64,
                                                   use_pallas=False))
    assert a.plan is plan, "first compile stamps the unconfigured plan"
    assert b.plan is not plan, "second compile must not mutate a's plan"
    mm_a = [s for s in a.plan.segments if s.kind in (MATMUL, FUSED_MM_ACT)]
    mm_b = [s for s in b.plan.segments if s.kind in (MATMUL, FUSED_MM_ACT)]
    assert all(s.meta["mm_parallel"] == 16 for s in mm_a)
    assert all(s.meta["mm_parallel"] == 64 for s in mm_b)
    assert a.plan.config.mm_parallel == 16


def test_resolve_config_is_deterministic(siren_graph):
    a = AC.resolve_config(siren_graph)
    b = AC.resolve_config(siren_graph)
    assert a.config == b.config
    assert a.predicted_latency == b.predicted_latency
    assert a.candidates == b.candidates


def test_resolve_config_never_worse_than_base(siren_graph):
    res = AC.resolve_config(siren_graph)
    assert res.predicted_row_cycles <= res.baseline_row_cycles
    assert res.evaluated >= 1
    assert res.mm_segments, "search targeted the MM segments"


def test_every_accepted_candidate_is_deadlock_free(siren_graph):
    res = AC.resolve_config(siren_graph)
    assert any(c.accepted for c in res.candidates)
    assert all(not c.deadlocked for c in res.candidates if c.accepted)
    plan = build_segment_plan(siren_graph, config=res.config)
    design = map_to_dataflow(siren_graph, plan=plan, config=res.config)
    dg = DataflowGraph(design)
    naive = {s: max(design.streams[s].n_blocks, 2) for s in design.streams}
    dead, _, _ = dg.check(naive)
    assert not dead
    fifo = optimize_fifo_depths(design, config=res.config)
    dead_final, _, _ = dg.check(fifo.depths_after)
    assert not dead_final


def test_resolve_mode_default_returns_base(siren_graph):
    base = HardwareConfig(mm_parallel=16).resolved()
    res = AC.resolve_config(siren_graph, mode="default", base=base)
    assert res.config == base
    assert res.predicted_latency == res.baseline_latency
    with pytest.raises(ValueError):
        AC.resolve_config(siren_graph, mode="fastest")


def test_resolve_config_respects_budget(siren_graph):
    plan = build_segment_plan(siren_graph)
    res = AC.resolve_config(siren_graph, plan)
    budget = DEFAULT_CONFIG.mm_parallel * len(res.mm_segments)
    spent = sum(res.config.mm_parallel_for(s) for s in res.mm_segments)
    assert spent <= budget, "allocation stays within the parallelism pool"


def test_measure_hook_refines_block(siren_graph):
    res = AC.resolve_config(siren_graph, measure=lambda c: -c.block)
    assert res.config.block == max(
        b for b in AC.BLOCK_CANDIDATES if 16 % b == 0)


def test_resolve_config_telemetry(siren_graph):
    searches = counter("autoconfig_searches")
    scored = counter("autoconfig_candidates")
    s0, c0 = searches.value(), scored.value()
    TRACER.clear()
    with TRACER.enabled_scope():
        res = AC.resolve_config(siren_graph)
    names = TRACER.span_names()
    TRACER.clear()
    assert names == ["compile.autoconfig"]
    assert searches.value() == s0 + 1
    assert scored.value() == c0 + len(res.candidates)


# ---------------------------------------------------------------------------
# the auto front door
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3])
def test_auto_matches_reference_and_default(small_siren, order):
    jf, tf, x = small_siren
    auto = P.compile_gradient(tf, order, torch.from_numpy(x), config="auto",
                              device="cpu")
    default = P.compile_gradient(tf, order, torch.from_numpy(x),
                                 device="cpu")
    ref = jpipeline.compile_gradient(jf, order, jnp.asarray(x),
                                     config="auto")
    assert auto.autoconfig is not None
    assert auto.config == auto.autoconfig.config.clamped(auto.plan.batch)
    # the port traces its own graph (its own node ids): the reference's
    # search on a copy of it gives the port's record exactly
    want = JAC.resolve_config(ref_graph(auto.graph),
                              base=JHardwareConfig(use_pallas=True))
    assert AC.result_as_dict(auto.autoconfig) == JAC.result_as_dict(want)
    assert auto.config.block == ref.config.block
    q = np.random.default_rng(order).uniform(-1, 1, (37, 2)).astype(
        np.float32)
    got = auto.apply_batched(torch.from_numpy(q))
    wref = ref.apply_batched(jnp.asarray(q))
    _close_port(got, default.apply_batched(torch.from_numpy(q)))
    assert len(got) == len(wref) == 2 ** order
    for a, b in zip(got, wref):
        _close_scaled(a, b)


def test_auto_is_cached_and_shares_resolved_entry(small_siren):
    _, tf, x = small_siren
    xt = torch.from_numpy(x)
    auto = P.compile_gradient(tf, 1, xt, config="auto", device="cpu")
    assert P.compile_gradient(tf, 1, xt, config="auto", device="cpu") is auto
    assert P.compile_gradient(tf, 1, xt, config=auto.config,
                              device="cpu") is auto
    # the trace batch rounds to a multiple of 8: 13 rows share 16's entry
    assert P.compile_gradient(tf, 1, xt[:13], config="auto",
                              device="cpu") is auto
    info = P.compile_cache_info()
    assert info["hits"] == 3 and info["misses"] == 1 and info["traces"] >= 1


def test_auto_attaches_record_to_an_explicit_entry(small_siren):
    """A search that resolves to an artifact compiled explicitly shares it
    and attaches the record once."""
    _, tf, x = small_siren
    xt = torch.from_numpy(x)
    res = P.compile_gradient(tf, 2, xt, config="auto", device="cpu")
    cfg = res.config
    P.clear_compile_cache()
    explicit = P.compile_gradient(tf, 2, xt, config=cfg, device="cpu")
    assert explicit.autoconfig is None
    auto = P.compile_gradient(tf, 2, xt, config="auto", device="cpu")
    assert auto is explicit and auto.autoconfig is not None


def test_base_config_only_seeds_auto(small_siren):
    _, tf, x = small_siren
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError):
        P.compile_gradient(tf, 1, xt, base_config=HardwareConfig(),
                           device="cpu")
    with pytest.raises(ValueError):
        P.compile_gradient(tf, 1, xt, config="fastest", device="cpu")
    with pytest.raises(TypeError, match="config='auto'"):
        P.compile_from_graph(port_graph(j_trace_graph(
            small_siren[0], 1, 16, (16, 2), "float32")), config="auto",
            device="cpu")
    plain = P.compile_gradient(tf, 1, xt, config="auto", device="cpu")
    sharded = P.compile_gradient(tf, 1, xt, config="auto", device="cpu",
                                 base_config=HardwareConfig(n_shards=4))
    assert sharded is not plain and sharded.config.n_shards == 4
    assert any(p.name.startswith("xshard") for p in
               sharded.dataflow_summary()["design"].processes)
    unfused = P.compile_gradient(tf, 1, xt, config="auto", device="cpu",
                                 base_config=HardwareConfig(
                                     fuse_regions=False))
    assert unfused.autoconfig.baseline_row_cycles == AC.resolve_config(
        unfused.graph, base=HardwareConfig(fuse_regions=False).resolved()
    ).baseline_row_cycles


def test_distinct_configs_distinct_cache_entries(small_siren):
    _, tf, x = small_siren
    xt = torch.from_numpy(x)

    def c(**kw):
        return P.compile_gradient(tf, 1, xt, device="cpu", **kw)
    a = c(config=HardwareConfig(block=8))
    b = c(config=HardwareConfig(block=8, mm_parallel=64))
    d = c(config=HardwareConfig(block=8, chunk_blocks=4))
    assert a is not b and a is not d and b is not d
    assert c(config=HardwareConfig(block=8)) is a
    assert c(block=8) is a


def test_artifact_records_the_config(small_siren):
    _, tf, x = small_siren
    hw = HardwareConfig(block=4, mm_parallel=32)
    cg = P.compile_gradient(tf, 1, torch.from_numpy(x), config=hw,
                            device="cpu")
    assert cg.config.block == 4 and cg.config.mm_parallel == 32
    assert cg.block == 4 and cg.use_pallas is True
    mm = [s for s in cg.plan.segments if s.kind in (MATMUL, FUSED_MM_ACT)]
    assert all(s.meta["mm_parallel"] == 32 for s in mm)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_store_round_trips_the_auto_record(small_siren, tmp_path):
    """A replica restoring an auto request makes no trace and no search."""
    _, tf, x = small_siren
    xt = torch.from_numpy(x)
    cg = P.compile_gradient(tf, 2, xt, config="auto", store=tmp_path,
                            device="cpu")
    want = AC.result_as_dict(cg.autoconfig)
    out = cg.apply_batched(xt)
    P.clear_compile_cache()
    t0, s0 = trace.TRACE_CALLS, counter("autoconfig_searches").value()
    back = P.compile_gradient(tf, 2, xt, config="auto", store=tmp_path,
                              device="cpu")
    assert trace.TRACE_CALLS == t0
    assert counter("autoconfig_searches").value() == s0
    assert back is not cg and back.provenance == "store"
    assert AC.result_as_dict(back.autoconfig) == want
    assert back.config == cg.config
    assert all(torch.equal(a, b) for a, b in zip(back.apply_batched(xt), out))
    # cached under the auto request and under the resolved config
    assert P.compile_gradient(tf, 2, xt, config="auto", store=tmp_path,
                              device="cpu") is back
    assert P.compile_gradient(tf, 2, xt, config=back.config,
                              device="cpu") is back
    assert "autoconfig:" in back.describe()


def test_reference_auto_entry_restores_with_its_record(small_siren,
                                                       tmp_path):
    jf, _, x = small_siren
    jcg = jpipeline.compile_gradient(jf, 2, jnp.asarray(x), config="auto",
                                     store=JArtifactStore(tmp_path))
    t0 = trace.TRACE_CALLS
    cg = ArtifactStore(tmp_path).load(jcg.signature, device="cpu")
    assert trace.TRACE_CALLS == t0
    assert AC.result_as_dict(cg.autoconfig) == \
        JAC.result_as_dict(jcg.autoconfig)
    assert cg.config.as_dict() == jcg.config.as_dict()
    q = jnp.asarray(x[:11])
    for a, b in zip(cg.apply_batched(torch.from_numpy(x[:11])),
                    jcg.apply_batched(q)):
        _close_scaled(a, b, 1e-5)


# ---------------------------------------------------------------------------
# the artifact's surface
# ---------------------------------------------------------------------------

def test_describe_and_outputs_match_reference(small_siren):
    _, tf, x = small_siren
    cg = P.compile_gradient(tf, 2, torch.from_numpy(x), device="cpu")
    jcg = jpipeline.compile_from_graph(ref_graph(cg.graph),
                                       config=JHardwareConfig(use_pallas=True),
                                       emit_source=False)
    assert cg.streamed_outputs() == jcg.streamed_outputs()
    text = cg.describe()
    assert text.splitlines()[0].startswith("CompiledGradient(order=2, ")
    assert "provenance: trace" in text and cg.signature in text
    assert cg.plan.describe() in text and cg.region_plan.describe() in text
    assert "autoconfig" not in text
    # a hit shows in the provenance line
    P.compile_gradient(tf, 2, torch.from_numpy(x), device="cpu")
    assert "(+1 in-process hits)" in cg.describe()
    for o in cg.graph.outputs:
        if o in cg.plan.resident:
            _close_scaled(cg.resident_output(o, 5), jcg.resident_output(o, 5))


@pytest.mark.parametrize("fused", [True, False])
def test_dataflow_summary_matches_reference_and_caches(small_siren, fused):
    _, tf, x = small_siren
    cg = P.compile_gradient(tf, 2, torch.from_numpy(x), device="cpu",
                            config=HardwareConfig(fuse_regions=fused))
    jcg = jpipeline.compile_from_graph(
        ref_graph(cg.graph), emit_source=False,
        config=JHardwareConfig(use_pallas=True, fuse_regions=fused))
    strip = ("design", "fifo")
    for kw in ({}, {"dataflow_block": 8}, {"mm_parallel": 64},
               {"dataflow_block": 16, "mm_parallel": 8}):
        got, want = cg.dataflow_summary(**kw), jcg.dataflow_summary(**kw)
        assert {k: v for k, v in got.items() if k not in strip} == \
            {k: v for k, v in want.items() if k not in strip}
        assert dataclasses.asdict(got["fifo"]) == \
            dataclasses.asdict(want["fifo"])
        assert cg.dataflow_summary(**kw) is got
    assert P.compile_cache_info()["dataflow_summaries"] == 4
    TRACER.clear()
    with TRACER.enabled_scope():
        cg.dataflow_summary(dataflow_block=32)
    assert TRACER.span_names() == ["compile.dataflow_map",
                                   "compile.fifo_opt"]
    TRACER.clear()
    P.clear_compile_cache()
    assert P.compile_cache_info()["dataflow_summaries"] == 0


# ---------------------------------------------------------------------------
# blocks other than 8 on the serving path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h64(siren_setup):
    """(reference fn, port fn, coords [N, 2]) of the hidden-64 SIREN."""
    cfg, params, f, _ = siren_setup
    tcfg = SirenConfig(hidden_features=cfg.hidden_features,
                       hidden_layers=cfg.hidden_layers)
    coords = np.random.default_rng(11).uniform(
        -1, 1, (N, cfg.in_features)).astype(np.float32)
    return f, siren_fn(tcfg, _port_params(params)), coords


@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_apply_batched_at_wide_blocks(h64, block, order):
    """Full chunks (``chunk_blocks`` = 2), the ragged remainder, the plan
    batch and the per-block walk at blocks 16, 32 and 64."""
    jf, tf, coords = h64
    kw = dict(block=block, chunk_blocks=2)
    cg = P.compile_gradient(tf, order, torch.from_numpy(coords[:64]),
                            config=HardwareConfig(**kw), device="cpu")
    assert cg.block == block and cg.plan.batch == 64
    ref = jpipeline.compile_gradient(jf, order, jnp.asarray(coords[:64]),
                                     config=JHardwareConfig(**kw))
    got = cg.apply_batched(torch.from_numpy(coords))
    want = ref.apply_batched(jnp.asarray(coords))
    assert len(got) == len(want) == 2 ** order
    for a, b in zip(got, want):
        _close_scaled(a, b)
    x = torch.from_numpy(coords)
    pad = (-N) % block
    x = torch.cat([x, x[-1:].expand(pad, 2)])
    walk = [torch.cat(col) for col in zip(*(
        cg.apply_block(x[i:i + block]) for i in range(0, x.shape[0], block)))]
    _close_port(got, [w[:N] for w in walk])
    _close_port(cg.apply(x[:64]), [w[:64] for w in walk])
    # each row-constant resident kept one block for the largest call
    blocks = cg.residents._blocks
    assert all(b.shape[0] == 2 * block for b in blocks.values())


# ---------------------------------------------------------------------------
# the streaming executor and the byte accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_streaming_executor_matches_reference(ref_graphs, use_pallas):
    gj = ref_graphs["h16", 2, 16]
    g = port_graph(gj)
    x = np.random.default_rng(3).uniform(-1, 1, (16, 2)).astype(np.float32)
    jlog, tlog = [], []
    want = jexecutor.streaming_executor(gj, block=8, use_pallas=use_pallas,
                                        dispatch_log=jlog)(jnp.asarray(x))
    f = texecutor.streaming_executor(g, block=8, use_pallas=use_pallas,
                                     dispatch_log=tlog, device="cpu")
    got = f(torch.from_numpy(x))
    assert tlog == jlog
    for a, b in zip(got, want):
        _close_scaled(a, b)
    info = P.compile_cache_info()
    assert info["graph_cache_size"] == 1
    assert texecutor.streaming_executor(
        g, block=8, use_pallas=use_pallas, device="cpu").__self__ is \
        f.__self__
    ref = texecutor.reference_executor(g)(torch.from_numpy(x))
    _close_port(got, ref)


def test_memory_accounting_matches_reference():
    """The reference's ``test_memory_accounting`` quantities (the paper's
    SIREN, 256 hidden x 3, batch 64, order 2) on the copied graph."""
    cfg = JSirenConfig()
    f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
    gj = j_trace_graph(f, 2, cfg.batch, (cfg.batch, cfg.in_features),
                       "float32")
    g = port_graph(gj)
    dj = j_map_to_dataflow(gj, block=64)
    dt = map_to_dataflow(g, block=64)
    rj, rt = j_optimize_fifo(dj), optimize_fifo_depths(dt)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    eager = texecutor.buffered_total_bytes(g)
    packed = texecutor.buffered_peak_bytes(g)
    streamed = texecutor.streaming_peak_bytes(g, dt, rt.depths_after)
    assert eager == jexecutor.buffered_total_bytes(gj)
    assert packed == jexecutor.buffered_peak_bytes(gj)
    assert streamed == jexecutor.streaming_peak_bytes(gj, dj, rj.depths_after)
    assert streamed < eager and streamed < 2 * packed
    for nid in list(g.nodes)[:20]:
        assert texecutor._nbytes(g.nodes[nid]) == \
            jexecutor._nbytes(gj.nodes[nid])
