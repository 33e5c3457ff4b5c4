"""The port's filter-bank compiler against the reference's (DESIGN.md §9).

Counterparts of ``tests/test_bank.py``: both packages get the same SIREN
(``siren.params_from_jax`` on the reference's ``siren_init`` weights) and the
same INSP heads (``insp.params_from_jax`` on the reference's ``insp_init``),
and the same coordinates made with numpy.  On the CPU every kernel wrapper
runs its plain version.  The bank must match the reference's bank within
1e-4 and equal the port's own single-head banks bit for bit; on the
reference's merged graph, copied node by node, the port must plan what the
reference plans and report the same dispatches and bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.siren import InspConfig as JInspConfig
from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import graph as jgraph
from repro.core import passes as jpasses
from repro.core import pipeline as JP
from repro.core.config import HardwareConfig as JHardwareConfig
from repro.core.regions import build_region_plan as j_build_region_plan
from repro.core.segment import build_segment_plan as j_build_segment_plan
from repro.inr import insp as jinsp
from repro.inr.gradnet import num_features
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as P
from repro_torch.core import trace
from repro_torch.core.config import HardwareConfig
from repro_torch.core.dataflow import DataflowGraph, map_to_dataflow
from repro_torch.core.graph import merge_graphs
from repro_torch.core.pipeline import CompiledBank, compile_bank
from repro_torch.core.regions import (build_region_plan,
                                      region_dispatch_table)
from repro_torch.core.segment import build_segment_plan
from repro_torch.inr import insp
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.serve import ArtifactStore, BankArtifact, ServingEngine
from repro_torch.serve.store import bank_request_key
from test_torch_pipeline import _close_scaled
from test_torch_planner import _regions, _segments, port_graph

CFG = HardwareConfig(block=8, use_pallas=True, fuse_regions=True)
JCFG = JHardwareConfig(block=8, use_pallas=True, fuse_regions=True)


@pytest.fixture(autouse=True)
def fresh_cache():
    P.clear_compile_cache()
    JP.clear_compile_cache()
    yield
    P.clear_compile_cache()


def _numpy(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _sirens(hidden, layers):
    """(reference fn, port fn) of one SIREN with the reference's weights."""
    jcfg = JSirenConfig(hidden_features=hidden, hidden_layers=layers)
    params = j_siren_init(jcfg, jax.random.PRNGKey(0))
    tcfg = SirenConfig(hidden_features=hidden, hidden_layers=layers)
    return j_siren_fn(jcfg, params), siren_fn(tcfg,
                                              params_from_jax(_numpy(params)))


@pytest.fixture(scope="module")
def siren():
    return _sirens(32, 2)


def _psis(order, n, hidden=16):
    icfg = JInspConfig(hidden=hidden, layers=2, grad_order=order)
    nf = num_features(2, 1, order)
    return [jinsp.insp_init(icfg, nf, 1, jax.random.PRNGKey(i + 1))
            for i in range(n)]


def _heads(order, n, hidden=16):
    """(reference heads, port heads) over the same INSP weights."""
    psis = _psis(order, n, hidden)
    return ([jinsp.insp_head(p) for p in psis],
            [insp.insp_head(insp.params_from_jax(_numpy(p))) for p in psis])


def _coords(n, d=2, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, d)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(a)


def _bank(f, heads, order, n=64, **kw):
    kw.setdefault("config", CFG)
    return compile_bank(f, heads, order, _t(_coords(n)), device="cpu", **kw)


# ---------------------------------------------------------------------------
# parity: against the reference's bank, and bit for bit against single heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3])
def test_bank_matches_reference(siren, order):
    jf, tf = siren
    jheads, theads = _heads(order, 3)
    ref = JP.compile_bank(jf, jheads, order, jnp.asarray(_coords(64)),
                          config=JCFG)
    bank = _bank(tf, theads, order)
    xs = _coords(37, seed=order)           # not a block multiple
    want = ref.apply_batched(jnp.asarray(xs))
    got = bank.apply_batched(_t(xs))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _close_scaled(a, b)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_bank_parity_orders(siren, order):
    _, tf = siren
    _, heads = _heads(order, 3)
    bank = _bank(tf, heads, order)
    xs = _t(_coords(37, seed=order))
    outs = bank.apply_batched(xs)
    assert len(outs) == 3
    for j, h in enumerate(heads):
        (ref,) = _bank(tf, [h], order).apply_batched(xs)
        assert torch.equal(outs[j], ref)


def test_bank_single_rows_and_apply(siren):
    _, tf = siren
    _, heads = _heads(2, 2)
    bank = _bank(tf, heads, 2)
    outs = bank.apply_batched(_t(_coords(1, seed=9)))
    assert all(o.shape[0] == 1 for o in outs)
    ex = _t(_coords(64))
    for a, b in zip(bank.apply(ex), bank.apply_batched(ex)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# cross-graph sharing and the bank's ratios on the port's own trace
# ---------------------------------------------------------------------------

def test_merged_graph_smaller_than_sum(siren):
    _, tf = siren
    _, heads = _heads(2, 4)
    bank = _bank(tf, heads, 2)
    r = bank.report
    assert r.n_heads == 4
    assert r.nodes_bank < r.nodes_loop      # CSE collapsed the shared prefix
    assert len(bank.graph.outputs) == 4
    assert len(bank.plan.inputs) == 1       # Inputs merged across graphs


def test_bank_dispatch_and_hbm_ratios(siren):
    _, tf = siren
    _, heads = _heads(2, 4)
    bank = _bank(tf, heads, 2)
    r = bank.report
    assert r.dispatches_loop >= 2 * r.dispatches_bank
    assert r.hbm_block_loop >= 2 * r.hbm_block_bank
    assert r.row_cycles_bank <= r.row_cycles_loop
    assert len(region_dispatch_table(bank.plan, bank.region_plan)) \
        == r.dispatches_bank


def test_bank_never_worse_than_loop_under_autoconfig(siren):
    _, tf = siren
    _, heads = _heads(2, 3)
    bank = _bank(tf, heads, 2, config="auto",
                 base_config=HardwareConfig(block=8, use_pallas=True))
    assert bank.cg.autoconfig is not None
    r = bank.report
    assert r.row_cycles_bank <= r.row_cycles_loop
    assert r.dispatches_bank <= r.dispatches_loop


def test_copied_bank_graph_gives_reference_plans_and_report():
    """``results/bank_baseline.json``'s configuration (SIREN 64 x 2, four
    INSP heads 16 x 2, order 2, block 8): the reference's per-filter and
    merged graphs, copied node by node, give the reference's segment plan,
    region plan and BankReport (1 against 4 dispatches, 192 against 384
    bytes per block)."""
    jf, tf = _sirens(64, 2)
    jheads, theads = _heads(2, 4)
    per = [JP._trace_filter_graph(jf, h, 2, 64, (64, 2), "float32")
           for h in jheads]
    merged, _ = jgraph.merge_graphs(per)
    jpasses.optimize(merged)
    x = jax.random.uniform(jax.random.PRNGKey(9), (64, 2), jnp.float32, -1, 1)
    ref = JP.compile_bank(jf, jheads, 2, x, config=JCFG).report

    g = port_graph(merged)
    pt, pj = build_segment_plan(g, config=CFG), \
        j_build_segment_plan(merged, config=JCFG)
    assert _segments(pt) == _segments(pj)
    assert _regions(build_region_plan(pt, CFG)) == \
        _regions(j_build_region_plan(pj, JCFG))
    cg = P.compile_from_graph(g, config=CFG, device="cpu", order=2)
    report = P._bank_report([port_graph(h) for h in per], g, cg)
    assert (report.dispatches_bank, report.dispatches_loop) == (1, 4)
    assert (report.hbm_block_bank, report.hbm_block_loop) == (192, 384)
    assert dataclasses.astuple(report) == dataclasses.astuple(ref)
    # the port's own trace shares the prefix too
    own = compile_bank(tf, theads, 2, _t(np.array(x)), config=CFG,
                       device="cpu").report
    assert own.nodes_bank < own.nodes_loop
    assert (own.dispatches_bank, own.dispatches_loop) == (1, 4)
    assert (own.hbm_block_bank, own.hbm_block_loop) == (192, 384)


# ---------------------------------------------------------------------------
# multi-output regions: invariants
# ---------------------------------------------------------------------------

def test_multi_output_region_invariants(siren):
    _, tf = siren
    _, heads = _heads(2, 4)
    bank = _bank(tf, heads, 2)
    rp = bank.region_plan
    assert rp.validate()
    assert rp.peak_vmem_bytes() <= rp.config.vmem_budget
    multi = [reg for reg in rp.fused_regions() if len(reg.outputs) >= 2]
    assert multi, "the bank must fuse a region with multiple output sinks"
    for reg in multi:
        assert reg.spec is not None
        assert tuple(reg.spec.outputs) == tuple(reg.outputs)
    emitted = [o for reg in rp.regions for o in reg.outputs]
    for o in bank.graph.outputs:
        assert emitted.count(o) == 1


def test_merge_graphs_slices(siren):
    _, tf = siren
    _, heads = _heads(1, 2)
    per = [P._trace_filter_graph(tf, h, 1, 64, (64, 2), "float32", "cpu")
           for h in heads]
    merged, slices = merge_graphs(per)
    assert slices == [(0, 1), (1, 2)]
    assert len(merged.outputs) == 2
    merged.validate()
    assert len(merged.topo_order()) <= sum(len(g.topo_order()) for g in per)


def test_head_with_multiple_outputs_rejected(siren):
    _, tf = siren
    bad = lambda feats: (feats[:, :1], feats[:, 1:2])    # noqa: E731
    with pytest.raises(ValueError, match="exactly one tensor"):
        _bank(tf, [bad], 1)


# ---------------------------------------------------------------------------
# dataflow: the merged mapping stays deadlock-free
# ---------------------------------------------------------------------------

def test_bank_dataflow_deadlock_free(siren):
    _, tf = siren
    _, heads = _heads(2, 3)
    bank = _bank(tf, heads, 2)
    design = map_to_dataflow(bank.graph, plan=bank.plan, config=bank.config,
                             region_plan=bank.region_plan)
    dg = DataflowGraph(design)
    dead, latency, _ = dg.check()
    assert not dead and latency > 0
    dead, lat_d, _ = dg.check(dg.observed_depths())
    assert not dead and lat_d >= latency
    sinks = [p for p in design.processes if p.name.startswith("sink")]
    streamed = [o for o in bank.graph.outputs if o not in bank.plan.resident]
    assert len(sinks) == len(streamed)


# ---------------------------------------------------------------------------
# the filter library
# ---------------------------------------------------------------------------

def test_filter_library_bank_matches_reference(siren):
    """The five-filter bank against ``repro.inr.filters.filter_bank``: the
    same units by kind, and outputs within 1e-4."""
    from repro.inr.filters import filter_bank as j_filter_bank
    from repro_torch.inr.filters import filter_bank
    jf, tf = siren
    names = ["identity", "blur", "edge", "laplacian", "sharpen"]
    ex = _coords(64)
    ref = j_filter_bank(jf, names, jnp.asarray(ex), config=JCFG)
    art = filter_bank(tf, names, _t(ex), config=CFG, device="cpu")
    assert art.filter_ids == tuple(names)

    def kinds(cg):
        return sorted(kind for _, kind, _ in cg.dispatch)
    assert kinds(art.cg) == kinds(ref.cg)
    assert kinds(art.cg).count("FusedRegion") == 3
    xs = _coords(45, seed=4)
    for a, b in zip(art.apply_batched(_t(xs)),
                    ref.apply_batched(jnp.asarray(xs))):
        _close_scaled(a, b)
    with pytest.raises(ValueError, match="cannot supply"):
        filter_bank(tf, ["blur"], _t(ex), order=1, device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        filter_bank(tf, ["edge", "edge"], _t(ex), device="cpu")


def test_library_bank_chunk_hands_kernels_contiguous_operands(
        siren, monkeypatch):
    """One chunk of the filter library's bank calls each kernel unit once,
    with contiguous operands: its ``Slice`` units run in plain torch, and a
    slice of the feature matrix is a view that must not reach a kernel as
    one (a CUDA wrapper refuses it)."""
    from repro_torch.inr.filters import filter_bank
    from test_torch_chunk import _count_calls, _unit_kernels
    _, tf = siren
    art = filter_bank(tf, ["identity", "blur", "edge", "laplacian",
                           "sharpen"], _t(_coords(64)), config=CFG,
                      device="cpu")
    cg = art.cg
    calls = _count_calls(monkeypatch)
    rows = cg.config.chunk_blocks * cg.config.block
    xs = _t(_coords(rows, seed=2))
    cg.apply_chunk(xs.reshape(cg.config.chunk_blocks, cg.config.block, 2))
    assert calls == [(k, rows) for k in _unit_kernels(cg)
                     if k != "interpret"]
    assert [k for k, _ in calls].count("region") == 3


# ---------------------------------------------------------------------------
# caching + store round trip
# ---------------------------------------------------------------------------

def test_bank_cache_hit(siren):
    _, tf = siren
    _, heads = _heads(1, 2)
    assert _bank(tf, heads, 1) is _bank(tf, heads, 1)


def test_bank_request_key_is_stable_over_tensor_heads(siren):
    """Head closures over torch tensors fingerprint by value: two heads
    built from equal weights give one key, other weights another."""
    _, tf = siren
    _, a = _heads(2, 2)
    _, b = _heads(2, 2)
    shape, cfg = (64, 2), CFG.resolved()
    ka = bank_request_key(tf, a, 2, shape, "float32", cfg)
    assert ka is not None
    assert ka == bank_request_key(tf, b, 2, shape, "float32", cfg)
    assert ka != bank_request_key(tf, b[::-1], 2, shape, "float32", cfg)
    assert ka != bank_request_key(tf, a, 1, shape, "float32", cfg)


def test_bank_store_roundtrip(siren, tmp_path):
    _, tf = siren
    _, heads = _heads(2, 3)
    store = ArtifactStore(str(tmp_path))
    bank = _bank(tf, heads, 2, store=store)
    xs = _t(_coords(21, seed=5))
    ref = bank.apply_batched(xs)

    P.clear_compile_cache()
    traces = trace.TRACE_CALLS
    restored = _bank(tf, heads, 2, store=store)
    assert trace.TRACE_CALLS == traces
    assert isinstance(restored, CompiledBank)
    assert restored.signature == bank.signature
    assert restored.cg.provenance == "store"
    for a, b in zip(restored.apply_batched(xs), ref):
        assert torch.equal(a, b)


def test_bank_artifact_from_store(siren, tmp_path):
    _, tf = siren
    _, heads = _heads(2, 2)
    store = ArtifactStore(str(tmp_path))
    bank = _bank(tf, heads, 2, store=store)
    art = BankArtifact.from_store(store, bank.signature, ["a", "b"],
                                  device="cpu")
    assert art.n_filters == 2 and art.index_of("b") == 1
    xs = _t(_coords(13, seed=7))
    for a, b in zip(art.apply_batched(xs), bank.apply_batched(xs)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        BankArtifact(bank, ["only-one"])      # id count must match outputs


def test_reference_bank_restores_into_the_port(siren, tmp_path):
    """A bank the reference wrote to a store serves from the port."""
    from repro.serve import ArtifactStore as JArtifactStore
    jf, _ = siren
    jheads, _ = _heads(2, 2)
    ref = JP.compile_bank(jf, jheads, 2, jnp.asarray(_coords(64)),
                          config=JCFG, store=JArtifactStore(str(tmp_path)))
    art = BankArtifact.from_store(ArtifactStore(str(tmp_path)),
                                  ref.signature, ["a", "b"], device="cpu")
    xs = _coords(19, seed=8)
    for a, b in zip(art.apply_batched(_t(xs)),
                    ref.apply_batched(jnp.asarray(xs))):
        _close_scaled(a, b)


# ---------------------------------------------------------------------------
# engine routing
# ---------------------------------------------------------------------------

def test_engine_routes_mixed_filter_requests(siren, tmp_path):
    _, tf = siren
    _, heads = _heads(2, 3)
    store = ArtifactStore(str(tmp_path))
    bank = _bank(tf, heads, 2, store=store)
    solo = _bank(tf, [heads[0]], 2)

    eng = ServingEngine(store, device="cpu")
    sig = eng.register_bank(["fa", "fb", "fc"], bank)
    eng.register("plain", solo.cg)

    xs = [_t(_coords(n, seed=10 + i)) for i, n in enumerate([13, 7, 21, 5])]
    res = eng.serve([("fb", xs[0]), ("plain", xs[1]),
                     ("fa", xs[2]), ("fb", xs[3])])
    full = bank.apply_batched(torch.cat([xs[0], xs[2], xs[3]]))
    assert torch.equal(res[0][0], full[1][:13])
    assert torch.equal(res[2][0], full[0][13:34])
    assert torch.equal(res[3][0], full[1][34:39])
    (ref_plain,) = solo.apply_batched(xs[1])
    assert torch.equal(res[1][0], ref_plain)
    assert eng.stats["bank_groups"] == 1      # one pass served all 3 requests
    assert "fb -> bank" in eng.describe()

    # a cold engine restores the bank from the store by signature
    traces = trace.TRACE_CALLS
    eng2 = ServingEngine(store, device="cpu")
    eng2.register_bank(["fa", "fb", "fc"], signature=sig)
    res2 = eng2.serve([("fc", xs[0])])
    assert torch.equal(res2[0][0], bank.apply_batched(xs[0])[2])
    assert eng2.stats["restores"] == 1
    assert trace.TRACE_CALLS == traces


def test_engine_bank_id_clash_rejected(siren):
    _, tf = siren
    _, heads = _heads(1, 2)
    bank = _bank(tf, heads, 1)
    eng = ServingEngine(device="cpu")
    eng.register("x", bank.cg)                # unrelated plain route
    with pytest.raises(ValueError, match="already registered"):
        eng.register_bank(["x", "y"], bank)
    with pytest.raises(ValueError, match="needs a store"):
        eng.register_bank(["y"], signature="abc")


def test_bank_entry_points_raise_without_cuda(siren, monkeypatch):
    from repro_torch.inr.filters import filter_bank
    _, tf = siren
    _, heads = _heads(1, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        compile_bank(tf, heads, 1, _t(_coords(8)))
    with pytest.raises(RuntimeError):
        filter_bank(tf, ["edge"], _t(_coords(8)))


def test_bank_and_editing_import_no_jax():
    """A filter bank and an editing bank compiled and served through the
    engine in a fresh interpreter: neither JAX nor the reference package
    may be imported."""
    import os
    import subprocess
    import sys
    code = """
import sys, torch
from repro_torch.configs.siren import InspConfig, SirenConfig
from repro_torch.inr.editing import edited_bank, gaussian_blur, sharpen
from repro_torch.inr.encode import image_coords, synthetic_image
from repro_torch.inr.filters import filter_bank
from repro_torch.inr.insp import insp_init
from repro_torch.inr.siren import siren_fn, siren_init
from repro_torch.serve import ServingEngine
cfg = SirenConfig(hidden_features=16, hidden_layers=1)
params = siren_init(cfg, torch.Generator().manual_seed(0))
x = image_coords(8)
art = filter_bank(siren_fn(cfg, params), ["identity", "edge"], x,
                  device="cpu")
icfg = InspConfig(hidden=8, layers=2, grad_order=1)
psi = insp_init(icfg, 3, 1, torch.Generator().manual_seed(1))
bank, fns = edited_bank(cfg, icfg, params, {"a": psi}, x, device="cpu")
eng = ServingEngine(device="cpu")
eng.register_bank(art.filter_ids, art)
(edge,), = eng.serve([("edge", x[:5])])
assert edge.shape == (5, 1) and fns["a"](x).shape == (64, 1)
assert sharpen(gaussian_blur(synthetic_image(8))).shape == (8, 8)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=src),
                       timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
