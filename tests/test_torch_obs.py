"""The port's telemetry against the reference's (DESIGN.md §10): the
compile-stage spans, the async engine's serve spans and their Chrome
export, the compile-time perf model and FIFO high-water marks (equal to the
reference's on reference graphs copied node by node), drift reports and the
structured logger.

The reference's 5% wall-overhead test is a check on the card in
``chip_smoke.py`` phase 10: a wall bound on a loaded CPU would make the
count unsteady.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core.config import DEFAULT_CONFIG
from repro.core.pipeline import _trace_graph as j_trace_graph
from repro.core.pipeline import compile_from_graph as j_compile_from_graph
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro.obs import drift as jdrift
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as P
from repro_torch.core.config import HardwareConfig
from repro_torch.inr.siren import siren_fn, siren_init
from repro_torch.obs import log as obslog
from repro_torch.obs import drift
from repro_torch.obs.tracing import TRACER
from repro_torch.serve import AsyncServingEngine
from test_torch_planner import port_graph

HW = HardwareConfig(block=8, chunk_blocks=4)
JHW = DEFAULT_CONFIG.replace(block=8, chunk_blocks=4)
STAGES = ("compile.trace", "compile.passes", "compile.segment_plan",
          "compile.region_plan", "compile.residents", "compile.codegen")


@pytest.fixture(autouse=True)
def fresh_cache():
    P.clear_compile_cache()
    TRACER.disable()
    TRACER.clear()
    yield
    P.clear_compile_cache()
    TRACER.disable()
    TRACER.clear()


@pytest.fixture(scope="module")
def small_inr():
    cfg = SirenConfig(hidden_features=16, hidden_layers=1)
    f = siren_fn(cfg, siren_init(cfg, torch.Generator().manual_seed(0)))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (16, 2)).astype(np.float32))
    return cfg, f, x


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------

def _inside(inner, outer):
    return (outer.ts_ns <= inner.ts_ns
            and inner.ts_ns + inner.dur_ns <= outer.ts_ns + outer.dur_ns)


def test_compile_emits_stage_spans(small_inr):
    """A default compile records the reference's stage spans, each inside
    the outer ``compile`` span."""
    _, f, x = small_inr
    with TRACER.enabled_scope():
        P.compile_gradient(f, 1, x, config=HW, device="cpu")
    names = TRACER.span_names()
    assert {"compile", *STAGES} <= set(names)
    top, = [e for e in TRACER.events if e.name == "compile"]
    assert top.args == {"order": 1, "mode": "explicit"}
    for e in TRACER.events:
        if e.name in STAGES:
            assert _inside(e, top), e.name
    ev = {e.name: e for e in TRACER.events}
    assert ev["compile.passes"].args["nodes"] > 0
    assert ev["compile.segment_plan"].args["segments"] > 0
    assert ev["compile.region_plan"].args["regions"] > 0


def test_auto_and_bank_compiles_nest_their_stages(small_inr):
    """``config="auto"`` keeps its outer span around the trace, plan and
    search stages; a cache hit records no compile span."""
    _, f, x = small_inr
    with TRACER.enabled_scope():
        P.compile_gradient(f, 1, x, config="auto", device="cpu")
    top, = [e for e in TRACER.events if e.name == "compile"]
    assert top.args["mode"] == "auto"
    for name in ("compile.trace", "compile.passes", "compile.segment_plan",
                 "compile.autoconfig", "compile.codegen"):
        stage = [e for e in TRACER.events if e.name == name]
        assert stage and all(_inside(e, top) for e in stage), name
    TRACER.clear()
    with TRACER.enabled_scope():
        P.compile_gradient(f, 1, x, config="auto", device="cpu")
    assert "compile" not in TRACER.span_names()


def test_restore_emits_no_codegen_span(small_inr, tmp_path):
    """A store restore rebuilds the back half of the compiler but attaches
    the persisted source instead of emitting it."""
    _, f, x = small_inr
    from repro_torch.serve import ArtifactStore
    cg = P.compile_gradient(f, 1, x, config=HW, device="cpu")
    store = ArtifactStore(tmp_path)
    sig = store.put(cg)
    with TRACER.enabled_scope():
        back = store.load(sig, device="cpu")
    names = TRACER.span_names()
    assert "compile.residents" in names and "compile.codegen" not in names
    assert back.source == cg.source


def test_serve_async_trace_has_nested_serve_spans(small_inr, tmp_path):
    _, f, x = small_inr
    cg = P.compile_gradient(f, 1, x, config=HW, device="cpu")
    eng = AsyncServingEngine(tmp_path / "a", device="cpu")
    eng.register("i0", cg)
    q = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (70, 2)).astype(np.float32))
    with TRACER.enabled_scope():
        eng.submit("i0", q)
        eng.drain()
    names = set(TRACER.span_names())
    assert "serve.retire" in names and "serve.unpad" in names
    assert names & {"serve.chunk", "serve.chunk.multi", "serve.block"}, names
    assert "serve.dispatch" in names and "serve.pad" in names
    # every dispatch and pad nests in a chunk or block span
    outer = [e for e in TRACER.events
             if e.name in ("serve.chunk", "serve.block")]
    for e in TRACER.events:
        if e.name in ("serve.dispatch", "serve.pad"):
            assert any(_inside(e, o) for o in outer), e.name
    path = tmp_path / "trace.json"
    doc = json.loads(TRACER.export_chrome_json(str(path)))
    assert doc == json.loads(path.read_text())
    assert all(e["ph"] == "X" for e in doc["traceEvents"])
    assert {e["name"] for e in doc["traceEvents"]} == names


# ---------------------------------------------------------------------------
# the perf model and FIFO high-water, against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_graphs():
    cfg = JSirenConfig(hidden_features=16, hidden_layers=1)
    f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
    return {order: j_trace_graph(f, order, 16, (16, 2), "float32")
            for order in (1, 2, 3)}


@pytest.fixture(scope="module")
def compiled_pairs(ref_graphs):
    """(reference artifact, port artifact) per (order, fused), compiled
    from the same graph."""
    out = {}
    for order, gj in ref_graphs.items():
        for fuse in (True, False):
            jcg = j_compile_from_graph(gj, config=JHW.replace(
                use_pallas=True, fuse_regions=fuse), order=order)
            cg = P.compile_from_graph(
                port_graph(gj), config=HW.replace(use_pallas=True,
                                                  fuse_regions=fuse),
                order=order, device="cpu")
            out[order, fuse] = jcg, cg
    return out


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("fuse", [True, False])
def test_perf_model_matches_reference(compiled_pairs, order, fuse):
    jcg, cg = compiled_pairs[order, fuse]
    assert cg.perf_model and cg.perf_model == jcg.perf_model
    for m in cg.perf_model:
        assert m["predicted_row_cycles"] > 0
        assert m["modeled_hbm_bytes_block"] > 0
    assert cg.perf_model == drift.build_perf_model(cg.plan, cg.region_plan,
                                                   cg.config)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("fuse", [True, False])
def test_fifo_high_water_matches_reference(compiled_pairs, order, fuse):
    """High-water occupancy under the configured depths equals the
    reference's, and never exceeds the depths (the deadlock-freedom
    guarantee has runtime evidence)."""
    jcg, cg = compiled_pairs[order, fuse]
    df, jdf = cg.dataflow_summary(), jcg.dataflow_summary()
    configured = df["fifo"].depths_after
    assert configured == jdf["fifo"].depths_after
    high = drift.fifo_high_water(df["design"], configured)
    assert high == jdrift.fifo_high_water(jdf["design"], configured)
    assert set(high) == set(configured)
    for s, hw in high.items():
        assert 0 < hw <= configured[s], \
            f"stream {s}: high-water {hw} > configured {configured[s]}"


def test_fifo_high_water_refuses_a_deadlocked_design():
    """The paper's Fig. 6: the consumer reads B0 before A0-A2, the producer
    writes A0-A2 first; at depth 2 the design deadlocks and has no
    high-water mark."""
    from repro_torch.core import dataflow as df
    streams = {0: df.Stream(0, "A", 3, 4), 1: df.Stream(1, "B", 1, 4)}
    prod = df.Process("producer", [df.Step(writes=(w,)) for w in
                                   [(0, 0), (0, 1), (0, 2), (1, 0)]])
    cons = df.Process("consumer", [
        df.Step(reads=((1, 0),)), df.Step(reads=((0, 0),)),
        df.Step(reads=((0, 1),)), df.Step(reads=((0, 2),))])
    design = df.DataflowDesign([prod, cons], streams)
    with pytest.raises(ValueError, match="deadlocked"):
        drift.fifo_high_water(design, {0: 2, 1: 2})
    assert drift.fifo_high_water(design, {0: 3, 1: 2}) == \
        jdrift.fifo_high_water(design, {0: 3, 1: 2}) == {0: 3, 1: 1}


# ---------------------------------------------------------------------------
# drift reports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("fuse", [True, False])
def test_fifo_headroom_within_configured(small_inr, order, fuse):
    _, f, x = small_inr
    cg = P.compile_gradient(f, order, x, config=HW.replace(fuse_regions=fuse),
                            device="cpu")
    rep = drift.drift_report(cg, iters=1, warmup=1)
    assert rep.fifo and all(h.high_water <= h.configured for h in rep.fifo)
    assert rep.min_headroom >= 0
    assert len(rep.units) == len(cg.perf_model) == len(cg.dispatch)


def test_drift_report_fields_and_json(small_inr):
    from repro_torch.obs import DriftReport, drift_report

    _, f, x = small_inr
    cg = P.compile_gradient(f, 2, x, config=HW.replace(fuse_regions=False),
                            device="cpu")
    rep = drift_report(cg, iters=2, warmup=1)
    assert isinstance(rep, DriftReport)
    assert rep.order == 2 and rep.block == HW.block
    assert len(rep.units) == len(cg.perf_model) > 1
    assert abs(sum(u.predicted_share for u in rep.units) - 1.0) < 1e-9
    assert abs(sum(u.measured_share for u in rep.units) - 1.0) < 1e-9
    assert all(u.drift > 0 and u.measured_s > 0 for u in rep.units)
    assert rep.meta["backend"] == "cpu"
    assert rep.meta["config"] == cg.config.describe()
    back = json.loads(json.dumps(rep.as_dict()))
    assert back["max_drift"] == rep.max_drift
    assert back["min_headroom"] == rep.min_headroom
    assert len(back["units"]) == len(rep.units)
    assert [u["name"] for u in back["units"]] == \
        [m["name"] for m in cg.perf_model]
    text = rep.describe()
    assert "DriftReport" in text and "min headroom" in text


def test_drift_report_uses_supplied_coords(small_inr):
    from repro_torch.obs import drift_report

    _, f, x = small_inr
    cg = P.compile_gradient(f, 1, x, config=HW, device="cpu")
    rep = drift_report(cg, x, iters=1, warmup=1)
    assert rep.total_measured_s > 0
    # a short block is edge-padded
    assert drift_report(cg, x[:3], iters=1).units


# ---------------------------------------------------------------------------
# structured logger
# ---------------------------------------------------------------------------

def test_logger_quiet_under_pytest(capsys):
    assert obslog.current_level() == "error", "pytest detection"
    log = obslog.get_logger("train")
    log.info("step", step=1, loss=0.5)
    log.warn("straggler", step=2)
    assert capsys.readouterr() == ("", "")
    log.error("boom", code=3)
    out = capsys.readouterr()
    assert out.out == "" and out.err == "[train] boom code=3\n"


def test_logger_level_override(capsys):
    obslog.set_level("debug")
    try:
        log = obslog.get_logger("dryrun")
        log.info("cell ok", compile_s=1.25)
        assert capsys.readouterr().out == "[dryrun] cell ok compile_s=1.25\n"
        obslog.set_level("off")
        log.error("hidden")
        assert capsys.readouterr() == ("", "")
        with pytest.raises(ValueError):
            obslog.set_level("verbose")
    finally:
        obslog.set_level(None)
    assert obslog.current_level() == "error"


def test_obs_exports_drift_lazily():
    import repro_torch.obs as obs
    assert obs.drift_report is drift.drift_report
    assert obs.drift is drift
    with pytest.raises(AttributeError):
        obs.no_such_name
