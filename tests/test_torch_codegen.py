"""The port's codegen against its executor and against the reference's
codegen (paper Sec. 3.2.5).

The port emits a torch module with the reference's layout; exec-loaded, it
must equal the port's ``streaming_executor`` and ``apply_batched`` bit for
bit on the CPU (each op is written as ``core.executor._eval_node`` computes
it) and stay within 1e-4 (scaled) of the reference's exec-loaded JAX module
on the same weights (``siren.params_from_jax``, ``insp.params_from_jax``)
and coordinates.  On a reference graph copied node by node, the emitted
docstring's graph, plan, regions, config and FIFO lines must read as the
reference's do.  The store persists the source as ``source.py``.
"""

import builtins
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.siren import InspConfig as JInspConfig
from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import codegen as jcodegen
from repro.core import graph as jgraph
from repro.core import pipeline as JP
from repro.core.config import DEFAULT_CONFIG
from repro.core.pipeline import _trace_graph as j_trace_graph
from repro.inr import insp as jinsp
from repro.inr.gradnet import num_features
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro.serve.store import ArtifactStore as JArtifactStore
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import codegen
from repro_torch.core import graph as tgraph
from repro_torch.core import pipeline as P
from repro_torch.core.config import HardwareConfig
from repro_torch.core.executor import streaming_executor
from repro_torch.inr import insp
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.serve import ArtifactStore
from test_torch_pipeline import _close_scaled
from test_torch_planner import port_graph

HW = HardwareConfig(block=8, chunk_blocks=4)
JHW = DEFAULT_CONFIG.replace(block=8, chunk_blocks=4)
X = np.random.default_rng(1).uniform(-1, 1, (16, 2)).astype(np.float32)


@pytest.fixture(autouse=True)
def fresh_cache():
    P.clear_compile_cache()
    yield
    P.clear_compile_cache()


def _numpy(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.fixture(scope="module")
def both():
    """(reference fn, port fn) of one SIREN with the reference's weights."""
    jcfg = JSirenConfig(hidden_features=16, hidden_layers=1)
    p = j_siren_init(jcfg, jax.random.PRNGKey(0))
    tcfg = SirenConfig(hidden_features=16, hidden_layers=1)
    return j_siren_fn(jcfg, p), siren_fn(tcfg, params_from_jax(_numpy(p)))


def _run(cg, x):
    run, _ = codegen.load_generated(cg.source)
    return run(codegen.graph_consts(cg.graph, cg.plan), x)


def _run_ref(jcg, x):
    run, _ = jcodegen.load_generated(jcg.source)
    return run(jcodegen.graph_consts(jcg.graph, jcg.plan), jnp.asarray(x))


# ---------------------------------------------------------------------------
# the emitted module against the executor and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("fuse", [True, False])
def test_codegen_equals_executor_and_matches_reference(both, order, fuse):
    jf, tf = both
    x = torch.from_numpy(X)
    cfg = HW.replace(fuse_regions=fuse)
    cg = P.compile_gradient(tf, order, x, config=cfg, device="cpu")
    got = _run(cg, x)
    assert len(got) == len(cg.graph.outputs)
    for a, b in zip(got, cg.apply_batched(x)):
        assert torch.equal(a, b)
    ex = streaming_executor(cg.graph, config=cfg, device="cpu")(x)
    for a, b in zip(got, ex):
        assert torch.equal(a, b)
    jcg = JP.compile_gradient(jf, order, jnp.asarray(X),
                              config=JHW.replace(fuse_regions=fuse))
    want = _run_ref(jcg, X)
    assert len(want) == len(got)
    for a, b in zip(got, want):
        _close_scaled(a.numpy(), np.asarray(b))


def test_codegen_on_a_filter_bank(both):
    """A bank's merged multi-output graph (Concat, Slice, ReLU heads):
    the module equals the bank's serving and the reference's module."""
    jf, tf = both
    icfg = JInspConfig(hidden=8, layers=2, grad_order=2)
    nf = num_features(2, 1, 2)
    psis = [jinsp.insp_init(icfg, nf, 1, jax.random.PRNGKey(i + 1))
            for i in range(3)]
    x = torch.from_numpy(X)
    bank = P.compile_bank(tf, [insp.insp_head(insp.params_from_jax(
        _numpy(p))) for p in psis], 2, x, config=HW, device="cpu")
    got = _run(bank.cg, x)
    assert len(got) == 3
    for a, b in zip(got, bank.apply_batched(x)):
        assert torch.equal(a, b)
    jbank = JP.compile_bank(jf, [jinsp.insp_head(p) for p in psis], 2,
                            jnp.asarray(X), config=JHW)
    for a, b in zip(got, _run_ref(jbank.cg, X)):
        _close_scaled(a.numpy(), np.asarray(b))


def test_emitted_source_imports_torch_only(both):
    _, tf = both
    cg = P.compile_gradient(tf, 2, torch.from_numpy(X), config=HW,
                            device="cpu")
    imports = [ln for ln in cg.source.splitlines()
               if ln.startswith(("import ", "from "))]
    assert imports == ["import torch", "import torch.nn.functional as F"]
    assert "jax" not in cg.source and "jnp" not in cg.source
    assert cg.source.startswith(codegen.SOURCE_HEADER)
    _, ns = codegen.load_generated(cg.source)
    assert ns["BLOCK"] == 8 and ns["BATCH"] == 16
    assert ns["HARDWARE_CONFIG"] == cg.config.as_dict()


def test_no_source_without_emit(both):
    _, tf = both
    cg = P.compile_gradient(tf, 1, torch.from_numpy(X), config=HW,
                            device="cpu")
    back = P.compile_from_graph(cg.graph, config=cg.config, order=1,
                                emit_source=False, device="cpu")
    assert back.source is None and back.perf_model == cg.perf_model


# ---------------------------------------------------------------------------
# the header and layout, on reference graphs copied node by node
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_graphs():
    cfg = JSirenConfig(hidden_features=16, hidden_layers=1)
    f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
    return {order: j_trace_graph(f, order, 16, (16, 2), "float32")
            for order in (1, 2, 3)}


def _header(src):
    lines = src.splitlines()
    end = lines.index('"""', 1)
    return lines[1:end]


def _layout(src):
    """The module-level names and every unit's signature line."""
    return [ln for ln in src.splitlines()
            if ln.startswith(("def ", "BLOCK", "BATCH", "HARDWARE_CONFIG",
                              "_RESIDENT_IDS"))]


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("conf", [dict(), dict(fuse_regions=False),
                                  dict(use_pallas=False)])
def test_header_and_layout_match_reference(ref_graphs, order, conf):
    gj = ref_graphs[order]
    g = port_graph(gj)
    depths = {0: 3, 1: 2, 5: 7}
    src = codegen.emit_python(g, config=HW.replace(**conf), depths=depths)
    jsrc = jcodegen.emit_python(gj, config=JHW.replace(**conf),
                                depths=depths)
    assert _header(src) == _header(jsrc)
    assert _header(src)[-1] == "optimized FIFO sum-depth: 12 blocks"
    port_defs = _layout(src)
    assert [ln for ln in _layout(jsrc) if ln != "def _bshape(shape, ref):"] \
        == [ln for ln in port_defs
            if not ln.startswith(("def _bshape", "def _broadcast_in_dim",
                                  "def _slice", "def _pad", "def _rows"))]


# ---------------------------------------------------------------------------
# the op set
# ---------------------------------------------------------------------------

def _unary_graph(mod, op):
    g = mod.ComputeGraph()
    x = g.add("Input", (8, 4), "float32", params=(("idx", 0),))
    y = g.add(op, (8, 4), "float32", (x,))
    g.outputs = [y]
    return g


@pytest.mark.parametrize("op", ["Sign", "Erf", "Gt"])
def test_codegen_raises_where_the_reference_does(op):
    for mod, cg in ((tgraph, codegen), (jgraph, jcodegen)):
        with pytest.raises(NotImplementedError, match=f"codegen: {op}"):
            cg.emit_python(_unary_graph(mod, op), config=HW)


@pytest.mark.parametrize("op", ["Sin", "Tanh", "Sigmoid", "Abs", "Exp"])
def test_codegen_unary_ops_run(op):
    g = _unary_graph(tgraph, op)
    run, _ = codegen.load_generated(codegen.emit_python(g, config=HW))
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0.1, 1, (8, 4)).astype(np.float32))
    out, = run([], x)
    want, = streaming_executor(g, config=HW, device="cpu")(x)
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_store_writes_and_restores_source(both, tmp_path):
    _, tf = both
    cg = P.compile_gradient(tf, 2, torch.from_numpy(X), config=HW,
                            device="cpu")
    store = ArtifactStore(tmp_path)
    sig = store.put(cg)
    path = os.path.join(tmp_path, sig, "source.py")
    with open(path) as f:
        assert f.read() == cg.source
    back = store.load(sig, device="cpu")
    assert back.source == cg.source and back.provenance == "store"
    x = torch.from_numpy(X)
    for a, b in zip(_run(back, x), cg.apply(x)):
        assert torch.equal(a, b)


def test_reference_entry_restores_without_exec(both, tmp_path, monkeypatch):
    """An entry the reference wrote carries a JAX ``source.py``: the port
    restores it (autoconfig record and all), never execs that file and
    leaves ``source`` unset."""
    jf, _ = both
    jcg = JP.compile_gradient(jf, 1, jnp.asarray(X), config="auto")
    sig = JArtifactStore(tmp_path).put(jcg)
    with open(os.path.join(tmp_path, sig, "source.py")) as f:
        assert "import jax" in f.read()
    ran = []
    real_exec = builtins.exec

    def spy(code, *a, **k):
        ran.append(getattr(code, "co_filename", code))
        return real_exec(code, *a, **k)

    monkeypatch.setattr(builtins, "exec", spy)
    cg = ArtifactStore(tmp_path).load(sig, device="cpu")
    monkeypatch.undo()
    assert not any("inr-arch-codegen" in str(c) or "import jax" in str(c)
                   for c in ran)
    assert cg.source is None
    assert cg.autoconfig is not None and cg.provenance == "store"
    x = torch.from_numpy(X)
    for a, b in zip(cg.apply_batched(x), jcg.apply_batched(jnp.asarray(X))):
        _close_scaled(a.numpy(), np.asarray(b))
