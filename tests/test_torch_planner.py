"""The port's copy of the planner against the reference planner.

A reference gradient graph (``repro.core.pipeline._trace_graph``, hidden 64,
2 layers, orders 1-3) is copied node by node into the port's ComputeGraph;
the port's ``optimize`` / ``build_segment_plan`` / ``build_region_plan``
must then produce exactly the reference's segments and region specs, under
the default config, without fusion, and under a budget tight enough to
column-tile.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import passes as jpasses
from repro.core.config import HardwareConfig as JHardwareConfig
from repro.core.pipeline import _trace_graph as j_trace_graph
from repro.core.regions import build_region_plan as j_build_region_plan
from repro.core.segment import build_segment_plan as j_build_segment_plan
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro_torch.core import passes
from repro_torch.core.config import HardwareConfig
from repro_torch.core.graph import ComputeGraph, Node
from repro_torch.core.regions import build_region_plan
from repro_torch.core.segment import build_segment_plan

CONFIGS = {
    "default": dict(use_pallas=True),
    "unfused": dict(use_pallas=True, fuse_regions=False),
    "tiled": dict(use_pallas=True, bn=32, vmem_budget=120_000),
    "sum": dict(use_pallas=True, region_packing="sum", vmem_budget=200_000),
}


def port_graph(gj) -> ComputeGraph:
    """The reference graph, node by node, in the port's IR."""
    g = ComputeGraph()
    for nid, n in gj.nodes.items():
        g.nodes[nid] = Node(n.id, n.op, n.shape, n.dtype, n.inputs, n.params,
                            None if n.const is None else np.array(n.const))
    g.outputs = list(gj.outputs)
    g._next = gj._next
    return g


@pytest.fixture(scope="module")
def ref_graphs():
    cfg = JSirenConfig(hidden_features=64, hidden_layers=2)
    f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
    wide = JSirenConfig(hidden_features=80, hidden_layers=1)
    fw = j_siren_fn(wide, j_siren_init(wide, jax.random.PRNGKey(0)))
    graphs = {order: j_trace_graph(f, order, 64, (64, 2), "float32")
              for order in (1, 2, 3)}
    graphs["wide2"] = j_trace_graph(fw, 2, 16, (16, 2), "float32")
    return graphs


def _plain(v):
    """Planner values with the port's and the reference's dataclasses
    (ChainSpec, RegionKernelSpec, TileGroup) reduced to tuples."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            _plain(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


def _segments(plan):
    return [(s.id, s.kind, s.nodes, s.stream_inputs, s.resident_inputs,
             _plain(s.meta)) for s in plan.segments]


def _regions(rplan):
    return [(r.id, r.segments, r.stream_inputs, r.broadcast_inputs,
             r.resident_inputs, r.outputs, r.bcast_rows, _plain(r.spec),
             dict(r.meta)) for r in rplan.regions]


@pytest.mark.parametrize("graph", [1, 2, 3, "wide2"])
@pytest.mark.parametrize("conf", sorted(CONFIGS))
def test_plans_match_reference(ref_graphs, graph, conf):
    gj = ref_graphs[graph]
    g = port_graph(gj)
    jc = JHardwareConfig(**CONFIGS[conf])
    tc = HardwareConfig(**CONFIGS[conf])
    pj = j_build_segment_plan(gj, config=jc)
    pt = build_segment_plan(g, config=tc)
    assert _segments(pt) == _segments(pj)
    assert (pt.resident, pt.rowconst, pt.inputs, pt.batch) == \
        (pj.resident, pj.rowconst, pj.inputs, pj.batch)
    assert [(e.src, e.dst, e.node) for e in pt.edges] == \
        [(e.src, e.dst, e.node) for e in pj.edges]
    rt, rj = build_region_plan(pt, tc), j_build_region_plan(pj, jc)
    assert _regions(rt) == _regions(rj)
    assert rt.counts() == rj.counts()
    if graph == "wide2" and conf == "tiled":
        assert any(r.spec.tile_groups for r in rt.fused_regions())


@pytest.mark.parametrize("order", [1, 2, 3])
def test_passes_match_reference(order):
    """The four optimization passes give the same graph on an unoptimized
    reference trace."""
    from repro.core.trace import extract_graph
    from repro.inr.gradnet import paper_gradients
    cfg = JSirenConfig(hidden_features=16, hidden_layers=1)
    f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
    x = jax.numpy.zeros((8, 2), jax.numpy.float32)
    gj = extract_graph(paper_gradients(f, order, 1, 2), x)
    g = port_graph(gj)
    rec_j, rec_t = [], []
    jpasses.optimize(gj, record=rec_j)
    passes.optimize(g, record=rec_t)
    assert rec_t == rec_j
    assert sorted(g.nodes) == sorted(gj.nodes)
    assert g.outputs == gj.outputs
    for nid, n in g.nodes.items():
        m = gj.nodes[nid]
        assert (n.op, n.shape, n.inputs, n.params) == \
            (m.op, m.shape, m.inputs, m.params)


def test_hardware_config_resolves_without_jax():
    cfg = HardwareConfig()
    assert cfg.use_pallas is None
    r = cfg.resolved()
    assert r.use_pallas is True
    assert r.resolved() is r                 # already concrete: no-op
    assert HardwareConfig(use_pallas=False).resolved().use_pallas is False
    assert HardwareConfig.from_dict(cfg.as_dict()) == cfg
