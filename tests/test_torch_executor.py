"""The port's executors against the reference's on the same graphs.

``reference_executor`` and the block pipeline (``compile_from_graph`` ->
``apply``) of the port run the reference's own gradient graphs, copied into
the port's IR, and must agree with the reference executor; a hand-built
graph holds ``_eval_node`` to lax semantics for Pad (lo/hi/interior),
Broadcast (broadcast_in_dim), strided Slice and the other structural ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import executor as jex
from repro.core.graph import ComputeGraph as JComputeGraph
from repro.core.pipeline import _trace_graph as j_trace_graph
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro_torch.core import executor as tex
from repro_torch.core.config import HardwareConfig
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.pipeline import compile_from_graph

from test_torch_planner import port_graph


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def graphs():
    cfg = JSirenConfig(hidden_features=64, hidden_layers=2)
    f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
    x = np.random.default_rng(0).uniform(-1, 1, (64, 2)).astype(np.float32)
    return x, {order: j_trace_graph(f, order, 64, (64, 2), "float32")
               for order in (1, 2, 3)}


@pytest.mark.parametrize("order", [1, 2, 3])
def test_reference_executor_matches(graphs, order):
    x, gs = graphs
    want = jex.reference_executor(gs[order])(jnp.asarray(x))
    got = tex.reference_executor(port_graph(gs[order]))(torch.from_numpy(x))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, 1e-4)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("conf", [
    dict(use_pallas=True),                        # fused regions
    dict(use_pallas=True, fuse_regions=False),    # per-segment kernels
    dict(use_pallas=False),                       # node-by-node interpreter
])
def test_block_pipeline_matches(graphs, order, conf):
    """The port's block pipeline over the reference graph == the reference
    executor (fused, per-segment and interpreted dispatch)."""
    x, gs = graphs
    want = jex.reference_executor(gs[order])(jnp.asarray(x))
    cg = compile_from_graph(port_graph(gs[order]),
                            config=HardwareConfig(block=8, **conf),
                            device="cpu")
    if conf.get("use_pallas") and conf.get("fuse_regions", True):
        assert cg.region_plan.fused_regions()
    got = cg.apply(torch.from_numpy(x))
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


def _structural_graph(G):
    """A graph of the ops the SIREN path rarely shows, built in either IR
    (``G`` is the reference's or the port's ComputeGraph class)."""
    g = G()
    x = g.add("Input", (4, 3), "float32", params=(("idx", 0),))
    zero = g.add("Const", (), "float32", const=np.asarray(0.5, np.float32))
    row = g.add("Const", (3,), "float32",
                const=np.asarray([1.0, -2.0, 3.0], np.float32))
    pad = g.add("Pad", (4, 7), "float32", (x, zero),
                (("padding_config", ((0, 0, 0), (1, 1, 1))),))
    crop = g.add("Pad", (4, 2), "float32", (x, zero),
                 (("padding_config", ((0, 0, 0), (0, -1, 0))),))
    bc = g.add("Broadcast", (1, 3), "float32", (row,),
               (("broadcast_dimensions", (1,)), ("shape", (1, 3))))
    bc0 = g.add("Broadcast", (4, 3), "float32", (row,),
                (("broadcast_dimensions", (1,)), ("shape", (4, 3))))
    add = g.add("Add", (4, 3), "float32", (x, bc))
    sl = g.add("Slice", (4, 4), "float32", (pad,),
               (("start_indices", (0, 1)), ("limit_indices", (4, 7)),
                ("strides", (1, 2))))
    iota = g.add("Iota", (4, 3), "int32", (),
                 (("dimension", 1), ("shape", (4, 3))))
    cv = g.add("Convert", (4, 3), "float32", (iota,),
               (("new_dtype", "float32"),))
    sq = g.add("IntPow", (4, 3), "float32", (add,), (("y", 3),))
    s = g.add("Sum", (4,), "float32", (sq,), (("axes", (1,)),))
    cat = g.add("Concat", (4, 6), "float32", (add, cv),
                (("dimension", 1),))
    mx = g.add("Maximum", (4, 3), "float32", (x, bc0))
    r = g.add("Reshape", (2, 6), "float32", (mx,), (("new_sizes", (2, 6)),))
    g.outputs = [pad, crop, sl, s, cat, r]
    return g


def test_eval_node_keeps_lax_semantics():
    x = np.random.default_rng(1).uniform(-1, 1, (4, 3)).astype(np.float32)
    want = jex.reference_executor(_structural_graph(JComputeGraph))(
        jnp.asarray(x))
    got = tex.reference_executor(_structural_graph(ComputeGraph))(
        torch.from_numpy(x))
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, 1e-6)


def test_broadcast_and_slice_take_the_block_override():
    """Inside a block, Broadcast's and Slice's batch dim follow the block
    (``block_b``), as in the reference interpreter."""
    g = _structural_graph(ComputeGraph)
    gj = _structural_graph(JComputeGraph)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 7)).astype(np.float32)
    for nid in [i for i, n in g.nodes.items()
                if n.op in ("Slice", "Broadcast")]:
        n, m = g.nodes[nid], gj.nodes[nid]
        arg = x if n.op == "Slice" else np.asarray([1.0, -2.0, 3.0],
                                                   np.float32)
        got = tex._eval_node(n, [torch.from_numpy(arg)], block_b=2)
        want = jex._eval_node(m, [jnp.asarray(arg)], block_b=2)
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, 0)
