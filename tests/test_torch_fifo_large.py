"""The FIFO-depth search of the largest design in ``test_torch_dataflow``
(hidden 64 / 2 layers, order 3, unfused, ``dataflow_block`` 8: ~100k steps,
about a minute a side in pure Python), held to the reference's result field
by field.  It sits in a file of its own so that a parallel run gives it its
own worker; ``test_torch_dataflow`` compares this case's design and
analyses and every other case's search."""

import dataclasses

import jax

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import config as jconfig
from repro.core import dataflow as jdataflow
from repro.core import fifo_opt as jfifo
from repro.core import segment as jsegment
from repro.core.pipeline import _trace_graph as j_trace_graph
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro_torch.core import config as tconfig
from repro_torch.core import dataflow as tdataflow
from repro_torch.core import fifo_opt as tfifo
from repro_torch.core import segment as tsegment
from test_torch_planner import port_graph


def test_largest_fifo_optimisation_matches_reference():
    cfg = JSirenConfig(hidden_features=64, hidden_layers=2)
    f = j_siren_fn(cfg, j_siren_init(cfg, jax.random.PRNGKey(0)))
    gj = j_trace_graph(f, 3, 64, (64, 2), "float32")
    g = port_graph(gj)
    kw = dict(use_pallas=True, fuse_regions=False, dataflow_block=8)
    jc, tc = jconfig.HardwareConfig(**kw), tconfig.HardwareConfig(**kw)
    dj = jdataflow.map_to_dataflow(
        gj, plan=jsegment.build_segment_plan(gj, config=jc), config=jc)
    dt = tdataflow.map_to_dataflow(
        g, plan=tsegment.build_segment_plan(g, config=tc), config=tc)
    want = jfifo.optimize_fifo_depths(dj, config=jc)
    got = tfifo.optimize_fifo_depths(dt, config=tc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    # the search does cut this design's depths
    assert want.sum_after < want.sum_before
