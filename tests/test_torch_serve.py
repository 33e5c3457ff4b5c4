"""The port's ServingEngine against the reference's.

Both engines get the same SIRENs (``params_from_jax`` on the reference's
``siren_init`` weights) and the same requests, made with numpy; outputs are
held to each other at ``rtol=1e-5, atol=1e-6`` (the reference's own engine
tests hold the engine to per-INR serving there), and the grouping stats
must be equal.  The port's engine serves multi-INR groups through the
stacked region path where the plan is all regions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import pipeline as jpipeline
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import trace
from repro_torch.core.config import HardwareConfig
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.obs.tracing import TRACER
from repro_torch.serve import ServingEngine, bind_weights
from repro_torch.serve.engine import _FreqCache, _LRU

STATS = ("groups", "multi_groups", "requests", "rows", "padded_rows")


def _pair(hidden, seed):
    """(reference fn, port fn) of one SIREN."""
    cfg = JSirenConfig(hidden_features=hidden, hidden_layers=1)
    p = j_siren_init(cfg, jax.random.PRNGKey(seed))
    tcfg = SirenConfig(hidden_features=hidden, hidden_layers=1)
    tp = params_from_jax([{k: np.asarray(v) for k, v in q.items()}
                          for q in p])
    return j_siren_fn(cfg, p), siren_fn(tcfg, tp), p, tp


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).uniform(-1, 1, (16, 2)).astype(
        np.float32)


@pytest.fixture(autouse=True)
def fresh_cache():
    tpipeline.clear_compile_cache()
    yield
    tpipeline.clear_compile_cache()


def _compile(pair, order, x):
    jf, tf = pair[:2]
    return (jpipeline.compile_gradient(jf, order, jnp.asarray(x)),
            tpipeline.compile_gradient(tf, order, torch.from_numpy(x),
                                       config=HardwareConfig(block=8),
                                       device="cpu"))


def _assert_outs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_engine_groups_and_preserves_request_order(x, tmp_path):
    """Three INRs of one architecture and one of another: two signature
    groups, the three-INR group multi-INR, one INR named twice."""
    pairs = [_pair(16, k) for k in range(3)] + [_pair(8, 5)]
    ids = ["inr0", "inr1", "inr2", "other"]
    ref = JServingEngine(tmp_path / "ref")
    port = ServingEngine(tmp_path / "port", device="cpu")
    for inr_id, pair in zip(ids, pairs):
        jcg, tcg = _compile(pair, 2, x)
        ref.register(inr_id, jcg)
        port.register(inr_id, tcg)
    q = np.random.default_rng(11).uniform(-1, 1, (19, 2)).astype(np.float32)
    reqs = [("inr1", q[:5]), ("other", q), ("inr0", q[:13]),
            ("inr1", q[5:]), ("inr2", q[:7])]
    want = ref.serve([(i, jnp.asarray(c)) for i, c in reqs])
    got = port.serve([(i, torch.from_numpy(c)) for i, c in reqs])
    assert len(got) == len(reqs)
    for a, b in zip(got, want):
        _assert_outs(a, b)
    assert {k: port.stats[k] for k in STATS} == \
        {k: ref.stats[k] for k in STATS}
    assert port.stats["groups"] == 2 and port.stats["multi_groups"] == 1
    sig = port._routes["inr0"][0]
    assert port._multi_artifact(sig, ("inr1", "inr0", "inr2")).double_buffered


def test_engine_serves_zero_row_requests_in_multi_groups(x, tmp_path):
    pairs = [_pair(16, 0), _pair(16, 21)]
    ref = JServingEngine(tmp_path / "ref")
    port = ServingEngine(tmp_path / "port", device="cpu")
    for inr_id, pair in zip("ab", pairs):
        jcg, tcg = _compile(pair, 1, x)
        ref.register(inr_id, jcg)
        port.register(inr_id, tcg)
    q = np.random.default_rng(22).uniform(-1, 1, (9, 2)).astype(np.float32)
    want = ref.serve([("a", jnp.asarray(q[:0])), ("b", jnp.asarray(q))])
    got = port.serve([("a", torch.from_numpy(q[:0])),
                      ("b", torch.from_numpy(q))])
    assert all(o.shape[0] == 0 for o in got[0])
    for a, b in zip(got, want):
        _assert_outs(a, b)
    assert {k: port.stats[k] for k in STATS} == \
        {k: ref.stats[k] for k in STATS}


def test_engine_k1_non_base_weight_id(x, tmp_path):
    """A group of one INR whose weights are not the base artifact's runs
    the K = 1 multi-INR path with that INR's payload, no recompile."""
    p0, p1 = _pair(16, 0), _pair(16, 3)
    _, base = _compile(p0, 2, x)
    port = ServingEngine(tmp_path / "port", device="cpu")
    sig, _ = port.register("a", base)
    port.store.put_weights(sig, "bw", bind_weights(base, p0[3], p1[3]))
    port.register("b", signature=sig, weight_id="bw")
    q = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (13, 2)).astype(np.float32))
    traces = trace.TRACE_CALLS
    out, = port.serve([("b", q)])
    assert trace.TRACE_CALLS == traces
    _, want_cg = _compile(p1, 2, x)
    for a, b in zip(out, want_cg.apply_batched(q)):
        assert torch.equal(a, b)
    assert port.stats["multi_groups"] == 0 and port.stats["groups"] == 1
    assert port.stats["padded_rows"] == 3


def test_engine_cold_starts_from_store_alone(x, tmp_path):
    pairs = [_pair(16, k) for k in range(2)]
    writer = ServingEngine(tmp_path / "store", device="cpu")
    sig = None
    for k, pair in enumerate(pairs):
        sig, _ = writer.register(f"inr{k}", _compile(pair, 2, x)[1])
    q = torch.from_numpy(np.random.default_rng(12).uniform(
        -1, 1, (9, 2)).astype(np.float32))
    want = writer.serve([("inr0", q), ("inr1", q)])

    tpipeline.clear_compile_cache()
    t0 = trace.TRACE_CALLS
    replica = ServingEngine(tmp_path / "store", device="cpu")
    for k in range(2):
        replica.register(f"inr{k}", signature=sig, weight_id=f"inr{k}")
    got = replica.serve([("inr0", q), ("inr1", q)])
    assert trace.TRACE_CALLS == t0, "replica serving must not trace"
    assert replica.stats["restores"] == 1
    for a, b in zip(want, got):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(KeyError):
        replica.register("nope", signature=sig, weight_id="missing")


def test_freq_cache_protects_hot_payloads():
    """Eviction ranks by hit count (ties: least recently used), so a scan
    of cold keys cannot flush the hot warm set the way pure LRU would."""
    c = _FreqCache(3)
    c.put("hot", 0)
    for _ in range(5):
        assert c.get("hot") == 0
    for i in range(10):
        c.put(f"cold{i}", i)
    assert "hot" in c
    assert len(c) == 3
    assert set(c) == {"hot", "cold8", "cold9"}
    assert set(c.hits) == set(c)
    lru = _LRU(2)
    assert [lru.put(k, k) for k in "abc"] == [0, 0, 1]
    assert list(lru) == ["b", "c"]
    assert lru.put("d", 4, evictable=False) == 0 and len(lru) == 3


def test_warm_hits_metric_counts_payload_cache_hits(x):
    """Serving a non-base weight set reads the payload cache; repeat stack
    builds hit the warm entry and the warm_hits counter sees them."""
    _, cg = _compile(_pair(16, 0), 1, x)
    e = ServingEngine(multi_cache=1, device="cpu")
    e.register("a", cg)
    e.register("b", cg, weight_id="bw")
    e.register("c", cg, weight_id="cw")
    q = torch.from_numpy(x[:8])
    assert e.stats["warm_hits"] == 0
    e.serve([("b", q)])                     # builds the (bw,) stack
    h1 = e.stats["warm_hits"]
    assert h1 >= 1
    e.serve([("c", q)])                     # evicts it (multi_cache=1) ...
    e.serve([("b", q)])                     # ... so the rebuild hits again
    assert e.stats["warm_hits"] > h1
    assert e.stats["multi_evictions"] >= 1


def test_engine_phases_are_spans(x):
    _, cg = _compile(_pair(16, 0), 1, x)
    e = ServingEngine(device="cpu")
    e.register("a", cg)
    with TRACER.enabled_scope():
        TRACER.clear()
        e.serve([("a", torch.from_numpy(x))])
        names = TRACER.span_names()
    for name in ("serve.group", "serve.pad", "serve.dispatch",
                 "serve.unpad"):
        assert name in names
    assert e.stats["device_exec_s"] > 0 and "ServingEngine" in e.describe()


def test_engine_unported_options_raise():
    with pytest.raises(NotImplementedError, match="item 12"):
        ServingEngine(sharding=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        ServingEngine(shard_chunking=True, device="cpu")
    # filter banks are ported: a bank route needs a bank or a signature
    with pytest.raises(ValueError, match="a bank or a signature"):
        ServingEngine(device="cpu").register_bank(["f0"])
    with pytest.raises(ValueError):
        ServingEngine(device="cpu").register("a")
    with pytest.raises(KeyError):
        ServingEngine(device="cpu").serve([("nope", np.zeros((1, 2)))])
