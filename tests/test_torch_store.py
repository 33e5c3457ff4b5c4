"""The port's ArtifactStore, checkpoint layer and store-backed compile.

The port keeps the reference's on-disk layout (DESIGN.md §6): an artifact
the reference wrote restores into the port by signature with zero tracer
calls and serves what the reference serves (``rtol=1e-5, atol=1e-6``, the
tolerance of the reference's multi-INR test); a port round trip is exact
(``torch.equal``); and weights written by either checkpoint layer restore
in the other.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import pipeline as jpipeline
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro.serve import ArtifactStore as JArtifactStore
from repro.serve.store import graph_from_json as j_graph_from_json
from repro_torch.checkpoint import ckpt
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import trace
from repro_torch.core.config import HardwareConfig
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.serve import (ArtifactStore, MultiINRArtifact,
                               arch_signature, bind_weights, fn_fingerprint)
from repro_torch.serve.store import graph_to_json


@pytest.fixture(scope="module")
def siren16():
    """(reference cfg, reference params, port cfg, port params, x)."""
    cfg = JSirenConfig(hidden_features=16, hidden_layers=1)
    params = j_siren_init(cfg, jax.random.PRNGKey(0))
    tcfg = SirenConfig(hidden_features=16, hidden_layers=1)
    x = np.random.default_rng(1).uniform(-1, 1, (16, 2)).astype(np.float32)
    return cfg, params, tcfg, _port_params(params), x


def _port_params(params):
    return params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                            for p in params])


@pytest.fixture(autouse=True)
def fresh_cache():
    tpipeline.clear_compile_cache()
    yield
    tpipeline.clear_compile_cache()


def _compile(tcfg, params, order, x, **kw):
    return tpipeline.compile_gradient(siren_fn(tcfg, params), order,
                                      torch.from_numpy(x),
                                      config=HardwareConfig(block=8),
                                      device="cpu", **kw)


def test_signature_is_weight_independent(siren16):
    cfg, _, tcfg, tp, x = siren16
    a = _compile(tcfg, tp, 1, x)
    b = _compile(tcfg, _port_params(j_siren_init(cfg, jax.random.PRNGKey(7))),
                 1, x)
    assert a is not b and a.signature == b.signature
    assert arch_signature(a.graph, 1, a.config) == a.signature
    assert _compile(tcfg, tp, 2, x).signature != a.signature
    c = tpipeline.compile_gradient(siren_fn(tcfg, tp), 1, torch.from_numpy(x),
                                   config=HardwareConfig(block=4),
                                   device="cpu")
    assert c.signature != a.signature


def test_fn_fingerprint_tracks_weights_not_identity(siren16):
    cfg, _, tcfg, tp, _ = siren16
    f = siren_fn(tcfg, tp)
    # a NEW module over the SAME weights fingerprints identically (what
    # lets a fresh process hit the disk index); other weights do not
    assert fn_fingerprint(f) is not None
    assert fn_fingerprint(f) == fn_fingerprint(
        siren_fn(tcfg, [{k: v.clone() for k, v in p.items()} for p in tp]))
    other = _port_params(j_siren_init(cfg, jax.random.PRNGKey(7)))
    assert fn_fingerprint(f) != fn_fingerprint(siren_fn(tcfg, other))
    # a plain function closing over tensors is fingerprinted the same way
    w = torch.arange(4.0)
    g1 = (lambda w: lambda x: x * w)(w)
    g2 = (lambda w: lambda x: x * w)(w.clone())
    g3 = (lambda w: lambda x: x * w)(w + 1)
    assert fn_fingerprint(g1) == fn_fingerprint(g2) != fn_fingerprint(g3)


def test_fn_fingerprint_sees_module_globals():
    """A changed module-level constant or helper must change the key."""
    mod = types.ModuleType("fp_probe")
    exec("G = 1.0\ndef f(x):\n    return x * G\n", mod.__dict__)
    before = fn_fingerprint(mod.f)
    mod.G = 2.0
    assert before is not None and fn_fingerprint(mod.f) != before


@pytest.mark.parametrize("order", [1, 2, 3])
def test_store_round_trip_is_exact(siren16, tmp_path, order):
    _, _, tcfg, tp, x = siren16
    cg = _compile(tcfg, tp, order, x, store=ArtifactStore(tmp_path / "s"))
    q = torch.from_numpy(np.random.default_rng(order).uniform(
        -1, 1, (13, 2)).astype(np.float32))
    want = cg.apply_batched(q)
    tpipeline.clear_compile_cache()
    t0 = trace.TRACE_CALLS
    restored = ArtifactStore(tmp_path / "s").load(cg.signature,
                                                  device="cpu")
    assert trace.TRACE_CALLS == t0
    assert restored.provenance == "store" and restored.order == order
    assert restored.config == cg.config
    assert restored.signature == cg.signature
    got = restored.apply_batched(q)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_three_level_lookup(siren16, tmp_path):
    _, _, tcfg, tp, x = siren16
    store = ArtifactStore(tmp_path / "s")
    f = siren_fn(tcfg, tp)
    xt = torch.from_numpy(x)
    cfg = HardwareConfig(block=8)
    cg = tpipeline.compile_gradient(f, 2, xt, config=cfg, store=store,
                                    device="cpu")
    assert cg.provenance == "trace"
    info = tpipeline.compile_cache_info()
    assert info["store_misses"] == 1 and info["store_puts"] == 1
    # level 1: in-process hit (same object, no store traffic)
    assert tpipeline.compile_gradient(f, 2, xt, config=cfg, store=store,
                                      device="cpu") is cg
    assert tpipeline.compile_cache_info()["store_hits"] == 0
    # level 2: disk hit in a "fresh replica" (cleared in-process cache, a
    # new module over the same weights, a new store handle)
    tpipeline.clear_compile_cache()
    t0 = trace.TRACE_CALLS
    replica = siren_fn(tcfg, [{k: v.clone() for k, v in p.items()}
                              for p in tp])
    cg2 = tpipeline.compile_gradient(replica, 2, xt, config=cfg,
                                     store=ArtifactStore(tmp_path / "s"),
                                     device="cpu")
    assert cg2.provenance == "store" and cg2.signature == cg.signature
    assert trace.TRACE_CALLS == t0, "disk hit must not trace"
    assert tpipeline.compile_cache_info()["store_hits"] == 1
    assert tpipeline.compile_gradient(replica, 2, xt, config=cfg,
                                      device="cpu") is cg2
    # a store handed to an in-process hit late still ends up populated
    late = ArtifactStore(tmp_path / "late")
    tpipeline.compile_gradient(replica, 2, xt, config=cfg, store=late,
                               device="cpu")
    assert late.signatures() == [cg.signature]


@pytest.mark.parametrize("order", [1, 2])
def test_reference_artifact_restores_into_port(siren16, tmp_path, order):
    """The reference writes an artifact (graph JSON + weight payload); the
    port restores it by signature alone and serves what the reference's
    restore serves."""
    cfg, params, _, _, x = siren16
    jcg = jpipeline.compile_gradient(j_siren_fn(cfg, params), order,
                                     jnp.asarray(x),
                                     store=JArtifactStore(tmp_path / "s"))
    q = np.random.default_rng(5 + order).uniform(-1, 1, (21, 2)).astype(
        np.float32)
    want = jcg.apply_batched(jnp.asarray(q))
    t0 = trace.TRACE_CALLS
    store = ArtifactStore(tmp_path / "s")
    assert store.signatures() == [jcg.signature]
    cg = store.load(jcg.signature, device="cpu")
    assert trace.TRACE_CALLS == t0
    assert cg.signature == jcg.signature and cg.provenance == "store"
    got = cg.apply_batched(torch.from_numpy(q))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_port_layout_reads_in_the_reference(siren16, tmp_path):
    """Same layout: the port's graph.json and weight checkpoints read back
    through the reference's own readers."""
    _, _, tcfg, tp, x = siren16
    store = ArtifactStore(tmp_path / "s")
    cg = _compile(tcfg, tp, 2, x)
    sig = store.put(cg, inr_id="base")
    entry = tmp_path / "s" / sig
    assert {"meta.json", "graph.json", "weights"} <= set(os.listdir(entry))
    doc = graph_to_json(cg.graph)
    consts = store.load_weights(sig, "base")
    g = j_graph_from_json(doc, consts)
    assert sorted(g.nodes) == sorted(cg.graph.nodes)
    template = {f"n{nid}": 0 for nid in consts}
    flat, _ = jckpt.restore(template, str(entry / "weights" / "base"))
    for nid, v in consts.items():
        np.testing.assert_array_equal(np.asarray(flat[f"n{nid}"]), v)
    assert store.weight_ids(sig) == ["base"]
    assert store.info()["weight_sets"] == 1
    with pytest.raises(ValueError):
        store.put_weights(sig, "bad", {0: np.zeros(1)})
    with pytest.raises(ValueError):
        store.load(sig, inr_id="../escape", device="cpu")


def test_checkpoint_trees_cross_compatible(tmp_path):
    """Nested trees: port save -> reference restore, and back."""
    tree = {"layers": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                        "b": np.ones(3, np.float32)}],
            "step": np.int32(7)}
    ckpt.save({"layers": [{"w": torch.from_numpy(tree["layers"][0]["w"]),
                           "b": tree["layers"][0]["b"]}],
               "step": tree["step"]}, str(tmp_path / "port"), step=3)
    got, step = jckpt.restore(tree, str(tmp_path / "port"))
    assert step == 3
    np.testing.assert_array_equal(got["layers"][0]["w"],
                                  tree["layers"][0]["w"])
    jckpt.save(tree, str(tmp_path / "ref"), step=4)
    back, step = ckpt.restore(tree, str(tmp_path / "ref"))
    assert step == 4 and int(back["step"]) == 7
    np.testing.assert_array_equal(back["layers"][0]["b"],
                                  tree["layers"][0]["b"])
    path = tmp_path / "ref" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["leaves"]["step"]["sha1"] = "0" * 40       # a torn write
    path.write_text(json.dumps(manifest))
    with pytest.raises(IOError):
        ckpt.restore(tree, str(tmp_path / "ref"))


def test_put_async_then_restore(siren16, tmp_path):
    _, _, tcfg, tp, x = siren16
    store = ArtifactStore(tmp_path / "s")
    cg = _compile(tcfg, tp, 1, x)
    sig = store.put_async(cg, inr_id="a", request_key="rk")
    store.wait()
    assert store.lookup("rk") == (sig, "a")
    assert store.lookup("missing") is None
    assert store.stats["index_hits"] == 1 and store.stats["index_misses"] == 1
    restored = store.restore_request("rk", device="cpu")
    q = torch.from_numpy(x[:9])
    assert all(torch.equal(a, b) for a, b in
               zip(restored.apply_batched(q), cg.apply_batched(q)))


def test_multi_inr_from_store(siren16, tmp_path):
    """K = 8 stored weight sets through one stored artifact, stacked path,
    against each INR's own compile."""
    cfg, _, tcfg, tp, x = siren16
    K = 8
    params = [_port_params(j_siren_init(cfg, jax.random.PRNGKey(100 + k)))
              for k in range(K)]
    store = ArtifactStore(tmp_path / "s")
    base = _compile(tcfg, params[0], 2, x, store=store)
    for k in range(K):
        store.put_weights(base.signature, f"inr{k}",
                          bind_weights(base, params[0], params[k]))
    t0 = trace.TRACE_CALLS
    multi = MultiINRArtifact.from_store(store, base.signature,
                                        [f"inr{k}" for k in range(K)],
                                        device="cpu")
    assert trace.TRACE_CALLS == t0 and multi.double_buffered
    q = torch.from_numpy(np.random.default_rng(9).uniform(
        -1, 1, (13, 2)).astype(np.float32))
    outs = multi.apply_batched(q)
    for k in range(K):
        want = _compile(tcfg, params[k], 2, x).apply_batched(q)
        for a, b in zip(want, outs):
            assert tuple(b.shape) == (K,) + tuple(a.shape)
            assert torch.equal(a, b[k])
