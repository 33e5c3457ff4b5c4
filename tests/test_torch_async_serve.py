"""The port's AsyncServingEngine against its own sync engine and against the
reference's AsyncServingEngine (DESIGN.md §8).

Counterparts of ``tests/test_async_serve.py`` (its one-device K-axis
sharding case is here; its two-device cases run on gloo ranks in
``test_torch_sharded_serve.py``).  Both packages
get the same SIRENs (``siren.params_from_jax`` on the reference's
``siren_init`` weights), the same INSP heads (``insp.params_from_jax``) and
the same requests, made with numpy.  On the CPU every kernel wrapper runs
its plain version, whose rows do not depend on a call's row count at these
sizes, so the port's ``serve_async`` is held ``torch.equal`` to its sync
``serve``; against the reference the outputs are held within 1e-4
(scaled), the reference's fp32 serving tolerance, and the engine's
grouping stats must be equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.siren import InspConfig as JInspConfig
from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import pipeline as JP
from repro.core.config import DEFAULT_CONFIG
from repro.inr import insp as jinsp
from repro.inr.gradnet import num_features
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro.serve import AsyncServingEngine as JAsyncServingEngine
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as P
from repro_torch.core.config import HardwareConfig
from repro_torch.inr import insp
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.serve import (AsyncServingEngine, MultiINRArtifact,
                               ServingEngine)
from repro_torch.serve.async_engine import _InFlight
from repro_torch.serve.multi_inr import const_payload
from repro_torch.distributed.sharding import ShardingPolicy
from test_torch_pipeline import _close_scaled
from test_torch_sharding import one_rank_mesh

HW = HardwareConfig(block=8, chunk_blocks=4)
JHW = DEFAULT_CONFIG.replace(block=8, chunk_blocks=4)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
# the engine stats both packages count the same way for one stream
STATS = ("requests", "submitted", "rows", "padded_rows", "async_chunks",
         "async_blocks", "async_multi_chunks", "admissions", "evictions",
         "bank_groups")


@pytest.fixture(autouse=True)
def fresh_cache():
    P.clear_compile_cache()
    yield
    P.clear_compile_cache()


def _numpy(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _pair(hidden, seed):
    """(reference fn, port fn) of one SIREN with the reference's weights."""
    jcfg = JSirenConfig(hidden_features=hidden, hidden_layers=1)
    p = j_siren_init(jcfg, jax.random.PRNGKey(seed))
    tcfg = SirenConfig(hidden_features=hidden, hidden_layers=1)
    return j_siren_fn(jcfg, p), siren_fn(tcfg, params_from_jax(_numpy(p)))


def _x(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 2)).astype(
        np.float32)


X16 = _x(16, 1)


@pytest.fixture(scope="module")
def fleet():
    """Four port INRs of one architecture + one of a second architecture,
    with the reference's functions for the same weights."""
    pairs = [_pair(16, k) for k in range(4)] + [_pair(24, 9)]
    P.clear_compile_cache()
    cgs = [P.compile_gradient(tf, 1, torch.from_numpy(X16), config=HW,
                              device="cpu") for _, tf in pairs]
    return pairs, cgs[:4], cgs[4]


def _register(engine, cgs, other):
    for k, cg in enumerate(cgs):
        engine.register(f"i{k}", cg)
    engine.register("w0", other)
    return engine


def _assert_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for a, b in zip(w, g):
            assert torch.equal(a, b)


def _mixed(seed, count=14):
    """Requests over the fleet with row counts spanning chunk boundaries,
    never a block multiple by design."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(count):
        inr = ["i0", "i1", "w0", "i2", "i0", "i3", "w0"][i % 7]
        reqs.append((inr, torch.from_numpy(
            _x(int(rng.integers(1, 75)), 200 + i))))
    return reqs


# ---------------------------------------------------------------------------
# async parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inflight", [1, 2, 3])
@pytest.mark.parametrize("seed", [3, 4])
def test_async_bit_identical_mixed_stream(fleet, tmp_path, inflight, seed):
    """serve_async over a mixed single/multi-INR stream returns results
    torch.equal to the sync path, in request order."""
    _, cgs, other = fleet
    sync = _register(ServingEngine(tmp_path / "s", device="cpu"), cgs, other)
    asyn = _register(AsyncServingEngine(tmp_path / "a", device="cpu",
                                        inflight=inflight), cgs, other)
    reqs = _mixed(seed)
    _assert_equal(sync.serve(reqs), asyn.serve_async(reqs))
    st = asyn.stats
    assert st["async_chunks"] + st["async_multi_chunks"] > 0
    assert 1 <= st["max_inflight"] <= asyn.inflight == inflight


def test_async_single_stream_coalesces_chunks(fleet, tmp_path):
    """Many small requests for ONE INR coalesce into full chunks: far fewer
    dispatches than requests, still torch.equal."""
    _, cgs, other = fleet
    sync = _register(ServingEngine(tmp_path / "s", device="cpu"), cgs, other)
    asyn = _register(AsyncServingEngine(tmp_path / "a", device="cpu"), cgs,
                     other)
    qs = [torch.from_numpy(_x(13, 300 + i)) for i in range(20)]
    want = sync.serve([("i0", q) for q in qs])   # 260 rows, chunk = 32
    tickets = [asyn.submit("i0", q) for q in qs]
    assert tickets == list(range(20))
    _assert_equal(want, asyn.drain())
    st = asyn.stats
    assert st["async_chunks"] == (20 * 13) // (HW.chunk_blocks * HW.block)
    assert st["async_chunks"] + st["async_blocks"] < len(qs)
    assert asyn.pending_rows() == 0


def test_mid_stream_admission_returns_in_order(fleet, tmp_path):
    """A request admitted mid-stream (after chunks of an earlier request
    already dispatched) joins the lane set at the next chunk boundary and
    still gets its results at its own ticket position."""
    _, cgs, other = fleet
    asyn = _register(AsyncServingEngine(tmp_path / "a", device="cpu"), cgs,
                     other)
    sync = _register(ServingEngine(tmp_path / "s", device="cpu"), cgs, other)
    q_big, q_mid, q_new = (torch.from_numpy(_x(n, s))
                           for n, s in ((90, 0), (17, 1), (21, 2)))
    t0 = asyn.submit("i0", q_big)      # full chunks dispatch immediately
    assert asyn.stats["async_chunks"] >= 1, "chunks dispatch before drain"
    t1 = asyn.submit("i1", q_mid)      # admitted mid-stream -> multi lanes
    t2 = asyn.submit("i0", q_new)
    assert (t0, t1, t2) == (0, 1, 2)
    got = asyn.drain()
    assert [g[0].shape[0] for g in got] == [90, 17, 21]
    want = sync.serve([("i0", q_big), ("i1", q_mid), ("i0", q_new)])
    _assert_equal(want, got)
    assert asyn.stats["admissions"] >= 2 and asyn.stats["evictions"] >= 2


def test_drain_is_incremental(fleet, tmp_path):
    """drain() returns only the tickets since the last drain; the engine
    is reusable across rounds."""
    _, cgs, other = fleet
    asyn = _register(AsyncServingEngine(tmp_path / "a", device="cpu"), cgs,
                     other)
    q = torch.from_numpy(_x(11, 4))
    asyn.submit("i0", q)
    assert len(asyn.drain()) == 1
    asyn.submit("i1", q)
    asyn.submit("i2", q)
    assert len(asyn.drain()) == 2
    assert asyn.drain() == []


def test_empty_request_and_serve_async_empty(fleet, tmp_path):
    """A zero-row request never reaches a lane yet still gets a
    well-formed 0-row result at its ticket position."""
    _, cgs, other = fleet
    asyn = _register(AsyncServingEngine(tmp_path / "a", device="cpu"), cgs,
                     other)
    sync = _register(ServingEngine(tmp_path / "s", device="cpu"), cgs, other)
    q0 = torch.zeros((0, 2))
    q1 = torch.from_numpy(_x(7, 5))
    # the empty request contributes no lane, so i1 serves alone
    want = sync.serve([("i0", q0)]) + sync.serve([("i1", q1)])
    got = asyn.serve_async([("i0", q0), ("i1", q1)])
    _assert_equal(want, got)
    assert got[0][0].shape[0] == 0
    assert asyn.serve_async([]) == []


def test_unregistered_and_bad_inflight(fleet):
    with pytest.raises(ValueError):
        AsyncServingEngine(inflight=0, device="cpu")
    asyn = AsyncServingEngine(device="cpu")
    with pytest.raises(KeyError):
        asyn.submit("nope", torch.zeros((3, 2)))


# ---------------------------------------------------------------------------
# LRU caches + perf counters
# ---------------------------------------------------------------------------

def test_engine_caches_are_lru_bounded(fleet, tmp_path):
    """_payloads/_multi evict past capacity (payloads only when a store can
    reload them) and count evictions in stats."""
    _, cgs, other = fleet
    e = _register(AsyncServingEngine(tmp_path / "s", payload_cache=3,
                                     multi_cache=2, device="cpu"),
                  cgs, other)
    assert len(e._payloads) <= 3
    assert e.stats["payload_evictions"] >= 2    # 5 registered, cap 3
    q = torch.from_numpy(_x(9, 6))
    # three distinct multi-lane sets -> the first stack is evicted
    for pair in (("i0", "i1"), ("i1", "i2"), ("i2", "i3")):
        e.serve_async([(i, q) for i in pair])
    assert len(e._multi) <= 2
    assert e.stats["multi_evictions"] >= 1
    # an evicted payload reloads from the store transparently
    out = e.serve_async([("i1", q)])
    assert out[0][0].shape[0] == 9
    assert e.registered() == ["i0", "i1", "i2", "i3", "w0"]


def test_payloads_not_evicted_without_store(fleet):
    """With no store attached an evicted payload would be the ONLY copy of
    the weights — the cache must grow instead."""
    _, cgs, _ = fleet
    e = AsyncServingEngine(payload_cache=2, device="cpu")
    for k, cg in enumerate(cgs):
        e.register(f"i{k}", cg)
    assert len(e._payloads) == 4 > e._payloads.cap
    assert e.stats["payload_evictions"] == 0


def test_perf_counters_populate(fleet, tmp_path):
    """Phase counters move on both paths and show in describe()."""
    _, cgs, other = fleet
    sync = _register(ServingEngine(tmp_path / "s", device="cpu"), cgs, other)
    asyn = _register(AsyncServingEngine(tmp_path / "a", device="cpu"), cgs,
                     other)
    q = torch.from_numpy(_x(40, 7))
    sync.serve([("i0", q), ("i1", q)])
    assert sync.stats["host_group_s"] > 0
    assert sync.stats["device_exec_s"] > 0
    assert sync.stats["queue_wait_s"] == 0, "sync path never queues"
    asyn.serve_async([("i0", q), ("i1", q)])
    assert asyn.stats["host_group_s"] > 0
    assert asyn.stats["queue_wait_s"] > 0
    assert asyn.stats["host_unpad_s"] > 0
    for text in (sync.describe(), asyn.describe()):
        assert "host_group" in text and "device_exec" in text \
            and "queue_wait" in text
    assert "async: inflight" in asyn.describe()


def test_k_sharding_not_ported_on_one_device(fleet):
    """Without a policy a stack reports ``k_sharded`` False and serves as
    the base does; on a one-rank mesh (``tests/test_async_serve.py``'s
    one-device case) the stack is K-sharded and the async engine under the
    policy serves bit for bit what it serves without one (the multi-rank
    cases are ``test_torch_sharded_serve.py``'s)."""
    _, cgs, other = fleet
    m = MultiINRArtifact(cgs[0], [const_payload(cgs[0])], ["a"])
    assert m.k_sharded is False
    q = torch.from_numpy(_x(9, 8))
    for a, b in zip(cgs[0].apply_batched(q), m.apply_batched(q)):
        assert torch.equal(a, b[0])
    with one_rank_mesh() as mesh:
        pol = ShardingPolicy(mesh)
        ms = MultiINRArtifact(cgs[0], [const_payload(cgs[0])], ["a"],
                              sharding=pol)
        assert ms.k_sharded             # 1 % 1 == 0: trivially sharded
        for a, b in zip(cgs[0].apply_batched(q), ms.apply_batched(q)):
            assert torch.equal(a, b[0])
        reqs = _mixed(5)
        plain = _register(AsyncServingEngine(device="cpu"), cgs, other)
        shard = _register(AsyncServingEngine(sharding=pol, device="cpu"),
                          cgs, other)
        _assert_equal(plain.serve_async(reqs), shard.serve_async(reqs))
        assert shard.stats["k_sharded_batches"] >= 1


# ---------------------------------------------------------------------------
# readiness and the in-flight bound
# ---------------------------------------------------------------------------

class _NeverReady:
    """An in-flight item whose device work never reports done."""

    def query(self):
        return False

    def synchronize(self):
        pass


def test_unready_item_is_not_polled_and_inflight_bounds_queue(fleet):
    """``_poll`` retires nothing while the front item's event reports not
    ready; the next dispatch must retire (wait on) the oldest item first so
    the queue never exceeds ``inflight``."""
    _, cgs, other = fleet
    asyn = _register(AsyncServingEngine(device="cpu", inflight=2), cgs,
                     other)
    stuck = [_InFlight("chunk", (), [], 0.0, 0, event=_NeverReady())
             for _ in range(2)]
    asyn._queue.extend(stuck)
    asyn._poll()
    assert list(asyn._queue) == stuck and not asyn._retired
    chunk_rows = HW.chunk_blocks * HW.block
    asyn.submit("i0", torch.from_numpy(_x(chunk_rows, 9)))
    assert len(asyn._queue) <= 2
    assert asyn._queue[0] is stuck[1], "the oldest item retired first"
    assert asyn.stats["max_inflight"] == 2
    # a CPU item carries no event and is always ready
    assert _InFlight("chunk", (), [], 0.0, 0).ready()


# ---------------------------------------------------------------------------
# against the reference's AsyncServingEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_fleet(fleet):
    pairs, _, _ = fleet
    xs = jnp.asarray(X16)
    cgs = [JP.compile_gradient(jf, 1, xs, config=JHW) for jf, _ in pairs]
    return cgs[:4], cgs[4]


def _to_jax(reqs):
    return [(i, jnp.asarray(c.numpy())) for i, c in reqs]


@pytest.mark.parametrize("mode", ["serve_async", "submit_drain"])
@pytest.mark.parametrize("seed", [3, 5])
def test_async_matches_reference_engine(fleet, ref_fleet, tmp_path, mode,
                                        seed):
    """The same stream through both packages' async engines: outputs within
    1e-4 (scaled), the grouping stats equal (``max_inflight`` may differ:
    the port flushes a lane's remainder in one pass)."""
    _, cgs, other = fleet
    jcgs, jother = ref_fleet
    port = _register(AsyncServingEngine(tmp_path / "p", device="cpu"), cgs,
                     other)
    ref = _register(JAsyncServingEngine(tmp_path / "r"), jcgs, jother)
    reqs = _mixed(seed, count=21)
    if mode == "serve_async":
        got, want = port.serve_async(reqs), ref.serve_async(_to_jax(reqs))
    else:
        for i, c in reqs:
            port.submit(i, c)
        for i, c in _to_jax(reqs):
            ref.submit(i, c)
        got, want = port.drain(), ref.drain()
    assert len(got) == len(want) == len(reqs)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _close_scaled(a.numpy(), np.asarray(b))
    assert {k: port.stats[k] for k in STATS} == \
        {k: ref.stats[k] for k in STATS}
    assert 1 <= port.stats["max_inflight"] <= port.inflight


# ---------------------------------------------------------------------------
# filter banks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bank_setup():
    jf, tf = _pair(16, 0)
    icfg = JInspConfig(hidden=8, layers=2, grad_order=1)
    nf = num_features(2, 1, 1)
    psis = [jinsp.insp_init(icfg, nf, 1, jax.random.PRNGKey(i + 1))
            for i in range(3)]
    x = torch.from_numpy(X16)
    P.clear_compile_cache()
    bank = P.compile_bank(tf, [insp.insp_head(insp.params_from_jax(
        _numpy(p))) for p in psis], 1, x, config=HW, device="cpu")
    cg = P.compile_gradient(tf, 1, x, config=HW, device="cpu")
    jx = jnp.asarray(X16)
    jbank = JP.compile_bank(jf, [jinsp.insp_head(p) for p in psis], 1, jx,
                            config=JHW)
    jcg = JP.compile_gradient(jf, 1, jx, config=JHW)
    return bank, cg, jbank, jcg


def _bank_engine(engine, bank, cg):
    engine.register("inr", cg)
    engine.register_bank(["fa", "fb", "fc"], bank)
    return engine


BANK_REQS = [("fa", 13, 2), ("inr", 9, 3), ("fb", 21, 4), ("fa", 5, 5),
             ("fc", 0, 6)]


def test_async_bank_parity_and_group_counter(bank_setup):
    """Filter requests of one bank coalesce into ONE concatenated pass per
    admission boundary — results torch.equal to the sync path, and the
    bank_groups counter advances in step with it."""
    bank, cg, _, _ = bank_setup
    reqs = [(i, torch.from_numpy(_x(n, s))) for i, n, s in BANK_REQS]
    sync = _bank_engine(ServingEngine(device="cpu"), bank, cg)
    asy = _bank_engine(AsyncServingEngine(device="cpu"), bank, cg)
    _assert_equal(sync.serve(reqs), asy.serve_async(reqs))
    assert asy.stats["bank_groups"] == sync.stats["bank_groups"] == 1
    assert asy.pending_rows() == 0


def test_async_bank_chunk_dispatch_before_drain(bank_setup):
    """A bank lane that fills a serving chunk dispatches at submit time
    (the double-buffered path), not only at drain."""
    bank, _, _, _ = bank_setup
    asy = AsyncServingEngine(device="cpu")
    asy.register_bank(["fa", "fb", "fc"], bank)
    chunk_rows = bank.cg.config.chunk_blocks * bank.cg.config.block
    q = torch.from_numpy(_x(chunk_rows, 7))
    asy.submit("fa", q)
    assert asy.stats["bank_groups"] == 1        # dispatched pre-drain
    asy.submit("fb", q[:7])
    res = asy.drain()
    assert asy.stats["bank_groups"] == 2
    sync = ServingEngine(device="cpu")
    sync.register_bank(["fa", "fb", "fc"], bank)
    _assert_equal(sync.serve([("fa", q), ("fb", q[:7])]), res)


def test_async_bank_matches_reference_engine(bank_setup):
    """Bank and plain requests mixed, through both packages' async
    engines: within 1e-4 (scaled), stats equal."""
    bank, cg, jbank, jcg = bank_setup
    reqs = [(i, torch.from_numpy(_x(n, s))) for i, n, s in BANK_REQS]
    port = _bank_engine(AsyncServingEngine(device="cpu"), bank, cg)
    ref = _bank_engine(JAsyncServingEngine(), jbank, jcg)
    got, want = port.serve_async(reqs), ref.serve_async(_to_jax(reqs))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _close_scaled(a.numpy(), np.asarray(b))
    assert {k: port.stats[k] for k in STATS} == \
        {k: ref.stats[k] for k in STATS}


# ---------------------------------------------------------------------------
# the import graph
# ---------------------------------------------------------------------------

def test_async_imports_no_jax():
    """The async engine, drift reports and the logger load and serve in a
    fresh interpreter that never imports jax, jaxlib or the reference."""
    code = """
import sys, torch
from repro_torch.serve import AsyncServingEngine
from repro_torch.obs import drift_report, get_logger
from repro_torch.configs.siren import SirenConfig
from repro_torch.core.pipeline import compile_gradient
from repro_torch.core.codegen import load_generated
from repro_torch.inr.siren import siren_fn, siren_init
cfg = SirenConfig(hidden_features=16, hidden_layers=1)
f = siren_fn(cfg, siren_init(cfg, torch.Generator().manual_seed(0)))
cg = compile_gradient(f, 1, torch.zeros(16, 2), device="cpu")
e = AsyncServingEngine(device="cpu")
e.register("a", cg)
out, = e.serve_async([("a", torch.rand(20, 2))])
assert [tuple(o.shape) for o in out] == [(20, 1), (20, 2)]
assert drift_report(cg, iters=1).units
load_generated(cg.source)
get_logger("t")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
