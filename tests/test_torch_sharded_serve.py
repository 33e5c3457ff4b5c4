"""Sharded serving on gloo ranks: the K-sharded multi-INR fleet and the
row-sharded engine, sync and async, against the unsharded engine
(``tests/test_async_serve.py`` K-axis cases, ``tests/test_serve.py``'s
policy parity).

The reference proves these on forced host devices; the port runs one
process per rank (``test_torch_sharding.run_ranks``).  Every rank gets the
same SIRENs (the reference's ``siren_init`` weights, written to a file by
the test) and the same requests; every rank's sharded ``serve`` and
``serve_async`` must return the whole outputs within rtol 1e-6 / atol
1e-7 of the unsharded engine in the same process, the reference's
tolerance.  On a one-rank mesh the sharded paths must be ``torch.equal``
to the unsharded ones.  The port's unsharded outputs for these weights
are held to the reference's engine at 1e-4 (scaled), as in
``test_torch_serve.py``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import pipeline as JP
from repro.core.config import DEFAULT_CONFIG
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as P
from repro_torch.core.config import HardwareConfig
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.serve import (AsyncServingEngine, MultiINRArtifact,
                               ServingEngine)
from repro_torch.serve.multi_inr import const_payload
from test_torch_pipeline import _close_scaled
from test_torch_sharding import one_rank_mesh, run_ranks

SIZES = [21, 34, 9, 40]


def _weights(k: int, hidden: int = 16):
    cfg = JSirenConfig(hidden_features=hidden, hidden_layers=1)
    p = j_siren_init(cfg, jax.random.PRNGKey(k))
    return cfg, p, [{n: np.asarray(v) for n, v in layer.items()}
                    for layer in p]


def _coords(n: int, seed: int):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 2)).astype(
        np.float32)


@pytest.fixture(scope="module")
def fleet_file(tmp_path_factory):
    """Four SIRENs' weights and the requests' coordinates, in one npz the
    ranks read."""
    path = tmp_path_factory.mktemp("fleet") / "fleet.npz"
    arrays = {}
    for k in range(4):
        for i, layer in enumerate(_weights(k)[2]):
            for n, v in layer.items():
                arrays[f"w{k}_{i}_{n}"] = v
    for k, n in enumerate(SIZES):
        arrays[f"x{k}"] = _coords(n, 50 + k)
    arrays["trace"] = _coords(16, 1)
    np.savez(path, **arrays)
    return str(path)


# the ranks' common setup: the fleet's four artifacts (block 8, 4 blocks a
# chunk) and the requests
_SETUP = """
import numpy as np, tempfile
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as P
from repro_torch.core.config import HardwareConfig
from repro_torch.distributed.sharding import ShardingPolicy, make_mesh
from repro_torch.inr.siren import siren_fn
from repro_torch.serve import AsyncServingEngine, ServingEngine

data = np.load({path!r})
cfg = SirenConfig(hidden_features=16, hidden_layers=1)
def params(k):
    return [{{n: torch.from_numpy(data[f"w{{k}}_{{i}}_{{n}}"])
             for n in ("w", "b")}} for i in range(2)]
hw = HardwareConfig(block=8, chunk_blocks=4)
trace = torch.from_numpy(data["trace"])
cgs = [P.compile_gradient(siren_fn(cfg, params(k)), {order}, trace,
                          config=hw, device="cpu") for k in range(4)]
reqs = [(f"i{{k}}", torch.from_numpy(data[f"x{{k}}"])) for k in range(4)]
d = tempfile.mkdtemp()

def close(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for a, b in zip(w, g):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-7)
"""


def test_k_sharded_fleet_two_ranks(fleet_file):
    """Two ranks, a ("data",) mesh: the K = 4 fleet is K-sharded (each
    rank holds and serves 2 lanes), sync and async results are the
    unsharded engine's, and K = 3 falls back to replication."""
    outs = run_ranks(_SETUP.format(path=fleet_file, order=1) + """
pol = ShardingPolicy(make_mesh((WORLD,), ("data",)))
plain = ServingEngine(d + f"/p{RANK}", device="cpu")
shard = ServingEngine(d + f"/s{RANK}", sharding=pol, device="cpu")
asyn = AsyncServingEngine(d + f"/a{RANK}", sharding=pol, device="cpu")
for k in range(4):
    for e in (plain, shard, asyn):
        e.register(f"i{k}", cgs[k])
want = plain.serve(reqs)
for got, eng in ((shard.serve(reqs), shard), (asyn.serve_async(reqs), asyn)):
    close(want, got)
    assert eng.stats["k_sharded_batches"] >= 1, eng.stats
m = shard._multi_artifact(cgs[0].signature, ("i0", "i1", "i2", "i3"))
assert m.k_sharded and m.double_buffered
assert m._lanes == (2 * RANK, 2 * RANK + 2)
assert all(v.shape[0] == 2 for v in m.residents.values())
assert "K-sharded" in m.describe()
m3 = shard._multi_artifact(cgs[0].signature, ("i0", "i1", "i2"))
assert not m3.k_sharded
assert all(v.shape[0] == 3 for v in m3.residents.values())
close(want[:3], shard.serve(reqs[:3]))
print("K_SHARD_OK", RANK, shard.stats["k_sharded_batches"],
      asyn.stats["k_sharded_batches"])
""", 2)
    assert [o.split()[:2] for o in outs] == [["K_SHARD_OK", "0"],
                                              ["K_SHARD_OK", "1"]]


def test_row_sharded_engine_two_ranks(fleet_file):
    """Two ranks: a single-INR group's rows split over the data axis
    (``sharded_batches``), through the per-shard variant under
    ``shard_chunking`` (``chunk_blocks // 2``, ``n_shards = 2``, the same
    graph), and rows the axis does not divide served whole; the results
    are the unsharded engine's at order 2."""
    outs = run_ranks(_SETUP.format(path=fleet_file, order=2) + """
from repro_torch.core import trace as T
pol = ShardingPolicy(make_mesh((WORLD,), ("data",)))
plain = ServingEngine(device="cpu")
shard = ServingEngine(sharding=pol, shard_chunking=True, device="cpu")
asyn = AsyncServingEngine(sharding=pol, shard_chunking=True, device="cpu")
for e in (plain, shard, asyn):
    e.register("a", cgs[0])
even = [("a", reqs[1][1]), ("a", reqs[3][1])]          # 74 rows
odd = [("a", reqs[0][1])]                              # 21 rows
for batch, n in ((even, 1), (odd, 0)):
    before = shard.stats["sharded_batches"]
    want = plain.serve(batch)
    close(want, shard.serve(batch))
    close(want, asyn.serve_async(batch))
    assert shard.stats["sharded_batches"] - before == n
v = shard._serving_artifact(cgs[0].signature)
assert v is not cgs[0] and v.graph is cgs[0].graph
assert (v.config.chunk_blocks, v.config.n_shards) == (2, 2)
print("ROWS_OK", RANK)
""", 2)
    assert sorted(o.split()[1] for o in outs) == ["0", "1"]


def test_one_rank_mesh_is_bitwise(fleet_file):
    """On a one-rank ("data", "model") mesh the K-sharded stack, the
    sharded sync engine (with ``shard_chunking``) and the async engine are
    ``torch.equal`` to the unsharded ones."""
    data = np.load(fleet_file)
    cfg = SirenConfig(hidden_features=16, hidden_layers=1)
    trace = torch.from_numpy(data["trace"])
    hw = HardwareConfig(block=8, chunk_blocks=4)
    P.clear_compile_cache()
    cgs = [P.compile_gradient(siren_fn(cfg, [
        {n: torch.from_numpy(data[f"w{k}_{i}_{n}"]) for n in ("w", "b")}
        for i in range(2)]), 2, trace, config=hw, device="cpu")
        for k in range(4)]
    reqs = [(f"i{k}", torch.from_numpy(data[f"x{k}"])) for k in range(4)]
    with one_rank_mesh() as mesh:
        pol = ShardingPolicy(mesh)
        m = MultiINRArtifact(cgs[0], [const_payload(c) for c in cgs],
                             sharding=pol)
        assert m.k_sharded and m.double_buffered
        base = MultiINRArtifact(cgs[0], [const_payload(c) for c in cgs])
        q = reqs[3][1]
        for a, b in zip(base.apply_batched(q), m.apply_batched(q)):
            assert torch.equal(a, b)
        plain = ServingEngine(device="cpu")
        shard = ServingEngine(sharding=pol, shard_chunking=True,
                              device="cpu")
        asyn = AsyncServingEngine(sharding=pol, device="cpu")
        for k in range(4):
            for e in (plain, shard, asyn):
                e.register(f"i{k}", cgs[k])
        want = plain.serve(reqs) + plain.serve(reqs[:1])
        for got in (shard.serve(reqs) + shard.serve(reqs[:1]),
                    asyn.serve_async(reqs) + asyn.serve_async(reqs[:1])):
            for w, g in zip(want, got):
                for a, b in zip(w, g):
                    assert torch.equal(a, b)
        assert shard.stats["k_sharded_batches"] == 1
        assert asyn.stats["k_sharded_batches"] >= 1
        # one rank: nothing is split by rows, no variant is compiled
        assert shard.stats["sharded_batches"] == 0
        assert shard._serving_artifact(cgs[0].signature) is cgs[0]
        assert "mesh {'data': 1, 'model': 1}" in shard.describe()


@pytest.mark.parametrize("order", [1, 2])
def test_unsharded_port_matches_reference(fleet_file, order):
    """The weights the ranks serve: the port's unsharded engine against
    the reference's engine (1e-4 scaled, ``test_torch_serve.py``'s
    tolerance), single-INR and K = 4 groups."""
    data = np.load(fleet_file)
    jcfg = JSirenConfig(hidden_features=16, hidden_layers=1)
    tcfg = SirenConfig(hidden_features=16, hidden_layers=1)
    trace = data["trace"]
    P.clear_compile_cache()
    JP.clear_compile_cache()
    jeng, teng = JServingEngine(), ServingEngine(device="cpu")
    for k in range(4):
        _, jp, npw = _weights(k)
        jeng.register(f"i{k}", JP.compile_gradient(
            j_siren_fn(jcfg, jp), order, trace,
            config=DEFAULT_CONFIG.replace(block=8, chunk_blocks=4)))
        teng.register(f"i{k}", P.compile_gradient(
            siren_fn(tcfg, params_from_jax(npw)), order,
            torch.from_numpy(trace),
            config=HardwareConfig(block=8, chunk_blocks=4), device="cpu"))
    for reqs in ([("i0", data["x0"])],
                 [(f"i{k}", data[f"x{k}"]) for k in range(4)]):
        want = jeng.serve(reqs)
        got = teng.serve([(i, torch.from_numpy(x)) for i, x in reqs])
        for w, g in zip(want, got):
            for a, b in zip(w, g):
                _close_scaled(b.numpy(), np.asarray(a))
