"""The port's streamed fitting engine against ``repro.fit``.

The reference test's setting (``tests/test_fit.py``): a hidden-32, 2-layer
SIREN, ``block = 8``, grids that are not a multiple of 8.  Both sides get the
same numpy coordinates and targets and the same weights
(``params_from_jax``).  Gradients are compared with the reference's scaled
error (max |a - b| over max(1, max |b|)), at its bars: 1e-5 for streamed
gradients and 5-step trajectories, bit for bit and 1e-6 for the
checkpoint-cut contract.  With ``use_pallas`` the port's region units go
through ``region_grad_fn`` (on the CPU: the plain region and
``region_bwd_plain``), the reference's through its Pallas region kernels in
interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core.config import HardwareConfig as JHardwareConfig
from repro.core.regions import plan_fit_checkpoints as j_plan_fit_checkpoints
from repro.fit import GradMSE as JGradMSE
from repro.fit import LaplacianMSE as JLaplacianMSE
from repro.fit import ValueMSE as JValueMSE
from repro.fit import compile as JFC
from repro.fit import compile_fit as j_compile_fit
from repro.fit import fit as j_fit
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as P
from repro_torch.core.config import HardwareConfig
from repro_torch.core.graph import ComputeGraph, Node
from repro_torch.core.regions import (plan_fit_checkpoints,
                                      unit_act_row_bytes,
                                      unit_boundary_row_bytes)
from repro_torch.fit import (GradMSE, LaplacianMSE, ValueMSE, compile_fit,
                             fit, fit_many)
from repro_torch.fit import compile as FC
from repro_torch.inr.siren import (params_from_jax, siren_apply, siren_fn,
                                   siren_init)
from repro_torch.serve import ArtifactStore, ServingEngine

LOSSES = {"value": (ValueMSE(), JValueMSE()),
          "grad": (GradMSE(), JGradMSE()),
          "laplacian": (LaplacianMSE(), JLaplacianMSE())}


def _cfg(use_pallas):
    return HardwareConfig(block=8, use_pallas=use_pallas, fuse_regions=True)


def _jcfg(use_pallas):
    return JHardwareConfig(block=8, use_pallas=use_pallas, fuse_regions=True)


@pytest.fixture(autouse=True)
def fresh_cache():
    P.clear_compile_cache()
    yield
    P.clear_compile_cache()


@pytest.fixture(scope="module")
def siren():
    """(port config, port params, reference config, reference params):
    one weight set on both sides."""
    jcfg = JSirenConfig(hidden_features=32, hidden_layers=2)
    jparams = j_siren_init(jcfg, jax.random.PRNGKey(0))
    cfg = SirenConfig(hidden_features=32, hidden_layers=2)
    return cfg, params_from_jax(jparams), jcfg, jparams


def _coords(n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 2)).astype(
        np.float32)


def _targets(loss, n, seed=1):
    return np.random.RandomState(seed).standard_normal(
        (n, loss.target_cols(1, 2))).astype(np.float32)


def _scaled_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))]


def _port_leaves(params):
    return [p[k].detach().numpy() for p in params for k in sorted(p)]


def _compile(siren, loss, order, use_pallas=False, **kw):
    cfg, params, _, _ = siren
    return compile_fit(siren_fn(cfg, params), loss, order,
                       torch.zeros(64, 2), params=params,
                       config=_cfg(use_pallas), device="cpu", **kw)


# ---------------------------------------------------------------------------
# parity: the port's streamed gradient == the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("order,loss", [(1, "grad"), (2, "laplacian")])
def test_stream_value_and_grad_matches_reference(siren, order, loss,
                                                 use_pallas):
    cfg, params, jcfg, jparams = siren
    tloss, jloss = LOSSES[loss]
    coords = _coords(100, seed=order)        # 100 rows: not a multiple of 8
    targets = _targets(jloss, 100)
    cf = _compile(siren, tloss, order, use_pallas)
    if use_pallas:
        assert any(k == "region" for k, _ in FC._fit_units(cf.cg))
    jcf = j_compile_fit(j_siren_fn(jcfg, jparams), jloss, order,
                        jnp.zeros((64, 2)), params=jparams,
                        config=_jcfg(use_pallas))
    l_ref, g_ref = jcf.value_and_grad(jparams, jnp.asarray(coords),
                                      jnp.asarray(targets))
    l_t, g_t = cf.value_and_grad(params, torch.from_numpy(coords),
                                 torch.from_numpy(targets))
    assert abs(float(l_t) - float(l_ref)) <= 1e-5 * max(1.0,
                                                        abs(float(l_ref)))
    for a, b in zip(_port_leaves(g_t), _leaves(g_ref)):
        assert a.shape == b.shape
        assert _scaled_err(a, b) <= 1e-5


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_objective_row_loss_matches_reference(name):
    tloss, jloss = LOSSES[name]
    rng = np.random.RandomState(3)
    C, D, rows = 2, 3, 9
    outs = [rng.standard_normal((rows, c)).astype(np.float32)
            for c in [C] + [D] * C + [D] * (C * D)]
    target = rng.standard_normal((rows, jloss.target_cols(C, D))).astype(
        np.float32)
    got = tloss.row_loss([torch.from_numpy(o) for o in outs],
                         torch.from_numpy(target), C, D)
    want = jloss.row_loss([jnp.asarray(o) for o in outs],
                          jnp.asarray(target), C, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert tloss.target_cols(C, D) == jloss.target_cols(C, D)
    assert tloss.min_order == jloss.min_order
    assert hash(tloss) == hash(type(tloss)())


# ---------------------------------------------------------------------------
# checkpoint cuts: the invariance contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_checkpointed_unit_backward_bitwise(siren, use_pallas):
    """A cut unit's outputs and its backward (replayed on the backward
    sweep) are bit for bit the buffered unit's, for every unit."""
    _, params, _, _ = siren
    cf = _compile(siren, GradMSE(), 1, use_pallas, checkpoints="none")
    leaves = [l.requires_grad_(True) for l in
              (t.clone() for t in cf.leaves_of(params))]
    res_env = cf._res_env(leaves)
    xb, _, _, _ = cf._blocked(_coords(24, seed=3),
                              _targets(GradMSE(), 24))
    g = cf.cg.graph
    env = {g.nodes[i].id: xb[0] for i in cf.cg.plan.inputs}
    rng = np.random.RandomState(0)
    for kind, u in FC._fit_units(cf.cg):
        fnu = (FC._region_unit_fn(cf.cg, u) if kind == "region"
               else FC._segment_unit_fn(cf.cg, u))
        sub = {nid: env[nid].detach().requires_grad_(True)
               for nid in u.stream_inputs if nid in env}
        plain = fnu(res_env, sub, xb.shape[1])
        cut = FC._checkpointed(fnu)(res_env, sub, xb.shape[1])
        for k in plain:
            assert torch.equal(plain[k], cut[k])
        keys = [k for k in plain if plain[k].requires_grad]
        ct = [torch.from_numpy(rng.standard_normal(
            tuple(plain[k].shape)).astype(np.float32)) for k in keys]
        inputs = [v for v in (*res_env.values(), *sub.values())
                  if v.requires_grad]
        ga = torch.autograd.grad([plain[k] for k in keys], inputs, ct,
                                 allow_unused=True, retain_graph=True)
        gb = torch.autograd.grad([cut[k] for k in keys], inputs, ct,
                                 allow_unused=True, retain_graph=True)
        for a, b in zip(ga, gb):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
        env.update({k: v.detach() for k, v in plain.items()})


def test_checkpoint_cuts_forward_bitwise_grads_tight(siren):
    """Cutting every unit leaves the forward loss bitwise unchanged, and the
    gradients within 1e-6 scaled."""
    _, params, _, _ = siren
    coords = _coords(40, seed=5)
    targets = _targets(LaplacianMSE(), 40)
    cf0 = _compile(siren, LaplacianMSE(), 2, checkpoints="none")
    cf1 = _compile(siren, LaplacianMSE(), 2, checkpoints="all")
    assert cf0 is not cf1
    l0, g0 = cf0.value_and_grad(params, coords, targets)
    l1, g1 = cf1.value_and_grad(params, coords, targets)
    assert float(l0) == float(l1)
    for a, b in zip(_port_leaves(g1), _port_leaves(g0)):
        assert _scaled_err(a, b) <= 1e-6


def test_checkpoint_cuts_shrink_modeled_backward(siren):
    cf0 = _compile(siren, ValueMSE(), 2, checkpoints="none")
    units = FC._fit_units(cf0.cg)
    wins = tuple(i for i, (k, u) in enumerate(units)
                 if unit_act_row_bytes(cf0.cg.plan, k, u)
                 > unit_boundary_row_bytes(cf0.cg.plan, k, u))
    assert wins
    cf1 = _compile(siren, ValueMSE(), 2, checkpoints=wins)
    assert cf1.peak_bytes() < cf0.peak_bytes()


# ---------------------------------------------------------------------------
# the memory model on the reference's own graph
# ---------------------------------------------------------------------------

def _port_graph(gj) -> ComputeGraph:
    g = ComputeGraph()
    for nid, n in gj.nodes.items():
        g.nodes[nid] = Node(n.id, n.op, n.shape, n.dtype, n.inputs, n.params,
                            None if n.const is None else np.array(n.const))
    g.outputs = list(gj.outputs)
    g._next = gj._next
    return g


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("order,loss", [(1, "grad"), (2, "laplacian")])
def test_memory_model_matches_reference(siren, order, loss, use_pallas):
    """On the reference's graph (copied into the port), the checkpoint
    plans (default budget and one tight enough to cut) and every peak_bytes
    figure are the reference's integers."""
    cfg, params, jcfg, jparams = siren
    tloss, jloss = LOSSES[loss]
    jcf = j_compile_fit(j_siren_fn(jcfg, jparams), jloss, order,
                        jnp.zeros((64, 2)), params=jparams,
                        config=_jcfg(use_pallas))
    cg = P.compile_from_graph(_port_graph(jcf.cg.graph),
                              config=_cfg(use_pallas), device="cpu",
                              order=order)
    units, junits = FC._fit_units(cg), JFC._fit_units(jcf.cg)
    assert [k for k, _ in units] == [k for k, _ in junits]
    for budget in (None, 2_000):
        cuts = plan_fit_checkpoints(cg.plan, units, cg.config, budget=budget)
        assert cuts == j_plan_fit_checkpoints(jcf.cg.plan, junits,
                                              jcf.cg.config, budget=budget)
    assert cuts                                  # the tight budget cuts
    leaf_of, fixed, treedef, leaves = FC.match_trainable(cg, params)
    assert leaf_of == jcf.leaf_of
    for policy in ("auto", "none", "all", cuts):
        tcuts = FC._resolve_checkpoints(cg, policy)
        jcuts = JFC._resolve_checkpoints(jcf.cg, policy)
        assert tcuts == jcuts
        cf = FC.CompiledFit(cg=cg, loss=tloss, checkpoints=tcuts,
                            leaf_of=leaf_of, fixed=fixed, treedef=treedef,
                            template_leaves=leaves)
        jcf_p = JFC.CompiledFit(cg=jcf.cg, loss=jloss, checkpoints=jcuts,
                                leaf_of=jcf.leaf_of, fixed=jcf.fixed,
                                treedef=jcf.treedef,
                                template_leaves=jcf.template_leaves)
        assert cf.peak_bytes() == jcf_p.peak_bytes()
        assert cf.peak_bytes(n_rows=4096) == jcf_p.peak_bytes(n_rows=4096)


# ---------------------------------------------------------------------------
# the front door: cache + validation
# ---------------------------------------------------------------------------

def test_compile_fit_cache_hit_and_clear(siren):
    cfg, params, _, _ = siren
    f = siren_fn(cfg, params)
    kw = dict(params=params, config=_cfg(False), device="cpu")
    a = compile_fit(f, ValueMSE(), 1, torch.zeros(64, 2), **kw)
    b = P.compile_fit(f, ValueMSE(), 1, torch.zeros(64, 2), **kw)
    assert a is b
    c = compile_fit(f, GradMSE(), 1, torch.zeros(64, 2), **kw)
    assert c is not a                       # the objective keys the cache
    assert len(P._FIT_CACHE) == 2
    P.clear_compile_cache()
    assert not P._FIT_CACHE


def test_order_must_cover_objective(siren):
    with pytest.raises(ValueError, match="order"):
        _compile(siren, LaplacianMSE(), 1)
    with pytest.raises(TypeError):
        _compile(siren, JValueMSE(), 1)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_fit_trajectory_matches_reference(siren, use_pallas):
    """Five whole-grid AdamW steps (batch_rows=None): losses and final
    weights within 1e-5 scaled of the reference's fit."""
    cfg, params, jcfg, jparams = siren
    coords = _coords(52, seed=7)
    targets = np.tanh(3.0 * coords[:, :1]).astype(np.float32)
    cf = _compile(siren, ValueMSE(), 1, use_pallas)
    jcf = j_compile_fit(j_siren_fn(jcfg, jparams), JValueMSE(), 1,
                        jnp.zeros((64, 2)), params=jparams,
                        config=_jcfg(use_pallas))
    r = fit(cf, coords, targets, steps=5)
    jr = j_fit(jcf, jnp.asarray(coords), jnp.asarray(targets), steps=5)
    np.testing.assert_allclose(r.losses, jr.losses, rtol=1e-5)
    for a, b in zip(_port_leaves(r.params), _leaves(jr.params)):
        assert _scaled_err(a, b) <= 1e-5
    assert r.signature == cf.signature and r.steps == 5


def test_fit_many_matches_sequential(siren):
    cfg, params, _, _ = siren
    K, steps = 3, 4
    coords = _coords(64, seed=11)
    params_k = [siren_init(cfg, torch.Generator().manual_seed(10 + k))
                for k in range(K)]
    targets_k = [np.tanh((k + 1.0) * coords[:, :1]) for k in range(K)]
    cf = _compile(siren, ValueMSE(), 1)
    many = fit_many(cf, params_k, coords, targets_k, steps=steps,
                    batch_rows=24, key=5)
    for k in range(K):
        solo = fit(cf, coords, targets_k[k], steps=steps,
                   params=params_k[k], batch_rows=24, key=5)
        assert many[k].losses == solo.losses
        for a, b in zip(_port_leaves(many[k].params),
                        _port_leaves(solo.params)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        fit_many(cf, params_k, coords, targets_k[:2], steps=1)


def test_fit_detaches_params_that_require_grad(siren):
    """Leaves the caller marks requires_grad fit like plain tensors and
    come back free of any autograd graph."""
    cfg, params, _, _ = siren
    coords = _coords(40, seed=17)
    target = np.tanh(coords[:, :1])
    cf = _compile(siren, ValueMSE(), 1)
    marked = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
              for p in params]
    a = fit(cf, coords, target, steps=2, params=marked)
    b = fit(cf, coords, target, steps=2, params=params)
    assert a.losses == b.losses
    for u, v in zip(_port_leaves(a.params), _port_leaves(b.params)):
        np.testing.assert_array_equal(u, v)
    assert not any(p[k].requires_grad for p in a.params for k in p)


def test_fit_batched_chunks_descend(siren):
    coords = _coords(96, seed=13)
    target = np.tanh(2.0 * coords[:, :1])
    cf = _compile(siren, ValueMSE(), 1)
    r = fit(cf, coords, target, steps=10, batch_rows=32)
    assert min(r.losses[-3:]) < r.losses[0]


def test_chunk_schedule_covers_every_block():
    from repro_torch.fit.engine import _chunk_schedule
    chunks = _chunk_schedule(10, 4, 5, 3)
    assert all(len(c) == 4 for c in chunks)
    # two windows per epoch, then a fresh permutation
    assert len(set(chunks[0]) | set(chunks[1])) == 8
    assert [list(c) for c in chunks] == [list(c) for c in
                                         _chunk_schedule(10, 4, 5, 3)]
    assert len(_chunk_schedule(3, 5, 1, 0)[0]) == 5        # wrap-around


def test_fit_store_serve_roundtrip(siren, tmp_path):
    """fit -> put_weights -> a fresh ServingEngine serves the fitted INR."""
    cfg, params, _, _ = siren
    store = ArtifactStore(tmp_path / "store")
    coords = _coords(100, seed=9)
    target = np.tanh(3.0 * coords[:, :1])
    cf = compile_fit(siren_fn(cfg, params), ValueMSE(), 1,
                     torch.zeros(64, 2), params=params, config=_cfg(True),
                     store=store, device="cpu")
    r = fit(cf, coords, target, steps=8, store=store, inr_id="fitted")
    assert r.losses[-1] < r.losses[0]
    assert store.has(cf.signature, "fitted")
    eng = ServingEngine(store, device="cpu")
    eng.register("fitted", signature=cf.signature, weight_id="fitted")
    (outs,) = eng.serve([("fitted", torch.from_numpy(coords))])
    ref = siren_apply(r.params, torch.from_numpy(coords))
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), atol=1e-5)
