"""The chunk layer: each execution unit of a serving or fitting chunk runs
as one launch over the chunk's rows.

A hidden-64, 2-layer SIREN (``siren_setup``, trace batch B = 64) on both
sides, the port's weights from the reference's through ``params_from_jax``.
``chunk_blocks`` is 2 (16-row chunks, fewer rows than B) or 16 (128-row
chunks, more rows than B, where a row-constant resident of B rows must
broadcast past its own batch), and N = 300 leaves a ragged remainder (37.5
blocks).  Tolerances:

* chunk-wide against the per-block walk (``apply_block`` over each block):
  1e-5 of max|walk|.  Every unit is row-wise, so only BLAS blocking that
  depends on the row count can move a value; on the card the two are held
  ``torch.equal`` by ``chip_smoke.py``;
* against the reference's ``compile_gradient(...).apply_batched`` with the
  same config: ``test_torch_pipeline``'s 1e-4 (relative, and of max|ref|);
* fitting against the reference's ``value_and_grad``: ``test_torch_fit``'s
  1e-5 scaled error; the checkpoint cuts bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipeline
from repro.core.config import HardwareConfig as JHardwareConfig
from repro.fit import GradMSE as JGradMSE
from repro.fit import LaplacianMSE as JLaplacianMSE
from repro.fit import compile_fit as j_compile_fit
from repro.inr.siren import siren_init as j_siren_init
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.config import HardwareConfig
from repro_torch.core.executor import ResidentEnv
from repro_torch.fit import GradMSE, LaplacianMSE, compile_fit
from repro_torch.fit import compile as FC
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.kernels import fused_chain as tfused
from repro_torch.kernels import region as tregion
from repro_torch.kernels import siren_layer as tsiren
from repro_torch.kernels import stream_matmul as tmatmul
from repro_torch.serve import MultiINRArtifact, bind_weights

N = 300
# "tiled": the budget that column-tiles the order-1 region at hidden 64
CONFS = {"fused": dict(use_pallas=True),
         "unfused": dict(use_pallas=True, fuse_regions=False),
         "tiled": dict(use_pallas=True, bn=16, vmem_budget=80_000)}
PLANS = [(order, conf) for order in (1, 2, 3)
         for conf in ("fused", "unfused")] + [(1, "tiled")]
CASES = [(order, conf, cb) for order, conf in PLANS for cb in (2, 16)]
WRAPPERS = {"region": (tregion, "region_call"),
            "fused_chain": (tfused, "fused_chain"),
            "stream_matmul": (tmatmul, "stream_matmul"),
            "siren_layer": (tsiren, "siren_layer")}


def _port_params(jparams):
    return params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                            for p in jparams])


@pytest.fixture(scope="module")
def both(siren_setup):
    """(reference fn, port fn, port config, coords [N, 2], reference
    config, port params)."""
    cfg, params, f, _ = siren_setup
    tcfg = SirenConfig(hidden_features=cfg.hidden_features,
                       hidden_layers=cfg.hidden_layers)
    tparams = _port_params(params)
    coords = np.random.default_rng(7).uniform(
        -1, 1, (N, cfg.in_features)).astype(np.float32)
    return f, siren_fn(tcfg, tparams), tcfg, coords, cfg, tparams


def _artifact(tf, coords, order, conf, cb):
    return tpipeline.compile_gradient(
        tf, order, torch.from_numpy(coords[:64]),
        config=HardwareConfig(chunk_blocks=cb, **CONFS[conf]), device="cpu")


def _walk(cg, x):
    """The per-block walk: ``apply_block`` on each 8-row block of x (a
    block multiple of rows), outputs concatenated."""
    b = cg.config.block
    per_block = [cg.apply_block(x[i:i + b]) for i in range(0, x.shape[0], b)]
    return [torch.cat(col) for col in zip(*per_block)]


def _close_walk(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale


def _close_scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _padded(coords, block=8):
    x = torch.from_numpy(coords)
    pad = (-x.shape[0]) % block
    return torch.cat([x, x[-1:].expand(pad, x.shape[1])]) if pad else x


# ---------------------------------------------------------------------------
# serving: chunk-wide against the per-block walk and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order,conf,cb", CASES)
def test_chunk_matches_per_block_walk(both, order, conf, cb):
    """``apply_batched`` (full chunks and a ragged remainder),
    ``apply_chunk`` on one chunk and ``apply`` on the plan batch, each one
    pass a unit, against ``apply_block`` block by block."""
    _, tf, _, coords, _, _ = both
    cg = _artifact(tf, coords, order, conf, cb)
    if conf != "unfused":
        assert cg.region_plan.fused_regions()
    if conf == "tiled":
        assert any(r.spec.tile_groups
                   for r in cg.region_plan.fused_regions())
    x = _padded(coords)
    walk = _walk(cg, x)
    _close_walk(cg.apply_batched(torch.from_numpy(coords)),
                [w[:N] for w in walk])
    rows = cb * cg.config.block
    chunk = cg.apply_chunk(x[:rows].reshape(cb, cg.config.block, 2))
    _close_walk([o.reshape(rows, *o.shape[2:]) for o in chunk],
                [w[:rows] for w in walk])
    _close_walk(cg.apply(x[:64]), [w[:64] for w in walk])


@pytest.mark.parametrize("order,conf,cb", CASES)
def test_chunk_matches_reference(both, order, conf, cb):
    """The chunk-wide port against the reference's ``apply_batched`` (a
    ``lax.map`` over a chunk's blocks) with the same config."""
    f, tf, _, coords, _, _ = both
    ref = jpipeline.compile_gradient(
        f, order, jnp.asarray(coords[:64]),
        config=JHardwareConfig(chunk_blocks=cb, **CONFS[conf]))
    cg = _artifact(tf, coords, order, conf, cb)
    for n in (N, 5):
        want = ref.apply_batched(jnp.asarray(coords[:n]))
        got = cg.apply_batched(torch.from_numpy(coords[:n]))
        assert len(got) == len(want) == 2 ** order
        for a, b in zip(got, want):
            _close_scaled(a, b)


def _count_calls(monkeypatch):
    """Wrap every kernel wrapper the executor reaches: a list of (name,
    rows) per call, and a check on the operands a kernel reads."""
    calls = []

    def spy(name, run):
        def wrapper(*args, **kwargs):
            if name == "region":
                stream = args[1]
                assert all(a.is_contiguous() for a in stream)
                rows = stream[0].shape[0]
                assert all(a.shape[0] == rows for a in stream)
                assert all(a.shape[0] == 1 for a in args[2])
            else:
                rows = args[0].shape[0]
            if name == "fused_chain":
                x, extras = args[0], args[2] if len(args) > 2 else ()
                assert x.is_contiguous()
                for e in extras:
                    assert e.shape == x.shape and e.is_contiguous()
            calls.append((name, rows))
            return run(*args, **kwargs)
        return wrapper

    for name, (mod, attr) in WRAPPERS.items():
        monkeypatch.setattr(mod, attr, spy(name, getattr(mod, attr)))
    return calls


def _unit_kernels(cg):
    """The wrapper each execution unit of the plan calls, in plan order."""
    return [("region" if k.startswith("region") else k)
            for _, _, k in cg.dispatch]


@pytest.mark.parametrize("order,conf", PLANS)
def test_one_chunk_calls_each_unit_once(both, monkeypatch, order, conf):
    """One chunk of 128 rows (two plan batches) calls each unit's wrapper
    ONCE with R = 128, every kernel operand contiguous and every
    row-constant extra a full [128, C] block; ``apply_batched`` makes one
    pass a unit for each full chunk and one for the ragged remainder."""
    _, tf, _, coords, _, _ = both
    cg = _artifact(tf, coords, order, conf, 16)
    kernels = _unit_kernels(cg)
    assert set(kernels) <= set(WRAPPERS)
    calls = _count_calls(monkeypatch)
    x = _padded(coords)
    cg.apply_chunk(x[:128].reshape(16, 8, 2))
    assert calls == [(k, 128) for k in kernels]
    del calls[:]
    cg.apply_batched(torch.from_numpy(coords))    # 2 chunks + 6 blocks
    assert calls == [(k, r) for r in (128, 128, 48) for k in kernels]


def test_row_constant_residents_broadcast_past_the_plan_batch(both):
    """A row-constant resident of B rows serves a chunk of more rows: its
    row 0 broadcast, built once as the largest contiguous block seen and
    handed to smaller calls as its leading rows (no copy)."""
    _, tf, _, coords, _, _ = both
    cg = _artifact(tf, coords, 3, "unfused", 16)
    B = cg.plan.batch
    rowconst = [n for n in cg.plan.rowconst
                if cg.residents[n].dim() and cg.residents[n].shape[0] == B]
    assert rowconst
    cg.apply_batched(torch.from_numpy(coords[:200]))       # 128 + 72 rows
    blocks = cg.residents._blocks
    assert blocks and set(blocks) <= set(rowconst)
    for nid, blk in blocks.items():
        a = cg.residents[nid]
        assert blk.shape == (128, *a.shape[1:]) and blk.is_contiguous()
        assert torch.equal(blk, a[:1].expand_as(blk))
    before = {nid: blk.data_ptr() for nid, blk in blocks.items()}
    nid = next(iter(blocks))
    small = cg.residents.row_block(nid, 24)   # served from the block
    assert small.shape[0] == 24 and small.data_ptr() == before[nid]
    cg.apply_batched(torch.from_numpy(coords[:40]))
    assert {n: b.data_ptr() for n, b in blocks.items()} == before


def test_resident_env_builds_a_larger_block_once():
    env = ResidentEnv({3: torch.arange(4.0).repeat(2, 1)})   # [2, 4]
    a = env.row_block(3, 5)
    assert a.shape == (5, 4) and a.is_contiguous()
    assert torch.equal(a, env[3][:1].expand(5, 4))
    assert env.row_block(3, 5) is a
    assert env.row_block(3, 2).data_ptr() == a.data_ptr()
    b = env.row_block(3, 9)
    assert b.shape == (9, 4) and b.data_ptr() != a.data_ptr()
    assert env.row_block(3, 5).data_ptr() == b.data_ptr()
    assert dict(env) == {3: env[3]}        # the blocks are not residents


# ---------------------------------------------------------------------------
# multi-INR: the per-lane path serves each lane in chunk-wide passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conf", ["fused", "unfused"])
@pytest.mark.parametrize("cb", [2, 16])
def test_per_lane_path_chunks_match_apply_batched(both, monkeypatch, conf,
                                                  cb):
    """The per-lane path at order 3 (the unfused plan's, and the fused
    plan's taken as a plan with chain singletons would take it), K = 3
    weight sets, per-lane coordinates with a ragged N: lane k equals the
    lane's own artifact's ``apply_batched``; one chunk calls each unit once
    per lane."""
    _, tf, tcfg, coords, jcfg, tparams = both
    K = 3
    lanes = [_port_params(j_siren_init(jcfg, jax.random.PRNGKey(10 + k)))
             for k in range(K)]
    base = _artifact(tf, coords, 3, conf, cb)
    m = MultiINRArtifact(base, [bind_weights(base, tparams, w)
                                for w in lanes])
    assert m.double_buffered == (conf == "fused")
    m._serve = m._make_serve()
    q = np.random.default_rng(cb).uniform(-1, 1, (K, 150, 2)).astype(
        np.float32)
    got = m.apply_batched(torch.from_numpy(q))
    for k, w in enumerate(lanes):
        own = tpipeline.compile_gradient(
            siren_fn(tcfg, w), 3, torch.from_numpy(coords[:64]),
            config=base.config, device="cpu")
        _close_walk([a[k] for a in got],
                    own.apply_batched(torch.from_numpy(q[k])))
    calls = _count_calls(monkeypatch)
    rows = cb * 8
    xb = torch.from_numpy(q[:, :rows]).reshape(K, cb, 8, 2).movedim(1, 0)
    m.apply_chunk(xb)
    assert calls == [(k, rows) for _ in range(K)
                     for k in _unit_kernels(base)]


# ---------------------------------------------------------------------------
# fitting: one autograd pass, one region and one region_bwd per chunk
# ---------------------------------------------------------------------------

FIT_LOSSES = {1: (GradMSE(), JGradMSE()), 2: (LaplacianMSE(), JLaplacianMSE())}
FIT_N = 100                                  # 13 blocks, the last ragged


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _fit_inputs(loss, seed):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-1, 1, (FIT_N, 2)).astype(np.float32)
    targets = rng.standard_normal(
        (FIT_N, loss.target_cols(1, 2))).astype(np.float32)
    return coords, targets


def _compile_fit(both, order, cb, **kw):
    _, tf, _, _, _, tparams = both
    return compile_fit(tf, FIT_LOSSES[order][0], order, torch.zeros(64, 2),
                       params=tparams, device="cpu",
                       config=HardwareConfig(use_pallas=True,
                                             chunk_blocks=cb), **kw)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("cb", [4, 13, 64], ids=["smaller", "equal",
                                                 "larger"])
def test_fit_chunks_match_reference(both, order, cb):
    """``value_and_grad`` over 13 blocks in chunks of 4 (the last one
    ragged), 13 and 64 blocks against the reference's with the same
    config."""
    f, _, _, _, _, tparams = both
    tloss, jloss = FIT_LOSSES[order]
    coords, targets = _fit_inputs(jloss, order)
    jparams = [{k: jnp.asarray(v.numpy()) for k, v in p.items()}
               for p in tparams]
    jcf = j_compile_fit(f, jloss, order, jnp.zeros((64, 2)), params=jparams,
                        config=JHardwareConfig(use_pallas=True,
                                               chunk_blocks=cb))
    l_ref, g_ref = jcf.value_and_grad(jparams, jnp.asarray(coords),
                                      jnp.asarray(targets))
    cf = _compile_fit(both, order, cb)
    l_t, g_t = cf.value_and_grad(tparams, torch.from_numpy(coords),
                                 torch.from_numpy(targets))
    assert abs(float(l_t) - float(l_ref)) <= 1e-5 * max(
        1.0, abs(float(l_ref)))
    want = [np.asarray(p[k]) for p in g_ref for k in sorted(p)]
    got = [p[k].detach().numpy() for p in g_t for k in sorted(p)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _scaled_err(a, b) <= 1e-5


@pytest.mark.parametrize("cb", [4, 13, 64], ids=["smaller", "equal",
                                                 "larger"])
def test_fit_calls_region_grad_once_per_chunk(both, monkeypatch, cb):
    """Each chunk runs each region unit once forward (``region_call`` at the
    chunk's rows) and once backward (``region_bwd_call``), and nothing per
    block."""
    cf = _compile_fit(both, 2, cb, checkpoints="none")
    regions = sum(k == "region" for k, _ in FC._fit_units(cf.cg))
    assert regions
    calls = []
    for attr in ("region_call", "region_bwd_call"):
        run = getattr(tregion, attr)

        def spy(spec, stream, *rest, attr=attr, run=run):
            calls.append((attr, stream[0].shape[0]))
            return run(spec, stream, *rest)
        monkeypatch.setattr(tregion, attr, spy)
    coords, targets = _fit_inputs(FIT_LOSSES[2][1], 5)
    cf.value_and_grad(cf.unflatten(cf.template_leaves),
                      torch.from_numpy(coords), torch.from_numpy(targets))
    rows = [min(cb, 13 - c) * 8 for c in range(0, 13, cb)]
    fwd = [r for a, r in calls if a == "region_call"]
    bwd = [r for a, r in calls if a == "region_bwd_call"]
    assert fwd == [r for r in rows for _ in range(regions)]
    assert sorted(bwd) == sorted(fwd)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_checkpoint_cut_bitwise_at_chunk_rows(both, use_pallas):
    """At a chunk of 128 rows (more than the plan batch), a cut unit's
    outputs and its replayed backward are bit for bit the buffered unit's,
    for every unit."""
    _, tf, _, _, _, tparams = both
    cf = compile_fit(tf, GradMSE(), 1, torch.zeros(64, 2), params=tparams,
                     device="cpu", checkpoints="none",
                     config=HardwareConfig(use_pallas=use_pallas,
                                           chunk_blocks=16))
    leaves = [l.requires_grad_(True) for l in
              (t.clone() for t in cf.leaves_of(tparams))]
    res_env = cf._res_env(leaves)
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (128, 2)).astype(np.float32))
    env = {i: x for i in cf.cg.plan.inputs}
    rng = np.random.RandomState(0)
    for kind, u in FC._fit_units(cf.cg):
        fnu = (FC._region_unit_fn(cf.cg, u) if kind == "region"
               else FC._segment_unit_fn(cf.cg, u))
        sub = {nid: env[nid].detach().requires_grad_(True)
               for nid in u.stream_inputs if nid in env}
        plain = fnu(res_env, sub, 128)
        cut = FC._checkpointed(fnu)(res_env, sub, 128)
        for k in plain:
            assert plain[k].shape[0] == 128
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
