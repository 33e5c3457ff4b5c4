"""The port's K-stacked region kernel and MultiINRArtifact against the
reference's.

On the CPU ``region_call_stacked`` runs its plain version (lane by lane
through ``region_call_plain``); here it is held to the reference's
``region_call_stacked`` (Pallas in interpret mode) on the same numpy inputs,
and the instruction tables the CUDA kernel walks are executed lane by lane
with the numpy emulator of ``test_torch_kernels`` through the per-lane
strides the wrapper hands the kernel.  ``MultiINRArtifact`` (stacked and
per-lane paths) is held to the reference's at ``rtol=1e-5, atol=1e-6``,
the tolerance of the reference's own multi-INR test (``test_serve.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.siren import SirenConfig as JSirenConfig
from repro.core import pipeline as jpipeline
from repro.core.config import HardwareConfig as JHardwareConfig
from repro.inr.siren import siren_fn as j_siren_fn
from repro.inr.siren import siren_init as j_siren_init
from repro.kernels import region as jregion
from repro.serve import MultiINRArtifact as JMultiINRArtifact
from repro.serve import bind_weights as j_bind_weights
from repro_torch.configs.siren import SirenConfig
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.config import HardwareConfig
from repro_torch.inr.siren import params_from_jax, siren_fn
from repro_torch.kernels import region as tregion
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.serve import MultiINRArtifact, bind_weights
from test_torch_sharding import one_rank_mesh

from test_torch_kernels import (_close, _emulate, _port_spec, _region_inputs,
                                planned_regions)  # noqa: F401 (fixture)

FUSED = dict(block=8, use_pallas=True, fuse_regions=True)
UNFUSED = dict(block=8, use_pallas=True, fuse_regions=False)
INTERP = dict(block=8, use_pallas=False, fuse_regions=False)


def _stack(lanes):
    return [np.stack(col) for col in zip(*lanes)]


def _stacked_inputs(g, region, R, K, seed):
    """K lanes of ``_region_inputs``, stacked: stream [K, R, C], rows
    [K, 1, C], residents [K, ...]."""
    lanes = [_region_inputs(g, region, R, seed + 100 * k) for k in range(K)]
    return (_stack([s for s, _, _, _ in lanes]),
            _stack([r for _, r, _, _ in lanes]),
            _stack([res for _, _, res, _ in lanes]), lanes[0][3])


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


# -- the kernel --------------------------------------------------------------

def _bcast_spec():
    """The reference's own stacked-kernel case (test_regions_v2.py): mm with
    a bias, then a chain that multiplies by a broadcast row."""
    steps = (("mm", 2, 0, 10, 11, 1.0, False),
             ("chain", 3, 2, (("mul", None),), (1,)))
    return dict(steps=steps, stream_inputs=(0,), residents=(10, 11),
                outputs=(3,), bcast_rows=(1,))


def test_region_call_stacked_matches_reference_with_bcast_rows():
    K, R = 3, 20
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (K, R, 4)).astype(np.float32)
    row = rng.normal(size=(K, 1, 16)).astype(np.float32)
    w = rng.normal(size=(K, 4, 16)).astype(np.float32)
    b = rng.normal(size=(K, 16)).astype(np.float32)
    want, = jregion.region_call_stacked(
        jregion.RegionKernelSpec(**_bcast_spec()), [jnp.asarray(x)],
        [jnp.asarray(row)], [jnp.asarray(w), jnp.asarray(b)],
        [(16, jnp.float32)], bm=8, interpret=True)
    spec = tregion.RegionKernelSpec(**_bcast_spec())
    got, = tregion.region_call_stacked(spec, _t([x]), _t([row]), _t([w, b]),
                                       ((16, "float32"),))
    assert tuple(got.shape) == (K, R, 16)
    _close(got, want, 1e-5)
    for k in range(K):
        lane, = tregion.region_call(spec, [torch.from_numpy(x[k])],
                                    [torch.from_numpy(row[k])],
                                    [torch.from_numpy(w[k]),
                                     torch.from_numpy(b[k])],
                                    ((16, "float32"),))
        assert torch.equal(lane, got[k])


def test_region_call_stacked_matches_reference_on_planned_regions(
        planned_regions):
    """Every fused region the reference plans for a hidden-32 SIREN (orders
    1-3), over K = 3 lanes of different weights, against the reference's
    stacked kernel in interpret mode; the column-tiled regions against a
    float64 evaluation of the untiled spec, lane by lane."""
    K, R = 3, 13
    for n, (order, g, region) in enumerate(planned_regions):
        stream, rows, res, out_info = _stacked_inputs(g, region, R, K, n)
        spec = _port_spec(region.spec)
        got = tregion.region_call_stacked(spec, _t(stream), _t(rows),
                                          _t(res), out_info)
        if region.spec.tile_groups:
            untiled = dataclasses.replace(spec, tile_groups=())
            want = tregion.region_call_stacked_plain(
                untiled, [torch.from_numpy(a).double() for a in stream],
                [torch.from_numpy(a).double() for a in rows],
                [torch.from_numpy(a).double() for a in res],
                [(c, torch.float64) for c, _ in out_info])
        else:
            want = jregion.region_call_stacked(
                region.spec, [jnp.asarray(a) for a in stream],
                [jnp.asarray(a) for a in rows], [jnp.asarray(a) for a in res],
                tuple((c, jnp.float32) for c, _ in out_info), bm=8,
                interpret=True)
        for a, b in zip(got, want):
            assert tuple(a.shape) == (K, R, a.shape[-1])
            _close(a, b, 1e-4)


def test_lane_strides():
    assert tregion.lane_strides([(3, 20, 4), (3, 1, 16), (3, 4, 16),
                                 (3, 16), (3, 20, 16)]) == [80, 16, 64, 16,
                                                            320]


@pytest.mark.parametrize("n_rows", [8, 13])
def test_stacked_lowering_matches_plain(planned_regions, n_rows):
    """The CUDA kernel's view of a stacked launch: lane k's pointer table
    is every tensor's base plus ``k * lane_strides``; running the lowered
    program that way in numpy gives what the plain version gives, lane by
    lane (K = 3, a full and a ragged second row tile)."""
    K = 3
    for n, (order, g, region) in enumerate(planned_regions):
        stream, rows, res, out_info = _stacked_inputs(g, region, n_rows, K,
                                                      n)
        spec = _port_spec(region.spec)
        prog = tregion.lower(spec, tuple(a.shape[2] for a in stream),
                             tuple(a.shape[2] for a in rows),
                             tuple(a.shape[1:] for a in res))
        outs = [np.full((K, n_rows, c), np.nan, np.float32)
                for c, _ in out_info]
        tensors = stream + rows + res + outs
        flat = [t.reshape(-1) for t in tensors]
        strides = tregion.lane_strides(t.shape for t in tensors)
        for k in range(K):
            _emulate(prog, [f[k * s:] for f, s in zip(flat, strides)],
                     n_rows)
        want = tregion.region_call_stacked_plain(spec, _t(stream), _t(rows),
                                                 _t(res), out_info)
        for a, b in zip(outs, want):
            _close(a, b.numpy(), 1e-4)


def test_region_call_stacked_rejects_malformed_operands():
    spec = tregion.RegionKernelSpec(**_bcast_spec())
    x, row = torch.zeros(3, 20, 4), torch.zeros(3, 1, 16)
    w, b = torch.zeros(3, 4, 16), torch.zeros(3, 16)
    out = ((16, "float32"),)
    with pytest.raises(ValueError):                 # not [K, R, C]
        tregion.region_call_stacked(spec, [x[0]], [row], [w, b], out)
    with pytest.raises(ValueError):                 # row not [K, 1, C]
        tregion.region_call_stacked(spec, [x], [row[:, 0]], [w, b], out)
    with pytest.raises(ValueError):                 # lanes disagree
        tregion.region_call_stacked(spec, [x], [row], [w[:2], b], out)
    with pytest.raises(ValueError):                 # a resident missing
        tregion.region_call_stacked(spec, [x], [row], [w], out)


# -- MultiINRArtifact --------------------------------------------------------

@pytest.fixture(scope="module")
def inrs():
    """K = 8 hidden-16 SIRENs, as reference params and port params."""
    cfg = JSirenConfig(hidden_features=16, hidden_layers=1)
    jparams = [j_siren_init(cfg, jax.random.PRNGKey(100 + k))
               for k in range(8)]
    tcfg = SirenConfig(hidden_features=16, hidden_layers=1)
    tparams = [params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                for p in ps]) for ps in jparams]
    x = np.random.default_rng(1).uniform(-1, 1, (16, 2)).astype(np.float32)
    return cfg, jparams, tcfg, tparams, x


def _bases(inrs, order, conf, K):
    cfg, jparams, tcfg, tparams, x = inrs
    jbase = jpipeline.compile_gradient(j_siren_fn(cfg, jparams[0]), order,
                                       jnp.asarray(x),
                                       config=JHardwareConfig(**conf))
    tbase = tpipeline.compile_gradient(siren_fn(tcfg, tparams[0]), order,
                                       torch.from_numpy(x),
                                       config=HardwareConfig(**conf),
                                       device="cpu")
    jpay = [j_bind_weights(jbase, jparams[0], p) for p in jparams[:K]]
    tpay = [bind_weights(tbase, tparams[0], p) for p in tparams[:K]]
    return jbase, tbase, jpay, tpay


def _assert_outs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("conf", [FUSED, UNFUSED], ids=["stacked", "per_lane"])
def test_multi_inr_matches_reference(inrs, K, conf):
    """Broadcast queries (19 and 13 rows) and per-lane queries (11 rows)
    through the port's MultiINRArtifact and the reference's (asked for its
    stacked path), on the stacked path (fused plan) and the per-lane path
    (unfused plan)."""
    jbase, tbase, jpay, tpay = _bases(inrs, 2, conf, K)
    jm = JMultiINRArtifact(jbase, jpay, resident_double_buffer=True)
    tm = MultiINRArtifact(tbase, tpay)
    assert tm.double_buffered == jm.double_buffered == (conf is FUSED)
    rng = np.random.default_rng(K)
    for shape in [(19, 2), (13, 2), (K, 11, 2)]:
        q = rng.uniform(-1, 1, shape).astype(np.float32)
        _assert_outs(tm.apply_batched(torch.from_numpy(q)),
                     jm.apply_batched(jnp.asarray(q)))


def test_stacked_equals_per_lane_in_torch(inrs):
    """The stacked path and the per-lane path serve the same values, bit for
    bit (on the card both run the region kernel's 8-row tiles; here both
    run the plain region)."""
    _, tbase, _, tpay = _bases(inrs, 2, FUSED, 8)
    stacked = MultiINRArtifact(tbase, tpay)
    per_lane = MultiINRArtifact(tbase, tpay)
    assert stacked.double_buffered
    # the path a plan with non-region units takes, on the same plan
    per_lane._serve = per_lane._make_serve()
    q = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (8, 21, 2)).astype(np.float32))
    for a, b in zip(stacked.apply_batched(q), per_lane.apply_batched(q)):
        assert torch.equal(a, b)
    # the chunk step: [n_blocks, K, block, ...] in and out
    xb = q[:, :16].reshape(8, 2, 8, 2).movedim(1, 0)
    for m in (stacked, per_lane):
        want = m.apply_batched(q[:, :16])
        for a, b in zip(m.apply_chunk(xb), want):    # all outputs stream
            assert torch.equal(a.movedim(0, 1).reshape(b.shape), b)
    # lane k is the base artifact's result for weight set k
    for k in (0, 5):
        m1 = MultiINRArtifact(tbase, [tpay[k]])
        for a, b in zip(m1.apply_batched(q[k]), stacked.apply_batched(q)):
            assert torch.equal(a[0], b[k])


@pytest.mark.parametrize("order,conf", [
    (1, FUSED), (2, FUSED), (3, FUSED), (1, UNFUSED), (1, INTERP)])
def test_double_buffered_matches_reference(inrs, order, conf):
    """``.double_buffered`` as in the reference asked for its stacked path:
    taken only when the plan is all fused regions with kernel dispatch,
    otherwise the per-lane path serves."""
    jbase, tbase, jpay, tpay = _bases(inrs, order, conf, 2)
    jm = JMultiINRArtifact(jbase, jpay, resident_double_buffer=True)
    tm = MultiINRArtifact(tbase, tpay)
    assert tm.double_buffered == jm.double_buffered
    q = np.random.default_rng(order).uniform(-1, 1, (5, 2)).astype(
        np.float32)
    _assert_outs(tm.apply_batched(torch.from_numpy(q)),
                 jm.apply_batched(jnp.asarray(q)))


def test_bind_weights_rejects_mismatched_params(inrs):
    cfg, _, tcfg, tparams, x = inrs
    _, tbase, _, _ = _bases(inrs, 1, FUSED, 1)
    other = [{k: torch.zeros(v.shape[0] * 2, *v.shape[1:])
              for k, v in p.items()} for p in tparams[1]]
    with pytest.raises(ValueError):                 # leaf shapes differ
        bind_weights(tbase, tparams[0], other)
    with pytest.raises(ValueError):                 # structure differs
        bind_weights(tbase, tparams[0], tparams[1][:1])
    with pytest.raises(ValueError):                 # dtype differs
        bind_weights(tbase, tparams[0],
                     [{k: v.double() for k, v in p.items()}
                      for p in tparams[1]])
    # identical template leaves with differing replacements are ambiguous
    twin = [{"w": p["w"], "b": p["b"]} for p in tparams[0]]
    twin.append({"w": tparams[0][0]["w"].clone(), "b": tparams[0][0]["b"]})
    new = [{"w": p["w"], "b": p["b"]} for p in tparams[1]]
    new.append({"w": tparams[2][0]["w"], "b": tparams[2][0]["b"]})
    with pytest.raises(ValueError, match="ambiguous"):
        bind_weights(tbase, twin, new)


def test_multi_inr_zero_rows_and_unported_options(inrs):
    _, tbase, _, tpay = _bases(inrs, 2, FUSED, 3)
    m = MultiINRArtifact(tbase, tpay, ["a", "b", "c"])
    outs = m.apply_batched(torch.zeros(0, 2))
    assert [tuple(o.shape) for o in outs] == [(3, 0, 1), (3, 0, 2),
                                              (3, 0, 2), (3, 0, 2)]
    with pytest.raises(ValueError):                 # 2 lanes for 3 INRs
        m.apply_batched(torch.zeros(2, 5, 2))
    # K-axis sharding is ported: on a one-rank mesh the stack is
    # K-sharded and serves bit for bit what the unsharded one serves
    with one_rank_mesh() as mesh:
        ms = MultiINRArtifact(tbase, tpay, ["a", "b", "c"],
                              sharding=ShardingPolicy(mesh))
        assert ms.k_sharded and ms.double_buffered
        assert [tuple(o.shape) for o in ms.apply_batched(
            torch.zeros(0, 2))] == [(3, 0, 1), (3, 0, 2), (3, 0, 2),
                                    (3, 0, 2)]
        q = torch.rand(3, 13, 2, generator=torch.Generator().manual_seed(4))
        for a, b in zip(m.apply_batched(q), ms.apply_batched(q)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        MultiINRArtifact(tbase, [])
    assert "3 INRs" in m.describe() and "double-buffered" in m.describe()
