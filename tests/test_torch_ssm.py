"""The port's Mamba2 / SSD layers against the reference's.

``layers.ssd_chunked`` runs its inter-chunk recurrence through
``kernels.ssd_scan.ssd_scan``, which on the CPU takes the plain version;
here the whole function is held, on the same numpy inputs, against the
reference's ``ssd_chunked`` (fp32 within 1e-5 of max|reference|; in bf16
both round the same operands and accumulate in float32, so the port may be
at most twice the reference's error against a float64 recurrence) and
against a float64 step-by-step recurrence, as the reference's
``tests/test_kernels.py::test_ssd_scan_matches_model_ssd`` does.  Then
``_ssd_final_state``, ``_causal_conv`` with and without a cache, and a
whole ``mamba_layer``: prefill with ``return_state``, then decode steps
from its caches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import zoo as jzoo
from repro.models.template import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.models import layers as tlayers

H, P, N, CHUNK = 4, 8, 8, 8


def _ssd_inputs(s, seed=0, b=2):
    """xh, dt, a_log, B, C as float32 numpy arrays (dt > 0)."""
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((b, s, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, H)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, H)).astype(np.float32)
    Bm = (rng.standard_normal((b, s, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, N)) * 0.5).astype(np.float32)
    return xh, dt, a_log, Bm, Cm


def _round(a, dtype):
    """``a`` rounded to ``dtype``, back in float32 numpy."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def _recurrence(xh, dt, a_log, Bm, Cm):
    """float64 step by step: (y [b, s, h, p], final state [b, h, p, n])."""
    xh, dt, Bm, Cm = (np.asarray(t, np.float64) for t in (xh, dt, Bm, Cm))
    a = -np.exp(np.asarray(a_log, np.float64))
    b, s = xh.shape[:2]
    state = np.zeros((b, H, P, N))
    ys = []
    for t in range(s):
        da = np.exp(dt[:, t] * a[None, :])
        state = state * da[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], xh[:, t], Bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    return np.stack(ys, 1), state


def _scaled(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


def _port(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("s", [32, 29])
def test_ssd_chunked_matches_reference_f32(s):
    xh, dt, a_log, Bm, Cm = _ssd_inputs(s)
    want = jlayers.ssd_chunked(*(jnp.asarray(t) for t in
                                 (xh, dt, a_log, Bm, Cm)), CHUNK)
    got = tlayers.ssd_chunked(*_port(xh, dt, a_log, Bm, Cm), CHUNK)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, s, H, P)
    assert _scaled(got.numpy(), want) <= 1e-5
    assert _scaled(got.numpy(), _recurrence(xh, dt, a_log, Bm, Cm)[0]) \
        <= 1e-5


@pytest.mark.parametrize("s", [32, 29])
def test_ssd_chunked_bf16_against_float64(s):
    """bf16 operands (xh, B, C; dt and a_log stay float32, as mamba_layer
    passes them): within 2x the reference's error against float64 on the
    rounded inputs, and within 1e-2 of the reference."""
    xh, dt, a_log, Bm, Cm = _ssd_inputs(s, seed=1)
    xh, Bm, Cm = (_round(t, torch.bfloat16) for t in (xh, Bm, Cm))
    exact = _recurrence(xh, dt, a_log, Bm, Cm)[0]
    want = np.asarray(jlayers.ssd_chunked(
        jnp.asarray(xh, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a_log),
        jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16), CHUNK))
    xt, bt, ct = _port(xh, Bm, Cm, dtype=torch.bfloat16)
    got = tlayers.ssd_chunked(xt, torch.from_numpy(dt),
                              torch.from_numpy(a_log), bt, ct, CHUNK)
    assert got.dtype == torch.float32
    ref_err = _scaled(want, exact)
    assert 0 < _scaled(got.numpy(), exact) <= 2 * ref_err
    assert _scaled(got.numpy(), want) <= 1e-2


def test_ssd_chunked_runs_the_scan_wrapper(monkeypatch):
    """The inter-chunk recurrence goes through ``kernels/ssd_scan.py`` once,
    on a contiguous [b·h, nc, p, n] float32 tensor (the kernel's layout)."""
    calls = []
    real = tlayers.ssd_scan

    def spy(states, decay):
        calls.append((tuple(states.shape), states.dtype,
                      states.is_contiguous(), tuple(decay.shape)))
        return real(states, decay)
    monkeypatch.setattr(tlayers, "ssd_scan", spy)
    xh, dt, a_log, Bm, Cm = _ssd_inputs(29)
    tlayers.ssd_chunked(*_port(xh, dt, a_log, Bm, Cm), CHUNK)
    assert calls == [((2 * H, 4, P, N), torch.float32, True, (2 * H, 4))]


@pytest.mark.parametrize("s", [16, 13])
def test_ssd_final_state(s):
    xh, dt, a_log, Bm, _ = _ssd_inputs(s, seed=2)
    want = jlayers._ssd_final_state(*(jnp.asarray(t) for t in
                                      (xh, dt, a_log, Bm)))
    got = tlayers._ssd_final_state(*_port(xh, dt, a_log, Bm))
    assert tuple(got.shape) == (2, H, P, N) and got.dtype == torch.float32
    assert _scaled(got.numpy(), want) <= 1e-5
    assert _scaled(got.numpy(), _recurrence(xh, dt, a_log, Bm, Bm)[1]) \
        <= 1e-5


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv(cached, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if cached else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, want_cache = jlayers._causal_conv(
        jnp.asarray(x, jd), jnp.asarray(w, jd),
        None if cache is None else jnp.asarray(cache, jd))
    got, got_cache = tlayers._causal_conv(
        torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
        None if cache is None else torch.from_numpy(cache).to(td))
    assert got.dtype == td and tuple(got_cache.shape) == (2, 3, 12)
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert _scaled(got.float().numpy(), np.asarray(want, np.float32)) <= tol
    np.testing.assert_array_equal(got_cache.float().numpy(),
                                  np.asarray(want_cache, np.float32))


def _mamba_params(dtype):
    jcfg = dataclasses.replace(jget_config("mamba2-2.7b").reduced(),
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(),
                               compute_dtype=dtype)
    jp = jinit_params(jzoo.mamba_template(jcfg), jax.random.PRNGKey(5))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("s", [24, 21])
def test_mamba_layer_prefill_then_decode(s):
    """Prefill with ``return_state``, then three decode steps from its
    caches: outputs and caches within 1e-5 of max|reference| (fp32); the
    last step also equals prefill over the longer sequence."""
    jcfg, tcfg, jp, tp = _mamba_params("float32")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, s + 3, tcfg.d_model)).astype(np.float32)
    jy, (jconv, jstate) = jlayers.mamba_layer(jcfg, jp, jnp.asarray(x[:, :s]),
                                              return_state=True)
    ty, (tconv, tstate) = tlayers.mamba_layer(
        tcfg, tp, torch.from_numpy(x[:, :s]), return_state=True)
    assert tuple(tconv.shape) == (2, 3, tcfg.ssm_inner + 2 * tcfg.ssm_state)
    assert tuple(tstate.shape) == (2, tcfg.ssm_heads, tcfg.ssm_head_dim,
                                   tcfg.ssm_state)
    for got, want in ((ty, jy), (tconv, jconv), (tstate, jstate)):
        assert _scaled(got.numpy(), want) <= 1e-5
    for t in range(s, s + 3):
        xt = x[:, t:t + 1]
        jy, (jconv, jstate) = jlayers.mamba_layer(
            jcfg, jp, jnp.asarray(xt), conv_cache=jconv, ssm_state=jstate,
            decode=True)
        ty, (tconv, tstate) = tlayers.mamba_layer(
            tcfg, tp, torch.from_numpy(xt), conv_cache=tconv,
            ssm_state=tstate, decode=True)
        for got, want in ((ty, jy), (tconv, jconv), (tstate, jstate)):
            assert _scaled(got.numpy(), want) <= 1e-5
    full, (conv, state) = tlayers.mamba_layer(tcfg, tp, torch.from_numpy(x),
                                              return_state=True)
    assert _scaled(ty[:, 0].numpy(), full[:, -1].numpy()) <= 1e-5
    assert _scaled(tconv.numpy(), conv.numpy()) <= 1e-6
    assert _scaled(tstate.numpy(), state.numpy()) <= 1e-5


def test_mamba_layer_bf16_matches_reference():
    """bf16 compute with float32 weights: output within 2x the reference's
    error against the port's float64 evaluation, caches in bf16 / float32."""
    jcfg, tcfg, jp, tp = _mamba_params("bfloat16")
    x = np.random.default_rng(7).standard_normal(
        (2, 19, tcfg.d_model)).astype(np.float32)
    x = _round(x, torch.bfloat16)
    jy, _ = jlayers.mamba_layer(jcfg, jp, jnp.asarray(x, jnp.bfloat16),
                                return_state=True)
    ty, (conv, state) = tlayers.mamba_layer(
        tcfg, tp, torch.from_numpy(x).to(torch.bfloat16), return_state=True)
    assert ty.dtype == conv.dtype == torch.bfloat16
    assert state.dtype == torch.float32
    exact, _ = tlayers.mamba_layer(
        tcfg, {k: v.double() for k, v in tp.items()},
        torch.from_numpy(x).double(), return_state=True)
    exact = exact.numpy()
    ref_err = _scaled(np.asarray(jy, np.float64), exact)
    assert 0 < _scaled(ty.double().numpy(), exact) <= 2 * ref_err
