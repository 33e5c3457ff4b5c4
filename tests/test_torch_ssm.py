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


# -- the backward: ssd_scan's autograd Function and its plain reverse loop --

from repro.kernels import ref as jref                      # noqa: E402
from repro_torch.kernels import ssd_scan as tscan          # noqa: E402


@pytest.mark.parametrize("shape", [(6, 5, 3, 4), (4, 3, 2, 2), (2, 9, 4, 8)])
def test_ssd_scan_bwd_matches_reference_vjp(shape):
    """``ssd_scan_bwd_plain`` and the Function's backward against
    ``jax.vjp`` of the reference's recurrence (``kernels/ref.py::ssd_scan``,
    a ``lax.scan``), 1e-5 scaled."""
    rng = np.random.default_rng(11)
    st = rng.standard_normal(shape).astype(np.float32)
    dec = rng.uniform(0.05, 1.0, shape[:2]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    prev, vjp = jax.vjp(jref.ssd_scan, jnp.asarray(st), jnp.asarray(dec))
    want_st, want_dec = vjp(jnp.asarray(g))
    tprev = tscan.ssd_scan_plain(*_port(st, dec))
    assert _scaled(tprev.numpy(), prev) <= 1e-6
    dst, ddec = tscan.ssd_scan_bwd_plain(torch.from_numpy(g), tprev,
                                         torch.from_numpy(dec))
    assert _scaled(dst.numpy(), want_st) <= 1e-5
    assert _scaled(ddec.numpy(), want_dec) <= 1e-5
    ts, td = (t.requires_grad_() for t in _port(st, dec))
    out = tscan.ssd_scan(ts, td)
    assert out.grad_fn is not None
    gs, gd = torch.autograd.grad(out, (ts, td), torch.from_numpy(g))
    assert torch.equal(gs, dst) and torch.equal(gd, ddec)
    # the wrapper on CPU tensors is the plain version
    via = tscan.ssd_scan_bwd(torch.from_numpy(g), tprev,
                             torch.from_numpy(dec))
    assert all(torch.equal(a, b) for a, b in zip(via, (dst, ddec)))
    # one chunk: prev is S_{-1} = 0 and nothing reads S_0
    one = tscan.ssd_scan_bwd_plain(torch.from_numpy(g[:, :1]),
                                   tprev[:, :1], torch.from_numpy(dec[:, :1]))
    assert not one[0].any() and not one[1].any()


def test_ssd_scan_function_gradcheck():
    """The Function's backward is the recurrence's exact adjoint (float64
    finite differences), states of any float type keep their dtype."""
    rng = np.random.default_rng(12)
    st = torch.from_numpy(rng.standard_normal((3, 4, 2, 3))).requires_grad_()
    dec = torch.from_numpy(rng.uniform(0.1, 1.0, (3, 4))).requires_grad_()
    # the plain version runs in float32: compare its float32 gradient with
    # float64 finite differences of the float64 recurrence
    def f64(s, d):
        out, cur = [], torch.zeros_like(s[:, 0])
        for c in range(s.shape[1]):
            out.append(cur)
            cur = cur * d[:, c, None, None] + s[:, c]
        return torch.stack(out, 1)
    torch.autograd.gradcheck(f64, (st, dec))
    g = torch.from_numpy(rng.standard_normal((3, 4, 2, 3)))
    want = torch.autograd.grad(f64(st, dec), (st, dec), g)
    got = torch.autograd.grad(tscan.ssd_scan(st, dec), (st, dec), g)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        assert _scaled(a.numpy(), b.numpy()) <= 1e-6
    sb = st.detach().to(torch.bfloat16).requires_grad_()
    gb, = torch.autograd.grad(tscan.ssd_scan(sb, dec.detach().float()), sb,
                              g.float())
    assert gb.dtype == torch.bfloat16


@pytest.mark.parametrize("s", [32, 29])
def test_ssd_chunked_gradients_match_reference(s):
    """``jax.grad`` of the reference's ``ssd_chunked`` (its recurrence a
    ``lax.scan``) against the port's autograd through the ``ssd_scan``
    Function: every input's gradient within 1e-4 scaled."""
    xh, dt, a_log, Bm, Cm = _ssd_inputs(s, seed=3)
    w = np.random.default_rng(13).standard_normal((2, s, H, P)).astype(
        np.float32)

    def loss(*args):
        return jnp.sum(jlayers.ssd_chunked(*args, CHUNK) * w)

    want = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(t) for t in (xh, dt, a_log, Bm, Cm)))
    args = [t.requires_grad_() for t in _port(xh, dt, a_log, Bm, Cm)]
    y = tlayers.ssd_chunked(*args, CHUNK)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), args)
    for a, b, nm in zip(got, want, ("xh", "dt", "a_log", "B", "C")):
        assert _scaled(a.numpy(), b) <= 1e-4, nm


def test_mamba_layer_gradients_match_reference():
    """A whole reduced mamba2 layer: every weight's gradient against
    ``jax.grad`` of the reference's, 1e-4 scaled."""
    jcfg, tcfg, jp, tp = _mamba_params("float32")
    x = np.random.default_rng(14).standard_normal(
        (2, 21, tcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(15).standard_normal(
        (2, 21, tcfg.d_model)).astype(np.float32)

    def loss(p):
        y, _ = jlayers.mamba_layer(jcfg, p, jnp.asarray(x))
        return jnp.sum(y * w)

    want = jax.grad(loss)(jp)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, _ = tlayers.mamba_layer(tcfg, leaves, torch.from_numpy(x))
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                              list(leaves.values()))
    for (k, _), g in zip(leaves.items(), got):
        assert _scaled(g.numpy(), want[k]) <= 1e-4, k
