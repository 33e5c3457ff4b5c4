"""The streaming attention backward: ``models/flash_cvjp.py`` and the
attention kernel's autograd Function (``kernels/flash_attention.py``) against
the reference's ``repro.models.flash_cvjp``.

On the CPU the kernel wrapper runs its plain versions: the dense forward
with its log-sum-exp and ``flash_attention_bwd_plain``, the port of the
reference's ``_bwd_impl``; ``flash_attention_cvjp`` is that wrapper.  The
blockwise ``layers.flash_attention`` is held to ``_fwd_impl``.  Both
packages get the same numpy inputs.  Tolerances:
the reference's own cases (``tests/test_flash_cvjp.py``: forward 3e-4
against dense, gradients 2e-3 against dense autodiff) are kept where a case
is mirrored; the port against the reference's ``_fwd_impl`` / ``_bwd_impl``
and ``jax.grad`` of ``flash_attention_cvjp`` is held at 1e-4 of the largest
reference value in float32.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import flash_cvjp as jcvjp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as tlayers
from repro_torch.models.flash_cvjp import flash_attention_cvjp

# (Sq, Sk, H, KH, D, window): GQA, MHA with a window, q shorter than k
CASES = [(96, 96, 4, 2, 16, 0), (64, 64, 4, 4, 32, 16),
         (64, 128, 8, 2, 16, 0)]
# the port against the reference's blockwise functions, ragged blocks too
BLOCK_CASES = CASES + [(50, 50, 6, 2, 16, 7), (40, 72, 4, 1, 8, 0)]


def _inputs(sq, sk, h, kh, d, seed=0, b=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    t = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, t


def _scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("sq,sk,h,kh,d,win", CASES)
def test_forward_matches_dense(sq, sk, h, kh, d, win):
    q, k, v, _ = _inputs(sq, sk, h, kh, d)
    got = flash_attention_cvjp(*_t(q, k, v), window=win, q_block=32,
                               kv_block=32)
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


@pytest.mark.parametrize("impl", ["cvjp", "kernel"])
@pytest.mark.parametrize("sq,sk,h,kh,d,win", CASES)
def test_gradients_match_dense_ad(sq, sk, h, kh, d, win, impl):
    """The reference's case: gradients of sum(out * t) against autodiff of
    the dense reference, for ``flash_attention_cvjp`` and for the kernel
    wrapper's Function."""
    q, k, v, t = _inputs(sq, sk, h, kh, d)

    def loss_ref(q, k, v):
        o = jref.flash_attention(q, k, v, causal=True, window=win)
        return jnp.sum(o.astype(jnp.float32) * t)

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                      (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    if impl == "cvjp":
        o = flash_attention_cvjp(tq, tk, tv, window=win, q_block=32,
                                 kv_block=32)
    else:
        o = tfa.flash_attention(tq, tk, tv, causal=True, window=win)
    got = torch.autograd.grad((o * torch.from_numpy(t)).sum(), (tq, tk, tv))
    for a, b, nm in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-3, err_msg=f"d{nm}")


def test_gradients_match_flash_ad_path():
    """cvjp == autodiff through the zoo's blockwise ``"flash"`` path."""
    q, k, v, _ = _inputs(64, 64, 4, 2, 16, b=1)
    tq = torch.from_numpy(q).requires_grad_()
    g1, = torch.autograd.grad(flash_attention_cvjp(
        tq, *_t(k, v), q_block=32, kv_block=32).sum(), tq)
    g2, = torch.autograd.grad(tlayers.flash_attention(
        tq, *_t(k, v), causal=True, q_block=32, kv_block=32).sum(), tq)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("impl", ["cvjp", "kernel"])
def test_no_quadratic_residuals(impl):
    """What autograd saves for the backward is O(S·D): no saved tensor
    has an [S, S] tail (the blockwise autodiff path saves them)."""
    S, D = 256, 16
    q, k, v, _ = _inputs(S, S, 4, 2, D, b=1)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    tq, tk, tv = _t(q, k, v, grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if impl == "cvjp":
            o = flash_attention_cvjp(tq, tk, tv, q_block=64, kv_block=64)
        else:
            o = tfa.flash_attention(tq, tk, tv)
    o.sum().backward()
    assert saved and not any(s[-2:] in ((S, S), (64, 64))
                             for s in saved if len(s) >= 2), saved
    # the blockwise autodiff path does keep per-block probabilities
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tlayers.flash_attention(tq, tk, tv, q_block=64, kv_block=64).sum()
    assert any(s[-2:] == (64, 64) for s in saved if len(s) >= 2)


@pytest.mark.parametrize("sq,sk,h,kh,d,win", BLOCK_CASES)
def test_fwd_impl_and_lse_match_reference(sq, sk, h, kh, d, win):
    """The blockwise ``layers.flash_attention`` against ``_fwd_impl``'s out
    (ragged blocks of 32), and the dense plain forward's lse against its
    lse."""
    q, k, v, _ = _inputs(sq, sk, h, kh, d, seed=3)
    g = h // kh
    want_o, want_l = jcvjp._fwd_impl(
        jnp.asarray(q).reshape(2, sq, kh, g, d), jnp.asarray(k),
        jnp.asarray(v), win, q_block=32, kv_block=32, q_offset=sk - sq)
    want_o = np.asarray(want_o).reshape(2, sq, h, d)
    want_l = np.asarray(want_l).reshape(2, sq, h)
    out = tlayers.flash_attention(*_t(q, k, v), window=win, q_block=32,
                                  kv_block=32)
    assert _scaled(out, want_o) <= 1e-5
    out, lse = tfa.flash_attention_plain(*_t(q, k, v), window=win,
                                         return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, sq, h)
    assert np.abs(lse.numpy() - want_l).max() <= 1e-4
    assert torch.equal(out, tfa.flash_attention_plain(*_t(q, k, v),
                                                      window=win))


@pytest.mark.parametrize("blocks", [(32, 32), (512, 1024)])
@pytest.mark.parametrize("sq,sk,h,kh,d,win", BLOCK_CASES)
def test_bwd_plain_matches_bwd_impl(sq, sk, h, kh, d, win, blocks):
    """``flash_attention_bwd_plain`` against ``_bwd_impl`` on the same (q, k,
    v, out, lse, dO), 1e-4 scaled."""
    q, k, v, t = _inputs(sq, sk, h, kh, d, seed=4)
    qb, kb = blocks
    g = h // kh
    q5 = jnp.asarray(q).reshape(2, sq, kh, g, d)
    o, lse = jcvjp._fwd_impl(q5, jnp.asarray(k), jnp.asarray(v), win,
                             q_block=qb, kv_block=kb, q_offset=sk - sq)
    want = jcvjp._bwd_impl(q5, jnp.asarray(k), jnp.asarray(v), o, lse,
                           jnp.asarray(t).reshape(2, sq, kh, g, d), win,
                           q_block=qb, kv_block=kb, q_offset=sk - sq)
    got = tfa.flash_attention_bwd_plain(
        *_t(q, k, v), torch.from_numpy(np.array(o).reshape(2, sq, h, d)),
        torch.from_numpy(np.array(lse).reshape(2, sq, h)),
        torch.from_numpy(t), window=win, q_block=qb, kv_block=kb)
    for a, b, nm in zip(got, want, "qkv"):
        assert _scaled(a, np.asarray(b).reshape(a.shape)) <= 1e-4, nm
    # the wrapper on CPU tensors is the plain version
    via = tfa.flash_attention_bwd(
        *_t(q, k, v), torch.from_numpy(np.array(o).reshape(2, sq, h, d)),
        torch.from_numpy(np.array(lse).reshape(2, sq, h)),
        torch.from_numpy(t), window=win)
    if blocks == (512, 1024):
        assert all(torch.equal(a, b) for a, b in zip(via, got))


@pytest.mark.parametrize("impl", ["cvjp", "kernel"])
@pytest.mark.parametrize("sq,sk,h,kh,d,win", BLOCK_CASES)
def test_grad_matches_reference_cvjp(sq, sk, h, kh, d, win, impl):
    """``jax.grad`` of the reference's ``flash_attention_cvjp`` against the
    port's (``flash_attention_cvjp`` and the kernel Function), 1e-4
    scaled."""
    q, k, v, t = _inputs(sq, sk, h, kh, d, seed=5)

    def loss(q, k, v):
        return jnp.sum(jcvjp.flash_attention_cvjp(
            q, k, v, window=win, q_block=32, kv_block=32) * t)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    if impl == "cvjp":
        o = flash_attention_cvjp(tq, tk, tv, window=win, q_block=32,
                                 kv_block=32)
    else:
        o = tfa.flash_attention(tq, tk, tv, window=win)
    got = torch.autograd.grad((o * torch.from_numpy(t)).sum(), (tq, tk, tv))
    for a, b, nm in zip(got, want, "qkv"):
        assert _scaled(a, b) <= 1e-4, nm


@pytest.mark.parametrize("impl", ["cvjp", "kernel"])
def test_bf16_gradients_against_float64(impl):
    """bf16: p and ds are rounded as the reference rounds them; the port's
    gradients are within twice the reference's error against a float64
    evaluation of the same function."""
    sq, sk, h, kh, d, win = 64, 64, 4, 2, 32, 24
    q, k, v, t = _inputs(sq, sk, h, kh, d, seed=6)
    rb = lambda a: torch.from_numpy(a).to(torch.bfloat16)

    def loss(q, k, v):
        return jnp.sum(jcvjp.flash_attention_cvjp(
            q, k, v, window=win, q_block=32, kv_block=32).astype(
                jnp.float32) * t)

    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jax.grad(loss, argnums=(0, 1, 2))(*jb)
    exact_in = [rb(a).double().requires_grad_() for a in (q, k, v)]
    o64 = tfa.flash_attention_plain(*exact_in, window=win)
    exact = torch.autograd.grad((o64 * torch.from_numpy(t).double()).sum(),
                                exact_in)
    tq, tk, tv = (rb(a).requires_grad_() for a in (q, k, v))
    if impl == "cvjp":
        o = flash_attention_cvjp(tq, tk, tv, window=win, q_block=32,
                                 kv_block=32)
    else:
        o = tfa.flash_attention(tq, tk, tv, window=win)
    got = torch.autograd.grad((o.float() * torch.from_numpy(t)).sum(),
                              (tq, tk, tv))
    for a, b, e, nm in zip(got, want, exact, "qkv"):
        assert a.dtype == torch.bfloat16
        e = e.numpy()
        ref_err = np.abs(np.asarray(b.astype(jnp.float32), np.float64)
                         - e).max()
        assert np.abs(a.double().numpy() - e).max() <= 2 * ref_err, nm


def test_cvjp_is_causal_only_and_the_layer_trains():
    q, k, v, _ = _inputs(16, 16, 2, 1, 8)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_cvjp(*_t(q, k, v), causal=False)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_cvjp(*_t(q, k, v), q_offset=3)
    assert torch.equal(flash_attention_cvjp(*_t(q, k, v), q_offset=0),
                       tfa.flash_attention(*_t(q, k, v)))
    # attn_impl="flash_cvjp" is a layer choice that trains
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    from repro_torch.models.template import init_params
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              compute_dtype="float32")
    params = init_params(zoo.model_template(cfg), 0, device="cpu")
    batch = zoo.make_inputs(cfg, 2, 0, seq=12, device="cpu")
    grads = {}
    for impl in ("flash_cvjp", "flash"):
        loss, g = steps.loss_and_grads(
            cfg, steps.HParams(attn_impl=impl, remat="none"), params, batch)
        grads[impl] = g
        assert math.isfinite(float(loss))
    a, b = grads["flash_cvjp"]["layers"]["attn"]["q"], \
        grads["flash"]["layers"]["attn"]["q"]
    assert float(a.abs().max()) > 0
    assert _scaled(a, b) <= 1e-4


def test_kernel_function_saves_lse_only_under_autograd(monkeypatch):
    """The wrapper computes lse (and builds the Function) only where
    autograd needs it; under no_grad it is the plain forward alone."""
    calls = []
    real = tfa.flash_attention_plain

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_plain", spy)
    q, k, v, _ = _inputs(16, 16, 2, 1, 8)
    tq, tk, tv = _t(q, k, v, grad=True)
    with torch.no_grad():
        o = tfa.flash_attention(tq, tk, tv)
    assert calls == [False] and o.grad_fn is None
    o = tfa.flash_attention(tq, tk, tv)
    assert calls == [False, True] and o.grad_fn is not None
    calls.clear()
    tfa.flash_attention(*_t(q, k, v))
    assert calls == [False]
