"""LM serving: the port's prefill, decode and forward against the
reference's, on the reduced configs of the dense archs (qwen3, gemma3,
phi3, yi, musicgen), of the MoE, SSM and hybrid ones (deepseek-moe, dbrx,
mamba2, jamba) and of the VLM (llama-3.2-vision, with image embeddings).

Both packages get the same parameters (the reference's ``init_params``,
carried across by ``zoo.params_from_jax``) and the same numpy inputs.  On
the CPU the port's ``attn_impl="pallas"`` runs the kernel's plain version
and ``ssd_scan`` its plain version, so this checks the layer stack, the
cache layout and the decode path end to end; ``chip_smoke.py`` holds the
kernels themselves on the card.

The reference's own ``attn_impl="pallas"`` prefill cannot run inside its
layer scan (the per-layer window reaches the Pallas kernel as a traced
value), so the reference side is always its ``"flash"`` prefill, the same
function through ``layers.flash_attention``.  fp32 is held at the
reference's ``test_prefill_matches_forward`` bound (2e-4) for the dense
archs and within 1e-4 of max|reference| for the others; in bf16 the two
packages round at different points, so each is measured against a float64
evaluation and the port may be at most twice the reference's error.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import zoo as jzoo
from repro.models.template import init_params as jinit_params
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import zoo
from repro_torch.models.template import (abstract_params,
                                         count_template_params, init_params,
                                         tree_leaves)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
DENSE = ["qwen3-8b", "gemma3-4b", "phi3-mini-3.8b", "yi-34b",
         "musicgen-medium"]
# MoE, SSM and hybrid
MIXED = ["deepseek-moe-16b", "dbrx-132b", "mamba2-2.7b", "jamba-v0.1-52b"]
S = 24          # > gemma3's reduced window of 8
_REF = {}


def _configs(arch, dtype):
    return (dataclasses.replace(jget_config(arch).reduced(),
                                compute_dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(),
                                compute_dtype=dtype))


def _params(arch):
    jcfg, _ = _configs(arch, "float32")
    jp = jinit_params(jzoo.model_template(jcfg), jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        # the cross layers' tanh gate starts at 0, where they add nothing:
        # open it so that the image reaches the logits and the cache
        jp["periods"]["cross"]["gate"] = jnp.full_like(
            jp["periods"]["cross"]["gate"], 0.5)
    return jp, zoo.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def _batch(cfg, seq=S, seed=1):
    """(reference batch, port batch) from the same numpy draw."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        e = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(0, cfg.vocab_size, (2, seq))
    return ({"tokens": jnp.asarray(t, jnp.int32)},
            {"tokens": torch.from_numpy(t)})


def _reference(arch, dtype):
    """The reference's flash prefill, cached per (arch, dtype)."""
    if (arch, dtype) not in _REF:
        jcfg, _ = _configs(arch, dtype)
        jp, tp = _params(arch)
        jb, tb = _batch(jcfg)
        logits, cache = jzoo.prefill(jcfg, jp, jb)
        _REF[arch, dtype] = (jp, tp, tb, np.asarray(logits, np.float64),
                             {k: np.asarray(cache["layers"][k].astype(
                                 jnp.float32), np.float64) for k in "kv"})
    return _REF[arch, dtype]


def _f64(t):
    return t.double().numpy()


@pytest.mark.parametrize("attn_impl", ["pallas", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference_f32(arch, attn_impl):
    _, tp, tb, want, want_cache = _reference(arch, "float32")
    _, tcfg = _configs(arch, "float32")
    logits, cache = steps.build_prefill_step(
        tcfg, steps.HParams(attn_impl=attn_impl))(tp, tb)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(_f64(logits), want, rtol=2e-4, atol=2e-4)
    assert set(cache) == {"layers"} and set(cache["layers"]) == {"k", "v"}
    for k in "kv":
        assert tuple(cache["layers"][k].shape) == want_cache[k].shape == (
            tcfg.n_layers, 2, S, tcfg.n_kv_heads, tcfg.head_dim)
        np.testing.assert_allclose(_f64(cache["layers"][k]), want_cache[k],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("attn_impl", ["pallas", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_bf16_against_float64(arch, attn_impl):
    _, tp, tb, want, want_cache = _reference(arch, "bfloat16")
    _, tcfg = _configs(arch, "bfloat16")
    logits, cache = zoo.prefill(tcfg, tp, tb, attn_impl=attn_impl)
    assert cache["layers"]["k"].dtype == torch.bfloat16
    ocfg = dataclasses.replace(tcfg, compute_dtype="float64")
    exact, exact_cache = zoo.prefill(ocfg, tp, tb, attn_impl="flash")
    exact = exact.numpy()
    ref_err = np.abs(want - exact).max()
    assert 0 < np.abs(_f64(logits) - exact).max() <= 2 * ref_err
    for k in "kv":
        e = exact_cache["layers"][k].numpy()
        ref_err = np.abs(want_cache[k] - e).max()
        assert np.abs(_f64(cache["layers"][k]) - e).max() <= 2 * ref_err


def _pad_ref(cache, n):
    return {"layers": {k: jnp.pad(a, [(0, 0), (0, 0), (0, n), (0, 0),
                                      (0, 0)])
                       for k, a in cache["layers"].items()}}


def _pad_port(cache, n):
    return {"layers": {k: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, n))
                       for k, a in cache["layers"].items()}}


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_reference(arch):
    """Prefill S, pad the cache by 8, decode two tokens: the port's greedy
    tokens equal the reference's, and its cache takes the new entries."""
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(arch)
    jb, tb = _batch(jcfg, seed=3)
    _, jcache = jzoo.prefill(jcfg, jp, jb)
    _, tcache = steps.build_prefill_step(tcfg, steps.HParams())(tp, tb)
    jcache, tcache = _pad_ref(jcache, 8), _pad_port(tcache, 8)
    serve = steps.build_serve_step(tcfg, steps.HParams())
    tok = np.random.default_rng(4).integers(0, jcfg.vocab_size, 2)
    jt, tt = jnp.asarray(tok, jnp.int32), torch.from_numpy(tok)
    for pos in (S, S + 1):
        jt, jcache = jzoo.decode_step(jcfg, jp, jcache, jt, jnp.array(pos))
        tt, out = serve(tp, tcache, tt, pos)
        assert out is tcache and tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for k in "kv":
        np.testing.assert_allclose(_f64(tcache["layers"][k]),
                                   np.asarray(jcache["layers"][k]),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-4b"])
def test_decode_consistent_with_forward(arch):
    """Greedy token from (prefill S through the kernel path, decode S) ==
    argmax of the kernel path's forward over S + 1, as the reference's
    ``test_decode_consistent_with_forward``."""
    _, tcfg = _configs(arch, "float32")
    _, tp = _params(arch)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, S + 1)))
    logits, _ = zoo.forward(tcfg, tp, {"tokens": toks}, attn_impl="pallas")
    _, cache = zoo.prefill(tcfg, tp, {"tokens": toks[:, :S]},
                           attn_impl="pallas")
    got, _ = zoo.decode_step(tcfg, tp, _pad_port(cache, 8), toks[:, S], S)
    assert torch.equal(got.long(), logits[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(arch)
    jb, tb = _batch(jcfg, seq=12, seed=6)
    want, _ = jzoo.forward(jcfg, jp, jb, remat="none")
    got, aux = zoo.forward(tcfg, tp, tb, attn_impl="pallas")
    assert float(aux) == 0.0
    np.testing.assert_allclose(_f64(got), np.asarray(want, np.float64),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_analytic(arch):
    """Full size, on ``meta``: nothing is allocated."""
    cfg = get_config(arch)
    tmpl = zoo.model_template(cfg)
    tp = count_template_params(tmpl)
    assert abs(tp - cfg.count_params()) / cfg.count_params() < 0.02
    ap = abstract_params(tmpl)
    leaves = tree_leaves(ap)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == tp
    assert tuple(ap["layers"]["attn"]["q"].shape) == (cfg.n_layers,
                                                      cfg.d_model, cfg.q_dim)
    cache = zoo.init_cache(cfg, 2, 128, abstract=True)
    assert cache["layers"]["k"].device.type == "meta"
    assert tuple(cache["layers"]["k"].shape) == (
        cfg.n_layers, 2, 128, cfg.n_kv_heads, cfg.head_dim)


# -- MoE, SSM and hybrid -----------------------------------------------------

def _flat(tree, prefix=""):
    """A nested dict of arrays or tensors as {"a/b/c": leaf}."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _np64(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.double().numpy()
    return np.asarray(jnp.asarray(leaf).astype(jnp.float32), np.float64)


def _scaled(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _reference_mixed(arch, dtype):
    """The reference's prefill on a mixed arch: (params of both, port
    batch, last logits, flat cache), cached per (arch, dtype)."""
    if (arch, dtype) not in _REF:
        jcfg, _ = _configs(arch, dtype)
        jp, tp = _params(arch)
        jb, tb = _batch(jcfg)
        logits, cache = jzoo.prefill(jcfg, jp, jb)
        _REF[arch, dtype] = (jp, tp, tb, np.asarray(logits, np.float64),
                             {k: _np64(v) for k, v in _flat(cache).items()})
    return _REF[arch, dtype]


def _pad_attn(cache, n):
    """Every k / v leaf (a port or reference cache) padded by n positions
    along its sequence axis (the third from the end)."""
    def pad(key, a):
        if key not in ("k", "v"):
            return a
        if isinstance(a, torch.Tensor):
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, n))
        widths = [(0, 0)] * a.ndim
        widths[-3] = (0, n)
        return jnp.pad(a, widths)
    return {k: ({kk: pad(kk, vv) for kk, vv in v.items()}
                if isinstance(v, dict) else v) for k, v in cache.items()}


@pytest.mark.parametrize("attn_impl", ["pallas", "flash"])
@pytest.mark.parametrize("arch", MIXED)
def test_mixed_prefill_matches_reference_f32(arch, attn_impl):
    _, tp, tb, want, want_cache = _reference_mixed(arch, "float32")
    _, tcfg = _configs(arch, "float32")
    logits, cache = steps.build_prefill_step(
        tcfg, steps.HParams(attn_impl=attn_impl))(tp, tb)
    assert logits.dtype == torch.float32 and logits.shape == (
        2, tcfg.vocab_size)
    assert _scaled(_f64(logits), want) <= 1e-4
    got = _flat(cache)
    assert set(got) == set(want_cache)
    for k, w in want_cache.items():
        assert tuple(got[k].shape) == w.shape
        assert _scaled(_f64(got[k]), w) <= 1e-4, k


@pytest.mark.parametrize("attn_impl", ["pallas", "flash"])
@pytest.mark.parametrize("arch", MIXED)
def test_mixed_prefill_bf16_against_float64(arch, attn_impl):
    """bf16 logits and caches against the port's float64 evaluation (its
    scan runs in float32, the kernel's type, far inside bf16's error): the
    port's RMS error at most twice the reference's.  RMS, not the largest
    error: where bf16 flips a token's expert choice against float64, that
    token dominates the largest error of both packages alike."""
    _, tp, tb, want, want_cache = _reference_mixed(arch, "bfloat16")
    _, tcfg = _configs(arch, "bfloat16")
    logits, cache = zoo.prefill(tcfg, tp, tb, attn_impl=attn_impl)
    got = _flat(cache)
    for k, t in got.items():
        assert t.dtype == (torch.float32 if k.endswith("ssm")
                           else torch.bfloat16), k
    ocfg = dataclasses.replace(tcfg, compute_dtype="float64")
    exact, exact_cache = zoo.prefill(ocfg, tp, tb, attn_impl="flash")

    def rms(a):
        return np.sqrt(np.mean(np.square(a)))
    exact = exact.numpy()
    assert 0 < rms(_f64(logits) - exact) <= 2 * rms(want - exact)
    for k, e in _flat(exact_cache).items():
        e = e.numpy()
        assert rms(_f64(got[k]) - e) <= 2 * rms(want_cache[k] - e), k


@pytest.mark.parametrize("arch", MIXED)
def test_mixed_decode_matches_reference(arch):
    """Prefill S, pad the attention caches by 8, decode two tokens: the
    port's greedy tokens equal the reference's, and its cache (written in
    place) takes the same values."""
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(arch)
    jb, tb = _batch(jcfg, seed=3)
    _, jcache = jzoo.prefill(jcfg, jp, jb)
    _, tcache = steps.build_prefill_step(tcfg, steps.HParams())(tp, tb)
    jcache, tcache = _pad_attn(jcache, 8), _pad_attn(tcache, 8)
    serve = steps.build_serve_step(tcfg, steps.HParams())
    tok = np.random.default_rng(4).integers(0, jcfg.vocab_size, 2)
    jt, tt = jnp.asarray(tok, jnp.int32), torch.from_numpy(tok)
    for pos in (S, S + 1):
        jt, jcache = jzoo.decode_step(jcfg, jp, jcache, jt, jnp.array(pos))
        tt, out = serve(tp, tcache, tt, pos)
        assert out is tcache and tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    want = _flat(jcache)
    for k, t in _flat(tcache).items():
        assert _scaled(_f64(t), _np64(want[k])) <= 1e-4, k


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b",
                                  "deepseek-moe-16b"])
def test_mixed_decode_consistent_with_forward(arch, monkeypatch):
    """Greedy token from (prefill S through the kernel path, decode S) ==
    argmax of the kernel path's forward over S + 1.  An MoE layer's
    capacity follows its token count, so the forward over S + 1 may drop
    (token, expert) pairs that prefill over S and a decode step keep; the
    reference's own check leaves deepseek out.  Here deepseek runs with a
    capacity that drops nothing, which makes the two paths the same
    function again."""
    if arch == "deepseek-moe-16b":
        monkeypatch.setattr(L, "moe_ffn", functools.partial(
            L.moe_ffn, capacity_factor=100.0))
    _, tcfg = _configs(arch, "float32")
    _, tp = _params(arch)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, S + 1)))
    logits, _ = zoo.forward(tcfg, tp, {"tokens": toks}, attn_impl="pallas")
    _, cache = zoo.prefill(tcfg, tp, {"tokens": toks[:, :S]},
                           attn_impl="pallas")
    got, _ = zoo.decode_step(tcfg, tp, _pad_attn(cache, 8), toks[:, S], S)
    assert torch.equal(got.long(), logits[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", MIXED)
def test_mixed_forward_matches_reference(arch):
    """Logits within 1e-4 of max|reference|; the aux loss (the MoE layers'
    load-balance sum, 0 without MoE) within 1e-5 of the reference's."""
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(arch)
    jb, tb = _batch(jcfg, seq=12, seed=6)
    want, jaux = jzoo.forward(jcfg, jp, jb, remat="none")
    got, aux = zoo.forward(tcfg, tp, tb, attn_impl="pallas")
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert _scaled(_f64(got), np.asarray(want, np.float64)) <= 1e-4
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-6)
    assert (float(aux) > 0) == bool(tcfg.n_experts)


@pytest.mark.parametrize("arch", MIXED)
def test_mixed_templates_and_caches(arch):
    """Full size, on ``meta``: the template's leaves have the reference's
    keys and shapes, the count is the analytic one, and ``init_cache`` has
    the reference's layout and dtypes."""
    cfg = get_config(arch)
    tmpl = zoo.model_template(cfg)
    tp = count_template_params(tmpl)
    assert abs(tp - cfg.count_params()) / cfg.count_params() < 0.02
    want = _flat(jzoo.model_template(jget_config(arch)))
    got = _flat(abstract_params(tmpl))
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == want[k].shape
    want = _flat(jzoo.init_cache(jget_config(arch), 2, 128, abstract=True))
    got = _flat(zoo.init_cache(cfg, 2, 128, abstract=True))
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == want[k].shape
        assert str(t.dtype)[6:] == str(want[k].dtype), k


def test_mixed_families_default_to_cuda():
    """``device=None`` means CUDA for the new families too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for arch in ("mamba2-2.7b", "jamba-v0.1-52b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(zoo.model_template(cfg), 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            zoo.make_inputs(cfg, 2, 0, seq=4)
        with pytest.raises(RuntimeError, match="CUDA"):
            zoo.init_cache(cfg, 2, 4)


def test_init_params_ssm_rules():
    """a_log: log of uniform [1, 16) (mamba2's A init); d ones; dt_bias
    zeros; the conv weight std 0.5.  ``dtype=`` casts as it draws, equal to
    ``serving_params`` of the float32 draw."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    tmpl = zoo.model_template(cfg)
    p = init_params(tmpl, 0, device="cpu")
    m = p["blocks"]["mamba_moe"]["mamba"]
    assert tuple(m["a_log"].shape) == (1, 4, cfg.ssm_heads)
    a = m["a_log"]
    assert float(a.min()) >= 0.0 and float(a.max()) < np.log(16.0)
    assert float(a.std()) > 0.3
    assert bool((m["d"] == 1).all()) and not m["dt_bias"].any()
    assert abs(float(m["conv"].std()) / 0.5 - 1.0) < 0.1
    sp = steps.serving_params(cfg, steps.HParams(), p)
    direct = init_params(tmpl, 0, device="cpu", dtype="bfloat16")
    for k, t in _flat(direct).items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, _flat(sp)[k]), k


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_mixed_serving_params_bf16(arch):
    """Served in bf16 (``a_log``, ``d`` and ``dt_bias`` too, as the
    reference's ``serving_params_struct``): prefill and four decode steps
    through the step builders, finite logits and in-range tokens."""
    cfg = get_config(arch).reduced()
    hp = steps.HParams()
    sp = steps.serving_params(cfg, hp, init_params(zoo.model_template(cfg),
                                                   1, device="cpu"))
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(sp))
    batch = zoo.make_inputs(cfg, 2, 0, seq=20, device="cpu")
    logits, cache = steps.build_prefill_step(cfg, hp)(sp, batch)
    assert torch.isfinite(logits).all()
    cache = _pad_attn(cache, 4)
    tok, serve = logits.argmax(-1), steps.build_serve_step(cfg, hp)
    for pos in range(20, 24):
        tok, cache = serve(sp, cache, tok, pos)
        assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size


# -- VLM ---------------------------------------------------------------------

VLM = "llama-3.2-vision-90b"


def _vlm_batch(cfg, seq=S, seed=1):
    """(reference batch, port batch): tokens and image embeddings from one
    numpy draw."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (2, seq))
    im = rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model)).astype(
        np.float32)
    return ({"tokens": jnp.asarray(t, jnp.int32),
             "image_embeds": jnp.asarray(im)},
            {"tokens": torch.from_numpy(t),
             "image_embeds": torch.from_numpy(im)})


def _reference_vlm(dtype):
    """The reference's VLM prefill, cached per dtype."""
    if (VLM, dtype) not in _REF:
        jcfg, _ = _configs(VLM, dtype)
        jp, tp = _params(VLM)
        jb, tb = _vlm_batch(jcfg)
        logits, cache = jzoo.prefill(jcfg, jp, jb)
        _REF[VLM, dtype] = (jp, tp, tb, np.asarray(logits, np.float64),
                            {k: _np64(v) for k, v in _flat(cache).items()})
    return _REF[VLM, dtype]


@pytest.mark.parametrize("attn_impl", ["pallas", "flash"])
def test_vlm_prefill_matches_reference_f32(attn_impl):
    """Logits and every cache leaf (the self layers' k / v, the cross
    layers' image k / v) within 1e-4 of max|reference|."""
    _, tp, tb, want, want_cache = _reference_vlm("float32")
    _, tcfg = _configs(VLM, "float32")
    logits, cache = steps.build_prefill_step(
        tcfg, steps.HParams(attn_impl=attn_impl))(tp, tb)
    assert _scaled(_f64(logits), want) <= 1e-4
    got = _flat(cache)
    assert set(got) == set(want_cache) == {"self/k", "self/v", "cross/xk",
                                           "cross/xv"}
    for k, w in want_cache.items():
        assert tuple(got[k].shape) == w.shape
        assert _scaled(_f64(got[k]), w) <= 1e-4, k


@pytest.mark.parametrize("attn_impl", ["pallas", "flash"])
def test_vlm_prefill_bf16_against_float64(attn_impl):
    """bf16: the port's RMS error against its float64 evaluation at most
    twice the reference's, as for the other families."""
    _, tp, tb, want, want_cache = _reference_vlm("bfloat16")
    _, tcfg = _configs(VLM, "bfloat16")
    logits, cache = zoo.prefill(tcfg, tp, tb, attn_impl=attn_impl)
    ocfg = dataclasses.replace(tcfg, compute_dtype="float64")
    exact, exact_cache = zoo.prefill(ocfg, tp, tb, attn_impl="flash")

    def rms(a):
        return np.sqrt(np.mean(np.square(a)))
    exact = exact.numpy()
    assert 0 < rms(_f64(logits) - exact) <= 2 * rms(want - exact)
    got = _flat(cache)
    for k, e in _flat(exact_cache).items():
        assert got[k].dtype == torch.bfloat16
        e = e.numpy()
        assert rms(_f64(got[k]) - e) <= 2 * rms(want_cache[k] - e), k


def test_vlm_decode_matches_reference():
    """Prefill S, pad the self-attention caches by 8, decode two tokens:
    greedy tokens equal to the reference's, caches within 1e-4 scaled."""
    jcfg, tcfg = _configs(VLM, "float32")
    jp, tp = _params(VLM)
    jb, tb = _vlm_batch(jcfg, seed=3)
    _, jcache = jzoo.prefill(jcfg, jp, jb)
    _, tcache = steps.build_prefill_step(tcfg, steps.HParams())(tp, tb)
    jcache, tcache = _pad_attn(jcache, 8), _pad_attn(tcache, 8)
    serve = steps.build_serve_step(tcfg, steps.HParams())
    tok = np.random.default_rng(4).integers(0, jcfg.vocab_size, 2)
    jt, tt = jnp.asarray(tok, jnp.int32), torch.from_numpy(tok)
    for pos in (S, S + 1):
        jt, jcache = jzoo.decode_step(jcfg, jp, jcache, jt, jnp.array(pos))
        tt, out = serve(tp, tcache, tt, pos)
        assert out is tcache
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    want = _flat(jcache)
    for k, t in _flat(tcache).items():
        assert _scaled(_f64(t), _np64(want[k])) <= 1e-4, k


def test_vlm_decode_consistent_with_forward():
    """Greedy token of (prefill S through the kernel path, decode S) ==
    argmax of the kernel path's forward over S + 1, same image."""
    _, tcfg = _configs(VLM, "float32")
    _, tp = _params(VLM)
    _, tb = _vlm_batch(tcfg, seq=S + 1, seed=5)
    toks = tb["tokens"]
    logits, _ = zoo.forward(tcfg, tp, tb, attn_impl="pallas")
    _, cache = zoo.prefill(tcfg, tp, {"tokens": toks[:, :S],
                                      "image_embeds": tb["image_embeds"]},
                           attn_impl="pallas")
    got, _ = zoo.decode_step(tcfg, tp, _pad_attn(cache, 8), toks[:, S], S)
    assert torch.equal(got.long(), logits[:, -1].argmax(-1))


@pytest.mark.parametrize("attn_impl", ["pallas", "flash"])
def test_vlm_forward_matches_reference(attn_impl):
    jcfg, tcfg = _configs(VLM, "float32")
    jp, tp = _params(VLM)
    jb, tb = _vlm_batch(jcfg, seq=12, seed=6)
    want, jaux = jzoo.forward(jcfg, jp, jb, remat="none")
    got, aux = zoo.forward(tcfg, tp, tb, attn_impl=attn_impl)
    assert float(aux) == float(jaux) == 0.0
    assert _scaled(_f64(got), np.asarray(want, np.float64)) <= 1e-4


def test_vlm_cross_attention_matches_reference():
    """``cross_attn_forward`` (blockwise, every patch visible, q offset 0)
    and ``cross_attn_decode`` on the reference's cross-layer weights."""
    from repro.models import layers as jlayers
    jcfg, tcfg = _configs(VLM, "float32")
    jp, tp = _params(VLM)
    jx = {k: jax.tree.map(lambda a: a[0], v)
          for k, v in jp["periods"]["cross"].items()}["xattn"]
    tx = {k: v[0] for k, v in tp["periods"]["cross"]["xattn"].items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 11, tcfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, tcfg.n_image_tokens,
                               tcfg.d_model)).astype(np.float32)
    want, wk, wv = jlayers.cross_attn_forward(jcfg, jx, jnp.asarray(x),
                                              jnp.asarray(src))
    got, k, v = L.cross_attn_forward(tcfg, tx, torch.from_numpy(x),
                                     torch.from_numpy(src))
    for a, b in ((got, want), (k, wk), (v, wv)):
        assert _scaled(_f64(a), np.asarray(b, np.float64)) <= 1e-5
    want = jlayers.cross_attn_decode(jcfg, jx, jnp.asarray(x[:, :1]), wk, wv)
    got = L.cross_attn_decode(tcfg, tx, torch.from_numpy(x[:, :1]), k, v)
    assert _scaled(_f64(got), np.asarray(want, np.float64)) <= 1e-5


def test_vlm_template_and_cache():
    """Full size, on ``meta``: the reference's keys, shapes and cache
    layout; the count is the analytic one.  The template no longer
    raises."""
    cfg = get_config(VLM)
    tmpl = zoo.model_template(cfg)
    assert abs(count_template_params(tmpl) - cfg.count_params()) \
        / cfg.count_params() < 0.02
    want = _flat(jzoo.model_template(jget_config(VLM)))
    got = _flat(abstract_params(tmpl))
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
    assert tuple(got["periods/cross/gate"].shape) == (20, 1)
    want = _flat(jzoo.init_cache(jget_config(VLM), 2, 128, abstract=True))
    got = _flat(zoo.init_cache(cfg, 2, 128, abstract=True))
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape
        assert str(t.dtype)[6:] == str(want[k].dtype), k


def test_vlm_serving_params_bf16():
    """Served in bf16 through ``build_prefill_step`` and
    ``build_serve_step``: prefill and four decode steps, finite logits,
    in-range tokens, the image cache untouched by decode."""
    cfg = get_config(VLM).reduced()
    hp = steps.HParams()
    sp = steps.serving_params(cfg, hp, init_params(zoo.model_template(cfg),
                                                   1, device="cpu"))
    batch = zoo.make_inputs(cfg, 2, 0, seq=20, device="cpu")
    assert batch["image_embeds"].dtype == torch.bfloat16
    logits, cache = steps.build_prefill_step(cfg, hp)(sp, batch)
    assert torch.isfinite(logits).all()
    xk = cache["cross"]["xk"].clone()
    cache = _pad_attn(cache, 4)
    tok, serve = logits.argmax(-1), steps.build_serve_step(cfg, hp)
    for pos in range(20, 24):
        tok, cache = serve(sp, cache, tok, pos)
        assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size
    assert torch.equal(cache["cross"]["xk"], xk)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "musicgen-medium", *MIXED,
                                  "llama-3.2-vision-90b"])
def test_make_inputs_match_input_structs(arch, kind):
    cfg = get_config(arch).reduced()
    shape = ShapeConfig(f"small_{kind}", kind, 12, 3)
    structs = zoo.input_structs(cfg, shape)
    batch = zoo.make_inputs(cfg, shape, 0, device="cpu")
    assert set(batch) == set(structs)
    for name, st in structs.items():
        assert st.device.type == "meta"
        got = batch[name]
        if name == "pos":
            assert got == shape.seq_len - 1 and st.shape == ()
            continue
        assert tuple(got.shape) == tuple(st.shape)
        assert got.is_floating_point() == st.is_floating_point()
        if not got.is_floating_point():
            assert 0 <= int(got.min()) and int(got.max()) < cfg.vocab_size
    again = zoo.make_inputs(cfg, shape, np.random.default_rng(0),
                            device="cpu")
    assert all(torch.equal(torch.as_tensor(batch[k]),
                           torch.as_tensor(again[k])) for k in batch)


def test_entry_points_default_to_cuda():
    """``device=None`` means CUDA: without it, the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen3-8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(zoo.model_template(cfg), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.make_inputs(cfg, 2, 0, seq=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.init_cache(cfg, 2, 4)


def test_init_params_follows_the_reference_rules():
    cfg = get_config("qwen3-8b").reduced()
    p = init_params(zoo.model_template(cfg), torch.Generator().manual_seed(0),
                    device="cpu")
    q = p["layers"]["attn"]["q"]
    assert q.dtype == torch.float32 and tuple(q.shape) == (
        cfg.n_layers, cfg.d_model, cfg.q_dim)
    # normal: std scale / sqrt(fan_in); scaled: std 0.02; norms: zeros
    assert abs(float(q.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(p["embed"].std()) / 0.02 - 1.0) < 0.05
    assert not p["final_norm"].any() and not p["layers"]["ln1"].any()
    again = init_params(zoo.model_template(cfg), 0, device="cpu")
    assert torch.equal(again["lm_head"],
                       init_params(zoo.model_template(cfg), 0,
                                   device="cpu")["lm_head"])


def test_serving_params_and_hparams():
    assert steps.HParams().attn_impl == "pallas"
    assert steps.HParams().serve_dtype == "bfloat16"
    cfg = get_config("gemma3-4b").reduced()
    p = init_params(zoo.model_template(cfg), 0, device="cpu")
    sp = steps.serving_params(cfg, steps.HParams(), p)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(sp))
    assert torch.equal(sp["embed"], p["embed"].to(torch.bfloat16))
    batch = zoo.make_inputs(cfg, 2, np.random.default_rng(0), seq=20,
                            device="cpu")
    logits, cache = steps.build_prefill_step(cfg, steps.HParams())(sp, batch)
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(
        logits).all()
    assert cache["layers"]["k"].dtype == torch.bfloat16


def test_serving_runs_without_jax():
    """Prefill and decode through ``repro_torch.launch.steps`` in a fresh
    interpreter: neither JAX nor the reference package is imported."""
    code = """
import sys, torch
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import zoo
from repro_torch.models.template import init_params
import repro_torch.kernels.ops
cfg = get_config("qwen3-8b").reduced()
hp = steps.HParams()
params = steps.serving_params(cfg, hp, init_params(zoo.model_template(cfg),
                                                   0, device="cpu"))
batch = zoo.make_inputs(cfg, 2, 0, seq=16, device="cpu")
logits, cache = steps.build_prefill_step(cfg, hp)(params, batch)
cache = {"layers": {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
                    for k, v in cache["layers"].items()}}
tok = logits.argmax(-1)
serve = steps.build_serve_step(cfg, hp)
for pos in range(16, 20):
    tok, cache = serve(params, cache, tok, pos)
assert tok.shape == (2,) and cache["layers"]["k"].shape[2] == 20
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
