"""LM training: the port's ``launch/steps.py::build_train_step`` against the
reference's, from the same state.

The reference's ``init_state`` (params, AdamW moments, step) is carried
into the port by ``zoo.params_from_jax``; both packages then take one step
on the same numpy batch, in float32 on the reduced configs.  On the CPU the
port's attention kernel and ``ssd_scan`` run their plain versions, forward
and backward (``kernels/flash_attention.py``, ``kernels/ssd_scan.py``), so
this holds the whole loss, its gradients through the kernels' autograd
Functions and the in-place AdamW against ``jax.value_and_grad`` and the
reference's AdamW.  Tolerances: loss and grad norm within 1e-5 relative;
each gradient leaf (read from the first moment, which one step from zero
makes (1 - b1) times the clipped gradient; the state starts at step 1,
where the warmup's learning rate is no longer 0) within 1e-4 of the leaf's
largest reference value; each updated parameter within 1e-3 of a step
where its gradient is resolved (AdamW moves an element by about lr times
the sign of its gradient, whatever the gradient's size).  Where the step rounds
to bf16 (``cast_once``: bf16 weights and gradients; ``grad_cast``: a bf16
cotangent per layer) the two packages round float32 values that differ in
their last bits, so a gradient may differ by one bf16 step of its largest
value: 2**-7 scaled.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.optim import adam as jadam
from repro_torch.checkpoint.ckpt import tree_items
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import zoo
from repro_torch.optim import adam

ARCHS = ["qwen3-8b", "gemma3-4b", "deepseek-moe-16b", "mamba2-2.7b",
         "jamba-v0.1-52b", "llama-3.2-vision-90b"]
B, S = 2, 20                    # S > gemma3's reduced window of 8
_STATE = {}


def _configs(arch):
    return (dataclasses.replace(jget_config(arch).reduced(),
                                compute_dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(),
                                compute_dtype="float32"))


def _opt(**kw):
    return dict(optimizer=dataclasses.replace(
        jadam.AdamWConfig(warmup_steps=2, total_steps=10), **kw))


def _jstate(arch):
    """The reference's init_state, as numpy (cached per arch), at step 1:
    the warmup's learning rate is 0 at step 0."""
    if arch not in _STATE:
        jcfg, _ = _configs(arch)
        st = jax.tree.map(np.asarray, jsteps.init_state(
            jcfg, jax.random.PRNGKey(0)))
        st["step"] = np.asarray(1, np.int32)
        if jcfg.family == "vlm":
            # the cross layers' tanh gate starts at 0, where their
            # attention has no gradient: open it so that it has one
            gate = st["params"]["periods"]["cross"]["gate"]
            st["params"]["periods"]["cross"]["gate"] = np.full_like(gate,
                                                                    0.5)
        _STATE[arch] = st
    return _STATE[arch]


def _port_state(jstate):
    st = zoo.params_from_jax({"params": jstate["params"],
                              "opt": jstate["opt"]}, device="cpu")
    st["step"] = torch.tensor(int(jstate["step"]), dtype=torch.int32)
    return st


def _batch(cfg, seed=1, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, S))
    labs = rng.integers(0, cfg.vocab_size, (b, S))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labs, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    if cfg.family == "vlm":
        im = rng.standard_normal((b, cfg.n_image_tokens,
                                  cfg.d_model)).astype(np.float32)
        jb["image_embeds"] = jnp.asarray(im)
        tb["image_embeds"] = torch.from_numpy(im)
    return jb, tb


def _flat(tree):
    return {"/".join(map(str, k)): np.asarray(v, np.float64)
            if not isinstance(v, torch.Tensor) else v.double().numpy()
            for k, v in tree_items(tree)}


def _step_both(arch, jhp_kw=None, thp_kw=None, seed=1):
    jcfg, tcfg = _configs(arch)
    jhp = jsteps.HParams(**{"remat": "none", **_opt(), **(jhp_kw or {})})
    thp = steps.HParams(**{**_opt(), **(thp_kw or {})})
    jst = _jstate(arch)
    jb, tb = _batch(tcfg, seed)
    jnew, jm = jax.jit(jsteps.build_train_step(jcfg, jhp))(
        jax.tree.map(jnp.asarray, jst), jb)
    tnew, tm = steps.build_train_step(tcfg, thp)(_port_state(jst), tb)
    return (jax.tree.map(np.asarray, jnew), {k: float(v) for k, v in
                                              jm.items()},
            tnew, {k: float(v) for k, v in tm.items()})


def _check(jnew, jm, tnew, tm, tol=1e-4):
    for k in ("loss", "grad_norm", "lr"):
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm[k], jm[k])
    assert int(tnew["step"]) == int(jnew["step"]) == 2
    for part in ("mu", "nu"):
        want, got = _flat(jnew["opt"][part]), _flat(tnew["opt"][part])
        assert set(want) == set(got)
        for k, w in want.items():
            scale = max(np.abs(w).max(), 1e-30)
            err = np.abs(got[k] - w).max() / scale
            assert err <= (tol if part == "mu" else 2 * tol), (part, k, err)
    # AdamW moves each element by about lr·sign(g): compare the params
    # where the gradient is resolved (>= 1e-3 of the leaf's largest), to
    # 1e-3 of a step
    lr = jm["lr"]
    want, got = _flat(jnew["params"]), _flat(tnew["params"])
    mu = _flat(jnew["opt"]["mu"])
    for k, w in want.items():
        ok = np.abs(mu[k]) >= 1e-3 * np.abs(mu[k]).max()
        err = np.abs(got[k] - w)[ok]
        assert err.size == 0 or err.max() <= 1e-3 * lr + 1e-6 * np.abs(
            w).max(), k


@pytest.mark.parametrize("attn_impl", ["pallas", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, attn_impl):
    """One step from the reference's state: loss, grad norm, lr, the
    gradients (first moment), the second moment and the new params."""
    jnew, jm, tnew, tm = _step_both(arch, thp_kw={"attn_impl": attn_impl})
    _check(jnew, jm, tnew, tm)
    if arch == "llama-3.2-vision-90b":
        # the gate is open: the cross attention's weights get gradients
        mu = _flat(tnew["opt"]["mu"])
        for w in ("q", "k", "v", "o"):
            assert np.abs(mu[f"periods/cross/xattn/{w}"]).max() > 0, w


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-2.7b"])
def test_remat_policies_give_the_same_gradients(arch):
    """``remat`` changes what is recomputed, not the gradients."""
    _, tcfg = _configs(arch)
    params = _port_state(_jstate(arch))["params"]
    _, tb = _batch(tcfg)
    grads = {}
    for remat in ("none", "dots", "full"):
        loss, g = steps.loss_and_grads(tcfg, steps.HParams(remat=remat),
                                       params, tb)
        grads[remat] = (float(loss), _flat(g))
    base_loss, base = grads["none"]
    for remat in ("dots", "full"):
        loss, g = grads[remat]
        assert loss == base_loss
        for k, w in base.items():
            assert np.abs(g[k] - w).max() <= 1e-6 * max(np.abs(w).max(),
                                                        1e-30), (remat, k)


def test_dots_policy_saves_unbatched_products_only(monkeypatch):
    """``"dots"`` keeps the mm outputs and recomputes the rest: the
    attention kernel's forward runs again in the backward, once per layer
    (its launches are counted as such on the card)."""
    from repro_torch.kernels import flash_attention as tfa
    _, tcfg = _configs("qwen3-8b")
    params = _port_state(_jstate("qwen3-8b"))["params"]
    _, tb = _batch(tcfg)
    calls = []
    real = tfa._forward

    def spy(*a):
        calls.append(a[-1])
        return real(*a)

    monkeypatch.setattr(tfa, "_forward", spy)
    for remat, want in (("none", 1), ("dots", 2), ("full", 2)):
        calls.clear()
        steps.loss_and_grads(tcfg, steps.HParams(remat=remat), params, tb)
        assert calls == [True] * (want * tcfg.n_layers), (remat, calls)


def test_accum_matches_reference_and_full_batch():
    """accum=2: two microbatches summed in float32 and divided by 2, as the
    reference; for a token-mean loss that is the full batch's step."""
    arch = "qwen3-8b"
    jnew, jm, tnew, tm = _step_both(arch, {"accum": 2}, {"accum": 2})
    _check(jnew, jm, tnew, tm)
    _, _, full, fm = _step_both(arch, {}, {"accum": 1})
    assert abs(fm["loss"] - tm["loss"]) <= 1e-5 * abs(fm["loss"])
    assert abs(fm["grad_norm"] - tm["grad_norm"]) <= 1e-5 * fm["grad_norm"]
    a, b = _flat(tnew["opt"]["mu"]), _flat(full["opt"]["mu"])
    for k, w in b.items():
        assert np.abs(a[k] - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                    1e-30), k


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-2.7b"])
def test_cast_once_matches_reference(arch):
    """bf16 weights once a step, float32 gradients against the master."""
    jnew, jm, tnew, tm = _step_both(arch, {"cast_once": True},
                                    {"cast_once": True})
    assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * abs(jm["loss"])
    assert abs(tm["grad_norm"] - jm["grad_norm"]) <= 2 ** -7 * jm[
        "grad_norm"]
    want, got = _flat(jnew["opt"]["mu"]), _flat(tnew["opt"]["mu"])
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 2 ** -7 * max(np.abs(w).max(),
                                                         1e-30), k
    # the knob really rounds: the float32 step differs
    _, _, plain, _ = _step_both(arch)
    assert any(not np.array_equal(_flat(plain["opt"]["mu"])[k], got[k])
               for k in got)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-2.7b"])
def test_grad_cast(arch):
    """A bf16 cotangent barrier per layer.  The reference's needs a bf16
    compute dtype (its layer scan keeps the carry's dtype), where the two
    packages round at different points: there both steps are finite and
    their losses agree to bf16's precision.  In float32 the port's barrier
    moves each gradient by at most one bf16 step of its largest value."""
    _, tcfg = _configs(arch)
    params = _port_state(_jstate(arch))["params"]
    _, tb = _batch(tcfg)
    _, plain = steps.loss_and_grads(tcfg, steps.HParams(), params, tb)
    _, cast = steps.loss_and_grads(tcfg, steps.HParams(grad_cast=True),
                                   params, tb)
    plain, cast = _flat(plain), _flat(cast)
    assert any(not np.array_equal(plain[k], cast[k]) for k in plain)
    for k, w in plain.items():
        assert np.abs(cast[k] - w).max() <= 2 ** -7 * max(np.abs(w).max(),
                                                          1e-30), k
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               compute_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    jst = _jstate(arch)
    jb, tb = _batch(tcfg)
    _, jm = jax.jit(jsteps.build_train_step(jcfg, jsteps.HParams(
        remat="none", grad_cast=True, **_opt())))(
            jax.tree.map(jnp.asarray, jst), jb)
    _, tm = steps.build_train_step(tcfg, steps.HParams(
        grad_cast=True, **_opt()))(_port_state(jst), tb)
    for m in (jm, tm):
        assert all(np.isfinite(float(v)) for v in m.values())
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2 ** -7 * abs(
        float(jm["loss"]))


def test_vocab_chunk_matches_unchunked():
    _, tcfg = _configs("qwen3-8b")
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 128)).astype(
        np.float32) * 4)
    labels = torch.from_numpy(rng.integers(0, 128, (2, 5)))
    whole = zoo.ce_loss(logits, labels)
    for chunk in (32, 48, 100):
        assert abs(float(zoo.ce_loss(logits, labels, chunk)) -
                   float(whole)) <= 1e-6 * abs(float(whole))
    from repro.models import zoo as jzoo
    want = jzoo.ce_loss(jnp.asarray(logits.numpy()),
                        jnp.asarray(labels.numpy()), 48)
    assert abs(float(want) - float(whole)) <= 1e-5 * abs(float(want))
    _check(*_step_both("qwen3-8b", {"vocab_chunk": 48}, {"vocab_chunk": 48}))


def test_grad_cast_bf16_rounds_the_cotangent():
    x = torch.full((4,), 1.0, requires_grad=True)
    g, = torch.autograd.grad((zoo.grad_cast_bf16(x) * (1 / 3)).sum(), x)
    assert g.dtype == torch.float32
    assert torch.equal(g, torch.full((4,), 1 / 3).to(torch.bfloat16).float())
    assert torch.equal(zoo.grad_cast_bf16(x), x)


def test_state_layout_matches_reference():
    """``init_state``'s tree, shapes and dtypes are the reference's; the
    step is a host int32 scalar."""
    for arch in ("qwen3-8b", "jamba-v0.1-52b", "llama-3.2-vision-90b"):
        _, tcfg = _configs(arch)
        st = steps.init_state(tcfg, 0, device="cpu")
        want = {k: (v.shape, str(v.dtype)) for k, v in
                tree_items(_jstate(arch))}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in tree_items(st)}
        assert got == want
        assert st["step"].device.type == "cpu"


def test_sharding_knobs_raise():
    _, tcfg = _configs("qwen3-8b")
    for hp, policy in ((steps.HParams(seq_parallel=True), None),
                       (steps.HParams(constrain_proj=True), None),
                       (steps.HParams(extra_rules={"x": 1}), None),
                       (steps.HParams(), object())):
        with pytest.raises(NotImplementedError, match="item 12"):
            steps.build_train_step(tcfg, hp, policy)
    with pytest.raises(NotImplementedError, match="item 12"):
        steps.make_constrain(tcfg, object())
    assert steps.make_constrain(tcfg) is None
    assert steps.make_constrain(tcfg, grad_cast=True) is zoo.grad_cast_bf16


def test_in_place_adamw_matches_the_copying_one():
    """``adamw_update_`` updates the tensors where they lie and agrees with
    the reference's ``adamw_update``, which returns new trees: params and
    moments within 1e-6 of their largest value in float32, a bf16 leaf
    within one bf16 step, at a step where the clip and the weight decay
    (the leaves of two or more dims) act."""
    rng = np.random.default_rng(0)
    shapes = ((4, 3), (5,), (2, 2, 2), (3, 4))
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ms = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    vs = [np.abs(rng.standard_normal(s)).astype(np.float32) * 0.01
          for s in shapes]
    kw = dict(warmup_steps=2, total_steps=10, clip_norm=0.5)
    jp = [jnp.asarray(p) for p in ps[:3]] + [
        jnp.asarray(ps[3]).astype(jnp.bfloat16)]
    want_p, want_opt, want_gn = jadam.adamw_update(
        jadam.AdamWConfig(**kw), jp, [jnp.asarray(g) for g in gs],
        {"mu": [jnp.asarray(m) for m in ms],
         "nu": [jnp.asarray(v) for v in vs]}, jnp.asarray(3, jnp.int32))
    tp = [torch.from_numpy(p.copy()) for p in ps[:3]] + [
        torch.from_numpy(ps[3]).to(torch.bfloat16)]
    opt = {"mu": [torch.from_numpy(m.copy()) for m in ms],
           "nu": [torch.from_numpy(v.copy()) for v in vs]}
    ids = [id(t) for t in tp + opt["mu"] + opt["nu"]]
    gn = adam.adamw_update_(adam.AdamWConfig(**kw), tp,
                            [torch.from_numpy(g) for g in gs], opt, 3)
    assert [id(t) for t in tp + opt["mu"] + opt["nu"]] == ids
    assert abs(float(gn) - float(want_gn)) <= 1e-6 * float(want_gn)
    for got, want, name in ((tp[:3], want_p[:3], "p"),
                            (opt["mu"], want_opt["mu"], "mu"),
                            (opt["nu"], want_opt["nu"], "nu")):
        for a, b in zip(got, want):
            b = np.asarray(b, np.float64)
            assert np.abs(a.double().numpy() - b).max() <= 1e-6 * np.abs(
                b).max(), name
    assert tp[3].dtype == torch.bfloat16
    b = np.asarray(want_p[3].astype(jnp.float32), np.float64)
    assert np.abs(tp[3].double().numpy() - b).max() <= 2 ** -7 * np.abs(
        b).max()
    assert not np.array_equal(tp[0].numpy(), ps[0])


def test_train_step_updates_in_place():
    _, tcfg = _configs("qwen3-8b")
    st = _port_state(_jstate("qwen3-8b"))
    _, tb = _batch(tcfg)
    embed = st["params"]["embed"]
    before = embed.clone()
    new, m = steps.build_train_step(tcfg, steps.HParams(remat="none"))(st,
                                                                        tb)
    assert new is st and new["params"]["embed"] is embed
    assert not torch.equal(embed, before) and int(new["step"]) == 2
    assert set(m) == {"loss", "grad_norm", "lr"}
