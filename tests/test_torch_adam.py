"""The port's AdamW (``repro_torch.optim.adam``) against ``repro.optim.adam``.

The same numpy parameters and gradients go through both for several steps,
with clipping by global norm engaged, warmup, cosine decay and weight decay
on the matrices only; every step's parameters, moments, learning rate and
gradient norm must agree within 1e-6, scaled by max(1, max |reference|) as
the fit tests scale (float32 on both sides; XLA's and torch's cos and sums
differ in the last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro_torch.optim import adam as tadam

SHAPES = [(4, 3), (3,), (3, 2), (2,)]


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in SHAPES]


def _cfgs():
    return {
        "clip_warmup_decay": (tadam.AdamWConfig(lr=1e-2, clip_norm=0.5,
                                                warmup_steps=3,
                                                total_steps=8),
                              jadam.AdamWConfig(lr=1e-2, clip_norm=0.5,
                                                warmup_steps=3,
                                                total_steps=8)),
        "no_clip_no_decay": (tadam.AdamWConfig(lr=3e-3, clip_norm=0.0,
                                               weight_decay=0.0,
                                               warmup_steps=0,
                                               total_steps=6),
                             jadam.AdamWConfig(lr=3e-3, clip_norm=0.0,
                                               weight_decay=0.0,
                                               warmup_steps=0,
                                               total_steps=6)),
    }


@pytest.mark.parametrize("name", sorted(_cfgs()))
def test_adamw_update_matches_reference(name):
    tcfg, jcfg = _cfgs()[name]
    p0 = _arrays(0)
    tp = [torch.from_numpy(a) for a in p0]
    jp = [jnp.asarray(a) for a in p0]
    topt = tadam.init_opt_state(tp)
    jopt = jadam.init_opt_state(jp)
    for step in range(8):
        g = _arrays(100 + step, scale=3.0)
        tp, topt, tn = tadam.adamw_update(tcfg, tp, [torch.from_numpy(a)
                                                      for a in g], topt, step)
        jp, jopt, jn = jadam.adamw_update(jcfg, jp, [jnp.asarray(a)
                                                     for a in g], jopt,
                                          jnp.asarray(step))
        _close(float(tn), float(jn))
        for a, b in zip(tp, jp):
            assert a.dtype == torch.float32
            _close(a.numpy(), np.asarray(b))
        for key in ("mu", "nu"):
            for a, b in zip(topt[key], jopt[key]):
                _close(a.numpy(), np.asarray(b))


def test_lr_schedule_matches_reference():
    tcfg, jcfg = _cfgs()["clip_warmup_decay"]
    for step in range(12):
        _close(float(tadam.lr_at(tcfg, step)),
               float(jadam.lr_at(jcfg, step)))
    assert float(tadam.lr_at(tcfg, 0)) == 0.0
    assert float(tadam.lr_at(tcfg, 3)) == pytest.approx(tcfg.lr)
    assert float(tadam.lr_at(tcfg, 20)) == pytest.approx(
        tcfg.lr * tcfg.min_lr_frac)


def test_global_norm_matches_reference():
    arrs = _arrays(5)
    _close(float(tadam.global_norm([torch.from_numpy(a) for a in arrs])),
           float(jadam.global_norm([jnp.asarray(a) for a in arrs])))


def test_weight_decay_only_on_matrices():
    """With zero gradients the Adam step is zero, so only decoupled weight
    decay moves a leaf: matrices shrink by lr * wd * p, vectors stay."""
    cfg = tadam.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                            total_steps=1, clip_norm=0.0)
    p = [torch.ones(2, 2), torch.ones(2)]
    new, opt, gnorm = tadam.adamw_update(cfg, p, [torch.zeros(2, 2),
                                                  torch.zeros(2)],
                                         tadam.init_opt_state(p), 0)
    assert float(gnorm) == 0.0
    torch.testing.assert_close(new[0], torch.full((2, 2), 1 - 0.1 * 0.5))
    assert torch.equal(new[1], p[1])
    assert all(m.dtype == torch.float32 for m in opt["mu"] + opt["nu"])
