"""Fit engine — epochs of shuffled block chunks through AdamW (port of
``repro.fit.engine``, DESIGN.md §11).

``fit`` drives one ``CompiledFit`` artifact: each step streams a chunk of
coordinate blocks through the artifact's online loss-gradient program and
applies one ``optim.adam.adamw_update``.  With ``batch_rows=None`` every
step sees the whole grid (still streamed — peak memory stays
O(block x depth)), which makes a streamed fit comparable step for step with
the reference's; with ``batch_rows`` set, epochs visit equal-sized chunks
of a per-epoch block shuffle (wrap-around keeps every chunk the same size).
The shuffle comes from a ``torch.Generator`` seeded by ``key`` (an int, or
a generator), so its order differs from the reference's ``jax.random`` one.

``fit_many`` fits K weight sets of one architecture as a loop over lanes,
each lane ``fit``'s own loop on the shared grid and chunk schedule: the
reference vmaps the step, but ``vmap`` cannot pass through the ctypes
launch of a hand-written kernel (as in ``MultiINRArtifact``).  Lane k's
trajectory is ``fit``'s with the same key, bit for bit.

Fitted weights stream straight into ``ArtifactStore.put_weights`` — fit ->
store -> serve without a re-trace.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.fit.compile import CompiledFit
from repro_torch.obs import metrics
from repro_torch.obs.tracing import TRACER
from repro_torch.optim.adam import AdamWConfig, adamw_update, init_opt_state

_FIT_STEPS = metrics.counter(
    "fit_steps", "optimizer steps taken by the fit engine")
_FIT_PUTS = metrics.counter(
    "fit_weight_puts", "fitted weight payloads streamed into a store")
_PEAK = metrics.gauge(
    "fit_peak_bytes", "modeled peak fit memory (streamed path)")
_LAT_STEP = metrics.histogram(
    "fit_step_latency_s", "wall-clock seconds per fit step")


@dataclass
class FitResult:
    """One fit run: final params (caller's tree), per-step mean losses,
    and the artifact signature the weights serve under."""
    params: object
    losses: list[float]
    steps: int
    signature: str
    inr_id: str | None = None
    wall_s: float = 0.0
    meta: dict = field(default_factory=dict)

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


def _generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(0 if key is None else int(key))


def _chunk_schedule(n_blocks: int, chunk_blocks: int, steps: int, key):
    """Per-step block-index chunks: each epoch shuffles the block order,
    steps consume ``chunk_blocks``-sized windows with wrap-around (every
    chunk the same size)."""
    gen = _generator(key)
    out = []
    perm = None
    pos = 0
    for _ in range(steps):
        if perm is None or pos + chunk_blocks > n_blocks:
            perm = torch.randperm(n_blocks, generator=gen).numpy()
            pos = 0
        if chunk_blocks >= n_blocks:
            idx = np.resize(perm, chunk_blocks)
        else:
            idx = perm[pos:pos + chunk_blocks]
            pos += chunk_blocks
        out.append(idx)
    return out


def _chunk_vg(cf: CompiledFit, leaves, xc, yc, mc):
    """Mean loss + leaf grads over one pre-blocked chunk: the block
    accumulation of ``CompiledFit._stream_vg`` over the chunk's rows."""
    total, grads = cf._sum_vg(leaves, xc, yc, mc)
    n = torch.clamp(torch.sum(mc).float(), min=1.0)
    return total / n, tuple(g / n for g in grads)


def _schedule(cf: CompiledFit, xb, steps, key, batch_rows):
    if batch_rows is None:
        return None
    n_blocks = xb.shape[0]
    cb = max(1, min(n_blocks, -(-batch_rows // cf.config.block)))
    return _chunk_schedule(n_blocks, cb, steps, key)


def _run(cf: CompiledFit, leaves, xb, yb, mb, chunks, steps, adam):
    """``steps`` AdamW steps from ``leaves``; returns (leaves, losses)."""
    opt = init_opt_state(leaves)
    lv = list(leaves)
    losses = []
    for i in range(steps):
        ts = time.perf_counter()
        if chunks is None:
            xc, yc, mc = xb, yb, mb
        else:
            idx = torch.as_tensor(chunks[i], device=xb.device)
            xc, yc, mc = xb[idx], yb[idx], mb[idx]
        loss, gs = _chunk_vg(cf, lv, xc, yc, mc)
        lv, opt, _ = adamw_update(adam, lv, list(gs), opt, i)
        losses.append(float(loss))
        _FIT_STEPS.inc()
        _LAT_STEP.observe(time.perf_counter() - ts)
    return lv, losses


def _default_adam(adam, steps):
    if adam is None:
        return AdamWConfig(total_steps=max(steps, 1), warmup_steps=0,
                           weight_decay=0.0)
    return adam


def fit(cf: CompiledFit, coords, targets, *, steps: int,
        params=None, adam: AdamWConfig | None = None, key=None,
        batch_rows: int | None = None, store=None,
        inr_id: str | None = None) -> FitResult:
    """Fit one weight set.  ``params`` defaults to the compile template;
    ``batch_rows=None`` streams the WHOLE grid every step, otherwise each
    step visits a shuffled ~``batch_rows`` chunk (order from ``key``, an
    int seed or a ``torch.Generator``; default 0).  With
    ``store``/``inr_id`` the fitted payload is written for serving."""
    adam = _default_adam(adam, steps)
    leaves = cf.leaves_of(params if params is not None
                          else cf.unflatten(cf.template_leaves))
    _PEAK.max(float(cf.peak_bytes()))
    xb, yb, mb, _ = cf._blocked(coords, targets)
    chunks = _schedule(cf, xb, steps, key, batch_rows)

    t0 = time.perf_counter()
    with TRACER.span("fit.run", cat="fit", steps=steps, order=cf.order,
                     loss=type(cf.loss).__name__):
        lv, losses = _run(cf, leaves, xb, yb, mb, chunks, steps, adam)
    wall = time.perf_counter() - t0

    final = cf.unflatten(lv)
    if store is not None and inr_id is not None:
        with TRACER.span("fit.put_weights", cat="fit", inr_id=inr_id):
            store.put_weights(cf.signature, inr_id, cf.payload(final))
        _FIT_PUTS.inc()
    return FitResult(params=final, losses=losses, steps=steps,
                     signature=cf.signature, inr_id=inr_id, wall_s=wall,
                     meta={"peak_model_bytes": cf.peak_bytes()})


def fit_many(cf: CompiledFit, params_list, coords, targets_list, *,
             steps: int, adam: AdamWConfig | None = None, key=None,
             batch_rows: int | None = None, store=None,
             inr_ids=None) -> list[FitResult]:
    """Fit K weight sets of one architecture, lane by lane on a shared grid
    and chunk schedule: lane k's trajectory is exactly ``fit``'s with the
    same key.  Targets are per lane."""
    adam = _default_adam(adam, steps)
    K = len(params_list)
    if len(targets_list) != K:
        raise ValueError(f"{K} params vs {len(targets_list)} targets")
    flat = [cf.leaves_of(p) for p in params_list]
    _PEAK.max(float(cf.peak_bytes()) * K)
    xb, _, mb, _ = cf._blocked(coords, targets_list[0])
    ybs = [cf._blocked(coords, t)[1] for t in targets_list]
    chunks = _schedule(cf, xb, steps, key, batch_rows)

    results = []
    t0 = time.perf_counter()
    with TRACER.span("fit.run_many", cat="fit", k=K, steps=steps,
                     order=cf.order):
        for k in range(K):
            lv, losses = _run(cf, flat[k], xb, ybs[k], mb, chunks, steps,
                              adam)
            final = cf.unflatten(lv)
            iid = inr_ids[k] if inr_ids is not None else None
            if store is not None and iid is not None:
                store.put_weights(cf.signature, iid, cf.payload(final))
                _FIT_PUTS.inc()
            results.append(FitResult(params=final, losses=losses,
                                     steps=steps, signature=cf.signature,
                                     inr_id=iid, meta={"k": k, "lanes": K}))
    wall = time.perf_counter() - t0
    for r in results:
        r.wall_s = wall / K
    return results
