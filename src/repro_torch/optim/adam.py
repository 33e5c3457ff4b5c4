"""AdamW on lists of tensors (port of ``repro.optim.adam``).

Written out rather than ``torch.optim.AdamW``, so that a fit here and the
reference's take the same steps: clipping by global norm, linear warmup
then cosine decay, weight decay only on leaves with ``ndim >= 2``, and all
optimizer state in float32.  ``params``, ``grads`` and the state are lists
of tensors in one order (the fit engine's flat leaves, the train step's
leaves in the reference's tree order).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def lr_at(cfg: AdamWConfig, step) -> float:
    """Linear warmup + cosine decay to ``min_lr_frac`` (in float32, as the
    reference computes it)."""
    step = torch.tensor(float(step), dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
    return {"mu": zeros, "nu": [z.clone() for z in zeros]}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state, step: int):
    """One AdamW step.  All state math in float32; returns
    ``(params', opt_state', grad norm)`` with new tensors (nothing is
    updated in place): ``adamw_update_`` on copies."""
    params = [p.clone() for p in params]
    opt_state = {"mu": [m.clone() for m in opt_state["mu"]],
                 "nu": [v.clone() for v in opt_state["nu"]]}
    gnorm = adamw_update_(cfg, params, grads, opt_state, step)
    return params, opt_state, gnorm


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, params, grads, opt_state, step: int,
                  gnorm=None):
    """``adamw_update`` IN PLACE: each parameter and its moments are
    updated where they lie, one leaf at a time, with the same arithmetic
    (the reference's ``adamw_update`` returns new trees).  A full-width
    training state then needs no second copy of params and moments.
    Returns the grad norm (before clipping).  ``gnorm``: the norm of the
    whole gradient where ``grads`` are one rank's shards of it (the
    sharded train step); by default ``global_norm(grads)``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm else None)
    dev = params[0].device if params else torch.device("cpu")
    lr = lr_at(cfg, step).to(dev)
    t = torch.tensor(float(step + 1), dtype=torch.float32)
    bc1 = (1 - torch.tensor(cfg.b1, dtype=torch.float32) ** t).to(dev)
    bc2 = (1 - torch.tensor(cfg.b2, dtype=torch.float32) ** t).to(dev)
    for p, g, m, v in zip(params, grads, opt_state["mu"], opt_state["nu"]):
        g = g.float() * scale if scale is not None else g.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:
            upd = upd + cfg.weight_decay * p.float()
        if p.dtype == torch.float32:
            p.sub_(lr * upd)
        else:
            p.copy_((p.float() - lr * upd).to(p.dtype))
    return gnorm
