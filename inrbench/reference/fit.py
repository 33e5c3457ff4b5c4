"""Plain reference of fitting a SIREN to Laplacian supervision, in PyTorch.

The loss is the mean over rows of ``sum_c (lap_c(x) - t_c)^2``, with the
Laplacian from ``reference.siren.laplacian``; its gradient with respect to
every weight comes from autograd through that forward propagation, summed
over blocks of rows.  The optimizer is AdamW as stated in the traffic file:
bias-corrected moments, an optional global-norm clip, a constant rate
after warm-up (linear warm-up, cosine decay to ``min_lr_frac`` of it over
``total_steps``), and weight decay on matrices only.  Imports torch and
the SIREN reference only.
"""

from __future__ import annotations

import math

import torch

from inrbench.reference import siren


def loss_and_grads(params, x, target, w0: float, *, block: int = 16384,
                   matmul=None):
    """``(mean loss, [grad per leaf])`` in the dtype of ``params``; leaves
    are in ``leaves(params)`` order."""
    leaves = [v.detach().clone().requires_grad_(True)
              for v in flat(params)]
    tree = unflat(leaves)
    N = x.shape[0]
    total = torch.zeros((), dtype=leaves[0].dtype, device=x.device)
    grads = [torch.zeros_like(v) for v in leaves]
    for s in range(0, N, block):
        lap = siren.laplacian(tree, x[s:s + block], w0, matmul)
        loss = torch.sum((lap - target[s:s + block]) ** 2)
        # the last bias moves no derivative: its gradient is zero
        for g, d in zip(grads, torch.autograd.grad(loss, leaves,
                                                   allow_unused=True)):
            if d is not None:
                g += d
        total += loss.detach()
    return total / N, [g / N for g in grads]


def flat(params):
    """Leaves in layer order, ``b`` before ``w`` (the program's params
    tree sorts dict keys)."""
    return [p[k] for p in params for k in ("b", "w")]


def unflat(leaves):
    return [{"b": leaves[i], "w": leaves[i + 1]}
            for i in range(0, len(leaves), 2)]


def lr_at(cfg: dict, step: int) -> float:
    warm = cfg["warmup_steps"]
    if step < warm:
        return cfg["lr"] * step / max(warm, 1)
    prog = min(max((step - warm) / max(cfg["total_steps"] - warm, 1), 0.0),
               1.0)
    f = cfg["min_lr_frac"]
    return cfg["lr"] * (f + (1 - f) * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw(cfg: dict, leaves, grads, mu, nu, step: int):
    """One AdamW step on lists of tensors; returns new lists."""
    if cfg["clip_norm"]:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(cfg["clip_norm"] / (norm + 1e-9), max=1.0)
        grads = [g * scale for g in grads]
    lr = lr_at(cfg, step)
    b1, b2, eps = cfg["b1"], cfg["b2"], cfg["eps"]
    bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    out, m_out, v_out = [], [], []
    for p, g, m, v in zip(leaves, grads, mu, nu):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if p.dim() >= 2:
            upd = upd + cfg["weight_decay"] * p
        out.append(p - lr * upd)
        m_out.append(m)
        v_out.append(v)
    return out, m_out, v_out


def run(params, x, target, w0: float, cfg: dict, steps: int, *,
        matmul=None):
    """``steps`` steps from ``params``: ``{"losses": [...], "grad1":
    [first step's gradient as the optimizer takes it, per leaf],
    "leaves": [per leaf after the last step], "ref_grad1": unclipped}``."""
    leaves = [v.detach() for v in flat(params)]
    mu = [torch.zeros_like(v) for v in leaves]
    nu = [torch.zeros_like(v) for v in leaves]
    losses, grad1 = [], None
    for i in range(steps):
        loss, grads = loss_and_grads(unflat(leaves), x, target, w0,
                                     matmul=matmul)
        losses.append(float(loss))
        leaves, mu, nu = adamw(cfg, leaves, grads, mu, nu, i)
        if i == 0:
            grad1 = [m / (1 - cfg["b1"]) for m in mu]
    return {"losses": losses, "grad1": grad1, "leaves": leaves}
