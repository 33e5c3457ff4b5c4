"""n-th order input gradients of an INR (port of ``repro.inr.gradnet``).

INSP-Net consumes [y, dy/dx, d2y/dx2, ...] as features.  As in the paper
(and PyTorch autograd), gradients are built by REPEATED REVERSE-MODE
differentiation, which creates the redundant, exponentially growing graphs
the compiler optimizes.
"""

from __future__ import annotations

import torch


def _one_hot_seed(batch: int, width: int, col: int, device, dtype):
    seed = torch.zeros(batch, width, device=device, dtype=dtype)
    seed[:, col] = 1
    return seed


def paper_gradients(f, order: int, out_features: int, in_features: int, *,
                    batch: int, device="cpu", dtype=torch.float32):
    """PyTorch-autograd-faithful gradient builder (paper Sec. 3.2.2).

    INSP-Net calls ``torch.autograd.grad`` once per scalar output with
    ``create_graph=True``; each call builds a full backward graph, and the
    graphs share almost all of their computation — the redundancy the
    de-duplication pass removes.  One call per (channel, index path): the
    scalar is picked by a one-hot ``[batch, k]`` cotangent passed as
    ``grad_outputs``.  The seeds are built here, OUTSIDE the returned
    function, so a trace captures them as row-constant constants (as the
    reference's all-ones cotangent is).

    Returns g(x: [batch, in]) -> tuple of tensors:
      y [B, out], then per channel: dy_c [B, in], then per (c, i): d2y_ci
      [B, in], ... (the reference's order).
    """
    out_seeds = [_one_hot_seed(batch, out_features, c, device, dtype)
                 for c in range(out_features)]
    in_seeds = [_one_hot_seed(batch, in_features, i, device, dtype)
                for i in range(in_features)]

    def g(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            y = f(x)
            outs = [y]
            level = [(y, s) for s in out_seeds]
            for _ in range(order):
                grads = [torch.autograd.grad(t, x, grad_outputs=s,
                                             create_graph=True)[0]
                         for t, s in level]
                outs.extend(grads)
                level = [(gr, s) for gr in grads for s in in_seeds]
        return tuple(outs)
    return g
