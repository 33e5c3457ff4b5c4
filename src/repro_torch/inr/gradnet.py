"""n-th order input gradients of an INR (port of ``repro.inr.gradnet``).

INSP-Net consumes [y, dy/dx, d2y/dx2, ...] as features.  As in the paper
(and PyTorch autograd), gradients are built by REPEATED REVERSE-MODE
differentiation, which creates the redundant, exponentially growing graphs
the compiler optimizes.
"""

from __future__ import annotations

import torch


def gradient_outputs(f, order: int):
    """Returns g(x) -> tuple(y, dy, d2y, ..., d^order y) for a single
    coordinate x: [in].  Output k has shape [out] + [in]*k."""
    fns = [f]
    for _ in range(order):
        fns.append(torch.func.jacrev(fns[-1]))

    def g(x):
        return tuple(fn(x) for fn in fns)
    return g


def batched_gradients(f, order: int):
    """vmap over a batch of coordinates: x [B, in] -> tuple of [B, ...]."""
    return torch.func.vmap(gradient_outputs(f, order))


def _flat_cat(outs, rows: int):
    return torch.cat([o.reshape(rows, -1) for o in outs], -1)


def feature_vector(f, order: int, *, compiled=None):
    """x [B, in] -> concatenated flat feature matrix [B, F] where
    F = out * (1 + in + in^2 + ... + in^order).

    With ``compiled`` (a ``core.pipeline.CompiledGradient`` for ``f`` at this
    order), features come from the compiled pipeline's serving path
    (``apply_batched``): gradients are never re-derived per call.  Without
    it, they come from vmap'd jacrev (the uncompiled path).  The column
    order is the same either way: order-k entries are laid out (channel,
    i1..ik) row-major."""
    if compiled is not None:
        if compiled.order is not None and compiled.order != order:
            raise ValueError(f"compiled artifact is for order "
                             f"{compiled.order}, requested {order}")

        def feats(x):
            return _flat_cat(compiled.apply_batched(x), x.shape[0])
        return feats

    bg = batched_gradients(f, order)

    def feats(x):
        return _flat_cat(bg(x), x.shape[0])
    return feats


def compiled_feature_vector(f, order: int, example_coords, *,
                            config=None, block: int | None = None,
                            use_pallas: bool | None = None, store=None,
                            device=None):
    """Compile-or-hit the gradient pipeline for ``f`` on ``device`` (CUDA
    unless the caller passes "cpu") and return ``(feats_fn,
    CompiledGradient)``, the serving-path feature extractor.  ``config``,
    ``block``, ``use_pallas`` and ``store`` go to ``compile_gradient``."""
    from repro_torch.core.pipeline import compile_gradient

    cg = compile_gradient(f, order, example_coords, config=config,
                          block=block, use_pallas=use_pallas, store=store,
                          device=device)
    return feature_vector(f, order, compiled=cg), cg


def num_features(in_features: int, out_features: int, order: int) -> int:
    return out_features * sum(in_features ** k for k in range(order + 1))


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
