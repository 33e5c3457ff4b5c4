"""Curated filter library: classic image edits as closed-form INSP heads
(port of ``repro.inr.filters``).

INSP-Net (``inr.insp``) LEARNS an MLP head over an INR's gradient features;
for the classic edits the head has a closed form over the same features:
edge maps are gradient magnitudes, Laplacian filters read the Hessian
trace, and blur/sharpen are single heat-flow steps ``y ± α ∇²y``.  This
module names those compositions as heads over the feature-matrix layout
the learned heads consume (``gradnet.feature_vector`` column order:
order-k entries laid out (channel, i1..ik) row-major), so they compile
through ``core.pipeline.compile_bank`` into one multi-output artifact and
serve through ``ServingEngine.register_bank`` like any learned bank
(DESIGN.md §9).

    bank = filter_bank(f, ["identity", "blur", "edge"], coords)
    engine.register_bank(["identity", "blur", "edge"], bank)

The layout is a prefix layout (order-k columns start at
``C * sum_{m<k} D^m`` whatever the bank's order), so a head reads the same
columns at any order: a bank mixing an order-0 identity with an order-2
blur compiles at order 2.
"""

from __future__ import annotations

import torch

#: filter name -> smallest gradient order whose feature columns it reads
FILTER_ORDERS = {
    "identity": 0,
    "blur": 2,
    "edge": 1,
    "laplacian": 2,
    "sharpen": 2,
}


def _y(feats, C: int, D: int):
    return feats[:, :C]


def _grad_mag(feats, C: int, D: int):
    """Per-channel gradient magnitude ``sqrt(sum_i (dy_c/dx_i)^2)``."""
    cols = []
    for c in range(C):
        acc = None
        for i in range(D):
            g = feats[:, C + c * D + i: C + c * D + i + 1]
            acc = g * g if acc is None else acc + g * g
        cols.append(torch.sqrt(acc))
    return cols[0] if C == 1 else torch.cat(cols, dim=-1)


def _laplacian(feats, C: int, D: int):
    """Per-channel Hessian trace ``sum_i d2y_c/dx_i^2``."""
    o2 = C + C * D
    cols = []
    for c in range(C):
        acc = None
        for i in range(D):
            k = o2 + c * D * D + i * D + i
            h = feats[:, k: k + 1]
            acc = h if acc is None else acc + h
        cols.append(acc)
    return cols[0] if C == 1 else torch.cat(cols, dim=-1)


def filter_head(name: str, in_features: int, out_features: int, *,
                alpha: float = 0.15):
    """The named filter as a bank head: ``feats [B, F] -> [B, C]``.

    ``alpha`` scales the heat-flow step of ``blur`` / ``sharpen`` (one
    explicit-Euler step of the heat equation; its negation un-diffuses)."""
    if name not in FILTER_ORDERS:
        raise KeyError(f"unknown filter {name!r}; have "
                       f"{sorted(FILTER_ORDERS)}")
    C, D = out_features, in_features

    if name == "identity":
        return lambda feats: _y(feats, C, D)
    if name == "edge":
        return lambda feats: _grad_mag(feats, C, D)
    if name == "laplacian":
        return lambda feats: _laplacian(feats, C, D)
    if name == "blur":
        return lambda feats: _y(feats, C, D) + alpha * _laplacian(feats, C, D)
    # sharpen: unsharp masking, the blur step reversed
    return lambda feats: _y(feats, C, D) - alpha * _laplacian(feats, C, D)


def filter_bank(f, names, example_coords, *, out_features: int = 1,
                alpha: float = 0.15, order: int | None = None,
                config=None, block=None, use_pallas=None, store=None,
                device=None):
    """Compile the named filters over INR ``f`` as ONE multi-output bank on
    ``device`` (CUDA unless the caller passes "cpu") and return a
    ``serve.BankArtifact`` whose ``filter_ids`` are the names, ready for
    ``ServingEngine.register_bank``.

    ``order`` defaults to the largest order any named filter needs; a
    higher order is accepted (the prefix layout makes heads
    order-agnostic), a lower one cannot supply the columns and raises."""
    from repro_torch.core.pipeline import compile_bank
    from repro_torch.serve.bank import BankArtifact

    names = list(names)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate filter names: {names}")
    need = max((FILTER_ORDERS[n] for n in names), default=0)
    if order is None:
        order = need
    elif order < need:
        raise ValueError(f"order {order} cannot supply "
                         f"order-{need} filter columns")
    D = int(example_coords.shape[-1])
    heads = [filter_head(n, D, out_features, alpha=alpha) for n in names]
    bank = compile_bank(f, heads, order, example_coords, config=config,
                        block=block, use_pallas=use_pallas, store=store,
                        device=device)
    return BankArtifact(bank, names)
