"""End-to-end INR editing (paper Fig. 1B / Sec. 2.3; port of
``repro.inr.editing``).

Train an INSP-Net head so that INSP(features of INR) matches a pixel-space
transformation of the underlying image (here: Gaussian blur or sharpening;
both are differential-operator-like, which is why gradient features
suffice, per Xu et al. [12]).

Several edits of one INR are a FILTER BANK: ``train_insp_heads`` fits every
head against one shared feature matrix, and ``edited_bank`` compiles the
trained heads into a single multi-output artifact
(``core.pipeline.compile_bank``, DESIGN.md §9) whose shared gradient prefix
runs once per chunk however many edits it feeds.

The fits draw their batches and initial heads from a ``torch.Generator``
(seed 0 when none is given), so their parameters are not the reference's,
which come from JAX's PRNG.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.siren import InspConfig, SirenConfig
from repro_torch.inr.encode import fit_adam, image_coords
from repro_torch.inr.gradnet import (compiled_feature_vector, feature_vector,
                                     num_features)
from repro_torch.inr.insp import insp_apply, insp_head, insp_init
from repro_torch.inr.siren import siren_fn
from repro_torch.kernels.common import resolve_device


def _convolve_same(rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``np.convolve(row, k, mode="same")`` for every row of ``rows``: the
    full convolution (zeros past the edges), centred on the longer of the
    two lengths."""
    m, n = rows.shape[-1], k.shape[0]
    full = F.conv1d(rows[:, None, :], k.flip(0)[None, None, :],
                    padding=n - 1)[:, 0, :]
    start = (min(m, n) - 1) // 2
    return full[:, start:start + max(m, n)]


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    r = int(3 * sigma)
    xs = torch.arange(-r, r + 1, device=img.device, dtype=img.dtype)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = k / k.sum()
    out = _convolve_same(img, k)
    return _convolve_same(out.T, k).T


def sharpen(img: torch.Tensor, amount: float = 1.0) -> torch.Tensor:
    return img + amount * (img - gaussian_blur(img, 1.0))


def _siren_on(siren_cfg: SirenConfig, siren_params, device):
    """The SIREN with its parameters on ``device``."""
    return siren_fn(siren_cfg, [{k: torch.as_tensor(v).to(device)
                                 for k, v in p.items()}
                                for p in siren_params])


def train_insp_head(siren_cfg: SirenConfig, insp_cfg: InspConfig,
                    siren_params, target_img, *, steps: int = 300,
                    lr: float = 1e-3, batch: int = 512,
                    generator: torch.Generator | None = None,
                    config=None, block: int | None = None, compiled=None,
                    store=None, device=None):
    """Fit psi so INSP(features(x)) ~= target_img(x).  Returns (psi, mse).

    The gradient features of the (frozen) SIREN are what INR-Arch
    accelerates: they are compiled ONCE (or taken as the given
    ``compiled`` artifact) and streamed over the full coordinate grid up
    front; training then indexes the cached feature matrix.  ``store``
    threads through to the compile.  Runs on ``device`` (CUDA unless the
    caller passes "cpu")."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    device = resolve_device(device)
    coords = image_coords(target_img.shape[0], device)
    feats, _ = _cached_features(siren_cfg, insp_cfg, siren_params, coords,
                                config=config, block=block,
                                compiled=compiled, store=store, device=device)
    target = torch.as_tensor(target_img, device=device).reshape(-1, 1)
    return _fit_head(siren_cfg, insp_cfg, feats, target, steps=steps, lr=lr,
                     batch=batch, generator=gen)


def train_insp_heads(siren_cfg: SirenConfig, insp_cfg: InspConfig,
                     siren_params, targets, *, steps: int = 300,
                     lr: float = 1e-3, batch: int = 512,
                     generator: torch.Generator | None = None,
                     config=None, block: int | None = None, compiled=None,
                     store=None, device=None):
    """Fit one INSP head per named target image over ONE shared feature
    matrix: the filter-bank training front door.  ``targets`` maps name ->
    target image (all at one resolution); the gradient features stream once
    and every head trains against the same cached matrix, in sorted name
    order.  Returns ``{name: (psi, mse)}``; hand the psis to
    ``edited_bank`` to compile them into one multi-output artifact."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    targets = dict(targets)
    if not targets:
        raise ValueError("train_insp_heads needs at least one target")
    resolutions = {img.shape[0] for img in targets.values()}
    if len(resolutions) != 1:
        raise ValueError(f"targets span several resolutions: {resolutions}")
    device = resolve_device(device)
    coords = image_coords(resolutions.pop(), device)
    feats, _ = _cached_features(siren_cfg, insp_cfg, siren_params, coords,
                                config=config, block=block,
                                compiled=compiled, store=store, device=device)
    return {name: _fit_head(siren_cfg, insp_cfg, feats,
                            torch.as_tensor(img, device=device).reshape(-1, 1),
                            steps=steps, lr=lr, batch=batch, generator=gen)
            for name, img in sorted(targets.items())}


def _cached_features(siren_cfg, insp_cfg, siren_params, coords, *,
                     config, block, compiled, store, device):
    """The full-grid feature matrix, streamed once through the compiled
    gradient pipeline (compile-or-restore via ``store``)."""
    f = _siren_on(siren_cfg, siren_params, device)
    if compiled is None:
        feats_fn, compiled = compiled_feature_vector(
            f, insp_cfg.grad_order, coords, config=config, block=block,
            store=store, device=device)
    else:
        feats_fn = feature_vector(f, insp_cfg.grad_order, compiled=compiled)
    return feats_fn(coords), compiled


def _fit_head(siren_cfg, insp_cfg, feats, target, *, steps, lr, batch,
              generator):
    nf = num_features(siren_cfg.in_features, siren_cfg.out_features,
                      insp_cfg.grad_order)
    psi = insp_init(insp_cfg, nf, siren_cfg.out_features, generator,
                    device=feats.device)

    def loss_of(p, idx):
        return torch.mean((insp_apply(p, feats[idx]) - target[idx]) ** 2)
    return fit_adam(psi, loss_of, feats.shape[0], steps=steps, lr=lr,
                    batch=batch, generator=generator)


def edited_bank(siren_cfg: SirenConfig, insp_cfg: InspConfig, siren_params,
                psis, example_coords, *, config=None, block: int | None = None,
                store=None, device=None):
    """Compile a dict of trained heads into ONE filter bank on ``device``
    (CUDA unless the caller passes "cpu"): a single multi-output artifact
    whose shared feature prefix is computed once per chunk and feeds every
    head (``core.pipeline.compile_bank``, DESIGN.md §9).  Returns ``(bank,
    fns)``: ``bank`` is a ``serve.bank.BankArtifact`` naming the outputs
    after the (sorted) edit names, so ``edited_inr(bank=bank, head=name)``
    routes by name; ``fns[name](x)`` serves edit ``name`` through the bank
    (one pass computes ALL edits)."""
    from repro_torch.core.pipeline import compile_bank
    from repro_torch.serve.bank import BankArtifact
    device = resolve_device(device)
    names = sorted(psis)
    f = _siren_on(siren_cfg, siren_params, device)
    heads = [insp_head([{k: torch.as_tensor(v, device=device)
                         for k, v in layer.items()} for layer in psis[n]])
             for n in names]
    art = BankArtifact(
        compile_bank(f, heads, insp_cfg.grad_order, example_coords,
                     config=config, block=block, store=store, device=device),
        names)

    def make(j):
        def g(x):
            return art.apply_batched(x)[j]
        return g
    return art, {n: make(j) for j, n in enumerate(names)}


def edited_inr(siren_cfg: SirenConfig, insp_cfg: InspConfig, siren_params,
               psi=None, *, compiled=None, store=None, example_coords=None,
               config=None, bank=None, head=None, device=None):
    """The composite 'edited' INR g(x) = INSP(features_f(x)), the function
    whose computation graph INR-Arch compiles.

    Without ``compiled`` the returned g is pure math (jacrev features on
    ``device``, CUDA unless the caller passes "cpu").  With ``compiled`` (a
    CompiledGradient for f's gradients, e.g. from
    ``compiled_feature_vector``), g SERVES through the compiled pipeline.
    ``store`` + ``example_coords`` compile-or-restore the feature pipeline
    through the artifact store instead.

    ``bank`` + ``head`` route through a compiled filter bank
    (``edited_bank``): ``head`` picks the bank output (an index, or a
    filter name when ``bank`` is a ``serve.bank.BankArtifact``) and g(x)
    reads it from the bank's single multi-output pass (``psi`` is unused;
    the trained head is baked into the bank)."""
    if bank is not None:
        if head is None:
            raise ValueError("edited_inr(bank=...) needs head= (an output "
                             "index, or a filter name for a BankArtifact)")
        if isinstance(head, str):
            if not hasattr(bank, "index_of"):
                raise ValueError(
                    "head by name needs a serve.bank.BankArtifact (e.g. "
                    "from edited_bank); pass an integer output index for a "
                    "bare CompiledBank")
            j = bank.index_of(head)
        else:
            j = int(head)

        def g(x):
            return bank.apply_batched(x)[j]
        return g
    if psi is None:
        raise ValueError("edited_inr needs psi (or bank= + head=)")
    device = resolve_device(device)
    f = _siren_on(siren_cfg, siren_params, device)
    if compiled is None and store is not None:
        if example_coords is None:
            raise ValueError("edited_inr(store=...) needs example_coords "
                             "to compile-or-restore the feature pipeline")
        _, compiled = compiled_feature_vector(
            f, insp_cfg.grad_order, example_coords, config=config,
            store=store, device=device)
    feats = feature_vector(f, insp_cfg.grad_order, compiled=compiled)

    def g(x):
        return insp_apply(psi, feats(x))
    return g
