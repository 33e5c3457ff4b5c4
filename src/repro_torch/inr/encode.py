"""INR encoding: overfit a SIREN to one image (paper Sec. 2.2; port of
``repro.inr.encode``).

No image files ship with the repo, so the default "image" is a synthetic
band-limited texture (Gabor-ish mixture) that SIRENs fit well.
"""

from __future__ import annotations

import math

import torch

import repro_torch.optim.adam as A
from repro_torch.configs.siren import SirenConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.inr.siren import siren_apply, siren_init


def _linspace(res: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, res)`` by its own float32 formula,
    ``-(1 - s) + s`` with ``s = i * (1 / (res - 1))`` and the end point
    appended (XLA may fuse the last multiply-add, so the two can differ in
    the last bit)."""
    if res < 2:
        return -torch.ones(res, device=device)
    s = torch.arange(res - 1, dtype=torch.float32, device=device) \
        * torch.tensor(1.0 / (res - 1), dtype=torch.float32)
    return torch.cat([-(1 - s) + s, torch.ones(1, device=device)])


def _grid(res: int, device):
    xs = _linspace(res, device)
    return torch.meshgrid(xs, xs, indexing="ij")


def synthetic_image(res: int = 64, device="cpu") -> torch.Tensor:
    """[res, res] grayscale in [-1, 1], smooth + oriented texture."""
    X, Y = _grid(res, device)
    img = (torch.sin(4.1 * X + 2.3 * Y)
           + 0.5 * torch.sin(9.0 * X * Y + 1.0)
           + 0.3 * torch.exp(-4 * (X ** 2 + Y ** 2)) * torch.sin(14 * Y))
    return img / img.abs().max()


def image_coords(res: int, device="cpu") -> torch.Tensor:
    X, Y = _grid(res, device)
    return torch.stack([X.reshape(-1), Y.reshape(-1)], -1)   # [res*res, 2]


def fit_adam(params: list[dict], loss_of, n_rows: int, *, steps: int,
             lr: float, batch: int, generator: torch.Generator):
    """Fit ``params`` (a list of ``{"w", "b"}`` layers) with AdamW as the
    reference's small fits do (no weight decay, clipping or schedule): each
    step draws ``batch`` row indices below ``n_rows`` from ``generator`` and
    steps on ``loss_of(params, idx)``.  Returns (params, final loss)."""
    device = params[0]["w"].device
    leaves = [p[k] for p in params for k in ("w", "b")]

    def tree(ts):
        return [{"w": w, "b": b} for w, b in zip(ts[::2], ts[1::2])]

    ocfg = A.AdamWConfig(lr=lr, weight_decay=0.0, clip_norm=0.0,
                         warmup_steps=0, total_steps=steps, min_lr_frac=1.0)
    opt = A.init_opt_state(leaves)
    loss = None
    for step in range(steps):
        idx = torch.randint(0, n_rows, (batch,), generator=generator)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        loss = loss_of(tree(leaves), idx.to(device))
        grads = torch.autograd.grad(loss, leaves)
        leaves, opt, _ = A.adamw_update(ocfg, leaves, list(grads), opt, step)
    return (tree([t.detach() for t in leaves]),
            math.nan if loss is None else float(loss.detach()))


def encode_inr(cfg: SirenConfig, img, *, steps: int = 300, lr: float = 1e-4,
               generator: torch.Generator | None = None, batch: int = 1024,
               device=None):
    """Fit SIREN params to ``img`` on ``device`` (CUDA unless the caller
    passes "cpu") with AdamW on random batches of pixels drawn from
    ``generator`` (seed 0 when None); returns (params, final_mse)."""
    device = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    coords = image_coords(img.shape[0], device)
    target = torch.as_tensor(img, device=device).reshape(-1, 1)

    def loss_of(p, idx):
        return torch.mean((siren_apply(p, coords[idx], cfg.w0)
                           - target[idx]) ** 2)
    return fit_adam(siren_init(cfg, gen, device), loss_of, coords.shape[0],
                    steps=steps, lr=lr, batch=batch, generator=gen)


def decode_inr(cfg: SirenConfig, params, res: int) -> torch.Tensor:
    coords = image_coords(res, params[0]["w"].device)
    with torch.no_grad():
        out = siren_apply(params, coords, cfg.w0)
    return out.reshape(res, res)
