"""SIREN (Sitzmann et al.) as a torch module (port of ``repro.inr.siren``).

f: R^in -> R^out, MLP with sine activations:
    h_0 = sin(w0 (x W_0 + b_0));  h_k = sin(w0 (h W_k + b_k));  y = h W_L + b_L

The layout is the reference's: ``W`` is ``[in, out]`` and a layer computes
``h @ W + b`` (not ``nn.Linear``), so the traced gradient graph has the
reference's Mm orientation.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.siren import SirenConfig


def _sizes(cfg: SirenConfig) -> list[int]:
    return ([cfg.in_features] + [cfg.hidden_features] * cfg.hidden_layers
            + [cfg.out_features])


def siren_init(cfg: SirenConfig, generator: torch.Generator,
               device="cpu") -> list[dict]:
    """Weights with the reference's bounds: U(-1/fin, 1/fin) for the first
    layer, U(-sqrt(6/fin)/w0, sqrt(6/fin)/w0) after it."""
    sizes = _sizes(cfg)
    params = []
    for i, (fin, fout) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = 1.0 / fin if i == 0 else math.sqrt(6.0 / fin) / cfg.w0
        w = torch.empty(fin, fout).uniform_(-bound, bound,
                                            generator=generator)
        b = torch.empty(fout).uniform_(-bound, bound, generator=generator)
        params.append({"w": w.to(device), "b": b.to(device)})
    return params


def params_from_jax(params) -> list[dict]:
    """The JAX package's SIREN parameters, given as numpy arrays (or
    anything ``np.asarray`` takes), as the port's: both then compute the
    same function."""
    return [{"w": torch.from_numpy(np.array(p["w"], np.float32)),
             "b": torch.from_numpy(np.array(p["b"], np.float32))}
            for p in params]


def siren_apply(params: list[dict], x: torch.Tensor, w0: float = 30.0):
    """x: [..., in] -> [..., out]."""
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.sin(w0 * h)
    return h


class Siren(nn.Module):
    """The SIREN as a module; its weights are fixed parameters (the
    gradient pipeline differentiates with respect to the input only)."""

    def __init__(self, cfg: SirenConfig, params: list[dict]):
        super().__init__()
        self.cfg = cfg
        self.ws = nn.ParameterList(nn.Parameter(p["w"], requires_grad=False)
                                   for p in params)
        self.bs = nn.ParameterList(nn.Parameter(p["b"], requires_grad=False)
                                   for p in params)

    def params(self) -> list[dict]:
        return [{"w": w, "b": b} for w, b in zip(self.ws, self.bs)]

    def forward(self, x):
        return siren_apply(self.params(), x, self.cfg.w0)


def siren_fn(cfg: SirenConfig, params: list[dict]) -> Siren:
    return Siren(cfg, params)
