"""INSP-Net (Xu et al. [12]), the editing head the paper accelerates (port
of ``repro.inr.insp``).

An MLP over [y, dy/dx, d2y/dx2, ...] features of a SIREN INR.  Training the
head against a pixel-space transformation (blur, denoise, ...) makes the
composite network an INR of the EDITED image without ever decoding to pixels.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.siren import InspConfig, SirenConfig
from repro_torch.inr.gradnet import feature_vector
# the reference's INSP parameters have the SIREN's layout (a list of
# {"w": [in, out], "b": [out]}), so one conversion serves both
from repro_torch.inr.siren import params_from_jax

__all__ = ["insp_init", "insp_apply", "insp_head", "insp_pipeline",
           "params_from_jax"]


def insp_init(cfg: InspConfig, in_features: int, out_features: int,
              generator: torch.Generator, device="cpu") -> list[dict]:
    """The reference's initialisation: ``w ~ N(0, 1) / sqrt(fan_in)``,
    ``b = 0``, drawn from ``generator``."""
    sizes = [in_features] + [cfg.hidden] * (cfg.layers - 1) + [out_features]
    params = []
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(fi, fo, generator=generator) / math.sqrt(fi)
        params.append({"w": w.to(device),
                       "b": torch.zeros(fo, device=device)})
    return params


def insp_apply(params: list[dict], feats: torch.Tensor) -> torch.Tensor:
    h = feats
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def insp_head(psi: list[dict]):
    """The INSP head as a feature-space filter: a closure over ``psi``
    suitable as one head of ``core.pipeline.compile_bank``: it maps the
    feature matrix the bank's shared prefix computes to this filter's
    output."""
    def head(feats):
        return insp_apply(psi, feats)
    return head


def insp_pipeline(siren_cfg: SirenConfig, insp_cfg: InspConfig, f):
    """Returns edited(x, psi): INSP head ``psi`` applied to INR gradient
    features of ``f``, the full computation the paper maps to hardware."""
    feats = feature_vector(f, insp_cfg.grad_order)

    def edited(x, psi):
        return insp_apply(psi, feats(x))
    return edited
