"""Step builders, serving subset: prefill and decode steps for every
ported family (dense, audio, MoE, SSM, hybrid; ``models/zoo.py``), and the
serving parameters.

Port of the serving half of ``repro.launch.steps``.  The steps close over
(ModelConfig, HParams) and run eagerly on the device their parameters live
on: on the card a prefill launches the attention kernel in every attention
layer and the ``ssd_scan`` kernel in every mamba layer.  Training steps,
shardings and the dry run are not ported yet (ROADMAP Queue 1 items 13e,
13f and 12).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import zoo
from repro_torch.models.template import tree_map


@dataclass(frozen=True)
class HParams:
    """Serving knobs.

    ``attn_impl`` defaults to ``"pallas"``, the port's hand-written
    flash-attention kernel (``kernels/flash_attention.py``): as
    ``use_pallas=None`` means "the port's kernels" on the INR path, the
    normal serving entry point on the card goes through the kernel.  (The
    reference defaults to ``"flash"``.)  ``"flash"`` is the blockwise plain
    tensor version.  ``serve_dtype`` is the parameters' dtype for serving."""
    attn_impl: str = "pallas"        # pallas | flash
    serve_dtype: str = "bfloat16"


def build_prefill_step(cfg: ModelConfig, hp: HParams):
    def prefill_step(params, batch):
        with torch.no_grad():
            return zoo.prefill(cfg, params, batch, attn_impl=hp.attn_impl)
    return prefill_step


def build_serve_step(cfg: ModelConfig, hp: HParams):
    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return zoo.decode_step(cfg, params, cache, tokens, pos)
    return serve_step


def serving_params(cfg: ModelConfig, hp: HParams, params) -> dict:
    """``params`` with every float32 leaf cast to ``hp.serve_dtype`` (the
    SSM's ``a_log``, ``d`` and ``dt_bias`` too): the concrete counterpart
    of the reference's ``serving_params_struct``.  ``init_params(...,
    dtype=hp.serve_dtype)`` draws the same tree without a float32 copy."""
    dt = getattr(torch, hp.serve_dtype)
    return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32 else a,
                    params)
