"""The architecture zoo, dense subset: templates and the forward / prefill /
decode family of the uniform dense stack (``family`` ``dense`` or
``audio``).

Port of ``repro.models.zoo``.  The reference scans one compiled layer body
over stacked ``[n_layers, ...]`` parameters, feeding each layer's attention
window through the scan as a traced value.  The port keeps the stacked
layout (so parameters and caches have the reference's shapes) and runs a
Python loop over ``lp = {k: v[i]}`` with each window a plain int, which the
kernel's mask takes as a launch argument.

Families ``moe``, ``ssm``, ``hybrid`` and ``vlm`` raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.template import ParamSpec, tree_map

NORM = lambda d: ParamSpec((d,), ("tiny",), init="zeros")

_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 item 13b (MoE: moe_ffn)",
    "ssm": "ROADMAP Queue 1 item 13c (SSM / hybrid: mamba_layer, ssd_chunked)",
    "hybrid": "ROADMAP Queue 1 item 13c (SSM / hybrid: mamba_layer, "
              "ssd_chunked)",
    "vlm": "ROADMAP Queue 1 item 13d (VLM: cross attention)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                                  f"ported yet, {_NOT_PORTED[cfg.family]}")
    if cfg.family not in ("dense", "audio") or cfg.n_experts \
            or cfg.ssm_state or cfg.cross_attn_period:
        raise NotImplementedError(f"{cfg.name}: only the uniform dense stack "
                                  f"is ported (ROADMAP Queue 1 item 13)")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------

def stack_tree(tree, n):
    return tree_map(lambda s: ParamSpec((n, *s.shape), ("stack", *s.logical),
                                        s.init, s.scale, s.dtype), tree)


def attn_template(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    t = {
        "q": ParamSpec((D, cfg.q_dim), ("attn_fsdp", "q_dim")),
        "k": ParamSpec((D, cfg.kv_dim), ("attn_fsdp", "kv_dim")),
        "v": ParamSpec((D, cfg.kv_dim), ("attn_fsdp", "kv_dim")),
        "o": ParamSpec((cfg.q_dim, D), ("o_in", "attn_fsdp")),
    }
    if cfg.qk_norm:
        t["qn"] = NORM(cfg.head_dim)
        t["kn"] = NORM(cfg.head_dim)
    return t


def mlp_template(cfg: ModelConfig, hidden: int) -> dict:
    D = cfg.d_model
    t = {"wi": ParamSpec((D, hidden), ("mlp_fsdp", "ff")),
         "wo": ParamSpec((hidden, D), ("ff", "mlp_fsdp"))}
    if cfg.mlp_type in ("swiglu", "geglu"):
        t["wg"] = ParamSpec((D, hidden), ("mlp_fsdp", "ff"))
    return t


def _uniform_layer_template(cfg: ModelConfig) -> dict:
    """One layer of a uniform dense stack."""
    D = cfg.d_model
    return {"ln1": NORM(D), "attn": attn_template(cfg), "ln2": NORM(D),
            "mlp": mlp_template(cfg, cfg.d_ff)}


def model_template(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="scaled",
                           scale=0.02),
        "lm_head": ParamSpec((D, V), ("embed", "vocab")),
        "final_norm": NORM(D),
        "layers": stack_tree(_uniform_layer_template(cfg), cfg.n_layers),
    }


def params_from_jax(tree, device=None) -> dict:
    """The reference's parameter tree (numpy or JAX arrays, stacked
    ``[n_layers, ...]`` leaves) as the port's tree of tensors on ``device``
    (CUDA unless ``"cpu"``), same keys and layout."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = global), as Python ints."""
    return [0 if cfg.is_global_attn_layer(i) else cfg.sliding_window
            for i in range(cfg.n_layers)]


def _layer(params, i: int) -> dict:
    return tree_map(lambda a: a[i], params["layers"])


def _embed(cfg, params, batch, cdt):
    if cfg.embed_input:
        return batch["embeds"].to(cdt)
    return params["embed"][batch["tokens"]].to(cdt)


def _attn_block(cfg, p, x, positions, window, attn_impl):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, k, v = L.attn_forward(cfg, p["attn"], h, positions, window=window,
                             attn_impl=attn_impl)
    return x + a, k, v


def _ffn_block(cfg, p, x):
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg.mlp_type, x.dtype)


def forward(cfg: ModelConfig, params, batch, *, attn_impl="flash"):
    """Scoring forward pass -> (logits [B, S, V] in the compute dtype, aux
    loss 0).  No remat: the port runs no backward pass yet."""
    _check_family(cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(cfg, params, batch, cdt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i, window in enumerate(_layer_windows(cfg)):
        lp = _layer(params, i)
        x, _, _ = _attn_block(cfg, lp, x, positions, window, attn_impl)
        x = _ffn_block(cfg, lp, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(cdt)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# decode path (serve_step) + prefill
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, *, device=None,
               abstract=False) -> dict:
    """Decode cache ``{"layers": {"k", "v": [L, B, seq, KH, hd]}}`` in the
    compute dtype; ``abstract`` puts it on ``meta``."""
    _check_family(cfg)
    device = torch.device("meta") if abstract else resolve_device(device)
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    cdt = _dtype(cfg.compute_dtype)
    return {"layers": {"k": torch.zeros(shape, dtype=cdt, device=device),
                       "v": torch.zeros(shape, dtype=cdt, device=device)}}


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """One autoregressive step.  tokens: [B] integers; pos: int.
    Returns (next_tokens [B] int32, cache).  The cache is written IN PLACE
    (this token's k and v at ``pos``) and returned; the reference returns an
    updated copy."""
    _check_family(cfg)
    pos = int(pos)
    cdt = _dtype(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt)[:, None, :]
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, window in enumerate(_layer_windows(cfg)):
        lp = _layer(params, i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = L.attn_decode(cfg, lp["attn"], h, ck[i], cv[i], pos,
                                window=window)
        x = _ffn_block(cfg, lp, x + a)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"].to(cdt)).to(torch.float32)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def prefill(cfg: ModelConfig, params, batch, *, attn_impl="flash"):
    """Prefill pass: forward over S tokens -> (last logits [B, V] float32,
    cache ``{"layers": {"k", "v": [L, B, S, KH, hd]}}``)."""
    _check_family(cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(cfg, params, batch, cdt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ks, vs = [], []
    for i, window in enumerate(_layer_windows(cfg)):
        lp = _layer(params, i)
        x, k, v = _attn_block(cfg, lp, x, positions, window, attn_impl)
        ks.append(k)
        vs.append(v)
        x = _ffn_block(cfg, lp, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ params["lm_head"].to(cdt)).to(torch.float32)
    return logits, {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def input_structs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins on ``meta`` for every model input of a cell."""
    _check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    meta = {"device": "meta"}
    if shape.kind == "decode":
        return {"tokens": torch.empty((B,), dtype=torch.int32, **meta),
                "pos": torch.empty((), dtype=torch.int32, **meta)}
    batch = {}
    if cfg.embed_input:
        batch["embeds"] = torch.empty((B, S, cfg.d_model),
                                      dtype=_dtype(cfg.compute_dtype), **meta)
    else:
        batch["tokens"] = torch.empty((B, S), dtype=torch.int32, **meta)
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, **meta)
    return batch


def make_inputs(cfg: ModelConfig, shape_or_bs, rng=None, seq=None,
                device=None) -> dict:
    """Concrete random inputs, drawn on the host with numpy (``rng``: a seed
    or a ``numpy.random.Generator``) so that a test can hand the same draw
    to the reference.  ``device=None`` means CUDA."""
    _check_family(cfg)
    device = resolve_device(device)
    if isinstance(shape_or_bs, ShapeConfig):
        B, S, kind = (shape_or_bs.global_batch, shape_or_bs.seq_len,
                      shape_or_bs.kind)
    else:
        B, S, kind = shape_or_bs, seq, "train"
    gen = rng if isinstance(rng, np.random.Generator) else \
        np.random.default_rng(0 if rng is None else rng)

    def ints(shape):
        return torch.from_numpy(gen.integers(0, cfg.vocab_size,
                                             shape)).to(device)

    if kind == "decode":
        return {"tokens": ints((B,)), "pos": S - 1}
    batch = {}
    if cfg.embed_input:
        batch["embeds"] = torch.from_numpy(gen.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)).to(
                device, _dtype(cfg.compute_dtype))
    else:
        batch["tokens"] = ints((B, S))
    if kind == "train":
        batch["labels"] = ints((B, S))
    return batch
