"""The architecture zoo: templates and the forward / prefill / decode family
of the uniform stacks (``family`` ``dense``, ``audio``, ``moe``, ``ssm``)
and the hybrid one (``hybrid``: jamba's period of mamba and attention
layers, dense and MoE feed-forwards).

Port of ``repro.models.zoo``.  The reference scans one compiled layer body
over stacked ``[n_layers, ...]`` parameters (for the hybrid, over periods
of stacked ``[n_blocks, ...]`` sub-trees indexed by slot), feeding each
layer's attention window through the scan as a traced value.  The port
keeps the stacked layouts (so parameters and caches have the reference's
shapes and ``params_from_jax`` carries any reference tree across) and runs
a Python loop over the layers (``_layers``) with each window a plain int,
which the attention kernel's mask takes as a launch argument.  A mamba
layer's prefill runs its inter-chunk recurrence through the ``ssd_scan``
kernel (``layers.ssd_chunked``).

Family ``vlm`` raises ``NotImplementedError`` naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.template import ParamSpec, tree_map

NORM = lambda d: ParamSpec((d,), ("tiny",), init="zeros")

_FAMILIES = ("dense", "audio", "moe", "ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "vlm" or cfg.cross_attn_period:
        raise NotImplementedError(f"{cfg.name}: cross attention (family "
                                  f"'vlm') is not ported yet, ROADMAP Queue "
                                  f"1 item 13d")
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


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


def moe_template(cfg: ModelConfig) -> dict:
    if cfg.mlp_type not in ("swiglu", "geglu"):
        raise ValueError(f"{cfg.name}: MoE experts are gated, got "
                         f"mlp_type {cfg.mlp_type!r}")
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_expert
    t = {
        "router": ParamSpec((D, E), ("mlp_fsdp", "tiny")),
        "wi": ParamSpec((E, D, F), ("experts", "expert_fsdp", "expert_ff")),
        "wg": ParamSpec((E, D, F), ("experts", "expert_fsdp", "expert_ff")),
        "wo": ParamSpec((E, F, D), ("experts", "expert_ff", "expert_fsdp")),
    }
    if cfg.n_shared_experts:
        t["shared"] = mlp_template(cfg, cfg.n_shared_experts * cfg.d_expert)
    return t


def mamba_template(cfg: ModelConfig) -> dict:
    D, di, n, nh = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "wz": ParamSpec((D, di), ("ssm_fsdp", "ssm_inner")),
        "wx": ParamSpec((D, di), ("ssm_fsdp", "ssm_inner")),
        "wb": ParamSpec((D, n), ("ssm_fsdp", "ssm_state")),
        "wc": ParamSpec((D, n), ("ssm_fsdp", "ssm_state")),
        "wdt": ParamSpec((D, nh), ("ssm_fsdp", "ssm_heads")),
        "conv": ParamSpec((4, di + 2 * n), ("conv_w", "ssm_inner"),
                          init="scaled", scale=0.5),
        "a_log": ParamSpec((nh,), ("tiny",), init="ssm_a"),
        "d": ParamSpec((nh,), ("tiny",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("tiny",), init="zeros"),
        "norm": NORM(di),
        "wo": ParamSpec((di, D), ("ssm_inner", "ssm_fsdp")),
    }


def _uniform_layer_template(cfg: ModelConfig) -> dict:
    """One layer of a uniform stack."""
    D = cfg.d_model
    if cfg.family == "ssm":
        return {"ln": NORM(D), "mamba": mamba_template(cfg)}
    t = {"ln1": NORM(D), "attn": attn_template(cfg), "ln2": NORM(D)}
    if cfg.n_experts and cfg.moe_every == 1:
        t["moe"] = moe_template(cfg)
    else:
        t["mlp"] = mlp_template(cfg, cfg.d_ff)
    return t


def _hybrid_period(cfg: ModelConfig):
    """Jamba's period: (mixer, ffn, key, slot) for each of its layers, and
    the number of layers of each key (``mixer_ffn``)."""
    period = []
    counts = {"mamba_dense": 0, "mamba_moe": 0, "attn_dense": 0,
              "attn_moe": 0}
    for j in range(cfg.attn_period):
        mixer = "attn" if cfg.is_attn_layer(j) else "mamba"
        ffn = "moe" if cfg.is_moe_layer(j) else "dense"
        key = f"{mixer}_{ffn}"
        period.append((mixer, ffn, key, counts[key]))
        counts[key] += 1
    return period, counts


def _hybrid_block_template(cfg: ModelConfig) -> dict:
    """One period: a sub-tree per key, stacked over its slots where the
    key has more than one layer."""
    D = cfg.d_model
    _, counts = _hybrid_period(cfg)
    t = {}
    for key, cnt in counts.items():
        if cnt == 0:
            continue
        mixer, ffn = key.split("_")
        unit = {"ln1": NORM(D), "ln2": NORM(D)}
        unit["mamba" if mixer == "mamba" else "attn"] = (
            mamba_template(cfg) if mixer == "mamba" else attn_template(cfg))
        unit["moe" if ffn == "moe" else "mlp"] = (
            moe_template(cfg) if ffn == "moe" else mlp_template(cfg, cfg.d_ff))
        t[key] = stack_tree(unit, cnt) if cnt > 1 else unit
    return t


def model_template(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    t = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="scaled",
                           scale=0.02),
        "lm_head": ParamSpec((D, V), ("embed", "vocab")),
        "final_norm": NORM(D),
    }
    if cfg.family == "hybrid":
        t["blocks"] = stack_tree(_hybrid_block_template(cfg),
                                 cfg.n_layers // cfg.attn_period)
    else:
        t["layers"] = stack_tree(_uniform_layer_template(cfg), cfg.n_layers)
    return t


def params_from_jax(tree, device=None) -> dict:
    """The reference's parameter tree (numpy or JAX arrays, stacked
    ``[n_layers, ...]`` or ``[n_blocks, ...]`` leaves) as the port's tree
    of tensors on ``device`` (CUDA unless ``"cpu"``), same keys and
    layout."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


# ---------------------------------------------------------------------------
# the layer loop
# ---------------------------------------------------------------------------

def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = global), as Python ints."""
    return [0 if cfg.is_global_attn_layer(i) else cfg.sliding_window
            for i in range(cfg.n_layers)]


def _layers(cfg: ModelConfig, params):
    """The stack in order: (mixer, layer params, attention window, cache
    index) per layer, mixer ``"attn"`` or ``"mamba"``.  The cache index
    addresses the layer's entry in its cache group (``_cache_group``): the
    layer for a uniform stack; for the hybrid, the block for attention and
    (block, j) for the period's j-th mamba layer."""
    if cfg.family == "hybrid":
        period, counts = _hybrid_period(cfg)
        for blk in range(cfg.n_layers // cfg.attn_period):
            bp = tree_map(lambda a: a[blk], params["blocks"])
            j = 0
            for mixer, _, key, slot in period:
                lp = (tree_map(lambda a: a[slot], bp[key])
                      if counts[key] > 1 else bp[key])
                if mixer == "attn":
                    yield mixer, lp, 0, blk
                else:
                    yield mixer, lp, 0, (blk, j)
                    j += 1
        return
    mixer = "mamba" if cfg.family == "ssm" else "attn"
    for i, window in enumerate(_layer_windows(cfg)):
        yield mixer, tree_map(lambda a: a[i], params["layers"]), window, i


def _cache_group(cfg: ModelConfig, cache, mixer: str) -> dict:
    if cfg.family == "hybrid":
        return cache[mixer]
    return cache["layers"]


def _embed(cfg, params, batch, cdt):
    if cfg.embed_input:
        return batch["embeds"].to(cdt)
    return params["embed"][batch["tokens"]].to(cdt)


def _mixer_norm(cfg, p, x):
    return L.rms_norm(x, p["ln1" if "ln1" in p else "ln"], cfg.norm_eps)


def _attn_block(cfg, p, x, positions, window, attn_impl):
    a, k, v = L.attn_forward(cfg, p["attn"], _mixer_norm(cfg, p, x),
                             positions, window=window, attn_impl=attn_impl)
    return x + a, k, v


def _mamba_block(cfg, p, x, return_state=False):
    y, state = L.mamba_layer(cfg, p["mamba"], _mixer_norm(cfg, p, x),
                             return_state=return_state)
    return x + y, state


def _ffn_block(cfg, p, x):
    """The feed-forward half of a layer -> (x, aux loss); a pure mamba
    layer has none and returns x unchanged."""
    if "moe" in p:
        f, aux = L.moe_ffn(cfg, p["moe"], L.rms_norm(x, p["ln2"],
                                                     cfg.norm_eps))
        return x + f, aux
    if "mlp" in p:
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.mlp_type, x.dtype), 0.0
    return x, 0.0


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, batch, *, attn_impl="flash"):
    """Scoring forward pass -> (logits [B, S, V] in the compute dtype, aux
    loss: the MoE layers' sum, float32).  No remat: the port runs no
    backward pass yet."""
    _check_family(cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(cfg, params, batch, cdt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for mixer, lp, window, _ in _layers(cfg, params):
        if mixer == "attn":
            x, _, _ = _attn_block(cfg, lp, x, positions, window, attn_impl)
        else:
            x, _ = _mamba_block(cfg, lp, x)
        x, aux = _ffn_block(cfg, lp, x)
        aux_total = aux_total + aux
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(cdt)
    return logits, aux_total


# ---------------------------------------------------------------------------
# decode path (serve_step) + prefill
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, *, device=None,
               abstract=False) -> dict:
    """Decode cache, zeros, with the reference's layout: attention layers
    ``{"k", "v": [n, B, seq, KH, hd]}`` in the compute dtype, mamba layers
    ``{"conv": [n, B, 3, di + 2 n_state]}`` in the compute dtype and
    ``{"ssm": [n, B, heads, head_dim, n_state]}`` in float32, under
    ``"layers"`` for a uniform stack and ``"attn"`` / ``"mamba"`` for the
    hybrid (``n`` = blocks, then blocks x mamba layers per period).
    ``abstract`` puts it on ``meta``."""
    _check_family(cfg)
    device = torch.device("meta") if abstract else resolve_device(device)
    cdt = _dtype(cfg.compute_dtype)

    def kv(*lead):
        shape = (*lead, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cdt, device=device),
                "v": torch.zeros(shape, dtype=cdt, device=device)}

    def ssm(*lead):
        n = cfg.ssm_state
        return {"conv": torch.zeros((*lead, batch, 3, cfg.ssm_inner + 2 * n),
                                    dtype=cdt, device=device),
                "ssm": torch.zeros((*lead, batch, cfg.ssm_heads,
                                    cfg.ssm_head_dim, n), dtype=L._acc(cdt),
                                   device=device)}

    if cfg.family == "ssm":
        return {"layers": ssm(cfg.n_layers)}
    if cfg.family == "hybrid":
        n_blocks = cfg.n_layers // cfg.attn_period
        return {"attn": kv(n_blocks),
                "mamba": ssm(n_blocks, cfg.attn_period - 1)}
    return {"layers": kv(cfg.n_layers)}


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """One autoregressive step.  tokens: [B] integers; pos: int.
    Returns (next_tokens [B] int32, cache).  The cache is written IN PLACE
    (this token's k and v at ``pos``, each mamba layer's conv rows and
    state) and returned; the reference returns an updated copy."""
    _check_family(cfg)
    pos = int(pos)
    cdt = _dtype(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt)[:, None, :]
    for mixer, lp, window, idx in _layers(cfg, params):
        c = {k: t[idx] for k, t in _cache_group(cfg, cache, mixer).items()}
        h = _mixer_norm(cfg, lp, x)
        if mixer == "attn":
            a, _, _ = L.attn_decode(cfg, lp["attn"], h, c["k"], c["v"], pos,
                                    window=window)
        else:
            a, (conv, state) = L.mamba_layer(cfg, lp["mamba"], h,
                                             conv_cache=c["conv"],
                                             ssm_state=c["ssm"], decode=True)
            c["conv"].copy_(conv)
            c["ssm"].copy_(state)
        x, _ = _ffn_block(cfg, lp, x + a)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"].to(cdt)).to(torch.float32)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def prefill(cfg: ModelConfig, params, batch, *, attn_impl="flash"):
    """Prefill pass: forward over S tokens -> (last logits [B, V] float32,
    the decode cache of ``init_cache(cfg, B, S)`` filled: every attention
    layer's k and v, every mamba layer's last conv rows and final
    state)."""
    _check_family(cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(cfg, params, batch, cdt)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :]
    cache = init_cache(cfg, B, S, device=x.device)
    for mixer, lp, window, idx in _layers(cfg, params):
        c = {k: t[idx] for k, t in _cache_group(cfg, cache, mixer).items()}
        if mixer == "attn":
            x, k, v = _attn_block(cfg, lp, x, positions, window, attn_impl)
            c["k"].copy_(k)
            c["v"].copy_(v)
        else:
            x, (conv, state) = _mamba_block(cfg, lp, x, return_state=True)
            c["conv"].copy_(conv)
            c["ssm"].copy_(state)
        x, _ = _ffn_block(cfg, lp, x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ params["lm_head"].to(cdt)).to(torch.float32)
    return logits, cache


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
