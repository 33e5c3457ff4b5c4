"""The architecture zoo: templates and the forward / loss / prefill / decode
family of every LM family: the uniform stacks (``family`` ``dense``,
``audio``, ``moe``, ``ssm``), the hybrid one (``hybrid``: jamba's period of
mamba and attention layers, dense and MoE feed-forwards) and the VLM one
(``vlm``: llama-3.2-vision's periods of self-attention layers and one
gated cross-attention layer over precomputed image embeddings).

Port of ``repro.models.zoo``.  The reference scans one compiled layer body
over stacked ``[n_layers, ...]`` parameters (for the hybrid, over periods
of stacked ``[n_blocks, ...]`` sub-trees indexed by slot; for the VLM over
``[n_periods, n_self, ...]`` self layers), feeding each layer's attention
window through the scan as a traced value.  The port keeps the stacked
layouts (so parameters and caches have the reference's shapes and
``params_from_jax`` carries any reference tree across) and runs a Python
loop over the layers (``_layers``, which unbinds each stacked leaf once)
with each window a plain int, which the attention kernel's mask takes as a
launch argument.  A mamba layer runs its inter-chunk recurrence through
the ``ssd_scan`` kernel (``layers.ssd_chunked``).

Training: ``forward`` / ``loss_fn`` take the reference's ``remat``
(``"none"``, ``"dots"``: recompute everything but the unbatched matrix
products, ``"full"``: recompute everything) per layer through
``torch.utils.checkpoint``, and its ``constrain`` hooks.  Recomputation
relaunches the forward kernels of the layer.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.template import ParamSpec, tree_map

NORM = lambda d: ParamSpec((d,), ("tiny",), init="zeros")

_FAMILIES = ("dense", "audio", "moe", "ssm", "hybrid", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class _GradCastBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # autograd casts the bf16 gradient back to x's dtype, as JAX does
        return g.to(torch.bfloat16)


def grad_cast_bf16(x):
    """Identity with a bf16 cotangent barrier: stops f32 dtype drift in the
    backward residual chain (mixed-precision cotangent casting)."""
    return _GradCastBf16.apply(x)


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


def _vlm_period_template(cfg: ModelConfig) -> dict:
    """One period: ``cross_attn_period - 1`` stacked self-attention layers
    and one cross-attention layer with its tanh gate."""
    n_self = cfg.cross_attn_period - 1
    self_layer = {"ln1": NORM(cfg.d_model), "attn": attn_template(cfg),
                  "ln2": NORM(cfg.d_model), "mlp": mlp_template(cfg, cfg.d_ff)}
    cross_layer = {"lnx": NORM(cfg.d_model), "xattn": attn_template(cfg),
                   "ln2": NORM(cfg.d_model), "mlp": mlp_template(cfg, cfg.d_ff),
                   "gate": ParamSpec((1,), ("tiny",), init="zeros")}
    return {"self": stack_tree(self_layer, n_self), "cross": cross_layer}


def model_template(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    t = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), init="scaled",
                           scale=0.02),
        "lm_head": ParamSpec((D, V), ("embed", "vocab")),
        "final_norm": NORM(D),
    }
    if cfg.family == "vlm":
        t["periods"] = stack_tree(_vlm_period_template(cfg),
                                  cfg.n_layers // cfg.cross_attn_period)
    elif cfg.family == "hybrid":
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


def _unstack(tree, n: int) -> list[dict]:
    """A tree of stacked ``[n, ...]`` leaves as n trees of views, each leaf
    unbound once (under autograd one ``unbind`` per leaf, whose backward
    stacks the layers' gradients)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _layers(cfg: ModelConfig, params):
    """The stack in order: (mixer, layer params, attention window, cache
    index, first) per layer, mixer ``"attn"``, ``"mamba"`` or ``"cross"``.
    The cache index addresses the layer's entry in its cache group
    (``_cache_entry``): the layer for a uniform stack; for the hybrid, the
    block for attention and (block, j) for the period's j-th mamba layer;
    for the VLM, (period, j) for the j-th self layer and the period for the
    cross layer.  ``first`` marks where the reference applies ``constrain``:
    every layer of a uniform stack, the first of a hybrid block, every VLM
    self layer."""
    if cfg.family == "hybrid":
        period, counts = _hybrid_period(cfg)
        for blk, bp in enumerate(_unstack(params["blocks"],
                                          cfg.n_layers // cfg.attn_period)):
            units = {key: (_unstack(unit, counts[key]) if counts[key] > 1
                           else [unit]) for key, unit in bp.items()}
            j = 0
            for n, (mixer, _, key, slot) in enumerate(period):
                lp = units[key][slot]
                if mixer == "attn":
                    yield mixer, lp, 0, blk, n == 0
                else:
                    yield mixer, lp, 0, (blk, j), n == 0
                    j += 1
        return
    if cfg.family == "vlm":
        n_self = cfg.cross_attn_period - 1
        for per, pp in enumerate(_unstack(params["periods"],
                                          cfg.n_layers
                                          // cfg.cross_attn_period)):
            for j, lp in enumerate(_unstack(pp["self"], n_self)):
                yield "attn", lp, 0, (per, j), True
            yield "cross", pp["cross"], 0, per, False
        return
    mixer = "mamba" if cfg.family == "ssm" else "attn"
    for i, (window, lp) in enumerate(zip(_layer_windows(cfg),
                                         _unstack(params["layers"],
                                                  cfg.n_layers))):
        yield mixer, lp, window, i, True


def _cache_entry(cfg: ModelConfig, cache, mixer: str, idx) -> dict:
    """The cache leaves of one layer (views): its group's leaves at
    ``idx``."""
    if cfg.family == "hybrid":
        group = cache[mixer]
    elif cfg.family == "vlm":
        group = cache["cross" if mixer == "cross" else "self"]
    else:
        group = cache["layers"]
    return {k: t[idx] for k, t in group.items()}


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


def _cross_block(cfg, p, x, image):
    """x + tanh(gate) * cross attention -> (x, k, v of the image)."""
    h = L.rms_norm(x, p["lnx"], cfg.norm_eps)
    a, k, v = L.cross_attn_forward(cfg, p["xattn"], h, image)
    return x + torch.tanh(p["gate"].to(x.dtype)) * a, k, v


def _ffn_block(cfg, p, x):
    """The feed-forward half of a layer -> (x, aux loss); a pure mamba
    layer has none and returns x unchanged."""
    if "moe" in p:
        f, aux = L.moe_ffn(cfg, p["moe"], L.rms_norm(x, p["ln2"],
                                                     cfg.norm_eps))
    elif "mlp" in p:
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        f, aux = L.mlp(p["mlp"], h, cfg.mlp_type, x.dtype), 0.0
    else:
        return x, 0.0
    return x + f, aux


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

# the reference's ``dots_with_no_batch_dims_saveable``: outputs of matrix
# products without batch dimensions are kept, everything else (batched
# products included) is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat(fn, policy: str):
    """``fn`` recomputed in the backward by ``policy`` (``"none"``,
    ``"dots"``, ``"full"``); outside autograd ``fn`` runs as it is."""
    if policy == "none":
        return fn
    if policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       list(_DOTS))
    elif policy == "full":
        context_fn = None
    else:
        raise ValueError(f"unknown remat policy {policy!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return wrapped


def forward(cfg: ModelConfig, params, batch, *, remat="dots",
            attn_impl="flash", constrain=None):
    """Training / scoring forward pass -> (logits [B, S, V] in the compute
    dtype, aux loss: the MoE layers' sum, float32).  ``remat`` is applied
    per layer (the reference's per scan body: a layer, or a hybrid block;
    the VLM cross layer is not recomputed, as there); ``constrain`` wraps
    the residual stream where the reference does (``_layers``' ``first``)."""
    _check_family(cfg)
    cons = constrain if constrain is not None else (lambda a: a)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(cfg, params, batch, cdt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    image = batch.get("image_embeds")
    if image is not None:
        image = image.to(cdt)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer_fn(mixer, window, first, x, lp):
        if first:
            x = cons(x)
        if mixer == "attn":
            x, _, _ = _attn_block(cfg, lp, x, positions, window, attn_impl)
        else:
            x, _ = _mamba_block(cfg, lp, x)
        return _ffn_block(cfg, lp, x)

    for mixer, lp, window, _, first in _layers(cfg, params):
        if mixer == "cross":
            x, _, _ = _cross_block(cfg, lp, x, image)
            x, aux = _ffn_block(cfg, lp, x)
        else:
            x, aux = _remat(functools.partial(layer_fn, mixer, window, first),
                            remat)(x, lp)
        aux_total = aux_total + aux
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(cdt)
    return logits, aux_total


def ce_loss(logits, labels, vocab_chunk=0):
    """Cross entropy in f32; optional vocab chunking to bound live
    memory."""
    if vocab_chunk and logits.shape[-1] > vocab_chunk:
        V = logits.shape[-1]
        nc = math.ceil(V / vocab_chunk)
        pad = nc * vocab_chunk - V
        lp = torch.nn.functional.pad(logits, (0, pad), value=L.NEG_INF)
        chunks = lp.reshape(*lp.shape[:-1], nc, vocab_chunk)
        m = torch.full(logits.shape[:-1], L.NEG_INF, dtype=torch.float32,
                       device=logits.device)
        s = torch.zeros(logits.shape[:-1], dtype=torch.float32,
                        device=logits.device)
        for i in range(nc):
            c = chunks[..., i, :]
            m_new = torch.maximum(m, c.amax(-1).to(torch.float32))
            s = s * torch.exp(m - m_new) + torch.exp(
                c.to(torch.float32) - m_new[..., None]).sum(-1)
            m = m_new
        lse = m + torch.log(s)
    else:
        lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0].to(
        torch.float32)
    return (lse - lab).mean()


def loss_fn(cfg, params, batch, *, remat="dots", attn_impl="flash",
            vocab_chunk=0, aux_coef=0.01, constrain=None):
    logits, aux = forward(cfg, params, batch, remat=remat,
                          attn_impl=attn_impl, constrain=constrain)
    return ce_loss(logits, batch["labels"], vocab_chunk) + aux_coef * aux


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
    hybrid (``n`` = blocks, then blocks x mamba layers per period); for
    the VLM ``{"self": {"k", "v": [periods, n_self, B, seq, KH, hd]},
    "cross": {"xk", "xv": [periods, B, n_image_tokens, KH, hd]}}``.
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
    if cfg.family == "vlm":
        n_periods = cfg.n_layers // cfg.cross_attn_period
        shape = (n_periods, batch, cfg.n_image_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"self": kv(n_periods, cfg.cross_attn_period - 1),
                "cross": {"xk": torch.zeros(shape, dtype=cdt, device=device),
                          "xv": torch.zeros(shape, dtype=cdt,
                                            device=device)}}
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
    for mixer, lp, window, idx, _ in _layers(cfg, params):
        c = _cache_entry(cfg, cache, mixer, idx)
        if mixer == "cross":
            h = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
            a = L.cross_attn_decode(cfg, lp["xattn"], h, c["xk"], c["xv"])
            x, _ = _ffn_block(cfg, lp, x + torch.tanh(lp["gate"].to(x.dtype))
                              * a)
            continue
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
    layer's k and v, every mamba layer's last conv rows and final state,
    every cross layer's image k and v)."""
    _check_family(cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(cfg, params, batch, cdt)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :]
    image = batch.get("image_embeds")
    if image is not None:
        image = image.to(cdt)
    cache = init_cache(cfg, B, S, device=x.device)
    for mixer, lp, window, idx, _ in _layers(cfg, params):
        c = _cache_entry(cfg, cache, mixer, idx)
        if mixer == "cross":
            x, k, v = _cross_block(cfg, lp, x, image)
            c["xk"].copy_(k)
            c["xv"].copy_(v)
        elif mixer == "attn":
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
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.empty(
            (B, cfg.n_image_tokens, cfg.d_model),
            dtype=_dtype(cfg.compute_dtype), **meta)
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

    def normal(shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(device, _dtype(cfg.compute_dtype))

    if kind == "decode":
        return {"tokens": ints((B,)), "pos": S - 1}
    batch = {}
    if cfg.embed_input:
        batch["embeds"] = normal((B, S, cfg.d_model))
    else:
        batch["tokens"] = ints((B, S))
    if cfg.family == "vlm":
        batch["image_embeds"] = normal((B, cfg.n_image_tokens, cfg.d_model))
    if kind == "train":
        batch["labels"] = ints((B, S))
    return batch
