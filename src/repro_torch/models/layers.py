"""Model-zoo building blocks: the dense subset of ``repro.models.layers``.

Everything takes explicit param dicts (``models/zoo.py`` templates) and
keeps the reference's numerics, so that bf16 runs round where it rounds:

* ``rms_norm`` takes the mean of squares in float32 and multiplies in x's
  dtype;
* ``rope`` builds its angle table in float32 and rotates in x's dtype;
* attention scores and P.V accumulate in float32 (the reference's
  ``preferred_element_type``), and P is rounded to v's dtype before P.V.

"Float32" here means float32 or the input's own type where that is wider,
so a float64 run is a float64 evaluation of the same function.

Not ported yet (ROADMAP Queue 1 item 13): ``moe_ffn``, the Mamba2 / SSD
functions, ``cross_attn_*`` and ``flash_cvjp``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa_kernel

NEG_INF = -1e30


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# norms / rope / mlp
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps=1e-5):
    """RMSNorm: float32 statistics, only the [..., 1] moments in float32."""
    var = x.to(_acc(x.dtype)).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x * inv.to(x.dtype)) * (1.0 + w).to(x.dtype)


def rope(x, positions, theta):
    """x: [..., S, H, D], positions: [..., S].  Angle table in float32, the
    rotation in x's dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq     # [..., S, half]
    ang = ang[..., None, :]                                 # [..., S, 1, half]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _act(name):
    # jax.nn.gelu defaults to the tanh approximation
    return {"swiglu": F.silu,
            "geglu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp(p, x, mlp_type="swiglu", cdt=torch.bfloat16):
    act = _act(mlp_type)
    if mlp_type in ("swiglu", "geglu"):
        h = act(x @ p["wg"].to(cdt)) * (x @ p["wi"].to(cdt))
    else:
        h = act(x @ p["wi"].to(cdt))
    return h @ p["wo"].to(cdt)


# ---------------------------------------------------------------------------
# blockwise (flash-style) attention, plain tensor code
# ---------------------------------------------------------------------------

def _pad_to(x, axis, mult):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=None,
                    q_block=512, kv_block=1024):
    """Blockwise attention with a running softmax (``attn_impl="flash"``).

    q: [B, Sq, H, D]; k, v: [B, Sk, KH, D] with H = KH * G (GQA).
    window > 0 restricts to a local band (sliding-window attention).
    q_offset: starting absolute position of q; defaults to Sk - Sq.
    Every kv block is visited, masked or not, as in the reference."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    if q_offset is None:
        q_offset = Sk - Sq
    scale = 1.0 / math.sqrt(D)
    acc_t = _acc(q.dtype)
    dev = q.device

    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    q, k, v = _pad_to(q, 1, q_block), _pad_to(k, 1, kv_block), \
        _pad_to(v, 1, kv_block)
    nq, nk = q.shape[1] // q_block, k.shape[1] // kv_block
    neg = torch.tensor(NEG_INF, dtype=acc_t, device=dev)

    outs = []
    for qi in range(nq):
        qb = q[:, qi * q_block:(qi + 1) * q_block].reshape(
            B, q_block, KH, G, D).to(acc_t)
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((B, KH, G, q_block), NEG_INF, dtype=acc_t, device=dev)
        l = torch.zeros((B, KH, G, q_block), dtype=acc_t, device=dev)
        acc = torch.zeros((B, KH, G, q_block, D), dtype=acc_t, device=dev)
        for kj in range(nk):
            kb = k[:, kj * kv_block:(kj + 1) * kv_block]
            vb = v[:, kj * kv_block:(kj + 1) * kv_block]
            k_pos = kj * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb.to(acc_t)) * scale
            mask = (k_pos < Sk)[None, :].expand(q_block, kv_block)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window > 0:
                mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype).to(acc_t), vb.to(acc_t))
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.to(q.dtype))                      # [B, KH, G, Q, D]
    # [nq, B, KH, G, Q, D] -> [B, nq, Q, KH, G, D]
    out = torch.stack(outs, 0).permute(1, 0, 4, 2, 3, 5)
    return out.reshape(B, nq * q_block, H, D)[:, :Sq]


def decode_attention(q, k_cache, v_cache, pos, *, window=0):
    """Single-token attention against a cache.

    q: [B, 1, H, D]; caches: [B, Smax, KH, D]; pos: current position."""
    B, _, H, D = q.shape
    _, Smax, KH, _ = k_cache.shape
    G = H // KH
    acc_t = _acc(q.dtype)
    qi = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qi.to(acc_t), k_cache.to(acc_t)) \
        / math.sqrt(D)
    k_pos = torch.arange(Smax, device=q.device)
    mask = k_pos <= pos
    if window > 0:
        mask = mask & ((pos - k_pos) < window)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=acc_t,
                                          device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).to(acc_t),
                       v_cache.to(acc_t))
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# attention layer (prefill / decode)
# ---------------------------------------------------------------------------

def _qkv(cfg, p, x, positions, cdt):
    B = x.shape[0]
    q = (x @ p["q"].to(cdt)).reshape(B, -1, cfg.n_heads, cfg.head_dim)
    k = (x @ p["k"].to(cdt)).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["v"].to(cdt)).reshape(B, -1, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(cfg, p, x, positions, *, window=0, attn_impl="flash"):
    """Full-sequence self attention. x: [B, S, D].  ``attn_impl``:
    ``"pallas"`` runs the port's kernel (``kernels/flash_attention.py``),
    ``"flash"`` the blockwise plain version above."""
    cdt = x.dtype
    q, k, v = _qkv(cfg, p, x, positions, cdt)
    if attn_impl == "pallas":
        out = _fa_kernel.flash_attention(q, k, v, causal=True, window=window)
    elif attn_impl == "flash":
        out = flash_attention(q, k, v, causal=True, window=window)
    elif attn_impl == "flash_cvjp":
        raise NotImplementedError("attn_impl='flash_cvjp' (models/flash_cvjp"
                                  ".py) is not ported yet: ROADMAP Queue 1 "
                                  "item 13e")
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.q_dim)
    return out @ p["o"].to(cdt), k, v


def attn_decode(cfg, p, x, cache_k, cache_v, pos, *, window=0):
    """x: [B, 1, D]; caches [B, Smax, KH, hd].  Writes this token's k and v
    into the caches IN PLACE at ``pos`` (the reference returns updated
    copies through ``dynamic_update_slice``) and returns (out, cache_k,
    cache_v)."""
    cdt = x.dtype
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions, cdt)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    out = decode_attention(q, cache_k, cache_v, pos, window=window)
    B = x.shape[0]
    out = out.reshape(B, 1, cfg.q_dim)
    return out @ p["o"].to(cdt), cache_k, cache_v
