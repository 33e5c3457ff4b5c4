"""Model-zoo building blocks: ``repro.models.layers``.

Everything takes explicit param dicts (``models/zoo.py`` templates) and
keeps the reference's numerics, so that bf16 runs round where it rounds:

* ``rms_norm`` takes the mean of squares in float32 and multiplies in x's
  dtype;
* ``rope`` builds its angle table in float32 and rotates in x's dtype;
* attention scores and P.V accumulate in float32 (the reference's
  ``preferred_element_type``), and P is rounded to v's dtype before P.V.

"Float32" here means float32 or the input's own type where that is wider,
so a float64 run is a float64 evaluation of the same function.

Where the reference asks a product of bf16 operands for a float32 result
(``preferred_element_type``), the port upcasts the operands: a bf16 x bf16
product is exact in float32.  The SSD scan's inter-chunk recurrence runs
through ``kernels/ssd_scan.py`` (the CUDA kernel on CUDA tensors).

Everything here is differentiable: the attention kernel and ``ssd_scan``
are ``torch.autograd.Function``s with backward kernels, and nothing that
autograd saves is written in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa_kernel
from repro_torch.kernels.ssd_scan import ssd_scan

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


def mlp(p, x, mlp_type="swiglu", cdt=torch.bfloat16, ws=None, reduce=True):
    """The MLP of ``x``.  ``ws``: the decode step's weight-stationary
    hooks (``distributed/tensor_parallel.Stationary``, bound to the MLP):
    ``x`` is every row of the rank's block of ``d_model`` and ``p`` the
    rank's blocks; the hidden units are the rank's block of them, of
    every row, and the output every row of the rank's block of
    ``d_model`` (without ``reduce``, where ``wo``'s rows split over
    "model", the rank's partial output)."""
    act = _act(mlp_type)
    gated = mlp_type in ("swiglu", "geglu")
    if ws is not None:
        hs = ws.col(x, p, ("wg", "wi") if gated else ("wi",), rows=False,
                    whole=False)
        h = act(hs[0]) * hs[1] if gated else act(hs[0])
        return ws.row(h, p, "wo", rows=False, reduce=reduce)
    if gated:
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


def decode_attention(q, k_cache, v_cache, pos, *, window=0, offset=0,
                     with_lse=False):
    """Single-token attention against a cache.

    q: [B, 1, H, D]; caches: [B, Smax, KH, D] holding positions
    ``offset`` .. ``offset`` + Smax - 1 (a block of a cache split by
    sequence); pos: current position.  With ``with_lse`` returns (out
    [B, 1, H, D] in the accumulation dtype, the scores' log-sum-exp
    [B, 1, H]) for a merge of blocks with weights exp(lse): a block with
    every position masked gives an lse of about NEG_INF (its weight 0) and
    finite values."""
    B, _, H, D = q.shape
    _, Smax, KH, _ = k_cache.shape
    G = H // KH
    acc_t = _acc(q.dtype)
    qi = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qi.to(acc_t), k_cache.to(acc_t)) \
        / math.sqrt(D)
    k_pos = torch.arange(offset, offset + Smax, device=q.device)
    mask = k_pos <= pos
    if window > 0:
        mask = mask & ((pos - k_pos) < window)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=acc_t,
                                          device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).to(acc_t),
                       v_cache.to(acc_t)).reshape(B, 1, H, D)
    if with_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, 1, H)
    return out.to(q.dtype)


def _decode_attend(q, k, v, pos, *, window=0, offset=0, merge=None):
    """``decode_attention`` over a whole cache, or with ``merge`` over one
    rank's block of a cache split by sequence from position ``offset``,
    the ranks' parts combined by ``merge(out, lse)``."""
    if merge is None:
        return decode_attention(q, k, v, pos, window=window)
    return merge(*decode_attention(q, k, v, pos, window=window,
                                   offset=offset, with_lse=True)).to(q.dtype)


# ---------------------------------------------------------------------------
# attention layer (prefill / decode)
# ---------------------------------------------------------------------------

def _qkv(cfg, p, x, positions, cdt, ws=None):
    """q, k and v of ``x``, normed and rotated; with ``ws`` (the decode
    step's hooks, ``attn_decode``) of the rank's rows."""
    if ws is None:
        q, k, v = (x @ p[n].to(cdt) for n in ("q", "k", "v"))
    else:
        q, k, v = ws.col(x, p, ("q", "k", "v"), rows=True)
    B = q.shape[0]
    q = q.reshape(B, -1, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, -1, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, -1, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(cfg, p, x, positions, *, window=0, attn_impl="flash"):
    """Full-sequence self attention. x: [B, S, D].  ``attn_impl``:
    ``"pallas"`` runs the port's kernel (``kernels/flash_attention.py``),
    ``"flash"`` the blockwise plain version above, ``"flash_cvjp"`` the
    streaming-backward attention (``models/flash_cvjp.py``: the kernels on
    CUDA tensors)."""
    cdt = x.dtype
    q, k, v = _qkv(cfg, p, x, positions, cdt)
    if attn_impl == "pallas":
        out = _fa_kernel.flash_attention(q, k, v, causal=True, window=window)
    elif attn_impl == "flash":
        out = flash_attention(q, k, v, causal=True, window=window)
    elif attn_impl == "flash_cvjp":
        from repro_torch.models.flash_cvjp import flash_attention_cvjp
        out = flash_attention_cvjp(q, k, v, causal=True, window=window)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.q_dim)
    return out @ p["o"].to(cdt), k, v


def attn_decode(cfg, p, x, cache_k, cache_v, pos, *, window=0, offset=0,
                merge=None, ws=None):
    """x: [B, 1, D]; caches [B, Smax, KH, hd].  Writes this token's k and v
    into the caches IN PLACE at ``pos`` (the reference returns updated
    copies through ``dynamic_update_slice``) and returns (out, cache_k,
    cache_v).  With ``merge`` the caches are one rank's block of a cache
    split by sequence, from position ``offset``: the token's k and v are
    written only where ``pos`` falls in the block, and ``merge(out, lse)``
    combines the block's attention with the other ranks'
    (``_decode_attend``).  ``ws``: the sharded decode step's
    weight-stationary hooks (``distributed/tensor_parallel.Stationary``,
    bound to the attention): ``x`` is every row of the rank's block of
    ``d_model``, q, k and v the rank's rows (its heads where ``cfg`` holds
    the rank's head counts), the caches the rank's rows, and the output
    every row of the rank's block of ``d_model``."""
    cdt = x.dtype
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions, cdt, ws)
    at = pos - offset
    if merge is None or 0 <= at < cache_k.shape[1]:
        cache_k[:, at] = k[:, 0].to(cache_k.dtype)
        cache_v[:, at] = v[:, 0].to(cache_v.dtype)
    out = _decode_attend(q, cache_k, cache_v, pos, window=window,
                         offset=offset, merge=merge)
    out = out.reshape(q.shape[0], 1, cfg.q_dim)
    if ws is not None:
        return ws.row(out, p, "o", rows=True), cache_k, cache_v
    return out @ p["o"].to(cdt), cache_k, cache_v


def cross_attn_forward(cfg, p, x, kv_src):
    """Cross attention to precomputed patch embeddings.  x: [B, S, D];
    kv_src: [B, T, D] -> (out, k, v).  As in the reference, it runs the
    blockwise plain attention with full visibility (the reference's
    ``attn_impl`` argument here is unused)."""
    cdt = x.dtype
    B, S = x.shape[:2]
    T = kv_src.shape[1]
    q = (x @ p["q"].to(cdt)).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (kv_src @ p["k"].to(cdt)).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = (kv_src @ p["v"].to(cdt)).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    out = flash_attention(q, k, v, causal=False, q_offset=0)
    out = out.reshape(B, S, cfg.q_dim)
    return out @ p["o"].to(cdt), k, v


def cross_attn_decode(cfg, p, x, k, v, *, offset=0, merge=None, ws=None):
    """One token's cross attention to the cached patch keys and values
    (every patch visible).  x: [B, 1, D]; k, v: [B, T, KH, hd]; with
    ``merge``, one rank's block of them from patch ``offset``; ``ws`` as
    in ``attn_decode`` (``attn_decode``)."""
    cdt = x.dtype
    q = x @ p["q"].to(cdt) if ws is None else \
        ws.col(x, p, ("q",), rows=True)[0]
    B = q.shape[0]
    q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim)
    out = _decode_attend(q, k, v, offset + k.shape[1] - 1, offset=offset,
                         merge=merge)
    out = out.reshape(B, 1, cfg.q_dim)
    if ws is not None:
        return ws.row(out, p, "o", rows=True)
    return out @ p["o"].to(cdt)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def _top_k(gates, k):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first on ties (a stable sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(cfg, p, x, *, capacity_factor=1.25, group_tokens=4096,
            rows=None, split=None, seq=None, with_aux=True, ws=None):
    """Dropping MoE.  x: [B, S, D] -> (out [B, S, D], aux loss).

    Per group of Tg tokens each expert has C slots, taken by the (token,
    slot) pairs in (t, k) order; the rest are dropped.  The reference
    dispatches and combines through one-hot [G, Tg, E, C] einsums; the
    port computes the same queue positions and moves rows by index: each
    kept pair copies its token's row into its expert's slot (the one-hot
    product selects exactly), the experts run as one batched product over
    their G·C rows, and each token sums its K gated expert rows in float32
    and rounds once, as the einsum's accumulation does.  Nothing here waits
    on the device: the dropped pairs write a scratch row and read a zero
    gate instead of being filtered out.  Without ``with_aux`` the aux loss
    is not computed (0.0).

    ``rows``: under a sharded step, x is one rank's rows of a batch whose
    rows split over ``rows.n`` ranks (``launch/steps.py``), and the groups
    are the whole batch's.  Where a group holds other ranks' tokens, the
    queue positions count their choices too (``rows.whole`` gathers every
    rank's top-k experts); the rank computes its own tokens' rows.  The
    aux loss is the whole batch's, as the unsharded step's: the expert
    counts and the gates' sums are summed over the ranks (``rows.psum``,
    whose backward sums the gradient too).

    ``split``: the rank's ``ModelSplit``.  Where its ``experts`` block is
    set (the specs shard the experts over "model"), every rank of "model"
    routes every token as above (the same choices, queue positions,
    capacity and kept pairs), copies only the rows of its own experts'
    slots, runs its E/m experts and combines its gated rows into a
    float32 partial output; where ``shared`` is set the shared experts run
    the rank's hidden units into a partial output too.  The partial
    outputs are summed over "model" in one all-reduce, in float32 before
    the one cast; the input's and the gates' gradients, partial on each
    rank, are all-reduced over "model" (``ModelSplit.into``,
    ``complete``).

    ``seq``: under a sequence split (``tensor_parallel.SeqParallel``) x
    is the rank's block [B, S/m, D] of its rows' sequences.  The router
    runs on the rank's tokens and their gates are all-gathered
    (``seq.share``: every rank routes every token as above, and keeps its
    tokens' part of the gates' gradient, which is whole on every rank);
    the experts' input is the whole sequence (``seq.gather``); the split
    parts' partial outputs are reduce-scattered into the rank's block
    (``split.out``), and parts the rank computes whole for every token
    keep the rank's block; unsplit shared experts run on the rank's
    tokens.  The aux loss is the whole batch's.

    ``ws``: the sharded decode step's weight-stationary hooks
    (``distributed/tensor_parallel.Stationary``, bound to the layer): x is
    every row of the batch and the rank's block of ``d_model``, so every
    rank routes the whole batch as the unsharded step does (no ``rows``).
    The router's and the experts' ``wi`` / ``wg`` partial sums over the
    data axes are all-reduced in float32 (the router's logits stay
    float32, the experts' hidden units rounded once), ``wo`` gives the
    rank's block of ``d_model`` whole; the rank's experts' combined rows
    and its shared experts' partial output are summed over "model" in one
    float32 all-reduce, rounded once."""
    cdt = x.dtype
    acc = _acc(cdt)
    dev = x.device
    D = x.shape[-1]
    E, K = cfg.n_experts, cfg.top_k
    e0, El = (0, E) if split is None or split.experts is None \
        else split.experts
    shared_split = bool(cfg.n_shared_experts) and split is not None \
        and split.shared is not None

    own = x                              # the tokens the output is of
    if ws is None:
        logits = x.reshape(-1, D).to(acc) @ p["router"].to(acc)
    else:
        logits, = ws.col(x.reshape(-1, D), p, ("router",), rows=False,
                         whole=False, dtype=acc)
    gates = torch.softmax(logits, dim=-1)
    if seq is not None:
        # every token of the rank's rows: their gates, and the experts'
        # input, whose gradient is reduce-scattered into the block
        gates = seq.share(gates.reshape(*x.shape[:2], E)).reshape(-1, E)
        x = xi = seq.gather(x)
    else:
        # the input of the rank's parts of split experts, its gradient
        # summed over "model"
        xi = split.into(x) if (El < E or shared_split) and ws is None \
            else x
    B, S, _ = x.shape
    T = B * S                                                 # [T, E] gates
    top_g, top_i = _top_k(gates, K)                           # [T, K]
    top_g = top_g / torch.clamp_min(top_g.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (switch-style) over the whole batch
    n = 1 if rows is None else rows.n
    aux = 0.0
    if with_aux:
        counts = torch.zeros(E, dtype=acc, device=dev).index_add_(
            0, top_i[:, 0], torch.ones(T, dtype=acc, device=dev))
        if n == 1:
            density, mean = counts / T, gates.mean(0)
        else:
            both = rows.psum(torch.cat([counts, gates.sum(0)])) / (T * n)
            density, mean = both[:E], both[E:]
        aux = E * torch.sum(density * mean)

    # group tokens as the reference does, failing where it fails
    T_all = T * n
    g_tok = min(group_tokens, T_all)
    G = max(T_all // g_tok, 1)
    Tg = T_all // G
    if G * Tg != T_all:
        raise ValueError(f"moe_ffn: {T_all} tokens are not {G} groups of "
                         f"{Tg} (group_tokens {group_tokens})")
    C = min(max(int(math.ceil(Tg * K / E * capacity_factor)), K), Tg)

    # each (t, k)'s place in its expert's queue: the earlier pairs of its
    # group, in (t, k) order, that chose the same expert (the one-hot is
    # [groups, E, Tg·K], so the count runs along the contiguous axis);
    # ``lo``: the rank's first token among the tokens counted
    idx, lo = top_i, 0
    if T % Tg:
        idx, lo = rows.whole(top_i), rows.index * T
    idx = idx.reshape(-1, Tg * K)
    sel = torch.zeros((idx.shape[0], E, Tg * K), dtype=torch.int32,
                      device=dev).scatter_(1, idx[:, None, :], 1)
    pos = (sel.cumsum(2) - sel).gather(1, idx[:, None, :])[:, 0]
    del sel
    pos = pos.reshape(-1)[lo * K:(lo + T) * K].reshape(T, K)
    # the kept pairs of the rank's experts
    keep = ((pos < C) & (top_i >= e0) & (top_i < e0 + El)).reshape(T * K)
    # expert-major slots of the Gr groups the rank's tokens fall in, row
    # (e, g, c) of [El, Gr·C, D] for the rank's e-th expert; row El·Gr·C
    # is the other pairs' scratch row
    g0 = lo // Tg
    Gr = (lo + T - 1) // Tg - g0 + 1
    n_slots = El * Gr * C
    grp = ((lo + torch.arange(T, device=dev)) // Tg - g0)[:, None]
    slot = torch.where(
        keep, (((top_i - e0) * Gr + grp) * C + pos).reshape(T * K), n_slots)
    xe = x.new_zeros((n_slots + 1, D))
    xe[slot] = (xi if El < E else x).reshape(T, D).repeat_interleave(
        K, dim=0)

    act = _act(cfg.mlp_type)
    xe = xe[:n_slots].reshape(El, Gr * C, D)
    if ws is None:
        h = act(torch.bmm(xe, p["wg"].to(cdt))) * torch.bmm(
            xe, p["wi"].to(cdt))
    else:
        g, i = ws.col(xe, p, ("wg", "wi"), rows=False, whole=False)
        h = act(g) * i
    ye = torch.bmm(h, p["wo"].to(cdt)).reshape(n_slots, D)

    top_g = split.complete(top_g) if El < E else top_g
    gate = torch.where(keep, top_g.to(cdt).to(acc).reshape(T * K), 0.0)
    out = ye[slot.clamp(max=n_slots - 1)].to(acc) * gate[:, None]
    out = out.reshape(T, K, D).sum(1)                 # float32 [T, D]

    out = out.reshape(B, S, D)
    shared = None
    if cfg.n_shared_experts:
        shared = mlp(p["shared"], xi if shared_split else own, cfg.mlp_type,
                     cdt, ws=None if ws is None else ws.sub("shared"),
                     reduce=False)
    total = ws.model_sum if ws is not None else \
        None if split is None else split.out
    if shared_split and El < E:
        out, shared = total(out + shared.to(acc)), None
    elif El < E:
        out = total(out)
    else:
        if shared_split:
            shared = total(shared)
        if seq is not None:
            out = seq.keep(out)
    out = out.to(cdt)
    if shared is not None:
        out = out + shared.to(cdt)
    return out, aux


# ---------------------------------------------------------------------------
# mamba2 (SSD)
# ---------------------------------------------------------------------------

def _segsum(a):
    """a: [..., q] -> [..., q, q], out[i, j] = sum_{k=j+1..i} a_k for i >= j
    and NEG_INF above the diagonal."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~mask, NEG_INF)


def ssd_chunked(xh, dt, a_log, Bm, Cm, chunk):
    """Chunked state-space-duality scan (mamba2).

    xh: [b, s, h, p]; dt: [b, s, h]; a_log: [h]; Bm, Cm: [b, s, n] ->
    y [b, s, h, p] in float32.  Decays in float32; the products take the
    reference's rounding of their operands to xh's dtype and accumulate in
    float32, each written as a batched product of two operands.  The
    inter-chunk recurrence is ``kernels/ssd_scan.py::ssd_scan``, the CUDA
    kernel on CUDA tensors."""
    b, s, h, pdim = xh.shape
    n = Bm.shape[-1]
    cdt = xh.dtype
    acc = _acc(cdt)
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = xh.shape[1] // chunk
    q = chunk

    def up(t):
        """t rounded to the compute dtype, held in float32."""
        return t.to(cdt).to(acc)

    xh = xh.reshape(b, nc, q, h, pdim)
    dt = dt.reshape(b, nc, q, h).to(acc)
    Bm = up(Bm.reshape(b, nc, q, n))
    Cm = up(Cm.reshape(b, nc, q, n))

    a = -torch.exp(a_log.to(acc))                             # [h] (negative)
    xdt = up(xh.to(acc) * dt[..., None])                      # [b,nc,q,h,p]
    # dt·a as [b, nc, h, q], so the cumulative sums run along a contiguous
    # axis (a scan across the outer axis is slow on the card)
    da = (dt * a).permute(0, 1, 3, 2).contiguous()
    cum = torch.cumsum(da, dim=-1).permute(0, 1, 3, 2)        # [b,nc,q,h]

    # intra-chunk (quadratic within a chunk): (C B^T * L) @ xdt per head
    # out of place: in float32 up(L) is L itself, which exp saved
    m = up(torch.exp(_segsum(da))) * torch.einsum(
        "bcqn,bckn->bcqk", Cm, Bm)[:, :, None]                # [b,nc,h,q,k]
    y = torch.einsum("bchqk,bckhp->bcqhp", m, xdt)
    del m

    # chunk-final states
    decay_states = up(torch.exp(cum[:, :, -1:, :] - cum))     # [b,nc,q,h]
    states = torch.einsum("bcqn,bcqhp->bhcpn", Bm,
                          xdt * decay_states[..., None])

    # inter-chunk recurrence: the kernel over [b·h, nc, p·n]
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # [b,nc,h]
    prev = ssd_scan(states.contiguous().reshape(b * h, nc, pdim, n),
                    chunk_decay.permute(0, 2, 1).reshape(b * h, nc))
    del states
    prev = up(prev.reshape(b, h, nc, pdim, n).permute(0, 2, 1, 3, 4))

    state_decay = up(torch.exp(cum))                          # [b,nc,q,h]
    y += torch.einsum("bcqn,bchpn->bcqhp", Cm, prev) * state_decay[..., None]
    return y.reshape(b, nc * q, h, pdim)[:, :s]


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv.  x: [B, S, C]; w: [W, C]; cache: [B, W-1, C],
    the rows before x (zeros without one).  Returns (out, the last W-1 rows
    of [cache, x])."""
    W = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, :S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    new_cache = xp[:, S:].clone() if W > 1 else None
    return out, new_cache


def rms_norm_parts(x, w, eps, psum, width):
    """``rms_norm`` of rows whose ``width`` channels split over ranks:
    ``x`` holds some of them (``w`` their weights), and the float32 sum of
    their squares is summed over the ranks by ``psum`` before the
    ``rsqrt`` (the mamba gated norm under a head split, ``ModelSplit.
    psum``; a decode step's residual stream, ``tensor_parallel.
    Stationary.norm``).  Without ``psum``, ``rms_norm``."""
    if psum is None:
        return rms_norm(x, w, eps)
    ss = x.to(_acc(x.dtype)).square().sum(-1, keepdim=True)
    inv = torch.rsqrt(psum(ss) / width + eps)
    return (x * inv.to(x.dtype)) * (1.0 + w).to(x.dtype)


def mamba_layer(cfg, p, x, *, conv_cache=None, ssm_state=None, decode=False,
                return_state=False, split=None, ws=None):
    """Mamba2 block.  x: [B, S, D] -> (y, (conv cache, state)).

    Prefill: ``return_state=True`` gives the decode caches (the state is
    None without it).  Decode: S = 1 with both caches.

    ``split``: a sharded step's ``ModelSplit``.  Where it splits the mamba
    heads over "model" (``split.heads``), the rank runs its nh/m heads:
    ``p`` holds its ``wz`` / ``wx`` columns, ``wdt`` columns and ``wo``
    rows, ``a_log`` / ``d`` / ``dt_bias`` and ``norm`` narrowed to its
    heads and channels, and ``wb``, ``wc`` and ``conv`` whole (every rank
    computes B and C for all tokens).  The conv runs on the rank's x
    channels and all B / C channels (depthwise: no channel reads
    another's), taken from the whole ``conv`` and ``conv_cache``; the
    conv cache returned and ``ssm_state`` are the rank's channels and
    heads.  The gated norm's sum of squares over all ``ssm_inner``
    channels is all-reduced over "model", as is the output
    (``split.out``); the input passes ``split.into`` (under a sequence
    split the gather of the whole sequence, the output then
    reduce-scattered into the rank's block).

    ``ws``: the sharded decode step's weight-stationary hooks
    (``distributed/tensor_parallel.Stationary``, bound to the layer; with
    ``decode``): ``p`` holds the rank's blocks as its specs give them
    (the per-head scalars and the norm whole), ``x`` every row of the
    rank's block of ``d_model``, and the caches are the rank's blocks:
    its rows, its heads' state under the head split, its block of the
    conv channels (``_stationary_inputs``)."""
    cdt = x.dtype
    acc = _acc(cdt)
    di, n, nh, ph = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    conv_w = p["conv"]
    scalars = {k: p[k] for k in ("a_log", "d", "dt_bias", "norm")}
    if split is not None and split.heads is None:
        split = None
    if ws is not None:
        z, xin, Bm, Cm, dt_raw, new_conv = _stationary_inputs(
            cfg, p, x, conv_cache, split, ws)
        if split is not None:
            nh, di = split.heads[1], split.inner[1]
            scalars = {k: t.narrow(0, *(split.inner if k == "norm"
                                        else split.heads))
                       for k, t in scalars.items()}
    elif split is not None:
        x0, di = split.inner
        nh = split.heads[1]
        x = split.into(x)

        def own(t):
            """The rank's x channels and every B / C channel (last dim)."""
            return torch.cat([t[..., x0:x0 + di], t[..., -2 * n:]], dim=-1)
        conv_w = own(conv_w)
        if conv_cache is not None:
            conv_cache = own(conv_cache)
    if ws is None:
        z = x @ p["wz"].to(cdt)                               # [B,S,di]
        xin = x @ p["wx"].to(cdt)
        Bm = x @ p["wb"].to(cdt)                              # [B,S,n]
        Cm = x @ p["wc"].to(cdt)
        dt_raw = x @ p["wdt"].to(cdt)                         # [B,S,nh]

        xbc = torch.cat([xin, Bm, Cm], dim=-1)
        xbc, new_conv = _causal_conv(xbc, conv_w.to(cdt), conv_cache)
        xin, Bm, Cm = torch.split(F.silu(xbc), [di, n, n], dim=-1)
    B, S, _ = z.shape

    dt = F.softplus(dt_raw.to(acc) + scalars["dt_bias"].to(acc))
    xh = xin.reshape(B, S, nh, ph)

    if not decode:
        y = ssd_chunked(xh, dt, scalars["a_log"], Bm, Cm, cfg.ssm_chunk)
        new_state = (_ssd_final_state(xh, dt, scalars["a_log"], Bm)
                     if return_state else None)
    else:
        a = -torch.exp(scalars["a_log"].to(acc))              # [nh]
        d0 = dt[:, 0]                                         # [B,nh]
        upd = (d0[:, :, None, None] * xh[:, 0, :, :, None].to(acc)
               * Bm[:, 0, None, None, :].to(acc))             # [B,nh,p,n]
        new_state = ssm_state * torch.exp(d0 * a)[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", new_state,
                         Cm[:, 0].to(acc))[:, None]

    y = y + xh.to(acc) * scalars["d"].to(acc)[None, None, :, None]
    y = y.reshape(B, S, di).to(cdt)
    y = rms_norm_parts(y * F.silu(z), scalars["norm"], cfg.norm_eps,
                       None if split is None else split.psum, cfg.ssm_inner)
    if ws is not None:
        return ws.row(y, p, "wo", rows=True), (new_conv, new_state)
    out = y @ p["wo"].to(cdt)
    if split is not None:
        out = split.out(out)
    return out, (new_conv, new_state)


def _stationary_inputs(cfg, p, x, conv_cache, split, ws):
    """``mamba_layer``'s z, x, B, C and dt_raw of one decode token under
    the weight-stationary hooks ``ws``, of the rank's rows (the rank's
    heads' channels of z, x and dt where ``split`` splits the heads, else
    all), and the new conv rows of the rank's block of the conv cache.
    The projections' partial sums are reduce-scattered to the rank's rows
    in one collective.  The conv weight and cache stay as their specs
    split them: where their channels split over "model" the rank
    convolves its block of the channels (no channel reads another's) and
    the results are all-gathered, so each rank takes the channels it
    runs from the whole."""
    n = cfg.ssm_state
    z, xin, Bm, Cm, dt_raw = ws.col(x, p, ("wz", "wx", "wb", "wc", "wdt"),
                                    rows=True, whole=split is None)
    if split is not None:
        xin = ws.gather_model(xin)
    xbc = torch.cat([xin, Bm, Cm], dim=-1)
    blk = ws.block("conv", 1)
    if blk is not None:
        xbc = xbc.narrow(-1, *blk)
    xbc, new_conv = _causal_conv(xbc, p["conv"].to(x.dtype), conv_cache)
    if blk is not None:
        xbc = ws.gather_model(xbc)
    if split is not None:
        x0, w = split.inner
        xbc = torch.cat([xbc[..., x0:x0 + w], xbc[..., -2 * n:]], dim=-1)
    xin, Bm, Cm = torch.split(F.silu(xbc), [xbc.shape[-1] - 2 * n, n, n],
                              dim=-1)
    return z, xin, Bm, Cm, dt_raw, new_conv


def _ssd_final_state(xh, dt, a_log, Bm):
    """The SSM state after the whole sequence (prefill -> decode).

    Each step's decay to the end is exp of the sum of the later steps' dt·a,
    taken as a suffix sum.  The reference takes it as cum[-1] - cum of one
    cumulative sum over the sequence, which loses |cum[-1]|·eps on the
    recent steps that carry the state: with random weights dt·a runs to
    several units a step, and at mamba2's widths and S = 512 the card's
    float32 state then differed from the CPU's by 2.9e-4 of its largest
    value (their cumulative sums add in different orders)."""
    acc = _acc(xh.dtype)
    a = -torch.exp(a_log.to(acc))
    dt = dt.to(acc)
    # [b, h, s] reversed, so the sum runs along a contiguous axis
    da = (dt * a).transpose(1, 2).flip(-1).contiguous()
    tail = F.pad(torch.cumsum(da[..., :-1], dim=-1).flip(-1), (0, 1))
    w = torch.exp(tail).transpose(1, 2) * dt                  # [b,s,h]
    return torch.einsum("bsn,bshp->bhpn", Bm.to(acc),
                        xh.to(acc) * w[..., None])
