"""flash_attention — causal / sliding-window GQA attention forward
(``csrc/flash_attention_tc.cu`` for bf16, ``csrc/flash_attention.cu`` for
fp32) and its backward (``csrc/flash_attention_bwd_tc.cu`` for bf16,
``csrc/flash_attention_bwd.cu`` for fp32).

Port of ``repro.kernels.flash_attention``: online softmax over key tiles,
fp32 accumulators, output in q's dtype.  q: [B, Sq, H, D]; k, v:
[B, Sk, KH, D] with H = KH * G; query row i sits at position
(Sk - Sq) + i.  ``window`` is a plain int (0 = global).

``flash_attention_plain`` is the port of the reference's dense oracle
(``repro/kernels/ref.py::flash_attention``); CPU tensors take it.  On CUDA
tensors the wrapper launches a kernel chosen by dtype, with D in
``HEAD_DIMS``, or raises: bf16 runs on the tensor cores (``wgmma`` fed by
TMA, softmax in base 2), fp32 on the tensor cores too, in split TF32
(``csrc/split_tf32.cuh``: each fp32 operand as a sum of two TF32 values,
three ``mma.sync`` products per fp32 product, an fp32 FMA loop's accuracy;
plain TF32 would lose digits).

Where autograd needs it (grad enabled and an input requiring grad), the
wrapper is a ``torch.autograd.Function``: the forward also writes each
row's log-sum-exp (float32 [B, Sq, H]) and saves (q, k, v, out, lse); the
backward is ``flash_attention_bwd``, the streaming VJP of
``repro.models.flash_cvjp._bwd_impl`` (the reference's gradient is XLA
code, so these kernels have no Pallas counterpart).  bf16 runs it on the
tensor cores (``wgmma`` fed by TMA, two passes with one writer per output
element), fp32 in split TF32 (the same two passes, then a sum of the q
heads' shares of dk / dv where G > 1).  Its plain version
``flash_attention_bwd_plain`` is the port of ``_bwd_impl`` itself.

Both directions are custom ops of the dispatcher
(``torch.ops.repro_torch.flash_attention_fwd`` / ``flash_attention_bwd``,
``common.define_op``): the CPU kernel of each is its plain version, the
CUDA kernel the launch, a fake kernel gives the outputs' shapes and dtypes
(so ``FakeTensorMode`` traces a step through them without touching a
pointer), and a flop formula (``torch.utils.flop_counter``) charges
``attention_flops``: 4 D per visible (query, key) pair forward, 10 D
backward.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels.common import ABI, check_launch, define_op, \
    load_library, refuse_dtensor, stream_handle

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# head dims the kernels are instantiated for (every reduced config: 16,
# musicgen: 64, phi3: 96, qwen3: 128, gemma3: 256)
HEAD_DIMS = (16, 64, 96, 128, 256)
# (q rows of one CTA, keys of one kv tile) by dtype and head dim: the fp32
# kernel's (FA_BQ, FA_BK) and the bf16 kernel's (TC_BQ, tc_bk(D)),
# checked against csrc/abi.cuh when the library loads
KERNEL_TILES = {
    torch.float32: {d: (ABI["fa_bq"], ABI["fa_bk"]) for d in HEAD_DIMS},
    torch.bfloat16: {d: (ABI["fa_tc_bq"], ABI["fa_tc_bk"] if d <= 128
                         else ABI["fa_tc_bk_wide"]) for d in HEAD_DIMS},
}
# the bf16 backward's tiles by head dim (csrc/flash_attention_bwd_tc.cu),
# checked against csrc/abi.cuh when the library loads: pass 1 (dq) takes
# "bq" q rows per CTA (two warpgroups of 64 rows) over tiles of "bk" keys;
# pass 2 (dk, dv) takes "bkv" keys per CTA (both warpgroups on them) over
# tiles of "bq2" q rows
BWD_KERNEL_TILES = {
    d: {"bq": ABI["fa_bwd_bq"],
        "bk": ABI["fa_bwd_bk"] if d <= 128 else ABI["fa_bwd_bk_wide"],
        "bkv": ABI["fa_bwd_bkv"], "bq2": ABI["fa_bwd_bq2"]}
    for d in HEAD_DIMS}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 accumulation, or the input's own type where it is wider."""
    return torch.promote_types(dtype, torch.float32)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[2] < 1 \
            or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"fold onto k/v {tuple(k.shape)}")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          return_lse: bool = False):
    """Dense attention with the kernel's masks (``ref.py::flash_attention``):
    scores and P.V accumulate in fp32, P is rounded to v's dtype.
    ``return_lse``: also each row's log-sum-exp of the scaled, masked
    scores, [B, Sq, H] in the accumulation dtype, as ``_fwd_impl``'s."""
    _check_shapes(q, k, v)
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    acc = _acc_dtype(q.dtype)
    qf = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf.to(acc), k.to(acc)) \
        / math.sqrt(D)
    s = torch.where(_mask(Sq, Sk, causal, window, q.device), s,
                    torch.tensor(NEG_INF, dtype=acc, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).to(acc), v.to(acc))
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2).reshape(B, Sq, H)
    return out, lse


def _mask(Sq, Sk, causal, window, device, q_offset=None):
    """[Sq, Sk] visibility: causal q_pos >= k_pos with q_pos = q_offset + i
    (default Sk - Sq), window q_pos - k_pos < window."""
    q_pos = (Sk - Sq if q_offset is None else q_offset) + torch.arange(
        Sq, device=device)
    k_pos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs ``_mask`` lets through, for one batch row and
    head: query i at position Sk - Sq + i sees keys [lo, hi)."""
    q_pos = Sk - Sq + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q_pos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(q_pos - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo, 0).sum())


def attention_flops(B, Sq, Sk, H, D, *, causal, window):
    """Operations of one attention forward on these masks: 4 D for each
    visible (query, key) pair (q.k and p.v), for every batch row and q
    head.  The backward does 2.5 times as many (q.k and p.v again, then
    dO.v, dS.k and dS.q, p^T dO: 10 D a pair)."""
    return 4 * D * visible_pairs(Sq, Sk, causal, window) * B * H


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 256,
                    bk: int = 256) -> torch.Tensor:
    """Attention forward, [B, Sq, H, D] out.  ``bq`` / ``bk`` are taken for
    parity with the reference's signature; the kernels tile by
    ``KERNEL_TILES``.  CPU tensors take the plain version.  Differentiable:
    under autograd the backward is ``flash_attention_bwd``."""
    refuse_dtensor("flash_attention", q, k, v)
    del bq, bk
    _check_shapes(q, k, v)
    window = int(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, bool(causal), window)
    return _forward(q, k, v, causal, window, False)[0]


class _Attention(torch.autograd.Function):
    """The forward with its log-sum-exp saved; the streaming backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def _forward(q, k, v, causal: bool, window: int, want_lse: bool):
    """(out, lse or None) through the custom op
    ``torch.ops.repro_torch.flash_attention_fwd``: the plain version on
    CPU tensors, a kernel on CUDA tensors (writing lse only if
    ``want_lse``)."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out, lse = _fwd_op(q, k, v, bool(causal), int(window), bool(want_lse))
    return out, (lse if want_lse else None)


def _no_lse(q):
    """The op's second output when lse is not asked for: empty."""
    return torch.empty((0,), dtype=torch.float32, device=q.device)


def _fwd_cpu(q, k, v, causal, window, want_lse):
    """CPU: the plain version."""
    if want_lse:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    return flash_attention_plain(q, k, v, causal=causal,
                                 window=window), _no_lse(q)


def _fwd_cuda(q, k, v, causal, window, want_lse):
    """CUDA: the wgmma kernel for bf16, the split-TF32 one for fp32."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    _check_cuda(q, k, v)
    vec = 16 // q.element_size()           # elements of one 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(t.stride(i) % vec for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"head dim, 16-byte alignment and strides in "
                             f"whole 16-byte units, got strides "
                             f"{t.stride()}")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device) \
        if want_lse else _no_lse(q)
    strides = _strides(q, k, v, out)
    lib = load_library()
    if q.dtype == torch.bfloat16:
        launch, scale = lib.rt_flash_attention_tc, LOG2E / math.sqrt(D)
    else:
        launch, scale = lib.rt_flash_attention, 1.0 / math.sqrt(D)
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if want_lse else None, B, Sq, Sk, H, KH, D,
                strides, scale, int(bool(causal)), window,
                stream_handle(q.device))
    check_launch(rc, "flash_attention")
    return out, lse


def _fwd_fake(q, k, v, causal, window, want_lse):
    B, Sq, H, _ = q.shape
    out = q.new_empty(q.shape)
    if not want_lse:
        return out, _no_lse(q)
    return out, q.new_empty((B, Sq, H), dtype=_acc_dtype(q.dtype))


def _fwd_flops(q_shape, k_shape, v_shape, causal, window, want_lse, *args,
               out_shape=None, **kwargs) -> int:
    B, Sq, H, D = q_shape
    return attention_flops(B, Sq, k_shape[1], H, D, causal=causal,
                           window=window)


_fwd_op = define_op(
    "flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
    "int window, bool want_lse) -> (Tensor, Tensor)",
    cpu=_fwd_cpu, cuda=_fwd_cuda, fake=_fwd_fake, flops=_fwd_flops)


def _check_cuda(q, *others):
    """What every attention kernel takes: D in HEAD_DIMS, one dtype of
    KERNEL_TILES, every tensor on the current CUDA device, none empty."""
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in KERNEL_TILES or any(t.dtype != q.dtype
                                          for t in others):
        raise TypeError(f"flash_attention: tensors must all be float32 or "
                        f"all bfloat16, got "
                        f"{[str(t.dtype) for t in (q, *others)]}")
    if q.device.index != torch.cuda.current_device() or \
            any(t.device != q.device for t in others):
        raise ValueError(f"flash_attention: tensors on "
                         f"{[str(t.device) for t in (q, *others)]}, current "
                         f"device cuda:{torch.cuda.current_device()}")
    if any(t.numel() == 0 for t in (q, *others)):
        raise ValueError(f"flash_attention: empty operand among "
                         f"{[tuple(t.shape) for t in (q, *others)]}")


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=0, q_offset=None, q_block=512,
                              kv_block=1024):
    """(dq, dk, dv) of attention, streamed block by block from (q, k, v,
    out, lse): the port of ``flash_cvjp._bwd_impl``.

    D = rowsum(dO * O); per (q block, kv block) p = exp(s - lse) on the
    masked scaled scores, dp = dO v^T, ds = p (dp - D) scale; dq += ds k,
    dv += p^T dO, dk += ds^T q, with p rounded to dO's dtype before dv and
    ds to k's (q's) dtype before dq (dk), every sum in float32 (or the
    inputs' wider type).  dq sums its kv blocks and dk / dv their q blocks
    in order, as the reference's two scans do; ragged blocks are sliced
    where the reference pads (its padded rows and keys add zeros)."""
    _check_shapes(q, k, v)
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    if q_offset is None:
        q_offset = Sk - Sq
    acc = _acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(D)
    qb, kb = min(q_block, Sq), min(kv_block, Sk)
    q5 = q.reshape(B, Sq, KH, G, D)
    do5 = dout.reshape(B, Sq, KH, G, D)
    dl = torch.einsum("bqhgd,bqhgd->bqhg", do5.to(acc),
                      out.reshape(B, Sq, KH, G, D).to(acc))
    lse4 = lse.reshape(B, Sq, KH, G).to(acc)
    dq = torch.zeros((B, Sq, KH, G, D), dtype=acc, device=q.device)
    dk = torch.zeros((B, Sk, KH, D), dtype=acc, device=q.device)
    dv = torch.zeros((B, Sk, KH, D), dtype=acc, device=q.device)
    neg = torch.tensor(NEG_INF, dtype=acc, device=q.device)
    visible = _mask(Sq, Sk, causal, window, q.device, q_offset)
    for q0 in range(0, Sq, qb):
        qs = slice(q0, min(q0 + qb, Sq))
        qi, doi = q5[:, qs].to(acc), do5[:, qs]
        lse_i = lse4[:, qs].permute(0, 2, 3, 1)[..., None]    # [B,KH,G,q,1]
        dl_i = dl[:, qs].permute(0, 2, 3, 1)[..., None]
        for k0 in range(0, Sk, kb):
            ks = slice(k0, min(k0 + kb, Sk))
            kj, vj = k[:, ks], v[:, ks]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj.to(acc)) * scale
            p = torch.exp(torch.where(visible[qs, ks], s, neg) - lse_i)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doi.to(acc), vj.to(acc))
            ds = p * (dp - dl_i) * scale
            dq[:, qs] += torch.einsum("bhgqk,bkhd->bqhgd",
                                      ds.to(k.dtype).to(acc), kj.to(acc))
            dv[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd",
                                      p.to(dout.dtype).to(acc), doi.to(acc))
            dk[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd",
                                      ds.to(q.dtype).to(acc), qi)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) in q's, k's and v's dtype from the forward's (out, lse)
    and the output's gradient, through
    ``torch.ops.repro_torch.flash_attention_bwd``.  CPU tensors take the
    plain version.  CUDA tensors: bf16 ``csrc/flash_attention_bwd_tc.cu``
    (its preprocess and both passes, one launch count), which reads the
    operands through their strides where TMA can (else a contiguous copy);
    fp32 ``csrc/flash_attention_bwd.cu`` (both passes and, where G > 1,
    the sum of the q heads' dk / dv shares; one launch count), which reads
    contiguous copies."""
    refuse_dtensor("flash_attention_bwd", q, k, v, out, lse, dout)
    _check_shapes(q, k, v)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    return _bwd_op(q, k, v, out, lse, dout, bool(causal), int(window))


def _bwd_cpu(q, k, v, out, lse, dout, causal, window):
    """CPU: the plain version."""
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                     window=window)


def _bwd_cuda(q, k, v, out, lse, dout, causal, window):
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    if tuple(out.shape) != tuple(q.shape) or \
            tuple(dout.shape) != tuple(q.shape) or \
            tuple(lse.shape) != (B, Sq, H):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    _check_cuda(q, k, v, out, dout)
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise TypeError(f"flash_attention_bwd: lse must be float32 on "
                        f"{q.device}, got {lse.dtype} on {lse.device}")
    if q.dtype == torch.bfloat16:
        return _bwd_tc(q, k, v, out, lse, dout, causal, window)
    q, k, v, out, dout, lse = (t.contiguous()
                               for t in (q, k, v, out, dout, lse))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # rowsum(dO * O) by (batch, head, row), padded to 4 floats, then where
    # G > 1 each q head's share of dk and dv, [2, B, Sk, H, D]
    scratch = torch.empty((-(-B * H * Sq // 4) * 4
                           + (2 * B * Sk * H * D if H > KH else 0),),
                          dtype=torch.float32, device=q.device)
    rc = load_library().rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr(), B, Sq, Sk, H, KH, D,
        1.0 / math.sqrt(D), int(bool(causal)), window,
        stream_handle(q.device))
    check_launch(rc, "flash_attention_bwd")
    return dq, dk, dv


def _bwd_fake(q, k, v, out, lse, dout, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _bwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    B, Sq, H, D = q_shape
    causal, window = args[-2:]
    return 5 * attention_flops(B, Sq, k_shape[1], H, D, causal=causal,
                               window=window) // 2


_bwd_op = define_op(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
    "Tensor lse, Tensor dout, bool causal, int window) -> "
    "(Tensor, Tensor, Tensor)",
    cpu=_bwd_cpu, cuda=_bwd_cuda, fake=_bwd_fake, flops=_bwd_flops)


def _tma_operand(t):
    """``t`` where TMA and 16-byte loads can read it in place (contiguous
    head dim, 16-byte aligned, every stride of a dim longer than 1 a
    positive whole number of 16 bytes), else a contiguous copy (autograd
    may hand over an expanded gradient, with zero strides)."""
    vec = 16 // t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
            t.stride(i) > 0 and t.stride(i) % vec == 0
            for i in range(3) if t.shape[i] > 1):
        return t
    return t.contiguous()


def _bwd_tc(q, k, v, out, lse, dout, causal: bool, window: int):
    """The bf16 backward on the tensor cores: one launch of
    ``rt_flash_attention_bwd_tc`` (preprocess, pass 1, pass 2)."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    q, k, v, out, dout = (_tma_operand(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    # rowsum(dO * O) and lse * log2(e) by (batch, head, row), rows padded
    # to a multiple of the pass-1 tile with zeros
    sqp = -(-Sq // BWD_KERNEL_TILES[D]["bq"]) * BWD_KERNEL_TILES[D]["bq"]
    scratch = torch.empty((2, B, H, sqp), dtype=torch.float32,
                          device=q.device)
    rc = load_library().rt_flash_attention_bwd_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr(),
        _strides(q, k, v, out, dout, dq, dk, dv), B, Sq, Sk, H, KH, D, sqp,
        1.0 / math.sqrt(D), LOG2E / math.sqrt(D), int(bool(causal)), window,
        stream_handle(q.device))
    check_launch(rc, "flash_attention_bwd")
    return dq, dk, dv


def _strides(*tensors):
    """(batch, seq, head) strides of each [B, S, H, D] tensor, in elements."""
    return (ctypes.c_longlong * (3 * len(tensors)))(*(
        s for t in tensors for s in t.stride()[:3]))


def tensor_map_encode_ns(q, k, v, iters: int = 1000) -> int:
    """Host ns to encode the three TMA tensor maps of one bf16 launch on
    these CUDA tensors (mean over ``iters``; nothing is launched)."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    ns = load_library().rt_flash_attention_tc_encode_ns(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, Sk, H, KH, D,
        _strides(q, k, v), iters)
    if ns < 0:
        raise RuntimeError("flash_attention: cuTensorMapEncodeTiled failed")
    return ns

