"""flash_attention — causal / sliding-window GQA attention forward
(``csrc/flash_attention_tc.cu`` for bf16, ``csrc/flash_attention.cu`` for
fp32) and its backward (``csrc/flash_attention_bwd.cu``).

Port of ``repro.kernels.flash_attention``: online softmax over key tiles,
fp32 accumulators, output in q's dtype.  q: [B, Sq, H, D]; k, v:
[B, Sk, KH, D] with H = KH * G; query row i sits at position
(Sk - Sq) + i.  ``window`` is a plain int (0 = global).

``flash_attention_plain`` is the port of the reference's dense oracle
(``repro/kernels/ref.py::flash_attention``); CPU tensors take it.  On CUDA
tensors the wrapper launches a kernel chosen by dtype, with D in
``HEAD_DIMS``, or raises: bf16 runs on the tensor cores (``wgmma`` fed by
TMA, softmax in base 2), fp32 on SIMT FMAs (TF32 would lose digits).

Where autograd needs it (grad enabled and an input requiring grad), the
wrapper is a ``torch.autograd.Function``: the forward also writes each
row's log-sum-exp (float32 [B, Sq, H]) and saves (q, k, v, out, lse); the
backward is ``flash_attention_bwd``, the streaming VJP of
``repro.models.flash_cvjp._bwd_impl`` (the reference's gradient is XLA
code, so this kernel has no Pallas counterpart).  Its plain version
``flash_attention_bwd_plain`` is the port of ``_bwd_impl`` itself.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.common import ABI, check_launch, load_library, \
    stream_handle

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# head dims the kernels are instantiated for (every reduced config: 16,
# musicgen: 64, phi3: 96, qwen3: 128, gemma3: 256)
HEAD_DIMS = (16, 64, 96, 128, 256)
# (q rows of one CTA, keys of one kv tile) by dtype and head dim: the SIMT
# kernel's (FA_BQ, FA_BK) and the tensor-core kernel's (TC_BQ, tc_bk(D)),
# checked against csrc/abi.cuh when the library loads
KERNEL_TILES = {
    torch.float32: {d: (ABI["fa_bq"], ABI["fa_bk"]) for d in HEAD_DIMS},
    torch.bfloat16: {d: (ABI["fa_tc_bq"], ABI["fa_tc_bk"] if d <= 128
                         else ABI["fa_tc_bk_wide"]) for d in HEAD_DIMS},
}


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 256,
                    bk: int = 256) -> torch.Tensor:
    """Attention forward, [B, Sq, H, D] out.  ``bq`` / ``bk`` are taken for
    parity with the reference's signature; the kernels tile by
    ``KERNEL_TILES``.  CPU tensors take the plain version.  Differentiable:
    under autograd the backward is ``flash_attention_bwd``."""
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
    """(out, lse or None): the plain version on CPU tensors, a kernel on
    CUDA tensors (writing lse only if ``want_lse``)."""
    if q.device.type == "cpu":
        if want_lse:
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal,
                                     window=window), None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
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
        if want_lse else None
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
    and the output's gradient.  CPU tensors take the plain version; CUDA
    tensors ``csrc/flash_attention_bwd.cu`` (both passes, one launch
    count), which reads contiguous copies."""
    _check_shapes(q, k, v)
    window = int(window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
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
    q, k, v, out, dout, lse = (t.contiguous()
                               for t in (q, k, v, out, dout, lse))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dl = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = load_library().rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dl.data_ptr(), B, Sq, Sk, H, KH, D,
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
        int(bool(causal)), window, stream_handle(q.device))
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

