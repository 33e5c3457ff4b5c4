"""flash_attention — causal / sliding-window GQA attention forward
(``csrc/flash_attention_tc.cu`` for bf16, ``csrc/flash_attention.cu`` for
fp32).

Port of ``repro.kernels.flash_attention``: online softmax over key tiles,
fp32 accumulators, output in q's dtype.  q: [B, Sq, H, D]; k, v:
[B, Sk, KH, D] with H = KH * G; query row i sits at position
(Sk - Sq) + i.  ``window`` is a plain int (0 = global).

``flash_attention_plain`` is the port of the reference's dense oracle
(``repro/kernels/ref.py::flash_attention``); CPU tensors take it.  On CUDA
tensors the wrapper launches a kernel chosen by dtype, with D in
``HEAD_DIMS``, or raises: bf16 runs on the tensor cores (``wgmma`` fed by
TMA, softmax in base 2), fp32 on SIMT FMAs (TF32 would lose digits).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.common import ABI, check_launch, load_library, \
    stream_handle

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# head dims the kernels are instantiated for (musicgen: 64, phi3: 96,
# qwen3: 128, gemma3: 256)
HEAD_DIMS = (64, 96, 128, 256)
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


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Dense attention with the kernel's masks (``ref.py::flash_attention``):
    scores and P.V accumulate in fp32, P is rounded to v's dtype."""
    _check_shapes(q, k, v)
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    acc = _acc_dtype(q.dtype)
    qf = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf.to(acc), k.to(acc)) \
        / math.sqrt(D)
    q_pos = (Sk - Sq) + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=acc,
                                          device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).to(acc), v.to(acc))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 256,
                    bk: int = 256) -> torch.Tensor:
    """Attention forward, [B, Sq, H, D] out.  ``bq`` / ``bk`` are taken for
    parity with the reference's signature; the kernels tile by
    ``KERNEL_TILES``.  CPU tensors take the plain version."""
    del bq, bk
    _check_shapes(q, k, v)
    window = int(window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in KERNEL_TILES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must all be float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.device.index != torch.cuda.current_device() or \
            k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q/k/v on {q.device}/{k.device}/"
                         f"{v.device}, current device "
                         f"cuda:{torch.cuda.current_device()}")
    vec = 16 // q.element_size()           # elements of one 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(t.stride(i) % vec for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"head dim, 16-byte alignment and strides in "
                             f"whole 16-byte units, got strides "
                             f"{t.stride()}")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError(f"flash_attention: empty q {tuple(q.shape)} or "
                         f"k {tuple(k.shape)}")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, out)
    lib = load_library()
    if q.dtype == torch.bfloat16:
        launch, scale = lib.rt_flash_attention_tc, LOG2E / math.sqrt(D)
    else:
        launch, scale = lib.rt_flash_attention, 1.0 / math.sqrt(D)
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                Sq, Sk, H, KH, D, strides, scale, int(bool(causal)), window,
                stream_handle(q.device))
    check_launch(rc, "flash_attention")
    return out


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

