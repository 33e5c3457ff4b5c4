"""Flash attention with a STREAMING backward (port of
``repro.models.flash_cvjp``).

Plain autograd of blockwise attention saves every per-block probability
tensor, O(S^2) of them.  The streaming backward instead recomputes the
scores block by block from (q, k, v, out, lse):

  D_i  = rowsum(dO_i * O_i)
  p_ij = exp(q_i k_j^T * sc - lse_i)            (recomputed, masked)
  dv_j = sum_i p_ij^T dO_i
  ds   = p_ij * (dP_ij - D_i) * sc,   dP_ij = dO_i v_j^T
  dq_i = sum_j ds k_j ;  dk_j = sum_i ds^T q_i

so what autograd keeps is O(S·D).  This is the attention kernel wrapper's
``torch.autograd.Function`` (``kernels/flash_attention.py``): on CUDA
tensors the forward kernel writes lse and ``csrc/flash_attention_bwd.cu``
is the backward; on CPU tensors the plain forward with its lse and
``flash_attention_bwd_plain``, the port of ``_bwd_impl``.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def flash_attention_cvjp(q, k, v, *, causal=True, window=0, q_offset=None,
                         q_block=512, kv_block=1024):
    """Drop-in replacement for ``layers.flash_attention`` with the
    streaming backward.  q: [B, Sq, H, D]; k, v: [B, Sk, KH, D].  q sits at
    q_offset = Sk - Sq (the default, and the only offset taken);
    ``q_block`` / ``kv_block`` are taken for parity with the reference's
    signature, the kernels and the plain backward tile by their own
    blocks."""
    del q_block, kv_block
    if not causal:
        raise ValueError("streaming backward currently assumes causal "
                         "masking")
    Sq, Sk = q.shape[1], k.shape[1]
    if q_offset is not None and q_offset != Sk - Sq:
        raise ValueError(f"flash_attention_cvjp: q sits at Sk - Sq = "
                         f"{Sk - Sq}, got q_offset {q_offset}")
    return _fa.flash_attention(q, k, v, causal=True, window=int(window))
