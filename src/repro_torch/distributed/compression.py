"""Gradient compression with error feedback (port of
``repro.distributed.compression``).

int8 quantization with a per-tensor scale cuts cross-pod gradient traffic
4x (f32) / 2x (bf16).  Error feedback accumulates the quantization residual
into the next step's gradient, which keeps SGD/Adam convergence (Seide et
al.; Karimireddy et al.).  ``compress_grads`` is the state-carrying function
the reference uses inside a train step; a tree is a tensor or nested dicts
of tensors.  The reference's ``compressed_psum`` is a collective over a
device mesh: it raises here until sharding is ported (ROADMAP Queue 1 item
12).
"""

from __future__ import annotations

import torch


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _quantize(x: torch.Tensor):
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor):
    return q.to(torch.float32) * scale


def init_error_feedback(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compress_grads(grads, ef_state):
    """Returns (compressed-and-restored grads, new error feedback).

    The returned grads are exactly what the OTHER hosts would see after the
    quantized all-reduce; ef' carries the residual into the next step."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = _quantize(corrected)
        restored = _dequantize(q, s)
        return restored, corrected - restored
    outs = _map(one, grads, ef_state)          # (restored, residual) leaves
    return _map(lambda o: o[0], outs), _map(lambda o: o[1], outs)


def compression_ratio(grads) -> float:
    """Bytes on the wire: int8 payload + one f32 scale per tensor."""
    leaves = _leaves(grads)
    orig = sum(g.numel() * g.element_size() for g in leaves)
    comp = sum(g.numel() * 1 + 4 for g in leaves)
    return orig / comp


def compressed_psum(x: torch.Tensor, axis_name: str):
    """An all-reduce of int8-quantized values along a mesh axis: needs a
    device mesh, which the port does not build yet."""
    raise NotImplementedError("compressed_psum needs a device mesh: "
                              "sharding is not ported yet, ROADMAP Queue 1 "
                              "item 12")
