"""siren_layer — fused SIREN layer y = sin(w0 * (x @ W + b)) (``csrc/matmul.cu``).

Port of ``repro.kernels.siren_layer``: the bias and the sine are applied to
the accumulator before it is written, so ``x @ W + b`` never reaches device
memory.  The CUDA path is ``stream_matmul``'s kernel with its epilogue on.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import refuse_dtensor
from repro_torch.kernels.stream_matmul import launch_matmul


def siren_layer_plain(x, w, b, *, w0: float = 30.0, apply_sin: bool = True):
    h = x @ w
    if b is not None:
        h = h + b
    if apply_sin:
        h = torch.sin(w0 * h)
    return h


def siren_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
                w0: float = 30.0, apply_sin: bool = True,
                mm_parallel: int | None = None):
    """x: [B, K], w: [K, N], b: [N] or None -> sin(w0 (x@w + b)) (or
    linear).  CPU tensors take the plain version; CUDA tensors the kernel."""
    refuse_dtensor("siren_layer", x, w, b)
    if x.device.type == "cpu":
        return siren_layer_plain(x, w, b, w0=w0, apply_sin=apply_sin)
    if x.device.type != "cuda":
        raise ValueError(f"siren_layer: unsupported device {x.device}")
    return launch_matmul("siren_layer", x, w, b, w0=w0, apply_sin=apply_sin,
                         mm_parallel=mm_parallel)
