"""TF32 products for the controls: the precision next below float32.

On a CUDA card the product runs with TF32 allowed (the card's own
rounding); on the CPU, which has no TF32, each operand is rounded to
TF32's 10 mantissa bits and the product is taken in float32 (the rounding
passes gradients straight through).  ``tf32_allowed`` also covers the
products autograd takes for a backward pass on the card.
"""

from __future__ import annotations

import contextlib

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to nearest on 10 mantissa bits."""
    i = t.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t.detach())


@contextlib.contextmanager
def tf32_allowed():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def tf32_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    a, w = a.float(), w.float()
    if a.is_cuda:
        with tf32_allowed():
            return a @ w
    return round_tf32(a) @ round_tf32(w)
