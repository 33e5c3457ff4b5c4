"""Plain reference of an INSP-Net filter bank over a SIREN, in PyTorch.

Each head is an MLP with ReLU between its layers over the SIREN's
gradient features ``[y, dy, d2y, ...]``, concatenated in the order of
``reference.siren.outputs`` (the program's ``feature_vector`` layout).
Imports torch and the SIREN reference only.
"""

from __future__ import annotations

import torch

from inrbench.reference import siren


def features(params, x, order: int, w0: float, matmul=None):
    outs = siren.outputs(params, x, order, w0, matmul)
    return torch.cat([o.reshape(x.shape[0], -1) for o in outs], -1)


def head(psi, feats, matmul=None):
    mm = matmul or (lambda a, w: a @ w)
    h = feats
    for i, layer in enumerate(psi):
        h = mm(h, layer["w"]) + layer["b"]
        if i < len(psi) - 1:
            h = torch.relu(h)
    return h


def outputs(params, heads, x, order: int, w0: float, matmul=None):
    """One ``[N, out]`` tensor per head, in head order."""
    f = features(params, x, order, w0, matmul)
    return tuple(head(psi, f, matmul) for psi in heads)


def init(sizes, n_heads: int, generator, device, dtype=torch.float32):
    """Head weights as the program's ``inr/insp.py`` draws them:
    ``w ~ N(0, 1) / sqrt(fan_in)``, ``b = 0``; all heads in one call."""
    shapes = list(zip(sizes[:-1], sizes[1:]))
    per = sum(fi * fo for fi, fo in shapes)
    g = torch.randn(n_heads * per, generator=generator, device=device,
                    dtype=torch.float32)
    heads, at = [], 0
    for _ in range(n_heads):
        psi = []
        for fi, fo in shapes:
            w = g[at:at + fi * fo].view(fi, fo) / fi ** 0.5
            at += fi * fo
            psi.append({"w": w.to(dtype).contiguous(),
                        "b": torch.zeros(fo, device=device, dtype=dtype)})
        heads.append(psi)
    return heads
