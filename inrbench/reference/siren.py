"""Plain reference of the SIREN and its input derivatives, in PyTorch.

Imports torch only: nothing of the program under test.  A SIREN layer is
``h -> sin(w0 (h W + b))`` and the last one ``h -> h W + b`` (``W`` is
``[in, out]``).  Derivatives with respect to the input coordinates are
propagated forward through each layer (Faa di Bruno), so order ``n``
costs one pass over the rows, whatever graph the program builds.

``outputs`` returns them in the program's layout: ``y`` ``[N, C]``; per
channel ``c`` the gradient ``[N, D]``; per ``(c, i)`` the row ``i`` of the
Hessian, ``[N, D]`` (column ``j`` is d2y_c / dx_i dx_j); per ``(c, i, j)``
the row of third derivatives ``[N, D]`` (column ``k`` is d3y_c / dx_i dx_j
dx_k).
"""

from __future__ import annotations

import itertools

import torch


def _keys(D: int, order: int):
    """Multi-indices (sorted tuples of input axes) up to ``order``."""
    out = [()]
    for k in range(1, order + 1):
        out += list(itertools.combinations_with_replacement(range(D), k))
    return out


def _splits(key):
    """Set partitions of a multi-index of length 1 to 3, as lists of
    sub-indices (what Faa di Bruno's formula sums over)."""
    n = len(key)
    if n == 1:
        return [[key]]
    if n == 2:
        a, b = key
        return [[(a,), (b,)], [key]]
    a, b, c = key
    return [[(a,), (b,), (c,)],
            [tuple(sorted((a, b))), (c,)], [tuple(sorted((a, c))), (b,)],
            [tuple(sorted((b, c))), (a,)],
            [key]]


def _sin_derivs(u, order: int):
    """[sin(u), sin'(u), sin''(u), sin'''(u)] up to ``order``."""
    s, c = torch.sin(u), torch.cos(u)
    return [s, c, -s, -c][:order + 1]


def derivatives(params, x, order: int, w0: float, matmul=None):
    """``{multi-index: tensor [N, C]}`` of the SIREN's output and its input
    derivatives up to ``order`` (at most 3).  ``matmul(a, W)`` defaults to
    ``a @ W``; the control passes a lower-precision product."""
    if order > 3:
        raise ValueError("the reference propagates derivatives to order 3")
    mm = matmul or (lambda a, w: a @ w)
    N, D = x.shape
    keys = _keys(D, order)
    # the input layer: x itself, its first derivatives are unit vectors
    h = {(): x}
    for i in range(D):
        e = torch.zeros_like(x)
        e[:, i] = 1
        h[(i,)] = e
    for li, layer in enumerate(params):
        W, b = layer["w"], layer["b"]
        z = {k: mm(v, W) for k, v in h.items()}
        z[()] = z[()] + b
        if li == len(params) - 1:
            return {k: z.get(k, torch.zeros_like(z[()])) for k in keys}
        u = {k: w0 * v for k, v in z.items()}
        sd = _sin_derivs(u[()], order)
        h = {(): sd[0]}
        for k in keys[1:]:
            acc = None
            for part in _splits(k):
                if any(p not in u for p in part):
                    continue
                term = sd[len(part)]
                for p in part:
                    term = term * u[p]
                acc = term if acc is None else acc + term
            if acc is not None:
                h[k] = acc
    raise ValueError("params holds no layer")


def outputs(params, x, order: int, w0: float, matmul=None):
    """The program's output tuple for ``order`` (see the module doc)."""
    d = derivatives(params, x, order, w0, matmul)
    N, D = x.shape
    C = d[()].shape[1]
    outs = [d[()]]
    for c in range(C):
        outs.append(torch.stack([d[(i,)][:, c] for i in range(D)], -1))
    if order >= 2:
        for c in range(C):
            for i in range(D):
                outs.append(torch.stack(
                    [d[tuple(sorted((i, j)))][:, c] for j in range(D)], -1))
    if order >= 3:
        for c in range(C):
            for i in range(D):
                for j in range(D):
                    outs.append(torch.stack(
                        [d[tuple(sorted((i, j, k)))][:, c]
                         for k in range(D)], -1))
    return tuple(outs)


def laplacian(params, x, w0: float, matmul=None):
    """``sum_i d2y / dx_i^2``, ``[N, C]``."""
    d = derivatives(params, x, 2, w0, matmul)
    return sum(d[(i, i)] for i in range(x.shape[1]))


def init(sizes, w0: float, generator, device, dtype=torch.float32):
    """SIREN weights as the program's ``inr/siren.py`` draws them, made on
    ``device`` in one call: ``U(-1/fin, 1/fin)`` for the first layer,
    ``U(-sqrt(6/fin)/w0, sqrt(6/fin)/w0)`` after it, biases alike."""
    shapes = list(zip(sizes[:-1], sizes[1:]))
    total = sum(fi * fo + fo for fi, fo in shapes)
    u = torch.rand(total, generator=generator, device=device,
                   dtype=torch.float32) * 2 - 1
    params, at = [], 0
    for li, (fi, fo) in enumerate(shapes):
        bound = 1.0 / fi if li == 0 else (6.0 / fi) ** 0.5 / w0
        w = u[at:at + fi * fo].view(fi, fo) * bound
        at += fi * fo
        b = u[at:at + fo] * bound
        at += fo
        params.append({"w": w.to(dtype).contiguous(),
                       "b": b.to(dtype).contiguous()})
    return params


def as_dtype(params, dtype):
    return [{k: v.to(dtype) for k, v in p.items()} for p in params]
