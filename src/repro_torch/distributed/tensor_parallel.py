"""Tensor-parallel compute over a mesh's "model" axis for the sharded train
step (``launch/steps.py``).

The reference lets XLA partition a step from the parameters' specs; torch
has no such pass, so the port splits the blocks the "model" axis shards
(``q_dim``, ``kv_dim``, ``o_in``, ``ff``) by hand, Megatron's way:

* each rank of the axis runs its block of the attention heads (q, k and v
  columns, the output projection's rows) and of the dense MLP's hidden
  units (``wi`` / ``wg`` columns, ``wo`` rows), through the same layer code
  with a config of its local head counts: the attention kernel sees the
  rank's heads only;
* ``into`` (identity forward, all-reduce of the gradient) takes a block's
  normed input into the split, ``out`` (all-reduce forward, identity
  backward) sums the blocks' partial outputs, so the residual stream is
  whole and the same on every rank of the axis;
* where the kv heads do not split over the axis but each rank's q heads
  share one kv head (grouped-query attention with fewer kv heads than
  ranks), every rank runs that kv head, as Megatron replicates them.

Everything else (embeddings, norms, the head, MoE experts, mamba layers)
runs whole on every rank.  A parameter used inside a split block gets its
gradient as the sum over the axis of what each rank computed for its
block (``assemble``).  The VLM's cross layers read the global head counts,
so the VLM runs unsplit, as do configurations whose heads or hidden units
the axis does not divide.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.checkpoint.ckpt import tree_items

_FAMILIES = ("dense", "audio", "moe", "hybrid")


class _Into(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Out(torch.autograd.Function):
    """The partial outputs all-reduced over the group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclass(frozen=True)
class TensorParallel:
    """One rank's split: ``cfg`` with the rank's head counts, the column
    blocks (start, width) of q, of k / v and of the MLP's hidden units."""
    cfg: object
    group: object
    q: tuple[int, int]
    kv: tuple[int, int]
    ff: tuple[int, int]

    @property
    def hooks(self):
        """``(into, out)`` for ``zoo.forward(..., tp=)``."""
        return (lambda x: _Into.apply(x, self.group),
                lambda x: _Out.apply(x, self.group))

    def _rule(self, path):
        """How the leaf at ``path`` splits: None (whole, outside the split
        blocks), or (dim, start, width), with dim None for a leaf a split
        block uses whole (the q / k norms)."""
        if len(path) < 2:
            return None
        block, name = path[-2], path[-1]
        cols = {("attn", "q"): (-1, self.q), ("attn", "k"): (-1, self.kv),
                ("attn", "v"): (-1, self.kv), ("attn", "o"): (-2, self.q),
                ("mlp", "wi"): (-1, self.ff), ("mlp", "wg"): (-1, self.ff),
                ("mlp", "wo"): (-2, self.ff)}.get((block, name))
        if cols is not None:
            return (cols[0],) + cols[1]
        if block == "attn":
            return (None, 0, 0)
        return None

    def localize(self, params):
        """``params`` (whole tensors) with each split leaf narrowed to the
        rank's block (views)."""
        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            rule = self._rule(path)
            if rule is None or rule[0] is None:
                return tree
            dim, start, width = rule
            return tree.narrow(dim, start, width)
        return walk(params, ())

    def assemble(self, params, grads: list) -> list:
        """The whole gradient of each leaf of ``params`` (in the reference's
        leaf order) from this rank's gradients of ``localize(params)``: a
        split leaf's block, or a whole leaf a split block uses, summed over
        the axis into zeros of the leaf's shape; other leaves as they are
        (the same on every rank)."""
        import torch.distributed as dist
        out = []
        for (path, p), g in zip(tree_items(params), grads):
            rule = self._rule(path)
            if rule is None:
                out.append(g)
                continue
            full = torch.zeros(p.shape, dtype=g.dtype, device=g.device)
            dim, start, width = rule
            (full if dim is None else full.narrow(dim, start, width)).copy_(g)
            dist.all_reduce(full, group=self.group)
            out.append(full)
        return out


def plan(cfg, policy) -> TensorParallel | None:
    """This rank's split over the policy's "model" axis, or None: an axis of
    one rank, a family outside ``_FAMILIES``, heads or MLP hidden units the
    axis does not divide, or q heads of a rank that span kv heads not
    their own."""
    mesh = policy.mesh
    m = mesh.shape.get("model", 1)
    if m <= 1 or cfg.family not in _FAMILIES:
        return None
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if H % m or cfg.d_ff % m:
        return None
    r = mesh.coordinate()["model"]
    h = H // m
    if KH % m == 0:
        kh, kv0 = KH // m, r * (KH // m)
    elif (H // KH) % h == 0:
        kh, kv0 = 1, (r * h) // (H // KH)
    else:
        return None
    f = cfg.d_ff // m
    return TensorParallel(
        cfg=dataclasses.replace(cfg, n_heads=h, n_kv_heads=kh, head_dim=hd),
        group=mesh.get_group("model"), q=(r * h * hd, h * hd),
        kv=(kv0 * hd, kh * hd), ff=(r * f, f))
