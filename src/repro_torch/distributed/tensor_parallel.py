"""Tensor-parallel compute over a mesh's "model" axis, and the per-layer
gather of parameter blocks, for the sharded steps (``launch/steps.py``).

The reference lets XLA partition a step from the parameters' specs; torch
has no such pass, so the port splits the blocks the "model" axis shards
(``q_dim``, ``kv_dim``, ``o_in``, ``ff``) by hand, Megatron's way:

* each rank of the axis runs its block of the attention heads (q, k and v
  columns, the output projection's rows) and, in training, of the dense
  MLP's hidden units (``wi`` / ``wg`` columns, ``wo`` rows), through the
  same layer code with a config of its local head counts: the attention
  kernel sees the rank's heads only;
* ``into`` (identity forward, all-reduce of the gradient) takes a block's
  normed input into the split, ``out`` (all-reduce forward, identity
  backward) sums the blocks' partial outputs, so the residual stream is
  whole and the same on every rank of the axis;
* where the kv heads do not split over the axis but each rank's q heads
  share one kv head (grouped-query attention with fewer kv heads than
  ranks), every rank runs that kv head, as Megatron replicates them.

Everything else (embeddings, norms, the head, MoE experts, mamba layers)
runs whole on every rank.  The VLM's cross layers read the global head
counts, so the VLM trains unsplit, as do configurations whose heads or
hidden units the axis does not divide (``plan``).  Serving splits the
attention alone wherever the cache's kv heads split over the axis
(``attention_split``; the VLM's cross layers too).

``BlockGather`` is the ``gather`` hook of ``models/zoo.py``: it makes a
layer's working tensors from the rank's blocks while the layer runs
(``sharding.gather_block``).  A split leaf whose block over "model" is the
rank's split block is gathered over the other axes only; any other leaf
is gathered whole and, if split, narrowed.  In the backward each block
gets its gradient summed over the axes whose ranks computed different
parts of it (the data axes the rows are split over; "model" where the
rank computed a part of a leaf that is not its own block) and sliced over
the axes whose ranks computed the same.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.distributed import sharding as shd

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
    blocks (start, width) of q, of k / v and of the MLP's hidden units
    (``ff`` None: the attention alone is split)."""
    cfg: object
    group: object
    q: tuple[int, int]
    kv: tuple[int, int]
    ff: tuple[int, int] | None

    @property
    def mlp(self) -> bool:
        """Whether the dense MLPs are split too."""
        return self.ff is not None

    def into(self, x):
        return _Into.apply(x, self.group)

    def out(self, x):
        return _Out.apply(x, self.group)

    def rule(self, path):
        """How the leaf at ``path`` (within a layer) splits: None (whole,
        outside the split blocks), or (dim, start, width), with dim None
        for a leaf a split block uses whole (the q / k norms)."""
        if len(path) < 2:
            return None
        block, name = path[-2], path[-1]
        if block in ("attn", "xattn"):
            cols = {"q": (-1, self.q), "k": (-1, self.kv),
                    "v": (-1, self.kv), "o": (-2, self.q)}.get(name)
            return (None, 0, 0) if cols is None else (cols[0],) + cols[1]
        if block == "mlp" and self.mlp:
            cols = {"wi": (-1, self.ff), "wg": (-1, self.ff),
                    "wo": (-2, self.ff)}.get(name)
            return None if cols is None else (cols[0],) + cols[1]
        return None


def _split(cfg, mesh, h: int, kh: int, kv0: int, ff):
    r = mesh.coordinate()["model"]
    hd = cfg.head_dim
    return TensorParallel(
        cfg=dataclasses.replace(cfg, n_heads=h, n_kv_heads=kh, head_dim=hd),
        group=mesh.get_group("model"), q=(r * h * hd, h * hd),
        kv=(kv0 * hd, kh * hd), ff=ff)


def plan(cfg, policy) -> TensorParallel | None:
    """This rank's training split over the policy's "model" axis, or None:
    an axis of one rank, a family outside ``_FAMILIES``, heads or MLP
    hidden units the axis does not divide, or q heads of a rank that span
    kv heads not their own."""
    mesh = policy.mesh
    m = mesh.shape.get("model", 1)
    if m <= 1 or cfg.family not in _FAMILIES:
        return None
    H, KH = cfg.n_heads, cfg.n_kv_heads
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
    return _split(cfg, mesh, h, kh, kv0, (r * f, f))


def attention_split(cfg, policy) -> TensorParallel:
    """The serving split: each rank of "model" runs its block of the q and
    kv heads (the kv heads divide the axis), the MLPs whole."""
    mesh = policy.mesh
    m = mesh.shape["model"]
    if cfg.n_kv_heads % m or cfg.n_heads % m:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads / "
                         f"{cfg.n_kv_heads} kv heads do not split over "
                         f"model={m}")
    kh = cfg.n_kv_heads // m
    return _split(cfg, mesh, cfg.n_heads // m, kh,
                  mesh.coordinate()["model"] * kh, None)


class BlockGather:
    """The ``gather`` hook of ``zoo.forward`` / ``prefill`` /
    ``decode_step``: a tree of a layer's blocks (or of top-level leaves by
    name) -> the tensors the layer computes with.  ``specs`` maps a leaf's
    path within its layer (a top-level leaf's name) to its (whole shape,
    spec) with the stacked dims dropped (``launch/steps.layer_specs``);
    ``partial`` names the axes whose ranks hold different rows; ``tp`` is
    the rank's split or None."""

    def __init__(self, mesh, specs: dict, partial=(), tp=None):
        self.mesh = mesh
        self.specs = specs
        self.partial = tuple(partial)
        self.tp = tp

    def __call__(self, tree, path=()):
        if isinstance(tree, dict):
            return {k: self(v, path + (k,)) for k, v in tree.items()}
        return self.leaf(path, tree)

    def leaf(self, path, block):
        shape, spec = self.specs[path]
        rule = None if self.tp is None else self.tp.rule(path)
        if rule is None:
            return shd.gather_block(block, spec, self.mesh, self.partial)
        both = self.partial + ("model",)
        dim, start, width = rule
        if dim is None:
            return shd.gather_block(block, spec, self.mesh, both)
        dim %= len(shape)
        if shd.spec_dims(spec).get("model") == dim and shd.block_of(
                self.mesh, spec, dim, shape[dim]) == (start, width):
            # the block over "model" is the rank's split block
            rest = shd.only_axes(spec, set(self.mesh.axis_names) - {"model"})
            return shd.gather_block(block, rest, self.mesh, self.partial)
        whole = shd.gather_block(block, spec, self.mesh, both)
        return whole.narrow(dim, start, width)
