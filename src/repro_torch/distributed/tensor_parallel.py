"""Tensor-parallel compute over a mesh's "model" axis, the sequence split
over it, the per-layer gather of parameter blocks, and the decode step's
weight-stationary layout, for the sharded steps (``launch/steps.py``).

The reference lets XLA partition a step from the parameters' specs; torch
has no such pass, so the port splits the blocks the "model" axis shards
by hand, Megatron's way.  Each block the axis splits is wrapped in an
``into`` (its input taken into the split) and an ``out`` (the blocks'
partial outputs summed).  Two layouts of the residual stream between the
blocks:

* whole on every rank of the axis (the default): ``into`` is the
  identity with its gradient all-reduced, ``out`` an all-reduce with an
  identity backward;
* split along the sequence over the axis (``SeqParallel``: the step's
  batch splits its sequence dim over "model", as ``seq_parallel``'s
  ``batch_specs`` do; Megatron's sequence parallelism): each rank holds
  the residual stream of its rows and its block of the sequence, and the
  norms run on it.  ``into`` all-gathers the sequence (its backward a
  reduce-scatter), ``out`` reduce-scatters the partial outputs over the
  sequence (its backward an all-gather).  A block the axis does not
  split that needs the whole sequence (an attention or a mamba layer
  whose heads the axis does not divide) gathers it, runs whole and keeps
  the rank's block; one that runs token by token (a dense MLP, a cross
  attention layer) runs on the rank's tokens.  Every parameter a rank
  uses whole then gets a partial gradient, summed over "model"
  (``BlockGather``).  Attention always sees the whole sequence, at
  whole-sequence positions.

* ``TensorParallel`` (``plan``, ``serving_split``): each rank of the axis
  runs its block of the attention heads (q, k and v columns, the output
  projection's rows) where the axis divides them, and of the dense MLP's
  hidden units (``wi`` / ``wg`` columns, ``wo`` rows) wherever it divides
  ``d_ff``, independently: the reference's specs shard ``ff`` over
  "model" wherever the axis divides it.  The attention runs through the
  same layer code with a config of the rank's head counts: the attention
  kernel sees the rank's heads only.  Where the kv heads do not split
  over the axis but each rank's q heads share one kv head (grouped-query
  attention with fewer kv heads than ranks), every rank runs that kv
  head, as Megatron replicates them.  Elsewhere the attention runs whole
  on every rank.  The VLM's self and cross layers split alike (the image
  embeddings are batch inputs, whole on every rank).  Serving splits the
  attention wherever the cache's kv heads split over the axis and the
  MLPs wherever training does.
* ``ModelSplit`` (``model_split``), in every family and every sharded
  step, with or without the attention split: the blocks the specs shard
  over "model" of the vocab (Megatron's vocab-parallel embedding, head
  and cross entropy: ``lookup``, ``merge_lse``, ``label_logit``,
  ``columns``), of the MoE experts and shared experts
  (expert parallelism, ``layers.moe_ffn``) and of the mamba heads
  (``heads``, ``inner``: ``layers.mamba_layer`` runs the rank's nh/m
  heads on its ``wz`` / ``wx`` / ``wdt`` columns and ``wo`` rows, uses
  ``wb``, ``wc`` and the conv whole and the per-head scalars and the
  norm narrowed to its heads, and all-reduces its gated norm's sum of
  squares over "model", ``psum``) stay the rank's own; a leaf the specs
  leave whole over "model" is computed whole.  The mamba rules live here
  because, unlike the attention split, they need no config of local
  widths and hold in every step: ``mamba_layer`` reads its widths from
  the split.

The norms run whole on every rank (on the rank's sequence block under
``SeqParallel``), as do the mamba layers whose heads the axis does not
divide.

``BlockGather`` is the ``gather`` hook of ``models/zoo.py`` in training
and prefill: it makes a layer's working tensors from the rank's blocks
while the layer runs (``sharding.gather_block``).  A leaf whose block
over "model" is the rank's split block (of either split) is gathered
over the other axes only; any other leaf is gathered whole and, if
split, narrowed.  In the backward each block gets its gradient summed
over the axes whose ranks computed different parts of it (the data axes
the rows are split over; "model" where the rank computed a part of a
leaf that is not its own block, or under ``SeqParallel`` its own tokens'
part of a leaf it uses whole) and sliced over the axes whose ranks
computed the same.

``Stationary`` is the decode step's layout (Pope et al., "Efficiently
Scaling Transformer Inference", §3.2.2): no parameter block moves.  The
residual stream holds every row of the batch and the rank's block of
``d_model`` over the data axes (``D_blk``, the block of the parameters'
``*_fsdp`` dims); the collectives, all of activations:

* each norm: its float32 sum of squares [B] all-reduced over the data
  axes;
* a product x[B, D_blk] @ W[D_blk, F_blk] (q / k / v, an MLP's ``wi`` /
  ``wg``, the router, the experts' ``wi`` / ``wg``, the mamba
  projections, the head): its float32 partial sums reduce-scattered over
  the data axes to the rank's rows where the next op runs on the cache's
  rows (attention, mamba), else all-reduced; the leaves of one block
  share one collective; each result rounded once; and where the block
  runs whole over "model" but the specs split its columns, the rank's
  columns all-gathered over "model";
* a product h @ W[F_blk, D_blk] (``o``, the MLPs' and the mamba ``wo``):
  the rank's rows of h all-gathered over the data axes, and where W's
  rows split over "model", its partial outputs all-reduced over "model"
  in the compute dtype, as the split blocks' ``out`` sums them in
  prefill and training (a MoE layer sums its experts' combined rows and
  its shared experts' output in one float32 all-reduce, as
  ``layers.moe_ffn`` does in every step);
* the embedding's lookups of a vocab split over "model" all-reduced over
  it; the head's argmax merged over "model" (``merged_argmax``: each
  rank's best logit and its index all-gathered);
* a mamba layer's conv channels, where they split over "model": the
  rank's block convolved and the results all-gathered; under the head
  split its x channels all-gathered before the conv and its gated norm's
  sum of squares all-reduced; attention split by sequence: the lse
  merge's max and sums (``steps.CacheLayout.merge``).

Partial sums over the data axes, the ones this layout adds, move in
float32 and are rounded once to the compute dtype, as the unsharded
product rounds once.  On a mesh of one rank on every axis each product
is the unsharded step's.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.distributed import sharding as shd

_FAMILIES = ("dense", "audio", "moe", "hybrid", "vlm")


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


class _Sum(torch.autograd.Function):
    """The group's all-reduce with an all-reduce of the gradient: the sum
    a term of every rank's own loss reads (the transpose of a psum), so
    the ranks' gradients, summed over the group, count the term once for
    each rank that adds it."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x, groups):
    """``x`` summed over each process group of ``groups`` in turn, its
    gradient too (``_Sum``)."""
    for group in groups:
        x = _Sum.apply(x, group)
    return x


class _SeqGather(torch.autograd.Function):
    """The ranks' sequence blocks (dim 1) all-gathered over "model"; the
    gradient, partial on each rank, reduce-scattered back into the
    blocks."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return shd._all_gather_dim(x, 1, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return shd._reduce_scatter_dim(g, 1, ctx.mesh, "model"), None


class _SeqScatter(torch.autograd.Function):
    """The ranks' partial outputs over the whole sequence summed over
    "model", each rank keeping its sequence block (a reduce-scatter of
    dim 1); the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return shd._reduce_scatter_dim(x, 1, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return shd._all_gather_dim(g, 1, ctx.mesh, "model"), None


class _SeqShare(torch.autograd.Function):
    """The ranks' sequence blocks all-gathered over "model" for a use
    whose gradient is whole on every rank: the backward keeps the rank's
    block of it, no collective."""

    @staticmethod
    def forward(ctx, x, mesh, start):
        ctx.start, ctx.width = start, x.shape[1]
        return shd._all_gather_dim(x, 1, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.start, ctx.width), None, None


@dataclass(frozen=True)
class SeqParallel:
    """The residual stream split along the sequence (dim 1) over the
    "model" axis: each rank holds its block of ``n`` equal ones, the
    ``index``-th (module docstring)."""
    mesh: object

    @property
    def n(self) -> int:
        return self.mesh.shape["model"]

    @property
    def index(self) -> int:
        return self.mesh.coordinate()["model"]

    def gather(self, x):
        """The whole sequence from the ranks' blocks; the gradient
        reduce-scattered (``_SeqGather``)."""
        return _SeqGather.apply(x, self.mesh)

    def scatter(self, x):
        """The rank's block of the ranks' partial outputs summed
        (``_SeqScatter``)."""
        return _SeqScatter.apply(x, self.mesh)

    def keep(self, x):
        """The rank's block of a whole sequence every rank computed."""
        w = x.shape[1] // self.n
        return x.narrow(1, self.index * w, w)

    def share(self, x):
        """The whole sequence from the ranks' blocks for a use every rank
        makes alike, whose gradient is whole on every rank
        (``_SeqShare``)."""
        return _SeqShare.apply(x, self.mesh, self.index * x.shape[1])

    def tokens(self, t):
        """Integer blocks [B, S/n] (tokens, labels) gathered whole."""
        return shd._all_gather_dim(t, 1, self.mesh, "model")

    def last(self, x):
        """The whole sequence's last position x[:, -1] (on the last
        rank's block), on every rank."""
        return shd._all_gather_dim(x[:, -1:], 1, self.mesh, "model")[:, -1]

    def mean(self, loss):
        """The mean over the ranks of each rank's mean over its tokens
        (equal blocks: the whole sequence's mean); each rank's loss gets
        the gradient 1/n (``_Out``)."""
        return _Out.apply(loss, self.mesh.get_group("model")) / self.n


def with_seq(split, seq):
    """``split`` (a ``TensorParallel`` or ``ModelSplit``, or None) with
    its ``into`` / ``out`` on the sequence split ``seq``."""
    if split is None or seq is None:
        return split
    return dataclasses.replace(split, seq=seq)


def _own(idx, start: int, width: int):
    """(``idx`` as indices into the block [start, start + width), clamped
    into it; whether each falls in it)."""
    local = idx.long() - start
    own = (local >= 0) & (local < width)
    return local.clamp(0, width - 1), own


class _Lookup(torch.autograd.Function):
    """The rows of ``tokens`` from a block of an embedding table that
    starts at row ``start``, in ``dtype``, zeros for the tokens outside
    it.  It keeps ``tokens`` alone for the backward (the indices and the
    mask are made again there), as the plain lookup keeps its index."""

    @staticmethod
    def forward(ctx, table, tokens, start, dtype):
        local, own = _own(tokens, start, table.shape[0])
        ctx.save_for_backward(tokens)
        ctx.start, ctx.table = start, (table.shape, table.dtype)
        return table[local].to(dtype).masked_fill_(~own[..., None], 0)

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        shape, dtype = ctx.table
        local, own = _own(tokens, ctx.start, shape[0])
        grad = torch.zeros(shape, dtype=dtype, device=g.device)
        grad.index_put_((local,), g.masked_fill(~own[..., None], 0).to(
            dtype), accumulate=True)
        return grad, None, None, None


class _MergeLse(torch.autograd.Function):
    """The log-sum-exp over every rank's columns from each rank's own:
    the largest all-reduced (max), the exps below it all-reduced (sum).
    Backward: exp(own - whole) * g, no collective."""

    @staticmethod
    def forward(ctx, lse, group):
        import torch.distributed as dist
        top = lse.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        s = torch.exp(lse - top)
        dist.all_reduce(s, group=group)
        whole = top + torch.log(s)
        ctx.save_for_backward(lse, whole)
        return whole

    @staticmethod
    def backward(ctx, g):
        lse, whole = ctx.saved_tensors
        return g * torch.exp(lse - whole), None


@dataclass(frozen=True)
class TensorParallel:
    """One rank's split: ``cfg`` with the rank's head counts, the column
    blocks (start, width) of q and of k / v (None: the attention runs
    whole, ``cfg`` the model's) and of the MLP's hidden units (None: the
    MLPs run whole); ``seq`` the sequence split its ``into`` and ``out``
    move (None: the residual stream is whole)."""
    cfg: object
    group: object
    q: tuple[int, int] | None
    kv: tuple[int, int] | None
    ff: tuple[int, int] | None
    seq: SeqParallel | None = None

    @property
    def attn(self) -> bool:
        """Whether the attention heads are split."""
        return self.q is not None

    @property
    def mlp(self) -> bool:
        """Whether the dense MLPs are split."""
        return self.ff is not None

    def into(self, x):
        if self.seq is not None:
            return self.seq.gather(x)
        return _Into.apply(x, self.group)

    def out(self, x):
        if self.seq is not None:
            return self.seq.scatter(x)
        return _Out.apply(x, self.group)

    def rule(self, path):
        """How the leaf at ``path`` (within a layer) splits: None (whole,
        outside the split blocks), or (dim, start, width), with dim None
        for a leaf a split block uses whole (the q / k norms)."""
        if len(path) < 2:
            return None
        block, name = path[-2], path[-1]
        if block in ("attn", "xattn"):
            if not self.attn:
                return None
            cols = {"q": (-1, self.q), "k": (-1, self.kv),
                    "v": (-1, self.kv), "o": (-2, self.q)}.get(name)
            return (None, 0, 0) if cols is None else (cols[0],) + cols[1]
        if block == "mlp" and self.mlp:
            cols = {"wi": (-1, self.ff), "wg": (-1, self.ff),
                    "wo": (-2, self.ff)}.get(name)
            return None if cols is None else (cols[0],) + cols[1]
        return None


@dataclass(frozen=True)
class ModelSplit:
    """The blocks over the "model" axis a sharded step keeps the rank's
    own, (start, width) each, None where the specs leave the dim whole:
    ``embed`` the rank's rows of the embedding table, ``vocab`` its
    columns of the head (so of the logits), ``experts`` its MoE experts,
    ``shared`` its shared experts' hidden units, ``heads`` its mamba heads
    and ``inner`` their channels (``heads`` times the head dim); ``seq``
    the sequence split its ``into`` and ``out`` move, as
    ``TensorParallel``'s."""
    mesh: object
    embed: tuple[int, int] | None
    vocab: tuple[int, int] | None
    experts: tuple[int, int] | None
    shared: tuple[int, int] | None
    heads: tuple[int, int] | None = None
    inner: tuple[int, int] | None = None
    seq: SeqParallel | None = None

    # leaf path (within a layer) -> (the split's field, the dim it splits)
    _DIMS = {("embed",): ("embed", 0), ("lm_head",): ("vocab", 1),
             ("moe", "wi"): ("experts", 0), ("moe", "wg"): ("experts", 0),
             ("moe", "wo"): ("experts", 0),
             ("moe", "shared", "wi"): ("shared", 1),
             ("moe", "shared", "wg"): ("shared", 1),
             ("moe", "shared", "wo"): ("shared", 0),
             ("mamba", "wz"): ("inner", 1), ("mamba", "wx"): ("inner", 1),
             ("mamba", "wdt"): ("heads", 1), ("mamba", "wo"): ("inner", 0)}
    # the leaves the mamba split uses whole, by the dim it narrows them
    # on (None: whole; the conv's rank channels are ``layers.mamba_layer``'s
    # choice): their gradients are summed over "model"
    _WHOLE = {("mamba", "a_log"): ("heads", 0), ("mamba", "d"): ("heads", 0),
              ("mamba", "dt_bias"): ("heads", 0),
              ("mamba", "norm"): ("inner", 0), ("mamba", "wb"): None,
              ("mamba", "wc"): None, ("mamba", "conv"): None}

    @property
    def group(self):
        return self.mesh.get_group("model")

    def into(self, x):
        if self.seq is not None:
            return self.seq.gather(x)
        return _Into.apply(x, self.group)

    def out(self, x):
        if self.seq is not None:
            return self.seq.scatter(x)
        return _Out.apply(x, self.group)

    def complete(self, x):
        """``x`` as it is, its gradient, partial on each rank, all-reduced
        over "model" (a tensor of every token, whatever the layout)."""
        return _Into.apply(x, self.group)

    def rule(self, path):
        """As ``TensorParallel.rule``: (dim, start, width) of the rank's
        block of the leaf at ``path``, None where the leaf is whole, dim
        None for a leaf the split uses whole."""
        key = tuple(path[-2:])
        if key in self._WHOLE:
            if self.heads is None:
                return None
            how = self._WHOLE[key]
            return (None, 0, 0) if how is None else \
                (how[1],) + getattr(self, how[0])
        for key in (tuple(path[-3:]), key):
            if key in self._DIMS:
                field, dim = self._DIMS[key]
                block = getattr(self, field)
                return None if block is None else (dim,) + block
        return None

    def psum(self, x):
        """``x`` summed over "model", its gradient too (``psum``)."""
        return psum(x, [self.group])

    def lookup(self, table, tokens, dtype):
        """The embedding of ``tokens`` from the rank's rows of the table
        (in ``dtype``): the rows the rank holds, zeros for the others
        (``_Lookup``), summed over "model" (``out``; under ``seq`` the
        tokens of the rank's sequence block are gathered whole first, and
        the sums reduce-scattered into its block)."""
        if self.seq is not None:
            tokens = self.seq.tokens(tokens)
        return self.out(_Lookup.apply(table, tokens, self.embed[0], dtype))

    def merge_lse(self, lse):
        """The log-sum-exp over the whole vocab from the rank's columns'
        (``_MergeLse``)."""
        return _MergeLse.apply(lse, self.group)

    def label_logit(self, logits, labels):
        """float32 logit of each label from the rank's columns
        [..., V/m]: the rank that holds the label's column gives it, the
        others 0, summed over "model"."""
        local, own = _own(labels, *self.vocab)
        lab = torch.gather(logits, -1, local[..., None])[..., 0]
        return _Out.apply(torch.where(own, lab.to(torch.float32), 0.0),
                          self.group)

    def columns(self, logits):
        """Logits [B, V] from each rank's columns [B, V/m] (an
        all-gather over "model")."""
        return shd.gather(logits, shd.P(None, "model"), self.mesh)


def model_split(mesh, specs) -> ModelSplit | None:
    """The rank's ``ModelSplit`` from ``specs`` (``BlockGather``'s table:
    a leaf's whole shape and spec by its path in its layer); None over a
    "model" axis of one rank or where no such leaf splits over it."""
    if mesh.shape.get("model", 1) <= 1:
        return None

    blocks = dict.fromkeys(("embed", "vocab", "experts", "shared", "heads",
                            "inner"))
    for path, (field, dim) in ModelSplit._DIMS.items():
        if path in specs:
            shape, spec = specs[path]
            if shd.spec_dims(spec).get("model") == dim:
                blocks[field] = shd.block_of(
                    mesh, shd.only_axes(spec, ("model",)), dim, shape[dim])
    if blocks["heads"] is None or blocks["inner"] is None:
        # the mamba layers split by heads, or run whole
        blocks["heads"] = blocks["inner"] = None
    if not any(blocks.values()):
        return None
    return ModelSplit(mesh, **blocks)


def _split(cfg, mesh, heads, ff):
    """The rank's ``TensorParallel``: ``heads`` (q heads, kv heads, first
    kv head) of the rank, or None (the attention whole); ``ff`` its block
    of the MLP's hidden units, or None."""
    if heads is None:
        return TensorParallel(cfg=cfg, group=mesh.get_group("model"),
                              q=None, kv=None, ff=ff)
    h, kh, kv0 = heads
    r = mesh.coordinate()["model"]
    hd = cfg.head_dim
    return TensorParallel(
        cfg=dataclasses.replace(cfg, n_heads=h, n_kv_heads=kh, head_dim=hd),
        group=mesh.get_group("model"), q=(r * h * hd, h * hd),
        kv=(kv0 * hd, kh * hd), ff=ff)


def _ff_block(cfg, mesh):
    """The rank's block (start, width) of the dense MLPs' hidden units, or
    None where the axis does not divide ``d_ff`` (or there are none)."""
    m = mesh.shape["model"]
    if not cfg.d_ff or cfg.d_ff % m:
        return None
    f = cfg.d_ff // m
    return mesh.coordinate()["model"] * f, f


def plan(cfg, policy) -> TensorParallel | None:
    """This rank's training split over the policy's "model" axis, or None:
    an axis of one rank, a family outside ``_FAMILIES``, or neither the
    heads nor the MLP's hidden units split.  The heads split where the
    axis divides them and a rank's q heads use its own kv heads or share
    one; the hidden units wherever the axis divides ``d_ff``."""
    mesh = policy.mesh
    m = mesh.shape.get("model", 1)
    if m <= 1 or cfg.family not in _FAMILIES:
        return None
    H, KH = cfg.n_heads, cfg.n_kv_heads
    r = mesh.coordinate()["model"]
    heads = None
    if H % m == 0:
        h = H // m
        if KH % m == 0:
            heads = h, KH // m, r * (KH // m)
        elif (H // KH) % h == 0:
            heads = h, 1, (r * h) // (H // KH)
    ff = _ff_block(cfg, mesh)
    if heads is None and ff is None:
        return None
    return _split(cfg, mesh, heads, ff)


def serving_split(cfg, policy, heads: bool) -> TensorParallel | None:
    """The serving split: each rank of "model" runs its block of the q and
    kv heads where ``heads`` (the cache's kv heads split over the axis),
    and of the MLP's hidden units wherever the axis, of more than one
    rank, divides ``d_ff``, as ``plan``; None where neither splits."""
    mesh = policy.mesh
    m = mesh.shape["model"]
    if heads and (cfg.n_kv_heads % m or cfg.n_heads % m):
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads / "
                         f"{cfg.n_kv_heads} kv heads do not split over "
                         f"model={m}")
    kh = cfg.n_kv_heads // m
    ff = _ff_block(cfg, mesh) if m > 1 and cfg.family in _FAMILIES \
        else None
    if not heads and ff is None:
        return None
    return _split(cfg, mesh, (cfg.n_heads // m, kh,
                              mesh.coordinate()["model"] * kh)
                  if heads else None, ff)


class BlockGather:
    """The ``gather`` hook of ``zoo.forward`` / ``prefill`` /
    ``decode_step``: a tree of a layer's blocks (or of top-level leaves by
    name) -> the tensors the layer computes with.  ``specs`` maps a leaf's
    path within its layer (a top-level leaf's name) to its (whole shape,
    spec) with the stacked dims dropped (``launch/steps.layer_specs``);
    ``partial`` names the axes whose ranks hold different rows; ``tp`` is
    the rank's ``TensorParallel`` or None, ``split`` its ``ModelSplit`` or
    None; ``seq``: whether the ranks of "model" hold different blocks of
    the sequence, so that a leaf a rank uses whole gets a partial
    gradient there too."""

    def __init__(self, mesh, specs: dict, partial=(), tp=None, split=None,
                 seq=False):
        self.mesh = mesh
        self.specs = specs
        self.partial = tuple(partial)
        self.whole = self.partial + (("model",) if seq else ())
        self.tp = tp
        self.split = split

    def __call__(self, tree, path=()):
        if isinstance(tree, dict):
            return {k: self(v, path + (k,)) for k, v in tree.items()}
        return self.leaf(path, tree)

    def leaf(self, path, block):
        shape, spec = self.specs[path]
        rule = None if self.tp is None else self.tp.rule(path)
        if rule is None and self.split is not None:
            rule = self.split.rule(path)
        if rule is None:
            return shd.gather_block(block, spec, self.mesh, self.whole)
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


def _all_reduce(t, mesh, axes):
    """``t`` summed over each mesh axis of ``axes`` in turn
    (``_c10d_functional`` all-reduces)."""
    fc = shd._fc()
    for a in axes:
        t = fc.wait_tensor(fc.all_reduce(t.contiguous(), "sum",
                                         mesh.get_group(a).group_name))
    return t


class Stationary:
    """The decode step's weight-stationary layout (module docstring).
    ``specs`` is ``BlockGather``'s table, ``rows`` the data axes the
    step's rows (the cache's) split over, none where they are whole;
    ``sum`` are the data axes that split ``d_model``, over which the
    products' partial sums run.  ``sub(name, whole)`` binds the hooks to a block of a layer (its
    leaves' paths under ``name``); ``whole``: whether the block runs whole
    over "model" (the columns its specs split all-gathered), else on the
    rank's columns of every leaf."""

    def __init__(self, mesh, specs: dict, rows):
        self.mesh, self.specs = mesh, specs
        self.rows = tuple(rows)
        (_, D), spec = specs[("embed",)]
        self.d_model = D
        dims = shd.spec_dims(spec)
        self.sum = tuple(a for a in mesh.axis_names
                         if dims.get(a) == 1 and mesh.shape[a] > 1)
        if self.sum and self.rows and self.sum != self.rows:
            raise ValueError(f"the rows split over {self.rows}, d_model "
                             f"over {self.sum}")
        self.m = mesh.shape.get("model", 1)
        self.prefix, self.whole = (), True

    def sub(self, name: str, whole: bool = True) -> "Stationary":
        out = copy.copy(self)
        out.prefix, out.whole = self.prefix + (name,), whole
        return out

    # -- collectives of activations ---------------------------------------
    def model_sum(self, t):
        """``t`` summed over "model"."""
        return _all_reduce(t, self.mesh, ("model",) if self.m > 1 else ())

    def gather_model(self, t, dim: int = -1):
        """The ranks' blocks of ``t`` along ``dim`` all-gathered over
        "model"."""
        if self.m == 1:
            return t
        return shd._all_gather_dim(t, dim, self.mesh, "model")

    def gather_rows(self, t):
        """Every row (dim 0) from the ranks' rows."""
        for a in reversed(self.rows):
            t = shd._all_gather_dim(t, 0, self.mesh, a)
        return t

    # -- the rank's blocks ---------------------------------------------------
    def block(self, name: str, dim: int):
        """(start, width) of the rank's block over "model" of ``dim`` of
        the leaf ``name`` of the bound block, None where it is whole."""
        shape, spec = self.specs[self.prefix + (name,)]
        dim %= len(shape)
        return shd.block_of(self.mesh, shd.only_axes(spec, ("model",)),
                            dim, shape[dim])

    def _rows_of(self, t):
        """The rank's rows of a tensor of every row."""
        return shd.local_shard(t, shd.P(self.rows), self.mesh)

    # -- products ------------------------------------------------------------
    def col(self, x, p: dict, names, rows: bool, whole=None, dtype=None):
        """``x`` [B, ..., D_blk] @ each leaf ``p[name]`` [D_blk, F_blk]
        (or batched: the MoE experts' ``x`` [E_blk, n, D_blk] @ [E_blk,
        D_blk, F]): the list of results in ``dtype`` (``x``'s by default),
        of the rank's rows where ``rows`` (else every row), and with the
        columns the spec splits over "model" all-gathered where ``whole``
        (by default the bound block's).  Partial sums over ``sum`` are
        float32, summed in one collective for all the leaves and rounded
        once."""
        out_dt = x.dtype if dtype is None else dtype
        ws = [p[k] for k in names]
        if not self.sum:
            ys = [x.to(out_dt) @ w.to(out_dt) for w in ws]
            if rows:
                ys = [self._rows_of(y) for y in ys]
        else:
            acc = torch.promote_types(x.dtype, torch.float32)
            parts = [x.to(acc) @ w.to(acc) for w in ws]
            y = torch.cat(parts, dim=-1)
            if rows and self.rows:
                for a in self.rows:             # outer first
                    y = shd._reduce_scatter_dim(y, 0, self.mesh, a)
            else:
                y = _all_reduce(y, self.mesh, self.sum)
            ys = [t.to(out_dt) for t in torch.split(
                y, [t.shape[-1] for t in parts], dim=-1)]
        if self.whole if whole is None else whole:
            split = [i for i, k in enumerate(names)
                     if self.block(k, -1) is not None]
            if split:
                widths = [ys[i].shape[-1] for i in split]
                y = self.gather_model(torch.cat([ys[i] for i in split], -1))
                y = y.unflatten(-1, (self.m, sum(widths)))
                for i, t in zip(split, torch.split(y, widths, dim=-1)):
                    ys[i] = t.flatten(-2)
        return ys

    def row(self, h, p: dict, name: str, rows: bool, reduce: bool = True):
        """``h`` [rows, ..., F] @ ``p[name]`` [F_blk, D_blk] -> [B, ...,
        D_blk] of every row: ``h`` of the rank's rows (``rows``) or of
        every row, its columns narrowed to the leaf's block over "model"
        where they are whole.  Where that block splits, the partial
        outputs are summed over "model" in ``h``'s dtype, as the split
        blocks' ``out`` sums them in prefill and training (without
        ``reduce``, the rank's partial output)."""
        w = p[name]
        blk = self.block(name, 0)
        if blk is not None and h.shape[-1] != w.shape[0]:
            h = h.narrow(-1, *blk)
        if rows:
            h = self.gather_rows(h)
        y = h @ w.to(h.dtype)
        return self.model_sum(y) if blk is not None and reduce else y

    # -- the residual stream's ends and norms ----------------------------------
    def norm(self, x, w, eps):
        """``layers.rms_norm`` of the rows [B, ..., D_blk] over all of
        ``d_model``: the float32 sum of squares all-reduced over ``sum``,
        the whole weight ``w`` narrowed to the rank's block."""
        from repro_torch.models import layers
        if not self.sum:
            return layers.rms_norm(x, w, eps)
        return layers.rms_norm_parts(
            x, shd.local_shard(w, shd.P(self.sum), self.mesh), eps,
            lambda t: _all_reduce(t, self.mesh, self.sum), self.d_model)

    def lookup(self, table, tokens, dtype):
        """The rows [B, D_blk] of every token from the rank's block of the
        embedding table, in ``dtype``; where the vocab splits over
        "model", zeros for the rows other ranks hold and the lookups
        summed over "model" (one rank adds each row: exact)."""
        blk = self.block("embed", 0)
        if blk is None:
            return table[tokens].to(dtype)
        return self.model_sum(_Lookup.apply(table, tokens, blk[0], dtype))

    def head(self, x, w):
        """The greedy next token [B] (int64) of the normed rows
        ``x`` [B, D_blk] from the rank's block of the head: float32
        partial logits of its columns, all-reduced over ``sum`` and
        rounded once to the compute dtype, as the unsharded head rounds
        them; their argmax merged over "model" (``merged_argmax``)."""
        blk = self.block("lm_head", 1)
        if blk is None and self.m > 1:
            # the vocab whole on every rank of "model": each takes its
            # near-equal share of the columns
            V, r = w.shape[1], self.mesh.coordinate()["model"]
            lo, hi = V * r // self.m, V * (r + 1) // self.m
            w, blk = w[:, lo:hi], (lo, hi - lo)
        logits = self.col(x, {"lm_head": w}, ("lm_head",), rows=False,
                          whole=False)[0].to(torch.float32)
        if blk is None:
            return torch.argmax(logits, dim=-1)
        return merged_argmax(logits, blk[0], self.mesh)


def merged_argmax(logits, start: int, mesh):
    """Each row's index of its largest logit over every rank's columns
    [B, V_r] (the rank's starting at ``start``), int64; the lowest index on
    ties, as ``torch.argmax``: each rank's first largest, then the first
    rank (the lowest columns) holding the largest of them."""
    idx = torch.argmax(logits, dim=-1)
    best = torch.gather(logits, -1, idx[:, None])[:, 0]
    both = torch.stack([best.to(torch.float32),
                        (idx + start).to(torch.float32)])
    every = shd._all_gather_dim(both[None], 0, mesh, "model")
    rank = torch.argmax(every[:, 0], dim=0)
    return every[:, 1].gather(0, rank[None])[0].to(torch.int64)
