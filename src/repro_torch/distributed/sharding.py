"""Sharding policy: logical axes -> mesh partition specs (port of
``repro.distributed.sharding``).

Every parameter in the model zoo is declared with *logical* axis names
(e.g. ``("vocab", "embed")``).  This module maps logical names to mesh axes
(TP over "model", FSDP over the data axes, EP over "model" for experts) with
divisibility checks: a dim is only sharded if the mesh axis size divides it,
otherwise we fall back to the next candidate or replicate.  This is what lets
one policy serve 10 architectures with odd head counts / vocab sizes.

The policy's logic is the reference's, line for line.  What differs is the
mesh and what a spec turns into:

* ``make_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` with named
  dims over the process group that is up (one process per rank; the
  caller brings the group up, ``launch/mesh.py::init_process_group``), and
  wraps it in ``Mesh``, whose ``shape`` maps each axis name to its size as
  the reference's ``jax.sharding.Mesh.shape`` does.
* A ``PartitionSpec`` is a tuple of mesh-axis names, tuples of names or
  None, trailing Nones popped: it compares equal to the reference's ``P``.
* ``placements(spec, mesh)`` is the DTensor counterpart of the reference's
  ``named`` / ``tree_shardings``: one ``Shard(dim)`` / ``Replicate()`` per
  mesh dim.  A dim sharded over ("pod", "data") gets ``Shard(dim)`` on
  both, outer first, which lays the shards out as the reference does;
  ``NamedSharding`` pairs a spec with its mesh.
* ``local_shard`` / ``gather`` move between a full tensor and a rank's
  shard with plain tensors and explicit collectives; the kernels are
  always handed such local tensors, never a DTensor.
* ``gather_block`` is the pair a sharded step runs on a parameter block:
  an all-gather forward, a reduce-scatter of the whole gradient back into
  the block backward (``_c10d_functional`` ops).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# Candidate mesh axes per logical axis, in preference order.  "fsdp" is a
# pseudo-axis that expands to the batch axes of the mesh (("pod","data") on
# the multi-pod mesh, ("data",) on a single pod).
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    # embedding / unembedding
    "vocab": ("model",),
    "embed": ("fsdp",),          # d_model dim of embed table -> FSDP
    # attention
    "q_dim": ("model",),         # fused n_heads*head_dim
    "kv_dim": ("model",),        # fused n_kv*head_dim
    "o_in": ("model",),          # Wo input dim (row-parallel)
    "attn_fsdp": ("fsdp",),      # d_model dim of attention projections
    # mlp
    "ff": ("model",),
    "mlp_fsdp": ("fsdp",),
    # moe
    "experts": ("model",),       # expert parallelism
    "expert_ff": (),             # inner expert dim: keep whole per device
    "expert_fsdp": ("fsdp",),
    # mamba
    "ssm_inner": ("model",),
    "ssm_state": (),
    "ssm_heads": ("model",),
    "ssm_fsdp": ("fsdp",),
    # never shard
    "stack": (),                 # scanned-layer leading dim
    "tiny": (),                  # norms, biases, per-head scalars
    "conv_w": (),
}

# Activation logical axes
ACT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("fsdp",),
    # the multi-INR K axis (serve/multi_inr.py): stacked weight payloads of
    # a fleet of resident INRs — the large tensor at fleet scale.  Sharded
    # across the data axes first (each INR's weights are independent), the
    # model axis as fallback; rows stay per-shard-local (DESIGN.md §8).
    "inr": ("fsdp", "model"),
    "seq": (),                   # overridden to ("model",) under seq parallelism
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_vocab": ("model",),
    "head_dim": (),
    "image": (),
    # KV / SSM cache axes
    "stack": (),
    "seq_kv": (),                # default: cache seq unsharded
    "seq_shard": ("model",),     # fallback when kv heads don't divide |model|
    "ssm_heads": ("model",),
    "ssm_conv": ("model",),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (the
    dim split over all of them, outer first) or None (whole)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A named ``DeviceMesh``: ``shape`` maps axis name -> size (outer
    first), ``axis_names`` lists them; ``device_mesh`` is the torch mesh
    DTensors are placed on."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def get_group(self, name: str):
        return self.device_mesh.get_group(name)

    def coordinate(self) -> dict[str, int]:
        """This rank's index along each axis."""
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def make_mesh(axis_shapes, axis_names, *, device_type: str | None = None):
    """A ``Mesh`` of ``axis_shapes`` named ``axis_names`` over the process
    group that is up (its world size must equal the product).  The device
    type follows the group's backend: "cuda" under NCCL, else "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(launch/mesh.py::init_process_group)")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, tuple(axis_shapes),
                                 mesh_dim_names=tuple(axis_names)))


@dataclass(frozen=True)
class ShardingPolicy:
    """Resolves logical axes against a concrete mesh (anything whose
    ``shape`` maps axis name -> size)."""
    mesh: object
    seq_parallel: bool = False           # shard activations' seq dim over model
    extra_rules: dict | None = None      # overrides for perf experiments

    def _mesh_axes(self, logical: str, rules: dict[str, tuple[str, ...]]):
        if self.extra_rules and logical in self.extra_rules:
            cands = self.extra_rules[logical]
        else:
            cands = rules.get(logical, ())
        out: list = []
        for c in cands:
            if c == "fsdp":
                fsdp = tuple(a for a in ("pod", "data") if a in self.mesh.shape)
                if fsdp:
                    out.append(fsdp if len(fsdp) > 1 else fsdp[0])
            elif c in self.mesh.shape:
                out.append(c)
        return out

    def _axis_size(self, entry) -> int:
        if isinstance(entry, tuple):
            return math.prod(self.mesh.shape[a] for a in entry)
        return self.mesh.shape[entry]

    def spec(self, shape: tuple[int, ...], logical: tuple[str | None, ...],
             rules=None) -> PartitionSpec:
        """Build a PartitionSpec: shard each dim by the first candidate mesh
        axis (or axis tuple) that divides it and is not already used."""
        rules = rules or LOGICAL_RULES
        used: set[str] = set()
        parts: list = []
        for dim, name in zip(shape, logical):
            choice = None
            if name is not None:
                for cand in self._mesh_axes(name, rules):
                    flat = cand if isinstance(cand, tuple) else (cand,)
                    if used & set(flat):
                        continue
                    if dim % self._axis_size(cand) == 0:
                        choice = cand
                        used.update(flat)
                        break
            parts.append(choice)
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)

    def act_spec(self, shape, logical) -> PartitionSpec:
        rules = dict(ACT_RULES)
        if self.seq_parallel:
            rules["seq"] = ("model",)
        return self.spec(shape, logical, rules)


def tree_specs(policy: ShardingPolicy, template) -> dict:
    """Map a ParamSpec template tree -> PartitionSpec tree."""
    from repro_torch.models.template import tree_map
    return tree_map(lambda ps: policy.spec(ps.shape, ps.logical), template)


# ---------------------------------------------------------------------------
# specs -> placements, shards and gathers
# ---------------------------------------------------------------------------

def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_dims(spec) -> dict[str, int]:
    """mesh axis name -> the tensor dim it shards, for every axis ``spec``
    names."""
    return {a: d for d, entry in enumerate(spec) for a in _axes_of(entry)}


def placements(spec, mesh) -> list:
    """One ``Shard(dim)`` / ``Replicate()`` per mesh dim, outer first."""
    from torch.distributed.tensor import Replicate, Shard
    dims = spec_dims(spec)
    return [Shard(dims[a]) if a in dims else Replicate()
            for a in mesh.axis_names]


def sharded_axes(spec, mesh) -> list[str]:
    """The mesh axes of size > 1 that ``spec`` shards over, outer first."""
    dims = spec_dims(spec)
    return [a for a in mesh.axis_names if a in dims and mesh.shape[a] > 1]


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a view):
    each sharded mesh axis, outer first, splits its dim into equal
    blocks and keeps the one at this rank's coordinate."""
    dims = spec_dims(spec)
    coord = mesh.coordinate()
    for a in mesh.axis_names:
        if a in dims and mesh.shape[a] > 1:
            n = mesh.shape[a]
            d = dims[a]
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split over {a}={n}")
            size = t.shape[d] // n
            t = t.narrow(d, coord[a] * size, size)
    return t


def gather(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's ``local_shard``: an all-gather
    over each sharded mesh axis, innermost first (the inverse of
    ``local_shard``)."""
    import torch.distributed as dist
    dims = spec_dims(spec)
    for a in reversed(sharded_axes(spec, mesh)):
        n = mesh.shape[a]
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(a))
        t = torch.cat(parts, dim=dims[a])
    return t


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the reference's ``NamedSharding``):
    ``placements`` are its DTensor placements, ``device`` the device its
    blocks live on."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    @property
    def device(self) -> torch.device:
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def place(self, t: torch.Tensor):
        """``distribute`` of the full tensor ``t`` on this sharding's
        device."""
        return distribute(t.to(self.device), self.spec, self.mesh)


def distribute(t: torch.Tensor, spec, mesh):
    """A DTensor of the full tensor ``t`` (present on every rank) at
    ``spec``'s placements: each rank keeps its own block, no
    communication.  The block is ``t`` itself where it is the whole
    tensor, else a copy in storage of its own (a view would hold the
    whole of ``t`` alive on every rank)."""
    block = local_shard(t, spec, mesh)
    block = block.contiguous() if block.numel() == t.numel() else \
        block.clone(memory_format=torch.contiguous_format)
    return from_block(block, spec, mesh, t.shape)


def from_block(block: torch.Tensor, spec, mesh, shape):
    """A DTensor of global ``shape`` at ``spec`` whose local tensor on this
    rank is ``block`` (no communication, no copy)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(block, mesh.device_mesh, placements(spec, mesh),
                              run_check=False, shape=shape, stride=stride)


def full_tensor(x):
    """A DTensor's full value as a plain tensor: its local tensor where
    every mesh dim it is sharded over has size 1 (no copy), else the
    all-gather.  A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    sizes = x.device_mesh.mesh.shape
    if all(not isinstance(p, Shard) or sizes[i] == 1
           for i, p in enumerate(x.placements)):
        return x.to_local()
    return x.full_tensor()


def all_reduce_axes(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` summed IN PLACE over every mesh axis in ``axes`` of size > 1."""
    import torch.distributed as dist
    for a in axes:
        if mesh.shape.get(a, 1) > 1:
            dist.all_reduce(t, group=mesh.get_group(a))
    return t


def only_axes(spec, axes) -> PartitionSpec:
    """``spec`` with every mesh axis outside ``axes`` dropped (those dims
    whole)."""
    parts = []
    for entry in spec:
        kept = tuple(a for a in _axes_of(entry) if a in axes)
        parts.append(None if not kept else kept if len(kept) > 1
                     else kept[0])
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def block_of(mesh, spec, dim: int, size: int) -> tuple[int, int] | None:
    """(start, width) of this rank's block of a dim of ``size`` that
    ``spec`` splits over one mesh axis of size > 1 alone; None where the
    dim is whole or split over more than one such axis."""
    axes = [a for a in _axes_of(spec[dim] if dim < len(spec) else None)
            if mesh.shape[a] > 1]
    if len(axes) != 1:
        return None
    width = size // mesh.shape[axes[0]]
    return mesh.coordinate()[axes[0]] * width, width


def _fc():
    return torch.ops._c10d_functional


def _all_gather_dim(t, dim: int, mesh, axis: str):
    """The blocks of ``axis``' ranks concatenated along ``dim``."""
    x = t.movedim(dim, 0).contiguous()
    y = _fc().wait_tensor(_fc().all_gather_into_tensor(
        x, mesh.shape[axis], mesh.get_group(axis).group_name))
    return y.movedim(0, dim)


def _reduce_scatter_dim(t, dim: int, mesh, axis: str):
    """``t`` summed over ``axis``' ranks, each keeping its block of
    ``dim``."""
    x = t.movedim(dim, 0).contiguous()
    y = _fc().wait_tensor(_fc().reduce_scatter_tensor(
        x, "sum", mesh.shape[axis], mesh.get_group(axis).group_name))
    return y.movedim(0, dim)


def _narrow_rank(t, dim: int, mesh, axis: str):
    n = mesh.shape[axis]
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.coordinate()[axis] * size, size)


def _gather_axes(block, spec, mesh):
    """The whole tensor from its blocks: an all-gather over each sharded
    axis of size > 1, innermost first (as ``gather``)."""
    dims = spec_dims(spec)
    t = block
    for a in reversed(sharded_axes(spec, mesh)):
        t = _all_gather_dim(t, dims[a], mesh, a)
    return t


def _scatter_grad(g, spec, mesh, sum_axes):
    """The gradient of ``_gather_axes``' block from the whole gradient
    ``g``: over an axis in ``sum_axes`` summed (a reduce-scatter where the
    axis shards the block, an all-reduce where it does not), over the
    others the rank's slice (their ranks hold the same gradient).  Slices
    on dims no summed axis shares come first (fewer bytes to reduce);
    the rest go outermost first, the inverse of the gather's order."""
    dims = spec_dims(spec)
    live = sharded_axes(spec, mesh)
    summed = {dims[a] for a in live if a in sum_axes}
    first = [a for a in live if a not in sum_axes and dims[a] not in summed]
    for a in first:
        g = _narrow_rank(g, dims[a], mesh, a)
    for a in live:
        if a in first:
            continue
        g = (_reduce_scatter_dim if a in sum_axes else _narrow_rank)(
            g, dims[a], mesh, a)
    for a in sum_axes:
        if a not in live:
            g = _fc().wait_tensor(_fc().all_reduce(
                g.contiguous(), "sum", mesh.get_group(a).group_name))
    if g.untyped_storage().nbytes() > g.numel() * g.element_size():
        # a slice of the whole gradient: keep the block alone alive
        g = g.clone(memory_format=torch.contiguous_format)
    return g


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, spec, mesh, sum_axes):
        ctx.args = (spec, mesh, sum_axes)
        t = _gather_axes(block, spec, mesh)
        return t.view_as(t) if t is block else t

    @staticmethod
    def backward(ctx, g):
        return _scatter_grad(g, *ctx.args), None, None, None


def gather_block(block: torch.Tensor, spec, mesh, sum_axes=()):
    """The whole tensor of a rank's ``block`` of a tensor at ``spec``: an
    all-gather over each mesh axis of size > 1 that ``spec`` shards,
    innermost first.  Its backward takes the whole gradient back into the
    block: summed over the axes in ``sum_axes`` (the axes whose ranks
    computed different parts of it: a reduce-scatter where the axis shards
    the block, an all-reduce where it does not), the rank's slice over the
    other axes (their ranks computed the same gradient).  With nothing to
    gather or sum, ``block`` itself, no copy (as ``full_tensor``); outside
    autograd, the gather alone."""
    sums = tuple(a for a in sum_axes if mesh.shape.get(a, 1) > 1)
    if not sharded_axes(spec, mesh) and not sums:
        return block
    if not (torch.is_grad_enabled() and block.requires_grad):
        return _gather_axes(block, spec, mesh)
    return _GatherBlock.apply(block, spec, mesh, sums)
