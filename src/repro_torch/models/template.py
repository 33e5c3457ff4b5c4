"""Parameter templates: one declarative tree drives init and abstract shapes.

Port of ``repro.models.template``.  A model is described as a nested dict
of ``ParamSpec(shape, logical, init)``.  From the same template we derive:
  * real initialized params   (``init_params``)       - smoke tests, chip runs
  * shape-only params         (``abstract_params``)   - tensors on ``meta``
  * the parameter count       (``count_template_params``)

Leaves are drawn with the reference's rules (``_init_leaf``) from an
explicit ``torch.Generator``.  Its numbers are not ``jax.random``'s, so a
test that compares the two packages carries the reference's parameters
across (``models/zoo.py::params_from_jax``) instead of seeding both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from repro_torch.kernels.common import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]  # logical axis name per dim
    init: str = "normal"             # normal | zeros | ones | scaled | ssm_a
    scale: float = 1.0
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict (a ParamSpec or a
    tensor), keeping the keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _init_leaf(spec: ParamSpec, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    dtype = getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    kw = {"generator": gen, "dtype": torch.float32, "device": gen.device}
    # in place: a stacked expert leaf is tens of GB in float32
    if spec.init == "ssm_a":
        # A_log init: log of uniform [1, 16) as in mamba2
        u = torch.rand(spec.shape, **kw).mul_(15.0).add_(1.0)
        return u.log_().to(device=device, dtype=dtype)
    if spec.init == "normal":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        return torch.randn(spec.shape, **kw).mul_(std).to(device=device,
                                                          dtype=dtype)
    if spec.init == "scaled":
        return torch.randn(spec.shape, **kw).mul_(spec.scale).to(
            device=device, dtype=dtype)
    raise ValueError(spec.init)


def init_params(template, seed_or_generator, device=None,
                dtype=None) -> dict:
    """Draw every leaf of ``template`` in key order.

    ``seed_or_generator``: an int seeds a new generator on the target
    device (so the draw happens there); a ``torch.Generator`` draws on its
    own device and the leaves are moved to ``device``.  ``device=None``
    means CUDA (``kernels/common.py::resolve_device``).  ``dtype`` (a
    name): each float32 leaf is cast to it as it is drawn, the same values
    as casting the float32 tree afterwards (``launch.steps.serving_params``)
    without holding a float32 copy of the whole tree."""
    device = resolve_device(device)
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
    else:
        gen = torch.Generator(device=device).manual_seed(
            int(seed_or_generator))
    if dtype is not None:
        template = tree_map(lambda s: replace(s, dtype=dtype)
                            if s.dtype == "float32" else s, template)
    return tree_map(lambda s: _init_leaf(s, gen, device), template)


def abstract_params(template) -> dict:
    """The template's leaves as tensors on ``meta``: shapes and dtypes,
    no storage."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=getattr(torch,
                                                                 s.dtype),
                                          device="meta"), template)


def count_template_params(template) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(template))
