"""The step functions: the train step, the prefill and decode steps for
every family (``models/zoo.py``), the training state and the serving
parameters, and their sharding specs.

Port of ``repro.launch.steps``.  The steps close over (ModelConfig,
HParams) and run eagerly on the device their tensors live on: on the card
every attention layer launches the attention kernel (forward; in training
its backward too) and every mamba layer the ``ssd_scan`` kernel (and its
backward).

Sharding (``policy``, a ``distributed.sharding.ShardingPolicy`` over a
mesh of ranks, one process each).  The specs (``param_specs``,
``state_specs``, ``batch_specs``, ``cache_specs``) are the reference's.
torch has no compiler that partitions a step the way XLA does, so a step
under a policy runs data-parallel with fully sharded storage:

* the state lives as DTensors at ``state_specs`` (``place_state``): each
  rank keeps its block of every parameter and moment;
* a step gathers each parameter whole (``sharding.full_tensor``, no copy
  where every axis it is sharded over has size 1) and runs the loss,
  forward and backward on this rank's rows of the batch (``batch_specs``:
  rows over the data axes, whole where they do not divide), so every
  kernel gets plain local tensors;
* over a "model" axis of more than one rank the attention heads and the
  dense MLPs' hidden units are split between its ranks
  (``distributed/tensor_parallel.py``: the attention kernel runs on the
  rank's heads); where that plan does not apply, the axis shards storage
  only and its ranks repeat the compute;
* the gradients are averaged over the data axes, their norm taken whole,
  and each rank updates its own block of parameters and moments.

The loss and the gradients are the unsharded step's up to summation
order: the loss is a mean over equal row blocks.  (A MoE layer's capacity
and aux loss follow the rows a rank holds.)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint.ckpt import tree_items
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.sharding import P, ShardingPolicy
from repro_torch.kernels.common import resolve_device
from repro_torch.models import zoo
from repro_torch.models.template import init_params, tree_map
from repro_torch.optim import adam


@dataclass(frozen=True)
class HParams:
    """Performance / behaviour knobs.

    ``attn_impl`` defaults to ``"pallas"``, the port's hand-written
    flash-attention kernels (``kernels/flash_attention.py``, differentiable
    through ``csrc/flash_attention_bwd.cu``): as ``use_pallas=None`` means
    "the port's kernels" on the INR path, the normal entry points on the
    card go through the kernels.  (The reference defaults to ``"flash"``.)
    ``"flash"`` is the blockwise plain tensor version, ``"flash_cvjp"`` the
    streaming backward (``models/flash_cvjp.py``).  ``serve_dtype`` is the
    parameters' dtype for serving.  The training fields are the
    reference's but for its ``donate`` (the train step always updates its
    state in place).  ``seq_parallel`` and ``extra_rules`` are folded into
    a step's policy where the policy leaves them unset (``_policy``);
    ``constrain_proj`` constrains the projection outputs under a policy
    (on a rank's local rows the constraint holds already)."""
    attn_impl: str = "pallas"        # pallas | flash | flash_cvjp
    serve_dtype: str = "bfloat16"
    remat: str = "dots"              # none | dots | full
    vocab_chunk: int = 0             # 0 = unchunked CE
    seq_parallel: bool = False
    accum: int = 1                   # gradient-accumulation microbatches
    cast_once: bool = False          # cast the f32 master to bf16 once a step
    constrain_proj: bool = False
    grad_cast: bool = False          # bf16 cotangent barrier per layer
    extra_rules: dict | None = None
    optimizer: adam.AdamWConfig = field(default_factory=adam.AdamWConfig)
    aux_coef: float = 0.01


# ---------------------------------------------------------------------------
# state / specs
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig, policy: ShardingPolicy):
    return shd.tree_specs(policy, zoo.model_template(cfg))


def state_specs(cfg: ModelConfig, policy: ShardingPolicy):
    pspec = param_specs(cfg, policy)
    return {"params": pspec,
            "opt": {"mu": pspec, "nu": pspec},
            "step": P()}


def init_state(cfg: ModelConfig, seed_or_generator, device=None) -> dict:
    """``{"params", "opt": {"mu", "nu"}, "step"}`` with the reference's
    layout: params drawn by ``init_params`` on ``device`` (CUDA unless
    ``"cpu"``), float32 moments of zeros, step a 0-d int32 tensor on the
    host."""
    params = init_params(zoo.model_template(cfg), seed_or_generator,
                         device=device)
    zeros = lambda t: tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), t)
    return {"params": params, "opt": {"mu": zeros(params),
                                      "nu": zeros(params)},
            "step": torch.zeros((), dtype=torch.int32)}


def abstract_state(cfg: ModelConfig, device=None) -> dict:
    """``init_state``'s tree with no values: every leaf ``torch.empty`` on
    ``device`` (CUDA unless ``"cpu"``), made on the active
    ``FakeTensorMode`` when one is (``launch/dryrun.py``), so nothing is
    allocated.  The step stays a real 0-d int32 host tensor, as
    ``init_state``'s: the train step reads it with ``int``.  The
    reference's ``abstract_state``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    device = resolve_device(device)
    params = _empty_params(zoo.model_template(cfg), device)
    zeros = lambda t: tree_map(lambda p: torch.empty(
        p.shape, dtype=torch.float32, device=p.device), t)
    with unset_fake_temporarily():
        step = torch.zeros((), dtype=torch.int32)
    return {"params": params, "opt": {"mu": zeros(params),
                                      "nu": zeros(params)},
            "step": step}


def _empty_params(template, device, dtype=None) -> dict:
    """The template's leaves as ``torch.empty`` on ``device``; float32
    leaves in ``dtype`` where it is given."""
    def leaf(s):
        dt = getattr(torch, s.dtype)
        if dtype is not None and dt == torch.float32:
            dt = dtype
        return torch.empty(s.shape, dtype=dt, device=device)
    return tree_map(leaf, template)


def serving_params_struct(cfg: ModelConfig, hp: HParams, device=None):
    """``serving_params``' tree with no values (float32 leaves in
    ``hp.serve_dtype``), as ``abstract_state`` makes it: the reference's
    ``serving_params_struct``."""
    return _empty_params(zoo.model_template(cfg), resolve_device(device),
                         getattr(torch, hp.serve_dtype))


def _spec_map(fn, *trees):
    """``fn`` over the leaves of a spec tree and trees of its shape."""
    if isinstance(trees[0], dict):
        return {k: _spec_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _to_shardings(mesh, spec_tree):
    """A spec tree -> a tree of ``NamedSharding`` (spec and placements over
    ``mesh``), as the reference's."""
    return _spec_map(lambda s: shd.NamedSharding(mesh, s), spec_tree)


def place_state(state: dict, cfg: ModelConfig, policy: ShardingPolicy):
    """``state`` (full tensors, the same on every rank) as DTensors at
    ``state_specs``: each rank keeps its block, no communication, and no
    copy where the block is the whole tensor.  ``step`` stays a host
    scalar."""
    specs = state_specs(cfg, policy)
    placed = _spec_map(lambda s, t: shd.distribute(t, s, policy.mesh),
                       {k: specs[k] for k in ("params", "opt")},
                       {k: state[k] for k in ("params", "opt")})
    return {**placed, "step": state["step"]}


_BATCH_LOGICAL = {
    "labels": ("batch", "seq"),
    "embeds": ("batch", "seq", "act_embed"),
    "image_embeds": ("batch", "image", "act_embed"),
    "pos": (),
}


def _batch_logical(key: str, kind: str):
    if key == "tokens":
        return ("batch",) if kind == "decode" else ("batch", "seq")
    return _BATCH_LOGICAL[key]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, policy: ShardingPolicy):
    structs = zoo.input_structs(cfg, shape)
    return {k: policy.act_spec(tuple(v.shape), _batch_logical(k, shape.kind))
            for k, v in structs.items()}


# --- decode cache logical axes (mirrors zoo.init_cache structure) ----------

def _kv_logical(cfg: ModelConfig, policy: ShardingPolicy, lead: int):
    model = policy.mesh.shape.get("model", 1)
    if cfg.n_kv_heads % model == 0:
        tail = ("batch", "seq_kv", "act_kv_heads", None)
    else:
        tail = ("batch", "seq_shard", None, None)
    return ("stack",) * lead + tail


def _cache_logical(cfg, policy, key: str, ndim: int):
    if key in ("k", "v", "xk", "xv"):
        return _kv_logical(cfg, policy, ndim - 4)
    if key == "conv":
        return ("stack",) * (ndim - 3) + ("batch", None, "ssm_conv")
    if key == "ssm":
        return ("stack",) * (ndim - 4) + ("batch", "ssm_heads", None, None)
    return (None,) * ndim


def cache_specs(cfg: ModelConfig, policy: ShardingPolicy, cache_tree):
    """PartitionSpec tree matching ``zoo.init_cache``'s tree."""
    def spec_for(key, leaf):
        return policy.act_spec(tuple(leaf.shape),
                               _cache_logical(cfg, policy, key, leaf.dim()))

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return spec_for(key, tree)
    return walk(cache_tree)


def _leaves(tree) -> list:
    """A tree's leaves in the reference's flatten order (sorted keys)."""
    return [leaf for _, leaf in tree_items(tree)]


def _spec_leaves(tree) -> list:
    """A spec tree's PartitionSpecs in ``_leaves``' order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _spec_leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _policy(hp: HParams, policy):
    """``policy`` with ``hp.seq_parallel`` / ``hp.extra_rules`` where it
    leaves them unset (None without a policy)."""
    if policy is None:
        return None
    return dataclasses.replace(
        policy, seq_parallel=policy.seq_parallel or hp.seq_parallel,
        extra_rules=policy.extra_rules or hp.extra_rules)


def make_constrain(cfg, policy=None, grad_cast=False):
    """The residual-stream hook: None, ``zoo.grad_cast_bf16`` with
    ``grad_cast`` alone, or under a policy a function that lays a DTensor
    out at the activation spec ("batch", "seq", "act_embed") with a
    ``redistribute`` (the reference's ``with_sharding_constraint``; a
    plain tensor is a rank's local block and passes unchanged), then casts
    the cotangent with ``grad_cast``.  Its ``placements`` attribute names
    the layout."""
    if policy is None:
        return zoo.grad_cast_bf16 if grad_cast else None
    from torch.distributed.tensor import DTensor
    spec = policy.act_spec((0, 0, 0), ("batch", "seq", "act_embed"))
    where = shd.placements(spec, policy.mesh)

    def constrain(x):
        if isinstance(x, DTensor):
            x = x.redistribute(policy.mesh.device_mesh, where)
        if grad_cast:
            x = zoo.grad_cast_bf16(x)
        return x
    constrain.placements = where
    return constrain


def loss_and_grads(cfg: ModelConfig, hp: HParams, params, batch,
                   constrain=None, tp=None):
    """(loss, gradient tree) of ``zoo.loss_fn`` at ``params`` (leaves of
    any float dtype; gradients in their dtypes): ``jax.value_and_grad`` of
    the reference's ``lf``.  ``constrain``: the residual-stream hook, by
    default ``make_constrain(cfg, None, hp.grad_cast)``; ``tp``: the
    tensor-parallel hooks (``zoo.forward``)."""
    if constrain is None:
        constrain = make_constrain(cfg, None, grad_cast=hp.grad_cast)
    leaves = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    loss = zoo.loss_fn(cfg, leaves, batch, remat=hp.remat,
                       attn_impl=hp.attn_impl, vocab_chunk=hp.vocab_chunk,
                       aux_coef=hp.aux_coef, constrain=constrain, tp=tp)
    flat = _leaves(leaves)
    # a leaf the loss does not use (the token table of a model fed
    # embeddings) gets zeros, as jax.value_and_grad gives it
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    by_id = {id(p): g for p, g in zip(flat, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], leaves)


def _step_grads(cfg, hp, params, batch, constrain=None, tp=None):
    """(loss, float32 gradients in ``_leaves`` order) of one step's batch:
    ``accum`` microbatches summed in float32 and divided by ``accum``;
    with ``cast_once`` against a bf16 copy of the float32 master."""
    if hp.cast_once:
        fwd = tree_map(lambda x: x.to(torch.bfloat16)
                       if x.dtype == torch.float32 else x, params)
    else:
        fwd = params
    if hp.accum > 1:
        a = hp.accum
        gsum = [torch.zeros(p.shape, dtype=torch.float32,
                            device=p.device) for p in _leaves(params)]
        losses = []
        for i in range(a):
            mb = {k: v.reshape(a, v.shape[0] // a, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, g = loss_and_grads(cfg, hp, fwd, mb, constrain, tp)
            for s, x in zip(gsum, _leaves(g)):
                s.add_(x.to(torch.float32))
            losses.append(loss)
            del g
        grads = [g / a for g in gsum]
        del gsum
        return torch.stack(losses).mean(), grads
    loss, g = loss_and_grads(cfg, hp, fwd, batch, constrain, tp)
    return loss, [x.to(torch.float32) for x in _leaves(g)]


def _local(t):
    """A DTensor's local block (sharing its storage); a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _local_batch(policy: ShardingPolicy, batch: dict, kind: str):
    """(this rank's rows of ``batch``, the mesh axes the rows are split
    over).  A plain leaf is the full batch, its rows split as
    ``batch_specs`` splits them (whole where the axes do not divide the
    rows; the other dims whole: a rank computes whole sequences); a
    DTensor leaf is already split and gives its local block."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = policy.mesh
    out, axes = {}, []
    for k, v in batch.items():
        if isinstance(v, DTensor):
            out[k] = v.to_local()
            got = [a for a, p in zip(mesh.axis_names, v.placements)
                   if isinstance(p, Shard) and p.dim == 0
                   and mesh.shape[a] > 1]
        else:
            spec = policy.act_spec(tuple(v.shape), _batch_logical(k, kind))
            rows = P(spec[0]) if spec and spec[0] is not None else P()
            out[k] = shd.local_shard(v, rows, mesh)
            got = shd.sharded_axes(rows, mesh)
        if got:
            axes = got
    return out, axes


def _rows_spec(dim: int, axes) -> P:
    return P(*([None] * dim + [tuple(axes)]))


def _step_of(state) -> int:
    """The step counter, a real 0-d host tensor, as an int: read outside
    any ``FakeTensorMode`` (``launch/dryrun.py`` traces the step on one)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return int(state["step"])


def build_train_step(cfg: ModelConfig, hp: HParams, policy=None):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients (``_step_grads``), then AdamW.  The update runs IN PLACE on
    ``state``'s tensors (``optim.adam.adamw_update_``: the reference's
    arithmetic without a second copy of params and moments, so a
    full-width state fits the card) and the same dict is returned with its
    step advanced.  metrics: loss, grad_norm and lr, 0-d tensors.

    Under ``policy`` (module docstring): ``state`` as ``place_state``
    gives it (plain full tensors work too), ``batch`` the full batch on
    every rank or DTensors at ``batch_specs``; every rank returns the same
    metrics and updates its own blocks."""
    policy = _policy(hp, policy)
    constrain = make_constrain(cfg, policy, grad_cast=hp.grad_cast)

    def finish(state, params, grads, loss, step, opt, gnorm=None):
        gnorm = adam.adamw_update_(hp.optimizer, params, grads, opt, step,
                                   gnorm=gnorm)
        state["step"] = torch.tensor(step + 1, dtype=torch.int32)
        return state, {"loss": loss, "grad_norm": gnorm,
                       "lr": adam.lr_at(hp.optimizer, step)}

    if policy is None:
        def train_step(state, batch):
            params = state["params"]
            step = _step_of(state)
            loss, grads = _step_grads(cfg, hp, params, batch)
            return finish(state, _leaves(params), grads, loss, step,
                          {"mu": _leaves(state["opt"]["mu"]),
                           "nu": _leaves(state["opt"]["nu"])})
        return train_step

    mesh = policy.mesh
    specs = _spec_leaves(param_specs(cfg, policy))
    tp = tensor_parallel.plan(cfg, policy)

    def train_step(state, batch):
        step = _step_of(state)
        full = tree_map(shd.full_tensor, state["params"])
        local, dp = _local_batch(policy, batch, "train")
        if tp is None:
            loss, grads = _step_grads(cfg, hp, full, local, constrain)
        else:
            loss, grads = _step_grads(tp.cfg, hp, tp.localize(full), local,
                                      constrain, tp.hooks)
            grads = tp.assemble(full, grads)
        del full, local
        n_dp = 1
        for a in dp:
            n_dp *= mesh.shape[a]
        if n_dp > 1:
            loss = shd.all_reduce_axes(loss.clone(), mesh, dp) / n_dp
            for g in grads:
                shd.all_reduce_axes(g, mesh, dp).div_(n_dp)
        gnorm = adam.global_norm(grads)
        grads = [shd.local_shard(g, s, mesh) for g, s in zip(grads, specs)]
        own = lambda tree: [_local(t) for t in _leaves(tree)]
        return finish(state, own(state["params"]), grads, loss, step,
                      {"mu": own(state["opt"]["mu"]),
                       "nu": own(state["opt"]["nu"])}, gnorm)

    return train_step


def build_prefill_step(cfg: ModelConfig, hp: HParams, policy=None):
    """``prefill_step(params, batch) -> (last logits, cache)``.  Under
    ``policy`` each rank prefills its rows of the batch with the whole
    parameters and every rank returns the whole logits and cache (an
    all-gather of the rows)."""
    policy = _policy(hp, policy)

    def prefill_step(params, batch):
        with torch.no_grad():
            if policy is None:
                return zoo.prefill(cfg, params, batch,
                                   attn_impl=hp.attn_impl)
            mesh = policy.mesh
            full = tree_map(shd.full_tensor, params)
            local, dp = _local_batch(policy, batch, "prefill")
            logits, cache = zoo.prefill(cfg, full, local,
                                        attn_impl=hp.attn_impl)
            if not dp:
                return logits, cache
            rows = lambda key, t: shd.gather(
                t, _rows_spec(_cache_batch_dim(cfg, policy, key, t), dp),
                mesh)
            return (shd.gather(logits, _rows_spec(0, dp), mesh),
                    _cache_map(rows, cache))
    return prefill_step


def _cache_batch_dim(cfg, policy, key: str, t) -> int:
    return _cache_logical(cfg, policy, key, t.dim()).index("batch")


def _cache_map(fn, tree, key=""):
    if isinstance(tree, dict):
        return {k: _cache_map(fn, v, k) for k, v in tree.items()}
    return fn(key, tree)


def build_serve_step(cfg: ModelConfig, hp: HParams, policy=None):
    """``serve_step(params, cache, tokens, pos) -> (next tokens, cache)``,
    the cache written in place.  Under ``policy`` each rank decodes its
    rows of ``tokens`` with the whole parameters, writing its rows of the
    (whole, per-rank) cache; the rows are then all-gathered, so every rank
    returns the whole next tokens and holds the whole cache."""
    policy = _policy(hp, policy)

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            if policy is None:
                return zoo.decode_step(cfg, params, cache, tokens, pos)
            mesh = policy.mesh
            full = tree_map(shd.full_tensor, params)
            spec = policy.act_spec(tuple(tokens.shape), ("batch",))
            dp = shd.sharded_axes(spec, mesh) if spec else []
            if not dp:
                return zoo.decode_step(cfg, full, cache, tokens, pos)
            rows = lambda key, t: _rows_spec(
                _cache_batch_dim(cfg, policy, key, t), dp)
            mine = _cache_map(lambda key, t: shd.local_shard(
                t, rows(key, t), mesh), cache)
            nxt, _ = zoo.decode_step(cfg, full, mine,
                                     shd.local_shard(tokens, spec, mesh),
                                     pos)
            _cache_map(lambda key, t: t.copy_(shd.gather(
                shd.local_shard(t, rows(key, t), mesh), rows(key, t),
                mesh)), cache)
            return shd.gather(nxt, spec, mesh), cache
    return serve_step


def serving_params(cfg: ModelConfig, hp: HParams, params) -> dict:
    """``params`` with every float32 leaf cast to ``hp.serve_dtype`` (the
    SSM's ``a_log``, ``d`` and ``dt_bias`` too): the concrete counterpart
    of the reference's ``serving_params_struct``.  ``init_params(...,
    dtype=hp.serve_dtype)`` draws the same tree without a float32 copy."""
    dt = getattr(torch, hp.serve_dtype)
    return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32 else a,
                    params)
