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
``state_specs``, ``batch_specs``, ``cache_specs``) are the reference's,
and every sharded step keeps its state at them, as the reference's
``jax.jit`` does: each rank holds its own blocks.  In training and
prefill a tensor is whole only for the one layer that uses it, while
that layer runs; the decode step never gathers a parameter.

* The state lives as DTensors at ``state_specs`` (``place_state``): each
  rank keeps its block of every parameter and moment.  A train or
  prefill step hands the model the rank's blocks (plain local tensors)
  and a ``gather`` hook
  (``distributed/tensor_parallel.BlockGather``) that ``models/zoo.py``
  runs inside each layer's (recomputed) function: an all-gather of the
  layer's blocks over the axes their specs shard (``_c10d_functional``
  ``all_gather_into_tensor``; nothing where every such axis has size 1).
  The embedding, final norm and head are gathered where they are used.
* Every sharded step, in every family, keeps the blocks the specs shard
  over "model" of the vocab and of the MoE experts the rank's own
  (``tensor_parallel.ModelSplit``), in training and prefill gathered
  over the data axes alone:
  the embedding looks up the rank's rows of the table and sums the
  lookups over "model"; the head computes the rank's columns of the
  logits; a MoE layer runs the rank's E/m experts (and shared experts'
  hidden units) on every token's rows routed to them and sums the
  partial outputs over "model" (expert parallelism, ``layers.moe_ffn``);
  a mamba layer runs the rank's nh/m heads (``layers.mamba_layer``: its
  columns of ``wz`` / ``wx`` / ``wdt`` and rows of ``wo``, ``ssd_scan`` on
  [B·nh/m, nc, p, n]; its input's gradient and its output summed over
  "model", its gated norm's sum of squares all-reduced).  A leaf whose
  spec leaves it whole over "model" (a vocab, an expert count or mamba
  heads the axis does not divide) is computed whole.
* Train: the rows of the batch split over the data axes (``batch_specs``;
  whole where they do not divide).  The cross entropy merges the ranks'
  log-sum-exps over "model" and takes each label's logit from the rank
  that holds its column; the logits' gradient is the rank's columns'.
  Over a "model" axis of more than one rank the attention heads split
  where the axis divides them and the dense MLPs' hidden units wherever
  it divides ``d_ff`` (``tensor_parallel.plan``: the attention kernel
  runs on the rank's heads; Megatron's all-reduces of the split blocks'
  outputs and input gradients); a block that does not split is computed
  whole by every rank of the axis, which shards its storage.  The
  backward of each gather takes the whole gradient back into the block:
  a reduce-scatter over the data axes (an all-reduce for a leaf they do
  not shard), a slice over the axes whose ranks computed the same.  The
  block gradients are averaged over the data axes; the global norm is a
  sum of squares over the rank's blocks all-reduced over every axis, a
  leaf replicated over an axis counted once; AdamW updates the blocks in
  place.
* Sequence parallelism (``seq_parallel``, whose ``batch_specs`` split
  the sequence over "model"; a plain full batch is split the same way):
  each rank runs the residual stream of its rows and sequence block
  (``_local_batch``, ``tensor_parallel.SeqParallel``); the split blocks'
  ``into`` all-gathers the sequence and their ``out`` reduce-scatters
  the partial outputs (Megatron's sequence parallelism), the attention
  always sees the whole sequence, and the loss and gradients are the
  unsplit step's.  The reference's ``seq_parallel`` only lays its
  activations out so; the loss does not change.
* Prefill: the rank's rows (and, under ``seq_parallel``, its sequence
  block, as in training), the attention heads split over "model" where
  the cache's kv heads split over it and the dense MLPs' hidden units
  wherever the axis divides them (``tensor_parallel.serving_split``).
  It allocates only the rank's blocks of the cache
  and returns the cache as DTensors at ``cache_specs``: rows over the
  data axes, kv heads over "model" where they divide it, else the
  sequence; mamba states' heads and conv channels over "model".  Where
  the mamba heads split, a rank's SSM state block is its heads' state,
  which it computes and writes as it is.  The conv cache's blocks over
  "model" are (di + 2n)/m contiguous channels, which do not line up with
  a rank's x channels: the rank all-gathers each layer's new x rows
  [B_local, 3, di/m] over "model", puts the B / C rows it computed
  itself beside them, and writes its spec block of that (one small
  all-gather a layer; a write of exactly the spec block needs the other
  ranks' rows of it).  The last logits, the rank's columns, are
  all-gathered whole (they are small).
* Decode is weight-stationary (``tensor_parallel.Stationary``; Pope et
  al., "Efficiently Scaling Transformer Inference", §3.2.2): no
  collective carries a parameter block or a cache block.  The residual
  stream is [B, 1, D_blk] on every rank: every row of the batch (the
  tokens come whole) and the rank's block of ``d_model`` over the data
  axes, the block the
  parameters' ``*_fsdp`` dims hold.  Each norm all-reduces its float32
  sum of squares over the data axes.  A product with a leaf whose input
  dim is ``d_model`` (q, k, v, an MLP's ``wi`` / ``wg``, the router, the
  experts' ``wi`` / ``wg``, the mamba projections, the head) gives
  float32 partial sums over the data axes: q, k, v and the mamba
  projections are reduce-scattered to the rank's rows (the cache's rows)
  in one op a layer, the others all-reduced, each rounded once.  Where
  the attention or a mamba layer runs whole over "model" although its
  specs split its columns, the rank's columns of its rows are
  all-gathered over "model".  A product whose output dim is ``d_model``
  (``o``, an MLP's and the mamba ``wo``) takes its input's rank rows
  all-gathered over the data axes and the columns of its block; where
  its rows split over "model", its partial outputs are all-reduced over
  "model" in the compute dtype, as in prefill (a MoE layer sums its
  experts' combined rows and its shared experts' output in one float32
  all-reduce).  The embedding looks up the rank's
  block (summed over "model" where the vocab splits); the head gives
  float32 partial logits of the rank's columns, all-reduced over the
  data axes, and the next token is their argmax merged over "model"
  (each rank's largest logit and its index all-gathered, the lowest
  index on ties), the same on every rank.  The cache stays at
  ``cache_specs`` and each rank writes only its blocks: heads split as
  in prefill; where the cache's sequence splits, each rank attends over
  its positions (``layers.decode_attention(..., offset=, with_lse=True)``)
  and the ranks' parts merge over "model" by their log-sum-exp, and only
  the rank that holds ``pos`` writes the token's k and v.  A mamba
  layer's SSM state (its heads' under the head split) and conv rows (its
  block of the channels) are read and written in place; where the conv
  channels split over "model" each rank convolves its block and the
  results are all-gathered.  On a mesh whose every axis has one rank
  every product is the unsharded step's and nothing moves.

The loss and the gradients are the unsharded step's up to summation
order: the loss is a mean over equal row blocks.  A MoE layer groups the
tokens of the whole batch (``_Rows``: where a group spans ranks, the
ranks' expert choices are all-gathered for the queue positions), and its
aux loss is the whole batch's: the expert counts and the gates' sums are
all-reduced over the data axes the rows split over (``_Rows.psum``).
Every data rank then adds the same aux term to its loss, and the step
sums the ranks' gradients and divides them by ``n_dp``; so the
all-reduce's backward all-reduces the gradient too
(``tensor_parallel.psum``): each rank's gradient of its own gates is
counted ``n_dp`` times, and after the division once, as in the unsharded
step.
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


def place(tree, specs, mesh):
    """``tree`` (full tensors, the same on every rank: parameters, a
    batch, a decode cache) as DTensors at ``specs``: each rank keeps its
    blocks, no communication, and no copy where a block is the whole
    tensor."""
    return _spec_map(lambda s, t: shd.distribute(t, s, mesh), specs, tree)


def place_state(state: dict, cfg: ModelConfig, policy: ShardingPolicy):
    """``state`` (full tensors) placed at ``state_specs``; ``step`` stays
    a host scalar."""
    specs = state_specs(cfg, policy)
    placed = place({k: state[k] for k in ("params", "opt")},
                   {k: specs[k] for k in ("params", "opt")}, policy.mesh)
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


def layer_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    """(whole shape, spec) of every parameter leaf with its stacked dims
    dropped, by its path within its layer (a top-level leaf by its name):
    the table ``tensor_parallel.BlockGather`` reads.  "stack" dims are
    never sharded, so a layer's spec is its stacked leaf's spec without
    them."""
    out = {}
    for path, ps in tree_items(zoo.model_template(cfg)):
        k = 0
        while k < len(ps.logical) and ps.logical[k] == "stack":
            k += 1
        key = path if k == 0 else path[1:] if path[0] == "layers" \
            else path[2:]
        shape = tuple(ps.shape[k:])
        out[key] = (shape, policy.spec(shape, ps.logical[k:]))
    return out


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
    plain tensor is a rank's local block and passes unchanged: the
    sharded steps hold the spec's block already, the rank's rows and,
    under ``seq_parallel``, its block of the sequence), then casts the
    cotangent with ``grad_cast``.  Its ``placements`` attribute names the
    layout."""
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
                   constrain=None, tp=None, gather=None, rows=None,
                   split=None, seq=None):
    """(loss, gradient tree) of ``zoo.loss_fn`` at ``params`` (leaves of
    any float dtype; gradients in their dtypes): ``jax.value_and_grad`` of
    the reference's ``lf``.  ``constrain``: the residual-stream hook, by
    default ``make_constrain(cfg, None, hp.grad_cast)``; ``tp``,
    ``gather``, ``rows``, ``split`` and ``seq``: a sharded step's splits
    and hooks (``zoo.forward``), ``params`` then the rank's blocks."""
    if constrain is None:
        constrain = make_constrain(cfg, None, grad_cast=hp.grad_cast)
    leaves = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    loss = zoo.loss_fn(cfg, leaves, batch, remat=hp.remat,
                       attn_impl=hp.attn_impl, vocab_chunk=hp.vocab_chunk,
                       aux_coef=hp.aux_coef, constrain=constrain, tp=tp,
                       gather=gather, rows=rows, split=split, seq=seq)
    flat = _leaves(leaves)
    # a leaf the loss does not use (the token table of a model fed
    # embeddings) gets zeros, as jax.value_and_grad gives it
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    by_id = {id(p): g for p, g in zip(flat, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], leaves)


def _step_grads(cfg, hp, params, batch, constrain=None, tp=None,
                gather=None, rows=None, split=None, seq=None):
    """(loss, float32 gradients in ``_leaves`` order) of one step's batch:
    ``accum`` microbatches summed in float32 and divided by ``accum``;
    with ``cast_once`` against a bf16 copy of the float32 master (of the
    rank's blocks under ``gather``, so its gathers move bf16)."""
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
            loss, g = loss_and_grads(cfg, hp, fwd, mb, constrain, tp,
                                     gather, rows, split, seq)
            for s, x in zip(gsum, _leaves(g)):
                s.add_(x.to(torch.float32))
            losses.append(loss)
            del g
        grads = [g / a for g in gsum]
        del gsum
        return torch.stack(losses).mean(), grads
    loss, g = loss_and_grads(cfg, hp, fwd, batch, constrain, tp, gather,
                             rows, split, seq)
    return loss, [x.to(torch.float32) for x in _leaves(g)]


def _local(t):
    """A DTensor's local block (sharing its storage); a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _local_batch(policy: ShardingPolicy, batch: dict, kind: str):
    """(this rank's block of ``batch``, the mesh axes its rows are split
    over, whether its sequence is split over "model").  A plain leaf is
    the full batch, split as ``batch_specs`` splits its rows and, under
    ``seq_parallel``, its sequence (each whole where the axes do not
    divide it; the other dims whole); a DTensor leaf is already split and
    gives its local block.  Both feeds give one layout: the rank's rows,
    and under ``seq_parallel`` its block of the sequence, which the step
    runs as the residual stream's (``tensor_parallel.SeqParallel``), its
    layers seeing the whole sequence."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = policy.mesh
    out, axes, seq = {}, [], set()
    for k, v in batch.items():
        logical = _batch_logical(k, kind)
        if isinstance(v, DTensor):
            out[k] = v.to_local()
            split = {a: p.dim for a, p in zip(mesh.axis_names, v.placements)
                     if isinstance(p, Shard) and mesh.shape[a] > 1}
        else:
            spec = policy.act_spec(tuple(v.shape), logical)
            keep = 2 if logical[1:2] == ("seq",) else 1
            spec = P(*(tuple(spec) + (None,) * keep)[:keep])
            out[k] = shd.local_shard(v, spec, mesh)
            split = {a: d for a, d in shd.spec_dims(spec).items()
                     if mesh.shape[a] > 1}
        got = [a for a in mesh.axis_names if split.get(a) == 0]
        if got:
            axes = got
        if logical[1:2] == ("seq",):
            seq.add(tuple(a for a in mesh.axis_names if split.get(a) == 1))
    if not seq <= {(), ("model",)} or len(seq) > 1:
        raise ValueError(f"the batch's sequence splits over {sorted(seq)}: "
                         f"a sharded step splits it over \"model\" alone, "
                         f"in every leaf alike")
    return out, axes, seq == {("model",)}


def _rows_spec(dim: int, axes) -> P:
    return P(*([None] * dim + [tuple(axes)]))


class _Rows:
    """``zoo``'s ``rows`` hook (``layers.moe_ffn``): the model runs on
    this rank's rows of a batch whose rows split over the mesh ``axes``
    (none: the whole batch), ``n`` ranks' equal blocks, the rank's at
    ``index``; ``whole`` gathers a tensor over the rank's tokens (dim 0,
    rows major) from every block, in the batch's order; ``psum`` sums a
    tensor over the blocks, its gradient too
    (``tensor_parallel.psum``)."""

    def __init__(self, mesh, axes):
        self.mesh, self.spec = mesh, _rows_spec(0, axes)
        coord = mesh.coordinate()
        self.n, self.index, self.groups = 1, 0, []
        for a in mesh.axis_names:          # outer first, as local_shard
            if a in axes:
                self.n *= mesh.shape[a]
                self.index = self.index * mesh.shape[a] + coord[a]
                if mesh.shape[a] > 1:
                    self.groups.append(mesh.get_group(a))

    def whole(self, t):
        return shd.gather(t, self.spec, self.mesh)

    def psum(self, t):
        return tensor_parallel.psum(t, self.groups)


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
    gives it (plain full tensors work too: each rank then uses its block
    of them and updates it), ``batch`` the full batch on every rank or
    DTensors at ``batch_specs`` (one result either way, with or without
    ``seq_parallel``); every rank returns the same metrics and updates
    its own blocks."""
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
    pspecs = param_specs(cfg, policy)
    specs = _spec_leaves(pspecs)
    table = layer_specs(cfg, policy)
    tp = tensor_parallel.plan(cfg, policy)
    split = tensor_parallel.model_split(mesh, table)
    lcfg = cfg if tp is None else tp.cfg

    def train_step(state, batch):
        step = _step_of(state)
        params = _blocks(state["params"], pspecs, mesh)
        local, dp, sp = _local_batch(policy, batch, "train")
        seq = tensor_parallel.SeqParallel(mesh) if sp else None
        t, s = (tensor_parallel.with_seq(x, seq) for x in (tp, split))
        gather = tensor_parallel.BlockGather(mesh, table, dp, t, s, sp)
        loss, grads = _step_grads(lcfg, hp, params, local, constrain, t,
                                  gather, _Rows(mesh, dp), s, seq)
        del local, gather
        n_dp = 1
        for a in dp:
            n_dp *= mesh.shape[a]
        if n_dp > 1:
            loss = shd.all_reduce_axes(loss.clone(), mesh, dp) / n_dp
            for g in grads:
                g.div_(n_dp)
        gnorm = _global_norm(grads, specs, mesh)
        opt = {k: _leaves(_blocks(state["opt"][k], pspecs, mesh))
               for k in ("mu", "nu")}
        return finish(state, _leaves(params), grads, loss, step, opt, gnorm)

    return train_step


def _blocks(tree, spec_tree, mesh):
    """The rank's blocks of a parameter-shaped tree: a DTensor's local
    tensor, a plain full tensor's block at its spec (a view)."""
    from torch.distributed.tensor import DTensor
    return _spec_map(lambda s, t: t.to_local() if isinstance(t, DTensor)
                     else shd.local_shard(t, s, mesh), spec_tree, tree)


def _global_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of the whole gradients from the rank's blocks:
    sums of squares in float32 grouped by the mesh axes the blocks shard,
    each group summed over every axis of size > 1 with a group replicated
    over an axis counted once (the rank at coordinate 0 of that axis adds
    it).  Without such an axis, ``adam.global_norm``."""
    import torch.distributed as dist
    live = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    if not live:
        return adam.global_norm(grads)
    groups = {}
    for g, spec in zip(grads, specs):
        groups.setdefault(tuple(shd.sharded_axes(spec, mesh)), []).append(g)
    keys = sorted(groups)
    sums = torch.stack([sum(torch.sum(torch.square(t.float()))
                            for t in groups[k]) for k in keys])
    coord = mesh.coordinate()
    for a in live:
        keep = torch.tensor([float(a in k or coord[a] == 0) for k in keys],
                            device=sums.device)
        sums = sums * keep
        dist.all_reduce(sums, group=mesh.get_group(a))
    return torch.sqrt(sums.sum())


# the dims of one layer's cache leaf, by key
_LAYER_DIMS = {"k": 4, "v": 4, "xk": 4, "xv": 4, "conv": 3, "ssm": 4}


def _tree_leaf_items(tree, key=""):
    """(leaf key, leaf) of a cache tree, in its own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaf_items(v, k)
    else:
        yield key, tree


class CacheLayout:
    """How a sharded serve step's decode cache splits over ``policy``'s
    mesh: ``cache_specs`` of a cache tree of the whole shapes (``cache``:
    DTensors, or ``zoo.init_cache(..., abstract=True)``), and the hooks
    ``zoo.prefill`` / ``zoo.decode_step`` take as ``layout``.  ``tp`` is
    the serving split (``tensor_parallel.serving_split``), None where
    nothing splits: the attention heads over "model" where the specs
    split the kv heads (``cfg`` then holds the rank's head counts, else
    the model's), the dense MLPs' hidden units wherever the axis divides
    them.  Mamba heads split over "model" where the specs split them
    (``split.heads``): the SSM state's block over "model" is then the
    rank's heads, read and written in place.  ``gather`` is the prefill's
    per-layer gather of parameter blocks, ``stationary`` the decode's
    weight-stationary hooks (``tensor_parallel.Stationary``) over the
    rows the cache's batch dim splits over."""

    def __init__(self, cfg: ModelConfig, policy: ShardingPolicy, cache):
        self.mesh = mesh = policy.mesh
        self.specs = cache_specs(cfg, policy, cache)
        self.shapes = {}        # key -> (whole layer shape, layer spec)
        for (key, leaf), (_, spec) in zip(_tree_leaf_items(cache),
                                          _tree_leaf_items(self.specs)):
            lead = leaf.dim() - _LAYER_DIMS[key]
            full = tuple(spec) + (None,) * (leaf.dim() - len(spec))
            self.shapes[key] = (tuple(leaf.shape[lead:]),
                                shd.only_axes(full[lead:], ("model",)))
        heads = "k" in self.shapes and shd.spec_dims(
            self.shapes["k"][1]).get("model") == 2
        self.tp = tensor_parallel.serving_split(cfg, policy, heads)
        self.cfg = cfg if self.tp is None else self.tp.cfg
        table = layer_specs(cfg, policy)
        self.split = tensor_parallel.model_split(mesh, table)
        self.heads = self.split is not None and self.split.heads is not None
        if self.heads and "ssm" in self.shapes:
            shape, spec = self.shapes["ssm"]
            if shd.block_of(mesh, spec, 1, shape[1]) != self.split.heads:
                raise ValueError(f"{cfg.name}: the SSM state's heads over "
                                 f"model ({spec}) are not the layers' "
                                 f"{self.split.heads}")
        self.gather = tensor_parallel.BlockGather(mesh, table, (), self.tp,
                                                  self.split)
        batch = next(iter(self.shapes.values()))[0][0]    # every leaf's dim 0
        self.stationary = tensor_parallel.Stationary(
            mesh, table, shd.sharded_axes(policy.act_spec(
                (batch,), ("batch",)), mesh))

    def _seq(self, key):
        """(first position, length) of the rank's block of a kv leaf's
        sequence, None where it is whole."""
        shape, spec = self.shapes[key]
        return shd.block_of(self.mesh, spec, 1, shape[1])

    def kv(self, key: str) -> dict:
        """``layers.attn_decode``'s keyword arguments for the layers whose
        cache leaf is ``key``: ``offset`` and ``merge`` where the
        sequence splits, none where it is whole."""
        seq = self._seq(key)
        return {} if seq is None else {"offset": seq[0],
                                       "merge": self.merge}

    def merge(self, out, lse):
        """The ranks' partial attention (float32 out [B, 1, H, D], lse
        [B, 1, H]) merged over "model": each part weighted by exp(lse)
        less the ranks' largest lse (a block masked throughout weighs 0);
        one all-reduce of the max, one of the weighted sums."""
        import torch.distributed as dist
        group = self.mesh.get_group("model")
        top = lse.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        w = torch.exp(lse - top)
        both = torch.cat([(out * w[..., None]).flatten(), w.flatten()])
        dist.all_reduce(both, group=group)
        n = out.numel()
        return both[:n].view(out.shape) / both[n:].view(w.shape)[..., None]

    def put(self, key: str, dst, value):
        """Write the rank's block of a layer's cache tensor ``value`` (the
        rank's rows; whole over "model" but for split kv heads, which are
        the rank's already; k and v from position 0, perhaps shorter than
        the cache; under the mamba split the state of the rank's heads and
        the conv rows of its channels, ``layers.mamba_layer``'s) into the
        layer's block ``dst``."""
        if key in zoo.KV_KEYS:
            seq = self._seq("xk" if key in ("xk", "xv") else "k")
            zoo.put_kv(dst, value, 0 if seq is None else seq[0])
            return
        if self.heads and key == "ssm":
            dst.copy_(value)
            return
        if self.heads and key == "conv":
            # the ranks' x channels all-gathered over "model", then the
            # B / C channels every rank computed: the whole conv rows
            n2 = value.shape[-1] - self.split.inner[1]
            xs = shd.gather(value[..., :-n2], P(None, None, "model"),
                            self.mesh)
            value = torch.cat([xs, value[..., -n2:]], dim=-1)
        dst.copy_(shd.local_shard(value, self.shapes[key][1], self.mesh))

    def empty(self, cache, device):
        """Zeros at the rank's blocks of ``cache``'s leaves (whole shapes),
        as DTensors at ``cache_specs``: nothing whole is allocated."""
        def leaf(spec, t):
            shape = shd.local_shard(torch.empty(t.shape, device="meta"),
                                    spec, self.mesh).shape
            return shd.from_block(torch.zeros(shape, dtype=t.dtype,
                                              device=device),
                                  spec, self.mesh, t.shape)
        return _spec_map(leaf, self.specs, cache)


def _check_placed(cache, layout: CacheLayout):
    """Raise unless every leaf of ``cache`` is a DTensor at
    ``layout.specs``."""
    from torch.distributed.tensor import DTensor
    for (key, t), (_, spec) in zip(_tree_leaf_items(cache),
                                   _tree_leaf_items(layout.specs)):
        want = shd.placements(spec, layout.mesh)
        if not isinstance(t, DTensor) or list(t.placements) != want:
            raise TypeError(
                f"cache leaf {key!r}: a sharded serve step takes the cache "
                f"as DTensors at cache_specs ({want}; steps.place or the "
                f"sharded prefill), got "
                f"{getattr(t, 'placements', type(t).__name__)}")


def _prompt(batch) -> tuple[int, int, torch.device]:
    """(rows, length, device) of a prefill batch."""
    t = batch["embeds"] if "embeds" in batch else batch["tokens"]
    return t.shape[0], t.shape[1], t.device


def build_prefill_step(cfg: ModelConfig, hp: HParams, policy=None):
    """``prefill_step(params, batch, cache_len=None) -> (last logits,
    cache)``; ``cache_len`` is the cache's length, by default the
    prompt's (a longer cache leaves room for decode).  Under ``policy``
    (module docstring) each rank prefills its rows of the batch with its
    parameter blocks gathered a layer at a time and returns its blocks of
    the cache as DTensors at ``cache_specs``; every rank returns the
    whole logits."""
    policy = _policy(hp, policy)
    pspecs = None if policy is None else param_specs(cfg, policy)

    def prefill_step(params, batch, cache_len=None):
        with torch.no_grad():
            B, S, device = _prompt(batch)
            length = S if cache_len is None else cache_len
            if policy is None:
                cache = None if cache_len is None else zoo.init_cache(
                    cfg, B, length, device=device)
                return zoo.prefill(cfg, params, batch,
                                   attn_impl=hp.attn_impl, cache=cache)
            mesh = policy.mesh
            shapes = zoo.init_cache(cfg, B, length, abstract=True)
            layout = CacheLayout(cfg, policy, shapes)
            blocks = _blocks(params, pspecs, mesh)
            cache = layout.empty(shapes, _leaves(blocks)[0].device)
            local, dp, sp = _local_batch(policy, batch, "prefill")
            seq = tensor_parallel.SeqParallel(mesh) if sp else None
            logits, _ = zoo.prefill(
                layout.cfg, blocks, local, attn_impl=hp.attn_impl,
                gather=layout.gather,
                tp=tensor_parallel.with_seq(layout.tp, seq),
                cache=tree_map(_local, cache), layout=layout,
                rows=_Rows(mesh, dp),
                split=tensor_parallel.with_seq(layout.split, seq), seq=seq)
            if dp:
                logits = shd.gather(logits, _rows_spec(0, dp), mesh)
            return logits, cache
    return prefill_step


def build_serve_step(cfg: ModelConfig, hp: HParams, policy=None):
    """``serve_step(params, cache, tokens, pos) -> (next tokens, cache)``,
    the cache written in place.  Under ``policy`` (module docstring) the
    cache is DTensors at ``cache_specs`` (the sharded prefill's, or
    ``place``; anything else raises) and ``tokens`` the whole batch's on
    every rank: each rank multiplies with the parameter blocks it holds
    and moves only activations (weight-stationary), writes only its
    cache blocks and returns the whole next tokens."""
    policy = _policy(hp, policy)
    pspecs = None if policy is None else param_specs(cfg, policy)
    layouts = {}            # whole leaf shapes -> CacheLayout

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            if policy is None:
                return zoo.decode_step(cfg, params, cache, tokens, pos)
            mesh = policy.mesh
            key = tuple(tuple(t.shape) for _, t in _tree_leaf_items(cache))
            if key not in layouts:
                layouts[key] = CacheLayout(cfg, policy, cache)
            layout = layouts[key]
            _check_placed(cache, layout)
            ws = layout.stationary
            blocks = _blocks(params, pspecs, mesh)
            nxt, _ = zoo.decode_step(layout.cfg, blocks,
                                     tree_map(_local, cache),
                                     tokens, pos, tp=layout.tp,
                                     layout=layout, split=layout.split,
                                     ws=ws)
            return nxt, cache
    return serve_step


def serving_params(cfg: ModelConfig, hp: HParams, params) -> dict:
    """``params`` with every float32 leaf cast to ``hp.serve_dtype`` (the
    SSM's ``a_log``, ``d`` and ``dt_bias`` too): the concrete counterpart
    of the reference's ``serving_params_struct``.  ``init_params(...,
    dtype=hp.serve_dtype)`` draws the same tree without a float32 copy."""
    dt = getattr(torch, hp.serve_dtype)
    return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32 else a,
                    params)
