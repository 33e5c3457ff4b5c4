"""The step functions: the train step, the prefill and decode steps for
every family (``models/zoo.py``), the training state and the serving
parameters.

Port of ``repro.launch.steps``.  The steps close over (ModelConfig,
HParams) and run eagerly on the device their tensors live on: on the card
every attention layer launches the attention kernel (forward; in training
its backward too) and every mamba layer the ``ssd_scan`` kernel (and its
backward).  Shardings, sharded state specs and the dry run are not ported
yet (ROADMAP Queue 1 item 12, ``launch/dryrun.py``): a ``policy``,
``seq_parallel`` or ``extra_rules`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint.ckpt import tree_items
from repro_torch.configs.base import ModelConfig
from repro_torch.models import zoo
from repro_torch.models.template import init_params, tree_map
from repro_torch.optim import adam

_ITEM_12 = "sharding is not ported yet: ROADMAP Queue 1 item 12"


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
    state in place); ``seq_parallel``, ``constrain_proj`` and
    ``extra_rules`` need a sharding policy and raise (item 12)."""
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
# state
# ---------------------------------------------------------------------------

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


def _leaves(tree) -> list:
    """A tree's leaves in the reference's flatten order (sorted keys)."""
    return [leaf for _, leaf in tree_items(tree)]


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def make_constrain(cfg, policy=None, grad_cast=False):
    """The residual-stream hook: None, or ``zoo.grad_cast_bf16`` with
    ``grad_cast``.  A sharding policy raises (item 12)."""
    if policy is not None:
        raise NotImplementedError(_ITEM_12)
    return zoo.grad_cast_bf16 if grad_cast else None


def _check_unsharded(hp: HParams, policy) -> None:
    if policy is not None or hp.seq_parallel or hp.constrain_proj \
            or hp.extra_rules:
        raise NotImplementedError(f"policy / seq_parallel / constrain_proj "
                                  f"/ extra_rules: {_ITEM_12}")


def loss_and_grads(cfg: ModelConfig, hp: HParams, params, batch):
    """(loss, gradient tree) of ``zoo.loss_fn`` at ``params`` (leaves of
    any float dtype; gradients in their dtypes): ``jax.value_and_grad`` of
    the reference's ``lf``."""
    constrain = make_constrain(cfg, None, grad_cast=hp.grad_cast)
    leaves = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    loss = zoo.loss_fn(cfg, leaves, batch, remat=hp.remat,
                       attn_impl=hp.attn_impl, vocab_chunk=hp.vocab_chunk,
                       aux_coef=hp.aux_coef, constrain=constrain)
    flat = _leaves(leaves)
    grads = torch.autograd.grad(loss, flat)
    by_id = {id(p): g for p, g in zip(flat, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], leaves)


def build_train_step(cfg: ModelConfig, hp: HParams, policy=None):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients (``accum`` microbatches summed in float32 and divided by
    ``accum``; with ``cast_once`` against a bf16 copy of the float32
    master, the gradients cast back to float32), then AdamW.  The update
    runs IN PLACE on ``state``'s tensors (``optim.adam.adamw_update_``: the
    reference's arithmetic without a second copy of params and moments, so
    a full-width state fits the card) and the same dict is returned with
    its step advanced.  metrics: loss, grad_norm and lr, 0-d tensors."""
    _check_unsharded(hp, policy)

    def train_step(state, batch):
        params = state["params"]
        if hp.cast_once:
            fwd = tree_map(lambda x: x.to(torch.bfloat16)
                           if x.dtype == torch.float32 else x, params)
        else:
            fwd = params
        step = int(state["step"])
        if hp.accum > 1:
            a = hp.accum
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in _leaves(params)]
            losses = []
            for i in range(a):
                mb = {k: v.reshape(a, v.shape[0] // a, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, g = loss_and_grads(cfg, hp, fwd, mb)
                for s, x in zip(gsum, _leaves(g)):
                    s.add_(x.to(torch.float32))
                losses.append(loss)
                del g
            grads = [g / a for g in gsum]
            del gsum
            loss = torch.stack(losses).mean()
        else:
            loss, g = loss_and_grads(cfg, hp, fwd, batch)
            grads = [x.to(torch.float32) for x in _leaves(g)]
            del g
        del fwd
        gnorm = adam.adamw_update_(hp.optimizer, _leaves(params), grads,
                                   {"mu": _leaves(state["opt"]["mu"]),
                                    "nu": _leaves(state["opt"]["nu"])},
                                   step)
        del grads
        state["step"] = torch.tensor(step + 1, dtype=torch.int32)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": adam.lr_at(hp.optimizer, step)}
        return state, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig, hp: HParams, policy=None):
    _check_unsharded(hp, policy)

    def prefill_step(params, batch):
        with torch.no_grad():
            return zoo.prefill(cfg, params, batch, attn_impl=hp.attn_impl)
    return prefill_step


def build_serve_step(cfg: ModelConfig, hp: HParams, policy=None):
    _check_unsharded(hp, policy)

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return zoo.decode_step(cfg, params, cache, tokens, pos)
    return serve_step


def serving_params(cfg: ModelConfig, hp: HParams, params) -> dict:
    """``params`` with every float32 leaf cast to ``hp.serve_dtype`` (the
    SSM's ``a_log``, ``d`` and ``dt_bias`` too): the concrete counterpart
    of the reference's ``serving_params_struct``.  ``init_params(...,
    dtype=hp.serve_dtype)`` draws the same tree without a float32 copy."""
    dt = getattr(torch, hp.serve_dtype)
    return tree_map(lambda a: a.to(dt) if a.dtype == torch.float32 else a,
                    params)
