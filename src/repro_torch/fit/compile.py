"""compile_fit — the fitting half of the pipeline front door (port of
``repro.fit.compile``, DESIGN.md §11).

Serving streams an INR's order-n gradient outputs block by block through
the SegmentPlan / FusedRegion schedule; fitting needs ∂/∂θ of a LOSS over
those same outputs.  ``CompiledFit`` reuses the serving artifact's block
pipeline and accumulates the loss gradient ONLINE, one block at a time, so
reverse mode only ever buffers ONE block's activations — peak memory
O(block x depth) — while the summed partials match the whole-grid gradient
up to float reassociation.

  * The per-block forward is the execution-unit walk the serving executor
    uses.  Segments run through the per-node interpreter (differentiable
    torch ops); fused regions run through ``kernels.region.region_grad_fn``,
    a ``torch.autograd.Function`` whose forward is ``region_call`` (the
    serving launch, bit for bit) and whose backward is ``region_bwd_call``
    (the ``csrc/region_bwd.cu`` kernel on the card).
  * Per-unit gradient checkpoint cuts (``regions.plan_fit_checkpoints``):
    a cut unit keeps only its boundary inputs and replays its forward on
    the backward sweep (``_checkpointed``), bit-invariant against the
    buffered unit.
  * The resident environment (weights and the tensors derived from them)
    is built ONCE per call from the trainable leaves under autograd.  Each
    block differentiates with respect to detached copies of the residents;
    their cotangents are summed over the blocks and pulled back through the
    resident environment once at the end.  The reference rebuilds the
    environment inside every block's gradient instead; both give the same
    sum up to float reassociation, and this one spends no per-block host
    time on the rebuild.

Trainable parameters are identified the ``bind_weights`` way: each Const
node equal to a template-params leaf maps to that leaf; unmatched Consts
(w0 scalars, cotangent seeds) stay fixed.  The gradient arrives in the
caller's own params tree, and ``payload()`` turns fitted leaves into an
``ArtifactStore.put_weights`` payload for serving.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import host_array, tree_items
from repro_torch.core.executor import (_eval_node, _run_segment,
                                       const_tensor, region_operands)
from repro_torch.core.regions import (fit_backward_bytes,
                                      plan_fit_checkpoints,
                                      unit_act_row_bytes)
from repro_torch.core.segment import INTERPRET
from repro_torch.fit.objectives import Objective


# ---------------------------------------------------------------------------
# params trees and trainable-const identification
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class TreeDef:
    """The structure of a params tree (nested dicts, lists, tuples): its
    leaf paths in ``tree_items`` order, and the tree itself as the template
    that ``unflatten`` fills."""
    paths: tuple
    template: object

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self.paths == other.paths

    def unflatten(self, leaves):
        it = iter(leaves)

        def build(t):
            if isinstance(t, dict):
                return {k: build(t[k]) for k in sorted(t)}
            if isinstance(t, (list, tuple)):
                return type(t)(build(v) for v in t)
            return None if t is None else next(it)

        return build(self.template)


def tree_flatten(tree):
    """``(leaves, TreeDef)`` of a params tree."""
    items = list(tree_items(tree))
    return ([v for _, v in items],
            TreeDef(paths=tuple(p for p, _ in items), template=tree))


def match_trainable(cg, params):
    """Map Const nodes to template-params leaves (the ``bind_weights``
    matching, run once at compile): returns ``(leaf_of, fixed, treedef,
    template_leaves)`` where ``leaf_of[nid]`` is the flat leaf index a Const
    trains against and ``fixed[nid]`` holds every architecture constant, on
    the artifact's device."""
    leaves, treedef = tree_flatten(params)
    arrs = [host_array(v) for v in leaves]
    leaf_of: dict[int, int] = {}
    fixed: dict[int, torch.Tensor] = {}
    for nid, n in cg.graph.nodes.items():
        if n.op != "Const":
            continue
        c = np.asarray(n.const)
        matches = [i for i, a in enumerate(arrs)
                   if a.shape == c.shape and a.dtype == c.dtype
                   and np.array_equal(a, c)]
        if not matches:
            fixed[nid] = const_tensor(n, cg.device)
        elif len(matches) == 1:
            leaf_of[nid] = matches[0]
        else:
            raise ValueError(
                f"Const node {nid} matches {len(matches)} identical template "
                f"leaves — trainable binding is ambiguous")
    if not leaf_of:
        raise ValueError("no template leaf appears as a Const of the traced "
                         "graph — params do not parameterize fn")
    template = [torch.as_tensor(a, device=cg.device) for a in arrs]
    return leaf_of, fixed, treedef, template


# ---------------------------------------------------------------------------
# the differentiable block pipeline
# ---------------------------------------------------------------------------

def _region_unit_fn(cg, region):
    """Differentiable twin of ``executor._run_region``: the same operand
    assembly (``region_operands``), dispatched through the cached
    differentiable region call."""
    from repro_torch.kernels.region import region_grad_fn
    plan, g = cg.plan, cg.graph
    block, B = cg.config.block, plan.batch
    out_info = tuple((g.nodes[o].shape[-1], g.nodes[o].dtype)
                     for o in region.outputs)
    call = region_grad_fn(region.spec, out_info)

    def run(res_env, env):
        stream, rows, residents, _ = region_operands(plan, region, env,
                                                     res_env, block, B)
        outs = call(*stream, *rows, *residents)
        return dict(zip(region.outputs, outs))

    return run


def _segment_unit_fn(cg, seg):
    """One segment through the per-node interpreter — plain torch ops, so
    autograd differentiates it (the CPU/default fit path)."""
    plan = cg.plan
    block, B = cg.config.block, plan.batch

    def run(res_env, env):
        out = _run_segment(plan, seg, INTERPRET, env, res_env, block, B)
        return {seg.output: out}

    return run


class _Recompute(torch.autograd.Function):
    """A unit whose forward keeps only its boundary inputs; the backward
    replays the unit under autograd and pulls the cotangents back through
    the replay — the same ops in the same order as the buffered unit's
    backward, so the two agree bit for bit."""

    @staticmethod
    def forward(ctx, fnu, res_keys, env_keys, out_keys, *flat):
        ctx.fnu, ctx.res_keys, ctx.env_keys = fnu, res_keys, env_keys
        ctx.save_for_backward(*flat)
        nr = len(res_keys)
        out = fnu(dict(zip(res_keys, flat[:nr])),
                  dict(zip(env_keys, flat[nr:])))
        out_keys.extend(out)
        ctx.out_keys = tuple(out)
        return tuple(out.values())

    @staticmethod
    def backward(ctx, *cts):
        flat = [t.detach().requires_grad_(t.requires_grad)
                for t in ctx.saved_tensors]
        nr = len(ctx.res_keys)
        with torch.enable_grad():
            out = ctx.fnu(dict(zip(ctx.res_keys, flat[:nr])),
                          dict(zip(ctx.env_keys, flat[nr:])))
            outs = [out[k] for k in ctx.out_keys]
        want = [i for i, t in enumerate(flat) if t.requires_grad]
        pairs = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
        grads = [None] * len(flat)
        if want and pairs:
            got = torch.autograd.grad([o for o, _ in pairs],
                                      [flat[i] for i in want],
                                      grad_outputs=[c for _, c in pairs],
                                      allow_unused=True)
            for i, gr in zip(want, got):
                grads[i] = gr
        return (None, None, None, None, *grads)


def _checkpointed(fnu):
    """Gradient checkpoint cut: ``fnu(res_env, env) -> {node: tensor}`` run
    so that only its boundary inputs are saved, its interior rebuilt on the
    backward sweep (``_Recompute``)."""
    def wrapped(res_env, env):
        out_keys: list = []
        outs = _Recompute.apply(fnu, tuple(res_env), tuple(env), out_keys,
                                *res_env.values(), *env.values())
        return dict(zip(out_keys, outs))

    return wrapped


def _make_fit_block_fn(cg, checkpoints):
    """``f(res_env, xblk) -> streamed outs`` over the artifact's execution
    units, with a recompute boundary around each cut unit."""
    plan, g = cg.plan, cg.graph
    units = _fit_units(cg)
    input_nodes = [g.nodes[i] for i in plan.inputs]
    streamed_outs = cg._streamed_outs
    cut = set(checkpoints)

    unit_fns = []
    for idx, (kind, u) in enumerate(units):
        fnu = (_region_unit_fn(cg, u) if kind == "region"
               else _segment_unit_fn(cg, u))
        needs = tuple(u.stream_inputs)
        if idx in cut:
            fnu = _checkpointed(fnu)
        unit_fns.append((fnu, needs))

    def block_fn(res_env, xblk):
        env = {n.id: xblk for n in input_nodes}
        for fnu, needs in unit_fns:
            sub = {nid: env[nid] for nid in needs if nid in env}
            env.update(fnu(res_env, sub))
        return tuple(env[o] for o in streamed_outs)

    return block_fn


def _fit_units(cg):
    """The execution-unit walk the fit pipeline shares with serving."""
    if cg.region_plan is not None and cg.config.use_pallas:
        return cg.region_plan.units()
    return [("seg", s) for s in cg.plan.segments]


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class CompiledFit:
    """A cached fitting artifact: the serving ``CompiledGradient`` plus a
    streamed loss-gradient program over it.

    ``value_and_grad(params, coords, targets)`` returns the mean loss over
    ``coords`` and its gradient in the caller's params tree — computed
    block by block with online accumulation, never materializing a
    per-grid activation tensor."""
    cg: object
    loss: Objective
    checkpoints: tuple[int, ...]
    leaf_of: dict[int, int]
    fixed: dict[int, torch.Tensor]
    treedef: TreeDef
    template_leaves: list
    meta: dict = field(default_factory=dict, compare=False)

    def __post_init__(self):
        g = self.cg.graph
        plan = self.cg.plan
        self.in_features = g.nodes[plan.inputs[0]].shape[-1]
        self.out_features = g.nodes[g.outputs[0]].shape[-1]
        self._block_fn = _make_fit_block_fn(self.cg, self.checkpoints)
        self._resident_order = [
            (nid, g.nodes[nid]) for nid in plan.resident_order()]

    # -- identity ----------------------------------------------------------
    @property
    def order(self) -> int:
        return self.cg.order

    @property
    def config(self):
        return self.cg.config

    @property
    def device(self) -> torch.device:
        return self.cg.device

    @property
    def signature(self) -> str:
        return self.cg.signature

    @property
    def n_trainable(self) -> int:
        return len(set(self.leaf_of.values()))

    # -- params plumbing ---------------------------------------------------
    def leaves_of(self, params) -> tuple:
        """The params tree's leaves as tensors on the artifact's device,
        detached from any autograd graph the caller's tensors carry."""
        leaves, treedef = tree_flatten(params)
        if treedef != self.treedef:
            raise ValueError(f"params leaves {treedef.paths} != compiled "
                             f"{self.treedef.paths}")
        return tuple(torch.as_tensor(v, device=self.device).detach()
                     for v in leaves)

    def unflatten(self, leaves):
        return self.treedef.unflatten(leaves)

    def payload(self, params) -> dict[int, np.ndarray]:
        """``ArtifactStore.put_weights`` payload for a fitted params tree:
        trained Consts from the leaves, architecture constants as-is."""
        leaves = self.leaves_of(params)
        out = {nid: host_array(leaves[i]) for nid, i in self.leaf_of.items()}
        out.update({nid: host_array(v) for nid, v in self.fixed.items()})
        return out

    # -- the streamed loss gradient ----------------------------------------
    def _res_env(self, leaves):
        """The resident environment from the trainable leaves, under
        autograd when they require grad (the MultiINRArtifact recompute)."""
        env: dict[int, torch.Tensor] = {}
        for nid, n in self._resident_order:
            if n.op == "Const":
                i = self.leaf_of.get(nid)
                env[nid] = leaves[i] if i is not None else self.fixed[nid]
            else:
                env[nid] = _eval_node(n, [env[i] for i in n.inputs],
                                      device=self.device).contiguous()
        return env

    def _blocked(self, coords, targets):
        """Coordinates, targets and a row mask as ``[n_blocks, block, ...]``,
        zero-padded to a block multiple, and the true row count."""
        block = self.config.block
        coords = torch.as_tensor(coords, device=self.device)
        N = coords.shape[0]
        cols = self.loss.target_cols(self.out_features, self.in_features)
        t = torch.as_tensor(targets, device=self.device,
                            dtype=torch.float32).reshape(N, cols)
        pad = (-N) % block
        if pad:
            coords = torch.cat([coords, coords.new_zeros(
                (pad,) + tuple(coords.shape[1:]))])
            t = torch.cat([t, t.new_zeros((pad, cols))])
        mask = (torch.arange(N + pad, device=self.device) < N).to(
            coords.dtype)
        nb = (N + pad) // block
        return (coords.reshape(nb, block, coords.shape[-1]),
                t.reshape(nb, block, cols), mask.reshape(nb, block), N)

    def value_and_grad(self, params, coords, targets):
        """Mean loss over the grid and its ∂/∂params — streamed: one block
        of activations live at a time, gradient partials accumulated over
        the blocks, one normalization at the end."""
        leaves = self.leaves_of(params)
        loss, gleaves = self._stream_vg(leaves, coords, targets)
        grads = [torch.zeros_like(l) for l in self.template_leaves]
        for i in sorted(set(self.leaf_of.values())):
            grads[i] = gleaves[i]
        return loss, self.unflatten(grads)

    def _stream_vg(self, leaves, coords, targets):
        """Flat-leaves core: ``(mean loss, grad per leaf)``."""
        xb, yb, mb, N = self._blocked(coords, targets)
        total, grads = self._sum_vg(leaves, xb, yb, mb)
        return total / N, tuple(g / N for g in grads)

    def _sum_vg(self, leaves, xb, yb, mb):
        """The sum over blocks of the masked row losses, and its gradient
        per leaf (zeros for a leaf no block reads)."""
        C, D = self.out_features, self.in_features
        with torch.enable_grad():
            lv = [l.detach().requires_grad_(l.is_floating_point())
                  for l in leaves]
            res_env = self._res_env(lv)
            trained = [nid for nid, v in res_env.items() if v.requires_grad]
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            acc: dict[int, torch.Tensor] = {}
            for b in range(xb.shape[0]):
                blk = dict(res_env)
                for nid in trained:
                    blk[nid] = res_env[nid].detach().requires_grad_(True)
                outs = self._block_fn(blk, xb[b])
                loss = torch.sum(self.loss.row_loss(outs, yb[b], C, D)
                                 * mb[b])
                if loss.requires_grad:
                    grads = torch.autograd.grad(
                        loss, [blk[nid] for nid in trained],
                        allow_unused=True)
                    for nid, gr in zip(trained, grads):
                        if gr is not None:
                            acc[nid] = gr if nid not in acc else acc[nid] + gr
                total = total + loss.detach()
            used = [nid for nid in trained if nid in acc]
            want = [i for i, l in enumerate(lv) if l.requires_grad]
            gl = [None] * len(lv)
            if used and want:
                got = torch.autograd.grad(
                    [res_env[nid] for nid in used], [lv[i] for i in want],
                    grad_outputs=[acc[nid] for nid in used],
                    allow_unused=True)
                for i, gr in zip(want, got):
                    gl[i] = gr
        return total, tuple(torch.zeros_like(l) if gr is None else gr
                            for gr, l in zip(gl, lv))

    # -- the memory model --------------------------------------------------
    def peak_bytes(self, n_rows: int | None = None) -> int:
        """Modeled peak fit memory.  ``n_rows=None`` — the STREAMED path:
        optimizer state (params, grads, Adam mu/nu) plus ONE block's
        backward-sweep buffering under the checkpoint cuts.  With
        ``n_rows`` — the whole-grid baseline: every unit's activations
        buffered for EVERY row, no cuts."""
        plan, cfg = self.cg.plan, self.config
        units = _fit_units(self.cg)
        param_bytes = sum(l.numel() * l.element_size()
                          for l in self.template_leaves)
        state = 4 * param_bytes            # params + grads + Adam mu/nu
        if n_rows is None:
            act = fit_backward_bytes(plan, units, cfg, self.checkpoints)
            rows = cfg.block
        else:
            act = n_rows * sum(unit_act_row_bytes(plan, k, u)
                               for k, u in units)
            rows = n_rows
        g = self.cg.graph
        io = rows * (np.dtype(g.nodes[plan.inputs[0]].dtype).itemsize
                     * self.in_features
                     + 4 * self.loss.target_cols(self.out_features,
                                                 self.in_features))
        return state + act + io

    def describe(self) -> str:
        units = _fit_units(self.cg)
        return (f"CompiledFit[{type(self.loss).__name__} order={self.order}] "
                f"{len(units)} units, {len(self.checkpoints)} checkpointed, "
                f"{self.n_trainable} trainable leaves, "
                f"peak_model={self.peak_bytes()}B")


# ---------------------------------------------------------------------------
# the front door (the cache lives in core.pipeline next to its siblings)
# ---------------------------------------------------------------------------

def _resolve_checkpoints(cg, checkpoints):
    units = _fit_units(cg)
    if checkpoints == "auto":
        return plan_fit_checkpoints(cg.plan, units, cg.config)
    if checkpoints == "none":
        return ()
    if checkpoints == "all":
        return tuple(range(len(units)))
    return tuple(sorted(int(i) for i in checkpoints))


def compile_fit(fn, loss: Objective, order: int, example_coords, *,
                params, config=None, block=None, use_pallas=None,
                store=None, checkpoints="auto", device=None) -> CompiledFit:
    """Compile-or-hit the streamed fitting artifact for ``fn``'s order-n
    gradient pipeline under objective ``loss``.

    Delegates the heavy half to ``compile_gradient`` (same trace, passes,
    region schedule and three-level lookup; CUDA unless ``device="cpu"``),
    then binds the ``params`` template to the graph's Const nodes and builds
    the streamed loss-gradient program.  Repeat calls with the same
    (artifact, loss, checkpoint policy) return the SAME ``CompiledFit``.

    ``checkpoints``: ``"auto"`` (the byte-model planner), ``"none"``,
    ``"all"``, or an explicit tuple of unit indices."""
    from repro_torch.core import pipeline

    if not isinstance(loss, Objective):
        raise TypeError(f"loss must be a fit Objective, got {type(loss)}")
    if order < loss.min_order:
        raise ValueError(f"{type(loss).__name__} reads order-"
                         f"{loss.min_order} outputs; order={order} given")

    cg = pipeline.compile_gradient(fn, order, example_coords, config=config,
                                   block=block, use_pallas=use_pallas,
                                   store=store, device=device)
    if len(cg.plan.inputs) != 1:
        raise ValueError("compile_fit supports single-coordinate-input "
                         f"graphs; got {len(cg.plan.inputs)} inputs")
    if any(o in cg.plan.resident for o in cg.graph.outputs):
        raise ValueError("compile_fit requires every graph output to be "
                         "streamed (coordinate-dependent)")
    cuts = _resolve_checkpoints(cg, checkpoints)
    key = (cg, loss, cuts)
    hit = pipeline._FIT_CACHE.get(key)
    if hit is not None:
        hit.cg.cache_hits += 1
        return hit
    leaf_of, fixed, treedef, leaves = match_trainable(cg, params)
    cf = CompiledFit(cg=cg, loss=loss, checkpoints=cuts, leaf_of=leaf_of,
                     fixed=fixed, treedef=treedef, template_leaves=leaves)
    pipeline._FIT_CACHE[key] = cf
    return cf
