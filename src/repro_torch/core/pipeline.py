"""CompiledGradient — the compile-once / serve-many front door (port of
``repro.core.pipeline``).

    compile_gradient(fn, order, example_coords, device=...) -> CompiledGradient

The compiler extracts the order-th input-gradient graph of ``fn`` with the
paper's autograd structure (``inr.gradnet.paper_gradients`` traced by
``core.trace.extract_graph``), optimizes it, partitions it into segments and
fused regions, and computes the residents (weights and every const-derived
tensor) once on the device.  The artifact then serves any number of rows:
``apply_batched`` pads them to a block multiple and streams them block by
block through the region / segment kernels.

Entry points run on CUDA unless the caller passes ``device="cpu"``; there
every kernel wrapper runs its plain PyTorch version.  Repeat compilations
with the same ``(fn, order, trace shape, dtype, resolved config, device)``
return the same artifact from an in-process cache; ``store=`` adds the
artifact store as a second, on-disk level (``serve.store``).
"""

from __future__ import annotations

import torch

from repro_torch.core.config import HardwareConfig, as_hardware_config
from repro_torch.core.executor import (_eval_node, _run_region,
                                       _run_segment, check_streamable,
                                       const_tensor, torch_dtype)
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.segment import (INTERPRET, SegmentPlan,
                                      apply_hardware_config,
                                      build_segment_plan, dispatch_table,
                                      segment_dispatch, _p)
from repro_torch.kernels.common import fp32_strict, resolve_device
from repro_torch.obs.metrics import MetricsView, counter as _obs_counter


class CompiledGradient:
    """Frozen compile-once / serve-many pipeline artifact.  Instances are
    shared through the compile cache: treat them as immutable."""

    def __init__(self, graph: ComputeGraph, plan: SegmentPlan, *,
                 config: HardwareConfig, residents: dict, dispatch: list,
                 device: torch.device, fn=None, order: int | None = None,
                 region_plan=None):
        self.graph = graph
        self.plan = plan
        self.config = config              # resolved HardwareConfig
        self.residents = residents        # node id -> tensor on ``device``
        self.dispatch = dispatch          # one (id, kind, kernel) per kernel
        self.device = device
        self.fn = fn
        self.order = order
        self.region_plan = region_plan    # RegionPlan (None: per-segment)
        self.provenance = "trace"         # "trace" | "store" (set on restore)
        self.cache_hits = 0               # in-process hits served (metadata)
        self._signature = None            # lazy architecture signature
        self._stored_in: set[str] = set()  # store roots known to hold this
        self._decisions = {
            s.id: (segment_dispatch(plan, s) if config.use_pallas
                   else INTERPRET) for s in plan.segments}
        self._streamed_outs = [o for o in graph.outputs
                               if o not in plan.resident]
        self._block_fn = self.resident_block_fn()

    # -- execution ---------------------------------------------------------

    def resident_block_fn(self):
        """The per-block pipeline parameterized by its resident environment:
        ``f(res_env, *xblk) -> streamed outs``.  With kernel dispatch and a
        region plan, fused regions run as ONE region launch each
        (``_run_region``); everything else runs segment by segment."""
        plan, g = self.plan, self.graph
        decisions = self._decisions
        block, B = self.config.block, plan.batch
        input_nodes = [g.nodes[i] for i in plan.inputs]
        streamed_outs = self._streamed_outs

        if self.region_plan is not None and self.config.use_pallas:
            units = self.region_plan.units()
        else:
            units = [("seg", s) for s in plan.segments]

        def block_fn(res_env, *xblk):
            env = {n.id: xblk[_p(n, "idx")] for n in input_nodes}
            for kind, u in units:
                if kind == "region":
                    _run_region(plan, u, env, res_env, block, B)
                else:
                    env[u.output] = _run_segment(plan, u, decisions[u.id],
                                                 env, res_env, block, B)
            return tuple(env[o] for o in streamed_outs)
        return block_fn

    def apply_block(self, xblk):
        """One BLOCK step: [block, ...features] -> streamed outputs."""
        return self._block_fn(self.residents, xblk)

    def apply_chunk(self, xchunk):
        """One CHUNK step: ``xchunk`` is [n_blocks, block, ...features];
        returns the streamed outputs, each [n_blocks, block, ...]."""
        per_block = [self.apply_block(xchunk[i])
                     for i in range(xchunk.shape[0])]
        return tuple(torch.stack(col) for col in zip(*per_block))

    def apply(self, *inputs):
        """The plan-batch streaming execution: every input has the trace
        batch; returns every graph output."""
        plan, g = self.plan, self.graph
        block, B = self.config.block, plan.batch
        n_blocks = B // block
        inputs = [torch.as_tensor(x, device=self.device) for x in inputs]
        if self._streamed_outs:
            per_block = [self._block_fn(self.residents,
                                        *(x[i * block:(i + 1) * block]
                                          for x in inputs))
                         for i in range(n_blocks)]
            vals = iter(torch.cat(col) for col in zip(*per_block))
        else:
            vals = iter(())
        return tuple(self.residents[o] if o in plan.resident else next(vals)
                     for o in g.outputs)

    def apply_batched(self, coords):
        """Serve an arbitrary number of query rows.

        ``coords`` is [N, ...features] for any N: the batch is padded to a
        block multiple with copies of the last row (padding never reaches
        the caller), full chunks of ``config.chunk_blocks`` blocks go
        through ``apply_chunk``, the remainder block by block, and the
        first N rows of each output are returned."""
        if len(self.plan.inputs) != 1:
            raise ValueError("apply_batched serves single-input (coordinate) "
                             "pipelines; use apply() for multi-input graphs")
        coords = torch.as_tensor(coords, device=self.device)
        n = coords.shape[0]
        block = self.config.block
        chunk_blocks = self.config.chunk_blocks
        if n == 0:
            return tuple(
                self._resident_output(o, 0) if o in self.plan.resident
                else torch.zeros((0,) + tuple(self.graph.nodes[o].shape[1:]),
                                 dtype=torch_dtype(self.graph.nodes[o].dtype),
                                 device=self.device)
                for o in self.graph.outputs)
        pad = (-n) % block
        if pad:
            edge = coords[-1:].expand((pad,) + tuple(coords.shape[1:]))
            coords = torch.cat([coords, edge])
        nb = coords.shape[0] // block
        n_chunks = nb // chunk_blocks

        pieces: list[tuple] = []
        if n_chunks:
            head = coords[: n_chunks * chunk_blocks * block]
            xc = head.reshape(n_chunks, chunk_blocks, block,
                              *coords.shape[1:])
            for c in range(n_chunks):
                outs = self.apply_chunk(xc[c])     # each [chunk, block, ...]
                pieces.append(tuple(
                    o.reshape(chunk_blocks * block, *o.shape[2:])
                    for o in outs))
        for i in range(n_chunks * chunk_blocks, nb):
            pieces.append(self.apply_block(coords[i * block:(i + 1) * block]))

        streamed = iter(torch.cat(col)[:n] if len(col) > 1 else col[0][:n]
                        for col in zip(*pieces))
        return tuple(self._resident_output(o, n) if o in self.plan.resident
                     else next(streamed) for o in self.graph.outputs)

    def _resident_output(self, o: int, n: int):
        v = self.residents[o]
        if (o in self.plan.rowconst and v.dim()
                and v.shape[:1] == (self.plan.batch,)):
            # row-constant resident output: one row serves any batch size
            v = v[:1].expand((n,) + tuple(v.shape[1:]))
        return v

    @property
    def signature(self) -> str:
        """Weight-independent architecture signature (graph structure +
        order + resolved config) — the artifact store's canonical key.
        Computed lazily and cached; store-restored artifacts carry the
        signature they were stored under."""
        if self._signature is None:
            from repro_torch.serve.store import arch_signature
            self._signature = arch_signature(self.graph, self.order,
                                             self.config)
        return self._signature


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

def compile_from_graph(g: ComputeGraph, *,
                       config: HardwareConfig | None = None,
                       block: int | None = None,
                       use_pallas: bool | None = None,
                       plan: SegmentPlan | None = None,
                       device=None, fn=None,
                       order: int | None = None) -> CompiledGradient:
    """Compile an already-extracted, optimized ComputeGraph into a
    CompiledGradient on ``device`` (CUDA unless the caller passes "cpu")."""
    if not check_streamable(g):
        raise ValueError("graph is not batch-streamable")
    device = resolve_device(device)
    cfg = as_hardware_config(config, block=block,
                             use_pallas=use_pallas).resolved()
    if plan is None:
        plan = build_segment_plan(g, config=cfg)
    B = plan.batch
    cfg = cfg.clamped(B)
    if B % cfg.block != 0:
        raise ValueError(f"plan batch {B} is not a multiple of block "
                         f"{cfg.block}")
    if plan.config != cfg:
        plan = apply_hardware_config(plan, cfg)

    region_plan = None
    if cfg.fuse_regions:
        from repro_torch.core.regions import build_region_plan
        region_plan = build_region_plan(plan, cfg)

    if not cfg.use_pallas:
        dispatch = [(s.id, s.kind, INTERPRET) for s in plan.segments]
    elif region_plan is not None:
        from repro_torch.core.regions import region_dispatch_table
        dispatch = region_dispatch_table(plan, region_plan)
    else:
        dispatch = dispatch_table(plan)

    # residents once, on the device: the paper's on-chip tensors
    fp32_strict()
    residents: dict[int, torch.Tensor] = {}
    for nid in plan.resident_order():
        n = g.nodes[nid]
        if n.op == "Const":
            residents[nid] = const_tensor(n, device)
        else:
            residents[nid] = _eval_node(n, [residents[i] for i in n.inputs],
                                        device=device)
    residents = {k: v.contiguous() for k, v in residents.items()}

    return CompiledGradient(g, plan, config=cfg, residents=residents,
                            dispatch=dispatch, device=device, fn=fn,
                            order=order, region_plan=region_plan)


_CACHE: dict[tuple, CompiledGradient] = {}
# the compile-layer accounting, as registry metrics (a dict-shaped view)
_STATS = MetricsView({
    "hits": _obs_counter("compile_cache_hits",
                         "in-process compile cache hits"),
    "misses": _obs_counter("compile_cache_misses",
                           "in-process compile cache misses"),
    "store_hits": _obs_counter("compile_store_hits",
                               "artifact-store restore hits"),
    "store_misses": _obs_counter("compile_store_misses",
                                 "artifact-store restore misses"),
    "store_puts": _obs_counter("compile_store_puts",
                               "artifacts persisted to a store"),
})


def _fn_key(fn):
    """fn identity: the object itself when hashable (functions and modules
    hash by identity), else id() — the cached artifact keeps fn alive."""
    try:
        hash(fn)
        return fn
    except TypeError:
        return id(fn)


def compile_cache_info() -> dict:
    """The compile cache's size, the monotonic tracer counter, and the
    in-process and artifact-store hit/miss/put accounting."""
    from repro_torch.core import trace
    return {"size": len(_CACHE), "traces": trace.TRACE_CALLS,
            **{k: _STATS[k] for k in _STATS}}


def clear_compile_cache() -> None:
    """Drop every cached artifact (``compile_gradient``'s and
    ``compile_fit``'s) and reset the hit/miss accounting (the tracer counter
    is monotonic by design: tests measure deltas)."""
    _CACHE.clear()
    _FIT_CACHE.clear()
    for k in _STATS:
        _STATS[k] = 0


def _trace_graph(fn, order: int, trace_b: int, shape, dtype,
                 device) -> ComputeGraph:
    """Extract + optimize the order-th gradient graph of fn at the trace
    batch (the front half of the compiler, shared by every config)."""
    from repro_torch.core.passes import optimize
    from repro_torch.core.trace import extract_graph
    from repro_torch.inr.gradnet import paper_gradients

    dt = torch_dtype(dtype)
    example = torch.zeros((trace_b,) + tuple(shape[1:]), dtype=dt,
                          device=device)
    with torch.no_grad():
        out_features = fn(example).shape[-1]
    gfn = paper_gradients(fn, order, out_features, shape[-1],
                          batch=trace_b, device=device, dtype=dt)
    g = extract_graph(gfn, example)
    optimize(g)
    return g


def compile_gradient(fn, order: int, example_coords, *,
                     config: HardwareConfig | None = None,
                     block: int | None = None,
                     use_pallas: bool | None = None,
                     store=None,
                     device=None) -> CompiledGradient:
    """The pipeline front door: compile-or-hit the compiler for the
    ``order``-th input gradients of INR ``fn`` (a torch callable on
    ``[B, in]`` tensors whose weights live on ``device``).

    ``example_coords`` only contributes shape and dtype; its batch dim is
    rounded up to a block multiple for the trace (``apply`` expects that
    batch; ``apply_batched`` serves any N).  ``config`` is a
    ``HardwareConfig`` or ``None`` (``DEFAULT_CONFIG``); ``block`` /
    ``use_pallas`` override its fields.  ``device`` defaults to CUDA and
    raises without it; pass ``"cpu"`` to run the plain versions.

    ``store`` (a ``serve.ArtifactStore`` or a directory path) makes this a
    three-level lookup: in-process cache -> store -> trace + compile +
    persist.  A store hit rebuilds the artifact from the persisted graph,
    config and weights without a single tracer call."""
    device = resolve_device(device)
    shape = tuple(example_coords.shape)
    dtype = str(example_coords.dtype).removeprefix("torch.")
    if store is not None:
        from repro_torch.serve.store import as_store
        store = as_store(store)
    cfg = as_hardware_config(config, block=block,
                             use_pallas=use_pallas).resolved()
    trace_b = shape[0] + (-shape[0]) % cfg.block
    key = (_fn_key(fn), int(order), (trace_b,) + shape[1:], dtype,
           cfg.clamped(trace_b), device)
    hit = _CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        hit.cache_hits += 1
        if store is not None and store.root not in hit._stored_in:
            # a store handed in late still ends up populated
            store.ensure(hit, request_key=_request_key(fn, order, trace_b,
                                                       shape, dtype, cfg))
            hit._stored_in.add(store.root)
        return hit
    _STATS["misses"] += 1

    rk = None
    if store is not None:
        rk = _request_key(fn, order, trace_b, shape, dtype, cfg)
        cg = store.restore_request(rk, device=device)
        if cg is not None:
            _STATS["store_hits"] += 1
            if cg.fn is None:
                cg.fn = fn
            _CACHE[key] = cg
            return cg
        _STATS["store_misses"] += 1

    g = _trace_graph(fn, order, trace_b, shape, dtype, device)
    cg = compile_from_graph(g, config=cfg, device=device, fn=fn, order=order)
    _CACHE[key] = cg
    if store is not None:
        store.put(cg, request_key=rk)
        cg._stored_in.add(store.root)
        _STATS["store_puts"] += 1
    return cg


# compile_fit artifacts, keyed (CompiledGradient identity, Objective,
# checkpoint cuts) — the heavy compile half already dedupes through _CACHE /
# the store, so fit keys ride on the cg object itself (which the entry
# keeps alive).  Populated by repro_torch.fit.compile.
_FIT_CACHE: dict[tuple, object] = {}


def compile_fit(fn, loss, order: int, example_coords, *, params,
                config=None, block=None, use_pallas=None, store=None,
                checkpoints="auto", device=None):
    """Streamed-fitting front door: ``compile_gradient`` for the heavy half
    (same three-level cache/store lookup), plus the online loss-gradient
    program of DESIGN.md §11.  See ``repro_torch.fit.compile.compile_fit``."""
    from repro_torch.fit.compile import compile_fit as _compile_fit
    return _compile_fit(fn, loss, order, example_coords, params=params,
                        config=config, block=block, use_pallas=use_pallas,
                        store=store, checkpoints=checkpoints, device=device)


def _request_key(fn, order, trace_b, shape, dtype, cfg):
    """Disk-index key for one request (None when fn has no stable
    cross-process fingerprint — the disk level is then skipped)."""
    from repro_torch.serve.store import request_key
    return request_key(fn, order, (trace_b,) + tuple(shape[1:]), dtype,
                       cfg.clamped(trace_b))
