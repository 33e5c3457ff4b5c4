"""CompiledGradient — the compile-once / serve-many front door (port of
``repro.core.pipeline``).

    compile_gradient(fn, order, example_coords, device=...) -> CompiledGradient

The compiler extracts the order-th input-gradient graph of ``fn`` with the
paper's autograd structure (``inr.gradnet.paper_gradients`` traced by
``core.trace.extract_graph``), optimizes it, partitions it into segments and
fused regions, and computes the residents (weights and every const-derived
tensor) once on the device.  The artifact then serves any number of rows:
``apply_batched`` pads them to a block multiple and streams them chunk by
chunk: each execution unit (a fused region, or a segment) runs as one
launch over a chunk's ``chunk_blocks · block`` rows, as the reference runs
a chunk as one device program.

Entry points run on CUDA unless the caller passes ``device="cpu"``; there
every kernel wrapper runs its plain PyTorch version.  Repeat compilations
with the same ``(fn, order, trace shape, dtype, resolved config, device)``
return the same artifact from an in-process cache; ``store=`` adds the
artifact store as a second, on-disk level (``serve.store``).

``compile_bank`` compiles a filter bank: F heads over the same gradient
features of one INR, merged into one multi-output graph whose shared prefix
is computed once (DESIGN.md §9).

``config="auto"`` lets ``core.autoconfig`` pick the HardwareConfig with the
dataflow latency oracle (the paper's automatic hardware-parameter
configuration); on CUDA the analytic winner is then re-ranked by timing the
candidates' real ``apply_batched`` on the card.  ``dataflow_summary`` maps
the plan onto the paper's dataflow architecture and sizes its FIFOs
(``core.dataflow``, ``core.fifo_opt``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.config import HardwareConfig, as_hardware_config
from repro_torch.core.executor import (ResidentEnv, _eval_node,
                                       _run_region, _run_segment,
                                       check_streamable, const_tensor,
                                       torch_dtype)
from repro_torch.core.graph import ComputeGraph
from repro_torch.core.segment import (INTERPRET, SegmentPlan,
                                      apply_hardware_config,
                                      build_segment_plan, dispatch_table,
                                      segment_dispatch, _p)
from repro_torch.kernels.common import fp32_strict, resolve_device
from repro_torch.obs.metrics import MetricsView, counter as _obs_counter
from repro_torch.obs.tracing import TRACER


class CompiledGradient:
    """Frozen compile-once / serve-many pipeline artifact.  Instances are
    shared through the compile cache: treat them as immutable.  Two
    documented exceptions never change what the artifact computes: the
    dataflow summaries are computed lazily and cached on the artifact,
    keyed by their parameters; and ``autoconfig`` is a write-once metadata
    slot — ``None`` unless a ``config="auto"`` request resolves to this
    artifact's config, which attaches the search record."""

    def __init__(self, graph: ComputeGraph, plan: SegmentPlan, *,
                 config: HardwareConfig, residents: dict, dispatch: list,
                 device: torch.device, fn=None, order: int | None = None,
                 autoconfig=None, region_plan=None):
        self.graph = graph
        self.plan = plan
        self.config = config              # resolved HardwareConfig
        self.residents = ResidentEnv(residents)  # node id -> tensor
        self.dispatch = dispatch          # one (id, kind, kernel) per kernel
        self.device = device
        self.fn = fn
        self.order = order
        self.autoconfig = autoconfig      # AutoConfigResult when config="auto"
        self.region_plan = region_plan    # RegionPlan (None: per-segment)
        self.provenance = "trace"         # "trace" | "store" (set on restore)
        self.cache_hits = 0               # in-process hits served (metadata)
        self._signature = None            # lazy architecture signature
        self._stored_in: set[str] = set()  # store roots known to hold this
        self._dataflow: dict[tuple, dict] = {}
        self._decisions = {
            s.id: (segment_dispatch(plan, s) if config.use_pallas
                   else INTERPRET) for s in plan.segments}
        self._streamed_outs = [o for o in graph.outputs
                               if o not in plan.resident]
        self._block_fn = self.resident_block_fn()

    # the old scattered knobs, now views of the one config
    @property
    def block(self) -> int:
        return self.config.block

    @property
    def use_pallas(self) -> bool:
        return self.config.use_pallas

    # -- execution ---------------------------------------------------------

    def resident_block_fn(self):
        """The pipeline over the rows of one call, parameterized by its
        resident environment: ``f(res_env, *xrows) -> streamed outs`` for
        any row count (a block, a chunk, the plan batch).  With kernel
        dispatch and a region plan, fused regions run as ONE region launch
        each (``_run_region``); everything else runs segment by segment,
        one launch a segment.  ``res_env`` is a ``ResidentEnv``."""
        plan, g = self.plan, self.graph
        decisions = self._decisions
        B = plan.batch
        input_nodes = [g.nodes[i] for i in plan.inputs]
        streamed_outs = self._streamed_outs

        if self.region_plan is not None and self.config.use_pallas:
            units = self.region_plan.units()
        else:
            units = [("seg", s) for s in plan.segments]

        def block_fn(res_env, *xrows):
            env = {n.id: xrows[_p(n, "idx")] for n in input_nodes}
            rows = xrows[0].shape[0]
            for kind, u in units:
                if kind == "region":
                    _run_region(plan, u, env, res_env, rows, B)
                else:
                    env[u.output] = _run_segment(plan, u, decisions[u.id],
                                                 env, res_env, rows, B)
            return tuple(env[o] for o in streamed_outs)
        return block_fn

    def apply_block(self, xblk):
        """One BLOCK step: [block, ...features] -> streamed outputs."""
        return self._block_fn(self.residents, xblk)

    def apply_chunk(self, xchunk):
        """One CHUNK step: ``xchunk`` is [n_blocks, block, ...features];
        returns the streamed outputs, each [n_blocks, block, ...].  The
        chunk's rows make ONE pass: one launch per execution unit."""
        nb, block = xchunk.shape[:2]
        outs = self._block_fn(self.residents,
                              xchunk.reshape(nb * block, *xchunk.shape[2:]))
        return tuple(o.reshape(nb, block, *o.shape[1:]) for o in outs)

    def apply(self, *inputs):
        """The plan-batch streaming execution: every input has the trace
        batch, streamed in one pass; returns every graph output."""
        plan, g = self.plan, self.graph
        inputs = [torch.as_tensor(x, device=self.device) for x in inputs]
        vals = iter(self._block_fn(self.residents, *inputs)
                    if self._streamed_outs else ())
        return tuple(self.residents[o] if o in plan.resident else next(vals)
                     for o in g.outputs)

    def streamed_outputs(self) -> list[int]:
        """Graph outputs served by the streaming path, in output order (the
        rest are residents, read from ``resident_output``)."""
        return list(self._streamed_outs)

    def resident_output(self, o: int, n: int):
        """A resident (const-derived) output broadcast to ``n`` rows."""
        return self._resident_output(o, n)

    def apply_batched(self, coords):
        """Serve an arbitrary number of query rows.

        ``coords`` is [N, ...features] for any N: the batch is padded to a
        block multiple with copies of the last row (padding never reaches
        the caller), full chunks of ``config.chunk_blocks`` blocks go
        through ``apply_chunk``, the remainder blocks as one more pass, and
        the first N rows of each output are returned."""
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
        if nb > n_chunks * chunk_blocks:
            pieces.append(self._block_fn(
                self.residents, coords[n_chunks * chunk_blocks * block:]))

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

    # -- the rest of the artifact ------------------------------------------

    def dataflow_summary(self, *, dataflow_block: int | None = None,
                         mm_parallel: int | None = None) -> dict:
        """FIFO-optimized dataflow summary for this plan (lazy; the FIFO
        search is the expensive part of the paper's compiler).

        Defaults come from the artifact's HardwareConfig — ``dataflow_block``
        from ``config.dataflow_block``, MM parallelism per segment from the
        config's stamps.  Passing ``mm_parallel`` explicitly applies one
        uniform factor instead (what the table sweeps do).  Summaries are
        cached on the artifact keyed by those parameters.  The numbers are
        the dataflow model's (block steps, FIFO depths in blocks), not
        measurements of the card."""
        cfg = self.config
        db = dataflow_block if dataflow_block is not None else cfg.dataflow_block
        key = (db, mm_parallel if mm_parallel is not None
               else ("config", cfg.mm_parallel, cfg.mm_parallel_per_segment))
        cached = self._dataflow.get(key)
        if cached is None:
            from repro_torch.core.dataflow import map_to_dataflow
            from repro_torch.core.fifo_opt import optimize_fifo_depths
            with TRACER.span("compile.dataflow_map", cat="compile",
                             dataflow_block=db):
                design = map_to_dataflow(
                    self.graph, block=db, mm_parallel=mm_parallel,
                    plan=self.plan,
                    config=None if mm_parallel is not None else cfg,
                    region_plan=None if mm_parallel is not None
                    else self.region_plan)
            with TRACER.span("compile.fifo_opt", cat="compile",
                             streams=len(design.streams)):
                res = optimize_fifo_depths(design, config=cfg)
            cached = {"design": design, "fifo": res, **res.summary()}
            self._dataflow[key] = cached
        return cached

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

    def describe(self) -> str:
        kernels = [k for _, _, k in self.dispatch if k != INTERPRET]
        prov = self.provenance
        if self.cache_hits:
            prov += f" (+{self.cache_hits} in-process hits)"
        lines = [f"CompiledGradient(order={self.order}, "
                 f"config=[{self.config.describe()}]): "
                 f"{len(self.graph.nodes)} nodes, "
                 f"{len(self.plan.segments)} segments, "
                 f"{len(self.residents)} residents, "
                 f"{len(kernels)} kernel-dispatched units on {self.device}",
                 f"  provenance: {prov}",
                 f"  signature: {self.signature}"]
        if self.autoconfig is not None:
            lines.append(f"  {self.autoconfig.describe()}")
        lines.append(self.plan.describe())
        if self.region_plan is not None:
            lines.append(self.region_plan.describe())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

def compile_from_graph(g: ComputeGraph, *,
                       config: HardwareConfig | None = None,
                       block: int | None = None,
                       use_pallas: bool | None = None,
                       plan: SegmentPlan | None = None,
                       device=None, fn=None,
                       order: int | None = None,
                       autoconfig=None) -> CompiledGradient:
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
                            order=order, autoconfig=autoconfig,
                            region_plan=region_plan)


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
    """One view of every compile-layer cache: the compile_gradient artifact
    cache, the per-graph cache behind ``executor.streaming_executor``, the
    per-artifact keyed ``dataflow_summary`` caches, the monotonic tracer
    counter, and the in-process and artifact-store hit/miss/put
    accounting."""
    from repro_torch.core import executor, trace
    artifacts = {id(cg): cg for cg in _CACHE.values()}
    artifacts.update((id(cg), cg) for cg in executor._GRAPH_CACHE.values())
    return {"size": len(_CACHE),
            "graph_cache_size": len(executor._GRAPH_CACHE),
            "dataflow_summaries": sum(len(cg._dataflow)
                                      for cg in artifacts.values()),
            "traces": trace.TRACE_CALLS,
            **{k: _STATS[k] for k in _STATS}}


def clear_compile_cache() -> None:
    """Drop every cached artifact (``compile_gradient``'s,
    ``compile_bank``'s, ``compile_fit``'s and the per-graph cache behind
    ``executor.streaming_executor``, and with them every cached dataflow
    summary) and reset the hit/miss accounting (the tracer counter is
    monotonic by design: tests measure deltas)."""
    from repro_torch.core import executor
    _CACHE.clear()
    _BANK_CACHE.clear()
    _FIT_CACHE.clear()
    executor._GRAPH_CACHE.clear()
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
                     config: HardwareConfig | str | None = None,
                     block: int | None = None,
                     use_pallas: bool | None = None,
                     store=None,
                     base_config: HardwareConfig | None = None,
                     device=None) -> CompiledGradient:
    """The pipeline front door: compile-or-hit the compiler for the
    ``order``-th input gradients of INR ``fn`` (a torch callable on
    ``[B, in]`` tensors whose weights live on ``device``).

    ``example_coords`` only contributes shape and dtype; its batch dim is
    rounded up to a block multiple for the trace (``apply`` expects that
    batch; ``apply_batched`` serves any N).  ``device`` defaults to CUDA
    and raises without it; pass ``"cpu"`` to run the plain versions.

    ``config`` selects the hardware parameters:

      * a ``HardwareConfig`` — used as given (``block`` / ``use_pallas``
        override its fields);
      * ``None`` — ``DEFAULT_CONFIG`` (with the same overrides);
      * ``"auto"`` — ``core.autoconfig.resolve_config`` picks the config
        with the dataflow latency oracle, rejecting deadlock-flagged
        candidates; on CUDA the analytic winner's block, tile and
        ``chunk_blocks`` variants are then re-ranked by timing the real
        ``apply_batched`` on the card (``make_apply_batched_measure``); on
        the CPU the search stays analytic and deterministic.  The record
        rides on the artifact as ``cg.autoconfig``.  ``base_config`` (auto
        mode only) seeds the search; every candidate inherits its
        non-searched fields.

    The cache is keyed on the RESOLVED config, so ``config="auto"`` shares
    its entry with an explicit request for whatever config it resolved to.

    ``store`` (a ``serve.ArtifactStore`` or a directory path) makes this a
    three-level lookup: in-process cache -> store -> trace + compile +
    persist.  A store hit rebuilds the artifact from the persisted graph,
    config and weights without a single tracer call (and, for an auto
    request, without the search)."""
    device = resolve_device(device)
    shape = tuple(example_coords.shape)
    dtype = str(example_coords.dtype).removeprefix("torch.")
    if store is not None:
        from repro_torch.serve.store import as_store
        store = as_store(store)

    if isinstance(config, str):
        if config != "auto":
            raise ValueError(f"config must be a HardwareConfig, None, or "
                             f"'auto'; got {config!r}")
        return _compile_auto(fn, order, shape, dtype, block=block,
                             use_pallas=use_pallas, store=store,
                             base_config=base_config, device=device)
    if base_config is not None:
        raise ValueError("base_config only seeds config='auto'; pass it as "
                         "config= for an explicit request")

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


def _auto_search(g, plan, base, device):
    """Resolve config="auto" for graph ``g``: on CUDA the analytic winner
    is refined against real apply_batched timings on the card; on the CPU
    the search stays analytic (deterministic and cheap, what the tests
    rely on)."""
    from repro_torch.core.autoconfig import (make_apply_batched_measure,
                                             resolve_config)
    measure = (make_apply_batched_measure(g, plan, device=device)
               if device.type == "cuda" else None)
    return resolve_config(g, plan, base=base, measure=measure)


def _compile_auto(fn, order: int, shape, dtype, *, block=None,
                  use_pallas=None, store=None, base_config=None,
                  device) -> CompiledGradient:
    """config="auto": trace once, let autoconfig pick the HardwareConfig,
    compile with the winner, and cache under BOTH the auto request and the
    resolved config (so explicit requests for the winner hit the same
    artifact).  With a store, the auto request gets its own disk-index
    binding — a replica restoring it skips the trace AND the search, and
    the artifact carries the persisted AutoConfigResult."""
    base = as_hardware_config(base_config, block=block,
                              use_pallas=use_pallas).resolved()
    # round the trace batch to a multiple of 8 (every block candidate
    # divides it at the default batch) so the search may pick any of them
    trace_b = shape[0] + (-shape[0]) % 8
    tshape = (trace_b,) + tuple(shape[1:])
    auto_key = (_fn_key(fn), int(order), tshape, dtype, "auto", base, device)
    hit = _CACHE.get(auto_key)
    if hit is not None:
        _STATS["hits"] += 1
        hit.cache_hits += 1
        return hit
    _STATS["misses"] += 1

    rk = None
    if store is not None:
        from repro_torch.serve.store import request_key
        rk = request_key(fn, order, tshape, dtype, base, mode="auto")
        cg = store.restore_request(rk, device=device)
        if cg is not None:
            _STATS["store_hits"] += 1
            if cg.fn is None:
                cg.fn = fn
            _CACHE[auto_key] = cg
            _CACHE[(_fn_key(fn), int(order), tshape, dtype, cg.config,
                    device)] = cg
            return cg
        _STATS["store_misses"] += 1

    with TRACER.span("compile", cat="compile", order=order, mode="auto"):
        g = _trace_graph(fn, order, trace_b, shape, dtype, device)
        plan = build_segment_plan(g)
        result = _auto_search(g, plan, base, device)
        cfg = result.config

        resolved_key = (_fn_key(fn), int(order), tshape, dtype,
                        cfg.clamped(trace_b), device)
        cg = _CACHE.get(resolved_key)
        if cg is None:
            cg = compile_from_graph(g, config=cfg, plan=plan, device=device,
                                    fn=fn, order=order, autoconfig=result)
            _CACHE[resolved_key] = cg
        elif cg.autoconfig is None:
            # the search resolved to a config already compiled explicitly
            # (e.g. the default); share the artifact and attach the record
            cg.autoconfig = result
    _CACHE[auto_key] = cg
    if store is not None:
        store.put(cg, request_key=rk)
        cg._stored_in.add(store.root)
        _STATS["store_puts"] += 1
    return cg


# ---------------------------------------------------------------------------
# the filter-bank compiler (DESIGN.md §9): F filters, one pipeline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BankReport:
    """Compile-time accounting of the bank against the per-filter loop it
    replaces; every field is a deterministic compiler output (no timing).

    The "loop" numbers are the SUM over per-filter plans at the same
    HardwareConfig: F separate compiles, each re-deriving the shared
    gradient-feature prefix.  The bank merges the filter graphs, hash-conses
    the prefix to one computation and serves every filter output from one
    multi-sink region pipeline."""
    n_heads: int
    nodes_bank: int
    nodes_loop: int
    dispatches_bank: int
    dispatches_loop: int
    hbm_block_bank: int
    hbm_block_loop: int
    row_cycles_bank: int
    row_cycles_loop: int

    def describe(self) -> str:
        def x(a, b):
            return f"{b / max(a, 1):.1f}x"
        return (f"BankReport({self.n_heads} heads): "
                f"nodes {self.nodes_bank} vs loop {self.nodes_loop} "
                f"({x(self.nodes_bank, self.nodes_loop)}), "
                f"dispatches {self.dispatches_bank} vs "
                f"{self.dispatches_loop} "
                f"({x(self.dispatches_bank, self.dispatches_loop)}), "
                f"hbm/block {self.hbm_block_bank} vs {self.hbm_block_loop} "
                f"({x(self.hbm_block_bank, self.hbm_block_loop)}), "
                f"row-cycles {self.row_cycles_bank} vs "
                f"{self.row_cycles_loop}")


class CompiledBank:
    """F filter pipelines compiled as ONE multi-output artifact.

    Wraps the ``CompiledGradient`` of the MERGED graph (serving, store
    persistence and dataflow summaries come from it unchanged) plus the
    bank's bookkeeping: head count and order, and the compile-time
    ``BankReport`` (None when restored from a store, where the per-filter
    graphs were never traced).  Output ``j`` of every serving call is
    filter ``j``'s output, in the order the heads were given."""

    def __init__(self, cg: CompiledGradient, *, n_heads: int, order: int,
                 report: BankReport | None = None, fn=None, heads=None):
        self.cg = cg
        self.n_heads = n_heads
        self.order = order
        self.report = report
        self.fn = fn
        self.heads = tuple(heads) if heads is not None else None

    @property
    def graph(self) -> ComputeGraph:
        return self.cg.graph

    @property
    def plan(self) -> SegmentPlan:
        return self.cg.plan

    @property
    def config(self) -> HardwareConfig:
        return self.cg.config

    @property
    def region_plan(self):
        return self.cg.region_plan

    @property
    def dispatch(self):
        return self.cg.dispatch

    @property
    def signature(self) -> str:
        return self.cg.signature

    def apply(self, coords):
        return self.cg.apply(coords)

    def apply_batched(self, coords):
        """Serve any N rows; returns a tuple of F tensors, one per filter."""
        return self.cg.apply_batched(coords)

    def describe(self) -> str:
        lines = [f"CompiledBank({self.n_heads} heads, order={self.order})"]
        if self.report is not None:
            lines.append("  " + self.report.describe())
        lines.append(self.cg.describe())
        return "\n".join(lines)


_BANK_CACHE: dict[tuple, CompiledBank] = {}


def _trace_filter_graph(fn, head, order: int, trace_b: int, shape, dtype,
                        device) -> ComputeGraph:
    """Extract + optimize the graph of ONE filter: ``head`` applied to the
    order-th gradient feature matrix of ``fn`` (the INSP computation,
    DESIGN.md §9).  The column layout is ``gradnet.feature_vector``'s."""
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

    def filter_fn(x):
        outs = gfn(x)
        return head(torch.cat([o.reshape(o.shape[0], -1) for o in outs],
                              -1))

    g = extract_graph(filter_fn, example)
    optimize(g)
    return g


def _bank_report(per_head, merged: ComputeGraph,
                 cg: CompiledGradient) -> BankReport:
    """Deterministic bank-vs-loop accounting at the bank's resolved config.
    The loop columns sum per-filter plans compiled at the SAME config, so
    the comparison isolates graph sharing from the choice of config."""
    from repro_torch.core.autoconfig import predicted_latency
    from repro_torch.core.regions import (build_region_plan,
                                          region_dispatch_table,
                                          region_hbm_bytes_per_block)
    cfg = cg.config
    d_loop = h_loop = c_loop = n_loop = 0
    for g in per_head:
        plan = build_segment_plan(g, config=cfg)
        rp = build_region_plan(plan, cfg)
        d_loop += len(region_dispatch_table(plan, rp))
        h_loop += region_hbm_bytes_per_block(plan, rp, cfg.block)
        c_loop += predicted_latency(g, cfg, plan=plan)
        n_loop += len(g.nodes)
    rp_bank = cg.region_plan
    if rp_bank is None:
        rp_bank = build_region_plan(cg.plan, cfg)
    return BankReport(
        n_heads=len(per_head),
        nodes_bank=len(merged.nodes), nodes_loop=n_loop,
        dispatches_bank=len(region_dispatch_table(cg.plan, rp_bank)),
        dispatches_loop=d_loop,
        hbm_block_bank=region_hbm_bytes_per_block(cg.plan, rp_bank,
                                                  cfg.block),
        hbm_block_loop=h_loop,
        row_cycles_bank=predicted_latency(merged, cfg, plan=cg.plan),
        row_cycles_loop=c_loop)


def compile_bank(fn, heads, order: int, example_coords, *,
                 config: HardwareConfig | str | None = None,
                 block: int | None = None,
                 use_pallas: bool | None = None,
                 store=None,
                 base_config: HardwareConfig | None = None,
                 device=None) -> CompiledBank:
    """Compile a FILTER BANK: every ``head`` applied to the same order-th
    gradient features of INR ``fn``, served from ONE merged pipeline on
    ``device`` (CUDA unless the caller passes "cpu").

    Each filter's graph is traced on its own (the head over the
    ``gradnet.feature_vector`` feature matrix), grafted into one
    multi-output graph (``graph.merge_graphs``) and hash-consed
    (``passes.dedupe_common_subtrees``), so the shared gradient-feature
    prefix collapses to one computation feeding every head.  The merged
    graph compiles through ``compile_from_graph``: the region scheduler
    fuses the prefix and the head branches into multi-sink regions, so one
    pass emits all F filter outputs per chunk.

    ``config`` follows ``compile_gradient``: a ``HardwareConfig``, ``None``
    (defaults), or ``"auto"`` (the search runs over the MERGED graph,
    timing candidates on CUDA; ``base_config`` seeds it).  Each head must
    trace to exactly one output tensor.  Repeat calls with the same (fn,
    heads, order, coords shape, config, device) hit the in-process bank
    cache; ``store`` adds the disk level under the merged graph's
    architecture signature, the request bound through
    ``serve.store.bank_request_key``.

    Returns a ``CompiledBank``; ``apply_batched(coords)`` yields a tuple of
    F tensors in head order, equal to serving each filter through its own
    single-head bank."""
    heads = tuple(heads)
    if not heads:
        raise ValueError("compile_bank needs at least one head")
    device = resolve_device(device)
    shape = tuple(example_coords.shape)
    dtype = str(example_coords.dtype).removeprefix("torch.")
    if store is not None:
        from repro_torch.serve.store import as_store
        store = as_store(store)

    auto = isinstance(config, str)
    if auto and config != "auto":
        raise ValueError(f"config must be a HardwareConfig, None, or "
                         f"'auto'; got {config!r}")
    head_keys = tuple(_fn_key(h) for h in heads)
    if auto:
        base = as_hardware_config(base_config, block=block,
                                  use_pallas=use_pallas).resolved()
        trace_b = shape[0] + (-shape[0]) % 8
        key = (_fn_key(fn), head_keys, int(order),
               (trace_b,) + shape[1:], dtype, "auto", base, device)
        key_cfg = base
    else:
        if base_config is not None:
            raise ValueError("base_config only seeds config='auto'; pass it "
                             "as config= for an explicit request")
        cfg = as_hardware_config(config, block=block,
                                 use_pallas=use_pallas).resolved()
        trace_b = shape[0] + (-shape[0]) % cfg.block
        key_cfg = cfg.clamped(trace_b)
        key = (_fn_key(fn), head_keys, int(order),
               (trace_b,) + shape[1:], dtype, key_cfg, device)
    hit = _BANK_CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        hit.cg.cache_hits += 1
        return hit
    _STATS["misses"] += 1

    rk = None
    if store is not None:
        from repro_torch.serve.store import bank_request_key
        rk = bank_request_key(fn, heads, order,
                              (trace_b,) + tuple(shape[1:]), dtype, key_cfg,
                              mode="auto" if auto else "explicit")
        cg = store.restore_request(rk, device=device)
        if cg is not None:
            _STATS["store_hits"] += 1
            bank = CompiledBank(cg, n_heads=len(heads), order=order,
                                fn=fn, heads=heads)
            _BANK_CACHE[key] = bank
            return bank
        _STATS["store_misses"] += 1

    with TRACER.span("compile.bank", cat="compile", order=order,
                     heads=len(heads)):
        per_head = [_trace_filter_graph(fn, h, order, trace_b, shape, dtype,
                                        device) for h in heads]
        for j, gh in enumerate(per_head):
            if len(gh.outputs) != 1:
                raise ValueError(
                    f"bank head {j} traced to {len(gh.outputs)} outputs; "
                    f"each filter head must return exactly one tensor")
        from repro_torch.core.graph import merge_graphs
        from repro_torch.core.passes import optimize
        with TRACER.span("compile.passes", cat="compile"):
            merged, _ = merge_graphs(per_head)
            optimize(merged)    # dedupe_common_subtrees collapses the prefix

        if auto:
            plan = build_segment_plan(merged)
            autoconfig = _auto_search(merged, plan, base, device)
            cg = compile_from_graph(merged, config=autoconfig.config,
                                    plan=plan, device=device, order=order,
                                    autoconfig=autoconfig)
        else:
            cg = compile_from_graph(merged, config=cfg, device=device,
                                    order=order)

    bank = CompiledBank(cg, n_heads=len(heads), order=order,
                        report=_bank_report(per_head, merged, cg),
                        fn=fn, heads=heads)
    _BANK_CACHE[key] = bank
    if store is not None:
        store.put(cg, request_key=rk)
        cg._stored_in.add(store.root)
        _STATS["store_puts"] += 1
    return bank


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
