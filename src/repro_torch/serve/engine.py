"""ServingEngine — the request-level front door of the serving stack (port of
``repro.serve.engine``, the synchronous engine).

    engine = ServingEngine(store)
    engine.register(inr_id, cg)            # persist + route, or
    engine.register(inr_id, signature=..., weight_id=...)   # already stored
    outs = engine.serve([(inr_id, coords), ...])

``serve`` groups requests by architecture signature (one compiled artifact
per group), concatenates each INR's query rows, and executes each group in
ONE pass: a single-INR group goes through the artifact's ``apply_batched``;
a group spanning several INRs goes through a ``MultiINRArtifact`` (per-INR
rows padded to a common block-multiple length — edge rows replicated,
padding never reaches a caller).  Where the plan is all fused regions, a
group's K INRs run through the stacked region kernel, one launch per
region, and otherwise through the per-lane path (both give the per-INR
results; the reference's engine takes its vmap path).  Filter-bank routes
(``register_bank`` + ``serve.bank.BankArtifact``, DESIGN.md §9) are a third
grouping: requests naming filters of one bank run as ONE pass of the
merged multi-output graph, each request reading its row slice of its
filter's output.  Restored artifacts and multi-INR stacks are cached
in-process behind bounded LRU caches, so steady-state serving touches
neither the tracer nor the disk.

Sharding (``sharding=``, a ``distributed.sharding.ShardingPolicy`` over a
mesh of ranks, one process each; every rank runs the same ``serve``).  On
a mesh of more than one rank a group's rows axis is split over the data
axes where they divide it (``stats["sharded_batches"]``) and stays whole
where they do not; a multi-INR group whose K axis the policy shards runs
K-sharded instead (``MultiINRArtifact``, ``stats["k_sharded_batches"]``).
Each rank serves its block and the blocks are all-gathered at the end of
the group, so every rank returns the whole outputs, those of the
unsharded engine.  ``shard_chunking`` serves single-INR groups through a
per-shard variant of the artifact, compiled from the SAME graph (no
re-trace) with ``chunk_blocks // n`` and ``n_shards = n``.  The
asynchronous, continuously batched engine is
``serve.async_engine.AsyncServingEngine``.

Bounded caches.  ``_payloads`` (weight payloads, frequency-ranked) and
``_multi`` (stacked multi-INR artifacts) are bounded (``payload_cache`` /
``multi_cache``); evictions are counted in ``stats["payload_evictions"]`` /
``stats["multi_evictions"]``.  Payloads are only evicted when a store is
attached (they reload on demand).

Perf counters.  ``stats`` carries wall-clock phase totals:
``host_group_s`` (request grouping + padding) and ``device_exec_s`` (time
until the device finished the group: on CUDA the engine synchronizes the
device before it stops the clock).
"""

from __future__ import annotations

import itertools
import math
import time
from collections import OrderedDict

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.common import resolve_device
from repro_torch.obs.metrics import MetricsView, counter as _obs_counter
from repro_torch.obs.metrics import histogram as _obs_histogram
from repro_torch.obs.tracing import TRACER
from repro_torch.serve.multi_inr import (MultiINRArtifact, const_payload,
                                         pad_rows)
from repro_torch.serve.store import ArtifactStore, as_store

# engine instances get sequential labels ("e0", "e1", ...) so each engine's
# stats view reads its own timeseries while the fleet aggregates by metric
_ENGINE_SEQ = itertools.count()

# stats key -> (metric name, help); every engine shares the metrics,
# distinguished by its ``engine=`` label
_SERVE_METRICS = {
    "requests": ("serve_requests", "queries served"),
    "rows": ("serve_rows", "query rows served (pre-padding)"),
    "padded_rows": ("serve_padded_rows", "padding rows added"),
    "groups": ("serve_groups", "signature groups executed"),
    "multi_groups": ("serve_multi_groups", "multi-INR groups executed"),
    "bank_groups": ("serve_bank_groups", "filter-bank groups executed"),
    "restores": ("serve_restores", "artifacts restored from the store"),
    "sharded_batches": ("serve_sharded_batches",
                        "batches sharded across the mesh"),
    "k_sharded_batches": ("serve_k_sharded_batches",
                          "multi-INR batches K-sharded"),
    "payload_evictions": ("serve_payload_evictions",
                          "weight payloads evicted from the LRU"),
    "multi_evictions": ("serve_multi_evictions",
                        "multi-INR stacks evicted from the LRU"),
    "host_group_s": ("serve_host_group_s",
                     "host time grouping and padding requests"),
    "device_exec_s": ("serve_device_exec_s",
                      "time blocked on device execution"),
    "queue_wait_s": ("serve_queue_wait_s",
                     "async: time work sat in the in-flight queue"),
}

# per-batch serve latency of the synchronous path
_LAT_BATCH = _obs_histogram("serve_batch_latency_s",
                            "wall time of one synchronous serve() batch")


def _engine_stats(extra: dict | None = None) -> MetricsView:
    """One engine instance's stats: a read-through view over the shared
    serve metrics, labeled by instance."""
    label = f"e{next(_ENGINE_SEQ)}"
    mapping = {k: _obs_counter(name, help)
               for k, (name, help) in _SERVE_METRICS.items()}
    if extra:
        mapping.update({k: _obs_counter(name, help)
                        for k, (name, help) in extra.items()})
    view = MetricsView(mapping, engine=label)
    view.reset()       # fresh instance starts at zero on its own label
    return view


class _LRU(OrderedDict):
    """Tiny LRU: ``get`` refreshes recency; ``put`` evicts the least
    recently used entry past ``cap`` WHEN the guard allows eviction."""

    def __init__(self, cap: int):
        super().__init__()
        self.cap = int(cap)

    def get(self, key, default=None):
        v = super().get(key, default)
        if key in self:
            self.move_to_end(key)
        return v

    def put(self, key, value, *, evictable: bool = True) -> int:
        """Insert and evict down to cap; returns evictions performed."""
        self[key] = value
        self.move_to_end(key)
        evicted = 0
        if evictable:
            while len(self) > self.cap:
                self._evict_one()
                evicted += 1
        return evicted

    def _evict_one(self) -> None:
        self.popitem(last=False)


class _FreqCache(_LRU):
    """Frequency-ranked retention for the warm weight set: every ``get``
    hit bumps a per-key hit count, and eviction removes the key with the
    FEWEST hits (ties broken least-recently-used) instead of pure recency.
    A scan over many cold INRs can no longer flush the handful of hot
    payloads that serve most requests."""

    def __init__(self, cap: int):
        super().__init__(cap)
        self.hits: dict = {}

    def get(self, key, default=None):
        v = super().get(key, default)
        if key in self:
            self.hits[key] = self.hits.get(key, 0) + 1
        return v

    def put(self, key, value, *, evictable: bool = True) -> int:
        self.hits.setdefault(key, 0)
        return super().put(key, value, evictable=evictable)

    def _evict_one(self) -> None:
        # iteration order is recency (oldest first), so min() lands on the
        # least-recently-used key among those with the fewest hits
        victim = min(self, key=lambda k: self.hits.get(k, 0))
        del self[victim]
        self.hits.pop(victim, None)


def _synchronize(outs) -> None:
    """Wait for the device work behind ``outs`` (the port's
    ``jax.block_until_ready``): CPU results are ready when returned."""
    devices = {t.device for per in outs.values() for t in per
               if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def _row_outputs(cg) -> list[bool]:
    """Per graph output of ``cg``: whether ``apply_batched`` returns it by
    rows (streamed, or a row-constant resident broadcast to the rows)."""
    plan, B = cg.plan, cg.plan.batch
    out = []
    for o in cg.graph.outputs:
        if o not in plan.resident:
            out.append(True)
            continue
        v = cg.residents[o]
        out.append(o in plan.rowconst and v.dim() > 0
                   and tuple(v.shape[:1]) == (B,))
    return out


class ServingEngine:
    def __init__(self, store: "ArtifactStore | str | None" = None, *,
                 sharding=None, shard_chunking: bool = False,
                 payload_cache: int = 256, multi_cache: int = 32,
                 device=None):
        self.store = as_store(store)
        self.sharding = sharding
        self.shard_chunking = shard_chunking
        self._variants: dict = {}               # (sig, n) -> per-shard cg
        self.device = resolve_device(device)   # where restored artifacts run
        self._routes: dict[str, tuple[str, str]] = {}   # inr_id -> (sig, wid)
        self._artifacts: dict[str, object] = {}         # sig -> CompiledGradient
        self._base_wid: dict[str, str] = {}             # sig -> base weight id
        self._payloads: _FreqCache = _FreqCache(payload_cache)  # (sig, wid)
        self._multi: _LRU = _LRU(multi_cache)           # (sig, wids) -> stack
        self._banks: dict[str, object] = {}             # sig -> BankArtifact
        self._bank_routes: dict[str, tuple[str, int]] = {}  # fid -> (sig, j)
        self._bank_filters: dict[str, tuple[str, ...]] = {}  # sig -> fids
        self.stats = _engine_stats(extra={
            "warm_hits": ("serve_warm_hits",
                          "payload hits in the frequency-ranked warm cache"),
        })

    # -- registration ------------------------------------------------------

    def register(self, inr_id: str, cg=None, *, signature: str | None = None,
                 weight_id: str | None = None) -> tuple[str, str]:
        """Route ``inr_id`` to an artifact.  With ``cg``, the artifact is
        persisted to the store (when one is attached) and kept in-process;
        without it, (signature, weight_id) must name an existing store
        entry."""
        if cg is not None:
            wid = weight_id or inr_id
            if self.store is not None:
                sig = self.store.put(cg, inr_id=wid)
            else:
                sig = cg.signature
            if sig not in self._artifacts:
                self._artifacts[sig] = cg
                self._base_wid[sig] = wid
            self._put_payload(sig, wid, const_payload(cg))
        else:
            if signature is None:
                raise ValueError("register needs an artifact or a signature")
            sig = signature
            wid = weight_id or inr_id
            if self.store is None:
                raise ValueError("signature-only registration needs a store")
            if not self.store.has(sig, wid):
                raise KeyError(f"store has no weights {wid!r} under {sig}")
        self._routes[inr_id] = (sig, wid)
        return sig, wid

    def registered(self) -> list[str]:
        return sorted(self._routes)

    def register_bank(self, filter_ids, bank=None, *,
                      signature: str | None = None) -> str:
        """Route every id in ``filter_ids`` to one output of a filter bank.
        With ``bank`` (a BankArtifact, CompiledBank, or the merged
        CompiledGradient), the artifact is persisted to the store (when one
        is attached) and kept in-process; signature-only registration
        restores lazily from the store on first serve.  Filter ``j`` serves
        output ``j`` of the merged graph."""
        from repro_torch.serve.bank import BankArtifact
        filter_ids = tuple(filter_ids)
        if bank is not None:
            art = (bank if isinstance(bank, BankArtifact)
                   else BankArtifact(bank, filter_ids))
            if art.filter_ids != filter_ids:
                raise ValueError("filter_ids disagree with the artifact's")
            sig = (self.store.put(art.cg) if self.store is not None
                   else art.signature)
            self._banks[sig] = art
        else:
            if signature is None:
                raise ValueError("register_bank needs a bank or a signature")
            if self.store is None:
                raise ValueError("signature-only registration needs a store")
            sig = signature
        clash = [f for f in filter_ids if f in self._routes]
        if clash:
            raise ValueError(f"already registered as INR routes: {clash}")
        self._bank_filters[sig] = filter_ids
        for j, fid in enumerate(filter_ids):
            self._bank_routes[fid] = (sig, j)
        return sig

    def _bank(self, sig: str):
        art = self._banks.get(sig)
        if art is None:
            from repro_torch.serve.bank import BankArtifact
            if self.store is None:
                raise KeyError(f"unknown bank signature {sig} and no store")
            art = BankArtifact.from_store(self.store, sig,
                                          self._bank_filters[sig],
                                          device=self.device)
            self._banks[sig] = art
            self.stats["restores"] += 1
        return art

    # -- artifact / payload resolution (in-process, then store) ------------

    def _artifact(self, sig: str):
        cg = self._artifacts.get(sig)
        if cg is None:
            if self.store is None:
                raise KeyError(f"unknown signature {sig} and no store")
            cg = self.store.load(sig, device=self.device)
            self._artifacts[sig] = cg
            self._base_wid[sig] = self.store.meta(sig)["default_weights"]
            self.stats["restores"] += 1
        return cg

    def _put_payload(self, sig: str, wid: str, payload: dict) -> None:
        # payloads reload from the store; without one, eviction loses the
        # only copy of the weights — grow instead
        self.stats["payload_evictions"] += self._payloads.put(
            (sig, wid), payload, evictable=self.store is not None)

    def _payload(self, sig: str, wid: str) -> dict:
        p = self._payloads.get((sig, wid))
        if p is not None:
            self.stats["warm_hits"] += 1
        else:
            if self.store is None:
                raise KeyError(f"unknown weights {wid!r} and no store")
            p = self.store.load_weights(sig, wid)
            self._put_payload(sig, wid, p)
        return p

    def _multi_artifact(self, sig: str, wids: tuple[str, ...]):
        key = (sig, wids)
        m = self._multi.get(key)
        if m is None:
            base = self._artifact(sig)
            m = MultiINRArtifact(base, [self._payload(sig, w) for w in wids],
                                 list(wids), sharding=self.sharding)
            # stacks rebuild from payloads, so they are always evictable
            self.stats["multi_evictions"] += self._multi.put(key, m)
        return m

    # -- sharding ----------------------------------------------------------

    def _n_devices(self) -> int:
        if self.sharding is None:
            return 1
        return math.prod(self.sharding.mesh.shape.values())

    def _place(self, coords, batch_axis: int):
        """(this rank's block of ``coords``, the spec it was split at): the
        rows axis split over the policy's data axes, or (coords, None) when
        they do not divide it or there is one rank."""
        if self.sharding is None or self._n_devices() == 1:
            return coords, None
        logical = [None] * coords.dim()
        logical[batch_axis] = "batch"
        spec = self.sharding.act_spec(tuple(coords.shape), tuple(logical))
        if not spec:
            return coords, None
        self.stats["sharded_batches"] += 1
        return shd.local_shard(coords, spec, self.sharding.mesh), spec

    def _run_placed(self, fn, cg, coords, batch_axis: int):
        """``fn`` on this rank's block of ``coords`` (``_place``); the rows
        of every row output (streamed, or a row-constant resident
        broadcast to the rows) all-gathered, so every rank holds the whole
        outputs."""
        local, spec = self._place(coords, batch_axis)
        outs = fn(local)
        if spec is None:
            return outs
        return tuple(shd.gather(o, spec, self.sharding.mesh) if rows else o
                     for o, rows in zip(outs, _row_outputs(cg)))

    def _serving_artifact(self, sig: str):
        """The artifact a single-INR group executes: the base, or — under
        ``shard_chunking`` — a per-shard-config variant compiled from the
        SAME graph (chunk scaled to the per-rank slice, ``n_shards``
        stamped so the dataflow oracle models the cross-shard input stream;
        no re-trace)."""
        cg = self._artifact(sig)
        n = self._n_devices()
        if not self.shard_chunking or n == 1:
            return cg
        key = (sig, n)
        variant = self._variants.get(key)
        if variant is None:
            from repro_torch.core.pipeline import compile_from_graph
            shard_cfg = cg.config.replace(
                chunk_blocks=max(1, cg.config.chunk_blocks // n),
                n_shards=n)
            if shard_cfg == cg.config:
                variant = cg
            else:
                variant = compile_from_graph(cg.graph, config=shard_cfg,
                                             order=cg.order,
                                             emit_source=False,
                                             device=cg.device)
            self._variants[key] = variant
        return variant

    # -- serving -----------------------------------------------------------

    def serve(self, requests):
        """Execute a batch of ``(inr_id, coords)`` queries; returns one
        output tuple per request, in request order.  Synchronous: each
        signature group is grouped, padded, dispatched, and waited for
        before the next."""
        t_batch = time.perf_counter()
        t0 = t_batch
        requests = list(requests)
        self.stats["requests"] += len(requests)
        results: list = [None] * len(requests)

        # group rows by inr_id (concatenating multiple requests per INR),
        # then inr_ids by signature — one artifact execution per signature;
        # filter-bank requests group separately by bank signature
        per_inr: "OrderedDict[str, list]" = OrderedDict()
        bank_groups: "OrderedDict[str, list]" = OrderedDict()
        with TRACER.span("serve.group", cat="serve",
                         requests=len(requests)):
            for k, (inr_id, coords) in enumerate(requests):
                if inr_id in self._bank_routes:
                    sig, j = self._bank_routes[inr_id]
                    bank_groups.setdefault(sig, []).append(
                        (k, j, torch.as_tensor(coords)))
                    continue
                if inr_id not in self._routes:
                    raise KeyError(f"unregistered inr_id {inr_id!r}")
                per_inr.setdefault(inr_id, []).append(
                    (k, torch.as_tensor(coords)))
            by_sig: "OrderedDict[str, list[str]]" = OrderedDict()
            for inr_id in per_inr:
                sig, _ = self._routes[inr_id]
                by_sig.setdefault(sig, []).append(inr_id)
        self.stats["host_group_s"] += time.perf_counter() - t0

        for sig, inr_ids in by_sig.items():
            self.stats["groups"] += 1
            t0 = time.perf_counter()
            with TRACER.span("serve.pad", cat="serve", sig=sig[:12]):
                coords_per_inr = {
                    i: (torch.cat([c for _, c in per_inr[i]])
                        if len(per_inr[i]) > 1 else per_inr[i][0][1])
                    for i in inr_ids}
            self.stats["host_group_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            with TRACER.span("serve.dispatch", cat="serve", sig=sig[:12],
                             inrs=len(inr_ids)):
                if len(inr_ids) == 1:
                    outs = {inr_ids[0]: self._serve_single(
                        sig, inr_ids[0], coords_per_inr[inr_ids[0]])}
                else:
                    outs = self._serve_multi(sig, inr_ids, coords_per_inr)
                _synchronize(outs)
            self.stats["device_exec_s"] += time.perf_counter() - t0
            with TRACER.span("serve.unpad", cat="serve", sig=sig[:12]):
                for inr_id in inr_ids:
                    row = 0
                    for k, c in per_inr[inr_id]:
                        n = c.shape[0]
                        results[k] = tuple(o[row:row + n]
                                           for o in outs[inr_id])
                        row += n

        # a bank group runs ONE pass of the merged graph over the union of
        # its requests' rows — every filter's output materializes in that
        # pass, and request k for filter j reads its row slice of output j
        for sig, items in bank_groups.items():
            self.stats["groups"] += 1
            self.stats["bank_groups"] += 1
            t0 = time.perf_counter()
            with TRACER.span("serve.pad", cat="serve", sig=sig[:12]):
                coords = (torch.cat([c for _, _, c in items])
                          if len(items) > 1 else items[0][2])
            self.stats["host_group_s"] += time.perf_counter() - t0
            bank = self._bank(sig)
            self.stats["rows"] += int(coords.shape[0])
            self.stats["padded_rows"] += \
                (-int(coords.shape[0])) % bank.cg.config.block
            t0 = time.perf_counter()
            with TRACER.span("serve.dispatch", cat="serve", sig=sig[:12],
                             bank=True):
                outs = self._run_placed(bank.apply_batched, bank.cg, coords,
                                        0)
                _synchronize({sig: outs})
            self.stats["device_exec_s"] += time.perf_counter() - t0
            with TRACER.span("serve.unpad", cat="serve", sig=sig[:12]):
                row = 0
                for k, j, c in items:
                    n = int(c.shape[0])
                    results[k] = (outs[j][row:row + n],)
                    row += n
        if requests:
            _LAT_BATCH.observe(time.perf_counter() - t_batch,
                               engine=self.stats.labels["engine"])
        return results

    def _serve_single(self, sig: str, inr_id: str, coords):
        _, wid = self._routes[inr_id]
        cg = self._serving_artifact(sig)
        self.stats["rows"] += int(coords.shape[0])
        self.stats["padded_rows"] += (-int(coords.shape[0])) % cg.config.block
        if wid != self._base_wid.get(sig):
            # not the base artifact's weight set: run the K=1 multi path
            # with this INR's payload (resident swap, no recompilation)
            m = self._multi_artifact(sig, (wid,))
            if m.k_sharded:
                outs = m.apply_batched(coords[None])
            else:
                outs = self._run_placed(m.apply_batched, m.base,
                                        coords[None], 1)
            return tuple(o[0] for o in outs)
        return self._run_placed(cg.apply_batched, cg, coords, 0)

    def _serve_multi(self, sig: str, inr_ids, coords_per_inr):
        self.stats["multi_groups"] += 1
        wids = tuple(self._routes[i][1] for i in inr_ids)
        m = self._multi_artifact(sig, wids)
        block = m.base.config.block
        counts = [int(coords_per_inr[i].shape[0]) for i in inr_ids]
        n_max = max(counts)
        n_pad = n_max + (-n_max) % block
        batch = torch.stack([pad_rows(coords_per_inr[i], n_pad)
                             for i in inr_ids])          # [K, n_pad, ...]
        self.stats["rows"] += sum(counts)
        self.stats["padded_rows"] += n_pad * len(counts) - sum(counts)
        if m.k_sharded:
            # the artifact splits the K axis itself (rows stay shard-local)
            self.stats["k_sharded_batches"] += 1
            outs = m.apply_batched(batch)                # each [K, n_pad, ...]
        else:
            outs = self._run_placed(m.apply_batched, m.base, batch, 1)
        return {i: tuple(o[k, :counts[k]] for o in outs)
                for k, i in enumerate(inr_ids)}

    # -- introspection -----------------------------------------------------

    def describe(self) -> str:
        st = self.stats
        mesh = (f", mesh {dict(self.sharding.mesh.shape)}"
                f"{' (shard_chunking)' if self.shard_chunking else ''}"
                if self.sharding is not None else "")
        lines = [f"ServingEngine: {len(self._routes)} INRs + "
                 f"{len(self._bank_routes)} bank filters over "
                 f"{len(self._artifacts) + len(self._banks)} "
                 f"in-process artifacts "
                 f"({len(self._multi)}/{self._multi.cap} multi-INR stacks, "
                 f"{len(self._payloads)}/{self._payloads.cap} payloads), "
                 f"store={'yes' if self.store is not None else 'no'}, "
                 f"device={self.device}{mesh}",
                 f"  stats: {st}",
                 f"  phases: host_group {st['host_group_s'] * 1e3:.1f}ms | "
                 f"device_exec {st['device_exec_s'] * 1e3:.1f}ms"]
        for inr_id in sorted(self._routes):
            sig, wid = self._routes[inr_id]
            lines.append(f"  {inr_id} -> {sig} / {wid}")
        for fid in sorted(self._bank_routes):
            sig, j = self._bank_routes[fid]
            lines.append(f"  {fid} -> bank {sig} [out {j}]")
        return "\n".join(lines)
