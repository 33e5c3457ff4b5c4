"""AsyncServingEngine — double-buffered dispatch + continuous batching (port
of ``repro.serve.async_engine``).

The synchronous ``ServingEngine.serve`` runs each request group as
group → pad → dispatch → WAIT: the host sits idle while the card executes,
and every request pays its own padding and dispatch overhead.  This module
overlaps those phases (DESIGN.md §8):

  * ``submit(inr_id, coords)`` returns a ticket immediately; rows are
    appended to a per-signature admission queue, NOT dispatched.
  * An admission pump coalesces pending rows into FULL serving chunks
    (``config.chunk_blocks * block`` rows) and dispatches them through the
    artifact's chunk step (``apply_chunk``: one launch per execution unit)
    the moment a chunk fills.  CUDA launches are asynchronous, so while the
    card executes chunk *i* the host is already grouping and padding chunk
    *i+1* — double buffering with a bounded in-flight queue (``inflight``,
    default two-deep: one executing, one queued).  Each dispatched item
    carries a CUDA event recorded on the current stream right after its
    launches.  When the queue is full the oldest item is retired first
    (waiting on ITS event only, never on the whole device, so the chunk
    queued behind it keeps the card busy); between dispatches ready items
    are retired opportunistically (``event.query()``, non-blocking).
    Retirement only WAITS on device results — the host-side unpad/scatter
    of a retired chunk is deferred until right after the NEXT dispatch
    launches, so that host work overlaps the new chunk's device execution
    (``stats["host_unpad_s"]`` times it).  Nothing between ``submit`` and
    the launches reads device data back to the host.
  * ``drain()`` flushes the remainders (a lane's rows short of a chunk go
    out as one pass, edge-padded to a block multiple), retires everything
    in flight, and returns results for every outstanding ticket IN
    SUBMISSION ORDER.

Continuous batching.  Admission happens at CHUNK BOUNDARIES: a chunk's
rows may span several tickets (requests coalesce — the win over
serve-on-arrival), and for a signature served by several INRs the pump
builds multi-INR chunks whose K lanes are exactly the INRs with pending
rows at that boundary.  A request that arrives mid-stream joins the lane
set at the next chunk (admission); a lane whose rows are exhausted leaves
it (eviction).  Lanes shorter than the chunk are padded with their own
edge row — padding never reaches a caller.

Parity.  Every op in the pipeline is row-wise, and the kernels' summation
order does not depend on a launch's row count, so repacking rows across
chunk boundaries returns results ``torch.equal`` to the synchronous path.
The fixed lane generation, the stats and the admission/eviction order are
the reference's: the port keeps them although it has no XLA K = 1
specialisation to protect.  The one difference is the flush: the
reference sends a lane's remainder block by block through its fixed-shape
block step, the port as one pass (``async_blocks`` and ``padded_rows``
still count per block, so the stats equal the reference's; only
``max_inflight`` may read lower).

Routing matches the sync engine at each dispatch: a signature whose only
pending lane is the base weight set takes the single-INR fast path;
anything else takes the multi-INR (stacked-resident) path.  Under
``sharding=`` (passed through to ``ServingEngine``) a multi-INR chunk whose
K axis the policy shards runs K-sharded and a bank pass splits its rows
over the data axes, as ``serve`` does; full single-INR chunks run whole,
as the reference's do.  ``serve_async`` stays ``torch.equal`` to ``serve``
where the kernels' results do not depend on a launch's row count.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import torch

from repro_torch.core.executor import torch_dtype
from repro_torch.obs.metrics import counter as _obs_counter, histogram
from repro_torch.obs.tracing import TRACER
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.multi_inr import pad_rows

# async-only stats keys layered onto the inherited engine view
_ASYNC_METRICS = {
    "submitted": ("serve_submitted", "requests submitted (async)"),
    "async_chunks": ("serve_async_chunks",
                     "full single-INR chunks dispatched"),
    "async_blocks": ("serve_async_blocks", "remainder blocks dispatched"),
    "async_multi_chunks": ("serve_async_multi_chunks",
                           "multi-INR chunks dispatched"),
    "admissions": ("serve_admissions",
                   "lane admissions at chunk boundaries"),
    "evictions": ("serve_evictions", "lane evictions at chunk boundaries"),
    "max_inflight": ("serve_max_inflight", "peak dispatch queue depth"),
    "host_unpad_s": ("serve_host_unpad_s",
                     "host time unpadding retired chunks (overlapped)"),
}

# per-request latency histograms (DESIGN.md §10): queue-wait is the time a
# dispatched item sat in flight before retirement began; request latency is
# submit (admission) to the scatter of the request's final row
_LAT_QUEUE = histogram("serve_queue_wait_latency_s",
                       "per-item dispatch-to-retire queue wait")
_LAT_REQ = histogram("serve_request_latency_s",
                     "per-request submit-to-retire latency")


@dataclass
class _Ticket:
    """One submitted request: assembly state for its results."""
    inr_id: str
    sig: str
    wid: str
    n: int                                   # rows requested
    filled: int = 0                          # rows scattered so far
    t_submit: float = 0.0                    # admission time (latency histo)
    bank_j: int = -1                         # bank output index (-1: not bank)
    # streamed-output position -> [(row offset in ticket, slice), ...]
    parts: dict = field(default_factory=dict)

    def scatter(self, o_idx: int, tstart: int, val) -> None:
        self.parts.setdefault(o_idx, []).append((tstart, val))


@dataclass
class _Pending:
    """A lane of not-yet-dispatched rows for one INR (FIFO of ticket
    slices)."""
    slices: deque = field(default_factory=deque)   # (ticket_idx, coords, tstart)
    rows: int = 0
    feat_shape: tuple = ()
    dtype: object = None
    device: object = None

    def push(self, ticket_idx: int, coords, tstart: int = 0) -> None:
        self.slices.append((ticket_idx, coords, tstart))
        self.rows += int(coords.shape[0])
        self.feat_shape = tuple(coords.shape[1:])
        self.dtype = coords.dtype
        self.device = coords.device

    def take(self, n: int):
        """Pop up to ``n`` rows; returns (coords [m, ...], scatter) where
        scatter is [(ticket_idx, tstart, start-in-coords, count), ...].
        A drained lane yields 0 rows (an exhausted generation lane rides
        along as padding)."""
        cols, scatter, got = [], [], 0
        while got < n and self.slices:
            ti, c, tstart = self.slices.popleft()
            m = int(c.shape[0])
            if got + m <= n:
                cols.append(c)
                scatter.append((ti, tstart, got, m))
                got += m
            else:
                take = n - got
                cols.append(c[:take])
                scatter.append((ti, tstart, got, take))
                self.slices.appendleft((ti, c[take:], tstart + take))
                got = n
        self.rows -= got
        if not cols:
            return torch.zeros((0,) + self.feat_shape, dtype=self.dtype,
                               device=self.device), scatter
        coords = cols[0] if len(cols) == 1 else torch.cat(cols)
        return coords, scatter


@dataclass
class _InFlight:
    """A dispatched (not yet retired) device computation."""
    kind: str                  # "chunk" | "multi" | "bank"
    outs: tuple                # streamed outputs, still materializing
    scatter: list              # entries, shape depends on kind
    t_dispatch: float
    rows: int
    event: object = None       # torch.cuda.Event after the launches (CUDA)

    def ready(self) -> bool:
        """Non-blocking: have the item's launches finished?  A CPU item is
        always ready (its outputs existed when the call returned)."""
        return self.event is None or self.event.query()


class AsyncServingEngine(ServingEngine):
    """ServingEngine with asynchronous, continuously-batched dispatch.

    ``inflight`` bounds the dispatch queue depth (2 = double buffering).
    ``serve`` (inherited) stays available as the synchronous baseline;
    ``serve_async`` is its overlapped equivalent and returns results
    ``torch.equal`` to it, in the same request order.
    """

    def __init__(self, store=None, *, inflight: int = 2, **kw):
        super().__init__(store, **kw)
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        self.inflight = int(inflight)
        self._tickets: list[_Ticket] = []
        self._retired: deque[_InFlight] = deque()   # awaiting host unpad
        self._drained_upto = 0
        # sig -> OrderedDict[inr_id -> _Pending]  (admission queues)
        self._pending: "OrderedDict[str, OrderedDict[str, _Pending]]" = \
            OrderedDict()
        # bank sig -> _Pending: ONE lane per bank — filter requests of one
        # bank share the merged graph, so their rows coalesce into a single
        # concatenated pass per admission boundary (sync-path grouping)
        self._bank_pending: "OrderedDict[str, _Pending]" = OrderedDict()
        # sig -> lane tuple fixed at the last admission boundary (see _pump)
        self._gen: dict[str, tuple[str, ...]] = {}
        self._queue: deque[_InFlight] = deque()
        for k, (name, help) in _ASYNC_METRICS.items():
            self.stats.with_key(k, _obs_counter(name, help))
        self.stats.reset()       # async keys start at zero on this label

    # -- submission --------------------------------------------------------

    def _enqueue(self, inr_id: str, coords) -> int:
        t0 = time.perf_counter()
        if inr_id in self._bank_routes:
            return self._enqueue_bank(inr_id, coords, t0)
        if inr_id not in self._routes:
            raise KeyError(f"unregistered inr_id {inr_id!r}")
        sig, wid = self._routes[inr_id]
        coords = torch.as_tensor(coords, device=self.device)
        ticket = len(self._tickets)
        self._tickets.append(_Ticket(inr_id, sig, wid, int(coords.shape[0]),
                                     t_submit=t0))
        self.stats["submitted"] += 1
        self.stats["requests"] += 1
        if coords.shape[0]:
            lanes = self._pending.setdefault(sig, OrderedDict())
            if inr_id not in lanes:
                lanes[inr_id] = _Pending()
                self.stats["admissions"] += 1
            lanes[inr_id].push(ticket, coords)
        self.stats["host_group_s"] += time.perf_counter() - t0
        return ticket

    def _enqueue_bank(self, fid: str, coords, t0: float) -> int:
        """Queue a filter-bank request: all filters of one bank share a
        single pending lane — their rows run as ONE concatenated pass of
        the merged graph at the next admission boundary."""
        sig, j = self._bank_routes[fid]
        coords = torch.as_tensor(coords, device=self.device)
        ticket = len(self._tickets)
        self._tickets.append(_Ticket(fid, sig, "", int(coords.shape[0]),
                                     t_submit=t0, bank_j=j))
        self.stats["submitted"] += 1
        self.stats["requests"] += 1
        if coords.shape[0]:
            if sig not in self._bank_pending:
                self._bank_pending[sig] = _Pending()
                self.stats["admissions"] += 1
            self._bank_pending[sig].push(ticket, coords)
        self.stats["host_group_s"] += time.perf_counter() - t0
        return ticket

    def submit(self, inr_id: str, coords) -> int:
        """Enqueue one request; returns its ticket index.  Full chunks
        dispatch immediately (overlapping any execution in flight); partial
        rows wait for coalescing until ``drain``."""
        ticket = self._enqueue(inr_id, coords)
        self._pump(flush=False)
        self._poll()
        return ticket

    def serve_async(self, requests):
        """Asynchronous counterpart of ``serve``: enqueue every request,
        then drain — results in request order, ``torch.equal`` to one sync
        ``serve`` call over the same list.  Enqueueing the whole batch
        before the pump runs fixes each signature's lane generation to
        exactly the sync path's grouping; the double-buffered overlap
        happens across the chunks of the drain."""
        tickets = [self._enqueue(i, c) for i, c in requests]
        results = self.drain()
        base = tickets[0] if tickets else 0
        return [results[t - base] for t in tickets]

    def drain(self):
        """Flush all pending rows, retire everything in flight, and return
        the results of every ticket since the last drain, in submission
        order."""
        self._pump(flush=True)
        while self._queue:
            self._retire(self._queue.popleft())
        self._unpad_retired()
        out = [self._finalize(t)
               for t in self._tickets[self._drained_upto:]]
        self._drained_upto = len(self._tickets)
        return out

    def pending_rows(self) -> int:
        return (sum(p.rows for lanes in self._pending.values()
                    for p in lanes.values())
                + sum(p.rows for p in self._bank_pending.values()))

    # -- the admission pump ------------------------------------------------

    def _pump(self, *, flush: bool) -> None:
        """Dispatch every admissible chunk.  Admission/eviction happens at
        chunk boundaries: a newly-submitted lane joins the serving set (the
        GENERATION) at the next boundary, and that reform also drops lanes
        that have drained (eviction).  Between reforms the generation is
        FIXED — an exhausted lane rides along as padding rather than
        shrinking K, as the reference's pump does."""
        for sig in list(self._pending):
            lanes = self._pending[sig]
            gen = self._gen.get(sig)
            while True:
                live = [i for i, p in lanes.items() if p.rows > 0]
                if not live:
                    # generation fully drained: evict every lane
                    self.stats["evictions"] += len(gen or ())
                    self._gen.pop(sig, None)
                    del self._pending[sig]
                    break
                if gen is None or any(i not in gen for i in live):
                    # admission boundary: new lanes join, drained ones leave
                    if gen is not None:
                        dropped = [i for i in gen if i not in live]
                        self.stats["evictions"] += len(dropped)
                        for i in dropped:
                            lanes.pop(i, None)
                    gen = tuple(i for i in lanes if i in live)
                    self._gen[sig] = gen
                cg = self._artifact(sig)
                block = cg.config.block
                chunk_rows = cg.config.chunk_blocks * block
                single = (len(gen) == 1
                          and self._routes[gen[0]][1]
                          == self._base_wid.get(sig))
                n_max = max(lanes[i].rows for i in gen)
                if single:
                    p = lanes[gen[0]]
                    if p.rows >= chunk_rows:
                        self._dispatch_single_chunk(sig, p, chunk_rows)
                    elif flush:
                        self._flush_single(sig, p)
                    else:
                        break
                else:
                    if n_max >= chunk_rows or flush:
                        nb = min(cg.config.chunk_blocks,
                                 math.ceil(n_max / block))
                        self._dispatch_multi(sig, lanes, gen, nb)
                    else:
                        break
        self._pump_banks(flush=flush)

    def _pump_banks(self, *, flush: bool) -> None:
        """Dispatch bank lanes whose pending rows fill a chunk (or on
        flush): the whole lane goes out as ONE concatenated pass of the
        merged graph — the sync path's per-signature bank grouping, so the
        ``bank_groups`` counter advances identically."""
        for sig in list(self._bank_pending):
            p = self._bank_pending[sig]
            bank = self._bank(sig)
            chunk_rows = bank.cg.config.chunk_blocks * bank.cg.config.block
            if p.rows and (p.rows >= chunk_rows or flush):
                self._dispatch_bank(sig, p)
            if p.rows == 0:
                self.stats["evictions"] += 1
                del self._bank_pending[sig]

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, item: _InFlight) -> None:
        if self.device.type == "cuda":
            # marks the end of the item's launches on the current stream:
            # _poll queries it, _retire waits on it alone
            item.event = torch.cuda.Event()
            item.event.record(torch.cuda.current_stream(self.device))
        while len(self._queue) >= self.inflight:
            self._retire(self._queue.popleft())
        self._queue.append(item)
        self.stats["max_inflight"] = max(self.stats["max_inflight"],
                                         len(self._queue))
        # the item just dispatched is executing on the card NOW — scatter
        # any retired results while it runs (host unpad overlaps device exec)
        self._unpad_retired()

    def _dispatch_single_chunk(self, sig: str, p: _Pending,
                               chunk_rows: int) -> None:
        with TRACER.span("serve.chunk", cat="serve", sig=sig[:12],
                         rows=chunk_rows):
            t0 = time.perf_counter()
            cg = self._artifact(sig)
            block = cg.config.block
            with TRACER.span("serve.pad", cat="serve"):
                coords, scatter = p.take(chunk_rows)
                xc = coords.reshape(chunk_rows // block, block,
                                    *coords.shape[1:])
            self.stats["host_group_s"] += time.perf_counter() - t0
            self.stats["async_chunks"] += 1
            self.stats["rows"] += chunk_rows
            with TRACER.span("serve.dispatch", cat="serve"):
                outs = cg.apply_chunk(xc)
            self._dispatch(_InFlight("chunk", outs, scatter,
                                     time.perf_counter(), chunk_rows))

    def _flush_single(self, sig: str, p: _Pending) -> None:
        """Drain a partial single-INR lane (fewer rows than a chunk) as ONE
        pass of its remaining blocks, the last edge-padded (padding rows
        are never scattered) — the remainder pass of the sync path's
        ``apply_batched``.  Stats count per block, as the reference's
        block-by-block flush does."""
        cg = self._artifact(sig)
        block = cg.config.block
        with TRACER.span("serve.block", cat="serve", sig=sig[:12],
                         rows=p.rows):
            t0 = time.perf_counter()
            n = p.rows
            nb = math.ceil(n / block)
            with TRACER.span("serve.pad", cat="serve"):
                coords, scatter = p.take(n)
                xc = pad_rows(coords, nb * block).reshape(
                    nb, block, *coords.shape[1:])
            self.stats["rows"] += n
            self.stats["padded_rows"] += nb * block - n
            self.stats["host_group_s"] += time.perf_counter() - t0
            self.stats["async_blocks"] += nb
            with TRACER.span("serve.dispatch", cat="serve"):
                outs = cg.apply_chunk(xc)
            self._dispatch(_InFlight("chunk", outs, scatter,
                                     time.perf_counter(), n))

    def _dispatch_multi(self, sig: str, lanes, active, nb: int) -> None:
        """One continuous-batching round: a [nb, K, block, ...] chunk whose
        K lanes are the INRs admitted at this boundary."""
        with TRACER.span("serve.chunk.multi", cat="serve", sig=sig[:12],
                         lanes=len(active)):
            t0 = time.perf_counter()
            cg = self._artifact(sig)
            block = cg.config.block
            take = nb * block
            wids = tuple(self._routes[i][1] for i in active)
            m = self._multi_artifact(sig, wids)
            cols, scatter = [], []
            for k, inr_id in enumerate(active):
                p = lanes[inr_id]
                with TRACER.span("serve.pad", cat="serve", tid=k + 1,
                                 lane=inr_id):
                    n = min(p.rows, take)
                    coords, sc = p.take(n)
                    cols.append(pad_rows(coords, take))
                self.stats["rows"] += n
                self.stats["padded_rows"] += take - n
                scatter.extend((ti, tstart, k, start, count)
                               for ti, tstart, start, count in sc)
            batch = torch.stack(cols)                  # [K, take, ...]
            xb = batch.reshape(len(active), nb, block,
                               *batch.shape[2:]).movedim(0, 1)
            self.stats["host_group_s"] += time.perf_counter() - t0
            self.stats["async_multi_chunks"] += 1
            if m.k_sharded:
                self.stats["k_sharded_batches"] += 1
            with TRACER.span("serve.dispatch", cat="serve"):
                outs = m.apply_chunk(xb)
            self._dispatch(_InFlight("multi", outs, scatter,
                                     time.perf_counter(),
                                     take * len(active)))

    def _dispatch_bank(self, sig: str, p: _Pending) -> None:
        """One concatenated bank pass: every pending filter request of the
        bank rides one streamed execution of the merged multi-output graph
        (request k for filter j later reads its row slice of output j)."""
        with TRACER.span("serve.chunk.bank", cat="serve", sig=sig[:12],
                         rows=p.rows):
            t0 = time.perf_counter()
            bank = self._bank(sig)
            n = p.rows
            with TRACER.span("serve.pad", cat="serve"):
                coords, scatter = p.take(n)
            self.stats["host_group_s"] += time.perf_counter() - t0
            self.stats["bank_groups"] += 1
            self.stats["rows"] += n
            self.stats["padded_rows"] += (-n) % bank.cg.config.block
            with TRACER.span("serve.dispatch", cat="serve", bank=True):
                outs = self._run_placed(bank.apply_batched, bank.cg, coords,
                                        0)
            self._dispatch(_InFlight("bank", outs, scatter,
                                     time.perf_counter(), n))

    # -- retirement / assembly ---------------------------------------------

    def _poll(self) -> None:
        """Retire ready items without blocking (front of the queue first —
        retiring out of order would not preserve FIFO depth semantics)."""
        while self._queue and self._queue[0].ready():
            self._retire(self._queue.popleft())

    def _retire(self, item: _InFlight) -> None:
        """Wait until the item's launches are done (its own event, never
        the whole device), then queue it for host-side scatter.  The
        scatter itself (``_unpad_retired``) is DEFERRED: ``_dispatch`` runs
        it right after launching the next chunk, so unpadding retired
        results overlaps that chunk's device execution instead of sitting
        on the critical path."""
        t0 = time.perf_counter()
        wait = t0 - item.t_dispatch
        self.stats["queue_wait_s"] += wait
        _LAT_QUEUE.observe(wait, engine=self.stats.labels["engine"])
        with TRACER.span("serve.retire", cat="serve", kind=item.kind,
                         rows=item.rows):
            if item.event is not None:
                item.event.synchronize()
        self.stats["device_exec_s"] += time.perf_counter() - t0
        self._retired.append(item)

    def _unpad_retired(self) -> None:
        """Scatter every retired item's rows into its tickets (dropping
        padding — it never reaches a caller), timed as ``host_unpad_s``."""
        if not self._retired:
            return
        t0 = time.perf_counter()
        with TRACER.span("serve.unpad", cat="serve",
                         items=len(self._retired)):
            while self._retired:
                self._scatter_item(self._retired.popleft())
        self.stats["host_unpad_s"] += time.perf_counter() - t0

    def _scatter_item(self, item: _InFlight) -> None:
        if item.kind == "multi":
            # outs: each [nb, K, block, ...] -> per-lane flat rows
            flat = [o.movedim(0, 1).reshape(
                        o.shape[1], o.shape[0] * o.shape[2], *o.shape[3:])
                    for o in item.outs]
            for ti, tstart, lane, start, count in item.scatter:
                t = self._tickets[ti]
                for o_idx, o in enumerate(flat):
                    t.scatter(o_idx, tstart, o[lane, start:start + count])
                t.filled += count
                self._observe_ticket(t)
        elif item.kind == "bank":
            # outs: one [N, ...] tensor per bank output, already row-flat;
            # each ticket reads only ITS filter's output
            for ti, tstart, start, count in item.scatter:
                t = self._tickets[ti]
                t.scatter(0, tstart,
                          item.outs[t.bank_j][start:start + count])
                t.filled += count
                self._observe_ticket(t)
        else:
            # "chunk": each [nb, block, ...] -> flat rows
            flat = [o.reshape(o.shape[0] * o.shape[1], *o.shape[2:])
                    for o in item.outs]
            for ti, tstart, start, count in item.scatter:
                t = self._tickets[ti]
                for o_idx, o in enumerate(flat):
                    t.scatter(o_idx, tstart, o[start:start + count])
                t.filled += count
                self._observe_ticket(t)

    def _observe_ticket(self, t: _Ticket) -> None:
        """Record submit-to-last-row latency once a ticket fills."""
        if t.n > 0 and t.filled == t.n and t.t_submit:
            _LAT_REQ.observe(time.perf_counter() - t.t_submit,
                             engine=self.stats.labels["engine"])

    def _finalize(self, t: _Ticket):
        if t.bank_j >= 0:
            return self._finalize_bank(t)
        cg = self._artifact(t.sig)
        if t.filled != t.n:
            raise RuntimeError(f"ticket for {t.inr_id!r} assembled "
                               f"{t.filled}/{t.n} rows")
        outs = []
        s_idx = 0
        for o in cg.graph.outputs:
            if o in cg.plan.resident:
                outs.append(self._resident_out(t, o))
                continue
            if t.n == 0:
                node = cg.graph.nodes[o]
                outs.append(torch.zeros(
                    (0,) + tuple(node.shape[1:]),
                    dtype=torch_dtype(node.dtype), device=self.device))
            else:
                parts = sorted(t.parts[s_idx], key=lambda p: p[0])
                cols = [v for _, v in parts]
                outs.append(cols[0] if len(cols) == 1 else torch.cat(cols))
            s_idx += 1
        return tuple(outs)

    def _finalize_bank(self, t: _Ticket):
        """A bank ticket returns a 1-tuple: its filter's output rows (the
        sync path's ``(outs[j][row:row+n],)`` shape)."""
        if t.filled != t.n:
            raise RuntimeError(f"ticket for {t.inr_id!r} assembled "
                               f"{t.filled}/{t.n} rows")
        if t.n == 0:
            g = self._bank(t.sig).cg.graph
            node = g.nodes[g.outputs[t.bank_j]]
            return (torch.zeros((0,) + tuple(node.shape[1:]),
                                dtype=torch_dtype(node.dtype),
                                device=self.device),)
        parts = sorted(t.parts[0], key=lambda p: p[0])
        cols = [v for _, v in parts]
        return (cols[0] if len(cols) == 1 else torch.cat(cols),)

    def _resident_out(self, t: _Ticket, o: int):
        """Resident (const-derived) outputs depend on the weight set, not
        the rows: base weights read the artifact's own residents, any other
        set reads its (cached) K=1 stacked residents — the same values the
        sync multi path returns."""
        if t.wid == self._base_wid.get(t.sig):
            return self._artifact(t.sig).resident_output(o, t.n)
        m = self._multi_artifact(t.sig, (t.wid,))
        return m.resident_output(o, t.n)[0]

    # -- introspection -----------------------------------------------------

    def describe(self) -> str:
        st = self.stats
        return (super().describe()
                + f"\n  async phases: host_unpad "
                f"{st['host_unpad_s'] * 1e3:.1f}ms (overlapped)"
                + f"\n  async: inflight<= {self.inflight} "
                f"(peak {st['max_inflight']}), "
                f"{st['async_chunks']} chunks / {st['async_blocks']} blocks "
                f"/ {st['async_multi_chunks']} multi-chunks dispatched, "
                f"{st['admissions']} lane admissions / "
                f"{st['evictions']} evictions, "
                f"{self.pending_rows()} rows pending")
