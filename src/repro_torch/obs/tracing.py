"""The port's own copy of ``repro.obs.tracing`` (the port imports nothing of
the JAX package); keep the two in step.

Nestable span tracing with Chrome/Perfetto trace-event export.

Spans wrap host-side phases only — compile stages (trace → passes →
segment plan → region plan → autoconfig → codegen) and serve phases
(group → pad → dispatch → retire → unpad).  Nothing inside a jitted
kernel can be spanned from Python; device time shows up as the duration
of the host span that blocks on it.

The tracer is OFF by default.  When disabled, ``span()`` costs one
attribute read and yields a shared null object — cheap enough to leave
in every hot path (the obs benchmark gates total overhead at ≤5%).
When enabled, each span records ``perf_counter_ns`` start/duration plus
free-form args, and ``export_chrome()`` emits the standard trace-event
JSON (``ph: "X"`` complete events, microsecond timestamps) that
https://ui.perfetto.dev and chrome://tracing open directly.

Nesting is implicit: trace viewers reconstruct parent/child from
containment of [ts, ts+dur) intervals per (pid, tid) track, so a
``serve.chunk`` span opened inside ``serve.drain`` renders nested
without explicit parent ids.  Per-lane async phases pass ``tid=`` to get
their own track.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class SpanEvent:
    name: str
    cat: str
    ts_ns: int          # perf_counter_ns at span open
    dur_ns: int         # span duration
    tid: int
    args: dict = field(default_factory=dict)


class _NullSpan:
    """What ``span()`` yields when tracing is disabled (and also when
    enabled — the yielded handle only matters for ``set``)."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass


_NULL = _NullSpan()


class _LiveSpan:
    __slots__ = ("args",)

    def __init__(self, args: dict):
        self.args = args

    def set(self, **kw) -> None:
        """Attach args discovered while the span is open (e.g. the number
        of groups a serve round produced)."""
        self.args.update(kw)


class Tracer:
    """Collects SpanEvents; one per process (module-level ``TRACER``)."""

    def __init__(self):
        self.enabled = False
        self.events: list[SpanEvent] = []
        self._lock = threading.Lock()
        self._origin_ns = time.perf_counter_ns()

    # -- control -----------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self._origin_ns = time.perf_counter_ns()

    @contextmanager
    def enabled_scope(self):
        """Enable tracing for a with-block, restoring the prior state."""
        prev = self.enabled
        self.enabled = True
        try:
            yield self
        finally:
            self.enabled = prev

    # -- recording ---------------------------------------------------------

    @contextmanager
    def span(self, name: str, cat: str = "obs", tid: int = 0, **args):
        if not self.enabled:
            yield _NULL
            return
        live_args = dict(args)
        t0 = time.perf_counter_ns()
        try:
            yield _LiveSpan(live_args)
        finally:
            dur = time.perf_counter_ns() - t0
            with self._lock:
                self.events.append(
                    SpanEvent(name=name, cat=cat, ts_ns=t0, dur_ns=dur,
                              tid=tid, args=live_args))

    def instant(self, name: str, cat: str = "obs", tid: int = 0, **args):
        """Zero-duration marker (renders as a tick on the timeline)."""
        if not self.enabled:
            return
        with self._lock:
            self.events.append(
                SpanEvent(name=name, cat=cat, ts_ns=time.perf_counter_ns(),
                          dur_ns=0, tid=tid, args=dict(args)))

    # -- export ------------------------------------------------------------

    def export_chrome(self) -> dict:
        """Chrome/Perfetto trace-event JSON (the ``traceEvents`` array of
        ``ph: "X"`` complete events; timestamps in microseconds relative
        to the first event so the viewer opens at t=0)."""
        with self._lock:
            events = list(self.events)
        origin = min((e.ts_ns for e in events), default=self._origin_ns)
        out = []
        for e in events:
            out.append({
                "name": e.name,
                "cat": e.cat,
                "ph": "X",
                "ts": (e.ts_ns - origin) / 1000.0,
                "dur": e.dur_ns / 1000.0,
                "pid": os.getpid(),
                "tid": e.tid,
                "args": e.args,
            })
        out.sort(key=lambda ev: (ev["tid"], ev["ts"], -ev["dur"]))
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome_json(self, path: str | None = None) -> str:
        doc = json.dumps(self.export_chrome(), default=str)
        if path is not None:
            with open(path, "w") as f:
                f.write(doc)
        return doc

    def span_names(self) -> list[str]:
        with self._lock:
            return [e.name for e in self.events]


TRACER = Tracer()


def span(name: str, cat: str = "obs", tid: int = 0, **args):
    """Module-level shortcut: ``with obs.span("compile.trace"): ...``"""
    return TRACER.span(name, cat=cat, tid=tid, **args)
