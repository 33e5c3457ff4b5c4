"""The harness's spans and its reading of the profiler's trace.

Spans are host-clock ranges named ``bench.*`` around each call the
harness makes into a layer of the program, stamped with ``time.time_ns``
(the clock the profiler puts its device events on); with tracing off they
cost nothing.  The profiler records the card's activity only, so the host
pays no cost per PyTorch operation.  ``read`` keeps the device's
operations inside the ``bench.window`` span and reduces them to busy and
kernel time, the operations that took most time, and the longest idle
gaps labelled by the harness span in force.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

from inrbench.stats import merged

WINDOW = "bench.window"


class Spans:
    """``with spans("bench.request"):`` records ``(name, start_ns, end_ns)``
    in ``spans.done`` when ``on``; else it is a no-op context."""

    def __init__(self, on: bool):
        self.on = on
        self.done: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.done.append((name, t0, time.time_ns()))

    def __call__(self, name: str):
        return self._span(name) if self.on else contextlib.nullcontext()


@dataclass
class TraceReport:
    window_s: float                  # the traced window, by the trace
    busy_s: float                    # union of device operations
    kernel_s: float                  # summed kernel time
    copy_s: float                    # summed memcpy / memset time
    device_ops: list = field(default_factory=list)   # [[name, s]] top 10
    idle_gaps: list = field(default_factory=list)    # [[span, s]] top 10
    idle_by_span: dict = field(default_factory=dict)  # span -> idle s
    n_device_ops: int = 0
    n_outside: int = 0               # device ops of the trace outside it

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type()) or "GPU" in str(ev.device_type())


def _is_annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else ev.name().startswith("bench.")


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def read(prof, spans, top: int = 10) -> TraceReport | None:
    """Reduce a finished ``torch.profiler.profile`` and the harness's
    ``spans`` (``(name, start_ns, end_ns)``) to a ``TraceReport``; None
    when there is no ``bench.window`` span or no device operation inside
    it."""
    dev = []
    for ev in prof.profiler.kineto_results.events():
        if _is_device(ev) and not _is_annotation(ev):
            start = _ns(ev, "start")
            dev.append((start, start + _ns(ev, "duration"), ev.name()))
    spans = [(s, e, n) for n, s, e in spans]
    win = [(s, e) for s, e, n in spans if n == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    n_all = len(dev)
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev
           if e > w0 and s < w1]
    if not dev:
        return None
    by_name: dict[str, float] = defaultdict(float)
    kernel = copy = 0
    for s, e, n in dev:
        by_name[n] += (e - s) / 1e9
        if _is_copy(n):
            copy += e - s
        else:
            kernel += e - s
    busy = merged([(s, e) for s, e, _ in dev])
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # the harness's spans nest, so a sweep with a stack finds the innermost
    # span in force at each gap's midpoint
    inner = sorted((s, e, n) for s, e, n in spans if n != WINDOW)
    labelled, stack, k = [], [], 0
    for a, b in gaps:               # gaps come in time order
        mid = (a + b) // 2
        while k < len(inner) and inner[k][0] <= mid:
            stack.append(inner[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        labelled.append((stack[-1][2] if stack else WINDOW, (b - a) / 1e9))
    idle_by: dict[str, float] = defaultdict(float)
    for n, s in labelled:
        idle_by[n] += s
    return TraceReport(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        kernel_s=kernel / 1e9, copy_s=copy / 1e9,
        device_ops=[[n, s] for n, s in sorted(by_name.items(),
                                              key=lambda t: -t[1])[:top]],
        idle_gaps=[[n, s] for n, s in sorted(labelled,
                                             key=lambda t: -t[1])[:top]],
        idle_by_span=dict(idle_by), n_device_ops=len(dev),
        n_outside=n_all - len(dev))
