"""repro_torch.obs — the port's telemetry layer (port of ``repro.obs``).

  * **metrics** — the process-global ``REGISTRY`` of labeled counters /
    gauges / histograms; ``ServingEngine.stats``, ``ArtifactStore.stats``
    and ``pipeline._STATS`` are read-through ``MetricsView``s over it;
  * **tracing** — the global ``TRACER`` of nestable host spans around every
    compile stage and serve phase, exportable as Chrome/Perfetto
    trace-event JSON;
  * **drift** — ``drift_report(cg)``: the compile-time cost model
    (predicted row-cycles and modeled HBM bytes per block, recorded on every
    artifact as ``cg.perf_model``) against each unit's measured time, plus
    FIFO high-water against configured depth as deadlock headroom.

Plus ``get_logger``, the level-controlled structured logger (quiet by
default under pytest).

``drift`` imports ``repro_torch.core`` (it replays execution units), while
the core modules import ``obs.metrics`` / ``obs.tracing`` at module top, so
the drift names load lazily here (PEP 562) to keep the import graph
acyclic.
"""

from repro_torch.obs.log import current_level, get_logger, set_level
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, MetricsView, counter,
                                     gauge, histogram)
from repro_torch.obs.tracing import TRACER, SpanEvent, Tracer, span

_DRIFT_NAMES = ("DriftReport", "FifoHeadroom", "UnitDrift",
                "build_perf_model", "drift_report", "fifo_high_water")


def __getattr__(name):
    if name in _DRIFT_NAMES or name == "drift":
        import importlib
        drift = importlib.import_module("repro_torch.obs.drift")
        if name == "drift":
            return drift
        return getattr(drift, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "MetricsView", "counter", "gauge", "histogram",
    "TRACER", "SpanEvent", "Tracer", "span",
    "current_level", "get_logger", "set_level",
    *_DRIFT_NAMES,
]
