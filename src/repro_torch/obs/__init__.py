"""repro_torch.obs — the port's telemetry layer (port of ``repro.obs``).

  * **metrics** — the process-global ``REGISTRY`` of labeled counters /
    gauges / histograms; ``ServingEngine.stats``, ``ArtifactStore.stats``
    and ``pipeline._STATS`` are read-through ``MetricsView``s over it;
  * **tracing** — the global ``TRACER`` of nestable host spans around the
    serve phases, exportable as Chrome/Perfetto trace-event JSON.

Drift reports and the logger (``repro.obs.drift``, ``repro.obs.log``) are
not ported yet (ROADMAP Queue 1 item 10).
"""

from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, MetricsView, counter,
                                     gauge, histogram)
from repro_torch.obs.tracing import TRACER, SpanEvent, Tracer, span

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "MetricsView", "counter", "gauge", "histogram",
    "TRACER", "SpanEvent", "Tracer", "span",
]
