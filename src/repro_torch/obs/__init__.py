"""Telemetry of the port: metrics registry, request-lifecycle tracing and
kernel-dispatch profiling, all on the host.

  * :mod:`repro_torch.obs.metrics` — counters, gauges and bounded-reservoir
    histograms behind a :class:`MetricsRegistry`, with a JSON snapshot and
    Prometheus text. The serving engine and the block pool emit through it.
  * :mod:`repro_torch.obs.trace` — span / event tracer writing Chrome-trace
    (Perfetto) JSON; its spans also enter ``torch.profiler.record_function``
    so they line up with CUDA activity in a profiler trace.
  * :mod:`repro_torch.obs.dispatch` — which mpGEMM plan (shape key, fusion,
    tile, split-K count) ran, tuned or heuristic.
"""

from repro_torch.obs import dispatch
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, export_stats)
from repro_torch.obs.trace import Tracer, load_trace, validate_chrome_trace

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "export_stats", "Tracer", "load_trace", "validate_chrome_trace",
           "dispatch"]
