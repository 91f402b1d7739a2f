"""Observability for the port: metrics registry + span tracing.

The port's own copy of the JAX package's `repro/obs/` (pure Python; the
port never imports the JAX package).

`Obs` bundles the two surfaces every instrumented component takes as an
optional ``obs=`` parameter:

  * ``obs.metrics`` — a `MetricsRegistry` (always present; creating one is
    cheap and components need it for their `metrics()` readouts);
  * ``obs.tracer`` — an optional `Tracer`; when absent, `obs.span(...)` /
    `obs.instant(...)` are no-ops, so tracing costs nothing unless a
    launcher passed ``--trace-out``.

Components default to a private `Obs()` when none is supplied, so their
counters always work standalone; launchers pass ONE shared `Obs` down the
stack so engine, transport, WAL, serving, and fault events land in a
single registry and a single per-process trace file.
"""
from __future__ import annotations

from contextlib import nullcontext

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               DEFAULT_BUCKETS, now)
from repro_torch.obs.trace import (Tracer, load_trace, merge_traces,
                             trace_categories, validate_trace)

__all__ = ["Obs", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Tracer", "DEFAULT_BUCKETS", "now", "load_trace",
           "merge_traces", "trace_categories", "validate_trace"]

_NULL = nullcontext()


class Obs:
    """Bundle of a metrics registry and an optional tracer."""

    __slots__ = ("metrics", "tracer", "trace_path")

    def __init__(self, registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None,
                 trace_path: str | None = None):
        self.metrics = MetricsRegistry() if registry is None else registry
        self.tracer = tracer
        self.trace_path = trace_path

    def span(self, name: str, cat: str = "", **args):
        """Trace span context manager; no-op without a tracer."""
        if self.tracer is None:
            return _NULL
        return self.tracer.span(name, cat=cat, args=args or None)

    def instant(self, name: str, cat: str = "", **args) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, cat=cat, args=args or None)

    def flush(self) -> None:
        """Persist the trace now (called before a fault-injected kill so
        the victim's timeline survives `os._exit`)."""
        if self.tracer is not None and self.trace_path is not None:
            self.tracer.save(self.trace_path)
