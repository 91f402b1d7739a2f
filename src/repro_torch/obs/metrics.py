"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of `repro/obs/metrics.py`.

One registry instance is the single measurement path for a process: engine
passes, transport acks, WAL fsyncs, serving microbatches, and the CI
regression gate all observe into (and read back from) the same three
instrument kinds.  Design points:

* **Labeled families** — `registry.counter("transport_bytes", dir="out")`
  get-or-creates the `(name, labels)` child; the family pins the
  instrument kind at first use (a name cannot be a counter in one call
  site and a histogram in another).
* **Per-instrument locks** — every `inc`/`set`/`observe` is atomic under
  its own lock, so concurrent writers (admission-queue flusher thread vs
  request threads, replication writer vs reader) never lose updates; the
  unsynchronized read-modify-write races of the old ad-hoc `metrics()`
  dicts are structurally impossible here.
* **Histograms keep exact samples up to a bound** — percentile queries
  (`p50`/`p99` for the serving gate, `min` for best-of-trials benchmark
  metrics) are exact while `count <= sample_limit` and fall back to
  geometric-bucket interpolation after, so long-running servers stay
  O(buckets) while benchmarks stay exact.

Readout is `dump()` (nested plain dict, JSON-safe) or `exposition()`
(Prometheus-style text, served over the coordinator CTRL channel).
"""
from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager

__all__ = ["Counter", "Ewma", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "now"]


def now() -> float:
    """The one sanctioned clock for instrumented code: monotonic seconds.

    On Linux this is CLOCK_MONOTONIC — system-wide, so timestamps taken in
    different processes of one cluster are directly comparable (which is
    what lets per-process trace files merge into one timeline).  Raw
    `time.perf_counter()` / `time.time()` in the instrumented trees is
    rejected by tools/lint_timing.py; call this instead."""
    return time.monotonic()


#: Geometric latency buckets, seconds: 1us .. ~100s, x4 per step.
DEFAULT_BUCKETS = tuple(1e-6 * 4.0 ** i for i in range(13))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f'{k}="{v}"' for k, v in key)


class Counter:
    """Monotonically increasing value; `inc` is atomic."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins value (plus atomic add for up/down tracking)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Ewma:
    """Exponentially weighted moving average of observed samples.

    The rolling-rate instrument: observe 1.0 on an event (a deadline
    miss) and 0.0 on a non-event (an on-time flush) and `value` is the
    recent event *rate* with O(1) state — the serving plane's overload
    detector reads it every admission.  The first observation seeds the
    average exactly (no zero-bias warm-up)."""

    __slots__ = ("_lock", "alpha", "_value", "count")

    def __init__(self, alpha: float = 0.2):
        assert 0.0 < alpha <= 1.0
        self._lock = threading.Lock()
        self.alpha = alpha
        self._value = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._value = (v if self.count == 0
                           else self.alpha * v
                           + (1.0 - self.alpha) * self._value)
            self.count += 1

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with exact percentiles up to `sample_limit`.

    Buckets are upper-bound thresholds (`le` semantics); one overflow
    bucket catches the tail.  While fewer than `sample_limit` samples have
    been observed, `percentile` sorts the raw samples and interpolates
    linearly (numpy-compatible); beyond that it interpolates within the
    matching bucket — bounded memory, ~bucket-resolution accuracy."""

    __slots__ = ("_lock", "buckets", "counts", "count", "total",
                 "_min", "_max", "_samples", "sample_limit")

    def __init__(self, buckets=None, sample_limit: int = 8192):
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self.counts = [0] * (len(self.buckets) + 1)
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._samples: list[float] = []
        self.sample_limit = sample_limit

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            self.counts[i] += 1
            self.count += 1
            self.total += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if len(self._samples) < self.sample_limit:
                self._samples.append(v)

    @property
    def min(self) -> float:
        with self._lock:
            return self._min if self.count else math.nan

    @property
    def max(self) -> float:
        with self._lock:
            return self._max if self.count else math.nan

    @property
    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """q in [0, 100]."""
        with self._lock:
            if not self.count:
                return math.nan
            if len(self._samples) == self.count:
                xs = sorted(self._samples)
                pos = (q / 100.0) * (len(xs) - 1)
                lo = int(math.floor(pos))
                hi = min(lo + 1, len(xs) - 1)
                return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
            # Bucket interpolation: find the bucket holding rank q.
            rank = (q / 100.0) * self.count
            seen = 0
            for i, c in enumerate(self.counts):
                if seen + c >= rank and c > 0:
                    lo = self.buckets[i - 1] if i > 0 else min(
                        self._min, self.buckets[0])
                    hi = (self.buckets[i] if i < len(self.buckets)
                          else self._max)
                    frac = (rank - seen) / c
                    return lo + (hi - lo) * frac
                seen += c
            return self._max

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.total
            mn = self._min if count else None
            mx = self._max if count else None
            counts = list(self.counts)
        out = dict(count=count, sum=total, min=mn, max=mx,
                   buckets=list(self.buckets), counts=counts)
        if count:
            out["p50"] = self.percentile(50)
            out["p99"] = self.percentile(99)
        return out


class _Family:
    __slots__ = ("kind", "children", "kwargs")

    def __init__(self, kind, kwargs):
        self.kind = kind
        self.kwargs = kwargs
        self.children: dict[tuple, object] = {}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "ewma": Ewma}


class MetricsRegistry:
    """Get-or-create registry of labeled instrument families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get(self, kind: str, name: str, labels: dict, **kwargs):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(kind, kwargs)
            elif fam.kind != kind:
                raise TypeError(
                    f"metric {name!r} is a {fam.kind}, requested {kind}")
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = _KINDS[kind](**fam.kwargs)
            return child

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        return self._get("histogram", name, labels, buckets=buckets)

    def ewma(self, name: str, alpha: float = 0.2, **labels) -> Ewma:
        """Rolling-rate instrument (see `Ewma`); `alpha` is pinned at the
        family's first use, like histogram buckets."""
        return self._get("ewma", name, labels, alpha=alpha)

    @contextmanager
    def timer(self, name: str, **labels):
        """Observe the elapsed monotonic seconds of the with-block into
        `histogram(name, **labels)` — the benchmark measurement path."""
        h = self.histogram(name, **labels)
        t0 = now()
        try:
            yield h
        finally:
            h.observe(now() - t0)

    def value(self, name: str, **labels) -> float:
        """Scalar readback: counter/gauge value (0.0 if never touched)."""
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            child = fam.children.get(key) if fam else None
        return child.value if child is not None else 0.0

    def get_histogram(self, name: str, **labels) -> Histogram | None:
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind != "histogram":
                return None
            return fam.children.get(key)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._families)

    def dump(self) -> dict:
        """JSON-safe nested dict of every family and child."""
        with self._lock:
            items = [(name, fam.kind, dict(fam.children))
                     for name, fam in sorted(self._families.items())]
        out = {}
        for name, kind, children in items:
            vals = {}
            for key, child in sorted(children.items()):
                label = _label_str(key)
                if kind == "histogram":
                    vals[label] = child.snapshot()
                else:
                    vals[label] = child.value
            out[name] = {"type": kind, "values": vals}
        return out

    def exposition(self) -> str:
        """Prometheus-style text exposition (the CTRL-channel endpoint)."""
        lines = []
        for name, fam in self.dump().items():
            lines.append(f"# TYPE {name} {fam['type']}")
            for label, val in fam["values"].items():
                tag = f"{{{label}}}" if label else ""
                if fam["type"] == "histogram":
                    lines.append(f"{name}_count{tag} {val['count']}")
                    lines.append(f"{name}_sum{tag} {val['sum']:.9g}")
                    if val["count"]:
                        lines.append(f"{name}_p50{tag} {val['p50']:.9g}")
                        lines.append(f"{name}_p99{tag} {val['p99']:.9g}")
                else:
                    lines.append(f"{name}{tag} {val:.9g}")
        return "\n".join(lines) + "\n"
