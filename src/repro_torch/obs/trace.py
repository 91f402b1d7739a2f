"""Span tracing with Chrome-trace / Perfetto JSON export.

The port's copy of `repro/obs/trace.py`.

A `Tracer` collects trace events for ONE process; each event carries the
Chrome trace-event-format fields (`name`, `cat`, `ph`, `ts` in
microseconds, `pid`, `tid`, optional `dur`/`args`):

  * ``span(...)``   — context manager → one complete event (ph "X");
  * ``instant(...)``— point event (ph "i"), e.g. an injected fault or a
    promotion decision;
  * ``counter(...)``— sampled series (ph "C"), e.g. queue depth over time.

Thread tracks name themselves lazily: the first event emitted from a
thread records a `thread_name` metadata event, so the admission-queue
flusher, replication writer threads, and worker receive loops each get
their own labeled row in the Perfetto UI for free.

Timestamps come from an injectable `clock` (default: the shared monotonic
clock in `obs.metrics.now`).  Because CLOCK_MONOTONIC is system-wide on
Linux, traces written by different processes of one cluster run share a
timebase — `merge_traces` just concatenates their `traceEvents` and the
per-process `pid` keeps the tracks separate.  `validate_trace` is the
schema check used by tests: spans must nest properly and start times must
be monotone per (pid, tid) track.
"""
from __future__ import annotations

import json
import os
import threading

from repro_torch.obs.metrics import now as _monotonic

__all__ = ["Tracer", "load_trace", "merge_traces", "validate_trace",
           "trace_categories"]


class Tracer:
    """Per-process trace-event collector (thread-safe)."""

    def __init__(self, process_name: str | None = None,
                 pid: int | None = None, clock=None):
        self.pid = os.getpid() if pid is None else int(pid)
        self.clock = clock or _monotonic
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._named_tids: set[int] = set()
        if process_name is not None:
            self._emit(dict(name="process_name", ph="M", pid=self.pid,
                            tid=0, ts=0,
                            args={"name": str(process_name)}))

    # -- internals ---------------------------------------------------------
    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def _tid(self, tid: int | None) -> int:
        if tid is None:
            t = threading.current_thread()
            tid = t.ident or 0
            if tid not in self._named_tids:
                with self._lock:
                    if tid in self._named_tids:
                        return tid
                    self._named_tids.add(tid)
                    self._events.append(dict(
                        name="thread_name", ph="M", pid=self.pid, tid=tid,
                        ts=0, args={"name": t.name}))
        return tid

    def _us(self) -> float:
        return self.clock() * 1e6

    # -- event API ---------------------------------------------------------
    def set_thread_name(self, name: str, tid: int | None = None) -> None:
        tid = self._tid(tid)
        self._emit(dict(name="thread_name", ph="M", pid=self.pid, tid=tid,
                        ts=0, args={"name": str(name)}))

    def span(self, name: str, cat: str = "", args: dict | None = None,
             tid: int | None = None) -> "_Span":
        return _Span(self, name, cat, args, tid)

    def complete(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "", args: dict | None = None,
                 tid: int | None = None) -> None:
        """Record an already-measured interval (post-pass stats export)."""
        ev = dict(name=name, cat=cat, ph="X", ts=float(ts_us),
                  dur=max(0.0, float(dur_us)), pid=self.pid,
                  tid=self._tid(tid))
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, cat: str = "", args: dict | None = None,
                tid: int | None = None) -> None:
        ev = dict(name=name, cat=cat, ph="i", s="t", ts=self._us(),
                  pid=self.pid, tid=self._tid(tid))
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, values: dict, cat: str = "",
                tid: int | None = None) -> None:
        self._emit(dict(name=name, cat=cat, ph="C", ts=self._us(),
                        pid=self.pid, tid=self._tid(tid),
                        args={k: float(v) for k, v in values.items()}))

    # -- export ------------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def json_bytes(self) -> bytes:
        """Canonical bytes (sorted keys, fixed separators) — the byte-level
        golden-fixture representation."""
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":")).encode()

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("tracer", "name", "cat", "args", "tid", "t0")

    def __init__(self, tracer, name, cat, args, tid):
        self.tracer, self.name, self.cat = tracer, name, cat
        self.args = dict(args) if args else None
        self.tid = tid

    def __enter__(self):
        self.tid = self.tracer._tid(self.tid)
        self.t0 = self.tracer._us()
        return self

    def set(self, **kw) -> None:
        """Attach result args discovered inside the span."""
        if self.args is None:
            self.args = {}
        self.args.update(kw)

    def __exit__(self, exc_type, exc, tb):
        t1 = self.tracer._us()
        ev = dict(name=self.name, cat=self.cat, ph="X", ts=self.t0,
                  dur=t1 - self.t0, pid=self.tracer.pid, tid=self.tid)
        if exc_type is not None:
            self.set(error=exc_type.__name__)
        if self.args:
            ev["args"] = self.args
        self.tracer._emit(ev)
        return False


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge_traces(out_path: str, *sources) -> dict:
    """Concatenate traceEvents from tracers / trace dicts / trace-file
    paths into one Chrome trace (valid because all processes share the
    system-wide monotonic timebase; pids keep tracks distinct)."""
    events: list[dict] = []
    for src in sources:
        if isinstance(src, Tracer):
            events.extend(src.events())
        elif isinstance(src, dict):
            events.extend(src.get("traceEvents", []))
        else:
            try:
                events.extend(load_trace(src).get("traceEvents", []))
            except (OSError, ValueError):
                continue        # a crashed process may leave no/torn file
    merged = {"traceEvents": events, "displayTimeUnit": "ms"}
    if out_path:
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, out_path)
    return merged


def validate_trace(trace: dict) -> list[str]:
    """Schema check; returns a list of problems (empty = valid).

    Enforced invariants: required fields per phase type, non-negative
    durations, monotone start times per (pid, tid) track, and proper
    nesting of complete events within a track (a span that starts inside
    an enclosing span must also end inside it)."""
    problems: list[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    tracks: dict[tuple, list[dict]] = {}
    for i, ev in enumerate(events):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"event {i} missing {field!r}")
                break
        else:
            if ev["ph"] == "X":
                if "dur" not in ev:
                    problems.append(f"event {i} ({ev['name']}) ph=X "
                                    f"missing dur")
                elif ev["dur"] < 0:
                    problems.append(f"event {i} ({ev['name']}) dur < 0")
                else:
                    tracks.setdefault((ev["pid"], ev["tid"]),
                                      []).append(ev)
    for (pid, tid), evs in tracks.items():
        last_ts = -float("inf")
        stack: list[tuple[float, float, str]] = []   # (end, start, name)
        for ev in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            if ev["ts"] < last_ts:
                problems.append(
                    f"track ({pid},{tid}): ts not monotone at "
                    f"{ev['name']}")
            last_ts = ev["ts"]
            end = ev["ts"] + ev["dur"]
            while stack and ev["ts"] >= stack[-1][0] - 1e-6:
                stack.pop()
            if stack and end > stack[-1][0] + 1e-6:
                problems.append(
                    f"track ({pid},{tid}): span {ev['name']!r} "
                    f"[{ev['ts']:.1f},{end:.1f}] overlaps but does not "
                    f"nest in {stack[-1][2]!r} ending {stack[-1][0]:.1f}")
            stack.append((end, ev["ts"], ev["name"]))
    return problems


def trace_categories(trace: dict) -> set[str]:
    """Distinct non-metadata categories present (subsystem coverage)."""
    return {ev.get("cat", "") for ev in trace.get("traceEvents", [])
            if ev.get("ph") != "M" and ev.get("cat")}
