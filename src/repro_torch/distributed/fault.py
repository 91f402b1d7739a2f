"""Straggler / failure detection and deterministic fault injection.

The port's copy of `repro/distributed/fault.py` (pure Python).

The OCC paper's bulk-synchronous epochs are themselves the straggler story
for the *algorithm* (epoch size b bounds the blast radius of a slow worker).
For training we add a host-side watchdog: per-step wall-time EWMA with a
multiplicative threshold; breaches emit StragglerEvents that the launcher
acts on (re-dispatch, shrink the worker set, or ignore).

`FaultPlan` (§14) is the chaos half: a declarative list of `FaultRule`s —
delay / drop / duplicate / hold a frame, reset a socket, kill the process —
bound
to *named injection points* that the transport consults on its hot paths
(`server.send`, `server.writer`, `client.apply`, `client.connect`, ...).
Rules trigger on the nth hit of a point, on every k-th hit, or with a
seeded probability, so a chaos test is a (plan, seed) pair that replays
the same failure schedule on every run.  Absent a plan the hooks cost one
`is None` check.

This is host-side control-plane logic — it works identically with 1 or
4096 devices, and the tests drive it with synthetic timings.
"""
from __future__ import annotations

import os
import random
import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import Any

from repro_torch.obs.metrics import now as _now

__all__ = ["StragglerEvent", "StepWatchdog", "HeartbeatTracker",
           "FaultRule", "FaultEvent", "FaultPlan"]


@dataclass(frozen=True)
class StragglerEvent:
    step: int
    elapsed: float
    ewma: float
    ratio: float


@dataclass
class StepWatchdog:
    threshold: float = 3.0        # step slower than threshold x EWMA -> event
    alpha: float = 0.1            # EWMA smoothing
    warmup_steps: int = 5         # ignore compile/first steps
    ewma: float | None = None
    _seen: int = 0
    events: list[StragglerEvent] = field(default_factory=list)
    obs: Any = None               # optional repro_torch.obs.Obs

    def observe(self, step: int, elapsed: float) -> StragglerEvent | None:
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return None
        if self.ewma is None:
            self.ewma = elapsed
            return None
        event = None
        ratio = elapsed / max(self.ewma, 1e-9)
        if ratio > self.threshold:
            event = StragglerEvent(step, elapsed, self.ewma, ratio)
            self.events.append(event)
            # do not fold outliers into the EWMA
            if self.obs is not None:
                self.obs.metrics.counter("watchdog_stragglers").inc()
                self.obs.instant("fault.straggler", cat="fault", step=step,
                                 elapsed_s=elapsed, ratio=ratio)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * elapsed
        return event


@dataclass
class HeartbeatTracker:
    """Host-level liveness: hosts check in each step; silence -> dead.
    Default clock is the shared obs monotonic clock (wall-clock `time.time`
    would double-count NTP steps as silence)."""
    timeout: float = 60.0
    last_seen: dict[int, float] = field(default_factory=dict)

    def beat(self, host_id: int, now: float | None = None):
        self.last_seen[host_id] = now if now is not None else _now()

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = now if now is not None else _now()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout]


# ------------------------------------------------------- fault injection

@dataclass(frozen=True)
class FaultRule:
    """One injection rule: fire `kind` at `point` on a trigger condition.

    Triggers (first match wins per rule; combine rules for several):
      nth    fire on exactly the nth hit of the point (1-based)
      every  fire on every `every`-th hit
      prob   seeded coin per hit (deterministic for a fixed hit order)
    `count` caps total fires for the rule (0 = unlimited).
    """
    point: str                 # e.g. "server.writer", "client.apply"
    kind: str                  # "delay" | "drop" | "dup" | "hold" |
    #                            "reset" | "kill"
    nth: int = 0
    every: int = 0
    prob: float = 0.0
    delay_s: float = 0.0       # for kind == "delay"
    count: int = 0

    def __post_init__(self):
        if self.kind not in ("delay", "drop", "dup", "hold", "reset",
                             "kill"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not (self.nth or self.every or self.prob):
            raise ValueError("rule needs a trigger: nth, every or prob")


@dataclass(frozen=True)
class FaultEvent:
    """One fired injection — the plan's audit trail for chaos tests."""
    point: str
    kind: str
    hit: int                    # which hit of the point fired


class FaultPlan:
    """Deterministic fault schedule consulted at named transport points.

    `at(point)` counts a hit and returns the rules that fire on it (in
    declaration order); the *caller* interprets the kinds — the plan only
    decides *when*.  nth/every triggers are exactly reproducible; `prob`
    draws from one seeded stream under the plan lock, so it replays
    exactly whenever the global hit order replays (single-threaded
    drivers) and is still seed-stable in distribution otherwise.

    `kill()` is the one kind the plan executes itself (`os._exit`) since
    no caller can act after it — gated behind `allow_kill` so a plan
    deserialized from CLI flags cannot kill a test runner by accident.

    `hold` stalls the caller at its point until `release()`: a gate the
    test opens, so a stalled link lasts exactly as long as the test needs
    (a backlog builds deterministically, with no race against a timer).
    """

    def __init__(self, rules: tuple[FaultRule, ...] | list[FaultRule] = (),
                 seed: int = 0, allow_kill: bool = False,
                 obs: Any = None):
        self.rules = tuple(rules)
        self.allow_kill = allow_kill
        self.obs = obs                  # optional repro_torch.obs.Obs
        self._rng = random.Random(seed)
        self._hits: Counter = Counter()
        self._fires: Counter = Counter()
        self.events: list[FaultEvent] = []
        self._lock = threading.Lock()
        self._gate = threading.Event()

    def at(self, point: str) -> list[FaultRule]:
        """Register one hit of `point`; the rules firing on it, in order."""
        with self._lock:
            self._hits[point] += 1
            n = self._hits[point]
            fired = []
            for i, r in enumerate(self.rules):
                if r.point != point:
                    continue
                if r.count and self._fires[i] >= r.count:
                    continue
                hit = bool(r.nth and n == r.nth) \
                    or bool(r.every and n % r.every == 0) \
                    or bool(r.prob and self._rng.random() < r.prob)
                if hit:
                    self._fires[i] += 1
                    fired.append(r)
                    self.events.append(FaultEvent(point, r.kind, n))
                    if self.obs is not None:
                        # every injected fault is a trace event: a chaos
                        # run's timeline is replayable from the trace
                        self.obs.metrics.counter("fault_injections",
                                                 point=point,
                                                 kind=r.kind).inc()
                        self.obs.instant("fault.inject", cat="fault",
                                         point=point, kind=r.kind, hit=n)
                    if r.kind == "kill":
                        self._kill(point)
            return fired

    def release(self) -> None:
        """Open the gate: every caller held by a `hold` rule, now and
        later, goes on."""
        self._gate.set()

    def wait_released(self, timeout: float | None = None) -> bool:
        """Block a `hold` until `release()`; False on timeout."""
        return self._gate.wait(timeout)

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits[point]

    def _kill(self, point: str) -> None:
        if not self.allow_kill:
            raise RuntimeError(f"kill at {point!r} but allow_kill=False")
        if self.obs is not None:
            # the ONE exception to no-flushing: persist the victim's trace
            # first, or the chaos timeline loses exactly the interesting
            # process (os._exit skips atexit by design)
            self.obs.flush()
        # simulate SIGKILL: no atexit, no flushing, no goodbye frames
        os._exit(137)
