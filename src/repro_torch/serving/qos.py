"""Mixed-traffic QoS for the serving plane: typed requests, priority
lanes, and load shedding as PURE logic.

The port's copy of `repro/serving/qos.py`; `ServeConfig.backend` takes the
port's values ("auto", "cuda", "plain", as in `kernels/ops.py`).

The OCC premise — optimistically admit work, resolve conflicts only when
they materialize — applied to admission control: every request is
admitted optimistically into a per-(kind, k, lane) queue; the conflict
(an interactive deadline about to be eaten by a batch flush, an overload
about to blow every latency budget) is resolved at flush-scheduling
time by the lane scheduler and the shed policy below.  Everything here
is deliberately free of threads, clocks, and torch: the scheduler and the
shed policy are pure functions over explicit state, unit-testable
without a running service, and `cluster_service._AdmissionQueue` is a
thin threaded shell around them.

Three public surfaces:

* `Query` — the typed request: what used to be positional
  `assign(x)/score(x)/topk(x, k)` calls with no way to say "this is a
  batch analytics scan, it can be 3 versions stale, don't stall the
  interactive lane for it".  `kind`/`k` select the jit program,
  `priority` selects the lane, `deadline_ms` overrides the lane's
  coalesce deadline, `max_staleness` (versions behind latest) is the
  consistency point the caller can tolerate — 0 means "latest only,
  never shed".
* `ServeConfig` — ONE dataclass holding every service/router knob
  (backend, buckets, coalescing, probes, QoS thresholds), shared by
  `ClusterService` and `ModelRouter` so the construction surfaces
  cannot drift.
* the lane scheduler (`select_flush` / `next_deadline`) and shed policy
  (`overload_score` / `should_shed`) — see each docstring.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

__all__ = [
    "LANES", "LANE_RANK", "Query", "ServeConfig", "LaneState",
    "FlushDecision", "select_flush", "select_flush_fifo", "next_deadline",
    "overload_score", "should_shed", "effective_lane",
]

#: Priority lanes, best first.  `interactive` preempts `batch` preempts
#: `analytics` at flush-scheduling time; the aging credit in
#: `select_flush` bounds how long preemption can defer a ready lane.
LANES = ("interactive", "batch", "analytics")
LANE_RANK = {lane: i for i, lane in enumerate(LANES)}

_KINDS = ("score", "topk")

#: Kernel dispatch choices (`kernels/ops.py`).
BACKENDS = ("auto", "cuda", "plain")


@dataclasses.dataclass(frozen=True, eq=False)
class Query:
    """One typed serving request.

    `assign`/`score`/`topk` on the service and router are thin shims
    constructing one of these with defaults — `submit(Query(...))` is
    the single entrypoint they all route through.

    Fields:
      x: the query rows, (B, D) (or (D,) for a single row).
      kind: "score" (nearest center) or "topk" (k nearest centers).
      k: top-k width; required >= 1 for kind="topk", must stay 0 for
        kind="score" (it would be silently ignored otherwise).
      priority: lane name from `LANES`.
      deadline_ms: coalesce-deadline override for this request; None
        uses the lane's configured deadline (`ServeConfig.lane_delay_ms`).
      max_staleness: how many versions behind the newest published
        snapshot this caller tolerates.  0 = latest only — such queries
        are NEVER shed to a stale pin.  > 0 marks the query sheddable
        under overload (batch/analytics lanes only).
      want_scores: include distances in the response (labels always come).
    """
    x: Any
    kind: str = "score"
    k: int = 0
    priority: str = "interactive"
    deadline_ms: float | None = None
    max_staleness: int = 0
    want_scores: bool = True

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"Query.kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.kind == "topk" and self.k < 1:
            raise ValueError("Query(kind='topk') requires k >= 1")
        if self.kind == "score" and self.k != 0:
            raise ValueError("Query(kind='score') must leave k == 0 "
                             "(a nonzero k would be silently ignored)")
        if self.priority not in LANES:
            raise ValueError(f"Query.priority must be one of {LANES}, "
                             f"got {self.priority!r}")
        if self.deadline_ms is not None and not self.deadline_ms > 0:
            raise ValueError("Query.deadline_ms must be > 0 or None")
        if not isinstance(self.max_staleness, int) or self.max_staleness < 0:
            raise ValueError("Query.max_staleness must be an int >= 0")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every construction knob of the serving plane, in one place.

    `ClusterService(store, config)` and `ModelRouter(config)` both take
    one of these (plus keyword overrides) — service-level and
    router-level construction cannot drift.

    Serving-core knobs:
      backend ("auto": the kernels for tensors on the card, the plain
      versions on the CPU; "cuda": the kernels or raise; "plain": the
      plain versions on any device), min_bucket / max_bucket, coalesce /
      coalesce_bucket / coalesce_delay_ms, audit_log, probes /
      recall_audit_every.

    QoS knobs:
      priority_lanes: True runs the lane scheduler (per-(kind, k, lane)
        queues, independent deadline timers, preemption + aging).  False
        is the legacy policy — ONE logical queue whose head group
        gates every flush (head-of-line blocking included) — kept as the
        measurable FIFO baseline for the QoS A/B.
      batch_delay_ms / analytics_delay_ms: per-lane coalesce deadlines;
        None derives 8x / 16x the interactive deadline
        (`coalesce_delay_ms`) — batch lanes trade latency for fill.
      aging_limit: how many times a READY lower-priority group may be
        passed over by preemption before it must win (starvation proof).
      shed_depth: total queued rows across lanes at which sheddable
        queries stop queueing and degrade to the stale pin.
      shed_miss_rate: recent deadline-miss rate (EWMA of late flushes)
        with the same effect.
      miss_grace_ms: how late a flush must be past its group deadline to
        count as a miss; None derives the lane's own deadline (a flush
        more than one full budget late is a miss).
    """
    backend: str = "auto"
    min_bucket: int = 8
    max_bucket: int = 4096
    coalesce: bool = False
    coalesce_bucket: int = 64
    coalesce_delay_ms: float = 2.0
    audit_log: bool = False
    probes: int | None = None
    recall_audit_every: int = 0
    # --- QoS ---
    priority_lanes: bool = True
    batch_delay_ms: float | None = None
    analytics_delay_ms: float | None = None
    aging_limit: int = 4
    shed_depth: int = 512
    shed_miss_rate: float = 0.5
    miss_grace_ms: float | None = None

    def __post_init__(self):
        for f in ("min_bucket", "max_bucket", "coalesce_bucket"):
            v = getattr(self, f)
            if v < 1 or v & (v - 1):
                raise ValueError(f"ServeConfig.{f} must be a power of two, "
                                 f"got {v}")
        if self.backend not in BACKENDS:
            raise ValueError(f"ServeConfig.backend must be one of "
                             f"{BACKENDS}, got {self.backend!r}")
        if self.probes is not None and self.probes < 1:
            raise ValueError("ServeConfig.probes must be None or >= 1")
        if self.coalesce_delay_ms <= 0:
            raise ValueError("ServeConfig.coalesce_delay_ms must be > 0")
        if self.aging_limit < 1:
            raise ValueError("ServeConfig.aging_limit must be >= 1")
        if self.shed_depth < 1 or self.shed_miss_rate <= 0:
            raise ValueError("ServeConfig shed thresholds must be positive")

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)

    def lane_delay_s(self, lane: str) -> float:
        """The lane's coalesce deadline, seconds (per-query
        `Query.deadline_ms` overrides it)."""
        base = self.coalesce_delay_ms
        if lane == "batch":
            ms = self.batch_delay_ms if self.batch_delay_ms is not None \
                else 8.0 * base
        elif lane == "analytics":
            ms = self.analytics_delay_ms \
                if self.analytics_delay_ms is not None else 16.0 * base
        else:
            ms = base
        return ms / 1e3

    def miss_grace_s(self, lane: str) -> float:
        if self.miss_grace_ms is not None:
            return self.miss_grace_ms / 1e3
        return self.lane_delay_s(lane)


def effective_lane(priority: str, priority_lanes: bool) -> str:
    """The lane a query actually queues in: its priority, or the single
    legacy lane when the scheduler runs in FIFO-baseline mode."""
    return priority if priority_lanes else LANES[0]


class LaneState(NamedTuple):
    """One queue group as the scheduler sees it (pure data)."""
    key: tuple          # (kind, k, lane) — the group identity
    lane: str
    rows: int           # queued rows in this group
    oldest_t: float     # admission time of the oldest queued request
    deadline_t: float   # earliest per-request deadline in the group


class FlushDecision(NamedTuple):
    key: tuple                       # group to flush NOW
    reason: str                      # "full" | "deadline" | "aged"
    passed_over: tuple[tuple, ...]   # ready groups preempted this round


def select_flush(states: list[LaneState], now_t: float,
                 credits: dict[tuple, int], bucket: int,
                 aging_limit: int) -> FlushDecision | None:
    """Pick the group to flush now, or None if nothing is ready.

    A group is *ready* when its rows would fill the bucket or its
    deadline has expired — each group's timer is its own, so a stalled
    batch group waiting out a long deadline can never delay an
    interactive group's flush (deadline-timer independence).

    Among ready groups, the best lane wins (`LANE_RANK`; ties broken by
    earliest deadline, then earliest admission) — interactive preempts
    batch preempts analytics.  Starvation proof: every ready group that
    loses a round earns one aging credit (the caller bumps
    `credits[key]` for each `passed_over` entry); once a group has been
    passed over `aging_limit` times it enters the *aged* pool, which
    preempts everything — a batch lane under sustained interactive
    pressure drains after at most `aging_limit` interactive flushes.
    """
    ready = [s for s in states
             if s.rows >= bucket or now_t >= s.deadline_t]
    if not ready:
        return None
    order = (lambda s: (LANE_RANK[s.lane], s.deadline_t, s.oldest_t, s.key))
    best = min(ready, key=order)
    aged = [s for s in ready if credits.get(s.key, 0) >= aging_limit]
    win = min(aged, key=order) if aged else best
    reason = ("aged" if win.key != best.key
              else "full" if win.rows >= bucket else "deadline")
    passed = tuple(s.key for s in ready if s.key != win.key)
    return FlushDecision(win.key, reason, passed)


def select_flush_fifo(states: list[LaneState], now_t: float,
                      bucket: int) -> FlushDecision | None:
    """The legacy single-queue policy, kept as the FIFO baseline:
    only the group holding the globally OLDEST request may flush, when
    full or past ITS deadline.  An interactive request queued behind a
    batch group at the head waits for that group's flush first — the
    head-of-line blocking the lane scheduler exists to remove."""
    if not states:
        return None
    head = min(states, key=lambda s: (s.oldest_t, s.key))
    if head.rows >= bucket:
        return FlushDecision(head.key, "full", ())
    if now_t >= head.deadline_t:
        return FlushDecision(head.key, "deadline", ())
    return None


def next_deadline(states: list[LaneState]) -> float | None:
    """Earliest group deadline — the scheduler thread's wake-up time.
    Independent timers mean the wait is a min over ALL groups, not the
    head group's budget."""
    return min((s.deadline_t for s in states), default=None)


def overload_score(queue_rows: int, shed_depth: int,
                   miss_rate: float, shed_miss_rate: float) -> float:
    """The autoscaling signal, and the shed trigger at >= 1.0.

    Derived from the two pressure metrics the registry already tracks:
    total queued rows across lanes (queue depth) and the EWMA of
    deadline-missed flushes (a flush landing more than one budget late
    means the flusher can't keep up — the same signal that drives
    `serve_flushes{reason="deadline"}` and the bucket-fill ratio toward
    their overload regimes).  Each term is normalized by its configured
    threshold; the max is published as the `serve_overload_score` gauge:
    0 = idle, 1.0 = at threshold (shedding starts), > 1 = shedding."""
    return max(queue_rows / max(1, shed_depth),
               miss_rate / max(1e-9, shed_miss_rate))


def should_shed(lane: str, max_staleness: int, score: float) -> bool:
    """Shed = answer from the stale pinned snapshot instead of queueing.

    Only under measured overload (score >= 1), only for batch/analytics
    lanes, and only when the caller declared staleness tolerance —
    `max_staleness=0` queries are NEVER shed, whatever the load."""
    return (score >= 1.0 and lane != LANES[0] and max_staleness > 0)
