"""Batched cluster-assignment service over published snapshots.

The port of `repro/serving/cluster_service.py`: a `ClusterService`
answers `assign` / `score` / `topk` queries against the newest
`ModelSnapshot` in a `SnapshotStore` while the OCC trainer keeps
publishing new versions.

Microbatching: each public call is one microbatch and one dispatch of a
query step.  Ragged request sizes are padded up to a power-of-two bucket
(`min_bucket..max_bucket`), so the steps see a handful of (request bucket,
capacity bucket) shapes under any traffic, and a new model version adds
no shape.  Where the JAX package jit-compiles its steps, the port runs
them as plain functions; `query_step_compiles` counts the distinct step
shapes seen, so "a new version adds no step shape" stays checkable.
Padding rows are masked with the query-prefix count (`n_valid`) in the
dispatch (`kernels/ops.serve_assign`), come back (inf, -1) and are sliced
off.

Admission queue: `coalesce=True` merges concurrent small requests into
fuller microbatches.  Requests queue per (kind, k, lane) with independent
deadline timers; one scheduler thread runs the pure lane policy of
`serving/qos.py` (flush on full or deadline, interactive preempts
batch/analytics, aging credits bound starvation).  Under measured overload
sheddable queries (`max_staleness > 0`, non-interactive lanes) are answered
from a held stale snapshot, tagged `degraded`.  Every request of a group is
answered from the one snapshot pinned at flush time and tagged with its
version, group and offset, so every response replays bit-exactly from its
tagged version (`DispatchRecord`).  The scheduler thread launches on the
snapshot's device, on that device's current stream.

Hot swap: the service reads `store.latest()` once per microbatch and
computes the whole microbatch against that one immutable snapshot.

Top-k: flat (`kernels/ops.serve_topk`), or with `probes=p` over the
snapshot's hierarchical layout: route each query to its p nearest coarse
cells (the flat top-k kernel over the coarse centers), take the
microbatch's probed-cell union (packed ascending by a sort, no host sync)
and run the multi-probe kernel over only those shards.  p >= n_cells is
the flat step.  `recall_audit_every` > 0 runs the flat step on every Nth
multi-probe dispatch and publishes recall@k as a gauge.

Mesh (`mesh=`, a `DeviceMesh`): read-only data parallelism.  Every rank
runs the same service over its own store, into which the same versions
are published, so each holds the whole snapshot (replicated, as in
`shardings.serve_snapshot_sharding`).  A bucket-padded microbatch's rows
are split over the data axis (`serve_query_sharding`, with its
divisibility fallback): each rank runs the query step, and so the kernel,
on its block, and one all-gather gives every rank the whole response.
Every rank must submit the same requests in the same order; so the
admission queue, whose flushes follow each rank's own clock, and
multi-probe top-k are refused with a mesh.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch._device import to_device
from repro_torch.distributed.shardings import (
    axis_shard, gather_rows, serve_query_sharding,
)
from repro_torch.kernels import ops as _kops
from repro_torch.kernels.topk_stream import BLOCK_K, topk_tile_loads
from repro_torch.obs import Obs
from repro_torch.obs.metrics import now as _now
from repro_torch.serving import qos
from repro_torch.serving.qos import Query, ServeConfig
from repro_torch.serving.snapshot import ModelSnapshot, SnapshotStore, next_bucket

__all__ = ["ClusterService", "ServeResponse", "DispatchRecord", "Query",
           "ServeConfig"]


class ServeResponse(NamedTuple):
    """One request's answer, tagged with everything needed to replay it."""
    version: int            # ModelSnapshot.version used for every row
    labels: np.ndarray      # (B,) int32 assigned center / (B, k) for topk
    scores: np.ndarray | None   # (B,) squared distance / (B, k) for topk
    bucket: int             # padded microbatch size actually dispatched
    model: str | None = None    # owning model (set when served via a router)
    group: int = -1         # coalesced dispatch id (-1: solo dispatch)
    offset: int = 0         # this request's first row within the dispatch
    degraded: bool = False  # served from the stale shed pin under overload


class DispatchRecord(NamedTuple):
    """Audit-log entry: one dispatch, exactly as it ran.  Replaying `x`
    (same padded rows) through the service's own step against the
    version-`version` snapshot reproduces every member response
    bit-exactly."""
    group: int
    version: int
    kind: str               # "score" | "topk"
    k: int                  # top-k width (0 for score)
    bucket: int
    n_valid: int
    x: np.ndarray           # (bucket, D) the exact padded dispatch input
    spans: tuple[tuple[int, int], ...]   # member request row ranges
    probes: int = 0         # coarse cells probed per query (0: flat)
    degraded: bool = False  # shed-path dispatch against the stale pin


# Distinct query-step shapes seen in this process (the port's counterpart
# of the JAX package's trace counter): a version swap within one (bucket,
# capacity) adds none, and equal-shape router tenants share them.
_QUERY_TRACES = 0
_STEP_SHAPES: set[tuple] = set()
_SHAPES_LOCK = threading.Lock()


def _seen(key: tuple) -> None:
    global _QUERY_TRACES
    with _SHAPES_LOCK:
        if key not in _STEP_SHAPES:
            _STEP_SHAPES.add(key)
            _QUERY_TRACES += 1


def _key(name: str, *tensors, **static) -> tuple:
    return (name, tuple((tuple(t.shape), str(t.dtype), t.device.type)
                        for t in tensors), tuple(sorted(static.items())))


def _assign_step(centers, mask, count, xq, n_valid, *, backend):
    """THE query step: one dispatch per microbatch."""
    _seen(_key("assign", centers, xq, backend=backend))
    return _kops.serve_assign(xq, centers, mask, count=count,
                              n_valid=n_valid, backend=backend)


def _topk_step(centers, mask, count, xq, n_valid, *, k, backend):
    _seen(_key("topk", centers, xq, k=k, backend=backend))
    return _kops.serve_topk(xq, centers, k, mask=mask, count=count,
                            n_valid=n_valid, backend=backend)


def _probe_union(coarse, coarse_mask, xq, n_valid, *, p, u_cap, backend):
    """Route each query to its p nearest coarse cells and pack the
    microbatch's probed-cell union.  Returns (union (u_cap,) int32, packed
    ascending with -1 padding; member (B, u_cap) bool, query b probes
    union[u]; n_probed, a device scalar).  No step waits for the device:
    the union is a scatter into a trash column n_cells, then a sort of the
    cell ids cut to u_cap, where the JAX package uses a sized nonzero."""
    b = xq.shape[0]
    n_cells = coarse.shape[0]
    dev = xq.device
    _, cells_q = _kops.serve_topk(xq, coarse, p, mask=coarse_mask,
                                  n_valid=n_valid, backend=backend)
    safe = torch.where(cells_q >= 0, cells_q, n_cells).long()
    memb = torch.zeros((n_cells + 1,), dtype=torch.bool, device=dev)
    memb[safe.reshape(-1)] = True
    ranks = torch.arange(n_cells, dtype=torch.int32, device=dev)
    keys = torch.where(memb[:n_cells], ranks, n_cells)
    union = torch.sort(keys, stable=True).values[:u_cap]
    union = torch.where(union < n_cells, union, -1).to(torch.int32)
    real = union >= 0
    n_probed = torch.sum(real, dtype=torch.int32)
    # Per-query membership over union slots: a one-hot row per query (the
    # trash column absorbs invalid probes), gathered at the union.
    onehot = torch.zeros((b, n_cells + 1), dtype=torch.bool, device=dev)
    onehot[torch.arange(b, device=dev)[:, None], safe] = True
    member = onehot[:, torch.where(real, union, n_cells).long()] \
        & real[None, :]
    return union.contiguous(), member.contiguous(), n_probed


def _mp_topk_step(coarse, coarse_mask, fine, fine_ids, fine_mask, xq,
                  n_valid, *, k, p, u_cap, backend):
    """Hierarchical multi-probe top-k: the probed-cell union of the
    microbatch (`_probe_union`), then top-k over only those fine shards.
    `u_cap` bounds the union (min(n_cells, pow2(bucket * p)) at the call
    site, so it never cuts a real union).  Returns (d2, idx, n_probed)
    with idx flat ids and n_probed a device scalar; padded query rows
    route nowhere and come back (inf, -1)."""
    _seen(_key("mp_topk", coarse, fine, xq, k=k, p=p, u_cap=u_cap,
               backend=backend))
    union, member, n_probed = _probe_union(
        coarse, coarse_mask, xq, n_valid, p=p, u_cap=u_cap, backend=backend)
    d2, idx = _kops.serve_topk_multiprobe(
        xq, fine, fine_ids, fine_mask, union, member, k, u_count=n_probed,
        n_valid=n_valid, backend=backend)
    return d2, idx, n_probed


def _on_device(dev: torch.device):
    """Launch on `dev` (and its current stream) from any thread."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class _Pending:
    """One admitted request waiting for its lane's coalesced dispatch."""
    __slots__ = ("x", "query", "lane", "t", "deadline_t", "event", "out",
                 "err")

    def __init__(self, x, query: Query, lane: str, deadline_s: float):
        self.x, self.query, self.lane = x, query, lane
        self.t = _now()
        self.deadline_t = self.t + deadline_s
        self.event = threading.Event()
        self.out = self.err = None


class _AdmissionQueue:
    """Per-(kind, k, lane) request queues under one lane scheduler.

    One scheduler thread runs the pure policy of `serving/qos.py`
    (`select_flush`, or `select_flush_fifo` with `priority_lanes=False`)
    and sleeps until `next_deadline`.  `close()` flushes every admitted
    request before the thread exits; a submit racing with it fails fast
    with "service closed".
    """

    def __init__(self, service: "ClusterService", bucket: int,
                 cfg: ServeConfig):
        self._svc = service
        self._cfg = cfg
        self.bucket = bucket
        self._groups: dict[tuple, list[_Pending]] = {}
        self._credits: dict[tuple, int] = {}
        self._cond = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"admission-{service.name or id(service)}")
        self._thread.start()

    def submit(self, x, query: Query, lane: str,
               timeout_s: float = 60.0) -> ServeResponse:
        deadline_s = (query.deadline_ms / 1e3
                      if query.deadline_ms is not None
                      else self._cfg.lane_delay_s(lane))
        item = _Pending(x, query, lane, deadline_s)
        key = (query.kind, query.k, lane)
        with self._cond:
            if self._stop:
                raise RuntimeError("service closed")
            self._groups.setdefault(key, []).append(item)
            self._svc._lane_depth(lane).add(x.shape[0])
            self._cond.notify_all()
        if not item.event.wait(timeout_s):
            raise RuntimeError("admission queue flush timed out")
        if item.err is not None:
            raise item.err
        return item.out

    def depth_rows(self) -> int:
        """Total queued rows across every group: the shed-policy input."""
        with self._cond:
            return sum(it.x.shape[0] for g in self._groups.values()
                       for it in g)

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=10)

    # ---------------------------------------------------------- scheduler
    def _states(self) -> list[qos.LaneState]:
        return [qos.LaneState(key, key[2],
                              sum(it.x.shape[0] for it in g),
                              g[0].t, min(it.deadline_t for it in g))
                for key, g in self._groups.items() if g]

    def _drain_locked(self, key: tuple) -> list[_Pending]:
        """Longest FIFO prefix of the group that fits the bucket."""
        group = self._groups[key]
        take, total = [], 0
        while group:
            nxt = group[0].x.shape[0]
            if take and total + nxt > self.bucket:
                break          # never overshoot the bucket once non-empty
            take.append(group.pop(0))
            total += nxt
        if not group:
            del self._groups[key]
        self._svc._lane_depth(key[2]).add(-total)
        return take

    def _loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    states = self._states()
                    now_t = _now()
                    if self._cfg.priority_lanes:
                        pick = qos.select_flush(
                            states, now_t, self._credits, self.bucket,
                            self._cfg.aging_limit)
                    else:
                        pick = qos.select_flush_fifo(states, now_t,
                                                     self.bucket)
                    if pick is None and self._stop and states:
                        # Closing: everything admitted is still dispatched,
                        # earliest deadline first.
                        key = min(states, key=lambda s: s.deadline_t).key
                        pick = qos.FlushDecision(key, "close", ())
                    if pick is not None:
                        for k in pick.passed_over:
                            self._credits[k] = self._credits.get(k, 0) + 1
                        self._credits.pop(pick.key, None)
                        batch = self._drain_locked(pick.key)
                        break
                    if self._stop:
                        return
                    wake = qos.next_deadline(states)
                    self._cond.wait(None if wake is None
                                    else max(0.0, wake - now_t))
            try:
                self._svc._flush_group(batch, lane=pick.key[2],
                                       reason=pick.reason)
            except Exception as e:        # propagate to every waiter
                for it in batch:
                    it.err = e
                    it.event.set()


class ClusterService:
    """Serves batched assignment queries from a SnapshotStore.

    `ClusterService(store, config)` with a `ServeConfig` (serving/qos.py),
    or the keyword form `ClusterService(store, backend=..., coalesce=...)`:
    ServeConfig fields passed as keywords are `replace`d into the config.
    Queries are moved to the store's device.

      store: the `SnapshotStore` the trainer publishes into.
      name: model tag stamped on responses (set by the router).
      mesh / data_axis: optional `DeviceMesh` of the store's device type:
        replicated snapshots, query rows split over `data_axis`; every rank
        submits the same requests.  Refused with `probes` or `coalesce`.
      obs: optional shared `repro_torch.obs.Obs` for counters, histograms
        and spans.
      shed_signal: optional zero-arg callable returning an external
        overload score; the shed decision uses max(own score, signal).

    `submit(Query(...))` is the entry point; `assign` / `score` / `topk`
    construct the equivalent Query.  `config.probes`: None serves top-k
    flat; p routes each query to its p nearest coarse cells over the
    snapshot's hierarchical layout (requires `SnapshotStore(hier=True)`),
    p >= n_cells is the flat step.  `config.audit_log` keeps a
    `DispatchRecord` per dispatch (unbounded: for audits and tests).
    """

    def __init__(self, store: SnapshotStore,
                 config: ServeConfig | None = None, *,
                 name: str | None = None,
                 mesh: Any = None,
                 data_axis: str = "data",
                 obs: Obs | None = None,
                 shed_signal=None,
                 **overrides):
        if config is None:
            config = ServeConfig()
        if overrides:
            config = config.replace(**overrides)
        if mesh is not None:
            if config.probes is not None:
                raise ValueError("multi-probe serving is not supported with "
                                 "a mesh yet")
            if config.coalesce:
                raise ValueError("the admission queue flushes on each "
                                 "rank's own clock: no coalescing on a mesh")
            mesh_type = getattr(mesh, "device_type", None)
            if mesh_type != store.device.type:
                raise ValueError(f"a {mesh_type} mesh over a store on "
                                 f"{store.device.type}")
        self.config = config
        self.store = store
        self.device = store.device
        self.probes = config.probes
        self.recall_audit_every = config.recall_audit_every
        self.backend = config.backend
        self.min_bucket = config.min_bucket
        self.max_bucket = config.max_bucket
        self.name = name
        self.coalesce_bucket = min(config.coalesce_bucket, config.max_bucket)
        self.mesh = mesh
        self.data_axis = data_axis
        self._shed_signal = shed_signal
        # Scalar counters live in the obs registry (each instrument has its
        # own lock); _mlock guards the non-scalar tallies.
        self.obs = obs if obs is not None else Obs()
        mlab = dict(model=name or "")
        m = self.obs.metrics
        self._c_queries = m.counter("serve_queries", **mlab)
        self._c_requests = m.counter("serve_requests", **mlab)
        self._c_microbatches = m.counter("serve_microbatches", **mlab)
        self._c_dispatches = m.counter("serve_dispatches", **mlab)
        self._c_padded = m.counter("serve_padded_rows", **mlab)
        self._c_groups = m.counter("serve_coalesced_groups", **mlab)
        self._c_group_requests = m.counter("serve_group_requests", **mlab)
        self._c_flush_deadline = m.counter("serve_flushes", reason="deadline",
                                           **mlab)
        self._c_flush_full = m.counter("serve_flushes", reason="full", **mlab)
        self._c_swaps = m.counter("serve_swaps", **mlab)
        self._c_compiles = m.counter("serve_jit_compiles", **mlab)
        # Top-k accounting: per dispatch, the fine shards (multi-probe) or
        # center tiles (flat, in the CUDA kernels' tile width) streamed vs
        # skipped, from the same count bound the kernels use; and the last
        # audited recall@k (0 until a first audit runs).
        self._c_topk_mp = m.counter("serve_topk_multiprobe_dispatches",
                                    **mlab)
        self._c_shards_probed = m.counter("serve_topk_shards_probed", **mlab)
        self._c_tiles_skipped = m.counter("serve_topk_tiles_skipped", **mlab)
        self._c_recall_audits = m.counter("serve_topk_recall_audits", **mlab)
        self._g_recall = m.gauge("serve_topk_recall", **mlab)
        self._n_topk_dispatches = 0     # audit cadence (guarded by _mlock)
        self._h_queue_wait = m.histogram("serve_queue_wait_s", **mlab)
        self._h_dispatch = m.histogram("serve_dispatch_s", **mlab)
        self._h_request = m.histogram("serve_request_s", **mlab)
        self._g_depth = {lane: m.gauge("serve_lane_depth", lane=lane, **mlab)
                         for lane in qos.LANES}
        self._c_shed = {lane: m.counter("serve_shed", lane=lane, **mlab)
                        for lane in qos.LANES}
        self._c_lane_flush: dict[tuple[str, str], Any] = {}
        self._e_miss = m.ewma("serve_deadline_miss_rate", **mlab)
        self._g_overload = m.gauge("serve_overload_score", **mlab)
        self._mlab = mlab
        self._traces0 = _QUERY_TRACES
        self.bucket_hist: dict[int, int] = {}
        self.version_hist: dict[int, int] = {}
        self._cur_version: int | None = None
        self._mlock = threading.Lock()
        self._next_group = 0
        self._shed_pin: ModelSnapshot | None = None   # guarded by _mlock
        self.audit: list[DispatchRecord] | None = (
            [] if config.audit_log else None)
        self._queue = (_AdmissionQueue(self, self.coalesce_bucket, config)
                       if config.coalesce else None)

    def _lane_depth(self, lane: str):
        return self._g_depth[lane]

    def _lane_flush_counter(self, lane: str, reason: str):
        c = self._c_lane_flush.get((lane, reason))
        if c is None:
            c = self._c_lane_flush[(lane, reason)] = self.obs.metrics.counter(
                "serve_lane_flushes", lane=lane, reason=reason, **self._mlab)
        return c

    # ------------------------------------------------------ counter views
    @property
    def n_queries(self) -> int:
        return int(self._c_queries.value)

    @property
    def n_requests(self) -> int:
        return int(self._c_requests.value)

    @property
    def n_microbatches(self) -> int:
        return int(self._c_microbatches.value)

    @property
    def n_dispatches(self) -> int:
        return int(self._c_dispatches.value)

    @property
    def n_padded_rows(self) -> int:
        return int(self._c_padded.value)

    @property
    def n_groups(self) -> int:
        return int(self._c_groups.value)

    @property
    def n_group_requests(self) -> int:
        return int(self._c_group_requests.value)

    @property
    def n_deadline_flushes(self) -> int:
        return int(self._c_flush_deadline.value)

    @property
    def n_swaps(self) -> int:
        return int(self._c_swaps.value)

    # ------------------------------------------------------------ internals
    def _take_snapshot(self) -> ModelSnapshot:
        """The hot-swap point: one reference read per microbatch."""
        snap = self.store.latest()
        if snap is None:
            raise RuntimeError("no model version published yet")
        with self._mlock:
            if snap.version != self._cur_version:
                if self._cur_version is not None:
                    self._c_swaps.inc()
                self._cur_version = snap.version
        return snap

    def _pad(self, x: torch.Tensor, dtype) -> tuple[torch.Tensor, int]:
        n = x.shape[0]
        bucket = next_bucket(n, self.min_bucket, self.max_bucket)
        x = x.to(dtype)
        if n < bucket:
            x = torch.cat([x, x.new_zeros((bucket - n,) + tuple(x.shape[1:]))])
        return x.contiguous(), bucket

    def _account(self, snap: ModelSnapshot, n: int, bucket: int) -> None:
        self._c_queries.inc(n)
        self._c_microbatches.inc()
        self._c_padded.inc(bucket)
        with self._mlock:
            self.bucket_hist[bucket] = self.bucket_hist.get(bucket, 0) + 1
            self.version_hist[snap.version] = (
                self.version_hist.get(snap.version, 0) + n)

    def _record(self, group, snap, kind, k, bucket, n, xp, spans,
                probes: int = 0, degraded: bool = False) -> None:
        if self.audit is not None:
            self.audit.append(DispatchRecord(
                group, snap.version, kind, k, bucket, n,
                xp.cpu().numpy(), tuple(spans), probes, degraded))

    def _rows(self, x) -> torch.Tensor:
        x = to_device(x, self.device)
        return x[None, :] if x.dim() == 1 else x

    def _split(self, x: torch.Tensor) -> list[torch.Tensor]:
        if x.shape[0] <= self.max_bucket:
            return [x]
        return [x[i:i + self.max_bucket]
                for i in range(0, x.shape[0], self.max_bucket)]

    def _mp_probes(self, snap) -> int:
        """Probe width of this dispatch: 0 = flat (probes off, or p >=
        n_cells: probing everything IS the flat step)."""
        if self.probes is None:
            return 0
        h = snap.hier
        if h is None:
            raise RuntimeError(
                "probes is set but the published snapshot has no "
                "hierarchical layout — publish via SnapshotStore(hier=True)")
        return 0 if self.probes >= h.n_cells else self.probes

    def _flat_topk(self, snap, xp, n, k):
        return _topk_step(snap.centers, snap.mask, snap.count, xp, n, k=k,
                          backend=self.backend)

    def _on_mesh(self, step, xp, n):
        """step(rows, n_valid) -> (d2, idx) on this rank's block of the
        microbatch's rows, every rank's blocks gathered in order; the whole
        microbatch without a mesh or where the data axis does not divide
        the bucket."""
        shard = None
        if self.mesh is not None:
            shard = axis_shard(serve_query_sharding(
                self.mesh, self.data_axis, xp.shape[0], xp.dim()), 0)
        if shard is None:
            return step(xp, n)
        lo, hi = shard.rows(xp.shape[0])
        return gather_rows(step(xp[lo:hi], max(0, min(n, hi) - lo)), shard)

    def _audit_recall(self, snap, xp, n, k, idx) -> None:
        """Flat top-k on the same microbatch; recall@k of the multi-probe
        answer against it, published as a gauge."""
        _, flat_idx = self._flat_topk(snap, xp, n, k)
        approx = idx[:n].cpu().numpy()
        exact = flat_idx[:n].cpu().numpy()
        hits = tot = 0
        for a_row, e_row in zip(approx, exact):
            e = set(int(i) for i in e_row if i >= 0)
            if not e:
                continue
            a = set(int(i) for i in a_row if i >= 0)
            hits += len(a & e)
            tot += len(e)
        self._c_recall_audits.inc()
        self._g_recall.set(hits / tot if tot else 1.0)

    def _run_step(self, snap, xp, n, kind, k):
        """One dispatch (the only call sites of the steps), on the
        snapshot's device."""
        traces0 = _QUERY_TRACES
        mp = self._mp_probes(snap) if kind == "topk" else 0
        n_probed = None
        span = ("topk.dispatch" if kind == "topk" else "serve.dispatch")
        t0 = _now()
        with _on_device(snap.centers.device), self.obs.span(
                span, cat="serve", kind=kind, bucket=int(xp.shape[0]),
                version=snap.version, probes=mp):
            if mp:
                h = snap.hier
                u_cap = min(h.n_cells, next_bucket(xp.shape[0] * mp, 1))
                d2, idx, n_probed = _mp_topk_step(
                    h.coarse, h.coarse_mask, h.fine, h.fine_ids,
                    h.fine_mask, xp, n, k=k, p=mp, u_cap=u_cap,
                    backend=self.backend)
            elif kind == "topk":
                d2, idx = self._on_mesh(
                    lambda xq, nv: self._flat_topk(snap, xq, nv, k), xp, n)
            else:
                d2, idx = self._on_mesh(
                    lambda xq, nv: _assign_step(
                        snap.centers, snap.mask, snap.count, xq, nv,
                        backend=self.backend), xp, n)
            self._h_dispatch.observe(_now() - t0)
            self._c_dispatches.inc()
            if kind == "topk":
                if mp:
                    probed = int(n_probed)
                    self._c_topk_mp.inc()
                    self._c_shards_probed.inc(probed)
                    self._c_tiles_skipped.inc(snap.hier.n_cells - probed)
                else:
                    # the kernel walks the capacity's tiles up to the
                    # count's (`topk_tile_loads`)
                    k_tiles = -(-snap.capacity // BLOCK_K)
                    self._c_tiles_skipped.inc(k_tiles - topk_tile_loads(
                        snap.count, snap.capacity, BLOCK_K))
                with self._mlock:
                    self._n_topk_dispatches += 1
                    n_topk = self._n_topk_dispatches
                if (mp and self.recall_audit_every > 0
                        and n_topk % self.recall_audit_every == 0):
                    self._audit_recall(snap, xp, n, k, idx)
        if _QUERY_TRACES != traces0:
            self._c_compiles.inc(_QUERY_TRACES - traces0)
        return d2, idx

    # ----------------------------------------------------------- coalescing
    def _flush_group(self, items: list[_Pending], lane: str = "interactive",
                     reason: str = "deadline") -> None:
        """Dispatch one coalesced group: one snapshot pin, one step,
        per-request slices tagged (version, group, offset)."""
        snap = self._take_snapshot()
        q0 = items[0].query
        kind, k = q0.kind, q0.k
        kk = min(k, snap.capacity) if kind == "topk" else 0
        x = (torch.cat([it.x for it in items], 0)
             if len(items) > 1 else items[0].x)
        n = x.shape[0]
        t_flush = _now()
        grace = self.config.miss_grace_s(lane)
        missed = any(t_flush > it.deadline_t + grace for it in items)
        self._e_miss.observe(1.0 if missed else 0.0)
        for it in items:        # admission-to-flush wait per member request
            self._h_queue_wait.observe(t_flush - it.t)
        xp, bucket = self._pad(x, snap.centers.dtype)
        d2, idx = self._run_step(snap, xp, n, kind, kk)
        self._account(snap, n, bucket)
        self._c_groups.inc()
        self._c_group_requests.inc(len(items))
        self._c_requests.inc(len(items))
        deadline_flush = n < self.coalesce_bucket
        (self._c_flush_deadline if deadline_flush
         else self._c_flush_full).inc()
        self._lane_flush_counter(lane, reason).inc()
        self.obs.instant("serve.flush", cat="serve", reason=reason,
                         lane=lane, requests=len(items), rows=n)
        with self._mlock:
            gid = self._next_group
            self._next_group += 1
        spans, lo = [], 0
        for it in items:
            spans.append((lo, lo + it.x.shape[0]))
            lo += it.x.shape[0]
        self._record(gid, snap, kind, kk, bucket, n, xp, spans,
                     self._mp_probes(snap) if kind == "topk" else 0)
        labels, scores = idx.cpu().numpy(), d2.cpu().numpy()
        for it, (lo, hi) in zip(items, spans):
            it.out = ServeResponse(
                snap.version, labels[lo:hi],
                scores[lo:hi] if it.query.want_scores else None, bucket,
                model=self.name, group=gid, offset=lo)
            it.event.set()

    def close(self) -> None:
        """Stop the admission queue (no-op for solo services); admitted
        requests are flushed on the way down, never dropped."""
        if self._queue is not None:
            self._queue.close()
            self._queue = None

    # ------------------------------------------------------------- shedding
    def _overload(self) -> float:
        """Current overload score; published as `serve_overload_score`."""
        rows = self._queue.depth_rows() if self._queue is not None else 0
        score = qos.overload_score(rows, self.config.shed_depth,
                                   self._e_miss.value,
                                   self.config.shed_miss_rate)
        if self._shed_signal is not None:
            score = max(score, float(self._shed_signal()))
        self._g_overload.set(score)
        return score

    def queue_depth_rows(self) -> int:
        """Rows currently queued for admission (0 for solo services)."""
        return self._queue.depth_rows() if self._queue is not None else 0

    def _stale_pin(self, max_staleness: int) -> ModelSnapshot:
        """The degradation snapshot: pinned once and held while shedding,
        re-pinned only when it drifts past the caller's staleness
        tolerance or the store moved backwards."""
        latest = self.store.latest()
        if latest is None:
            raise RuntimeError("no model version published yet")
        with self._mlock:
            pin = self._shed_pin
            if (pin is None or pin.version > latest.version
                    or pin.version < latest.version - max_staleness):
                pin = self._shed_pin = latest
        return pin

    # -------------------------------------------------------------- queries
    def _solo(self, x, kind: str, k: int, snap: ModelSnapshot | None = None,
              degraded: bool = False) -> ServeResponse:
        """This request is its own microbatch (split into max_bucket chunks
        when giant), every row answered by the one pinned version."""
        if snap is None:
            snap = self._take_snapshot()
        kk = min(k, snap.capacity) if kind == "topk" else 0
        parts_l, parts_s, bucket = [], [], 0
        for xc in self._split(x):
            n = xc.shape[0]
            xp, bucket = self._pad(xc, snap.centers.dtype)
            d2, idx = self._run_step(snap, xp, n, kind, kk)
            self._account(snap, n, bucket)
            self._record(-1, snap, kind, kk, bucket, n, xp, [(0, n)],
                         self._mp_probes(snap) if kind == "topk" else 0,
                         degraded)
            parts_l.append(idx[:n].cpu().numpy())
            parts_s.append(d2[:n].cpu().numpy())
        self._c_requests.inc()
        return ServeResponse(snap.version, np.concatenate(parts_l),
                             np.concatenate(parts_s), bucket,
                             model=self.name, degraded=degraded)

    def submit(self, query: Query) -> ServeResponse:
        """THE serving entry point.  Requests of <= coalesce_bucket rows go
        through the admission queue in their lane; under overload
        sheddable requests are answered solo from the stale pin with
        `degraded=True`; larger requests take the solo path."""
        t0 = _now()
        x = self._rows(query.x)
        if self._queue is not None and x.shape[0] <= self.coalesce_bucket:
            lane = qos.effective_lane(query.priority,
                                      self.config.priority_lanes)
            if qos.should_shed(lane, query.max_staleness, self._overload()):
                self._c_shed[lane].inc()
                resp = self._solo(x, query.kind, query.k,
                                  snap=self._stale_pin(query.max_staleness),
                                  degraded=True)
            else:
                resp = self._queue.submit(x, query, lane)
        else:
            resp = self._solo(x, query.kind, query.k)
        if not query.want_scores and resp.scores is not None:
            resp = resp._replace(scores=None)
        self._h_request.observe(_now() - t0)
        return resp

    def score(self, x) -> ServeResponse:
        """Nearest-center label AND squared distance per query row."""
        return self.submit(Query(x))

    def assign(self, x) -> ServeResponse:
        """Nearest-center label per query row (scores omitted)."""
        return self.submit(Query(x, want_scores=False))

    def topk(self, x, k: int = 4) -> ServeResponse:
        """k nearest centers per query row, distances ascending."""
        return self.submit(Query(x, kind="topk", k=k))

    # -------------------------------------------------------------- metrics
    def metrics(self) -> dict[str, Any]:
        meta = self.store.latest_meta()
        return {
            "model": self.name,
            "n_queries": self.n_queries,
            "n_requests": self.n_requests,
            "n_microbatches": self.n_microbatches,
            "n_dispatches": self.n_dispatches,
            "dispatches_per_microbatch":
                self.n_dispatches / max(1, self.n_microbatches),
            "bucket_fill_ratio": self.n_queries / max(1, self.n_padded_rows),
            "n_coalesced_groups": self.n_groups,
            "n_deadline_flushes": self.n_deadline_flushes,
            "requests_per_group":
                self.n_group_requests / max(1, self.n_groups),
            "n_swaps": self.n_swaps,
            "overload_score": self._g_overload.value,
            "deadline_miss_rate": self._e_miss.value,
            "lane_depth_rows": {lane: int(g.value)
                                for lane, g in self._g_depth.items()},
            "lane_flushes": {f"{lane}/{reason}": int(c.value)
                             for (lane, reason), c
                             in sorted(dict(self._c_lane_flush).items())},
            "n_shed": {lane: int(c.value)
                       for lane, c in self._c_shed.items()},
            "request_p50_ms": 1e3 * self._h_request.percentile(50)
                if self._h_request.count else 0.0,
            "request_p99_ms": 1e3 * self._h_request.percentile(99)
                if self._h_request.count else 0.0,
            "queue_wait_p99_ms": 1e3 * self._h_queue_wait.percentile(99)
                if self._h_queue_wait.count else 0.0,
            # distinct query-step shapes first seen since this service was
            # built (process-wide: router tenants with equal shapes share
            # them)
            "query_step_compiles": _QUERY_TRACES - self._traces0,
            "topk_probes": self.probes,
            "n_topk_multiprobe": int(self._c_topk_mp.value),
            "topk_shards_probed": int(self._c_shards_probed.value),
            "topk_tiles_skipped": int(self._c_tiles_skipped.value),
            "topk_recall_audits": int(self._c_recall_audits.value),
            "topk_recall": self._g_recall.value,
            "versions_served": sorted(self.version_hist),
            "bucket_hist": dict(sorted(self.bucket_hist.items())),
            "latest_version": None if meta is None else meta.version,
            "cap_est": None if meta is None else meta.cap_est,
            "cap_trace": None if meta is None else meta.cap_trace,
        }
