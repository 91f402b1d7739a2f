"""Train-on-stream, serve-while-training: the full train->publish->serve
pipeline, scaled out to many tenants.

The port of `repro/launch/serve_clusters.py`, on the card unless the
caller asks for the CPU (`--device cpu`).  Per model, a trainer thread
streams batches through `OCCEngine.partial_fit` (arbitrary batch lengths:
the partial-epoch carry keeps the stream bit-identical to a one-shot run)
and publishes one immutable version per committed pass through the DELTA
log (O(dK*D) per publish), mirrored into an eager shadow store so the
audit can prove delta-materialize == eager-copy bit-identity on the live
stream.  Concurrently, a pool of client threads runs a load generator
against a `ModelRouter` fronting all tenants with admission-queue
coalescing enabled: ragged request sizes, concurrent small requests merged
into fuller microbatches under the deadline-or-full policy, one kernel
dispatch per microbatch, atomic hot-swap per model between requests.  On
the card the trainers' propose and the services' score steps launch
`dpmeans_assign` from their own threads, and the analytics lane's top-k
scans launch `topk_stream`.

After the run, every response is audited:
  * zero stale reads: every coalesced dispatch is replayed from its
    tagged (model, version) snapshot through the service's own step
    (`DispatchRecord` holds the exact padded inputs) and must reproduce
    each member response bit-exactly; versions observed by any single
    client are monotone per model;
  * multi-model isolation + serve == train: response labels are
    bit-identical to `core.occ.nearest_center` on the tagged model's
    snapshot pool through the PLAIN version, per (model, version), so on
    the card every label of the kernel is held against the plain version,
    request by request;
  * delta publication: every published version materializes
    bit-identically from the delta log and from the eager shadow copy;
  * stream == one-shot: tenant 0's streamed pool equals a one-shot run;
  * coalescing pays: the same request trace replayed solo (no admission
    queue) must show a WORSE bucket-fill ratio than the coalesced run;
  * >= 2 models, >= `min_versions` hot-swapped through per model,
    >= `min_queries` total rows (full mode: 10k).

A second ADVERSARIAL MIXED-TRAFFIC phase then runs the QoS A/B: the same
offered load (interactive clients with small `score` queries, tight
deadlines and `max_staleness=0`, mixed against analytics clients with
wide `topk` scans, long deadlines and staleness tolerance) is replayed
against a priority-lane service and against the FIFO baseline
(`priority_lanes=False`), each with a live trainer republishing versions
underneath.  Audited:
  * interactive p99 with priority lanes STRICTLY better than FIFO under
    the same offered load;
  * overload shedding fired (priority run), and every degraded response
    replays bit-exactly from its `DispatchRecord` tagged with the stale
    pinned version + `degraded` flag;
  * `max_staleness=0` traffic is NEVER degraded and always replays
    bit-exactly from its tagged version (zero stale reads), with
    per-client monotone versions on the non-degraded path.

p50/p99 latency, QPS, fill ratios and the QoS A/B are returned (and
written to `--out` when given).

  PYTHONPATH=src python -m repro_torch.launch.serve_clusters [--quick] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import DPMeansTransaction, OCCEngine
from repro_torch.core.occ import nearest_center
from repro_torch.data import dp_stick_breaking_data
from repro_torch.obs import Obs, Tracer
from repro_torch.serving import (
    ClusterService, ModelRouter, Query, ServeConfig, SnapshotStore,
)
from repro_torch.serving.cluster_service import _assign_step, _topk_step

__all__ = ["ServeDemoConfig", "run_demo"]


@dataclass
class ServeDemoConfig:
    n: int = 8192              # stream length PER MODEL
    dim: int = 16
    n_models: int = 2
    lam: float = 4.0
    k_max: int = 512
    pb: int = 128              # points per OCC epoch
    train_batch: int = 384     # NOT a multiple of pb: exercises the carry
    min_queries: int = 10_000  # load-generator floor (rows, all models)
    max_request: int = 32      # ragged request sizes in [1, max_request]
    # Closed-loop load: the queue depth per model is ~ n_clients/n_models
    # blocked requests, so the coalesce bucket is sized to that row supply
    # (a bucket far above it turns every flush into a half-empty deadline
    # flush and coalescing stops paying).
    n_clients: int = 16        # concurrent load-generator threads
    coalesce_bucket: int = 64
    coalesce_delay_ms: float = 10.0
    backend: str = "auto"      # service kernel backend
    min_versions: int = 3      # hot-swap floor per model under load
    # --- adversarial mixed-traffic QoS A/B ---
    # Deadlines are sized so the FIFO head-of-line penalty (an analytics
    # group parked at the head for its WHOLE deadline: 2 clients x 24
    # rows can never fill the 64-row bucket) dwarfs scheduler/GIL noise;
    # the lane scheduler flushes interactive on its own 10ms timer
    # regardless.
    qos_n: int = 4096          # stream length for the QoS tenant
    qos_interactive_clients: int = 6
    qos_analytics_clients: int = 2
    qos_interactive_requests: int = 120   # per client, fixed offered trace
    qos_analytics_requests: int = 25
    qos_analytics_rows: int = 24          # rows per analytics topk scan
    qos_interactive_deadline_ms: float = 10.0
    qos_analytics_deadline_ms: float = 250.0
    qos_shed_depth: int = 48   # queued rows at which shedding starts
    seed: int = 0
    out_path: str | None = None
    trace_out: str | None = None   # Perfetto JSON of the whole run
    quiet: bool = False
    device: str = "cuda"       # where training, serving and audits run


@dataclass
class _Trace:
    """One served request, as recorded by a load-generator client."""
    model: str
    version: int
    q_lo: int
    q_hi: int
    labels: np.ndarray
    scores: np.ndarray
    bucket: int
    group: int
    offset: int
    latency_s: float = 0.0
    client: int = 0


@dataclass
class _Tenant:
    name: str
    x: torch.Tensor
    engine: OCCEngine
    store: SnapshotStore          # the router's delta store
    shadow: SnapshotStore         # eager shadow for the delta audit
    batches: list = field(default_factory=list)
    train_s: float = 0.0          # the trainer thread's partial_fit time


def _trainer(tn: _Tenant, svc: ClusterService,
             pace_microbatches: int = 2, timeout_s: float = 5.0):
    """Stream batches through partial_fit; between publishes, wait until the
    service has answered a couple more microbatches so every version is
    actually *observed* under load (deterministic interleaving, no sleeps
    tuned to machine speed)."""
    for xb in tn.batches:
        seen = svc.n_microbatches
        t0 = time.perf_counter()
        tn.engine.partial_fit(xb)
        tn.train_s += time.perf_counter() - t0
        deadline = time.perf_counter() + timeout_s
        while (svc.n_microbatches < seen + pace_microbatches
               and time.perf_counter() < deadline):
            time.sleep(0.001)
    t0 = time.perf_counter()
    tn.engine.flush()
    tn.train_s += time.perf_counter() - t0


def _stream_x(cfg: ServeDemoConfig, n: int, seed: int) -> torch.Tensor:
    x, _, _ = dp_stick_breaking_data(n, seed=seed, dim=cfg.dim)
    return torch.as_tensor(x, device=resolve_device(cfg.device))


def _make_tenant(name: str, i: int, cfg: ServeDemoConfig,
                 router: ModelRouter, obs: Obs) -> _Tenant:
    x = _stream_x(cfg, cfg.n, cfg.seed + 17 * i)
    store = router.add_model(name, snapshot_capacity=256, delta=True)
    shadow = SnapshotStore(capacity=256, device=cfg.device)

    def publish(res, **kw):
        store.publish_pass(res, **kw)
        shadow.publish_pass(res, **kw)

    eng = OCCEngine(
        DPMeansTransaction(cfg.lam * (1.0 + 0.25 * i), k_max=cfg.k_max),
        pb=cfg.pb, validate_cap="adaptive", publish=publish, obs=obs,
        device=cfg.device)
    batches = [x[j:j + cfg.train_batch]
               for j in range(0, cfg.n, cfg.train_batch)]
    return _Tenant(name, x, eng, store, shadow, batches)


@dataclass
class _QosTrace:
    """One served request of the QoS A/B phase."""
    lane: str
    version: int
    q_lo: int
    q_hi: int
    labels: np.ndarray
    scores: np.ndarray
    bucket: int
    group: int
    offset: int
    degraded: bool
    latency_s: float = 0.0


def _qos_schedule(cfg: ServeDemoConfig) -> list[tuple[str, list]]:
    """The offered load, fixed ahead of time: one request list per client,
    identical for both A/B modes (same sizes, same rows, same order):
    'same offered load' is by construction, not by matched RNG draws."""
    rng = np.random.default_rng(cfg.seed + 4242)
    sched = []
    for _ in range(cfg.qos_interactive_clients):
        sched.append(("interactive",
                      [(int(rng.integers(1, 9)),
                        int(rng.integers(0, cfg.qos_n - 8)))
                       for _ in range(cfg.qos_interactive_requests)]))
    for _ in range(cfg.qos_analytics_clients):
        sched.append(("analytics",
                      [(cfg.qos_analytics_rows,
                        int(rng.integers(0, cfg.qos_n
                                         - cfg.qos_analytics_rows)))
                       for _ in range(cfg.qos_analytics_requests)]))
    return sched


def _replay_step(rec, snap, backend):
    """Replay one DispatchRecord through the service's own step, on the
    snapshot's device."""
    xq = torch.as_tensor(rec.x, device=snap.centers.device)
    if rec.kind == "topk":
        d2, idx = _topk_step(snap.centers, snap.mask, snap.count, xq,
                             rec.n_valid, k=rec.k, backend=backend)
    else:
        d2, idx = _assign_step(snap.centers, snap.mask, snap.count, xq,
                               rec.n_valid, backend=backend)
    return d2.cpu().numpy(), idx.cpu().numpy()


def _qos_mode(cfg: ServeDemoConfig, obs: Obs, sched,
              priority_lanes: bool, tag: str | None = None) -> dict:
    """One arm of the A/B: train-while-serving a single tenant under the
    fixed adversarial schedule, with (QoS) or without (FIFO) the lane
    scheduler, then audit every response."""
    x = _stream_x(cfg, cfg.qos_n, cfg.seed + 999)
    store = SnapshotStore(capacity=256, device=cfg.device)
    eng = OCCEngine(DPMeansTransaction(cfg.lam, k_max=cfg.k_max),
                    pb=cfg.pb, validate_cap="adaptive",
                    publish=store.publish_pass, obs=obs, device=cfg.device)
    batches = [x[j:j + cfg.train_batch]
               for j in range(0, cfg.qos_n, cfg.train_batch)]
    # Warm the capacity bucket before measuring: publish all but a tail
    # of batches up front; the tail streams DURING the phase so latest
    # keeps moving and the shed pin genuinely lags it.
    tail = max(2, len(batches) // 4)
    for xb in batches[:-tail]:
        eng.partial_fit(xb)
    mode = tag or ("qos" if priority_lanes else "fifo")
    svc = ClusterService(
        store,
        ServeConfig(backend=cfg.backend, min_bucket=8,
                    max_bucket=max(128, cfg.coalesce_bucket),
                    coalesce=True, coalesce_bucket=cfg.coalesce_bucket,
                    coalesce_delay_ms=cfg.qos_interactive_deadline_ms,
                    audit_log=True, priority_lanes=priority_lanes,
                    shed_depth=cfg.qos_shed_depth),
        name=mode, obs=obs)
    # Warm the request buckets both modes hit, so first-dispatch costs
    # land in neither mode's percentiles.
    for b in (8, 32, 64):
        svc.score(x[:b])
        svc.topk(x[:b], k=8)
    warm_gid = svc._next_group

    traces: list[list[_QosTrace]] = [[] for _ in sched]

    def client(ci: int, lane: str, reqs):
        mine = traces[ci]
        for size, lo in reqs:
            if lane == "interactive":
                q = Query(x[lo:lo + size], priority="interactive",
                          deadline_ms=cfg.qos_interactive_deadline_ms,
                          max_staleness=0)
            else:
                q = Query(x[lo:lo + size], kind="topk", k=8,
                          priority="analytics",
                          deadline_ms=cfg.qos_analytics_deadline_ms,
                          max_staleness=3)
            t0 = time.perf_counter()
            resp = svc.submit(q)
            dt = time.perf_counter() - t0
            mine.append(_QosTrace(lane, resp.version, lo, lo + size,
                                  resp.labels, resp.scores, resp.bucket,
                                  resp.group, resp.offset, resp.degraded,
                                  dt))

    def trainer():
        for xb in batches[-tail:]:
            seen = svc.n_microbatches
            eng.partial_fit(xb)
            deadline = time.perf_counter() + 5.0
            while (svc.n_microbatches < seen + 2
                   and time.perf_counter() < deadline):
                time.sleep(0.001)
        eng.flush()

    threads = [threading.Thread(target=client, args=(ci, lane, reqs),
                                daemon=True)
               for ci, (lane, reqs) in enumerate(sched)]
    threads.append(threading.Thread(target=trainer, daemon=True))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    svc.close()

    # ------------------------------------------------------------- audits
    all_t = [t for ts in traces for t in ts]
    ints = [t for t in all_t if t.lane == "interactive"]
    assert all(not t.degraded for t in ints), \
        "max_staleness=0 interactive traffic must never be degraded"
    for ts in traces:
        last = -1       # per-client monotone versions, non-degraded path
        for t in ts:    # (a shed pin may legitimately lag latest)
            if t.degraded:
                continue
            assert t.version >= last, \
                "stale read: version went backwards for a client"
            last = t.version
    # Zero stale reads: every coalesced response replays bit-exactly from
    # its tagged version through the service's own step.
    by_group: dict[int, list[_QosTrace]] = {}
    for t in all_t:
        if not t.degraded:
            assert t.group >= warm_gid, "measured request missed the queue"
            by_group.setdefault(t.group, []).append(t)
    n_replayed = 0
    for rec in svc.audit:
        if rec.degraded:
            continue
        members = by_group.get(rec.group, [])
        if not members:
            continue        # warm-up groups carry no measured traces
        snap = store.get(rec.version)
        assert snap is not None, "audited version evicted — grow the ring"
        d2, idx = _replay_step(rec, snap, cfg.backend)
        for t in members:
            sl = slice(t.offset, t.offset + (t.q_hi - t.q_lo))
            assert (np.array_equal(t.labels, idx[sl])
                    and np.array_equal(t.scores, d2[sl])), \
                f"{mode}: response not reproducible from its tag"
            n_replayed += 1
    assert n_replayed == len([t for t in all_t if not t.degraded]), \
        "audit log lost a dispatch"
    # Degraded replay: every shed response must reproduce bit-exactly
    # from a degraded-tagged DispatchRecord at its tagged stale version.
    deg_by_key: dict[tuple, list] = {}
    for rec in svc.audit:
        if rec.degraded:
            deg_by_key.setdefault((rec.version, rec.n_valid), []).append(rec)
    n_degraded = 0
    for t in (t for t in all_t if t.degraded):
        assert t.lane == "analytics", "only sheddable lanes may degrade"
        n = t.q_hi - t.q_lo
        ok = False
        for rec in deg_by_key.get((t.version, n), []):
            if not np.array_equal(rec.x[:n], x[t.q_lo:t.q_hi].cpu().numpy()):
                continue
            d2, idx = _replay_step(rec, store.get(rec.version), cfg.backend)
            if (np.array_equal(t.labels, idx[:n])
                    and np.array_equal(t.scores, d2[:n])):
                ok = True
                break
        assert ok, "degraded response not reproducible from its tagged record"
        n_degraded += 1
    m = svc.metrics()
    n_shed = sum(m["n_shed"].values())
    assert n_shed == n_degraded, "shed counter / degraded responses diverge"
    int_lat = np.asarray([t.latency_s for t in ints])
    return {
        "interactive_p50_ms": float(np.percentile(int_lat, 50) * 1e3),
        "interactive_p99_ms": float(np.percentile(int_lat, 99) * 1e3),
        "n_interactive": len(ints),
        "n_analytics": len(all_t) - len(ints),
        "n_shed": n_shed,
        "n_degraded_replayed": n_degraded,
        "n_replayed": n_replayed,
        "lane_flushes": m["lane_flushes"],
        "deadline_miss_rate": m["deadline_miss_rate"],
        "overload_score_last": m["overload_score"],
        "versions_published": len(store),
        "wall_s": wall,
    }


def _qos_warm_jit(cfg: ServeDemoConfig, obs: Obs) -> None:
    """Warm every (request bucket, capacity) pair the A/B will hit,
    including capacities only reached by the MID-PHASE tail publishes.
    Where the JAX package compiles its steps here, the port loads the
    kernel libraries and allocates their per-stream scratch, so neither
    measured arm pays for it.  Training is deterministic, so a throwaway
    run discovers the exact capacity sequence both arms will publish."""
    x = _stream_x(cfg, cfg.qos_n, cfg.seed + 999)
    store = SnapshotStore(capacity=256, device=cfg.device)
    eng = OCCEngine(DPMeansTransaction(cfg.lam, k_max=cfg.k_max),
                    pb=cfg.pb, validate_cap="adaptive",
                    publish=store.publish_pass, obs=obs, device=cfg.device)
    for j in range(0, cfg.qos_n, cfg.train_batch):
        eng.partial_fit(x[j:j + cfg.train_batch])
    eng.flush()
    snaps = {}
    for v in store.versions():
        snap = store.get(v)
        snaps[snap.capacity] = snap
    for snap in snaps.values():
        kk = min(8, snap.capacity)
        for b in (8, 16, 32, 64, 128):
            xq = x.new_zeros((b, x.shape[1]))
            _assign_step(snap.centers, snap.mask, snap.count, xq, b,
                         backend=cfg.backend)
            _topk_step(snap.centers, snap.mask, snap.count, xq, b, k=kk,
                       backend=cfg.backend)


def _qos_mix(cfg: ServeDemoConfig, obs: Obs) -> dict:
    """The A/B: identical offered load against priority lanes vs the FIFO
    baseline; priority lanes must win interactive p99 STRICTLY, shedding
    must have fired (and only in the QoS arm: FIFO is the faithful legacy
    policy, which never sheds)."""
    _qos_warm_jit(cfg, obs)
    # A discarded warm arm absorbs every first-run cost the prewarm
    # can't (thread ramp, first flush/shed paths, allocator warmth) so
    # neither MEASURED arm pays for running first.
    warm_cfg = dataclasses.replace(cfg, qos_interactive_requests=10,
                                   qos_analytics_requests=3)
    _qos_mode(warm_cfg, obs, _qos_schedule(warm_cfg), priority_lanes=True,
              tag="qos-warm")
    sched = _qos_schedule(cfg)
    qos = _qos_mode(cfg, obs, sched, priority_lanes=True)
    fifo = _qos_mode(cfg, obs, sched, priority_lanes=False)
    assert qos["interactive_p99_ms"] < fifo["interactive_p99_ms"], (
        f"priority lanes did not beat FIFO: "
        f"{qos['interactive_p99_ms']:.2f}ms vs "
        f"{fifo['interactive_p99_ms']:.2f}ms")
    assert qos["n_shed"] > 0, "overload shedding never fired in the QoS arm"
    assert fifo["n_shed"] == 0, "the FIFO baseline must never shed"
    return {"qos": qos, "fifo": fifo,
            "interactive_p99_speedup":
                fifo["interactive_p99_ms"] / qos["interactive_p99_ms"]}


def _train_while_serve(cfg: ServeDemoConfig, obs: Obs):
    """The multi-tenant train-while-serve run and every audit of it ->
    (record, tenants, router); the router is left open."""
    assert cfg.n_models >= 2, "the scale-out audit needs >= 2 tenants"
    assert cfg.max_request <= cfg.coalesce_bucket
    serve_cfg = ServeConfig(backend=cfg.backend, coalesce=True,
                            coalesce_bucket=cfg.coalesce_bucket,
                            coalesce_delay_ms=cfg.coalesce_delay_ms,
                            audit_log=True,
                            max_bucket=max(128, cfg.coalesce_bucket))
    router = ModelRouter(serve_cfg, obs=obs, device=cfg.device)
    names = [chr(ord("a") + i) for i in range(cfg.n_models)]
    tenants = {nm: _make_tenant(nm, i, cfg, router, obs)
               for i, nm in enumerate(names)}

    # First batch per tenant before any client starts, so every model has a
    # version.
    for tn in tenants.values():
        t0 = time.perf_counter()
        tn.engine.partial_fit(tn.batches[0])
        tn.train_s += time.perf_counter() - t0
        tn.batches = tn.batches[1:]

    trainers = [threading.Thread(target=_trainer,
                                 args=(tn, router.service(tn.name)),
                                 daemon=True)
                for tn in tenants.values()]

    # ---------------------------------------------------------------- serve
    traces: list[list[_Trace]] = [[] for _ in range(cfg.n_clients)]
    stop = threading.Event()

    def client(ci: int):
        rng = np.random.default_rng(cfg.seed + 1000 + ci)
        mine = traces[ci]
        while not stop.is_set():
            nm = names[int(rng.integers(0, cfg.n_models))]
            tn = tenants[nm]
            size = int(rng.integers(1, cfg.max_request + 1))
            lo = int(rng.integers(0, cfg.n - size))
            t0 = time.perf_counter()
            resp = router.score(nm, tn.x[lo:lo + size])
            dt = time.perf_counter() - t0
            mine.append(_Trace(nm, resp.version, lo, lo + size, resp.labels,
                               resp.scores, resp.bucket, resp.group,
                               resp.offset, dt, ci))

    t_serve0 = time.perf_counter()
    for t in trainers:
        t.start()
    clients = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(cfg.n_clients)]
    for c in clients:
        c.start()

    def floors_met() -> bool:
        rows = sum(t.q_hi - t.q_lo for ts in traces for t in ts)
        if rows < cfg.min_queries:
            return False
        for nm in names:
            seen = {t.version for ts in traces for t in ts if t.model == nm}
            if len(seen) < cfg.min_versions:
                return False
        return True

    while any(t.is_alive() for t in trainers) or not floors_met():
        time.sleep(0.005)
        if time.perf_counter() - t_serve0 > 180:
            break    # safety valve; the audit below still decides pass/fail
    for t in trainers:
        t.join()
    stop.set()
    for c in clients:
        c.join()
    serve_wall = time.perf_counter() - t_serve0
    all_traces = [t for ts in traces for t in ts]
    n_rows = sum(t.q_hi - t.q_lo for t in all_traces)

    # ---------------------------------------------------------------- audit
    t_audit0 = time.perf_counter()
    # Versions monotone per (client, model): each client's requests are
    # sequential, so the hot-swap point can only move forward for it.
    for ts in traces:
        last: dict[str, int] = {}
        for t in ts:
            assert t.version >= last.get(t.model, -1), \
                "stale read: version went backwards for a client"
            last[t.model] = t.version
    versions_observed = {nm: sorted({t.version for t in all_traces
                                     if t.model == nm}) for nm in names}
    for nm, vs in versions_observed.items():
        assert len(vs) >= cfg.min_versions, (
            f"model {nm}: only {len(vs)} versions observed under load")

    # Zero stale reads: replay every coalesced dispatch from its tagged
    # (model, version) snapshot through the service's own step: exact
    # padded inputs from the audit log, bit-exact member slices.
    by_group: dict[tuple[str, int], list[_Trace]] = {}
    for t in all_traces:
        by_group.setdefault((t.model, t.group), []).append(t)
    stale = parity = 0
    n_replayed = 0
    for nm in names:
        tn = tenants[nm]
        svc = router.service(nm)
        for rec in svc.audit:
            members = by_group.get((nm, rec.group), [])
            if not members:
                continue
            snap = tn.store.get(rec.version)
            assert snap is not None, "audited version evicted — grow the ring"
            d2, idx = _replay_step(rec, snap, cfg.backend)
            for t in members:
                sl = slice(t.offset, t.offset + (t.q_hi - t.q_lo))
                if not (np.array_equal(t.labels, idx[sl])
                        and np.array_equal(t.scores, d2[sl])):
                    stale += 1
                n_replayed += 1
        # serve == train + isolation: labels bit-identical to the plain
        # version's nearest center on the tagged MODEL's snapshot.
        for t in (t for t in all_traces if t.model == nm):
            snap = tn.store.get(t.version)
            _, ide = nearest_center(snap.as_pool(), tn.x[t.q_lo:t.q_hi],
                                    backend="plain")
            if not np.array_equal(t.labels, ide.cpu().numpy()):
                parity += 1
    assert n_replayed == len(all_traces), "audit log lost a dispatch"
    assert stale == 0, f"{stale} responses not reproducible from their tag"
    assert parity == 0, f"{parity} responses diverge from engine labels"

    # Delta publication: every version materializes bit-identically from
    # the delta log and from the eager shadow copy of the same pass.
    for nm in names:
        tn = tenants[nm]
        assert tn.store.versions() == tn.shadow.versions()
        for v in tn.store.versions():
            sd, se = tn.store.get(v), tn.shadow.get(v)
            assert sd.count == se.count and sd.capacity == se.capacity
            assert torch.equal(sd.centers, se.centers), \
                f"model {nm} v{v}: delta != eager"

    # stream == one-shot (the carry, end to end; tenant 0)
    tn0 = tenants[names[0]]
    one = OCCEngine(DPMeansTransaction(cfg.lam, k_max=cfg.k_max),
                    pb=cfg.pb, device=cfg.device).run(tn0.x)
    assert int(one.pool.count) == int(tn0.engine.pool.count)
    assert torch.equal(one.pool.centers, tn0.engine.pool.centers), \
        "stream != one-shot"

    # Coalescing pays: replay the same request trace solo (no admission
    # queue) against the same stores and compare bucket-fill ratios.
    fill_coalesced = router.metrics()["bucket_fill_ratio"]
    solo = {nm: ClusterService(
                tenants[nm].store,
                serve_cfg.replace(coalesce=False, audit_log=False))
            for nm in names}
    for t in all_traces:
        solo[t.model].score(tenants[t.model].x[t.q_lo:t.q_hi])
    solo_rows = sum(s.n_queries for s in solo.values())
    solo_padded = sum(s.n_padded_rows for s in solo.values())
    fill_solo = solo_rows / max(1, solo_padded)
    assert fill_coalesced > fill_solo, (
        f"coalescing did not improve bucket fill: "
        f"{fill_coalesced:.3f} vs solo {fill_solo:.3f}")
    audit_s = time.perf_counter() - t_audit0

    lat = np.asarray([t.latency_s for t in all_traces])
    m = router.metrics()
    record = {
        "bench": "cluster_service",
        "device": str(resolve_device(cfg.device)),
        "n_models": cfg.n_models,
        "n_train_per_model": cfg.n, "pb": cfg.pb,
        "train_batch": cfg.train_batch,
        "k_final": {nm: int(tenants[nm].engine.pool.count) for nm in names},
        "n_queries": m["n_queries"],
        "n_requests": m["n_requests"],
        "n_microbatches": m["n_microbatches"],
        "query_step_compiles": m["query_step_compiles"],
        "n_versions_published": {nm: len(tenants[nm].store) for nm in names},
        "n_versions_observed": {nm: len(versions_observed[nm])
                                for nm in names},
        "delta_rows_published": {nm: tenants[nm].store.delta_rows_published
                                 for nm in names},
        "zero_stale_reads": stale == 0,
        "serve_train_parity": parity == 0,
        "delta_eq_eager": True,
        "stream_eq_oneshot": True,
        "n_replayed": n_replayed,
        "bucket_fill_coalesced": fill_coalesced,
        "bucket_fill_solo": fill_solo,
        "requests_per_group": {
            nm: m["models"][nm]["requests_per_group"] for nm in names},
        "n_deadline_flushes": {
            nm: m["models"][nm]["n_deadline_flushes"] for nm in names},
        "cap_trace_latest": {
            nm: m["models"][nm]["cap_trace"] for nm in names},
        "trainer_s": {nm: tenants[nm].train_s for nm in names},
        "serve_wall_s": serve_wall,
        "audit_s": audit_s,
        "qps": n_rows / serve_wall,
        "p50_latency_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_latency_ms": float(np.percentile(lat, 99) * 1e3),
    }
    return record, tenants, router


def run_demo(cfg: ServeDemoConfig) -> dict:
    # ONE shared Obs: trainer engines and every tenant's service land in a
    # single registry / trace file (tracer only when --trace-out asked).
    obs = Obs(tracer=Tracer("serve_clusters") if cfg.trace_out else None,
              trace_path=cfg.trace_out)
    record, tenants, router = _train_while_serve(cfg, obs)

    # Adversarial mixed-traffic QoS A/B: same offered load, lanes vs FIFO,
    # with shed + degraded-replay audits inside.
    t0 = time.perf_counter()
    qos_ab = _qos_mix(cfg, obs)
    record["qos_ab"] = qos_ab
    record["qos_s"] = time.perf_counter() - t0
    router.close()
    obs.flush()
    if cfg.out_path is not None:
        with open(cfg.out_path, "w") as f:
            json.dump(record, f, indent=2)
    if not cfg.quiet:
        names = list(tenants)
        ks = ", ".join(f"{nm}:K={record['k_final'][nm]}" for nm in names)
        print(f"trained {cfg.n_models} models ({ks}) over {cfg.n} streamed "
              f"points each; versions published: "
              f"{record['n_versions_published']}")
        print(f"served {record['n_queries']} rows / {record['n_requests']} "
              f"requests in {record['n_microbatches']} microbatches across "
              f"{record['n_versions_observed']} hot-swapped versions")
        print(f"bucket fill: coalesced={record['bucket_fill_coalesced']:.3f}"
              f" vs solo={record['bucket_fill_solo']:.3f}  "
              f"(requests/group: {record['requests_per_group']})")
        print(f"QPS={record['qps']:.0f}  p50={record['p50_latency_ms']:.2f}ms"
              f"  p99={record['p99_latency_ms']:.2f}ms  "
              f"({record['device']})")
        print("zero stale reads: True   serve==train bit-parity: True   "
              "delta==eager bit-identity: True")
        q, f = qos_ab["qos"], qos_ab["fifo"]
        print(f"QoS A/B: interactive p99 lanes="
              f"{q['interactive_p99_ms']:.2f}ms vs fifo="
              f"{f['interactive_p99_ms']:.2f}ms "
              f"({qos_ab['interactive_p99_speedup']:.1f}x); "
              f"shed={q['n_shed']} (all degraded replay bit-exact), "
              f"fifo shed={f['n_shed']}")
    return record


def quick_config(**kw) -> ServeDemoConfig:
    """The `--quick` sizes (a smoke run; numbers not meaningful)."""
    base = dict(n=1024, n_models=2, pb=64, train_batch=200, dim=8,
                min_queries=600, max_request=16, k_max=256, n_clients=12,
                coalesce_bucket=64, coalesce_delay_ms=8.0, qos_n=1024,
                qos_interactive_clients=6, qos_analytics_clients=2,
                qos_interactive_requests=60, qos_analytics_requests=12,
                qos_analytics_deadline_ms=150.0)
    base.update(kw)
    return ServeDemoConfig(**base)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--models", type=int, default=2)
    ap.add_argument("--pb", type=int, default=128)
    ap.add_argument("--train-batch", type=int, default=384)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--backend", default="auto")
    # ServeConfig-backed QoS knobs: the same fields the services are
    # constructed from, so CLI and library cannot drift.
    ap.add_argument("--shed-depth", type=int,
                    default=ServeDemoConfig.qos_shed_depth,
                    help="queued rows at which shedding starts "
                         "(ServeConfig.shed_depth)")
    ap.add_argument("--interactive-deadline-ms", type=float,
                    default=ServeDemoConfig.qos_interactive_deadline_ms,
                    help="interactive lane deadline in the QoS A/B")
    ap.add_argument("--analytics-deadline-ms", type=float,
                    default=ServeDemoConfig.qos_analytics_deadline_ms,
                    help="analytics lane deadline in the QoS A/B")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizes (numbers not meaningful)")
    ap.add_argument("--out", default=None,
                    help="write the run's record (JSON) here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto/Chrome trace JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = ServeDemoConfig(n=args.n, n_models=args.models, pb=args.pb,
                          train_batch=args.train_batch,
                          min_queries=args.queries, backend=args.backend,
                          out_path=args.out, trace_out=args.trace_out,
                          device=args.device)
    if args.quick:
        cfg = quick_config(n_models=max(2, args.models),
                           backend=args.backend, out_path=args.out,
                           trace_out=args.trace_out, device=args.device)
    cfg.qos_shed_depth = args.shed_depth
    cfg.qos_interactive_deadline_ms = args.interactive_deadline_ms
    if not args.quick:
        cfg.qos_analytics_deadline_ms = args.analytics_deadline_ms
    return run_demo(cfg)


if __name__ == "__main__":
    main()
