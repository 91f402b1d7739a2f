"""Multi-model router: many snapshot stores behind one service.

The port of `repro/serving/router.py`.  A `ModelRouter` owns one
(SnapshotStore, ClusterService) pair per named model and routes
assign / score / topk requests by model name:

* Per-model versioning and hot swap: tenants share no mutable state, so
  publishing to one model never changes another model's responses.
* Shared query steps: the steps are module-level functions, and
  `metrics()["query_step_compiles"]` counts the distinct step shapes seen
  since the router was built, bounded by the distinct (bucket, capacity)
  pairs across all tenants, not by the tenant count.
* Coalescing per model: with `config.coalesce` every tenant service gets
  an admission queue (requests of different models never share a
  dispatch).
* Fleet-wide shedding: every tenant service gets a `shed_signal` reading
  the total queued rows of all tenants against `config.shed_depth`.
* `add_model(delta=True, wire=channel)` publishes through the delta log
  and emits the `CenterDelta` wire stream.

Differences from the JAX package: stores are made on the router's
`device` ("cuda" unless the caller asks for the CPU).  `mesh` is passed on
to every tenant's service (`ClusterService(mesh=)`: every rank routes the
same requests).
"""
from __future__ import annotations

import threading
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.obs import Obs
from repro_torch.serving import cluster_service as _cs
from repro_torch.serving.cluster_service import ClusterService, ServeResponse
from repro_torch.serving.qos import Query, ServeConfig
from repro_torch.serving.snapshot import SnapshotStore

__all__ = ["ModelRouter"]


class ModelRouter:
    """Routes batched assignment queries to named per-model services.

    Construction mirrors `ClusterService`: `ModelRouter(config)` with a
    shared `ServeConfig` (see serving/qos.py), or the historical keyword
    form (`ModelRouter(coalesce=True, ...)`) — ServeConfig fields passed
    as keywords are `replace`d into the config.  The config is every
    tenant's default; `add_model` accepts per-tenant ServeConfig-field
    overrides (or a whole `config=`).  Thread-safe: `add_model` and
    queries may race (the model map flips atomically under a lock;
    queries hold a reference to their tenant's service for the duration
    of the call).
    """

    def __init__(self, config: ServeConfig | None = None, *,
                 mesh: Any = None,
                 data_axis: str = "data",
                 obs: Obs | None = None,
                 device: str | torch.device = "cuda",
                 **overrides):
        if config is None:
            config = ServeConfig()
        if overrides:
            config = config.replace(**overrides)
        self.config = config
        # ONE shared obs: every tenant's counters land in the same
        # registry (distinguished by their model= label), so the router-
        # level aggregates below are plain registry reads.
        self.obs = obs if obs is not None else Obs()
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = resolve_device(device)
        mesh_type = getattr(mesh, "device_type", None)
        if mesh is not None and mesh_type != self.device.type:
            raise ValueError(f"a {mesh_type} mesh for a router on "
                             f"{self.device.type}")
        self._services: dict[str, ClusterService] = {}
        self._lock = threading.Lock()
        self._traces0 = _cs._QUERY_TRACES

    # ------------------------------------------------------------ model mgmt
    def _fleet_shed_signal(self):
        """Fleet-wide overload term: total queued rows across every
        tenant, normalized by the shared shed_depth threshold.  Each
        service takes max(own score, this) at admission time."""
        def signal() -> float:
            with self._lock:
                svcs = list(self._services.values())
            rows = sum(svc.queue_depth_rows() for svc in svcs)
            return rows / max(1, self.config.shed_depth)
        return signal

    def add_model(self, name: str, store: SnapshotStore | None = None, *,
                  snapshot_capacity: int = 16, delta: bool = False,
                  wire: Any = None, max_model_capacity: int | None = None,
                  config: ServeConfig | None = None,
                  **service_overrides) -> SnapshotStore:
        """Register a tenant; returns its store (hand `store.publish_pass`
        to the tenant's `OCCEngine(publish=)`).  `config` replaces the
        router default wholesale for this tenant; bare ServeConfig fields
        in `service_overrides` patch it."""
        with self._lock:
            if name in self._services:
                raise ValueError(f"model {name!r} already registered")
        if store is None:
            store = SnapshotStore(capacity=snapshot_capacity, delta=delta,
                                  model=name, wire=wire,
                                  max_model_capacity=max_model_capacity,
                                  device=self.device)
        cfg = config if config is not None else self.config
        if service_overrides:
            cfg = cfg.replace(**service_overrides)
        # Construct outside the lock (coalescing services spawn a flusher
        # thread); re-check under it so a racing duplicate never leaks that
        # thread — the loser closes its service and raises.
        svc = ClusterService(store, cfg, name=name, mesh=self.mesh,
                             data_axis=self.data_axis, obs=self.obs,
                             shed_signal=self._fleet_shed_signal())
        with self._lock:
            if name in self._services:
                svc.close()
                raise ValueError(f"model {name!r} already registered")
            self._services[name] = svc
        return store

    def remove_model(self, name: str) -> None:
        with self._lock:
            svc = self._services.pop(name)
        svc.close()

    def close(self) -> None:
        with self._lock:
            svcs = list(self._services.values())
            self._services.clear()
        for svc in svcs:
            svc.close()

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._services)

    def service(self, model: str) -> ClusterService:
        with self._lock:
            svc = self._services.get(model)
        if svc is None:
            raise KeyError(f"unknown model {model!r}")
        return svc

    def store(self, model: str) -> SnapshotStore:
        return self.service(model).store

    def publish_hook(self, model: str):
        """The tenant's `OCCEngine(publish=...)` target."""
        return self.store(model).publish_pass

    # --------------------------------------------------------------- queries
    def submit(self, model: str, query: Query) -> ServeResponse:
        """Typed entrypoint, mirroring `ClusterService.submit`."""
        return self.service(model).submit(query)

    def score(self, model: str, x) -> ServeResponse:
        return self.service(model).score(x)

    def assign(self, model: str, x) -> ServeResponse:
        return self.service(model).assign(x)

    def topk(self, model: str, x, k: int = 4) -> ServeResponse:
        return self.service(model).topk(x, k=k)

    # --------------------------------------------------------------- metrics
    def metrics(self) -> dict[str, Any]:
        with self._lock:
            svcs = dict(self._services)
        per_model = {name: svc.metrics() for name, svc in sorted(svcs.items())}
        return {
            "models": per_model,
            "n_models": len(per_model),
            "n_queries": sum(m["n_queries"] for m in per_model.values()),
            "n_requests": sum(m["n_requests"] for m in per_model.values()),
            "n_microbatches": sum(m["n_microbatches"]
                                  for m in per_model.values()),
            "bucket_fill_ratio": (
                sum(m["n_queries"] for m in per_model.values())
                / max(1, sum(svc.n_padded_rows for svc in svcs.values()))),
            # fleet-wide QoS pressure: the max of every tenant's last
            # published overload score, plus total shed counts per lane.
            "overload_score": max(
                (m["overload_score"] for m in per_model.values()),
                default=0.0),
            "n_shed": {
                lane: sum(m["n_shed"][lane] for m in per_model.values())
                for lane in ("interactive", "batch", "analytics")},
            # distinct step shapes since router construction, across
            # every tenant: bounded by distinct (bucket, capacity, backend)
            # triples, not by the tenant count.
            "query_step_compiles": _cs._QUERY_TRACES - self._traces0,
        }
