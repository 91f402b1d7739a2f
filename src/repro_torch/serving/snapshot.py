"""Immutable model snapshots: the train -> serve publication point.

The port of `repro/serving/snapshot.py`.  OCC training *publishes*
immutable model versions; a read-only service answers queries against
them.  Trainer and service share no mutable state: the only channel is
`SnapshotStore.publish_pass`, handed to `OCCEngine(publish=...)`.

Immutability: a `ModelSnapshot`'s tensors are copies of the pool's prefix,
taken at publish time on the store's device and never written again, so a
reader may hold a snapshot across any number of queries.  `version` is
assigned monotonically under the store lock.

Capacity bucketing: the pool's valid slots are a prefix, so a snapshot
keeps only the next power-of-two capacity >= count (min 8).  Capacities
move through a handful of buckets as the model grows, so the service's
query steps see a handful of shapes.

Delta publication (`SnapshotStore(delta=True)`): within an engine stream
the pool only appends between publishes, so version v+1 differs from v by
the rows [count_v, count_{v+1}).  Each publish copies only those rows to
the host, appends them to an append-only `CenterLog`, and registers a lazy
`DeltaSnapshot` whose `materialize()` rebuilds the dense capacity-bucketed
tensors bit-identically to the eager copy (pool rows beyond `count` are
zero by construction).  The emitted `CenterDelta` (numpy rows) is the
replication wire format: `apply_delta`-ing the deltas into a follower
store reproduces every version bit-identically.  A caller that rewrote the
prefix passes `rebase=True`; a one-row guard (`verify=True`: a full check)
rebases on its own when the last published row changed.

Hierarchical layout (`SnapshotStore(hier=True)`): `build_hier` groups the
flat prefix into cells around a strided sample of coarse centers, routed
through `kernels/ops.assign` (the CUDA kernel for tensors on the card); it
is an access path for multi-probe top-k, and the flat tensors stay
authoritative.

Differences from the JAX package: snapshots live on the store's device
(`SnapshotStore(device="cuda")` by default, `freeze_snapshot(...,
device=None)` keeps the pool's device), and `CenterLog` takes the device
its dense buffers go to.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.engine import OCCPassResult
from repro_torch.core.occ import CenterPool, next_pow2

__all__ = ["ModelSnapshot", "SnapshotStore", "next_bucket", "freeze_snapshot",
           "CenterDelta", "CenterLog", "DeltaSnapshot", "HierIndex",
           "build_hier"]

_MIN_CAPACITY = 8   # the smallest center buffer a snapshot keeps


@dataclass(frozen=True)
class HierIndex:
    """Two-level routing layout over a snapshot's flat center prefix.

    `coarse` holds about sqrt(count) routing centers (a strided sample of
    the active prefix); every active center belongs to exactly one cell
    (its nearest coarse center, ties to the lower cell), and cell c's
    members sit in `fine[c]`, padded to the common power-of-two
    `shard_cap`, in ascending flat index.  `fine_ids` maps each shard slot
    back to its flat index (-1 pad), so hierarchical top-k returns flat
    ids.  `fine` rows are bit-copies of flat rows, so probing every cell
    reproduces flat top-k.
    """
    coarse: torch.Tensor       # (n_cells, D) routing centers
    coarse_mask: torch.Tensor  # (n_cells,) bool, all True
    fine: torch.Tensor         # (n_cells, shard_cap, D) member rows
    fine_ids: torch.Tensor     # (n_cells, shard_cap) int32 flat index, -1 pad
    fine_mask: torch.Tensor    # (n_cells, shard_cap) bool
    n_cells: int
    shard_cap: int


def build_hier(centers, mask, count: int, *, n_cells: int | None = None,
               shard_cap: int | None = None) -> HierIndex | None:
    """Group a flat center prefix into the two-level `HierIndex`, on the
    centers' device.

    The routing pass is `kernels/ops.assign` of every active center
    against the coarse sample (the CUDA kernel on the card, the plain
    version on the CPU); the stable grouping runs on the host over the
    cell labels, and the rows are gathered on the device.  Defaults:
    n_cells = pow2(ceil(sqrt(count))) clamped to <= count, shard_cap =
    pow2(largest cell).  Returns None for an empty model.
    """
    from repro_torch.kernels import ops as _kops
    count = int(count)
    if count <= 0:
        return None
    cn = centers[:count].contiguous()
    dev = cn.device
    d = cn.shape[1]
    if n_cells is None:
        n_cells = next_pow2(max(int(np.ceil(np.sqrt(count))), 1))
    while n_cells > count:
        n_cells //= 2
    n_cells = max(n_cells, 1)
    seeds = (np.arange(n_cells) * count) // n_cells
    coarse = cn[torch.as_tensor(seeds, device=dev)].contiguous()
    _, cell_t = _kops.assign(cn, coarse,
                             torch.ones((n_cells,), dtype=torch.bool,
                                        device=dev))
    cell = cell_t.cpu().numpy().astype(np.int64)
    counts = np.bincount(cell, minlength=n_cells)
    cap = next_bucket(int(counts.max()), lo=_MIN_CAPACITY)
    if shard_cap is not None:
        if shard_cap < counts.max():
            raise ValueError(
                f"shard_cap={shard_cap} < largest cell ({int(counts.max())})")
        cap = shard_cap
    order = np.argsort(cell, kind="stable")      # groups cells, keeps
    #                                              ascending ids per cell
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.arange(count) - start[cell[order]]
    slot = torch.as_tensor(cell[order] * cap + ranks, device=dev)
    order_t = torch.as_tensor(order, device=dev)
    fine = torch.zeros((n_cells * cap, d), dtype=cn.dtype, device=dev)
    fine[slot] = cn[order_t]
    fine_ids = torch.full((n_cells * cap,), -1, dtype=torch.int32, device=dev)
    fine_ids[slot] = order_t.to(torch.int32)
    fine_mask = torch.zeros((n_cells * cap,), dtype=torch.bool, device=dev)
    fine_mask[slot] = True
    return HierIndex(coarse=coarse,
                     coarse_mask=torch.ones((n_cells,), dtype=torch.bool,
                                            device=dev),
                     fine=fine.reshape(n_cells, cap, d),
                     fine_ids=fine_ids.reshape(n_cells, cap),
                     fine_mask=fine_mask.reshape(n_cells, cap),
                     n_cells=n_cells, shard_cap=cap)


def next_bucket(n: int, lo: int = _MIN_CAPACITY, hi: int | None = None) -> int:
    """Smallest power of two >= n, clamped to [lo, hi] (lo a power of
    two)."""
    b = max(lo, next_pow2(n))
    return b if hi is None else min(b, hi)


@dataclass(frozen=True)
class ModelSnapshot:
    """One immutable published model version.

    Tensor fields live on the store's device and are frozen at publish
    time; scalar metadata is host Python (read once per publish, never on
    the query path).
    """
    version: int            # monotone id assigned by the store
    centers: torch.Tensor   # (capacity, D), the capacity-bucketed prefix
    mask: torch.Tensor      # (capacity,) bool, arange < count
    count: int              # valid centers (K of this version)
    capacity: int           # power-of-two buffer size
    n_seen: int = 0         # training points folded in when frozen
    epochs: int = 0         # global OCC epochs committed when frozen
    overflow: bool = False  # pool or validator overflow was raised
    objective: float | None = None   # optional objective metadata
    cap_est: int | None = None       # adaptive-cap estimator at publish time
    cap_trace: tuple[int, ...] | None = None  # per-epoch OCCStats.cap of the
    #                                           pass that produced it
    hier: HierIndex | None = None    # optional two-level layout (build_hier)

    @property
    def k(self) -> int:
        return self.count

    def materialize(self) -> "ModelSnapshot":
        """Already dense (`DeltaSnapshot.materialize()` produces this)."""
        return self

    def as_pool(self) -> CenterPool:
        """This snapshot as a read-only `CenterPool` on its device, so
        serving results can be checked against `core.occ.nearest_center`
        on the exact tensors the service used."""
        dev = self.centers.device
        return CenterPool(self.centers, self.mask,
                          torch.tensor(self.count, dtype=torch.int32,
                                       device=dev),
                          torch.tensor(self.overflow, device=dev))

    def to_pool(self, k_max: int) -> CenterPool:
        """Re-expand into a trainer-shaped (k_max, D) pool, the seed of
        `OCCEngine.restore`.  Rows beyond `count` are zero, as in a live
        pool, so a restored stream equals the uninterrupted one."""
        if k_max < self.count:
            raise ValueError(f"k_max={k_max} < snapshot count {self.count}")
        dev = self.centers.device
        centers = torch.zeros((k_max, self.centers.shape[1]),
                              dtype=self.centers.dtype, device=dev)
        centers[:self.count] = self.centers[:self.count]
        mask = torch.arange(k_max, device=dev) < self.count
        return CenterPool(centers, mask,
                          torch.tensor(self.count, dtype=torch.int32,
                                       device=dev),
                          torch.tensor(self.overflow, device=dev))


def freeze_snapshot(pool: CenterPool, version: int, *, n_seen: int = 0,
                    epochs: int = 0, objective: float | None = None,
                    max_capacity: int | None = None,
                    cap_est: int | None = None,
                    cap_trace: tuple[int, ...] | None = None,
                    hier_spec: tuple[int | None, int | None] | None = None,
                    device: str | torch.device | None = None,
                    ) -> ModelSnapshot:
    """Freeze a CenterPool into an immutable, capacity-bucketed snapshot on
    `device` (None: the pool's).

    One host sync (count and overflow) per publish; the centers are a
    fresh copy the trainer never touches.  `hier_spec` (n_cells,
    shard_cap, either None for the default) also builds the `HierIndex`
    over the same prefix; the flat tensors are the same either way.
    """
    dev = pool.centers.device if device is None else resolve_device(device)
    count = int(pool.count)
    k_max = pool.centers.shape[0]
    cap = next_bucket(count, hi=min(k_max, max_capacity or k_max))
    if cap < count:
        # Silent truncation would drop live centers and break the
        # serve == train contract; refuse loudly instead.
        raise ValueError(
            f"max_capacity={max_capacity} cannot hold {count} live centers")
    centers = pool.centers[:cap].to(dev, copy=True).contiguous()
    mask = torch.arange(cap, device=dev) < count
    hier = None
    if hier_spec is not None:
        hier = build_hier(centers, mask, count,
                          n_cells=hier_spec[0], shard_cap=hier_spec[1])
    return ModelSnapshot(version=version, centers=centers, mask=mask,
                         count=count, capacity=cap, n_seen=n_seen,
                         epochs=epochs, overflow=bool(pool.overflow),
                         objective=objective, cap_est=cap_est,
                         cap_trace=cap_trace, hier=hier)


# ---------------------------------------------------------------------------
# Delta publication
# ---------------------------------------------------------------------------

class CenterDelta(NamedTuple):
    """One publish, as it crosses the wire: the rows version v adds over
    v-1 plus the scalar metadata of v.  `rows` is numpy, the wire format
    of both packages."""
    model: str | None       # routing tag on a shared channel
    version: int            # assigned by the primary store
    start: int              # first row this delta writes (== prior count)
    rows: np.ndarray        # (dK, D) appended center rows (bit-exact)
    count: int              # watermark after applying == start + len(rows)
    capacity: int           # the primary's capacity bucket
    rebase: bool            # True: rows span [0, count), a fresh base
    n_seen: int = 0
    epochs: int = 0
    overflow: bool = False
    objective: float | None = None
    cap_est: int | None = None
    cap_trace: tuple[int, ...] | None = None

    @property
    def nbytes(self) -> int:
        return self.rows.nbytes


class CenterLog:
    """Append-only dense row store (host memory) backing a delta-mode
    store: amortised-doubling numpy buffer, `append` O(dK*D), `dense`
    materialises log[:count] + zero pad on `device` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, dim: int, dtype=np.float32,
                 device: str | torch.device = "cuda"):
        self._dim = dim
        self._dtype = np.dtype(dtype)
        self._device = resolve_device(device)
        self._buf = np.zeros((_MIN_CAPACITY, dim), self._dtype)
        self._n = 0

    @property
    def rows(self) -> int:
        return self._n

    def append(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, self._dtype)
        need = self._n + rows.shape[0]
        if need > self._buf.shape[0]:
            grown = np.zeros((next_pow2(need), self._dim), self._dtype)
            grown[:self._n] = self._buf[:self._n]
            self._buf = grown
        self._buf[self._n:need] = rows
        self._n = need

    def row(self, i: int) -> np.ndarray:
        return self._buf[i]

    def dense(self, count: int, capacity: int) -> torch.Tensor:
        """(capacity, D) tensor on the log's device: log[:count] + zero
        pad."""
        out = np.zeros((capacity, self._dim), self._dtype)
        out[:count] = self._buf[:count]
        return torch.from_numpy(out).to(self._device)


@dataclass
class DeltaSnapshot:
    """Lazy published version: metadata now, dense tensors on first read
    (`materialize()`, cached; bit-identical to the eager copy)."""
    version: int
    count: int
    capacity: int
    n_seen: int
    epochs: int
    overflow: bool
    objective: float | None
    cap_est: int | None
    cap_trace: tuple[int, ...] | None
    _log: CenterLog
    _dense: ModelSnapshot | None = None
    hier_spec: tuple[int | None, int | None] | None = None

    def materialize(self) -> ModelSnapshot:
        """Dense, capacity-bucketed tensors, equal bit for bit to the
        eager `freeze_snapshot` copy of the same pool; a configured
        `hier_spec` builds the HierIndex here (a benign race may build the
        cache twice; both builds are equal)."""
        if self._dense is None:
            centers = self._log.dense(self.count, self.capacity)
            mask = torch.arange(self.capacity, device=centers.device) \
                < self.count
            hier = None
            if self.hier_spec is not None:
                hier = build_hier(centers, mask, self.count,
                                  n_cells=self.hier_spec[0],
                                  shard_cap=self.hier_spec[1])
            self._dense = ModelSnapshot(
                version=self.version, centers=centers, mask=mask,
                count=self.count, capacity=self.capacity, n_seen=self.n_seen,
                epochs=self.epochs, overflow=self.overflow,
                objective=self.objective, cap_est=self.cap_est,
                cap_trace=self.cap_trace, hier=hier)
        return self._dense


@dataclass
class SnapshotStore:
    """Thread-safe ring of published model versions on `device`.

    The trainer publishes (`publish_pass` as the engine's `publish=` hook,
    or `publish_pool`); services read `latest()` / `get(version)`.  Old
    versions are evicted FIFO beyond `capacity`; readers holding an
    evicted snapshot are unaffected.

    `delta=True` publishes through the append-only center log (O(dK*D) a
    publish, lazy dense tensors) and emits a `CenterDelta` per publish, to
    `wire` when given.  `hier=True` (with `hier_cells` /
    `hier_shard_cap`) builds a `HierIndex` on every version, eagerly for
    eager stores and at first materialize for delta stores; it is local
    store policy, not wire state.
    """
    capacity: int = 16
    max_model_capacity: int | None = None
    delta: bool = False
    hier: bool = False
    hier_cells: int | None = None
    hier_shard_cap: int | None = None
    model: str | None = None            # wire tag for emitted deltas
    wire: Any = None                    # optional .send(CenterDelta) channel
    device: str | torch.device = "cuda"
    _ring: "OrderedDict[int, Any]" = field(default_factory=OrderedDict)
    _next_version: int = 1
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _log: CenterLog | None = None
    _watermark: int = 0                 # rows published into the log so far
    n_deltas: int = 0
    delta_rows_published: int = 0       # sum of dK over all publishes

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def publish_pool(self, pool: CenterPool, *, n_seen: int = 0,
                     epochs: int = 0, objective: float | None = None,
                     cap_est: int | None = None,
                     cap_trace: tuple[int, ...] | None = None,
                     rebase: bool = False,
                     verify: bool = False) -> ModelSnapshot | DeltaSnapshot:
        """Freeze and publish; returns the new snapshot with its version."""
        with self._lock:
            if not self.delta:
                snap = freeze_snapshot(
                    pool, self._next_version, n_seen=n_seen, epochs=epochs,
                    objective=objective, cap_est=cap_est, cap_trace=cap_trace,
                    max_capacity=self.max_model_capacity,
                    hier_spec=self._hier_spec(), device=self.device)
                self._next_version += 1
                self._register(snap)
                return snap
            return self._publish_delta_locked(
                pool, n_seen=n_seen, epochs=epochs, objective=objective,
                cap_est=cap_est, cap_trace=cap_trace, rebase=rebase,
                verify=verify)

    def _new_log(self, dim: int, dtype) -> CenterLog:
        return CenterLog(dim, dtype, device=self.device)

    def _publish_delta_locked(self, pool, *, n_seen, epochs, objective,
                              cap_est, cap_trace, rebase, verify):
        count = int(pool.count)
        k_max = pool.centers.shape[0]
        cap = next_bucket(count, hi=min(k_max,
                                        self.max_model_capacity or k_max))
        if cap < count:
            raise ValueError(
                f"max_model_capacity={self.max_model_capacity} cannot hold "
                f"{count} live centers")
        dtype = pool.centers[:1].cpu().numpy().dtype
        if self._log is None:
            self._log = self._new_log(pool.centers.shape[1], dtype)
        wm = self._watermark
        # Append-only guards: a shrunk count is never append-only; the
        # one-row check catches a rewritten prefix at O(D); verify checks
        # the whole prefix.
        if count < wm:
            rebase = True
        elif wm and not rebase:
            probe = slice(0, wm) if verify else slice(wm - 1, wm)
            if not np.array_equal(pool.centers[probe].cpu().numpy(),
                                  self._log._buf[probe]):
                rebase = True
        start = 0 if rebase else wm
        rows = pool.centers[start:count].cpu().numpy()
        if rebase:
            # A fresh log, not a reset: versions published before the
            # rebase keep the old one, which is never written again.
            self._log = self._new_log(pool.centers.shape[1], dtype)
        self._log.append(rows)
        self._watermark = count
        delta = CenterDelta(
            model=self.model, version=self._next_version, start=start,
            rows=rows, count=count, capacity=cap, rebase=rebase,
            n_seen=n_seen, epochs=epochs, overflow=bool(pool.overflow),
            objective=objective, cap_est=cap_est, cap_trace=cap_trace)
        self._next_version += 1
        snap = self._snapshot_from_delta(delta)
        self._register(snap)
        self.n_deltas += 1
        self.delta_rows_published += rows.shape[0]
        if self.wire is not None:
            self.wire.send(delta)
        return snap

    def _hier_spec(self) -> tuple[int | None, int | None] | None:
        if not self.hier:
            return None
        return (self.hier_cells, self.hier_shard_cap)

    def _snapshot_from_delta(self, delta: CenterDelta):
        return DeltaSnapshot(
            version=delta.version, count=delta.count, capacity=delta.capacity,
            n_seen=delta.n_seen, epochs=delta.epochs,
            overflow=delta.overflow, objective=delta.objective,
            cap_est=delta.cap_est, cap_trace=delta.cap_trace, _log=self._log,
            hier_spec=self._hier_spec())

    def _register(self, snap) -> None:
        self._ring[snap.version] = snap
        while len(self._ring) > self.capacity:
            self._ring.popitem(last=False)

    def apply_delta(self, delta: CenterDelta) -> ModelSnapshot | DeltaSnapshot:
        """Follower side of replication: fold one wire delta into this
        store, reproducing the primary's version bit-identically.  Deltas
        must arrive in order per model."""
        with self._lock:
            if not self.delta:
                raise ValueError("apply_delta requires a delta-mode store")
            if self._log is None or delta.rebase:
                self._log = self._new_log(delta.rows.shape[1],
                                          delta.rows.dtype)
                self._watermark = 0
            if delta.start != self._watermark:
                raise ValueError(
                    f"delta gap: have {self._watermark} rows, delta starts "
                    f"at {delta.start} (version {delta.version})")
            self._log.append(delta.rows)
            self._watermark = delta.count
            self._next_version = delta.version + 1
            snap = self._snapshot_from_delta(delta)
            self._register(snap)
            self.n_deltas += 1
            self.delta_rows_published += delta.rows.shape[0]
            return snap

    def bootstrap_delta(self) -> CenterDelta | None:
        """The latest version as a full-prefix rebase delta: the bootstrap
        payload of a late-joining follower."""
        with self._lock:
            if not self._ring:
                return None
            snap = next(reversed(self._ring.values()))
            if self.delta:
                # after a rebase the current log backs the latest version
                rows = self._log._buf[:snap.count].copy()
            else:
                rows = snap.centers[:snap.count].cpu().numpy()
            return CenterDelta(
                model=self.model, version=snap.version, start=0, rows=rows,
                count=snap.count, capacity=snap.capacity, rebase=True,
                n_seen=snap.n_seen, epochs=snap.epochs,
                overflow=bool(snap.overflow), objective=snap.objective,
                cap_est=snap.cap_est, cap_trace=snap.cap_trace)

    def publish_pass(self, result: OCCPassResult, *, n_seen: int = 0,
                     epochs: int = 0,
                     cap_est: int | None = None) -> Any:
        """`OCCEngine(publish=store.publish_pass)`: one version per
        committed pass, with the engine's adaptive-cap estimate and the
        pass's per-epoch cap trace."""
        cap = result.stats.cap
        trace = None if cap is None else tuple(
            int(c) for c in cap.cpu().tolist())
        return self.publish_pool(result.pool, n_seen=n_seen, epochs=epochs,
                                 cap_est=cap_est, cap_trace=trace)

    def latest(self) -> ModelSnapshot | None:
        with self._lock:
            if not self._ring:
                return None
            snap = next(reversed(self._ring.values()))
        return snap.materialize()

    def latest_meta(self) -> Any:
        """Newest published version without materialising dense tensors."""
        with self._lock:
            if not self._ring:
                return None
            return next(reversed(self._ring.values()))

    def get(self, version: int) -> ModelSnapshot | None:
        with self._lock:
            snap = self._ring.get(version)
        return None if snap is None else snap.materialize()

    def versions(self) -> list[int]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
