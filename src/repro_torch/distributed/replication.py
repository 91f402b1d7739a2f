"""Cross-host snapshot replication: the delta stream as wire format (§12).

The port's copy of `repro/distributed/replication.py`.  Follower stores
live on the device their caller gives (`make_follower(..., device=...)`,
the card by default).

`serving/snapshot.py`'s delta publication makes every publish an
append-only `CenterDelta` — O(ΔK·D) rows plus scalar metadata.  That
tuple IS the replication protocol: ship the per-model delta stream in
order and `SnapshotStore.apply_delta` it into follower stores, and every
follower version is bit-identical to the primary's (versions are assigned
once, by the primary, and travel on the wire).

`DeltaChannel` is the in-process loopback backend of the `Transport`
interface (`distributed/transport.py`): a thread-safe ordered queue with
per-model follower registration and explicit `pump()` delivery — tests
drive delivery deterministically, and swapping in the socket-backed
`ReplicationServer` changes nothing about the stores or the protocol,
which is the point of the shared interface.  Byte counters expose the
replication cost: Σ ΔK·D·itemsize, NOT versions × capacity × D — the
log-vs-prefix saving the delta format exists for.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any

from repro_torch.distributed.transport import Transport
from repro_torch.serving.snapshot import CenterDelta, SnapshotStore

__all__ = ["DeltaChannel", "make_follower"]


class DeltaChannel(Transport):
    """In-process, ordered, thread-safe delta stream with fan-out.

    Publishers call `send` (SnapshotStore does it on every delta-mode
    publish when constructed with `wire=channel`); followers attach per
    model tag and receive deltas in publish order on `pump()`.  Delivery
    is pull-based so tests control interleaving; `pump` is safe to call
    from any thread, concurrently with senders.
    """

    def __init__(self):
        super().__init__()
        self._q: deque[CenterDelta] = deque()
        self._lock = threading.Lock()
        self._followers: dict[str | None, list[SnapshotStore]] = {}
        self._acked: dict[str | None, dict[int, int]] = {}
        #            model → {id(store): last applied version}

    def send(self, delta: CenterDelta) -> None:
        with self._lock:
            self._q.append(delta)
            self.n_sent += 1
            self.bytes_sent += delta.nbytes

    def attach(self, model: str | None, store: SnapshotStore) -> SnapshotStore:
        """Register a follower store for one model's delta stream."""
        if not store.delta:
            raise ValueError("followers must be delta-mode stores")
        with self._lock:
            self._followers.setdefault(model, []).append(store)
        return store

    def pending(self) -> int:
        with self._lock:
            return len(self._q)

    def commit_watermark(self, model: str | None = None) -> int | None:
        """Min version every attached follower of `model` has applied
        (0 for a follower that has applied nothing; None if no followers)
        — the loopback analogue of the socket server's ack watermark,
        where delivery via `pump` IS the ack."""
        with self._lock:
            stores = self._followers.get(model, ())
            if not stores:
                return None
            acked = self._acked.get(model, {})
            return min(acked.get(id(s), 0) for s in stores)

    def pump(self, max_items: int | None = None) -> int:
        """Deliver queued deltas to attached followers, in order.  Returns
        the number of deltas delivered.  Deltas for models with no
        follower are dropped (delivered to nobody) — the primary's ring is
        the source of truth; followers that attach later start from the
        next rebase/bootstrap they see."""
        delivered = 0
        while max_items is None or delivered < max_items:
            with self._lock:
                if not self._q:
                    break
                delta = self._q.popleft()
                followers = list(self._followers.get(delta.model, ()))
            for store in followers:
                # A follower attached mid-stream is not yet bootstrapped:
                # it can only start on a stream head (start == 0); anything
                # later must wait for the next rebase.
                if store.n_deltas == 0 and delta.start != 0:
                    continue
                store.apply_delta(delta)
                with self._lock:
                    self._acked.setdefault(delta.model,
                                           {})[id(store)] = delta.version
            with self._lock:
                self.n_delivered += 1
            delivered += 1
        return delivered


def make_follower(channel: DeltaChannel, model: str | None,
                  capacity: int = 16, **store_kw: Any) -> SnapshotStore:
    """A delta-mode follower store attached to `channel` for `model` —
    the receive side of cross-host serving: point a `ClusterService` (or a
    follower `ModelRouter` tenant) at it and `pump()` on arrival."""
    store = SnapshotStore(capacity=capacity, delta=True, model=model,
                          **store_kw)
    return channel.attach(model, store)
