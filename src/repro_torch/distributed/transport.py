"""Socket transport for delta replication: acks, watermark, bootstrap,
backpressure, fencing and fault injection (§13–§14).

The port's copy of `repro/distributed/transport.py`: the same frames on the
same sockets, so a follower of one package tails a primary of the other.
The stores it keeps (the server's shadow, a client's follower store) live on
the device the caller gives, the card unless the caller asks for the CPU.

The `Transport` interface is the seam between the OCC publication path and
the bytes that carry it: a `SnapshotStore(delta=True, wire=transport)`
calls `send(CenterDelta)` on every publish and never learns whether the
other side is a deque in the same process (`replication.DeltaChannel`, the
loopback backend) or follower processes on real sockets
(`ReplicationServer` here).  Both back ends preserve the one invariant the
stores rely on: per-model deltas arrive in publish order — live deltas
exactly once, with any loss repaired by a full-prefix SNAPSHOT rebase so
the *state* stream is still exactly-once.

`ReplicationServer` is the primary's side of the wire:

  * per-follower ACKs — each follower acknowledges every version it has
    durably applied; the server records per-(connection, version) ack
    latency for the replication benchmarks;
  * commit watermark — `commit_watermark(model)` is the min acked version
    over live followers: everything at or below it is replicated
    everywhere, the transport-level analogue of the serializing master's
    commit point in the paper;
  * snapshot bootstrap — the server folds every outbound delta into an
    internal shadow follower store; a late joiner (HELLO with
    `have_version` behind the shadow's latest) first receives a SNAPSHOT
    frame: the shadow's latest version as a full-prefix REBASE delta.
    `SnapshotStore.apply_delta` already implements rebase semantics, so
    bootstrap needs no new follower code path — the joiner applies the
    snapshot like any delta and then tails the live stream, landing
    bit-identical to a follower that was attached from version 1;
  * backpressure (§14) — per-follower outbound queues are BOUNDED
    (`max_queue`).  A follower too slow to drain its queue is lagged: its
    queued frames are discarded and replaced by one fresh SNAPSHOT (the
    shadow's latest as a rebase delta), so server memory per follower is
    bounded by `max_queue` frames + 1 snapshot while the follower still
    converges to the exact primary state — the drop-to-resync policy;
  * term fencing (§14) — the server stamps every outbound frame with its
    promotion `term`.  A HELLO carrying a NEWER term proves a newer
    master has been promoted: the server marks itself `fenced` and stops
    accepting connections — the zombie-master guard.

`ReplicationClient` is the follower loop: connect → HELLO → apply
SNAPSHOT/DELTA frames into a local delta-mode store → ACK each version →
stop on FIN or EOF.  With `reconnect=True` a broken stream is retried
with exponential backoff + seeded full jitter; the HELLO carries the
store's latest version, so a reconnect resumes exactly where the stream
broke (or takes a SNAPSHOT resync if it fell behind).  Duplicate frames
(at-least-once redelivery after a reconnect race, or chaos `dup`
injection) are ACKed but not re-applied; a sequence gap (chaos `drop`)
raises inside `apply_delta` and is healed by the same reconnect-and-
resync path.  Frames with a stale term are rejected without ACK.

Both sides accept a `fault.FaultPlan` and consult it at named points
(`server.writer`, `client.apply`) — the chaos tests drive delayed,
dropped, duplicated and held frames and socket resets through real code
paths.
"""
from __future__ import annotations

import abc
import queue
import random
import socket
import threading
import time

import numpy as np

import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.fault import FaultPlan
from repro_torch.distributed.protocol import (
    ACK, DELTA, FIN, HELLO, SNAPSHOT, ack_frame, delta_frame, fin_frame,
    frame_delta, hello_frame, read_frame, write_frame)
from repro_torch.obs import Obs
from repro_torch.obs.metrics import now as _now
from repro_torch.serving.snapshot import CenterDelta, SnapshotStore

__all__ = ["Transport", "ReplicationServer", "ReplicationClient",
           "store_digest"]


class Transport(abc.ABC):
    """Delta fan-out seam between a primary store and its followers.

    Implementations must deliver each model's deltas to every follower in
    publish order, exactly once at the state level (a lossy path must
    repair itself with a rebase SNAPSHOT).  `pump`/`pending` exist for
    pull-based back ends (the in-process loopback lets tests control
    interleaving); push-based back ends deliver asynchronously and leave
    them as no-ops.
    """

    def __init__(self) -> None:
        self.n_sent = 0        # deltas accepted for delivery
        self.n_delivered = 0   # delta→follower deliveries completed
        self.bytes_sent = 0    # payload bytes accepted for delivery

    @abc.abstractmethod
    def send(self, delta: CenterDelta) -> None:
        """Enqueue one published delta for delivery to followers."""

    @abc.abstractmethod
    def attach(self, model: str | None, store: SnapshotStore) -> SnapshotStore:
        """Register an in-process follower store for one model's stream."""

    def pump(self, max_items: int | None = None) -> int:
        """Deliver queued deltas (pull-based back ends); 0 for push-based."""
        return 0

    def pending(self) -> int:
        """Deltas accepted but not yet delivered everywhere."""
        return 0

    def commit_watermark(self, model: str | None = None) -> int | None:
        """Min version every live follower of `model` has applied (None if
        no followers) — everything <= it is fully replicated."""
        return None

    def close(self) -> None:
        """Release transport resources; followers see an orderly FIN."""


def store_digest(store: SnapshotStore) -> str:
    """Content digest of a store's latest version: sha256 over (count,
    capacity, the capacity-bucketed center bytes, zero rows past count
    included).  Equal digests == bit-identical latest snapshots — the
    cross-process identity check the e2e drivers pin, and equal to the JAX
    package's digest of an equal store."""
    import hashlib
    snap = store.latest()
    h = hashlib.sha256()
    if snap is None:
        return h.hexdigest()
    h.update(f"{snap.count}:{snap.capacity}:".encode())
    h.update(np.ascontiguousarray(snap.centers.cpu().numpy()).tobytes())
    return h.hexdigest()


class _FollowerConn:
    """Server-side state for one connected follower socket."""

    def __init__(self, sock: socket.socket, model: str | None,
                 have_version: int, max_queue: int):
        self.sock = sock
        self.model = model
        self.have_version = have_version
        # bounded: a slow follower triggers drop-to-resync, never unbounded
        # server memory (max_queue=0 keeps the legacy unbounded behavior)
        self.q: "queue.Queue[bytes | None]" = queue.Queue(maxsize=max_queue)
        self.acked = 0                      # highest version ACKed
        self.alive = True
        self.sent_ts: dict[int, float] = {}  # version → enqueue time
        self.bootstrap_version: int | None = None
        self.resync_version: int | None = None   # pending lag-resync target
        self.dropped = 0                    # frames discarded on overflow
        self.idx = -1                       # stable follower index (obs label)


class ReplicationServer(Transport):
    """Primary-side socket transport: fan-out, acks, watermark, bootstrap,
    bounded-queue backpressure and term fencing.

    One accept thread; per follower connection one reader (ACKs, runs the
    handshake) and one writer (drains the outbound frame queue) thread.
    `send` never blocks on a slow follower — frames queue per connection
    up to `max_queue`, beyond which the queue is dropped and the follower
    scheduled for a SNAPSHOT resync; a dead connection is detected by
    EOF/send failure and deregistered.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 shadow_capacity: int = 4, max_queue: int = 1024,
                 term: int = 0, fault: FaultPlan | None = None,
                 obs: Obs | None = None,
                 device: str | torch.device = "cuda"):
        # Counters live in the obs registry (§15); the legacy attribute
        # names (n_sent, n_resyncs, ...) remain as read-only properties.
        self.device = resolve_device(device)    # the shadow stores' device
        self.obs = obs if obs is not None else Obs()
        m = self.obs.metrics
        self._c_sent = m.counter("transport_deltas_sent")
        self._c_delivered = m.counter("transport_deltas_delivered")
        self._c_bytes = m.counter("transport_bytes", dir="out_published")
        self._c_bytes_wire = m.counter("transport_bytes", dir="out_wire")
        self._c_frames_in = m.counter("transport_frames_in")
        self._c_bootstraps = m.counter("transport_bootstraps")
        self._c_resyncs = m.counter("transport_resyncs")
        self._c_dropped = m.counter("transport_dropped_frames")
        self._c_fenced = m.counter("transport_fenced_hellos")
        self._h_ack = m.histogram("transport_ack_rtt_s")
        self._g_term = m.gauge("transport_term")
        self._g_term.set(term)
        self._lock = threading.RLock()
        self._acked_cv = threading.Condition(self._lock)
        self._shadow: dict[str | None, SnapshotStore] = {}
        self._shadow_capacity = shadow_capacity
        self._max_queue = max_queue
        self.term = term
        self.fault = fault
        self.fenced = False        # a newer-term master exists (§14)
        self._conns: list[_FollowerConn] = []
        self._conn_seq = 0         # stable per-follower obs label
        self._local: dict[str | None, list[SnapshotStore]] = {}
        self._local_acked: dict[int, int] = {}   # id(store) → version
        self._closing = False
        self._lsock = socket.create_server((host, port))
        self.address = self._lsock.getsockname()
        self._threads: list[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop,
                             name="repl-accept", daemon=True)
        t.start()
        self._threads.append(t)

    # ---------------------------------------------- legacy counter surface
    @property
    def n_sent(self) -> int:
        return int(self._c_sent.value)

    @property
    def n_delivered(self) -> int:
        return int(self._c_delivered.value)

    @property
    def bytes_sent(self) -> int:
        return int(self._c_bytes.value)

    @property
    def n_bootstraps(self) -> int:
        return int(self._c_bootstraps.value)

    @property
    def n_resyncs(self) -> int:
        return int(self._c_resyncs.value)

    @property
    def n_dropped_frames(self) -> int:
        return int(self._c_dropped.value)

    @property
    def n_fenced_hellos(self) -> int:
        return int(self._c_fenced.value)

    # ------------------------------------------------------------- sending

    def send(self, delta: CenterDelta) -> None:
        with self.obs.span("transport.send", cat="transport",
                           version=delta.version):
            with self._lock:
                if self._closing:
                    raise RuntimeError("transport closed")
                if self.fenced:
                    raise RuntimeError(
                        f"fenced: a master with term > {self.term} exists")
                shadow = self._shadow.get(delta.model)
                if shadow is None:
                    shadow = SnapshotStore(capacity=self._shadow_capacity,
                                           delta=True, model=delta.model,
                                           device=self.device)
                    self._shadow[delta.model] = shadow
                shadow.apply_delta(delta)
                frame = delta_frame(delta, term=self.term)
                self._c_sent.inc()
                self._c_bytes.inc(len(frame))
                for store in self._local.get(delta.model, ()):  # loopback
                    store.apply_delta(delta)
                    self._local_acked[id(store)] = delta.version
                    self._c_delivered.inc()
                now = _now()
                depth = 0
                for conn in self._conns:
                    if conn.alive and conn.model == delta.model:
                        self._enqueue(conn, shadow, delta, frame, now)
                        depth += conn.q.qsize()
                if self.obs.tracer is not None:
                    self.obs.tracer.counter(
                        "transport.queue_depth", {"frames": depth},
                        cat="transport")

    def _enqueue(self, conn: _FollowerConn, shadow: SnapshotStore,
                 delta: CenterDelta, frame: bytes, now: float) -> None:
        """Offer one live frame to a follower queue under the drop-to-
        resync backpressure policy (§14): on overflow, discard everything
        queued for this follower and enqueue ONE fresh SNAPSHOT instead —
        the shadow already folded `delta`, so the snapshot covers it and
        the next live delta continues the stream with no gap.  Per-
        follower server memory is bounded by max_queue frames + 1
        snapshot, and the follower still converges bit-identically."""
        try:
            conn.q.put_nowait(frame)
            conn.sent_ts[delta.version] = now
            self.obs.metrics.gauge("transport_queue_depth",
                                   follower=conn.idx).set(conn.q.qsize())
            return
        except queue.Full:
            pass
        dropped = 0
        while True:
            try:
                conn.q.get_nowait()
                dropped += 1
            except queue.Empty:
                break
        conn.dropped += dropped
        self._c_dropped.inc(dropped + 1)   # +1: the frame never queued
        conn.sent_ts.clear()
        boot = shadow.bootstrap_delta()
        conn.q.put_nowait(delta_frame(boot, SNAPSHOT, term=self.term))
        conn.sent_ts[boot.version] = now
        conn.resync_version = boot.version
        self._c_resyncs.inc()
        self.obs.instant("transport.resync", cat="transport",
                         version=boot.version, dropped=dropped + 1)

    def attach(self, model: str | None,
               store: SnapshotStore) -> SnapshotStore:
        """In-process follower (delivered synchronously on send).  A store
        attached after publishes began is bootstrapped from the shadow —
        the same rebase-snapshot path a late socket joiner takes."""
        if not store.delta:
            raise ValueError("followers must be delta-mode stores")
        with self._lock:
            shadow = self._shadow.get(model)
            if shadow is not None and len(shadow):
                boot = shadow.bootstrap_delta()
                if boot is not None and store.n_deltas == 0:
                    store.apply_delta(boot)
                    self._local_acked[id(store)] = boot.version
                    self._c_bootstraps.inc()
            self._local.setdefault(model, []).append(store)
        return store

    def seed_shadow(self, model: str | None, store: SnapshotStore) -> None:
        """Adopt `store`'s full prefix as this server's shadow for `model`
        — the promotion path (§14): a promoted follower's server must
        bootstrap late or stale joiners from its own replicated history
        before it has published anything itself."""
        boot = store.bootstrap_delta()
        with self._lock:
            shadow = SnapshotStore(capacity=self._shadow_capacity,
                                   delta=True, model=model,
                                   device=self.device)
            if boot is not None:
                shadow.apply_delta(boot)
            self._shadow[model] = shadow

    # ------------------------------------------------------------ watermark

    def commit_watermark(self, model: str | None = None) -> int | None:
        with self._lock:
            acks = [c.acked for c in self._conns
                    if c.alive and c.model == model]
            acks += [self._local_acked.get(id(s), 0)
                     for s in self._local.get(model, ())]
        return min(acks) if acks else None

    def wait_acked(self, version: int, model: str | None = None,
                   timeout: float = 30.0) -> bool:
        """Block until every live follower of `model` has acked `version`
        (vacuously true with zero followers).  The replication barrier the
        cluster driver uses before declaring a pass fully replicated.

        Wakes promptly — never runs to the full timeout — when a follower
        is dropped (the watermark is recomputed over the survivors) or
        the server is closed/aborted mid-wait (returns False: the barrier
        can no longer be met)."""
        deadline = time.monotonic() + timeout
        with self._acked_cv:
            while True:
                if self._closing:
                    return False
                wm = self.commit_watermark(model)
                if wm is None or wm >= version:
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._acked_cv.wait(min(left, 0.2))

    def followers(self, model: str | None = None) -> int:
        with self._lock:
            return sum(1 for c in self._conns
                       if c.alive and c.model == model)

    def pending(self) -> int:
        with self._lock:
            return sum(c.q.qsize() for c in self._conns if c.alive)

    def max_pending_bound(self) -> int:
        """The backpressure guarantee: queued frames per follower never
        exceed max_queue (+1 slot headroom for the resync SNAPSHOT)."""
        return self._max_queue + 1 if self._max_queue else 0

    def metrics(self) -> dict:
        h = self._h_ack
        n_acks = h.count
        return dict(n_sent=self.n_sent, n_delivered=self.n_delivered,
                    bytes_sent=self.bytes_sent, n_acks=n_acks,
                    n_bootstraps=self.n_bootstraps,
                    n_resyncs=self.n_resyncs,
                    n_dropped_frames=self.n_dropped_frames,
                    n_fenced_hellos=self.n_fenced_hellos,
                    max_queue=self._max_queue, term=self.term,
                    ack_p50_ms=1e3 * h.percentile(50) if n_acks else 0.0,
                    ack_p99_ms=1e3 * h.percentile(99) if n_acks else 0.0)

    # ----------------------------------------------------------- conn plumbing

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._lsock.accept()
            except OSError:        # listening socket closed: shutdown
                return
            t = threading.Thread(target=self._serve_conn, args=(sock,),
                                 name="repl-conn", daemon=True)
            t.start()
            with self._lock:
                self._threads.append(t)

    def _serve_conn(self, sock: socket.socket) -> None:
        conn: _FollowerConn | None = None
        try:
            fr = read_frame(sock)
            if fr is None or fr[0] != HELLO:
                sock.close()
                return
            _, meta, _ = fr
            if meta.get("role") != "follower":
                write_frame(sock, fin_frame("replication port is "
                                            "follower-only"))
                sock.close()
                return
            peer_term = int(meta.get("term", 0))
            if peer_term > self.term:
                # §14 zombie guard: a follower from a NEWER term proves a
                # newer master was promoted — this server must stand down.
                with self._acked_cv:
                    self.fenced = True
                    self._c_fenced.inc()
                    self._acked_cv.notify_all()
                self.obs.instant("transport.fenced", cat="transport",
                                 term=self.term, peer_term=peer_term)
                write_frame(sock, fin_frame(
                    f"fenced: server term {self.term} < peer {peer_term}"))
                sock.close()
                return
            conn = _FollowerConn(sock, meta.get("model"),
                                 int(meta.get("have_version", 0)),
                                 self._max_queue)
            with self._lock:
                if self._closing:
                    sock.close()
                    return
                # Bootstrap decision and registration are one atomic step:
                # every version after the snapshot flows through the live
                # fan-out, so the joiner sees no gap and no duplicate.
                shadow = self._shadow.get(conn.model)
                if shadow is not None and len(shadow):
                    latest = shadow.latest_meta().version
                    if conn.have_version != latest:
                        boot = shadow.bootstrap_delta()
                        conn.sent_ts[boot.version] = _now()
                        conn.q.put(delta_frame(boot, SNAPSHOT,
                                               term=self.term))
                        conn.bootstrap_version = boot.version
                        self._c_bootstraps.inc()
                        self.obs.instant("transport.bootstrap",
                                         cat="transport",
                                         version=boot.version)
                conn.idx = self._conn_seq
                self._conn_seq += 1
                self._conns.append(conn)
            wt = threading.Thread(target=self._writer, args=(conn,),
                                  name="repl-write", daemon=True)
            wt.start()
            with self._lock:
                self._threads.append(wt)
            self._reader(conn)
        except (ConnectionError, ValueError, OSError):
            pass
        finally:
            if conn is not None:
                self._drop(conn)
            else:
                try:
                    sock.close()
                except OSError:
                    pass

    def _reader(self, conn: _FollowerConn) -> None:
        while True:
            fr = read_frame(conn.sock)
            if fr is None:
                return
            ftype, meta, _ = fr
            self._c_frames_in.inc()
            if ftype == ACK:
                with self._acked_cv:
                    version = int(meta["version"])
                    conn.acked = max(conn.acked, version)
                    ts = conn.sent_ts.pop(version, None)
                    if ts is not None:
                        self._h_ack.observe(_now() - ts)
                    if (conn.resync_version is not None
                            and version >= conn.resync_version):
                        conn.resync_version = None   # lagger caught up
                    self._acked_cv.notify_all()
            elif ftype == FIN:
                return

    def _writer(self, conn: _FollowerConn) -> None:
        while True:
            frame = conn.q.get()
            if frame is None:
                return
            send_n = 1
            for rule in (self.fault.at("server.writer")
                         if self.fault is not None else ()):
                if rule.kind == "delay":
                    time.sleep(rule.delay_s)
                elif rule.kind == "drop":
                    send_n = 0           # frame vanishes on the wire
                elif rule.kind == "dup":
                    send_n = 2           # at-least-once redelivery
                elif rule.kind == "hold":
                    self.fault.wait_released()   # stalled link
                elif rule.kind == "reset":
                    self._drop(conn)     # hard socket reset, no FIN
                    return
            try:
                for _ in range(send_n):
                    conn.sock.sendall(frame)
                self._c_bytes_wire.inc(send_n * len(frame))
            except OSError:
                self._drop(conn)
                return

    def _drop(self, conn: _FollowerConn) -> None:
        with self._acked_cv:
            if not conn.alive:
                return
            conn.alive = False
            if conn in self._conns:
                self._conns.remove(conn)
            # a dead follower no longer holds the watermark back
            self._acked_cv.notify_all()
        self._put_final(conn, None)
        try:
            conn.sock.close()
        except OSError:
            pass

    @staticmethod
    def _put_final(conn: _FollowerConn, *frames: bytes | None) -> None:
        """Queue shutdown frames even on a full bounded queue (evicting
        stale entries — we are tearing the connection down anyway)."""
        for fr in frames:
            while True:
                try:
                    conn.q.put_nowait(fr)
                    break
                except queue.Full:
                    try:
                        conn.q.get_nowait()
                    except queue.Empty:
                        pass

    def _close_listener(self) -> None:
        """Close the listening socket.  The shutdown wakes the accept
        thread (on Linux a bare close leaves it blocked in accept)."""
        for op in (lambda: self._lsock.shutdown(socket.SHUT_RDWR),
                   self._lsock.close):
            try:
                op()
            except OSError:
                pass

    def close(self, reason: str = "shutdown") -> None:
        with self._acked_cv:
            if self._closing:
                return
            self._closing = True
            conns = list(self._conns)
            self._acked_cv.notify_all()   # wake wait_acked: barrier is off
        fin = fin_frame(reason)
        for conn in conns:
            self._put_final(conn, fin, None)
        self._close_listener()
        # writers flush the FIN; followers close; readers see EOF and drop
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(timeout=5.0)

    def abort(self) -> None:
        """Crash the primary: close the listener and every follower socket
        with NO FIN — followers observe a bare EOF, the §14 orphaned
        signal that starts promotion.  Queued frames are discarded."""
        with self._acked_cv:
            if self._closing:
                return
            self._closing = True
            conns = list(self._conns)
            self._acked_cv.notify_all()
        self._close_listener()
        for conn in conns:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
            self._put_final(conn, None)


class ReplicationClient:
    """Follower loop over one socket: HELLO → apply deltas → ACK → FIN.

    `store` may be a pre-existing delta-mode store (reconnect: HELLO
    carries its latest version, and the server bootstraps only if that is
    behind) or None for a fresh joiner, whose store lives on `device`.

    With `reconnect=True`, a broken stream (EOF, socket error, or a
    sequence gap from a lost frame) is retried: exponential backoff
    doubling from `backoff_s` up to `backoff_max_s`, multiplied by a
    seeded full jitter in [1, 2) — `backoff_log` records every sleep for
    the tests.  The failure counter resets whenever a connection made
    progress, so `max_retries` bounds CONSECUTIVE fruitless attempts.
    Duplicates are ACKed but not re-applied; frames with `term` below the
    client's known term are rejected without ACK (§14 fencing).
    """

    def __init__(self, address: tuple[str, int], model: str | None = None,
                 store: SnapshotStore | None = None, capacity: int = 16,
                 connect_timeout: float = 10.0, reconnect: bool = False,
                 max_retries: int = 6, backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0, seed: int = 0, term: int = 0,
                 fault: FaultPlan | None = None, obs: Obs | None = None,
                 device: str | torch.device = "cuda"):
        self.address = tuple(address)
        self.model = model
        self.store = store if store is not None else SnapshotStore(
            capacity=capacity, delta=True, model=model, device=device)
        self.connect_timeout = connect_timeout
        self.reconnect = reconnect
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.term = term
        self.fault = fault
        self.obs = obs if obs is not None else Obs()
        m = self.obs.metrics
        self._c_applied = m.counter("transport_client_applied")
        self._c_bytes_in = m.counter("transport_bytes", dir="in_applied")
        # redelivered versions ACKed, not applied / sequence gaps healed by
        # reconnect / stale-term frames rejected / successful re-connections
        self._c_duplicates = m.counter("transport_client_duplicates")
        self._c_gaps = m.counter("transport_client_gaps")
        self._c_fenced = m.counter("transport_client_fenced")
        self._c_reconnects = m.counter("transport_client_reconnects")
        self.backoff_log: list[float] = []
        self.bootstrapped = False
        self.fin_reason: str | None = None
        self._rng = random.Random(seed)
        self._sock: socket.socket | None = None
        self._ever_connected = False
        self._stop = False
        self._thread: threading.Thread | None = None
        self._applied_cv = threading.Condition()

    @property
    def n_applied(self) -> int:
        return int(self._c_applied.value)

    @property
    def n_duplicates(self) -> int:
        return int(self._c_duplicates.value)

    @property
    def n_gaps(self) -> int:
        return int(self._c_gaps.value)

    @property
    def n_fenced(self) -> int:
        return int(self._c_fenced.value)

    @property
    def n_reconnects(self) -> int:
        return int(self._c_reconnects.value)

    def connect(self) -> None:
        meta = self.store.latest_meta()
        have = 0 if meta is None else meta.version
        self._sock = socket.create_connection(self.address,
                                              timeout=self.connect_timeout)
        self._sock.settimeout(None)
        write_frame(self._sock, hello_frame("follower", self.model,
                                            have_version=have,
                                            term=self.term))
        if self._ever_connected:
            self._c_reconnects.inc()
            self.obs.instant("transport.reconnect", cat="transport")
        self._ever_connected = True

    def run(self) -> None:
        """Apply the stream until FIN, orderly EOF, or retry exhaustion
        (inline; `start` for a thread).  Each applied version is ACKed
        immediately after the store commit — the ack IS the durability
        signal upstream."""
        failures = 0
        try:
            while not self._stop:
                if self._sock is None:
                    try:
                        self.connect()
                    except OSError:
                        if not self._backoff(failures):
                            return
                        failures += 1
                        continue
                outcome, progressed = self._run_stream()
                self._close_sock()
                if outcome == "fin" or self._stop or not self.reconnect:
                    return
                if progressed:
                    failures = 0
                if not self._backoff(failures):
                    return
                failures += 1
        finally:
            self.close()

    def _backoff(self, failures: int) -> bool:
        """Sleep before retry `failures`; False when retries are off or
        exhausted.  Exponential with seeded full jitter in [1, 2)x."""
        if not self.reconnect or self._stop or failures >= self.max_retries:
            return False
        delay = min(self.backoff_max_s, self.backoff_s * (2 ** failures))
        delay *= 1.0 + self._rng.random()
        self.backoff_log.append(delay)
        time.sleep(delay)
        return True

    def _run_stream(self) -> tuple[str, bool]:
        """Drain one connection; (outcome, made-progress).  Outcomes:
        "fin" (orderly stop — never retried), "eof"/"conn" (stream broke),
        "gap" (lost frame detected by the store: reconnect so the server's
        bootstrap path resyncs us)."""
        sock = self._sock
        progressed = False
        try:
            while not self._stop:
                fr = read_frame(sock)
                if fr is None:
                    return "eof", progressed
                ftype, meta, arrays = fr
                if ftype in (DELTA, SNAPSHOT):
                    term = int(meta.get("term", 0))
                    if term < self.term:
                        # §14: a zombie master's frame — reject, no ACK
                        self._c_fenced.inc()
                        continue
                    self.term = max(self.term, term)
                    delta = frame_delta(meta, arrays)
                    if self.fault is not None:
                        dropped = False
                        for rule in self.fault.at("client.apply"):
                            if rule.kind == "delay":
                                time.sleep(rule.delay_s)
                            elif rule.kind == "hold":
                                self.fault.wait_released()
                            elif rule.kind == "drop":
                                dropped = True    # lost in apply: no ACK
                            elif rule.kind == "reset":
                                self._close_sock()
                                return "conn", progressed
                        if dropped:
                            continue
                    have = self.store.latest_meta()
                    if have is not None and delta.version <= have.version:
                        # at-least-once redelivery: already applied — ACK
                        # again (the server may have lost the first ack)
                        self._c_duplicates.inc()
                        write_frame(sock, ack_frame(self.model,
                                                    delta.version))
                        progressed = True
                        continue
                    try:
                        with self.obs.span("transport.apply",
                                           cat="transport",
                                           version=delta.version):
                            self.store.apply_delta(delta)
                    except ValueError:
                        # sequence gap (dropped frame): reconnect; HELLO
                        # advertises our version and the server resyncs
                        self._c_gaps.inc()
                        self.obs.instant("transport.gap", cat="transport",
                                         version=delta.version)
                        return "gap", progressed
                    self._c_applied.inc()
                    self._c_bytes_in.inc(delta.nbytes)
                    with self._applied_cv:
                        if ftype == SNAPSHOT:
                            self.bootstrapped = True
                        self._applied_cv.notify_all()
                    write_frame(sock, ack_frame(self.model, delta.version))
                    progressed = True
                elif ftype == FIN:
                    self.fin_reason = meta.get("reason", "")
                    return "fin", progressed
            return "fin", progressed
        except (ConnectionError, OSError):
            return "conn", progressed

    def start(self) -> "ReplicationClient":
        if self._sock is None and not self.reconnect:
            self.connect()
        self._thread = threading.Thread(target=self.run, name="repl-client",
                                        daemon=True)
        self._thread.start()
        return self

    def wait_version(self, version: int, timeout: float = 30.0) -> bool:
        """Block until the local store holds `version` (or newer)."""
        deadline = time.monotonic() + timeout
        with self._applied_cv:
            while True:
                meta = self.store.latest_meta()
                if meta is not None and meta.version >= version:
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._applied_cv.wait(min(left, 0.2))

    def stop(self) -> None:
        """Request the loop to exit (unblocks a pending read)."""
        self._stop = True
        self._close_sock()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _close_sock(self) -> None:
        """Close the stream; the shutdown wakes a read blocked on it in the
        loop's thread (a bare close does not, on Linux)."""
        sock, self._sock = self._sock, None
        if sock is not None:
            for op in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    op()
                except OSError:
                    pass

    def close(self) -> None:
        self._close_sock()
