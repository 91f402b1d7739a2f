"""The port's wire protocol, socket transport, loopback channel and fault
plan, on the CPU (`device="cpu"`), against the JAX package.

Covers: the port's frames byte for byte against
`tests/golden/transport_frames.bin` (every frame type) and against the
JAX package's encoder, codec round trips, both `Transport` back ends,
socket replication (acks, watermark, bootstrap, backpressure, reconnect,
chaos drop/dup, fencing), replication across the packages in both
directions with equal `store_digest`s, and the fault-plan units of the
reference's `tests/test_fault.py`.
"""
import os
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.distributed import protocol as jproto  # noqa: E402
from repro.distributed import transport as jtransport  # noqa: E402
from repro.serving import snapshot as jsnap  # noqa: E402
from repro_torch.core import DPMeansTransaction, OCCEngine  # noqa: E402
from repro_torch.core.occ import make_pool  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.distributed import protocol as proto  # noqa: E402
from repro_torch.distributed.fault import (  # noqa: E402
    FaultEvent, FaultPlan, FaultRule, HeartbeatTracker, StepWatchdog,
)
from repro_torch.distributed.replication import (  # noqa: E402
    DeltaChannel, make_follower,
)
from repro_torch.distributed.transport import (  # noqa: E402
    ReplicationClient, ReplicationServer, Transport, store_digest,
)
from repro_torch.serving.snapshot import (  # noqa: E402
    CenterDelta, SnapshotStore,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "transport_frames.bin")
CPU = dict(device="cpu")


def _store(**kw):
    return SnapshotStore(delta=True, model=kw.pop("model", "m"), **CPU, **kw)


def _pool(rows: np.ndarray, k_max: int = 16):
    rows = np.asarray(rows, np.float32)
    k = rows.shape[0]
    pool = make_pool(k_max, rows.shape[1], device="cpu")
    pool.centers[:k] = torch.from_numpy(rows)
    pool.mask[:k] = True
    pool.count.fill_(k)
    return pool


def _wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _golden_frames(p, delta_cls) -> list[bytes]:
    """The reference's golden frame sequence, built with protocol module
    `p` and delta class `delta_cls`: every frame type, a snapshot
    bootstrap, a pool-overflow delta with a non-finite objective, an
    empty-ΔK delta and a mixed-dtype proposal block."""
    boot = delta_cls(
        model="m", version=4, start=0,
        rows=np.linspace(-1.0, 1.0, 20, dtype=np.float32).reshape(5, 4),
        count=5, capacity=8, rebase=True, n_seen=320, epochs=4,
        overflow=False, objective=0.5, cap_est=16, cap_trace=(8, 8, 4, 4))
    tail = delta_cls(
        model="m", version=5, start=5,
        rows=(np.arange(12, dtype=np.float32).reshape(3, 4) / 8.0),
        count=8, capacity=8, rebase=False, n_seen=384, epochs=5,
        overflow=False, objective=1.25, cap_est=16, cap_trace=None)
    ovf = delta_cls(
        model="ovf", version=2, start=3, rows=np.zeros((0, 4), np.float32),
        count=3, capacity=8, rebase=False, n_seen=128, epochs=2,
        overflow=True, objective=float("inf"), cap_est=None, cap_trace=(64,))
    return [
        p.hello_frame("follower", "m", have_version=3, worker=-1, term=2),
        p.delta_frame(boot, p.SNAPSHOT, term=2),
        p.delta_frame(tail),
        p.delta_frame(ovf),
        p.ack_frame("m", 5),
        p.step_frame(7, 8, term=2),
        p.propose_frame(7, 1, [np.array([True, False, True]),
                               np.arange(6, dtype=np.float32).reshape(3, 2),
                               np.array([2, -1, 0], np.int32)]),
        p.ctrl_frame("promote", node=1, term=3, watermark=5),
        p.fin_frame("bye"),
    ]


def _split_frames(buf: bytes) -> list[bytes]:
    out, off = [], 0
    while off < len(buf):
        _, _, _, plen = struct.unpack_from("!4sBBI", buf, off)
        out.append(buf[off:off + 10 + plen])
        off += 10 + plen
    return out


# ------------------------------------------------------------ golden fixture

def test_port_frames_equal_golden_bytes():
    with open(GOLDEN, "rb") as f:
        want = f.read()
    got = _golden_frames(proto, CenterDelta)
    assert b"".join(got) == want
    # frame by frame, so a drift names its frame type
    for a, b in zip(got, _split_frames(want)):
        assert a == b, proto.FRAME_NAMES[proto.decode_frame(b)[0]]


def test_golden_covers_every_port_frame_type():
    with open(GOLDEN, "rb") as f:
        frames = _split_frames(f.read())
    assert {proto.decode_frame(fr)[0] for fr in frames} == set(
        proto.FRAME_NAMES)
    assert proto.FRAME_NAMES == jproto.FRAME_NAMES
    assert proto.PROTOCOL_VERSION == jproto.PROTOCOL_VERSION


def test_golden_decodes_back_in_the_port():
    with open(GOLDEN, "rb") as f:
        decoded = [proto.decode_frame(fr) for fr in _split_frames(f.read())]
    assert decoded[0][1] == dict(role="follower", model="m", have_version=3,
                                 worker=-1, term=2)
    boot = proto.frame_delta(decoded[1][1], decoded[1][2])
    assert boot.rebase and boot.start == 0 and boot.count == 5
    ovf = proto.frame_delta(decoded[3][1], decoded[3][2])
    assert ovf.overflow and ovf.rows.shape == (0, 4)
    assert ovf.objective is None      # inf is not JSON-representable
    assert decoded[5][1] == dict(epoch=7, count=8, term=2)
    _, meta, arrays = decoded[6]
    assert meta["n_leaves"] == 3 and arrays["leaf2"].dtype == np.int32
    assert decoded[7][1] == dict(op="promote", node=1, term=3, watermark=5)
    assert decoded[8][1]["reason"] == "bye"


@pytest.mark.parametrize("seed", range(4))
def test_random_frames_equal_jax_encoder(seed):
    """Random deltas, proposal blocks and control frames encode to the
    same bytes in both packages, and each decodes the other's."""
    rng = np.random.default_rng(seed)
    k, d = int(rng.integers(0, 9)), int(rng.integers(1, 33))
    fields = dict(model=["m", None][seed % 2], version=int(rng.integers(1, 99)),
                  start=3, rows=rng.normal(size=(k, d)).astype(np.float32),
                  count=3 + k, capacity=64, rebase=bool(seed % 3 == 0),
                  n_seen=int(rng.integers(0, 10**6)), epochs=seed,
                  overflow=bool(seed % 2), objective=float(rng.normal()),
                  cap_est=[None, 32][seed % 2],
                  cap_trace=[None, (1, 2, 3)][seed % 2])
    leaves = [rng.normal(size=(5, d)).astype(np.float32),
              rng.integers(-1, 9, size=5).astype(np.int32),
              rng.random(5) < 0.5]
    pairs = [
        (proto.delta_frame(CenterDelta(**fields), term=seed),
         jproto.delta_frame(jsnap.CenterDelta(**fields), term=seed)),
        (proto.propose_frame(seed, 1, leaves),
         jproto.propose_frame(seed, 1, leaves)),
        (proto.ctrl_frame("epoch", digest="ab", epoch=seed, cap=None),
         jproto.ctrl_frame("epoch", digest="ab", epoch=seed, cap=None)),
        (proto.hello_frame("worker", "m", worker=seed, term=seed),
         jproto.hello_frame("worker", "m", worker=seed, term=seed)),
    ]
    for mine, theirs in pairs:
        assert mine == theirs
        a, b = proto.decode_frame(theirs), jproto.decode_frame(mine)
        assert a[:2] == b[:2]
        assert all(np.array_equal(a[2][n], b[2][n]) for n in a[2])


# ------------------------------------------------------------- codec basics

def test_delta_frame_roundtrip_every_field():
    rng = np.random.default_rng(0)
    d = CenterDelta(model="abc", version=17, start=6,
                    rows=rng.normal(size=(4, 9)).astype(np.float32),
                    count=10, capacity=16, rebase=False, n_seen=1234,
                    epochs=11, overflow=True, objective=-2.5, cap_est=32,
                    cap_trace=(1, 2, 3))
    ftype, meta, arrays = proto.decode_frame(proto.delta_frame(d))
    back = proto.frame_delta(meta, arrays)
    assert ftype == proto.DELTA
    for f in CenterDelta._fields:
        a, b = getattr(d, f), getattr(back, f)
        if f == "rows":
            assert b.dtype == a.dtype and np.array_equal(a, b)
        else:
            assert a == b, f


def test_propose_frame_carries_tensor_leaves_as_numpy():
    leaves = [torch.tensor([[True], [False]]),
              torch.arange(8, dtype=torch.float32).reshape(2, 4),
              torch.tensor([7, -7], dtype=torch.int32),
              torch.arange(2, dtype=torch.float64)]
    ftype, meta, arrays = proto.decode_frame(
        proto.propose_frame(3, 0, [t.cpu().numpy() for t in leaves]))
    assert ftype == proto.PROPOSE and meta["n_leaves"] == 4
    for i, t in enumerate(leaves):
        got = torch.from_numpy(arrays[f"leaf{i}"])
        assert got.dtype == t.dtype and torch.equal(got, t)


def test_decode_rejects_garbage():
    frame = proto.fin_frame("x")
    with pytest.raises(ValueError, match="magic"):
        proto.decode_frame(b"NOPE" + frame[4:])
    with pytest.raises(ValueError, match="version"):
        proto.decode_frame(frame[:4] + b"\x63" + frame[5:])
    with pytest.raises(ValueError, match="truncated"):
        proto.decode_frame(frame[:-1])


def test_ctrl_frame_roundtrip_and_positional_op():
    ftype, meta, _ = proto.decode_frame(
        proto.ctrl_frame("orphaned", node=2, watermark=7))
    assert ftype == proto.CTRL
    assert meta == dict(op="orphaned", node=2, watermark=7)
    with pytest.raises(TypeError):
        proto.ctrl_frame("x", op="y")


# -------------------------------------------------------- Transport interface

def test_both_backends_implement_transport():
    assert isinstance(DeltaChannel(), Transport)
    srv = ReplicationServer(**CPU)
    try:
        assert isinstance(srv, Transport)
    finally:
        srv.close()


def test_loopback_commit_watermark_tracks_pump():
    chan = DeltaChannel()
    store = _store(capacity=8, wire=chan)
    f1 = make_follower(chan, "m", capacity=8, **CPU)
    assert chan.commit_watermark("m") == 0
    assert chan.commit_watermark("other") is None
    for k in (2, 3):
        store.publish_pool(_pool(np.ones((k, 4))))
    assert chan.commit_watermark("m") == 0
    chan.pump()
    assert chan.commit_watermark("m") == 2
    assert f1.versions() == store.versions()
    assert store_digest(f1) == store_digest(store)


# ------------------------------------------------------- socket replication

def test_socket_replication_acks_watermark_bootstrap():
    srv = ReplicationServer(**CPU)
    store = _store(capacity=32, wire=srv)
    c1 = ReplicationClient(srv.address, model="m", capacity=32, **CPU).start()
    rng = np.random.default_rng(1)
    pools = [_pool(rng.normal(size=(k, 4))) for k in (2, 3, 5, 6, 9)]
    try:
        _wait(lambda: srv.followers("m") >= 1, "follower connect")
        for p in pools[:3]:
            store.publish_pool(p)
        assert srv.wait_acked(3, "m", timeout=20)
        assert srv.commit_watermark("m") == 3
        c2 = ReplicationClient(srv.address, model="m", capacity=32,
                               **CPU).start()
        assert c2.wait_version(3)
        for p in pools[3:]:
            store.publish_pool(p)
        assert srv.wait_acked(5, "m", timeout=20)
        assert c1.wait_version(5) and c2.wait_version(5)
        assert c2.bootstrapped and not c1.bootstrapped
        assert c1.store.versions() == store.versions()
        assert c2.store.versions() == [3, 4, 5]
        assert (store_digest(store) == store_digest(c1.store)
                == store_digest(c2.store))
        for v in (3, 4, 5):
            assert torch.equal(store.get(v).centers, c2.store.get(v).centers)
        m = srv.metrics()
        assert m["n_acks"] >= 8 and m["n_bootstraps"] == 1
        assert m["ack_p99_ms"] >= m["ack_p50_ms"] >= 0.0
    finally:
        srv.close()
    c1.join(10)
    c2.join(10)
    assert c1.fin_reason == "shutdown"


def test_socket_reconnect_at_head_tails_without_bootstrap():
    srv = ReplicationServer(**CPU)
    store = _store(capacity=8, wire=srv)
    try:
        store.publish_pool(_pool(np.ones((2, 4))))
        c1 = ReplicationClient(srv.address, model="m", capacity=8,
                               **CPU).start()
        assert c1.wait_version(1)
        c1.close()
        c1.join(10)
        # the old link is gone before the new one registers, so the
        # publish below reaches the new link live
        _wait(lambda: srv.followers("m") == 0, "old link dropped")
        c2 = ReplicationClient(srv.address, model="m",
                               store=c1.store).start()
        _wait(lambda: srv.followers("m") >= 1, "reconnect")
        store.publish_pool(_pool(np.ones((4, 4)) * 2))
        assert c2.wait_version(2)
        assert not c2.bootstrapped
        assert c2.store.versions() == [1, 2]
    finally:
        srv.close()


def test_socket_stale_reconnect_bootstraps_over_existing_store():
    srv = ReplicationServer(**CPU)
    store = _store(capacity=8, wire=srv)
    rng = np.random.default_rng(2)
    try:
        store.publish_pool(_pool(rng.normal(size=(2, 4))))
        c1 = ReplicationClient(srv.address, model="m", capacity=8,
                               **CPU).start()
        assert c1.wait_version(1)
        c1.close()
        c1.join(10)
        for k in (3, 5, 8):
            store.publish_pool(_pool(rng.normal(size=(k, 4))))
        c2 = ReplicationClient(srv.address, model="m",
                               store=c1.store).start()
        assert c2.wait_version(4)
        assert c2.bootstrapped
        assert store_digest(c2.store) == store_digest(store)
    finally:
        srv.close()


def test_server_local_attach_is_loopback_follower():
    srv = ReplicationServer(**CPU)
    store = _store(capacity=8, wire=srv)
    try:
        store.publish_pool(_pool(np.ones((2, 4))))
        late = _store(capacity=8)
        srv.attach("m", late)
        store.publish_pool(_pool(np.ones((3, 4)) * 3))
        assert late.versions() == [1, 2]
        assert srv.commit_watermark("m") == 2
        assert store_digest(late) == store_digest(store)
    finally:
        srv.close()


def _publish_seq(store, rng, ks):
    base = rng.normal(size=(max(ks), 4)).astype(np.float32)
    for k in ks:
        store.publish_pool(_pool(base[:k]))
    return base


def test_apply_delta_backlog_multiple_versions_behind():
    chan = DeltaChannel()
    primary = _store(capacity=8, wire=chan)
    follower = make_follower(chan, "m", capacity=8, **CPU)
    _publish_seq(primary, np.random.default_rng(3), (1, 2, 4, 5, 9))
    assert chan.pending() == 5 and follower.n_deltas == 0
    assert chan.commit_watermark("m") == 0
    chan.pump()
    assert chan.commit_watermark("m") == 5
    assert follower.versions() == primary.versions()
    for v in primary.versions():
        assert torch.equal(primary.get(v).centers, follower.get(v).centers)


def test_apply_delta_rebase_mid_backlog():
    chan = DeltaChannel()
    primary = _store(capacity=8, wire=chan)
    follower = make_follower(chan, "m", capacity=8, **CPU)
    rng = np.random.default_rng(4)
    _publish_seq(primary, rng, (3, 6))
    shrunk = rng.normal(size=(2, 4)).astype(np.float32)
    primary.publish_pool(_pool(shrunk))             # count 6 → 2: rebase
    grown = np.concatenate(
        [shrunk, rng.normal(size=(2, 4)).astype(np.float32)])
    primary.publish_pool(_pool(grown))
    chan.pump()
    assert follower.versions() == primary.versions() == [1, 2, 3, 4]
    for v in (1, 2, 3, 4):
        assert torch.equal(primary.get(v).centers, follower.get(v).centers)


def test_apply_delta_gap_detected():
    primary = _store(capacity=8)
    deltas = []
    primary.wire = type("W", (), {"send": lambda self, d: deltas.append(d)})()
    _publish_seq(primary, np.random.default_rng(5), (2, 4, 7))
    follower = _store(capacity=8)
    follower.apply_delta(deltas[0])
    with pytest.raises(ValueError, match="delta gap"):
        follower.apply_delta(deltas[2])
    follower.apply_delta(deltas[1])
    follower.apply_delta(deltas[2])
    assert follower.versions() == [1, 2, 3]


# ------------------------- backpressure, reconnect, fencing (§14 transport)

def test_slow_follower_bounded_queue_snapshot_resync():
    """Backpressure with a deterministic trigger: the server's writer is
    held at a gate on its first frame, so the 40 publishes back up in the
    bounded per-follower queue for certain (at most one frame has left
    it).  The queue stays bounded, overflow drops the backlog to ONE
    SNAPSHOT, and once the test opens the gate the follower converges
    bit-identically to version 40."""
    plan = FaultPlan([FaultRule("server.writer", "hold", nth=1)])
    srv = ReplicationServer(max_queue=4, fault=plan, **CPU)
    store = _store(capacity=64, wire=srv)
    base = np.random.default_rng(6).normal(size=(40, 4)).astype(np.float32)
    c = ReplicationClient(srv.address, model="m", capacity=64, **CPU)
    try:
        c.start()
        _wait(lambda: srv.followers("m") >= 1, "follower connect")
        bound = srv.max_pending_bound()
        for k in range(1, 41):
            store.publish_pool(_pool(base[:k], k_max=64))
            assert srv.pending() <= bound, "server queue memory unbounded"
        m = srv.metrics()          # read while the writer is still held
        assert m["n_resyncs"] >= 1 and m["n_dropped_frames"] > 0
        assert c.store.latest_meta() is None or \
            c.store.latest_meta().version <= 1
        plan.release()
        assert srv.wait_acked(40, "m", timeout=20)
        assert store_digest(c.store) == store_digest(store)
        assert c.store.latest_meta().version == 40
        assert [e.kind for e in plan.events] == ["hold"]
    finally:
        plan.release()
        srv.close()
    c.join(10)


def test_client_reconnects_with_backoff_after_stream_break():
    srv = ReplicationServer(**CPU)
    store = _store(capacity=16, wire=srv)
    base = np.random.default_rng(7).normal(size=(8, 4)).astype(np.float32)
    c = ReplicationClient(srv.address, model="m", capacity=16,
                          reconnect=True, backoff_s=0.01, seed=1, **CPU)
    try:
        store.publish_pool(_pool(base[:2]))
        c.start()
        assert c.wait_version(1)
        with srv._lock:
            conn = srv._conns[0]
        conn.sock.shutdown(1)           # SHUT_WR: client sees EOF
        _wait(lambda: c.n_reconnects >= 1, "reconnect")
        _wait(lambda: srv.followers("m") >= 1, "re-registration")
        for k in (4, 6):
            store.publish_pool(_pool(base[:k]))
        assert c.wait_version(3)
        assert c.n_reconnects >= 1 and len(c.backoff_log) >= 1
        assert all(d > 0 for d in c.backoff_log)
        assert store_digest(c.store) == store_digest(store)
    finally:
        srv.close()
    c.join(10)


@pytest.mark.parametrize("kind", ["drop", "dup"])
def test_chaos_frame_heals_or_is_not_reapplied(kind):
    """`drop` loses live version 2: the client sees the gap, reconnects
    and is resynced by a SNAPSHOT.  `dup` redelivers version 2: it is
    ACKed again and applied once.  Both end bit-identical."""
    plan = FaultPlan([FaultRule("server.writer", kind, nth=2)])
    srv = ReplicationServer(fault=plan, **CPU)
    store = _store(capacity=16, wire=srv)
    base = np.random.default_rng(8).normal(size=(8, 4)).astype(np.float32)
    c = ReplicationClient(srv.address, model="m", capacity=16,
                          reconnect=kind == "drop", backoff_s=0.01, seed=2,
                          **CPU)
    try:
        c.start()
        _wait(lambda: srv.followers("m") >= 1, "follower connect")
        for k in (2, 4, 6):
            store.publish_pool(_pool(base[:k]))
        assert c.wait_version(3, timeout=20)
        if kind == "drop":
            assert c.n_gaps >= 1 and c.bootstrapped
        else:
            assert srv.wait_acked(3, "m", timeout=20)
            assert c.n_duplicates == 1
            assert c.store.versions() == [1, 2, 3]
        assert store_digest(c.store) == store_digest(store)
        assert plan.events[0].kind == kind
    finally:
        srv.close()
    c.join(10)


def test_zombie_master_fenced_by_newer_term_hello():
    srv = ReplicationServer(term=1, **CPU)
    store = _store(capacity=8, wire=srv)
    try:
        store.publish_pool(_pool(np.ones((2, 4))))
        c = ReplicationClient(srv.address, model="m", term=3, **CPU)
        c.connect()
        c.run()
        assert c.fin_reason is not None and "fenced" in c.fin_reason
        _wait(lambda: srv.fenced, "fenced")
        with pytest.raises(RuntimeError, match="fenced"):
            store.publish_pool(_pool(np.ones((3, 4))))
        assert srv.metrics()["n_fenced_hellos"] == 1
    finally:
        srv.close()


def test_client_rejects_stale_term_frames():
    srv = ReplicationServer(term=0, **CPU)
    store = _store(capacity=8, wire=srv)
    try:
        c = ReplicationClient(srv.address, model="m", term=2, **CPU)
        srv.term = 2                     # handshake passes at equal term
        c.start()
        _wait(lambda: srv.followers("m") >= 1, "follower connect")
        srv.term = 1                     # demoted after the handshake
        store.publish_pool(_pool(np.ones((2, 4))))
        _wait(lambda: c.n_fenced >= 1, "stale frame rejected")
        assert c.store.latest_meta() is None
        assert c.n_applied == 0
    finally:
        srv.close()


@pytest.mark.parametrize("how", ["drop", "close"])
def test_wait_acked_wakes_promptly(how):
    """A caller blocked in wait_acked wakes when the lagging follower is
    dropped (vacuously True over the survivors) or the server closes
    (False: the barrier is abandoned) — not at the full timeout."""
    plan = FaultPlan([FaultRule("client.apply", "hold", nth=1)])
    srv = ReplicationServer(**CPU)
    store = _store(capacity=8, wire=srv)
    c = ReplicationClient(srv.address, model="m", fault=plan, **CPU)
    try:
        c.start()
        _wait(lambda: srv.followers("m") >= 1, "follower connect")
        store.publish_pool(_pool(np.ones((2, 4))))
        _wait(lambda: plan.hits("client.apply") >= 1, "apply held")
        result = {}

        def waiter():
            t0 = time.monotonic()
            ok = srv.wait_acked(1, "m", timeout=30.0)
            result.update(ok=ok, took=time.monotonic() - t0)

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        if how == "drop":
            with srv._lock:
                conn = srv._conns[0]
            srv._drop(conn)
        else:
            srv.close()
        t.join(10)
        assert result, "wait_acked never returned"
        assert result["ok"] is (how == "drop")
        assert result["took"] < 5.0
    finally:
        plan.release()
        c.stop()
        srv.close()


def test_server_abort_sends_no_fin():
    srv = ReplicationServer(**CPU)
    store = _store(capacity=8, wire=srv)
    c = ReplicationClient(srv.address, model="m", **CPU)
    c.start()
    _wait(lambda: srv.followers("m") >= 1, "follower connect")
    store.publish_pool(_pool(np.ones((2, 4))))
    assert srv.wait_acked(1, "m", timeout=20)
    srv.abort()
    c.join(10)
    assert c.fin_reason is None
    assert c.store.latest_meta().version == 1


def test_chaotic_stream_converges_for_any_seed(inject_seed):
    plan = FaultPlan([FaultRule("server.writer", "drop", prob=0.25),
                      FaultRule("server.writer", "dup", prob=0.25),
                      FaultRule("server.writer", "delay", prob=0.25,
                                delay_s=0.002)],
                     seed=inject_seed)
    srv = ReplicationServer(fault=plan, **CPU)
    store = _store(capacity=64, wire=srv)
    base = np.random.default_rng(10).normal(size=(48, 4)).astype(np.float32)
    c = ReplicationClient(srv.address, model="m", capacity=64,
                          reconnect=True, max_retries=100, backoff_s=0.01,
                          seed=inject_seed, **CPU)
    try:
        c.start()
        _wait(lambda: srv.followers("m") >= 1, "follower connect")
        for k in range(1, 9):
            store.publish_pool(_pool(base[:k], k_max=64))
        k = 9
        while not c.wait_version(store.latest_meta().version, timeout=1.0):
            assert k < 48, "follower failed to converge under chaos"
            store.publish_pool(_pool(base[:k], k_max=64))
            k += 1
        assert store_digest(c.store) == store_digest(store)
    finally:
        srv.close()
    c.join(10)


# ------------------------------------------------- across the two packages

def _jax_pool(rows, k_max=16):
    rows = np.asarray(rows, np.float32)
    k = rows.shape[0]
    c = jnp.zeros((k_max, rows.shape[1]), jnp.float32).at[:k].set(rows)
    return jcore.CenterPool(c, jnp.arange(k_max) < k,
                            jnp.asarray(k, jnp.int32), jnp.asarray(False))


def test_store_digest_equal_across_packages():
    rows = np.random.default_rng(11).normal(size=(5, 4)).astype(np.float32)
    js = jsnap.SnapshotStore(capacity=4, delta=True, model="m")
    ts = _store(capacity=4)
    for k in (2, 5):
        js.publish_pool(_jax_pool(rows[:k]))
        ts.publish_pool(_pool(rows[:k]))
    assert jtransport.store_digest(js) == store_digest(ts)


def test_port_follower_tracks_jax_master():
    """A JAX engine publishes every epoch through a JAX ReplicationServer;
    a port client that joined before the pass and a port client that
    joins late (bootstrap) both land on the JAX store's digest."""
    x = tsyn.dp_stick_breaking_data(512, seed=12)[0]
    srv = jtransport.ReplicationServer()
    store = jsnap.SnapshotStore(capacity=32, delta=True, model="m", wire=srv)
    early = ReplicationClient(srv.address, model="m", capacity=32,
                              **CPU).start()
    late = []
    try:
        _wait(lambda: srv.followers("m") >= 1, "port follower connect")

        def on_commit(pool, epoch, t):
            store.publish_pool(pool, epochs=epoch + 1)
            if epoch == 3:
                late.append(ReplicationClient(srv.address, model="m",
                                              capacity=32, **CPU).start())
        jcore.OCCEngine(jcore.DPMeansTransaction(4.0, 128), 64) \
            .run_from_proposals(jnp.asarray(x), on_commit=on_commit)
        assert late[0].wait_version(8, timeout=20)
        assert srv.wait_acked(8, "m", timeout=20)
        want = jtransport.store_digest(store)
        assert store_digest(early.store) == store_digest(late[0].store) \
            == want
        assert early.store.versions() == store.versions()
        assert late[0].bootstrapped and not early.bootstrapped
    finally:
        srv.close()
    early.join(10)
    late[0].join(10)


def test_jax_follower_tracks_port_master():
    """The port engine publishes every epoch through a port
    ReplicationServer; a JAX client lands on the port store's digest."""
    x = tsyn.dp_stick_breaking_data(512, seed=13)[0]
    srv = ReplicationServer(**CPU)
    store = _store(capacity=32, wire=srv)
    c = jtransport.ReplicationClient(srv.address, model="m",
                                     capacity=32).start()
    try:
        _wait(lambda: srv.followers("m") >= 1, "JAX follower connect")
        OCCEngine(DPMeansTransaction(4.0, 128), 64, device="cpu") \
            .run_from_proposals(
                x, on_commit=lambda p, e, t: store.publish_pool(
                    p, epochs=e + 1))
        assert srv.wait_acked(8, "m", timeout=20)
        assert c.wait_version(8)
        assert jtransport.store_digest(c.store) == store_digest(store)
        assert c.store.versions() == store.versions()
    finally:
        srv.close()
    c.join(10)


# -------------------------------------- fault plan (tests/test_fault.py)

def test_watchdog_flags_straggler_after_warmup():
    wd = StepWatchdog(threshold=3.0, alpha=0.5, warmup_steps=2)
    assert wd.observe(0, 100.0) is None
    assert wd.observe(1, 100.0) is None
    assert wd.observe(2, 1.0) is None
    assert wd.observe(3, 1.0) is None
    ev = wd.observe(4, 10.0)
    assert ev is not None and ev.step == 4 and ev.ratio > 3.0
    assert wd.events == [ev]


def test_watchdog_outliers_not_folded_into_ewma():
    wd = StepWatchdog(threshold=2.0, alpha=0.5, warmup_steps=0)
    wd.observe(0, 1.0)
    wd.observe(1, 50.0)
    assert wd.ewma == 1.0
    assert wd.observe(2, 1.5) is None
    assert len(wd.events) == 1


def test_watchdog_ewma_tracks_gradual_drift_quietly():
    wd = StepWatchdog(threshold=3.0, alpha=0.3, warmup_steps=0)
    t = 1.0
    for step in range(30):
        t *= 1.10
        assert wd.observe(step, t) is None
    assert wd.ewma > 1.0


def test_heartbeat_dead_hosts_synthetic_clock():
    hb = HeartbeatTracker(timeout=10.0)
    hb.beat(0, now=100.0)
    hb.beat(1, now=100.0)
    hb.beat(2, now=105.0)
    assert hb.dead_hosts(now=109.0) == []
    assert hb.dead_hosts(now=111.0) == [0, 1]
    hb.beat(0, now=112.0)
    assert hb.dead_hosts(now=113.0) == [1]


def test_fault_rule_validates_kind_and_trigger():
    with pytest.raises(ValueError, match="kind"):
        FaultRule("p", "explode", nth=1)
    with pytest.raises(ValueError, match="trigger"):
        FaultRule("p", "drop")


def test_fault_plan_nth_and_every_triggers_are_exact():
    plan = FaultPlan([FaultRule("a", "drop", nth=3),
                      FaultRule("a", "delay", every=2, delay_s=0.0)])
    fired = [tuple(r.kind for r in plan.at("a")) for _ in range(6)]
    assert fired == [(), ("delay",), ("drop",), ("delay",), (),
                     ("delay",)]
    assert plan.hits("a") == 6
    assert [e.hit for e in plan.events if e.kind == "drop"] == [3]


def test_fault_plan_points_are_independent():
    plan = FaultPlan([FaultRule("a", "drop", nth=1)])
    assert plan.at("b") == []
    assert [r.kind for r in plan.at("a")] == ["drop"]
    assert plan.hits("a") == 1 and plan.hits("b") == 1


def test_fault_plan_count_caps_total_fires():
    plan = FaultPlan([FaultRule("a", "dup", every=1, count=2)])
    assert [len(plan.at("a")) for _ in range(5)] == [1, 1, 0, 0, 0]


def test_fault_plan_prob_is_seed_deterministic():
    mk = lambda seed: FaultPlan([FaultRule("a", "drop", prob=0.5)],
                                seed=seed)
    run = lambda plan: [bool(plan.at("a")) for _ in range(64)]
    a, b = run(mk(7)), run(mk(7))
    assert a == b
    assert run(mk(8)) != a
    assert 10 < sum(a) < 54


def test_fault_plan_prob_schedule_equals_jax_package():
    """The port's seeded schedule is the reference's, hit for hit."""
    from repro.distributed import fault as jfault
    rules = [("a", "drop", 0.3), ("a", "dup", 0.6)]
    mine = FaultPlan([FaultRule(p, k, prob=q) for p, k, q in rules], seed=5)
    theirs = jfault.FaultPlan([jfault.FaultRule(p, k, prob=q)
                               for p, k, q in rules], seed=5)
    for _ in range(50):
        assert [r.kind for r in mine.at("a")] == \
            [r.kind for r in theirs.at("a")]


def test_fault_plan_kill_requires_opt_in():
    plan = FaultPlan([FaultRule("a", "kill", nth=1)])
    with pytest.raises(RuntimeError, match="allow_kill"):
        plan.at("a")


def test_fault_plan_audit_trail():
    plan = FaultPlan([FaultRule("x", "reset", nth=2)])
    plan.at("x")
    plan.at("x")
    assert plan.events == [FaultEvent("x", "reset", 2)]


def test_fault_plan_hold_gate_releases_every_waiter():
    plan = FaultPlan([FaultRule("w", "hold", every=1)])
    assert [r.kind for r in plan.at("w")] == ["hold"]
    assert plan.wait_released(timeout=0.01) is False
    plan.release()
    assert plan.wait_released(timeout=0.01) is True
