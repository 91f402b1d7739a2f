"""The port's CheckpointManager and DeltaWAL on the CPU (`device="cpu"`),
and both across the two packages.

The manager: atomic save/restore of nested trees of tensors and arrays
(dicts, lists, tuples, NamedTuples), keep-k GC, async writes, corrupt
checkpoint tolerance, and leaf names equal to the JAX package's, so a
checkpoint written by either package restores in the other.  The WAL:
append/checkpoint/replay, torn tails, segment GC, the trainer crash and
bit-identical resume, and a log written by either package recovered by
the other with equal digests and version lists.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.checkpoint import wal as jwal  # noqa: E402
from repro.distributed import transport as jtransport  # noqa: E402
from repro.serving import snapshot as jsnap  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, DeltaWAL, WireTee, recover_wal,
)
from repro_torch.checkpoint.manager import _flatten_with_names  # noqa: E402
from repro_torch.core import DPMeansTransaction, OCCEngine  # noqa: E402
from repro_torch.core.occ import CenterPool, make_pool  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.distributed.replication import (  # noqa: E402
    DeltaChannel, make_follower,
)
from repro_torch.distributed.transport import store_digest  # noqa: E402
from repro_torch.serving.snapshot import SnapshotStore  # noqa: E402

LAM = 4.0
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


def _publish_chain(store, n, rng, k_max=64):
    """n genuinely append-only versions (1 new row each)."""
    base = rng.normal(size=(n, 4)).astype(np.float32)
    for k in range(1, n + 1):
        store.publish_pool(_pool(base[:k], k_max=k_max))


def _tree():
    return {"pool": CenterPool(torch.arange(12, dtype=torch.float32)
                               .reshape(3, 4),
                               torch.tensor([True, True, False]),
                               torch.tensor(2, dtype=torch.int32),
                               torch.tensor(False)),
            "flags": [np.array([True, False]), np.asarray(2.5, np.float32),
                      (np.arange(3, dtype=np.int64), None)],
            "count": np.asarray(3, np.int32)}


# --------------------------------------------------------- CheckpointManager

def test_save_restore_roundtrip_nested_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    path = mgr.save(7, tree, extra={"note": "x"})
    assert os.path.isdir(path)
    step, back = mgr.restore(tree, **CPU)
    assert step == 7
    assert isinstance(back["pool"], CenterPool)
    for a, b in zip(tree["pool"], back["pool"]):
        assert torch.equal(a, b)
    assert torch.equal(back["flags"][0], torch.tensor([True, False]))
    assert float(back["flags"][1]) == 2.5
    assert back["flags"][2][1] is None
    assert back["flags"][2][0].dtype == torch.int64
    assert int(back["count"]) == 3
    assert mgr.manifest(7)["extra"] == {"note": "x"}


def test_leaf_names_equal_the_jax_package():
    tree = _tree()
    jtree = {"pool": jcore.CenterPool(*(t.numpy() for t in tree["pool"])),
             "flags": tree["flags"], "count": tree["count"]}
    assert [n for n, _ in _flatten_with_names(tree)] == \
        [n for n, _ in jmanager._flatten_with_names(jtree)]


def test_restore_rejects_missing_leaf_and_shardings(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": np.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"a": np.zeros(2), "b": np.zeros(2)}, **CPU)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(
            {"a": np.zeros(2)}, **CPU)
    with pytest.raises(NotImplementedError, match="multi-card"):
        mgr.restore({"a": np.zeros(2)}, shardings=object(), **CPU)


def test_keep_gc_prunes_oldest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.full((3,), float(s))})
    assert mgr.all_steps() == [3, 4]
    step, back = mgr.restore({"a": np.zeros(3)}, **CPU)
    assert step == 4 and float(back["a"][0]) == 4.0


def test_async_write_snapshots_at_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    a = torch.arange(8, dtype=torch.float32)
    mgr.save(1, {"a": a})
    a += 100.0                 # in place, AFTER save: must not leak in
    mgr.save(2, {"a": a})
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    _, t1 = mgr.restore({"a": np.zeros(8)}, step=1, **CPU)
    assert torch.equal(t1["a"], torch.arange(8, dtype=torch.float32))


def test_latest_step_tolerates_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": np.zeros(2)})
    os.makedirs(tmp_path / "step_00000002.tmp")
    os.makedirs(tmp_path / "step_00000003")
    with open(tmp_path / "step_00000003" / "manifest.json", "w") as f:
        f.write('{"step": 3, "lea')
    os.makedirs(tmp_path / "step_00000004")
    os.makedirs(tmp_path / "step_nonsense")
    assert mgr.all_steps() == [1]
    step, _ = mgr.restore({"a": np.zeros(2)}, **CPU)
    assert step == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A checkpoint written by one package restores in the other, leaf
    for leaf."""
    tree = _tree()
    host = {"pool": jcore.CenterPool(*(t.numpy() for t in tree["pool"])),
            "flags": tree["flags"], "count": tree["count"]}
    if writer == "jax":
        jmanager.CheckpointManager(str(tmp_path)).save(3, host)
        step, back = CheckpointManager(str(tmp_path)).restore(tree, **CPU)
        got = [b.numpy() for _, b in _flatten_with_names(back)]
    else:
        CheckpointManager(str(tmp_path)).save(3, tree)
        step, back = jmanager.CheckpointManager(str(tmp_path)).restore(host)
        got = [np.asarray(b) for _, b in jmanager._flatten_with_names(back)]
    want = [np.asarray(a) for _, a in jmanager._flatten_with_names(host)]
    if writer == "port":
        # the JAX package restores as jnp arrays: 64-bit types narrow
        # unless jax_enable_x64 is set
        want = [np.asarray(jnp.asarray(a)) for a in want]
    assert step == 3 and len(got) == len(want) == 8
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------------ DeltaWAL

def _wal(path, **kw):
    return DeltaWAL(str(path), model="m", fsync=False, **CPU, **kw)


def test_wal_recover_bit_identical_and_version_continuity(tmp_path):
    wal = _wal(tmp_path, checkpoint_every=0)
    store = _store(capacity=32, wire=wal)
    rng = np.random.default_rng(0)
    _publish_chain(store, 10, rng)
    wal.close()
    rec, info = recover_wal(str(tmp_path), model="m", capacity=32, **CPU)
    assert info == dict(ckpt_version=0, n_replayed=10, n_skipped=0)
    assert rec.latest_meta().version == 10
    assert store_digest(rec) == store_digest(store)
    snap = rec.publish_pool(_pool(rng.normal(size=(11, 4)), k_max=64))
    assert snap.version == 11


def test_wal_checkpoint_cadence_bounds_replay(tmp_path):
    wal = _wal(tmp_path, checkpoint_every=4)
    store = _store(capacity=32, wire=wal)
    _publish_chain(store, 10, np.random.default_rng(1))
    assert wal.n_checkpoints == 2 and wal.ckpt.all_steps() == [4, 8]
    wal.close()
    rec, info = recover_wal(str(tmp_path), model="m", capacity=32, **CPU)
    assert info["ckpt_version"] == 8 and info["n_replayed"] == 2
    assert store_digest(rec) == store_digest(store)
    assert rec.latest_meta().n_seen == store.latest_meta().n_seen


def test_wal_torn_tail_recovers_last_complete_frame(tmp_path):
    wal = _wal(tmp_path, checkpoint_every=0)
    store = _store(capacity=32, wire=wal)
    _publish_chain(store, 6, np.random.default_rng(2))
    wal.close()
    seg = os.path.join(str(tmp_path), "seg_00000000.log")
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.truncate(size - 7)          # crash mid-append: torn last frame
    rec, info = recover_wal(str(tmp_path), model="m", **CPU)
    assert rec.latest_meta().version == 5
    assert info["n_replayed"] == 5
    with open(seg, "ab") as f:
        f.write(b"\x00garbage-not-a-frame-header\xff" * 3)
    rec2, _ = recover_wal(str(tmp_path), model="m", **CPU)
    assert rec2.latest_meta().version == 5
    assert store_digest(rec2) == store_digest(rec)


def test_wal_segment_gc_follows_checkpoint_keep(tmp_path):
    wal = _wal(tmp_path, checkpoint_every=2, keep=2)
    store = _store(capacity=64, wire=wal)
    _publish_chain(store, 12, np.random.default_rng(3))
    assert wal.ckpt.all_steps() == [10, 12]
    assert all(b >= 10 for b in wal.segment_bases())
    wal.close()
    rec, _ = recover_wal(str(tmp_path), model="m", **CPU)
    assert store_digest(rec) == store_digest(store)


def test_wal_rejects_foreign_model(tmp_path):
    wal = _wal(tmp_path)
    store = _store(capacity=8, model="other", wire=wal)
    with pytest.raises(ValueError, match="WAL for 'm'"):
        store.publish_pool(_pool(np.ones((2, 4))))
    wal.close()


def test_wire_tee_fans_out_to_wal_and_followers(tmp_path):
    wal = _wal(tmp_path, checkpoint_every=0)
    chan = DeltaChannel()
    follower = make_follower(chan, "m", capacity=8, **CPU)
    store = _store(capacity=8, wire=WireTee(chan, wal))
    _publish_chain(store, 3, np.random.default_rng(4), k_max=16)
    chan.pump()
    wal.close()
    rec, _ = recover_wal(str(tmp_path), model="m", **CPU)
    assert (store_digest(follower) == store_digest(rec)
            == store_digest(store))


def test_trainer_crash_wal_replay_resumes_bit_identical(tmp_path):
    """WAL replay after a simulated trainer crash restores the stream
    bit-identically: the resumed trainer's final pool equals the
    uninterrupted run's."""
    x = tsyn.dp_stick_breaking_data(1024, 8, seed=5)[0]

    def engine(**kw):
        return OCCEngine(DPMeansTransaction(LAM, k_max=64), pb=64, **CPU,
                         **kw)
    ref = engine()
    ref.partial_fit(x[:512])
    ref.partial_fit(x[512:])
    ref.flush()

    wal = _wal(tmp_path, checkpoint_every=2)
    store = _store(capacity=16, wire=wal)
    crashy = engine(publish=store.publish_pass)
    crashy.partial_fit(x[:512])
    wal.close()                        # process dies here; only disk remains

    rec, _ = recover_wal(str(tmp_path), model="m", capacity=16, **CPU)
    assert store_digest(rec) == store_digest(store)
    snap = rec.latest().materialize()
    assert snap.n_seen == 512

    resumed = engine()
    resumed.restore(snap, k_max=64)
    resumed.partial_fit(x[snap.n_seen:])
    resumed.flush()
    assert all(torch.equal(a, b) for a, b in zip(resumed.pool, ref.pool))


# ------------------------------------------------- across the two packages

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("checkpoint_every", [0, 3])
def test_wal_recovers_across_packages(tmp_path, writer, checkpoint_every):
    """One package's engine publishes every epoch into its DeltaWAL; the
    other package's `recover_wal` rebuilds the store with the writer's
    digest, and with the digest and version list of the writer's own
    `recover_wal` (checkpoint images included)."""
    x = tsyn.dp_stick_breaking_data(640, seed=14)[0]
    if writer == "jax":
        wal = jwal.DeltaWAL(str(tmp_path), model="m", fsync=False,
                            checkpoint_every=checkpoint_every)
        store = jsnap.SnapshotStore(capacity=32, delta=True, model="m",
                                    wire=wal)
        jcore.OCCEngine(jcore.DPMeansTransaction(LAM, 128), 64) \
            .run_from_proposals(jnp.asarray(x), on_commit=lambda p, e, t:
                                store.publish_pool(p, n_seen=(e + 1) * 64,
                                                   epochs=e + 1))
        wal.close()
        rec, info = recover_wal(str(tmp_path), model="m", capacity=32, **CPU)
        own, _ = jwal.recover_wal(str(tmp_path), model="m", capacity=32)
        want = jtransport.store_digest(store)
        assert jtransport.store_digest(own) == want
        got = store_digest(rec)
    else:
        wal = _wal(tmp_path, checkpoint_every=checkpoint_every)
        store = _store(capacity=32, wire=wal)
        OCCEngine(DPMeansTransaction(LAM, 128), 64, **CPU) \
            .run_from_proposals(x, on_commit=lambda p, e, t:
                                store.publish_pool(p, n_seen=(e + 1) * 64,
                                                   epochs=e + 1))
        wal.close()
        rec, info = jwal.recover_wal(str(tmp_path), model="m", capacity=32)
        own, _ = recover_wal(str(tmp_path), model="m", capacity=32, **CPU)
        want = store_digest(store)
        assert store_digest(own) == want
        got = jtransport.store_digest(rec)
    assert got == want
    assert store.versions() == list(range(1, 11))
    assert rec.versions() == own.versions() == (
        [9, 10] if checkpoint_every else list(range(1, 11)))
    assert rec.latest_meta().n_seen == store.latest_meta().n_seen == 640
    assert info["ckpt_version"] == (9 if checkpoint_every else 0)
