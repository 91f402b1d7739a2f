"""The port's serving plane against the JAX package, on the CPU.

The JAX trainer publishes every version into a JAX store and, converted
through numpy, into the port's store, so both services answer from the
same published state.  Bar: labels, versions, buckets and groups
identical; scores within rtol = atol = 1e-5; snapshot tensors and
hierarchical layouts bit for bit.  The kernels behind the port's service
run on the card in `chip_smoke.py`; here the port runs its plain versions.
"""
import dataclasses
import inspect
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import DPMeansTransaction as JTxn  # noqa: E402
from repro.core import OCCEngine as JEngine  # noqa: E402
from repro.core.occ import CenterPool as JPool  # noqa: E402
from repro.data import dp_stick_breaking_data  # noqa: E402
from repro.serving import ClusterService as JService  # noqa: E402
from repro.serving import ModelRouter as JRouter  # noqa: E402
from repro.serving import Query as JQuery  # noqa: E402
from repro.serving import SnapshotStore as JStore  # noqa: E402
from repro.serving import freeze_snapshot as j_freeze  # noqa: E402
from repro.serving.snapshot import build_hier as j_build_hier  # noqa: E402

import repro_torch.serving as tserving  # noqa: E402
from repro_torch.convert import pool_from_numpy, snapshot_from_numpy  # noqa: E402
from repro_torch.core import DPMeansTransaction, OCCEngine  # noqa: E402
from repro_torch.core.occ import CenterPool  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ClusterService, ModelRouter, Query, ServeConfig, SnapshotStore,
    freeze_snapshot,
)
from repro_torch.serving import cluster_service as cs_mod  # noqa: E402
from repro_torch.serving.snapshot import build_hier  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LAM = 4.0
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "api_surface_serving.json")


def _stream(n=768, seed=0, dim=8):
    return dp_stick_breaking_data(n, seed=seed, dim=dim)[0]


def _port_pool(pool) -> CenterPool:
    return pool_from_numpy(np.asarray(pool.centers), np.asarray(pool.mask),
                           np.asarray(pool.count), np.asarray(pool.overflow),
                           device="cpu")


def _publish_both(jstore, tstore, res, **kw):
    """One JAX pass result into both stores, as `publish_pass` would."""
    jstore.publish_pass(res, **kw)
    trace = tuple(int(c) for c in np.asarray(res.stats.cap))
    tstore.publish_pool(_port_pool(res.pool), cap_trace=trace, **kw)


def _twin_stores(x, lam=LAM, pb=64, k_max=128, batches=((0, 300), (300, 768)),
                 **store_kw):
    """A JAX trainer publishing every version into a JAX store and, through
    numpy, into the port's store (same versions, same pools)."""
    jstore = JStore(capacity=64, **store_kw)
    tstore = SnapshotStore(capacity=64, device="cpu", **store_kw)

    def publish(res, **kw):
        _publish_both(jstore, tstore, res, **kw)
    eng = JEngine(JTxn(lam, k_max=k_max), pb=pb, publish=publish)
    for lo, hi in batches:
        eng.partial_fit(jnp.asarray(x[lo:hi]))
    eng.flush()
    return jstore, tstore, eng


def _same_response(t, j, scores=True):
    assert (t.version, t.bucket, t.group, t.offset, t.degraded) == \
        (j.version, j.bucket, j.group, j.offset, j.degraded)
    assert t.labels.dtype == np.int32
    np.testing.assert_array_equal(t.labels, j.labels)
    if scores:
        np.testing.assert_allclose(t.scores, j.scores, **TOL)
    else:
        assert t.scores is None and j.scores is None


def _hier_fields_equal(th, jh):
    assert (th.n_cells, th.shard_cap) == (jh.n_cells, jh.shard_cap)
    np.testing.assert_array_equal(th.fine_ids.numpy(), np.asarray(jh.fine_ids))
    np.testing.assert_array_equal(th.fine_mask.numpy(),
                                  np.asarray(jh.fine_mask))
    np.testing.assert_array_equal(th.fine.numpy(), np.asarray(jh.fine))
    np.testing.assert_array_equal(th.coarse.numpy(), np.asarray(jh.coarse))
    np.testing.assert_array_equal(th.coarse_mask.numpy(),
                                  np.asarray(jh.coarse_mask))


# ------------------------------------------------------------- snapshots

@pytest.mark.parametrize("lam,k_max", [(4.0, 128), (1.0, 128), (0.01, 8)])
def test_freeze_snapshot_matches_jax(lam, k_max):
    x = _stream()
    eng = JEngine(JTxn(lam, k_max=k_max), pb=64)
    eng.partial_fit(jnp.asarray(x[:512]))
    js = j_freeze(eng.pool, 7, n_seen=eng.n_processed)
    ts = freeze_snapshot(_port_pool(eng.pool), 7, n_seen=eng.n_processed)
    assert (ts.version, ts.count, ts.capacity, ts.overflow, ts.n_seen) == \
        (js.version, js.count, js.capacity, js.overflow, js.n_seen)
    assert ts.capacity & (ts.capacity - 1) == 0 and ts.capacity >= ts.count
    np.testing.assert_array_equal(ts.centers.numpy(), np.asarray(js.centers))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    pool = ts.to_pool(k_max)
    np.testing.assert_array_equal(pool.centers.numpy(),
                                  np.asarray(js.to_pool(k_max).centers))
    if ts.count > 1:
        with pytest.raises(ValueError):
            freeze_snapshot(_port_pool(eng.pool), 8, max_capacity=1)


@pytest.mark.parametrize("n_cells,shard_cap,lam", [
    (None, None, 1.0), (None, None, 0.5), (4, None, 1.0), (8, 128, 1.0)])
def test_build_hier_matches_jax(n_cells, shard_cap, lam):
    x = _stream()
    eng = JEngine(JTxn(lam, k_max=256), pb=64)
    eng.partial_fit(jnp.asarray(x))
    eng.flush()
    count = int(eng.pool.count)
    jh = j_build_hier(eng.pool.centers, eng.pool.mask, count,
                      n_cells=n_cells, shard_cap=shard_cap)
    tp = _port_pool(eng.pool)
    th = build_hier(tp.centers, tp.mask, count, n_cells=n_cells,
                    shard_cap=shard_cap)
    _hier_fields_equal(th, jh)
    ids, msk = th.fine_ids.numpy(), th.fine_mask.numpy()
    np.testing.assert_array_equal(np.sort(ids[msk]), np.arange(count))
    assert build_hier(tp.centers, tp.mask, 0) is None
    with pytest.raises(ValueError, match="shard_cap"):
        build_hier(tp.centers, tp.mask, count, n_cells=2, shard_cap=8)


def test_delta_materialization_equals_eager_every_version():
    """Port stores only: a port trainer publishes into an eager and a delta
    store (both hierarchical); every version materializes bit for bit."""
    x = torch.from_numpy(_stream())
    eager = SnapshotStore(capacity=64, hier=True, device="cpu")
    delta = SnapshotStore(capacity=64, hier=True, delta=True, device="cpu")

    def publish(res, **kw):
        eager.publish_pass(res, **kw)
        delta.publish_pass(res, **kw)
    eng = OCCEngine(DPMeansTransaction(1.0, k_max=128), pb=64,
                    publish=publish, device="cpu")
    for lo, hi in ((0, 100), (100, 300), (300, 768)):
        eng.partial_fit(x[lo:hi])
    eng.flush()
    assert eager.versions() == delta.versions() and len(eager) >= 3
    for v in eager.versions():
        e, d = eager.get(v), delta.get(v)
        assert (e.count, e.capacity, e.n_seen, e.epochs, e.cap_trace) == \
            (d.count, d.capacity, d.n_seen, d.epochs, d.cap_trace)
        assert torch.equal(e.centers, d.centers) and torch.equal(e.mask,
                                                                 d.mask)
        for f in ("coarse", "fine", "fine_ids", "fine_mask"):
            assert torch.equal(getattr(e.hier, f), getattr(d.hier, f))
    assert delta.delta_rows_published == int(eng.pool.count)
    # a rewritten prefix rebases; the older versions keep their centers
    v_old = delta.versions()[-1]
    old = delta.get(v_old).centers.clone()
    pool = eng.pool
    centers = pool.centers.clone()
    centers[0] += 1.0
    delta.publish_pool(pool._replace(centers=centers), verify=True)
    assert torch.equal(delta.latest().centers[:1], centers[:1])
    assert torch.equal(delta.get(v_old).centers, old)


def test_jax_deltas_reproduce_every_version_in_port_follower():
    class Wire:
        def __init__(self):
            self.sent = []

        def send(self, delta):
            self.sent.append(delta)
    x = _stream()
    wire = Wire()
    primary = JStore(capacity=64, delta=True, model="m", wire=wire)
    eng = JEngine(JTxn(LAM, k_max=128), pb=64, publish=primary.publish_pass)
    for lo, hi in ((0, 300), (300, 768)):
        eng.partial_fit(jnp.asarray(x[lo:hi]))
    eng.flush()
    # a rewritten prefix: the JAX store emits a rebase delta
    c = np.asarray(eng.pool.centers).copy()
    c[1] += 3.0
    primary.publish_pool(JPool(jnp.asarray(c), eng.pool.mask, eng.pool.count,
                               eng.pool.overflow), verify=True)
    assert wire.sent[-1].rebase
    follower = SnapshotStore(capacity=64, delta=True, hier=True,
                             device="cpu")
    for delta in wire.sent:
        follower.apply_delta(delta)
    assert follower.versions() == primary.versions()
    for v in primary.versions():
        jp, tf = primary.get(v), follower.get(v)
        assert (tf.count, tf.capacity, tf.n_seen, tf.epochs) == \
            (jp.count, jp.capacity, jp.n_seen, jp.epochs)
        np.testing.assert_array_equal(tf.centers.numpy(),
                                      np.asarray(jp.centers))
        assert tf.hier is not None
    # a late follower bootstraps from the JAX store's rebase delta
    late = SnapshotStore(delta=True, device="cpu")
    late.apply_delta(primary.bootstrap_delta())
    np.testing.assert_array_equal(late.latest().centers.numpy(),
                                  np.asarray(primary.latest().centers))
    with pytest.raises(ValueError, match="gap"):
        late.apply_delta(wire.sent[1])
    with pytest.raises(ValueError, match="delta-mode"):
        SnapshotStore(device="cpu").apply_delta(wire.sent[0])


def test_snapshot_from_numpy_serves_like_the_jax_snapshot():
    x = _stream()
    jstore, _, _ = _twin_stores(x, lam=1.0, hier=True)
    js = jstore.latest()
    h = js.hier
    snap = snapshot_from_numpy(
        js.version, js.centers, js.mask, js.count, js.capacity,
        hier={f: getattr(h, f) for f in (
            "coarse", "coarse_mask", "fine", "fine_ids", "fine_mask",
            "n_cells", "shard_cap")},
        n_seen=js.n_seen, epochs=js.epochs, device="cpu")
    store = SnapshotStore(device="cpu")
    store._register(snap)
    t = ClusterService(store, probes=2).topk(x[:20], k=3)
    j = JService(jstore, backend="ref", probes=2).topk(x[:20], k=3)
    _same_response(t, j)


# ------------------------------------------------- service against JAX

def _both(x, **store_kw):
    jstore, tstore, _ = _twin_stores(x, lam=1.0, **store_kw)
    assert jstore.versions() == tstore.versions()
    return jstore, tstore


@pytest.mark.parametrize("kind", ["score", "assign", "topk", "multiprobe"])
def test_solo_responses_match_jax(kind):
    x = _stream()
    jstore, tstore = _both(x, hier=True)
    _hier_fields_equal(tstore.latest().hier, jstore.latest().hier)
    kw = dict(max_bucket=64)
    if kind == "multiprobe":
        kw.update(probes=2, recall_audit_every=2)
    tsvc = ClusterService(tstore, **kw)
    jsvc = JService(jstore, backend="ref", **kw)
    for lo, n in ((0, 1), (5, 9), (40, 33), (100, 100)):
        q = x[lo:lo + n]
        if kind in ("score", "assign"):
            t, j = getattr(tsvc, kind)(q), getattr(jsvc, kind)(q)
            _same_response(t, j, scores=kind == "score")
        else:
            _same_response(tsvc.topk(q, k=5), jsvc.topk(q, k=5))
    tm, jm = tsvc.metrics(), jsvc.metrics()
    for key in ("n_queries", "n_requests", "n_microbatches", "n_dispatches",
                "bucket_hist", "versions_served", "n_topk_multiprobe",
                "topk_shards_probed", "topk_recall_audits", "latest_version",
                "cap_trace"):
        assert tm[key] == jm[key], key
    assert tm["topk_recall"] == pytest.approx(jm["topk_recall"])


def test_coalesced_responses_match_jax():
    """Sequential coalesced requests: each flushes alone at its deadline,
    so groups are numbered alike in both packages."""
    x = _stream()
    jstore, tstore = _both(x, hier=True)
    kw = dict(coalesce=True, coalesce_bucket=64, coalesce_delay_ms=1.0)
    tsvc, jsvc = ClusterService(tstore, **kw), JService(jstore, backend="ref",
                                                        **kw)
    try:
        for lo, n in ((0, 13), (20, 1), (30, 64), (100, 100)):
            q = x[lo:lo + n]
            _same_response(tsvc.score(q), jsvc.score(q))
            _same_response(tsvc.topk(q, k=4), jsvc.topk(q, k=4))
            _same_response(tsvc.submit(Query(q, kind="topk", k=2,
                                             priority="batch")),
                           jsvc.submit(JQuery(q, kind="topk", k=2,
                                              priority="batch")))
    finally:
        tsvc.close()
        jsvc.close()
    assert tsvc.n_groups == jsvc.n_groups


def test_router_two_tenants_match_jax():
    x = _stream()
    trouter = ModelRouter(device="cpu", max_bucket=64)
    jrouter = JRouter(backend="ref", max_bucket=64)
    for name, lam, span in (("a", LAM, (0, 512)), ("b", 1.0, (256, 768))):
        ts, js = trouter.add_model(name), jrouter.add_model(name)

        def publish(res, _js=js, _ts=ts, **kw):
            _publish_both(_js, _ts, res, **kw)
        eng = JEngine(JTxn(lam, k_max=128), pb=64, publish=publish)
        eng.partial_fit(jnp.asarray(x[span[0]:span[1]]))
        eng.flush()
    try:
        for name in ("a", "b"):
            q = x[:70]
            _same_response(trouter.score(name, q), jrouter.score(name, q))
            _same_response(trouter.topk(name, q, k=3),
                           jrouter.topk(name, q, k=3))
            t = trouter.submit(name, Query(q, want_scores=False))
            assert t.model == name and t.scores is None
        assert trouter.models() == ["a", "b"]
        tm = trouter.metrics()
        assert tm["n_models"] == 2 and tm["n_requests"] == 6
        with pytest.raises(KeyError):
            trouter.score("nope", x[:4])
        with pytest.raises(ValueError):
            trouter.add_model("a")
    finally:
        trouter.close()
        jrouter.close()


# ----------------------------------------------------- port invariants

def test_audit_records_replay_bit_exactly():
    x = _stream()
    _, tstore = _both(x, hier=True)
    snap = tstore.latest()
    h = snap.hier
    flat = ClusterService(tstore, audit_log=True, max_bucket=64)
    mp = ClusterService(tstore, audit_log=True, max_bucket=64, probes=2)
    resps = [(flat, flat.score(x[:50])), (flat, flat.topk(x[3:40], k=4)),
             (mp, mp.topk(x[7:70], k=6))]
    for svc, r in resps:
        rec = svc.audit.pop(0)
        xp = torch.from_numpy(rec.x)
        if rec.probes:
            d2, idx, _ = cs_mod._mp_topk_step(
                h.coarse, h.coarse_mask, h.fine, h.fine_ids, h.fine_mask,
                xp, rec.n_valid, k=rec.k, p=rec.probes, u_cap=h.n_cells,
                backend="auto")
        elif rec.kind == "topk":
            d2, idx = cs_mod._topk_step(snap.centers, snap.mask, snap.count,
                                        xp, rec.n_valid, k=rec.k,
                                        backend="auto")
        else:
            d2, idx = cs_mod._assign_step(snap.centers, snap.mask,
                                          snap.count, xp, rec.n_valid,
                                          backend="auto")
        n = rec.n_valid
        assert rec.version == r.version
        np.testing.assert_array_equal(idx[:n].numpy(), r.labels)
        np.testing.assert_array_equal(d2[:n].numpy(), r.scores)


def test_coalesced_burst_equals_solo_answers():
    x = _stream()
    _, tstore = _both(x)
    co = ClusterService(tstore, coalesce=True, coalesce_bucket=64,
                        coalesce_delay_ms=50.0)
    solo = ClusterService(tstore)
    spans = [(0, 13), (13, 40), (40, 41), (41, 64)]
    got = {}

    def client(i, lo, hi):
        got[i] = co.topk(x[lo:hi], k=5)
    try:
        ts = [threading.Thread(target=client, args=(i, lo, hi))
              for i, (lo, hi) in enumerate(spans)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        co.close()
    assert len(got) == len(spans) and co.n_groups < len(spans)
    for i, (lo, hi) in enumerate(spans):
        s = solo.topk(x[lo:hi], k=5)
        assert got[i].version == s.version and got[i].group >= 0
        np.testing.assert_array_equal(got[i].labels, s.labels)
        np.testing.assert_allclose(got[i].scores, s.scores, **TOL)


def test_hot_swap_adds_no_step_shape():
    x = torch.from_numpy(_stream())
    store = SnapshotStore(device="cpu")
    eng = OCCEngine(DPMeansTransaction(LAM, k_max=128), pb=64,
                    publish=store.publish_pass, device="cpu")
    eng.partial_fit(x[:256])
    svc = ClusterService(store)
    r1 = svc.assign(x[:40])
    eng.partial_fit(x[256:512])
    svc.assign(x[:40])                        # may add a capacity bucket
    before = svc.metrics()["query_step_compiles"]
    store.publish_pool(eng.pool)
    r2 = svc.assign(x[:40])
    assert r2.version > r1.version and svc.n_swaps >= 2
    assert svc.metrics()["query_step_compiles"] == before
    assert svc.n_dispatches == svc.n_microbatches


def test_multiprobe_p_all_is_the_flat_step_and_needs_hier():
    x = _stream()
    _, tstore = _both(x, hier=True)
    n_cells = tstore.latest().hier.n_cells
    flat = ClusterService(tstore, audit_log=True)
    pall = ClusterService(tstore, probes=n_cells, audit_log=True)
    q = x[100:137]
    a, b = flat.topk(q, k=7), pall.topk(q, k=7)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.scores, b.scores)
    assert pall.audit[-1].probes == 0
    assert pall.metrics()["n_topk_multiprobe"] == 0
    _, plain = _both(x)
    with pytest.raises(RuntimeError, match="hier"):
        ClusterService(plain, probes=2).topk(x[:8], k=3)


def test_multiprobe_counters():
    x = _stream()
    _, tstore = _both(x, hier=True)
    h = tstore.latest().hier
    svc = ClusterService(tstore, probes=2, recall_audit_every=2,
                         audit_log=True)
    for _ in range(4):
        resp = svc.topk(x[:40], k=5)
    m = svc.metrics()
    assert m["n_topk_multiprobe"] == 4 and m["topk_recall_audits"] == 2
    assert 0 < m["topk_shards_probed"] <= 4 * h.n_cells
    assert m["topk_tiles_skipped"] == 4 * h.n_cells - m["topk_shards_probed"]
    assert 0.0 < m["topk_recall"] <= 1.0
    assert ((resp.labels >= -1) & (resp.labels < tstore.latest().count)).all()


def test_flat_topk_counts_the_skipped_center_tiles():
    """count 130 in the 256 bucket: the kernel's 64-center tiles are 4, it
    walks 3, so each flat dispatch skips one."""
    x = _stream()
    rng = np.random.default_rng(5)
    c = rng.normal(size=(256, 8)).astype(np.float32)
    c[130:] = 0.0
    pool = pool_from_numpy(c, np.arange(256) < 130, 130, False, device="cpu")
    store = SnapshotStore(device="cpu")
    store.publish_pool(pool)
    svc = ClusterService(store)
    for _ in range(3):
        svc.topk(x[:20], k=4)
    m = svc.metrics()
    assert store.latest().capacity == 256
    assert m["topk_tiles_skipped"] == 3 and m["n_topk_multiprobe"] == 0


def test_serving_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    for call in (lambda: SnapshotStore(), lambda: ModelRouter(),
                 lambda: tserving.CenterLog(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    log = tserving.CenterLog(4, device="cpu")
    log.append(np.ones((3, 4), np.float32))
    dense = log.dense(3, 8)
    assert dense.device.type == "cpu" and dense.shape == (8, 4)
    assert torch.equal(dense[:3], torch.ones((3, 4)))
    assert not bool(dense[3:].any())


def test_restore_resumes_bit_identical_with_warm_cap():
    x = torch.from_numpy(_stream(1024, seed=3))
    store = SnapshotStore(capacity=64, device="cpu")
    eng_a = OCCEngine(DPMeansTransaction(LAM, k_max=128), pb=64,
                      validate_cap="adaptive", publish=store.publish_pass,
                      device="cpu")
    eng_a.partial_fit(x[:512])
    snap = store.latest()
    assert snap.cap_est is not None and len(snap.cap_trace) == 8
    eng_a.partial_fit(x[512:])
    eng_a.flush()
    eng_b = OCCEngine(DPMeansTransaction(LAM, k_max=128), pb=64,
                      validate_cap="adaptive", device="cpu")
    eng_b.restore(snap, k_max=128)
    assert eng_b._cap_est == snap.cap_est
    assert eng_b.n_seen == snap.n_seen and eng_b.epochs_done == snap.epochs
    eng_b.partial_fit(x[512:])
    eng_b.flush()
    assert eng_b.cap_history[0] is not None
    for a, b in zip(eng_a.pool, eng_b.pool):
        assert torch.equal(a, b)
    assert torch.equal(eng_a.stats.proposed[-eng_b.stats.proposed.shape[0]:],
                       eng_b.stats.proposed)
    with pytest.raises(ValueError):
        eng_a.restore(snap, k_max=128)
    with pytest.raises(ValueError):
        snap.to_pool(k_max=snap.count - 1)


def test_cap_trace_and_estimate_surface_in_metrics():
    x = _stream()
    jstore, tstore, _ = _twin_stores(x, delta=True)
    m = ClusterService(tstore).metrics()
    jm = JService(jstore, backend="ref").metrics()
    assert m["latest_version"] == jm["latest_version"]
    assert m["cap_trace"] == jm["cap_trace"] and m["cap_est"] == jm["cap_est"]
    assert all(isinstance(c, int) for c in m["cap_trace"])


def test_unported_and_unknown_options_raise():
    store = SnapshotStore(device="cpu")
    # a mesh must be a DeviceMesh of the store's device type
    # (tests/test_torch_mesh_serving.py serves on one)
    with pytest.raises(ValueError, match="mesh"):
        ClusterService(store, mesh=object())
    with pytest.raises(ValueError, match="mesh"):
        ModelRouter(mesh=object(), device="cpu")
    for backend in ("ref", "pallas", "emulate"):
        with pytest.raises(ValueError, match="backend"):
            ServeConfig(backend=backend)
    with pytest.raises(RuntimeError, match="no model version"):
        ClusterService(store).assign(np.zeros((4, 8), np.float32))


def test_close_flushes_admitted_requests():
    x = _stream()
    _, tstore = _both(x)
    svc = ClusterService(tstore, coalesce=True, coalesce_delay_ms=60_000.0)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", svc.score(x[:5])))
    t.start()
    while svc.queue_depth_rows() == 0:
        threading.Event().wait(0.01)
    svc.close()
    t.join(timeout=30)
    assert out["r"].labels.shape == (5,)
    with pytest.raises(RuntimeError, match="closed"):
        svc._queue = cs_mod._AdmissionQueue(svc, 64, svc.config)
        svc._queue.close()
        svc._queue.submit(torch.zeros((1, 8)), Query(x[:1]), "interactive")


# ---------------------------------------------------------- API surface

# Documented differences from the JAX package's serving surface: stores,
# routers and frozen snapshots take a device; CenterLog takes the device of
# its dense tensors; ServeEngine takes no `params`, because the port's
# model is an nn.Module that holds its parameters.
EXTRA_INIT = {"ModelRouter": {"device"}, "CenterLog": {"device"}}
EXTRA_FIELDS = {"SnapshotStore": {"device"}}
MISSING_INIT = {"ServeEngine": {"params"}}


def _params(fn) -> list[str]:
    return [p for p in inspect.signature(fn).parameters if p != "self"]


def _golden_params(sig: str) -> list[str]:
    """Parameter names of a signature string of the golden file: split at
    the commas outside brackets and quotes."""
    parts, depth, quote, cur = [], 0, None, ""
    for ch in sig.strip()[1:sig.rindex(")")]:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        cur += ch
    parts.append(cur)
    names = [p.strip().lstrip("*").split(":")[0].split("=")[0].strip()
             for p in parts]
    return [n for n in names if n and n != "self"]


def test_public_serving_names_match_golden():
    with open(GOLDEN) as f:
        golden = json.load(f)
    want = golden["exports"]
    assert sorted(tserving.__all__) == want
    for name in want:
        spec, obj = golden["api"][name], getattr(tserving, name)
        if spec["kind"] == "namedtuple":
            assert list(obj._fields) == spec["fields"], name
            assert {k: repr(v) for k, v in obj._field_defaults.items()} \
                == spec["defaults"], name
            continue
        if spec["kind"] == "function":
            assert [p for p in _params(obj) if p != "device"] == \
                _golden_params(spec["signature"]), name
            continue
        if spec["kind"] == "dataclass":
            got = [f.name for f in dataclasses.fields(obj)]
            assert [f for f in got if f not in EXTRA_FIELDS.get(name, ())] \
                == [f[0] for f in spec["fields"]], name
        else:
            got = [p for p in _params(obj.__init__)
                   if p not in EXTRA_INIT.get(name, ())]
            assert got == [p for p in _golden_params(spec["init"])
                           if p not in MISSING_INIT.get(name, ())], name
        members = sorted(n for n, v in vars(obj).items()
                         if not n.startswith("_")
                         and (callable(v) or isinstance(v, property)))
        assert members == sorted(spec["members"]), name
