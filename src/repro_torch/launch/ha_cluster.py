"""Crash-recoverable multi-process OCC: follower promotion + watermark
resume under a coordinator (§14).

The port's copy of `repro/launch/ha_cluster.py`.  Nodes and workers run on
the card unless the caller asks for the CPU (`--device cpu`); the driver
builds the kernel libraries before it spawns anyone.

`run_ha_cluster` grows `launch/occ_cluster.py`'s topology into a
highly-available one: R node processes (one master + R-1 socket-replicated
follower stores) and P propose workers, all brokered by a tiny coordinator
in the driver process that speaks only CTRL frames:

  * node 0 is PROMOTEd to master with term 1: it runs the serializing
    epoch loop (`OCCEngine.run_from_proposals` over a `_WorkerPlane`),
    publishes every epoch's pool delta through a `ReplicationServer`, and
    blocks each commit on `wait_acked` — the per-epoch replication
    barrier that makes the commit watermark exact;
  * when the master dies (chaos: a `FaultPlan` kill at the named point
    "master.commit", i.e. `os._exit` right after version v is fully
    acked) every follower's `ReplicationClient` sees a bare EOF — no FIN
    — and reports `orphaned(version)` to the coordinator.  The follower
    with the HIGHEST replicated version (ties → lowest node id) is
    PROMOTEd with term+1;
  * the promoted node seeds its server's shadow from its own replicated
    store (`seed_shadow`), wires the store onto the new server (version
    numbering continues — `apply_delta` advanced `_next_version`), opens
    a fresh worker plane, and resumes the pass with
    `run_from_proposals(x[v*pb:], epoch_base=v, pool=watermark pool)` —
    global epoch numbering, shard addressing and publish versions
    continue exactly where the dead master stopped;
  * workers outlive the master: on EOF they ask the coordinator
    "who is master with term > the one I lost?" (blocking CTRL query),
    reconnect to the new worker plane, take the promoted master's rebase
    broadcast, and keep proposing.  Stale-term frames are fenced at both
    workers and followers, so a zombie master cannot corrupt anyone;
  * every master exports each epoch's outputs BEFORE committing it: a
    sha256 digest of the (assign, send) block plus the epoch's OCCStats
    scalars, sent to the coordinator as CTRL "epoch" records.  The
    coordinator replays the uninterrupted single-process reference and
    checks every epoch digest, every stats triple, the final store digest
    and every surviving follower's digest — the whole killed-and-promoted
    run must be BIT-IDENTICAL to a run where nothing ever failed.

  PYTHONPATH=src python -m repro_torch.launch.ha_cluster --quick \
      --nodes 3 --workers 2 --kill-after 6 --device cpu
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import os
import socket
import tempfile
import threading
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.obs import Obs, Tracer, merge_traces
from repro_torch.obs.metrics import now

__all__ = ["HAConfig", "run_ha_cluster", "ha_node_main", "ha_worker_main",
           "main"]


@dataclass
class HAConfig:
    n: int = 2048
    dim: int = 8
    lam: float = 3.0
    k_max: int = 128
    pb: int = 64                # points per epoch (split across workers)
    n_workers: int = 2
    n_nodes: int = 3            # 1 master + n_nodes-1 follower replicas
    validate_cap: int | None = None
    seed: int = 0
    model: str = "occ"
    snapshot_capacity: int = 256
    max_queue: int = 1024       # follower backpressure bound (§14)
    # chaos: SIGKILL-equivalent (os._exit 137) the term-1 master right
    # after version v is fully acked by every follower — the promotion
    # watermark is then exactly v, making the whole test deterministic.
    kill_master_after_version: int | None = None
    spawn_timeout_s: float = 180.0
    out_path: str | None = None
    # telemetry: every master phase appends its publishes to a DeltaWAL
    # under wal_dir; each process writes trace_dir/<proc>.json and the
    # driver merges them into trace_out (one Perfetto timeline — valid
    # because CLOCK_MONOTONIC is system-wide on Linux).
    wal_dir: str | None = None
    trace_dir: str | None = None
    trace_out: str | None = None
    quiet: bool = False
    device: str = "cuda"        # nodes, workers and the driver's audit

    def cluster_kw(self) -> dict:
        """The `ClusterConfig` projection every process derives its data,
        transaction and worker plane from (same seed ⇒ same points)."""
        return dict(n=self.n, dim=self.dim, lam=self.lam, k_max=self.k_max,
                    pb=self.pb, n_workers=self.n_workers, model=self.model,
                    seed=self.seed, validate_cap=self.validate_cap,
                    spawn_timeout_s=self.spawn_timeout_s, quiet=True,
                    device=self.device)


def _outputs_digest(assign_e, send_e) -> str:
    """sha256 over an epoch's raw output block — equal digests across
    processes == bit-identical epoch outputs (assign may be a tree:
    BP-means emits (pb, K) booleans; leaves hash in the JAX package's
    flatten order, so equal outputs digest equally in both packages)."""
    from repro_torch.core.occ import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(assign_e):
        h.update(np.ascontiguousarray(leaf.cpu().numpy()).tobytes())
    h.update(np.ascontiguousarray(send_e.cpu().numpy()).tobytes())
    return h.hexdigest()


def _send_ctrl(sock: socket.socket, op: str, **fields) -> None:
    from repro_torch.distributed.protocol import ctrl_frame, write_frame
    write_frame(sock, ctrl_frame(op, **fields))


def _read_ctrl(sock: socket.socket) -> dict | None:
    from repro_torch.distributed.protocol import CTRL, read_frame
    fr = read_frame(sock)
    if fr is None:
        return None
    ftype, meta, _ = fr
    if ftype != CTRL:
        raise ValueError(f"expected CTRL frame, got type {ftype}")
    return meta


# ----------------------------------------------------------------- node side

def ha_node_main(cfg_kw: dict, node_id: int, coord_port: int) -> None:
    """One HA node process: follower by default, master when promoted.

    The node holds ONE delta-mode `SnapshotStore` for its whole life — as
    a follower it is the replication target; after a promotion the SAME
    store becomes the primary (its `_next_version` already continues the
    dead master's numbering).  The coordinator drives the node through
    CTRL directives: follow (tail a master; report `orphaned` on bare EOF
    or `report` after an orderly FIN), promote (run the master phase), and
    exit.
    """
    from repro_torch.distributed.protocol import hello_frame, write_frame
    from repro_torch.distributed.transport import (ReplicationClient,
                                                   store_digest)
    from repro_torch.serving.snapshot import SnapshotStore

    cfg = HAConfig(**cfg_kw)
    obs = Obs()
    if cfg.trace_dir is not None:
        obs = Obs(tracer=Tracer(f"ha.node{node_id}"),
                  trace_path=os.path.join(cfg.trace_dir,
                                          f"node{node_id}.json"))
    store = SnapshotStore(capacity=cfg.snapshot_capacity, delta=True,
                          model=cfg.model, device=cfg.device)
    coord = socket.create_connection(("127.0.0.1", coord_port), timeout=30.0)
    coord.settimeout(None)
    write_frame(coord, hello_frame("node", cfg.model, worker=node_id))
    try:
        while True:
            msg = _read_ctrl(coord)
            if msg is None or msg["op"] == "exit":
                return
            if msg["op"] == "follow":
                term = int(msg["term"])
                client = ReplicationClient(
                    ("127.0.0.1", int(msg["port"])), model=cfg.model,
                    store=store, term=term, obs=obs)
                try:
                    client.connect()
                    client.run()
                except OSError:
                    pass
                meta = store.latest_meta()
                have = 0 if meta is None else meta.version
                if client.fin_reason is not None:   # orderly end of pass
                    _send_ctrl(coord, "report", node=node_id,
                               digest=store_digest(store), version=have,
                               versions=store.versions(),
                               bootstrapped=client.bootstrapped,
                               n_fenced=client.n_fenced,
                               n_duplicates=client.n_duplicates)
                else:                               # bare EOF: §14 orphaned
                    obs.instant("ha.orphaned", cat="ha", node=node_id,
                                version=have, term=term)
                    _send_ctrl(coord, "orphaned", node=node_id,
                               version=have, term=term)
            elif msg["op"] == "promote":
                obs.instant("ha.promote", cat="ha", node=node_id,
                            term=int(msg["term"]))
                _master_phase(cfg, store, int(msg["term"]),
                              int(msg["n_followers"]), coord, node_id, obs)
    finally:
        obs.flush()
        try:
            coord.close()
        except OSError:
            pass


def _master_phase(cfg: HAConfig, store, term: int, n_followers: int,
                  coord: socket.socket, node_id: int,
                  obs: Obs | None = None) -> None:
    """Run (or resume) the serializing master on this node.

    Resume point v = the store's latest version: versions 1..v hold
    epochs 0..v-1, so the remaining points are x[v*pb:] driven with
    epoch_base=v.  The first worker broadcast is a rebase delta (the
    workers' replicas descend from a dead master's stream) and every
    outbound frame carries `term` for fencing.
    """
    from repro_torch.core.engine import OCCEngine
    from repro_torch.core.occ import block_epochs
    from repro_torch.distributed.fault import FaultPlan, FaultRule
    from repro_torch.distributed.transport import (ReplicationServer,
                                                   store_digest)
    from repro_torch.launch.occ_cluster import (
        ClusterConfig, _ClusterProposer, _WorkerPlane, _cluster_data,
        _cluster_txn)

    ccfg = ClusterConfig(**cfg.cluster_kw())
    x = _cluster_data(ccfg)
    txn = _cluster_txn(ccfg)
    t_total = block_epochs(cfg.n, cfg.pb)
    obs = obs if obs is not None else Obs()

    fault = None
    if cfg.kill_master_after_version is not None and term == 1:
        # the plan carries obs: the kill flushes this node's trace file
        # first, so the victim's timeline survives os._exit
        fault = FaultPlan(
            rules=[FaultRule("master.commit", "kill",
                             nth=cfg.kill_master_after_version)],
            allow_kill=True, obs=obs)

    meta = store.latest_meta()
    v = 0 if meta is None else meta.version
    srv = ReplicationServer(term=term, max_queue=cfg.max_queue, obs=obs,
                            device=cfg.device)
    if v:
        srv.seed_shadow(cfg.model, store)   # bootstrap joiners from history
    wal = None
    if cfg.wal_dir is not None:
        # each (node, term) master phase logs its publishes durably; the
        # per-term directory keeps a promoted master's log separate from
        # the stream it inherited
        from repro_torch.checkpoint.wal import DeltaWAL, WireTee
        wal = DeltaWAL(os.path.join(cfg.wal_dir,
                                    f"node{node_id}_term{term}"),
                       model=cfg.model, obs=obs, device=cfg.device)
        if v:
            # seed the fresh log with the inherited watermark as a rebase
            # frame: replay starts from this image, and the WAL shadow is
            # primed for the first (non-rebase) post-promotion delta
            wal.send(store.bootstrap_delta())
        store.wire = WireTee(srv, wal)
    else:
        store.wire = srv
    plane = _WorkerPlane(ccfg)
    _send_ctrl(coord, "serving", node=node_id, term=term,
               repl_port=srv.address[1], worker_port=plane.port, watermark=v)
    plane.accept_workers()
    # deterministic start: every follower attached before epoch v runs, so
    # the per-epoch ack barrier really covers all R-1 replicas
    deadline = time.monotonic() + cfg.spawn_timeout_s
    while (srv.followers(cfg.model) < n_followers
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert srv.followers(cfg.model) == n_followers, "follower attach"

    pool = None if v == 0 else store.latest().to_pool(cfg.k_max)
    engine = OCCEngine(txn, pb=cfg.pb, validate_cap=cfg.validate_cap,
                       obs=obs, device=cfg.device)
    proposer = _ClusterProposer(ccfg, txn, plane, term=term,
                                rebase_first=v > 0)

    def on_outputs(ge, ae, sde, stats):
        ns, na, ce = stats
        _send_ctrl(coord, "epoch", node=node_id, term=term, epoch=ge,
                   digest=_outputs_digest(ae, sde),
                   proposed=int(ns), accepted=int(na), cap=int(ce))

    def on_commit(pool_c, ge, t_epochs):
        store.publish_pool(pool_c, n_seen=min(cfg.n, (ge + 1) * cfg.pb),
                           epochs=ge + 1)
        assert srv.wait_acked(ge + 1, cfg.model,
                              timeout=cfg.spawn_timeout_s), "ack barrier"
        if fault is not None:
            # §14 chaos: the kill fires HERE — after version ge+1 is fully
            # replicated — so every follower's watermark is exactly ge+1
            # and the promotion outcome is pinned, not racy.
            fault.at("master.commit")

    res = engine.run_from_proposals(
        x[v * cfg.pb:], proposer, pool=pool, epoch_base=v,
        on_commit=on_commit, on_outputs=on_outputs)
    plane.close()
    _send_ctrl(coord, "done", node=node_id, term=term, epochs=t_total,
               resumed_from=v, k=int(res.pool.count),
               digest=store_digest(store),
               worker_deaths={str(w): e for w, e
                              in proposer.dead_from.items()},
               metrics=srv.metrics(),
               worker_reports=[plane.reports.get(w)
                               for w in range(cfg.n_workers)],
               wal=None if wal is None else wal.dir)
    srv.close()     # FIN → followers write their reports
    if wal is not None:
        wal.close()
    obs.flush()


# --------------------------------------------------------------- worker side

def _query_master(coord_port: int, min_term: int,
                  timeout: float = 30.0) -> dict | None:
    """Blocking who-is-master CTRL query: the coordinator answers once a
    master with term >= min_term is serving (None/port=None ⇒ shut down)."""
    try:
        s = socket.create_connection(("127.0.0.1", coord_port),
                                     timeout=timeout)
    except OSError:
        return None
    try:
        s.settimeout(None)
        _send_ctrl(s, "get_master", min_term=min_term)
        return _read_ctrl(s)
    except (ConnectionError, OSError, ValueError):
        return None
    finally:
        s.close()


def ha_worker_main(cfg_kw: dict, worker_id: int, coord_port: int) -> None:
    """A propose worker that OUTLIVES its master (§14): serve the current
    master until FIN (pass complete → exit) or EOF (master died →
    re-discover).  After an EOF the worker insists on term strictly above
    the one it lost, so it can never reconnect to a zombie."""
    from repro_torch.distributed.protocol import hello_frame, write_frame
    from repro_torch.launch.occ_cluster import (ClusterConfig, _serve_master,
                                                _worker_inputs)

    cfg = ClusterConfig(**HAConfig(**cfg_kw).cluster_kw())
    txn, xp, sp = _worker_inputs(cfg)
    stats: dict = {}
    replica = dict(centers=np.zeros((cfg.k_max, cfg.dim), np.float32),
                   count=0, term=0)
    min_term = 1
    while True:
        info = _query_master(coord_port, min_term)
        if info is None or info.get("port") is None:
            return
        try:
            sock = socket.create_connection(
                ("127.0.0.1", int(info["port"])), timeout=30.0)
        except OSError:
            time.sleep(0.05)    # promoted master not accepting yet
            continue
        sock.settimeout(None)
        write_frame(sock, hello_frame("worker", cfg.model, worker=worker_id,
                                      term=int(info["term"])))
        replica["term"] = max(replica["term"], int(info["term"]))
        if _serve_master(sock, cfg, worker_id, txn, xp, sp, replica,
                         stats) == "fin":
            return
        min_term = replica["term"] + 1


# -------------------------------------------------------------- coordinator

class _Coordinator:
    """The control plane: one listening socket, persistent per-node
    connections (HELLO role="node"), and ephemeral worker queries
    (CTRL get_master).  All shared state lives behind one condition
    variable; the orchestration policy itself runs in `run_ha_cluster`."""

    def __init__(self, cfg: HAConfig, obs: Obs | None = None):
        self.cfg = cfg
        self.obs = obs if obs is not None else Obs()
        self.cv = threading.Condition(threading.RLock())
        self.lsock = socket.create_server(("127.0.0.1", 0))
        self.port = self.lsock.getsockname()[1]
        self.nodes: dict[int, socket.socket] = {}
        self.node_alive: dict[int, bool] = {}
        self.master: dict | None = None     # node/term/repl_port/worker_port
        self.orphans: dict[int, int] = {}   # node → watermark (current term)
        self.epochs: dict[int, dict] = {}   # epoch → digest/stats record
        self.done: dict | None = None
        self.reports: dict[int, dict] = {}
        self.shutdown = False
        threading.Thread(target=self._accept, name="coord-accept",
                         daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self.lsock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(sock,),
                             name="coord-conn", daemon=True).start()

    def _serve(self, sock: socket.socket) -> None:
        from repro_torch.distributed.protocol import CTRL, HELLO, read_frame
        try:
            fr = read_frame(sock)
            if fr is None:
                sock.close()
                return
            ftype, meta, _ = fr
            if ftype == HELLO and meta.get("role") == "node":
                nid = int(meta["worker"])
                with self.cv:
                    self.nodes[nid] = sock
                    self.node_alive[nid] = True
                    self.cv.notify_all()
                self._node_reader(nid, sock)
            elif ftype == CTRL and meta.get("op") == "get_master":
                self._answer_get_master(sock, int(meta.get("min_term", 0)))
            elif ftype == CTRL and meta.get("op") == "metrics":
                # text-exposition endpoint: one CTRL round-trip returns the
                # driver-side registry in Prometheus text form
                _send_ctrl(sock, "metrics",
                           text=self.obs.metrics.exposition())
                sock.close()
            else:
                sock.close()
        except (ConnectionError, OSError, ValueError):
            try:
                sock.close()
            except OSError:
                pass

    def _answer_get_master(self, sock: socket.socket, min_term: int) -> None:
        deadline = time.monotonic() + self.cfg.spawn_timeout_s
        with self.cv:
            while (not self.shutdown
                   and (self.master is None
                        or self.master["term"] < min_term)):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self.cv.wait(min(left, 0.2))
            info = (None if (self.shutdown or self.master is None
                             or self.master["term"] < min_term)
                    else dict(self.master))
        if info is None:
            _send_ctrl(sock, "master", port=None, term=0)
        else:
            _send_ctrl(sock, "master", port=info["worker_port"],
                       term=info["term"])
        sock.close()

    def _node_reader(self, nid: int, sock: socket.socket) -> None:
        from repro_torch.distributed.protocol import CTRL, read_frame
        try:
            while True:
                fr = read_frame(sock)
                if fr is None:
                    break
                ftype, meta, _ = fr
                if ftype != CTRL:
                    continue
                op = meta.get("op")
                with self.cv:
                    if op == "serving":
                        self.master = dict(
                            node=nid, term=int(meta["term"]),
                            repl_port=int(meta["repl_port"]),
                            worker_port=int(meta["worker_port"]),
                            watermark=int(meta.get("watermark", 0)))
                        self.orphans = {}
                    elif op == "orphaned":
                        self.orphans[nid] = int(meta["version"])
                    elif op == "epoch":
                        e, t = int(meta["epoch"]), int(meta["term"])
                        prev = self.epochs.get(e)
                        if prev is None or t >= prev["term"]:
                            self.epochs[e] = dict(
                                term=t, node=nid, digest=meta["digest"],
                                proposed=int(meta["proposed"]),
                                accepted=int(meta["accepted"]),
                                cap=int(meta["cap"]))
                    elif op == "done":
                        self.done = dict(meta, node=nid)
                    elif op == "report":
                        self.reports[nid] = dict(meta)
                    self.cv.notify_all()
        except (ConnectionError, OSError, ValueError):
            pass
        with self.cv:
            self.node_alive[nid] = False
            self.cv.notify_all()

    def send_to(self, nid: int, op: str, **fields) -> None:
        _send_ctrl(self.nodes[nid], op, **fields)

    def wait(self, pred, what: str) -> None:
        deadline = time.monotonic() + self.cfg.spawn_timeout_s
        with self.cv:
            while not pred():
                left = deadline - time.monotonic()
                assert left > 0, f"coordinator timeout waiting for {what}"
                self.cv.wait(min(left, 0.2))

    def close(self) -> None:
        with self.cv:
            self.shutdown = True
            self.cv.notify_all()
        for sock in [self.lsock, *self.nodes.values()]:
            try:
                sock.close()
            except OSError:
                pass


def run_ha_cluster(cfg: HAConfig) -> dict:
    """Run the HA topology (with the configured master kill) and audit it
    against the uninterrupted single-process pass; returns the record (and
    raises AssertionError when the audit fails)."""
    from repro_torch._device import resolve_device
    from repro_torch.checkpoint.wal import recover_wal
    from repro_torch.core.engine import OCCEngine
    from repro_torch.core.occ import block_epochs
    from repro_torch.distributed.transport import store_digest
    from repro_torch.launch.occ_cluster import (
        ClusterConfig, _build_kernels, _cluster_data, _cluster_txn)
    from repro_torch.serving.snapshot import SnapshotStore

    assert cfg.n_nodes >= 2, "HA needs a master and at least one follower"
    assert cfg.pb % cfg.n_workers == 0, "pb must split evenly across workers"
    t_total = block_epochs(cfg.n, cfg.pb)
    if cfg.kill_master_after_version is not None:
        assert 1 <= cfg.kill_master_after_version < t_total, \
            "kill version must land mid-pass"
    dev = resolve_device(cfg.device)
    _build_kernels(dev)
    t0 = now()

    # Telemetry plumbing: --trace-out implies a per-process trace_dir (and
    # a WAL dir — a traced run exercises every subsystem, so the merged
    # timeline carries engine, transport, wal, fault AND ha events).
    trace_dir = cfg.trace_dir
    if cfg.trace_out is not None and trace_dir is None:
        trace_dir = tempfile.mkdtemp(prefix="ha_trace_")
    wal_dir = cfg.wal_dir
    if cfg.trace_out is not None and wal_dir is None:
        wal_dir = tempfile.mkdtemp(prefix="ha_wal_")
    driver_obs = Obs()
    if trace_dir is not None:
        driver_obs = Obs(tracer=Tracer("ha.driver"),
                         trace_path=os.path.join(trace_dir, "driver.json"))

    coord = _Coordinator(cfg, obs=driver_obs)
    ctx = mp.get_context("spawn")
    cfg_kw = {**cfg.__dict__, "out_path": None, "trace_out": None,
              "trace_dir": trace_dir, "wal_dir": wal_dir}
    node_procs = [ctx.Process(target=ha_node_main,
                              args=(cfg_kw, i, coord.port), daemon=True)
                  for i in range(cfg.n_nodes)]
    for p in node_procs:
        p.start()
    coord.wait(lambda: len(coord.nodes) == cfg.n_nodes, "node registration")

    promotions = 0
    terms = [1]
    coord.send_to(0, "promote", term=1, n_followers=cfg.n_nodes - 1)
    coord.wait(lambda: coord.master is not None
               and coord.master["term"] == 1, "term-1 master serving")
    for i in range(1, cfg.n_nodes):
        coord.send_to(i, "follow", port=coord.master["repl_port"], term=1)

    worker_procs = [ctx.Process(target=ha_worker_main,
                                args=(cfg_kw, w, coord.port), daemon=True)
                    for w in range(cfg.n_workers)]
    for p in worker_procs:
        p.start()

    resume_epoch = None
    while True:
        def phase():
            if coord.done is not None:
                return "done"
            m = coord.master
            live = [nid for nid, ok in coord.node_alive.items() if ok]
            if (m is not None and not coord.node_alive.get(m["node"], False)
                    and live and all(nid in coord.orphans for nid in live)):
                return "promote"
            return ""
        coord.wait(lambda: phase() != "", "master completion or death")
        if phase() == "done":
            break
        # ------------------------------------------------- §14 promotion
        with coord.cv:
            orphans = dict(coord.orphans)
            old_term = coord.master["term"]
        # highest replicated watermark wins; ties break to the lowest id
        winner = max(orphans, key=lambda nid: (orphans[nid], -nid))
        resume_epoch = orphans[winner]
        new_term = old_term + 1
        promotions += 1
        terms.append(new_term)
        driver_obs.metrics.counter("ha_promotions").inc()
        driver_obs.instant("ha.promote", cat="ha", winner=winner,
                           term=new_term, watermark=resume_epoch)
        if not cfg.quiet:
            print(f"master (term {old_term}) died; promoting node {winner} "
                  f"at watermark {resume_epoch} with term {new_term}")
        coord.send_to(winner, "promote", term=new_term,
                      n_followers=len(orphans) - 1)
        coord.wait(lambda: coord.master is not None
                   and coord.master["term"] == new_term,
                   "promoted master serving")
        for nid in orphans:
            if nid != winner:
                coord.send_to(nid, "follow",
                              port=coord.master["repl_port"], term=new_term)

    final_master = coord.done["node"]
    expected_reports = [nid for nid, ok in coord.node_alive.items()
                        if ok and nid != final_master]
    coord.wait(lambda: all(nid in coord.reports for nid in expected_reports),
               "follower reports")
    with coord.cv:
        for nid, ok in coord.node_alive.items():
            if ok:
                coord.send_to(nid, "exit")
    for p in [*node_procs, *worker_procs]:
        p.join(timeout=30.0)
    coord.close()
    # Only the killed master may end other than cleanly (os._exit 137).
    killed_nodes = {0} if cfg.kill_master_after_version is not None else set()
    exit_ok = ([p.exitcode for p in worker_procs] == [0] * cfg.n_workers
               and [p.exitcode for p in node_procs]
               == [137 if i in killed_nodes else 0
                   for i in range(cfg.n_nodes)])

    if trace_dir is not None:
        driver_obs.flush()
        if cfg.trace_out is not None:
            # one merged Perfetto timeline: driver + every node (including
            # the killed master — its FaultPlan flushed before os._exit)
            parts = sorted(os.path.join(trace_dir, f)
                           for f in os.listdir(trace_dir)
                           if f.endswith(".json"))
            merge_traces(cfg.trace_out, *parts)

    # --------------------------------------------------------------- audit
    # The uninterrupted single-process reference: same per-epoch digests,
    # same stats, same published store — computed in THIS process.
    ccfg = ClusterConfig(**cfg.cluster_kw())
    x = _cluster_data(ccfg)
    txn = _cluster_txn(ccfg)
    ref_store = SnapshotStore(capacity=cfg.snapshot_capacity, delta=True,
                              model=cfg.model, device=dev)
    ref_digests: dict[int, str] = {}
    ref_stats: dict[int, tuple] = {}

    def ref_outputs(e, ae, sde, st):
        ref_digests[e] = _outputs_digest(ae, sde)
        ref_stats[e] = (int(st[0]), int(st[1]), int(st[2]))

    def ref_commit(pool, e, t):
        ref_store.publish_pool(pool, n_seen=min(cfg.n, (e + 1) * cfg.pb),
                               epochs=e + 1)

    OCCEngine(txn, pb=cfg.pb, validate_cap=cfg.validate_cap, device=dev) \
        .run_from_proposals(x, on_commit=ref_commit, on_outputs=ref_outputs)

    epoch_digests_match = (
        sorted(coord.epochs) == list(range(t_total))
        and all(coord.epochs[e]["digest"] == ref_digests[e]
                for e in coord.epochs))
    epoch_stats_match = epoch_digests_match and all(
        (coord.epochs[e]["proposed"], coord.epochs[e]["accepted"],
         coord.epochs[e]["cap"]) == ref_stats[e] for e in coord.epochs)
    ref_digest = store_digest(ref_store)
    final_digest_match = (coord.done["digest"] == ref_digest
                          and int(coord.done["k"])
                          == int(ref_store.latest_meta().count))
    follower_digests_match = [r["digest"] == ref_digest
                              for r in coord.reports.values()]
    overlap = [e for e, rec in coord.epochs.items()
               if resume_epoch is not None and rec["term"] > 1
               and e < resume_epoch]
    # The final master's durable log rebuilds its final store.
    wal_digest_match = wal_recover_s = None
    if coord.done.get("wal") is not None:
        tw = now()
        wal_store, _ = recover_wal(coord.done["wal"], model=cfg.model,
                                   capacity=cfg.snapshot_capacity, device=dev)
        wal_digest_match = store_digest(wal_store) == ref_digest
        wal_recover_s = now() - tw

    record = {
        "bench": "ha",
        "n": cfg.n, "dim": cfg.dim, "pb": cfg.pb,
        "workers": cfg.n_workers, "nodes": cfg.n_nodes,
        "epochs": t_total,
        "k_final": int(coord.done["k"]),
        "promotions": promotions,
        "terms": terms,
        "kill_version": cfg.kill_master_after_version,
        "resume_epoch": resume_epoch,
        "master_node_final": final_master,
        "epoch_digests_match": epoch_digests_match,
        "epoch_stats_match": epoch_stats_match,
        "final_digest_match": final_digest_match,
        "follower_digests_match": follower_digests_match,
        "recomputed_overlap_epochs": overlap,
        "worker_deaths": coord.done.get("worker_deaths", {}),
        "final_term_metrics": coord.done.get("metrics", {}),
        "final_term_worker_reports": coord.done.get("worker_reports"),
        "wal_digest_match": wal_digest_match,
        "wal_recover_s": wal_recover_s,
        "exit_codes_ok": exit_ok,
        "device": str(dev),
        "trace_out": cfg.trace_out,
        "wall_s": now() - t0,
    }
    assert epoch_digests_match, "per-epoch outputs diverged from reference"
    assert epoch_stats_match, "per-epoch OCCStats diverged from reference"
    assert final_digest_match, "final store digest diverged from reference"
    assert follower_digests_match and all(follower_digests_match), \
        "a surviving follower's store diverged"
    assert wal_digest_match is not False, \
        "the final master's WAL does not recover its store"
    assert exit_ok, "a worker or node process failed"
    if cfg.kill_master_after_version is not None:
        assert promotions == 1, "the master kill did not trigger promotion"
        assert resume_epoch == cfg.kill_master_after_version, (
            f"promotion watermark {resume_epoch} != acked kill version "
            f"{cfg.kill_master_after_version}")
    if cfg.out_path is not None:
        with open(cfg.out_path, "w") as f:
            json.dump(record, f, indent=2)
    if not cfg.quiet:
        print(f"{cfg.n_nodes} nodes x {cfg.n_workers} workers, "
              f"{t_total} epochs -> K={record['k_final']} "
              f"(promotions={promotions}, terms={terms}, "
              f"resume@{resume_epoch})")
        print(f"bit-identical to uninterrupted single-process pass: "
              f"{epoch_digests_match and final_digest_match}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--pb", type=int, default=64)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--kill-after", type=int, default=None,
                    help="kill the term-1 master after this acked version")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizes (numbers not meaningful)")
    ap.add_argument("--out", default=None, help="write BENCH_ha.json here")
    ap.add_argument("--trace-out", default=None,
                    help="merged Perfetto/Chrome trace JSON of all "
                         "processes (implies WAL + per-process tracing)")
    ap.add_argument("--wal-dir", default=None,
                    help="append every master publish to a DeltaWAL here")
    ap.add_argument("--device", default="cuda",
                    help="where nodes and workers run (cuda or cpu)")
    args = ap.parse_args(argv)
    cfg = HAConfig(n=args.n, dim=args.dim, pb=args.pb,
                   n_workers=args.workers, n_nodes=args.nodes,
                   kill_master_after_version=args.kill_after,
                   out_path=args.out, trace_out=args.trace_out,
                   wal_dir=args.wal_dir, device=args.device)
    if args.quick:
        cfg = HAConfig(n=1024, dim=8, pb=64, k_max=128, lam=3.0,
                       n_workers=args.workers, n_nodes=args.nodes,
                       kill_master_after_version=args.kill_after,
                       out_path=args.out, trace_out=args.trace_out,
                       wal_dir=args.wal_dir, device=args.device)
    run_ha_cluster(cfg)


if __name__ == "__main__":
    main()
