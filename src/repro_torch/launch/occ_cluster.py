"""Multi-process OCC: sharded propose workers + serializing master (§13).

The port's copy of `repro/launch/occ_cluster.py`: the paper's P-machine
experiment as real OS processes, on the card unless the caller asks for
the CPU (`--device cpu`).  A master process drives
`OCCEngine.run_from_proposals`; P spawned worker processes each hold a
bit-exact replica of the center pool (tailed from the master's per-epoch
DELTA broadcasts) and run the optimistic `propose` phase on a disjoint
contiguous shard of every epoch — on the card that is the `dpmeans_assign`
kernel.  Proposal blocks stream back as PROPOSE frames (each tensor leaf as
`.cpu().numpy()`); the master turns them back into tensors on its device in
worker order (== global index order), runs the one true precomputed
validator, commits the epoch, and publishes the pool delta — to the workers
(training plane) and to any number of socket-connected follower stores via
`ReplicationServer` (replication plane, with acks and snapshot bootstrap
for late joiners).

A row's nearest-center result does not depend on the rows beside it (the
kernel's rows are independent on the card; the plain version's matmul
gives each row the same bits at shard and epoch width on the CPU, pinned in
tests/test_torch_cluster.py), and the master's per-epoch finish is the
fused pass's epoch body, so the whole multi-process run is bit-identical
to the single-process `OCCEngine.run` on the same data — final centers,
per-point assignments, `OCCStats`, and every follower's snapshot store.
The driver audits all of that and reports delta bytes a publish and the
replication ack latency p50/p99.

Every process is spawned (never forked: the master holds a CUDA context),
and the master builds the kernel libraries before it spawns anyone, so the
workers only load them.

Failure semantics:
  * a worker that dies mid-epoch is detected by socket EOF (belt:
    `fault.HeartbeatTracker` timeout for hangs); its shard is masked
    invalid from that epoch on and the master completes every epoch with
    the survivors' proposals.  Only the configured chaos death
    (`die_worker` / `die_epoch`, exit code 3) passes the audit: a worker
    that exits any other way (a kernel that does not load, say) fails it;
  * a follower killed mid-publish simply drops off the ack set; a
    replacement follower bootstraps from a SNAPSHOT frame and tails to
    the same bit-identical store.

  PYTHONPATH=src python -m repro_torch.launch.occ_cluster --workers 4
  PYTHONPATH=src python -m repro_torch.launch.occ_cluster --quick \\
      --workers 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import socket
import statistics
import tempfile
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ClusterConfig", "run_cluster", "worker_main", "main"]

# The exit code of the configured chaos death (`die_worker`).
_DIE_EXIT = 3


@dataclass
class ClusterConfig:
    n: int = 4096
    dim: int = 16
    lam: float = 4.0
    k_max: int = 256
    pb: int = 128               # points per epoch (split across workers)
    n_workers: int = 2
    n_followers: int = 1        # followers connected before epoch 0
    validate_cap: int | None = None
    seed: int = 0
    model: str = "occ"
    snapshot_capacity: int = 256    # ring >= epochs+1: version lists compare
    late_follower: bool = True      # spawn one follower mid-run (bootstrap)
    late_join_frac: float = 0.5     # ...after this fraction of the epochs
    worker_timeout_s: float = 120.0  # heartbeat timeout (EOF detects deaths)
    spawn_timeout_s: float = 120.0   # worker connect + follower join budget
    straggler_threshold: float = 3.0  # epoch slower than this x EWMA → event
    straggler_warmup: int = 3        # ignore the first epochs
    # chaos knobs (tests/test_torch_cluster.py pins their outcomes)
    die_worker: int | None = None    # this worker exits without proposing...
    die_epoch: int | None = None     # ...upon receiving STEP for this epoch
    kill_follower_at_epoch: int | None = None  # SIGKILL follower 0 here and
    #                                            respawn a fresh one after
    out_path: str | None = None
    trace_out: str | None = None    # master-side Perfetto JSON
    quiet: bool = False
    device: str = "cuda"            # master, workers and followers


def _cluster_data(cfg: ClusterConfig) -> np.ndarray:
    """Deterministic per-config dataset — every process regenerates the
    same points from (n, seed, dim), so no training data travels on the
    wire (shards are index ranges, exactly the paper's setup)."""
    from repro_torch.data import dp_stick_breaking_data
    x, _, _ = dp_stick_breaking_data(cfg.n, seed=cfg.seed, dim=cfg.dim)
    return x


def _cluster_txn(cfg: ClusterConfig):
    from repro_torch.core.dp_means import DPMeansTransaction
    return DPMeansTransaction(cfg.lam, cfg.k_max)


def _padded_epochs(cfg: ClusterConfig, x: torch.Tensor, state):
    """(t, x, state) padded with zero rows to t*pb — the engine's exact
    epoch partition, recomputed identically by master and every worker."""
    from repro_torch.core.occ import block_epochs, tree_map
    n = x.shape[0]
    t = block_epochs(n, cfg.pb)
    pad = t * cfg.pb - n

    def zp(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], 0)
    return t, zp(x), tree_map(zp, state)


def _build_kernels(device: torch.device) -> None:
    """Build the kernel libraries before any process is spawned, so the
    workers only load them (no nvcc races on one source)."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(["dpmeans_assign"])


# --------------------------------------------------------------- worker side

def _serve_master(sock: socket.socket, cfg: ClusterConfig, worker_id: int,
                  txn, xp: torch.Tensor, sp, replica: dict,
                  stats: dict | None = None) -> str:
    """Serve ONE master connection until FIN ("fin") or a broken stream
    ("eof" — the §14 orphaned signal for the HA worker's reconnect loop).

    `replica` (centers ndarray / count / term) persists across calls so a
    reconnecting HA worker keeps its pool between masters; a promoted
    master's first broadcast is a rebase delta that resets it anyway.
    Term fencing (§14): DELTA/SNAPSHOT/STEP frames below the replica's
    known term are zombie-master traffic and are ignored outright.

    `stats` (kept across calls) collects each propose's time — CUDA events
    on the card, the host clock on the CPU; on FIN the worker sends it back
    to the master in a CTRL "worker_report" frame with its
    `dpmeans_assign` launch count."""
    from repro_torch.core.occ import CenterPool, tree_leaves, tree_map
    from repro_torch.distributed.protocol import (
        DELTA, FIN, SNAPSHOT, STEP, ctrl_frame, frame_delta, propose_frame,
        read_frame, write_frame)
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import now

    stats = {} if stats is None else stats
    times = stats.setdefault("propose_ms", [])
    spb = cfg.pb // cfg.n_workers
    dev = xp.device
    centers = replica["centers"]
    arange = torch.arange(cfg.k_max, device=dev)
    try:
        while True:
            fr = read_frame(sock)
            if fr is None:
                return "eof"
            ftype, meta, arrays = fr
            if ftype in (DELTA, SNAPSHOT, STEP):
                term = int(meta.get("term", 0))
                if term < replica["term"]:
                    continue            # §14 fencing: stale-term frame
                replica["term"] = term
            if ftype in (DELTA, SNAPSHOT):
                delta = frame_delta(meta, arrays)
                if delta.rebase:
                    centers[:] = 0.0
                    replica["count"] = 0
                assert delta.start == replica["count"], \
                    "pool delta gap at worker"
                centers[delta.start:delta.count] = delta.rows
                replica["count"] = delta.count
            elif ftype == STEP:
                e = int(meta["epoch"])
                if cfg.die_epoch == e and cfg.die_worker == worker_id:
                    os._exit(_DIE_EXIT)  # hard mid-epoch death, no FIN
                count = replica["count"]
                assert int(meta["count"]) == count, "replica out of sync"
                pool = CenterPool(
                    torch.from_numpy(centers.copy()).to(dev),
                    arange < count,
                    torch.tensor(count, dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev))
                cut = slice(e * cfg.pb + worker_id * spb,
                            e * cfg.pb + (worker_id + 1) * spb)
                if dev.type == "cuda":
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                else:
                    t0 = now()
                out = txn.propose(pool, xp[cut],
                                  tree_map(lambda s: s[cut], sp))
                if dev.type == "cuda":
                    ev[1].record()
                leaves = [t.cpu().numpy() for t in tree_leaves(out)]
                times.append(ev[0].elapsed_time(ev[1]) if dev.type == "cuda"
                             else (now() - t0) * 1e3)
                write_frame(sock, propose_frame(e, worker_id, leaves))
            elif ftype == FIN:
                write_frame(sock, ctrl_frame(
                    "worker_report", worker=worker_id, epochs=len(times),
                    propose_ms=float(sum(times)),
                    propose_ms_p50=(float(statistics.median(times))
                                    if times else 0.0),
                    assign_launches=ops.ASSIGN_LAUNCHES, device=str(dev)))
                return "fin"
    except (ConnectionError, OSError):
        return "eof"
    finally:
        sock.close()


def _worker_inputs(cfg: ClusterConfig):
    """A worker's (txn, padded x, padded state) on its device."""
    from repro_torch._device import resolve_device
    dev = resolve_device(cfg.device)
    x = torch.from_numpy(_cluster_data(cfg)).to(dev)
    txn = _cluster_txn(cfg)
    _, xp, sp = _padded_epochs(cfg, x, txn.make_state(x, 0))
    return txn, xp, sp


def worker_main(cfg_kw: dict, worker_id: int, port: int) -> None:
    """One propose worker (spawned process): tail pool deltas, answer STEP
    frames with the shard propose, exit on FIN.

    The pool replica is rebuilt from broadcast deltas only — the worker
    never sees the master's pool object, yet proposes against bit-equal
    state C^{t-1} (append-only pool + prefix mask ⇒ the replica IS the
    pool).  If cfg.die_epoch targets this worker it exits hard (os._exit)
    upon the STEP, before proposing — the chaos tests' mid-epoch death.
    Any failure (a kernel that does not load, say) ends the process with a
    non-zero exit code, which fails the master's audit.
    """
    from repro_torch.distributed.protocol import hello_frame, write_frame

    cfg = ClusterConfig(**cfg_kw)
    txn, xp, sp = _worker_inputs(cfg)
    replica = dict(centers=np.zeros((cfg.k_max, cfg.dim), np.float32),
                   count=0, term=0)
    sock = socket.create_connection(("127.0.0.1", port), timeout=30.0)
    sock.settimeout(None)
    write_frame(sock, hello_frame("worker", cfg.model, worker=worker_id))
    _serve_master(sock, cfg, worker_id, txn, xp, sp, replica)


# --------------------------------------------------------------- master side

class _WorkerPlane:
    """Master end of the training plane: P worker sockets, a reader thread
    per worker filling the per-epoch inbox, EOF + heartbeat liveness, and
    the workers' final reports."""

    def __init__(self, cfg: ClusterConfig):
        from repro_torch.distributed.fault import HeartbeatTracker
        self.cfg = cfg
        self.lsock = socket.create_server(("127.0.0.1", 0))
        self.port = self.lsock.getsockname()[1]
        self.conns: dict[int, socket.socket] = {}
        self.alive = [True] * cfg.n_workers
        self.inbox: dict[tuple[int, int], list[np.ndarray]] = {}
        self.reports: dict[int, dict] = {}
        self.cv = threading.Condition()
        self.hb = HeartbeatTracker(timeout=cfg.worker_timeout_s)
        self.procs: list[mp.process.BaseProcess] = []
        self._readers: list[threading.Thread] = []

    def start(self) -> None:
        """Start the worker processes; they connect when they are ready
        (`accept_workers` takes them), so their start-up overlaps the
        followers'."""
        ctx = mp.get_context("spawn")
        cfg_kw = {**self.cfg.__dict__, "out_path": None}
        for w in range(self.cfg.n_workers):
            p = ctx.Process(target=worker_main, args=(cfg_kw, w, self.port),
                            daemon=True)
            p.start()
            self.procs.append(p)

    def accept_workers(self) -> None:
        """Accept `n_workers` HELLO handshakes — from children this plane
        spawned, or from §14 HA workers reconnecting to a promoted master
        (the plane does not care who started them)."""
        from repro_torch.distributed.protocol import HELLO, read_frame
        self.lsock.settimeout(self.cfg.spawn_timeout_s)
        for _ in range(self.cfg.n_workers):
            sock, _addr = self.lsock.accept()
            sock.settimeout(None)
            fr = read_frame(sock)
            assert fr is not None and fr[0] == HELLO, "bad worker handshake"
            wid = int(fr[1]["worker"])
            self.conns[wid] = sock
            self.hb.beat(wid)
            t = threading.Thread(target=self._reader, args=(wid, sock),
                                 name=f"worker-rx-{wid}", daemon=True)
            t.start()
            self._readers.append(t)

    def _reader(self, wid: int, sock: socket.socket) -> None:
        from repro_torch.distributed.protocol import CTRL, PROPOSE, read_frame
        try:
            while True:
                fr = read_frame(sock)
                if fr is None:
                    break
                ftype, meta, arrays = fr
                if ftype == PROPOSE:
                    leaves = [arrays[f"leaf{i}"]
                              for i in range(int(meta["n_leaves"]))]
                    with self.cv:
                        self.inbox[(int(meta["epoch"]), wid)] = leaves
                        self.hb.beat(wid)
                        self.cv.notify_all()
                elif ftype == CTRL and meta.get("op") == "worker_report":
                    with self.cv:
                        self.reports[wid] = dict(meta)
        except (ConnectionError, OSError, ValueError):
            pass
        with self.cv:
            self.alive[wid] = False
            self.cv.notify_all()

    def broadcast(self, frame: bytes) -> None:
        for wid, sock in self.conns.items():
            if not self.alive[wid]:
                continue
            try:
                sock.sendall(frame)
            except OSError:
                with self.cv:
                    self.alive[wid] = False
                    self.cv.notify_all()

    def gather(self, epoch: int) -> dict[int, list[np.ndarray] | None]:
        """Block until every live worker answered `epoch` (or died — EOF is
        the fast path, the heartbeat timeout the hang backstop).  Returns
        worker → leaves, None for workers dead by/at this epoch."""
        with self.cv:
            while True:
                for wid in self.hb.dead_hosts():
                    self.alive[wid] = False     # hang backstop
                missing = [w for w in range(self.cfg.n_workers)
                           if self.alive[w] and (epoch, w) not in self.inbox]
                if not missing:
                    break
                self.cv.wait(0.05)
            return {w: self.inbox.pop((epoch, w), None)
                    for w in range(self.cfg.n_workers)}

    def close(self) -> None:
        """FIN to every worker, then wait for their reports (a worker
        sends one after FIN and closes its socket).  The processes end on
        their own; `exitcodes` waits for them."""
        from repro_torch.distributed.protocol import fin_frame
        self.broadcast(fin_frame("pass complete"))
        for t in self._readers:
            t.join(timeout=30.0)
        for sock in self.conns.values():
            try:
                sock.close()
            except OSError:
                pass
        self.lsock.close()

    def exitcodes(self) -> list[int | None]:
        """The exit codes of the workers this plane started (None for one
        still running 30 s after FIN)."""
        for p in self.procs:
            p.join(timeout=30.0)
        return [p.exitcode for p in self.procs]


class _ClusterProposer:
    """`propose_fn` for `OCCEngine.run_from_proposals`, backed by the
    worker plane: broadcast the epoch-start pool delta + STEP, gather the
    PROPOSE blocks, reassemble leaves in worker order as tensors on the
    master's device, mask dead shards."""

    def __init__(self, cfg: ClusterConfig, txn, plane: _WorkerPlane,
                 term: int = 0, rebase_first: bool = False):
        self.cfg = cfg
        self.txn = txn
        self.plane = plane
        self.term = term                # §14: stamped on every broadcast
        self.last_count = 0
        self._force_rebase = rebase_first   # promoted master: the workers'
        #   replicas come from a DEAD master's stream — rebase them first
        self._like = None               # the proposal tree's structure
        self._specs = None              # shard leaf (shape, dtype)
        self.dead_from: dict[int, int] = {}   # worker → first masked epoch

    def _structure(self, pool, x_e, state_e):
        """The proposal tree of the transaction, from its plain propose on
        zero rows on the CPU (no kernel runs; only the structure is
        used)."""
        from repro_torch.core.occ import tree_map
        cut = lambda t: t[:0].cpu()
        return self.txn.propose(tree_map(lambda t: t.cpu(), pool),
                                cut(x_e), tree_map(cut, state_e))

    def _pool_delta(self, pool, epoch: int):
        from repro_torch.serving.snapshot import CenterDelta
        count = int(pool.count)
        rebase = epoch == 0 or self._force_rebase
        self._force_rebase = False
        start = 0 if rebase else self.last_count
        self.last_count = count
        return CenterDelta(model=self.cfg.model, version=epoch, start=start,
                           rows=pool.centers[start:count].cpu().numpy(),
                           count=count, capacity=self.cfg.k_max,
                           rebase=rebase)

    def __call__(self, pool, x_e, state_e, valid_e, *, epoch, offset):
        from repro_torch.core.occ import tree_unflatten
        from repro_torch.distributed.protocol import delta_frame, step_frame
        if self._like is None:
            self._like = self._structure(pool, x_e, state_e)
        self.plane.broadcast(delta_frame(self._pool_delta(pool, epoch),
                                         term=self.term))
        self.plane.broadcast(step_frame(epoch, self.last_count,
                                        term=self.term))
        blocks = self.plane.gather(epoch)
        live = [lv for lv in blocks.values() if lv is not None]
        if live:
            self._specs = [(l.shape, l.dtype) for l in live[0]]
        if self._specs is None:
            raise RuntimeError(f"no live worker answered epoch {epoch}")
        dev = x_e.device
        cat = []
        for i, (shape, dtype) in enumerate(self._specs):
            parts = [np.zeros(shape, dtype) if blocks[w] is None
                     else blocks[w][i] for w in range(self.cfg.n_workers)]
            cat.append(torch.from_numpy(np.concatenate(parts, 0)).to(dev))
        send, payload, aux, safe = tree_unflatten(self._like, cat)
        dead = [w for w, lv in blocks.items() if lv is None]
        if dead:
            spb = self.cfg.pb // self.cfg.n_workers
            rows = torch.ones((self.cfg.pb,), dtype=torch.bool, device=dev)
            for w in dead:
                self.dead_from.setdefault(w, epoch)
                rows[w * spb:(w + 1) * spb] = False
            valid_e = valid_e & rows
        return send, payload, aux, safe, valid_e


def _masked_reference(cfg: ClusterConfig, engine, dead_from: dict[int, int]):
    """The deterministic chaos oracle: the in-process proposer with the
    SAME shard masking the master applied for dead workers."""
    base = engine.local_proposer()
    spb = cfg.pb // cfg.n_workers
    masks = {}
    for w, e0 in dead_from.items():
        rows = torch.ones((cfg.pb,), dtype=torch.bool, device=engine.device)
        rows[w * spb:(w + 1) * spb] = False
        masks[w] = (e0, rows)

    def fn(pool, x_e, state_e, valid_e, *, epoch, offset):
        s, p, a, sf, ve = base(pool, x_e, state_e, valid_e,
                               epoch=epoch, offset=offset)
        for e0, rows in masks.values():
            if epoch >= e0:
                ve = ve & rows
        return s, p, a, sf, ve
    return fn


def _span_seconds(tracer, *names: str) -> dict[str, float]:
    """Total seconds of each named span in a tracer's events."""
    out = dict.fromkeys(names, 0.0)
    for ev in tracer.events():
        if ev.get("ph") == "X" and ev.get("name") in out:
            out[ev["name"]] += ev["dur"] / 1e6
    return out


def _eq(a, b) -> bool:
    return bool(np.array_equal(a.cpu().numpy(), b.cpu().numpy()))


def run_cluster(cfg: ClusterConfig) -> dict:
    """Run the multi-process pass and audit it; returns the record (and
    raises AssertionError when the audit fails)."""
    from repro_torch._device import resolve_device
    from repro_torch.core.engine import OCCEngine
    from repro_torch.distributed.fault import StepWatchdog
    from repro_torch.distributed.transport import (ReplicationServer,
                                                   store_digest)
    from repro_torch.launch.occ_follower import follower_main
    from repro_torch.obs import Obs, Tracer
    from repro_torch.obs.metrics import now
    from repro_torch.serving.snapshot import SnapshotStore

    assert cfg.pb % cfg.n_workers == 0, "pb must split evenly across workers"
    dev = resolve_device(cfg.device)
    _build_kernels(dev)
    # ONE shared Obs for the master process: engine passes, replication and
    # the straggler watchdog land in one registry / one trace file.
    obs = Obs(tracer=Tracer("occ_cluster.master") if cfg.trace_out else None,
              trace_path=cfg.trace_out)
    t0 = now()
    x = _cluster_data(cfg)
    txn = _cluster_txn(cfg)

    # replication plane: primary store wired straight onto the socket server
    srv = ReplicationServer(obs=obs, device=dev)
    store = SnapshotStore(capacity=cfg.snapshot_capacity, delta=True,
                          model=cfg.model, wire=srv, device=dev)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="occ_cluster_")
    followers: list[dict] = []      # {proc, path, late, replacement}

    def spawn_follower(late: bool, replacement: bool = False) -> None:
        path = os.path.join(tmp, f"follower_{len(followers)}.json")
        p = ctx.Process(
            target=follower_main,
            args=(srv.address[0], srv.address[1], cfg.model, path,
                  cfg.snapshot_capacity),
            kwargs=dict(device=cfg.device), daemon=True)
        p.start()
        followers.append(dict(proc=p, path=path, late=late,
                              replacement=replacement))

    for _ in range(cfg.n_followers):
        spawn_follower(late=False)
    # training plane: the workers start up beside the followers
    plane = _WorkerPlane(cfg)
    plane.start()
    deadline = time.monotonic() + cfg.spawn_timeout_s
    while (srv.followers(cfg.model) < cfg.n_followers
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert srv.followers(cfg.model) == cfg.n_followers, "follower connect"
    plane.accept_workers()
    proposer = _ClusterProposer(cfg, txn, plane)
    engine = OCCEngine(txn, pb=cfg.pb, validate_cap=cfg.validate_cap,
                       obs=obs, device=dev)

    killed = {"done": False}
    # straggler watchdog on the master's epoch loop: a slow epoch (a hung
    # or lagging worker that still answers before the heartbeat timeout)
    # emits a StragglerEvent into the run's metrics instead of passing
    # silently.
    watchdog = StepWatchdog(threshold=cfg.straggler_threshold,
                            warmup_steps=cfg.straggler_warmup, obs=obs)
    last_commit = [now()]

    def on_commit(pool, epoch, t_epochs):
        t = now()
        watchdog.observe(epoch, t - last_commit[0])
        last_commit[0] = t
        store.publish_pool(pool, n_seen=min(cfg.n, (epoch + 1) * cfg.pb),
                           epochs=epoch + 1)
        if (cfg.kill_follower_at_epoch == epoch and not killed["done"]
                and followers):
            followers[0]["proc"].kill()      # mid-publish, no FIN, no ACK
            killed["done"] = True
            spawn_follower(late=True, replacement=True)
        if cfg.late_follower and epoch == max(1, int(t_epochs
                                                     * cfg.late_join_frac)):
            spawn_follower(late=True)

    tp = now()
    res = engine.run_from_proposals(x, proposer, on_commit=on_commit)
    pass_s = now() - tp
    plane.close()
    t_end = now()

    # replication barrier: every surviving follower connected and acked
    latest = store.latest_meta().version
    expect = sum(1 for f in followers
                 if not (killed["done"] and f is followers[0]))
    deadline = time.monotonic() + cfg.spawn_timeout_s
    while (srv.followers(cfg.model) < expect
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert srv.wait_acked(latest, cfg.model,
                          timeout=cfg.spawn_timeout_s), "ack barrier"
    metrics = srv.metrics()
    srv.close()     # FIN → followers write their reports and exit
    reports = []
    for f in followers:
        f["proc"].join(timeout=30.0)
        if os.path.exists(f["path"]):
            with open(f["path"]) as fh:
                reports.append({**json.load(fh), "late": f["late"],
                                "replacement": f["replacement"]})
    exitcodes = plane.exitcodes()
    teardown_s = now() - t_end

    # ------------------------------------------------------------- audit
    # The single-process oracle: the fused pass (clean run), or the
    # host-driven pass with the same dead-shard masks (chaos run).
    ref_engine = OCCEngine(txn, pb=cfg.pb, validate_cap=cfg.validate_cap,
                           device=dev)
    tr = now()
    if proposer.dead_from:
        ref = ref_engine.run_from_proposals(
            x, _masked_reference(cfg, ref_engine, proposer.dead_from))
    else:
        ref = ref_engine.run(x)
    ref_count = int(ref.pool.count)
    ref_pass_s = now() - tr
    bit = dict(
        centers=_eq(ref.pool.centers, res.pool.centers),
        count=ref_count == int(res.pool.count),
        mask=_eq(ref.pool.mask, res.pool.mask),
        assign=_eq(ref.assign, res.assign),
        send=_eq(ref.send, res.send),
        epoch_of=_eq(ref.epoch_of, res.epoch_of),
        stats_proposed=_eq(ref.stats.proposed, res.stats.proposed),
        stats_accepted=_eq(ref.stats.accepted, res.stats.accepted),
        stats_cap=_eq(ref.stats.cap, res.stats.cap),
    )
    primary_digest = store_digest(store)
    follower_ok = [r["digest"] == primary_digest for r in reports]
    boot_ok = all(r["bootstrapped"] for r in reports if r["late"])
    full_stream_ok = all(r["versions"] == store.versions()
                         for r in reports if not r["late"])
    # Only the configured chaos death may end a worker other than cleanly.
    want_exit = [_DIE_EXIT if w == cfg.die_worker else 0
                 for w in range(cfg.n_workers)]
    exit_ok = exitcodes == want_exit

    record = {
        "bench": "transport",
        "n": cfg.n, "dim": cfg.dim, "pb": cfg.pb,
        "workers": cfg.n_workers,
        "followers": len(reports),
        "device": str(dev),
        "epochs": int(res.stats.proposed.shape[0]),
        "k_final": int(res.pool.count),
        "versions_published": len(store),
        "delta_rows_published": store.delta_rows_published,
        "delta_bytes_per_publish":
            metrics["bytes_sent"] / max(1, metrics["n_sent"]),
        "ack_p50_ms": metrics["ack_p50_ms"],
        "ack_p99_ms": metrics["ack_p99_ms"],
        "n_acks": metrics["n_acks"],
        "n_bootstraps": metrics["n_bootstraps"],
        "bit_identical": bit,
        "follower_digests_match": follower_ok,
        "late_joiners_bootstrapped": boot_ok,
        "full_stream_versions_match": full_stream_ok,
        "worker_deaths": proposer.dead_from,
        "worker_exitcodes": exitcodes,
        "worker_reports": [plane.reports.get(w)
                           for w in range(cfg.n_workers)],
        "straggler_events": [
            dict(step=ev.step, elapsed_s=ev.elapsed, ratio=ev.ratio)
            for ev in watchdog.events],
        "setup_s": tp - t0,         # data, sockets, processes up
        "pass_s": pass_s,
        "teardown_s": teardown_s,   # FIN, reports, barrier, exits
        "ref_pass_s": ref_pass_s,
        "wall_s": now() - t0,
    }
    if obs.tracer is not None:
        # the master's time split: waiting on the workers' proposals
        # against serializing them
        record["master_span_s"] = _span_seconds(
            obs.tracer, "engine.propose", "engine.validate")
    obs.flush()
    assert all(bit.values()), f"multi-process run diverged: {bit}"
    assert reports and all(follower_ok), "follower store digest mismatch"
    assert boot_ok, "a late joiner did not bootstrap from a snapshot"
    assert full_stream_ok, "a from-start follower lost versions"
    assert exit_ok, (f"worker exit codes {exitcodes} != {want_exit}: a "
                     f"worker failed")
    if cfg.die_worker is not None:
        assert proposer.dead_from.get(cfg.die_worker) == cfg.die_epoch, (
            "worker death not detected at the pinned epoch")
    if cfg.kill_follower_at_epoch is not None:
        rep = [r for r in reports if r["replacement"]]
        assert rep and rep[0]["bootstrapped"], "replacement did not resync"
    if cfg.out_path is not None:
        with open(cfg.out_path, "w") as f:
            json.dump(record, f, indent=2)
    if not cfg.quiet:
        print(f"{cfg.n_workers} workers x {record['epochs']} epochs over "
              f"{cfg.n} points on {dev} -> K={record['k_final']} "
              f"({record['versions_published']} versions, "
              f"{record['delta_bytes_per_publish']:.0f} B/publish)")
        print(f"bit-identical to single-process pass: "
              f"{all(bit.values())}  followers={len(reports)} "
              f"(late bootstraps ok: {boot_ok})  "
              f"ack p50={record['ack_p50_ms']:.2f}ms "
              f"p99={record['ack_p99_ms']:.2f}ms")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--pb", type=int, default=128)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--followers", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where master, workers and followers run "
                         "(cuda or cpu)")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizes (numbers not meaningful)")
    ap.add_argument("--out", default=None,
                    help="write the JSON record here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto/Chrome trace JSON here")
    args = ap.parse_args(argv)
    cfg = ClusterConfig(n=args.n, dim=args.dim, pb=args.pb,
                        n_workers=args.workers, n_followers=args.followers,
                        out_path=args.out, trace_out=args.trace_out,
                        device=args.device)
    if args.quick:
        cfg = ClusterConfig(n=1024, dim=8, pb=64, k_max=128, lam=3.0,
                            n_workers=args.workers,
                            n_followers=args.followers, out_path=args.out,
                            trace_out=args.trace_out, device=args.device)
    run_cluster(cfg)


if __name__ == "__main__":
    main()
