"""Crash recovery walkthrough: WAL-backed training that survives a kill.

The port of `examples/crash_recovery.py`.  Three acts:

  1. train with every published version appended to a durable `DeltaWAL`
     (wire-format frames + crc32, periodic full checkpoints), then
     "crash" by throwing the trainer and its store away;
  2. `recover_wal` rebuilds the store from disk (newest checkpoint image
     + at most one interval of delta replay), `OCCEngine.restore` resumes
     from the published watermark, and the finished run is BIT-IDENTICAL
     to one that never crashed;
  3. the same machinery at cluster scale: `run_ha_cluster` SIGKILLs the
     master mid-pass, promotes the highest-watermark follower with a
     fenced term, and audits every epoch digest against an uninterrupted
     reference.  (Act 3 spawns processes; pass --ha to include it.)

  PYTHONPATH=src python -m repro_torch.examples.crash_recovery [--ha] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import DeltaWAL, recover_wal
from repro_torch.core import DPMeansTransaction, OCCEngine
from repro_torch.data import dp_stick_breaking_data
from repro_torch.serving.snapshot import SnapshotStore


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ha", action="store_true",
                    help="act 3: kill the master of a live cluster")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    x = torch.as_tensor(dp_stick_breaking_data(2048, seed=0, dim=8)[0],
                        device=dev)
    lam, k_max, pb = 4.0, 128, 128

    # --- the run that never fails: our bit-identity oracle ---------------
    ref = OCCEngine(DPMeansTransaction(lam, k_max=k_max), pb=pb, device=dev)
    ref.partial_fit(x[:1024])
    ref.partial_fit(x[1024:])
    ref.flush()
    out = {"K_ref": int(ref.pool.count)}
    print(f"reference (uninterrupted): K={out['K_ref']}")

    wal_dir = tempfile.mkdtemp(prefix="occ-wal-")
    try:
        # --- act 1: durable training, then a crash -----------------------
        # The WAL rides the store's `wire` seam (the seam socket
        # replication uses), so durability is one more subscriber.
        wal = DeltaWAL(wal_dir, model="demo", checkpoint_every=4, device=dev)
        store = SnapshotStore(capacity=16, delta=True, model="demo",
                              wire=wal, device=dev)
        trainer = OCCEngine(DPMeansTransaction(lam, k_max=k_max), pb=pb,
                            publish=store.publish_pass, device=dev)
        for lo in range(0, 1024, 256):  # publish per chunk: versions 1..4,
            trainer.partial_fit(x[lo:lo + 256])  # checkpoint at version 4
        wal.close()                              # ...then the process dies
        del trainer, store              # the crash: only disk remains
        out.update(n_appended=wal.n_appended, n_checkpoints=wal.n_checkpoints)
        print(f"crashed after 1024/2048 points; WAL dir keeps "
              f"{wal.n_appended} delta records + {wal.n_checkpoints} "
              f"checkpoints")

        # --- act 2: recover, resume, verify bit-identity ------------------
        recovered, info = recover_wal(wal_dir, model="demo", capacity=16,
                                      device=dev)
        snap = recovered.latest().materialize()
        out.update(ckpt_version=info["ckpt_version"],
                   n_replayed=info["n_replayed"], version=snap.version,
                   n_seen=snap.n_seen)
        print(f"recovered: checkpoint@v{info['ckpt_version']} + "
              f"{info['n_replayed']} deltas replayed -> version "
              f"{snap.version}, watermark n_seen={snap.n_seen}")
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)

    resumed = OCCEngine(DPMeansTransaction(lam, k_max=k_max), pb=pb,
                        device=dev)
    resumed.restore(snap, k_max=k_max)
    resumed.partial_fit(x[snap.n_seen:])   # only the unseen suffix
    resumed.flush()
    identical = (int(resumed.pool.count) == int(ref.pool.count)
                 and torch.equal(resumed.pool.centers, ref.pool.centers))
    out.update(K_resumed=int(resumed.pool.count), identical=identical)
    print(f"resumed:   K={out['K_resumed']}  "
          f"bit-identical to the uninterrupted run: {identical}")
    assert identical

    # --- act 3 (--ha): kill the MASTER of a live cluster ------------------
    if args.ha:
        from repro_torch.launch.ha_cluster import HAConfig, run_ha_cluster
        rec = run_ha_cluster(HAConfig(
            n=1024, dim=8, pb=64, k_max=128, lam=3.0, n_workers=2,
            n_nodes=3, kill_master_after_version=6, quiet=True,
            device=str(dev)))
        out["ha"] = {k: rec[k] for k in (
            "kill_version", "master_node_final", "terms", "resume_epoch",
            "epoch_digests_match", "final_digest_match")}
        print(f"HA cluster: master killed after acked version "
              f"{rec['kill_version']}; node {rec['master_node_final']} "
              f"promoted (terms {rec['terms']}), resumed at epoch "
              f"{rec['resume_epoch']}; every epoch digest + final store "
              f"bit-identical: "
              f"{rec['epoch_digests_match'] and rec['final_digest_match']}")
    return out


if __name__ == "__main__":
    main()
