"""Follower process entrypoint: tail a primary's delta stream (§13).

The port's copy of `repro/launch/occ_follower.py`; the follower's store
lives on `--device` (the card unless the caller asks for the CPU).

Connects a `ReplicationClient` to a `ReplicationServer`, applies
SNAPSHOT/DELTA frames into a local delta-mode `SnapshotStore` (ACKing each
version), and on FIN writes a JSON report — versions held, latest count /
capacity, a sha256 content digest of the latest snapshot, and whether the
stream began with a snapshot bootstrap.  The cluster driver compares the
digest against the primary to prove cross-process bit-identity; a follower
spawned mid-run must report `bootstrapped: true` with the same digest.

  PYTHONPATH=src python -m repro_torch.launch.occ_follower \
      --connect 127.0.0.1:5432 --model occ --out follower.json
"""
from __future__ import annotations

import argparse
import json

from repro_torch.distributed.transport import ReplicationClient, store_digest

__all__ = ["follower_main"]


def follower_main(host: str, port: int, model: str | None,
                  result_path: str | None = None,
                  capacity: int = 128, reconnect: bool = False,
                  max_retries: int = 6, backoff_s: float = 0.05,
                  backoff_max_s: float = 2.0, device: str = "cuda") -> dict:
    """Run the follower loop to FIN/EOF; return (and optionally write) the
    state report.  Spawnable as a `multiprocessing` target.

    With `reconnect=True` a broken stream is retried with exponential
    backoff + jitter (§14) up to `max_retries` consecutive failures; the
    re-HELLO carries the follower's watermark, so a retry resumes with the
    missing suffix (or a SNAPSHOT resync) rather than the full history."""
    client = ReplicationClient((host, port), model=model, capacity=capacity,
                               reconnect=reconnect, max_retries=max_retries,
                               backoff_s=backoff_s,
                               backoff_max_s=backoff_max_s, device=device)
    client.connect()
    client.run()
    store = client.store
    meta = store.latest_meta()
    report = dict(
        model=model,
        versions=store.versions(),
        latest_version=None if meta is None else meta.version,
        count=None if meta is None else meta.count,
        capacity=None if meta is None else meta.capacity,
        digest=store_digest(store),
        bootstrapped=client.bootstrapped,
        n_applied=client.n_applied,
        n_reconnects=client.n_reconnects,
        fin_reason=client.fin_reason,
    )
    if result_path is not None:
        with open(result_path, "w") as f:
            json.dump(report, f, indent=2)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--model", default=None)
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--capacity", type=int, default=128,
                    help="follower snapshot-ring capacity")
    ap.add_argument("--reconnect", action="store_true",
                    help="retry a broken stream with backoff + jitter")
    ap.add_argument("--max-retries", type=int, default=6,
                    help="consecutive failures before giving up")
    ap.add_argument("--backoff", type=float, default=0.05,
                    help="initial reconnect backoff (seconds)")
    ap.add_argument("--backoff-max", type=float, default=2.0,
                    help="backoff ceiling (seconds)")
    ap.add_argument("--device", default="cuda",
                    help="where the follower's store lives (cuda or cpu)")
    args = ap.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    report = follower_main(host, int(port), args.model, args.out,
                           args.capacity, reconnect=args.reconnect,
                           max_retries=args.max_retries,
                           backoff_s=args.backoff,
                           backoff_max_s=args.backoff_max,
                           device=args.device)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
