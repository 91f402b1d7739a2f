"""Quickstart: the OCC engine and its transactions on the card.

The port of `examples/quickstart.py`.  The primary API is `OCCEngine` + an
`OCCTransaction` (DP-means, OFL, BP-means, or your own): the engine runs a
whole pass (padding, optional serial bootstrap, bounded-master validation,
stats) as one call; `occ_dp_means` / `occ_ofl` / `occ_bp_means` are
one-call conveniences over the same engine.  Propose, scoring and top-k run
the hand-written kernels on the card.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core import (
    DPMeansTransaction, OCCEngine, occ_bp_means, occ_ofl, serial_dp_means,
)
from repro_torch.data import bp_stick_breaking_data, dp_stick_breaking_data
from repro_torch.serving import ClusterService, Query, ServeConfig, SnapshotStore


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- DP-means through the engine (primary API) -----------------------
    x, z_true, _ = dp_stick_breaking_data(2048, seed=0)
    x = torch.as_tensor(x, device=dev)
    txn = DPMeansTransaction(lam=4.0, k_max=256)
    eng = OCCEngine(txn, pb=256, device=dev)
    res = eng.run(x)                          # one call: all epochs
    pool = eng.refine(res.pool, x, res.assign)
    stats = res.stats
    for _ in range(2):                        # Lloyd-style passes, as serial
        res = eng.run(x, pool=pool)
        pool = eng.refine(res.pool, x, res.assign)
    out = {"K": int(res.pool.count), "K_true": int(z_true.max() + 1),
           "J": float(txn.objective(x, res.assign, pool)),
           "proposed": int(stats.proposed.sum()),
           "rejected": int(stats.proposed.sum() - stats.accepted.sum()),
           "dispatches": eng.n_dispatches}
    print(f"OCC DP-means:  K={out['K']} (true {out['K_true']}), "
          f"J={out['J']:.1f}, proposed={out['proposed']}, "
          f"rejected={out['rejected']} (bound Pb=256), "
          f"dispatches={out['dispatches']} (1 per pass)")
    ser = serial_dp_means(x, 4.0, k_max=256, max_iters=3, device=dev)
    out["K_serial"] = int(ser.pool.count)
    print(f"serial DP-means: K={out['K_serial']}, "
          f"J={float(ser.objective):.1f}"
          f"  <- OCC matches the serial algorithm (Thm 3.1)")

    # --- OFL / BP-means via the convenience wrappers ----------------------
    # key (0, 0): the raw key data of the JAX package's jax.random.key(0)
    ofl = occ_ofl(x, lam=4.0, pb=256, key=(0, 0), k_max=512, device=dev)
    out["K_ofl"] = int(ofl.pool.count)
    print(f"OCC OFL:       K={out['K_ofl']}, J={float(ofl.objective):.1f}"
          f"  (constant-factor approx of DP-means objective, Lemma 3.2)")

    xb, zb, _ = bp_stick_breaking_data(1024, seed=0)
    bp = occ_bp_means(xb, lam=4.0, pb=256, k_max=128, max_iters=2,
                      device=dev)
    out["K_bp"] = int(bp.pool.count)
    print(f"OCC BP-means:  K={out['K_bp']} features "
          f"(true {zb.shape[1]}), cost={float(bp.objective):.1f}")

    # --- train/serve split: publish snapshots, serve queries --------------
    # Training publishes immutable model versions into a SnapshotStore; a
    # read-only ClusterService answers typed queries against the newest
    # version (pad-to-bucket microbatching, one kernel dispatch per
    # microbatch, atomic hot-swap).
    store = SnapshotStore(device=dev)
    eng = OCCEngine(txn, pb=256, publish=store.publish_pass, device=dev)
    for xs in torch.split(x, [700, 800, 548]):   # ragged stream, carry on
        eng.partial_fit(xs)
    eng.flush()
    svc = ClusterService(store, ServeConfig(max_bucket=1024))
    resp = svc.submit(Query(x[:100]))         # one microbatch, one dispatch
    top = svc.submit(Query(x[:5], kind="topk", k=3))
    scan = svc.submit(Query(x[:32], kind="topk", k=3, priority="analytics",
                            max_staleness=2))  # sheddable background scan
    out.update(version=resp.version, bucket=resp.bucket,
               K_served=store.latest().count,
               topk0=[int(i) for i in top.labels[0]],
               degraded=bool(scan.degraded))
    print(f"serving:       v{resp.version} answered 100 queries in bucket "
          f"{resp.bucket}, K={out['K_served']}, topk[0]={out['topk0']}, "
          f"analytics scan degraded={out['degraded']}")
    print("streaming: python -m repro_torch.examples.streaming_clusters; "
          "full train-while-serve demo: "
          "python -m repro_torch.launch.serve_clusters")
    return out


if __name__ == "__main__":
    main()
