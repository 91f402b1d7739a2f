"""RETRO-style retrieval serving at K >= 10^5 centers.

The port of `examples/retrieval_index.py`: the serving-plane scale proof
for the streaming top-k path.  Train a DP-means clustering of synthetic
chunk embeddings up to ~10^5 centers with the OCC engine (tiny lambda:
nearly every chunk becomes a center, the regime a retrieval index lives
in), publish it into a hierarchical `SnapshotStore`, and serve top-k
nearest-neighbor lookups through `ClusterService` as the index:

  * flat serving: the `topk_stream` kernel over the full center buffer,
    its tile loop stopping at the active prefix;
  * multi-probe serving: route each query to its p nearest coarse cells
    and stream only those fine shards (`topk_multiprobe_stream`),
    sweeping the exactness knob p: p = all is AUDITED bit-identical to
    flat, smaller p reports measured recall@k from the service's own
    audit gauge.

`--out F` merges the p50/p99 latency + recall rows into the JSON file F
under the "retrieval" key (read-modify-write).

  PYTHONPATH=src python -m repro_torch.examples.retrieval_index [--quick] \\
      [--out F] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import DPMeansTransaction, OCCEngine
from repro_torch.serving import ClusterService, Query, ServeConfig, SnapshotStore

N_CHUNKS = 110_000          # K >= 1e5 after conflict rejections
DIM = 16
LAM = 0.05                  # << chunk spacing: every chunk a center
K_MAX = 131_072             # 2^17 capacity bucket
BUCKET = 64                 # latency-regime microbatches (probing prunes)
TOPK = 8


def _chunk_embeddings(n: int, dim: int, seed: int) -> np.ndarray:
    """Unit-normalized Gaussian 'chunk embeddings': uniform on the sphere,
    the shape retrieval corpora actually have (no mixture structure: the
    index IS the dataset)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def build_index(n_chunks: int = N_CHUNKS, quiet: bool = False,
                device: str | torch.device = "cuda"):
    """Train the index -> (chunks (numpy), hierarchical store, train
    seconds, the engine).  On the card the seconds end in a
    synchronize."""
    dev = resolve_device(device)
    x = _chunk_embeddings(n_chunks, DIM, seed=0)
    store = SnapshotStore(hier=True, device=dev)
    eng = OCCEngine(DPMeansTransaction(LAM, k_max=K_MAX), pb=256,
                    validate_cap="adaptive", publish=store.publish_pass,
                    device=dev)
    xt = torch.as_tensor(x, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.partial_fit(xt)
    eng.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_train = time.perf_counter() - t0
    k = int(eng.pool.count)
    assert k >= 100_000, f"index too small: K={k}"
    snap = store.latest()
    h = snap.hier
    if not quiet:
        print(f"index: K={k} centers of {n_chunks} chunks in "
              f"{t_train:.1f}s  (capacity {snap.capacity}, "
              f"{h.n_cells} cells x {h.shard_cap} shard rows)")
    return x, store, t_train, eng


def _serve_sweep(x, store, n_queries: int, ps, quiet: bool = False):
    """One service per probe setting; identical query trace; p50/p99 from
    each service's own request histogram, recall from its audit gauge."""
    rng = np.random.default_rng(42)
    # queries = perturbed chunks: the retrieval access pattern (a query
    # lands NEAR its source chunk, not on it)
    base = x[rng.integers(0, x.shape[0], size=n_queries)]
    q = base + 0.02 * rng.normal(size=base.shape).astype(np.float32)
    h = store.latest().hier
    rows = {}
    flat_resp = None
    for p in ps:
        probes = h.n_cells if p == "all" else p
        svc = ClusterService(store, ServeConfig(
            max_bucket=BUCKET, probes=probes, recall_audit_every=1))
        resps = [svc.submit(Query(q[lo:lo + BUCKET], kind="topk", k=TOPK))
                 for lo in range(0, n_queries, BUCKET)]
        met = svc.metrics()
        labels = np.concatenate([r.labels for r in resps])
        scores = np.concatenate([r.scores for r in resps])
        row = {
            "p": probes,
            "p50_ms": met["request_p50_ms"],
            "p99_ms": met["request_p99_ms"],
            f"recall@{TOPK}": (1.0 if p == "all"
                               else met["topk_recall"]),
            "shards_probed": met["topk_shards_probed"],
            "tiles_skipped": met["topk_tiles_skipped"],
        }
        if p == "all":
            # the exactness contract, audited: p = all responses must be
            # BIT-identical to a probes=None flat service on every row
            flat = ClusterService(store, ServeConfig(max_bucket=BUCKET))
            fq = [flat.submit(Query(q[lo:lo + BUCKET], kind="topk", k=TOPK))
                  for lo in range(0, n_queries, BUCKET)]
            fl = np.concatenate([r.labels for r in fq])
            fs = np.concatenate([r.scores for r in fq])
            row["exact_vs_flat"] = bool(np.array_equal(labels, fl)
                                        and np.array_equal(scores, fs))
            assert row["exact_vs_flat"], "p=all must be bit-identical"
            flat_resp = labels
        rows[f"p{probes}" if p != "all" else "p_all"] = row
        if not quiet:
            tag = "all" if p == "all" else f"{probes:3d}"
            print(f"  p={tag}: p50={row['p50_ms']:7.2f}ms "
                  f"p99={row['p99_ms']:7.2f}ms "
                  f"recall@{TOPK}={row[f'recall@{TOPK}']:.3f}"
                  + (";exact=True" if p == "all" else ""))
    assert flat_resp is not None
    return rows


def main(argv=None, index=None) -> dict:
    """`index`: an already trained `build_index(...)` result to serve
    (the training is then skipped)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer queries + a 2-point probe sweep (the index "
                         "still trains to K >= 1e5)")
    ap.add_argument("--out", default=None,
                    help="merge rows into this JSON file (retrieval key)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    quiet = args.quiet
    if index is None:
        index = build_index(quiet=quiet, device=args.device)
    x, store, t_train, _ = index
    n_queries = 256 if args.quick else 1024
    ps = (4, "all") if args.quick else (1, 4, 16, "all")
    if not quiet:
        print(f"serving {n_queries} queries, k={TOPK}, "
              f"bucket={BUCKET}, probe sweep {ps}:")
    rows = _serve_sweep(x, store, n_queries, ps, quiet=quiet)
    snap = store.latest()
    record = {
        "bench": "retrieval_index",
        "device": str(store.device),
        "n_chunks": int(x.shape[0]),
        "k_centers": int(snap.count),
        "capacity": int(snap.capacity),
        "n_cells": int(snap.hier.n_cells),
        "shard_cap": int(snap.hier.shard_cap),
        "dim": DIM,
        "k": TOPK,
        "train_s": t_train,
        "n_queries": n_queries,
        "sweep": rows,
    }
    if args.out:
        merged = {}
        if os.path.exists(args.out):
            try:
                with open(args.out) as f:
                    merged = json.load(f)
            except ValueError:
                merged = {}
        if not isinstance(merged, dict):
            merged = {"demo": merged}
        merged["retrieval"] = record
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=2)
        if not quiet:
            print(f"merged retrieval rows into {args.out}")
    return record


if __name__ == "__main__":
    main()
