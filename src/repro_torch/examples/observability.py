"""Observability walkthrough: one registry + one trace for a whole run.

The port of `examples/observability.py`.  Three acts:

  1. a single shared `Obs` threaded through engine -> store -> WAL: every
     layer's counters land in ONE registry, read back via `dump()` /
     Prometheus-style `exposition()`;
  2. the same run traced: spans and instants from every subsystem land in
     one Chrome-trace JSON (open it at https://ui.perfetto.dev);
  3. a 3-node HA cluster with the master SIGKILLed mid-pass, `trace_out`
     merging every process's timeline (the victim flushes its trace
     before `os._exit`) into one file whose span categories cover engine,
     transport, WAL, fault and the HA control plane.  (Act 3 spawns
     processes; pass --ha to include it.)

  PYTHONPATH=src python -m repro_torch.examples.observability [--ha] \\
      [--device cpu] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import DeltaWAL
from repro_torch.core import DPMeansTransaction, OCCEngine
from repro_torch.data import dp_stick_breaking_data
from repro_torch.obs import Obs, Tracer, load_trace, trace_categories, \
    validate_trace
from repro_torch.serving.snapshot import SnapshotStore


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ha", action="store_true",
                    help="act 3: the merged multi-process chaos timeline")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=None,
                    help="where the traces and the WAL go (default: a new "
                         "temporary directory, kept)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    x = torch.as_tensor(dp_stick_breaking_data(2048, seed=0, dim=8)[0],
                        device=dev)
    lam, k_max, pb = 4.0, 128, 128
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="occ-obs-")
    trace_path = os.path.join(out_dir, "trace.json")

    # --- acts 1+2: one Obs, every layer, one registry + one trace --------
    # Components create a private Obs() when none is given (counters still
    # work standalone); passing ONE bundle is what unifies the run.
    obs = Obs(tracer=Tracer("observability-demo"), trace_path=trace_path)
    wal = DeltaWAL(os.path.join(out_dir, "wal"), model="demo",
                   checkpoint_every=4, obs=obs, device=dev)
    store = SnapshotStore(capacity=16, delta=True, model="demo", wire=wal,
                          device=dev)
    engine = OCCEngine(DPMeansTransaction(lam, k_max=k_max), pb=pb,
                       publish=store.publish_pass, obs=obs, device=dev)
    for lo in range(0, 2048, 512):
        engine.partial_fit(x[lo:lo + 512])
    engine.flush()
    wal.close()
    obs.flush()

    print("--- registry (Prometheus text exposition, excerpt) ---")
    for line in obs.metrics.exposition().splitlines():
        if line.startswith(("engine_p", "engine_accepted", "wal_appends",
                            "wal_checkpoints", "engine_pass_s_")):
            print(f"  {line}")
    h = obs.metrics.get_histogram("engine_pass_s")
    out = {"engine_passes": h.count, "K": int(engine.pool.count),
           "engine_accepted": int(obs.metrics.value("engine_accepted")),
           "engine_proposed": int(obs.metrics.value("engine_proposed")),
           "wal_appends": int(obs.metrics.value("wal_appends")),
           "wal_checkpoints": int(obs.metrics.value("wal_checkpoints")),
           "conflict_rate": obs.metrics.value("engine_conflict_rate")}
    print(f"engine passes: {h.count}, pass p50 {h.percentile(50) * 1e3:.1f}ms"
          f" (K={out['K']}, conflict_rate={out['conflict_rate']:.3f})")

    trace = load_trace(trace_path)
    assert validate_trace(trace) == []
    out["trace_categories"] = sorted(trace_categories(trace))
    print(f"trace: {len(trace['traceEvents'])} events, categories "
          f"{out['trace_categories']}\n"
          f"  -> open {trace_path} at https://ui.perfetto.dev")

    # --- act 3 (--ha): the merged multi-process chaos timeline -----------
    if args.ha:
        from repro_torch.launch.ha_cluster import HAConfig, run_ha_cluster
        ha_trace = os.path.join(out_dir, "trace_ha.json")
        rec = run_ha_cluster(HAConfig(
            n=1024, dim=8, pb=64, k_max=128, lam=3.0, n_workers=2,
            n_nodes=3, kill_master_after_version=6, trace_out=ha_trace,
            quiet=True, device=str(dev)))
        merged = load_trace(ha_trace)
        assert validate_trace(merged) == []
        pids = {e["pid"] for e in merged["traceEvents"]}
        out["ha"] = {"promotions": rec["promotions"],
                     "processes": len(pids),
                     "categories": sorted(trace_categories(merged))}
        print(f"HA chaos: {rec['promotions']} promotion, "
              f"{len(merged['traceEvents'])} events from {len(pids)} "
              f"processes (killed master included), categories "
              f"{out['ha']['categories']}\n"
              f"  -> open {ha_trace} at https://ui.perfetto.dev")
    return out


if __name__ == "__main__":
    main()
