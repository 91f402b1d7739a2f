"""Online clustering of an arriving stream: `OCCEngine.partial_fit`.

The port of `examples/streaming_clusters.py`.  The pool, the global point
counter and the epoch statistics carry over between batches, and the
trailing `n mod pb` points of each call ride in an explicit partial-epoch
carry, so the stream is *bit-identical* to the one-shot run for ANY batch
lengths, even the deliberately ragged ones below.  `flush()` commits the
stream's final short epoch.

  PYTHONPATH=src python -m repro_torch.examples.streaming_clusters \\
      [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core import DPMeansTransaction, OFLTransaction, OCCEngine, occ_ofl
from repro_torch.data import dp_stick_breaking_data


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- a stream of RAGGED arriving batches ------------------------------
    x, z_true, _ = dp_stick_breaking_data(4096, seed=0)
    x = torch.as_tensor(x, device=dev)
    cuts = [353, 1000, 1024, 2500, 4070]          # nothing aligned to pb
    batches = torch.tensor_split(x, cuts)

    # --- DP-means over the stream ----------------------------------------
    eng = OCCEngine(DPMeansTransaction(lam=4.0, k_max=256), pb=128,
                    device=dev)
    print("DP-means stream (ragged batches, pb=128):")
    rows = []
    for i, xb in enumerate(batches):
        res = eng.partial_fit(xb)
        rows.append({"len": xb.shape[0], "n_seen": eng.n_seen,
                     "carried": eng.n_pending, "K": int(eng.pool.count),
                     "sent": int(res.stats.proposed.sum())})
        r = rows[-1]
        print(f"  batch {i}: len={r['len']:4d}  n_seen={r['n_seen']:5d}"
              f"  carried={r['carried']:3d}  K={r['K']:3d}"
              f"  sent={r['sent']:4d}")
    eng.flush()                                   # final short epoch
    print(f"  true K = {z_true.max() + 1}; master load stays ~Pb per batch "
          f"after warmup (Thm 3.3)")

    # --- OFL: ragged stream is bit-identical to the one-shot run ----------
    key = (0, 0)              # the JAX package's jax.random.key(0)
    eng_o = OCCEngine(OFLTransaction(lam=8.0, k_max=512, key=key), pb=128,
                      device=dev)
    zs = [eng_o.partial_fit(xb).assign for xb in batches]
    fl = eng_o.flush()
    if fl is not None:
        zs.append(fl.assign)
    one_shot = occ_ofl(x, 8.0, pb=128, key=key, k_max=512, device=dev)
    same = bool(torch.equal(torch.cat(zs), one_shot.z))
    out = {"dp_batches": rows, "K_dp": int(eng.pool.count),
           "K_ofl": int(eng_o.pool.count), "ofl_stream_eq_oneshot": same}
    print(f"OFL stream:      K={out['K_ofl']}  "
          f"bit-identical to one-shot run (ANY batching): {same}")
    print("train/serve split: python -m repro_torch.launch.serve_clusters "
          "(publish snapshots + serve while training)")
    return out


if __name__ == "__main__":
    main()
