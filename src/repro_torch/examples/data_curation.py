"""OCC data curation inside the language-model framework: cluster
sequence embeddings with OCC DP-means, down-weight near-duplicate
clusters, feed the weights back into sampling.

The port of `examples/data_curation.py`: reduced granite-3-2b in float32,
random weights from a seeded generator, on the card unless `--device cpu`.

  PYTHONPATH=src python -m repro_torch.examples.data_curation \\
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.curation import curate, embed_sequences
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import build_model


def main(argv=None, model=None) -> dict:
    """`model`: a built reduced granite-3-2b (float32) to curate with,
    random weights from `--seed` otherwise."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = reduced(ARCHS["granite-3-2b"]).replace(dtype="float32")
    if model is None:
        dev = resolve_device(args.device)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        model = build_model(cfg, device=dev).init(gen)

    # Build a corpus with injected near-duplicates (the realistic failure
    # mode curation exists for).
    pipe = TokenPipeline(cfg.vocab, global_batch=16, seq_len=32, seed=0)
    batches = [pipe.batch_at(s) for s in range(6)]
    dup = batches[0]["tokens"][:1]
    batches[1] = dict(batches[1])
    batches[1]["tokens"] = np.tile(dup, (16, 1))   # a batch of duplicates

    embeds = embed_sequences(model, batches)
    print(f"embedded {embeds.shape[0]} sequences into R^{embeds.shape[1]}")

    lam = 0.5 * float(torch.median(torch.linalg.vector_norm(
        embeds - embeds.mean(0), dim=1)))
    rep = curate(embeds, lam=lam, pb=32, k_max=64)
    print(f"OCC DP-means curation: {rep.n_clusters} clusters over "
          f"{rep.n_points} sequences; dup_fraction={rep.dup_fraction:.2%}")
    w = rep.keep_weight
    print(f"sampling weights: min={w.min():.3f} mean={w.mean():.3f} "
          f"(duplicate cluster down-weighted: {np.sum(w < 1.0)} seqs)")
    assert rep.dup_fraction > 0.0, "expected the injected duplicates to cluster"
    return {"n_embedded": int(embeds.shape[0]), "dim": int(embeds.shape[1]),
            "lam": lam, "n_clusters": rep.n_clusters,
            "n_points": rep.n_points, "dup_fraction": rep.dup_fraction,
            "n_downweighted": int(np.sum(w < 1.0)),
            "z": rep.result.z.cpu().numpy()}


if __name__ == "__main__":
    main()
