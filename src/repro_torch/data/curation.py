"""OCC data curation: the paper's algorithm as a feature of the language
model framework.

The port of `repro/data/curation.py`.  OCC DP-means clusters sequence
embeddings, and the clusters drive near-duplicate down-weighting of the
token pipeline.  The embeddings are mean-pooled final hidden states of the
model (before its final norm), so curation runs inside the framework and
not as an offline job.  The forward runs the language-model kernels and
the clustering `dpmeans_assign` on the card, their plain versions on the
CPU.  `curate(mesh=...)` runs the pass on a mesh's ranks (each epoch
proposed split over the data axis), every rank getting the same report.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.dp_means import DPMeansResult, occ_dp_means

__all__ = ["embed_sequences", "curate", "CurationReport"]


@dataclass(frozen=True)
class CurationReport:
    n_clusters: int
    n_points: int
    dup_fraction: float      # points in overfull clusters
    keep_weight: np.ndarray  # (N,) sampling weight per example
    result: DPMeansResult


@torch.inference_mode()
def embed_sequences(model, batches) -> torch.Tensor:
    """Mean-pooled final hidden states as sequence embeddings (B_total, D)
    in float32, on the model's device (the vision prefix left out).
    `batches`: dicts with "tokens" (B, S), numpy or tensors, and
    "frontend" for the frontend families (the encoder-decoder's decoder
    attends to its encoder's output)."""
    outs = []
    for batch in batches:
        x, n_prefix = model._embed(batch)
        enc_out = model._encode(batch) if model.cfg.is_encdec else None
        h, _ = model._body_train(x, model._positions(x.shape[1]), enc_out)
        outs.append(h[:, n_prefix:].to(torch.float32).mean(dim=1))
    return torch.cat(outs, dim=0)


def curate(embeds, lam: float, pb: int, k_max: int = 512,
           max_per_cluster: int | None = None, mesh=None,
           device: str | torch.device | None = None) -> CurationReport:
    """OCC DP-means over embeddings -> per-example sampling weights.

    Clusters with more than `max_per_cluster` members are down-weighted to
    that size (near-duplicate suppression); the default is the mean
    cluster size.  `device`: where the pass runs; by default the
    embeddings' device (a numpy array: the card).  `mesh`: a `DeviceMesh`
    whose every rank calls this alike (`occ_dp_means(mesh=)`).
    """
    if device is None:
        device = embeds.device if isinstance(embeds, torch.Tensor) else "cuda"
    res = occ_dp_means(embeds, lam, pb=pb, k_max=k_max, max_iters=2,
                       device=device, mesh=mesh)
    z = res.z.cpu().numpy()
    n = z.shape[0]
    k = int(res.pool.count)
    counts = np.bincount(z[z >= 0], minlength=max(k, 1))
    cap = max_per_cluster or max(1, int(np.ceil(n / max(k, 1))))
    w = np.ones(n, np.float64)
    over = counts > cap
    for c in np.nonzero(over)[0]:
        w[z == c] = cap / counts[c]
    dup_frac = float(np.sum(counts[over] - cap) / max(n, 1))
    return CurationReport(k, n, dup_frac, w, res)
