"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Each `<name>_ref` is the semantic spec of a hand-written kernel: the CPU
tests run it, `chip_smoke.py` holds the kernel against it on the card, and
the dispatch in `kernels/ops.py` takes it only for tensors on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["assign_ref", "pairwise_argmin_ref", "topk_ref", "topk_merge_ref",
           "topk_multiprobe_ref", "TOPK_SENTINEL"]

# Invalid-candidate id inside the top-k selection: larger than any real
# center index, so the lexicographic (d2, id) order puts exhausted slots
# last.  Callers map it to -1 wherever d2 is not finite.
TOPK_SENTINEL = 2**31 - 1


def assign_ref(x: torch.Tensor, centers: torch.Tensor, mask: torch.Tensor):
    """`ops.assign` spec: masked min squared distance + argmin, idx = -1
    where no valid center.  Computes IN THE INPUT DTYPE (the expanded-matmul
    algebra of `core.objective.sq_dists`), so routing `nearest_center`
    through it keeps the propose phase's dtype contract."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=-1)[None, :]
    d2 = torch.clamp_min(x2 + c2 - 2.0 * (x @ centers.T), 0.0)
    d2 = torch.where(mask[None, :], d2, torch.inf)
    d2min, arg = torch.min(d2, dim=-1)
    idx = torch.where(torch.isfinite(d2min), arg, -1).to(torch.int32)
    return d2min, idx


def pairwise_argmin_ref(x: torch.Tensor, centers: torch.Tensor,
                        mask: torch.Tensor | None = None):
    """Min squared distance + argmin over centers, x (N, D), centers (K, D),
    computed in float32 (the kernel's accumulation dtype)."""
    xf = x.to(torch.float32)
    cf = centers.to(torch.float32)
    x2 = torch.sum(xf * xf, dim=-1, keepdim=True)
    c2 = torch.sum(cf * cf, dim=-1)[None, :]
    d2 = torch.clamp_min(x2 + c2 - 2.0 * (xf @ cf.T), 0.0)
    if mask is not None:
        d2 = torch.where(mask[None, :], d2, torch.inf)
    d2min, arg = torch.min(d2, dim=-1)
    return d2min, arg.to(torch.int32)


def topk_merge_ref(run_d: torch.Tensor, run_i: torch.Tensor,
                   d2: torch.Tensor, ids: torch.Tensor, k: int):
    """Running top-k merge by lexicographic (d2, id): THE selection spec.

    run_d / run_i (N, k) are the current candidates (pad: (inf,
    TOPK_SENTINEL)); d2 / ids (N, M) the new ones (invalid: d2 = inf, any
    id).  Returns the new (N, k), ascending by (d2, id), by k extraction
    steps, each taking the distance minimum and, among ties, the smallest
    id.  The result depends only on the candidate multiset, so it does not
    depend on how candidates are tiled or ordered — the property that makes
    the CUDA kernels' split-and-merge equal to this.  `torch.topk` is not
    used: its tie order is unspecified.
    """
    cat_d = torch.cat([run_d, d2], dim=1)
    cat_i = torch.cat([run_i, ids.to(torch.int32)], dim=1)
    out_d, out_i = [], []
    sentinel = torch.full_like(cat_i, TOPK_SENTINEL)
    for _ in range(k):
        dmin = torch.min(cat_d, dim=1).values
        tie = cat_d == dmin[:, None]
        imin = torch.min(torch.where(tie, cat_i, sentinel), dim=1).values
        out_d.append(dmin)
        out_i.append(imin)
        hit = tie & (cat_i == imin[:, None])
        cat_d = torch.where(hit, torch.inf, cat_d)
        cat_i = torch.where(hit, sentinel, cat_i)
    return torch.stack(out_d, dim=1), torch.stack(out_i, dim=1)


def _select(d2: torch.Tensor, ids: torch.Tensor, k: int):
    """k smallest (d2, id) per row from scratch; (inf, -1) where exhausted."""
    n = d2.shape[0]
    init_d = torch.full((n, k), torch.inf, dtype=d2.dtype, device=d2.device)
    init_i = torch.full((n, k), TOPK_SENTINEL, dtype=torch.int32,
                        device=d2.device)
    d2k, idx = topk_merge_ref(init_d, init_i, d2, ids, k)
    return d2k, torch.where(torch.isfinite(d2k), idx, -1).to(torch.int32)


def topk_ref(x: torch.Tensor, centers: torch.Tensor, k: int,
             mask: torch.Tensor | None = None):
    """k nearest centers per query: (d2 (N, k) ascending, idx (N, k) int32).

    The expanded-matmul algebra of `assign_ref`, in the input dtype, so
    the top-1 column equals `assign_ref`; ties go to the lower index, and
    slots beyond the valid set are (inf, -1).  Masked center rows are
    zeroed before the matmul, so NaN or inf in padded slots can neither
    surface nor poison a valid column.
    """
    if mask is not None:
        centers = torch.where(mask[:, None], centers, 0)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=-1)[None, :]
    d2 = torch.clamp_min(x2 + c2 - 2.0 * (x @ centers.T), 0.0)
    if mask is not None:
        d2 = torch.where(mask[None, :], d2, torch.inf)
    ids = torch.arange(centers.shape[0], dtype=torch.int32,
                       device=x.device).expand(x.shape[0], -1)
    return _select(d2, ids, k)


def topk_multiprobe_ref(x: torch.Tensor, fine: torch.Tensor,
                        fine_ids: torch.Tensor, fine_mask: torch.Tensor,
                        cells: torch.Tensor, member: torch.Tensor, k: int):
    """Multi-probe top-k over a two-level (cell -> shard) layout.

    x (B, D); fine (n_cells, S, D) shard rows; fine_ids / fine_mask
    (n_cells, S) flat ids (-1 pad) / validity; cells (U,) int32, the
    probed-cell union packed ascending with -1 pad; member (B, U) bool,
    query b may see cell cells[u].  The probed shards are gathered into one
    (U*S, D) matrix and scored by one matmul shared by the microbatch;
    masked shard rows are zeroed first, membership masks only after the
    distance is formed.  Returns flat ids.
    """
    s = fine.shape[1]
    u = cells.shape[0]
    b = x.shape[0]
    cc = torch.clamp_min(cells, 0).long()
    g = fine[cc].reshape(u * s, -1)
    gids = fine_ids[cc].reshape(u * s)
    gmask = fine_mask[cc] & (cells >= 0)[:, None]
    gmask = gmask.reshape(u * s)
    g = torch.where(gmask[:, None], g, 0)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    g2 = torch.sum(g * g, dim=-1)[None, :]
    d2 = torch.clamp_min(x2 + g2 - 2.0 * (x @ g.T), 0.0)
    ok = gmask[None, :] & member[:, :, None].expand(b, u, s).reshape(b, u * s)
    d2 = torch.where(ok, d2, torch.inf)
    return _select(d2, gids.expand(x.shape[0], -1), k)
