"""Dispatch between the hand-written kernels and their plain versions.

The device of the input decides, never a probe of the machine:

  backend="auto"   -> a CUDA tensor launches the kernel (or the call raises),
                      a CPU tensor runs the plain version
  backend="cuda"   -> the kernel; raises for a tensor that is not on a card
  backend="plain"  -> the plain version on any device (comparisons only)

There is no fallback: a CUDA tensor reaches the plain version only when
`backend="plain"` is asked for.  The serving primitives (`serve_assign`,
`serve_topk`, `serve_topk_multiprobe`) add the query-prefix mask of a
padded bucket.  Each kernel has a plain-int launch count,
raised by one where the kernel is launched and nowhere else, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dpmeans_assign import dpmeans_assign as _dpmeans_assign
from repro_torch.kernels.topk_stream import (
    topk_multiprobe_stream as _topk_mp_stream,
    topk_stream as _topk_stream,
)

__all__ = ["assign", "pairwise_argmin", "serve_assign", "serve_topk",
           "serve_topk_multiprobe", "ASSIGN_LAUNCHES",
           "PAIRWISE_ARGMIN_LAUNCHES", "TOPK_LAUNCHES", "TOPK_MP_LAUNCHES",
           "reset_launch_counts"]

ASSIGN_LAUNCHES = 0
PAIRWISE_ARGMIN_LAUNCHES = 0
TOPK_LAUNCHES = 0
TOPK_MP_LAUNCHES = 0


def reset_launch_counts() -> None:
    global ASSIGN_LAUNCHES, PAIRWISE_ARGMIN_LAUNCHES, TOPK_LAUNCHES, \
        TOPK_MP_LAUNCHES
    ASSIGN_LAUNCHES = PAIRWISE_ARGMIN_LAUNCHES = 0
    TOPK_LAUNCHES = TOPK_MP_LAUNCHES = 0


def _use_kernel(x: torch.Tensor, backend: str) -> bool:
    if backend == "plain":
        return False
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if x.device.type == "cuda":
        return True
    if backend == "cuda":
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got {x.device}")
    return False


def _count_tensor(count, k: int, device) -> torch.Tensor:
    if count is None:
        count = k
    if isinstance(count, torch.Tensor):
        return count.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(count), dtype=torch.int32, device=device)


def assign(x, centers, mask=None, count=None, backend: str = "auto"):
    """Nearest-center assignment: THE OCC propose primitive.

    x (N, D), centers (K, D), mask (K,) bool, count (optional int or
    int32 tensor) bounding the valid prefix.  Returns (d2min (N,), idx (N,)
    int32) with (inf, -1) where no valid center exists.  d2min is f32 from
    the kernel and the input dtype from the plain version, as in the JAX
    package.  The kernel skips center tiles past `count`; the plain version
    folds `count` into the mask, which the pool invariant makes a no-op.
    """
    global ASSIGN_LAUNCHES
    k = centers.shape[0]
    if _use_kernel(x, backend):
        if mask is None:
            mask = torch.ones((k,), dtype=torch.bool, device=x.device)
        out = _dpmeans_assign(x, centers, mask, _count_tensor(count, k, x.device))
        ASSIGN_LAUNCHES += 1
        return out
    if mask is None:
        mask = torch.ones((k,), dtype=torch.bool, device=x.device)
    if count is not None:
        mask = mask & (torch.arange(k, device=x.device) < count)
    return _ref.assign_ref(x, centers, mask)


def pairwise_argmin(x, centers, mask=None, backend: str = "auto"):
    """Kernel/plain pair without the count restriction, for parity tests.
    As in the JAX package the plain version computes in f32 and returns
    argmin 0 (not -1) for a row with no valid center; the kernel returns -1
    there."""
    global PAIRWISE_ARGMIN_LAUNCHES
    k = centers.shape[0]
    if _use_kernel(x, backend):
        if mask is None:
            mask = torch.ones((k,), dtype=torch.bool, device=x.device)
        out = _dpmeans_assign(x, centers, mask, _count_tensor(None, k, x.device))
        PAIRWISE_ARGMIN_LAUNCHES += 1
        return out
    return _ref.pairwise_argmin_ref(x, centers, mask)


def _mask_queries(d2, idx, n_valid):
    """Rows at or past `n_valid` (an int or a device scalar) become
    (inf, -1): padding rows of a bucket can never alias a real answer."""
    if n_valid is None:
        return d2, idx
    ok = torch.arange(d2.shape[0], device=d2.device) < n_valid
    if d2.dim() == 2:
        ok = ok[:, None]
    return torch.where(ok, d2, torch.inf), torch.where(ok, idx, -1)


def serve_assign(x, centers, mask=None, count=None, n_valid=None,
                 backend: str = "auto"):
    """Bucket-padded assignment, the serving plane's query primitive:
    `assign` plus query-prefix masking (`n_valid` real rows; the padding
    rows of the bucket come back as (inf, -1))."""
    d2, idx = assign(x, centers, mask, count=count, backend=backend)
    return _mask_queries(d2, idx, n_valid)


def _pad_columns(d2, idx, k: int):
    """(inf, -1) columns up to k (k may exceed the center capacity)."""
    pad = k - d2.shape[1]
    if pad <= 0:
        return d2, idx
    n = d2.shape[0]
    return (torch.cat([d2, d2.new_full((n, pad), torch.inf)], 1),
            torch.cat([idx, idx.new_full((n, pad), -1)], 1))


def _next_pow2(n: int) -> int:
    # A local copy of core.occ.next_pow2: core.occ imports this module.
    p = 1
    while p < n:
        p <<= 1
    return p


def serve_topk(x, centers, k: int, mask=None, count=None, n_valid=None,
               backend: str = "auto"):
    """k nearest centers per query: (d2 (N, k) ascending, idx (N, k) int32).

    The same count-prefix and query-prefix masking as `serve_assign`;
    masked, padded and beyond-count slots are (inf, -1), and distance ties
    go to the lower index on both paths, so `topk[:, :1]` equals
    `serve_assign`.  The kernel reads `count` on the device and stops its
    center loop there.  On the plain path a host-int `count` first slices
    the centers to the power-of-two active prefix (min 8), which changes no
    surviving distance.  k may exceed the capacity: the extra columns are
    (inf, -1).  The kernel takes k <= 64 and raises a ValueError beyond.
    """
    global TOPK_LAUNCHES
    kc = centers.shape[0]
    if mask is None:
        mask = torch.ones((kc,), dtype=torch.bool, device=centers.device)
    if _use_kernel(x, backend):
        kk = min(k, kc)
        d2, idx = _topk_stream(x, centers, mask,
                               _count_tensor(count, kc, x.device), kk)
        TOPK_LAUNCHES += 1
    else:
        if count is not None:
            mask = mask & (torch.arange(kc, device=centers.device) < count)
        if count is not None and not isinstance(count, torch.Tensor):
            kp = min(kc, max(_next_pow2(max(int(count), 1)), 8))
            centers, mask = centers[:kp], mask[:kp]
        d2, idx = _ref.topk_ref(x, centers, min(k, centers.shape[0]), mask)
    d2, idx = _pad_columns(d2, idx, k)
    return _mask_queries(d2, idx, n_valid)


def serve_topk_multiprobe(x, fine, fine_ids, fine_mask, cells, member,
                          k: int, u_count=None, n_valid=None,
                          backend: str = "auto"):
    """Top-k over a hierarchical snapshot's probed fine shards.

    x (B, D); fine (n_cells, S, D), fine_ids / fine_mask (n_cells, S) as
    `serving.snapshot.build_hier` lays them out; cells (U,) the
    microbatch's probed-cell union (packed ascending, -1 pad); member (B, U)
    per-query membership; `u_count` the union's real length (an int or a
    device scalar).  Returns (d2 (B, k), idx (B, k)) with idx flat-snapshot
    ids.  With every cell in the union and member all true the result
    equals `serve_topk` on the flat buffers (on the card bitwise, by the
    kernels' shared arithmetic).  The plain version gathers the union and
    ignores `u_count` (its padding ranks are -1 and match nothing).
    """
    global TOPK_MP_LAUNCHES
    if _use_kernel(x, backend):
        d2, idx = _topk_mp_stream(
            x, fine, fine_ids, fine_mask, cells, member,
            _count_tensor(u_count, cells.shape[0], x.device), k)
        TOPK_MP_LAUNCHES += 1
    else:
        d2, idx = _ref.topk_multiprobe_ref(x, fine, fine_ids, fine_mask,
                                           cells, member, k)
    return _mask_queries(d2, idx, n_valid)
