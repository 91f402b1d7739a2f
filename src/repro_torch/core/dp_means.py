"""DP-means: serial (Alg. 1) and OCC-parallel (Alg. 3 + DPValidate Alg. 2).

The PyTorch port of `repro.core.dp_means`: `DPMeansTransaction` run by
`OCCEngine`, the serial algorithm, and the `occ_dp_means` wrapper.

Serial equivalence (Thm 3.1): within an epoch, non-proposed points (whose
assignment depends only on C^{t-1}) are ordered before proposed points,
which are validated in global index order.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device, to_device
from repro_torch.core.engine import (
    OCCEngine, accumulate_pass_stats, resolve_assignments,
)
from repro_torch.core.objective import dp_means_objective, sq_dists
from repro_torch.core.occ import (
    CenterPool, OCCStats, ValidatePre, make_pool, nearest_center,
    nearest_center_with_new, serial_validate,
)

__all__ = ["DPMeansResult", "DPMeansTransaction", "serial_dp_means_pass",
           "serial_dp_means", "occ_dp_means", "thm31_permutation"]


class DPMeansResult(NamedTuple):
    pool: CenterPool
    z: torch.Tensor             # (N,) int32 — assignment to pool slot
    stats: OCCStats             # per-epoch proposed / accepted counts
    send: torch.Tensor          # (N,) bool — point was sent to the validator
    epoch_of: torch.Tensor      # (N,) int32 — epoch each point was processed in
    n_iters: int
    objective: torch.Tensor


@lru_cache(maxsize=None)
def _lam2(lam: float, dtype: torch.dtype) -> float:
    """λ² rounded in `dtype` (λ cast first, as `jnp.asarray(lam, dtype)**2`),
    as a Python float: exactly representable in `dtype`, so comparing a
    tensor with it rounds nothing and needs no device tensor."""
    return float(torch.tensor(lam, dtype=dtype) ** 2)


def _dp_accept(lam2: float):
    """DPValidate accept rule: accept iff not within lambda of any center."""
    def accept_fn(pool: CenterPool, x_j, aux_j):
        d2, ref = nearest_center(pool, x_j)
        return d2 > lam2, x_j, ref
    return accept_fn


@dataclass(frozen=True)
class DPMeansTransaction:
    """DP-means as an OCC transaction: propose a point as a new cluster iff
    it is farther than lambda from every center of C^{t-1}."""
    lam: float
    k_max: int = 256

    def init_pool(self, x):
        return make_pool(self.k_max, x.shape[-1], x.dtype, x.device)

    def make_state(self, x, offset: int = 0):
        return ()

    def propose(self, pool, x_e, state_e):
        d2, idx = nearest_center(pool, x_e)
        # Threshold in d2's dtype (f32 from the kernel) so propose and the
        # validator round λ² alike; (d2, idx) are threaded to the validator.
        return d2 > _lam2(self.lam, d2.dtype), x_e, (d2, idx), idx

    def precompute_accept(self, pool, payload_c, aux_c, count0):
        d2s, idxs = aux_c
        return ValidatePre(d2s, idxs, sq_dists(payload_c, payload_c), None)

    def accept_pre(self, d2_cur, aux_j):
        return d2_cur > _lam2(self.lam, d2_cur.dtype)

    def accept(self, pool, x_j, aux_j, count0):
        # REFERENCE ONLY (core/_reference.py).
        d2s_j, idxs_j = aux_j
        d2, ref = nearest_center_with_new(pool, x_j, d2s_j, idxs_j, count0)
        return d2 > _lam2(self.lam, d2.dtype), x_j, ref

    def writeback(self, send, slots, outs, safe, valid):
        return resolve_assignments(send, slots, outs, safe, valid)

    def empty_assign(self, device):
        return torch.zeros((0,), dtype=torch.int32, device=device)

    def refine(self, pool, x, z):
        return _recompute_means(x, z, pool)

    def objective(self, x, z, pool):
        return dp_means_objective(x, pool.centers, self.lam, pool.mask)


# ---------------------------------------------------------------------------
# Serial DP-means (Alg. 1)
# ---------------------------------------------------------------------------

def serial_dp_means_pass(x, lam: float, k_max: int,
                         pool: CenterPool | None = None,
                         device: str | torch.device = "cuda"):
    """One serial pass of Alg. 1's inner loop: scan points in order,
    assigning to the nearest center or creating a new one (the OCC run with
    P = b = 1).  Returns (pool, z)."""
    x = to_device(x, resolve_device(device)).contiguous()
    if pool is None:
        pool = make_pool(k_max, x.shape[-1], x.dtype, x.device)
    send = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    pool, slots, refs = serial_validate(pool, send, x,
                                        _dp_accept(_lam2(lam, x.dtype)))
    z = torch.where(slots >= 0, slots, refs).to(torch.int32)
    return pool, z


def _segment_sums(values: torch.Tensor, seg: torch.Tensor, num: int):
    """Deterministic per-segment sums of the rows of `values` (N, C), in
    float64: rows sorted stably by segment, one prefix sum per column, and
    a difference at the segment bounds.  No atomics, so the bits are the
    same on every run on the card (`index_add_` would not be)."""
    order = torch.argsort(seg, stable=True)
    bounds = torch.searchsorted(seg[order],
                                torch.arange(num + 1, device=seg.device))
    cols = values.to(torch.float64)[order].T.contiguous()
    csum = torch.cat([cols.new_zeros((cols.shape[0], 1)),
                      torch.cumsum(cols, dim=1)], dim=1)
    return (csum[:, bounds[1:]] - csum[:, bounds[:-1]]).T.contiguous()


def _recompute_means(x: torch.Tensor, z: torch.Tensor, pool: CenterPool) -> CenterPool:
    """Second phase of Alg. 1/3: mu_k <- Mean({x_i | z_i = k}).  Slots with
    no assigned points keep their previous vector."""
    k_max, d = pool.centers.shape
    zc = z.clamp(0, k_max - 1).long()
    w = (z >= 0).to(x.dtype)
    sums = _segment_sums(torch.cat([x * w[:, None], w[:, None]], 1), zc, k_max)
    cnts = sums[:, d]
    means = (sums[:, :d] / torch.clamp_min(cnts, 1.0)[:, None]).to(x.dtype)
    keep = (cnts > 0)[:, None] & pool.mask[:, None]
    return pool._replace(
        centers=torch.where(keep, means, pool.centers).contiguous())


def serial_dp_means(x, lam: float, k_max: int = 256, max_iters: int = 20,
                    device: str | torch.device = "cuda") -> DPMeansResult:
    """Full serial DP-means (Alg. 1): alternate the assignment/creation pass
    with the centroid recomputation until assignments are fixed."""
    x = to_device(x, resolve_device(device)).contiguous()
    n = x.shape[0]
    pool = make_pool(k_max, x.shape[-1], x.dtype, x.device)
    z_prev = None
    it = 0
    for it in range(1, max_iters + 1):
        pool, z = serial_dp_means_pass(x, lam, k_max, pool, device=x.device)
        pool = _recompute_means(x, z, pool)
        if z_prev is not None and torch.equal(z, z_prev):
            break
        z_prev = z
    obj = dp_means_objective(x, pool.centers, lam, pool.mask)
    t = torch.zeros((1,), dtype=torch.int32, device=x.device)
    return DPMeansResult(pool, z, OCCStats(t, t),
                         torch.zeros((n,), dtype=torch.bool, device=x.device),
                         torch.zeros((n,), dtype=torch.int32, device=x.device),
                         it, obj)


# ---------------------------------------------------------------------------
# OCC DP-means (Alg. 3) — convenience wrapper over the engine
# ---------------------------------------------------------------------------

def occ_dp_means(
    x,
    lam: float,
    pb: int,
    k_max: int = 256,
    max_iters: int = 1,
    bootstrap: bool = False,
    validate_cap: int | None | str = None,
    scan_mode: str = "serial",
    device: str | torch.device = "cuda",
    mesh=None,
    data_axis: str = "data",
) -> DPMeansResult:
    """OCC DP-means (Alg. 3): `DPMeansTransaction` under `OCCEngine`.

    max_iters: outer passes (1 = the paper's Fig-3 setting).  bootstrap:
    serially pre-process the first pb/16 points (paper §4.2).  validate_cap
    / scan_mode: see OCCEngine (bit-identical results).  mesh / data_axis:
    every rank of the mesh calls this alike; each epoch is proposed split
    over `data_axis` and validated on every rank (OCCEngine).
    """
    txn = DPMeansTransaction(lam, k_max)
    eng = OCCEngine(txn, pb, validate_cap=validate_cap, scan_mode=scan_mode,
                    device=device,
                    mesh=mesh, data_axis=data_axis)
    x = eng._x(x)
    n = x.shape[0]
    nb = min(n, max(1, pb // 16)) if bootstrap else 0

    z = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    send = torch.zeros((n,), dtype=torch.bool, device=x.device)
    epoch_of = torch.zeros((n,), dtype=torch.int32, device=x.device)
    stat_parts: list[OCCStats] = []
    epoch_base = 0
    z_prev = None
    it_done = 0
    pool = None
    for it in range(1, max_iters + 1):
        it_done = it
        if it == 1:
            res = eng.run(x, n_bootstrap=nb)
            z, send, epoch_of = res.assign, res.send, res.epoch_of
        else:
            # Bootstrapped points keep their serial-prefix assignment; later
            # passes re-run only the bulk-synchronous epochs.
            res = eng.run(x[nb:], pool=pool)
            z = torch.cat([z[:nb], res.assign])
            send = torch.cat([send[:nb], res.send])
            epoch_of = torch.cat([epoch_of[:nb], res.epoch_of + epoch_base])
        stat_parts.append(res.stats)
        epoch_base += res.stats.proposed.shape[0]
        pool = txn.refine(res.pool, x, z)
        if z_prev is not None and torch.equal(z, z_prev):
            break
        z_prev = z
    stats = accumulate_pass_stats(stat_parts)
    obj = txn.objective(x, z, pool)
    return DPMeansResult(pool, z, stats, send, epoch_of, it_done, obj)


def thm31_permutation(result: DPMeansResult, n: int) -> np.ndarray:
    """The serial order of Thm 3.1 from an OCC run: epochs in order; within
    an epoch, non-validated points (index order) precede validated points
    (validation = index order)."""
    send = result.send.cpu().numpy()
    epoch = result.epoch_of.cpu().numpy()
    idx = np.arange(n)
    order = np.lexsort((idx, send.astype(np.int32), epoch))
    return idx[order]
