"""BP-means: serial (Alg. 7) and OCC-parallel (Alg. 6 + BPValidate Alg. 8).

The PyTorch port of `repro.core.bp_means`: `BPMeansTransaction` run by
`OCCEngine`, the serial algorithm, and the `occ_bp_means` wrapper.

Latent binary features: x_i ~ sum_k z_ik f_k.  A point's transaction is a
greedy coordinate pass setting each z_ik in feature order, then, if the
residual norm exceeds λ, a proposal of the residual as a new feature.
BPValidate refits each proposal against the features accepted this epoch
and accepts what remains (the Gram-carry scan,
`occ.precomputed_validate_gram`).  The per-point state is the (N, K_max)
bool assignment.

Where the reference scans all K_max features, `coordinate_pass` loops to
the pool count (one host read a call): a slot at or past the count is
masked out and zero, so it decides nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch._device import resolve_device, to_device
from repro_torch.core.dp_means import _lam2
from repro_torch.core.engine import OCCEngine, accumulate_pass_stats
from repro_torch.core.objective import bp_means_objective
from repro_torch.core.occ import (
    CenterPool, OCCStats, ValidatePre, make_pool, serial_validate,
)

__all__ = ["BPMeansResult", "BPMeansTransaction", "coordinate_pass",
           "serial_bp_means_pass", "serial_bp_means", "occ_bp_means"]


class BPMeansResult(NamedTuple):
    pool: CenterPool            # features live in pool.centers
    z: torch.Tensor             # (N, K_max) bool
    stats: OCCStats
    send: torch.Tensor
    epoch_of: torch.Tensor
    n_iters: int
    objective: torch.Tensor


def coordinate_pass(x: torch.Tensor, z0: torch.Tensor, pool: CenterPool,
                    feat_mask: torch.Tensor | None = None):
    """Greedy single pass over features in order (Alg. 7 inner loop).

    x: (B, D), z0: (B, K_max) bool.  For each feature k in index order,
    z_k = 1 iff 2 r·f_k > ||f_k||^2 with r excluding f_k's current term.
    Returns (z, residual) with residual = x - z F.  The loop runs over
    [0, pool.count): 5 launches a feature."""
    mask = pool.mask if feat_mask is None else feat_mask
    centers = pool.centers
    zm = z0 & mask[None, :]
    zf = zm.to(x.dtype)
    r = x - zf @ centers
    # 2 r·f_k > inf never holds: a masked-out feature is never taken.
    thr = torch.where(mask, torch.sum(centers * centers, dim=-1), torch.inf)
    zt = torch.zeros(zm.shape[::-1], dtype=x.dtype, device=x.device)
    for k in range(int(pool.count)):
        f_k = centers[k]
        r = torch.addcmul(r, zf[:, k:k + 1], f_k)          # r_excl
        torch.gt((r @ f_k) * 2.0, thr[k], out=zt[k])
        r = torch.addcmul(r, zt[k, :, None], f_k, value=-1.0)
    return zt.T.bool(), r


def _created_rows(slots: torch.Tensor, k_max: int) -> torch.Tensor:
    """(B, K_max) bool: one-hot of each point's accepted slot (or all-False)."""
    return slots[:, None] == torch.arange(k_max, device=slots.device)


@dataclass(frozen=True)
class BPMeansTransaction:
    """OCC BP-means as a transaction (Alg. 6 optimistic phase + Alg. 8
    BPValidate): fit each point against C^{t-1} and propose the residual;
    the validator refits proposals against this epoch's accepted
    features before deciding."""
    lam: float
    k_max: int = 256
    init_mean: bool = True

    def init_pool(self, x):
        pool = make_pool(self.k_max, x.shape[-1], x.dtype, x.device)
        if not self.init_mean:
            return pool
        # Alg. 7 initialization: f_1 = mean(x), z_i1 = 1.  The engine hands
        # this the pass's first Pb block, so batch and streaming runs seed
        # the same feature.
        pool.centers[0] = torch.mean(x, dim=0)
        pool.mask[0] = True
        pool.count.fill_(1)
        return pool

    def make_state(self, x, offset: int = 0):
        z = torch.zeros((x.shape[0], self.k_max), dtype=torch.bool,
                        device=x.device)
        if self.init_mean:
            z[:, 0] = True
        return z

    def propose(self, pool, x_e, z0_e):
        z_old, r = coordinate_pass(x_e, z0_e, pool)
        resid2 = torch.sum(r * r, dim=-1)
        return resid2 > _lam2(self.lam, x_e.dtype), r, None, z_old

    def precompute_accept(self, pool, payload_c, aux_c, count0):
        # Every feature the refit can touch is a signed combination of sent
        # payloads, so the payload Gram matrix covers every dot product the
        # scan needs; the engine routes this to the Gram-carry scan.
        return ValidatePre(None, None, None, aux_c,
                           gram=payload_c @ payload_c.T)

    def accept_pre(self, resid2, aux_j):
        return resid2 > _lam2(self.lam, resid2.dtype)

    def accept(self, pool, f_new, aux_j, count0):
        # REFERENCE ONLY (core/_reference.py): BPValidate by explicit
        # D-dimensional refit against the features accepted this epoch.
        k_max = pool.centers.shape[0]
        epoch_mask = pool.mask & (torch.arange(k_max, device=f_new.device)
                                  >= count0)
        zref, r = coordinate_pass(
            f_new[None, :],
            torch.zeros((1, k_max), dtype=torch.bool, device=f_new.device),
            pool, epoch_mask)
        resid2 = torch.sum(r[0] * r[0])
        return resid2 > _lam2(self.lam, f_new.dtype), r[0], zref[0]

    def writeback(self, send, slots, outs, safe, valid):
        created = _created_rows(slots, self.k_max)
        z = safe | (outs & send[:, None]) | created
        return z & valid[:, None]

    def empty_assign(self, device):
        return torch.zeros((0, self.k_max), dtype=torch.bool, device=device)

    def refine(self, pool, x, z):
        return _reestimate(x, z, pool)

    def objective(self, x, z, pool):
        return bp_means_objective(x, z, pool.centers, self.lam, pool.mask)


# ---------------------------------------------------------------------------
# Serial BP-means (Alg. 7)
# ---------------------------------------------------------------------------

def _serial_bp_pass(x, z, pool, lam2: float):
    """Serial pass: each point fits against the current feature set (which
    grows during the pass), then may create its residual as a feature."""
    def accept_fn(p: CenterPool, x_j, z_j):
        znew, r = coordinate_pass(x_j[None, :], z_j[None, :], p)
        resid2 = torch.sum(r[0] * r[0])
        return resid2 > lam2, r[0], znew[0]

    send = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    pool, slots, z_out = serial_validate(pool, send, x, accept_fn, aux=z)
    return pool, z_out | _created_rows(slots, pool.centers.shape[0])


def _reestimate(x, z, pool, ridge: float = 1e-6):
    """F <- (Z^T Z)^{-1} Z^T X restricted to valid features."""
    zf = (z & pool.mask[None, :]).to(x.dtype)
    ztz = zf.T @ zf
    ztx = zf.T @ x
    m = pool.mask
    diag = torch.where(m, ridge, 1.0).to(x.dtype)
    a = ztz * (m[:, None] & m[None, :]) + torch.diag(diag)
    f = torch.linalg.solve(a, ztx * m[:, None])
    return pool._replace(centers=torch.where(m[:, None], f, pool.centers))


def serial_bp_means_pass(x, lam: float, k_max: int, pool=None, z=None,
                         init_mean: bool = True,
                         device: str | torch.device = "cuda"):
    """One serial pass (Alg. 7's inner loop).  Without `pool` it starts
    from `init_pool` over all of x and `make_state`.  Returns (pool, z)."""
    x = to_device(x, resolve_device(device)).contiguous()
    if pool is None:
        txn = BPMeansTransaction(lam, k_max, init_mean)
        pool = txn.init_pool(x)
        z = txn.make_state(x)
    return _serial_bp_pass(x, to_device(z, x.device), pool,
                           _lam2(lam, x.dtype))


def serial_bp_means(x, lam: float, k_max: int = 256, max_iters: int = 10,
                    init_mean: bool = True,
                    device: str | torch.device = "cuda") -> BPMeansResult:
    """Full serial BP-means (Alg. 7): passes and re-estimation until the
    assignments are fixed."""
    x = to_device(x, resolve_device(device)).contiguous()
    n = x.shape[0]
    pool, z = serial_bp_means_pass(x, lam, k_max, init_mean=init_mean,
                                   device=x.device)
    pool = _reestimate(x, z, pool)
    it = 1
    for it in range(2, max_iters + 1):
        z_prev = z
        pool, z = serial_bp_means_pass(x, lam, k_max, pool, z, device=x.device)
        pool = _reestimate(x, z, pool)
        if torch.equal(z, z_prev):
            break
    obj = bp_means_objective(x, z, pool.centers, lam, pool.mask)
    t = torch.zeros((1,), dtype=torch.int32, device=x.device)
    return BPMeansResult(pool, z, OCCStats(t, t),
                         torch.zeros((n,), dtype=torch.bool, device=x.device),
                         torch.zeros((n,), dtype=torch.int32, device=x.device),
                         it, obj)


# ---------------------------------------------------------------------------
# OCC BP-means (Alg. 6) — convenience wrapper over the engine
# ---------------------------------------------------------------------------

def occ_bp_means(
    x,
    lam: float,
    pb: int,
    k_max: int = 256,
    max_iters: int = 1,
    init_mean: bool = True,
    bootstrap: bool = False,
    validate_cap: int | None | str = None,
    device: str | torch.device = "cuda",
    mesh=None,
    data_axis: str = "data",
) -> BPMeansResult:
    """OCC BP-means (Alg. 6): `BPMeansTransaction` under `OCCEngine`, with
    a refine after every pass.  `init_mean` seeds f₁ from the first Pb
    block's mean, so batch and streaming runs agree; `bootstrap` serially
    pre-processes the first pb/16 points; `mesh` / `data_axis` as in
    `occ_dp_means`."""
    txn = BPMeansTransaction(lam, k_max, init_mean)
    eng = OCCEngine(txn, pb, validate_cap=validate_cap, device=device,
                    mesh=mesh, data_axis=data_axis)
    x = eng._x(x)
    n = x.shape[0]
    nb = min(n, max(1, pb // 16)) if bootstrap else 0

    z = txn.make_state(x)
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
            res = eng.run(x, state=z, n_bootstrap=nb)
            z, send, epoch_of = res.assign, res.send, res.epoch_of
        else:
            # Bootstrapped points keep their serial-prefix assignment; later
            # passes re-run only the bulk-synchronous epochs.
            res = eng.run(x[nb:], pool=pool, state=z[nb:])
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
    return BPMeansResult(pool, z, stats, send, epoch_of, it_done, obj)
