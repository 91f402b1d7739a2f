"""Online Facility Location: serial (Meyerson [17]) and OCC-parallel (Alg. 4/5).

The PyTorch port of `repro.core.ofl`: `OFLTransaction` run by `OCCEngine`,
the serial algorithm, and the `occ_ofl` wrapper.

Serial OFL opens x as a facility with probability min(1, d²/λ²), d the
distance to the nearest open facility.  Each point owns one uniform draw
u_i; it is sent iff u_i < min(1, d²/λ²) against C^{t-1} and accepted iff
u_i < min(1, d*²/λ²) against the current pool.  Since d* <= d the joint
event is the serial decision with the same u_i, so OCC and serial runs
agree draw for draw (App. B.3).

The draws are the JAX package's bit for bit: `point_uniforms` computes
`jax.random.uniform(jax.random.fold_in(key, i))` under threefry2x32 with
`jax_threefry_partitionable` on, in integer tensor arithmetic, so the same
key gives the same uniforms on the CPU, on the card and in the JAX
package.  They are counter-based in the global point index, so a stream
(`OCCEngine.partial_fit`) reproduces the one-shot run for any batching.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device, to_device
from repro_torch.core.dp_means import _lam2
from repro_torch.core.engine import OCCEngine, resolve_assignments
from repro_torch.core.objective import dp_means_objective, sq_dists
from repro_torch.core.occ import (
    CenterPool, OCCStats, ValidatePre, make_pool, nearest_center,
    nearest_center_with_new, serial_validate,
)

__all__ = ["OFLResult", "OFLTransaction", "point_uniforms", "serial_ofl",
           "occ_ofl"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class OFLResult(NamedTuple):
    pool: CenterPool
    z: torch.Tensor
    stats: OCCStats
    send: torch.Tensor
    epoch_of: torch.Tensor
    objective: torch.Tensor


def _key_words(key) -> tuple[int, int]:
    """Raw threefry key data (two uint32: a tuple, array or tensor) as two
    Python ints.  `jax.random.key(seed)` has the key data (0, seed)."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    k0, k1 = (int(v) for v in np.asarray(key).reshape(-1).astype(np.uint64))
    return k0 & _M32, k1 & _M32


def _threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 values.

    `key` is a pair of Python ints or of int64 tensors (one key per
    counter).  Returns the two output words, int64 in [0, 2^32)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def point_uniforms(key, n: int, offset: int = 0,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """One counter-based f32 uniform per global point index offset + i
    (wrapping at 2^32, as `fold_in`'s uint32 cast does) — shared by
    serial, OCC and streaming runs.

    Per index: `fold_in` gives f = threefry(key, (0, i)); `uniform` gives
    b = threefry(f, (0, 0)); u = bitcast_f32(((b0 ^ b1) >> 9) | 0x3F800000)
    - 1."""
    k0, k1 = _key_words(key)
    dev = resolve_device(device)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    idx = (idx + offset % 2**32) & _M32
    zero = torch.zeros_like(idx)
    f = _threefry2x32((k0, k1), zero, idx)
    b0, b1 = _threefry2x32(f, zero, zero)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


@lru_cache(maxsize=None)
def _lam2_on(lam: float, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """λ² rounded in `dtype` as a 0-d tensor on `device`: d2 / λ² is then a
    true division on the card too (a CPU scalar divisor makes CUDA multiply
    by its reciprocal)."""
    return torch.full((), _lam2(lam, dtype), dtype=dtype, device=device)


def _send_prob(d2: torch.Tensor, lam: float) -> torch.Tensor:
    """min(1, d²/λ²) in d2's dtype; an empty pool (d² = inf) gives 1."""
    return torch.clamp_max(d2 / _lam2_on(lam, d2.dtype, d2.device), 1.0)


def _ofl_accept(lam: float):
    def accept_fn(pool: CenterPool, x_j, u_j):
        d2, ref = nearest_center(pool, x_j)
        return u_j < _send_prob(d2, lam), x_j, ref
    return accept_fn


@dataclass(frozen=True)
class OFLTransaction:
    """OCC Online Facility Location as a transaction (Alg. 4/5): the
    per-point state is its counter-based uniform, which makes the validator
    decision the exact serial decision (App. B.3).  `key` is the raw key
    data, two uint32."""
    lam: float
    k_max: int
    key: Any

    def __post_init__(self):
        object.__setattr__(self, "key", _key_words(self.key))

    def init_pool(self, x):
        return make_pool(self.k_max, x.shape[-1], x.dtype, x.device)

    def make_state(self, x, offset: int = 0):
        return point_uniforms(self.key, x.shape[0], offset, device=x.device)

    def propose(self, pool, x_e, u_e):
        d2, idx = nearest_center(pool, x_e)
        # Threshold in d2's dtype (f32 from the kernel) so propose and the
        # validator round λ² alike; (u, d2, idx) go to the validator.
        return u_e < _send_prob(d2, self.lam), x_e, (u_e, d2, idx), idx

    def precompute_accept(self, pool, payload_c, aux_c, count0):
        u, d2s, idxs = aux_c
        return ValidatePre(d2s, idxs, sq_dists(payload_c, payload_c), u)

    def accept_pre(self, d2_cur, u_j):
        return u_j < _send_prob(d2_cur, self.lam)

    def accept(self, pool, x_j, aux_j, count0):
        # REFERENCE ONLY (core/_reference.py): only the epoch's new slots
        # are measured fresh.
        u_j, d2s_j, idxs_j = aux_j
        d2, ref = nearest_center_with_new(pool, x_j, d2s_j, idxs_j, count0)
        return u_j < _send_prob(d2, self.lam), x_j, ref

    def writeback(self, send, slots, outs, safe, valid):
        return resolve_assignments(send, slots, outs, safe, valid)

    def empty_assign(self, device):
        return torch.zeros((0,), dtype=torch.int32, device=device)

    def refine(self, pool, x, z):
        return pool   # single-pass algorithm: no refinement phase

    def objective(self, x, z, pool):
        return dp_means_objective(x, pool.centers, self.lam, pool.mask)


def serial_ofl(x, u, lam: float, k_max: int,
               device: str | torch.device = "cuda"):
    """Serial OFL over the points in the given order, with per-point
    uniforms u.  Returns (pool, z)."""
    dev = resolve_device(device)
    x = to_device(x, dev).contiguous()
    u = to_device(u, dev)
    pool = make_pool(k_max, x.shape[-1], x.dtype, dev)
    send = torch.ones((x.shape[0],), dtype=torch.bool, device=dev)
    pool, slots, refs = serial_validate(pool, send, x, _ofl_accept(lam), aux=u)
    z = torch.where(slots >= 0, slots, refs).to(torch.int32)
    return pool, z


def occ_ofl(
    x,
    lam: float,
    pb: int,
    key,
    k_max: int = 256,
    validate_cap: int | None | str = None,
    scan_mode: str = "serial",
    device: str | torch.device = "cuda",
    mesh=None,
    data_axis: str = "data",
) -> OFLResult:
    """OCC Online Facility Location (Alg. 4): `OFLTransaction` under
    `OCCEngine`.  Single pass by construction; `mesh` / `data_axis` as in
    `occ_dp_means`."""
    txn = OFLTransaction(lam, k_max, key)
    eng = OCCEngine(txn, pb, validate_cap=validate_cap, scan_mode=scan_mode,
                    device=device,
                    mesh=mesh, data_axis=data_axis)
    x = eng._x(x)
    res = eng.run(x)
    obj = txn.objective(x, res.assign, res.pool)
    return OFLResult(res.pool, res.assign, res.stats, res.send,
                     res.epoch_of, obj)
