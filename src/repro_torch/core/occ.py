"""Generic Optimistic Concurrency Control (OCC) scaffolding — paper §1.1.

The PyTorch port of `repro.core.occ`.  Each epoch every point proposes
against the replicated state C^{t-1} (one batched nearest-center kernel
launch over the epoch); the proposals that may violate serial invariants
are validated in global index order; the accepted centers are written back
in one batched pool write.

What changed against the JAX version:
  * `lax.scan` becomes a Python loop of tensor ops on the device.  The
    serial accept scan (`precomputed_validate`) reads nothing back to the
    host inside a pass: its carry stays on the device.  It is launch-bound
    on a card (a few launches per step); a CUDA graph or a scan kernel is
    later work.
  * The log-depth resolution's `while_loop` tests its condition on the host
    (one sync per round), and its overflow fallback is a Python `if` on one
    synced bool per epoch.
  * The BP-means Gram-carry scan (`precomputed_validate_gram`) keeps its
    inner trip count on the host: one host read an epoch (the sent slots
    and the pool count) and one a sent step (its verdict).
  * `.at[].set(mode="drop")` becomes a write into a copy of the buffer with
    one spare row that takes the dropped writes.
  * Functions never modify the pool they are given, except
    `pool_append_serial`, which appends in place (its caller owns a copy).

The global center set C lives in a fixed-capacity masked buffer
(`CenterPool`); overflow is detected and surfaced.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core.objective import sq_dists
from repro_torch.kernels import ops as _kops

__all__ = [
    "CenterPool", "make_pool", "pool_append_serial", "block_epochs",
    "next_pow2", "serial_validate", "nearest_center",
    "nearest_center_with_new", "OCCStats", "ValidatePre",
    "precomputed_validate", "precomputed_validate_gram", "logdepth_validate",
    "precomputed_gather_validate", "effective_cap", "tree_map",
    "tree_leaves", "tree_unflatten",
]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map `fn` over the tensors of nested tuples / NamedTuples (None and
    () pass through) — the small pytree the transactions use for aux and
    per-point state."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        items = [tree_map(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a `tree_map` tree in JAX's tree-flatten order (None
    and () contribute no leaf) — the leaf order of a PROPOSE frame."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree shaped like `like` whose tensors are `leaves`, taken in
    `tree_leaves` order (the inverse of `tree_leaves` on that shape)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has tensors")
    return out


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


class CenterPool(NamedTuple):
    """Fixed-capacity masked buffer holding the global state C."""
    centers: torch.Tensor   # (K_max, D)
    mask: torch.Tensor      # (K_max,) bool — slot holds a validated center
    count: torch.Tensor     # () int32 — number of valid slots (== mask.sum())
    overflow: torch.Tensor  # () bool — a validated accept did not fit


class OCCStats(NamedTuple):
    """Per-epoch bookkeeping: points sent to the validator, proposals
    accepted, and the validator cap each epoch ran with (None for the
    serial algorithms' placeholder stats)."""
    proposed: torch.Tensor  # (T,) int32
    accepted: torch.Tensor  # (T,) int32
    cap: torch.Tensor | None = None  # (T,) int32


def make_pool(k_max: int, dim: int, dtype=torch.float32,
              device: torch.device | str = "cuda") -> CenterPool:
    """An empty pool on `device` (the card unless the caller asks for the
    CPU; without a card "cuda" raises)."""
    device = resolve_device(device)
    return CenterPool(
        centers=torch.zeros((k_max, dim), dtype=dtype, device=device),
        mask=torch.zeros((k_max,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def nearest_center(pool: CenterPool, x: torch.Tensor,
                   backend: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Min squared distance and argmin over valid centers.

    x: (..., D).  Returns (d2min (...,), idx (...,)).  Empty pool -> +inf / -1.
    Routed through `kernels/ops.assign`: the CUDA kernel for a tensor on the
    card (one-row calls included), the plain version on the CPU.
    """
    xf = x.reshape(-1, x.shape[-1])
    d2min, idx = _kops.assign(xf, pool.centers, pool.mask, count=pool.count,
                              backend=backend)
    batch_shape = x.shape[:-1]
    return d2min.reshape(batch_shape), idx.reshape(batch_shape)


def nearest_center_with_new(pool: CenterPool, x: torch.Tensor,
                            d2_start: torch.Tensor, idx_start: torch.Tensor,
                            count0: torch.Tensor):
    """`nearest_center` over C^{t-1} ∪ this epoch's accepts, given the
    distance to C^{t-1} from the propose phase.  Only slots >= count0 are
    measured fresh; on a distance tie the epoch-start center wins.
    x: (D,) — one validator step (reference validator only)."""
    k_max = pool.centers.shape[0]
    arange = torch.arange(k_max, device=x.device)
    new_mask = pool.mask & (arange >= count0)
    d2 = sq_dists(x[None, :], pool.centers)[0]
    d2 = torch.where(new_mask, d2, torch.inf)
    best_new, arg_new = torch.min(d2, dim=0)
    use_new = best_new < d2_start
    idx = torch.where(use_new, arg_new.to(torch.int32), idx_start)
    return torch.minimum(d2_start, best_new), idx


def pool_append_serial(pool: CenterPool, x: torch.Tensor, do: torch.Tensor
                       ) -> tuple[CenterPool, torch.Tensor]:
    """Append x at slot `count` if `do` (a bool tensor), IN PLACE on the
    pool's buffers.  Returns (pool, slot): the written index, or -1 when
    not written / overflowed.  No host sync."""
    k_max = pool.centers.shape[0]
    fits = pool.count < k_max
    write = do & fits
    slot = torch.where(write, pool.count, -1)
    idx = pool.count.clamp(0, k_max - 1).long()
    row = pool.centers[idx]
    pool.centers[idx] = torch.where(write, x.to(pool.centers.dtype), row)
    pool.mask[idx] = pool.mask[idx] | write
    count = pool.count + write.to(torch.int32)
    overflow = pool.overflow | (do & ~fits)
    return CenterPool(pool.centers, pool.mask, count, overflow), slot


def block_epochs(n: int, pb: int) -> int:
    """Number of bulk-synchronous epochs for n points with Pb points/epoch."""
    return max(1, math.ceil(n / pb))


def _copy_pool(pool: CenterPool) -> CenterPool:
    return CenterPool(*(t.clone() for t in pool))


def serial_validate(
    pool: CenterPool,
    send: torch.Tensor,             # (B,) bool — proposal flags in index order
    payload: torch.Tensor,          # (B, D)
    accept_fn: Callable[[CenterPool, torch.Tensor, Any], tuple],
    aux: Any = None,
) -> tuple[CenterPool, torch.Tensor, Any]:
    """The serializing validator: one step per proposal in global index
    order (Alg. 2 DPValidate generically).  `accept_fn(pool, x_j, aux_j) ->
    (accept, append_vec, out_j)`.  Returns (pool', slot (B,) int32 —
    accepted slot or -1, outs stacked over B).  Works on a copy of the
    pool; no host sync."""
    pool = _copy_pool(pool)
    b = send.shape[0]
    if aux is None:
        aux = torch.zeros((b,), dtype=torch.int32, device=send.device)
    slots, outs = [], []
    for j in range(b):
        aux_j = tree_map(lambda a: a[j], aux)
        accept, append_vec, out_j = accept_fn(pool, payload[j], aux_j)
        pool, slot = pool_append_serial(pool, append_vec, accept & send[j])
        slots.append(slot)
        outs.append(out_j)
    if not b:
        z = torch.zeros((0,), dtype=torch.int32, device=send.device)
        return pool, z, z
    return (pool, torch.stack(slots).to(torch.int32),
            tree_map(lambda *o: torch.stack(o), outs[0], *outs[1:]))


def effective_cap(cap: int | None, b: int) -> int:
    """The bounded master's compaction width for a width-b epoch — the one
    definition the validator compacts to and the engine records."""
    return b if cap is None or cap >= b else cap


def _compact_sent(send: torch.Tensor, cap: int):
    """Stable indices of the first `cap` sent proposals (ascending global
    order) + the sent_overflow flag (a device bool)."""
    b = send.shape[0]
    n_sent = torch.sum(send, dtype=torch.int32)
    if cap < b:
        sent_overflow = n_sent > cap
    else:
        sent_overflow = torch.zeros((), dtype=torch.bool, device=send.device)
    key = torch.where(send, torch.arange(b, device=send.device), b)
    order = torch.argsort(key, stable=True)[:cap]
    return order, sent_overflow


def _scatter_back(order: torch.Tensor, b: int, slots_c: torch.Tensor, outs_c):
    """Scatter compacted validator verdicts back to the full index space
    (`order` is a prefix of a permutation: its indices are distinct)."""
    slots = torch.full((b,), -1, dtype=torch.int32, device=slots_c.device)
    slots[order] = slots_c

    def back(o):
        full = torch.zeros((b,) + tuple(o.shape[1:]), dtype=o.dtype,
                           device=o.device)
        full[order] = o
        return full
    return slots, tree_map(back, outs_c)


def _write_rows(buf: torch.Tensor, rows: torch.Tensor, values) -> torch.Tensor:
    """A copy of `buf` with buf[rows] = values, where a row index equal to
    len(buf) is dropped (JAX's `.at[rows].set(..., mode="drop")`).  Indices
    below len(buf) must be distinct; the dropped writes all land in one
    spare row that is cut off again."""
    spare = torch.zeros((1,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                        device=buf.device)
    out = torch.cat([buf, spare])
    out[rows.long()] = values
    return out[:buf.shape[0]]


# ---------------------------------------------------------------------------
# Precomputed (D-free) validation
# ---------------------------------------------------------------------------

class ValidatePre(NamedTuple):
    """Everything D-dimensional the fast validator needs, batched once.

    d2_start:  (cap,)  min squared distance to the epoch-start centers.
    idx_start: (cap,)  int32 — that center's slot, -1 when the pool is empty.
    pair_d2:   (cap, cap)  payload pairwise squared distances.
    aux:       per-proposal decision scalars (leading dim cap), or None.
    gram:      (cap, cap)  payload inner products r_i · r_j of Gram-append
               transactions (BP-means, whose d2_start / idx_start /
               pair_d2 stay None); None for payload-append ones.
    """
    d2_start: torch.Tensor | None
    idx_start: torch.Tensor | None
    pair_d2: torch.Tensor | None
    aux: Any
    gram: torch.Tensor | None = None


def _commit(pool: CenterPool, payload_c: torch.Tensor, slots_c: torch.Tensor,
            count: torch.Tensor, overflow: torch.Tensor) -> CenterPool:
    """One batched pool write: appended slots are unique by construction."""
    k_max = pool.centers.shape[0]
    widx = torch.where(slots_c >= 0, slots_c, k_max)
    centers = _write_rows(pool.centers, widx, payload_c.to(pool.centers.dtype))
    mask = _write_rows(pool.mask, widx, True)
    return CenterPool(centers, mask, count, overflow)


def precomputed_validate(
    pool: CenterPool,
    send_c: torch.Tensor,           # (cap,) bool — compacted proposal flags
    payload_c: torch.Tensor,        # (cap, D)
    pre: ValidatePre,
    decide_fn: Callable[[torch.Tensor, Any], torch.Tensor],
) -> tuple[CenterPool, torch.Tensor, torch.Tensor]:
    """The serializing scan with ZERO D-dimensional work per step.

    Same serial semantics as `serial_validate`: step j takes the min of its
    distance to C^{t-1} and to the proposals appended before it (a masked
    row of `pair_d2`), decides, and appends if the pool has room.  The loop
    carries only what the next step needs (the appended set, the count);
    each step's best-new distance and index are recorded, and slots, refs
    and the overflow flag are formed from them after the loop — the same
    values the step-by-step scan of the JAX package produces.  No host
    sync.  Returns (pool', slots_c (cap,) int32, refs_c (cap,) int32).
    """
    cap = send_c.shape[0]
    k_max = pool.centers.shape[0]
    dev = send_c.device
    count0 = pool.count
    aux = pre.aux
    if aux is None:
        aux = torch.zeros((cap,), dtype=torch.int32, device=dev)
    d2_dtype = pre.pair_d2.dtype
    # pen[i] = 0 once proposal i is appended, inf before: row + pen is the
    # masked row of pair_d2 (x + 0 == x exactly).
    pen = torch.full((cap,), torch.inf, dtype=d2_dtype, device=dev)
    zero = torch.zeros((), dtype=d2_dtype, device=dev)
    inf = torch.full((), torch.inf, dtype=d2_dtype, device=dev)
    best_new = torch.empty((cap,), dtype=d2_dtype, device=dev)
    arg_new = torch.empty((cap,), dtype=torch.int64, device=dev)
    acc = torch.empty((cap,), dtype=torch.bool, device=dev)
    app = torch.empty((cap,), dtype=torch.bool, device=dev)
    count = count0.clone()
    rows, d2s, sends = pre.pair_d2.unbind(0), pre.d2_start.unbind(0), send_c.unbind(0)
    bests, args = best_new.unbind(0), arg_new.unbind(0)
    accs, apps, pens = acc.unbind(0), app.unbind(0), pen.unbind(0)
    for j in range(cap):
        torch.min(rows[j] + pen, dim=0, out=(bests[j], args[j]))
        d2_cur = torch.minimum(d2s[j], bests[j])
        torch.logical_and(decide_fn(d2_cur, tree_map(lambda a: a[j], aux)),
                          sends[j], out=accs[j])
        torch.logical_and(accs[j], count < k_max, out=apps[j])
        torch.where(apps[j], zero, inf, out=pens[j])
        count += apps[j]
    rank = torch.cumsum(app.to(torch.int32), dim=0, dtype=torch.int32)
    slots_c = torch.where(app, count0 + rank - 1, -1).to(torch.int32)
    # Strict <: on a tie the lower slot — the epoch-start center — wins.
    use_new = best_new < pre.d2_start
    refs_c = torch.where(use_new, slots_c[arg_new], pre.idx_start)
    overflow = pool.overflow | torch.any(acc & ~app)
    return _commit(pool, payload_c, slots_c, count, overflow), slots_c, refs_c


def logdepth_validate(
    pool: CenterPool,
    send_c: torch.Tensor,
    payload_c: torch.Tensor,
    pre: ValidatePre,
    decide_fn: Callable[[torch.Tensor, Any], torch.Tensor],
) -> tuple[CenterPool, torch.Tensor, torch.Tensor]:
    """`precomputed_validate` with the sequential accept chain replaced by a
    log-depth parallel resolution — bit-identical verdicts.

    For a monotone threshold rule accepting is intersective, so
    accept_j = base_j ∧ ∀ accepted i<j : surv[i, j]: the lexicographically
    first independent set of the `¬surv` conflict digraph, found by rounds
    of boolean matvecs (one host sync per round to test for live
    proposals).  Slots come from a prefix sum (`cumsum`), refs from one
    masked column-min.  An epoch whose accepts do not all fit the pool
    falls back to the serial scan (one synced bool per epoch).
    """
    cap = send_c.shape[0]
    k_max = pool.centers.shape[0]
    dev = send_c.device
    count0 = pool.count
    aux = pre.aux
    if aux is None:
        aux = torch.zeros((cap,), dtype=torch.int32, device=dev)
    aux_row = tree_map(lambda a: a[None, ...], aux)   # broadcast over i

    base = decide_fn(pre.d2_start, aux) & send_c
    surv = decide_fn(pre.pair_d2, aux_row)
    ar = torch.arange(cap, device=dev)
    tri = ar[:, None] < ar[None, :]
    kill = ~surv & tri

    alive = base
    accepted = torch.zeros((cap,), dtype=torch.bool, device=dev)
    while bool(torch.any(alive)):
        blocked = torch.any(kill & alive[:, None], dim=0)
        newly = alive & ~blocked
        accepted = accepted | newly
        victims = torch.any(kill & newly[:, None], dim=0)
        alive = alive & ~(newly | victims)

    n_acc = torch.sum(accepted.to(torch.int32))
    if bool(count0 + n_acc > k_max):
        return precomputed_validate(pool, send_c, payload_c, pre, decide_fn)

    rank = torch.cumsum(accepted.to(torch.int32), dim=0, dtype=torch.int32)
    slots_c = torch.where(accepted, count0 + rank - 1, -1).to(torch.int32)
    # refs: min over the FINAL accepted prefix — the value set (and the
    # lowest-index tie-break) the serial chain of minimums sees.
    d2_new = torch.where(accepted[:, None] & tri, pre.pair_d2, torch.inf)
    best_new, arg_new = torch.min(d2_new, dim=0)
    use_new = best_new < pre.d2_start
    refs_c = torch.where(use_new, slots_c[arg_new], pre.idx_start)
    count = (count0 + n_acc).to(torch.int32)
    return (_commit(pool, payload_c, slots_c, count, pool.overflow),
            slots_c, refs_c)


def precomputed_validate_gram(
    pool: CenterPool,
    send_c: torch.Tensor,           # (cap,) bool — compacted proposal flags
    payload_c: torch.Tensor,        # (cap, D) — compacted payload residuals
    pre: ValidatePre,
    decide_fn: Callable[[torch.Tensor, Any], torch.Tensor],
) -> tuple[CenterPool, torch.Tensor, torch.Tensor]:
    """The BP-means serializing scan with ZERO D-dimensional work per step
    — the Gram-carry path.

    BPValidate (Alg. 8) refits each proposed residual r_j against the
    features accepted earlier this epoch and appends what remains.  Each
    such feature is a signed combination of sent payloads, so the scan
    carries each accepted feature's coefficient row c_m and its G-row
    g_m = G c_m, and takes every refit dot product from the payload Gram
    matrix G (`pre.gram`): r · f_m = (G a) · c_m with a the running
    residual's coefficients, ‖f_m‖² is the residual norm² carried from m's
    own acceptance, and ‖r - f‖² = ‖r‖² - 2 r·f + ‖f‖².  The accepted
    residuals are materialised after the scan in one `coef @ payload`.

    The reference's inner `fori_loop(0, nacc, …)` has its trip count on
    the device.  Here it is a Python int: the scan reads the sent slots and
    the pool count once an epoch, and each sent step's verdict once, so a
    step costs one launch (the verdict) plus 8 for each feature accepted
    before it this epoch (9 kernels on the card, where the dot is two), 2
    more when it appends, and one host sync.  A
    bound known on the host instead (every sent step before j) would cost
    O(sent²) launches an epoch.  Unsent compacted slots are
    skipped: they cannot append, and `writeback` discards their fit rows,
    which stay False here.  All vectors live on the sent slots only, so a
    step's arithmetic does not depend on the window's width (adaptive cap
    ≡ full cap bit for bit).

    Returns (pool', slots_c (cap,) int32, z_c (cap, K_max) bool — each sent
    proposal's fit against this epoch's accepted features, at their pool
    slots).  Against the D-dimensional refit reference the decisions are
    identical and the features agree to float reassociation.
    """
    cap = send_c.shape[0]
    k_max = pool.centers.shape[0]
    dev = send_c.device
    sent_t = torch.nonzero(send_c).flatten()
    count0, *sent = torch.cat([pool.count.reshape(1).long(), sent_t]).tolist()
    n_s = len(sent)
    g = pre.gram[sent_t][:, sent_t]
    aux = pre.aux
    # Row p of `start` is the running state s = [a | u] of sent step p
    # before its refit: a = e_p, u = G a = g[p].  Accepted features keep the
    # same layout in `feat`: [c_m | g_m].
    start = torch.cat([torch.eye(n_s, dtype=g.dtype, device=dev), g], 1)
    feat = torch.zeros((n_s, 2 * n_s), dtype=g.dtype, device=dev)
    fnorm2 = torch.zeros((n_s,), dtype=g.dtype, device=dev)
    z_s = torch.zeros((n_s, n_s), dtype=torch.bool, device=dev)
    slots = [-1] * n_s
    nacc, overflow = 0, False
    for p, j in enumerate(sent):
        s, rn2 = start[p], g[p, p]     # views: every update makes a new tensor
        for m in range(nacc):
            dot = torch.dot(s[n_s:], feat[m, :n_s])
            dot2 = dot * 2.0
            z_m = torch.gt(dot2, fnorm2[m], out=z_s[p, m])
            s = torch.where(z_m, s - feat[m], s)
            rn2 = torch.where(z_m, rn2 - dot2 + fnorm2[m], rn2)
        if not bool(decide_fn(rn2, tree_map(lambda a: a[j], aux))):
            continue
        if count0 + nacc >= k_max:
            overflow = True
            continue
        feat[nacc] = s
        fnorm2[nacc] = rn2
        slots[p] = count0 + nacc
        nacc += 1

    slots_c = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    slots_c[sent_t] = torch.tensor(slots, dtype=torch.int32).to(dev)
    z_c = torch.zeros((cap, k_max), dtype=torch.bool, device=dev)
    z_c[sent_t, count0:count0 + nacc] = z_s[:, :nacc]
    feats = feat[:nacc, :n_s] @ payload_c[sent_t]
    centers = pool.centers.clone()
    centers[count0:count0 + nacc] = feats.to(centers.dtype)
    mask = pool.mask.clone()
    mask[count0:count0 + nacc] = True
    return (CenterPool(centers, mask, pool.count + nacc,
                       pool.overflow | overflow), slots_c, z_c)


def precomputed_gather_validate(
    pool: CenterPool,
    send: torch.Tensor,
    payload: torch.Tensor,
    aux: Any,
    precompute_fn: Callable[..., ValidatePre],
    decide_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    cap: int | None = None,
    scan_mode: str = "serial",
):
    """Bounded-master validation — THE engine validator.

    Compacts the sent proposals (stable order == global index order), runs
    `precompute_fn(pool, payload_c, aux_c, count0)` once, then the D-free
    serializing resolution (`pre.gram` set: the Gram-carry scan; else the
    one `scan_mode` picks), then scatters verdicts back to the full index
    space.  Returns (pool', slots, refs, sent_overflow)."""
    b = send.shape[0]
    count0 = pool.count
    cap_c = effective_cap(cap, b)
    order, sent_overflow = _compact_sent(send, cap_c)
    send_c = send[order]
    payload_c = payload[order]
    aux_c = tree_map(lambda a: a[order], aux)
    pre = precompute_fn(pool, payload_c, aux_c, count0)
    if pre.gram is not None:
        validate = precomputed_validate_gram
    elif scan_mode == "logdepth":
        validate = logdepth_validate
    elif scan_mode == "serial":
        validate = precomputed_validate
    else:
        raise ValueError(f"unknown scan_mode {scan_mode!r}")
    pool, slots_c, refs_c = validate(pool, send_c, payload_c, pre, decide_fn)
    slots, outs = _scatter_back(order, b, slots_c, refs_c)
    return pool, slots, outs, sent_overflow
