"""Reference validators — tests ONLY.

The port's copy of `repro.core._reference`: one full D-dimensional
recompute per sequential scan step through each transaction's `accept`, the
independent oracle the fast validator is held against.  Nothing under
`repro_torch.core` imports this module.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.occ import (
    CenterPool, OCCStats, _compact_sent, _scatter_back, block_epochs,
    serial_validate, tree_map,
)

__all__ = ["_reference_validate", "reference_pass"]


def _reference_validate(pool: CenterPool, send: torch.Tensor,
                        payload: torch.Tensor, accept_fn, aux: Any = None,
                        cap: int | None = None):
    """Bounded-master validation on the legacy path: compact the sent
    proposals (stable order) to `cap` slots, then run the serial scan with
    `accept_fn` recomputing every D-dimensional quantity per step."""
    b = send.shape[0]
    if cap is None or cap >= b:
        pool, slots, outs = serial_validate(pool, send, payload, accept_fn, aux)
        return pool, slots, outs, torch.zeros((), dtype=torch.bool,
                                              device=send.device)
    order, sent_overflow = _compact_sent(send, cap)
    aux_c = tree_map(lambda a: a[order], aux)
    pool, slots_c, outs_c = serial_validate(pool, send[order], payload[order],
                                            accept_fn, aux_c)
    slots, outs = _scatter_back(order, b, slots_c, outs_c)
    return pool, slots, outs, sent_overflow


def _reference_epoch(txn, pool, x_e, valid_e, state_e, cap):
    """One OCC epoch on the legacy path (`engine._epoch_body` with the
    per-step D-dimensional validator)."""
    count0 = pool.count
    send, payload, aux, safe = txn.propose(pool, x_e, state_e)
    send = send & valid_e
    accept = lambda p, v_j, a_j: txn.accept(p, v_j, a_j, count0)
    pool, slots, outs, sent_ovf = _reference_validate(
        pool, send, payload, accept, aux, cap=cap)
    assign_e = txn.writeback(send, slots, outs, safe, valid_e)
    pool = pool._replace(overflow=pool.overflow | sent_ovf)
    n_sent = torch.sum(send, dtype=torch.int32)
    n_acc = torch.sum(slots >= 0, dtype=torch.int32)
    return pool, assign_e, send, n_sent, n_acc


def reference_pass(txn, pool: CenterPool, x: torch.Tensor, state: Any = None,
                   *, pb: int, cap: int | None = None):
    """A whole pass on the legacy validator, epoch partition identical to
    the engine's (no bootstrap prefix).  Returns (pool, assign, send,
    stats)."""
    if state is None:
        state = txn.make_state(x, 0)
    n = x.shape[0]
    dev = x.device
    t_epochs = block_epochs(n, pb)
    assigns, sends, n_sents, n_accs = [], [], [], []
    for t in range(t_epochs):
        lo, hi = t * pb, min((t + 1) * pb, n)
        width = hi - lo
        x_e = x[lo:hi]
        state_e = tree_map(lambda s: s[lo:hi], state)
        if width < pb:     # pad the final short epoch like the engine does
            padf = lambda a: torch.cat(
                [a, a.new_zeros((pb - width,) + tuple(a.shape[1:]))], 0)
            x_e = padf(x_e)
            state_e = tree_map(padf, state_e)
        valid_e = torch.arange(pb, device=dev) < width
        pool, assign_e, send_e, n_sent, n_acc = _reference_epoch(
            txn, pool, x_e, valid_e, state_e, cap)
        assigns.append(tree_map(lambda a: a[:width], assign_e))
        sends.append(send_e[:width])
        n_sents.append(n_sent)
        n_accs.append(n_acc)
    assign = tree_map(lambda *a: torch.cat(a, 0), assigns[0], *assigns[1:])
    cap_eff = pb if cap is None or cap >= pb else cap
    stats = OCCStats(torch.stack(n_sents), torch.stack(n_accs),
                     torch.full((t_epochs,), cap_eff, dtype=torch.int32,
                                device=dev))
    return pool, assign, torch.cat(sends, 0), stats
