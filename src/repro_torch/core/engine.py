"""Unified OCC engine: one epoch loop for every OCC transaction.

The PyTorch port of `repro.core.engine`.  An `OCCTransaction` supplies the
algorithm-specific pieces (init_pool, make_state, propose,
precompute_accept / accept_pre, writeback, refine, objective); `OCCEngine`
owns epoch padding and valid-masking, the serial bootstrap prefix (paper
§4.2), bounded-master validation (`occ.precomputed_gather_validate`, the
only validator), per-epoch statistics, the Thm-3.3 adaptive cap with its
full-width retry, and streaming `partial_fit` / `flush`.

Where the JAX engine runs a pass as one `lax.scan` inside one jit, the port
runs it as a Python loop over epochs whose tensors stay on the device:
`OCCStats` accumulate on the device and are read back once per pass (by the
adaptive cap), never per epoch in serial scan mode.

Adaptive bounded master: `validate_cap="adaptive"` sizes the compaction
window from the observed Pb·ε + ΔK of the previous pass, power-of-two
bucketed; a pass whose sends exceed its window is re-run at full width
before it is committed, so adaptive results are bit-identical to full-cap
results.

Streaming: `partial_fit` holds back the trailing `n mod pb` points as an
explicit carry so a stream's epoch partition equals the one-shot run's, and
a row's nearest-center result does not depend on its batch, so streams are
bit-identical to one-shot runs on the card too.

Telemetry (`obs=`): after a pass `_export_pass` folds its `OCCStats` into
the registry and the trace with one host read of the stats, adding no
launch and no sync inside the epoch loop.

Pluggable proposal source: `run_from_proposals` drives the same epoch loop
from the host with the propose half supplied by a callable (the in-process
`local_proposer`, or the worker processes of `launch/occ_cluster.py`),
bit-identical to `run()` on the same data.

Not ported yet (see ROADMAP.md): `mesh`.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Callable, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch._device import resolve_device, to_device
from repro_torch.core.occ import (
    CenterPool, OCCStats, ValidatePre, block_epochs, effective_cap,
    next_pow2, precomputed_gather_validate, tree_map,
)
from repro_torch.obs.metrics import now as _obs_now

__all__ = ["OCCTransaction", "OCCEngine", "OCCPassResult",
           "resolve_assignments", "accumulate_pass_stats"]


@runtime_checkable
class OCCTransaction(Protocol):
    """What an algorithm must supply to run under the OCC engine."""

    def init_pool(self, x: torch.Tensor) -> CenterPool:
        """Allocate the global state from the pass's first `pb` points."""
        ...

    def make_state(self, x: torch.Tensor, offset: int = 0) -> Any:
        """Per-point state (leading dim len(x)) for points starting at
        global index `offset`; () when the transaction is stateless."""
        ...

    def propose(self, pool: CenterPool, x_e: torch.Tensor, state_e: Any
                ) -> tuple[torch.Tensor, torch.Tensor, Any, Any]:
        """Optimistic phase over one epoch: (send, payload, aux, safe)."""
        ...

    def precompute_accept(self, pool: CenterPool, payload_c: torch.Tensor,
                          aux_c: Any, count0: torch.Tensor) -> ValidatePre:
        """Every D-dimensional quantity validation can need, batched once."""
        ...

    def accept_pre(self, d2_cur: torch.Tensor, aux_j: Any) -> torch.Tensor:
        """The D-free accept rule (elementwise monotone threshold)."""
        ...

    def accept(self, pool: CenterPool, payload_j: torch.Tensor, aux_j: Any,
               count0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, Any]:
        """REFERENCE ONLY: one proposal per step with full D-dimensional
        recompute (`core/_reference.py`)."""
        ...

    def writeback(self, send, slots, outs, safe, valid) -> Any:
        """Combine validator verdicts into the per-point epoch output."""
        ...

    def empty_assign(self, device: torch.device) -> Any:
        """The per-point output of zero points (DP-means: (0,) int32)."""
        ...

    def refine(self, pool: CenterPool, x: torch.Tensor, assign: Any) -> CenterPool:
        """Bulk-synchronous refinement between passes."""
        ...

    def objective(self, x: torch.Tensor, assign: Any, pool: CenterPool) -> torch.Tensor:
        ...


class OCCPassResult(NamedTuple):
    """Everything one pass returns — all device tensors."""
    pool: CenterPool
    assign: Any             # (N,) int32
    send: torch.Tensor      # (N,) bool — point hit the validator
    epoch_of: torch.Tensor  # (N,) int32 — epoch each point was processed in
    stats: OCCStats         # (T,) proposed / accepted / cap


def resolve_assignments(send, slots, outs, safe, valid):
    """The DP/OFL writeback: accepted → new slot, rejected → validator's
    nearest-center ref, not sent → optimistic nearest, padding → -1."""
    z = torch.where(send, torch.where(slots >= 0, slots, outs), safe)
    return torch.where(valid, z, -1).to(torch.int32)


def _empty_stats(device) -> OCCStats:
    z = torch.zeros((0,), dtype=torch.int32, device=device)
    return OCCStats(z, z, z)


def accumulate_pass_stats(stat_parts: list[OCCStats]) -> OCCStats:
    """Concatenate per-pass OCCStats into one globally-epoch-numbered tuple
    (empty input → empty CPU stats).  `cap` concatenates when every part
    carries it and stays None otherwise."""
    if not stat_parts:
        return _empty_stats("cpu")
    caps = [s.cap for s in stat_parts]
    return OCCStats(
        torch.cat([s.proposed for s in stat_parts]),
        torch.cat([s.accepted for s in stat_parts]),
        None if any(c is None for c in caps) else torch.cat(caps))


# Adaptive-cap policy constants: smallest cap ever chosen, safety margin on
# the Thm-3.3 estimate (the decay floor halves the estimate at most).
ADAPTIVE_CAP_MIN = 8
ADAPTIVE_CAP_MARGIN = 2


def _finish_epoch(txn, pool, send, payload, aux, safe, valid_e, validate_cap,
                  scan_mode):
    """Serialize one epoch's proposals: valid-masking, the validator,
    writeback, overflow fold, epoch stats."""
    b = valid_e.shape[0]
    send = send & valid_e
    pool, slots, outs, sent_ovf = precomputed_gather_validate(
        pool, send, payload, aux, txn.precompute_accept, txn.accept_pre,
        cap=validate_cap, scan_mode=scan_mode)
    assign_e = txn.writeback(send, slots, outs, safe, valid_e)
    pool = pool._replace(overflow=pool.overflow | sent_ovf)
    n_sent = torch.sum(send, dtype=torch.int32)
    n_acc = torch.sum(slots >= 0, dtype=torch.int32)
    return pool, (assign_e, send, n_sent, n_acc, effective_cap(validate_cap, b))


def _epoch_body(txn, pool, x_e, valid_e, state_e, validate_cap, scan_mode):
    """One bulk-synchronous OCC epoch (any width, incl. the width-1 epochs
    of the serial bootstrap prefix)."""
    send, payload, aux, safe = txn.propose(pool, x_e, state_e)
    return _finish_epoch(txn, pool, send, payload, aux, safe, valid_e,
                         validate_cap, scan_mode)


def _cat(parts):
    return tree_map(lambda *p: torch.cat(p, 0), parts[0], *parts[1:])


def _engine_pass(txn, pool, x, state, *, pb, cap_warm, cap_rest, n_warm,
                 n_bootstrap, scan_mode="serial"):
    """The whole pass: bootstrap prefix + T epochs.  The main epochs run in
    up to two segments: the first `n_warm` at `cap_warm` (the burn-in
    width), the rest at `cap_rest`.  Returns (result, epochs run)."""
    n = x.shape[0]
    nb = n_bootstrap
    dev = x.device

    # Serial bootstrap prefix (paper §4.2): width-1 epochs are exactly the
    # serial algorithm.
    assign_b = None
    if nb:
        vb = torch.ones((1,), dtype=torch.bool, device=dev)
        parts = []
        for i in range(nb):
            pool, (a, *_) = _epoch_body(
                txn, pool, x[i:i + 1], vb,
                tree_map(lambda s: s[i:i + 1], state), cap_warm, scan_mode)
            parts.append(a)
        assign_b = _cat(parts)

    # Main epochs: pad to T*pb and view as (T, pb, ...).
    n_rest = n - nb
    t_epochs = block_epochs(n_rest, pb)
    pad = t_epochs * pb - n_rest

    def stack(a):
        flat = torch.cat([a[nb:], a.new_zeros((pad,) + tuple(a.shape[1:]))], 0)
        return flat.reshape((t_epochs, pb) + tuple(a.shape[1:]))

    xs = stack(x)
    valid = stack(torch.ones((n,), dtype=torch.bool, device=dev))
    ss = tree_map(stack, state)
    t_warm = min(n_warm, t_epochs) if cap_warm != cap_rest else 0
    am, sm, sent, acc, caps = [], [], [], [], []
    for e in range(t_epochs):
        cap = cap_warm if e < t_warm else cap_rest
        pool, (a, s, ns, na, c) = _epoch_body(
            txn, pool, xs[e], valid[e], tree_map(lambda t: t[e], ss), cap,
            scan_mode)
        am.append(a)
        sm.append(s)
        sent.append(ns)
        acc.append(na)
        caps.append(c)

    assign = tree_map(lambda a: a[:n_rest], _cat(am))
    send = torch.cat(sm)[:n_rest]
    if nb:
        assign = tree_map(lambda b, m: torch.cat([b, m], 0), assign_b, assign)
        # Bootstrapped points are processed by the master by construction.
        send = torch.cat([torch.ones((nb,), dtype=torch.bool, device=dev), send])
    epoch_of = torch.cat([
        torch.zeros((nb,), dtype=torch.int32, device=dev),
        torch.arange(t_epochs, dtype=torch.int32, device=dev)
        .repeat_interleave(pb)[:n_rest]])
    stats = OCCStats(proposed=torch.stack(sent), accepted=torch.stack(acc),
                     cap=torch.tensor(caps, dtype=torch.int32, device=dev))
    return OCCPassResult(pool, assign, send, epoch_of, stats), nb + t_epochs


class OCCEngine:
    """Driver for OCC transactions: batch passes and streaming epochs.

    Args:
      transaction: an `OCCTransaction`.
      pb: points per epoch (the paper's P*b product).
      validate_cap: an int fixes the bounded master's window; None leaves
        it unbounded; "adaptive" sizes it per pass from the Thm-3.3 bound
        with a full-width first epoch on cold pools and a full-width retry
        whenever a pass overflows its window (bit-identical to full cap).
      scan_mode: "serial" (the sequential accept scan) or "logdepth" (the
        parallel fixed point; bit-identical).
      publish: optional hook `publish(result, n_seen=..., epochs=...,
        cap_est=...)` called after every committed pass.
      obs: optional telemetry (`repro_torch.obs.Obs`).  None costs
        nothing: no clock reads and no host reads beyond the caller's own.
      device: where the pass runs — "cuda" (default) or "cpu".  Inputs are
        moved there; without a card, "cuda" raises.
    """

    def __init__(self, transaction: OCCTransaction, pb: int,
                 validate_cap: int | None | str = None,
                 scan_mode: str = "serial",
                 publish: Callable[..., Any] | None = None,
                 obs: Any = None,
                 device: str | torch.device = "cuda"):
        if isinstance(validate_cap, str) and validate_cap != "adaptive":
            raise ValueError(f"unknown validate_cap {validate_cap!r}")
        if scan_mode not in ("serial", "logdepth"):
            raise ValueError(f"unknown scan_mode {scan_mode!r}")
        self.device = resolve_device(device)
        self.txn = transaction
        self.obs = obs
        self.pb = int(pb)
        self.adaptive = validate_cap == "adaptive"
        self.validate_cap = None if self.adaptive else validate_cap
        self.scan_mode = scan_mode
        self.publish = publish
        self.mesh = None            # multi-card meshes are not ported
        self.n_dispatches = 0       # passes run, retries included
        self.n_epochs_dispatched = 0  # epochs run, retries included
        # adaptive-cap observability
        self._cap_est: int | None = None    # None → full width
        self.cap_history: list[int | None] = []
        self.n_cap_retries = 0
        # streaming state
        self._pool: CenterPool | None = None
        self._n_seen = 0
        self._stat_chunks: list[OCCStats] = []
        self._epoch_base = 0
        self._carry_x: torch.Tensor | None = None
        self._carry_state: Any = None

    def _x(self, x) -> torch.Tensor:
        return to_device(x, self.device).contiguous()

    # ---------------------------------------------------------- adaptive cap
    def _plan_caps(self, cold: bool) -> tuple[int | None, int | None, int]:
        """(cap_warm, cap_rest, n_warm) for the next pass."""
        if not self.adaptive:
            return self.validate_cap, self.validate_cap, 0
        rest = self._cap_est
        if rest is None or rest >= self.pb:
            return None, None, 0
        # Cold pool → the first main epoch sends ~everything (burn-in).
        return (None, rest, 1) if cold else (rest, rest, 0)

    def _observe_stats(self, stats: OCCStats, cold: bool) -> None:
        """Fold a committed pass's load into the Thm-3.3 estimate:
        cap ≈ pow2(2 · (max sent + max accepted)) after burn-in."""
        if not self.adaptive:
            return
        sent = stats.proposed.cpu().numpy()
        acc = stats.accepted.cpu().numpy()
        if cold:
            sent, acc = sent[1:], acc[1:]
        if sent.size == 0:
            return
        bound = ADAPTIVE_CAP_MARGIN * (int(sent.max()) + int(acc.max()))
        est = next_pow2(max(ADAPTIVE_CAP_MIN, bound))
        if self._cap_est is not None:
            est = max(est, self._cap_est // 2)
        self._cap_est = None if est >= self.pb else est

    def _pass(self, pool, x, state, n_bootstrap, cap_warm, cap_rest, n_warm):
        res, epochs = _engine_pass(
            self.txn, pool, x, state, pb=self.pb, cap_warm=cap_warm,
            cap_rest=cap_rest, n_warm=n_warm, n_bootstrap=n_bootstrap,
            scan_mode=self.scan_mode)
        self.n_dispatches += 1
        self.n_epochs_dispatched += epochs
        return res

    def _export_pass(self, res: OCCPassResult, t0: float) -> None:
        """Post-pass telemetry export (obs is set): fold the pass's
        `OCCStats` into the registry and the trace.  The three stat vectors
        come to the host in one read, which waits for the pass; nothing is
        added inside the epoch loop.  Per-epoch spans are synthesized by
        even subdivision of the measured pass interval (flagged
        ``synthetic_timing``)."""
        m = self.obs.metrics
        st = res.stats
        host = torch.stack([st.proposed, st.accepted,
                            st.cap.to(st.proposed.device)]).cpu().numpy()
        prop, acc, cap = host
        t1 = _obs_now()
        n_epochs = int(prop.shape[0])
        n_prop, n_acc = int(prop.sum()), int(acc.sum())
        m.counter("engine_passes").inc()
        m.counter("engine_epochs").inc(n_epochs)
        m.counter("engine_proposed").inc(n_prop)
        m.counter("engine_accepted").inc(n_acc)
        m.counter("engine_rejected").inc(n_prop - n_acc)
        if n_prop:
            # Thm 3.3 conflict rate: the rejected fraction of proposals.
            m.gauge("engine_conflict_rate").set((n_prop - n_acc) / n_prop)
        if n_epochs:
            m.gauge("engine_cap").set(int(cap[-1]))
        m.histogram("engine_pass_s").observe(t1 - t0)
        tr = self.obs.tracer
        if tr is not None:
            ts0, dur = t0 * 1e6, (t1 - t0) * 1e6
            tr.complete("engine.pass", ts0, dur, cat="engine",
                        args=dict(epochs=n_epochs, proposed=n_prop,
                                  accepted=n_acc,
                                  dispatches=self.n_dispatches))
            if n_epochs:
                step = dur / n_epochs
                for e in range(n_epochs):
                    tr.complete(
                        "engine.epoch", ts0 + e * step, step, cat="engine",
                        args=dict(epoch=e, proposed=int(prop[e]),
                                  accepted=int(acc[e]), cap=int(cap[e]),
                                  synthetic_timing=True))

    def _dispatch(self, pool, x, state, *, n_bootstrap: int,
                  cold: bool) -> OCCPassResult:
        """One pass, with the adaptive overflow retry: a pass whose sends
        exceed its window is re-run at full width (same inputs), so
        committed adaptive results equal full-cap results."""
        t0 = _obs_now() if self.obs is not None else 0.0
        cap_warm, cap_rest, n_warm = self._plan_caps(cold)
        res = self._pass(pool, x, state, n_bootstrap, cap_warm, cap_rest, n_warm)
        self.cap_history.append(cap_rest)
        if self.adaptive and cap_rest is not None:
            if bool(torch.any(res.stats.proposed > res.stats.cap)):
                self.n_cap_retries += 1
                self._cap_est = None
                self.cap_history[-1] = None
                res = self._pass(pool, x, state, n_bootstrap, None, None, 0)
        self._observe_stats(res.stats, cold)
        if self.obs is not None:
            self._export_pass(res, t0)
        return res

    # ------------------------------------------------------------- batch
    def run(self, x, *, pool: CenterPool | None = None, state: Any = None,
            n_bootstrap: int = 0) -> OCCPassResult:
        """One full pass over x."""
        x = self._x(x)
        cold = pool is None
        if pool is None:
            pool = self.txn.init_pool(x[:min(self.pb, x.shape[0])])
        if state is None:
            state = self.txn.make_state(x, 0)
        res = self._dispatch(pool, x, state,
                             n_bootstrap=min(int(n_bootstrap), x.shape[0]),
                             cold=cold)
        if self.publish is not None:
            self.publish(res, n_seen=x.shape[0],
                         epochs=res.stats.proposed.shape[0],
                         cap_est=self._cap_est)
        return res

    def refine(self, pool: CenterPool, x, assign: Any) -> CenterPool:
        return self.txn.refine(pool, self._x(x), assign)

    # ------------------------------------------- pluggable proposal source
    def local_proposer(self):
        """The in-process proposal source: `txn.propose` on the full epoch.
        `run_from_proposals(x)` with it equals `run(x)` bit for bit, and a
        worker's shard propose equals the matching slice of it (a row's
        nearest-center result does not depend on the rows beside it)."""
        def propose_fn(pool, x_e, state_e, valid_e, *, epoch, offset):
            send, payload, aux, safe = self.txn.propose(pool, x_e, state_e)
            return send, payload, aux, safe, valid_e
        return propose_fn

    def run_from_proposals(self, x, propose_fn=None, *,
                           pool: CenterPool | None = None, state: Any = None,
                           n_bootstrap: int = 0, on_commit=None,
                           on_outputs=None,
                           epoch_base: int = 0) -> OCCPassResult:
        """One pass with a pluggable proposal source — the host-driven dual
        of `run()`, bit-identical to it on the same data.

        The epoch loop asks `propose_fn` for each epoch's proposal block
        and runs only the serializing finish (`_finish_epoch`: the
        validator and writeback) itself: the paper's master.  Proposals
        may come from `local_proposer()` or from P worker processes, each
        proposing on a disjoint shard, reassembled in global index order
        (`launch/occ_cluster.py`).

        propose_fn(pool, x_e, state_e, valid_e, *, epoch, offset) returns
        (send, payload, aux, safe, valid_e) for the epoch's `pb` points
        (`offset` is the global index of the epoch's first point; the
        returned valid_e may narrow the input mask, e.g. to mask the shard
        of a worker that died).

        on_commit(pool, epoch, t_epochs) runs after each main epoch's
        commit (the per-epoch replication hook).  on_outputs(epoch,
        assign_e, send_e, (proposed, accepted, cap)) runs after each main
        epoch, before on_commit, with the epoch's raw (padded) outputs.
        epoch_base shifts the epoch indices reported to propose_fn /
        on_commit / on_outputs (a promoted master resumes the global
        numbering); offsets stay relative to this call's x.

        The adaptive cap needs the whole-pass retry and is refused.  Each
        epoch counts as one dispatch.
        """
        if self.adaptive:
            raise ValueError("run_from_proposals requires a fixed/None "
                             "validate_cap (adaptive needs the fused pass)")
        if self.mesh is not None:
            raise ValueError("run_from_proposals is host-driven; use run() "
                             "for mesh-sharded passes")
        if propose_fn is None:
            propose_fn = self.local_proposer()
        cap, sm, pb = self.validate_cap, self.scan_mode, self.pb
        x = self._x(x)
        n = x.shape[0]
        dev = x.device
        nb = min(int(n_bootstrap), n)
        if pool is None:
            pool = self.txn.init_pool(x[:min(pb, n)])
        else:
            pool = tree_map(lambda t: t.to(dev), pool)
        if state is None:
            state = self.txn.make_state(x, 0)

        obs = self.obs
        _span = obs.span if obs is not None else (
            lambda *a, **k: nullcontext())

        # Serial bootstrap prefix: width-1 epochs, stats discarded and send
        # forced True, as in the fused pass.
        assign_b = None
        if nb:
            ones = torch.ones((1,), dtype=torch.bool, device=dev)
            parts = []
            for i in range(nb):
                s_, p_, a_, sf_, ve = propose_fn(
                    pool, x[i:i + 1], tree_map(lambda s: s[i:i + 1], state),
                    ones, epoch=0, offset=i)
                pool, (ae, *_) = _finish_epoch(self.txn, pool, s_, p_, a_,
                                               sf_, ve, cap, sm)
                self.n_dispatches += 1
                self.n_epochs_dispatched += 1
                parts.append(ae)
            assign_b = _cat(parts)

        # Main epochs: the fused pass's padding and valid-masking.
        n_rest = n - nb
        t_epochs = block_epochs(n_rest, pb)
        pad = t_epochs * pb - n_rest

        def flat(a):
            return torch.cat([a[nb:],
                              a.new_zeros((pad,) + tuple(a.shape[1:]))], 0)
        xs = flat(x)
        valid = flat(torch.ones((n,), dtype=torch.bool, device=dev))
        ss = tree_map(flat, state)

        am, sm_parts, sent, acc, caps = [], [], [], [], []
        for e in range(t_epochs):
            ge = epoch_base + e          # global epoch index (resume)
            t0e = _obs_now() if obs is not None else 0.0
            cut = slice(e * pb, (e + 1) * pb)
            with _span("engine.propose", cat="engine", epoch=ge):
                s_, p_, a_, sf_, ve = propose_fn(
                    pool, xs[cut], tree_map(lambda s: s[cut], ss),
                    valid[cut], epoch=ge, offset=nb + e * pb)
            with _span("engine.validate", cat="engine", epoch=ge):
                pool, (ae, sde, ns, na, ce) = _finish_epoch(
                    self.txn, pool, s_, p_, a_, sf_, ve, cap, sm)
            self.n_dispatches += 1
            self.n_epochs_dispatched += 1
            am.append(ae)
            sm_parts.append(sde)
            sent.append(ns)
            acc.append(na)
            caps.append(ce)
            if obs is not None:
                # Host-driven loop: real per-epoch telemetry (one host read
                # an epoch), unlike the fused pass's synthesized spans.
                nsi, nai, cei = int(ns), int(na), int(ce)
                m = obs.metrics
                m.counter("engine_epochs").inc()
                m.counter("engine_proposed").inc(nsi)
                m.counter("engine_accepted").inc(nai)
                m.counter("engine_rejected").inc(nsi - nai)
                if nsi:
                    m.gauge("engine_conflict_rate").set((nsi - nai) / nsi)
                m.gauge("engine_cap").set(cei)
                t1e = _obs_now()
                m.histogram("engine_epoch_s").observe(t1e - t0e)
                if obs.tracer is not None:
                    obs.tracer.complete(
                        "engine.epoch", t0e * 1e6, (t1e - t0e) * 1e6,
                        cat="engine",
                        args=dict(epoch=ge, proposed=nsi, accepted=nai,
                                  cap=cei))
            if on_outputs is not None:
                on_outputs(ge, ae, sde, (ns, na, ce))
            if on_commit is not None:
                on_commit(pool, ge, t_epochs)

        assign = tree_map(lambda a: a[:n_rest], _cat(am))
        send = torch.cat(sm_parts)[:n_rest]
        if nb:
            assign = tree_map(lambda b, m: torch.cat([b, m], 0), assign_b,
                              assign)
            send = torch.cat([torch.ones((nb,), dtype=torch.bool,
                                         device=dev), send])
        epoch_of = torch.cat([
            torch.zeros((nb,), dtype=torch.int32, device=dev),
            torch.arange(t_epochs, dtype=torch.int32, device=dev)
            .repeat_interleave(pb)[:n_rest]])
        res = OCCPassResult(
            pool, assign, send, epoch_of,
            OCCStats(proposed=torch.stack(sent), accepted=torch.stack(acc),
                     cap=torch.tensor(caps, dtype=torch.int32, device=dev)))
        if self.publish is not None:
            self.publish(res, n_seen=n, epochs=t_epochs,
                         cap_est=self._cap_est)
        return res

    # --------------------------------------------------------- streaming
    @property
    def pool(self) -> CenterPool | None:
        """Current streaming pool (None before the first committed epoch)."""
        return self._pool

    @property
    def n_seen(self) -> int:
        """Total points submitted to the stream (including carried ones)."""
        return self._n_seen

    @property
    def n_pending(self) -> int:
        """Points held in the partial-epoch carry, not yet in the pool."""
        return 0 if self._carry_x is None else int(self._carry_x.shape[0])

    @property
    def n_processed(self) -> int:
        """Points whose epoch has been committed to the pool."""
        return self._n_seen - self.n_pending

    @property
    def epochs_done(self) -> int:
        """Global epochs committed so far."""
        return self._epoch_base

    @property
    def stats(self) -> OCCStats:
        """All streaming epochs' stats so far, concatenated on the device."""
        if len(self._stat_chunks) > 1:
            self._stat_chunks = [accumulate_pass_stats(self._stat_chunks)]
        if not self._stat_chunks:
            return _empty_stats(self.device)
        return self._stat_chunks[0]

    def reset_stream(self) -> None:
        self._pool, self._n_seen, self._stat_chunks = None, 0, []
        self._epoch_base = 0
        self._carry_x = self._carry_state = None

    def restore(self, snapshot, *, k_max: int) -> None:
        """Resume a stream from a published `serving.ModelSnapshot`.

        Seeds the pool (re-expanded to the trainer's (k_max, D) buffer on
        the engine's device; rows beyond `count` are zero, as in the live
        pool), the global point and epoch counters, and the adaptive-cap
        estimate the snapshot persisted (`cap_est`), so the first pass runs
        at the warm cap.  The stream continues from the snapshot's
        `n_seen`: points after the last publish must be sent again.  From
        the restore point on, the stream equals the uninterrupted one bit
        for bit."""
        if self._pool is not None or self._n_seen:
            raise ValueError("restore() requires a fresh engine/stream")
        self._pool = tree_map(lambda t: t.to(self.device),
                              snapshot.to_pool(k_max))
        self._n_seen = snapshot.n_seen
        self._epoch_base = snapshot.epochs
        if self.adaptive and snapshot.cap_est is not None:
            self._cap_est = snapshot.cap_est

    def _empty_stream_result(self, x1: torch.Tensor) -> OCCPassResult:
        """A zero-point result (pool unchanged, length-0 outputs), returned
        when a whole batch lands in the carry.  Before the first commit it
        carries an all-zeros pool of the right shape."""
        pool = self._pool
        if pool is None:
            pool = tree_map(torch.zeros_like, self.txn.init_pool(x1))
        empty = _empty_stats(self.device)
        return OCCPassResult(
            pool, self.txn.empty_assign(self.device),
            torch.zeros((0,), dtype=torch.bool, device=self.device),
            empty.proposed, empty)

    def _commit_stream_pass(self, xb: torch.Tensor, state: Any) -> OCCPassResult:
        """Run one pass over pb-aligned (or final-flush) points and fold it
        into the stream: pool, stats, global epoch numbering, publication."""
        cold = self._pool is None
        if cold:
            self._pool = self.txn.init_pool(xb[:min(self.pb, xb.shape[0])])
        res = self._dispatch(self._pool, xb, state, n_bootstrap=0, cold=cold)
        self._pool = res.pool
        self._stat_chunks.append(res.stats)
        if len(self._stat_chunks) >= 64:
            _ = self.stats
        res = res._replace(epoch_of=res.epoch_of + self._epoch_base)
        self._epoch_base += res.stats.proposed.shape[0]
        if self.publish is not None:
            self.publish(res, n_seen=self.n_processed,
                         epochs=self._epoch_base, cap_est=self._cap_est)
        return res

    def partial_fit(self, xb, *, state: Any = None,
                    pool: CenterPool | None = None) -> OCCPassResult:
        """Incremental epochs over an arriving batch.  The trailing
        `n mod pb` points wait in the carry for a later call or `flush()`,
        so any batching reproduces the one-shot run bit for bit.  `pool`
        (first call only) seeds the stream."""
        xb = self._x(xb)
        if pool is not None:
            if self._pool is not None:
                raise ValueError("pool= only seeds the FIRST partial_fit")
            self._pool = pool
        if state is None:
            state = self.txn.make_state(xb, self._n_seen)
        self._n_seen += xb.shape[0]
        if self._carry_x is not None:
            xb = torch.cat([self._carry_x, xb], 0)
            state = tree_map(lambda c, s: torch.cat([c, s], 0),
                             self._carry_state, state)
        n = xb.shape[0]
        n_full = (n // self.pb) * self.pb
        if n_full < n:
            self._carry_x = xb[n_full:]
            self._carry_state = tree_map(lambda s: s[n_full:], state)
        else:
            self._carry_x = self._carry_state = None
        if n_full == 0:
            return self._empty_stream_result(xb)
        return self._commit_stream_pass(
            xb[:n_full], tree_map(lambda s: s[:n_full], state))

    def flush(self) -> OCCPassResult | None:
        """Commit the carried partial epoch as the stream's final short
        epoch.  Returns that result, or None when nothing is pending."""
        if self._carry_x is None:
            return None
        xb, state = self._carry_x, self._carry_state
        self._carry_x = self._carry_state = None
        return self._commit_stream_pass(xb, state)
