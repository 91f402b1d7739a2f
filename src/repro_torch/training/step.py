"""The train step: loss -> grads -> (error feedback) -> clip -> AdamW, with
optional microbatch gradient accumulation (the port of
`repro/training/step.py` for one card).

A `TrainState` holds tensors keyed by the port's parameter names
(`Model.named_parameters()`): `params`, the AdamW state and, when
`TrainConfig.compress_cross_pod` is set, the error-feedback residuals.
The step runs the model's loss on the state's own tensors through
`torch.func.functional_call`, so any `Model` of the configuration serves
as the structure (one on the "meta" device holds no memory), and it
updates the state's tensors in place (the JAX step donates its state).
`convert.train_state_to_numpy` / `train_state_from_numpy` carry a state to
and from the JAX package's layout.

On a mesh (a `Model` built with `mesh=`), the state's tensors are DTensors
of each rank's blocks (`train_state_init` over `model.named_parameters()`;
moments and residuals placed as their parameters).  A step, on every rank:
gather each parameter over the data axes (ZeRO-3) into the rank's
tensor-parallel block; take the rank's rows of the batch (`batch_spec`)
and split them into the microbatches; loss and gradients of those blocks;
one all-reduce SUM over the data axes, divided by their size, after which
each rank keeps its own block of every gradient (gloo has no
reduce-scatter for CUDA tensors); error feedback with each stacked leaf's
amax taken over the whole leaf (an all-reduce MAX over the mesh), so the
quantization is the one-device step's; the global norm with each leaf's
squares counted once; AdamW on the rank's blocks, in place.  The metrics
are the same on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import functional_call

from repro_torch.distributed.shardings import (
    is_dtensor, like_dtensor, unshard,
)
from repro_torch.models.model import layer_of
from repro_torch.optim.adamw import (
    AdamWState, _clip_scale, adamw_init, adamw_update, cosine_lr,
    global_norm,
)
from repro_torch.optim.compression import (
    EFState, apply_error_feedback, ef_init,
)

__all__ = ["TrainState", "train_state_init", "make_train_step",
           "param_groups", "loss_and_grads"]


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    opt: AdamWState
    ef: EFState | tuple   # EFState when compressing, else ()


def param_groups(names) -> dict[str, str]:
    """name -> its JAX leaf path: a stack's per-layer tensors
    ("segments.seg_00.3.wq", "encoder.segments.3.wq") share the stacked
    leaf ("segments/seg_00/wq", "encoder/segments/wq"), which the JAX
    package quantizes with one scale; the others are their own leaves."""
    def leaf(n):
        at = layer_of(n)
        return n if at is None else f"{at[0]}/{at[2]}"
    return {n: leaf(n) for n in names}


def train_state_init(params: dict[str, torch.Tensor], tcfg) -> TrainState:
    """A state over `params` (e.g. `{n: p.detach() for n, p in
    model.named_parameters()}`, the model's own storage): zero moments,
    step 0, zero residuals when compressing.  DTensor parameters (a mesh)
    get DTensor moments and residuals of the same placements."""
    local = {n: _local(p) for n, p in params.items()}
    opt = adamw_init(local)
    ef = ef_init(local) if tcfg.compress_cross_pod else ()
    if any(is_dtensor(p) for p in params.values()):
        def placed(tree):
            return {n: like_dtensor(t, params[n]) for n, t in tree.items()}
        opt = AdamWState(opt.step, placed(opt.mu), placed(opt.nu))
        if ef:
            ef = EFState(placed(ef.residual))
    return TrainState(params=dict(params), opt=opt, ef=ef)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (a view: writes reach the DTensor)."""
    return t.to_local() if is_dtensor(t) else t


def loss_and_grads(model, params: dict[str, torch.Tensor], batch):
    """(loss, {name: gradient}) of `model`'s loss (`Model.forward`) run on
    `params`' tensors through `torch.func.functional_call`; the loss is
    detached, each gradient in its parameter's dtype."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    loss = functional_call(model, leaves, (batch,))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(model, tcfg):
    """-> train_step(state, batch) -> (state, metrics).

    `batch` holds "tokens" and "labels" (B, S) ints (numpy or tensors);
    with microbatches > 1 the batch splits into n_micro equal slices along
    B, whose f32 gradients are summed and, like the losses, averaged before
    the one optimizer update.  metrics: "loss", "grad_norm", "lr" (0-d f32
    tensors) and "step" (0-d int32), on the device of the state.
    """
    n_micro = max(1, tcfg.microbatches)

    def grads_of(params, batch):
        if n_micro == 1:
            return loss_and_grads(model, params, batch)
        b = len(batch["tokens"])
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             "microbatches")
        m = b // n_micro
        total, acc = None, None
        for i in range(n_micro):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, g = loss_and_grads(model, params, mb)
            total = loss if total is None else total + loss
            if acc is None:
                acc = {n: t.to(torch.float32) for n, t in g.items()}
            else:
                for n, t in g.items():
                    acc[n] += t.to(torch.float32)
            del g
        return total / n_micro, {n: t / n_micro for n, t in acc.items()}

    mp = getattr(model, "mp", None)

    def train_step(state: TrainState, batch):
        if mp is None:
            loss, grads = grads_of(state.params, batch)
            params, opt, ef = state.params, state.opt, state.ef
            amax_reduce, gnorm_of = None, global_norm
        else:
            with torch.no_grad():
                tp = {n: unshard(p, mp.data_axes)
                      for n, p in state.params.items()}
            loss, grads = grads_of(tp, model.local_batch(batch))
            del tp
            loss, grads = mp.data_mean(loss, grads, state.params)
            params = {n: _local(p) for n, p in state.params.items()}
            opt = AdamWState(state.opt.step,
                             {n: _local(t) for n, t in state.opt.mu.items()},
                             {n: _local(t) for n, t in state.opt.nu.items()})
            ef = EFState({n: _local(t) for n, t in state.ef.residual.items()}
                         ) if state.ef else ()
            amax_reduce = mp.all_max

            def gnorm_of(g):
                return mp.global_norm(g, state.params)
        if tcfg.compress_cross_pod:
            grads, new_ef = apply_error_feedback(
                grads, ef, param_groups(grads), amax_reduce=amax_reduce)
            if mp is None:
                ef = new_ef
            else:       # into the state's DTensors
                for n, t in new_ef.residual.items():
                    ef.residual[n].copy_(t)
        gnorm = gnorm_of(grads)
        lr = cosine_lr(state.opt.step, tcfg.learning_rate,
                       tcfg.warmup_steps, tcfg.total_steps)
        opt = adamw_update(params, grads, opt, lr,
                           b1=tcfg.beta1, b2=tcfg.beta2, eps=tcfg.eps,
                           weight_decay=tcfg.weight_decay,
                           grad_scale=_clip_scale(gnorm, tcfg.grad_clip))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": opt.step}
        if mp is not None:      # the moments were written in place
            opt = AdamWState(opt.step, state.opt.mu, state.opt.nu)
            ef = state.ef
        return TrainState(state.params, opt, ef), metrics

    return train_step
