"""Batched serving engine of the language model (continuous-batching-lite).

The port of `repro/serving/engine.py`, with its exact token semantics.  A
fixed pool of B slots shares one KV cache.  A request claims the first
free slot and is prefilled token by token through `decode_step` on its
lane (the other lanes carry token 0 at their current positions, as in the
JAX package); its first output is the argmax of the last prompt step.
One `decode_step` then advances every slot per tick, and a slot is
recycled once its request has `max_new` tokens or its position reaches
`cache_len - 1`.  Greedy ties go to the first index (`torch.argmax`, like
`jnp.argmax`).  The cache is written in place.

The engine records each tick's host seconds in `step_seconds` (the tick
ends in the host read of its argmax) and counts its `decode_step` calls
in `n_decode_calls`.

On a mesh (a `Model` built with `mesh=`) every rank runs the same engine:
`decode_step` takes the whole batch and returns the whole logits on every
rank, so every rank's host logic (argmax, slots, positions) is the same;
the caches are the rank's blocks.  Decode mode "cp" runs as "tp" where the
model axis does not divide cache_len (`Model.decode_layout`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["ServeEngine", "Request"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int
    max_new: int = 32
    out: list[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False


class ServeEngine:
    def __init__(self, model, n_slots: int = 4, cache_len: int = 512,
                 decode_mode: str = "tp", greedy: bool = True):
        self.model = model
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.decode_mode = model.decode_layout(cache_len, decode_mode)
        self.greedy = greedy    # decoding is greedy, as in the JAX package
        self.caches = model.init_cache(n_slots, cache_len, self.decode_mode)
        self.pos = np.zeros((n_slots,), np.int64)
        self.active: list[Request | None] = [None] * n_slots
        self.last_tok = np.zeros((n_slots,), np.int64)
        self.step_seconds: list[float] = []
        self.n_decode_calls = 0

    def _decode(self, tok_b: np.ndarray, pos_b: np.ndarray):
        if (pos_b >= self.cache_len).any():
            # The JAX package clamps such a write; the port refuses it.
            raise RuntimeError(f"cache position {int(pos_b.max())} past "
                               f"cache_len {self.cache_len}")
        self.n_decode_calls += 1
        logits, self.caches = self.model.decode_step(
            self.caches, tok_b, pos_b, decode_mode=self.decode_mode)
        return logits

    # ---------------------------------------------------------------- intake
    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def submit(self, req: Request) -> bool:
        slots = self._free_slots()
        if not slots:
            return False
        req.slot = slots[0]
        self.active[req.slot] = req
        self._prefill_into_slot(req)
        return True

    def _prefill_into_slot(self, req: Request):
        """Token-by-token prefill through decode_step on the slot's lane."""
        for tok in np.asarray(req.prompt).astype(np.int64):
            tok_b = np.zeros((self.n_slots, 1), np.int64)
            tok_b[req.slot, 0] = tok
            logits = self._decode(tok_b, self.pos.copy())
            self.pos[req.slot] += 1
        self.last_tok[req.slot] = int(torch.argmax(logits[req.slot]))

    # ----------------------------------------------------------------- ticks
    def step(self) -> list[Request]:
        """One decode tick across all active slots; returns finished reqs."""
        if not any(r is not None for r in self.active):
            return []
        t0 = time.perf_counter()
        tok_b = self.last_tok.reshape(-1, 1).copy()
        logits = self._decode(tok_b, self.pos.copy())
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.step_seconds.append(time.perf_counter() - t0)
        finished = []
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(tok_b[i, 0]))
            self.pos[i] += 1
            self.last_tok[i] = nxt[i]
            if len(req.out) >= req.max_new or self.pos[i] >= self.cache_len - 1:
                req.done = True
                finished.append(req)
                self.active[i] = None
                self.pos[i] = 0      # recycle slot
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Drive a request list to completion with slot recycling."""
        pending = list(requests)
        done: list[Request] = []
        while pending or any(r is not None for r in self.active):
            while pending and self._free_slots():
                self.submit(pending.pop(0))
            done.extend(self.step())
        return done
