"""Synthetic LM token pipeline (the port's copy of
`repro/data/tokens.py`, numpy only: batches are bitwise the JAX package's).

Deterministic, shardable, restartable: batch t is a pure function of
(seed, step), so a restarted job regenerates exactly the stream it would
have seen — the data-side half of fault tolerance.  Each host materializes
only its shard of the global batch (host_slice), which is what a 1000-node
run needs; on a single host the slice covers everything.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["TokenPipeline", "synthetic_token_batches"]


@dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step, host): tokens + next-token labels.

        Tokens follow a cheap power-law-ish distribution so losses are not
        uniform-random (gives optimizers something to fit in examples).
        """
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        shape = (self.host_batch, self.seq_len + 1)
        u = rng.uniform(size=shape)
        toks = np.minimum(
            (self.vocab_size * u ** 3.0).astype(np.int32), self.vocab_size - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def synthetic_token_batches(vocab_size: int, batch: int, seq_len: int,
                            steps: int, seed: int = 0):
    pipe = TokenPipeline(vocab_size, batch, seq_len, seed)
    for s in range(steps):
        yield pipe.batch_at(s)
