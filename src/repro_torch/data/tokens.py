"""Deterministic synthetic token pipeline for LM training and serving.

Copy of ``repro/data/tokens.py`` (numpy only, so the port keeps its own).

Sequences follow a fixed random permutation chain with ε-noise:
``x_{t+1} = perm[x_t]`` with probability ``1 − ε`` else uniform — so
next-token prediction is learnable to ``1 − ε`` accuracy and training-loss
curves are meaningful without any external corpus. Sharded iteration is
host-deterministic: batch ``i`` is a pure function of ``(seed, i)``, which is
what makes checkpoint/restart bit-exact and elastic re-sharding trivial
(every host can regenerate any global batch slice).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["TokenStream"]


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    noise: float = 0.1

    def _perm(self) -> np.ndarray:
        return np.random.default_rng(self.seed).permutation(self.vocab)

    def batch_at(self, step: int) -> dict:
        """Global batch for ``step`` — stateless, restart-safe."""
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + step)
        perm = self._perm()
        x = np.empty((self.batch, self.seq_len + 1), np.int32)
        x[:, 0] = rng.integers(0, self.vocab, self.batch)
        for t in range(self.seq_len):
            nxt = perm[x[:, t]]
            flip = rng.random(self.batch) < self.noise
            nxt = np.where(flip, rng.integers(0, self.vocab, self.batch), nxt)
            x[:, t + 1] = nxt
        return {"tokens": x[:, :-1], "labels": x[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
