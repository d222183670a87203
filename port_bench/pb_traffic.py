"""One generator for every traffic mix: a mix file gives the length
distributions, the share of accuracy-critical requests and the block size;
the run's seed gives the tokens.

Every seed serves the same sizes in the same order: ``block`` (prompt,
output) pairs at fixed, evenly spaced quantiles of the two distributions
(paired by a fixed permutation), and the request stream is that block
again and again, each copy in an order drawn from :data:`ORDER_SEED`,
one constant for every mix, fixed before any run. In a closed loop the
sizes and their order set which requests complete together, hence every
admission wave's rows and prompt bucket: an order drawn from the run's
seed changed the work from seed to seed (``PERF.md``), so every seed runs
the same waves and steps, and the seed changes only the prompt tokens
(uniform over the vocabulary: no two prompts share a prefix) and the
weights. Request ``i`` is accuracy-critical when ``i % critical_every ==
0``, as in the launcher."""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["ORDER_SEED", "Req", "quantiles", "size_block", "Stream"]

ORDER_SEED = 0


@dataclasses.dataclass
class Req:
    """One request as the benchmark sends it."""

    index: int
    prompt: np.ndarray          # int32 token ids
    max_new: int
    critical: bool


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` integer lengths at the quantiles ``(i + 0.5) / n`` of
    ``dist``: ``log_uniform`` draws ``floor(exp(u))`` for ``u`` uniform
    over ``[ln lo, ln(hi + 1))``, so every integer of ``[lo, hi]`` can
    occur and the log of the length is uniform."""
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if dist["dist"] != "log_uniform":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    u = (np.arange(n) + 0.5) / n
    v = np.floor(np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo))))
    return np.clip(v, lo, hi).astype(np.int64)


def size_block(mix: dict) -> list[tuple[int, int]]:
    """The mix's fixed block of (prompt, output) sizes: prompt quantile
    ``i`` beside output quantile ``perm[i]``, ``perm`` fixed (seed 0), so
    the two lengths are independent over the block."""
    n = int(mix["block"])
    p = quantiles(mix["prompt_tokens"], n)
    o = quantiles(mix["output_tokens"], n)
    perm = np.random.default_rng(0).permutation(n)
    return [(int(p[i]), int(o[perm[i]])) for i in range(n)]


class Stream:
    """The requests of one run, in order: ``next()`` hands out the next
    one. ``vocab`` bounds the token ids; ``seed`` (any integer) draws the
    tokens, :data:`ORDER_SEED` the order of each block copy."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.block = size_block(mix)
        self.every = int(mix.get("critical_every", 0))
        self.vocab = int(vocab)
        self.order = np.random.default_rng(ORDER_SEED)
        self.rng = np.random.default_rng(int(seed) % 2 ** 63)
        self._order: list[int] = []
        self._n = 0

    def next(self) -> Req:
        if not self._order:
            self._order = list(self.order.permutation(len(self.block)))
        plen, out = self.block[self._order.pop(0)]
        prompt = self.rng.integers(0, self.vocab, plen).astype(np.int32)
        i = self._n
        self._n += 1
        crit = bool(self.every) and i % self.every == 0
        return Req(i, prompt, int(out), crit)
