"""The traffic generator: deterministic per seed, the stated distributions,
the same sizes in the same order for every seed."""
import json
import math
from collections import Counter

import numpy as np

import pb_spec
from pb_traffic import ORDER_SEED, Stream, quantiles, size_block


def _mix():
    return pb_spec.cell("granite-3-2b.chat").traffic


def test_same_seed_same_stream_and_large_seeds():
    mix = _mix()
    seed = 2 ** 31 + 12345
    a, b = Stream(mix, 49155, seed), Stream(mix, 49155, seed)
    for _ in range(100):
        x, y = a.next(), b.next()
        assert x.max_new == y.max_new and x.critical == y.critical
        assert np.array_equal(x.prompt, y.prompt)


def test_seeds_share_sizes_and_order_not_tokens():
    mix = _mix()
    n = int(mix["block"])
    runs, toks = [], []
    for seed in (1, 2):
        s = Stream(mix, 49155, seed)
        reqs = [s.next() for _ in range(2 * n)]
        runs.append([(len(r.prompt), r.max_new) for r in reqs])
        toks.append(reqs[0].prompt)
    assert runs[0] == runs[1]
    assert not np.array_equal(toks[0], toks[1])
    assert runs[0][:n] != runs[0][n:]        # each block copy reordered
    for k in range(2):                       # every block: the same multiset
        assert Counter(runs[0][k * n:(k + 1) * n]) == Counter(size_block(mix))
    # the order is the one fixed constant's, whatever the mix or seed
    perm = np.random.default_rng(ORDER_SEED).permutation(n)
    assert runs[0][:n] == [size_block(mix)[i] for i in perm]


def test_lengths_log_uniform_within_bounds():
    for path in sorted((pb_spec.HERE / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        for key in ("prompt_tokens", "output_tokens"):
            d = mix[key]
            v = quantiles(d, 4096)
            assert v.min() >= d["lo"] and v.max() <= d["hi"]
            u = (np.log(v + 0.5) - math.log(d["lo"])) / (
                math.log(d["hi"] + 1) - math.log(d["lo"]))
            # the log of the length is uniform: its deciles at i/10
            dec = np.quantile(u, np.linspace(0.1, 0.9, 9))
            assert np.allclose(dec, np.linspace(0.1, 0.9, 9), atol=0.05)


def test_critical_every_third_and_tokens_in_vocab():
    s = Stream(_mix(), 512, 7)
    reqs = [s.next() for _ in range(30)]
    assert [r.critical for r in reqs] == [i % 3 == 0 for i in range(30)]
    assert all(r.prompt.min() >= 0 and r.prompt.max() < 512 for r in reqs)
