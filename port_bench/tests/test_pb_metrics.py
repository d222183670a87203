"""The metric arithmetic: tails over all requests, rates over the whole
window, and the operation and byte counts against counts by hand."""
import math
import types

import numpy as np
import pytest

import pb_spec
from pb_flops import k1_step_bytes, k5_forward_bytes, prefill_flops, \
    token_flops
from pb_serve import Record, Round
from pb_traffic import Req
from conftest import SMOKE, SMOKE_MOE


def _rec(i, plen, out, t_sub, t_first, t_done, round_first=None):
    r = Record(Req(i, np.zeros(plen, np.int32), out, False), i, t_sub)
    r.t_first, r.t_done, r.round_first = t_first, t_done, round_first
    r.tokens = list(range(out)) if t_done is not None else None
    r.n_tok = out
    return r


def _ctx(**kw):
    base = dict(t0=10.0, t_end=20.0, window_s=10.0, profiler_s=0.0,
                rounds=[], sliced=[], records=[], trace=None, rows=4,
                quantum=8, kv_bits=16, model=dict(SMOKE))
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_ttft_tail_is_over_all_requests_not_chunks():
    # 100 requests, 20 of them slow and all in the window's second half:
    # a median of per-chunk percentiles would hide them
    recs = [_rec(i, 8, 4, 10.0 + 0.1 * i, 10.0 + 0.1 * i
                 + (1.0 if i >= 80 else 0.05), None) for i in range(100)]
    ttft = [1e3 * (r.t_first - r.t_sub) for r in recs
            if 10.0 <= r.t_first <= 20.0]
    got = pb_spec.metric_reader("ttft_p95_ms")(_ctx(records=recs))
    assert got == pytest.approx(np.percentile(ttft, 95))
    assert got > 900.0


def test_tpot_is_over_requests_completed_in_window():
    recs = [_rec(0, 8, 11, 9.0, 9.5, 10.5), _rec(1, 8, 5, 9.0, 9.6, 21.0),
            _rec(2, 8, 3, 10.0, 10.2, 10.6)]
    got = pb_spec.metric_reader("tpot_p95_ms")(_ctx(records=recs))
    assert got == pytest.approx(np.percentile([100.0, 200.0], 95))


def test_rate_is_whole_window_tokens_over_its_seconds():
    rounds = [Round(i, 10 + i, 10.5 + i, 40 + i, 0, 8, False, [], [])
              for i in range(10)]
    got = pb_spec.metric_reader("output_tok_s")(
        _ctx(rounds=rounds, window_s=12.5))
    assert got == pytest.approx(sum(40 + i for i in range(10)) / 12.5)
    occ = pb_spec.metric_reader("occupancy")(_ctx(rounds=rounds, rows=8))
    assert occ == pytest.approx(100 * sum(40 + i for i in range(10))
                                / (80 * 8))


def test_flops_against_a_hand_count():
    m = dict(SMOKE)                      # L 2, d 64, H 4, Hkv 2, hd 16
    L, d, H, Hkv, hd, f, V = 2, 64, 4, 2, 16, 128, 512
    per_layer = d * (H + 2 * Hkv) * hd + H * hd * d + 3 * d * f
    for ctx in (1, 17, 40):
        hand = L * (2 * per_layer + 4 * ctx * H * hd) + 2 * d * V
        assert token_flops(m, ctx) == hand
    plen = 9
    hand = sum(L * (2 * per_layer + 4 * (p + 1) * H * hd)
               for p in range(plen)) + 2 * d * V
    assert prefill_flops(m, plen) == hand
    moe = dict(SMOKE, moe=dict(SMOKE_MOE))
    routed = 2 * 3 * d * 32 + 1 * 3 * d * 32 + d * 8
    per_layer = d * (H + 2 * Hkv) * hd + H * hd * d + routed
    assert token_flops(moe, 5) == L * (2 * per_layer + 4 * 5 * H * hd) \
        + 2 * d * V


def test_mfu_counts_prefill_once_and_each_decoded_token():
    m = dict(SMOKE)
    rec = _rec(0, 10, 6, 0.0, 1.0, None)
    rounds = [Round(1, 0, 1, 1, 1, 8, True, [rec], [(rec, 0, 1)]),
              Round(2, 1, 2, 5, 0, 8, False, [], [(rec, 1, 6)])]
    got = pb_spec.metric_reader("mfu")(_ctx(rounds=rounds, window_s=2.0,
                                            model=m))
    hand = prefill_flops(m, 10) + sum(token_flops(m, 10 + i)
                                      for i in range(1, 6))
    assert got == pytest.approx(100 * hand / (2.0 * 989e12))


def test_k1_bytes_against_a_hand_count():
    m = dict(SMOKE)
    per_tok = 2 * 2 * 2 * 16 * 2        # L · (K, V) · Hkv · hd · bf16
    q_out = 2 * (2 * 4 * 16 * 2)        # L · (q, out) · H · hd · bf16
    assert k1_step_bytes(m, 16, 33) == per_tok * 33 + q_out


def test_k1_roofline_reads_live_rows_at_their_contexts():
    m = dict(SMOKE)
    # admitted in round 5, max_new 12: 11 decode steps, 8 in round 5, 3 in 6
    rec = _rec(0, 20, 12, 0.0, 1.0, None, round_first=5)
    sliced = [Round(6, 0, 1, 3, 0, 8, False, [], [])]
    tr = types.SimpleNamespace(device_s=lambda match: 1e-6)
    got = pb_spec.metric_reader("k1_roofline")(
        _ctx(sliced=sliced, records=[rec], trace=tr, model=m))
    need = sum(k1_step_bytes(m, 16, 20 + k + 1) for k in (8, 9, 10))
    assert got == pytest.approx(100 * need / 3.35e12 / 1e-6)


def test_k5_bytes_against_a_hand_count():
    m = dict(SMOKE, moe=dict(SMOKE_MOE))     # E 8, f 32, k 2, G 4, cf 1.5
    E, f, d, L = 8, 32, 64, 2
    stacks = E * (d * 2 * f + f * d) * 6
    # a decode step over 4 rows: gcd(4, 4) = 4 groups of 1 token
    cap = math.ceil(1 * 2 / 8 * 1.5)
    assert k5_forward_bytes(m, 4) == L * (stacks + 4 * E * cap * (d + f) * 4)
    cap = math.ceil(32 * 2 / 8 * 1.5)        # a wave of 2 × 64 tokens
    assert k5_forward_bytes(m, 128) == L * (stacks
                                            + 4 * E * cap * (d + f) * 4)
