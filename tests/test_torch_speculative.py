"""Speculative decoding in the PyTorch port against the JAX reference, on the
granite-3-2b smoke config with the reference's weights (``params_from_jax``)
and inputs made from seeds with numpy.

* ``ngram_propose``: bit-exact against JAX (integer-only);
* K2's plain version (``paged_attention_multi`` on CPU tensors) against
  ``paged_attention_pallas_multi(interpret=True)`` and against
  ``paged_view`` + ``decode_attention_window``, ``atol=1e-5`` (f32 on both
  sides, summation order differs);
* ``_kv_window_quantize``: scale ladders and int rows bitwise equal to JAX's;
* ``decode_segment_spec`` at the acceptance boundaries (``draft_override``),
  both backends: tokens, delivered counts, carry equal to JAX's;
* rollback: after random accept prefixes the carry and every valid cache
  position bit-match a never-speculated twin (kv16, kv8);
* the speculative ``ContinuousScheduler`` against JAX's: tokens, profile
  traces, billing events, ``spec_billed``, admission order, the ledger, and
  spec tokens equal to greedy tokens;
* speculation across preemption and resume (greedy's tokens, billed =
  delivered), a class that opts out of speculation (one token per window),
  and the contiguous pool (``paged_kv=False``) at kv16/kv8 with k 1 and 4,
  each against the JAX scheduler.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.manager import ProfileManager as JManager
from repro.core.profiles import paper_profiles
from repro.kernels.paged_attention import paged_attention_pallas_multi
from repro.launch.serve import profile_stats as jax_profile_stats
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
from repro.serving.scheduler import ContinuousScheduler as JScheduler
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.manager import ProfileManager
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from torch_threads import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def parts():
    cfg = get_smoke("granite-3-2b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    names = JT.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    jeng = AdaptiveEngine(tuple(profs), QuantIndex(names), lambda *a: None)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names, inner_layers=[])),
                             TE.QuantIndex(names))
    stats = jax_profile_stats(cfg, profs, JT.param_count(jp))
    return cfg, C.get_smoke("granite-3-2b"), jp, tp, jeng, teng, stats


# ---------------------------------------------------------------------------
# the drafter: integer-only, bit-exact
# ---------------------------------------------------------------------------

def _pad(row, hn=32):
    return [-1] * (hn - len(row)) + row


DRAFTER_CASES = {
    # period 3, and period 2 < k (wraps past its own tail)
    "periodic": ([_pad([5, 7, 9] * 3), _pad([3, 8] * 3)], [9, 8], 4),
    "fresh": ([_pad([42])], [42], 3),                  # no match: repeat
    "longest_suffix": ([_pad([10, 11, 70, 4, 11, 80, 10, 11])], [11], 1),
    "tie_break": ([_pad([10, 11, 70, 4, 10, 11, 80, 10, 11])], [11], 1),
    "k_zero": ([[-1] * 8] * 2, [0, 0], 0),
}


@pytest.mark.parametrize("case", [*DRAFTER_CASES, "random_a", "random_b"])
def test_ngram_propose_matches_jax(case):
    if case in DRAFTER_CASES:
        hist, tok, k = DRAFTER_CASES[case]
        hist, tok = np.asarray(hist, np.int32), np.asarray(tok, np.int32)
    else:            # small vocab so matches are frequent; −1 left pads
        rng = np.random.default_rng(len(case) + ord(case[-1]))
        b, hn, k = 16, 24, 4
        hist = rng.integers(0, 6, (b, hn)).astype(np.int32)
        for r, n in enumerate(rng.integers(0, hn, b)):
            hist[r, :n] = -1
        tok = hist[:, -1].copy()
    want = np.asarray(JT.ngram_propose(jnp.asarray(hist), jnp.asarray(tok),
                                       k, 512))
    got = T.ngram_propose(torch.from_numpy(hist), torch.from_numpy(tok), k,
                          512)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()


# ---------------------------------------------------------------------------
# K2's plain version
# ---------------------------------------------------------------------------

BS, HKV, HG, D, N_LBLK = 8, 2, 2, 16, 4
LENGTHS = (7, 8, 9, 16, 17, 30)      # the last row's window runs past capacity


def _window_inputs(bits: int, w: int, seed: int = 0):
    """numpy inputs: one row per length plus a dead row, shuffled physical
    blocks, unmapped entries alternating −1 and ≥ n_blocks; ``pos`` is
    each row's length, its window writes at ``pos .. pos + W − 1``."""
    rng = np.random.default_rng(seed + 10 * bits + w)
    b = len(LENGTHS) + 1
    cap = N_LBLK * BS
    n_blocks = b * N_LBLK + 3
    perm = list(rng.permutation(n_blocks))
    bt = np.zeros((b, N_LBLK), np.int32)
    tidx = np.full((n_blocks, BS), -1, np.int32)
    pos = np.zeros((b,), np.int32)
    for r in range(b):
        n = LENGTHS[r] if r < len(LENGTHS) else 0
        pos[r] = n
        for lb in range(N_LBLK):
            if r < len(LENGTHS) and lb * BS < n + w:
                phys = perm.pop()
                bt[r, lb] = phys
                t = lb * BS + np.arange(BS)
                # the window's own positions are written; stale slots past it
                tidx[phys] = np.where(t < min(n + w, cap), t,
                                      np.where(t < n + w + 2, t, -1))
            else:
                bt[r, lb] = -1 if (r + lb) % 2 else n_blocks + lb
    shape = (n_blocks, BS, HKV, D)
    if bits == 16:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    else:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
    kl = rng.uniform(0.01, 0.05, (b, w, HKV)).astype(np.float32)
    vl = rng.uniform(0.01, 0.05, (b, w, HKV)).astype(np.float32)
    q = rng.standard_normal((b, w, HKV, HG, D)).astype(np.float32)
    return dict(q=q, k_pool=k, v_pool=v, k_ladder=kl, v_ladder=vl,
                token_idx=tidx, block_table=bt, pos=pos)


def _convert(x: dict, bits: int, mod):
    out = {n: (torch.from_numpy(a) if mod is torch else jnp.asarray(a))
           for n, a in x.items()}
    if bits == 16:
        for n in ("k_pool", "v_pool"):
            out[n] = (out[n].bfloat16() if mod is torch
                      else out[n].astype(jnp.bfloat16))
    return out


@pytest.mark.parametrize("w", [2, 5])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bits", [16, 8])
def test_window_plain_matches_pallas_interpret_and_view(bits, window, w):
    x = _window_inputs(bits, w)
    got = PA.paged_attention_multi(**_convert(x, bits, torch), bits=bits,
                                   window=window)
    assert got.dtype == torch.float32 and got.shape == x["q"].shape
    got = got.numpy()
    pallas = np.asarray(paged_attention_pallas_multi(
        **_convert(x, bits, jnp), bits=bits, window=window, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    assert np.all(got[-1] == 0.0)                 # dead row: exact zeros
    assert PA.paged_attention_multi.launches == 0  # CPU tensors never launch

    # the gather oracle on the port's pool layout, with its write sink
    t = _convert(x, bits, torch)
    n_blocks = t["token_idx"].shape[0]
    for name, fill in (("k_pool", 7), ("v_pool", 7), ("token_idx", -1)):
        sink = torch.full_like(t[name][:1], fill)
        t[name] = torch.cat([t[name], sink])
    cache = A.PagedKVCache(k=t["k_pool"], v=t["v_pool"],
                           k_scale=torch.ones(len(LENGTHS) + 1, HKV),
                           v_scale=torch.ones(len(LENGTHS) + 1, HKV),
                           token_idx=t["token_idx"],
                           block_table=t["block_table"], n_blocks=n_blocks,
                           bits=bits)
    b = x["q"].shape[0]
    q = t["q"].reshape(b, w, HKV * HG, D)
    kernel = A.paged_decode_attention_window(q, cache, t["pos"], t["k_ladder"],
                                             t["v_ladder"], window=window or None)
    win = window or N_LBLK * BS + w               # the kernel's sentinel
    gather = A.decode_attention_window(q, A.paged_view(cache), t["pos"],
                                       t["k_ladder"], t["v_ladder"],
                                       window=win)
    live = slice(0, len(LENGTHS))                 # the dead row's view is junk
    np.testing.assert_allclose(kernel.numpy()[live], gather.numpy()[live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(kernel.numpy(), got.reshape(kernel.shape),
                               atol=0, rtol=0)


def test_window_wrapper_rejects_what_the_kernel_cannot_take():
    """CUDA tensors launch or raise; validation runs before any build. A
    window of any width passes the shape check (the kernel tiles its query
    rows): W·Hg = 72 gets past it, and on ``meta`` tensors on to the plain
    version (shape arithmetic for the dry run). The limits that stay — D
    odd or above 256 — raise on the shape itself."""
    x = _convert(_window_inputs(16, 2), 16, torch)
    meta = {n: a.to("meta") for n, a in x.items()}
    with pytest.raises(ValueError, match="kv16/kv8"):
        PA.paged_attention_multi(**meta, bits=4)
    b = x["q"].shape[0]
    big = dict(meta, q=torch.zeros(b, 9, HKV, 8, D, device="meta"),
               k_ladder=torch.zeros(b, 9, HKV, device="meta"),
               v_ladder=torch.zeros(b, 9, HKV, device="meta"))
    assert PA.supports(D, 8, BS, 9) is None
    out = PA.paged_attention_multi(**big)
    assert (out.device.type, out.shape) == ("meta", (b, 9, HKV, 8, D))
    for d in (D + 1, 258):
        odd = dict(meta, q=torch.zeros(7, 2, HKV, HG, d, device="meta"))
        with pytest.raises(ValueError, match="head dim"):
            PA.paged_attention_multi(**odd)
    with pytest.raises(ValueError, match="kv16/kv8"):
        PA.paged_attention_multi(**x, bits=4)     # the plain version too


# ---------------------------------------------------------------------------
# int-KV window ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("floor", [1e-6, 0.02])
def test_kv_window_quantize_matches_jax_bitwise(floor):
    """Ladders (cummax of the per-position scales over the window, floored
    at the committed scale) and int8 rows equal JAX's jitted function bit
    for bit at kv8; kv16 passes the rows through and broadcasts the
    committed scale."""
    rng = np.random.default_rng(int(floor * 1e6))
    b, w, hkv, d = 4, 5, 2, 16
    k = (rng.standard_normal((b, w, hkv, d))
         * rng.uniform(0.2, 3.0, (b, w, hkv, 1))).astype(np.float32)
    v = (rng.standard_normal((b, w, hkv, d))
         * rng.uniform(0.2, 3.0, (b, w, hkv, 1))).astype(np.float32)
    for bits in (8, 16):
        jc = JA.init_kv_cache(b, 8, hkv, d, bits=bits)._replace(
            k_scale=jnp.full((b, hkv), floor, jnp.float32),
            v_scale=jnp.full((b, hkv), floor, jnp.float32))
        want = jax.jit(JA._kv_window_quantize)(jc, jnp.asarray(k),
                                               jnp.asarray(v))
        tc = A.init_kv_cache(b, 8, hkv, d, bits=bits, dtype=torch.bfloat16,
                             device="cpu")
        tc.k_scale.fill_(floor)
        tc.v_scale.fill_(floor)
        got = A._kv_window_quantize(tc, torch.from_numpy(k),
                                    torch.from_numpy(v))
        for g, wnt in zip(got, want):
            g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
            assert np.array_equal(g, np.asarray(wnt).astype(g.dtype)), bits


# ---------------------------------------------------------------------------
# decode_segment_spec at the acceptance boundaries, both backends
# ---------------------------------------------------------------------------

PLENS = (4, 9, 17)
B, SLOTS, BSZ, NB, K = 4, 64, 8, 24, 3


def _admit_inputs(cfg):
    rng = np.random.default_rng(5)
    prompts = np.zeros((B, 32), np.int32)
    plen = np.zeros((B,), np.int32)
    for j, n in enumerate(PLENS):
        prompts[j, 32 - n:] = rng.integers(0, cfg.vocab, n)
        plen[j] = n
    sidx = np.array([0, 1, 2, B], np.int32)        # wave row 3 is padding
    dest = np.full((B, SLOTS // BSZ), NB, np.int32)
    perm = np.random.default_rng(1).permutation(NB)
    for j, n in enumerate(PLENS):                  # prompt + 16 decode writes
        need = -(-(n + 16) // BSZ)
        dest[j, :need], perm = perm[:need], perm[need:]
    return prompts, plen, sidx, dest


@pytest.fixture(scope="module")
def seg(parts):
    """A paged admission on both sides, the JAX greedy stream after it, and
    a factory for fresh port states."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    scfg = dict(slots=SLOTS, max_batch=B, kv_bits=16, block_size=BSZ,
                pool_blocks=NB, prefix_cache=False)
    js = JServer(cfg, jp, jeng, JConfig(paged_backend="gather", **scfg))
    prompts, plen, sidx, dest = _admit_inputs(cfg)
    jc = JT.init_paged_caches(cfg, B, SLOTS, kv_bits=16, block_size=BSZ,
                              pool_blocks=NB)
    _, _, jtok, jpos, jc = js._admit_paged(
        0, {"tokens": jnp.asarray(prompts), "prompt_len": jnp.asarray(plen)},
        jnp.asarray(sidx), jnp.asarray(dest), jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32), jc)
    rem = jnp.asarray([16, 16, 16, 0], jnp.int32)
    ys, ok, _, _, _ = JT.decode_segment(
        jp, cfg, jnp.asarray(jeng.table), jnp.zeros((16,), jnp.int32), jtok,
        jpos, jc, rem, prequant=js._prequant, paged_backend="gather")
    assert bool(np.all(np.asarray(ok)))

    def port_state(backend):
        ts = AdaptiveServer(tcfg, tp, teng, ServingConfig(
            paged_backend=backend, **scfg), device="cpu")
        tc = T.init_paged_caches(tcfg, B, SLOTS, kv_bits=16, block_size=BSZ,
                                 pool_blocks=NB, device="cpu")
        tok = torch.zeros((B,), dtype=torch.int32)
        pos = torch.zeros((B,), dtype=torch.int32)
        ts.admit_paged(0, prompts, plen, sidx, dest, tok, pos, tc)
        return ts, tok, pos, tc

    return {"js": js, "jc": jc, "jtok": jtok, "jpos": jpos,
            "g": np.asarray(ys), "port_state": port_state}


def _run_both(parts, st, backend, dov, *, n_iter=1, remaining=None,
              quota=None, spec_on=None, jstate=None, tstate=None):
    """One spec segment on each side from the given (or the admitted)
    state. Returns ``(jax outputs, port outputs)`` as numpy, plus both
    states after the segment."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    rem = np.array([16, 16, 16, 0]) if remaining is None else remaining
    jtok, jpos, jc = jstate or (st["jtok"], st["jpos"], st["jc"])
    jout = JT.decode_segment_spec(
        jp, cfg, jnp.asarray(jeng.table), jnp.zeros((n_iter,), jnp.int32),
        jtok, jpos, jc, jnp.asarray(rem, jnp.int32),
        quota=None if quota is None else jnp.asarray(quota, jnp.int32),
        spec_on=None if spec_on is None else jnp.asarray(spec_on),
        prequant=st["js"]._prequant, paged_backend="gather", draft_k=K,
        draft_override=None if dov is None else jnp.asarray(dov, jnp.int32))
    ts, tok, pos, tc = tstate or st["port_state"](backend)
    tout = T.decode_segment_spec(
        tp, tcfg, teng.table, np.zeros((n_iter,), np.int32), tok, pos, tc,
        rem, quota=quota, spec_on=spec_on, prequant=ts.prequant,
        paged_backend=backend, draft_k=K,
        draft_override=None if dov is None else torch.from_numpy(
            np.array(dov, np.int32)))
    for o in (jout, tout):
        assert bool(np.all(np.asarray(o[2])))
    jnp_out = [np.asarray(a) for a in jout[:5]]
    t_out = [a.numpy() for a in tout[:5]]
    for name, a, bb in zip(("tokens", "delivered", "ok", "tok", "pos"),
                           jnp_out, t_out):
        assert a.tolist() == bb.tolist(), (backend, name)
    return jnp_out, (jout[3], jout[4], jout[5]), (ts, tout[3], tout[4],
                                                  tout[5])


BOUNDARIES = ["zero_accepted", "rollback_continue", "all_k",
              "accept_then_done", "quota", "opt_out"]


@pytest.mark.parametrize("case", BOUNDARIES)
def test_spec_segment_boundaries_match_jax(parts, seg, case):
    """Both backends equal JAX's ``decode_segment_spec`` on the same state
    and overrides — tokens, delivered counts, carry — and the delivered
    tokens are the greedy stream's."""
    vocab = parts[0].vocab
    g = seg["g"]
    wrong = ((g[:, :K] + 1) % vocab)[:, None, :]
    right = g[:, :K][:, None, :]
    live = [0, 1, 2]
    for backend in ("gather", "kernel"):
        if case == "zero_accepted":
            (toks, m, _, tok, pos), _, _ = _run_both(parts, seg, backend,
                                                     wrong)
            assert m[live, 0].tolist() == [1, 1, 1] and m[3, 0] == 0
            assert np.array_equal(toks[live, 0, 0], g[live, 0])
        elif case == "rollback_continue":
            _, js1, ts1 = _run_both(parts, seg, backend, wrong)
            (toks, m, _, _, _), _, _ = _run_both(
                parts, seg, backend, None, n_iter=3,
                remaining=np.array([15, 15, 15, 0]), jstate=js1,
                tstate=ts1)
            for r in live:
                got = [int(t) for i in range(3) for t in toks[r, i, :m[r, i]]]
                assert got == g[r, 1:1 + len(got)].tolist() and len(got) >= 3
        elif case == "all_k":
            (toks, m, _, tok, _), _, _ = _run_both(parts, seg, backend, right)
            assert m[live, 0].tolist() == [K + 1] * 3
            assert np.array_equal(toks[live, 0], g[live, :K + 1])
        elif case == "accept_then_done":
            (toks, m, _, tok, _), _, _ = _run_both(
                parts, seg, backend, np.repeat(right, 2, axis=1), n_iter=2,
                remaining=np.array([2, 2, 2, 0]))
            assert m[live].tolist() == [[2, 0]] * 3
            assert np.array_equal(tok[live], g[live, 1])
        elif case == "quota":
            (_, m, _, _, _), _, _ = _run_both(parts, seg, backend, right,
                                              quota=np.ones(B, np.int32))
            assert m[live, 0].tolist() == [1, 1, 1]
        else:
            (_, m, _, _, _), _, _ = _run_both(parts, seg, backend, right,
                                              spec_on=np.zeros(B, bool))
            assert m[live, 0].tolist() == [1, 1, 1]


# ---------------------------------------------------------------------------
# rollback: random accept prefixes vs a never-speculated twin
# ---------------------------------------------------------------------------

def _clone(caches):
    kv = caches["kv"]
    return {"kv": A.KVCache(kv.k.clone(), kv.v.clone(), kv.k_scale.clone(),
                            kv.v_scale.clone(), kv.token_idx.clone(),
                            kv.bits)}


def _masked_equal(spec_kv, twin_kv, end_pos, scales_exact):
    """Bit-compare every cache field at real-token positions (logical
    position < the row's final ``pos``); the slot past it holds both
    paths' parked junk. Scales: bitwise when the twin took no dead step,
    else spec's committed scale never exceeds the twin's."""
    ti = twin_kv.token_idx.numpy()                          # [L, B, S]
    end = np.broadcast_to(np.asarray(end_pos), ti.shape[1:2])
    valid = (ti >= 0) & (ti < end[None, :, None])
    for name in ("k", "v", "token_idx"):
        a, bb = (getattr(c, name) for c in (spec_kv, twin_kv))
        a, bb = a.float().numpy(), bb.float().numpy()
        m = valid.reshape(valid.shape + (1,) * (a.ndim - 3))
        assert np.array_equal(np.where(m, a, 0), np.where(m, bb, 0)), name
    for name in ("k_scale", "v_scale"):
        a, bb = (getattr(c, name).numpy() for c in (spec_kv, twin_kv))
        assert (np.array_equal(a, bb) if scales_exact
                else np.all(a <= bb)), name


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_rollback_bitmatch_never_speculated(parts, kv_bits):
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    table = teng.table
    b, plen, steps, k, n_iter = 2, 6, 16, 3, 3
    prompts = np.random.default_rng(31).integers(
        0, cfg.vocab, (b, plen)).astype(np.int32)
    logits, caches = T.prefill(tp, tcfg, table[0],
                               {"tokens": torch.from_numpy(prompts)}, 32,
                               kv_bits=kv_bits)
    tok0 = logits.argmax(dim=-1).to(torch.int32)
    pos0 = torch.full((b,), plen, dtype=torch.int32)
    pq = T.prequant_decode_weights(tp, tcfg, table)

    def twin(n_steps, rem):
        return T.decode_segment(tp, tcfg, table, np.zeros(n_steps, np.int32),
                                tok0, pos0, _clone(caches), rem, prequant=pq)

    def spec(dov, rem):
        return T.decode_segment_spec(
            tp, tcfg, table, np.zeros(n_iter, np.int32), tok0, pos0,
            _clone(caches), rem, prequant=pq, draft_k=k,
            draft_override=torch.from_numpy(dov))

    ys, ok, _, _, _ = twin(steps, np.full(b, steps))
    assert bool(ok.all())
    g = ys.numpy()
    for trial in range(4):                        # random accept prefixes
        rng = np.random.default_rng(100 + trial)
        rem_r = rng.integers(3, 10, b)
        dov = np.full((b, n_iter, k), -1, np.int32)
        exp = [[] for _ in range(b)]
        exp_m = np.zeros((b, n_iter), np.int32)
        p = np.zeros(b, int)
        remaining = rem_r.copy()
        for it in range(n_iter):
            for r in range(b):
                if remaining[r] <= 0:
                    continue
                a = int(rng.integers(0, k + 1))
                for j in range(k):
                    true = int(g[r, p[r] + j])
                    dov[r, it, j] = true if j < a else (true + 1) % cfg.vocab
                m = min(a + 1, int(remaining[r]))
                exp[r].extend(int(t) for t in g[r, p[r]:p[r] + m])
                exp_m[r, it] = m
                p[r] += m
                remaining[r] -= m
        toks, m, ok, tok, pos, cch = spec(dov, rem_r)
        assert bool(ok.all())
        assert np.array_equal(m.numpy(), exp_m), trial
        for r in range(b):
            got = [int(t) for it in range(n_iter)
                   for t in toks[r, it, :m[r, it]]]
            assert got == exp[r], (trial, r)
        assert tok.numpy().tolist() == [int(g[r, p[r] - 1]) for r in range(b)]
        _, _, _, t_pos, t_cch = twin(steps, p)
        assert pos.numpy().tolist() == t_pos.numpy().tolist()
        _masked_equal(cch["kv"], t_cch["kv"], plen + p, scales_exact=False)

    # exact fill: each row delivers exactly nf tokens, so the twin takes no
    # dead step and the committed int8 scales must match bit for bit
    nf = 8
    _, _, e_tok, e_pos, e_cch = twin(nf, np.full(b, nf))
    for trial in range(2):
        rng = np.random.default_rng(200 + trial)
        dov = np.full((b, n_iter, k), -1, np.int32)
        for r in range(b):
            while True:
                m1, m2 = (int(x) for x in rng.integers(1, k + 2, 2))
                if 1 <= nf - m1 - m2 <= k + 1:
                    break
            q = 0
            for it, mi in enumerate((m1, m2, nf - m1 - m2)):
                for j in range(k):
                    true = int(g[r, q + j])
                    dov[r, it, j] = true if j < mi - 1 else (true + 1) % cfg.vocab
                q += mi
        _, m, ok, tok, pos, cch = spec(dov, np.full(b, nf))
        assert m.numpy().sum(axis=1).tolist() == [nf] * b
        assert tok.numpy().tolist() == e_tok.numpy().tolist()
        assert pos.numpy().tolist() == e_pos.numpy().tolist()
        _masked_equal(cch["kv"], e_cch["kv"], plen + nf, scales_exact=True)


# ---------------------------------------------------------------------------
# the speculative scheduler against JAX's
# ---------------------------------------------------------------------------

def _mixed_requests(vocab, seed=3):
    rng = np.random.default_rng(seed)
    shape = [(8, 12), (5, 9), (12, 1), (7, 17), (9, 5), (6, 12)]
    return [(rng.integers(0, vocab, n).astype(np.int32), mn, i == 3)
            for i, (n, mn) in enumerate(shape)]


def _manager(cls, stats):
    return cls(stats, accuracy_target=0.985, accuracy_floor=0.95,
               budget_j=stats[0].energy_j * 30, low_energy=0.5)


_GREEDY: dict = {}


@pytest.mark.parametrize("kv_bits,k,managed,drafter", [
    (16, 1, False, None), (16, 4, False, None), (8, 1, False, None),
    (8, 4, False, None), (8, 4, True, None), (16, 4, False, "repeat")])
def test_spec_scheduler_matches_reference(parts, kv_bits, k, managed,
                                          drafter):
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    reqs = _mixed_requests(cfg.vocab)
    scfg = dict(slots=64, max_batch=4, kv_bits=kv_bits, block_size=8,
                prefix_cache=False)
    spec = dict(speculate=True, draft_k=k, draft_model=drafter)
    jm = _manager(JManager, stats) if managed else None
    js = JServer(cfg, jp, jeng, JConfig(**scfg, **spec), manager=jm)
    jsched = JScheduler(js, quantum=5)
    for t, m, crit in reqs:
        jsched.submit(JRequest(tokens=t, max_new=m, accuracy_critical=crit))
    want = jsched.run()
    if not managed and kv_bits not in _GREEDY:    # the port's greedy tokens
        gs = ContinuousScheduler(AdaptiveServer(
            tcfg, tp, teng, ServingConfig(**scfg), device="cpu"), quantum=5)
        for t, m, crit in reqs:
            gs.submit(Request(tokens=t, max_new=m, accuracy_critical=crit))
        _GREEDY[kv_bits] = [r["tokens"] for r in gs.run()]
    for backend in ("gather", "kernel"):
        tm = _manager(ProfileManager, stats) if managed else None
        ts = AdaptiveServer(tcfg, tp, teng, ServingConfig(
            paged_backend=backend, **scfg, **spec), manager=tm,
            device="cpu")
        sched = ContinuousScheduler(ts, quantum=5)
        for t, m, crit in reqs:
            sched.submit(Request(tokens=t, max_new=m, accuracy_critical=crit))
        got = sched.run()
        for g, w, (_, mn, _) in zip(got, want, reqs):
            assert g["tokens"] == w["tokens"], backend
            assert g["profile_trace"] == w["profile_trace"], backend
            assert g["status"].value == w["status"].value == "completed"
            assert len(g["tokens"]) == mn
        assert sched.events == jsched.events
        assert sched.spec_billed == jsched.spec_billed
        assert sched.admission_log == jsched.admission_log
        assert sched.allocator.used_blocks == 0
        assert sched.peak_used_blocks == jsched.peak_used_blocks
        # accepted-token billing: admission tokens + spec actuals = delivered
        delivered = sum(len(r["tokens"]) for r in got)
        assert sum(n for _, n in sched.spec_billed) == delivered - len(got)
        if managed:       # the ledger; windows bind profiles, so no greedy
            assert tm.spent_j == jm.spent_j
        else:             # one profile: the greedy scheduler's tokens
            assert [r["tokens"] for r in got] == _GREEDY[kv_bits]


def test_spec_server_validation(parts):
    """Speculation on a stack or precision without it, a bad drafter or
    depth, and a head dim the kernels cannot take all raise at
    construction; a window of any width (draft_k=40: W·Hg = 82) constructs
    on the kernel backend."""
    import dataclasses
    _, tcfg, _, tp, _, teng, _ = parts

    def make(cfg=tcfg, **kw):
        return AdaptiveServer(cfg, tp, teng, ServingConfig(
            slots=32, max_batch=2, speculate=True, **kw), device="cpu")

    assert make(kv_bits=8).draft_fn is None
    assert make(draft_model="repeat").draft_fn(
        torch.zeros(2, 4), torch.tensor([3, 5])).tolist() == [[3] * 4,
                                                               [5] * 4]
    assert make(draft_k=40, paged_backend="kernel").paged_backend == "kernel"
    for kw, msg in [(dict(kv_bits=4), "supports_speculation"),
                    (dict(draft_k=0), "draft_k"),
                    (dict(draft_hist=1), "draft_hist"),
                    (dict(draft_model="medusa"), "draft_model")]:
        with pytest.raises(ValueError, match=msg):
            make(**kw)
    for hd in (17, 264):                  # the limit that stays: D even, <= 256
        cfg = dataclasses.replace(tcfg, head_dim=hd)
        with pytest.raises(ValueError, match="head dim.*gather"):
            make(cfg, draft_k=40, paged_backend="kernel")


# ---------------------------------------------------------------------------
# speculation under preemption, per-class opt-out, the contiguous pool
# ---------------------------------------------------------------------------

def _spec_preempt_scenario(cfg):
    """Two saver rows on a shared prefix, then a critical arrival on the
    full pool (the reference's speculation-and-preemption scenario)."""
    def scenario(sched, Req):
        rng = np.random.default_rng(17)
        sys_p = rng.integers(0, cfg.vocab, 16).astype(np.int32)
        reqs = [Req(tokens=np.concatenate(
            [sys_p, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
            max_new=m, priority=1) for n, m in ((4, 18), (7, 16))]
        sched.submit(reqs[0])
        sched.step()
        sched.submit(reqs[1])
        sched.step()
        sched.step()
        sched.submit(Req(tokens=rng.integers(0, cfg.vocab, 7)
                         .astype(np.int32), max_new=4, priority=0))
        while sched.step():
            pass
        return {"preemptions": sched.preemptions, "resumes": sched.resumes,
                "spec_billed": list(getattr(sched, "spec_billed", []))}
    return scenario


def test_spec_preempt_resume_token_identity(parts):
    """A saver row evicted for a critical arrival resumes (its drafter
    history replayed) and emits the greedy tokens; tokens, events,
    ``spec_billed`` and counters equal the JAX scheduler's, billed tokens
    equal delivered ones and no block is left live."""
    from test_torch_prefix import run_pair
    cfg, tcfg, _, tp, _, teng, _ = parts
    scfg = dict(slots=64, max_batch=2, block_size=8, priority_classes=2,
                preemption=True)
    out = run_pair(parts, dict(speculate=True, draft_k=2, **scfg),
                   _spec_preempt_scenario(cfg), quantum=4)
    greedy = ContinuousScheduler(AdaptiveServer(
        tcfg, tp, teng, ServingConfig(**scfg), device="cpu"), quantum=4)
    _spec_preempt_scenario(cfg)(greedy, Request)
    for sched in out.values():
        assert sched.preemptions >= 1
        assert sched.resumes == sched.preemptions
        res = [sched.results[i] for i in range(3)]
        assert [r["tokens"] for r in res] == \
            [greedy.results[i]["tokens"] for i in range(3)]
        delivered = sum(len(r["tokens"]) for r in res)
        assert len(sched.admission_log) + sum(
            n for _, n in sched.spec_billed) == delivered


def test_spec_class_opt_out(parts):
    """A class with ``speculative=False`` rides the verify windows but
    advances one token per window; the other class speculates. Tokens,
    traces, events and ``spec_billed`` equal the JAX scheduler's under the
    same classes, and the tokens equal greedy decode's."""
    import dataclasses
    from repro.serving.policy import PriorityPolicy as JPolicy
    from repro.serving.policy import default_classes as jclasses
    from repro_torch.serving.policy import PriorityPolicy, default_classes
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    reqs = [(t, m, i % 2) for i, (t, m, _) in
            enumerate(_mixed_requests(cfg.vocab, seed=11))]
    scfg = dict(slots=64, max_batch=4, block_size=8, priority_classes=2)

    def classes(mk):
        crit, saver = mk(2)
        return (crit, dataclasses.replace(saver, speculative=False))

    jsched = JScheduler(JServer(cfg, jp, jeng, JConfig(
        speculate=True, draft_k=3, **scfg)), quantum=5,
        policy=JPolicy(classes(jclasses)))
    for t, m, pr in reqs:
        jsched.submit(JRequest(tokens=t, max_new=m, priority=pr))
    want = jsched.run()
    greedy = ContinuousScheduler(AdaptiveServer(
        tcfg, tp, teng, ServingConfig(**scfg), device="cpu"), quantum=5)
    for t, m, pr in reqs:
        greedy.submit(Request(tokens=t, max_new=m, priority=pr))
    greedy_toks = [r["tokens"] for r in greedy.run()]
    for backend in ("gather", "kernel"):
        sched = ContinuousScheduler(AdaptiveServer(
            tcfg, tp, teng, ServingConfig(paged_backend=backend,
                                          speculate=True, draft_k=3, **scfg),
            device="cpu"), quantum=5, policy=PriorityPolicy(
                classes(default_classes)))
        windows = []
        flush = sched._flush_spec

        def record(e, arr, names, _flush=flush, _s=sched):
            windows.append((e["ms"].numpy().copy(),
                            [(s, _s._slot_spec[s]) for s, _ in e["rows"]]))
            return _flush(e, arr, names)
        sched._flush_spec = record
        for t, m, pr in reqs:
            sched.submit(Request(tokens=t, max_new=m, priority=pr))
        got = sched.run()
        for g, w in zip(got, want):
            assert g["tokens"] == w["tokens"], backend
            assert g["profile_trace"] == w["profile_trace"]
        assert [r["tokens"] for r in got] == greedy_toks
        assert sched.events == jsched.events
        assert sched.spec_billed == jsched.spec_billed
        on = [ms[s].max() for ms, rows in windows for s, spec in rows if spec]
        off = [ms[s].max() for ms, rows in windows for s, spec in rows
               if not spec]
        assert off and max(off) <= 1 and on


@pytest.mark.parametrize("kv_bits,k", [(16, 1), (16, 4), (8, 1), (8, 4)])
def test_contiguous_spec_matches_reference(parts, kv_bits, k):
    """Speculation on the contiguous pool (``paged_kv=False``): tokens,
    traces, billing events, ``spec_billed`` and admission order equal the
    JAX scheduler's with ``paged_kv=False, speculate=True``, on both
    backends, and the tokens equal the port's greedy contiguous pool's."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    reqs = _mixed_requests(cfg.vocab)
    scfg = dict(slots=64, max_batch=4, kv_bits=kv_bits, paged_kv=False)
    spec = dict(speculate=True, draft_k=k)
    jsched = JScheduler(JServer(cfg, jp, jeng, JConfig(**scfg, **spec)),
                        quantum=5)
    for t, m, crit in reqs:
        jsched.submit(JRequest(tokens=t, max_new=m, accuracy_critical=crit))
    want = jsched.run()
    greedy = ContinuousScheduler(AdaptiveServer(
        tcfg, tp, teng, ServingConfig(**scfg), device="cpu"), quantum=5)
    for t, m, crit in reqs:
        greedy.submit(Request(tokens=t, max_new=m, accuracy_critical=crit))
    greedy_toks = [r["tokens"] for r in greedy.run()]
    for backend in ("gather", "kernel"):
        sched = ContinuousScheduler(AdaptiveServer(
            tcfg, tp, teng, ServingConfig(paged_backend=backend, **scfg,
                                          **spec), device="cpu"), quantum=5)
        assert not sched.paged
        for t, m, crit in reqs:
            sched.submit(Request(tokens=t, max_new=m, accuracy_critical=crit))
        got = sched.run()
        for g, w, (_, mn, _) in zip(got, want, reqs):
            assert g["tokens"] == w["tokens"], backend
            assert g["profile_trace"] == w["profile_trace"]
            assert g["status"].value == w["status"].value == "completed"
            assert len(g["tokens"]) == mn
        assert sched.events == jsched.events
        assert sched.spec_billed == jsched.spec_billed
        assert sched.admission_log == jsched.admission_log
        assert sched.windows_run > 0
        assert [r["tokens"] for r in got] == greedy_toks
