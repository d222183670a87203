"""Shared prompt prefixes in the port against the JAX reference, on the same
weights (smoke granite-3-2b, ``params_from_jax``).

* the model's continuation prefill: ``prefix_attention`` within 1e-5 of the
  reference in f32; ``prefill_extend`` logits within 1e-4; its kv8/kv4 ints
  and scales bit for bit when both sides fill from the same K/V;
  ``prefill(..., return_raw_kv=True)`` hands back the reference's raw K/V
  (within 1e-5: the forwards agree to float rounding);
* the scheduler with the prefix cache on, on both of the port's backends
  (the kernel backend takes its plain version on the CPU): a registry hit
  emits the cold tokens at kv16, kv8 and kv4; a tail that crosses a block
  boundary still hits the shared prompt at a shorter key; two rows decoding
  off one copy-on-write prefix leave its blocks' bytes unchanged; two
  prompts of one cold wave dedup (``admit()`` admits 3, 2 hits). Tokens,
  profile traces, billing events, admission order and the registry's
  counters equal the reference's, and the allocator drains to 0 live
  blocks.
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


def _manager(cls, stats):
    return cls(stats, accuracy_target=0.985, accuracy_floor=0.95,
               budget_j=stats[0].energy_j * 30, low_energy=0.5)


def _raw(x) -> np.ndarray:
    """The bytes of a pool tensor (torch or JAX), for bitwise compares."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else x.dtype).numpy().copy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else a.dtype).copy()


def _stats(sched) -> dict:
    """``robustness_stats()`` without the wall-clock latencies."""
    out = sched.robustness_stats()
    out.pop("recovery_latency_s")
    return out


def run_pair(parts, scfg, scenario, *, quantum=4, managed=False,
             sched_kw=None):
    """Run ``scenario(sched, Request) -> observations`` on the JAX
    scheduler and on the port's with each backend; check that results
    (tokens, traces, status, reason, retries), billing events, admission
    order, registry counters, robustness counters and observations agree
    and that the port's pool drains to 0 live blocks. ``sched_kw(side)``
    (side ``"jax"``, ``"gather"`` or ``"kernel"``) gives each scheduler
    its own keyword arguments (a ``FaultSchedule`` is stateful); without
    it every request must complete. Returns the port's schedulers."""
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    kw = sched_kw or (lambda side: {})
    jm = _manager(JManager, stats) if managed else None
    jsched = JScheduler(JServer(cfg, jp, jeng, JConfig(**scfg), manager=jm),
                        quantum=quantum, **kw("jax"))
    want = scenario(jsched, JRequest)
    out = {}
    for backend in ("gather", "kernel"):
        tm = _manager(ProfileManager, stats) if managed else None
        srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
            paged_backend=backend, **scfg), manager=tm, device="cpu")
        sched = ContinuousScheduler(srv, quantum=quantum, **kw(backend))
        got = scenario(sched, Request)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == want[key], (backend, key)
        res, jres = sched.results, jsched.results
        assert sorted(res) == sorted(jres)
        for rid in jres:
            assert res[rid]["tokens"] == jres[rid]["tokens"], (backend, rid)
            assert res[rid]["profile_trace"] == jres[rid]["profile_trace"]
            assert res[rid]["status"].value == jres[rid]["status"].value
            if sched_kw is None:
                assert res[rid]["status"].value == "completed"
            for key in ("reason", "retries"):
                assert res[rid].get(key) == jres[rid].get(key), (rid, key)
        assert sched.events == jsched.events
        assert sched.admission_log == jsched.admission_log
        if jsched.spec:
            assert sched.spec_billed == jsched.spec_billed
        assert _stats(sched) == _stats(jsched), backend
        if jsched.registry is not None:
            for name in ("hits", "misses", "invalidated"):
                assert getattr(sched.registry, name) == \
                    getattr(jsched.registry, name), name
            assert len(sched.registry) == len(jsched.registry)
        if jsched.paged:
            assert sched.allocator.used_blocks == 0 == \
                jsched.allocator.used_blocks
            assert sched.allocator.lru_blocks == jsched.allocator.lru_blocks
            assert sched.peak_used_blocks == jsched.peak_used_blocks
        if managed:
            assert tm.spent_j == jm.spent_j
        out[backend] = sched
    return out


# ---------------------------------------------------------------- the model

def test_prefix_attention_matches_reference():
    rng = np.random.default_rng(3)
    b, s, pp, hkv, hg, d = 3, 6, 16, 2, 3, 8
    q = rng.standard_normal((b, s, hkv * hg, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((b, pp, hkv, d)).astype(np.float32)
              for _ in "kv")
    ks, vs = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
              for _ in "kv")
    plen = np.array([16, 5, 0], np.int32)
    slen = np.array([6, 3, 2], np.int32)
    local = np.arange(s)[None] - (s - slen)[:, None]
    positions = (local + plen[:, None]).astype(np.int32)
    valid = local >= 0
    want = JA.prefix_attention(
        *(jnp.asarray(x) for x in (q, kp, vp, ks, vs)),
        positions=jnp.asarray(positions), prefix_len=jnp.asarray(plen),
        suffix_valid=jnp.asarray(valid))
    got = A.prefix_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, ks, vs)),
        positions=torch.from_numpy(positions),
        prefix_len=torch.from_numpy(plen),
        suffix_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _extend_inputs(cfg, seed=0):
    """Three rows: prefixes of 16, 8 and 0 tokens (raw K/V from the
    reference's cold prefill of the prefix), suffixes of 5, 9 and 3."""
    rng = np.random.default_rng(seed)
    plen = np.array([16, 8, 0], np.int32)
    slen = np.array([5, 9, 3], np.int32)
    sb = 16
    suf = np.zeros((3, sb), np.int32)
    for j, n in enumerate(slen):
        suf[j, sb - n:] = rng.integers(0, cfg.vocab, n)
    pre = np.zeros((3, 16), np.int32)
    for j, n in enumerate(plen):
        pre[j, 16 - n:] = rng.integers(0, cfg.vocab, n)
    return pre, plen, suf, slen


def _prefix_masters(parts, pre, plen, pid):
    """The reference's raw prefix K/V and amaxes, as ``prefill_extend``
    takes them (``[L, B, 16, Hkv, hd]``, zero past each prefix)."""
    cfg, _, jp, _, jeng, _, _ = parts
    _, _, (k, v) = JT.prefill(
        jp, cfg, jnp.asarray(jeng.table)[pid],
        {"tokens": jnp.asarray(pre), "prompt_len": jnp.asarray(plen)}, 32,
        return_raw_kv=True)
    k, v = np.asarray(k, np.float32), np.asarray(v, np.float32)
    mk, mv = np.zeros_like(k), np.zeros_like(v)
    for j, n in enumerate(plen):             # left-padded → leading
        mk[:, j, :n] = k[:, j, 16 - n:]
        mv[:, j, :n] = v[:, j, 16 - n:]
    ka = np.abs(mk).max(axis=(2, 4))
    va = np.abs(mv).max(axis=(2, 4))
    return mk, mv, ka, va


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_prefill_extend_logits_match_reference(parts, kv_bits):
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    pre, plen, suf, slen = _extend_inputs(cfg, seed=kv_bits)
    mk, mv, ka, va = _prefix_masters(parts, pre, plen, 2)
    jl, jc = JT.prefill_extend(
        jp, cfg, jnp.asarray(jeng.table)[2],
        {"tokens": jnp.asarray(suf), "prompt_len": jnp.asarray(slen)}, 48,
        kv_bits=kv_bits, prefix_k=jnp.asarray(mk), prefix_v=jnp.asarray(mv),
        prefix_len=jnp.asarray(plen), prefix_k_amax=jnp.asarray(ka),
        prefix_v_amax=jnp.asarray(va))
    tl, tc = T.prefill_extend(
        tp, tcfg, teng.table[2],
        {"tokens": torch.from_numpy(suf), "prompt_len": slen}, 48,
        kv_bits=kv_bits, prefix_k=torch.from_numpy(mk),
        prefix_v=torch.from_numpy(mv), prefix_len=plen,
        prefix_k_amax=torch.from_numpy(ka), prefix_v_amax=torch.from_numpy(va))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert np.array_equal(tc["kv"].token_idx.numpy(),
                          np.asarray(jc["kv"].token_idx))
    tidx = tc["kv"].token_idx.numpy()[0]
    for j in range(3):                       # prefix ++ suffix, then empty
        n = plen[j] + slen[j]
        assert tidx[j, :n].tolist() == list(range(n))
        assert (tidx[j, n:] == -1).all()
    # an all-16 precision-policy row is an exact passthrough
    pl, _ = T.prefill_extend(
        tp, tcfg, teng.table[2],
        {"tokens": torch.from_numpy(suf), "prompt_len": slen}, 48,
        kv_bits=kv_bits, prefix_k=torch.from_numpy(mk),
        prefix_v=torch.from_numpy(mv), prefix_len=plen,
        prefix_k_amax=torch.from_numpy(ka), prefix_v_amax=torch.from_numpy(va),
        kv_sched=np.full((cfg.n_layers,), 16))
    assert torch.equal(pl, tl)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_prefill_extend_ints_and_scales_bitwise(parts, kv_bits, monkeypatch):
    """Both sides fill from the same suffix K/V (their forwards are
    replaced by one fixed output): the quantized prefix and suffix ints,
    the scales ``max(prefix amax, suffix amax)`` in the fma form, and the
    token indices are equal bit for bit."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    pre, plen, suf, slen = _extend_inputs(cfg, seed=kv_bits + 1)
    mk, mv, ka, va = _prefix_masters(parts, pre, plen, 0)
    rng = np.random.default_rng(kv_bits)
    shape = (cfg.n_layers, 3, suf.shape[1], cfg.n_kv, cfg.hd)
    k, v = (rng.standard_normal(shape).astype(np.float32) * 2 for _ in "kv")
    k[:, 1, -1, 0, 0] = 40.0                # a suffix amax over the prefix's
    hid = rng.standard_normal((3, suf.shape[1], cfg.d_model)).astype(
        np.float32)
    monkeypatch.setattr(JT, "forward_extend", lambda *a, **kw: (
        jnp.asarray(hid), (jnp.asarray(k), jnp.asarray(v))))
    monkeypatch.setattr(T, "forward_extend", lambda *a, **kw: (
        torch.from_numpy(hid), (torch.from_numpy(k), torch.from_numpy(v))))
    # jitted, as the reference's servers run it: XLA lowers the scale to
    # the fma form that attention.kv_scale reproduces
    _, jc = jax.jit(lambda mk, mv, ka, va: JT.prefill_extend(
        jp, cfg, jnp.asarray(jeng.table)[0],
        {"tokens": jnp.asarray(suf), "prompt_len": jnp.asarray(slen)}, 48,
        kv_bits=kv_bits, prefix_k=mk, prefix_v=mv,
        prefix_len=jnp.asarray(plen), prefix_k_amax=ka,
        prefix_v_amax=va))(*(jnp.asarray(x) for x in (mk, mv, ka, va)))
    _, tc = T.prefill_extend(
        tp, tcfg, teng.table[0],
        {"tokens": torch.from_numpy(suf), "prompt_len": slen}, 48,
        kv_bits=kv_bits, prefix_k=torch.from_numpy(mk),
        prefix_v=torch.from_numpy(mv), prefix_len=plen,
        prefix_k_amax=torch.from_numpy(ka), prefix_v_amax=torch.from_numpy(va))
    for name in ("k", "v", "k_scale", "v_scale", "token_idx"):
        assert np.array_equal(_raw(getattr(tc["kv"], name)),
                              _raw(getattr(jc["kv"], name))), name


@pytest.mark.parametrize("kv_bits,pid", [(16, 2), (8, 5)])
def test_prefill_returns_reference_raw_kv(parts, kv_bits, pid):
    """At A8 and Mixed (at A16 the reference's inexact pow2 activation grid
    moves a value by one step, ``test_torch_quant``)."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    pre, plen, _, _ = _extend_inputs(cfg)
    plen = np.array([16, 8, 3], np.int32)
    _, _, (jk, jv) = JT.prefill(
        jp, cfg, jnp.asarray(jeng.table)[pid],
        {"tokens": jnp.asarray(pre), "prompt_len": jnp.asarray(plen)}, 32,
        kv_bits=kv_bits, return_raw_kv=True)
    batch = {"tokens": torch.from_numpy(pre), "prompt_len": plen}
    tl, tc, (tk, tv) = T.prefill(tp, tcfg, teng.table[pid], batch, 32,
                                 kv_bits=kv_bits, return_raw_kv=True)
    assert tk.shape == jk.shape == (cfg.n_layers, 3, 16, cfg.n_kv, cfg.hd)
    for j, n in enumerate(plen):      # real columns (pad columns are junk)
        for t, jx in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(t[:, j, 16 - n:].numpy(),
                                       np.asarray(jx)[:, j, 16 - n:],
                                       atol=1e-5, rtol=0)
    tl2, tc2 = T.prefill(tp, tcfg, teng.table[pid], batch, 32,
                         kv_bits=kv_bits)
    assert torch.equal(tl, tl2)
    assert torch.equal(tc["kv"].k, tc2["kv"].k)


# ------------------------------------------------------------ the scheduler

def _sys_requests(cfg, seed, tails, max_new, Req, sys_len=16):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, cfg.vocab, sys_len).astype(np.int32)
    return [Req(tokens=np.concatenate(
        [sys_p, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
        max_new=m, accuracy_critical=(i == 1))
        for i, (n, m) in enumerate(zip(tails, max_new))]


@pytest.mark.parametrize("kv_bits,managed", [(16, False), (8, True),
                                             (4, False)])
def test_shared_prefix_admission_matches_reference(parts, kv_bits, managed):
    """A hit prefills only its suffix yet emits the reference's tokens (the
    cold tokens, by the reference's own test), with the cold request
    retired first (its blocks resurrect from the LRU at kv16)."""
    cfg = parts[0]

    def scenario(sched, Req):
        reqs = _sys_requests(cfg, 21, (5, 3), (6, 6), Req)
        sched.submit(reqs[0])
        sched.run()
        after_cold = (sched.registry.hits, len(sched.registry))
        sched.submit(reqs[1])
        sched.run()
        return {"after_cold": after_cold, "hits": sched.registry.hits}

    out = run_pair(parts, dict(slots=64, max_batch=4, kv_bits=kv_bits,
                               block_size=8), scenario, managed=managed)
    assert out["kernel"].registry.hits == 1
    assert len(out["kernel"].registry) == 2


def test_shared_prefix_hits_across_block_boundary_tails(parts):
    cfg = parts[0]

    def scenario(sched, Req):
        reqs = _sys_requests(cfg, 37, (9, 11), (5, 5), Req)
        sched.submit(reqs[0])
        sched.run()                 # registers the 24-, 16- and 8-token keys
        n_reg = len(sched.registry)
        sched.submit(reqs[1])       # 27 tokens: its 24-token key differs,
        sched.run()                 # so it falls through to the 16-token one
        return {"n_reg": n_reg}

    out = run_pair(parts, dict(slots=64, max_batch=4, block_size=8),
                   scenario)
    assert out["gather"].registry.hits == 1
    assert out["gather"].registry._entries  # noqa: SLF001


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_cow_shared_blocks_unchanged(parts, kv_bits):
    """Two rows decode concurrently off the same prefix: at kv16 the second
    maps the first's blocks copy-on-write and the shared blocks' bytes are
    unchanged by its admission and by every later decode step, on both
    backends (the gather backend folds its views back through tables that
    several rows share); at kv8 nothing is shared and the hit requantizes
    from the masters."""
    cfg = parts[0]

    def scenario(sched, Req):
        r1, r2 = _sys_requests(cfg, 29, (4, 7), (12, 8), Req)
        sched.submit(r1)
        sched.step()                      # r1 cold, registered, still live
        e = max(sched.registry._entries.values(), key=lambda x: x.n_tokens)
        bids = None if e.block_ids is None else list(e.block_ids)
        pool = sched._caches["kv"]
        snap = (None if bids is None else
                [_raw(getattr(pool, n)[:, np.asarray(bids)])
                 for n in ("k", "v", "token_idx")])
        sched.submit(r2)                  # shares while r1 decodes
        steps = 0
        while sched.step():
            steps += 1
            if snap is not None:
                pool = sched._caches["kv"]
                now = [_raw(getattr(pool, n)[:, np.asarray(bids)])
                       for n in ("k", "v", "token_idx")]
                assert all(np.array_equal(a, b) for a, b in zip(now, snap))
        return {"bids": bids, "hits": sched.registry.hits, "steps": steps}

    out = run_pair(parts, dict(slots=64, max_batch=4, kv_bits=kv_bits,
                               block_size=8), scenario, quantum=2)
    assert out["kernel"].registry.hits == 1


def test_intra_wave_prefix_dedup(parts):
    """Three prompts with one system prefix (two of them identical) in one
    round: the first prefills cold and registers, the other two defer to the
    shared wave of the same round."""
    cfg = parts[0]

    def scenario(sched, Req):
        rng = np.random.default_rng(5)
        sys_p = rng.integers(0, cfg.vocab, 16).astype(np.int32)
        r1 = Req(tokens=np.concatenate(
            [sys_p, rng.integers(0, cfg.vocab, 4).astype(np.int32)]),
            max_new=6)
        r2 = Req(tokens=r1.tokens.copy(), max_new=6)
        r3 = Req(tokens=np.concatenate(
            [sys_p, rng.integers(0, cfg.vocab, 3).astype(np.int32)]),
            max_new=5)
        for r in (r1, r2, r3):
            sched.submit(r)
        n = sched.admit()
        hits = sched.registry.hits
        sched.run()
        return {"admitted": n, "hits_after_admit": hits}

    out = run_pair(parts, dict(slots=64, max_batch=4, block_size=8),
                   scenario, managed=True)
    sched = out["kernel"]
    assert sched.registry.hits == 2 and len(sched.events) > 2
    assert sched.events[:2] == [(sched.events[0][0], 1, False),
                                (sched.events[1][0], 2, False)]


def test_prefix_cache_refuses_rows_that_could_wrap(parts):
    _, tcfg, _, tp, _, teng, _ = parts
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        slots=64, max_batch=2, block_size=8), device="cpu")
    sched = ContinuousScheduler(srv)
    with pytest.raises(ValueError, match="prefix-sharing"):
        sched.submit(Request(tokens=np.zeros(40, np.int32), max_new=24))
    off = ContinuousScheduler(AdaptiveServer(tcfg, tp, teng, ServingConfig(
        slots=64, max_batch=2, block_size=8, prefix_cache=False),
        device="cpu"))
    assert off.registry is None
    off.submit(Request(tokens=np.zeros(40, np.int32), max_new=24))
    st = sched.paged_stats()
    assert st["registry_entries"] == 0 and st["registry_bytes"] == 0
    assert "registry_hits" not in off.paged_stats()
