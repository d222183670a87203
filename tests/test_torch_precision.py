"""The per-layer KV precision policy in the port against the JAX reference,
on the same weights (smoke granite-3-2b cut to 3 layers, so a striped row
holds 4, 8 and 16; f32; ``params_from_jax``):

* the model: ``kv_refine`` bit for bit against the jitted reference (f32
  and bf16, 4/8/16 bits, an all-zero row); ``prefill`` and
  ``prefill_extend`` under a striped row: logits within 1e-4, and the
  caches (ints and scales, bf16 bytes) bit for bit when both sides
  project the same K/V (``_attn_qkv`` replaced by one fixed function of
  the weights);
  ``decode_step`` on both backends within 1e-4;
* the serving stack, the cases of the reference's own policy tests called
  directly: the continuous scheduler under a striped row on both backends
  at kv16/kv8/kv4 gives the JAX scheduler's tokens (through
  ``test_torch_prefix.run_pair``) and the port's solo tokens, and differs
  from the run without a policy; the all-16 row gives the no-policy
  tokens; the refusals (speculation on either pool, a wrong shape, an
  entry of 5, ``greedy=False``); critical pinning (events equal, the
  critical request's tokens and trace those of no policy, billed =
  delivered); static ``serve``/``generate`` at kv8; chunked prefill, a
  prefix hit and a preemption resume under the policy;
* the frontier search against ``benchmarks/precision_frontier.py``, the
  launcher's ``--precision-policy`` and ``--paged-backend pallas``, and
  ``ServingConfig``'s fields against the reference's.
"""
import dataclasses
import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.manager import ProfileManager as JManager
from repro.core.manager import ProfileStats as JStats
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
from repro_torch.core.manager import ProfileManager, ProfileStats
from repro_torch.launch import precision_frontier as F
from repro_torch.launch import serve as S
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_policy import _preempt_cfg, _preempt_requests, \
    _preempt_scenario
from test_torch_prefix import _raw, _sys_requests, run_pair
from torch_threads import _one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
STRIPE = (4, 8, 16)


@pytest.fixture(scope="module")
def parts():
    """``run_pair``'s tuple at 3 layers."""
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), n_layers=3)
    tcfg = dataclasses.replace(C.get_smoke("granite-3-2b"), n_layers=3)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    names = JT.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    jeng = AdaptiveEngine(tuple(profs), QuantIndex(names), lambda *a: None)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names, inner_layers=[])),
                             TE.QuantIndex(names))
    stats = jax_profile_stats(cfg, profs, JT.param_count(jp))
    return cfg, tcfg, jp, tp, jeng, teng, stats


def _row(cfg):
    return tuple(STRIPE[l % 3] for l in range(cfg.n_layers))


def _mixed(parts, row=None):
    """The striped row (or ``row``) for every profile."""
    cfg, *_, teng, _ = parts
    return tuple(row or _row(cfg) for _ in teng.profile_names)


def _all16(parts):
    return _mixed(parts, (16,) * parts[0].n_layers)


# ---------------------------------------------------------------- the model

def test_kv_refine_bitwise_against_jitted_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 17, 8, 64)) * 3).astype(np.float32)
    x[0, 0] = 0.0                              # an all-zero row: the floor
    x[1, 2, 3, 5] = 1e-12
    ref = jax.jit(JA.kv_refine)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(x).astype(jdt)
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
        for bits in (4, 8, 16):
            want = ref(xj, jnp.int32(bits))
            got = A.kv_refine(xt, bits)
            assert got.dtype == tdt
            assert np.array_equal(_raw(got), _raw(want)), (jdt, bits)
    zero = A.kv_refine(torch.zeros(2, 3, 4), 4)
    assert torch.equal(zero, torch.zeros(2, 3, 4))
    t = torch.from_numpy(x)
    assert A.kv_refine(t, 16) is t             # 16: no ops at all


def _fake_qkv(lib):
    """``_attn_qkv`` replaced by a fixed function of the layer's weights
    (rows of ``qkv.w`` scaled by the batch row), elementwise, so both
    sides project the same K/V bit for bit."""
    def fake(cfg, lp, x, lb, positions):
        b, s, _ = x.shape
        hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv
        w = lp["qkv"]["w"][:s]
        if lib == "jax":
            base = w[None] * (jnp.arange(b, dtype=jnp.float32) + 1.0
                              )[:, None, None]
        else:
            base = w[None] * (torch.arange(b, dtype=torch.float32) + 1.0
                              )[:, None, None]
        q = base[..., :h * hd].reshape(b, s, h, hd)
        k = base[..., h * hd:(h + hkv) * hd].reshape(b, s, hkv, hd)
        v = base[..., (h + hkv) * hd:].reshape(b, s, hkv, hd)
        return q, k, v
    return fake


def _prompts(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (3, 11)).astype(np.int32),
            np.array([11, 7, 4], np.int32))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_prefill_under_policy_matches_reference(parts, kv_bits,
                                                monkeypatch):
    """Logits within 1e-4 of the jitted reference's (A8-W8, whose
    activation grid is exact on both sides); at kv8/kv4 the ints, scales
    and token indices bit for bit on a shared projection; the raw K/V are
    the refined ones."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    toks, plen = _prompts(cfg)
    row = np.asarray(_row(cfg), np.int32)

    def both():
        jl, jc, jraw = jax.jit(lambda t, p, s: JT.prefill(
            jp, cfg, jnp.asarray(jeng.table)[2],
            {"tokens": t, "prompt_len": p}, 24, kv_bits=kv_bits,
            kv_sched=s, return_raw_kv=True))(
                jnp.asarray(toks), jnp.asarray(plen), jnp.asarray(row))
        tl, tc, traw = T.prefill(
            tp, tcfg, teng.table[2],
            {"tokens": torch.from_numpy(toks), "prompt_len": plen}, 24,
            kv_bits=kv_bits, kv_sched=row, return_raw_kv=True)
        return (jl, jc, jraw), (tl, tc, traw)

    (jl, _, _), (tl, _, _) = both()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    nl, _ = T.prefill(tp, tcfg, teng.table[2],
                      {"tokens": torch.from_numpy(toks), "prompt_len": plen},
                      24, kv_bits=kv_bits)
    assert not torch.equal(nl, tl)             # the policy moved the logits
    monkeypatch.setattr(JT, "_attn_qkv", _fake_qkv("jax"))
    monkeypatch.setattr(T, "_attn_qkv", _fake_qkv("torch"))
    (_, jc, (jk, jv)), (_, tc, (tk, tv)) = both()
    for name in ("k", "v", "k_scale", "v_scale", "token_idx"):
        assert np.array_equal(_raw(getattr(tc["kv"], name)),
                              _raw(getattr(jc["kv"], name))), name
    assert np.array_equal(_raw(tk), _raw(jk))
    assert np.array_equal(_raw(tv), _raw(jv))
    for l, b in enumerate(row):               # the masters are refined
        k = _fake_qkv("torch")(tcfg, T._layer(tp["layers"], l),
                               torch.zeros(3, 11, 1), None, None)[1]
        assert torch.equal(tk[l], A.kv_refine(k, b))
        assert torch.equal(tk[l], k) == (b == 16)


@pytest.mark.parametrize("kv_bits", [16, 4])
def test_prefill_extend_under_policy_matches_reference(parts, kv_bits,
                                                       monkeypatch):
    """Only the fresh suffix is refined: the prefix masters replay as
    they are. Logits within 1e-4; the cache (kv4 ints and scales, kv16
    bf16 bytes) bit for bit on a shared projection."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    rng = np.random.default_rng(kv_bits)
    plen = np.array([16, 8, 0], np.int32)
    slen = np.array([5, 9, 3], np.int32)
    suf = np.zeros((3, 16), np.int32)
    for j, n in enumerate(slen):
        suf[j, 16 - n:] = rng.integers(0, cfg.vocab, n)
    shape = (cfg.n_layers, 3, 16, cfg.n_kv, cfg.hd)
    mk, mv = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    for j, n in enumerate(plen):
        mk[:, j, n:] = mv[:, j, n:] = 0.0
    ka, va = np.abs(mk).max(axis=(2, 4)), np.abs(mv).max(axis=(2, 4))
    row = np.asarray(_row(cfg), np.int32)

    def both():
        jl, jc, jraw = jax.jit(lambda s, *m: JT.prefill_extend(
            jp, cfg, jnp.asarray(jeng.table)[2],
            {"tokens": jnp.asarray(suf), "prompt_len": jnp.asarray(slen)},
            48, kv_bits=kv_bits, prefix_k=m[0], prefix_v=m[1],
            prefix_len=jnp.asarray(plen), prefix_k_amax=m[2],
            prefix_v_amax=m[3], return_raw_kv=True, kv_sched=s))(
                jnp.asarray(row), *(jnp.asarray(x) for x in (mk, mv, ka, va)))
        tl, tc, traw = T.prefill_extend(
            tp, tcfg, teng.table[2],
            {"tokens": torch.from_numpy(suf), "prompt_len": slen}, 48,
            kv_bits=kv_bits, prefix_k=torch.from_numpy(mk),
            prefix_v=torch.from_numpy(mv), prefix_len=plen,
            prefix_k_amax=torch.from_numpy(ka),
            prefix_v_amax=torch.from_numpy(va), return_raw_kv=True,
            kv_sched=row)
        return (jl, jc, jraw), (tl, tc, traw)

    (jl, _, _), (tl, _, _) = both()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    monkeypatch.setattr(JT, "_attn_qkv", _fake_qkv("jax"))
    monkeypatch.setattr(T, "_attn_qkv", _fake_qkv("torch"))
    (_, jc, (jk, _)), (_, tc, (tk, _)) = both()
    for name in ("k", "v", "k_scale", "v_scale", "token_idx"):
        assert np.array_equal(_raw(getattr(tc["kv"], name)),
                              _raw(getattr(jc["kv"], name))), name
    assert np.array_equal(_raw(tk), _raw(jk))
    if kv_bits == 16:                          # prefix bytes: the masters
        got = tc["kv"].k[0, 0, :16].float()
        assert torch.equal(got, torch.from_numpy(mk[0, 0]).bfloat16().float())


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_decode_step_under_policy_matches_reference(parts, backend):
    """Three decode steps on a contiguous cache under the striped row
    (at kv8 the kernel backend reads through K4's plain version)."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    kv_bits = 8
    toks, plen = _prompts(cfg, seed=3)
    row = np.asarray(_row(cfg), np.int32)
    jl, jc = jax.jit(lambda t, p, s: JT.prefill(
        jp, cfg, jnp.asarray(jeng.table)[2], {"tokens": t, "prompt_len": p},
        24, kv_bits=kv_bits, kv_sched=s))(
            jnp.asarray(toks), jnp.asarray(plen), jnp.asarray(row))
    tl, tc = T.prefill(tp, tcfg, teng.table[2],
                       {"tokens": torch.from_numpy(toks), "prompt_len": plen},
                       24, kv_bits=kv_bits, kv_sched=row)
    jstep = jax.jit(lambda t, p, c, s: JT.decode_step(
        jp, cfg, jnp.asarray(jeng.table)[5], t, p, c, kv_sched=s))
    pos = plen.copy()
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(tl.numpy().argmax(-1), nxt)
        jl, jc = jstep(jnp.asarray(nxt[:, None]), jnp.asarray(pos), jc,
                       jnp.asarray(row))
        tl, tc = T.decode_step(tp, tcfg, teng.table[5],
                               torch.from_numpy(nxt[:, None]),
                               torch.from_numpy(pos), tc,
                               paged_backend=backend, kv_sched=row)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        pos = pos + 1
    with pytest.raises(ValueError, match="entries"):
        T.decode_step(tp, tcfg, teng.table[5], torch.from_numpy(nxt[:, None]),
                      torch.from_numpy(pos), tc, kv_sched=row[:2])


# ------------------------------------------------------------ serving level

def _solo(parts, req, policy=None, kv_bits=16):
    _, tcfg, _, tp, _, teng, _ = parts
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        slots=64, max_batch=4, kv_bits=kv_bits, precision_policy=policy),
        device="cpu")
    return srv.generate(req.tokens[None, :], req.max_new)["tokens"][0]


def _mix_requests(cfg, Req):
    rng = np.random.default_rng(37)
    return [Req(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=mn) for n, mn in [(7, 6), (9, 5), (17, 6)]]


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_mixed_schedule_scheduler_identity(parts, kv_bits):
    """The scheduler under the striped row on both backends gives the
    JAX scheduler's tokens and the port's solo tokens under the same
    policy, and differs from the run without one."""
    cfg = parts[0]
    policy = _mixed(parts)

    def scenario(sched, Req):
        for r in _mix_requests(cfg, Req):
            sched.submit(r)
        sched.run()
        return {}

    out = run_pair(parts, dict(slots=64, max_batch=4, block_size=8,
                               kv_bits=kv_bits, prefix_cache=False,
                               precision_policy=policy), scenario)
    drifted = False
    for rid, req in enumerate(_mix_requests(cfg, Request)):
        toks = out["kernel"].results[rid]["tokens"]
        assert toks == _solo(parts, req, policy, kv_bits)
        drifted |= toks != _solo(parts, req, None, kv_bits)
    assert drifted


def test_all16_policy_is_exact_passthrough(parts):
    """Solo and through the scheduler, on both backends."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    req = _mix_requests(cfg, Request)[2]
    assert _solo(parts, req, _all16(parts)) == _solo(parts, req)
    for backend in ("gather", "kernel"):
        got = []
        for pol in (_all16(parts), None):
            srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
                slots=64, max_batch=4, block_size=8, kv_bits=8,
                paged_backend=backend, precision_policy=pol), device="cpu")
            sched = ContinuousScheduler(srv, quantum=4)
            for r in _mix_requests(cfg, Request):
                sched.submit(r)
            got.append([r["tokens"] for r in sched.run()])
        assert got[0] == got[1], backend


def test_invalid_configurations_refused(parts):
    _, tcfg, _, tp, _, teng, _ = parts

    def build(**kw):
        return AdaptiveServer(tcfg, tp, teng, ServingConfig(
            slots=64, max_batch=4, block_size=8, **kw), device="cpu")

    for paged in (True, False):
        with pytest.raises(ValueError, match="speculate"):
            build(speculate=True, draft_k=2, paged_kv=paged,
                  precision_policy=_mixed(parts))
    with pytest.raises(ValueError, match="shape"):
        build(precision_policy=_mixed(parts)[:3])
    with pytest.raises(ValueError, match="shape"):
        build(precision_policy=_mixed(parts, (8, 8)))
    with pytest.raises(ValueError, match="4, 8 or 16"):
        build(precision_policy=_mixed(parts, (4, 5, 16)))
    with pytest.raises(ValueError, match="greedy"):
        build(greedy=False)
    assert build(paged_backend="pallas").paged_backend == "kernel"
    assert build(precision_policy=_mixed(parts)).kv_table.shape == (6, 3)
    assert build().kv_table is None


def test_serving_config_fields_equal_the_reference():
    assert [f.name for f in dataclasses.fields(ServingConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    assert ServingConfig().greedy is True
    assert ServingConfig().precision_policy is None


_CRIT_STATS = [("A16-W8", 0.99, 4.0), ("A16-W4", 0.953, 2.0),
               ("A8-W8", 0.988, 3.0), ("A8-W4", 0.953, 1.5),
               ("A4-W4", 0.958, 1.0), ("Mixed", 0.975, 2.0)]


def test_critical_pinned_identity_and_billing(parts):
    """The accuracy-bound profiles pin the all-16 row: the critical
    request's stream equals the no-policy twin's while saver rows ride the
    striped row; events equal (billing does not depend on the policy),
    billed = delivered, and the JAX scheduler agrees under the policy."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    policy = tuple((16,) * cfg.n_layers if acc >= 0.985 else _row(cfg)
                   for _, acc, _ in _CRIT_STATS)
    scfg = dict(slots=64, max_batch=4, block_size=8, priority_classes=2)

    def reqs(Req):
        rng = np.random.default_rng(43)
        mk = lambda n: rng.integers(0, cfg.vocab, n).astype(np.int32)
        return [Req(tokens=mk(7), max_new=6, priority=0,
                    accuracy_critical=True),
                Req(tokens=mk(9), max_new=8, priority=1),
                Req(tokens=mk(6), max_new=8, priority=1)]

    def run(Server, Config, Sched, Manager, Stats, Req, params, eng, pol,
            **kw):
        mgr = Manager([Stats(n, a, e, 1e-3) for n, a, e in _CRIT_STATS],
                      accuracy_target=0.985, accuracy_floor=0.90,
                      budget_j=60.0, low_energy=0.5)
        srv = Server(cfg if Server is JServer else tcfg, params, eng,
                     Config(precision_policy=pol, **scfg), manager=mgr, **kw)
        sched = Sched(srv, quantum=3)
        for r in reqs(Req):
            sched.submit(r)
        sched.run()
        return sched

    port = (AdaptiveServer, ServingConfig, ContinuousScheduler,
            ProfileManager, ProfileStats, Request, tp, teng)
    s_pol = run(*port, policy, device="cpu")
    s_base = run(*port, None, device="cpu")
    s_ref = run(JServer, JConfig, JScheduler, JManager, JStats, JRequest,
                jp, jeng, policy)
    assert any("A4-W4" in s_pol.results[rid]["profile_trace"]
               for rid in range(3))
    assert s_pol.events == s_base.events == s_ref.events
    assert s_pol.results[0]["profile_trace"] == \
        s_base.results[0]["profile_trace"]
    assert s_pol.results[0]["tokens"] == s_base.results[0]["tokens"]
    for rid in range(3):
        assert s_pol.results[rid]["tokens"] == s_ref.results[rid]["tokens"]
        assert s_pol.results[rid]["profile_trace"] == \
            s_ref.results[rid]["profile_trace"]
    assert any(s_pol.results[rid]["tokens"] != s_base.results[rid]["tokens"]
               for rid in (1, 2))
    assert sum(n for _, n, _ in s_pol.events) == sum(
        r.max_new for r in reqs(Request))


def test_static_serve_and_generate_kv8_match_reference(parts):
    """``serve``, ``generate`` and ``generate_stepwise``, managed (the
    ledger crosses into saver profiles, so steps switch rows), on both
    backends (the kernel reads through K4's plain version)."""
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    policy = tuple((16,) * cfg.n_layers if i == 0 else _row(cfg)
                   for i in range(6))
    rng = np.random.default_rng(5)
    shape = [(4, 6), (9, 3), (17, 8), (6, 1), (12, 5), (7, 9)]
    reqs = [(rng.integers(0, cfg.vocab, n).astype(np.int32), m, i % 3 == 0)
            for i, (n, m) in enumerate(shape)]
    prompts = rng.integers(0, cfg.vocab, (3, 7)).astype(np.int32)

    def mgr(cls):
        return cls(stats, accuracy_target=0.985, accuracy_floor=0.95,
                   budget_j=stats[0].energy_j * 12, low_energy=0.5)

    scfg = dict(slots=64, max_batch=4, kv_bits=8, prefix_cache=False,
                precision_policy=policy)
    js = JServer(cfg, jp, jeng, JConfig(**scfg), manager=mgr(JManager))
    want = js.serve([JRequest(tokens=t, max_new=m, accuracy_critical=c)
                     for t, m, c in reqs])
    js.manager = mgr(JManager)
    want_gen = js.generate(prompts, 9)
    js.manager = mgr(JManager)
    want_step = js.generate_stepwise(prompts, 9)
    for backend in ("gather", "kernel"):
        ts = AdaptiveServer(tcfg, tp, teng, ServingConfig(
            paged_backend=backend, **scfg), manager=mgr(ProfileManager),
            device="cpu")
        got = ts.serve([Request(tokens=t, max_new=m, accuracy_critical=c)
                        for t, m, c in reqs])
        for g, w in zip(got, want):
            assert g["tokens"] == w["tokens"], backend
            assert g["profile_trace"] == w["profile_trace"], backend
        assert len({p for r in got for p in r["profile_trace"]}) > 1
        ts.manager = mgr(ProfileManager)
        gen = ts.generate(prompts, 9)
        assert gen["tokens"] == [list(map(int, r))
                                 for r in want_gen["tokens"]], backend
        assert gen["profile_trace"] == want_gen["profile_trace"]
        ts.manager = mgr(ProfileManager)
        step = ts.generate_stepwise(prompts, 9)
        assert step["tokens"] == [list(map(int, r))
                                  for r in want_step["tokens"]], backend
        assert step["profile_trace"] == want_step["profile_trace"]


def test_chunked_prefill_and_prefix_hit_under_policy(parts):
    """A cold request registers its prefix, a second hits it with a long
    suffix that prefills in chunks; kv8 keeps masters, so every replay
    reads the refined masters, never refining them again."""
    cfg = parts[0]

    def scenario(sched, Req):
        reqs = _sys_requests(cfg, 21, (5, 30), (6, 6), Req)
        sched.submit(reqs[0])
        sched.run()
        sched.submit(reqs[1])
        sched.run()
        return {"hits": sched.registry.hits}

    out = run_pair(parts, dict(slots=64, max_batch=4, kv_bits=8,
                               block_size=8, prefill_chunk=16,
                               precision_policy=_mixed(parts)), scenario,
                   managed=True)
    assert out["kernel"].registry.hits == 1
    assert out["kernel"].chunk_waves >= 1


@pytest.mark.parametrize("kv_bits", [4])
def test_preempt_resume_under_policy(parts, kv_bits):
    """The resume wave replays the refined masters (an empty suffix is all
    that passes through the refine): the JAX scheduler's tokens, and the
    savers' tokens those of the calm serve under the same policy."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    scfg = _preempt_cfg(kv_bits, precision_policy=_mixed(parts))
    out = run_pair(parts, scfg, _preempt_scenario(cfg), quantum=2)
    calm = ContinuousScheduler(AdaptiveServer(
        tcfg, tp, teng, ServingConfig(**scfg), device="cpu"), quantum=2)
    _preempt_scenario(cfg, crit=False)(calm, Request)
    for sched in out.values():
        assert sched.preemptions == sched.resumes >= 1
        for rid in range(2):
            assert sched.results[rid]["tokens"] == \
                calm.results[rid]["tokens"]
    assert len(_preempt_requests(cfg, Request)) == 3


# ------------------------------------------------- frontier and launcher

def _reference_frontier(monkeypatch):
    """``benchmarks/precision_frontier.py`` with its prefill jitted (one
    compile instead of JAX's per-op dispatch; the same logits)."""
    spec = importlib.util.spec_from_file_location(
        "precision_frontier_ref", ROOT / "benchmarks" / "precision_frontier.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jitted = types.SimpleNamespace(**vars(JT))
    jitted.prefill = jax.jit(JT.prefill, static_argnums=(1, 4))
    monkeypatch.setattr(mod, "T", jitted)
    return mod


def test_frontier_search_matches_reference(monkeypatch):
    """On the reference's own weights: probing at A8-W8 (an activation
    grid both sides compute exactly), the port's score function and
    ``search_precision`` give the reference's frontier, schedules equal
    and scores within 1e-4 relative; ``search`` itself (A16-W8, as the
    reference's) gives the reference's schedules and JSON keys (the
    reference's A16 grid is inexact on the CPU, which moves its scores by
    a few per cent)."""
    ref = _reference_frontier(monkeypatch)
    cfg = get_smoke("granite-3-2b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    names = JT.quant_layer_names(cfg)
    jeng = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                          QuantIndex(names), lambda *a: None)
    probe = np.random.default_rng(0).integers(0, cfg.vocab, (4, 12)).astype(
        np.int32)
    mgr = JManager([JStats("hi", 0.99, 1.0, 1.0)], accuracy_target=0.985,
                   accuracy_floor=0.95, budget_j=0.0)
    score = ref.build_score_fn(cfg, jp, jnp.asarray(jeng.table)[2], probe)
    want_sched, want = mgr.search_precision(
        cfg.n_layers, score, lambda s: ref.kv_bytes_per_token(cfg, s),
        ladder=(16, 8, 4), max_drop=0.05)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names, inner_layers=[])),
                             TE.QuantIndex(names))
    tscore = F.build_score_fn(cfg, tp, teng.table[2], torch.from_numpy(probe))
    tmgr = ProfileManager([ProfileStats("hi", 0.99, 1.0, 1.0)],
                          accuracy_target=0.985, accuracy_floor=0.95,
                          budget_j=0.0)
    got_sched, got = tmgr.search_precision(
        cfg.n_layers, tscore, lambda s: F.kv_bytes_per_token(cfg, s),
        ladder=(16, 8, 4), max_drop=0.05)
    assert got_sched.tolist() == want_sched.tolist()
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g["schedule"] == w["schedule"] and g["bytes"] == w["bytes"]
        assert abs(g["score"] - w["score"]) <= 1e-4 * max(w["score"], 1e-12)
    full_ref = ref.search("granite-3-2b", 0.05)
    full = F.search("granite-3-2b", 0.05, device="cpu", params=tp)
    assert full.keys() == full_ref.keys()
    assert full["schedule"] == full_ref["schedule"]
    assert [s["schedule"] for s in full["frontier"]] == \
        [s["schedule"] for s in full_ref["frontier"]]
    assert full["bytes_per_token_all16"] == full_ref["bytes_per_token_all16"]


def test_launcher_precision_policy(tmp_path, capsys):
    """The frontier's JSON drives the launcher: profile 0 keeps the all-16
    row, the others ride the schedule; a schedule of another length is a
    SystemExit; ``--paged-backend pallas`` is the kernel backend."""
    path = tmp_path / "policy.json"
    F.main(["--device", "cpu", "--json", str(path)])
    sched = json.loads(path.read_text())["schedule"]
    assert len(sched) == 2 and set(sched) <= {4, 8, 16}
    args = S.parse_args(["--device", "cpu", "--continuous",
                         "--precision-policy", str(path),
                         "--paged-backend", "pallas"])
    cfg, srv = S.build_server(args)
    assert srv.paged_backend == "kernel"
    assert srv.kv_table.tolist() == [[16, 16]] + [sched] * 5
    S.main(["--device", "cpu", "--continuous", "--requests", "3",
            "--max-new", "4", "--precision-policy", str(path),
            "--paged-backend", "pallas"])
    out = capsys.readouterr().out
    assert "12 tokens" in out and "kernel backend" in out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schedule": [8, 8, 8]}))
    with pytest.raises(SystemExit, match="3 layers, model has 2"):
        S.build_server(S.parse_args(["--device", "cpu",
                                     "--precision-policy", str(bad)]))
