"""The admission waves' CUDA-graph route (``WaveGraphs`` in
``repro_torch/serving/graphs.py``) on the CPU, where no graph is captured:
the capture stand-in returns the step itself as its replay, so the
staging into fixed int32 buffers, the shared prefix and output buffers and
the bookkeeping run eagerly.

* the graphed scheduler (two submission passes on one scheduler, so wave
  keys recur) against the JAX ``ContinuousScheduler`` on the granite smoke
  config at kv16 paged, kv8 and kv16 paged with prefix hits and chunked
  prefill, kv8 contiguous, and a preemption and resume: tokens, traces,
  statuses, events, admission order, registry counters and the ledger
  equal;
* on those runs the eager waves (``graphs=False``) equal the graphed ones
  bitwise, the pool's ``k``, ``v``, ``token_idx``, scales and block table
  and the carries after each wave included;
* a padded wave (a = 4, 3 live rows) leaves every pool row outside
  ``slots_idx`` and every block outside ``dest`` unchanged, the write
  sink apart, eager and graphed, paged and contiguous;
* ``prefill`` / ``prefill_extend`` with lengths as tensors equal the
  numpy-length calls bitwise;
* two waves of one key before a flush keep their own first tokens;
* captures = the distinct wave keys, none on a warm pool; a forced
  recapture fails ``assert_wave_executables``;
* a hymba smoke contiguous wave writes its SSM rows as the reference's
  ``admit`` does.
"""
import dataclasses

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
from repro.models import transformer as JT
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
from repro.serving.scheduler import ContinuousScheduler as JScheduler
import repro_torch.configs as C
from repro_torch.analysis.tracker import SchedulerAudit
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.manager import ProfileManager
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import graphs as G
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from torch_threads import _one_thread  # noqa: F401


def stand_in(step, stream, pool):
    """A capture that records nothing: the step is its own replay."""
    return step


def _engines(cfg):
    names = JT.quant_layer_names(cfg)
    jeng = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                          QuantIndex(names), lambda *a: None)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names, inner_layers=[])),
                             TE.QuantIndex(names))
    return jeng, teng


@pytest.fixture(scope="module")
def parts():
    cfg = get_smoke("granite-3-2b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jeng, teng = _engines(cfg)
    stats = jax_profile_stats(cfg, jeng.profiles, JT.param_count(jp))
    return cfg, C.get_smoke("granite-3-2b"), jp, tp, jeng, teng, stats


def _manager(cls, stats):
    return cls(stats, accuracy_target=0.985, accuracy_floor=0.95,
               budget_j=stats[0].energy_j * 30, low_energy=0.5)


def _requests(cfg, Req, seed, shape, sys_len=0):
    """Requests of ``shape`` ``(prompt tokens, max_new)`` from ``seed``,
    behind a shared system prompt of ``sys_len`` tokens."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, cfg.vocab, sys_len).astype(np.int32)
    return [Req(tokens=np.concatenate(
        [sys_p, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
        max_new=m, accuracy_critical=(i % 3 == 0))
        for i, (n, m) in enumerate(shape)]


MIXED = [(4, 9), (9, 2), (6, 5), (5, 12), (8, 3), (7, 7)]
TAILS = [(3, 5), (13, 3), (5, 4), (20, 2), (2, 3)]


def _two_passes(sys_len, shape):
    """Two submission passes on one scheduler: the second's prompts have
    the first's lengths (another seed), so its waves reuse the keys."""
    def scenario(sched, Req):
        cfg = sched.srv.cfg
        for seed in (11, 12):
            for r in _requests(cfg, Req, seed, shape, sys_len):
                sched.submit(r)
            sched.run()
        return {}
    return scenario


def _preempt(sched, Req):
    """Two savers on a shared prefix, then a critical arrival that evicts
    one; it resumes through the master-replay wave."""
    cfg = sched.srv.cfg
    rng = np.random.default_rng(17)
    sys_p = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    savers = [Req(tokens=np.concatenate(
        [sys_p, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
        max_new=m, priority=1) for n, m in ((4, 18), (7, 16))]
    crit = Req(tokens=rng.integers(0, cfg.vocab, 7).astype(np.int32),
               max_new=4, priority=0)
    sched.submit(savers[0])
    sched.step()
    sched.submit(savers[1])
    sched.step()
    sched.step()
    sched.submit(crit)
    while sched.step():
        pass
    return {"preemptions": sched.preemptions, "resumes": sched.resumes}


MODES = {
    "kv16-paged": (dict(slots=64, max_batch=4, block_size=8), True,
                   _two_passes(0, MIXED)),
    "kv8-prefix-chunked": (dict(slots=64, max_batch=4, block_size=8,
                                kv_bits=8, prefill_chunk=8), True,
                           _two_passes(16, TAILS)),
    "kv16-prefix-chunked": (dict(slots=64, max_batch=4, block_size=8,
                                 prefill_chunk=8), False,
                            _two_passes(16, TAILS)),
    "kv8-contiguous": (dict(slots=64, max_batch=4, kv_bits=8,
                            paged_kv=False), True, _two_passes(0, MIXED)),
    "preempt-resume": (dict(slots=64, max_batch=2, block_size=8, kv_bits=8,
                            priority_classes=2, preemption=True), False,
                       _preempt),
}


def _state(sched) -> dict:
    """Every tensor of the pool and the carries, as bytes."""
    out = {"tok": sched._tok.clone(), "pos": sched._pos.clone()}
    for key, c in sched._caches.items():
        for f in dataclasses.fields(c):
            x = getattr(c, f.name)
            if isinstance(x, torch.Tensor):
                out[f"{key}.{f.name}"] = x.clone()
    return out


def _same(a: dict, b: dict, what) -> None:
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k].contiguous(), b[k].contiguous()
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), \
            (what, k)


def _watch(sched) -> list:
    """Record ``(kind, tok0, pool state)`` after every wave."""
    seen = []
    orig = sched._wave

    def wave(kind, *a, **k):
        tok0, raw = orig(kind, *a, **k)
        seen.append((kind, tok0.clone(), _state(sched)))
        return tok0, raw
    sched._wave = wave
    return seen


@pytest.fixture(scope="module")
def runs(parts):
    """Per mode, once: the JAX scheduler and the port's eager and graphed
    (stand-in capture) schedulers on the kernel backend, each with the
    pool's state after every wave."""
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    cache = {}

    def get(mode):
        if mode in cache:
            return cache[mode]
        scfg, managed, scenario = MODES[mode]
        jm = _manager(JManager, stats) if managed else None
        js = JScheduler(JServer(cfg, jp, jeng, JConfig(**scfg), manager=jm),
                        quantum=2 if "preempt" in mode else 4)
        out = {"jax": (js, scenario(js, JRequest), jm)}
        for side, kw in (("eager", {"graphs": False}),
                         ("graphed", {"capture": stand_in})):
            tm = _manager(ProfileManager, stats) if managed else None
            srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
                paged_backend="kernel", **scfg), manager=tm, device="cpu")
            sched = ContinuousScheduler(srv, quantum=js.quantum, **kw)
            seen = _watch(sched)
            out[side] = (sched, scenario(sched, Request), tm, seen)
        cache[mode] = out
        return out
    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_graphed_waves_match_reference(runs, mode):
    """The graphed scheduler's waves replay from their keys' graphs and
    its tokens, traces, statuses, events, admission order, registry
    counters and ledger equal the JAX scheduler's."""
    r = runs(mode)
    js, want, jm = r["jax"]
    sched, got, tm, _ = r["graphed"]
    assert got == want
    assert sorted(sched.results) == sorted(js.results)
    for rid in js.results:
        for key in ("tokens", "profile_trace"):
            assert sched.results[rid][key] == js.results[rid][key], rid
        assert sched.results[rid]["status"].value == \
            js.results[rid]["status"].value == "completed"
    assert sched.events == js.events
    assert sched.admission_log == js.admission_log
    if js.registry is not None:
        for name in ("hits", "misses", "invalidated"):
            assert getattr(sched.registry, name) == \
                getattr(js.registry, name), name
    if js.paged:
        assert sched.allocator.used_blocks == 0 == js.allocator.used_blocks
        assert sched.peak_used_blocks == js.peak_used_blocks
    if jm is not None:
        assert tm.spent_j == jm.spent_j
    w = sched.waves
    assert isinstance(w, G.WaveGraphs) and w.lifetimes == 1
    assert sorted(w.captured) == sorted(w.used) and w.captured
    kinds = {k[0] for k in w.used}
    if mode == "preempt-resume":
        assert sched.preemptions >= 1 and sched.resumes == sched.preemptions
        assert "master" in kinds
    else:
        assert w.replays > 0                 # the second pass reuses keys
    if mode == "kv8-prefix-chunked":
        assert sched.registry.hits > 0 and sched.chunk_waves > 0
        assert kinds == {"paged", "master"}
    if mode == "kv16-prefix-chunked":
        assert sched.registry.hits > 0 and sched.chunk_waves > 0
        assert kinds == {"paged", "pool"}
    if mode == "kv8-contiguous":
        assert kinds == {"cold"}


@pytest.mark.parametrize("mode", list(MODES))
def test_eager_waves_equal_graphed_bitwise(runs, mode):
    """The eager waves (``graphs=False``) and the graphed ones give the
    same results, and after every wave the same pool (``k``, ``v``,
    ``token_idx``, scales, block table, SSM rows) and carries, bitwise."""
    r = runs(mode)
    eager, _, _, e_seen = r["eager"]
    graphed, _, _, g_seen = r["graphed"]
    assert eager.waves is None and graphed.waves is not None
    assert [k for k, _, _ in e_seen] == [k for k, _, _ in g_seen]
    assert len(g_seen) >= 3
    for i, ((_, t_e, s_e), (_, t_g, s_g)) in enumerate(zip(e_seen, g_seen)):
        assert torch.equal(t_e, t_g), i
        _same(s_e, s_g, i)
    for rid in eager.results:
        assert graphed.results[rid] == eager.results[rid]
    assert graphed.events == eager.events
    assert graphed.admission_log == eager.admission_log


# ---------------------------------------------------------------------------
# one wave
# ---------------------------------------------------------------------------

def _fill(caches: dict, tok, pos, gen) -> None:
    """Random bytes in every pool tensor and carry."""
    for c in caches.values():
        for f in dataclasses.fields(c):
            x = getattr(c, f.name)
            if isinstance(x, torch.Tensor):
                if x.dtype.is_floating_point:
                    x.copy_(torch.randn(x.shape, generator=gen))
                else:
                    x.copy_(torch.randint(-3, 40, x.shape, generator=gen))
    tok.copy_(torch.randint(0, 50, tok.shape, generator=gen))
    pos.copy_(torch.randint(0, 50, pos.shape, generator=gen))


def _state_of(caches: dict, tok, pos) -> dict:
    """The pool's tensors and the carries, by name (no copies)."""
    out = {"tok": tok, "pos": pos}
    for key, c in caches.items():
        for f in dataclasses.fields(c):
            x = getattr(c, f.name)
            if isinstance(x, torch.Tensor):
                out[f"{key}.{f.name}"] = x
    return out


@pytest.mark.parametrize("route", ["eager", "graphed"])
@pytest.mark.parametrize("kind", ["paged", "cold"])
def test_padded_wave_writes_only_its_rows_and_blocks(parts, kind, route):
    """A wave of a = 4 rows, 3 live (wave row 2 is padding, its ``dest``
    naming blocks in the pool), over a pool of random bytes: pool rows
    outside ``slots_idx`` keep their tables, scales, carries and
    (contiguous) rows; blocks outside the live rows' ``dest`` keep their
    bytes, the write sink apart; the live rows get their tables, token
    counts and first tokens. The graphed wave (its replay) writes what
    the eager one writes."""
    _, tcfg, _, tp, _, teng, _ = parts
    nb, bs, b = 20, 8, 5
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        slots=32, max_batch=b, block_size=bs, kv_bits=8, pool_blocks=nb,
        prefix_cache=False, paged_backend="kernel",
        paged_kv=kind == "paged"), device="cpu")
    rng = np.random.default_rng(5)
    plan = {"prompts": rng.integers(0, tcfg.vocab, (4, 8)).astype(np.int32),
            "plen": np.array([5, 8, 7, 3], np.int32),
            "sidx": np.array([3, 0, b, 4], np.int32)}
    dest = np.full((4, 4), nb, np.int32)
    dest[0, :2], dest[1, :2], dest[2, :2], dest[3, :1] = (4, 9), (2, 11), \
        (6, 7), (15,)
    if kind == "paged":
        plan["dest"] = dest
        caches = T.init_paged_caches(tcfg, b, 32, kv_bits=8, block_size=bs,
                                     pool_blocks=nb, device="cpu")
    else:
        caches = T.init_caches(tcfg, b, 32, kv_bits=8, device="cpu")
    tok = torch.zeros((b,), dtype=torch.int32)
    pos = torch.zeros((b,), dtype=torch.int32)
    _fill(caches, tok, pos, torch.Generator().manual_seed(3))
    state = _state_of(caches, tok, pos)
    before = {k: v.clone() for k, v in state.items()}
    tok0, _ = srv.wave(kind, 1, plan, tok, pos, caches)
    want = {k: v.clone() for k, v in state.items()}
    if route == "graphed":
        w = G.WaveGraphs(srv, capture=stand_in)
        for _ in range(2):                       # warm-up, then a replay
            for k, v in before.items():
                state[k].copy_(v)
            got, _ = w.run(kind, 1, plan, tok, pos, caches)
            assert torch.equal(got, tok0)
        assert w.replays == 1 and w.captured == [w.key(kind, 1, plan)]
    after = {k: v.clone() for k, v in state.items()}
    live_j = [0, 1, 3]
    live = plan["sidx"][live_j].tolist()
    other = [s for s in range(b) if s not in live]
    sink = slice(0, nb) if kind == "paged" else slice(None)
    for k in after:
        x, y = after[k], want[k]
        if k in ("kv.k", "kv.v", "kv.token_idx"):
            x, y = x[:, sink], y[:, sink]
        assert torch.equal(x.contiguous().view(torch.uint8),
                           y.contiguous().view(torch.uint8)), k
    if kind == "paged":
        written = set(dest[live_j].ravel().tolist()) - {nb}
        untouched = [i for i in range(nb) if i not in written]
        assert 6 not in written and 7 not in written
        for k in ("kv.k", "kv.v", "kv.token_idx"):
            assert torch.equal(after[k][:, untouched],
                               before[k][:, untouched]), k
        rows = ("kv.block_table", "kv.k_scale", "kv.v_scale")
        assert after["kv.block_table"][:, live].tolist() == \
            [dest[live_j].tolist()] * tcfg.n_layers
    else:
        rows = tuple(k for k in after if k.startswith("kv."))
    for k in rows:
        assert torch.equal(after[k][:, other], before[k][:, other]), k
        assert not torch.equal(after[k][:, live], before[k][:, live]), k
    for k in ("tok", "pos"):
        assert torch.equal(after[k][other], before[k][other])
    assert after["pos"][live].tolist() == plan["plen"][live_j].tolist()
    assert torch.equal(after["tok"][live], tok0[live_j])


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_device_lengths_equal_host_lengths(parts, kv_bits):
    """``prefill`` and ``prefill_extend`` given their lengths as tensors
    return bitwise what they return given numpy lengths."""
    _, tcfg, _, tp, _, teng, _ = parts
    rng = np.random.default_rng(8)
    bits = teng.table[2]
    tokens = torch.as_tensor(rng.integers(0, tcfg.vocab, (3, 8)), dtype=
                             torch.int32)
    plen = np.array([8, 3, 5], np.int32)
    outs = [T.prefill(tp, tcfg, bits, {"tokens": tokens, "prompt_len": x},
                      16, kv_bits=kv_bits, return_raw_kv=True)
            for x in (plen, torch.as_tensor(plen))]
    pre_len = np.array([8, 0, 5], np.int32)
    pk, pv = (outs[0][2][0].float(), outs[0][2][1].float())
    ext = [T.prefill_extend(
        tp, tcfg, bits, {"tokens": tokens, "prompt_len": sl}, 32,
        kv_bits=kv_bits, prefix_k=pk, prefix_v=pv, prefix_len=pl,
        return_raw_kv=True)
        for sl, pl in ((plen, pre_len),
                       (torch.as_tensor(plen), torch.as_tensor(pre_len)))]
    for a, b in (outs, ext):
        assert torch.equal(a[0], b[0])
        for x, y in zip(a[2], b[2]):
            assert torch.equal(x, y)
        _same(_state_of(a[1], tokens, tokens),
              _state_of(b[1], tokens, tokens), "cache")


# ---------------------------------------------------------------------------
# the bookkeeping
# ---------------------------------------------------------------------------

def _server(parts, **kw):
    _, tcfg, _, tp, _, teng, _ = parts
    return AdaptiveServer(tcfg, tp, teng, ServingConfig(**dict(
        dict(slots=64, max_batch=4, block_size=8, paged_backend="kernel"),
        **kw)), device="cpu")


def test_two_waves_of_one_key_keep_their_first_tokens(parts):
    """Two waves of one key before a flush: the second replays the first's
    graph, yet each parked first token stays its own (a tensor apart from
    the graph's output), and the flush reads the eager waves' tokens."""
    cfg = parts[1]
    got = {}
    for side, kw in (("eager", {"graphs": False}),
                     ("graphed", {"capture": stand_in})):
        sched = ContinuousScheduler(_server(parts), quantum=4, **kw)
        for n, seed in ((5, 1), (6, 2)):
            rng = np.random.default_rng(seed)
            sched.submit(Request(tokens=rng.integers(0, cfg.vocab, n)
                                 .astype(np.int32), max_new=4))
            assert sched.admit() == 1
        assert len(sched._inflight) == 2
        toks = [e["toks"] for e in sched._inflight]
        if side == "graphed":
            w = sched.waves
            (key,) = w.used
            assert w.captured == [key] and w.replays == 1
            out = w._graphs[key].tok0
            assert all(t.data_ptr() != out.data_ptr() for t in toks)
            assert toks[0].data_ptr() != toks[1].data_ptr()
        sched._flush()
        got[side] = [sched.results[rid]["tokens"] for rid in (0, 1)]
    assert got["graphed"] == got["eager"]


def test_captures_equal_keys_none_when_warm(parts):
    """Over two passes: the first captures one graph per distinct wave
    key; the second (the same lengths) captures none; a key whose graph
    is dropped is captured again, which ``assert_wave_executables``
    reports."""
    cfg = parts[1]
    sched = ContinuousScheduler(_server(parts, prefill_chunk=8),
                                quantum=4, capture=stand_in)
    shape = [(3, 5), (14, 4), (6, 6), (9, 3), (2, 4)]
    with SchedulerAudit(sched) as first:
        for r in _requests(cfg, Request, 21, shape, sys_len=8):
            sched.submit(r)
        sched.run()
    first.assert_wave_executables()
    w = sched.waves
    assert first.wave_captures() == len(w.used) == len(w.captured) >= 2
    caps = list(w.captured)
    with SchedulerAudit(sched) as warm:
        for r in _requests(cfg, Request, 22, shape, sys_len=8):
            sched.submit(r)
        sched.run()
    warm.assert_wave_executables()
    assert w.captured == caps and w.replays > 0 and w.lifetimes == 1
    w._graphs.pop(caps[0])                  # forget one key's graph
    with SchedulerAudit(sched) as again:
        for r in _requests(cfg, Request, 23, shape, sys_len=8):
            sched.submit(r)
        sched.run()
    assert w.captured.count(caps[0]) == 2
    with pytest.raises(AssertionError, match="captured again"):
        again.assert_wave_executables()


def test_rebinding_starts_a_new_wave_lifetime(parts):
    """Rebinding the server's images starts a new lifetime of the wave
    graphs too: its keys are captured again."""
    cfg = parts[1]
    srv = _server(parts)
    sched = ContinuousScheduler(srv, quantum=4, capture=stand_in)
    reqs = _requests(cfg, Request, 31, [(5, 4), (6, 3)])
    sched.submit(reqs[0])
    sched.run()
    w = sched.waves
    caps = list(w.captured)
    srv.prequant = list(srv.prequant)
    sched.submit(reqs[1])
    sched.run()
    assert w.lifetimes == 2 and w.captured == caps
    with pytest.raises(ValueError, match="CUDA"):
        G.WaveGraphs(srv)


# ---------------------------------------------------------------------------
# the hybrid stack's SSM rows
# ---------------------------------------------------------------------------

def test_hybrid_contiguous_wave_writes_ssm_rows_as_reference():
    """A hymba smoke wave into the contiguous pool (a = 4, 3 live rows),
    graphed: each live pool row's SSM state (``h``, ``conv``) and KV row
    equal the reference ``admit``'s; the other rows stay as they were."""
    cfg = get_smoke("hymba-1.5b")
    jp = jax.jit(JT.init_params, static_argnums=0)(cfg,
                                                    jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jeng, teng = _engines(cfg)
    scfg = dict(slots=32, max_batch=5, kv_bits=16, paged_kv=False)
    js = JServer(cfg, jp, jeng, JConfig(**scfg))
    srv = AdaptiveServer(C.get_smoke("hymba-1.5b"), tp, teng,
                         ServingConfig(paged_backend="kernel", **scfg),
                         device="cpu")
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    plen = np.array([16, 9, 4, 12], np.int32)
    sidx = np.array([4, 1, 5, 0], np.int32)
    jc = JT.init_caches(cfg, 5, 32, kv_bits=16)
    jtok0, jtok, jpos, jc = js._admit(
        3, {"tokens": jnp.asarray(prompts), "prompt_len": jnp.asarray(plen)},
        jnp.asarray(sidx), jnp.zeros((5,), jnp.int32),
        jnp.zeros((5,), jnp.int32), jc)
    caches = T.init_caches(srv.cfg, 5, 32, kv_bits=16, device="cpu")
    tok = torch.zeros((5,), dtype=torch.int32)
    pos = torch.zeros((5,), dtype=torch.int32)
    w = G.WaveGraphs(srv, capture=stand_in)
    plan = {"prompts": prompts, "plen": plen, "sidx": sidx}
    tok0, raw = w.run("cold", 3, plan, tok, pos, caches)
    assert raw is None and w.captured == [("cold", 3, 4, 16, 0)]
    live = [4, 1, 0]
    assert tok0.numpy()[[0, 1, 3]].tolist() == \
        np.asarray(jtok0)[[0, 1, 3]].tolist()
    assert tok.numpy().tolist() == np.asarray(jtok).tolist()
    assert pos.numpy().tolist() == np.asarray(jpos).tolist()
    for name in ("h", "conv"):
        got = getattr(caches["ssm"], name).numpy()
        want = np.asarray(getattr(jc["ssm"], name))
        np.testing.assert_allclose(got[:, live], want[:, live], atol=1e-5,
                                   rtol=0, err_msg=name)
        assert not got[:, [2, 3]].any()                  # untouched rows
        assert not want[:, [2, 3]].any()
    np.testing.assert_array_equal(caches["kv"].token_idx.numpy(),
                                  np.asarray(jc["kv"].token_idx))
    np.testing.assert_allclose(
        caches["kv"].k.float().numpy()[:, live],
        np.asarray(jc["kv"].k.astype(jnp.float32))[:, live], atol=2e-2,
        rtol=2e-2)
