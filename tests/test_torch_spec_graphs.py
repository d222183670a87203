"""The speculative segment's and the static decode's CUDA-graph routes
(``repro_torch/serving/graphs.py``) on the CPU, where no graph is
captured: the capture stand-in of ``tests/test_torch_graphs.py`` returns
the step itself as its replay, so the bookkeeping and the static-buffer
steps run eagerly.

* ``transformer.segment_spec_step`` over the fixed buffers of
  ``segment_spec_buffers``, stepped once per window, gives bitwise the
  tokens, delivered counts, finite checks, carries, committed scales and
  caches of ``decode_segment_spec`` at kv16/kv8 paged (kernel backend) and
  kv8 contiguous, k 1 and 4, with a fault window, the ``repeat`` drafter,
  a row opted out and a quota cut; at kv4 both refuse the window (the
  packed cache has no scale ladder);
* the speculative scheduler on the stand-in against the JAX
  ``ContinuousScheduler`` at kv16/kv8 × k 1/4, paged and contiguous,
  managed: tokens, traces, events, ``spec_billed``, admission order and
  the ledger equal;
* the bookkeeping on a speculative server: one capture per profile id
  over two rounds, none on the warm pool (``SchedulerAudit``), a retrace
  reported after the drafter is rebound; a preemption and resume, and a
  ``durability.recover`` (a new lifetime), with the eager scheduler's
  tokens;
* the static path: ``AdaptiveServer.serve`` on the stand-in equals the
  JAX server's ``serve`` at kv8 and kv16, managed, with one capture per
  (profile id, group shape), none on a second serve over the kept cache
  (shorter groups after longer ones), and decodes longer than the buffers
  run in chunks; qwen2-moe's groups share one graph set per row bucket.
"""
import copy

import numpy as np
import pytest
import torch

from repro.core.manager import ProfileManager as JManager
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch.analysis.tracker import SchedulerAudit
from repro_torch.core.manager import ProfileManager
from repro_torch.models import transformer as T
from repro_torch.serving import durability as D
from repro_torch.serving import engine as E
from repro_torch.serving import graphs as G
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_graphs import _clone, _same_caches
from test_torch_graphs import servers, stand_in  # noqa: F401
from test_torch_prefix import parts  # noqa: F401
from torch_threads import _one_thread  # noqa: F401


def _admitted(srv, seed=5):
    """A pool with 4 rows admitted by an eager scheduler (prompts of 3–11
    tokens)."""
    sched = ContinuousScheduler(srv, quantum=4, graphs=False)
    rng = np.random.default_rng(seed)
    for n in (5, 11, 3, 8):
        sched.submit(Request(tokens=rng.integers(0, srv.cfg.vocab, n)
                             .astype(np.int32), max_new=20))
    assert sched.admit() == 4
    sched._flush(0)
    return sched


def _history(sched, hn=16, seed=2):
    """Each row's drafter history: a repeating run of tokens ending in the
    row's current token (so drafts get accepted), −1 padded on the left."""
    rng = np.random.default_rng(seed)
    tok = sched._tok.numpy()
    hist = np.full((4, hn), -1, np.int32)
    for r in range(4):
        period = rng.integers(1, 4)
        run = np.resize(np.append(rng.integers(0, 50, period - 1), tok[r]),
                        hn - 2 * r)
        hist[r, 2 * r:] = np.roll(run, -(len(run) % period))
        hist[r, -1] = tok[r]
    return hist


SPEC_STEP_CASES = [
    (dict(kv_bits=16), 1, None), (dict(kv_bits=16), 4, None),
    (dict(kv_bits=8), 1, None), (dict(kv_bits=8), 4, None),
    (dict(kv_bits=8, paged_kv=False), 1, None),
    (dict(kv_bits=8, paged_kv=False), 4, None),
    (dict(kv_bits=16), 4, "repeat"), (dict(kv_bits=8), 2, "repeat")]


@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("scfg,k,drafter", SPEC_STEP_CASES,
                         ids=[f"{sorted(s.items())}-k{k}-{d}"
                              for s, k, d in SPEC_STEP_CASES])
def test_segment_spec_step_is_decode_segment_spec(servers, scfg, k, drafter,
                                                  fault):
    """The static-buffer window, stepped under a mixed schedule, gives
    bitwise ``decode_segment_spec``'s tokens, delivered counts, finite
    checks, carries, committed scales and caches: rows that finish inside
    the segment, one never live, one opted out of speculation, one cut by
    its quota, and (``fault``) one poisoned at window 1."""
    srv = servers(**scfg)
    sched = _admitted(srv)
    schedule = np.array([0, 2, 5, 4], np.int32)
    remaining = np.array([7, 0, 12, 3], np.int32)
    quota = np.array([9, 9, 4, 9], np.int32)
    spec_on = np.array([True, True, True, False])
    fs = np.array([-1, -1, 1, -1], np.int32) if fault else None
    hist = _history(sched)
    draft_fn = (None if drafter is None else
                lambda h, t: t[:, None].expand(t.shape[0], k))
    want = T.decode_segment_spec(
        srv.params, srv.cfg, srv.engine.table, schedule, sched._tok.clone(),
        sched._pos.clone(), _clone(sched._caches), remaining, quota=quota,
        hist0=torch.as_tensor(hist), spec_on=torch.as_tensor(spec_on),
        prequant=srv.prequant, paged_backend="kernel", fault_step=fs,
        draft_k=k, draft_fn=draft_fn)
    caches = _clone(sched._caches)
    buf = T.segment_spec_buffers(4, len(schedule), k + 1, hist.shape[1])
    buf["tok"].copy_(sched._tok)
    buf["pos"].copy_(sched._pos)
    buf["hist"].copy_(torch.as_tensor(hist))
    for name, x in (("rem", remaining), ("rem0", remaining), ("qta", quota),
                    ("son", spec_on.astype(np.int32))):
        buf[name].copy_(torch.as_tensor(x))
    if fs is not None:
        buf["fs"].copy_(torch.as_tensor(fs))
    for pid in schedule:
        T.segment_spec_step(srv.profile_params(pid), srv.cfg,
                            srv.engine.table[pid], buf, caches,
                            paged_backend="kernel", draft_k=k,
                            draft_fn=draft_fn)
    kv = caches["kv"]
    if isinstance(kv, T.PagedKVCache):
        finish = (buf["rem0"] > 0) & (buf["rem"] <= 0)
        kv.block_table.masked_fill_(finish[None, :, None], kv.n_blocks)
    ys, delivered, ok, tok, pos, wcaches = want
    assert torch.equal(buf["out"], ys)
    assert torch.equal(buf["ms"], delivered)
    assert torch.equal(buf["ok"], ok) and bool(ok.all()) != fault
    assert torch.equal(buf["tok"], tok) and torch.equal(buf["pos"], pos)
    assert int(buf["i"]) == len(schedule)
    assert buf["ms"].sum(dim=1).tolist()[1:] == [0, 4, 3]   # quota, finish
    assert int(buf["ms"][3].max()) == 1                     # opted out
    _same_caches(caches, wcaches)


def test_spec_windows_accept_drafts(servers):
    """The history of :func:`_history` makes the n-gram drafter propose
    tokens the model accepts, so the cases above reach ``m > 1``."""
    srv = servers(kv_bits=16)
    sched = _admitted(srv)
    hist = _history(sched)
    _, delivered, *_ = T.decode_segment_spec(
        srv.params, srv.cfg, srv.engine.table, np.zeros(4, np.int32),
        sched._tok.clone(), sched._pos.clone(), _clone(sched._caches),
        np.full(4, 12, np.int32), hist0=torch.as_tensor(hist),
        prequant=srv.prequant, paged_backend="kernel", draft_k=4)
    assert int(delivered.max()) > 1


def test_kv4_refuses_the_window_on_both_paths(servers):
    srv = servers(kv_bits=4)
    sched = _admitted(srv)
    buf = T.segment_spec_buffers(4, 1, 3, 8)
    with pytest.raises(AssertionError, match="kv8/kv16"):
        T.segment_spec_step(srv.profile_params(0), srv.cfg,
                            srv.engine.table[0], buf, sched._caches,
                            paged_backend="kernel", draft_k=2)
    with pytest.raises(AssertionError, match="kv8/kv16"):
        T.decode_segment_spec(srv.params, srv.cfg, srv.engine.table, [0],
                              sched._tok, sched._pos, sched._caches,
                              np.full(4, 3), prequant=srv.prequant,
                              paged_backend="kernel", draft_k=2)


def test_segment_spec_step_refuses_the_gather_view(servers):
    srv = servers(kv_bits=16, paged_backend="gather")
    sched = _admitted(srv)
    buf = T.segment_spec_buffers(4, 1, 3, 8)
    with pytest.raises(ValueError, match="kernel backend"):
        T.segment_spec_step(srv.profile_params(0), srv.cfg,
                            srv.engine.table[0], buf, sched._caches,
                            paged_backend="gather", draft_k=2)


# ---------------------------------------------------------------------------
# the speculative scheduler against the JAX reference
# ---------------------------------------------------------------------------

def _spec_requests(cfg, Req, seed=3):
    rng = np.random.default_rng(seed)
    return [Req(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=m, accuracy_critical=(i % 3 == 0))
            for i, (n, m) in enumerate([(8, 12), (5, 9), (7, 1), (7, 17),
                                        (6, 5), (6, 12)])]


def _serve(sched, Req):
    for r in _spec_requests(sched.srv.cfg, Req):
        sched.submit(r)
    return sched.run()


def _manager(cls, stats):
    return cls(stats, accuracy_target=0.985, accuracy_floor=0.95,
               budget_j=stats[0].energy_j * 30, low_energy=0.5)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("kv_bits,k", [(16, 1), (16, 4), (8, 1), (8, 4)])
def test_graphed_spec_scheduler_matches_reference(parts, kv_bits, k, paged):
    """The kernel-backend speculative scheduler on window graphs (the
    stand-in capture) equals the JAX scheduler's tokens, traces, statuses,
    events, ``spec_billed``, admission order and ledger under the
    launcher's manager; billed tokens equal delivered ones, the pool
    drains, one capture per profile id."""
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    scfg = dict(slots=64, max_batch=4, kv_bits=kv_bits, speculate=True,
                draft_k=k, prefix_cache=False)
    scfg.update(dict(block_size=8) if paged else dict(paged_kv=False))
    jm, tm = _manager(JManager, stats), _manager(ProfileManager, stats)
    jsched = JScheduler(JServer(cfg, jp, jeng, JConfig(**scfg), manager=jm),
                        quantum=5)
    want = _serve(jsched, JRequest)
    sched = ContinuousScheduler(AdaptiveServer(
        tcfg, tp, teng, ServingConfig(paged_backend="kernel", **scfg),
        manager=tm, device="cpu"), quantum=5, capture=stand_in)
    got = _serve(sched, Request)
    for g, w in zip(got, want):
        for key in ("tokens", "profile_trace"):
            assert g[key] == w[key], key
        assert g["status"].value == w["status"].value == "completed"
    assert sched.events == jsched.events
    assert sched.spec_billed == jsched.spec_billed
    assert sched.admission_log == jsched.admission_log
    assert tm.spent_j == jm.spent_j
    assert len(sched.admission_log) + sum(n for _, n in sched.spec_billed) \
        == sum(len(r["tokens"]) for r in got)
    assert sched.paged == paged
    if paged:
        assert sched.allocator.used_blocks == 0
    g = sched.graphs
    assert isinstance(g, G.SpecSegmentGraphs) and g.lifetimes == 1
    assert sorted(g.captured) == sorted(g.used)
    assert g.replays == sched.windows_run - len(g.captured) > 0


# ---------------------------------------------------------------------------
# the bookkeeping on a speculative server
# ---------------------------------------------------------------------------

def _round(sched, rng, shapes):
    for n, m in shapes:
        sched.submit(Request(tokens=rng.integers(0, sched.srv.cfg.vocab, n)
                             .astype(np.int32), max_new=m))
    sched.run()


@pytest.mark.parametrize("scfg", [dict(kv_bits=8), dict(kv_bits=16,
                                                        paged_kv=False)],
                         ids=["kv8-paged", "kv16-contiguous"])
def test_one_capture_per_profile_none_when_warm(servers, scfg):
    """Two rounds on a managed speculative server: one window capture per
    distinct profile id, none on the warm pool."""
    srv = servers(managed=True, speculate=True, draft_k=3, **scfg)
    sched = ContinuousScheduler(srv, quantum=4, capture=stand_in)
    rng = np.random.default_rng(9)
    with SchedulerAudit(sched) as first:
        _round(sched, rng, ((4, 9), (21, 6), (6, 5), (5, 12), (30, 3)))
    first.assert_single_segment()
    g = sched.graphs
    assert len(g.used) >= 2 and g.lifetimes == 1
    assert g.capture_count() == len(g.used) <= len(srv.engine.table)
    with SchedulerAudit(sched) as warm:
        _round(sched, rng, ((7, 6), (3, 4)))
    warm.assert_single_segment()
    warm.assert_no_retrace()
    assert warm.captures() == len(g.used)


def test_rebinding_the_drafter_fails_the_audit(servers):
    """The drafter is baked into the window graphs: rebinding it starts a
    new pool lifetime, which ``assert_no_retrace`` reports."""
    srv = servers(kv_bits=16, speculate=True, draft_k=2)
    sched = ContinuousScheduler(srv, quantum=4, capture=stand_in)
    rng = np.random.default_rng(1)
    _round(sched, rng, ((5, 6),))
    assert sched.graphs.captured == [0]
    try:
        with SchedulerAudit(sched) as audit:
            srv.draft_fn = lambda h, t: t[:, None].expand(t.shape[0], 2)
            _round(sched, rng, ((6, 6),))
        assert sched.graphs.lifetimes == 2
        with pytest.raises(AssertionError, match="lifetime"):
            audit.assert_no_retrace()
    finally:
        srv.draft_fn = None


def test_preemption_and_resume_on_the_window_graphs(parts, servers):
    """A saver row evicted for a critical arrival resumes on the window
    graphs (its history replayed by the host): tokens, ``spec_billed`` and
    counters equal the eager scheduler's, one capture per profile id."""
    from test_torch_speculative import _spec_preempt_scenario
    cfg = parts[0]
    scfg = dict(kv_bits=16, max_batch=2, priority_classes=2, preemption=True,
                speculate=True, draft_k=2)
    runs = {}
    for kw in ({"graphs": False}, {"capture": stand_in}):
        sched = ContinuousScheduler(servers(**scfg), quantum=4, **kw)
        with SchedulerAudit(sched) as audit:
            seen = _spec_preempt_scenario(cfg)(sched, Request)
        runs[bool(sched.graphs)] = (sched, audit, seen)
    (eager, _, want), (graphed, audit, got) = runs[False], runs[True]
    assert got == want and got["preemptions"] >= 1
    assert got["resumes"] == got["preemptions"]
    for rid in eager.results:
        assert graphed.results[rid]["tokens"] == eager.results[rid]["tokens"]
    audit.assert_single_segment()
    assert graphed.graphs.captured == [0]


def test_recover_starts_a_new_lifetime(servers, tmp_path):
    """``durability.recover`` of a speculative server builds a new
    scheduler with new window graphs: it captures again and finishes with
    the uninterrupted run's tokens and billing."""
    srv = servers(kv_bits=16, speculate=True, draft_k=2)
    rng = np.random.default_rng(4)
    reqs = [Request(tokens=rng.integers(0, srv.cfg.vocab, n).astype(np.int32),
                    max_new=m) for n, m in ((5, 9), (9, 6), (4, 11))]
    calm = ContinuousScheduler(srv, quantum=4, capture=stand_in)
    for r in reqs:
        calm.submit(r)
    calm.run()
    s1 = ContinuousScheduler(srv, quantum=4, capture=stand_in)
    D.Durability(s1, str(tmp_path), checkpoint_every=1)
    for r in reqs:
        s1.submit(r)
    for _ in range(2):
        s1.step()
    assert s1.graphs.captured == [0]
    s2 = D.recover(srv, str(tmp_path), checkpoint_every=1, quantum=4,
                   capture=stand_in)
    assert isinstance(s2.graphs, G.SpecSegmentGraphs)
    assert s2.graphs is not s1.graphs and s2.graphs.captured == []
    while s2.step():
        pass
    assert s2.graphs.captured == [0] and s2.graphs.lifetimes == 1
    for rid in range(len(reqs)):
        assert s2.results[rid]["tokens"] == calm.results[rid]["tokens"]


# ---------------------------------------------------------------------------
# the static path
# ---------------------------------------------------------------------------

STATIC_REQS = [(4, 6), (9, 3), (17, 8), (6, 1), (12, 5), (7, 9), (10, 4),
               (5, 7), (14, 2)]


def _static_requests(cfg, Req):
    rng = np.random.default_rng(7)
    return [Req(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=m, accuracy_critical=(i % 3 == 0))
            for i, (n, m) in enumerate(STATIC_REQS)]


def _static_sets(srv) -> dict:
    return {key: (list(g.captured), sorted(g.used), g.lifetimes)
            for key, (g, _) in srv.static_graphs.items()}


@pytest.mark.parametrize("kv_bits", [8, 16])
def test_static_serve_on_graphs_matches_reference(parts, kv_bits):
    """The static ``serve`` on the stand-in (three groups of 4 rows, the
    last padded) equals the JAX server's tokens, traces and ledger under
    profile switches, with one capture per (profile id, group shape). A
    second serve from the same manager state replays the kept graphs over
    the kept cache (its first group, the shortest, follows the longest):
    the same tokens, no capture."""
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    scfg = dict(slots=64, max_batch=4, kv_bits=kv_bits, prefix_cache=False)
    jm = JManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                  budget_j=stats[0].energy_j * 12, low_energy=0.5)
    want = JServer(cfg, jp, jeng, JConfig(**scfg), manager=jm).serve(
        _static_requests(cfg, JRequest))
    tm = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                        budget_j=stats[0].energy_j * 12, low_energy=0.5)
    m0 = copy.deepcopy(tm)
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        paged_backend="kernel", **scfg), manager=tm, device="cpu")
    got = srv.serve(_static_requests(cfg, Request), capture=stand_in)
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"]
        assert g["profile_trace"] == w["profile_trace"]
    assert tm.spent_j == jm.spent_j
    used = {p for r in got for p in r["profile_trace"]}
    assert len(used) > 1
    sets = _static_sets(srv)
    assert list(sets) == [(4, 64, kv_bits)]
    (captured, pids, lifetimes), = sets.values()
    assert sorted(captured) == pids and lifetimes == 1
    assert len(captured) == len(pids) <= len(used)
    srv.manager = copy.deepcopy(m0)
    again = srv.serve(_static_requests(cfg, Request), capture=stand_in)
    assert [r["tokens"] for r in again] == [r["tokens"] for r in got]
    assert _static_sets(srv) == sets
    srv.manager = copy.deepcopy(m0)
    eager = srv.serve(_static_requests(cfg, Request), graphs=False)
    assert [r["tokens"] for r in eager] == [r["tokens"] for r in got]


def test_static_decode_runs_in_chunks(servers, monkeypatch):
    """A decode longer than the buffers runs in chunks of their width
    (``STATIC_STEPS`` cut to 3 here, 8 steps): ``generate``'s tokens and
    trace equal ``decode_many``'s, rows frozen at their budgets."""
    srv = servers(kv_bits=8, paged_kv=False)
    srv.static_graphs.clear()
    monkeypatch.setattr(E, "STATIC_STEPS", 3)
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, srv.cfg.vocab, (4, 7)).astype(np.int32)
    kw = dict(row_budget=np.array([9, 0, 4, 7]),
              prompt_len=np.array([7, 0, 5, 6]))
    want = srv.generate(prompts, 9, graphs=False, **kw)
    got = srv.generate(prompts, 9, capture=stand_in, **kw)
    assert got == want
    (g, _), = srv.static_graphs.values()
    assert g.buf["out"].shape == (4, 3) and g.replays == 8 - 1
    srv.static_graphs.clear()


def test_static_graphs_refuse_the_cpu(servers):
    srv = servers(kv_bits=16)
    prompts = np.ones((4, 5), np.int32)
    with pytest.raises(ValueError, match="CUDA"):
        srv.generate(prompts, 3, graphs=True)
    assert srv.generate(prompts, 3) == srv.generate(prompts, 3, graphs=False)


def test_moe_row_buckets_share_a_graph_set(servers):
    """qwen2-moe's static groups pad to power-of-two row buckets: groups of
    4, 4 and 1 requests on ``max_batch=4`` replay two graph sets (rows 4
    and 2), one capture each; tokens equal the eager serve's."""
    srv = servers("qwen2-moe-a2.7b", kv_bits=16, max_batch=4)
    srv.static_graphs.clear()
    reqs = _static_requests(srv.cfg, Request)
    eager = srv.serve(reqs, graphs=False)
    calls = []
    gen = srv.generate

    def record(prompts, *a, **k):
        calls.append(prompts.shape[0])
        return gen(prompts, *a, **k)

    srv.generate = record
    try:
        got = srv.serve(reqs, capture=stand_in)
    finally:
        del srv.generate
    assert calls == [4, 4, 2]
    assert [r["tokens"] for r in got] == [r["tokens"] for r in eager]
    sets = _static_sets(srv)
    assert sorted(sets) == [(2, 64, 16), (4, 64, 16)]
    assert all(c == [0] and life == 1 for c, _, life in sets.values())
    srv.static_graphs.clear()


def test_rebinding_the_images_starts_a_new_static_lifetime(servers):
    srv = servers(kv_bits=16)
    srv.static_graphs.clear()
    prompts = np.ones((4, 5), np.int32)
    srv.generate(prompts, 4, capture=stand_in)
    (g, _), = srv.static_graphs.values()
    images = srv.prequant
    try:
        srv.prequant = list(images)
        srv.generate(prompts, 4, capture=stand_in)
        assert g.lifetimes == 2 and g.captured == [0]
    finally:
        srv.prequant = images
        srv.static_graphs.clear()


def test_launcher_serve_passes_graphs_to_the_static_path(servers):
    """The launcher's ``serve(..., sched_kw=...)`` hands ``graphs``/
    ``capture`` to ``AdaptiveServer.serve`` on the static path."""
    from repro_torch.launch import serve as S
    srv = servers(kv_bits=16)
    srv.static_graphs.clear()
    reqs = _static_requests(srv.cfg, Request)[:3]
    out = S.serve(srv, reqs, 4, continuous=False,
                  sched_kw={"capture": stand_in})
    assert out["sched"] is None and len(srv.static_graphs) == 1
    eager = S.serve(srv, reqs, 4, continuous=False,
                    sched_kw={"graphs": False})
    assert eager["results"] == out["results"]
    srv.static_graphs.clear()


def test_faults_in_a_graphed_window_match_eager(servers):
    """Injected NaNs in the window graphs (the fault index is staged data)
    quarantine and retry the rows the eager segment does: statuses,
    retries, robustness counters, tokens and ``spec_billed`` equal."""
    from repro_torch.serving.faults import FaultSchedule
    srv = servers(kv_bits=8, speculate=True, draft_k=2)
    runs = []
    for kw in ({"graphs": False}, {"capture": stand_in}):
        sched = ContinuousScheduler(
            srv, quantum=4, faults=FaultSchedule(
                3, p_nan=0.3, max_nan=2, nan_at={1: (0,)}), **kw)
        _round(sched, np.random.default_rng(8),
               ((5, 9), (9, 6), (4, 11), (7, 5)))
        stats = sched.robustness_stats()
        stats.pop("recovery_latency_s")
        runs.append((sched, stats))
    (eager, want), (graphed, got) = runs
    assert got == want and got["faults_detected"] >= 1
    for rid in eager.results:
        for key in ("tokens", "status", "retries"):
            assert graphed.results[rid].get(key) == \
                eager.results[rid].get(key), (rid, key)
    assert graphed.spec_billed == eager.spec_billed
    assert graphed.graphs.captured and graphed.graphs.lifetimes == 1


@pytest.mark.parametrize("arch,scfg", [
    ("granite-3-2b", dict(kv_bits=8, precision_policy=tuple(
        (16, 8) if p % 2 else (4, 16) for p in range(6)))),
    ("hymba-1.5b", dict(kv_bits=8)), ("mamba2-130m", dict())],
    ids=["policy", "hymba", "mamba2"])
def test_static_graphs_on_other_stacks_equal_eager(servers, arch, scfg):
    """The static graphs under a precision policy and on the hybrid and
    SSM stacks (their kept caches hold the SSM state rows, hymba's the
    window ring) give the eager serve's tokens and traces, managed."""
    srv = servers(arch, managed=True, **scfg)
    srv.static_graphs.clear()
    m0 = copy.deepcopy(srv.manager)
    reqs = _static_requests(srv.cfg, Request)
    eager = srv.serve(reqs, graphs=False)
    srv.manager = copy.deepcopy(m0)
    got = srv.serve(reqs, capture=stand_in)
    assert got == eager
    (g, kept), = srv.static_graphs.values()
    assert sorted(g.captured) == sorted(g.used) and g.replays > 0
    assert ("ssm" in kept) == (arch != "granite-3-2b")
    srv.manager = m0
    srv.static_graphs.clear()
