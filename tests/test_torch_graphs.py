"""The decode segment's CUDA-graph route (``repro_torch/serving/graphs.py``)
on the CPU, where no graph is captured: a capture stand-in returns the step
itself as its replay, so the bookkeeping and the static-buffer step run
eagerly.

* ``transformer.segment_step`` over the fixed buffers of
  ``segment_buffers``, stepped once per profile id, gives bitwise the
  tokens, finite checks, carries and caches of ``decode_segment`` on the
  smoke configs: granite's paged pool (kernel backend) at kv16, kv8 and
  kv4, its contiguous pool at kv8 and kv16, native W8 weights, a fault
  step and a precision-policy row; mamba2, hymba and qwen2-moe;
* the scheduler on the stand-in against the JAX ``ContinuousScheduler``
  at kv16/kv8 paged and kv8 contiguous, managed (profile switches):
  tokens, traces, events, admission order and the ledger equal;
* the bookkeeping: one capture per distinct profile id in a pool lifetime
  over admissions, retirements, chunked prefill and a preemption and
  resume; none on a warm pool (``SchedulerAudit``'s
  ``assert_single_segment`` and ``assert_no_retrace``, which fail on a
  retrace); the kernels' counters read launches per capture × replays; a
  new lifetime after ``durability.recover`` and after the server's images
  are rebound;
* the CUDA route refuses a server on the CPU, a speculative scheduler's
  too (its window graphs are held in ``tests/test_torch_spec_graphs.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as C
from repro_torch.analysis.tracker import SchedulerAudit
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.manager import ProfileManager
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch.serve import profile_stats
from repro_torch.models import transformer as T
from repro_torch.models.native import to_native
from repro_torch.serving import durability as D
from repro_torch.serving import graphs as G
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_policy import _preempt_cfg, _preempt_scenario
from test_torch_prefix import parts, run_pair  # noqa: F401
from torch_threads import _one_thread  # noqa: F401


def stand_in(step, stream, pool):
    """A capture that records nothing: the step is its own replay."""
    return step


def _managed(cfg, params):
    """The launcher's manager on a small budget: the serve switches
    profiles."""
    stats = profile_stats(cfg, _engine(cfg).profiles, T.param_count(params))
    return ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                          budget_j=stats[0].energy_j * 30, low_energy=0.5)


def _engine(cfg):
    names = T.quant_layer_names(cfg)
    return TE.AdaptiveEngine(tuple(TP.paper_profiles(names, inner_layers=[])),
                             TE.QuantIndex(names))


@pytest.fixture(scope="module")
def servers():
    """``servers(arch, native=None, **scfg)``: a port server on the CPU
    (smoke config, seed-0 weights), cached."""
    cache = {}

    def get(arch="granite-3-2b", native=None, managed=False, **scfg):
        key = (arch, native, managed, tuple(sorted(scfg.items())))
        if key not in cache:
            cfg = C.get_smoke(arch)
            params = T.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
            if native is not None:
                params = to_native(params, native)
            cache[key] = AdaptiveServer(
                cfg, params, _engine(cfg),
                ServingConfig(**dict(dict(slots=64, max_batch=4,
                                          block_size=8,
                                          paged_backend="kernel"), **scfg)),
                device="cpu", manager=_managed(cfg, params) if managed
                else None)
        return cache[key]
    return get


def _clone(caches: dict) -> dict:
    return {k: dataclasses.replace(c, **{
        f.name: getattr(c, f.name).clone() for f in dataclasses.fields(c)
        if isinstance(getattr(c, f.name), torch.Tensor)})
        for k, c in caches.items()}


def _same_caches(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        for f in dataclasses.fields(a[k]):
            x, y = getattr(a[k], f.name), getattr(b[k], f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (k, f.name)


def _admitted(srv, rng_seed=5):
    """A pool with 4 rows admitted (prompts of 3–11 tokens) by an eager
    scheduler, and its carries."""
    sched = ContinuousScheduler(srv, quantum=4, graphs=False)
    rng = np.random.default_rng(rng_seed)
    for n in (5, 11, 3, 8):
        sched.submit(Request(tokens=rng.integers(0, srv.cfg.vocab, n)
                             .astype(np.int32), max_new=12))
    assert sched.admit() == 4
    return sched


STEP_CASES = [
    ("granite-3-2b", None, dict(kv_bits=16)),
    ("granite-3-2b", None, dict(kv_bits=8)),
    ("granite-3-2b", None, dict(kv_bits=4)),
    ("granite-3-2b", None, dict(kv_bits=8, paged_kv=False)),
    ("granite-3-2b", None, dict(kv_bits=16, paged_kv=False)),
    ("granite-3-2b", 8, dict(kv_bits=16)),
    ("granite-3-2b", None, dict(kv_bits=16, precision_policy=tuple(
        (16, 8) if p % 2 else (4, 16) for p in range(6)))),
    ("mamba2-130m", None, dict()),
    ("hymba-1.5b", None, dict(kv_bits=8)),
    ("qwen2-moe-a2.7b", None, dict(kv_bits=16)),
]


@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("arch,native,scfg", STEP_CASES,
                         ids=[f"{a}-{n}-{sorted(s.items())}"
                              for a, n, s in STEP_CASES])
def test_segment_step_is_decode_segment(servers, arch, native, scfg, fault):
    """The static-buffer step, stepped under a mixed schedule with rows
    that finish inside the segment (and one never live), gives bitwise
    ``decode_segment``'s tokens, finite checks, carries and caches."""
    srv = servers(arch, native, **scfg)
    sched = _admitted(srv)
    schedule = np.array([0, 2, 2, 5, 4], np.int32)
    remaining = np.array([3, 0, 5, 1], np.int64)
    fs = np.array([-1, -1, 2, -1], np.int32) if fault else None
    caches = _clone(sched._caches)
    want = T.decode_segment(
        srv.params, srv.cfg, srv.engine.table, schedule, sched._tok.clone(),
        sched._pos.clone(), _clone(sched._caches), remaining,
        prequant=srv.prequant, paged_backend="kernel",
        fault_step=None if fs is None else torch.as_tensor(fs),
        kv_table=srv.kv_table)
    buf = T.segment_buffers(4, len(schedule))
    buf["tok"].copy_(sched._tok)
    buf["pos"].copy_(sched._pos)
    buf["rem"].copy_(torch.as_tensor(remaining.astype(np.int32)))
    if fs is not None:
        buf["fs"].copy_(torch.as_tensor(fs))
    for pid in schedule:
        T.segment_step(srv.profile_params(pid), srv.cfg,
                       srv.engine.table[pid], buf, caches,
                       paged_backend="kernel", kv_sched=srv.kv_sched(pid))
    if "kv" in caches and isinstance(caches["kv"], T.PagedKVCache):
        finish = (buf["rem"] > 0) & (buf["rem"] <= len(schedule))
        caches["kv"].block_table.masked_fill_(finish[None, :, None],
                                              caches["kv"].n_blocks)
    ys, ok, tok, pos, wcaches = want
    assert torch.equal(buf["out"], ys)
    assert torch.equal(buf["ok"], ok)
    assert torch.equal(buf["tok"], tok) and torch.equal(buf["pos"], pos)
    assert int(buf["i"]) == len(schedule)
    assert bool(ok.all()) != fault
    _same_caches(caches, {k: wcaches[k] for k in caches})


def test_segment_step_refuses_the_gather_view(servers):
    srv = servers(kv_bits=16, paged_backend="gather")
    sched = _admitted(srv)
    buf = T.segment_buffers(4, 2)
    with pytest.raises(ValueError, match="kernel backend"):
        T.segment_step(srv.profile_params(0), srv.cfg, srv.engine.table[0],
                       buf, sched._caches, paged_backend="gather")


# ---------------------------------------------------------------------------
# the scheduler against the JAX reference
# ---------------------------------------------------------------------------

def _mixed_requests(cfg, Req):
    rng = np.random.default_rng(3)
    return [Req(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=m, accuracy_critical=(i % 3 == 0))
            for i, (n, m) in enumerate([(4, 9), (9, 2), (6, 5), (5, 12),
                                        (8, 3), (7, 7)])]


def _serve(sched, Req):
    for r in _mixed_requests(sched.srv.cfg, Req):
        sched.submit(r)
    sched.run()
    return {}


GRAPHED = {"gather": {}, "kernel": {"capture": stand_in}, "jax": {}}


@pytest.mark.parametrize("scfg", [
    dict(slots=64, max_batch=4, block_size=8),
    dict(slots=64, max_batch=4, block_size=8, kv_bits=8),
    dict(slots=64, max_batch=4, kv_bits=8, paged_kv=False)],
    ids=["kv16-paged", "kv8-paged", "kv8-contiguous"])
def test_graphed_scheduler_matches_reference(parts, scfg):
    """The kernel-backend scheduler on segment graphs (the stand-in
    capture) equals the JAX scheduler's tokens, traces, events, admission
    order and ledger under profile switches; the gather side runs eagerly
    beside it."""
    out = run_pair(parts, scfg, _serve, quantum=4, managed=True,
                   sched_kw=lambda side: dict(GRAPHED[side]))
    g = out["kernel"].graphs
    assert g is not None and out["gather"].graphs is None
    assert len(g.used) >= 2 and sorted(g.captured) == sorted(g.used)
    assert g.replays > 0


# ---------------------------------------------------------------------------
# the bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scfg", [
    dict(kv_bits=16, prefill_chunk=8),
    dict(kv_bits=8, paged_kv=False)], ids=["paged-chunked", "contiguous"])
def test_one_capture_per_profile_none_when_warm(servers, scfg):
    """Admissions, retirements and chunked prefill over a managed serve:
    one capture per distinct profile id; a second round on the warm pool
    captures no id again."""
    srv = servers(managed=True, **scfg)
    sched = ContinuousScheduler(srv, quantum=4, capture=stand_in)
    rng = np.random.default_rng(9)
    with SchedulerAudit(sched) as first:
        for n, m in ((4, 9), (21, 6), (6, 5), (5, 12), (30, 3)):
            sched.submit(Request(tokens=rng.integers(0, srv.cfg.vocab, n)
                                 .astype(np.int32), max_new=m))
        sched.run()
    first.assert_single_segment()
    if scfg.get("prefill_chunk"):
        assert sched.chunk_waves > 0 and sched.segments_chunking > 0
    g = sched.graphs
    assert len(g.used) >= 2 and g.lifetimes == 1
    assert g.capture_count() == len(g.used) <= len(srv.engine.table)
    with SchedulerAudit(sched) as warm:
        for n, m in ((7, 6), (3, 4)):
            sched.submit(Request(tokens=rng.integers(0, srv.cfg.vocab, n)
                                 .astype(np.int32), max_new=m))
        sched.run()
    warm.assert_single_segment()
    warm.assert_no_retrace()
    assert warm.captures() == len(g.used)


def test_preemption_and_resume_reuse_the_graphs(parts, servers):
    """A preemption and its resume wave rewrite the pool and the carries
    in place: the graphs serve on, one capture per profile id, and the
    tokens equal the eager scheduler's."""
    cfg = parts[0]
    runs = {}
    for kw in ({"graphs": False}, {"capture": stand_in}):
        srv = servers(**_preempt_cfg(16))
        sched = ContinuousScheduler(srv, quantum=2, **kw)
        with SchedulerAudit(sched) as audit:
            _preempt_scenario(cfg)(sched, Request)
        runs[bool(sched.graphs)] = (sched, audit)
    (eager, _), (graphed, audit) = runs[False], runs[True]
    assert graphed.preemptions >= 1 and graphed.resumes == graphed.preemptions
    for rid in eager.results:
        assert graphed.results[rid]["tokens"] == eager.results[rid]["tokens"]
    audit.assert_single_segment()
    assert graphed.graphs.captured == [0]


def test_a_retrace_fails_the_audit(servers):
    """Rebinding the server's images starts a new pool lifetime, which
    ``assert_no_retrace`` reports."""
    srv = servers(kv_bits=16)
    sched = ContinuousScheduler(srv, quantum=4, capture=stand_in)
    sched.submit(Request(tokens=np.arange(5, dtype=np.int32), max_new=6))
    sched.run()
    assert sched.graphs.captured == [0]
    images = srv.prequant
    try:
        with SchedulerAudit(sched) as audit:
            srv.prequant = list(images)
            sched.submit(Request(tokens=np.arange(6, dtype=np.int32),
                                 max_new=6))
            sched.run()
        assert sched.graphs.lifetimes == 2
        assert sched.graphs.captured == [0]
        with pytest.raises(AssertionError, match="lifetime"):
            audit.assert_no_retrace()
    finally:
        srv.prequant = images


def test_counters_read_launches_per_capture_times_replays(servers,
                                                          monkeypatch):
    """A capture calls each wrapper once and runs nothing: its counter
    increments are taken back and added again at every replay. The
    stand-in bumps K1's counter as a capture of an ``L``-layer step would;
    the plain versions count nothing on the CPU."""
    srv = servers(kv_bits=16)
    n_layers = srv.cfg.n_layers

    def capture(step, stream, pool):
        PA.paged_attention.launches += n_layers
        return step

    monkeypatch.setattr(PA.paged_attention, "launches", 0)
    sched = ContinuousScheduler(srv, quantum=4, capture=capture)
    for n in (4, 7, 5):
        sched.submit(Request(tokens=np.arange(n, dtype=np.int32),
                             max_new=9))
    sched.run()
    g = sched.graphs
    assert g.capture_count() == 1 and g.replays == sched.decode_steps - 1
    assert PA.paged_attention.launches == n_layers * g.replays


def test_recover_starts_a_new_lifetime(servers, tmp_path):
    """``durability.recover`` builds a new scheduler, hence a new pool
    lifetime with no graphs: it captures again, once per id, and finishes
    with the uninterrupted run's tokens."""
    srv = servers(kv_bits=16)
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
    assert s2.graphs is not s1.graphs and s2.graphs.captured == []
    while s2.step():
        pass
    assert s2.graphs.captured == [0] and s2.graphs.lifetimes == 1
    for rid in range(len(reqs)):
        assert s2.results[rid]["tokens"] == calm.results[rid]["tokens"]


def test_cuda_route_refuses_the_cpu(servers):
    """The graphed route needs a CUDA device: asked for on the CPU, the
    scheduler (and ``SegmentGraphs``) raise; by default it runs eagerly."""
    srv = servers(kv_bits=16)
    with pytest.raises(ValueError, match="CUDA"):
        ContinuousScheduler(srv, quantum=4, graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        G.SegmentGraphs(srv, 4, 4)
    assert ContinuousScheduler(srv, quantum=4).graphs is None


def test_speculation_defaults_to_eager_on_the_cpu(servers):
    """A speculative scheduler on the CPU runs the eager segment by
    default and refuses ``graphs=True`` (the CUDA capture); the stand-in
    capture gives it the window graphs."""
    srv = servers(kv_bits=16, speculate=True, draft_k=2)
    assert ContinuousScheduler(srv, quantum=4).graphs is None
    with pytest.raises(ValueError, match="CUDA"):
        ContinuousScheduler(srv, quantum=4, graphs=True)
    g = ContinuousScheduler(srv, quantum=4, capture=stand_in).graphs
    assert isinstance(g, G.SpecSegmentGraphs)
    assert g.buf["out"].shape == (4, 2, 3) and g.buf["hist"].shape == (4, 32)
