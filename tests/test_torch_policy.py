"""Priority classes and preemption in the port against the JAX reference, on
the same weights (smoke granite-3-2b, f32, ``params_from_jax``), on both of
the port's backends (``kernel`` runs the kernels' plain versions here):

* the policy layer and the allocator (host objects, as copied): queue
  disciplines, the victim picker, ``make_policy``, aging and its
  ``queue_state`` round trip, double release, the retired-block LRU;
* the scheduler: a registry hit on a retired prompt's blocks until
  pressure reclaims them; a critical submission overtakes queued savers; a
  critical-class wave selects at the accuracy target in the saver regime;
* preemption (``_preempt_scenario``: two saver rows, the second a
  copy-on-write sharer of the first's prefix, then a critical arrival on a
  full pool) at kv16, kv8 and kv4: tokens, traces, billing events, admission
  order and counters equal the JAX scheduler's, the savers' tokens equal
  the port's run without the critical arrival, and ``preemptions ==
  resumes >= 1``; the resumed row's bytes, scales, ``token_idx`` and
  carry equal the suspended row's bit for bit; no round dispatches more
  than two prefill waves; the ledger replays through ``select``/
  ``account`` and bills Σ max_new; invalid configurations raise;
* ``amax_for_scale`` inverts the port's ``kv_scale`` at qmax 127 and 7;
* the launcher's ``--priority-classes``, ``--preemption`` and ``--aging``.
"""
import numpy as np
import pytest
import torch

from repro.core.manager import ProfileManager as JManager
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch.core.manager import ProfileManager, ProfileStats
from repro_torch.launch import serve as S
from repro_torch.models import transformer as T
from repro_torch.models.attention import kv_scale
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.paged import BlockAllocator
from repro_torch.serving.policy import (FifoPolicy, PriorityPolicy, RowState,
                                        default_classes,
                                        default_victim_picker, make_policy)
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_cuda import _row_bytes
from test_torch_prefix import parts, run_pair  # noqa: F401
from torch_threads import _one_thread  # noqa: F401


def _req(n=4, pr=0):
    return Request(tokens=np.zeros(n, np.int32), priority=pr)


# ---------------------------------------------------------------------------
# the policy layer and the allocator
# ---------------------------------------------------------------------------

def test_policy_queue_disciplines():
    """FIFO keeps submission order; the ladder serves lowest level first,
    FIFO within a class, with front re-insertion."""
    fifo = FifoPolicy()
    for rid in (3, 1, 2):
        fifo.enqueue(rid, _req())
    assert [fifo.pop_head() for _ in range(3)] == [3, 1, 2]
    pol = PriorityPolicy(default_classes(3))
    reqs = {0: _req(pr=2), 1: _req(pr=2), 2: _req(pr=0), 3: _req(pr=1)}
    for rid in (0, 1, 2, 3):
        pol.enqueue(rid, reqs[rid])
    assert pol.head() == 2 and len(pol) == 4
    assert pol.pop_head() == 2
    pol.push_front(1, reqs[1])
    order = []
    while len(pol):
        order.append(pol.pop_head())
    assert order == [3, 1, 0, 1]


def test_default_victim_picker_lowest_class_fewest_tokens():
    rows = [RowState(0, 10, level=2, generated=9, blocks=3, preemptible=True),
            RowState(1, 11, level=2, generated=2, blocks=3, preemptible=True),
            RowState(2, 12, level=1, generated=1, blocks=3, preemptible=True),
            RowState(3, 13, level=0, generated=0, blocks=9,
                     preemptible=False)]
    assert [r.slot for r in default_victim_picker(0, rows, 1, 0)] == [1]
    assert [r.slot for r in default_victim_picker(0, rows, 1, 5)] == [1, 0]
    assert default_victim_picker(2, rows, 1, 0) == []
    assert default_victim_picker(0, rows, 1, 100) == []


def test_make_policy_from_config():
    assert isinstance(make_policy(ServingConfig()), FifoPolicy)
    pol = make_policy(ServingConfig(priority_classes=3, preemption=True))
    assert isinstance(pol, PriorityPolicy) and pol.preemptive
    assert [c.name for c in pol.classes] == ["critical", "standard", "saver"]
    assert pol.classes[0].accuracy_critical
    assert not pol.classes[0].preemptible and pol.classes[0].can_preempt
    assert pol.aging is None
    assert make_policy(ServingConfig(priority_classes=2, aging=5)).aging == 5
    assert make_policy(ServingConfig(preemption=True)).preemptive


def test_aging_promotes_starved_saver_in_bounded_rounds():
    def rounds_until_served(aging, budget=40):
        pol = PriorityPolicy(default_classes(3), aging=aging)
        pol.enqueue(0, _req(pr=2))
        for rnd in range(1, budget + 1):
            pol.enqueue(100 + rnd, _req(pr=0))
            pol.age_tick()
            if pol.pop_head() == 0:
                return rnd
        return None

    assert rounds_until_served(None) is None
    served = rounds_until_served(3)
    assert served is not None and served <= 3 * 2 + 8
    pol = PriorityPolicy(default_classes(3))
    for rid, lvl in [(0, 2), (1, 0), (2, 1), (3, 2)]:
        pol.enqueue(rid, _req(pr=lvl))
    for _ in range(10):
        pol.age_tick()
    assert [pol.pop_head() for _ in range(4)] == [1, 2, 0, 3]


def test_aging_promotion_survives_queue_state_roundtrip():
    pol = PriorityPolicy(default_classes(3), aging=2)
    pol.enqueue(0, _req(pr=2))
    pol.enqueue(1, _req(pr=1))
    for _ in range(3):
        pol.age_tick()
    st = pol.queue_state()
    twin = PriorityPolicy(default_classes(3), aging=2)
    twin.restore_queue_state(st)
    assert twin.queue_state() == st
    twin.age_tick()
    assert twin.head() == 1
    assert [twin.pop_head(), twin.pop_head()] == [1, 0]


def test_double_release_raises_loudly():
    al = BlockAllocator(4, 8)
    ids = al.alloc(2)
    al.release(ids)
    with pytest.raises(RuntimeError, match="double release"):
        al.release([ids[0]])
    ids = al.alloc(1)
    with pytest.raises(RuntimeError, match="double release"):
        al.release([ids[0], ids[0]])
    with pytest.raises(RuntimeError):
        al.retain([ids[0]])


def test_lru_free_list_mechanics():
    al = BlockAllocator(4, 8)
    a = al.alloc(2)
    b = al.alloc(2)
    al.release(a, cache=set(a))
    assert al.lru_blocks == 2 and al.free_blocks == 0
    assert al.available_blocks == 2 and al.used_blocks == 2
    assert al.activate(a)
    assert al.lru_blocks == 0 and al.used_blocks == 4
    al.release(a, cache=set(a))
    reclaimed = []
    al.on_reclaim = reclaimed.append
    al.release(b)
    got = al.alloc(3)
    assert len(got) == 3 and reclaimed == [a[0]]
    assert al.lru_blocks == 1 and al.used_blocks == 3
    al.uncache([a[1]])
    assert al.lru_blocks == 0 and al.free_blocks == 1
    assert not al.activate([a[1]])
    assert al.free_blocks == 1


# ---------------------------------------------------------------------------
# the scheduler: LRU hits, admission order, class binding
# ---------------------------------------------------------------------------

def test_registry_hit_on_retired_blocks_until_pressure(parts):
    """A resubmitted prompt hits its retired owner's blocks in the LRU;
    pressure reclaims them, and the same prompt then admits cold."""
    cfg = parts[0]

    def scenario(sched, Req):
        rng = np.random.default_rng(21)
        sys_p = rng.integers(0, cfg.vocab, 16).astype(np.int32)
        r1, r2 = (Req(tokens=np.concatenate(
            [sys_p, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
            max_new=m) for n, m in ((5, 3), (3, 4)))
        sched.submit(r1)
        sched.run()
        st = sched.paged_stats()
        obs = {"after_r1": (st["live_blocks"], st["lru_cached_blocks"],
                            st["free_blocks"])}
        sched.submit(r2)
        sched.run()
        obs["hits_r2"] = sched.registry.hits
        sched.submit(Req(tokens=rng.integers(0, cfg.vocab, 40)
                         .astype(np.int32), max_new=16))
        sched.run()
        obs["pressure"] = (sched.registry.invalidated,
                           sched.allocator.reclaimed_blocks)
        sched.submit(Req(tokens=r2.tokens.copy(), max_new=4))
        sched.run()
        obs["hits_end"] = sched.registry.hits
        return obs

    out = run_pair(parts, dict(slots=64, max_batch=2, block_size=8,
                               pool_blocks=8), scenario)
    for sched in out.values():
        res = sched.results
        assert res[1]["tokens"] == res[3]["tokens"]    # hit = cold
        assert sched.registry.hits == 1
        assert sched.registry.invalidated > 0
        assert sched.allocator.reclaimed_blocks > 0


def test_priority_admission_order(parts):
    """A critical submission overtakes earlier saver submissions on a busy
    one-row pool (queue discipline alone, no preemption)."""
    cfg = parts[0]

    def scenario(sched, Req):
        rng = np.random.default_rng(5)

        def mk(pr, mn):
            return Req(tokens=rng.integers(0, cfg.vocab, 6).astype(np.int32),
                       max_new=mn, priority=pr)
        rids = [sched.submit(mk(1, 4))]
        sched.step()
        rids += [sched.submit(mk(1, 3)), sched.submit(mk(1, 3)),
                 sched.submit(mk(0, 3))]
        sched.run()
        return {"rids": rids}

    out = run_pair(parts, dict(slots=64, max_batch=1, priority_classes=2),
                   scenario, quantum=2)
    for sched in out.values():
        assert sched.admission_log == [0, 3, 1, 2]


def test_critical_class_binds_profile(parts):
    """In the saver regime a critical-class wave (no per-request flag)
    selects at the accuracy target; saver-class waves drop below it. The
    events equal the JAX scheduler's."""
    cfg, tcfg, jp, tp, jeng, teng, stats = parts

    def saver_manager(cls):
        m = cls(stats, accuracy_target=0.985, accuracy_floor=0.90,
                budget_j=1e9, low_energy=0.5)
        m._saver = True                   # pin the saver regime
        m.low_energy, m.hysteresis = 2.0, 0.0
        return m

    def scenario(sched, Req):
        rng = np.random.default_rng(9)
        for pr in (1, 0):
            sched.submit(Req(tokens=rng.integers(0, cfg.vocab, 6)
                             .astype(np.int32), max_new=2, priority=pr))
            sched.run()
        return list(sched.events)

    scfg = dict(slots=64, max_batch=2, priority_classes=2)
    jsched = JScheduler(JServer(cfg, jp, jeng, JConfig(**scfg),
                                manager=saver_manager(JManager)), quantum=2)
    want = scenario(jsched, JRequest)
    for backend in ("gather", "kernel"):
        srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
            paged_backend=backend, **scfg),
            manager=saver_manager(ProfileManager), device="cpu")
        sched = ContinuousScheduler(srv, quantum=2)
        got = scenario(sched, Request)
        assert got == want
        n_saver = 2                       # one admission wave + one step
        saver, crit = got[:n_saver], [e for e in got[n_saver:] if e[1] > 0]
        assert all(not c for _, _, c in saver)
        assert crit and all(c for _, _, c in crit)
        assert stats[crit[0][0]].accuracy >= 0.985
        assert stats[saver[0][0]].accuracy < 0.985


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def _preempt_requests(cfg, Req, crit=True):
    """Two saver requests sharing a 16-token prefix, and a critical one."""
    rng = np.random.default_rng(17)
    sys_p = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    reqs = [Req(tokens=np.concatenate(
        [sys_p, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
        max_new=m, priority=1) for n, m in ((4, 18), (7, 16))]
    c = Req(tokens=rng.integers(0, cfg.vocab, 7).astype(np.int32),
            max_new=4, priority=0)
    return reqs + ([c] if crit else [])


def _preempt_scenario(cfg, crit=True):
    """s1 cold (registers the prefix), s2 maps it copy-on-write, both
    decode, then the critical arrival finds the pool full."""
    def scenario(sched, Req):
        reqs = _preempt_requests(cfg, Req, crit)
        sched.submit(reqs[0])
        sched.step()
        sched.submit(reqs[1])
        sched.step()
        sched.step()
        if crit:
            sched.submit(reqs[2])
        while sched.step():
            pass
        return {"preemptions": sched.preemptions, "resumes": sched.resumes,
                "paged": {k: v for k, v in sched.paged_stats().items()
                          if k in ("preemptions", "resumes",
                                   "peak_used_blocks")}}
    return scenario


def _preempt_cfg(kv_bits, **kw):
    return dict(slots=64, max_batch=2, block_size=8, kv_bits=kv_bits,
                priority_classes=2, preemption=True, **kw)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_preempt_resume_token_identity(parts, kv_bits):
    """A preempted-then-resumed row, the copy-on-write sharer included,
    emits the tokens of the run without the critical arrival, and every
    observable equals the JAX scheduler's."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    out = run_pair(parts, _preempt_cfg(kv_bits), _preempt_scenario(cfg),
                   quantum=2)
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(**_preempt_cfg(
        kv_bits)), device="cpu")
    calm = ContinuousScheduler(srv, quantum=2)
    _preempt_scenario(cfg, crit=False)(calm, Request)
    assert calm.preemptions == 0
    for sched in out.values():
        assert sched.preemptions >= 1
        assert sched.resumes == sched.preemptions
        assert sched.registry.hits >= 1
        st = sched.paged_stats()
        assert st["preemptions"] == st["resumes"] == sched.preemptions
        for rid, req in enumerate(_preempt_requests(cfg, Request)):
            toks = sched.results[rid]["tokens"]
            assert len(toks) == req.max_new
            if rid < 2:
                assert toks == calm.results[rid]["tokens"], rid


@pytest.mark.parametrize("backend", ["gather", "kernel"])
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_restore_is_bitwise(parts, kv_bits, backend):
    """The resume wave rebuilds the suspended row exactly: its bytes at
    every written position (the shared span now private), its scales,
    ``token_idx``, ``tok`` and ``pos``."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        paged_backend=backend, **_preempt_cfg(kv_bits)), device="cpu")
    sched = ContinuousScheduler(srv, quantum=2)
    before, after = {}, {}
    snap_fn, resume_fn = sched._snapshot_row, sched._dispatch_resume

    def snapshot(slot):
        snap = snap_fn(slot)
        before[snap.rid] = (snap.n_done, _row_bytes(sched, slot, snap.n_done))
        return snap

    def resume(rows):
        n = resume_fn(rows)
        for rid, slot, _ in rows:
            after[rid] = _row_bytes(sched, slot, before[rid][0])
        return n

    sched._snapshot_row, sched._dispatch_resume = snapshot, resume
    _preempt_scenario(cfg)(sched, Request)
    assert before and before.keys() == after.keys()
    for rid, (_, was) in before.items():
        for key, x in was.items():
            y = after[rid][key]
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), (rid, key)


def test_at_most_two_prefill_waves_per_round(parts):
    """Counted by wrappers on the scheduler's wave methods (cold, shared,
    resume, chunk continuation), round by round, under preemption with
    chunked prompts in flight."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        prefill_chunk=8, **_preempt_cfg(16)), device="cpu")
    sched = ContinuousScheduler(srv, quantum=2)
    count = {"n": 0}
    for name in ("_dispatch_cold", "_dispatch_shared", "_dispatch_resume",
                 "_dispatch_chunks"):
        fn = getattr(sched, name)

        def wrapped(*a, _fn=fn, **kw):
            count["n"] += 1
            return _fn(*a, **kw)
        setattr(sched, name, wrapped)
    per_round = []
    step = sched.step

    def counted_step():
        count["n"] = 0
        more = step()
        per_round.append(count["n"])
        return more

    sched.step = counted_step
    _preempt_scenario(cfg)(sched, Request)
    assert sched.preemptions >= 1 and sched.resumes >= 1
    assert sched.chunk_waves >= 1
    assert max(per_round) <= 2 and sum(per_round) >= 4


def test_ledger_exact_under_preemption(parts):
    """The event log replays through a fresh manager's select/account to
    the same profiles and joules, and the bill is Σ max_new: suspension
    and resume bill nothing."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    stats = [ProfileStats(n, acc, e, 1e-3) for n, acc, e in [
        ("A16-W8", 0.99, 4.0), ("A16-W4", 0.953, 2.0), ("A8-W8", 0.988, 3.0),
        ("A8-W4", 0.953, 1.5), ("A4-W4", 0.958, 1.0), ("Mixed", 0.975, 2.0)]]

    def manager():
        return ProfileManager(stats, accuracy_target=0.985,
                              accuracy_floor=0.90, budget_j=150.0,
                              low_energy=0.5)

    mgr = manager()
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(**_preempt_cfg(16)),
                         manager=mgr, device="cpu")
    sched = ContinuousScheduler(srv, quantum=2)
    rng = np.random.default_rng(31)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=mn, priority=1) for n, mn in [(9, 14), (12, 12)]]
    for r in reqs:
        sched.submit(r)
    sched.step()
    sched.step()
    reqs.append(Request(tokens=rng.integers(0, cfg.vocab, 6)
                        .astype(np.int32), max_new=3, priority=0))
    sched.submit(reqs[-1])
    while sched.step():
        pass
    assert sched.preemptions >= 1
    oracle = manager()
    for pid, n_rows, critical in sched.events:
        assert oracle.select(accuracy_critical=critical) == pid
        oracle.account(pid, n_rows)
    assert abs(oracle.spent_j - mgr.spent_j) < 1e-9
    assert sum(n for _, n, _ in sched.events) == sum(r.max_new for r in reqs)


def test_preemption_config_validation(parts):
    _, tcfg, _, tp, _, teng, _ = parts
    with pytest.raises(ValueError, match="preemption"):
        AdaptiveServer(tcfg, tp, teng, ServingConfig(
            slots=64, max_batch=2, paged_kv=False, preemption=True),
            device="cpu")
    srv = AdaptiveServer(tcfg, tp, teng,
                         ServingConfig(slots=64, max_batch=2), device="cpu")
    with pytest.raises(ValueError, match="preemptive"):
        ContinuousScheduler(
            srv, policy=PriorityPolicy(default_classes(2), preemptive=True))
    # classes without preemption run on either pool
    for paged in (True, False):
        ContinuousScheduler(AdaptiveServer(tcfg, tp, teng, ServingConfig(
            slots=64, max_batch=2, paged_kv=paged, priority_classes=3,
            aging=2), device="cpu"))


@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_amax_for_scale_inverts_kv_scale(qmax):
    """Every scale ``kv_scale`` produces has a preimage the search finds
    (strict), and ``kv_scale`` of it is bit-equal to the scale. A scale
    the multiply steps over raises under ``strict`` and comes back within
    one ulp otherwise."""
    rng = np.random.default_rng(int(qmax))
    amax = (np.abs(rng.standard_normal(4096)) * rng.choice(
        [1e-3, 1.0, 40.0], 4096)).astype(np.float32).reshape(8, 512)
    s = kv_scale(torch.from_numpy(amax), qmax).numpy()
    pre = T.amax_for_scale(s, qmax)
    assert np.array_equal(kv_scale(torch.from_numpy(pre), qmax).numpy(), s)
    cand = np.nextafter(s.reshape(-1), np.float32(np.inf))
    img = kv_scale(torch.from_numpy(T.amax_for_scale(cand, qmax,
                                                     strict=False)),
                   qmax).numpy()
    missed = cand[img != cand]
    if qmax == 7.0:               # f32(1/7) < 1/8·2: the multiply skips
        assert missed.size
    if missed.size:
        with pytest.raises(ValueError, match="no amax preimage"):
            T.amax_for_scale(missed[:1], qmax)
        back = kv_scale(torch.from_numpy(
            T.amax_for_scale(missed[:1], qmax, strict=False)), qmax).numpy()
        assert abs(int(back.view(np.int32)[0])
                   - int(missed[:1].view(np.int32)[0])) <= 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_preemption_serves(capsys):
    S.main(["--device", "cpu", "--continuous", "--priority-classes", "2",
            "--preemption", "--aging", "4", "--requests", "6",
            "--max-new", "6", "--pool-blocks", "10", "--block-size", "8"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if "preemptions" in x)
    n = int(line.split("preemptions ")[1].split()[0])
    assert f"resumes {n}" in line
    assert out.count(": 6 tokens [completed]") == 6


def test_launcher_preemption_needs_continuous():
    with pytest.raises(SystemExit, match="--preemption needs --continuous"):
        S.parse_args(["--device", "cpu", "--preemption"])
    args = S.parse_args(["--device", "cpu", "--continuous",
                         "--priority-classes", "3", "--preemption",
                         "--aging", "2"])
    assert (args.priority_classes, args.preemption, args.aging) == (3, True,
                                                                    2)


def test_launcher_speculates_on_the_contiguous_pool(capsys):
    S.main(["--device", "cpu", "--continuous", "--no-paged-kv",
            "--speculate", "--draft-k", "2", "--kv-bits", "8",
            "--requests", "3", "--max-new", "5"])
    out = capsys.readouterr().out
    assert "contiguous pool" in out and "draft/verify windows" in out
    assert out.count(": 5 tokens [completed]") == 3
