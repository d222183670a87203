"""Fault-tolerant serving in the port against the JAX reference, on the same
weights (smoke granite-3-2b, ``params_from_jax``): every case of
``tests/test_robustness.py`` as a parity test, and the cases it leaves out.

* ``FaultSchedule`` draws bitwise the reference's decisions (the same
  ``np.random.default_rng([seed, kind, key])``), fires a targeted
  ``(rid, attempt)`` once and caps random NaNs; ``Watchdog``,
  ``ShedPolicy`` and the queue surgery behave as the reference's;
* the scheduler, at kv16 and kv8, on both of the port's backends (the
  kernel backend takes its plain version on the CPU), through
  ``test_torch_prefix.run_pair``: shedding at submit (a critical arrival
  displaces the saver tail), deadline-aware admission, cancel and expiry
  mid-segment (the ledger replays exactly, billed == delivered), NaN
  quarantine with an escalated retry (its tokens equal a clean
  ``accuracy_critical=True`` run's), a persistent fault ending ``FAILED``
  after ``retry_budget + 1`` attempts, an allocator drought and a flush
  stall the watchdog flags. Statuses, reasons, retries, tokens, traces,
  events, admission order and ``robustness_stats()`` equal the JAX
  scheduler's; ``paranoid`` audits the pool after every step and it
  drains to 0 used blocks;
* beyond the reference's file: cancelling a suspended (preempted) request
  and a mid-chunk row, a NaN inside a speculative window, quarantine on
  the contiguous pool (K4's plain version at kv8), a retry that does not
  look the prefix registry up, and a retry under a precision policy (it
  runs the critical profile's row: profile 0's all-16 row without a
  manager); the launcher's ``--inject-faults``, ``--paranoid``,
  ``--deadline-ms``, ``--shed`` and ``--retry-budget``.

Every scheduler gets a virtual clock (``time.sleep`` advances it), so the
watchdog and the deadlines decide the same on both packages.
"""
import time

import numpy as np
import pytest

from repro.serving import faults as JF
from repro.serving import policy as JP
from repro_torch.core.manager import ProfileManager
from repro_torch.serving import faults as F
from repro_torch.serving import policy as P
from repro_torch.serving.engine import (AdaptiveServer, Request,
                                        RequestStatus, ServingConfig)
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_prefix import _manager, parts, run_pair  # noqa: F401
from torch_threads import _one_thread  # noqa: F401


class VClock:
    """Virtual time: the schedulers read it, ``time.sleep`` advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def vclock(monkeypatch):
    clock = VClock()
    monkeypatch.setattr(time, "sleep",
                        lambda s: setattr(clock, "t", clock.t + s))
    return clock


def _kw(vclock, faults=None, shed=None, **kw):
    """``run_pair``'s per-side factory: a fresh virtual clock and each
    package's own ``FaultSchedule``/``ShedPolicy`` built from the same
    arguments."""
    def make(side):
        vclock.t = 0.0
        fm, pm = (JF, JP) if side == "jax" else (F, P)
        out = dict(clock=vclock, **kw)
        if faults is not None:
            out["faults"] = fm.FaultSchedule(**faults)
        if shed is not None:
            out["shed"] = pm.ShedPolicy(**shed)
        return out
    return make


def _cfg(kv_bits, **kw):
    return {"slots": 64, "max_batch": 2, "block_size": 8, "kv_bits": kv_bits,
            **kw}


def _rand(cfg, rng, n, **kw):
    def make(Req):
        return Req(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                   **kw)
    return make


def _clean_tokens(parts, scfg, req, managed=True):
    """Tokens of ``req`` served alone with ``accuracy_critical=True`` on a
    fresh port server (the recovery reference)."""
    _, tcfg, _, tp, _, teng, stats = parts
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(**scfg),
                         manager=(_manager(ProfileManager, stats)
                                  if managed else None), device="cpu")
    sched = ContinuousScheduler(srv, quantum=4)
    rid = sched.submit(Request(tokens=req.tokens, max_new=req.max_new,
                               accuracy_critical=True))
    return sched.run()[rid]["tokens"]


def _drained(sched):
    sched.check()
    if sched.paged:
        assert sched.allocator.used_blocks == 0


# ---------------------------------------------------------------------------
# the host layer
# ---------------------------------------------------------------------------

def test_fault_schedule_draws_bitwise_the_reference():
    for seed in (0, 7, 12345):
        for kind in (1, 2, 3):
            for key in (0, 1, 131, 2**20 + 3):
                assert F._draw(seed, kind, key) == JF._draw(seed, kind, key)
    rates = dict(seed=7, p_nan=0.4, p_alloc=0.3, p_stall=0.3)
    a, b = F.FaultSchedule(**rates), JF.FaultSchedule(**rates)
    keys = [(r, at) for r in range(12) for at in range(3)]
    assert [a.want_nan(*k) for k in keys] == [b.want_nan(*k) for k in keys]
    assert [a.alloc_dry(i) for i in range(40)] == \
        [b.alloc_dry(i) for i in range(40)]
    assert [a.flush_stall(i) for i in range(40)] == \
        [b.flush_stall(i) for i in range(40)]
    assert (a.injected_nan, a.injected_alloc, a.injected_stall) == \
        (b.injected_nan, b.injected_alloc, b.injected_stall)
    # the reference's properties on the port's classes
    c = F.FaultSchedule(seed=7, p_nan=0.4)
    rev = {k: c.want_nan(*k) for k in reversed(keys)}
    fwd = {k: F.FaultSchedule(seed=7, p_nan=0.4).want_nan(*k) for k in keys}
    assert fwd == rev and any(fwd.values()) and not all(fwd.values())
    tgt = F.FaultSchedule(nan_at={3: (1,)})
    assert not tgt.want_nan(3, 0)
    assert tgt.want_nan(3, 1) and not tgt.want_nan(3, 1)   # once, ever
    assert tgt.injected_nan == 1
    capped = F.FaultSchedule(seed=0, p_nan=1.0, max_nan=2)
    assert sum(capped.want_nan(r, 0) for r in range(10)) == 2
    st = F.FaultSchedule(stall_at=(2,), stall_s=0.5)
    assert st.flush_stall(0) == 0.0 and st.flush_stall(2) == 0.5
    wd = F.Watchdog(limit_s=0.1)
    assert not wd.record("fast", 0.05) and wd.record("slow", 0.2)
    assert wd.stalls == 1 and wd.flagged == [("slow", 0.2)]


@pytest.mark.parametrize("lib", [P, JP], ids=["port", "reference"])
def test_shed_policy_and_queue_surgery(lib):
    """ShedPolicy thresholds and remove/rids/shed_tail on both queue
    disciplines, run on both packages' policy modules."""
    sp = lib.ShedPolicy(max_queue=3)
    assert not sp.triggered(3, 0) and sp.triggered(4, 0)
    assert lib.ShedPolicy(max_predicted_miss=0).triggered(0, 1)
    assert not lib.ShedPolicy().triggered(10**6, 10**6)
    fifo = lib.FifoPolicy()
    for rid in (5, 6, 7):
        fifo.enqueue(rid, Request(tokens=np.zeros(2, np.int32), max_new=1))
    assert fifo.rids() == [5, 6, 7] and fifo.shed_tail() == (7, 0)
    assert fifo.remove(6) and not fifo.remove(6)
    assert fifo.rids() == [5, 7]
    pol = lib.PriorityPolicy(lib.default_classes(2))
    crit = Request(tokens=np.zeros(2, np.int32), max_new=1, priority=0)
    savr = Request(tokens=np.zeros(2, np.int32), max_new=1, priority=1)
    pol.enqueue(1, savr)
    pol.enqueue(2, crit)
    pol.enqueue(3, savr)
    assert pol.rids() == [2, 1, 3]
    assert pol.shed_tail() == (3, 1)
    assert pol.remove(1) and pol.rids() == [2, 3]
    pol.remove(3)
    assert pol.shed_tail() == (2, 0)


# ---------------------------------------------------------------------------
# the scheduler: the reference's cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [16, 8])
def test_shed_at_submit_protects_critical(parts, vclock, kv_bits):
    """A saver flood sheds the arrival once the queue cap trips; a critical
    arrival displaces the queued saver tail; cancel and its refusals."""
    cfg = parts[0]

    def scenario(sched, Req):
        rng = np.random.default_rng(3)
        mk = [_rand(cfg, rng, 6, max_new=4, priority=pr)(Req)
              for pr in (1, 1, 1, 0)]
        s0, s1, s2 = (sched.submit(r) for r in mk[:3])
        c0 = sched.submit(mk[3])
        obs = {"s2": sched.results[s2]["status"].value,
               "s1": sched.results[s1]["status"].value,
               "c0_queued": c0 not in sched.results,
               "rids": sched.policy.rids(),
               "cancel": [sched.cancel(s0), sched.cancel(s2),
                          sched.cancel(9999)],
               "counts": (sched.shed_count, sched.cancelled),
               "polled": sorted(r["status"].value
                                for _, r in sched.poll_completed())}
        while sched.step():
            pass
        return obs

    out = run_pair(parts, _cfg(kv_bits, priority_classes=2), scenario,
                   sched_kw=_kw(vclock, shed=dict(max_queue=2)))
    sched = out["kernel"]
    assert sched.shed_count == 2 and sched.cancelled == 1
    assert sched.results == {3: sched.results[3]}     # the rest were polled
    assert sched.results[3]["status"] is RequestStatus.COMPLETED


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_deadline_aware_admission_rejects_doomed(parts, vclock, kv_bits):
    """A request the step-time EMA rules unreachable finalizes EXPIRED at
    admission and never takes a slot."""
    cfg = parts[0]

    def scenario(sched, Req):
        sched._seg_dt = 5.0               # calibrated: 5 s per segment
        rng = np.random.default_rng(4)
        rid = sched.submit(_rand(cfg, rng, 6, max_new=8,
                                 deadline_ms=1000.0)(Req))
        sched.step()
        res = sched.results[rid]
        return {"status": res["status"].value, "reason": res["reason"],
                "admitted": rid in sched.admission_log,
                "expired": sched.expired}

    out = run_pair(parts, _cfg(kv_bits), scenario, quantum=2,
                   sched_kw=_kw(vclock))
    res = out["kernel"].results[0]
    assert res["status"] is RequestStatus.EXPIRED and res["tokens"] == []
    assert "unreachable" in res["reason"]


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_cancel_expiry_mid_segment_oracle_exact(parts, vclock, kv_bits):
    """Cancel a live copy-on-write sharer mid-generation, expire another
    through the clock, cancel a queued one: the survivors complete, the
    event log replays the ledger exactly and billed == delivered."""
    cfg, stats = parts[0], parts[-1]

    def scenario(sched, Req):
        rng = np.random.default_rng(11)
        base = rng.integers(0, cfg.vocab, 16).astype(np.int32)
        tail = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                for n in (9, 3, 5, 7)]
        reqs = [Req(tokens=tail[0], max_new=10),
                Req(tokens=np.concatenate([base, tail[1]]), max_new=12),
                Req(tokens=np.concatenate([base, tail[2]]), max_new=12),
                Req(tokens=tail[3], max_new=40, deadline_ms=5000.0)]
        rids = [sched.submit(r) for r in reqs]
        queued = sched.submit(_rand(cfg, rng, 6, max_new=6)(Req))
        took = [sched.cancel(queued)]
        sched.step()
        sched.step()
        took += [sched.cancel(rids[2]), sched.cancel(rids[2])]
        sched.clock.t = 10.0
        while sched.step():
            pass
        return {"took": took, "hits": sched.registry.hits}

    out = run_pair(parts, _cfg(kv_bits, max_batch=4), scenario, quantum=2,
                   managed=True, sched_kw=_kw(vclock, paranoid=True))
    for sched in out.values():
        res = sched.results
        assert [res[i]["status"] for i in range(5)] == [
            RequestStatus.COMPLETED, RequestStatus.COMPLETED,
            RequestStatus.CANCELLED, RequestStatus.EXPIRED,
            RequestStatus.CANCELLED]
        assert len(res[0]["tokens"]) == 10 and len(res[1]["tokens"]) == 12
        assert 0 < len(res[2]["tokens"]) < 12
        assert 0 < len(res[3]["tokens"]) < 40 and res[4]["tokens"] == []
        oracle = _manager(ProfileManager, stats)
        for pid, n_rows, critical in sched.events:
            assert oracle.select(accuracy_critical=critical) == pid
            oracle.account(pid, n_rows)
        assert abs(oracle.spent_j - sched.srv.manager.spent_j) < 1e-9
        assert sum(n for _, n, _ in sched.events) == \
            sum(len(r["tokens"]) for r in res.values())
        _drained(sched)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_quarantine_escalates_and_recovers_token_identical(parts, vclock,
                                                           kv_bits):
    """A NaN-poisoned row is quarantined, escalated, retried from the
    prompt and completes with a clean accuracy-critical run's tokens."""
    cfg = parts[0]
    req = _rand(cfg, np.random.default_rng(21), 11, max_new=8)(Request)

    def scenario(sched, Req):
        rid = sched.submit(Req(tokens=req.tokens, max_new=8))
        sched.run()
        return {"injected": sched.faults.injected_nan,
                "latencies": len(sched.recovery_latency), "rid": rid}

    scfg = _cfg(kv_bits)
    out = run_pair(parts, scfg, scenario, managed=True,
                   sched_kw=_kw(vclock, faults=dict(nan_at={0: (0,)}),
                                retry_budget=2, paranoid=True))
    clean = _clean_tokens(parts, scfg, req)
    for sched in out.values():
        res = sched.results[0]
        assert res["status"] is RequestStatus.COMPLETED
        assert res["retries"] == 1 and res["tokens"] == clean
        assert sched.faults_detected == 1 == sched.recovered
        crit = {s.name for s in sched.srv.manager.profiles
                if s.accuracy >= 0.985}
        assert set(res["profile_trace"]) <= crit
        _drained(sched)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_persistent_fault_bounded_failure(parts, vclock, kv_bits):
    """A row that faults on every attempt ends FAILED after
    ``retry_budget + 1`` attempts with no tokens; its neighbour rides
    through."""
    cfg = parts[0]

    def scenario(sched, Req):
        rng = np.random.default_rng(22)
        for _ in range(2):
            sched.submit(_rand(cfg, rng, 9, max_new=6)(Req))
        sched.run()
        return {}

    out = run_pair(parts, _cfg(kv_bits), scenario, managed=True,
                   sched_kw=_kw(vclock, faults=dict(nan_at={0: (0, 1, 2)}),
                                retry_budget=2, paranoid=True))
    for sched in out.values():
        bad, ok = sched.results[0], sched.results[1]
        assert bad["status"] is RequestStatus.FAILED
        assert bad["reason"] == "retry budget exhausted"
        assert bad["tokens"] == [] and bad["retries"] == 3
        assert ok["status"] is RequestStatus.COMPLETED
        assert len(ok["tokens"]) == 6
        assert sched.failed == 1 and sched.recovered == 0
        _drained(sched)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_alloc_drought_stall_and_watchdog(parts, vclock, kv_bits):
    """An injected drought is one round of backpressure, an injected flush
    stall trips the watchdog, and robustness_stats reports both."""
    cfg = parts[0]

    def scenario(sched, Req):
        rng = np.random.default_rng(23)
        for _ in range(2):
            sched.submit(_rand(cfg, rng, 8, max_new=5)(Req))
        sched.run()
        return {"flagged": [lab for lab, _ in sched.watchdog.flagged]}

    out = run_pair(parts, _cfg(kv_bits), scenario, quantum=2, managed=True,
                   sched_kw=_kw(vclock, faults=dict(alloc_at=(1,),
                                                    stall_at=(0,),
                                                    stall_s=0.05),
                                watchdog_s=0.02, paranoid=True))
    for sched in out.values():
        assert all(r["status"] is RequestStatus.COMPLETED
                   and len(r["tokens"]) == 5 for r in sched.results.values())
        st = sched.robustness_stats()
        assert st["alloc_injected_rounds"] == 1 == st["injected_stall"]
        assert st["watchdog_stalls"] == 1
        assert st["cancelled"] == st["failed"] == 0
        _drained(sched)


# ---------------------------------------------------------------------------
# the scheduler: cases beyond the reference's file
# ---------------------------------------------------------------------------

def test_cancel_suspended_request(parts, vclock):
    """A saver preempted for a critical arrival is cancelled while it
    waits to resume: it drops with the tokens it had, its snapshot goes,
    and nothing resumes."""
    from test_torch_policy import _preempt_cfg, _preempt_requests

    def scenario(sched, Req):
        reqs = _preempt_requests(parts[0], Req)
        sched.submit(reqs[0])
        sched.step()
        sched.submit(reqs[1])
        sched.step()
        sched.step()
        sched.submit(reqs[2])
        while not sched._suspended:
            sched.step()
        victim = next(iter(sched._suspended))
        took = sched.cancel(victim)
        while sched.step():
            pass
        return {"victim": victim, "took": took,
                "preemptions": sched.preemptions, "resumes": sched.resumes}

    out = run_pair(parts, _preempt_cfg(16), scenario, quantum=2,
                   sched_kw=_kw(vclock, paranoid=True))
    for sched in out.values():
        v = next(rid for rid, r in sched.results.items()
                 if r["status"] is RequestStatus.CANCELLED)
        assert sched.preemptions == 1 and sched.resumes == 0
        assert 0 < len(sched.results[v]["tokens"]) < 18
        assert not sched._suspended
        _drained(sched)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_cancel_mid_chunk_row(parts, vclock, kv_bits):
    """A row still chunking its prompt in is cancelled: its blocks and
    table go at the next boundary, with no token delivered."""
    cfg = parts[0]

    def scenario(sched, Req):
        rng = np.random.default_rng(41)
        long = sched.submit(_rand(cfg, rng, 40, max_new=5)(Req))
        short = sched.submit(_rand(cfg, rng, 6, max_new=6)(Req))
        sched.step()
        chunking = [st["rid"] for st in sched._chunk_state.values()]
        took = sched.cancel(long)
        while sched.step():
            pass
        return {"chunking": chunking, "took": took, "ids": [long, short]}

    out = run_pair(parts, _cfg(kv_bits, prefill_chunk=16), scenario,
                   quantum=2, sched_kw=_kw(vclock, paranoid=True))
    for sched in out.values():
        assert sched.results[0]["status"] is RequestStatus.CANCELLED
        assert sched.results[0]["tokens"] == []
        assert sched.results[1]["status"] is RequestStatus.COMPLETED
        assert not sched._chunk_state
        _drained(sched)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_nan_in_speculative_window(parts, vclock, kv_bits):
    """A NaN in a verify window quarantines the row; the retry delivers a
    clean accuracy-critical run's tokens and the ledger bills what was
    delivered, the discarded attempt included."""
    cfg = parts[0]
    req = _rand(cfg, np.random.default_rng(29), 10, max_new=9)(Request)

    def scenario(sched, Req):
        sched.submit(Req(tokens=req.tokens, max_new=9))
        sched.submit(_rand(cfg, np.random.default_rng(30), 7,
                           max_new=7)(Req))
        sched.run()
        return {"windows": len(sched.spec_billed)}

    scfg = _cfg(kv_bits, speculate=True, draft_k=2)
    out = run_pair(parts, scfg, scenario, quantum=4, managed=True,
                   sched_kw=_kw(vclock, faults=dict(nan_at={0: (0,)}),
                                paranoid=True))
    clean = _clean_tokens(parts, scfg, req)
    for sched in out.values():
        res = sched.results[0]
        assert res["status"] is RequestStatus.COMPLETED
        assert res["retries"] == 1 and res["tokens"] == clean
        assert sched.results[1]["status"] is RequestStatus.COMPLETED
        _drained(sched)


def test_quarantine_on_the_contiguous_pool(parts, vclock):
    """Quarantine on ``paged_kv=False`` at kv8 (K4's plain version on the
    kernel backend): no blocks to release, the same recovery, the same
    tokens as the JAX scheduler's."""
    cfg = parts[0]
    req = _rand(cfg, np.random.default_rng(31), 12, max_new=8)(Request)

    def scenario(sched, Req):
        sched.submit(Req(tokens=req.tokens, max_new=8))
        rng = np.random.default_rng(32)
        for _ in range(2):
            sched.submit(_rand(cfg, rng, 9, max_new=6)(Req))
        sched.run()
        return {}

    scfg = _cfg(8, paged_kv=False)
    out = run_pair(parts, scfg, scenario, managed=True,
                   sched_kw=_kw(vclock, faults=dict(nan_at={0: (0,),
                                                            2: (0, 1)}),
                                retry_budget=1, paranoid=True))
    clean = _clean_tokens(parts, scfg, req)
    for sched in out.values():
        assert not sched.paged
        res = sched.results
        assert res[0]["tokens"] == clean and res[0]["retries"] == 1
        assert res[1]["status"] is RequestStatus.COMPLETED
        assert res[2]["status"] is RequestStatus.FAILED
        assert res[2]["retries"] == 2


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_retry_does_not_hit_the_registry(parts, vclock, kv_bits):
    """The first attempt maps a registered prefix; its retry recomputes the
    whole prompt cold (a miss, no hit) and equals a clean critical run."""
    cfg = parts[0]
    rng = np.random.default_rng(43)
    base = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    prompts = [np.concatenate([base, rng.integers(0, cfg.vocab, n)
                               .astype(np.int32)]) for n in (3, 5)]

    def scenario(sched, Req):
        sched.submit(Req(tokens=prompts[0], max_new=6))
        sched.step()                     # registers the shared prefix
        sched.submit(Req(tokens=prompts[1], max_new=7))
        sched.run()
        return {"hits": sched.registry.hits,
                "misses": sched.registry.misses}

    scfg = _cfg(kv_bits)
    out = run_pair(parts, scfg, scenario, managed=True,
                   sched_kw=_kw(vclock, faults=dict(nan_at={1: (0,)}),
                                paranoid=True))
    clean = _clean_tokens(parts, scfg, Request(tokens=prompts[1], max_new=7))
    for sched in out.values():
        assert sched.registry.hits == 1 and sched.registry.misses == 2
        res = sched.results[1]
        assert res["retries"] == 1 and res["tokens"] == clean
        _drained(sched)


@pytest.mark.parametrize("managed", [False, True])
def test_retry_under_a_precision_policy(parts, vclock, managed):
    """Under the launcher's policy layout (profile 0 keeps every layer at 16
    bits, the others ride a 4/8 row) the escalated retry runs the critical
    profile's row — profile 0's without a manager, the accuracy target's
    with one, while the saver rows ride the 4/8 row — and its tokens equal
    a clean critical run's under the same policy."""
    cfg, *_, teng, stats = parts
    row = tuple((4, 8)[l % 2] for l in range(cfg.n_layers))
    policy = tuple((16,) * cfg.n_layers if i == 0 else row
                   for i in range(len(teng.profile_names)))
    req = _rand(cfg, np.random.default_rng(47), 13, max_new=8)(Request)

    def scenario(sched, Req):
        rng = np.random.default_rng(48)
        for _ in range(3):
            sched.submit(_rand(cfg, rng, 9, max_new=6)(Req))
        sched.submit(Req(tokens=req.tokens, max_new=8))
        sched.run()
        return {}

    scfg = _cfg(8, max_batch=4, prefix_cache=False,
                precision_policy=policy)
    out = run_pair(parts, scfg, scenario, managed=managed,
                   sched_kw=_kw(vclock, faults=dict(nan_at={3: (0,)}),
                                paranoid=True))
    clean = _clean_tokens(parts, scfg, req, managed=managed)
    crit = (_manager(ProfileManager, stats).select(accuracy_critical=True)
            if managed else 0)
    for sched in out.values():
        res = sched.results[3]
        assert res["retries"] == 1 and res["tokens"] == clean
        assert set(res["profile_trace"]) == {teng.profile_names[crit]}
        if managed:
            pids = {teng.profile_names.index(p)
                    for r in list(sched.results.values())[:3]
                    for p in r["profile_trace"]}
            assert any(sched.srv.kv_table[p].tolist() == list(row)
                       for p in pids)
        _drained(sched)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_injects_faults_and_audits(capsys):
    from repro_torch.launch import serve as S
    S.main(["--device", "cpu", "--continuous", "--inject-faults",
            "--paranoid", "--retry-budget", "1", "--requests", "6",
            "--max-new", "6"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if "robustness:" in x)
    stats = dict(kv.split("=") for kv in line.split("robustness: ")[1]
                 .split())
    assert int(stats["faults_detected"]) >= 1
    assert int(stats["faults_detected"]) == \
        int(stats["recovered"]) + 2 * int(stats["failed"])
    assert "req1: 6 tokens [completed] (recovered after 1 escalated retry)" \
        in out
    assert "block-pool audit clean" in out


def test_launcher_deadline_and_shed(capsys):
    from repro_torch.launch import serve as S
    S.main(["--device", "cpu", "--continuous", "--deadline-ms", "0.001",
            "--shed", "2", "--requests", "6", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "robustness: cancelled=0 expired=2 shed=4 failed=0" in out
    assert out.count("0 tokens [shed: overload") == 4
    assert out.count("0 tokens [expired]") == 2
    assert "block-pool audit clean" in out


@pytest.mark.parametrize("flags", [["--inject-faults"], ["--paranoid"],
                                   ["--deadline-ms", "50"], ["--shed", "3"]])
def test_launcher_robustness_needs_continuous(flags):
    from repro_torch.launch import serve as S
    with pytest.raises(SystemExit, match="need --continuous"):
        S.parse_args(["--device", "cpu", *flags])
    args = S.parse_args(["--device", "cpu", "--continuous",
                         "--retry-budget", "3", *flags])
    kw = S.scheduler_kwargs(args)
    assert kw["retry_budget"] == 3
    assert (kw["faults"] is not None) == ("--inject-faults" in flags)
    assert (kw["shed"] is not None) == ("--shed" in flags)
