"""Crash-consistent serving in the port against the JAX reference, on the
same weights (smoke granite-3-2b, ``params_from_jax``, f32): every case of
``tests/test_durability.py``, and the two packages against each other.

* the journal: a torn tail is truncated on reopen, a checksum failure cuts
  the suffix, and records written through both packages' ``RequestJournal``
  give byte-identical files;
* one workload (kv8, chunked prefill, copy-on-write prefixes, two classes,
  ``checkpoint_every=2``, a queued and a mid-chunk cancel, a virtual clock)
  journaled by both packages gives byte-identical ``journal.jsonl`` files
  and checkpoints with equal metadata, keys, shapes and dtypes; the row
  state agrees as the forwards do (masters within 1e-5, scales and amaxes
  to one f32 ulp, the quantized ints equal);
* abandoning the scheduler after every round boundary (kv16 with
  speculation, kv8 with chunked prefill; both backends) and recovering
  gives the uninterrupted run's statuses and tokens, which equal the JAX
  scheduler's; ``check()`` is clean and no block stays in use;
* journal-only recovery, an idempotent re-crash, a corrupted snapshot
  leaf re-prefilled from the prompt, billed = delivered through a restart
  (the ledger replays exactly), drain and a cold restart, ``kv16_masters``;
* a directory the reference wrote and abandoned mid-serve is recovered by
  the port, which finishes with the reference's tokens; the reverse
  direction too;
* the contiguous pool refuses a live-state cut; the launcher's
  ``--journal-dir``, ``--checkpoint-every`` and ``--drain-on-sigterm``.

The JAX schedulers run each workload once (module fixtures); the port's
runs are cheap.
"""
import json
import os
import signal

import numpy as np
import pytest

from repro.core.engine import AdaptiveEngine as JEngine
from repro.core.engine import QuantIndex as JQuantIndex
from repro.core.profiles import paper_profiles as jax_paper_profiles
from repro.models import transformer as JT
from repro.serving import durability as JD
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.manager import ProfileManager, ProfileStats
from repro_torch.launch import serve as S
from repro_torch.serving import durability as D
from repro_torch.serving.engine import (AdaptiveServer, Request,
                                        RequestStatus, ServingConfig)
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_prefix import parts  # noqa: F401
from torch_threads import _one_thread  # noqa: F401

BASE = dict(slots=64, max_batch=4, block_size=8, pool_blocks=64,
            priority_classes=2)
CONFIGS = {"kv16-spec": dict(BASE, speculate=True, draft_k=2),
           "kv8-chunked": dict(BASE, kv_bits=8, prefill_chunk=16)}
BACKENDS = ["gather", "kernel"]


def _workload(cfg, Req, seed=0):
    """Two classes, a 16-token system prefix two block-aligned prompts
    share copy-on-write, and a 40-token prompt (chunks at 16)."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, cfg.vocab, 16).astype(np.int32)

    def mk(n):
        return rng.integers(0, cfg.vocab, n).astype(np.int32)

    return [Req(tokens=np.concatenate([sys_p, mk(5)]), max_new=6, priority=1),
            Req(tokens=np.concatenate([sys_p, mk(7)]), max_new=5, priority=0),
            Req(tokens=mk(40), max_new=4, priority=1),
            Req(tokens=mk(6), max_new=8, priority=0),
            Req(tokens=mk(9), max_new=6, priority=1),
            Req(tokens=mk(5), max_new=4, priority=0)]


def _pattern(sched, reqs, stop_after=None):
    """Four requests up front, the rest after round 1; stops after
    ``stop_after`` rounds (the crash). Returns the rounds stepped."""
    for r in reqs[:4]:
        sched.submit(r)
    steps = 0
    while True:
        if stop_after is not None and steps == stop_after:
            return steps
        more = sched.step()
        steps += 1
        if steps == 1 and len(reqs) > 4:
            for r in reqs[4:]:
                sched.submit(r)
            more = True
        if not more:
            return steps


def _finish(sched, reqs):
    """Run a recovered scheduler to the end, submitting the arrivals the
    crash predates (``_n`` counts the accepted submissions)."""
    for r in reqs[sched._n:]:
        sched.submit(r)
    while sched.step():
        pass


def _tokens(sched, n):
    return [[int(x) for x in sched.results[i]["tokens"]] for i in range(n)]


def _assert_identical(sched, n, *twins):
    for rid in range(n):
        assert sched.results[rid]["status"] is RequestStatus.COMPLETED, rid
    for twin in twins:
        assert _tokens(sched, n) == twin
    sched.check()
    assert sched.allocator.used_blocks == 0


def _jax_engine(names, order=None):
    profs = jax_paper_profiles(names, inner_layers=[])
    order = order or range(len(profs))
    return JEngine(tuple(profs[i] for i in order), JQuantIndex(names),
                   lambda *a: None)


def _port_engine(names, order=None):
    profs = TP.paper_profiles(names, inner_layers=[])
    order = order or range(len(profs))
    return TE.AdaptiveEngine(tuple(profs[i] for i in order),
                             TE.QuantIndex(names))


@pytest.fixture(scope="module")
def ref(parts):  # noqa: F811
    """The JAX servers of both configurations and their uninterrupted
    tokens on the seed-0 workload."""
    cfg, _, jp, _, jeng, _, _ = parts
    out = {}
    for which, scfg in CONFIGS.items():
        srv = JServer(cfg, jp, jeng, JConfig(**scfg))
        sched = JScheduler(srv, quantum=4)
        rounds = _pattern(sched, _workload(cfg, JRequest))
        out[which] = {"srv": srv, "rounds": rounds,
                      "tokens": _tokens(sched, 6)}
    return out


@pytest.fixture(scope="module")
def servers(parts):  # noqa: F811
    """``servers(which, backend, **extra)``: the port's server, cached."""
    _, tcfg, _, tp, _, teng, _ = parts
    cache = {}

    def get(which, backend="kernel", **extra):
        key = (which, backend, tuple(sorted(extra.items())))
        if key not in cache:
            scfg = dict(CONFIGS[which], **extra) if which else dict(extra)
            cache[key] = AdaptiveServer(
                tcfg, tp, teng, ServingConfig(paged_backend=backend, **scfg),
                device="cpu")
        return cache[key]
    return get


def _twin(srv, cfg, seed=0):
    sched = ContinuousScheduler(srv, quantum=4)
    rounds = _pattern(sched, _workload(cfg, Request, seed))
    return rounds, _tokens(sched, 6)


# ---------------------------------------------------------------------------
# the journal (pure host)
# ---------------------------------------------------------------------------

def _both(tmp_path, name):
    return [(mod, str(tmp_path / f"{tag}-{name}.jsonl"))
            for tag, mod in (("jax", JD), ("port", D))]


def _same_files(paths):
    (_, a), (_, b) = paths
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_journal_torn_tail_truncated_on_reopen(tmp_path):
    """A crash mid-write leaves a torn tail: scan stops at it, reopening
    truncates it and the next append gives a clean suffix; both packages
    write the same bytes at every stage."""
    paths = _both(tmp_path, "torn")
    for mod, p in paths:
        j = mod.RequestJournal(p)
        j.append({"t": "submit", "rid": 0}, sync=True)
        j.append({"t": "final", "rid": 0})
        j.close()
        with open(p, "ab") as f:
            f.write(b'deadbeef {"t": "gar')          # no newline: torn
        assert [r["t"] for _, r in D.RequestJournal.scan(p)] == \
            ["submit", "final"]
    for mod, p in paths:
        j2 = mod.RequestJournal(p)                  # reopen truncates
        j2.append({"t": "cancel", "rid": 0})
        j2.close()
        recs = D.RequestJournal.scan(p)
        assert [r["t"] for _, r in recs] == ["submit", "final", "cancel"]
        assert recs[-1][0] == os.path.getsize(p)    # byte-exact prefix
    _same_files(paths)


def test_journal_checksum_gates_suffix(tmp_path):
    """A bit flip in a middle record invalidates it and everything after:
    scan returns the intact prefix only, in both packages."""
    paths = _both(tmp_path, "crc")
    for mod, p in paths:
        j = mod.RequestJournal(p)
        for rid in range(3):
            j.append({"t": "submit", "rid": rid})
        j.close()
    _same_files(paths)
    for mod, p in paths:
        raw = open(p, "rb").read().splitlines(keepends=True)
        raw[1] = raw[1][:12] + b"X" + raw[1][13:]
        with open(p, "wb") as f:
            f.writelines(raw)
        assert [r["rid"] for _, r in D.RequestJournal.scan(p)] == [0]
        assert [r["rid"] for _, r in mod.RequestJournal.scan(p)] == [0]


def test_journal_records_byte_identical(tmp_path):
    """Every field type the hooks write (ints, floats, None, bools, lists,
    strings with non-ASCII) frames and checksums identically."""
    recs = [{"t": "submit", "rid": 7, "tokens": [1, 2, 3], "max_new": 5,
             "accuracy_critical": True, "priority": 0, "deadline_ms": 12.5},
            {"t": "final", "rid": 7, "status": "expired", "reason": "säge",
             "retries": None, "tokens": [], "profile_trace": ["A8-W8"]},
            {"t": "deliver", "rids": [7, 3]}, {"t": "ckpt", "step": 2,
                                               "pos": 418}]
    paths = _both(tmp_path, "recs")
    for mod, p in paths:
        j = mod.RequestJournal(p)
        for i, r in enumerate(recs):
            j.append(r, sync=bool(i % 2))
        assert j.position() == os.path.getsize(p)
        j.close()
    _same_files(paths)
    assert [r for _, r in D.RequestJournal.scan(paths[1][1])] == recs


# ---------------------------------------------------------------------------
# one workload journaled by both packages
# ---------------------------------------------------------------------------

def _journal_scenario(sched, cfg, Req):
    """Four requests, two more after round 1 (the queued 5 cancelled at
    once), then the 40-token prompt cancelled mid-chunk after round 2."""
    reqs = _workload(cfg, Req)
    for r in reqs[:4]:
        sched.submit(r)
    sched.step()
    for r in reqs[4:]:
        sched.submit(r)
    assert sched.cancel(5)
    sched.step()
    assert sched.cancel(2)
    while sched.step():
        pass


@pytest.mark.parametrize("backend", BACKENDS)
def test_workload_journal_byte_identical_across_packages(parts, tmp_path,
                                                         backend):
    """The JAX and the port's scheduler journal one workload into
    byte-identical files, and cut checkpoints with equal metadata.

    Both read one virtual clock, so the metadata read from the clock
    (``seg_dt``, each request's ``deadline_left``, ``q_elapsed``,
    ``recovery_latency``) is equal too; on the host clock only those fields
    would differ. Profile 0 is A8-W8 on both sides: at A16 the reference's
    inexact pow2 activation grid moves a value by one step
    (``test_torch_quant``), which the raw masters would carry. The row
    state agrees as the two forwards do: masters within 1e-5, scales and
    amaxes to one f32 ulp (rtol 1e-6: an amax is the forward's largest
    |K|), and the ints the masters quantize to under their scales equal."""
    cfg, tcfg, jp, tp, _, _, _ = parts
    names = JT.quant_layer_names(cfg)
    order = [2, 0, 1, 3, 4, 5]                # A8-W8 first
    scfg = CONFIGS["kv8-chunked"]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    js = JScheduler(JServer(cfg, jp, _jax_engine(names, order),
                            JConfig(**scfg)), quantum=4, clock=lambda: 0.0)
    JD.Durability(js, jd, checkpoint_every=2)
    _journal_scenario(js, cfg, JRequest)
    ts = ContinuousScheduler(
        AdaptiveServer(tcfg, tp, _port_engine(names, order),
                       ServingConfig(paged_backend=backend, **scfg),
                       device="cpu"), quantum=4, clock=lambda: 0.0)
    D.Durability(ts, td, checkpoint_every=2)
    _journal_scenario(ts, cfg, Request)
    with open(os.path.join(jd, "journal.jsonl"), "rb") as f:
        want = f.read()
    with open(os.path.join(td, "journal.jsonl"), "rb") as f:
        assert f.read() == want
    kinds = [r["t"] for _, r in D.RequestJournal.scan(
        os.path.join(td, "journal.jsonl"))]
    assert {"submit", "cancel", "final", "admit", "flush", "ckpt"} <= \
        set(kinds)
    steps = sorted(os.listdir(os.path.join(jd, "checkpoints")))
    assert steps == sorted(os.listdir(os.path.join(td, "checkpoints")))
    assert len(steps) >= 4                    # two committed cuts at least
    for name in steps:
        if name.endswith(".DONE"):
            continue
        a, b = (os.path.join(d, "checkpoints", name) for d in (jd, td))
        ma, mb = (json.load(open(os.path.join(x, "meta.json")))
                  for x in (a, b))
        assert ma["metadata"] == mb["metadata"]
        assert ma["keys"] == mb["keys"] and ma["keys"]
        with np.load(os.path.join(a, "arrays.npz")) as za, \
                np.load(os.path.join(b, "arrays.npz")) as zb:
            for k in ma["keys"]:
                x, y = za[k], zb[k]
                assert x.shape == y.shape and x.dtype == y.dtype, k
                leaf = k.rsplit("/", 1)[1]
                if leaf in ("mk", "mv"):
                    np.testing.assert_allclose(y, x, atol=1e-5, rtol=0,
                                               err_msg=k)
                else:
                    np.testing.assert_allclose(y, x, rtol=1e-6, atol=0,
                                               err_msg=k)
            for k in ma["keys"]:
                group, leaf = k.rsplit("/", 1)
                if group.startswith("rows/") and leaf in ("mk", "mv"):
                    sc = f"{group}/{'ksc' if leaf == 'mk' else 'vsc'}"
                    q = [np.round(z[k] / z[sc][:, None, :, None])
                         for z in (za, zb)]
                    assert np.array_equal(*q), k


# ---------------------------------------------------------------------------
# crash at every round boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("which", list(CONFIGS))
def test_crash_restart_token_identity_every_boundary(parts, ref, servers,
                                                     tmp_path, which,
                                                     backend):
    """For every round boundary k (at most 8), abandon the scheduler after
    k rounds (``checkpoint_every=1``: the newest cut is that boundary's)
    and recover into a fresh scheduler. k = 0 recovers from the journal
    alone. Statuses and tokens equal the port's uninterrupted run and the
    JAX scheduler's; the pool drains clean."""
    cfg = parts[0]
    srv = servers(which, backend)
    rounds, twin = _twin(srv, cfg)
    assert rounds == ref[which]["rounds"] >= 3
    assert twin == ref[which]["tokens"]
    resumed = 0
    for k in range(min(rounds, 8)):
        jd = str(tmp_path / f"k{k}")
        s1 = ContinuousScheduler(srv, quantum=4)
        D.Durability(s1, jd, checkpoint_every=1)
        _pattern(s1, _workload(cfg, Request), stop_after=k)   # the crash
        s2 = D.recover(srv, jd, checkpoint_every=1, quantum=4)
        assert s2.recover_info["recovery_s"] >= 0.0
        resumed += (s2.recover_info["resumed_rows"]
                    + s2.recover_info["chunk_rows"])
        _finish(s2, _workload(cfg, Request))
        _assert_identical(s2, 6, twin)
    assert resumed > 0


def test_journal_only_recovery_no_checkpoint(parts, servers, tmp_path):
    """``checkpoint_every=0``: the write-ahead submit records alone recover
    every accepted request (nothing resumed, nothing lost)."""
    cfg = parts[0]
    srv = servers("kv16-spec")
    _, twin = _twin(srv, cfg, seed=3)
    jd = str(tmp_path / "jd")
    s1 = ContinuousScheduler(srv, quantum=4)
    D.Durability(s1, jd)
    _pattern(s1, _workload(cfg, Request, 3), stop_after=3)
    s2 = D.recover(srv, jd, quantum=4)
    assert s2.recover_info["resumed_rows"] == 0
    assert s2._n >= 4
    _finish(s2, _workload(cfg, Request, 3))
    _assert_identical(s2, 6, twin)


def test_recover_is_idempotent_on_recrash(parts, servers, tmp_path):
    """A second crash right after recovery recovers to the same state: the
    cut recovery writes leaves nothing to replay."""
    cfg = parts[0]
    srv = servers("kv8-chunked")
    _, twin = _twin(srv, cfg, seed=5)
    jd = str(tmp_path / "jd")
    s1 = ContinuousScheduler(srv, quantum=4)
    D.Durability(s1, jd, checkpoint_every=1)
    _pattern(s1, _workload(cfg, Request, 5), stop_after=2)
    D.recover(srv, jd, checkpoint_every=1, quantum=4)     # crash again
    s3 = D.recover(srv, jd, checkpoint_every=1, quantum=4)
    assert s3.recover_info["replayed"] == 0
    _finish(s3, _workload(cfg, Request, 5))
    _assert_identical(s3, 6, twin)


def test_corrupted_snapshot_refills_from_prompt(parts, servers, tmp_path):
    """A live row's master-K leaf flipped inside the newest checkpoint
    fails its crc32: recovery re-prefills only that row from its prompt
    (``recover_info["refilled"]``) and it still completes with the
    uninterrupted tokens."""
    cfg = parts[0]
    srv = servers("kv16-spec")
    rounds, twin = _twin(srv, cfg, seed=7)
    for k in range(2, rounds):
        jd = str(tmp_path / f"k{k}")
        s1 = ContinuousScheduler(srv, quantum=4)
        D.Durability(s1, jd, checkpoint_every=1)
        _pattern(s1, _workload(cfg, Request, 7), stop_after=k)
        step = s1.durable.manager.latest_step()
        sdir = os.path.join(jd, "checkpoints", f"step_{step:09d}")
        with np.load(os.path.join(sdir, "arrays.npz")) as z:
            flat = {n: z[n] for n in z.files}
        victims = [n for n in flat
                   if n.startswith("rows/") and n.endswith("/mk")]
        if not victims:
            continue
        flat[victims[0]] = flat[victims[0]] + 1.0         # silent bit-rot
        np.savez(os.path.join(sdir, "arrays.npz"), **flat)
        s2 = D.recover(srv, jd, checkpoint_every=1, quantum=4)
        rid = int(victims[0].split("/")[1])
        assert s2.recover_info["refilled"] == [rid]
        assert s2.recover_info["corrupt_keys"] == [victims[0]]
        _finish(s2, _workload(cfg, Request, 7))
        _assert_identical(s2, 6, twin)
        return
    pytest.fail("no crash point left a live row in the checkpoint")


def _manager():
    stats = [ProfileStats(n, acc, e, 1e-3) for n, acc, e in [
        ("A16-W8", 0.99, 4.0), ("A16-W4", 0.953, 2.0), ("A8-W8", 0.988, 3.0),
        ("A8-W4", 0.953, 1.5), ("A4-W4", 0.958, 1.0), ("Mixed", 0.975, 2.0)]]
    return ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.90,
                          budget_j=150.0, low_energy=0.5)


def test_billed_equals_delivered_through_restart(parts, tmp_path):  # noqa: F811
    """The energy ledger is part of the cut: replaying the recovered
    scheduler's events through a fresh manager reproduces its profiles and
    spend, and the inferences billed equal the tokens delivered (the
    rounds re-run after the cut bill what the lost ones had)."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    mgr = _manager()
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        slots=64, max_batch=2, block_size=8, priority_classes=2),
        manager=mgr, device="cpu")
    reqs = _workload(cfg, Request, 11)[:4]
    jd = str(tmp_path / "jd")
    s1 = ContinuousScheduler(srv, quantum=3)
    D.Durability(s1, jd, checkpoint_every=1)
    _pattern(s1, reqs, stop_after=2)
    s2 = D.recover(srv, jd, checkpoint_every=1, quantum=3)
    _finish(s2, reqs)
    for rid, req in enumerate(reqs):
        assert s2.results[rid]["status"] is RequestStatus.COMPLETED
        assert len(s2.results[rid]["tokens"]) == req.max_new
    oracle = _manager()
    for pid, n_rows, critical in s2.events:
        assert oracle.select(accuracy_critical=critical) == pid
        oracle.account(pid, n_rows)
    assert abs(oracle.spent_j - mgr.spent_j) < 1e-9
    assert sum(n for _, n, _ in s2.events) == sum(r.max_new for r in reqs)
    s2.check()


def test_drain_finishes_live_keeps_queued_restart_completes(parts, servers,
                                                            tmp_path):
    """``drain()`` stops admission, runs the live rows to completion and
    leaves the queued request queued; a final cut and a cold restart
    complete it with the uninterrupted tokens."""
    cfg = parts[0]
    srv = servers("kv16-spec")
    reqs = _workload(cfg, Request, 13)[:5]          # max_batch 4: one queues
    tw = ContinuousScheduler(srv, quantum=4)
    for r in reqs:
        tw.submit(r)
    tw.run()
    twin = _tokens(tw, 5)
    jd = str(tmp_path / "jd")
    s1 = ContinuousScheduler(srv, quantum=4)
    dur = D.Durability(s1, jd, checkpoint_every=2)
    for r in reqs:
        s1.submit(r)
    s1.step()
    s1.drain()
    assert s1.live_rows == 0 and not s1._inflight
    done = [rid for rid in range(5)
            if s1.results.get(rid, {}).get("status")
            is RequestStatus.COMPLETED]
    assert len(done) == 4 and s1.pending == 1
    assert any(r["t"] == "drain" for _, r in D.RequestJournal.scan(
        os.path.join(jd, "journal.jsonl")))
    dur.checkpoint()                                  # the shutdown cut
    s2 = D.recover(srv, jd, checkpoint_every=2, quantum=4)
    assert s2.pending == 1 and not s2.draining      # drain does not persist
    _finish(s2, reqs)
    _assert_identical(s2, 5, twin)


def test_kv16_masters_registry_and_crash_identity(parts, servers, tmp_path):
    """``kv16_masters=True`` keeps f32 masters beside the shared blocks:
    the registry carries both, and a crash restores the shared prefixes
    from the masters with the uninterrupted tokens."""
    cfg = parts[0]
    srv = servers(None, slots=64, max_batch=4, block_size=8, pool_blocks=64,
                  kv16_masters=True)
    assert srv.masters_mode and srv._collect_masters
    reqs = _workload(cfg, Request, 17)[:4]
    tw = ContinuousScheduler(srv, quantum=4)
    rounds = _pattern(tw, reqs)
    twin = _tokens(tw, 4)
    assert any(e.master_k is not None and e.block_ids is not None
               for e in tw.registry._entries.values())
    jd = str(tmp_path / "jd")
    s1 = ContinuousScheduler(srv, quantum=4)
    D.Durability(s1, jd, checkpoint_every=1)
    _pattern(s1, reqs, stop_after=max(2, rounds // 2))
    s2 = D.recover(srv, jd, checkpoint_every=1, quantum=4)
    assert any(e.master_k is not None and e.block_ids is None
               for e in s2.registry._entries.values())   # masters-only
    _finish(s2, reqs)
    _assert_identical(s2, 4, twin)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", list(CONFIGS))
def test_port_recovers_a_reference_directory(parts, ref, servers, tmp_path,
                                             which):
    """The JAX scheduler journals and checkpoints the workload and is
    abandoned at its midpoint; the port recovers the directory and
    finishes with the reference's uninterrupted tokens. The cut the port's
    recovery writes holds the reference cut's rows, chunk masters and
    registry masters bit for bit (restore is data movement)."""
    cfg = parts[0]
    jd = str(tmp_path / "jd")
    k = ref[which]["rounds"] // 2
    js = JScheduler(ref[which]["srv"], quantum=4)
    JD.Durability(js, jd, checkpoint_every=1)
    _pattern(js, _workload(cfg, JRequest), stop_after=k)
    cut, _ = D.CheckpointManager(os.path.join(jd, "checkpoints")).restore()
    s2 = D.recover(servers(which), jd, checkpoint_every=1, quantum=4)
    info = s2.recover_info
    assert info["resumed_rows"] + info["chunk_rows"] > 0
    assert not info["refilled"] and not info["corrupt_keys"]
    again, _ = s2.durable.manager.restore()
    for group in ("rows", "chunks", "registry"):
        assert sorted(cut.get(group, {})) == sorted(again.get(group, {}))
        for key, leaves in cut.get(group, {}).items():
            assert sorted(leaves) == sorted(again[group][key])
            for name, x in leaves.items():
                assert np.array_equal(again[group][key][name], x), \
                    (group, key, name)
    _finish(s2, _workload(cfg, Request))
    _assert_identical(s2, 6, ref[which]["tokens"])


def test_reference_recovers_a_port_directory(parts, ref, servers, tmp_path):
    """The reverse: the port abandons the kv8 chunked workload at its
    midpoint and the JAX package's ``recover`` finishes it with its own
    uninterrupted tokens."""
    cfg = parts[0]
    which = "kv8-chunked"
    jd = str(tmp_path / "jd")
    s1 = ContinuousScheduler(servers(which), quantum=4)
    D.Durability(s1, jd, checkpoint_every=1)
    _pattern(s1, _workload(cfg, Request), stop_after=ref[which]["rounds"] // 2)
    js = JD.recover(ref[which]["srv"], jd, checkpoint_every=1, quantum=4)
    assert js.recover_info["resumed_rows"] + js.recover_info["chunk_rows"]
    _finish(js, _workload(cfg, JRequest))
    assert _tokens(js, 6) == ref[which]["tokens"]
    assert js.allocator.used_blocks == 0


def test_contiguous_pool_refuses_a_live_cut(parts, servers, tmp_path):
    """Rows restore only through the paged pool's resume wave: a cut with
    a live row on the contiguous pool raises ``ValueError``."""
    cfg = parts[0]
    srv = servers(None, slots=64, max_batch=2, paged_kv=False)
    assert not srv.can_restore
    s1 = ContinuousScheduler(srv, quantum=4)
    D.Durability(s1, str(tmp_path / "jd"), checkpoint_every=1)
    s1.submit(_workload(cfg, Request)[3])
    with pytest.raises(ValueError, match="paged KV pool"):
        s1.step()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _finals(jd):
    out = {}
    for _, rec in D.RequestJournal.scan(os.path.join(jd, "journal.jsonl")):
        if rec["t"] == "final":
            out.setdefault(rec["rid"], []).append(rec["tokens"])
    return out


def test_launcher_journal_dir_recovers_after_a_crash(tmp_path, monkeypatch,
                                                     capsys):
    """``--journal-dir`` with ``--checkpoint-every 2``: a process that dies
    after 5 rounds is recovered by the next boot (its ``[serve] recovered``
    line), which also serves its own submissions; every request of the
    first boot has exactly one ``final`` record, with the tokens of an
    uninterrupted boot on a fresh directory."""
    base = ["--continuous", "--device", "cpu", "--requests", "5",
            "--max-new", "12", "--quantum", "4", "--checkpoint-every", "2"]
    crash, clean = str(tmp_path / "crash"), str(tmp_path / "clean")
    step = ContinuousScheduler.step
    rounds = [0]

    def dying_step(self):
        rounds[0] += 1
        if rounds[0] > 5:
            raise KeyboardInterrupt("the process dies")
        return step(self)

    monkeypatch.setattr(ContinuousScheduler, "step", dying_step)
    with pytest.raises(KeyboardInterrupt):
        S.main(base + ["--journal-dir", crash])
    monkeypatch.setattr(ContinuousScheduler, "step", step)
    assert len(_finals(crash)) < 5
    S.main(base + ["--journal-dir", crash])
    out = capsys.readouterr().out
    assert f"[serve] recovered from {crash}:" in out
    assert "[serve] durability:" in out
    S.main(base + ["--journal-dir", clean])
    got, want = _finals(crash), _finals(clean)
    assert sorted(got) == list(range(10)) and sorted(want) == list(range(5))
    for rid in range(5):
        assert len(got[rid]) == 1 and got[rid] == want[rid], rid


def test_launcher_drain_on_sigterm(tmp_path, monkeypatch, capsys):
    """``--drain-on-sigterm``: a SIGTERM after the first round stops
    admission, finishes the admitted rows, cuts a final checkpoint and
    leaves the queued requests journaled; the next boot completes them."""
    jd = str(tmp_path / "jd")
    base = ["--continuous", "--device", "cpu", "--requests", "6",
            "--max-new", "8", "--quantum", "4", "--journal-dir", jd,
            "--drain-on-sigterm"]
    step = ContinuousScheduler.step

    def term_after_first(self):
        more = step(self)
        if self._round == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return more

    old = signal.getsignal(signal.SIGTERM)
    try:
        monkeypatch.setattr(ContinuousScheduler, "step", term_after_first)
        S.main(base)
        out = capsys.readouterr().out
        assert "[serve] SIGTERM drain: 2 request(s) left queued" in out
        assert out.count("queued (journaled for the next process)") == 2
        kinds = [r["t"] for _, r in D.RequestJournal.scan(
            os.path.join(jd, "journal.jsonl"))]
        assert "drain" in kinds and kinds[-1] == "ckpt"
        assert len(_finals(jd)) == 4
        monkeypatch.setattr(ContinuousScheduler, "step", step)
        S.main(base)
    finally:
        signal.signal(signal.SIGTERM, old)
    finals = _finals(jd)
    assert sorted(finals) == list(range(12))
    assert all(len(v) == 1 and len(v[0]) == 8 for v in finals.values())


def test_launcher_durability_flags_need_continuous():
    for flags in (["--journal-dir", "x"], ["--drain-on-sigterm"]):
        with pytest.raises(SystemExit, match="--continuous"):
            S.parse_args(["--device", "cpu"] + flags)
    assert S.parse_args([]).checkpoint_every == 8
