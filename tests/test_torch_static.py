"""The port's static serving path and contiguous slot pool against the JAX
package, on the same weights (smoke granite-3-2b, f32):

* ``AdaptiveServer.serve`` with mixed prompt lengths and mixed ``max_new``
  (two groups, pad rows), ``generate``, ``generate_stepwise`` and
  ``transformer.decode_many`` at kv16/kv8/kv4, managed and unmanaged: on the
  gather backend the tokens, profile traces and the ledger's joules equal
  the reference's; on the kernel backend (K4's plain version here, at kv8)
  the tokens do too;
* ``ContinuousScheduler`` on the contiguous pool (``paged_kv=False``) at
  kv16/kv8: tokens, traces, billing events, admission order and the ledger
  equal the JAX scheduler's with ``paged_kv=False``;
* the ring wrap off the paged pool (``prompt + max_new > slots``, slots
  32): static ``serve`` and the contiguous pool at kv16/kv8/kv4 on the
  gather backend, and at kv8 on the kernel backend (K4's plain version
  here), give the reference's tokens; kv32 (f32 cache, gather backend) on
  static ``serve`` and the contiguous pool does too;
* the launcher: without ``--continuous`` it serves through
  ``AdaptiveServer.serve`` and builds no scheduler; ``--speculate`` needs
  ``--continuous``.
"""
import jax
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
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.manager import ProfileManager
from repro_torch.launch import serve as S
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from torch_threads import _one_thread  # noqa: F401

# (prompt length, max_new): two static groups of max_batch=4, the second
# padded by two rows; max_new 1 finishes at its prefill token
REQS = [(4, 6), (9, 3), (17, 8), (6, 1), (12, 5), (7, 9)]


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
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab, n).astype(np.int32), m, i % 3 == 0)
            for i, (n, m) in enumerate(REQS)]
    return cfg, C.get_smoke("granite-3-2b"), jp, tp, jeng, teng, stats, reqs


def _manager(cls, stats, budget=12):
    """A budget of ``budget`` full-power inferences: the ledger crosses
    into saver mode part-way through the requests."""
    return cls(stats, accuracy_target=0.985, accuracy_floor=0.95,
               budget_j=stats[0].energy_j * budget, low_energy=0.5)


_JSERVERS: dict = {}


def _servers(parts, kv_bits, managed, backend, **kw):
    """A JAX server (one per configuration for the module, so its jitted
    executables compile once; the manager, host state only, is swapped in)
    and a fresh port server, each with a fresh manager when ``managed``."""
    cfg, tcfg, jp, tp, jeng, teng, stats, _ = parts
    scfg = dict(slots=64, max_batch=4, kv_bits=kv_bits, prefix_cache=False)
    scfg.update(kw)
    key = tuple(sorted(scfg.items()))
    if key not in _JSERVERS:
        _JSERVERS[key] = JServer(cfg, jp, jeng, JConfig(**scfg))
    js = _JSERVERS[key]
    js.manager = jm = _manager(JManager, stats) if managed else None
    tm = _manager(ProfileManager, stats) if managed else None
    ts = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        paged_backend=backend, **scfg), manager=tm, device="cpu")
    return js, ts, jm, tm


@pytest.mark.parametrize("kv_bits,managed", [
    (16, False), (8, False), (4, False), (16, True), (8, True), (4, True)])
def test_serve_matches_reference(parts, kv_bits, managed):
    reqs = parts[-1]
    backends = ("gather", "kernel") if kv_bits == 8 else ("gather",)
    want = jm = None
    for backend in backends:
        js, ts, jm_b, tm = _servers(parts, kv_bits, managed, backend)
        if want is None:
            want, jm = js.serve([JRequest(tokens=t, max_new=m,
                                          accuracy_critical=c)
                                 for t, m, c in reqs]), jm_b
        got = ts.serve([Request(tokens=t, max_new=m, accuracy_critical=c)
                        for t, m, c in reqs])
        for g, w, (_, m, _) in zip(got, want, reqs):
            assert g["tokens"] == w["tokens"], backend
            assert len(g["tokens"]) == m
            assert g["profile_trace"] == w["profile_trace"], backend
        if managed:
            assert tm.spent_j == jm.spent_j
            assert len({p for r in got for p in r["profile_trace"]}) > 1


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_generate_and_stepwise_match_reference(parts, kv_bits):
    """``generate`` (fused, billing ``B`` rows per step) and the per-token
    oracle ``generate_stepwise``, managed, on a uniform-length batch."""
    rng = np.random.default_rng(kv_bits)
    prompts = rng.integers(0, 512, (3, 7)).astype(np.int32)
    backends = ("gather", "kernel") if kv_bits == 8 else ("gather",)
    for backend in backends:
        for method in ("generate", "generate_stepwise"):
            js, ts, jm, tm = _servers(parts, kv_bits, True, backend)
            want = getattr(js, method)(prompts, 9)
            got = getattr(ts, method)(prompts, 9)
            assert got["tokens"] == [list(map(int, r))
                                     for r in want["tokens"]], \
                (backend, method)
            assert got["profile_trace"] == want["profile_trace"]
            assert tm.spent_j == jm.spent_j
            assert len(set(got["profile_trace"])) > 1


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_decode_many_matches_reference(parts, backend):
    """``decode_many`` from the same prefill at kv8 with per-row budgets
    (one row at 0 budget: all −1) and a switching schedule."""
    cfg, tcfg, jp, tp, jeng, teng, _, _ = parts
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, 512, (3, 6)).astype(np.int32)
    sched = np.asarray([0, 0, 2, 4, 4, 1, 5], np.int32)
    budget = np.asarray([7, 3, 0], np.int32)
    jl, jc = JT.prefill(jp, cfg, jeng.table[0], {"tokens": prompts}, 32,
                        kv_bits=8)
    pos0 = np.full((3,), 6, np.int32)
    want, jpids, _ = jax.jit(lambda p, lg, c: JT.decode_many(
        p, cfg, jeng.table, sched, lg, pos0, c, row_budget=budget))(jp, jl,
                                                                    jc)
    tl, tc = T.prefill(tp, tcfg, teng.table[0],
                       {"tokens": torch.from_numpy(prompts)}, 32, kv_bits=8)
    got, pids, _ = T.decode_many(tp, tcfg, teng.table, sched, tl,
                                 torch.from_numpy(pos0), tc,
                                 row_budget=budget, paged_backend=backend)
    assert got.tolist() == np.asarray(want).tolist()
    assert list(pids) == np.asarray(jpids).tolist()
    assert got[2].tolist() == [-1] * len(sched)


@pytest.mark.parametrize("kv_bits,managed", [
    (16, False), (8, False), (16, True), (8, True)])
def test_contiguous_pool_matches_reference(parts, kv_bits, managed):
    """Staggered admission into a 4-row contiguous pool (6 requests, one
    finishing at admission): tokens, traces, events, admission order and
    the ledger equal the JAX scheduler's; both backends."""
    reqs = parts[-1]
    want = jm = None
    for backend in ("gather", "kernel"):
        js, ts, jm_b, tm = _servers(parts, kv_bits, managed, backend,
                                    paged_kv=False)
        if want is None:
            jm, jsched = jm_b, JScheduler(js, quantum=4)
            for t, m, c in reqs:
                jsched.submit(JRequest(tokens=t, max_new=m,
                                       accuracy_critical=c))
            want = jsched.run()
        sched = ContinuousScheduler(ts, quantum=4)
        assert not sched.paged and sched.allocator is None
        for t, m, c in reqs:
            sched.submit(Request(tokens=t, max_new=m, accuracy_critical=c))
        got = sched.run()
        for g, w in zip(got, want):
            assert g["tokens"] == w["tokens"], backend
            assert g["profile_trace"] == w["profile_trace"]
            assert g["status"].value == w["status"].value == "completed"
        assert sched.events == jsched.events
        assert sched.admission_log == jsched.admission_log
        assert sched.decode_steps > 0
        st = sched.paged_stats()
        assert st == {"paged": False, "kv_bytes": st["kv_bytes"]}
        if managed:
            assert tm.spent_j == jm.spent_j


# (prompt length, max_new) with prompt + max_new > 32 slots in three rows:
# the contiguous ring wraps onto the row's first slots
WRAP = [(30, 12), (12, 25), (26, 9), (5, 4)]


def _serve_both(parts, kv_bits, backend, path, reqs, **kw):
    """The reference's and the port's tokens for ``reqs`` on ``path``:
    static ``serve``, or the scheduler on the contiguous pool."""
    js, ts, _, _ = _servers(parts, kv_bits, False, backend,
                            paged_kv=path == "static", **kw)
    if path == "static":
        want = js.serve([JRequest(tokens=t, max_new=m) for t, m in reqs])
        got = ts.serve([Request(tokens=t, max_new=m) for t, m in reqs])
        return want, got
    jsched, sched = JScheduler(js, quantum=4), ContinuousScheduler(ts,
                                                                   quantum=4)
    assert not sched.paged
    for t, m in reqs:
        jsched.submit(JRequest(tokens=t, max_new=m))
        sched.submit(Request(tokens=t, max_new=m))
    want, got = jsched.run(), sched.run()
    assert sched.admission_log == jsched.admission_log
    return want, got


@pytest.mark.parametrize("path", ["static", "contiguous"])
@pytest.mark.parametrize("kv_bits,backend", [
    (16, "gather"), (8, "gather"), (8, "kernel"), (4, "gather")])
def test_ring_wrap_off_the_paged_pool_matches_reference(parts, kv_bits,
                                                        backend, path):
    rng = np.random.default_rng(47 + kv_bits)
    reqs = [(rng.integers(0, 512, n).astype(np.int32), m) for n, m in WRAP]
    want, got = _serve_both(parts, kv_bits, backend, path, reqs, slots=32)
    for g, w, (n, m) in zip(got, want, WRAP):
        assert g["tokens"] == w["tokens"], (backend, n, m)
        assert len(g["tokens"]) == m


@pytest.mark.parametrize("path", ["static", "contiguous"])
def test_kv32_matches_reference(parts, path):
    """An f32 cache (gather backend, the only one that takes it)."""
    reqs = [(t, m) for t, m, _ in parts[-1]]
    want, got = _serve_both(parts, 32, "gather", path, reqs)
    for g, w, (_, m) in zip(got, want, reqs):
        assert g["tokens"] == w["tokens"]
        assert len(g["tokens"]) == m


@pytest.mark.parametrize("argv,path", [
    ([], "static"), (["--continuous"], "paged"),
    (["--continuous", "--no-paged-kv"], "contiguous")])
def test_launcher_continuous_flag_decides_the_path(monkeypatch, capsys,
                                                   argv, path):
    """Without ``--continuous`` the launcher serves through
    ``AdaptiveServer.serve`` and builds no scheduler; with it, the
    scheduler runs on the pool ``--no-paged-kv`` picks."""
    calls = {"serve": 0, "sched": []}
    orig_serve = AdaptiveServer.serve

    def counting_serve(self, requests):
        calls["serve"] += 1
        return orig_serve(self, requests)

    class Recording(ContinuousScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            calls["sched"].append(self.paged)

    monkeypatch.setattr(AdaptiveServer, "serve", counting_serve)
    monkeypatch.setattr(S, "ContinuousScheduler", Recording)
    S.main(["--device", "cpu", "--requests", "3", "--max-new", "3",
            "--kv-bits", "8"] + argv)
    out = capsys.readouterr().out
    if path == "static":
        assert calls == {"serve": 1, "sched": []}
        assert "static groups" in out
    else:
        assert calls == {"serve": 0, "sched": [path == "paged"]}
    assert out.count("3 tokens") == 3


def test_launcher_speculate_needs_continuous():
    with pytest.raises(SystemExit, match="--continuous"):
        S.parse_args(["--device", "cpu", "--speculate"])
    args = S.parse_args(["--device", "cpu", "--speculate", "--continuous"])
    assert args.speculate and args.continuous and args.paged_kv
