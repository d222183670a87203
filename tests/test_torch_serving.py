"""The port's ContinuousScheduler against the JAX one, on the same weights
and staggered requests (smoke granite-3-2b, paged pool, no prefix cache):
per-request tokens and profile traces, billing events and admission order
all equal; the allocator drains to zero live blocks; the energy ledger
matches to the joule. Both of the port's backends run (the kernel backend
takes its plain version on the CPU). An f32 cache (kv32, gather backend
only) on the paged pool gives the reference's tokens too.
"""
import jax
import numpy as np
import pytest

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
from repro_torch.core.energy import TPU_V5E
from repro_torch.core.manager import ProfileManager
from repro_torch.launch.serve import profile_stats
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler

# (prompt, max_new): the block-boundary case of tests/test_paged_kv.py, and
# the mid-stream-refill case of tests/test_serving_ragged.py (max_new=1
# completes at admission)
CASES = {
    "boundary": (13, [(7, 6), (8, 5), (9, 7), (16, 4), (17, 6)]),
    "refill": (11, [(4, 7), (9, 3), (17, 10), (5, 1), (12, 6), (6, 9)]),
}


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


def _requests(case: str):
    seed, shape = CASES[case]
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, n).astype(np.int32), m, m == 9)
            for n, m in shape]


def _manager(cls, stats):
    return cls(stats, accuracy_target=0.985, accuracy_floor=0.95,
               budget_j=stats[0].energy_j * 30, low_energy=0.5)


@pytest.mark.parametrize("case,kv_bits,managed", [
    ("boundary", 16, False), ("boundary", 8, False), ("boundary", 4, False),
    ("boundary", 16, True), ("boundary", 8, True), ("boundary", 4, True),
    ("refill", 8, True), ("refill", 16, False)])
def test_scheduler_matches_reference(parts, case, kv_bits, managed):
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    reqs = _requests(case)
    scfg = dict(slots=64, max_batch=4, kv_bits=kv_bits, block_size=8)
    jm = _manager(JManager, stats) if managed else None
    js = JServer(cfg, jp, jeng, JConfig(prefix_cache=False, **scfg),
                 manager=jm)
    jsched = JScheduler(js, quantum=4)
    for t, m, crit in reqs:
        jsched.submit(JRequest(tokens=t, max_new=m, accuracy_critical=crit))
    want = jsched.run()
    for backend in ("gather", "kernel"):
        tm = _manager(ProfileManager, stats) if managed else None
        ts = AdaptiveServer(tcfg, tp, teng, ServingConfig(
            paged_backend=backend, **scfg), manager=tm, device="cpu")
        sched = ContinuousScheduler(ts, quantum=4)
        for t, m, crit in reqs:
            sched.submit(Request(tokens=t, max_new=m, accuracy_critical=crit))
        got = sched.run()
        for g, w in zip(got, want):
            assert g["tokens"] == w["tokens"], backend
            assert g["profile_trace"] == w["profile_trace"]
            assert g["status"].value == w["status"].value == "completed"
        assert sched.events == jsched.events
        assert sched.admission_log == jsched.admission_log
        assert sched.allocator.used_blocks == 0
        assert sched.peak_used_blocks == jsched.peak_used_blocks
        if managed:
            assert tm.spent_j == jm.spent_j


def test_kv32_paged_pool_matches_reference(parts):
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    reqs = _requests("refill")
    scfg = dict(slots=64, max_batch=4, kv_bits=32, block_size=8)
    jsched = JScheduler(JServer(cfg, jp, jeng, JConfig(prefix_cache=False,
                                                       **scfg)), quantum=4)
    sched = ContinuousScheduler(AdaptiveServer(tcfg, tp, teng, ServingConfig(
        paged_backend="gather", **scfg), device="cpu"), quantum=4)
    assert sched.paged
    for t, m, crit in reqs:
        jsched.submit(JRequest(tokens=t, max_new=m, accuracy_critical=crit))
        sched.submit(Request(tokens=t, max_new=m, accuracy_critical=crit))
    want, got = jsched.run(), sched.run()
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"]
        assert g["status"].value == w["status"].value == "completed"
    assert sched.admission_log == jsched.admission_log
    assert sched.allocator.used_blocks == 0


def test_poll_completed_and_backpressure(parts):
    """A pool too small for everyone queues the rest (FIFO backpressure on
    blocks), polls hand each result over exactly once, and an impossible
    request fails at submit."""
    _, tcfg, _, tp, _, teng, _ = parts
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        slots=64, max_batch=4, block_size=8, pool_blocks=4), device="cpu")
    sched = ContinuousScheduler(srv, quantum=4)
    rng = np.random.default_rng(2)
    rids = [sched.submit(Request(tokens=rng.integers(0, 512, 9)
                                 .astype(np.int32), max_new=6))
            for _ in range(3)]
    assert sched.admit() == 2 and sched.pending == 1   # 2 blocks each
    seen = {}
    while sched.step():
        seen.update(sched.poll_completed())
    seen.update(sched.poll_completed())
    assert sorted(seen) == rids and sched.admission_log == rids
    assert all(len(r["tokens"]) == 6 for r in seen.values())
    assert sched.results == {} and sched.allocator.used_blocks == 0
    with pytest.raises(ValueError):
        sched.submit(Request(tokens=np.zeros(30, np.int32), max_new=20))


def test_launcher_profile_stats_on_both_specs(parts):
    """The port's launcher keeps the reference's energy model: on the
    TPU_V5E spec its ProfileStats equal the reference's; by default it
    models the H100."""
    cfg, _, jp, _, _, _, stats = parts
    profs = TP.paper_profiles(JT.quant_layer_names(cfg), inner_layers=[])
    n = JT.param_count(jp)
    assert [vars(s) for s in profile_stats(cfg, profs, n, hw=TPU_V5E)] == \
        [vars(s) for s in stats]
    h100 = profile_stats(cfg, profs, n)
    assert [s.name for s in h100] == [s.name for s in stats]
    assert h100[0].latency_s == 2.0 * n / 989e12
