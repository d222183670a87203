"""The static path's prefill and the stepwise oracle's step on CUDA graphs
(``StaticGraphs`` and ``StepGraphs`` in ``repro_torch/serving/graphs.py``)
on the CPU, where no graph is captured: the capture stand-in returns the
step itself as its replay, so the staging, the kept cache and the
bookkeeping run eagerly.

* a ragged static ``serve`` (two groups, pad rows, profile switches) at
  kv16, kv8 and kv4 equals the JAX ``serve``: tokens, traces and the
  ledger; prefill captures = the distinct exact keys, and a second serve
  of the same groups captures nothing (``assert_static_executables``);
* qwen2-moe's 7 requests of 6 tokens on ``max_batch=4`` (groups of 4 and
  3, both padded to 4 rows): one prefill capture and one graph set, the
  JAX tokens, and the reference's one ``_prefill`` executable;
* the prefill graph writes its group shape's kept cache bitwise as the
  eager prefill writes a new cache, over a cache an earlier, longer group
  left behind (granite kv16/kv8/kv4, hymba's window ring and SSM rows,
  mamba2's SSM rows, qwen2-moe's pad rows);
* hymba across its ring wrap and mamba2: the graphed serve equals the
  eager one;
* a uniform ``generate`` (no ``prompt_len``) equals JAX's ``generate``,
  under a key of its own;
* the graphed ``generate_stepwise`` equals JAX's on tokens, trace and the
  ledger, one step capture per profile id;
* nothing copies the kept cache whole, and its leaves are the ones the
  prefill and decode graphs were captured on;
* rebinding the images starts a new lifetime of the prefill and step
  graphs; ``graphs=True`` on the CPU without a capture raises.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.manager import ProfileManager as JManager
from repro.core.profiles import paper_profiles
from repro.launch.serve import profile_stats as jax_profile_stats
from repro.models import transformer as JT
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
import repro_torch.configs as C
from repro_torch.analysis.tracker import (assert_static_executables,
                                          static_captures)
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.manager import ProfileManager
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import graphs as G
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from torch_threads import _one_thread  # noqa: F401

# (prompt length, max_new): two static groups of max_batch=4 (maxlen 9 and
# 17), the second padded by two rows; max_new 1 finishes at its prefill
REQS = [(4, 6), (9, 3), (17, 8), (6, 1), (12, 5), (7, 9)]


def stand_in(step, stream, pool):
    """A capture that records nothing: the step is its own replay."""
    return step


@pytest.fixture(scope="module")
def parts():
    """``get(arch)``: the JAX config, weights and engine, the port's, and
    the launcher's profile stats, built once per arch for the module."""
    cache = {}

    def get(arch="granite-3-2b"):
        if arch not in cache:
            cfg = get_smoke(arch)
            jp = JT.init_params(cfg, jax.random.PRNGKey(0))
            tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
            names = JT.quant_layer_names(cfg)
            jeng = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                                  QuantIndex(names), lambda *a: None)
            teng = TE.AdaptiveEngine(
                tuple(TP.paper_profiles(names, inner_layers=[])),
                TE.QuantIndex(names))
            stats = jax_profile_stats(cfg, jeng.profiles, JT.param_count(jp))
            cache[arch] = (cfg, C.get_smoke(arch), jp, tp, jeng, teng, stats)
        return cache[arch]
    return get


def _manager(cls, stats, budget=12):
    """A budget of ``budget`` full-power inferences: the ledger crosses
    into saver mode part-way, so profiles switch."""
    return cls(stats, accuracy_target=0.985, accuracy_floor=0.95,
               budget_j=stats[0].energy_j * budget, low_energy=0.5)


def _requests(cfg, Req, reqs=REQS, seed=7):
    rng = np.random.default_rng(seed)
    return [Req(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=m, accuracy_critical=(i % 3 == 0))
            for i, (n, m) in enumerate(reqs)]


def _server(parts, arch="granite-3-2b", managed=True, **scfg):
    """A port server on the CPU (K4's plain version at kv8) with a fresh
    manager, on the JAX weights."""
    _, tcfg, _, tp, _, teng, stats = parts(arch)
    scfg = dict(dict(slots=64, max_batch=4, prefix_cache=False,
                     paged_backend="kernel"), **scfg)
    return AdaptiveServer(tcfg, tp, teng, ServingConfig(**scfg),
                          manager=_manager(ProfileManager, stats)
                          if managed else None, device="cpu")


def _jserver(parts, arch="granite-3-2b", managed=True, **scfg):
    cfg, _, jp, _, jeng, _, stats = parts(arch)
    scfg = dict(dict(slots=64, max_batch=4, prefix_cache=False), **scfg)
    return JServer(cfg, jp, jeng, JConfig(**scfg),
                   manager=_manager(JManager, stats) if managed else None)


def _leaves(caches: dict) -> list:
    return [(k, f.name, getattr(c, f.name)) for k, c in sorted(caches.items())
            for f in dataclasses.fields(c)
            if isinstance(getattr(c, f.name), torch.Tensor)]


def _same_caches(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for (k, name, x), (_, _, y) in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), (k, name)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_ragged_serve_matches_reference(parts, kv_bits):
    """The graphed ragged serve equals the JAX serve under profile
    switches; each group's prefill replays the graph of its exact key,
    captured once; a second serve of the same groups captures nothing and
    gives the same tokens, as does the eager serve."""
    cfg = parts()[0]
    js = _jserver(parts, kv_bits=kv_bits)
    want = js.serve(_requests(cfg, JRequest))
    srv = _server(parts, kv_bits=kv_bits)
    m0 = copy.deepcopy(srv.manager)
    got = srv.serve(_requests(cfg, Request), capture=stand_in)
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"]
        assert g["profile_trace"] == w["profile_trace"]
    assert srv.manager.spent_j == js.manager.spent_j
    assert len({p for r in got for p in r["profile_trace"]}) > 1
    assert_static_executables(srv)
    caps = static_captures(srv)
    (g, _), = srv.static_graphs.values()
    assert sorted(g.prefill.used) == sorted(caps[(4, 64, kv_bits)]["prefill"])
    assert {(k[0], k[2], k[3]) for k in g.prefill.used} == {
        ("static", 4, 9), ("static", 4, 17)}
    for _ in range(2):
        srv.manager = copy.deepcopy(m0)
        again = srv.serve(_requests(cfg, Request), capture=stand_in)
        assert again == got
        assert static_captures(srv) == caps
    assert g.prefill.replays == 4 and g.prefill.lifetimes == 1
    srv.manager = copy.deepcopy(m0)
    assert srv.serve(_requests(cfg, Request), graphs=False) == got


def test_moe_group_bucketing_bounds_executables(parts):
    """The port of the reference's ``test_moe_group_bucketing_bounds_
    executables``: qwen2-moe's groups of 4 and 3 requests pad to one
    4-row bucket, so one prefill graph and one graph set serve both (the
    reference: one ``_prefill`` executable); pad rows leave the capacity
    dispatch through ``prompt_len`` 0; the tokens equal the JAX tokens."""
    arch = "qwen2-moe-a2.7b"
    cfg = parts(arch)[0]
    reqs = [(6, 3)] * 7
    js = _jserver(parts, arch, managed=False, slots=32)
    want = js.serve(_requests(cfg, JRequest, reqs, seed=6))
    assert js._prefill._cache_size() == 1
    srv = _server(parts, arch, managed=False, slots=32)
    got = srv.serve(_requests(cfg, Request, reqs, seed=6), capture=stand_in)
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    assert all(len(r["tokens"]) == 3 for r in got)
    assert static_captures(srv) == {(4, 32, 16): {
        "prefill": [("static", 0, 4, 6, 0)], "decode": [0], "step": []}}
    (g, _), = srv.static_graphs.values()
    assert g.prefill.replays == 1
    assert srv.serve(_requests(cfg, Request, reqs, seed=6),
                     graphs=False) == got


PREFILL_CASES = [("granite-3-2b", dict(kv_bits=16)),
                 ("granite-3-2b", dict(kv_bits=8)),
                 ("granite-3-2b", dict(kv_bits=4)),
                 ("hymba-1.5b", dict(kv_bits=8)),
                 ("mamba2-130m", dict()),
                 ("qwen2-moe-a2.7b", dict(kv_bits=16))]


@pytest.mark.parametrize("arch,scfg", PREFILL_CASES,
                         ids=[f"{a}-{s}" for a, s in PREFILL_CASES])
def test_prefill_graph_writes_the_eager_cache(parts, arch, scfg):
    """A group's prefill graph leaves the kept cache bitwise what the eager
    prefill's new cache holds — every slot (hymba's ring holds the window
    of a 40-token prompt), the int-KV scales, the SSM rows, the MoE pad
    rows — after a longer group filled it first; the first tokens and
    ``pos0`` land in the decode's carries."""
    srv = _server(parts, arch, managed=False, **scfg)
    cfg = srv.cfg
    g = srv._static_set(4, stand_in)
    rng = np.random.default_rng(3)
    long = rng.integers(0, cfg.vocab, (4, 40)).astype(np.int32)
    g.prefill_group(1, long, np.array([40, 33, 12, 40]))
    prompts = rng.integers(0, cfg.vocab, (4, 10)).astype(np.int32)
    plen = np.array([10, 0, 7, 3])                  # row 1: a pad row
    for pid, pl in ((2, plen), (0, None)):
        tok0 = g.prefill_group(pid, prompts, pl)
        logits, want = srv._prefill(pid, prompts, srv.scfg.slots, pl)
        _same_caches(g.kept, want)
        assert torch.equal(tok0, logits.argmax(-1).to(torch.int32))
        assert torch.equal(g.buf["tok"], tok0)
        assert g.buf["pos"].tolist() == (list(plen) if pl is not None
                                         else [10] * 4)
    assert g.prefill.captured == [("static", 1, 4, 40, 0),
                                  ("static", 2, 4, 10, 0),
                                  ("uniform", 0, 4, 10, 0)]


@pytest.mark.parametrize("arch,scfg", [("hymba-1.5b", dict(kv_bits=8)),
                                       ("mamba2-130m", dict())],
                         ids=["hymba", "mamba2"])
def test_hybrid_and_ssm_stacks_equal_eager(parts, arch, scfg):
    """hymba (window 16: prompts of up to 20 tokens plus 9 new wrap the
    ring) and mamba2, managed: the graphed serve gives the eager serve's
    tokens and traces, and captures each prefill key and profile id
    once."""
    srv = _server(parts, arch, **scfg)
    cfg = srv.cfg
    reqs = [(20, 9), (13, 6), (5, 8), (17, 4), (9, 7)]
    m0 = copy.deepcopy(srv.manager)
    eager = srv.serve(_requests(cfg, Request, reqs), graphs=False)
    srv.manager = copy.deepcopy(m0)
    got = srv.serve(_requests(cfg, Request, reqs), capture=stand_in)
    assert got == eager
    if cfg.sliding_window:                      # hymba: the ring wraps
        assert max(n + m for n, m in reqs) > cfg.sliding_window
    assert_static_executables(srv)
    (g, kept), = srv.static_graphs.values()
    assert len(g.prefill.captured) == 2 and g.captured
    assert "ssm" in kept


def test_uniform_generate_matches_reference(parts):
    """A uniform batch (no ``prompt_len``) runs under its own key,
    ``("uniform", ...)``, beside the ragged key of the same shape, and
    equals JAX's ``generate`` (tokens, trace, ledger)."""
    cfg = parts()[0]
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab, (4, 7)).astype(np.int32)
    js = _jserver(parts, kv_bits=8)
    want = js.generate(prompts, 9)
    srv = _server(parts, kv_bits=8)
    got = srv.generate(prompts, 9, capture=stand_in)
    assert got["tokens"] == [list(map(int, r)) for r in want["tokens"]]
    assert got["profile_trace"] == want["profile_trace"]
    assert srv.manager.spent_j == js.manager.spent_j
    srv.generate(prompts, 9, prompt_len=np.full((4,), 7), capture=stand_in)
    (g, _), = srv.static_graphs.values()
    kinds = {k[0] for k in g.prefill.captured}
    assert kinds == {"uniform", "static"}
    assert_static_executables(srv)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_stepwise_matches_reference(parts, kv_bits):
    """The graphed stepwise oracle (the uniform prefill key, then one step
    graph per profile id, the host reading its logits) equals JAX's
    ``generate_stepwise`` on tokens, trace and the ledger."""
    cfg = parts()[0]
    prompts = np.random.default_rng(kv_bits).integers(
        0, cfg.vocab, (3, 7)).astype(np.int32)
    js = _jserver(parts, kv_bits=kv_bits)
    want = js.generate_stepwise(prompts, 9)
    srv = _server(parts, kv_bits=kv_bits)
    m0 = copy.deepcopy(srv.manager)
    got = srv.generate_stepwise(prompts, 9, capture=stand_in)
    assert got["tokens"] == [list(map(int, r)) for r in want["tokens"]]
    assert got["profile_trace"] == want["profile_trace"]
    assert srv.manager.spent_j == js.manager.spent_j
    names = srv.engine.profile_names
    used = {names.index(p) for p in got["profile_trace"][1:]}
    assert len(set(got["profile_trace"])) > 1
    caps = static_captures(srv)[(3, 64, kv_bits)]
    assert sorted(caps["step"]) == sorted(used) and caps["decode"] == []
    assert caps["prefill"] == [("uniform", names.index(
        got["profile_trace"][0]), 3, 7, 0)]
    (g, _), = srv.static_graphs.values()
    assert g.steps.replays == 8 - len(used)
    srv.manager = m0
    assert srv.generate_stepwise(prompts, 9, graphs=False) == got


class _WholeWrites(TorchDispatchMode):
    """Records every in-place op whose destination is a whole tensor of
    ``leaves`` (same storage start, same size)."""

    def __init__(self, leaves):
        super().__init__()
        self.leaves = {(x.data_ptr(), x.numel()) for x in leaves}
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dst = args[0] if args else None
        if (func._schema.name.endswith("_") and isinstance(dst, torch.Tensor)
                and (dst.data_ptr(), dst.numel()) in self.leaves):
            self.hits.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def test_the_kept_cache_is_never_copied(parts):
    """Over graphed generates nothing copies a kept leaf whole (the prefill
    writes each layer, the decode one slot a step), and the prefill
    graphs, the decode graphs and the kept cache share the same leaves."""
    srv = _server(parts, kv_bits=8, managed=False)
    cfg = srv.cfg
    rng = np.random.default_rng(4)
    g = srv._static_set(4, stand_in)
    leaves = [x for _, _, x in _leaves(g.kept)]
    ptrs = [x.data_ptr() for x in leaves]
    for s in (11, 6, 11):
        prompts = rng.integers(0, cfg.vocab, (4, s)).astype(np.int32)
        with _WholeWrites(leaves) as mode:
            srv.generate(prompts, 6, prompt_len=np.array([s, s - 2, 3, s]),
                         capture=stand_in)
        assert mode.hits == []
    assert [x.data_ptr() for _, _, x in _leaves(g.kept)] == ptrs
    bound = G._leaves(g.kept)
    assert g._pool_leaves == bound
    assert g.prefill._pool_leaves[:len(bound)] == bound
    assert g.prefill.captured == [("static", 0, 4, 11, 0),
                                  ("static", 0, 4, 6, 0)]


def test_rebinding_starts_new_prefill_and_step_lifetimes(parts):
    """Rebinding the server's images starts a new lifetime of the whole
    set: the prefill key and the step's profile id are captured again."""
    srv = _server(parts, kv_bits=16, managed=False)
    prompts = np.ones((4, 5), np.int32)
    srv.generate(prompts, 4, capture=stand_in)
    srv.generate_stepwise(prompts, 3, capture=stand_in)
    (g, _), = srv.static_graphs.values()
    images = srv.prequant
    srv.prequant = list(images)
    srv.generate_stepwise(prompts, 3, capture=stand_in)
    assert g.prefill.lifetimes == g.steps.lifetimes == g.lifetimes == 2
    assert g.prefill.captured == [("uniform", 0, 4, 5, 0)]
    assert g.steps.captured == [0] and g.captured == []
    srv.generate(prompts, 4, capture=stand_in)
    assert g.lifetimes == 2 and g.captured == [0]
    assert_static_executables(srv)


def test_graphs_refuse_the_cpu(parts):
    srv = _server(parts, kv_bits=16, managed=False)
    prompts = np.ones((4, 5), np.int32)
    with pytest.raises(ValueError, match="CUDA"):
        srv.generate(prompts, 3, graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        srv.generate_stepwise(prompts, 3, graphs=True)
    assert not srv.static_graphs
    assert srv.generate_stepwise(prompts, 3) == srv.generate_stepwise(
        prompts, 3, graphs=False)
