"""The port's MoE family against the JAX reference on the smoke configs of
qwen2-moe-a2.7b and deepseek-moe-16b (2 layers, d_model 64, 4 query heads
over 2 KV heads of 16, 8 routed experts top-2 of width 32, one shared
expert, capacity factor 1.5, 2 dispatch groups), on the reference's weights
(``params_from_jax``); every input is drawn from a numpy seed. The
reference's forward, prefill and decode step are jitted once per arch.

Tolerances: ``moe_ffn``'s output and aux values within ``1e-5`` relative to
the output's largest magnitude (f32 einsums contract in another order than
XLA's); hidden states and collected K/V within ``1e-5``, logits within
``1e-4`` absolute, as the other family tests; native leaves bitwise.
Routing is held through the outputs: at a capacity factor low enough that
assignments drop, equal outputs mean equal per-expert ranks, and with a
zeroed router every probability ties and the port must pick the
reference's experts. Tokens, profile traces, billing events and admission
order equal.

* the configs, the quantization sites, the parameter tree and the active
  parameter count;
* ``moe_ffn`` with and without ``token_valid``, with drops, with a tied
  router, and the ``t % G`` refusal on both sides;
* ``forward`` (hidden, aux, collected K/V), ragged prefill + ``decode_step``
  with dead rows (``row_valid``) at the float and A8-W8 profiles, and
  prefill + decode = forward at capacity factor 8.0;
* ``ContinuousScheduler`` on the paged pool at kv16 and kv8 (both backends)
  and on the contiguous kv8 pool, and the static ``serve``'s power-of-two
  groups;
* ``to_native`` bitwise at W8 and W4, native prefill logits and native
  scheduler tokens;
* the refusals (speculation, prefix cache, chunked prefill, preemption,
  ``forward_extend``);
* the launcher's ``--arch qwen2-moe-a2.7b`` against the reference launcher.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.profiles import Profile as JProfile
from repro.core.profiles import paper_profiles
from repro.core.profiles import profile_table as jax_profile_table
from repro.launch import serve as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.native import to_native as jax_to_native
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
from repro.serving.scheduler import ContinuousScheduler as JScheduler
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.energy import TPU_V5E
from repro_torch.launch import serve as S
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.native import NATIVE_SITES, to_native
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_prefix import run_pair

TOL = 1e-5
LOGIT_TOL = 1e-4
ARCHS = ("qwen2-moe-a2.7b", "deepseek-moe-16b")
ARCH = ARCHS[0]
_PARTS: dict = {}
_JIT: dict = {}


def _parts(arch):
    """``(cfg, tcfg, jp, tp, jeng, teng, stats)`` of one arch, built once."""
    if arch not in _PARTS:
        cfg = get_smoke(arch)
        jp = jax.jit(JT.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        names = JT.quant_layer_names(cfg)
        profs = paper_profiles(names, inner_layers=[])
        jeng = AdaptiveEngine(tuple(profs), QuantIndex(names),
                              lambda *a: None)
        teng = TE.AdaptiveEngine(
            tuple(TP.paper_profiles(names, inner_layers=[])),
            TE.QuantIndex(names))
        stats = JL.profile_stats(cfg, profs, JT.param_count(jp))
        _PARTS[arch] = (cfg, C.get_smoke(arch), jp, tp, jeng, teng, stats)
    return _PARTS[arch]


@pytest.fixture(scope="module")
def parts():
    return _parts(ARCH)


def _jitted(name):
    """The reference's model entry points, jitted once per module."""
    if not _JIT:
        _JIT.update(
            forward=jax.jit(JT.forward, static_argnums=1,
                            static_argnames=("collect",)),
            prefill=jax.jit(JT.prefill, static_argnums=(1, 4),
                            static_argnames=("kv_bits",)),
            decode=jax.jit(JT.decode_step, static_argnums=1),
            moe_ffn=jax.jit(JM.moe_ffn, static_argnums=3))
    return _JIT[name]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0,
                               err_msg=what)


def _row(cfg, jeng, profile):
    if profile == "f32":
        names = JT.quant_layer_names(cfg)
        return np.asarray(jax_profile_table([JProfile.float32(names)],
                                            names)[0])
    return np.asarray(jeng.table)[{"A8-W8": 2, "A4-W4": 4}[profile]]


# ---------------------------------------------------------------- config

def _tree(t, prefix=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _tree(v, prefix + (k,))
    else:
        yield prefix, t


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_sites_and_param_tree_match_reference(arch):
    """Both configs field for field (full and smoke), the seven sites per
    layer, the paper profiles' table, and a parameter tree of the
    reference's keys, shapes and dtypes, with its total and active
    parameter counts."""
    cfg, tcfg, jp, _, jeng, teng, _ = _parts(arch)
    fields = [f for f in tcfg.__dataclass_fields__ if f != "moe"]
    for mine, ref in ((tcfg, cfg), (C.get_config(arch), jax_get_config(arch))):
        assert {f: getattr(mine, f) for f in fields} == \
            {f: getattr(ref, f) for f in fields}
        assert dataclasses.asdict(mine.moe) == dataclasses.asdict(ref.moe)
        assert T.quant_layer_names(mine) == JT.quant_layer_names(ref)
    assert T.sites(tcfg) == JT.sites(cfg) == (
        "qkv", "attn_out", "router", "expert_in", "expert_out", "shared_in",
        "shared_out")
    assert np.array_equal(np.asarray(jeng.table), teng.table)
    assert arch in C.ARCHS
    mine_tree = T.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    mine = dict(_tree(mine_tree))
    want = dict(_tree(jax.tree.map(np.asarray, jp)))
    assert sorted(mine) == sorted(want)
    assert set(mine_tree["layers"]) == {"qkv", "attn_out", "norm_attn",
                                        "moe", "norm_mlp"}
    for path, w in want.items():
        assert tuple(mine[path].shape) == w.shape, path
        assert str(mine[path].dtype) == f"torch.{w.dtype}", path
    assert T.param_count(mine_tree) == JT.param_count(jp)
    assert T.active_param_count(tcfg, mine_tree) == \
        JT.active_param_count(cfg, jp) < JT.param_count(jp)


def test_init_scale_of_the_routed_stacks():
    """The routed stacks are drawn at the reference's scales (``1/sqrt(d)``
    for ``w_in``, ``1/sqrt(f)`` for ``w_out``, 0.02 for the router)."""
    tcfg = dataclasses.replace(C.get_smoke(ARCH), n_layers=4)
    p = T.init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    moe = p["layers"]["moe"]
    for leaf, std in ((moe["w_in"], 64 ** -0.5), (moe["w_out"], 32 ** -0.5),
                      (moe["router"]["w"], 0.02)):
        assert abs(float(leaf.std()) / std - 1) < 0.05


# ---------------------------------------------------------------- moe_ffn

def _ffn_inputs(arch, seed, b=4, s=6):
    cfg, _, jp, tp, _, _, _ = _parts(arch)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    tv = rng.random((b, s)) > 0.3
    return cfg, jp["layers"], tp["layers"], x, tv


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _run_ffn(arch, x, tv, bits, mcfg, jmoe=None, tmoe=None):
    cfg, jlay, tlay, _, _ = _ffn_inputs(arch, 0)
    jmoe = _layer0(jlay["moe"]) if jmoe is None else jmoe
    tmoe = _layer0(tlay["moe"]) if tmoe is None else tmoe
    jy, ja = _jitted("moe_ffn")(jmoe, jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in bits.items()}, mcfg,
                        token_valid=None if tv is None else jnp.asarray(tv))
    ty, ta = M.moe_ffn(tmoe, torch.from_numpy(x), bits,
                       M.MoEConfig(**dataclasses.asdict(mcfg)),
                       token_valid=None if tv is None else
                       torch.from_numpy(tv))
    scale = float(np.abs(np.asarray(jy)).max())
    _close(ty, jy, TOL * scale, "y")
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(ta[key]), float(ja[key]),
                                   rtol=TOL, atol=0, err_msg=key)
    return ty


_BITS = {"A8-W8": (8, 8), "A4-W4": (4, 4), "f32": (32, 32)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", ["A8-W8", "A4-W4", "f32"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cf", [1.5, 0.3])
def test_moe_ffn_matches_reference(arch, bits, masked, cf):
    """``y`` and both aux values, with and without ``token_valid``, at the
    smoke capacity factor and at 0.3, where assignments drop: equal outputs
    there mean equal per-expert ranks (the masked tokens advance none)."""
    cfg, _, _, x, tv = _ffn_inputs(arch, seed=int(cf * 10) + masked)
    bw = {n: np.array(_BITS[bits], np.int32) for n in M.MOE_SITES}
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=cf)
    y = _run_ffn(arch, x, tv if masked else None, bw, mcfg)
    if cf < 1:               # the dispatch did drop: the output moved
        big = _run_ffn(arch, x, tv if masked else None, bw,
                       dataclasses.replace(mcfg, capacity_factor=8.0))
        assert float((y - big).abs().max()) > 1e-3


def test_masked_tokens_take_no_capacity():
    """A masked token neither takes a slot nor advances a rank: the live
    tokens' outputs equal those of the batch without the masked ones (one
    group, capacity tight enough that one extra assignment would drop a
    live one: ``cap = 1`` for the 8 tokens and for the 5 live ones alone)."""
    cfg, _, _, x, _ = _ffn_inputs(ARCH, seed=9, b=1, s=8)
    mcfg = dataclasses.replace(cfg.moe, groups=1, capacity_factor=0.5)
    bw = {n: np.array([32, 32], np.int32) for n in M.MOE_SITES}
    _, _, tlay, _, _ = _ffn_inputs(ARCH, 0)
    tmoe = _layer0(tlay["moe"])
    live = np.array([[1, 0, 1, 0, 1, 1, 0, 1]], bool)
    mc = M.MoEConfig(**dataclasses.asdict(mcfg))
    y, _ = M.moe_ffn(tmoe, torch.from_numpy(x), bw, mc,
                     token_valid=torch.from_numpy(live))
    solo, _ = M.moe_ffn(tmoe, torch.from_numpy(x[:, live[0]]), bw, mc)
    _close(y[:, live[0]], solo, TOL)
    unmasked, _ = M.moe_ffn(tmoe, torch.from_numpy(x), bw, mc)
    assert float((unmasked[:, live[0]] - solo).abs().max()) > 1e-3


def test_tied_router_routes_like_the_reference():
    """A zeroed router gives every expert the same probability: the
    reference's ``top_k`` takes the lowest indices, and so must the port
    (``torch.topk`` promises no order on ties). At capacity 1.0 the ranks
    then decide which assignments drop; outputs equal prove both picked
    the same experts in the same order."""
    cfg, jlay, tlay, x, tv = _ffn_inputs(ARCH, seed=5)
    jmoe, tmoe = _layer0(jlay["moe"]), _layer0(tlay["moe"])
    jmoe = dict(jmoe, router={"w": jnp.zeros_like(jmoe["router"]["w"])})
    tmoe = dict(tmoe, router={"w": torch.zeros_like(tmoe["router"]["w"])})
    bw = {n: np.array([8, 8], np.int32) for n in M.MOE_SITES}
    for masked in (False, True):
        _run_ffn(ARCH, x, tv if masked else None, bw,
                 dataclasses.replace(cfg.moe, capacity_factor=1.0),
                 jmoe=jmoe, tmoe=tmoe)
    vals, idx = M.top_k_stable(torch.full((3, 8), 0.125), 2)
    assert idx.tolist() == [[0, 1]] * 3 and vals.tolist() == [[0.125] * 2] * 3
    probs = torch.tensor([[0.1, 0.3, 0.2, 0.3, 0.1]])
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    got = M.top_k_stable(probs, 3)
    assert got[1].tolist() == np.asarray(want[1]).tolist() == [[1, 3, 2]]


def test_token_count_must_divide_groups_on_both_sides():
    cfg, jlay, tlay, x, _ = _ffn_inputs(ARCH, seed=1, b=3, s=5)
    bw = {n: np.array([8, 8], np.int32) for n in M.MOE_SITES}
    with pytest.raises(AssertionError, match="must divide groups"):
        JM.moe_ffn(_layer0(jlay["moe"]), jnp.asarray(x),
                   {k: jnp.asarray(v) for k, v in bw.items()}, cfg.moe)
    with pytest.raises(ValueError, match="tokens 15 must divide groups 2"):
        M.moe_ffn(_layer0(tlay["moe"]), torch.from_numpy(x), bw,
                  M.MoEConfig(**dataclasses.asdict(cfg.moe)))


# ---------------------------------------------------------------- model

def _ragged(cfg, seed):
    rng = np.random.default_rng(seed)
    plen = np.array([13, 4, 9, 16], np.int32)
    prompts = np.zeros((4, 16), np.int32)
    for j, n in enumerate(plen):
        prompts[j, 16 - n:] = rng.integers(0, cfg.vocab, n)
    return prompts, plen


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("profile", ["A8-W8", "f32"])
def test_forward_matches_reference(arch, profile):
    """Hidden states, the summed aux losses and the collected K/V of a
    ragged batch (pad tokens masked out of the dispatch)."""
    cfg, tcfg, jp, tp, jeng, _, _ = _parts(arch)
    prompts, plen = _ragged(cfg, seed=3)
    row = _row(cfg, jeng, profile)
    jh, jaux, ((jk, jv), _) = _jitted("forward")(
        jp, cfg, jnp.asarray(row), {"tokens": jnp.asarray(prompts),
                                     "prompt_len": jnp.asarray(plen)},
        collect=True)
    th, taux, (tk, tv) = T.forward(tp, tcfg, row,
                                   {"tokens": torch.from_numpy(prompts),
                                    "prompt_len": plen}, collect=True)
    for got, want, what in ((th, jh, "hidden"), (tk, jk, "k"), (tv, jv, "v")):
        assert tuple(got.shape) == want.shape, what
        _close(got, want, TOL, what)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=0)
    assert float(taux) > 0


@pytest.mark.parametrize("profile", ["A8-W8", "f32"])
def test_prefill_decode_with_dead_rows_matches_reference(parts, profile):
    """A ragged prefill of 13, 4, 9 and 16 tokens, then 6 decode steps at
    ``B = 4`` (2 groups of 2, capacity 1: the rows compete) with
    ``row_valid`` killing row 1 from step 2 and row 3 from step 4: logits
    within 1e-4 at every step, so a dead row never took a live row's
    slot."""
    cfg, tcfg, jp, tp, jeng, _, _ = parts
    prompts, plen = _ragged(cfg, seed=4)
    row = _row(cfg, jeng, profile)
    jl, jc = _jitted("prefill")(jp, cfg, jnp.asarray(row),
                                {"tokens": jnp.asarray(prompts),
                                 "prompt_len": jnp.asarray(plen)}, 32)
    tl, tc = T.prefill(tp, tcfg, row, {"tokens": torch.from_numpy(prompts),
                                       "prompt_len": plen}, 32)
    _close(tl, jl, LOGIT_TOL, "prefill")
    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for step in range(6):
        live = np.array([True, step < 2, True, step < 4])
        pos = plen + step
        jl, jc = _jitted("decode")(jp, cfg, jnp.asarray(row),
                                   jnp.asarray(tok), jnp.asarray(pos), jc,
                                   row_valid=jnp.asarray(live))
        tl, tc = T.decode_step(tp, tcfg, row, torch.from_numpy(tok),
                               torch.from_numpy(pos), tc,
                               row_valid=torch.from_numpy(live))
        _close(tl, jl, LOGIT_TOL, f"decode {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]


def test_prefill_decode_equals_forward():
    """The reference's relation (``tests/test_prefill_decode.py``) on the
    port, deepseek-moe's smoke config at capacity factor 8.0 (drop-free):
    prefill of 31 tokens into an f32 cache, one decode step against the
    forward over 32, float profile, ``rel < 5e-5``."""
    cfg, tcfg, _, tp, jeng, _, _ = _parts("deepseek-moe-16b")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=8.0))
    br = _row(cfg, jeng, "f32")
    toks = torch.from_numpy(np.random.default_rng(42).integers(
        0, tcfg.vocab, (2, 32)).astype(np.int32))
    hidden, _, _ = T.forward(tp, tcfg, br, {"tokens": toks})
    full = T._logits(tcfg, tp, br, hidden[:, -1:])[:, 0]
    _, caches = T.prefill(tp, tcfg, br, {"tokens": toks[:, :31]}, 36,
                          kv_bits=32)
    dec, _ = T.decode_step(tp, tcfg, br, toks[:, 31:],
                           torch.full((2,), 31, dtype=torch.int32), caches)
    rel = float((dec - full).abs().max()) / max(1e-9, float(full.abs().max()))
    assert rel < 5e-5, rel


def test_prequant_images_leave_the_routed_stacks_alone(parts):
    """The images cover ``router``/``shared_in``/``shared_out`` (and
    attention), never the routed stacks, as the reference's."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    mine = T.prequant_decode_weights(tp, tcfg, teng.table)
    ref = jax.jit(JT.prequant_decode_weights, static_argnums=1)(
        jp, cfg, jnp.asarray(jeng.table))
    assert set(mine[0]["layers"]["moe"]) == set(ref["layers"]["moe"]) == {
        "router", "shared_in", "shared_out"}
    for p in range(len(mine)):
        for site in ("router", "shared_in", "shared_out"):
            _close(mine[p]["layers"]["moe"][site]["wfq"],
                   np.asarray(ref["layers"]["moe"][site]["wfq"])[p], 0.0,
                   f"{site} profile {p}")


# ---------------------------------------------------------------- serving

def _scenario(reqs):
    def scenario(sched, Req):
        for t, m in reqs:
            sched.submit(Req(tokens=t, max_new=m))
        sched.run()
        return {"paged": sched.paged}
    return scenario


def _requests(cfg, seed, lens=((13, 9), (4, 9), (19, 12), (9, 5), (6, 7))):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for n, m in lens]


@pytest.mark.parametrize("kv_bits,paged", [(16, True), (8, True),
                                            (8, False)])
def test_scheduler_matches_reference(parts, kv_bits, paged):
    """Five requests on three rows (a wave of three, rows freed and
    reused, free rows dead in every segment's dispatch): tokens, traces,
    events and admission order equal the JAX scheduler's on both of the
    port's backends (``run_pair``), on the paged pool at kv16 and kv8 and
    on the contiguous kv8 pool."""
    cfg = parts[0]
    reqs = _requests(cfg, 70 + kv_bits + paged)
    scfg = dict(slots=64, max_batch=3, kv_bits=kv_bits, paged_kv=paged,
                prefix_cache=False)
    out = run_pair(parts, scfg, _scenario(reqs), managed=True)
    for sched in out.values():
        assert sched.paged == paged
        assert sched.admission_log == list(range(len(reqs)))


def test_static_serve_buckets_groups_to_powers_of_two(parts, monkeypatch):
    """Seven requests on ``max_batch=4``: groups of 4 and 3 both run one
    4-row ``generate`` shape (the reference's ``_next_pow2(max(2, n))``),
    the pad row dropped from the dispatch; the tokens equal the
    reference's serve."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(slots=32, max_batch=4),
                         device="cpu")
    shapes = []
    gen = srv.generate

    def recording(prompts, *a, **kw):
        shapes.append(prompts.shape)
        return gen(prompts, *a, **kw)

    monkeypatch.setattr(srv, "generate", recording)
    rng = np.random.default_rng(6)
    toks = [rng.integers(0, cfg.vocab, 6).astype(np.int32) for _ in range(7)]
    got = srv.serve([Request(tokens=t, max_new=3) for t in toks])
    assert shapes == [(4, 6), (4, 6)]
    want = JServer(cfg, jp, jeng, JConfig(slots=32, max_batch=4)).serve(
        [JRequest(tokens=t, max_new=3) for t in toks])
    for g, w in zip(got, want):
        assert g["tokens"] == [int(x) for x in w["tokens"]]
    # a lone request still pads to 2 rows
    shapes.clear()
    srv.serve([Request(tokens=toks[0], max_new=2)])
    assert shapes == [(2, 6)]


def test_full_groups_refuse_what_does_not_divide(parts):
    """The reference's ``t % G`` assertion at the full config's 16 groups
    (on the smoke widths): a static group of 2 rows x 6 tokens and a
    one-row admission wave of 8 tokens (a 5-token prompt in the
    scheduler's smallest bucket) are refused by both packages, the
    reference by its assertion, the port by a ``ValueError``."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    jcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            groups=16))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             groups=16))
    toks = np.arange(6, dtype=np.int32)
    with pytest.raises(AssertionError, match="must divide groups 16"):
        JServer(jcfg, jp, jeng, JConfig(slots=32, max_batch=2)).serve(
            [JRequest(tokens=toks, max_new=2)])
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(slots=32,
                                                       max_batch=2),
                         device="cpu")
    with pytest.raises(ValueError, match="tokens 12 must divide groups 16"):
        srv.serve([Request(tokens=toks, max_new=2)])
    js = JScheduler(JServer(jcfg, jp, jeng, JConfig(slots=32, max_batch=2)))
    js.submit(JRequest(tokens=toks[:5], max_new=2))
    with pytest.raises(AssertionError, match="must divide groups 16"):
        js.run()
    ts = ContinuousScheduler(srv)
    ts.submit(Request(tokens=toks[:5], max_new=2))
    with pytest.raises(ValueError, match="tokens 8 must divide groups 16"):
        ts.run()
    # a 16-token bucket divides: the same prompt in a wider bucket serves
    ts = ContinuousScheduler(srv, prefill_bucket=16)
    ts.submit(Request(tokens=toks[:5], max_new=2))
    assert len(ts.run()[0]["tokens"]) == 2


# ---------------------------------------------------------------- native

def _jax_native(jp, w_bits):
    return jax.jit(jax_to_native, static_argnums=1)(jp, w_bits)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("w_bits", [8, 4])
def test_to_native_moe_leaves_bitwise(arch, w_bits):
    """The routed stacks become ``QTensor`` leaves with per-layer,
    per-output-channel scales ``[L, 1, 1, N]``; ``router``, ``shared_in``
    and ``shared_out`` become ``{"wq"}`` linears: data and scales bitwise
    the reference's."""
    _, _, jp, tp, _, _, _ = _parts(arch)
    jn = params_from_jax(jax.tree.map(np.asarray, _jax_native(jp, w_bits)),
                         device="cpu")
    tn = to_native(tp, w_bits)
    moe, jmoe = tn["layers"]["moe"], jn["layers"]["moe"]
    for leaf in ("w_in", "w_out"):
        g, w = moe[leaf], jmoe[leaf]
        assert (g.bits, g.orig_last) == (w.bits, w.orig_last)
        assert torch.equal(g.data, w.data) and torch.equal(g.scale, w.scale)
        assert tuple(g.scale.shape) == (2, 1, 1, g.orig_last)
    for site in ("router", "shared_in", "shared_out"):
        g, w = moe[site]["wq"], jmoe[site]["wq"]
        assert set(moe[site]) == {"wq"}
        assert torch.equal(g.data, w.data) and torch.equal(g.scale, w.scale)
    assert {"router", "shared_in", "shared_out"} <= set(NATIVE_SITES)
    assert T.param_count(tn) == T.param_count(jn)


@pytest.mark.parametrize("w_bits", [8, 4])
def test_native_prefill_logits_match_reference(parts, w_bits):
    """Native prefill logits of a ragged batch at A8 (f32 compute on both
    sides: the routed stacks dequantized, then the batched products) within
    1e-4; each forward dequantizes both routed stacks of every layer,
    counted on their own counter."""
    cfg, tcfg, jp, tp, jeng, _, _ = parts
    prompts, plen = _ragged(cfg, seed=8)
    row = _row(cfg, jeng, "A8-W8")
    jl, _ = _jitted("prefill")(_jax_native(jp, w_bits), cfg,
                               jnp.asarray(row),
                               {"tokens": jnp.asarray(prompts),
                                "prompt_len": jnp.asarray(plen)}, 32)
    M.routed_dequant.calls = 0
    tl, _ = T.prefill(to_native(tp, w_bits), tcfg, row,
                      {"tokens": torch.from_numpy(prompts),
                       "prompt_len": plen}, 32)
    assert M.routed_dequant.calls == 2 * tcfg.n_layers
    _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("w_bits", [8, 4])
def test_native_scheduler_matches_reference(parts, w_bits):
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    nparts = (cfg, tcfg, _jax_native(jp, w_bits), to_native(tp, w_bits),
              jeng, teng, stats)
    reqs = _requests(cfg, 80 + w_bits, lens=((11, 7), (5, 9), (17, 6)))
    run_pair(nparts, dict(slots=64, max_batch=2, prefix_cache=False),
             _scenario(reqs), managed=True)


# ---------------------------------------------------------------- refusals

def test_refusals(parts):
    """Speculation and preemption are refused by both servers; the prefix
    cache and chunked prefill stay off; ``forward_extend`` and
    ``decode_step_spec`` assert, as the reference's."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    for kw in (dict(speculate=True), dict(preemption=True)):
        with pytest.raises(ValueError):
            JServer(cfg, jp, jeng, JConfig(slots=64, **kw))
        with pytest.raises(ValueError):
            AdaptiveServer(tcfg, tp, teng, ServingConfig(slots=64, **kw),
                           device="cpu")
    assert not T.supports_prefix_sharing(tcfg)
    assert not T.supports_speculation(tcfg)
    assert not JT.supports_prefix_sharing(cfg)
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        slots=64, max_batch=2, prefill_chunk=8), device="cpu")
    assert not srv.prefix_sharing and srv.chunk_tokens is None
    assert not srv.can_restore
    sched = ContinuousScheduler(srv, quantum=4)
    assert sched.paged and sched.registry is None and sched.chunk is None
    z = torch.zeros((2, 1, 4, 1, 16))
    with pytest.raises(AssertionError):
        T.forward_extend(tp, tcfg, teng.table[0],
                         {"tokens": torch.zeros((1, 2), dtype=torch.int32),
                          "prompt_len": np.array([2])},
                         z, z, torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(AssertionError):
        T.decode_step_spec(tp, tcfg, teng.table[0],
                           torch.zeros((1, 2), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.int32),
                           sched._caches)


# ---------------------------------------------------------------- launcher

@pytest.mark.parametrize("continuous", [False, True])
def test_launcher_serves_qwen2_moe_like_the_reference(monkeypatch, capsys,
                                                      continuous):
    """``--arch qwen2-moe-a2.7b --device cpu`` (static groups, and the paged
    pool with ``--continuous``), both launchers on one set of weights and
    on the reference's energy model (``TPU_V5E``): every request's tokens
    and profile trace equal the reference launcher's."""
    from repro.serving import engine as JE
    from repro.serving import scheduler as JS
    jp, tp = _parts(ARCH)[2], _parts(ARCH)[3]
    argv = ["--arch", ARCH, "--requests", "3", "--max-new", "5"]
    argv += ["--continuous"] if continuous else []
    want: dict = {}

    class Recording(JS.ContinuousScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            want["sched"] = self

    jserve = JE.AdaptiveServer.serve

    def recording_serve(self, reqs):
        want["results"] = jserve(self, reqs)
        return want["results"]

    monkeypatch.setattr(JS, "ContinuousScheduler", Recording)
    monkeypatch.setattr(JE.AdaptiveServer, "serve", recording_serve)
    monkeypatch.setattr(JT, "init_params", lambda *a, **kw: jp)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    JL.main()
    got: dict = {}
    pserve, pstats = S.serve, S.profile_stats

    def port_serve(*a, **kw):
        got.update(pserve(*a, **kw))
        return got

    monkeypatch.setattr(S, "serve", port_serve)
    monkeypatch.setattr(S, "profile_stats",
                        lambda *a: pstats(*a, hw=TPU_V5E))
    monkeypatch.setattr(T, "init_params", lambda *a, **kw: tp)
    capsys.readouterr()
    S.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}-smoke on cpu" in out
    assert all(f"req{i}: 5 tokens" in out for i in range(3))
    ref = ([want["sched"].results[i] for i in range(3)] if continuous
           else want["results"])
    for g, w in zip(got["results"], ref):
        assert g["tokens"] == [int(x) for x in w["tokens"]]
        assert g["profile_trace"] == w["profile_trace"]
