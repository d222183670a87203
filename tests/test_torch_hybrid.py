"""The port's hybrid family (hymba) against the JAX reference on the
hymba-1.5b smoke config (2 layers, d_model 64, 8 query heads over 2 KV heads
of 16, a sliding window of 16, 8 SSD heads of 16, d_state 16, chunk 16), on
the reference's weights (``params_from_jax``); every input is drawn from a
numpy seed. The reference's forward, prefill and decode step are jitted
(only XLA's lowering gives the fma form of the int-KV scale).

Tolerances: hidden states, collected K/V and SSM states within ``1e-5``
(absolute; f32 einsums contract in another order than XLA's), logits within
``1e-4``, as ``test_torch_ssm.py``; int-KV scales within ``1e-6`` relative
(the two forwards' K/V, and with them each row's amax, differ in the last
f32 bits); ``token_idx`` and the int-KV ints bitwise; a bf16 attention
output within one bf16 step (``8e-3`` at the inputs' magnitudes). Tokens,
profile traces, billing events and admission order equal.

* the config, the quantization sites and the paper profiles' table;
* the parameter tree of ``init_params``;
* ``swa_attention`` at S 40 with a ragged ``kv_valid`` (f32 and bf16) and
  against the masked ``gqa_attention``;
* ``forward`` at S 8, 17 and 40 (ragged, past the window: the
  block-skipping path) at A8-W8, Mixed and f32, and under a ``kv_sched`` row;
* prefill + ``decode_step`` across two ring wraps at kv16, kv8 and kv4;
* the caches' shapes at ``eff = min(slots, window)`` and the paged block size;
* a ragged static serve against solo and against the reference, and K4
  reached on every layer of a kv8 serve whose ring wraps;
* ``ContinuousScheduler`` on the paged pool (both backends) at kv16 and kv8
  with rows reused after their first occupants retire, and against the
  contiguous pool;
* ``to_native`` at W8 and W4 bitwise, and the W4 refusal of an odd vocab;
* the refusals (speculation, preemption, prefix cache, chunked prefill, a
  durability cut with live rows);
* the launcher's ``--arch hymba-1.5b`` on the CPU against the reference
  launcher.
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
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.native import to_native as jax_to_native
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.energy import TPU_V5E
from repro_torch.core.manager import ProfileManager
from repro_torch.kernels import qkv_attention as QK
from repro_torch.launch import serve as S
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.native import NATIVE_SITES, to_native
from repro_torch.serving import durability as D
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_prefix import _manager, run_pair
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def parts():
    cfg = get_smoke(ARCH)
    jp = jax.jit(JT.init_params, static_argnums=0)(cfg,
                                                    jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    names = JT.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    jeng = AdaptiveEngine(tuple(profs), QuantIndex(names), lambda *a: None)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names, inner_layers=[])),
                             TE.QuantIndex(names))
    stats = JL.profile_stats(cfg, profs, JT.param_count(jp))
    return cfg, C.get_smoke(ARCH), jp, tp, jeng, teng, stats


@pytest.fixture(scope="module")
def jitted():
    """The reference's model entry points, jitted once per module."""
    return {"forward": jax.jit(JT.forward, static_argnums=1,
                               static_argnames=("collect",)),
            "prefill": jax.jit(JT.prefill, static_argnums=(1, 4),
                               static_argnames=("kv_bits",)),
            "decode": jax.jit(JT.decode_step, static_argnums=1)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0,
                               err_msg=what)


def _f32_row(cfg):
    names = JT.quant_layer_names(cfg)
    return np.asarray(jax_profile_table([JProfile.float32(names)], names)[0])


# ---------------------------------------------------------------- config

def test_config_sites_and_profiles_match_reference(parts):
    cfg, tcfg, _, _, jeng, teng, _ = parts
    fields = [f for f in tcfg.__dataclass_fields__ if f != "ssm"]
    for mine, ref in ((tcfg, cfg), (C.get_config(ARCH), jax_get_config(ARCH))):
        assert {f: getattr(mine, f) for f in fields} == \
            {f: getattr(ref, f) for f in fields}
        assert dataclasses.asdict(mine.ssm) == dataclasses.asdict(ref.ssm)
        assert T.quant_layer_names(mine) == JT.quant_layer_names(ref)
    assert T.sites(tcfg) == JT.sites(cfg) == ("qkv", "attn_out", "ssm_in",
                                              "ssm_out", "mlp_in", "mlp_out")
    assert len(T.quant_layer_names(C.get_config(ARCH))) == 2 + 32 * 6
    assert np.array_equal(np.asarray(jeng.table), teng.table)
    assert (tcfg.has_attn, tcfg.has_ssm, tcfg.has_mlp) == \
        (cfg.has_attn, cfg.has_ssm, cfg.has_mlp) == (True, True, True)
    assert ARCH in C.ARCHS


def _tree(t, prefix=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _tree(v, prefix + (k,))
    else:
        yield prefix, t


def test_param_tree_matches_reference(parts):
    """Same keys, shapes and dtypes as the reference's ``init_params`` (the
    hybrid layer's ``qkv``, ``attn_out``, ``norm_attn``, ``ssm`` without
    ``norm_ssm``, the two output norms, ``mlp``, ``norm_mlp``, and the
    untied head); the leaves the reference does not draw at random equal
    its values to an f32 ulp."""
    cfg, tcfg, jp, _, _, _, _ = parts
    mine_tree = T.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    mine = dict(_tree(mine_tree))
    want = dict(_tree(jax.tree.map(np.asarray, jp)))
    assert sorted(mine) == sorted(want)
    assert set(mine_tree["layers"]) == {
        "qkv", "attn_out", "norm_attn", "ssm", "norm_attn_out",
        "norm_ssm_out", "mlp", "norm_mlp"}
    for path, w in want.items():
        got = mine[path]
        assert tuple(got.shape) == w.shape and str(got.dtype) == \
            f"torch.{w.dtype}", path
        if path[-1] in ("A_log", "D", "dt_bias", "conv_b", "norm_g", "g"):
            np.testing.assert_allclose(got.numpy(), w, rtol=2e-7, atol=0,
                                       err_msg=str(path))
    assert T.param_count(mine_tree) == JT.param_count(jp)


# ---------------------------------------------------------------- attention

def _swa_inputs(dtype):
    rng = np.random.default_rng(3)
    b, s, hkv, hg, d = 3, 40, 2, 4, 16
    q = rng.standard_normal((b, s, hkv * hg, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in "kv")
    lens = np.array([40, 23, 7])
    valid = np.arange(s)[None] >= (s - lens)[:, None]
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx = [jnp.asarray(x).astype(jd) for x in (q, k, v)]
    tx = [torch.from_numpy(x).to(td) for x in (q, k, v)]
    return jx, tx, valid


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swa_attention_matches_reference(dtype):
    """Window 16, query blocks of 32 over S 40 (one padded block), rows of
    40, 23 and 7 real tokens: the reference's own arithmetic (q scaled in
    f32), so bf16 inputs agree within one bf16 step, f32 within 1e-5."""
    jx, tx, valid = _swa_inputs(dtype)
    want = JA.swa_attention(*jx, window=16, block_q=32,
                            kv_valid=jnp.asarray(valid))
    got = A.swa_attention(*tx, window=16, block_q=32,
                          kv_valid=torch.from_numpy(valid))
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    _close(got, want, 8e-3 if dtype == "bf16" else TOL)


def test_swa_attention_equals_masked_gqa_attention():
    """On every real query row, the block-skipping form equals the masked
    blockwise one at the same window (f32)."""
    _, tx, valid = _swa_inputs("f32")
    kv_valid = torch.from_numpy(valid)
    got = A.swa_attention(*tx, window=16, block_q=32, kv_valid=kv_valid)
    want = A.gqa_attention(*tx, causal=True, window=16, block_k=32,
                           kv_valid=kv_valid)
    _close(got[kv_valid], want[kv_valid], TOL)


# ---------------------------------------------------------------- forward

def _batch(cfg, s: int, seed: int):
    """Tokens ``[3, s]``; at S 40 a ragged batch of 40, 23 and 7 tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (3, s)).astype(np.int32)
    plen = np.array([40, 23, 7], np.int32) if s == 40 else None
    return toks, plen


def _row(cfg, jeng, profile):
    if profile == "f32":
        return _f32_row(cfg)
    return np.asarray(jeng.table)[{"A8-W8": 2, "Mixed": 5}[profile]]


@pytest.mark.parametrize("profile", ["A8-W8", "Mixed", "f32"])
@pytest.mark.parametrize("s", [8, 17, 40])
def test_forward_matches_reference(parts, jitted, s, profile):
    """Hidden states and the collected ``((k, v), (h, conv_tail))``; S 17
    and 40 exceed the window of 16, so every layer takes the block-skipping
    prefill (with the ragged mask at S 40)."""
    cfg, tcfg, jp, tp, jeng, _, _ = parts
    toks, plen = _batch(cfg, s, seed=s)
    row = _row(cfg, jeng, profile)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    if plen is not None:
        jb["prompt_len"], tb["prompt_len"] = jnp.asarray(plen), plen
    jh, _, ((jk, jv), (jhs, jtail)) = jitted["forward"](
        jp, cfg, jnp.asarray(row), jb, collect=True)
    th, _, ((tk, tv), (ths, ttail)) = T.forward(tp, tcfg, row, tb,
                                                 collect=True)
    for got, want, what in ((th, jh, "hidden"), (tk, jk, "k"), (tv, jv, "v"),
                            (ths, jhs, "h"), (ttail, jtail, "conv_tail")):
        assert tuple(got.shape) == want.shape, what
        _close(got, want, TOL, what)


def test_forward_under_a_kv_sched_row(parts, jitted):
    """A precision-policy row (layer 0 at 8 bits, layer 1 at 4) refines the
    fresh K/V of both layers in the hybrid stack as in the reference."""
    cfg, tcfg, jp, tp, jeng, _, _ = parts
    toks, plen = _batch(cfg, 40, seed=41)
    row = np.asarray(jeng.table)[2]
    sched = np.array([8, 4], np.int32)
    jh, _, ((jk, _), _) = jitted["forward"](
        jp, cfg, jnp.asarray(row), {"tokens": jnp.asarray(toks),
                                     "prompt_len": jnp.asarray(plen)},
        collect=True, kv_sched=jnp.asarray(sched))
    th, _, ((tk, _), _) = T.forward(
        tp, tcfg, row, {"tokens": torch.from_numpy(toks), "prompt_len": plen},
        collect=True, kv_sched=sched)
    _close(th, jh, TOL, "hidden")
    _close(tk, jk, TOL, "k")


# ---------------------------------------------------------------- decode

@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_prefill_decode_across_ring_wraps(parts, jitted, kv_bits):
    """A ragged prefill of 17, 4, 9 and 14 tokens into ``slots=64`` (a ring
    of 16), then 19 decode steps at the float profile: the row of 14 wraps
    its ring at positions 16 and 32. Logits within 1e-4, ``token_idx`` and
    int-KV ints bitwise, scales within 1e-6 relative, the SSM state within
    1e-5. (At an A8 profile an activation that lands exactly on a grid
    midpoint rounds away from zero in the port, while the jitted
    reference divides by the scale as a multiply by its reciprocal, one
    ulp off the midpoint: one such flip changes every later logit, so the
    8-bit grids are held to the reference through ``forward`` above and
    the schedulers' tokens below.)"""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    rng = np.random.default_rng(50 + kv_bits)
    plen = np.array([17, 4, 9, 14], np.int32)
    prompts = np.zeros((4, 17), np.int32)
    for j, n in enumerate(plen):
        prompts[j, 17 - n:] = rng.integers(0, cfg.vocab, n)
    row = _f32_row(cfg)
    jl, jc = jitted["prefill"](jp, cfg, jnp.asarray(row),
                               {"tokens": jnp.asarray(prompts),
                                "prompt_len": jnp.asarray(plen)}, 64,
                               kv_bits=kv_bits)
    tl, tc = T.prefill(tp, tcfg, row,
                       {"tokens": torch.from_numpy(prompts),
                        "prompt_len": plen}, 64, kv_bits=kv_bits)
    assert set(tc) == {"kv", "ssm"}
    assert tuple(tc["kv"].token_idx.shape) == (2, 4, 16)

    def same(step):
        _close(tl, jl, LOGIT_TOL, f"logits {step}")
        np.testing.assert_array_equal(tc["kv"].token_idx.numpy(),
                                      np.asarray(jc["kv"].token_idx))
        if kv_bits in (4, 8):
            for f in ("k", "v"):
                np.testing.assert_array_equal(
                    getattr(tc["kv"], f).numpy(),
                    np.asarray(getattr(jc["kv"], f)), err_msg=f"{f} {step}")
            for f in ("k_scale", "v_scale"):
                np.testing.assert_allclose(
                    getattr(tc["kv"], f).numpy(),
                    np.asarray(getattr(jc["kv"], f)), rtol=1e-6, atol=0,
                    err_msg=f"{f} {step}")
        _close(tc["ssm"].h, jc["ssm"].h, TOL, f"h {step}")
        _close(tc["ssm"].conv, jc["ssm"].conv, TOL, f"conv {step}")

    same("prefill")
    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for step in range(19):
        pos = plen + step
        jl, jc = jitted["decode"](jp, cfg, jnp.asarray(row),
                                  jnp.asarray(tok), jnp.asarray(pos), jc)
        tl, tc = T.decode_step(tp, tcfg, row, torch.from_numpy(tok),
                               torch.from_numpy(pos), tc)
        same(step)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    assert int(tc["kv"].token_idx.max()) == 17 + 18


def test_prefill_decode_equals_forward(parts):
    """The reference's relation (``tests/test_prefill_decode.py``) on the
    port: prefill of 31 tokens (past the window) into an f32 cache, then
    one decode step against the forward over 32, float profile, ``rel <
    5e-5``."""
    tcfg, tp = parts[1], parts[3]
    br = _f32_row(parts[0])
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


@pytest.mark.parametrize("slots", [64, 10])
def test_cache_geometry_at_the_window(parts, slots):
    """Every attention row holds ``eff = min(slots, window)`` slots, on the
    contiguous pool and on the paged one (``ceil(eff / bs)`` table entries),
    as the reference allocates them; the block size falls to a divisor of
    ``eff``; the SSM state rides beside the KV."""
    cfg, tcfg = parts[0], parts[1]
    eff = min(slots, 16)
    for kv_bits in (16, 8, 4):
        mine = T.init_caches(tcfg, 3, slots, kv_bits=kv_bits, device="cpu")
        ref = JT.init_caches(cfg, 3, slots, kv_bits=kv_bits)
        assert set(mine) == set(ref) == {"kv", "ssm"}
        assert tuple(mine["kv"].token_idx.shape) == (2, 3, eff)
        for f in ("k", "v", "k_scale", "v_scale", "token_idx"):
            assert tuple(getattr(mine["kv"], f).shape) == \
                getattr(ref["kv"], f).shape, f
        assert T.cache_bytes(mine) == JT.cache_bytes(ref)
    for bs in (16, 5, 3):
        assert T.paged_block_size(tcfg, slots, bs) == \
            JT.paged_block_size(cfg, slots, bs)
        mine = T.init_paged_caches(tcfg, 3, slots, block_size=bs,
                                   device="cpu")
        ref = JT.init_paged_caches(cfg, 3, slots, block_size=bs)
        assert tuple(mine["kv"].block_table.shape) == \
            ref["kv"].block_table.shape
        # the port's pool carries one more block, the write sink
        assert mine["kv"].k.shape[1] == ref["kv"].k.shape[1] + 1
        assert tuple(mine["kv"].k.shape[2:]) == ref["kv"].k.shape[2:]
        assert set(mine) == {"kv", "ssm"}
    assert T.paged_block_size(tcfg, 64, 5) == 4 == \
        JT.paged_block_size(cfg, 64, 5)


# ---------------------------------------------------------------- serving

_JSERVERS: dict = {}


def _jserver(parts, key, **scfg):
    if key not in _JSERVERS:
        cfg, _, jp, _, jeng, _, _ = parts
        _JSERVERS[key] = JServer(cfg, jp, jeng, JConfig(**scfg))
    return _JSERVERS[key]


def test_ragged_static_serve_matches_solo_and_reference(parts):
    """Prompts 4, 9 and 17 in one static group (17 exceeds the window):
    each row emits its solo ``generate``'s tokens and the reference
    serve's."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(slots=64,
                                                       max_batch=4),
                         device="cpu")
    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, cfg.vocab, n).astype(np.int32)
            for n in (4, 9, 17)]
    got = srv.serve([Request(tokens=t, max_new=6) for t in reqs])
    want = _jserver(parts, "static", slots=64, max_batch=4).serve(
        [JRequest(tokens=t, max_new=6) for t in reqs])
    for t, g, w in zip(reqs, got, want):
        assert g["tokens"] == [int(x) for x in w["tokens"]]
        assert g["tokens"] == srv.generate(t[None], 6)["tokens"][0]


def test_kv8_serve_reaches_k4_across_the_wrap(parts, monkeypatch):
    """A kv8 static serve on the kernel backend reads the contiguous int8
    ring through K4 on every layer and step, also after the ring wraps
    (positions past 16): ``decode_attention``'s window guard never fires,
    since a ring of ``min(slots, window)`` slots holds only tokens inside
    the window. Tokens equal the einsum (gather) backend's."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    calls = {"n": 0}
    plain = QK.qkv_attention

    def counting(*a, **kw):
        calls["n"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(QK, "qkv_attention", counting)
    rng = np.random.default_rng(8)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=20) for n in (9, 17)]
    out = {}
    for backend in ("kernel", "gather"):
        srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
            slots=64, max_batch=2, kv_bits=8, paged_backend=backend),
            device="cpu")
        calls["n"] = 0
        out[backend] = [r["tokens"] for r in srv.serve(reqs)]
        if backend == "kernel":
            assert calls["n"] == tcfg.n_layers * 19
    assert calls["n"] == 0
    assert out["kernel"] == out["gather"]


def _scenario(reqs):
    def scenario(sched, Req):
        for t, m in reqs:
            sched.submit(Req(tokens=t, max_new=m))
        sched.run()
        return {"paged": sched.paged}
    return scenario


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_scheduler_reuses_rows_like_the_reference(parts, kv_bits):
    """Four requests on two rows of the paged pool (blocks of 5 asked for,
    4 taken: a divisor of the window), two waves of two with prompts up to
    19 and rings that wrap: both rows are reused after their first
    occupants retire, and each new occupant decodes from its own prefill's
    SSM state — tokens, traces, events and admission order equal the JAX
    scheduler's on both backends (``run_pair``) and the contiguous
    pool's."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    rng = np.random.default_rng(60 + kv_bits)
    reqs = [(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for n, m in ((17, 9), (4, 9), (19, 12), (9, 12))]
    scfg = dict(slots=64, max_batch=2, kv_bits=kv_bits, block_size=5,
                prefix_cache=False)
    out = run_pair(parts, scfg, _scenario(reqs), managed=True)
    for sched in out.values():
        assert sched.paged and sched.block_size == 4 and sched.n_lblk == 4
        assert sched.admission_log == list(range(len(reqs)))
        assert sched.n_slots == 2 and sched.decode_steps > 16
    contig = ContinuousScheduler(AdaptiveServer(
        tcfg, tp, teng, ServingConfig(paged_kv=False, **scfg),
        manager=_manager(ProfileManager, parts[6]), device="cpu"),
        quantum=4)
    _scenario(reqs)(contig, Request)
    assert not contig.paged
    for rid in range(len(reqs)):
        assert contig.results[rid]["tokens"] == \
            out["kernel"].results[rid]["tokens"]


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("w_bits", [8, 4])
def test_to_native_hybrid_sites_bitwise(parts, w_bits):
    _, _, jp, tp, _, _, _ = parts
    jn = params_from_jax(jax.tree.map(np.asarray, jax.jit(
        jax_to_native, static_argnums=1)(jp, w_bits)), device="cpu")
    tn = to_native(tp, w_bits)
    lay, jlay = tn["layers"], jn["layers"]
    leaves = [(lay[s], jlay[s]) for s in ("qkv", "attn_out")]
    leaves += [(lay["ssm"][s], jlay["ssm"][s]) for s in ("in_proj",
                                                         "out_proj")]
    leaves += [(lay["mlp"][s], jlay["mlp"][s]) for s in ("w_in", "w_out")]
    leaves += [(tn["lm_head"], jn["lm_head"]), (tn["embed"], jn["embed"])]
    for got, want in leaves:
        assert set(got) == set(want) == {"wq"}
        g, w = got["wq"], want["wq"]
        assert (g.bits, g.orig_last) == (w.bits, w.orig_last)
        assert torch.equal(g.data, w.data) and torch.equal(g.scale, w.scale)
    for leaf in ("norm_attn_out", "norm_ssm_out", "norm_attn", "norm_mlp"):
        assert lay[leaf]["g"] is tp["layers"][leaf]["g"]
    assert "lm_head" in NATIVE_SITES
    assert T.param_count(tn) == T.param_count(jn)


def test_w4_refuses_an_odd_vocab_in_both_packages(parts):
    """Packed int4 needs an even output width: with ``vocab=511`` the
    untied head cannot be packed (hymba-1.5b's 32001 has no native W4
    either). The reference's ``pack_int4`` asserts; the port names the
    leaf. W8 converts."""
    tcfg = dataclasses.replace(parts[1], vocab=511)
    tp = T.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    head = np.asarray(tp["lm_head"]["w"])
    with pytest.raises(AssertionError):
        jax_to_native({"lm_head": {"w": jnp.asarray(head)}}, 4)
    with pytest.raises(ValueError, match=r"^lm_head: .*N 511 is odd"):
        to_native(tp, 4)
    assert tuple(to_native(tp, 8)["lm_head"]["wq"].data.shape) == (64, 511)


# ---------------------------------------------------------------- refusals

def test_refusals(parts, tmp_path):
    """Speculation and preemption are refused by both servers; prefix
    sharing and chunked prefill stay off; a durability cut with a live row
    raises, as on the contiguous pool."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    for kw in (dict(speculate=True), dict(preemption=True)):
        with pytest.raises(ValueError):
            JServer(cfg, jp, jeng, JConfig(slots=64, **kw))
        with pytest.raises(ValueError):
            AdaptiveServer(tcfg, tp, teng, ServingConfig(slots=64, **kw),
                           device="cpu")
    assert not T.supports_prefix_sharing(tcfg)
    assert not T.supports_speculation(tcfg)
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        slots=64, max_batch=2, prefill_chunk=8), device="cpu")
    assert not srv.prefix_sharing and srv.chunk_tokens is None
    assert not srv.can_restore
    sched = ContinuousScheduler(srv, quantum=4)
    assert sched.paged and sched.registry is None and sched.chunk is None
    D.Durability(sched, str(tmp_path / "jd"), checkpoint_every=1)
    sched.submit(Request(tokens=np.arange(5, dtype=np.int32), max_new=8))
    with pytest.raises(ValueError, match="paged KV pool"):
        sched.step()
    with pytest.raises(NotImplementedError):
        T.init_params(dataclasses.replace(tcfg, family="encoder"),
                      torch.Generator().manual_seed(0), device="cpu")


# ---------------------------------------------------------------- launcher

def test_launcher_serves_hymba_like_the_reference(parts, monkeypatch,
                                                  capsys):
    """``--arch hymba-1.5b --continuous --device cpu`` (the paged pool),
    both launchers on one set of weights and on the reference's energy
    model (``TPU_V5E``): every request's tokens and profile trace equal the
    reference launcher's."""
    from repro.serving import scheduler as JS
    jp, tp = parts[2], parts[3]
    argv = ["--arch", ARCH, "--requests", "3", "--max-new", "6",
            "--continuous"]
    want: dict = {}

    class Recording(JS.ContinuousScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            want["sched"] = self

    monkeypatch.setattr(JS, "ContinuousScheduler", Recording)
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
    assert "blocks of 16 tokens" in out
    assert all(f"req{i}: 6 tokens" in out for i in range(3))
    for i, g in enumerate(got["results"]):
        w = want["sched"].results[i]
        assert g["tokens"] == [int(x) for x in w["tokens"]]
        assert g["profile_trace"] == w["profile_trace"]


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_launcher_static_serves_hymba(capsys, kv_bits):
    """The static path of ``--arch hymba-1.5b --device cpu`` (the default
    seed's weights), at kv16 and on the int8 ring."""
    S.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
            "--max-new", "4", "--kv-bits", str(kv_bits)])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}-smoke on cpu" in out and "static groups" in out
    assert f"kv{kv_bits})" in out
    assert all(f"req{i}: 4 tokens" in out for i in range(3))
