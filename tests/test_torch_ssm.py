"""The port's SSM family (mamba2) against the JAX reference on the
mamba2-130m smoke config (2 layers, d_model 64, 8 SSD heads of 16, d_state
16, chunk 16), f32, on the reference's weights (``params_from_jax``); every
input is drawn from a numpy seed.

Tolerances: the SSD block's outputs and final states within ``1e-5``
(absolute; f32 einsums contract in another order than XLA's); logits within
``1e-4``, as ``test_torch_model.py``; tokens, profile traces, billing events
and admission order equal. At the A16 profiles the reference's CPU ``exp2``
builds an inexact 16-bit grid (ROADMAP Queue 3, pitfall 1), which the
``1e-4`` on logits covers; on these inputs no greedy token flips, so the
serves are held to token equality at every profile.

* the config, the quantization site names and the paper profiles' table;
* the parameter tree of ``init_params`` (keys, shapes, the deterministic
  leaves);
* ``ssd_forward`` at S 37 with chunk 16 (chunk padding), with a ragged
  ``valid`` (left-padded rows of 37, 20, 5 and 2 tokens), and at S 2 (the
  tail left-padded to ``d_conv − 1``): outputs and ``(h, conv_tail)``;
* ``ssm_decode_step`` over 4 steps from a ragged prefill's state;
* ``to_native`` on ``in_proj``/``out_proj`` and the prequant images of
  ``ssm_in``/``ssm_out``, bitwise;
* ``prefill`` + ``decode_step`` logits at every paper profile, and the
  reference's relation prefill(31) + decode = forward(32) on the port;
* a ragged serve of prompts 4, 9 and 17 against each prompt's solo
  ``generate``;
* a ragged static ``serve`` (prompts 4 to 17, two groups) and
  ``ContinuousScheduler.run`` over 6 requests on 4 rows (retired rows'
  slots reused), managed and not, and a native W8 scheduler;
* quarantine and escalated retry on the contiguous pool;
* the refusals (speculation, preemption, prefix sharing and chunking off,
  no paging, an unported family) and the SSM state's bytes;
* the launcher's ``--arch mamba2-130m`` on the CPU, static and continuous.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.manager import ProfileManager as JManager
from repro.core.profiles import paper_profiles
from repro.launch.serve import profile_stats as jax_profile_stats
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.native import to_native as jax_to_native
from repro.serving import faults as JF
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.manager import ProfileManager
from repro_torch.launch import serve as S
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.native import to_native
from repro_torch.serving import faults as F
from repro_torch.serving.engine import (AdaptiveServer, Request,
                                        RequestStatus, ServingConfig)
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_prefix import _manager, run_pair
from torch_threads import _one_thread  # noqa: F401

SSD_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "mamba2-130m"


@pytest.fixture(scope="module")
def parts():
    cfg = get_smoke(ARCH)
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    names = JT.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    jeng = AdaptiveEngine(tuple(profs), QuantIndex(names), lambda *a: None)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names, inner_layers=[])),
                             TE.QuantIndex(names))
    stats = jax_profile_stats(cfg, profs, JT.param_count(jp))
    return cfg, C.get_smoke(ARCH), jp, tp, jeng, teng, stats


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0,
                               err_msg=what)


# ---------------------------------------------------------------- config

def test_config_sites_and_profiles_match_reference(parts):
    cfg, tcfg, _, _, jeng, teng, _ = parts
    fields = [f for f in tcfg.__dataclass_fields__ if f != "ssm"]
    assert {f: getattr(tcfg, f) for f in fields} == \
        {f: getattr(cfg, f) for f in fields}
    assert dataclasses.asdict(tcfg.ssm) == dataclasses.asdict(cfg.ssm)
    full, jfull = C.get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full.ssm) == dataclasses.asdict(jfull.ssm)
    assert (full.n_layers, full.d_model, full.vocab, full.tie_embeddings) \
        == (jfull.n_layers, jfull.d_model, jfull.vocab, jfull.tie_embeddings)
    assert T.quant_layer_names(tcfg) == JT.quant_layer_names(cfg)
    assert T.quant_layer_names(full) == JT.quant_layer_names(jfull)
    assert len(T.quant_layer_names(full)) == 2 + 24 * 2
    assert np.array_equal(np.asarray(jeng.table), teng.table)
    assert (tcfg.has_attn, tcfg.has_ssm, tcfg.has_mlp) == \
        (cfg.has_attn, cfg.has_ssm, cfg.has_mlp) == (False, True, False)


def _tree(t, prefix=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _tree(v, prefix + (k,))
    else:
        yield prefix, t


def test_param_tree_matches_reference(parts):
    """Same keys, shapes and dtypes as the reference's ``init_params``; the
    leaves the reference does not draw at random (``A_log``, ``D``,
    ``dt_bias``, conv bias, norms) equal its values to an f32 ulp."""
    cfg, tcfg, jp, _, _, _, _ = parts
    gen = torch.Generator().manual_seed(0)
    mine = dict(_tree(T.init_params(tcfg, gen, device="cpu")))
    want = dict(_tree(jax.tree.map(np.asarray, jp)))
    assert sorted(mine) == sorted(want)
    for path, w in want.items():
        got = mine[path]
        assert tuple(got.shape) == w.shape and str(got.dtype) == \
            f"torch.{w.dtype}", path
        if path[-1] in ("A_log", "D", "dt_bias", "conv_b", "norm_g", "g"):
            np.testing.assert_allclose(got.numpy(), w, rtol=2e-7, atol=0,
                                       err_msg=str(path))
    assert T.param_count(dict(T.init_params(tcfg, gen, device="cpu"))) == \
        JT.param_count(jp)


# ---------------------------------------------------------------- SSD block

def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["ssm"]),
            T._layer(tp["layers"], 0)["ssm"])


def _ssd_inputs(case: str):
    rng = np.random.default_rng({"chunk_pad": 1, "ragged": 2, "short": 3}[case])
    s = 2 if case == "short" else 37
    x = rng.standard_normal((4, s, 64)).astype(np.float32)
    valid = None
    if case == "ragged":
        lens = np.array([37, 20, 5, 2])
        valid = np.arange(s)[None] >= (s - lens)[:, None]
    return x, valid


@pytest.mark.parametrize("bits", [(32, 32), (8, 8)], ids=["f32", "A8W8"])
@pytest.mark.parametrize("case", ["chunk_pad", "ragged", "short"])
def test_ssd_forward_matches_reference(parts, case, bits):
    cfg, tcfg, jp, tp, _, _, _ = parts
    jl, tl = _layer0(jp, tp)
    x, valid = _ssd_inputs(case)
    jb = jnp.asarray(bits, jnp.int32)
    want, (jh, jtail) = JS.ssd_forward(
        jl, jnp.asarray(x), jb, jb, cfg.ssm, return_final_state=True,
        valid=None if valid is None else jnp.asarray(valid))
    got, (th, ttail) = TS.ssd_forward(
        tl, torch.from_numpy(x), bits, bits, tcfg.ssm,
        return_final_state=True,
        valid=None if valid is None else torch.from_numpy(valid))
    _close(got, want, SSD_TOL, "y")
    _close(th, jh, SSD_TOL, "h")
    assert ttail.shape == jtail.shape == (4, 3, tcfg.ssm.conv_dim(64))
    _close(ttail, jtail, SSD_TOL, "conv_tail")
    if case == "ragged":                 # pads of short rows stay zero
        assert (ttail[3, 0] == 0).all()
    if case == "short":                  # left-padded to d_conv - 1
        assert (ttail[:, 0] == 0).all()
    # no output without return_final_state, same values
    _close(TS.ssd_forward(tl, torch.from_numpy(x), bits, bits, tcfg.ssm,
                          valid=None if valid is None
                          else torch.from_numpy(valid)), got, 0.0)


def test_ssm_decode_steps_match_reference(parts):
    """Four recurrent steps from a ragged prefill's final state: outputs
    and the state after each step."""
    cfg, tcfg, jp, tp, _, _, _ = parts
    jl, tl = _layer0(jp, tp)
    x, valid = _ssd_inputs("ragged")
    bits = (8, 8)
    jb = jnp.asarray(bits, jnp.int32)
    _, (jh, jtail) = JS.ssd_forward(jl, jnp.asarray(x), jb, jb, cfg.ssm,
                                    return_final_state=True,
                                    valid=jnp.asarray(valid))
    jst = JS.ssm_prefill_state((jh, jtail), 4, 64, cfg.ssm)
    tst = TS.SSMState(h=torch.from_numpy(np.array(jst.h)),
                      conv=torch.from_numpy(np.array(jst.conv)))
    rng = np.random.default_rng(4)
    for step in range(4):
        xt = rng.standard_normal((4, 1, 64)).astype(np.float32)
        want, jst = JS.ssm_decode_step(jl, jnp.asarray(xt), jst, jb, jb,
                                       cfg.ssm)
        got = TS.ssm_decode_step(tl, torch.from_numpy(xt), tst, bits, bits,
                                 tcfg.ssm)
        _close(got, want, SSD_TOL, f"y step {step}")
        _close(tst.h, jst.h, SSD_TOL, f"h step {step}")
        _close(tst.conv, jst.conv, SSD_TOL, f"conv step {step}")


def test_softplus_is_the_reference_form():
    """The port's softplus is ``logaddexp(x, 0)``, finite and exact where
    ``F.softplus`` switches to ``x``; on the dt range of the block it
    agrees with ``jax.nn.softplus`` to a few f32 ulps (``exp`` and
    ``log1p`` differ by an ulp between the libraries, and XLA flushes
    denormals to zero)."""
    x = np.random.default_rng(5).normal(-4.6, 3.0, 4096).astype(np.float32)
    x[:4] = [-100.0, 0.0, 20.5, 80.0]
    got = TS.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-38)
    assert got[3] == np.float32(80.0) and got[0] >= 0


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("w_bits", [8, 4])
def test_to_native_ssm_sites_bitwise(parts, w_bits):
    _, _, jp, tp, _, _, _ = parts
    jn = params_from_jax(jax.tree.map(np.asarray, jax_to_native(jp, w_bits)),
                         device="cpu")
    tn = to_native(tp, w_bits)
    for site in ("in_proj", "out_proj"):
        got, want = tn["layers"]["ssm"][site], jn["layers"]["ssm"][site]
        assert set(got) == set(want) == {"wq"}
        g, w = got["wq"], want["wq"]
        assert (g.bits, g.orig_last) == (w.bits, w.orig_last)
        assert torch.equal(g.data, w.data) and torch.equal(g.scale, w.scale)
    for leaf in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_g"):
        assert tn["layers"]["ssm"][leaf] is tp["layers"]["ssm"][leaf]
    assert T.param_count(tn) == JT.param_count(jax_to_native(jp, w_bits))


def test_prequant_ssm_images_bitwise(parts):
    """Every profile's ``ssm_in``/``ssm_out`` weight image, and the
    embedding's, equal the reference's ``prequant_decode_weights``."""
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    want = jax.tree.map(np.asarray, JT.prequant_decode_weights(
        jp, cfg, jnp.asarray(jeng.table)))
    got = T.prequant_decode_weights(tp, tcfg, teng.table)
    assert len(got) == teng.table.shape[0]
    for p, ov in enumerate(got):
        assert set(ov["layers"]) == {"ssm"}
        for site in ("in_proj", "out_proj"):
            np.testing.assert_array_equal(
                ov["layers"]["ssm"][site]["wfq"].numpy(),
                want["layers"]["ssm"][site]["wfq"][p], err_msg=f"{p} {site}")
        np.testing.assert_array_equal(ov["embed"]["wfq"].numpy(),
                                      want["embed"]["wfq"][p])


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("pid", range(6))
def test_prefill_then_decode_logits(parts, pid):
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    rng = np.random.default_rng(10 + pid)
    plen = np.array([4, 9, 17, 2], np.int32)
    s = 40
    prompts = np.zeros((4, s), np.int32)
    for j, n in enumerate(plen):
        prompts[j, s - n:] = rng.integers(0, cfg.vocab, n)
    row = jnp.asarray(jeng.table)[pid]
    jl, jc = JT.prefill(jp, cfg, row, {"tokens": jnp.asarray(prompts),
                                       "prompt_len": jnp.asarray(plen)}, 64)
    tl, tc = T.prefill(tp, tcfg, teng.table[pid],
                       {"tokens": torch.from_numpy(prompts),
                        "prompt_len": plen}, 64)
    assert set(tc) == {"ssm"}
    _close(tl, jl, LOGIT_TOL, "prefill logits")
    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for step in range(2):
        jl, jc = JT.decode_step(jp, cfg, row, jnp.asarray(tok),
                                jnp.asarray(plen + step), jc)
        tl, tc = T.decode_step(tp, tcfg, teng.table[pid],
                               torch.from_numpy(tok),
                               torch.from_numpy(plen + step), tc)
        _close(tl, jl, LOGIT_TOL, f"decode logits {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    _close(tc["ssm"].h, jc["ssm"].h, LOGIT_TOL, "h")


def test_prefill_decode_equals_forward(parts):
    """The reference's own relation (``tests/test_prefill_decode.py``) on
    the port: prefill of 31 tokens then one decode step against the
    forward over 32, float profile, ``rel < 5e-5``."""
    from repro_torch.core.profiles import Profile, profile_table
    tcfg, tp = parts[1], parts[3]
    names = T.quant_layer_names(tcfg)
    br = profile_table([Profile.float32(names)], names)[0]
    toks = torch.from_numpy(np.random.default_rng(42).integers(
        0, tcfg.vocab, (2, 32)).astype(np.int32))
    hidden, _, _ = T.forward(tp, tcfg, br, {"tokens": toks})
    full = T._logits(tcfg, tp, br, hidden[:, -1:])[:, 0]
    _, caches = T.prefill(tp, tcfg, br, {"tokens": toks[:, :31]}, 36)
    dec, _ = T.decode_step(tp, tcfg, br, toks[:, 31:],
                           torch.full((2,), 31, dtype=torch.int32), caches)
    rel = float((dec - full).abs().max()) / max(1e-9, float(full.abs().max()))
    assert rel < 5e-5, rel


# ---------------------------------------------------------------- serving

def test_ragged_serve_equals_solo(parts):
    """Prompts 4, 9 and 17 in one static group (left-padded to 17, past
    the chunk of 16): each row emits what its solo ``generate`` emits."""
    cfg, tcfg, _, tp, _, teng, _ = parts
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(slots=64,
                                                       max_batch=4),
                         device="cpu")
    rng = np.random.default_rng(7)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=6) for n in (4, 9, 17)]
    for req, res in zip(reqs, srv.serve(reqs)):
        assert res["tokens"] == srv.generate(req.tokens[None],
                                             req.max_new)["tokens"][0]


REQS = [(4, 6), (9, 3), (17, 8), (6, 1), (12, 5), (7, 9)]


def _requests(cfg, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, n).astype(np.int32), m, i % 3 == 0)
            for i, (n, m) in enumerate(REQS)]


_JSERVERS: dict = {}


@pytest.mark.parametrize("managed", [False, True])
def test_static_serve_matches_reference(parts, managed):
    """Ragged static groups (the first holds prompts 4, 6, 7 and 9, the
    second 12 and 17 with two pad rows), then ``generate`` and
    ``generate_stepwise``: tokens, traces and the ledger equal the
    reference's, and unmanaged the fused loop gives the stepwise tokens.
    One JAX server serves both cases (its jitted prefill compiles once);
    the manager, host state only, is swapped in."""
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    scfg = dict(slots=64, max_batch=4, prefix_cache=False)
    jm = _manager(JManager, stats) if managed else None
    tm = _manager(ProfileManager, stats) if managed else None
    if "static" not in _JSERVERS:
        _JSERVERS["static"] = JServer(cfg, jp, jeng, JConfig(**scfg))
    js = _JSERVERS["static"]
    js.manager = jm
    ts = AdaptiveServer(tcfg, tp, teng, ServingConfig(**scfg), manager=tm,
                        device="cpu")
    reqs = _requests(cfg)
    want = js.serve([JRequest(tokens=t, max_new=m, accuracy_critical=c)
                     for t, m, c in reqs])
    got = ts.serve([Request(tokens=t, max_new=m, accuracy_critical=c)
                    for t, m, c in reqs])
    for g, w in zip(got, want):
        assert g["tokens"] == [int(x) for x in w["tokens"]]
        assert g["profile_trace"] == w["profile_trace"]
    if managed:
        assert tm.spent_j == jm.spent_j
        assert len({p for r in got for p in r["profile_trace"]}) > 1
    prompts = np.stack([t[:4] for t, _, _ in reqs[:3]])
    for method in ("generate", "generate_stepwise"):
        w = getattr(js, method)(prompts, 5)
        g = getattr(ts, method)(prompts, 5)
        assert g["tokens"] == [[int(x) for x in r] for r in w["tokens"]]
        assert g["profile_trace"] == w["profile_trace"]
    if not managed:
        assert ts.generate(prompts, 5)["tokens"] == \
            ts.generate_stepwise(prompts, 5)["tokens"]


def _scenario(reqs):
    def scenario(sched, Req):
        for t, m, c in reqs:
            sched.submit(Req(tokens=t, max_new=m, accuracy_critical=c))
        sched.run()
        return {"paged": sched.paged}
    return scenario


@pytest.mark.parametrize("managed", [False, True])
def test_scheduler_matches_reference(parts, managed):
    """6 requests on 4 rows with ``paged_kv=True`` asked for: both
    schedulers fall back to the contiguous pool (``paged`` False), retired
    rows' slots are reused, and results, traces, events, admission order
    and the ledger equal the JAX scheduler's (``run_pair``)."""
    cfg = parts[0]
    reqs = _requests(cfg, seed=11)
    out = run_pair(parts, dict(slots=64, max_batch=4, paged_kv=True),
                   _scenario(reqs), managed=managed)
    for sched in out.values():
        assert not sched.paged
        assert sched.admission_log == list(range(len(reqs)))
        assert sched.decode_steps > 0


def test_native_w8_scheduler_matches_reference(parts):
    cfg, tcfg, jp, tp, jeng, teng, stats = parts
    jn = jax_to_native(jp, 8)
    native = (cfg, tcfg, jn, to_native(tp, 8), jeng, teng, stats)
    run_pair(native, dict(slots=64, max_batch=4),
             _scenario(_requests(cfg, seed=13)), managed=True)


def test_quarantine_and_retry_on_the_ssm_pool(parts):
    """NaN faults on the contiguous SSM pool: one recovered retry (whole
    re-prefill over the row's stale state), one request that exhausts its
    budget; status, retries and tokens equal the JAX scheduler's."""
    cfg = parts[0]
    rng = np.random.default_rng(31)
    reqs = [(rng.integers(0, cfg.vocab, n).astype(np.int32), m, False)
            for n, m in ((12, 8), (9, 6), (10, 6))]

    def sched_kw(side):
        fm = JF if side == "jax" else F
        return dict(faults=fm.FaultSchedule(nan_at={0: (0,), 2: (0, 1)}),
                    retry_budget=1, paranoid=True)

    out = run_pair(parts, dict(slots=64, max_batch=2, paged_kv=False),
                   _scenario(reqs), managed=True, sched_kw=sched_kw)
    for sched in out.values():
        res = sched.results
        assert res[0]["retries"] == 1
        assert res[0]["status"] is RequestStatus.COMPLETED
        assert res[2]["status"] is RequestStatus.FAILED


def test_refusals_and_state_bytes(parts):
    cfg, tcfg, jp, tp, jeng, teng, _ = parts
    for kw in (dict(speculate=True), dict(preemption=True)):
        with pytest.raises(ValueError):
            JServer(cfg, jp, jeng, JConfig(slots=64, **kw))
        with pytest.raises(ValueError):
            AdaptiveServer(tcfg, tp, teng, ServingConfig(slots=64, **kw),
                           device="cpu")
    srv = AdaptiveServer(tcfg, tp, teng, ServingConfig(
        slots=64, max_batch=3, prefill_chunk=8, paged_backend="kernel"),
        device="cpu")
    assert not srv.prefix_sharing and srv.chunk_tokens is None
    assert not srv.can_restore
    assert not T.supports_prefix_sharing(tcfg)
    assert not T.supports_speculation(tcfg)
    sched = ContinuousScheduler(srv)
    st = sched.paged_stats()
    assert st["paged"] is False and set(sched._caches) == {"ssm"}
    sc = tcfg.ssm
    per_row = (sc.n_heads(64) * sc.head_dim * sc.d_state
               + (sc.d_conv - 1) * sc.conv_dim(64)) * 4
    assert st["kv_bytes"] == 3 * tcfg.n_layers * per_row
    assert srv.clear_rows([0, 1], sched._caches) is sched._caches
    with pytest.raises(AssertionError):
        T.decode_step_spec(tp, tcfg, teng.table[0],
                           torch.zeros((1, 2), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.int32),
                           sched._caches)
    unknown = dataclasses.replace(tcfg, family="encoder")
    with pytest.raises(NotImplementedError):
        T.init_params(unknown, torch.Generator().manual_seed(0),
                      device="cpu")


@pytest.mark.parametrize("continuous", [False, True])
def test_launcher_serves_mamba2_on_cpu(capsys, continuous):
    argv = ["--arch", ARCH, "--device", "cpu", "--requests", "3",
            "--max-new", "4"] + (["--continuous"] if continuous else [])
    S.main(argv)
    out = capsys.readouterr().out
    head = "contiguous pool of 4 rows" if continuous else "static groups"
    assert f"[serve] {ARCH}-smoke on cpu" in out and head in out
    assert out.count("4 tokens") == 3 and "12 tokens in" in out
