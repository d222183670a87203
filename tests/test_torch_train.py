"""The port's LM training path against the JAX reference: the token
stream, stochastic rounding, int8 gradient compression, ``chunked_xent``
and ``train_loss``, per-layer remat, the in-place AdamW, the train loop
(restart, stragglers, preemption) and the launcher, on the reference's
granite-3-2b smoke config at f32 with the reference's weights
(``params_from_jax``). The reference's steps are jitted.

Tolerances and why:

* bitwise: the token stream (numpy on both sides); stochastic rounding
  and compression given the uniforms JAX drew (the test recomputes them
  from the same keys with ``jax.random.uniform``: JAX's PRNG cannot be
  reproduced in torch, the arithmetic can); remat on against off (the
  recompute runs the same ops on the same inputs); the in-place AdamW
  against the functional one; a restart against the uninterrupted run.
* ``1e-5``: ``chunked_xent`` and ``train_loss`` (absolute; the f32
  contractions sum in another order than XLA's).
* the loop against the reference's ``train()``: 8 steps at B 2 × S 32,
  lr 1e-4, profiles rotating over the four whose activation grids are at
  8 bits or fewer (A8-W8, A8-W4, A4-W4, Mixed; the A16 grid is inexact in
  JAX on the CPU, ``tests/test_torch_quant.py``): losses within 1e-5,
  parameters within 2e-6 (0.5 % of the largest update over the 8 steps,
  4.3e-4; the largest difference, 1.2e-6, is the one element whose first
  gradient is 1e-8, in Adam's ``eps`` region), moments within 1e-5 of
  each leaf's max-abs. At lr 1e-3 that element is 1.2e-5 apart after the
  first step, and at the ``Mixed`` profile's first step (step 3) one
  activation's inputs, a few ulps apart, straddle a grid midpoint, after
  which the runs part by 1e-3 within 8 steps; at B 8 × S 64 such a flip
  comes in the first forward. ``test_loop_divergence_starts_at_a_grid_flip``
  holds both readings.
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core import quantizers as JQ
from repro.core.engine import AdaptiveEngine as JEngine
from repro.core.engine import QuantIndex as JIndex
from repro.core.profiles import paper_profiles as jax_profiles
from repro.core.qtypes import QuantSpec as JSpec
from repro.data.tokens import TokenStream as JStream
from repro.models import transformer as JT
from repro.optim import compression as JC
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.train import loop as JL
from repro_torch.checkpoint.manager import latest_step
from repro_torch.configs import get_smoke
from repro_torch.core.qtypes import QuantSpec
from repro_torch.core.quantizers import fake_quant, round_stochastic
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train as LT
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adam as A
from repro_torch.optim import compression as C
from repro_torch.train.loop import (StragglerMonitor, TrainConfig, _flatten,
                                    train, value_and_grad)
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-3-2b"
TOL = 1e-5
B, S, LR, STEPS = 2, 32, 1e-4, 8
PIDS = (2, 3, 4, 5)                  # A8-W8, A8-W4, A4-W4, Mixed


def _leaves_np(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _leaves_t(tree):
    return [l.detach().numpy() for l in _flatten(tree)[0]]


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("seed,noise", [(0, 0.1), (5, 0.1), (3, 0.4)])
def test_token_stream_is_the_reference(seed, noise):
    kw = dict(vocab=97, seq_len=16, batch=4, seed=seed, noise=noise)
    got, want = TokenStream(**kw), JStream(**kw)
    for step in (0, 1, 7, 123, 999):
        g, w = got.batch_at(step), want.batch_at(step)
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
        assert np.array_equal(g["labels"][:, :-1], g["tokens"][:, 1:])


# ----------------------------------------------------- stochastic rounding

@pytest.mark.parametrize("bits,scale", [(8, None), (4, None), (8, 0.01),
                                        (2, 0.5)])
def test_stochastic_rounding_bitwise_given_jax_uniforms(bits, scale):
    """``fake_quant(stochastic=True)`` fed the uniforms JAX draws from the
    key is the reference's output bit for bit, and so is its
    straight-through gradient."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((37, 19)) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(bits + 11)
    s = None if scale is None else jnp.asarray(scale, jnp.float32)
    jspec = JSpec(bits=bits, stochastic=True)
    f = lambda v: JQ.fake_quant(v, jspec, s, key=key)
    want = np.asarray(f(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: (f(v) * 1.5).sum())(
        jnp.asarray(x)))
    u = torch.from_numpy(np.array(
        jax.random.uniform(key, x.shape, jnp.float32)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = fake_quant(xt, QuantSpec(bits=bits, stochastic=True),
                     None if scale is None else torch.tensor(scale),
                     uniforms=u)
    (got * 1.5).sum().backward()
    assert np.array_equal(got.detach().numpy(), want)
    assert np.array_equal(xt.grad.numpy(), want_g)
    assert not np.array_equal(want, np.asarray(
        JQ.fake_quant(jnp.asarray(x), JSpec(bits=bits), s)))


def test_stochastic_rounding_is_unbiased_with_a_generator():
    """With a ``torch.Generator``: ``E[q] = x`` (the mean of 40000 draws
    within 4σ of each value: 0.0087 at x = 0.5), only the two neighbours
    are drawn, the same seed repeats, and a call with neither a generator
    nor uniforms is refused."""
    spec = QuantSpec(bits=8, stochastic=True)
    for v in (0.3, 0.5, -1.75, 2.9):
        x = torch.full((40000,), v)
        y = fake_quant(x, spec, torch.tensor(1.0),
                       generator=torch.Generator().manual_seed(0))
        assert abs(float(y.mean()) - v) < 4 * 0.5 / np.sqrt(40000)
        assert set(torch.unique(y).tolist()) <= {np.floor(v), np.ceil(v)}
    a = fake_quant(x, spec, generator=torch.Generator().manual_seed(3))
    b = fake_quant(x, spec, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert torch.equal(round_stochastic(torch.tensor([0.25, -0.25, -0.25]),
                                        torch.tensor([0.75, 0.5, 0.2])),
                       torch.tensor([1.0, 0.0, -1.0]))
    with pytest.raises(ValueError, match="generator or uniforms"):
        fake_quant(x, spec)


# ------------------------------------------------------------ compression

def _grad_tree(rng, scale=1.0):
    return {"b": {"w": (rng.standard_normal((3, 5, 7)) * scale
                        ).astype(np.float32),
                  "g": (rng.standard_normal(11) * 1e-3).astype(np.float32)},
            "a": np.zeros((4, 2), np.float32),
            "c": (rng.standard_normal((6, 9)) * scale).astype(np.float32)}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("slice_elems", [None, 8, 40])
def test_compress_tree_bitwise_given_jax_uniforms(slice_elems, monkeypatch):
    """Three steps of compress → decompress with the residual carried:
    the int8 payloads, the scales, the residuals and the decompressed
    gradients are the reference's bit for bit when the port takes the
    uniforms JAX draws from the split keys — also when a large leaf goes
    by runs of rows (``_SLICE``, shared with the in-place AdamW, lowered
    to reach it here: one row, or several rows, a run). The all-zero leaf
    takes the 1e-12 floor."""
    if slice_elems:
        monkeypatch.setattr(A, "_SLICE", slice_elems)
    rng = np.random.default_rng(0)
    g0 = _grad_tree(rng)
    js = JC.init_error_feedback(jax.tree.map(jnp.asarray, g0))
    ts = C.init_error_feedback(_torch_tree(g0))
    for step in range(3):
        g = _grad_tree(rng, scale=0.1 * (step + 1))
        key = jax.random.PRNGKey(step)
        jq, jsc, js = JC.compress_tree(jax.tree.map(jnp.asarray, g), js, key)
        leaves, tdef = jax.tree_util.tree_flatten(g)
        keys = jax.random.split(key, len(leaves))
        u = tdef.unflatten([np.asarray(jax.random.uniform(k, l.shape,
                                                          jnp.float32))
                            for k, l in zip(keys, leaves)])
        tq, tsc, ts = C.compress_tree(_torch_tree(g), ts,
                                      uniforms=_torch_tree(u))
        for want, got in ((jq, tq), (jsc, tsc), (js.residual, ts.residual),
                          (JC.decompress_tree(jq, jsc),
                           C.decompress_tree(tq, tsc))):
            for w, t in zip(_leaves_np(want), _leaves_t(got)):
                assert w.dtype == t.dtype and np.array_equal(w, t)
    assert float(tsc["a"]) == np.float32(1e-12) / np.float32(127.0)


def test_error_feedback_preserves_the_signal():
    """The reference's invariant with the port's generator: over 20 steps
    the sent signal plus the residual equals the total gradient within
    1e-3, and the wire is int8 with one f32 scale per leaf."""
    g_true = {"w": torch.from_numpy(
        np.random.default_rng(0).standard_normal(256).astype(np.float32)
        * 0.1)}
    state = C.init_error_feedback(g_true)
    acc = torch.zeros(256)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        q, s, state = C.compress_tree(g_true, state, gen)
        assert q["w"].dtype == torch.int8 and s["w"].dtype == torch.float32
        assert s["w"].dim() == 0
        acc = acc + C.decompress_tree(q, s)["w"]
    err = (acc + state.residual["w"] - 20 * g_true["w"]).abs().max()
    assert float(err) < 1e-3


def test_compression_release_and_refusal():
    """``release`` drops each raw gradient (and each int8 leaf on
    decompress) as soon as it is read; no noise source is refused."""
    g = {"w": torch.ones(4), "v": {"u": torch.ones(2)}}
    st = C.init_error_feedback(g)
    q, s, st = C.compress_tree(g, st, torch.Generator().manual_seed(0),
                               release=True)
    assert g == {"w": None, "v": {"u": None}}
    out = C.decompress_tree(q, s, release=True)
    assert q == {"w": None, "v": {"u": None}}
    assert torch.allclose(out["w"] + st.residual["w"], torch.ones(4))
    with pytest.raises(ValueError, match="generator or uniforms"):
        C.compress_tree({"w": torch.ones(1)}, st)


# ------------------------------------------------------------------ adam

@pytest.mark.parametrize("slice_elems", [None, 8, 40])
def test_adam_update_in_place_is_bitwise_functional(slice_elems,
                                                    monkeypatch):
    """``adam_update_`` writes the functional update into the tensors it
    is given: parameters, moments, step and metrics bit for bit over six
    steps (clip engaged on some), also by runs of rows of a large leaf."""
    if slice_elems:
        monkeypatch.setattr(A, "_SLICE", slice_elems)
    rng = np.random.default_rng(0)
    tree = _grad_tree(rng)
    cfg = A.AdamConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    fp = _torch_tree(tree)
    ip = _torch_tree(tree)
    fs, is_ = A.adam_init(fp), A.adam_init(ip)
    for step in range(6):
        g = _grad_tree(rng, scale=3.0 if step % 2 else 0.01)
        fp, fs, fm = A.adam_update(cfg, _torch_tree(g), fs, fp)
        ip2, is_, im = A.adam_update_(cfg, _torch_tree(g), is_, ip)
        assert ip2 is ip
        for k in ("lr", "grad_norm"):
            assert torch.equal(fm[k], im[k])
        assert torch.equal(fs.step, is_.step)
        for want, got in ((fp, ip), (fs.mu, is_.mu), (fs.nu, is_.nu)):
            for w, t in zip(_leaves_t(want), _leaves_t(got)):
                assert np.array_equal(w, t)


# ------------------------------------------------------------------ loss

def _models():
    jcfg = jax_get_smoke(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, get_smoke(ARCH), tp


def _bits_row(cfg, pid):
    names = JT.quant_layer_names(cfg)
    inner = [n for n in names if n.startswith("L1.")]
    from repro.core.profiles import profile_table
    return profile_table(jax_profiles(names, inner_layers=inner),
                         names)[pid]


def _lm_batch(cfg, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :7] = -100
    labels[1, s // 2 + 3] = -100
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_xent_and_train_loss_match_reference(chunk):
    """At two chunk sizes (4 and 2 chunks of S 64), with ``-100`` labels:
    ``chunked_xent`` on the reference's own hidden states, and
    ``train_loss`` (total, xent, aux) from the tokens, within 1e-5 of the
    reference's at A8-W8 and Mixed; a row whose labels are all masked
    counts nothing (the count's floor at 1 keeps an all-masked batch at
    0)."""
    jcfg, jp, cfg, tp = _models()
    jcfg = dataclasses.replace(jcfg, loss_chunk=chunk)
    cfg = dataclasses.replace(cfg, loss_chunk=chunk)
    batch = _lm_batch(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = jax.tree.map(jnp.asarray, batch)
    for pid in (2, 5):
        br = _bits_row(jcfg, pid)
        jl, jm = jax.jit(lambda p, b: JT.train_loss(p, jcfg, br, b))(jp, jb)
        tl, tm = T.train_loss(tp, cfg, br, tb)
        for got, want in ((tl, jl), (tm["xent"], jm["xent"]),
                          (tm["aux"], jm["aux"])):
            assert abs(float(got) - float(want)) <= TOL
        hidden = jax.jit(lambda p, b: JT.forward(p, jcfg, br, b)[0])(jp, jb)
        for labels in (batch["labels"], np.full_like(batch["labels"], -100)):
            want = JT.chunked_xent(jcfg, jp, br, hidden, jnp.asarray(labels))
            got = T.chunked_xent(cfg, tp, br,
                                 torch.from_numpy(np.array(hidden)),
                                 torch.from_numpy(labels))
            assert abs(float(got) - float(want)) <= TOL
    assert float(got) == 0.0


def test_chunk_must_divide_the_sequence():
    """The reference asserts ``S % chunk == 0``; the port refuses."""
    _, _, cfg, tp = _models()
    cfg = dataclasses.replace(cfg, loss_chunk=24)
    tb = {k: torch.from_numpy(v) for k, v in _lm_batch(cfg).items()}
    with pytest.raises(ValueError, match="does not divide"):
        T.train_loss(tp, cfg, _bits_row(jax_get_smoke(ARCH), 2), tb)


# ----------------------------------------------------------------- remat

def _count(monkeypatch, name):
    calls = {"n": 0}
    orig = getattr(T, name)

    def wrapped(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)
    monkeypatch.setattr(T, name, wrapped)
    return calls


@pytest.mark.parametrize("arch,policy", [
    ("granite-3-2b", "nothing"), ("granite-3-2b", "dots"),
    ("qwen2-moe-a2.7b", "nothing"), ("mamba2-130m", "dots"),
    ("hymba-1.5b", "nothing")])
def test_remat_is_bitwise_and_recomputes(arch, policy, monkeypatch):
    """With ``cfg.remat`` the loss and every gradient leaf are bitwise
    those without it, and the backward really recomputes: each layer body
    and each loss chunk runs twice (once without remat). With grad off
    the forward is bitwise the same and runs each layer once."""
    jcfg = jax_get_smoke(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    base = get_smoke(arch)
    batch = {k: torch.from_numpy(v)
             for k, v in _lm_batch(base, s=32, seed=1).items()}
    br = _bits_row(jcfg, 5)
    body = "_ssm_layer_forward" if base.family == "ssm" else "_layer_forward"
    layers, chunks = _count(monkeypatch, body), _count(monkeypatch,
                                                       "_chunk_loss")
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy,
                                  loss_chunk=16)
        layers["n"] = chunks["n"] = 0
        (loss, m), g = value_and_grad(
            lambda p, b: T.train_loss(p, cfg, br, b), tp, batch)
        runs[remat] = (loss, m, _leaves_t(g))
        assert layers["n"] == cfg.n_layers * (2 if remat else 1)
        assert chunks["n"] == 2 * (2 if remat else 1)
        with torch.no_grad():
            layers["n"] = 0
            h = T.forward(tp, cfg, br, batch)[0]
            assert layers["n"] == cfg.n_layers
        runs[remat] += (h,)
    (l0, m0, g0, h0), (l1, m1, g1, h1) = runs[False], runs[True]
    assert torch.equal(l0, l1) and torch.equal(h0, h1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(np.array_equal(a, b) for a, b in zip(g0, g1))


def test_backward_accumulates_with_no_atomics():
    """A granite training step's ops, forward and backward, as the
    dispatcher sees them: none of the ops PyTorch documents as
    accumulating with atomics on CUDA (``index_put_`` with accumulate —
    ``w[ids]``'s backward —, ``index_add``, ``scatter_add`` — ``gather``'s
    backward —, ``scatter_reduce``, ``put_``); the embedding's backward is
    the sorted ``embedding_dense_backward``. So a step on the card repeats
    bit for bit (held there by ``tests/test_torch_cuda.py``). The stacked
    leaves' per-layer views come from one ``unbind`` each, whose backward
    is one ``stack``, not a ``select_backward`` per layer."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            acc = kwargs.get("accumulate", args[3] if len(args) > 3
                             and isinstance(args[3], bool) else False)
            seen.append((name, bool(acc)))
            return func(*args, **(kwargs or {}))

    _, _, cfg, tp = _models()
    cfg = dataclasses.replace(cfg, remat=True)
    batch = {k: torch.from_numpy(v) for k, v in _lm_batch(cfg).items()}
    br = _bits_row(jax_get_smoke(ARCH), 2)
    with Record():
        value_and_grad(lambda p, b: T.train_loss(p, cfg, br, b), tp, batch)
    names = {n for n, _ in seen}
    assert "embedding_dense_backward" in names and "mm" in names
    # each stacked leaf is taken apart once (unbind: one stack in the
    # backward), not selected per layer (a zeroed full leaf per layer)
    assert "select_backward" not in names and "stack" in names
    bad = {n for n, acc in seen
           if n in ("index_add", "index_add_", "scatter_add", "scatter_add_",
                    "scatter_reduce", "scatter_reduce_", "put", "put_",
                    "index_reduce", "index_reduce_")
           or (n in ("index_put", "index_put_", "_index_put_impl_") and acc)}
    assert not bad, bad


# ------------------------------------------------------------------ loop

@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's ``train()`` on the launcher's setup, 8 steps,
    checkpointing every 2 (so steps 0, 2, 4, 6, 7)."""
    jcfg = jax_get_smoke(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    names = JT.quant_layer_names(jcfg)
    lo, hi = jcfg.n_layers // 3, 2 * jcfg.n_layers // 3
    inner = [n for n in names
             if n.startswith("L") and lo <= int(n[1:].split(".")[0]) < hi]
    eng = JEngine(tuple(jax_profiles(names, inner_layers=inner)),
                  JIndex(names), lambda p, br, b: JT.train_loss(p, jcfg, br, b))
    stream = JStream(vocab=jcfg.vocab, seq_len=S, batch=B, seed=0)

    def data_at(step):
        b = stream.batch_at(step)
        return {"tokens": jnp.asarray(b["tokens"]),
                "labels": jnp.asarray(b["labels"]),
                "profile_id": jnp.asarray(PIDS[step % len(PIDS)], jnp.int32)}

    def loss_fn(p, b):
        return eng(p, b["profile_id"], {"tokens": b["tokens"],
                                        "labels": b["labels"]})

    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    acfg = JAdamConfig(lr=LR, total_steps=STEPS, warmup_steps=2)
    out = JL.train(jp, loss_fn, data_at,
                   JL.TrainConfig(steps=STEPS, ckpt_dir=d, ckpt_every=2,
                                  keep=10, log_every=100), acfg,
                   log=lambda s: None)
    return {"params0": jp, "out": out, "dir": d, "table": eng.table}


def _port_run(monkeypatch_pids=True):
    """The launcher's smoke setup on the CPU, its data at the test's B, S
    and profiles."""
    run = LT.setup(LT.parse_args(["--device", "cpu", "--batch", str(B),
                                  "--seq", str(S), "--steps", str(STEPS),
                                  "--lr", str(LR)]))
    base = run.data_at

    def data_at(step):
        b = base(step)
        b["profile_id"] = PIDS[step % len(PIDS)]
        return b
    run.data_at = data_at
    run.adam_cfg = A.AdamConfig(lr=LR, total_steps=STEPS, warmup_steps=2)
    return run


def _close_to(ref, got):
    """The loop tolerance: parameters within 2e-6, moments within 1e-5 of
    each leaf's max-abs, the step equal."""
    for w, t in zip(_leaves_np(ref["params"]), _leaves_t(got["params"])):
        assert float(np.abs(w - t).max()) <= 2e-6
    for tree in ("mu", "nu"):
        for w, t in zip(_leaves_np(getattr(ref["opt"], tree)),
                        _leaves_t(getattr(got["opt"], tree))):
            assert float(np.abs(w - t).max()) <= TOL * max(
                float(np.abs(w).max()), 1e-30)
    assert int(got["opt"].step) == int(ref["opt"].step)


def test_train_matches_reference(reference_run):
    """The port's ``train()`` from the reference's weights, with the
    launcher's loss and data, against the reference's ``train()``: losses
    per step within 1e-5, then the final parameters and moments."""
    ref = reference_run["out"]
    run = _port_run()
    assert np.array_equal(run.engine.table, reference_run["table"])
    params = params_from_jax(
        jax.tree.map(np.asarray, reference_run["params0"]), "cpu")
    got = train(params, run.loss_fn, run.data_at,
                TrainConfig(steps=STEPS, log_every=100), run.adam_cfg,
                step_factory=run.step_factory, log=lambda s: None)
    assert len(got["history"]) == STEPS and got["last_step"] == STEPS - 1
    np.testing.assert_allclose(got["history"], ref["history"], rtol=0,
                               atol=TOL)
    _close_to(ref, got)


def test_resumes_a_reference_checkpoint(reference_run, tmp_path):
    """A state the reference's ``train()`` checkpointed at step 4 (its
    ``AdamState`` keyed by field name): the port's checkpoint manager
    reads the parameters and moments bitwise as ``params_from_jax``
    converts the reference's own restore of them; it resumes in the
    port's ``train()``, and steps 5–7 follow the reference's
    uninterrupted run within the loop tolerance."""
    import shutil
    d = str(tmp_path / "ck")
    os.makedirs(d)
    for name in ("step_000000004", "step_000000004.DONE"):
        src = os.path.join(reference_run["dir"], name)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(
            src, os.path.join(d, name))
    run = _port_run()
    from repro.checkpoint.manager import restore as jax_restore
    from repro.optim.adam import adam_init as jax_adam_init
    from repro_torch.checkpoint.manager import restore
    p0 = reference_run["params0"]
    (jp, jopt), _ = jax_restore(d, (p0, jax_adam_init(p0)))
    (tp, topt), _ = restore(d, (run.params, A.adam_init(run.params)),
                            device="cpu")
    for want, got in ((jp, tp), (jopt.mu, topt.mu), (jopt.nu, topt.nu)):
        conv = params_from_jax(jax.tree.map(np.asarray, want), "cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            _flatten(conv)[0], _flatten(got)[0]))
    assert topt.step.shape == () and int(topt.step) == int(jopt.step) == 5
    logs = []
    got = train(run.params, run.loss_fn, run.data_at,
                TrainConfig(steps=STEPS, ckpt_dir=d, ckpt_every=100,
                            log_every=100), run.adam_cfg,
                step_factory=run.step_factory, log=logs.append)
    assert logs[0] == "[train] resumed from step 4"
    ref = reference_run["out"]
    np.testing.assert_allclose(got["history"], ref["history"][5:], rtol=0,
                               atol=TOL)
    _close_to(ref, got)


def _act_grid(x, bits):
    """The activation fake-quant's grid in numpy: each token's pow2 scale
    from its amax (as ``fake_quant_dynamic_token`` picks it), ``x / s``
    and the index, rounded half away from zero."""
    amax = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-9))
    s = np.exp2(np.ceil(np.log2(amax / np.float32(2 ** (bits - 1)))))
    t = x / s
    q = np.clip(np.sign(t) * np.floor(np.abs(t) + 0.5), -2 ** (bits - 1),
                2 ** (bits - 1) - 1)
    return q, s, t


def _recorded_forward(jfwd, jrec, tloss, trec, jp, tp, batch, pid):
    """Both packages' loss from their own weights, with the input and bits
    of every activation fake-quant recorded in call order."""
    del jrec[:], trec[:]
    jl = float(jfwd(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                    jnp.asarray(pid, jnp.int32)))
    jax.effects_barrier()
    with torch.no_grad():
        tl = float(tloss(tp, {**{k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                              "profile_id": pid})[0])
    return jl, tl


@pytest.mark.parametrize("b,s,flip_step", [(2, 32, 3), (8, 64, 0)])
def test_loop_divergence_starts_at_a_grid_flip(b, s, flip_step,
                                               monkeypatch):
    """The witness behind the loop check's lr 1e-4 and B 2 x S 32: at lr
    1e-3 both packages step in lockstep from the same weights, each from
    its own state, with every activation fake-quant's input recorded.

    Before ``flip_step`` every grid index agrees, the losses are equal,
    the gradients agree within 1e-6 of each leaf's max-abs, and the
    parameters within 1e-6 except where Adam's first step met a gradient
    below 1e-7: there the update ``lr · g / (|g| + eps)`` turns a 1e-9
    difference of ``g`` into up to ``lr / 2`` (at B 2 x S 32 one element,
    1.2e-5 apart, the readings in ``ROADMAP.md`` Queue 3). At
    ``flip_step`` (the ``Mixed`` profile's first step at B 2 x S 32; the
    first step at B 8 x S 64) one activation's inputs, a few ulps apart,
    straddle a grid midpoint, so its index differs by one, and the loss
    parts by more than 1e-6."""
    import repro.models.layers as JLy
    import repro_torch.models.layers as TLy
    from repro.optim.adam import adam_init as jax_adam_init
    from repro.optim.adam import adam_update as jax_adam_update
    lr, pids = 1e-3, PIDS
    jcfg = jax_get_smoke(ARCH)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    names = JT.quant_layer_names(jcfg)
    lo, hi = jcfg.n_layers // 3, 2 * jcfg.n_layers // 3
    inner = [n for n in names
             if n.startswith("L") and lo <= int(n[1:].split(".")[0]) < hi]
    eng = JEngine(tuple(jax_profiles(names, inner_layers=inner)),
                  JIndex(names), lambda p, br, bt: JT.train_loss(p, jcfg,
                                                                 br, bt))
    jrec, trec = [], []
    jfq, tfq = JLy.fake_quant_dynamic_token, TLy.fake_quant_dynamic_token

    def jwrap(x, bits, ss):
        jax.debug.callback(lambda a, n: jrec.append((np.array(a), int(n))),
                           x, bits, ordered=True)
        return jfq(x, bits, ss)

    def twrap(x, bits, ss):
        trec.append((x.detach().float().numpy().copy(), int(bits)))
        return tfq(x, bits, ss)
    monkeypatch.setattr(JLy, "fake_quant_dynamic_token", jwrap)
    monkeypatch.setattr(TLy, "fake_quant_dynamic_token", twrap)
    acfg = JAdamConfig(lr=lr, total_steps=STEPS, warmup_steps=2)

    def jloss(p, bt, pid):
        return eng(p, pid, {"tokens": bt["tokens"], "labels": bt["labels"]})
    jfwd = jax.jit(lambda p, bt, pid: jloss(p, bt, pid)[0])

    @jax.jit
    def jstep(p, o, bt, pid):
        (loss, _), g = jax.value_and_grad(jloss, has_aux=True)(p, bt, pid)
        p, o, _ = jax_adam_update(acfg, g, o, p)
        return loss, g, p, o

    run = LT.setup(LT.parse_args(["--device", "cpu", "--batch", str(b),
                                  "--seq", str(s)]))
    tcfg = A.AdamConfig(lr=lr, total_steps=STEPS, warmup_steps=2)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jopt, topt = jax_adam_init(jp), A.adam_init(tp)
    stream = JStream(vocab=jcfg.vocab, seq_len=s, batch=b, seed=0)
    eps_region = None
    for step in range(flip_step + 1):
        x = stream.batch_at(step)
        batch = {"tokens": x["tokens"], "labels": x["labels"]}
        pid = pids[step % len(pids)]
        jl, tl = _recorded_forward(jfwd, jrec, run.loss_fn, trec, jp, tp,
                                   batch, pid)
        assert [r[0].shape for r in jrec] == [r[0].shape for r in trec]
        flips = []
        for (xj, nj), (xt, nt) in zip(jrec, trec):
            assert nj == nt
            (qj, sj, tj), (qt, st, tt) = _act_grid(xj, nj), _act_grid(xt, nt)
            if (qj != qt).any() or (sj != st).any():
                flips.append((qj, sj, tj, qt, st, tt))
        if step < flip_step:
            assert not flips and jl == tl
        else:
            assert flips and abs(jl - tl) > 1e-6
            qj, sj, tj, qt, st, tt = flips[0]
            assert np.array_equal(sj, st)
            at = qj != qt
            assert np.array_equal(np.abs(qj[at] - qt[at]), np.ones(at.sum()))
            mid = np.floor(np.abs(tj[at])) + 0.5
            assert ((np.abs(tj[at]) - mid) * (np.abs(tt[at]) - mid) < 0).all()
            assert (np.abs(np.abs(tj[at]) - mid) < 1e-5).all()
            assert (np.abs(np.abs(tt[at]) - mid) < 1e-5).all()
            return
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, jg, jp, jopt = jstep(jp, jopt, jb, jnp.asarray(pid, jnp.int32))
        (tloss, _), tg = value_and_grad(run.loss_fn, tp, {
            **{k: torch.from_numpy(v) for k, v in batch.items()},
            "profile_id": pid})
        tp, topt, _ = A.adam_update(tcfg, tg, topt, tp)
        assert float(loss) == float(tloss)
        jgl, tgl = _leaves_np(jg), _leaves_t(tg)
        for w, t in zip(jgl, tgl):
            assert np.abs(w - t).max() <= 1e-6 * np.abs(w).max()
        if eps_region is None:
            eps_region = [np.abs(w) < 1e-7 for w in jgl]
        for w, t, e in zip(_leaves_np(jp), _leaves_t(tp), eps_region):
            d = np.abs(w - t)
            assert d[~e].max(initial=0) <= 1e-6
            assert d[e].max(initial=0) <= lr / 2
    raise AssertionError("unreachable")


def _regression():
    """The reference fault-tolerance test's regression, in torch."""
    w_true = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    params = {"w": torch.zeros(8, 4)}

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        l = torch.mean((pred - batch["y"]) ** 2)
        return l, {"mse": l}

    def data_at(step):
        x = torch.randn(32, 8,
                        generator=torch.Generator().manual_seed(1000 + step))
        return {"x": x, "y": x @ w_true}

    return params, loss_fn, data_at


def test_restart_bit_exact(tmp_path):
    """Die at step 12, restart from the step-10 checkpoint: the final
    parameters and moments are bitwise the uninterrupted run's, and it
    learns. A third start on the finished directory runs nothing and
    returns the last state (``last_step`` 19; the reference's loop raises
    ``UnboundLocalError`` there)."""
    params, loss_fn, data_at = _regression()
    acfg = A.AdamConfig(lr=1e-2, total_steps=20, warmup_steps=2)
    ref = train(params, loss_fn, data_at,
                TrainConfig(steps=20, ckpt_dir=str(tmp_path / "ref"),
                            ckpt_every=5, log_every=100), acfg,
                log=lambda s: None)
    ckpt = str(tmp_path / "fail")
    with pytest.raises(RuntimeError, match="injected failure"):
        train(params, loss_fn, data_at,
              TrainConfig(steps=20, ckpt_dir=ckpt, ckpt_every=5,
                          fail_at_step=12, log_every=100), acfg,
              log=lambda s: None)
    assert latest_step(ckpt) == 10
    resumed = train(params, loss_fn, data_at,
                    TrainConfig(steps=20, ckpt_dir=ckpt, ckpt_every=5,
                                log_every=100), acfg, log=lambda s: None)
    assert torch.equal(ref["params"]["w"], resumed["params"]["w"])
    assert torch.equal(ref["opt"].mu["w"], resumed["opt"].mu["w"])
    assert torch.equal(ref["opt"].nu["w"], resumed["opt"].nu["w"])
    assert ref["history"][-1] < ref["history"][0]
    assert params["w"].abs().sum() == 0          # the caller's tree is kept
    done = train(params, loss_fn, data_at,
                 TrainConfig(steps=20, ckpt_dir=ckpt, log_every=100), acfg,
                 log=lambda s: None)             # nothing left to run
    assert done["history"] == [] and done["last_step"] == 19
    assert torch.equal(done["params"]["w"], resumed["params"]["w"])


def test_smoke_lm_restart_bit_exact(tmp_path):
    """The launcher's smoke LM (in-place steps, profiles rotating) dies at
    step 5 and a new launch resumes from its step-4 checkpoint: the final
    parameters and moments are bitwise the uninterrupted run's. A run
    hands its initial weights over, and the resume drops them before the
    checkpoint is read (no second copy of the weights beside the
    restored one)."""
    import weakref
    argv = ["--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "32"]

    def launch(name, fail=None):
        run = LT.setup(LT.parse_args(argv + ["--ckpt-dir",
                                             str(tmp_path / name)]))
        run.train_cfg = dataclasses.replace(run.train_cfg, ckpt_every=4,
                                            fail_at_step=fail)
        return run

    ref = launch("ref").run(log=lambda s: None)
    run = launch("fail", 5)
    with pytest.raises(RuntimeError, match="injected failure"):
        run.run(log=lambda s: None)
    assert latest_step(str(tmp_path / "fail")) == 4
    assert run.params is None
    with pytest.raises(RuntimeError, match="handed over"):
        run.run(log=lambda s: None)
    run = launch("fail")
    initial = [weakref.ref(t) for t in _flatten(run.params)[0]]
    gone = []
    resumed = run.run(log=lambda s: gone.append(
        all(r() is None for r in initial)) if "resumed" in s else None)
    assert gone == [True]
    assert len(resumed["history"]) == 3
    assert resumed["history"] == ref["history"][5:]
    for tree in (lambda o: o["params"], lambda o: o["opt"].mu,
                 lambda o: o["opt"].nu):
        for a, b in zip(_leaves_t(tree(ref)), _leaves_t(tree(resumed))):
            assert np.array_equal(a, b)


def test_checkpoint_keeps_a_0d_leaf(tmp_path):
    """``AdamState.step`` is 0-d: it comes back 0-d (a restored step of
    shape ``(1,)`` was saved again as such and then refused against the
    0-d template), keyed by field name as JAX keys it."""
    from repro_torch.checkpoint.manager import restore, save
    state = A.adam_init({"w": torch.ones(3)})
    save(str(tmp_path), 1, (state,))
    (got,), meta = restore(str(tmp_path), (state,), device="cpu")
    assert got.step.shape == () and got.step.dtype == torch.int32
    assert sorted(meta["keys"]) == ["0/mu/w", "0/nu/w", "0/step"]
    flat, _ = restore(str(tmp_path), device="cpu")
    assert flat["0"]["step"].shape == ()


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=10, k_sigma=3.0, min_steps=5)
    for i in range(10):
        assert not mon.record(i, 0.10 + 0.001 * (i % 3))
    assert mon.record(10, 0.5)          # 5× the mean → flagged
    assert mon.flagged and mon.flagged[0][0] == 10
    assert not mon.record(11, 0.101)    # back to normal


def test_preemption_checkpoints(tmp_path):
    """SIGTERM during step 7: the loop finishes the step, checkpoints it
    and exits; the handler is restored afterwards."""
    params, loss_fn, data_at = _regression()
    ckpt = str(tmp_path / "pre")

    def data_with_sigterm(step):
        if step == 7:
            os.kill(os.getpid(), signal.SIGTERM)  # simulated preemption
        return data_at(step)

    before = signal.getsignal(signal.SIGTERM)
    out = train(params, loss_fn, data_with_sigterm,
                TrainConfig(steps=50, ckpt_dir=ckpt, ckpt_every=100,
                            log_every=100),
                A.AdamConfig(lr=1e-2, total_steps=50, warmup_steps=2),
                log=lambda s: None)
    assert out["last_step"] == 7 and len(out["history"]) == 8
    assert latest_step(ckpt) == 7
    assert signal.getsignal(signal.SIGTERM) is before


# -------------------------------------------------------------- launcher

@pytest.mark.parametrize("compression", [False, True])
def test_launcher_on_the_cpu_trains_and_resumes(tmp_path, capsys,
                                                compression):
    """``python -m repro_torch.launch.train --device cpu``: finite losses,
    the reference's log lines, and a second launch on the same
    ``--ckpt-dir`` resumes from the last step."""
    argv = ["--device", "cpu", "--steps", "6", "--ckpt-dir",
            str(tmp_path)] + (["--grad-compression"] if compression else [])
    out = LT.main(argv)
    assert len(out["history"]) == 6 and np.isfinite(out["history"]).all()
    printed = capsys.readouterr().out
    assert "[train] granite-3-2b-smoke:" in printed
    assert "[train] done: loss" in printed
    out = LT.main(argv[:3] + ["9"] + argv[4:])
    assert "[train] resumed from step 5" in capsys.readouterr().out
    assert len(out["history"]) == 3 and np.isfinite(out["history"]).all()


def test_launcher_profiles_and_refusals():
    """The profile rotation (``step % 6``; ``Mixed`` at A4-W4 on the inner
    third of the layers, as the reference's launcher builds it),
    ``--profile``, the refused frontend archs, and no silent CPU."""
    run = LT.setup(LT.parse_args(["--device", "cpu"]))
    jcfg = jax_get_smoke(ARCH)
    names = JT.quant_layer_names(jcfg)
    lo, hi = jcfg.n_layers // 3, 2 * jcfg.n_layers // 3
    inner = [n for n in names
             if n.startswith("L") and lo <= int(n[1:].split(".")[0]) < hi]
    from repro.core.profiles import profile_table
    assert np.array_equal(run.engine.table, profile_table(
        jax_profiles(names, inner_layers=inner), names))
    assert [run.data_at(s)["profile_id"] for s in range(8)] == \
        [0, 1, 2, 3, 4, 5, 0, 1]
    fixed = LT.setup(LT.parse_args(["--device", "cpu", "--profile",
                                    "Mixed"]))
    assert {fixed.data_at(s)["profile_id"] for s in range(3)} == {5}
    for arch in ("hubert-xlarge", "qwen2-vl-2b"):
        with pytest.raises(SystemExit, match="token-LM launcher"):
            LT.setup(LT.parse_args(["--device", "cpu", "--arch", arch]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LT.setup(LT.parse_args([]))
