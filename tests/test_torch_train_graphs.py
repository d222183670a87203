"""The training step and the CNN's QAT step on CUDA graphs
(``TrainGraphs`` in ``repro_torch/train/graphs.py``) on the CPU, where no
graph is captured: the capture stand-in returns the step itself as its
replay, so the staging, the fixed buffers, the write-back and the
bookkeeping run eagerly.

* the graphed ``train()`` on the launcher's granite smoke setup, the six
  profiles in turn for 8 steps, equals the eager port bit for bit; the
  captures are the six profile ids, none twice
  (``assert_train_executables``); with the profiles of
  ``tests/test_torch_train.py``'s loop check in turn it is within that
  file's ``_close_to`` tolerance of the JAX ``train()`` (the A16 grid is
  inexact in JAX on the CPU, so the A16 profiles' steps part from it
  beyond that tolerance: 2.1e-5 in the loss by step 3);
* after every step the parameters, moments and step counter are the
  tensors the graphs were captured on, and the counter advances;
* the same with ``--grad-compression`` (the generator reseeded before each
  replay), and for a graphed resume from a checkpoint;
* the functional step (``make_train_step``) replays too, its new tensors
  written back into the fixed ones;
* the CNN's ``train_profile`` with graphs equals the eager one bit for
  bit, and a forward replays from one graph per input shape;
* ``graphs=True`` with no capture raises on the CPU, and a second capture
  of one profile id fails the tracker's check.

Tolerances: bitwise wherever the port meets itself (the graphed path runs
the eager step's ops on the same inputs); against JAX the loop tolerance
of ``tests/test_torch_train.py`` (its docstring gives the reasons).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core.engine import AdaptiveEngine as JEngine
from repro.core.engine import QuantIndex as JIndex
from repro.core.profiles import paper_profiles as jax_profiles
from repro.data.tokens import TokenStream as JStream
from repro.models import transformer as JT
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.train import loop as JL
from repro_torch.analysis.tracker import (assert_train_executables,
                                          train_captures)
from repro_torch.checkpoint.manager import latest_step
from repro_torch.core.profiles import paper_profiles, profile_table
from repro_torch.launch import repro_cnn as L
from repro_torch.launch import train as LT
from repro_torch.models import cnn as C
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adam as A
from repro_torch.train import graphs as G
from repro_torch.train.loop import TrainConfig, _flatten, train
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-3-2b"
B, S, LR, STEPS = 2, 32, 1e-4, 8
PIDS = (2, 3, 4, 5)                  # A8-W8, A8-W4, A4-W4, Mixed
CPU = torch.device("cpu")


def stand_in(step, stream, pool, generators=()):
    """A capture that records nothing: the step is its own replay."""
    return step


def _leaves(out) -> list:
    return [t for tree in (out["params"], out["opt"].mu, out["opt"].nu)
            for t in _flatten(tree)[0]]


def _same(a: dict, b: dict) -> None:
    """Two runs' losses, parameters, moments and step bit for bit."""
    assert a["history"] == b["history"]
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert int(a["opt"].step) == int(b["opt"].step)


def _setup(*extra):
    run = LT.setup(LT.parse_args(["--device", "cpu", "--batch", str(B),
                                  "--seq", str(S), "--steps", str(STEPS),
                                  "--lr", str(LR), *extra]))
    run.adam_cfg = A.AdamConfig(lr=LR, total_steps=STEPS, warmup_steps=2)
    return run


def _run(run, graphed: bool, params=None, **kw):
    return train(run.params if params is None else params, run.loss_fn,
                 run.data_at, kw.pop("cfg", TrainConfig(steps=STEPS,
                                                         log_every=100)),
                 run.adam_cfg, step_factory=run.step_factory,
                 log=lambda s: None,
                 **({"capture": stand_in} if graphed else {"graphs": False}),
                 **kw)


@pytest.fixture(scope="module")
def jax_run():
    """The reference's ``train()`` on the launcher's setup, the loop
    check's profiles in turn (``PIDS``)."""
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
                "profile_id": jnp.asarray(PIDS[step % len(PIDS)],
                                          jnp.int32)}

    def loss_fn(p, b):
        return eng(p, b["profile_id"], {"tokens": b["tokens"],
                                        "labels": b["labels"]})

    out = JL.train(jp, loss_fn, data_at,
                   JL.TrainConfig(steps=STEPS, log_every=100),
                   JAdamConfig(lr=LR, total_steps=STEPS, warmup_steps=2),
                   log=lambda s: None)
    return {"params0": jp, "out": out}


def test_graphed_train_equals_eager():
    """Eight steps over the six profiles (the launcher's ``step % 6``):
    graphed = eager bit for bit (losses, parameters, moments, step); six
    captures, one per profile id, two replays, every step in the one
    lifetime."""
    runs = {g: _run(_setup(), g) for g in (False, True)}
    eager, graphed = runs[False], runs[True]
    assert eager["graphs"] is None
    _same(eager, graphed)
    g = graphed["graphs"]
    assert train_captures(g) == [0, 1, 2, 3, 4, 5]
    assert g.runs == STEPS and g.replays == STEPS - 6
    assert_train_executables(g, steps=len(graphed["history"]))


def test_graphed_train_matches_reference(jax_run):
    """The graphed ``train()`` from the reference's weights, the loop
    check's profiles in turn, against the reference's ``train()``: losses
    within 1e-5, parameters and moments within ``_close_to``; one capture
    per profile id."""
    from test_torch_train import _close_to
    run = _setup()
    base = run.data_at

    def data_at(step):
        return {**base(step), "profile_id": PIDS[step % len(PIDS)]}
    run.data_at = data_at
    p0 = params_from_jax(jax.tree.map(np.asarray, jax_run["params0"]), "cpu")
    got = _run(run, True, p0)
    np.testing.assert_allclose(got["history"], jax_run["out"]["history"],
                               rtol=0, atol=1e-5)
    _close_to(jax_run["out"], got)
    assert train_captures(got["graphs"]) == list(PIDS)
    assert_train_executables(got["graphs"], steps=STEPS)


@pytest.mark.parametrize("extra", [(), ("--grad-compression",)])
def test_leaves_stay_the_captured_tensors(extra):
    """Stepping ``TrainGraphs`` by hand: after every step (a capture or a
    replay) the parameters, moments and step counter are the tensors the
    first capture saw, the counter reads the steps taken, the metrics are
    the fixed output buffers, and the batch's arrays went into the fixed
    input buffers; with ``--grad-compression`` the residual is the one
    the graphs write. Each value equals the eager steps'."""
    outs = {}
    for graphed in (False, True):
        run = _setup(*extra)
        step = run.step_factory(run.loss_fn, run.adam_cfg)
        params = run._take_params()
        opt = A.adam_init(params)
        if not graphed:
            for i in range(STEPS):
                params, opt, m = step(params, opt, run.data_at(i))
            outs[graphed] = (params, opt, run.ef["state"])
            continue
        tg = G.TrainGraphs(step, CPU, stand_in)
        assert tg.generators == ((step.generators[0],) if extra else ())
        leaves = [t for t, _ in G._pairs((params, opt), (params, opt))]
        residual = run.ef["state"]
        for i in range(STEPS):
            batch = run.data_at(i)
            p, o, m = tg.run(params, opt, batch)
            assert p is params and o is opt
            assert all(a is b for a, (b, _) in zip(
                leaves, G._pairs((p, o), (p, o))))
            assert int(o.step) == i + 1
            assert m is tg.metrics and set(m) == {"loss", "xent", "aux",
                                                  "grad_norm", "lr"}
            assert torch.equal(tg.inputs["tokens"], batch["tokens"])
            assert run.ef["state"] is residual
        assert tg.captured == [0, 1, 2, 3, 4, 5] and tg.runs == STEPS
        outs[graphed] = (params, opt, run.ef["state"])
    (p0, o0, r0), (p1, o1, r1) = outs[False], outs[True]
    assert int(o0.step) == int(o1.step) == STEPS
    for tree0, tree1 in ((p0, p1), (o0.mu, o1.mu), (o0.nu, o1.nu)) + (
            ((r0.residual, r1.residual),) if extra else ()):
        assert all(torch.equal(a, b) for a, b in zip(_flatten(tree0)[0],
                                                     _flatten(tree1)[0]))


def test_compressed_train_graphed_equals_eager():
    """``--grad-compression`` through ``train()``: graphed = eager bit for
    bit; the step's generator is the one each replay reseeds."""
    runs = {g: _run(_setup("--grad-compression"), g) for g in (False, True)}
    _same(runs[False], runs[True])
    assert_train_executables(runs[True]["graphs"], steps=STEPS)


def test_graphed_resume_from_a_checkpoint(tmp_path):
    """A graphed run that fails at step 5 and resumes from its step-4
    checkpoint (a new lifetime, captured on the restored tensors) ends
    bit for bit where the uninterrupted eager run ends; the resumed
    lifetime captures the profile ids of steps 5-7 only."""
    ref = _run(_setup(), False)
    d = str(tmp_path / "ck")
    cfg = TrainConfig(steps=STEPS, ckpt_dir=d, ckpt_every=4, log_every=100,
                      fail_at_step=5)
    with pytest.raises(RuntimeError, match="injected failure"):
        _run(_setup(), True, cfg=cfg)
    assert latest_step(d) == 4
    cfg = dataclasses.replace(cfg, fail_at_step=None)
    got = _run(_setup(), True, cfg=cfg)
    assert got["history"] == ref["history"][5:]
    assert all(torch.equal(x, y) for x, y in zip(_leaves(ref),
                                                 _leaves(got)))
    assert int(got["opt"].step) == STEPS
    assert train_captures(got["graphs"]) == [5, 0, 1]
    assert_train_executables(got["graphs"], steps=3)


def test_functional_step_replays_with_write_back():
    """``make_train_step`` (the reference's functional step, new tensors
    each step) under graphs: its results are copied into the fixed
    tensors, so the run equals the eager functional run bit for bit and
    keeps the tensors it started with."""
    g = torch.Generator().manual_seed(0)
    w_true = torch.randn(8, 4, generator=g)

    def loss_fn(p, b):
        err = ((b["x"] @ p["w"] - b["y"]) ** 2).mean()
        return err, {"mse": err}

    def data_at(step):
        x = torch.randn(16, 8, generator=torch.Generator().manual_seed(step))
        return {"x": x, "y": x @ w_true}

    acfg = A.AdamConfig(lr=1e-2, total_steps=10, warmup_steps=2)
    outs = []
    for kw in ({"graphs": False}, {"capture": stand_in}):
        w = torch.zeros(8, 4)
        out = train({"w": w}, loss_fn, data_at, TrainConfig(
            steps=10, log_every=100), acfg, log=lambda s: None, **kw)
        outs.append(out)
    eager, graphed = outs
    assert graphed["params"]["w"] is not eager["params"]["w"]
    assert torch.equal(eager["params"]["w"], graphed["params"]["w"])
    assert torch.equal(eager["opt"].nu["w"], graphed["opt"].nu["w"])
    assert eager["history"] == graphed["history"]
    assert int(graphed["opt"].step) == 10
    assert train_captures(graphed["graphs"]) == [None]


def test_adam_step_advances_in_place():
    """``adam_update_`` advances the 0-d int32 step it is given (a graph
    of it replays on that tensor) and returns it; the bias corrections
    made by a device fill are ``torch.tensor(b)``'s bit for bit."""
    cfg = A.AdamConfig(warmup_steps=3, total_steps=50)
    p = {"w": torch.ones(5)}
    st = A.adam_init(p)
    step = st.step
    for i in range(1, 41):
        _, st2, _ = A.adam_update_(cfg, {"w": torch.full((5,), 0.5)}, st, p)
        assert st2.step is step and int(step) == i and step.dim() == 0
        sf = step.to(torch.float32)
        b1c, b2c = A._corrections(cfg, step)
        assert torch.equal(b1c, 1 - torch.pow(torch.tensor(cfg.b1), sf))
        assert torch.equal(b2c, 1 - torch.pow(torch.tensor(cfg.b2), sf))


def _cnn_case():
    profs = paper_profiles(C.CNN_LAYERS, inner_layers=["conv1"])
    table = profile_table(profs, C.CNN_LAYERS)
    x, y = L._train_data()
    return table, (x[:768], y[:768])


@pytest.mark.parametrize("pid", [2, 5])
def test_cnn_train_profile_graphed_equals_eager(pid):
    """The CNN's QAT (8 channels, 6 steps of batch 256) at A8-W8 and
    Mixed: the graphed ``train_profile`` (one lifetime, one capture)
    gives the eager one's parameters bit for bit, and the eager one
    (now the in-place AdamW) the functional update's."""
    table, data = _cnn_case()
    kw = dict(steps=6, device="cpu", channels=8, data=data)
    eager = L.train_profile(pid, table, graphs=False, **kw)
    graphed = L.train_profile(pid, table, capture=stand_in, **kw)
    params = C.init_cnn(C.CNNConfig(channels=8),
                        torch.Generator().manual_seed(0), "cpu")
    opt = A.adam_init(params)
    acfg = A.AdamConfig(lr=1e-3, total_steps=6, warmup_steps=10)
    it = L.batches(*data, L.BATCH, seed=3 + pid)
    for _ in range(6):
        x, y = next(it)
        _, g = C.cnn_loss_and_grad(params, table[pid], {
            "images": torch.from_numpy(x), "labels": torch.from_numpy(y)})
        params, opt, _ = A.adam_update(acfg, g, opt, params)
    for ln in params:
        for k in params[ln]:
            assert torch.equal(eager[ln][k], graphed[ln][k])
            assert torch.equal(eager[ln][k], params[ln][k])


def test_forward_replays_one_graph_per_shape():
    """``CallGraphs`` over the CNN's forward: one capture per input shape,
    the replays' logits the eager forward's bit for bit, and the
    counters' bookkeeping (one warm-up, then replays)."""
    table, (x, _) = _cnn_case()
    params = C.init_cnn(C.CNNConfig(channels=8),
                        torch.Generator().manual_seed(0), "cpu")
    fwd = G.CallGraphs(lambda t: C.cnn_forward(params, table[2], t), CPU,
                       stand_in)
    for n in (4, 1, 4, 4, 1):
        t = torch.from_numpy(x[n:2 * n])
        assert torch.equal(fwd(t), C.cnn_forward(params, table[2], t))
    assert fwd.captured == [(((4, 28, 28, 1), torch.float32),),
                            (((1, 28, 28, 1), torch.float32),)]
    assert fwd.replays == 3


def test_graphs_refuse_the_cpu():
    """``graphs=True`` with no capture stand-in raises on the CPU (the
    CUDA capture), for ``train()``, the CNN's QAT, its latency and its
    accuracy; by default each runs eagerly there."""
    run = _setup()
    with pytest.raises(ValueError, match="CUDA"):
        run.run(log=lambda s: None, graphs=True)
    table, data = _cnn_case()
    with pytest.raises(ValueError, match="CUDA"):
        L.train_profile(2, table, steps=1, device="cpu", channels=8,
                        data=data, graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        L.measure_ms(lambda: None, CPU, graphs=True)
    params = C.init_cnn(C.CNNConfig(channels=8),
                        torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        C.cnn_accuracy(params, table[2], data[0][:8], data[1][:8], batch=4,
                       graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        G.TrainGraphs(lambda p, o, b: (p, o, {}), CPU)
    assert _setup().run(log=lambda s: None)["graphs"] is None


def test_a_lifetime_refuses_other_tensors():
    """The graphs serve the tensors they were captured on: other
    parameters, or a batch of another shape, are refused."""
    run = _setup()
    step = run.step_factory(run.loss_fn, run.adam_cfg)
    params = run._take_params()
    opt = A.adam_init(params)
    tg = G.TrainGraphs(step, CPU, stand_in)
    tg.run(params, opt, run.data_at(0))
    other = {k: v for k, v in params.items()}
    other["norm_f"] = {k: v.clone() for k, v in params["norm_f"].items()}
    with pytest.raises(ValueError, match="captured on"):
        tg.run(other, opt, run.data_at(1))
    b = run.data_at(1)
    b["tokens"] = b["tokens"][:, :16]
    with pytest.raises(ValueError, match="tokens"):
        tg.run(params, opt, b)


def test_a_second_capture_of_an_id_fails_the_check():
    """``assert_train_executables`` holds a lifetime to one capture per
    profile id used: a second capture of id 2, an id used but never
    captured, or steps run outside the lifetime each fail it."""
    tg = G.TrainGraphs(lambda p, o, b: (p, o, {}), CPU, stand_in)
    tg.captured, tg.used, tg.runs = [0, 2], {0, 2}, 5
    assert_train_executables(tg, steps=5)
    tg.captured = [0, 2, 2]
    with pytest.raises(AssertionError, match="captured again: \\[2\\]"):
        assert_train_executables(tg)
    tg.captured, tg.used = [0, 2], {0, 2, 3}
    with pytest.raises(AssertionError, match="once each"):
        assert_train_executables(tg)
    tg.used = {0, 2}
    with pytest.raises(AssertionError, match="4 of the run's"):
        tg.runs = 4
        assert_train_executables(tg, steps=5)
    with pytest.raises(AssertionError, match="eager"):
        assert_train_executables(None)


def test_cnn_numerics_are_deterministic():
    """The CNN launcher's numerics (``_f32``): TF32 off and cuDNN's
    deterministic algorithms (benchmark off) inside, every flag restored
    after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
              matmul.allow_tf32)
    with L._f32():
        assert (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
                matmul.allow_tf32) == (False, True, False, False)
    assert (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            matmul.allow_tf32) == before
