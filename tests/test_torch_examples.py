"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/*.py``, loaded by file path) at the reference examples' sizes
on the CPU, with the reference's weights (``params_from_jax``), and the
port's serve launcher's flags against the reference launcher's.

* quickstart: the merge report equal, each profile's loss within 1e-4 (on
  the reference's own batch; JAX's A16 grid is inexact on the CPU);
* serve_adaptive_lm: tokens and profile traces equal at kv16 and kv8, the
  energy spent within 1e-9 relative (the port given the reference's
  ``TPU_V5E`` figures);
* train_restartable_lm: the launcher's arguments equal the reference
  example's, and 2 steps run;
* adaptive_cnn: 2 steps at 4 channels, ``--force`` accepted;
* the launchers: every flag both have has the same dest and default,
  ``--paged-kv`` included, and ``--full`` draws the reference's prompts
  from the same seed on the reference's 256 slots and 4 rows.
"""
import argparse
import importlib.util
import inspect
import os
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke
from repro.launch import serve as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.core.energy import TPU_V5E
from repro_torch.examples import adaptive_cnn as AC
from repro_torch.examples import quickstart as QS
from repro_torch.examples import serve_adaptive_lm as SA
from repro_torch.examples import train_restartable_lm as TRL
from repro_torch.launch import serve as S
from repro_torch.models.convert import params_from_jax
from torch_threads import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _example(name: str):
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    keep, sys.dont_write_bytecode = sys.dont_write_bytecode, True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.dont_write_bytecode = keep
    return mod


@pytest.fixture(scope="module")
def jax_params():
    """The reference examples' weights: ``init_params(PRNGKey(0))``."""
    jp = JT.init_params(get_smoke("granite-3-2b"), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


class _Stop(Exception):
    pass


def test_quickstart_matches_reference(monkeypatch, capsys):
    ref = _example("quickstart")
    seen: dict = {"losses": []}

    class Engine(ref.AdaptiveEngine):
        def merge_report(self, *a, **kw):
            seen["report"] = super().merge_report(*a, **kw)
            return seen["report"]

    class Jax:                           # the example's jax, its jit recorded
        random = jax.random

        @staticmethod
        def jit(fn):
            jf = jax.jit(fn)

            def call(params, pid, batch):
                seen.update(params=params, batch=batch)
                out = jf(params, pid, batch)
                seen["losses"].append(float(out[0]))
                return out
            return call

    monkeypatch.setattr(ref, "AdaptiveEngine", Engine)
    monkeypatch.setattr(ref, "jax", Jax)
    ref.main()
    params = params_from_jax(jax.tree.map(np.asarray, seen["params"]),
                             device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             seen["batch"].items()}
    capsys.readouterr()
    got = QS.run(device="cpu", params=params, batch=batch)
    assert "one engine, six profiles" in capsys.readouterr().out
    assert got["report"] == seen["report"]
    assert list(got["losses"]) == ["A16-W8", "A16-W4", "A8-W8", "A8-W4",
                                   "A4-W4", "Mixed"]
    np.testing.assert_allclose(list(got["losses"].values()), seen["losses"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_serve_adaptive_lm_matches_reference(jax_params, kv_bits,
                                             monkeypatch):
    ref = _example("serve_adaptive_lm")
    seen: dict = {}

    class Server(ref.AdaptiveServer):
        def serve(self, requests):
            seen["results"] = super().serve(requests)
            seen["manager"] = self.manager
            return seen["results"]

    monkeypatch.setattr(ref, "AdaptiveServer", Server)
    monkeypatch.setattr(sys, "argv", ["serve_adaptive_lm", "--kv-bits",
                                      str(kv_bits)])
    ref.main()
    got = SA.run(kv_bits=kv_bits, device="cpu", params=jax_params[1],
                 hw=TPU_V5E)
    assert len(got["results"]) == len(seen["results"]) == 8
    for g, w in zip(got["results"], seen["results"]):
        assert g["tokens"] == [int(t) for t in w["tokens"]]
        assert g["profile_trace"] == list(w["profile_trace"])
    want = seen["manager"].spent_j
    assert abs(got["manager"].spent_j - want) <= 1e-9 * abs(want)
    assert got["manager"]._saver == seen["manager"]._saver
    hw = inspect.signature(SA.run).parameters["hw"].default
    assert hw.name == "h100-sxm"                       # the port's own


def test_train_restartable_lm_argv_and_two_steps(tmp_path, monkeypatch):
    ref = _example("train_restartable_lm")
    seen = []
    monkeypatch.setattr(ref, "train_main", lambda: seen.append(sys.argv[1:]))
    d = str(tmp_path / "ckpt")
    for argv in (["--ckpt-dir", d],
                 ["--steps", "2", "--ckpt-dir", d, "--grad-compression"],
                 ["--arch", "mamba2-130m", "--ckpt-dir", d]):
        monkeypatch.setattr(sys, "argv", ["train_restartable_lm"] + argv)
        ref.main()
        assert TRL.launcher_argv(TRL.parse_args(argv)) == seen[-1]
    assert TRL.parse_args([]).ckpt_dir == os.path.join(
        tempfile.gettempdir(), "aqe_ckpt")
    out = TRL.main(["--steps", "2", "--ckpt-dir", d, "--device", "cpu"])
    assert len(out["history"]) == 2
    assert all(np.isfinite(out["history"]))
    assert os.listdir(d)


def test_adaptive_cnn_runs(capsys):
    args = AC.parse_args(["--steps", "2", "--device", "cpu", "--force"])
    assert (args.steps, args.device, args.force) == (2, "cpu", True)
    out = AC.run(steps=args.steps, channels=4, device=args.device)
    assert len(out["table1"]["rows"]) == 6
    text = capsys.readouterr().out
    assert "Table 1 analogue" in text and "battery budget" in text


def _parser(fn, *args) -> argparse.ArgumentParser:
    """The parser ``fn`` builds, caught at its ``parse_args``."""
    seen = []

    def catch(self, *a, **kw):
        seen.append(self)
        raise _Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Stop):
            fn(*args)
    return seen[0]


def test_launchers_share_dests_and_defaults():
    ref, port = _parser(JL.main), _parser(S.parse_args, [])
    rflags = {o: a for a in ref._actions for o in a.option_strings}
    pflags = {o: a for a in port._actions for o in a.option_strings}
    shared = sorted(set(rflags) & set(pflags) - {"-h", "--help"})
    assert set(rflags) - set(pflags) == set()
    assert "--paged-kv" in shared and "--no-paged-kv" in shared
    for o in shared:
        assert (pflags[o].dest, pflags[o].default) == \
            (rflags[o].dest, rflags[o].default), o
    assert S.parse_args(["--no-paged-kv"]).paged_kv is False
    assert S.parse_args(["--paged-kv"]).paged_kv is True


def test_full_draws_the_reference_workload(monkeypatch):
    """``--full`` on both launchers: the reference's requests come from its
    own run (model build stubbed: 2.5 B parameters are not made here), the
    port's from ``make_requests``; the server geometry is the reference's
    256 slots and 4 rows in both."""
    seen: dict = {}

    class Server:
        def __init__(self, cfg, params, engine, scfg, manager=None):
            seen["scfg"] = scfg

        def serve(self, reqs):
            seen["reqs"] = reqs
            raise _Stop

    argv = ["--full", "--requests", "7", "--seed", "3"]
    monkeypatch.setattr(JT, "init_params", lambda *a, **kw: {})
    monkeypatch.setattr(JT, "param_count", lambda p: 2_533_931_008)
    monkeypatch.setattr(JL, "AdaptiveServer", Server)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(_Stop):
        JL.main()
    cfg = get_config("granite-3-2b")
    assert cfg.vocab == jax_get_config("granite-3-2b").vocab
    got = S.make_requests(cfg, S.parse_args(argv))
    assert len(got) == len(seen["reqs"]) == 7
    for g, w in zip(got, seen["reqs"]):
        assert g.tokens.tolist() == w.tokens.tolist()
        assert (g.max_new, g.accuracy_critical, g.priority) == \
            (w.max_new, w.accuracy_critical, w.priority)
    assert 4 <= min(len(r.tokens) for r in got) <= \
        max(len(r.tokens) for r in got) <= 23
    defaults = inspect.signature(S.build_server).parameters
    assert (defaults["slots"].default, defaults["max_batch"].default) == \
        (seen["scfg"].slots, seen["scfg"].max_batch) == (256, 4)
