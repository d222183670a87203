"""A run with the chip's look skipped (the program on the CPU at smoke
size) comes out correct, and comes out not correct with the timed path
broken underneath, once for each fault a serving cell can have; the fp8
control, judged in the program's place by the same limits, comes out not
correct. (The exchange between chips does not exist in a one-chip
cell.)"""
import time

import pytest
import torch

import run
from conftest import smoke_cell

# the smoke program computes in f32 over a bf16 KV cache. Over 12 smoke
# calibration windows its widest gap read up to 0.019 on the dense model,
# the fp8 control's at least 0.072; on the MoE the mean gap read up to
# 0.0067 against the control's 0.0247 or more.
SMOKE_LIMITS = {"max_logit_gap": 0.03, "mean_logit_gap": 0.012}


CELLS = ["granite-3-2b.chat", "qwen2-moe-a2.7b.chat"]


def _smoke(name):
    c = smoke_cell(name)
    for k in c.cell["limits"]:
        if k in SMOKE_LIMITS:
            c.cell["limits"][k] = SMOKE_LIMITS[k]
    return c


def _run(name="granite-3-2b.chat", seed=2 ** 31 + 5):
    return run.run_cell(_smoke(name), seed, 1.0, False, torch.device("cpu"),
                        time.perf_counter(), log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_prints_the_contract_keys(name):
    out = _run(name)
    assert out["correct"] is True
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == ({"output_tok_s", "setup_s"} | (
        {"ttft_p95_ms", "tpot_p95_ms"} if "granite" in name else set()))
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}


def test_traced_run_reports_per_layer_metrics():
    c = smoke_cell("granite-3-2b.chat")
    out = run.run_cell(c, 77, 1.0, True, torch.device("cpu"),
                       time.perf_counter(), log=lambda s: None)
    assert {"occupancy", "mfu", "device_idle_share"} <= set(out["metrics"])
    assert "breakdown" in out and "window_s" in out["device"]


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_is_caught(monkeypatch, name):
    from repro_torch.models import transformer as T
    monkeypatch.setattr(T, "update_kv_cache", lambda c, k, v, pos: c)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_caught(monkeypatch, name):
    from repro_torch.models import transformer as T
    step = T.decode_step

    def half(params, cfg, bits, tokens, pos, caches, **kw):
        logits, caches = step(params, cfg, bits, tokens, pos, caches, **kw)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:h].mean(dim=0, keepdim=True)
        return logits, caches

    monkeypatch.setattr(T, "decode_step", half)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_token_altered_where_produced_is_caught(monkeypatch, name):
    from repro_torch.serving.engine import AdaptiveServer
    seg = AdaptiveServer.segment

    def altered(self, *a, **kw):
        toks, ok, tok, pos, caches = seg(self, *a, **kw)
        toks = torch.where(toks >= 0, (toks + 1) % self.cfg.vocab, toks)
        return toks, ok, tok, pos, caches

    monkeypatch.setattr(AdaptiveServer, "segment", altered)
    assert _run(name)["correct"] is False


def test_profile_outside_the_policy_is_caught(monkeypatch):
    from repro_torch.core.manager import ProfileManager
    monkeypatch.setattr(ProfileManager, "select",
                        lambda self, accuracy_critical=False: 4)
    out = _run()
    assert out["correct"] is False
    assert out["checks"]["profile_violations"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_comes_out_not_correct(name):
    # a dozen requests: at smoke size a few tokens' expert choices flip
    # under the bf16 KV cache, which a sample of three may catch alone
    c = _smoke(name)
    c.cell["sample_requests"] = 12
    rows = run.calibrate(c, 2 ** 31 + 9, 3, 1.0, torch.device("cpu"),
                         log=lambda s: None)
    assert all(r["correct"] for r in rows)
    assert not any(r["control_correct"] for r in rows)
    key = next(k for k in c.cell["limits"] if k.endswith("logit_gap"))
    prog = max(r[key] for r in rows)
    ctrl = min(r[f"control_{key}"] for r in rows)
    assert ctrl > 3 * prog and ctrl > SMOKE_LIMITS[key]


def test_jax_loaded_after_the_window_gives_no_result(monkeypatch, capsys):
    # a metric reader, which runs after the window and the reference,
    # loads a module named ``jax``: the run exits 2 and prints no result
    import sys
    import types

    import pb_spec
    reader = pb_spec.metric_reader

    def loading_jax(name):
        read = reader(name)

        def wrapped(ctx):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return read(ctx)
        return wrapped

    monkeypatch.setattr(pb_spec, "metric_reader", loading_jax)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    cell_run = run.run_cell
    monkeypatch.setattr(run, "run_cell", lambda cell, seed, sec, trace, dev,
                        t0, log: cell_run(_smoke(cell.name), seed, sec,
                                          trace, torch.device("cpu"), t0,
                                          log))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "card_lines", lambda: [])
    rc = run.main(["--workload", "granite-3-2b.chat", "--seed",
                   str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"])
    cap = capsys.readouterr()
    assert rc == 2 and cap.out == ""
    assert "['jax']" in cap.err
