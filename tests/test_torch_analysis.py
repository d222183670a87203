"""The port's hot-path analysis against the reference's: lint rules, op-trace
budgets, dispatch audits, the gate's canaries.

``repro/analysis/__init__.py`` imports ``jaxpr_check``, which does not
import under this jax, so the reference's ``lint.py`` and ``tracker.py``
(standard library only) are loaded by file path. The lint cases of
``tests/test_analysis.py`` are shared fixtures: each JAX source and its
torch twin (same lines) fire the same rule ids on the same lines. Every
torch-only host-sync form has a positive and a negative fixture. The
op-trace checks run on toy functions and on the granite smoke segment at
every budget point; the kernel path's budgets proper run on the card
(``chip_smoke.py`` phase 20), here a model of the card's allocations
stands in for K1 and K2.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import budgets as BG
from repro_torch.analysis import check_static
from repro_torch.analysis import lint as L
from repro_torch.analysis import op_check as O
from repro_torch.analysis import tracker as TR
from repro_torch.kernels import paged_attention as PA
from torch_threads import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
REF_FIXTURES = REPO / "tests" / "fixtures" / "static_analysis"
FIXTURES = REPO / "tests" / "fixtures" / "torch_static_analysis"


def _load(name: str):
    path = REPO / "src" / "repro" / "analysis" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses look their module up
    keep, sys.dont_write_bytecode = sys.dont_write_bytecode, True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.dont_write_bytecode = keep
    return mod


REF_LINT = _load("lint")
REF_TRACKER = _load("tracker")


def _port(src: str) -> list:
    return [(f.rule, f.line) for f in L.lint_source(src, "probe.py", L.ALL_HOT)]


def _ref(src: str) -> list:
    return [(f.rule, f.line)
            for f in REF_LINT.lint_source(src, "probe.py", REF_LINT.ALL_HOT)]


# ---------------------------------------------------------------------------
# shared fixtures: the cases of tests/test_analysis.py, JAX source and its
# torch twin line for line
# ---------------------------------------------------------------------------

SHARED = {
    "host_sync_item": (
        "import jax.numpy as jnp\n"
        "def f(tok):\n"
        "    return jnp.sum(tok).item()\n",
        "import torch\n"
        "def f(tok):\n"
        "    return torch.sum(tok).item()\n"),
    "coercion_on_device_value": (
        "import jax.numpy as jnp\n"
        "def f():\n"
        "    x = jnp.ones((4,))\n"
        "    return float(x.sum())\n",
        "import torch\n"
        "def f():\n"
        "    x = torch.ones((4,))\n"
        "    return float(x.sum())\n"),
    "np_asarray_of_device_value": (
        "import jax.numpy as jnp\nimport numpy as np\n"
        "def f():\n"
        "    x = jnp.ones((4,))\n"
        "    return np.asarray(x)\n",
        "import torch\nimport numpy as np\n"
        "def f():\n"
        "    x = torch.ones((4,))\n"
        "    return np.asarray(x)\n"),
    "explicit_barrier": (
        "import jax.numpy as jnp\n"
        "def f():\n"
        "    jnp.ones((4,)).block_until_ready()\n",
        "import torch\n"
        "def f():\n"
        "    torch.cuda.synchronize()\n"),
    "negative_pure_host": (
        "import numpy as np\n"
        "def f(xs):\n"
        "    a = np.asarray(xs)\n"
        "    return float(a.sum()), int(a.max())\n",
        "import numpy as np\n"
        "def f(xs):\n"
        "    a = np.asarray(xs)\n"
        "    return float(a.sum()), int(a.max())\n"),
    "materialized_then_coerced": (
        "import jax.numpy as jnp\nimport numpy as np\n"
        "def f():\n"
        "    x = jnp.ones((4,))\n"
        "    a = np.asarray(x)\n"
        "    return int(a[0])\n",
        "import torch\nimport numpy as np\n"
        "def f():\n"
        "    x = torch.ones((4,))\n"
        "    a = np.asarray(x)\n"
        "    return int(a[0])\n"),
    "late_closure": (
        "def outer():\n"
        "    def inner(x):\n"
        "        return x + scale\n"
        "    scale = 3.0\n"
        "    return inner\n",
        "def outer():\n"
        "    def inner(x):\n"
        "        return x + scale\n"
        "    scale = 3.0\n"
        "    return inner\n"),
    "late_closure_negative": (
        "def outer():\n"
        "    scale = 3.0\n"
        "    def inner(x):\n"
        "        return x + scale\n"
        "    return inner\n",
        "def outer():\n"
        "    scale = 3.0\n"
        "    def inner(x):\n"
        "        return x + scale\n"
        "    return inner\n"),
    "device_constant": (
        "import jax.numpy as jnp\n"
        "def f(x):\n"
        "    return x + jnp.array([0.0] * 64)\n",
        "import torch\n"
        "def f(x):\n"
        "    return x + torch.tensor([0.0] * 64)\n"),
    "device_constant_small": (
        "import jax.numpy as jnp\n"
        "def f(x):\n"
        "    return x + jnp.array([0.0, 1.0, 2.0])\n",
        "import torch\n"
        "def f(x):\n"
        "    return x + torch.tensor([0.0, 1.0, 2.0])\n"),
    "allow_same_line": (
        "import jax.numpy as jnp\n"
        "def f():\n"
        "    x = jnp.ones((4,))\n"
        "    return x.sum().item()  # repro: allow(host-sync) reduced\n",
        "import torch\n"
        "def f():\n"
        "    x = torch.ones((4,))\n"
        "    return x.sum().item()  # repro: allow(host-sync) reduced\n"),
    "allow_line_above": (
        "import jax.numpy as jnp\n"
        "def f():\n"
        "    x = jnp.ones((4,))\n"
        "    # repro: allow(host-sync) reduced scalar, sync intended\n"
        "    return x.sum().item()\n",
        "import torch\n"
        "def f():\n"
        "    x = torch.ones((4,))\n"
        "    # repro: allow(host-sync) reduced scalar, sync intended\n"
        "    return x.sum().item()\n"),
    "allow_on_def_line": (
        "import jax.numpy as jnp\n"
        "def oracle(tok):  # repro: allow(host-sync) per-step oracle\n"
        "    x = jnp.ones((2,))\n"
        "    a = x.sum().item()\n"
        "    b = float(x.max())\n"
        "    return a, b\n",
        "import torch\n"
        "def oracle(tok):  # repro: allow(host-sync) per-step oracle\n"
        "    x = torch.ones((2,))\n"
        "    a = x.sum().item()\n"
        "    b = float(x.max())\n"
        "    return a, b\n"),
    "allow_is_rule_specific": (
        "def outer():\n"
        "    def inner(x):  # repro: allow(host-sync) wrong id\n"
        "        return x + scale\n"
        "    scale = 3.0\n"
        "    return inner\n",
        "def outer():\n"
        "    def inner(x):  # repro: allow(host-sync) wrong id\n"
        "        return x + scale\n"
        "    scale = 3.0\n"
        "    return inner\n"),
}


@pytest.mark.parametrize("case", list(SHARED))
def test_lint_matches_reference_on_shared_fixtures(case):
    jax_src, torch_src = SHARED[case]
    assert _port(torch_src) == _ref(jax_src)


# The seeded fixture files: the reference's JAX files and the port's torch
# twins, line for line but for the lines the port adds: the torch-only
# host-sync forms, and the eager form of ``tracer-branch`` (a branch on a
# tensor is a bool() sync).
PORT_ONLY = {"bad_host_sync.py": {12, 13, 14, 15}, "bad_eager.py": {14},
             "good_hot.py": set()}


@pytest.mark.parametrize("ref_name,port_name", [
    ("bad_host_sync.py", "bad_host_sync.py"), ("bad_jit.py", "bad_eager.py"),
    ("good_hot.py", "good_hot.py")])
def test_seeded_fixtures_match_reference_on_shared_rules(ref_name, port_name):
    ref = [(f.rule, f.line) for f in REF_LINT.lint_source(
        (REF_FIXTURES / ref_name).read_text(), ref_name, REF_LINT.ALL_HOT)]
    got = _port((FIXTURES / port_name).read_text())
    only = PORT_ONLY[port_name]
    assert [x for x in got if x[1] not in only] == \
        [x for x in ref if x[0] in L.RULES]
    assert sorted(x[1] for x in got if x[1] in only) == sorted(only)
    assert all(x[0] == "host-sync" for x in got if x[1] in only)


def test_seeded_fixtures_cover_every_rule():
    rules = {f.rule for f in L.lint_tree(FIXTURES, L.ALL_HOT)}
    assert rules == set(L.RULES) == {"host-sync", "late-closure",
                                     "device-constant"}
    assert len([f for f in L.lint_tree(FIXTURES, L.ALL_HOT)
                if f.path == "bad_host_sync.py"]) == 8


def test_registry_is_the_references_less_the_jit_rules():
    assert set(REF_LINT.RULES) - set(L.RULES) == {"missing-donate",
                                                  "tracer-branch"}
    for rid in L.RULES:
        assert L.RULES[rid].summary.split()[0] == \
            REF_LINT.RULES[rid].summary.split()[0]


def test_default_spec_is_the_references_plus_attention():
    ref, got = REF_LINT.DEFAULT_SPEC, L.DEFAULT_SPEC
    assert got.dirs == ref.dirs and got.func_substr == ref.func_substr
    assert got.files == ref.files + ("models/attention.py",)
    for rel, fn in [("kernels/aquant.py", "aquant"),
                    ("models/transformer.py", "decode_step"),
                    ("models/transformer.py", "prefill"),
                    ("serving/paged.py", "register")]:
        assert got.func_is_hot(rel, fn) == ref.func_is_hot(rel, fn)
    assert got.func_is_hot("models/attention.py", "paged_view")


# ---------------------------------------------------------------------------
# torch-only host-sync forms: a positive and a negative each
# ---------------------------------------------------------------------------

def _wrap(body: str) -> str:
    lines = "".join(f"    {b}\n" for b in body.split("\n"))
    return ("import numpy as np\nimport torch\nimport torch.nn.functional as F\n"
            "from repro_torch.kernels.paged_attention import paged_attention\n"
            "def f(q, xs, n, flag, self):\n" + lines)


TORCH_FORMS = {
    "cpu": ("x = torch.ones(4)\ny = x.cpu()",
            "x = torch.ones(4)  # repro: allow(host-sync) the flush\ny = x.cpu()"),
    "numpy": ("x = torch.ones(4)\ny = x.numpy()",
              "x = np.ones(4)\ny = x.copy()"),
    "tolist": ("x = torch.ones(4)\ny = x.tolist()",
               "x = np.ones(4)\ny = x.tolist()"),
    "item": ("x = torch.ones(4)\ny = x.sum().item()",
             "x = torch.ones(4)\ny = x.sum()"),
    "cuda_synchronize": ("torch.cuda.synchronize()",
                         "ok = torch.cuda.is_available()"),
    "event_synchronize": ("ev = torch.cuda.Event()\nev.synchronize()",
                          "ev = torch.cuda.Event()\nev.record()"),
    "int_of_tensor": ("x = torch.ones(4)\ny = int(x[0])",
                      "x = torch.ones(4)\ny = int(x.shape[0]) + int(x.numel())"),
    "bool_of_tensor": ("x = torch.ones(4)\ny = bool(x.any())",
                       "x = torch.ones(4)\ny = bool(x.dim())"),
    "np_array_of_tensor": ("x = torch.ones(4)\ny = np.array(x)",
                           "x = [1, 2]\ny = np.array(x)"),
    "if_on_tensor": ("x = torch.ones(4)\nif x.sum() > 0:\n    n = 1",
                     "x = torch.ones(4)\nif x.shape[0] > 1 and x is not None:\n"
                     "    n = 1"),
    "while_on_tensor": ("x = torch.ones(4)\nwhile x.any():\n    x = x - 1",
                        "x = torch.ones(4)\nwhile n > 0:\n    n = n - 1"),
    "assert_on_tensor": ("x = torch.ones(4)\nassert (x > 0).all()",
                         "x = torch.ones(4)\nassert x.dim() == 1"),
    "ternary_on_tensor": ("x = torch.ones(4)\ny = 1 if x.max() > 0 else 2",
                          "x = torch.ones(4)\ny = 1 if flag else 2"),
    "membership_is_host": ("c = torch.ones(4)\nif c[0] > 0:\n    n = 1",
                           "caches = {}\nif 'kv' in caches:\n    n = 1"),
    "functional_taint": ("y = F.softmax(q, -1)\nz = float(y.max())",
                         "y = sorted(xs)\nz = float(y[0])"),
    "kernel_wrapper_taint": ("o = paged_attention(q, xs)\nz = int(o.sum())",
                             "o = len(xs)\nz = int(o)"),
    "device_attribute_taint": ("t = self._tok\nz = int(t[0])",
                               "t = self.remaining\nz = int(t[0])"),
    "tensor_constructor_constant": (
        "t = torch.as_tensor([1.0] * 64)", "t = torch.as_tensor([1.0] * 63)"),
}


@pytest.mark.parametrize("form", list(TORCH_FORMS))
@pytest.mark.parametrize("sign", ["positive", "negative"])
def test_torch_only_forms(form, sign):
    pos, neg = TORCH_FORMS[form]
    rules = {r for r, _ in _port(_wrap(pos if sign == "positive" else neg))}
    want = ("device-constant" if form == "tensor_constructor_constant"
            else "host-sync")
    assert (want in rules) == (sign == "positive"), rules


def test_a_pragma_without_a_reason_allows_nothing():
    src = ("import torch\n"
           "def f():\n"
           "    x = torch.ones(4)\n"
           "    return x.cpu()  # repro: allow(host-sync)\n")
    assert _port(src) == [("host-sync", 4)]
    assert L.pragmas(src) == [(4, "host-sync", "")]


def test_hot_scope_follows_the_spec():
    src = ("import torch\n"
           "def decode_step(x):\n"
           "    return torch.ones(4).item()\n"
           "def prefill(x):\n"
           "    return torch.ones(4).item()\n")
    spec = L.HotPathSpec(func_substr=(("models/transformer.py", "decode"),))
    got = [(f.rule, f.line) for f in L.lint_source(
        src, "models/transformer.py", spec)]
    assert got == [("host-sync", 3)]


def test_port_tree_lints_clean_with_reasons():
    pkg = REPO / "src" / "repro_torch"
    assert L.lint_tree(pkg, L.DEFAULT_SPEC) == []
    allows = [(p, a) for p in pkg.rglob("*.py") if p.parent.name != "analysis"
              for a in L.pragmas(p.read_text())]
    assert len(allows) == 8 and all(a[2] for _, a in allows)
    # each one sits on a sync the reference allowlists too
    ref_reasons = {why for p in (REPO / "src" / "repro").rglob("*.py")
                   for _, _, why in L.pragmas(p.read_text())}
    assert {a[2] for _, a in allows} <= ref_reasons


# ---------------------------------------------------------------------------
# op traces on toy functions
# ---------------------------------------------------------------------------

def _toy(x):
    return (x * 2.0 + 1.0).sum()


def test_bytes_budget_pass_and_fail():
    trace = O.trace_ops(_toy, torch.zeros((64, 64)))
    assert O.max_out_bytes(trace) == 64 * 64 * 4
    assert O.check_bytes_budget(trace, 64 * 64 * 4) == []
    over = O.check_bytes_budget(trace, 64 * 64 * 4 - 1)
    assert len(over) == 2 and all(v.nbytes > 64 * 64 * 4 - 1 for v in over)
    assert O.count_ops(trace) == {"aten.mul": 1, "aten.add": 1, "aten.sum": 1}
    assert float(trace.result) == 64 * 64


def test_forbid_shape_and_adjacent_dims():
    def f(x):
        y = x.reshape(4, 16)            # the "forbidden" intermediate
        return y.sum()

    trace = O.trace_ops(f, torch.zeros((64,)))
    assert O.has_adjacent_dims(trace, (4, 16))
    assert not O.has_adjacent_dims(trace, (4, 17))
    assert not O.has_adjacent_dims(trace, (4, 16, 1))
    hits = O.forbid_shape(trace, lambda s: s == (4, 16))
    assert hits and hits[0].shape == (4, 16)


def test_views_and_in_place_updates_are_not_allocations():
    x = torch.zeros((32, 32))
    trace = O.trace_ops(lambda: (x.view(1024), x.add_(1.0), x[0]))
    assert O.max_out_bytes(trace) == 0
    assert all(o.alias for r in trace for o in r.outputs)


def test_count_transfers_sees_reads_and_copies():
    x = torch.ones(4)
    trace = O.trace_ops(lambda: (x.sum().item(), int(x[0]), x.nonzero(),
                                 x.to("meta"), torch.as_tensor(
                                     np.arange(3), device="meta")))
    assert O.count_transfers(trace) == O.Transfers(d2h=3, h2d=2)
    m = x.to("meta")
    rec = O._Recorder()
    with pytest.raises(NotImplementedError):
        with rec:
            m.cpu()                     # recorded before the copy raises
    assert O.count_transfers(rec.records) == O.Transfers(d2h=1, h2d=0)
    assert O.count_transfers(O.trace_ops(_toy, x)).total == 0


@pytest.mark.parametrize("device,h2d", [("cuda", 1), ("cpu", 0)])
def test_count_transfers_sees_a_constructor_on_the_device(device, h2d):
    """``torch.as_tensor(<list>, device="cuda")`` copies below the
    dispatcher: its one op is ``aten.lift_fresh`` on a device tensor (the
    record the card gives, written out: there is no card here)."""
    out = O.OutSpec((8,), "int32", device, 32, False)
    rec = O.OpRecord("aten.lift_fresh.default", (out,), (device,))
    assert O.count_transfers([rec]) == O.Transfers(d2h=0, h2d=h2d)
    on_cpu = O.trace_ops(torch.as_tensor, [1, 2])
    assert [r.packet for r in on_cpu] == ["aten.lift_fresh"]
    assert O.count_transfers(on_cpu).total == 0


def test_verify_in_place():
    c = torch.zeros((16, 16))
    assert O.verify_in_place(lambda t: t.add_(1.0), {"c": c}, c).ok
    out = O.verify_in_place(lambda t: t + 1.0, {"c": c}, c,
                            after=lambda r: {"c": r})
    assert not out.ok and out.moved == ("c",) and len(out.allocations) == 1
    small = O.verify_in_place(lambda t: t[:2].clone(), {"c": c}, c)
    assert small.ok                     # an eighth of the carry: no copy of it


# ---------------------------------------------------------------------------
# the dispatch audits against the reference's
# ---------------------------------------------------------------------------

class _Host:
    def __init__(self):
        self.seen = []

    def step(self, x):
        self.seen.append(x)
        return x + 1

    def other(self, x):
        return x * 2


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_dispatch_audit_counts_forbids_and_restores(pkg):
    mod = TR if pkg == "port" else REF_TRACKER
    host = _Host()
    with mod.DispatchAudit(host, ["step", "other"]) as audit:
        assert host.step(1) == 2 and host.step(2) == 3
        audit.forbid("other")
        with pytest.raises(AssertionError, match="forbidden"):
            host.other(1)
        assert audit.calls("step") == 2 and audit.calls("other") == 0
    assert host.seen == [1, 2]
    assert host.step.__func__ is _Host.step     # the method shows through


class _Sched:
    """A scheduler stand-in whose admission rounds dispatch ``plan[i]``
    waves through the port's (and the reference's) wave names."""

    def __init__(self, plan, names):
        self.plan, self.names, self.i = list(plan), names, 0
        for n in names:
            setattr(self, n, lambda *a: None)

    def run_segment(self):
        return None

    _segment = run_segment

    def admit(self):
        k, self.i = self.plan[self.i], self.i + 1
        for j in range(k):
            getattr(self, self.names[j % len(self.names)])()
        return k


def test_scheduler_audit_brackets_rounds_like_the_reference():
    plan = [2, 0, 1, 3]
    port = _Sched(plan, list(TR.WAVE_NAMES))
    ref = _Sched(plan, list(REF_TRACKER._ADMIT_NAMES))
    with TR.SchedulerAudit(port) as a, REF_TRACKER.SchedulerAudit(ref) as b:
        for _ in plan:
            port.admit()
            ref.admit()
        assert a.prefill_waves_per_round == b.prefill_waves_per_round == plan
        a.assert_max_prefill_waves(3)
        b.assert_max_prefill_waves(3)
        for audit in (a, b):
            with pytest.raises(AssertionError, match="3 prefill waves"):
                audit.assert_max_prefill_waves(2)
    assert "admit" not in port.__dict__ and "admit" not in ref.__dict__


# ---------------------------------------------------------------------------
# the budget points on the smoke segment, and the gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parts():
    with torch.no_grad():
        return BG.smoke_parts()


def _card_wrapper(multi: bool):
    """What K1's and K2's CUDA wrappers allocate (``_launch``): the f32
    output and, with more than one split, the partials and (m, l)."""
    def call(q, k_pool, v_pool, a, b_, token_idx, block_table, pos, *,
             bits=16, window=0, n_blocks=None):
        qq = q if multi else q.unsqueeze(1)
        b, w, hkv, hg, d = qq.shape
        rows, _ = PA.row_plan(w, hg, d)
        splits, _ = PA.split_plan(b, hkv, rows,
                                  block_table.shape[1] * token_idx.shape[1])
        out = torch.zeros((b, w, hkv, hg, d))
        if splits > 1:
            torch.empty((b * hkv * splits, w * hg, d))
            torch.empty((b * hkv * splits, w * hg, 2))
        return out if multi else out.squeeze(1)
    return call


@pytest.mark.parametrize("budget", BG.REFERENCE_BUDGETS, ids=lambda b: b.name)
def test_budget_point(parts, budget, monkeypatch):
    """The gather backend trips the view check at every point; the kernel
    path with K1/K2 standing in as the allocations their CUDA wrappers make
    (the card's path but for the kernels themselves) passes the point."""
    cfg = parts[0]
    gather = BG.check_budget(parts, budget, backend="gather")
    assert gather.gather_view and not gather.ok
    assert gather.max_bytes >= budget.view_bytes(cfg)
    monkeypatch.setattr(PA, "paged_attention", _card_wrapper(False))
    monkeypatch.setattr(PA, "paged_attention_multi", _card_wrapper(True))
    kernel = BG.check_budget(parts, budget, backend="kernel")
    assert kernel.ok, kernel.render()
    assert kernel.transfers == O.Transfers(0, 0)


def test_which_points_the_ceiling_alone_separates(parts):
    cfg = parts[0]
    alone = [b.name for b in BG.REFERENCE_BUDGETS if not b.view_separates(cfg)]
    assert alone == ["bench10-kv4", "bench8-spec-kv8"]
    assert {b.max_out_bytes % 1024 for b in BG.REFERENCE_BUDGETS} == {0}


def test_gate_passes_on_the_tree(capsys):
    assert check_static.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "lint: 0 finding(s) in src/repro_torch, 8 allow pragma(s), 0 " \
           "without a reason" in out
    assert "self-test ok" in out and "checked on the card only" in out
    assert "stepwise oracle calls=0" in out and "check_static: PASS" in out


def test_gate_fails_on_seeded_lint_fixtures():
    assert check_static.main(["--lint-root", str(FIXTURES)]) != 0
    assert check_static.main(["--lint-root", str(REF_FIXTURES)]) != 0


def test_gate_fails_on_budget_canary():
    assert check_static.main(["--canary-budget"]) != 0


def test_scenario_audit_catches_a_stepwise_dispatch(parts, monkeypatch):
    """The scenario stage fails when the fused path reaches the stepwise
    oracle."""
    from repro_torch.serving.scheduler import ContinuousScheduler

    def bad_segment(self):
        self.srv.generate_stepwise(np.zeros((1, 2), np.int32), 2)

    monkeypatch.setattr(ContinuousScheduler, "run_segment", bad_segment)
    with pytest.raises(AssertionError, match="forbidden"):
        check_static.run_scenarios(parts, torch.device("cpu"))
