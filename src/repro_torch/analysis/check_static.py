"""Hot-path discipline gate: AST lint + op-trace budgets + runtime audit.

Port of ``scripts/check_static.py``:

  PYTHONPATH=src python -m repro_torch.analysis.check_static [--device cpu]

Three blocking stages (any failure => non-zero exit):

1. **lint** — :mod:`repro_torch.analysis.lint` over ``src/repro_torch``
   with the default hot-path spec; the tree must report zero findings, and
   every allow pragma in it must give its reason.
2. **budgets** — every :data:`~repro_torch.analysis.budgets.
   REFERENCE_BUDGETS` point traced on the kernel backend must pass its
   output-byte ceiling and the no-gather-view check; as a self-test, the
   gather backend must *fail* the view check at the first point (proving
   the detector detects). On the CPU the kernel backend runs the
   paged-attention kernel's plain version, which builds the very view the
   check forbids, so there the stage runs the self-test alone and says so.
3. **scenarios** — a smoke server + scheduler run under
   :class:`~repro_torch.analysis.tracker.SchedulerAudit` (one audit per
   admission round, the second on a warm pool), once greedy and once
   speculative (``draft_k`` 2), must satisfy the runtime invariants: <= 2
   prefill waves per admission round, zero calls of the server's stepwise
   oracle (``generate_stepwise``), and on a CUDA device, where the segment
   (or the speculative segment's window) replays CUDA graphs, one capture
   per profile id in use (``single-segment-executable``) and none in the
   second round (``no-retrace``); the admission waves, which replay the
   graph of their wave key, capture each key they use once
   (``assert_wave_executables``). A static-path scenario serves the same
   groups twice on one server with the stepwise oracle forbidden, then
   runs the oracle once: on a CUDA device, where the prefill, the decode
   and the oracle's step replay graphs, each group shape captures each
   prefill key and profile id it uses once (``assert_static_executables``)
   and the second serve captures nothing. On the CPU all of it runs
   eagerly.

Flags:

- ``--lint-root PATH`` lints an alternate tree (every file hot) instead of
  ``src/repro_torch`` — used by the seeded-violation canary.
- ``--canary-budget`` checks a toy function against a 1-byte ceiling,
  which must fail — proving the budget class of violation is fatal.
- ``--skip-lint`` / ``--skip-budgets`` / ``--skip-scenarios`` narrow the
  run.
- ``--device`` (default: cuda; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent      # src/repro_torch


def run_lint(lint_root: str | None) -> int:
    from repro_torch.analysis.lint import ALL_HOT, DEFAULT_SPEC, lint_tree, pragmas

    if lint_root is not None:
        findings = lint_tree(lint_root, ALL_HOT)
        label, root = lint_root, Path(lint_root)
    else:
        findings = lint_tree(PACKAGE, DEFAULT_SPEC)
        label, root = "src/repro_torch", PACKAGE
    for f in findings:
        print(f.render())
    allows = [(path, line, rule, why)
              for path in sorted(root.rglob("*.py"))
              if not (root == PACKAGE and path.parent.name == "analysis")
              for line, rule, why in pragmas(path.read_text())]
    bare = [a for a in allows if not a[3]]
    for path, line, rule, _ in bare:
        print(f"{path}:{line}: allow({rule}) gives no reason")
    print(f"lint: {len(findings)} finding(s) in {label}, {len(allows)} "
          f"allow pragma(s), {len(bare)} without a reason")
    return 1 if findings or bare else 0


def run_budgets(parts, device) -> int:
    from repro_torch.analysis import op_check
    from repro_torch.analysis.budgets import (REFERENCE_BUDGETS, check_budget,
                                              trace_segment)

    cfg = parts[0]
    rc = 0
    if device.type == "cuda":
        for budget in REFERENCE_BUDGETS:
            report = check_budget(parts, budget, backend="kernel",
                                  device=device)
            print(report.render())
            if not budget.view_separates(cfg):
                print(f"    (the ceiling is not below the {budget.view_bytes(cfg):,} B "
                      f"view: the no-gather-view check separates the backends)")
            if not report.ok:
                rc = 1
    else:
        print(f"budgets: on {device.type} the kernel backend runs the "
              f"paged-attention kernel's plain version, which builds the "
              f"gather view; the {len(REFERENCE_BUDGETS)} kernel-path points "
              f"are checked on the card only (self-test below)")
    # Self-test: the gather backend must trip the view detector at the
    # first reference point, or the guard is vacuous.
    first = REFERENCE_BUDGETS[0]
    gather = trace_segment(parts, "gather", first, device)
    if not op_check.has_adjacent_dims(gather, first.view_dims(cfg)):
        print("budgets: SELF-TEST FAILED — gather backend did not produce "
              "the view the detector claims to catch")
        rc = 1
    else:
        print("budgets: self-test ok (gather backend trips the view check)")
    return rc


def run_canary_budget() -> int:
    """A toy function vs a 1-byte ceiling: must report violations."""
    import torch

    from repro_torch.analysis import op_check

    def f(x):
        return (x * 2.0).sum()

    trace = op_check.trace_ops(f, torch.zeros((64, 64)))
    violations = op_check.check_bytes_budget(trace, 1)
    print(f"canary-budget: {len(violations)} violation(s) at 1-byte ceiling")
    return 1 if violations else 0


SCENARIO_REQUESTS = ((7, 5), (9, 4), (17, 5), (5, 4), (12, 4))


def run_scenarios(parts, device) -> int:
    rc = 0
    for label, spec in (("greedy", {}),
                        ("speculative", dict(speculate=True, draft_k=2))):
        rc |= _scenario(parts, device, label, spec)
    rc |= _static_scenario(parts, device)
    return rc


def _static_scenario(parts, device) -> int:
    import numpy as np

    from repro_torch.analysis.tracker import (DispatchAudit,
                                              assert_static_executables,
                                              static_captures)
    from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig

    cfg, params, eng = parts
    srv = AdaptiveServer(cfg, params, eng,
                         ServingConfig(slots=64, max_batch=4, kv_bits=8),
                         device=device)
    rng = np.random.default_rng(7)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=mn)
            for n, mn in SCENARIO_REQUESTS]
    graphed = device.type == "cuda"     # the static path replays graphs
    caps = []
    with DispatchAudit(srv, ["generate_stepwise"]) as srv_audit:
        srv_audit.forbid("generate_stepwise")   # no-per-token-dispatch
        for _ in range(2):                     # the second: the same groups
            res = srv.serve(reqs)
            caps.append(static_captures(srv))
    srv.generate_stepwise(np.stack([r.tokens[:5] for r in reqs[:4]]), 4)
    try:
        if len(res) != len(reqs) or any(not r["tokens"] for r in res):
            raise AssertionError("the static serve did not complete all "
                                 "requests")
        if graphed:
            assert_static_executables(srv)
            if caps[0] != caps[1]:
                raise AssertionError(f"the second serve captured: "
                                     f"{caps[0]} -> {caps[1]}")
    except AssertionError as e:
        print(f"scenarios (static): FAIL — {e}")
        return 1
    done = static_captures(srv)
    print("scenarios (static): ok — 2 serves of "
          f"{-(-len(reqs) // srv.scfg.max_batch)} groups, stepwise oracle "
          "calls in them=0, " + (
              f"captures per group shape {done} (each prefill key and "
              "profile id once), none in the second serve" if graphed else
              f"static graphs: none (eager on {device.type}; checked on a "
              "CUDA device)"))
    return 0


def _scenario(parts, device, label: str, spec: dict) -> int:
    import numpy as np

    from repro_torch.analysis.budgets import (MAX_PREFILL_WAVES_PER_ROUND,
                                              SEGMENT_GRAPHS_PER_PROFILE)
    from repro_torch.analysis.tracker import DispatchAudit, SchedulerAudit
    from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler

    cfg, params, eng = parts
    srv = AdaptiveServer(cfg, params, eng,
                         ServingConfig(slots=64, max_batch=4, block_size=8,
                                       **spec),
                         device=device)
    sched = ContinuousScheduler(srv, quantum=4)
    rng = np.random.default_rng(7)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=mn)
            for n, mn in SCENARIO_REQUESTS]
    graphed = device.type == "cuda"     # the segment replays CUDA graphs
    rc = 0
    rounds = []
    with DispatchAudit(srv, ["generate_stepwise"]) as srv_audit:
        srv_audit.forbid("generate_stepwise")   # no-per-token-dispatch
        for batch in (reqs[:3], reqs[3:]):     # the second on a warm pool
            with SchedulerAudit(sched) as audit:
                for r in batch:
                    sched.submit(r)
                res = sched.run()
            rounds.append(audit)
            try:
                audit.assert_max_prefill_waves(MAX_PREFILL_WAVES_PER_ROUND)
                if graphed:
                    audit.assert_single_segment()
                    audit.assert_wave_executables()
                    if len(rounds) == 2:
                        audit.assert_no_retrace()
            except AssertionError as e:
                print(f"scenarios ({label}): FAIL — {e}")
                rc = 1
    if len(res) != len(reqs) or any(not r["tokens"] for r in res):
        print(f"scenarios ({label}): FAIL — scheduler did not complete all "
              f"requests")
        rc = 1
    if rc == 0:
        caps = (f"segment graphs captured={sched.graphs.captured} "
                f"(<= {SEGMENT_GRAPHS_PER_PROFILE} per profile id), none on "
                f"the warm pool; wave graphs captured="
                f"{sched.waves.capture_count()} = distinct wave keys "
                f"{len(sched.waves.used)}" if graphed else
                "segment graphs: none (eager segment on "
                f"{device.type}; checked on a CUDA device)")
        print(f"scenarios ({label}): ok — segments="
              f"{sum(a.calls('run_segment') for a in rounds)}, prefill "
              f"waves/round="
              f"{[w for a in rounds for w in a.prefill_waves_per_round]}, "
              f"stepwise oracle calls=0, {caps}")
    return rc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lint-root", default=None,
                    help="lint this tree (all files hot) instead of "
                         "src/repro_torch")
    ap.add_argument("--canary-budget", action="store_true",
                    help="run the toy-budget canary (must fail => exit 1)")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--skip-budgets", action="store_true")
    ap.add_argument("--skip-scenarios", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    if args.canary_budget:
        return run_canary_budget()

    rc = 0
    if not args.skip_lint:
        rc |= run_lint(args.lint_root)
    if args.lint_root is not None:
        # Fixture lint runs don't trace the real model.
        return rc
    parts = device = None
    if not (args.skip_budgets and args.skip_scenarios):
        import torch

        from repro_torch.analysis.budgets import smoke_parts
        from repro_torch.runtime import resolve_device

        device = resolve_device(args.device)
        with torch.no_grad():
            parts = smoke_parts(device=device)
    if not args.skip_budgets:
        rc |= run_budgets(parts, device)
    if not args.skip_scenarios:
        rc |= run_scenarios(parts, device)
    print("check_static:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
