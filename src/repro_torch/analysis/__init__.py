"""Static analysis for hot-path discipline (port of ``repro.analysis``).

Three layers, each usable on its own:

- :mod:`repro_torch.analysis.lint` — AST rules over source files (host
  syncs, late closures, device-constant smells) with per-line
  ``# repro: allow(rule-id) reason`` suppression.
- :mod:`repro_torch.analysis.op_check` — invariant checks over a recorded
  trace of aten ops (output byte budgets, forbidden shapes, op counts,
  host/device transfers, in-place carries).
- :mod:`repro_torch.analysis.tracker` — runtime dispatch auditing of the
  callables bound on a server or scheduler.

:mod:`repro_torch.analysis.budgets` pins the reference-scenario ceilings
that ``python -m repro_torch.analysis.check_static`` enforces.
"""

from repro_torch.analysis.lint import Finding, lint_file, lint_source, lint_tree
from repro_torch.analysis.op_check import (
    check_bytes_budget,
    count_ops,
    count_transfers,
    forbid_shape,
    has_adjacent_dims,
    max_out_bytes,
    trace_ops,
    verify_in_place,
)
from repro_torch.analysis.tracker import DispatchAudit, SchedulerAudit

__all__ = [
    "Finding",
    "lint_file",
    "lint_source",
    "lint_tree",
    "trace_ops",
    "max_out_bytes",
    "check_bytes_budget",
    "forbid_shape",
    "has_adjacent_dims",
    "count_ops",
    "count_transfers",
    "verify_in_place",
    "DispatchAudit",
    "SchedulerAudit",
]
