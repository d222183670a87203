"""Deterministic fault injection + stall watchdog for the serving runtime.

Copy of ``repro/serving/faults.py`` (numpy-only), cross-references rewritten
for the port; the draws are bitwise the reference's.

The paper's adaptive loop trades accuracy for energy — which means the
runtime deliberately operates close to the numerical edge (int-KV storage,
4-bit weight variants). A production engine must therefore treat non-finite
outputs, allocator droughts and stalled dispatches as *expected* events with
rehearsed recoveries, not as crashes. This module is the rehearsal
machinery, modeled on the reference's training loop's injected-failure
discipline (``TrainConfig.fail_at_step`` + the ``StragglerMonitor``): faults are
**seeded and deterministic**, so a chaos run is replayable and a CI gate can
assert exact recovery behavior.

* :class:`FaultSchedule` — decides, per well-defined scheduler hook, whether
  to (a) poison one row's logits with NaN for one decode-segment step
  (:meth:`want_nan` — keyed by ``(rid, attempt)`` so a retry at the
  escalated profile is injected independently of the first attempt),
  (b) report the block allocator dry for one admission round
  (:meth:`alloc_dry` — exercises backpressure without touching refcounts),
  or (c) stall a flush boundary (:meth:`flush_stall` — what the watchdog
  must catch). Random draws hash ``(seed, kind, key)`` through
  ``numpy``'s deterministic bit generator, so the decision for a given
  request/round is independent of call order — two runs over the same
  trace inject the same faults even if wall-clock timing reorders the
  scheduler's queries.
* :class:`Watchdog` — wall-clock no-progress detector for the segment/flush
  loop (the serving twin of the training ``StragglerMonitor``): any step
  exceeding ``limit_s`` is flagged and counted. Detection only — a stalled
  device dispatch cannot be killed from the host, but surfacing it turns a
  silent hang into an observable, alertable event.

Detection of injected (or genuine) non-finite logits is NOT here: it rides
the decode segment itself (:func:`repro_torch.models.transformer.decode_segment`
folds a per-row finite-check into the scan carry, so it costs no extra
dispatch) and the scheduler's quarantine machinery reacts to the flag.
Speculative decode widens the same check, not the machinery: the verify
pass's logits span the whole ``W``-position draft window, and
:func:`repro_torch.models.transformer.decode_segment_spec` finite-checks the
*full* ``[B, W, vocab]`` verify tensor per window — a NaN anywhere in the
window (even at a position whose draft would have been rejected) marks
the row not-ok, and the ordinary quarantine/escalated-retry ladder takes
over — the attempt's tokens (speculatively delivered or not) are
discarded wholesale and the retry restarts from the prompt, so recovery
stays token-identical to a clean accuracy-critical run.
``want_nan`` needs no window awareness: injection still keys on
``(rid, attempt)`` and poisons step 0 of the targeted attempt's first
segment, which under speculation is the first verify window.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["FaultSchedule", "Watchdog"]

# namespaces for the stable per-decision hash draws, so the NaN / allocator /
# stall streams are independent even under one seed
_NAN, _ALLOC, _STALL = 1, 2, 3


def _draw(seed: int, kind: int, key: int) -> float:
    """Uniform in [0, 1) determined solely by ``(seed, kind, key)`` — NOT by
    how many draws happened before it, so injection decisions are stable
    under scheduler-timing differences between runs."""
    return float(np.random.default_rng([int(seed), kind, int(key)]).random())


@dataclasses.dataclass
class FaultSchedule:
    """Seeded, deterministic fault plan consulted by the scheduler.

    Explicit targets (exact tests, CI gates):

    * ``nan_at`` — ``{rid: (attempt, ...)}``: poison that request's logits
      during the named attempts (attempt 0 = first admission, 1 = first
      quarantine retry, ...). ``nan_at={3: (0,)}`` is the canonical
      "recoverable fault": attempt 0 breaks, the escalated retry is clean.
    * ``alloc_at`` — admission-round indices where the allocator reports dry.
    * ``stall_at`` — flush indices to stall by ``stall_s`` seconds.

    Random rates (chaos benches): ``p_nan`` per ``(rid, attempt)``,
    ``p_alloc`` per admission round, ``p_stall`` per flush — all hash-drawn
    from ``seed`` (see module docstring), with ``max_nan`` capping the total
    number of random NaN injections so a chaos trace cannot degenerate into
    all-FAILED.
    """

    seed: int = 0
    p_nan: float = 0.0
    p_alloc: float = 0.0
    p_stall: float = 0.0
    stall_s: float = 0.05
    nan_at: dict = dataclasses.field(default_factory=dict)
    alloc_at: tuple = ()
    stall_at: tuple = ()
    max_nan: Optional[int] = None
    # injection counters (chaos-bench reporting)
    injected_nan: int = 0
    injected_alloc: int = 0
    injected_stall: int = 0
    _fired: set = dataclasses.field(default_factory=set)

    def want_nan(self, rid: int, attempt: int) -> bool:
        """True exactly once per targeted ``(rid, attempt)`` — the scheduler
        asks before every decode segment, and the first segment of a
        targeted attempt takes the hit (step 0 of that segment)."""
        key = (int(rid), int(attempt))
        if key in self._fired:
            return False
        want = attempt in tuple(self.nan_at.get(int(rid), ()))
        if not want and self.p_nan > 0.0:
            if self.max_nan is not None and self.injected_nan >= self.max_nan:
                want = False
            else:
                # fold attempt into the key so a retry draws independently
                want = _draw(self.seed, _NAN, rid * 131 + attempt) < self.p_nan
        if want:
            self._fired.add(key)
            self.injected_nan += 1
        return want

    def alloc_dry(self, admission_round: int) -> bool:
        """Simulated allocator exhaustion for this admission round: the
        scheduler skips the round entirely (queue backpressure — the same
        observable behavior as a genuinely dry pool, with zero refcount
        involvement, so the allocator invariants stay pristine)."""
        dry = admission_round in tuple(self.alloc_at) or (
            self.p_alloc > 0.0
            and _draw(self.seed, _ALLOC, admission_round) < self.p_alloc)
        if dry:
            self.injected_alloc += 1
        return dry

    def flush_stall(self, flush_idx: int) -> float:
        """Seconds to stall the ``flush_idx``-th materializing flush (0.0 =
        no stall) — the injected no-progress condition the watchdog must
        flag."""
        stall = flush_idx in tuple(self.stall_at) or (
            self.p_stall > 0.0
            and _draw(self.seed, _STALL, flush_idx) < self.p_stall)
        if stall:
            self.injected_stall += 1
            return float(self.stall_s)
        return 0.0


@dataclasses.dataclass
class Watchdog:
    """Wall-clock no-progress detector for the scheduler's step loop.

    ``limit_s`` is the per-step budget: any admit→segment→flush round
    exceeding it is recorded in ``flagged`` (label, seconds) and counted in
    ``stalls``. The training-side ``StragglerMonitor`` flags statistical
    outliers across workers; serving has a hard latency contract instead,
    so a fixed threshold is the right detector here.
    """

    limit_s: float
    stalls: int = 0
    flagged: list = dataclasses.field(default_factory=list)

    def record(self, label: str, dt: float) -> bool:
        """Feed one step's wall time; True (and flagged) when over budget."""
        if dt > self.limit_s:
            self.stalls += 1
            self.flagged.append((label, float(dt)))
            return True
        return False
