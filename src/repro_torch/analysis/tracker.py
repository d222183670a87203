"""Runtime dispatch auditing for the serving path.

Port of ``repro/analysis/tracker.py``. ``DispatchAudit`` wraps named
callables on any object (an ``AdaptiveServer``, a ``ContinuousScheduler``,
a module) and counts every call while the context is open, so scenarios
can assert "N dispatches" and "never dispatched" declaratively instead of
hand-rolling monkeypatches per test. On exit every wrapped name is
restored: an instance attribute that shadowed nothing is removed, so the
class's method shows through again.

``SchedulerAudit`` extends it with admission-round bracketing: it wraps
``scheduler.admit`` so the prefill-wave methods' call deltas are recorded
*per round*, which is what the <=2-prefill-waves invariant is about. The
port's waves are the scheduler's four dispatchers (``_dispatch_cold``,
``_dispatch_shared``, ``_dispatch_resume``, ``_dispatch_chunks``), where
the reference's are its admission executables (``_admit`` ...).

The reference's ``assert_no_retrace`` and ``assert_single_segment`` read a
jitted executable's cache size. An eager segment has no executable and
nothing to retrace, so both are left out until decode is captured in CUDA
graphs; their counterpart then is the number of graph captures per pool
lifetime (``ROADMAP.md`` item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

__all__ = ["DispatchAudit", "SchedulerAudit", "WAVE_NAMES"]


@dataclass
class _Wrapped:
    name: str
    original: Any
    shadowed: bool       # the name was in the target's own __dict__
    calls: int = 0
    forbidden: bool = False


class DispatchAudit:
    """Count calls of named callables on ``target`` while open.

    >>> with DispatchAudit(server, ["generate_stepwise"]) as audit:
    ...     audit.forbid("generate_stepwise")   # any call raises
    ...     ContinuousScheduler(server).run()
    >>> audit.calls("generate_stepwise")
    0
    """

    def __init__(self, target: Any, names: Sequence[str]):
        self.target = target
        self.names = list(names)
        self._wrapped: dict[str, _Wrapped] = {}

    def __enter__(self) -> "DispatchAudit":
        own = getattr(self.target, "__dict__", {})
        for name in self.names:
            w = _Wrapped(name, getattr(self.target, name), name in own)
            self._wrapped[name] = w

            def make(wrec: _Wrapped):
                def counted(*args, **kwargs):
                    if wrec.forbidden:
                        raise AssertionError(
                            f"forbidden callable {wrec.name!r} was dispatched"
                        )
                    wrec.calls += 1
                    return wrec.original(*args, **kwargs)

                return counted

            setattr(self.target, name, make(w))
        return self

    def __exit__(self, *exc) -> None:
        for name, w in self._wrapped.items():
            if w.shadowed:
                setattr(self.target, name, w.original)
            else:
                # a bound method wrapped through an instance attribute:
                # remove the shadow rather than pin a stale bound method
                delattr(self.target, name)

    # -- assertions ---------------------------------------------------------

    def forbid(self, name: str) -> None:
        """Any subsequent call of ``name`` raises AssertionError."""
        self._wrapped[name].forbidden = True

    def calls(self, name: str) -> int:
        return self._wrapped[name].calls


WAVE_NAMES = ("_dispatch_cold", "_dispatch_shared", "_dispatch_resume",
              "_dispatch_chunks")


class SchedulerAudit(DispatchAudit):
    """DispatchAudit over a ``ContinuousScheduler`` with per-admission-round
    prefill-wave bracketing.

    The audited invariants (``docs/serving.md`` "Invariants" in the
    reference):

    - ``max-prefill-waves`` — ``assert_max_prefill_waves(2)``
    - ``no-per-token-dispatch`` — forbid the server's stepwise oracle
      (``DispatchAudit(server, ["generate_stepwise"])``) around the run;
      ``run_segment`` calls count the segments.
    """

    def __init__(self, scheduler: Any, extra_names: Sequence[str] = ()):
        names = ["run_segment"]
        names += [n for n in WAVE_NAMES if getattr(scheduler, n, None) is not None]
        names += [n for n in extra_names if n not in names]
        super().__init__(scheduler, names)
        self.prefill_waves_per_round: list[int] = []
        self._admit_original = None

    def _waves(self) -> int:
        return sum(self.calls(n) for n in WAVE_NAMES if n in self._wrapped)

    def __enter__(self) -> "SchedulerAudit":
        super().__enter__()
        self._admit_original = self.target.admit
        audit = self

        def bracketed_admit(*args, **kwargs):
            before = audit._waves()
            out = audit._admit_original(*args, **kwargs)
            audit.prefill_waves_per_round.append(audit._waves() - before)
            return out

        self.target.admit = bracketed_admit
        return self

    def __exit__(self, *exc) -> None:
        # `admit` is a class method wrapped via an instance attribute; remove
        # the shadow rather than pinning a stale bound method.
        self.target.__dict__.pop("admit", None)
        super().__exit__(*exc)

    # -- named invariants ----------------------------------------------------

    def assert_max_prefill_waves(self, ceiling: int = 2) -> None:
        if not self.prefill_waves_per_round:
            return
        worst = max(self.prefill_waves_per_round)
        if worst > ceiling:
            raise AssertionError(
                f"an admission round dispatched {worst} prefill waves "
                f"(ceiling {ceiling}): {self.prefill_waves_per_round}"
            )
