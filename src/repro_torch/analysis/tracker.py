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
jitted executable's cache size. The port's segment replays CUDA graphs
(:mod:`repro_torch.serving.graphs`), one per profile id — a decode step's,
or on a speculative scheduler a draft/verify window's — so both read the
scheduler's captures per pool lifetime instead: ``single-segment-
executable`` is one capture per profile id in use, at most ``P``;
``no-retrace`` is no capture of a profile id that was already captured
when the audit opened, and no new pool lifetime. The admission waves'
counterpart (the reference compiles one admission executable per bucket
shape) reads the scheduler's wave graphs: one capture per distinct wave
key its waves used in the pool lifetime, none twice
(``assert_wave_executables``). The static path's counterpart of the
reference's one ``_prefill`` and one ``_generate`` executable per shape
(``_cache_size() == 1``) reads the server's group-shape sets
(``AdaptiveServer.static_graphs``): in each, one capture per exact
prefill key, per decode profile id and per stepwise step profile id used,
none twice (:func:`assert_static_executables`). The training step's
counterpart of the reference's one jitted step (the profile id passed as
data) reads a training lifetime's graphs
(:class:`~repro_torch.train.graphs.TrainGraphs`, ``train()``'s
``"graphs"``): one capture per distinct profile id the steps used, none
twice, and every step of the run in that one lifetime
(:func:`assert_train_executables`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

__all__ = ["DispatchAudit", "SchedulerAudit", "WAVE_NAMES",
           "static_captures", "assert_static_executables", "train_captures",
           "assert_train_executables"]


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

    - ``single-segment-executable`` — ``assert_single_segment()``
    - ``max-prefill-waves`` — ``assert_max_prefill_waves(2)``
    - ``no-retrace`` — ``assert_no_retrace()``, and for the admission
      waves ``assert_wave_executables()``
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
        g = getattr(self.target, "graphs", None)
        self._graphs_at_enter = (None if g is None else
                                 (g.lifetimes, list(g.captured)))
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

    def captures(self) -> int | None:
        """Graphs captured in the scheduler's current pool lifetime
        (``None``: the scheduler runs the eager segment)."""
        g = self.target.graphs
        return None if g is None else g.capture_count()

    def assert_single_segment(self) -> None:
        """``single-segment-executable``: one capture per profile id the
        segments used in this pool lifetime, at most ``P`` (the reference
        compiles one executable with the id as data; the port's graphs
        read the id's weight images by pointer). It holds on a speculative
        scheduler as on a greedy one: its graphs are the window's."""
        g = self.target.graphs
        if g is None:
            raise AssertionError("the scheduler runs the eager segment: "
                                 "nothing is captured")
        n_prof = len(self.target.srv.engine.table)
        if (len(set(g.captured)) != len(g.captured)
                or set(g.captured) != g.used or len(g.captured) > n_prof):
            raise AssertionError(
                f"captures {g.captured} for profile ids {sorted(g.used)} "
                f"(at most one each, {n_prof} profiles)")

    def wave_captures(self) -> int | None:
        """Wave graphs captured in the scheduler's current pool lifetime
        (``None``: the scheduler runs the eager waves)."""
        w = getattr(self.target, "waves", None)
        return None if w is None else w.capture_count()

    def assert_wave_executables(self) -> None:
        """The admission waves' ``no-retrace``: the wave captures of the
        pool lifetime equal the distinct wave keys ``(kind, profile id,
        rows, bucket, prefix bucket)`` its waves used, and no key is
        captured twice."""
        w = getattr(self.target, "waves", None)
        if w is None:
            raise AssertionError("the scheduler runs the eager waves: "
                                 "nothing is captured")
        again = sorted({k for k in w.captured if w.captured.count(k) > 1})
        if again or set(w.captured) != w.used:
            raise AssertionError(
                f"wave keys captured {w.captured} for the keys used "
                f"{sorted(w.used)} (once each; captured again: {again})")

    def assert_no_retrace(self) -> None:
        """``no-retrace``: since the audit opened, no new pool lifetime
        and no capture of a profile id already captured then (an id first
        used while open may be captured once: its warm-up)."""
        g = self.target.graphs
        if g is None or self._graphs_at_enter is None:
            raise AssertionError("the scheduler runs the eager segment: "
                                 "nothing is captured")
        lifetimes, before = self._graphs_at_enter
        if g.lifetimes != lifetimes:
            raise AssertionError(f"a new pool lifetime began ({lifetimes} "
                                 f"-> {g.lifetimes})")
        new = g.captured[len(before):]
        again = [p for p in new if p in before]
        if again or len(set(new)) != len(new):
            raise AssertionError(f"profile ids captured again: {new} after "
                                 f"{before}")


STATIC_PARTS = ("prefill", "decode", "step")


def static_captures(server: Any) -> dict:
    """The static path's captures in the current lifetime of each group
    shape's set: ``{(rows, slots, kv bits): {"prefill": [key, ...],
    "decode": [profile id, ...], "step": [profile id, ...]}}``."""
    return {shape: {name: list(part.captured) for name, part in
                    zip(STATIC_PARTS, g.parts())}
            for shape, (g, _) in server.static_graphs.items()}


def assert_static_executables(server: Any) -> None:
    """The static path's ``no-retrace``: in each group shape's set the
    prefill captures equal the distinct prefill keys ``(kind, profile id,
    rows, maxlen, 0)`` used, the decode and step captures the profile ids
    used, and nothing is captured twice."""
    for shape, (g, _) in server.static_graphs.items():
        for name, part in zip(STATIC_PARTS, g.parts()):
            again = sorted({k for k in part.captured
                            if part.captured.count(k) > 1})
            if again or set(part.captured) != part.used:
                raise AssertionError(
                    f"group shape {shape}: {name} captured {part.captured} "
                    f"for the keys used {sorted(part.used)} (once each; "
                    f"captured again: {again})")


def train_captures(graphs: Any) -> list:
    """A training lifetime's captures, in order: the profile id of each
    (``None`` for steps without one)."""
    return list(graphs.captured)


def assert_train_executables(graphs: Any, steps: int | None = None) -> None:
    """The training step's ``no-retrace``: the lifetime's captures equal
    the distinct profile ids its steps used, none captured twice, and (with
    ``steps``, the steps the run took) every step ran in this one lifetime,
    none in a new one begun mid-run."""
    if graphs is None:
        raise AssertionError("the run took the eager step: nothing is "
                             "captured")
    again = sorted({k for k in graphs.captured
                    if graphs.captured.count(k) > 1}, key=repr)
    if again or set(graphs.captured) != graphs.used:
        raise AssertionError(
            f"training step captured {graphs.captured} for the profile ids "
            f"used {sorted(graphs.used, key=repr)} (once each; captured "
            f"again: {again})")
    if steps is not None and graphs.runs != steps:
        raise AssertionError(f"{graphs.runs} of the run's {steps} steps ran "
                             f"in this training lifetime")
