"""Profile Manager — the paper's runtime self-adaptive controller (§4.4, Fig. 4).

Copy of ``repro/core/manager.py`` (numpy-only), imports rewritten for the port.

Monitors the remaining energy budget and the application accuracy constraint,
and selects the execution profile for the next inference(s). Mirrors the
CERBERO-style monitor→decide→act loop the paper references: the *engine*
executes whatever ``profile_id`` the manager hands it (one scalar, no
recompilation), the *manager* owns the policy.

Also provides :func:`battery_simulation`, the Fig. 4 right-hand-side experiment
(10 Ah budget → battery lifetime / number of classifications, adaptive vs
non-adaptive).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

__all__ = ["ProfileStats", "ProfileManager", "battery_simulation"]


@dataclasses.dataclass(frozen=True)
class ProfileStats:
    """Calibrated characteristics of one profile (from QAT eval + energy model)."""

    name: str
    accuracy: float          # validation accuracy in [0,1]
    energy_j: float          # modeled J / inference (core/energy.py)
    latency_s: float         # modeled s / inference


@dataclasses.dataclass
class ProfileManager:
    """Energy-aware profile selection with hysteresis.

    Policy (paper §4.4): run the cheapest profile that satisfies the accuracy
    requirement; when the remaining energy fraction drops below ``low_energy``,
    relax the requirement to ``accuracy_floor`` (the "battery saver" regime)
    unless the caller flags the request accuracy-critical. Hysteresis keeps the
    selection from oscillating around the threshold.
    """

    profiles: Sequence[ProfileStats]
    accuracy_target: float
    accuracy_floor: float
    budget_j: float
    low_energy: float = 0.2
    hysteresis: float = 0.05

    spent_j: float = 0.0
    _saver: bool = False

    def remaining_fraction(self) -> float:
        """Remaining energy budget in ``[0, 1]``.

        Zero budget = *unconstrained* (an unconfigured manager must not be
        silently pinned into battery-saver mode by a 0/0 → "empty" reading).
        """
        if not self.budget_j:
            return 1.0
        return max(0.0, 1.0 - self.spent_j / self.budget_j)

    def _eligible(self, floor: float) -> list[tuple[int, ProfileStats]]:
        ok = [(i, p) for i, p in enumerate(self.profiles) if p.accuracy >= floor]
        # If nothing meets the floor, degrade gracefully to the most accurate.
        return ok or [max(enumerate(self.profiles), key=lambda ip: ip[1].accuracy)]

    def select(self, accuracy_critical: bool = False) -> int:
        """Return the profile index to run next (the engine's ``profile_id``).

        Deterministic given the ledger (``spent_j``) and the hysteresis
        state — the property every schedule planner below relies on.
        ``accuracy_critical`` holds the selection at ``accuracy_target``
        even in the battery-saver regime. Does NOT account: callers pair
        each ``select`` with an :meth:`account` of the inferences actually
        dispatched.
        """
        rem = self.remaining_fraction()
        if self._saver and rem > self.low_energy + self.hysteresis:
            self._saver = False
        elif not self._saver and rem < self.low_energy:
            self._saver = True
        floor = self.accuracy_target if (accuracy_critical or not self._saver) \
            else self.accuracy_floor
        cand = self._eligible(floor)
        idx, _ = min(cand, key=lambda ip: ip[1].energy_j)
        return idx

    def account(self, profile_idx: int, n_inferences: int = 1) -> None:
        """Bill ``n_inferences`` runs of profile ``profile_idx`` to the
        ledger (one batched decode step over N live rows = N inferences;
        one admission prefill = one inference per admitted request)."""
        self.spent_j += self.profiles[profile_idx].energy_j * n_inferences

    def plan_schedule(self, steps: int, n_per_step: int = 1,
                      accuracy_critical: bool = False) -> np.ndarray:
        """Select-and-account ``steps`` inferences ahead → ``int32[steps]``.

        The policy is deterministic given the energy ledger, so the per-step
        profile ids of a multi-token generate call can be precomputed and fed
        to the engine as *data* (the schedule array rides through the jitted
        decode scan without retracing — the bits-as-data analogue of the
        paper's runtime configuration word). Identical ledger evolution to
        calling ``select``/``account`` once per step.
        """
        sched = np.empty((steps,), np.int32)
        for i in range(steps):
            sched[i] = self.select(accuracy_critical=accuracy_critical)
            self.account(int(sched[i]), n_per_step)
        return sched

    def plan_schedule_ragged(self, steps: int, row_remaining,
                             row_critical=None, *, draft_w: int = 1,
                             provisional: bool = False) -> np.ndarray:
        """Per-step ids for a ragged row group → ``int32[steps]``.

        Rows finish at different steps (heterogeneous ``max_new`` /
        continuous-batching slot pools), so step ``i`` bills the ledger for
        the rows actually live at that step (``row_remaining > i``) and is
        accuracy-critical only while a critical row is still live — the exact
        ledger evolution of a stepwise per-row select/account oracle, not the
        group-wide over-billing of padding every row to the longest request.

        Args:
            steps: schedule length (the decode segment's quantum — in
                *windows* when ``draft_w > 1``).
            row_remaining: ``[B]`` tokens each pool row still has to emit
                (0 = idle slot — never billed).
            row_critical: optional ``[B]`` bool accuracy-critical flags.
            draft_w: tokens a speculative draft/verify window can deliver
                (``k + 1``; 1 = plain greedy). Window ``i``'s planned bill
                for row ``b`` is ``min(draft_w, rem_b - i*draft_w)`` —
                **clamped** where the final window would overshoot the
                row's budget, so a row with 3 tokens left never plans 4
                phantom bills under ``draft_w = 4`` (invariant 11:
                accepted-token billing).
            provisional: plan profile ids only — do NOT advance the
                ledger. Speculative segments bill *delivered* tokens at the
                flush boundary (acceptance is data the planner cannot
                know); the plan is just the per-window profile binding.
        Returns:
            ``int32[steps]`` profile ids, ready to ride the fused decode
            scan as data. Unless ``provisional``, the ledger is already
            advanced for all of them — plan exactly one segment ahead, or
            the billing drifts from the rows actually live.
        """
        rem = np.asarray(row_remaining, np.int64)
        w = max(1, int(draft_w))
        crit = (np.zeros(rem.shape, bool) if row_critical is None
                else np.asarray(row_critical, bool))
        sched = np.empty((steps,), np.int32)
        spent0, saver0 = self.spent_j, self._saver
        for i in range(steps):
            live = rem > i * w
            sched[i] = self.select(accuracy_critical=bool((crit & live).any()))
            # never bill past a row's own budget: the last window of a row
            # delivers at most rem - i*w tokens, not a full draft_w
            n_tok = int(np.minimum(w, np.maximum(rem - i * w, 0)).sum())
            self.account(int(sched[i]), n_tok)
        if provisional:
            self.spent_j, self._saver = spent0, saver0
        return sched

    def plan_schedule_classes(self, steps: int, row_remaining, row_levels,
                              critical_levels, row_critical=None, *,
                              draft_w: int = 1, provisional: bool = False
                              ) -> np.ndarray:
        """Per-step ids for a *class-aware* row group → ``int32[steps]``.

        The priority-class analogue of :meth:`plan_schedule_ragged`: each
        pool row carries a priority-class ``level``, and the scheduling
        policy binds some classes to the accuracy target
        (``critical_levels``). Step ``i`` is planned accuracy-critical iff
        any row live at step ``i`` belongs to a bound class or carries its
        own per-request critical flag (``row_critical``) — so a critical-
        class row pins high-precision profiles for exactly the steps it is
        live, and the ledger still bills precisely the live rows (the
        stepwise-oracle exactness contract is unchanged).

        Args:
            steps: schedule length (the decode segment's quantum).
            row_remaining: ``[B]`` tokens each pool row still has to emit.
            row_levels: ``[B]`` int priority-class level per row (value
                irrelevant for idle rows — ``remaining == 0`` never bills).
            critical_levels: class levels whose profile binding is
                accuracy-critical (e.g. ``(0,)`` for the stock ladder).
            row_critical: optional ``[B]`` per-request critical flags,
                OR'd with the class binding.
            draft_w: speculative window width in tokens (``k + 1``); the
                final window of each row is clamped to its remaining
                budget — see :meth:`plan_schedule_ragged`.
            provisional: plan ids without advancing the ledger (the
                speculative flush bills actual delivered tokens instead).
        """
        lvl = np.asarray(row_levels)
        crit = np.isin(lvl, np.asarray(list(critical_levels), lvl.dtype))
        if row_critical is not None:
            crit = crit | np.asarray(row_critical, bool)
        return self.plan_schedule_ragged(steps, row_remaining, crit,
                                         draft_w=draft_w,
                                         provisional=provisional)

    def search_precision(self, n_layers: int,
                         score_fn: Callable[[np.ndarray], float],
                         bytes_fn: Callable[[np.ndarray], float],
                         *, ladder: Sequence[int] = (16, 8, 4),
                         max_drop: float = 0.05) -> tuple[np.ndarray, list[dict]]:
        """Search a per-layer KV bit-width schedule (greedy frontier descent).

        The offline half of the precision-policy loop: the online half
        (``select``/``plan_schedule_*``) binds a *profile* per step, and this
        search produces the per-layer KV schedule a profile carries (the
        ``kv_table`` row the serving engine gathers as data — no retrace).

        Starts from the all-high schedule (``ladder[0]`` everywhere — the
        exact-passthrough baseline) and greedily lowers one layer one rung at
        a time, always taking the move with the best bytes-saved per unit of
        proxy-score increase, while the cumulative proxy score stays within
        ``max_drop`` of the baseline. Layers are never raised back: the walk
        is a monotone descent of the bytes axis, and every accepted state is
        recorded on the frontier.

        Args:
            n_layers: schedule length.
            score_fn: ``schedule -> float`` proxy degradation (0 at the
                all-high baseline; larger = worse). Must be deterministic.
            bytes_fn: ``schedule -> float`` KV bytes/step under the schedule.
            ladder: bit-widths high → low (each move drops one rung).
            max_drop: proxy-score budget — moves that would exceed it are
                rejected.
        Returns:
            ``(schedule, frontier)``: the final ``int32[n_layers]`` schedule
            and the accepted-state frontier, each entry a dict with
            ``schedule`` (list), ``score``, and ``bytes``.
        """
        ladder = [int(b) for b in ladder]
        assert sorted(ladder, reverse=True) == ladder and len(ladder) >= 1
        rung = np.zeros((n_layers,), np.int64)      # index into `ladder`
        sched = np.full((n_layers,), ladder[0], np.int32)
        base = float(score_fn(sched))
        frontier = [{"schedule": sched.tolist(), "score": base,
                     "bytes": float(bytes_fn(sched))}]
        while True:
            best = None                              # (ratio, layer, score, by)
            cur_bytes = frontier[-1]["bytes"]
            for l in range(n_layers):
                if rung[l] + 1 >= len(ladder):
                    continue
                cand = sched.copy()
                cand[l] = ladder[rung[l] + 1]
                s = float(score_fn(cand))
                if s - base > max_drop:
                    continue
                by = float(bytes_fn(cand))
                saved = max(cur_bytes - by, 1e-12)
                ratio = max(s - frontier[-1]["score"], 0.0) / saved
                if best is None or ratio < best[0]:
                    best = (ratio, l, s, by)
            if best is None:
                break
            _, l, s, by = best
            rung[l] += 1
            sched[l] = ladder[rung[l]]
            frontier.append({"schedule": sched.tolist(), "score": s,
                             "bytes": by})
        return sched, frontier

    def exhausted(self) -> bool:
        """Whether the energy budget is fully spent."""
        if not self.budget_j:           # zero budget = unconstrained (see
            return False                # remaining_fraction): never exhausts
        return self.spent_j >= self.budget_j


def battery_simulation(profiles: Sequence[ProfileStats], budget_j: float,
                       accuracy_target: float, accuracy_floor: float,
                       fixed_profile: int | None = None,
                       critical_every: int = 0,
                       max_steps: int = 100_000_000) -> dict:
    """Run inferences until the budget is gone (paper Fig. 4, right).

    ``fixed_profile`` simulates the non-adaptive engine (always that profile);
    otherwise the :class:`ProfileManager` policy runs. ``critical_every`` marks
    every k-th classification accuracy-critical (the paper's "critical
    circumstances"). Returns classifications executed, mean accuracy, and the
    battery lifetime in engine-seconds.
    """
    mgr = ProfileManager(profiles, accuracy_target, accuracy_floor, budget_j)
    n = 0
    acc_sum = 0.0
    lifetime_s = 0.0
    usage = [0] * len(profiles)
    while not mgr.exhausted() and n < max_steps:
        if fixed_profile is not None:
            idx = fixed_profile
        else:
            critical = critical_every > 0 and (n % critical_every == 0)
            idx = mgr.select(accuracy_critical=critical)
        mgr.account(idx)
        usage[idx] += 1
        acc_sum += profiles[idx].accuracy
        lifetime_s += profiles[idx].latency_s
        n += 1
    return {
        "classifications": n,
        "mean_accuracy": acc_sum / max(1, n),
        "lifetime_s": lifetime_s,
        "profile_usage": {p.name: u for p, u in zip(profiles, usage)},
    }
