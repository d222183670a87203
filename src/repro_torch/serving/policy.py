"""Scheduling policy layer: priority classes, profile binding, preemption.

Copy of ``repro/serving/policy.py`` (numpy-only), imports rewritten for the port.

The paper's runtime adaptivity (§4.4) is a *per-request-class* trade of
accuracy against energy — which the serving layer can only realize if the
scheduler knows about classes at all. This module is that knowledge,
factored out of the execution core (:class:`repro_torch.serving.scheduler.
ContinuousScheduler`, which keeps only wave dispatch, segment running and
flush):

* :class:`PriorityClass` — one request class: an urgency ``level`` (lower =
  more urgent), a **profile binding** (``accuracy_critical`` pins the
  :class:`~repro_torch.core.manager.ProfileManager` selection to the accuracy
  target even in the battery-saver regime — the paper's "critical
  circumstances" made first-class), and the preemption contract
  (``preemptible`` / ``can_preempt``).
* :class:`SchedulingPolicy` — the pluggable queue discipline. The execution
  core never touches request ordering directly: it asks the policy for the
  next admission candidate (:meth:`head`), reports waves for billing
  semantics (:meth:`wave_critical`), and hands over preemption decisions
  (:meth:`pick_victims`). :class:`FifoPolicy` reproduces the pre-policy
  scheduler exactly (single FIFO, no classes, no preemption);
  :class:`PriorityPolicy` runs per-class FIFOs with strict
  lowest-level-first admission.
* Victim selection is itself pluggable (``victim_picker``): the default
  picks the lowest class first and, within a class, the row with the
  fewest generated tokens — the cheapest row to suspend and resume, since
  the snapshot/replay cost of :meth:`ContinuousScheduler.evict_row` grows
  with the tokens processed. Selection is all-or-nothing: evicting rows
  without admitting the arrival would burn suspend/resume work for
  nothing.

Nothing in here touches the device: policies are pure host-side decision
objects, so swapping one (or unit-testing one) never recompiles anything.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, NamedTuple, Optional, Sequence

__all__ = ["PriorityClass", "RowState", "SchedulingPolicy", "FifoPolicy",
           "PriorityPolicy", "ShedPolicy", "default_classes",
           "default_victim_picker", "make_policy"]


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One request priority class.

    ``level`` orders admission (lower = more urgent; class 0 is served
    first). ``accuracy_critical`` is the class's *profile binding*: every
    wave or decode step with a live row of this class selects profiles with
    ``accuracy_critical=True``, pinning the ProfileManager to the accuracy
    target even in battery-saver mode. ``preemptible`` marks rows of this
    class as evictable; ``can_preempt`` lets arrivals of this class evict
    strictly-lower classes when slots or KV blocks run dry. ``speculative``
    opts the class's rows into draft/verify speculative decode when the
    server runs with ``ServingConfig.speculate`` — rows of a class that
    opts out ride the same verify windows but advance exactly one token
    per window (the ``spec_on`` operand of ``decode_segment_spec``;
    delivered tokens are identical either way, speculation only changes
    throughput, so the default is on).
    """

    name: str
    level: int
    accuracy_critical: bool = False
    preemptible: bool = True
    can_preempt: bool = False
    speculative: bool = True


def default_classes(n: int) -> tuple[PriorityClass, ...]:
    """The stock ``n``-class ladder (``--priority-classes n``).

    One class degrades to the classless FIFO contract. Two gives
    ``critical`` (accuracy-pinned, non-preemptible, may preempt) over
    ``saver``. Three and more insert ``standard`` tiers in between —
    preemptible by critical arrivals but never preempting anyone.
    """
    if n <= 1:
        return (PriorityClass("standard", 0),)
    crit = PriorityClass("critical", 0, accuracy_critical=True,
                         preemptible=False, can_preempt=True)
    saver = PriorityClass("saver", n - 1)
    mids = tuple(PriorityClass(f"standard{i}" if n > 3 else "standard", i)
                 for i in range(1, n - 1))
    return (crit,) + mids + (saver,)


class RowState(NamedTuple):
    """Preemption-relevant view of one live pool row (host bookkeeping)."""

    slot: int
    rid: int
    level: int
    generated: int        # tokens emitted so far (snapshot/resume cost)
    blocks: int           # private blocks eviction would return to the pool
    preemptible: bool


def default_victim_picker(arrival_level: int, rows: Sequence[RowState],
                          need_slots: int, need_blocks: int
                          ) -> list[RowState]:
    """Lowest class first, fewest generated tokens first, all-or-nothing.

    Only rows of a *strictly lower* class (``level > arrival_level``) are
    candidates — equal-class traffic never preempts itself, so a class
    cannot starve under its own load. Returns the shortest victim prefix
    that frees ``need_slots`` slots and ``need_blocks`` blocks, or ``[]``
    if no prefix does (partial eviction would suspend rows without
    admitting anyone).
    """
    cands = sorted((r for r in rows
                    if r.preemptible and r.level > arrival_level),
                   key=lambda r: (-r.level, r.generated))
    out: list[RowState] = []
    got_blocks = 0
    for r in cands:
        if len(out) >= need_slots and got_blocks >= need_blocks:
            break
        out.append(r)
        got_blocks += r.blocks
    if len(out) >= need_slots and got_blocks >= need_blocks:
        return out
    return []


class SchedulingPolicy:
    """Queue discipline + class semantics behind the execution core.

    Subclasses own the pending-request ordering; the scheduler only ever
    calls :meth:`enqueue` / :meth:`head` / :meth:`pop_head` /
    :meth:`push_front` (the rollback/resume path re-inserts at the front of
    the request's class so relative order within a class is preserved).
    """

    classes: tuple[PriorityClass, ...] = (PriorityClass("standard", 0),)
    preemptive: bool = False

    def klass(self, request) -> PriorityClass:
        """The class a request belongs to (``request.priority`` clamped
        into the table — FIFO policies map everything to class 0)."""
        i = min(max(int(getattr(request, "priority", 0)), 0),
                len(self.classes) - 1)
        return self.classes[i]

    def bind_critical(self, request) -> bool:
        """Resolved accuracy-critical flag: the class's profile binding
        OR'd with the request's own flag (a critical request in a saver
        class still pins accuracy — the paper's per-request escape hatch)."""
        return bool(request.accuracy_critical
                    or self.klass(request).accuracy_critical)

    def wave_critical(self, requests) -> bool:
        """Profile binding of one admission wave (any bound row pins it)."""
        return any(self.bind_critical(r) for r in requests)

    def bind_speculative(self, request) -> bool:
        """Whether this request's rows speculate under a speculative server
        (the class's ``speculative`` flag; classless FIFOs always do)."""
        return bool(self.klass(request).speculative)

    # ---- queue discipline (subclass responsibility) ----------------------
    def enqueue(self, rid: int, request) -> None:
        raise NotImplementedError

    def head(self) -> Optional[int]:
        """Next admission candidate's rid (None when nothing waits)."""
        raise NotImplementedError

    def pop_head(self) -> int:
        raise NotImplementedError

    def push_front(self, rid: int, request) -> None:
        """Re-insert at the front of the request's class (rollback of a
        failed admission, or a suspended row queued for resume)."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    # ---- queue surgery (cancellation / expiry / shedding) ---------------
    def remove(self, rid: int) -> bool:
        """Remove a queued rid wherever it sits; False if not queued."""
        raise NotImplementedError

    def rids(self):
        """All queued rids, admission order (snapshot — safe to mutate
        the policy while iterating the returned list)."""
        raise NotImplementedError

    def shed_tail(self) -> Optional[tuple[int, int]]:
        """The ``(rid, level)`` load shedding would drop first: the
        *least* urgent queued request, last within its class. ``None``
        when the queue is empty."""
        raise NotImplementedError

    # ---- durability (serving/durability.py checkpoints) ------------------
    def queue_state(self) -> dict:
        """JSON-serializable snapshot of the queue discipline's mutable
        state (order, ages) — everything a process restart cannot rebuild
        from the request set alone."""
        raise NotImplementedError

    def restore_queue_state(self, state: dict) -> None:
        """Inverse of :meth:`queue_state` on a freshly built policy."""
        raise NotImplementedError

    # ---- aging -----------------------------------------------------------
    def age_tick(self) -> None:
        """One scheduler round passed: age queued requests (anti-starvation
        hook — the scheduler calls this every round; disciplines without
        aging ignore it)."""

    # ---- preemption ------------------------------------------------------
    def pick_victims(self, request, rows: Sequence[RowState],
                     need_slots: int, need_blocks: int) -> list[RowState]:
        """Victim rows to evict so ``request`` can admit; ``[]`` = don't."""
        return []


class FifoPolicy(SchedulingPolicy):
    """The pre-policy scheduler, verbatim: one FIFO, no classes, no
    preemption. ``priority`` fields are ignored; profile binding reduces to
    each request's own ``accuracy_critical`` flag."""

    def __init__(self):
        self.classes = (PriorityClass("standard", 0),)
        self._q: deque[int] = deque()

    def klass(self, request) -> PriorityClass:
        return self.classes[0]

    def enqueue(self, rid: int, request) -> None:
        self._q.append(rid)

    def head(self) -> Optional[int]:
        return self._q[0] if self._q else None

    def pop_head(self) -> int:
        return self._q.popleft()

    def push_front(self, rid: int, request) -> None:
        self._q.appendleft(rid)

    def __len__(self) -> int:
        return len(self._q)

    def remove(self, rid: int) -> bool:
        try:
            self._q.remove(rid)
            return True
        except ValueError:
            return False

    def rids(self):
        return list(self._q)

    def shed_tail(self) -> Optional[tuple[int, int]]:
        return (self._q[-1], 0) if self._q else None

    def queue_state(self) -> dict:
        return {"q": [int(r) for r in self._q]}

    def restore_queue_state(self, state: dict) -> None:
        self._q = deque(int(r) for r in state["q"])


class PriorityPolicy(SchedulingPolicy):
    """Per-class FIFOs, served strictly lowest-level-first.

    Within a class, order is submission order (resumed / rolled-back
    requests re-enter at the front of their class). ``preemptive`` arms
    :meth:`pick_victims`; ``victim_picker`` is the pluggable selection
    strategy (:func:`default_victim_picker` unless overridden).

    ``aging`` arms anti-starvation promotion: every scheduler round ages
    each queued request by one (:meth:`age_tick`), and a class head that
    has waited ``aging`` rounds is promoted ONE level up — appended to the
    tail of the next-more-urgent queue, behind that class's own backlog,
    with its age reset (climbing two levels takes two full ages). Under a
    sustained critical flood a saver request therefore reaches the front
    in bounded rounds instead of starving forever. Promotion moves queue
    *position only*: the request keeps its class for profile binding,
    billing and preemption (a promoted saver never pins the accuracy
    profile). ``aging=None`` (default) preserves strict
    lowest-level-first exactly.
    """

    def __init__(self, classes: Sequence[PriorityClass],
                 preemptive: bool = False,
                 victim_picker: Optional[Callable] = None,
                 aging: Optional[int] = None):
        assert classes, "at least one priority class"
        self.classes = tuple(sorted(classes, key=lambda c: c.level))
        assert [c.level for c in self.classes] == list(range(len(
            self.classes))), "class levels must be 0..n-1"
        self.preemptive = bool(preemptive)
        self.victim_picker = victim_picker or default_victim_picker
        assert aging is None or aging >= 1, "aging is rounds >= 1"
        self.aging = aging
        self._waited: dict[int, int] = {}     # rid -> rounds since enqueue
        self._q: dict[int, deque[int]] = {c.level: deque()
                                          for c in self.classes}

    def enqueue(self, rid: int, request) -> None:
        self._waited[rid] = 0
        self._q[self.klass(request).level].append(rid)

    def head(self) -> Optional[int]:
        for lvl in range(len(self.classes)):
            if self._q[lvl]:
                return self._q[lvl][0]
        return None

    def pop_head(self) -> int:
        for lvl in range(len(self.classes)):
            if self._q[lvl]:
                rid = self._q[lvl].popleft()
                self._waited.pop(rid, None)
                return rid
        raise IndexError("pop from empty policy queue")

    def push_front(self, rid: int, request) -> None:
        # rollback/resume re-entry: lands at the request's CLASS front
        # (a promotion earned before eviction is forfeited — the wait
        # counter restarts with the new queue residence)
        self._waited.setdefault(rid, 0)
        self._q[self.klass(request).level].appendleft(rid)

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def remove(self, rid: int) -> bool:
        for q in self._q.values():
            try:
                q.remove(rid)
                self._waited.pop(rid, None)
                return True
            except ValueError:
                continue
        return False

    def rids(self):
        return [r for lvl in range(len(self.classes))
                for r in self._q[lvl]]

    def shed_tail(self) -> Optional[tuple[int, int]]:
        for lvl in range(len(self.classes) - 1, -1, -1):
            if self._q[lvl]:
                return (self._q[lvl][-1], lvl)
        return None

    def queue_state(self) -> dict:
        return {"q": {str(lvl): [int(r) for r in q]
                      for lvl, q in self._q.items()},
                "waited": {str(r): int(w) for r, w in self._waited.items()}}

    def restore_queue_state(self, state: dict) -> None:
        # restores queue POSITION (including earned aging promotions) —
        # a promoted rid comes back in its promoted queue, not its class's
        self._q = {c.level: deque(int(r)
                                  for r in state["q"].get(str(c.level), []))
                   for c in self.classes}
        self._waited = {int(r): int(w)
                        for r, w in state.get("waited", {}).items()}

    def age_tick(self) -> None:
        if self.aging is None:
            return
        for q in self._q.values():
            for rid in q:
                self._waited[rid] = self._waited.get(rid, 0) + 1
        for lvl in range(1, len(self.classes)):
            q = self._q[lvl]
            if q and self._waited.get(q[0], 0) >= self.aging:
                rid = q.popleft()
                self._waited[rid] = 0
                self._q[lvl - 1].append(rid)

    def pick_victims(self, request, rows: Sequence[RowState],
                     need_slots: int, need_blocks: int) -> list[RowState]:
        if not self.preemptive:
            return []
        k = self.klass(request)
        if not k.can_preempt:
            return []
        return self.victim_picker(k.level, rows, need_slots, need_blocks)


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Graceful overload degradation thresholds.

    When either threshold trips at submission time, the scheduler sheds
    the *least* urgent queued request (class tail via
    :meth:`SchedulingPolicy.shed_tail`, or the arrival itself if it is no
    more urgent) with :class:`~repro_torch.serving.engine.RequestStatus.SHED` —
    a structured refusal the client can retry elsewhere, instead of
    admitting work that will blow every deadline in the queue.

    * ``max_queue`` — queue-depth cap: shed while more than this many
      requests wait.
    * ``max_predicted_miss`` — deadline-pressure cap: shed when more than
      this many queued requests are already predicted (by the scheduler's
      per-segment wall-time EMA) to miss their deadlines.

    ``None`` disables a threshold; the default instance never sheds.
    """

    max_queue: Optional[int] = None
    max_predicted_miss: Optional[int] = None

    def triggered(self, queue_depth: int, predicted_misses: int) -> bool:
        """True when the current load calls for shedding one request."""
        if self.max_queue is not None and queue_depth > self.max_queue:
            return True
        return (self.max_predicted_miss is not None
                and predicted_misses > self.max_predicted_miss)


def make_policy(scfg) -> SchedulingPolicy:
    """Policy for a :class:`~repro_torch.serving.engine.ServingConfig`:
    ``priority_classes > 1`` (or ``preemption``) builds the stock
    :class:`PriorityPolicy` ladder, anything else the exact legacy
    :class:`FifoPolicy`."""
    n = int(getattr(scfg, "priority_classes", 1) or 1)
    if n > 1 or getattr(scfg, "preemption", False):
        return PriorityPolicy(default_classes(max(2, n)),
                              preemptive=bool(scfg.preemption),
                              aging=getattr(scfg, "aging", None))
    return FifoPolicy()
