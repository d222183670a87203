"""Continuous batching on the paged or the contiguous KV pool (port of
``repro/serving/scheduler.py``: the policy layer, admission waves,
preemption with a bit-exact resume, speculation).

The scheduler owns a fixed ``[max_batch]`` slot pool whose decode state —
last token, position, the paged KV pool — lives on the device and is updated
in place by the server's primitives (the reference donates the same state
through its jit boundaries). A request holds one row from admission to
retirement; free rows idle with ``remaining == 0`` (each step's live mask
freezes them, and an MoE stack's capacity dispatch drops them through
``row_valid``, as it drops a wave's pad rows through their empty prompts).

Decode runs in segments of ``quantum`` steps. Between segments, free rows
are refilled by an **admission wave**: one ragged prefill of the admitted
prompts (rows bucketed to a power of two, prompts left-padded to a power-of-
two length), whose rows are scattered into blocks the
:class:`~repro_torch.serving.paged.BlockAllocator` hands out — exactly the
blocks ``prompt + max_new`` will touch. A dry allocator is backpressure:
the queue head waits. With ``ServingConfig.paged_kv=False`` the pool is
contiguous ``[max_batch, slots]`` rows: admission is gated on free rows
alone, and each wave writes its prefilled rows whole over the pool rows
(:meth:`~repro_torch.serving.engine.AdaptiveServer.admit`). Token blocks
come back one segment late
(``_flush(keep=1)``): retirement needs only the host's ``remaining`` counts,
so the next dispatch is queued before the previous tokens are read.

The profile plan is made one segment ahead with
:meth:`~repro_torch.core.manager.ProfileManager.plan_schedule_ragged` (or,
under more than one priority class,
:meth:`~repro_torch.core.manager.ProfileManager.plan_schedule_classes`)
over the rows actually live at each step, so the energy ledger bills
exactly the live rows; every billing event lands in
:attr:`ContinuousScheduler.events`.

**Policy** (:mod:`repro_torch.serving.policy`): the queue discipline,
class→profile binding and victim choice. Under ``priority_classes > 1``
class 0 admits first and pins every wave and step a class-0 row is live
for to the accuracy target, in the saver regime too; ``aging`` promotes a
starved class head one level per ``aging`` rounds.

**Preemption** (``ServingConfig.preemption``, paged pool): a critical
arrival that cannot admit evicts policy-chosen saver rows
(:meth:`ContinuousScheduler.evict_row`): the victim's written span is
snapshotted as f32 masters with its exact scales
(:class:`~repro_torch.serving.paged.RowSnapshot`), its blocks go back
(registered prefixes park in the LRU), its table is unmapped and it
requeues at the front of its class. It later resumes through the
master-replay continuation wave with an empty suffix: pure data movement,
so the rebuilt cache bytes, scales and ``token_idx`` equal the suspended
row's and it continues token-identically. Suspension and resume bill
nothing.

**Speculation** (``ServingConfig.speculate``): each segment runs
``ceil(quantum / W)`` draft/verify windows (``W = draft_k + 1``) with a
quota of ``quantum`` delivered tokens per row. A window's delivered count
is data the host needs for retirement, history and billing, so spec mode
is synchronous (``_flush(keep=0)``): the profile plan is provisional, and
the ledger bills the tokens each window actually delivered at the flush
(:attr:`ContinuousScheduler.spec_billed`, invariant 11 of the reference).
Speculation runs on either pool, shared copy-on-write rows and resumed rows
included; a class with ``speculative=False`` advances one token per
window.

**Shared prefixes** (``ServingConfig.prefix_cache``): prompts are hashed at
block granularity when submitted and matched against a
:class:`~repro_torch.serving.paged.PrefixRegistry` at admission. A hit
prefills only its suffix (a continuation wave over the prefix K/V: at kv16
gathered from the shared blocks, at int KV replayed from f32 masters under
``max(prefix amax, suffix amax)``) and, at kv16, maps the registered
blocks copy-on-write: the row's table holds them, the wave never writes
them. Two prompts of one cold wave that share a prefix are deduplicated:
the later one defers its lookup until the wave has registered the prefix
and rides the shared wave. Retired blocks a registered prefix still covers
park in the allocator's retired-block LRU.

**Chunked prefill** (``ServingConfig.prefill_chunk``): a prompt longer than
the chunk rides its admission wave with its first chunk only; the rest
follows one chunk per admission round through continuation waves, between
decode segments. A row mid-admission holds its slot and blocks with
``remaining == 0`` (frozen), its profile pinned for the whole prompt, and
continuation waves bill nothing. Each round dispatches at most two prefill
waves (cold, shared, resume, chunk continuations per pinned profile).

**Fault tolerance**: every request leaves through exactly one terminal
:class:`~repro_torch.serving.engine.RequestStatus`. ``COMPLETED`` (all
tokens delivered); ``CANCELLED`` (:meth:`ContinuousScheduler.cancel`: a
queued request drops at once, a live row is reaped at the next flush
boundary, so it is billed exactly the tokens it delivered); ``EXPIRED``
(``Request.deadline_ms`` passed, or admission predicts from the step-time
EMA that it cannot be met); ``SHED`` (a
:class:`~repro_torch.serving.policy.ShedPolicy` judged the pool overloaded
at submission: the least urgent party goes); ``FAILED`` (quarantine
retries exhausted). A row whose logits go non-finite (the per-row finite
check rides the decode segment) is *quarantined*: its blocks go back as
on eviction, its tokens are discarded (argmax over NaN is garbage), it
escalates to ``accuracy_critical=True`` and requeues at the front of its
class after ``1, 2, 4, ...`` rounds of backoff, up to ``retry_budget``
retries; the retry recomputes its whole prompt cold, so its tokens equal
a clean accuracy-critical run's. A seeded
:class:`~repro_torch.serving.faults.FaultSchedule` injects NaN logits
(as data through the one segment), dry allocator rounds and flush stalls;
a :class:`~repro_torch.serving.faults.Watchdog` flags slow rounds, and
:meth:`ContinuousScheduler.check` (after every step with ``paranoid``)
audits the block pool's refcounts.

**Durability** (:mod:`repro_torch.serving.durability`): an attached
``durable`` layer is told of every lifecycle edge at the reference's
points, in the reference's order (submit, cancel, finalize and deliver
records, write-ahead; flush, admit and round-end markers, the round end
driving the checkpoint cadence); :meth:`ContinuousScheduler.drain` stops
admission and finishes every admitted row.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from .engine import AdaptiveServer, Request, RequestStatus, _next_pow2
from .faults import FaultSchedule, Watchdog
from .paged import BlockAllocator, PrefixRegistry, RowSnapshot, prefix_keys
from .policy import RowState, SchedulingPolicy, ShedPolicy, make_policy

__all__ = ["ContinuousScheduler"]


def _f32(x: torch.Tensor) -> torch.Tensor:
    """An f32 copy of ``x`` in a buffer of its own (a master must not keep
    the whole wave's raw K/V alive)."""
    return torch.empty(x.shape, dtype=torch.float32,
                       device=x.device).copy_(x)


class ContinuousScheduler:
    """Continuous batching on an :class:`AdaptiveServer`'s slot pool.

    ``quantum`` = decode steps per segment; ``prefill_bucket`` = minimum
    power-of-two prompt padding; ``record_events`` keeps the billing events
    and admission order (for the ledger-oracle tests — a long-lived server
    turns it off); ``policy`` defaults to
    :func:`~repro_torch.serving.policy.make_policy` of the server's config
    (the FIFO unless ``priority_classes``/``preemption`` say otherwise).

    Robustness knobs: ``shed`` (a :class:`~repro_torch.serving.policy.
    ShedPolicy` checked at :meth:`submit`), ``faults`` (a seeded
    :class:`~repro_torch.serving.faults.FaultSchedule`), ``retry_budget``
    (quarantine retries before ``FAILED``), ``watchdog_s`` (the per-step
    budget of a :class:`~repro_torch.serving.faults.Watchdog`), ``clock``
    (replaces ``time.monotonic``: tests inject virtual time) and
    ``paranoid`` (run :meth:`check` after every step).
    """

    def __init__(self, server: AdaptiveServer, quantum: int = 8,
                 prefill_bucket: int = 8, record_events: bool = True,
                 policy: Optional[SchedulingPolicy] = None,
                 shed: Optional[ShedPolicy] = None,
                 faults: Optional[FaultSchedule] = None,
                 retry_budget: int = 2,
                 watchdog_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 paranoid: bool = False):
        self.srv = server
        self.quantum = int(quantum)
        self.bucket_min = int(prefill_bucket)
        self.record_events = record_events
        cfg, scfg = server.cfg, server.scfg
        nslots = self.n_slots = scfg.max_batch
        self.policy = policy if policy is not None else make_policy(scfg)
        dev = server.device
        # an SSM stack has no KV to page: its O(1) state rides the
        # contiguous pool whatever ``paged_kv`` asks for
        self.paged = bool(scfg.paged_kv) and cfg.has_attn
        if self.policy.preemptive and (not self.paged or not scfg.preemption
                                       or not server.can_restore):
            raise ValueError(
                "a preemptive policy needs the paged pool and a server "
                "built with ServingConfig.preemption=True (the restore "
                "wave) on a supports_prefix_sharing stack")
        if self.paged:
            self.block_size = server.block_size
            self.n_lblk = server.n_lblk
            nb = (scfg.pool_blocks if scfg.pool_blocks is not None
                  else nslots * self.n_lblk)
            self._caches = T.init_paged_caches(
                cfg, nslots, scfg.slots, kv_bits=scfg.kv_bits,
                block_size=self.block_size, pool_blocks=nb, device=dev)
            self.allocator = BlockAllocator(nb, self.block_size)
            self.registry = (PrefixRegistry(self.allocator,
                                            capacity=scfg.prefix_capacity)
                             if server.prefix_sharing else None)
            self._slot_blocks: list = [None] * nslots  # (private, entry)
            self._prefix_keys: dict[int, list[bytes]] = {}
            self.peak_used_blocks = 0
            # chunked prefill: a mid-admission row's progress, by slot
            self.chunk = server.chunk_tokens
            self._chunk_state: dict[int, dict] = {}
        else:
            self._caches = T.init_caches(cfg, nslots, scfg.slots,
                                         kv_bits=scfg.kv_bits, device=dev)
            self.allocator = None
            self.registry = None
        self._tok = torch.zeros((nslots,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((nslots,), dtype=torch.int32, device=dev)
        self.remaining = np.zeros((nslots,), np.int64)   # tokens left to emit
        self.slot_req: list[Optional[int]] = [None] * nslots
        self._slot_crit = np.zeros((nslots,), bool)
        self._slot_level = np.zeros((nslots,), np.int32)  # priority class
        self._reqs: dict[int, Request] = {}
        self._suspended: dict[int, RowSnapshot] = {}       # rid -> snapshot
        self.preemptions = 0
        self.resumes = 0
        self.results: dict[int, dict] = {}
        self._n = 0
        self.admission_log: list[int] = []               # rids, admission order
        self.events: list[tuple[int, int, bool]] = []    # (pid, n_rows, crit)
        self._done: list[int] = []                       # completions, in order
        self._inflight: list[dict] = []                  # dispatched, unread
        self.segments_run = 0
        self.decode_steps = 0
        self.chunk_waves = 0           # continuation waves of chunked rows
        self.prefill_tokens = 0        # prompt tokens the waves computed
        self.segments_chunking = 0     # segments run while a row chunked in
        self.windows_run = 0
        self.spec_row_windows = 0      # (row, window) pairs that delivered
        # speculative state: per-row drafter history (−1 pad, last entry =
        # the row's current token, updated at the flush) and the per-class
        # opt-out mask (bound at admission)
        self.spec = bool(scfg.speculate)
        self.draft_w = int(scfg.draft_k) + 1 if self.spec else 1
        if self.spec:
            self._hist = np.full((nslots, int(scfg.draft_hist)), -1,
                                 np.int32)
            self._slot_spec = np.ones((nslots,), bool)
            # (pid, delivered) per verify window, in billing order: the
            # flush-side twin of the planned `events`
            self.spec_billed: list[tuple[int, int]] = []
        # robustness: deadlines, cancellation, quarantine, shedding
        self.clock = clock if clock is not None else time.monotonic
        self.shed = shed
        self.faults = faults
        self.retry_budget = int(retry_budget)
        self.watchdog = (Watchdog(float(watchdog_s))
                         if watchdog_s is not None else None)
        self.paranoid = bool(paranoid)
        self._deadline: dict[int, float] = {}     # rid -> absolute deadline
        self._to_reap: dict[int, RequestStatus] = {}     # slot -> status
        self._nf_rows: list[int] = []             # rids w/ non-finite logits
        self._quarantine_q: list[tuple[int, int]] = []   # (ready_round, rid)
        self._attempts: dict[int, int] = {}       # rid -> quarantine retries
        self._q_t0: dict[int, float] = {}         # rid -> first-fault time
        self._round = 0
        self._seg_dt: Optional[float] = None      # step wall-time EMA
        self._flush_idx = 0
        # durability layer (serving/durability.py): when attached, it is
        # told of every lifecycle edge (submit, cancel, finalize, deliver:
        # fsync'd write-ahead records) and flush boundary (checkpoint
        # cadence, crash-point markers); None costs nothing
        self.durable = None
        self.draining = False                     # admit nothing new
        self.cancelled = self.expired = self.shed_count = self.failed = 0
        self.recovered = self.faults_detected = 0
        self.alloc_injected_rounds = 0
        self.recovery_latency: list[float] = []   # seconds, fault -> done

    # ------------------------------------------------------------- paged util
    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks a request touches over its life: prompt positions plus
        every decode write, capped at the row's logical table."""
        return min(self.n_lblk,
                   -(-(prompt_len + max_new) // self.block_size))

    def _release_blocks(self, blocks) -> None:
        """Return a row's private blocks: those a registered prefix still
        covers park in the allocator's retired-block LRU, the rest go
        straight to the free list."""
        self.allocator.release(
            blocks, cache=(self.registry.covered(blocks)
                           if self.registry is not None else ()))

    def _retire_blocks(self, slot: int) -> None:
        """Hand back slot ``slot``'s private blocks and its registry
        entry's shared references."""
        blocks, reg = self._slot_blocks[slot]
        self._release_blocks(blocks)
        if reg is not None:
            self.registry.release(reg)
        self._slot_blocks[slot] = None

    def paged_stats(self) -> dict:
        """Block-pool occupancy (live / LRU-cached / free partition) and the
        prefix registry's counters; the contiguous pool reports
        ``{"paged": False, "kv_bytes": ...}``."""
        if not self.paged:
            return {"paged": False, "kv_bytes": T.cache_bytes(self._caches)}
        live = self.allocator.used_blocks
        out = {
            "paged": True,
            "block_size": self.block_size,
            "pool_blocks": self.allocator.n_blocks,
            "used_blocks": live,
            "live_blocks": live,
            "lru_cached_blocks": self.allocator.lru_blocks,
            "reclaimed_blocks": self.allocator.reclaimed_blocks,
            "peak_used_blocks": self.peak_used_blocks,
            "free_blocks": self.allocator.free_blocks,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "kv_bytes": T.cache_bytes(self._caches),
            "registry_bytes": 0,
        }
        if self.registry is not None:
            out.update(registry_entries=len(self.registry),
                       registry_hits=self.registry.hits,
                       registry_misses=self.registry.misses,
                       registry_invalidated=self.registry.invalidated,
                       registry_bytes=self.registry.nbytes())
        return out

    # ------------------------------------------------------------------ queue
    def submit(self, request: Request) -> int:
        """Enqueue a request; returns its id. A request that could never fit
        the pool raises ``ValueError`` here: more blocks than the pool has,
        or, on a prefix-sharing pool, ``prompt + max_new >=`` the row's
        virtual length (its ring position could wrap onto a shared
        block). The deadline starts now. Under a :class:`ShedPolicy` that
        trips, one request finalizes ``SHED``: the queue's class tail if
        it is strictly less urgent than the arrival, else the arrival (a
        saver flood never displaces queued critical work)."""
        if self.paged and request.max_new > 0:
            plen = len(request.tokens)
            if self.registry is not None \
                    and plen + request.max_new >= self.srv.slots_p:
                raise ValueError(
                    f"request needs {plen + request.max_new} KV slots but a "
                    f"prefix-sharing paged pool caps rows at "
                    f"{self.srv.slots_p - 1} (slots={self.srv.scfg.slots})")
            need = self._blocks_needed(plen, request.max_new)
            if need > self.allocator.n_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool has only "
                    f"{self.allocator.n_blocks} "
                    f"(block_size={self.block_size})")
        rid = self._n
        self._n += 1
        self._reqs[rid] = request
        if self.durable is not None:
            # write-ahead: the submit record is durable before the request
            # can be observed, so a crash never loses an accepted request
            self.durable.on_submit(rid, request)
        if request.deadline_ms is not None:
            self._deadline[rid] = self.clock() + request.deadline_ms / 1e3
        if request.max_new <= 0:        # nothing to generate: done on arrival
            self.results[rid] = {"tokens": [], "profile_trace": [],
                                 "status": RequestStatus.COMPLETED}
            self._done.append(rid)
            return rid
        if self.shed is not None and self.shed.triggered(
                len(self.policy) + 1, self._predicted_misses()):
            tail = self.policy.shed_tail()
            if tail is not None and tail[1] > self.policy.klass(
                    request).level:
                vrid = tail[0]
                self.policy.remove(vrid)
                self._suspended.pop(vrid, None)
                self._finalize(vrid, RequestStatus.SHED,
                               reason="overload: displaced by a more "
                                      "urgent arrival")
            else:
                self._finalize(rid, RequestStatus.SHED,
                               reason="overload: queue depth or deadline "
                                      "pressure over threshold")
                return rid
        if self.paged and self.registry is not None:
            self._prefix_keys[rid] = prefix_keys(
                np.asarray(request.tokens, np.int32), self.block_size)
        self.policy.enqueue(rid, request)
        return rid

    @property
    def live_rows(self) -> int:
        """Pool rows still generating (``remaining > 0``)."""
        return int((self.remaining > 0).sum())

    @property
    def pending(self) -> int:
        """Requests queued but not yet admitted (suspended rows waiting to
        resume count: they hold no slot)."""
        return len(self.policy)

    def poll_completed(self) -> list[tuple[int, dict]]:
        """``(rid, result)`` pairs finished since the last poll; ownership
        of each result passes to the caller."""
        done, self._done = self._done, []
        if done and self.durable is not None:
            # deliver record before the hand-over: recovery drops exactly
            # the rids the caller owns and delivers the rest again
            self.durable.on_deliver(done)
        out = []
        for rid in done:
            out.append((rid, self.results.pop(rid)))
            self._reqs.pop(rid, None)
            self._deadline.pop(rid, None)
            self._attempts.pop(rid, None)
            self._q_t0.pop(rid, None)
            if self.paged:
                self._prefix_keys.pop(rid, None)
        return out

    # ------------------------------------------- request lifecycle (terminal)
    def _finalize(self, rid: int, status: RequestStatus,
                  reason: Optional[str] = None) -> None:
        """Retire a request through its one terminal status: stamp the
        result (tokens already read stay on it: a cancelled or expired
        request keeps, and was billed for, what it generated), count it
        and queue it for :meth:`poll_completed`."""
        res = self.results.setdefault(rid,
                                      {"tokens": [], "profile_trace": []})
        res["status"] = status
        if reason is not None:
            res["reason"] = reason
        if rid in self._attempts:
            res["retries"] = self._attempts[rid]
        self._done.append(rid)
        if status is RequestStatus.CANCELLED:
            self.cancelled += 1
        elif status is RequestStatus.EXPIRED:
            self.expired += 1
        elif status is RequestStatus.SHED:
            self.shed_count += 1
        elif status is RequestStatus.FAILED:
            self.failed += 1
        if self.durable is not None:
            self.durable.on_final(rid)

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it sits; True if it took.

        A queued request (suspended and quarantine-backoff ones included)
        drops at once with ``CANCELLED``. A live or mid-chunk row is
        *marked* and reaped at the next flush boundary: every dispatched
        token is read first, so the ledger bills exactly what the request
        generated, and its blocks go back as on eviction. False for unknown
        rids and for requests already terminal — one whose last tokens are
        in flight completes as ``COMPLETED``."""
        took = self._cancel(rid)
        if took and self.durable is not None:
            self.durable.on_cancel(rid)
        return took

    def _cancel(self, rid: int) -> bool:
        if rid not in self._reqs or "status" in self.results.get(rid, {}):
            return False
        if self.policy.remove(rid):
            self._suspended.pop(rid, None)
            self._finalize(rid, RequestStatus.CANCELLED)
            return True
        for i, (_rdy, qrid) in enumerate(self._quarantine_q):
            if qrid == rid:
                del self._quarantine_q[i]
                self._finalize(rid, RequestStatus.CANCELLED)
                return True
        for slot in range(self.n_slots):
            if self.slot_req[slot] == rid:
                if slot in self._to_reap:
                    return False             # already marked for the reaper
                self._to_reap[slot] = RequestStatus.CANCELLED
                return True
        if self.paged:
            for slot, st in self._chunk_state.items():
                if st["rid"] == rid:
                    if slot in self._to_reap:
                        return False
                    self._to_reap[slot] = RequestStatus.CANCELLED
                    return True
        if rid in self._nf_rows:
            # flagged non-finite, its slot already retired: cancellation
            # preempts the quarantine retry
            self._nf_rows.remove(rid)
            self._finalize(rid, RequestStatus.CANCELLED)
            return True
        return False

    def _eta_s(self, rid: int) -> float:
        """Predicted seconds to finish ``rid`` if admitted now: its
        remaining tokens at the step-time EMA (0.0 before a first segment
        calibrates it: admission never rejects blind)."""
        if self._seg_dt is None:
            return 0.0
        req = self._reqs[rid]
        left = req.max_new - len(self.results.get(rid, {}).get("tokens", ()))
        return -(-left // self.quantum) * self._seg_dt

    def _deadline_unreachable(self, rid: int) -> bool:
        dl = self._deadline.get(rid)
        return dl is not None and self.clock() + self._eta_s(rid) > dl

    def _predicted_misses(self) -> int:
        """Queued requests already predicted to miss their deadlines (the
        :class:`ShedPolicy`'s second trigger)."""
        if self._seg_dt is None or not self._deadline:
            return 0
        return sum(1 for rid in self.policy.rids()
                   if self._deadline_unreachable(rid))

    def _expire(self) -> None:
        """Retire every request past its deadline: queued, suspended and
        backoff requests finalize ``EXPIRED`` now; live and mid-chunk rows
        are marked for the flush-boundary reap (they keep the tokens they
        generated)."""
        if not self._deadline:
            return
        now = self.clock()
        for rid in self.policy.rids():
            dl = self._deadline.get(rid)
            if dl is not None and now > dl:
                self.policy.remove(rid)
                self._suspended.pop(rid, None)
                self._finalize(rid, RequestStatus.EXPIRED)
        if self._quarantine_q:
            keep = []
            for rdy, rid in self._quarantine_q:
                dl = self._deadline.get(rid)
                if dl is not None and now > dl:
                    self._finalize(rid, RequestStatus.EXPIRED)
                else:
                    keep.append((rdy, rid))
            self._quarantine_q = keep
        for slot in range(self.n_slots):
            if slot in self._to_reap:
                continue
            rid = self.slot_req[slot]
            if rid is None and self.paged and slot in self._chunk_state:
                rid = self._chunk_state[slot]["rid"]
            if rid is None:
                continue
            dl = self._deadline.get(rid)
            if dl is not None and now > dl:
                self._to_reap[slot] = RequestStatus.EXPIRED

    def _vacate(self, slot: int) -> None:
        """Free live row ``slot``: hand its blocks back (paged pool) and
        zero its host state. The caller unmaps its table."""
        if self.paged:
            self._retire_blocks(slot)
        self.slot_req[slot] = None
        self._slot_crit[slot] = False
        self._slot_level[slot] = 0
        self.remaining[slot] = 0

    def _reap_marked(self) -> None:
        """Flush-boundary reap of cancelled and expired rows: read every
        dispatched token first (billed == delivered), then release each
        marked row's blocks and unmap the tables in one clear — the
        eviction machinery without the snapshot."""
        if not self._to_reap:
            return
        self._flush(0)
        marked, self._to_reap = self._to_reap, {}
        clear = []
        for slot, status in marked.items():
            if self.paged and slot in self._chunk_state:
                st = self._chunk_state.pop(slot)
                rid = st["rid"]
                self._release_blocks(st["blocks"])
                if st["entry"] is not None:
                    self.registry.release(st["entry"])
                clear.append(slot)
                if rid in self._nf_rows:
                    self._nf_rows.remove(rid)
                self._finalize(rid, status)
                continue
            rid = self.slot_req[slot]
            if rid is None:
                continue         # completed inside the in-flight segment
            if rid in self._nf_rows:
                self._nf_rows.remove(rid)    # cancel/expiry beats quarantine
            self._vacate(slot)
            if self.paged:
                clear.append(slot)
            self._finalize(rid, status)
        if clear:
            self.srv.clear_rows(clear, self._caches)

    def _process_quarantine(self) -> None:
        """Quarantine and escalated retry of rows flagged non-finite.

        The row's blocks go back as on eviction, but no snapshot is taken
        and the attempt's tokens are discarded: everything argmaxed after
        the bad logits is garbage, so the retry restarts from the prompt.
        The retry binds ``accuracy_critical=True`` (one rung up, to the
        accuracy target) and requeues at the front of its class after
        ``1 << (attempt - 1)`` rounds; past ``retry_budget`` retries the
        request finalizes ``FAILED``."""
        if not self._nf_rows:
            return
        self._flush(0)           # may flag more rows; drain what's known
        rows, self._nf_rows = self._nf_rows, []
        clear = []
        for rid in rows:
            slot = next((s for s in range(self.n_slots)
                         if self.slot_req[s] == rid), None)
            if slot is not None:
                self._vacate(slot)
                if self.paged:
                    clear.append(slot)
            self.faults_detected += 1
            attempt = self._attempts.get(rid, 0) + 1
            self._attempts[rid] = attempt
            self._q_t0.setdefault(rid, self.clock())
            self.results[rid] = {"tokens": [], "profile_trace": []}
            if attempt > self.retry_budget:
                self._q_t0.pop(rid, None)
                self._finalize(rid, RequestStatus.FAILED,
                               reason="retry budget exhausted")
                continue
            req = self._reqs[rid]
            if not req.accuracy_critical:
                self._reqs[rid] = dataclasses.replace(
                    req, accuracy_critical=True)
            self._quarantine_q.append(
                (self._round + (1 << (attempt - 1)), rid))
        if clear:
            self.srv.clear_rows(clear, self._caches)

    def check(self) -> None:
        """Audit the paged pool (no-op on the contiguous one): rebuild the
        expected per-block refcounts — one per live row's private block,
        per mid-chunk row's private block, and per registry sharer of each
        entry block — and hand them to :meth:`~repro_torch.serving.paged.
        BlockAllocator.check`, which also verifies the free/LRU/live
        partition. Raises ``RuntimeError`` on any divergence."""
        if not self.paged:
            return
        exp = np.zeros((self.allocator.n_blocks,), np.int64)
        for sb in self._slot_blocks:
            if sb is not None:
                for b in sb[0]:
                    exp[int(b)] += 1
        for st in self._chunk_state.values():
            for b in st["blocks"]:
                exp[int(b)] += 1
        if self.registry is not None:
            self.registry.add_expected_refs(exp)
        self.allocator.check(expected=exp)

    def robustness_stats(self) -> dict:
        """Fault-tolerance counters."""
        out = {"cancelled": self.cancelled, "expired": self.expired,
               "shed": self.shed_count, "failed": self.failed,
               "recovered": self.recovered,
               "faults_detected": self.faults_detected,
               "alloc_injected_rounds": self.alloc_injected_rounds,
               "recovery_latency_s": list(self.recovery_latency),
               "watchdog_stalls": (self.watchdog.stalls
                                   if self.watchdog is not None else 0)}
        if self.faults is not None:
            out.update(injected_nan=self.faults.injected_nan,
                       injected_alloc=self.faults.injected_alloc,
                       injected_stall=self.faults.injected_stall)
        return out

    # -------------------------------------------------------------- admission
    def admit(self) -> int:
        """Fill free slots from the queue in policy order; returns the
        number of requests admitted. The contiguous pool runs one cold wave
        gated on free rows; the paged pool classifies candidates by the
        wave they need (:meth:`_admit_paged_waves`). A candidate whose
        deadline the step-time EMA rules unreachable finalizes ``EXPIRED``
        instead. Nothing admits while ``draining``, nor in a round the
        :class:`FaultSchedule` declares the allocator dry."""
        if self.draining:
            return 0
        if self.faults is not None and self.faults.alloc_dry(self._round):
            self.alloc_injected_rounds += 1
            return 0
        if self.paged:
            return self._admit_paged_waves()
        free = [s for s in range(self.n_slots) if self.slot_req[s] is None]
        rows = []
        while free and len(self.policy):
            rid = self.policy.pop_head()
            if self._deadline_unreachable(rid):
                self._finalize(rid, RequestStatus.EXPIRED,
                               reason="deadline unreachable at admission")
                continue
            rows.append((rid, free.pop(0), None))
        return self._dispatch_cold(rows) if rows else 0

    def _admit_paged_waves(self) -> int:
        """Claim slots *and* blocks in policy order, then dispatch at most
        two prefill waves.

        First a preemptive policy may evict victims for an urgent head that
        would not fit (:meth:`_maybe_preempt`). A candidate is **cold**
        (full ragged prefill; a prompt longer than the chunk rides with its
        first chunk), **shared** (a registry hit: suffix-only continuation;
        a hit with a long suffix chunks too), **resume** (a suspended row
        replaying its snapshot; one pinned profile per round) or
        **deferred**: a cold candidate whose prefix an earlier candidate of
        this round's cold wave will register. It looks the registry up
        again once that wave has dispatched and rides the shared wave; if
        the prefix did not register, or the private-block top-up fails, it
        rolls back to the head of its class for the next round. A round
        commits to at most two wave kinds; chunk continuations that will
        run this round (one wave per pinned profile) take their share of
        the two first (``kind_cap``), and a candidate needing a kind over
        the cap waits. Then the mid-admission chunks advance.
        """
        self._maybe_preempt()
        free = [s for s in range(self.n_slots)
                if self.slot_req[s] is None and s not in self._chunk_state]
        cold, shared, deferred, chunked, shared_chunked = [], [], [], [], []
        resume: list = []
        resume_pid: Optional[int] = None
        kinds: set = set()
        kind_cap = 2 - len({st["pid"] for st in self._chunk_state.values()
                            if not st.get("fresh")})
        pending: dict[bytes, int] = {}   # key -> tokens this wave registers
        while free and len(self.policy):
            rid = self.policy.head()
            if self._deadline_unreachable(rid):
                self.policy.pop_head()
                self._suspended.pop(rid, None)
                self._finalize(rid, RequestStatus.EXPIRED,
                               reason="deadline unreachable at admission")
                continue
            req = self._reqs[rid]
            if rid in self._suspended:
                if "resume" not in kinds and len(kinds) >= kind_cap:
                    break                # over budget: next round
                snap = self._suspended[rid]
                if resume and snap.pid != resume_pid:
                    break                # one pinned-pid resume group/round
                blocks = self.allocator.alloc(
                    self._blocks_needed(len(req.tokens), req.max_new))
                if blocks is None:
                    break                # backpressure: the head waits
                self.policy.pop_head()
                resume.append((rid, free.pop(0), blocks))
                resume_pid = snap.pid
                kinds.add("resume")
                continue
            plen = len(req.tokens)
            need = self._blocks_needed(plen, req.max_new)
            # a quarantine retry looks nothing up: a hit would map blocks
            # prefilled under another profile, and the retry must equal a
            # clean run at the escalated one, so it recomputes cold
            keys = (self._prefix_keys.get(rid, [])
                    if self._attempts.get(rid, 0) == 0 else [])
            entry, wait, n_shared = None, False, 0
            if self.registry is not None:
                entry = self.registry.lookup(keys)
            if entry is not None:
                self.registry.acquire(entry)     # references (or resurrects
                if entry.block_ids is not None:  # from the LRU) its blocks
                    n_shared = entry.n_tokens // self.block_size
            elif pending:
                for k in keys:                   # longest first, as lookup
                    if k in pending:
                        wait = True
                        if self.srv.scfg.kv_bits == 16:
                            n_shared = pending[k] // self.block_size
                        break
            kind = "shared" if (entry is not None or wait) else "cold"
            if kind not in kinds and len(kinds) >= kind_cap:
                if entry is not None:
                    self.registry.release(entry)
                break                            # over budget: next round
            blocks = self.allocator.alloc(need - n_shared)
            if blocks is None:                   # backpressure: the head
                if entry is not None:            # waits, order preserved
                    self.registry.release(entry)
                break
            self.policy.pop_head()
            slot = free.pop(0)
            kinds.add(kind)
            if self.registry is not None and not wait:
                self.registry.record_admission(entry)
            if entry is not None:
                if self.chunk and plen - entry.n_tokens > self.chunk:
                    shared_chunked.append((rid, slot, entry, blocks))
                else:
                    shared.append((rid, slot, entry, blocks))
            elif wait:
                deferred.append((rid, slot, blocks, keys))
            elif self.chunk and plen > self.chunk:
                chunked.append((rid, slot, blocks))
            else:
                cold.append((rid, slot, blocks))
                if self.registry is not None:
                    j_max = (plen - 1) // self.block_size
                    for i, k in enumerate(keys):     # chain, longest first
                        pending.setdefault(k, (j_max - i) * self.block_size)
        n = 0
        if cold or chunked:
            n += self._dispatch_cold(cold, chunked)
        rollback: list[int] = []
        for rid, slot, blocks, keys in deferred:
            # the cold wave has registered its chains: resolve now, and
            # square the private blocks with the entry actually registered
            req = self._reqs[rid]
            need = self._blocks_needed(len(req.tokens), req.max_new)
            entry = self.registry.lookup(keys)
            if entry is None:
                self.allocator.release(blocks)
                rollback.append(rid)
                continue
            self.registry.acquire(entry)
            n_shared = (entry.n_tokens // self.block_size
                        if entry.block_ids is not None else 0)
            n_priv = need - n_shared
            if len(blocks) > n_priv:
                self.allocator.release(blocks[n_priv:])
                blocks = blocks[:n_priv]
            elif len(blocks) < n_priv:
                extra = self.allocator.alloc(n_priv - len(blocks))
                if extra is None:
                    self.registry.release(entry)
                    self.allocator.release(blocks)
                    rollback.append(rid)
                    continue
                blocks = blocks + extra
            self.registry.record_admission(entry)
            if self.chunk and len(req.tokens) - entry.n_tokens > self.chunk:
                shared_chunked.append((rid, slot, entry, blocks))
            else:
                shared.append((rid, slot, entry, blocks))
        if shared or shared_chunked:
            n += self._dispatch_shared(shared, shared_chunked)
        if resume:
            n += self._dispatch_resume(resume)
        for rid in reversed(rollback):      # keep their relative order
            self.policy.push_front(rid, self._reqs[rid])
        if n:
            self.peak_used_blocks = max(self.peak_used_blocks,
                                        self.allocator.used_blocks)
        self._advance_chunks()
        return n

    def _bill(self, reqs) -> int:
        """Select/account the wave's profile (one inference per request)."""
        mgr = self.srv.manager
        crit = self.policy.wave_critical(reqs)
        pid = 0 if mgr is None else mgr.select(crit)
        if mgr is not None:
            mgr.account(pid, len(reqs))
        if self.record_events:
            self.events.append((pid, len(reqs), crit))
        return pid

    # ------------------------------------------------------------- preemption
    def _maybe_preempt(self) -> None:
        """The preemption trigger: the queue head's class may preempt and
        the pool cannot take it (no free slot, or the allocator's free and
        reclaimable blocks do not cover its private need). The policy picks
        the victims (lowest class first, fewest tokens first, all or
        nothing); each is suspended by :meth:`evict_row`, and all their
        tables are unmapped in one clear."""
        if not self.policy.preemptive:
            return
        rid = self.policy.head()
        if rid is None:
            return
        req = self._reqs[rid]
        need = self._blocks_needed(len(req.tokens), req.max_new)
        if rid not in self._suspended and self.registry is not None:
            # a hit maps its prefix blocks: count only the private need
            entry = self.registry.lookup(self._prefix_keys.get(rid, []))
            if entry is not None and entry.block_ids is not None:
                need -= entry.n_tokens // self.block_size
        have_slot = any(self.slot_req[s] is None
                        and s not in self._chunk_state
                        for s in range(self.n_slots))
        need_slots = 0 if have_slot else 1
        need_blocks = max(0, need - self.allocator.available_blocks)
        if not need_slots and not need_blocks:
            return
        rows = []
        for slot in range(self.n_slots):
            vrid = self.slot_req[slot]
            if vrid is None or slot in self._chunk_state:
                continue
            blocks, _ = self._slot_blocks[slot]
            rows.append(RowState(
                slot=slot, rid=vrid, level=int(self._slot_level[slot]),
                generated=len(self.results[vrid]["tokens"]),
                blocks=len(blocks),
                preemptible=self.policy.klass(self._reqs[vrid]).preemptible))
        victims = self.policy.pick_victims(req, rows, need_slots,
                                           need_blocks)
        if not victims:
            return
        for v in victims:
            self.evict_row(v.slot)
        self.srv.clear_rows([v.slot for v in victims], self._caches)

    def _snapshot_row(self, slot: int) -> RowSnapshot:
        """A live row's :class:`RowSnapshot`: its written span as f32
        masters (:func:`~repro_torch.models.transformer.paged_row_masters`)
        and, at int KV, its exact scales with their best-effort amax
        preimages (:func:`~repro_torch.models.transformer.amax_for_scale`).
        Every in-flight token must be flushed first, so that the snapshot
        holds the row's true progress."""
        rid = self.slot_req[slot]
        req = self._reqs[rid]
        res = self.results[rid]
        g = len(res["tokens"])              # >= 1: admission emitted one
        p_written = len(req.tokens) + g - 1  # KV positions 0..p_written-1
        pid = self.srv.engine.profile_names.index(res["profile_trace"][-1])
        blocks, reg = self._slot_blocks[slot]
        ns = (reg.n_tokens // self.block_size
              if reg is not None and reg.block_ids is not None else 0)
        row_map = ([int(b) for b in reg.block_ids[:ns]] if ns else []) \
            + list(blocks)
        pool = self._caches["kv"]
        mk, mv = T.paged_row_masters(pool, slot, row_map, p_written)
        ka = va = ksc = vsc = None
        kv_bits = self.srv.scfg.kv_bits
        if kv_bits in (4, 8):
            qmax = 127.0 if kv_bits == 8 else 7.0
            dev = self.srv.device
            ksc = pool.k_scale[:, slot].clone()
            vsc = pool.v_scale[:, slot].clone()
            ka = torch.as_tensor(T.amax_for_scale(
                # repro: allow(host-sync) suspend edge materializes masters
                ksc.cpu().numpy(), qmax, strict=False), device=dev)
            va = torch.as_tensor(T.amax_for_scale(
                # repro: allow(host-sync) suspend edge materializes masters
                vsc.cpu().numpy(), qmax, strict=False), device=dev)
        return RowSnapshot(
            rid=rid, n_done=p_written, last_tok=int(res["tokens"][-1]),
            pid=pid, master_k=mk, master_v=mv, k_amax=ka, v_amax=va,
            k_scale=ksc, v_scale=vsc)

    def evict_row(self, slot: int) -> int:
        """Suspend one live pool row; returns its rid. Flush every
        in-flight token, snapshot the row (:meth:`_snapshot_row`), release
        its blocks (registered prefixes park in the LRU; a mapped
        copy-on-write entry drops this sharer's references) and requeue the
        request at the front of its class. The caller unmaps the slot's
        table (:meth:`~repro_torch.serving.engine.AdaptiveServer.
        clear_rows`), so the frozen row's writes cannot follow the freed
        blocks to their next owner. The row resumes through
        :meth:`_dispatch_resume`."""
        rid = self.slot_req[slot]
        assert rid is not None and slot not in self._chunk_state
        self._flush(0)
        self._suspended[rid] = self._snapshot_row(slot)
        self._vacate(slot)
        self.policy.push_front(rid, self._reqs[rid])
        self.preemptions += 1
        return rid

    def _dispatch_resume(self, rows) -> int:
        """One continuation wave re-admitting suspended rows ``(rid, slot,
        blocks)``. The prefix is everything the row had written (replayed
        from its snapshot masters), the suffix is empty (``prompt_len =
        0``) and ``dest`` is a fully private rebuild: pure data movement,
        so the restored bytes, scales and ``token_idx`` equal the suspended
        row's (kv16 masters round-trip through bf16; int re-quantization
        under the snapshot's scale gives back every int, and the exact
        scales are forced over the wave's recalibration). It bills nothing
        and recomputes no token: the carry is re-pointed at the last
        emitted token, and with ``pos = n_done`` it is the uninterrupted
        row's. All rows share the snapshot-pinned profile."""
        bs = self.block_size
        snaps = [self._suspended.pop(rid) for rid, _, _ in rows]
        pid = snaps[0].pid
        sb = _next_pow2(self.bucket_min)            # empty suffixes
        pp = bs * _next_pow2(max(-(-s.n_done // bs) for s in snaps))
        a = _next_pow2(len(rows))
        prompts = np.zeros((a, sb), np.int32)
        slen = np.zeros((a,), np.int32)             # 0: nothing prefills
        plen_pre = np.zeros((a,), np.int32)
        sidx = np.full((a,), self.n_slots, np.int32)
        dest = np.full((a, self.n_lblk), self.allocator.n_blocks, np.int32)
        for j, ((_, slot, blocks), s) in enumerate(zip(rows, snaps)):
            plen_pre[j] = s.n_done
            sidx[j] = slot
            dest[j, :len(blocks)] = blocks
        self._call_continuation(
            pid, prompts, slen, sidx, dest, dest, plen_pre, pp,
            [(s.n_done, None, s.master_k, s.master_v, s.k_amax, s.v_amax)
             for s in snaps], masters=True)
        dev = self.srv.device
        sl = torch.as_tensor([slot for _, slot, _ in rows], device=dev)
        if snaps[0].k_scale is not None:
            kv = self._caches["kv"]
            kv.k_scale[:, sl] = torch.stack([s.k_scale for s in snaps], 1)
            kv.v_scale[:, sl] = torch.stack([s.v_scale for s in snaps], 1)
        self._tok[sl] = torch.as_tensor([s.last_tok for s in snaps],
                                        dtype=torch.int32, device=dev)
        for rid, slot, blocks in rows:
            req = self._reqs[rid]
            self.slot_req[slot] = rid
            self._slot_crit[slot] = self.policy.bind_critical(req)
            self._slot_level[slot] = self.policy.klass(req).level
            self.remaining[slot] = \
                req.max_new - len(self.results[rid]["tokens"])
            self._slot_blocks[slot] = (blocks, None)
            self._seed_spec(slot, req, history=self.results[rid]["tokens"])
            self.resumes += 1
        return len(rows)

    # ------------------------------------------------------------------ waves
    def _dispatch_cold(self, rows, chunked=()) -> int:
        """One admission wave: full ragged prefill, then a block scatter
        (paged pool) or whole-row writes (contiguous pool). ``rows``:
        ``(rid, slot, blocks)``, ``blocks`` None on the contiguous pool.

        ``chunked`` rows ride the same wave with their first ``chunk``
        tokens only and take a ``_chunk_state`` entry; the rest of the
        prompt follows through :meth:`_advance_chunks`. At int KV the entry
        keeps the chunk's f32 masters and their running amax, which the
        next chunk replays as its prefix."""
        allrows = list(rows) + list(chunked)
        n_cold = len(rows)
        reqs = [self._reqs[rid] for rid, _, _ in allrows]
        lens = [len(r.tokens) if j < n_cold else min(len(r.tokens),
                                                      self.chunk)
                for j, r in enumerate(reqs)]
        bucket = _next_pow2(max(self.bucket_min, max(lens)))
        a = _next_pow2(len(allrows))
        prompts = np.zeros((a, bucket), np.int32)
        plen = np.zeros((a,), np.int32)
        sidx = np.full((a,), self.n_slots, np.int32)
        for j, (rid, slot, _) in enumerate(allrows):
            prompts[j, bucket - lens[j]:] = np.asarray(
                reqs[j].tokens, np.int32)[:lens[j]]
            plen[j] = lens[j]
            sidx[j] = slot
        pid = self._bill(reqs)
        self.prefill_tokens += sum(lens)
        if not self.paged:
            tok0 = self.srv.admit(pid, prompts, plen, sidx, self._tok,
                                  self._pos, self._caches)
            self._post_admission(tok0, self.srv.engine.profile_names[pid],
                                 [(j, rid, slot, None, None)
                                  for j, (rid, slot, _) in enumerate(rows)])
            return len(rows)
        dest = np.full((a, self.n_lblk), self.allocator.n_blocks, np.int32)
        for j, (_, _, blocks) in enumerate(allrows):
            dest[j, :len(blocks)] = blocks
        tok0, raw = self.srv.admit_paged(pid, prompts, plen, sidx, dest,
                                         self._tok, self._pos, self._caches)
        if self.registry is not None and rows:
            self._register_prefixes(rows, reqs[:n_cold], raw, bucket)
        for off, (rid, slot, blocks) in enumerate(chunked):
            j = n_cold + off
            st = {"rid": rid, "blocks": blocks, "done": lens[j],
                  "map": list(blocks),   # logical → physical, shared span too
                  "entry": None, "n_shared": 0,
                  "fresh": True,         # chunk 2 waits for the next round
                  "pid": pid,            # one profile for the whole prompt
                  "mk": None, "mv": None, "ka": None, "va": None}
            if raw is not None:
                c0 = bucket - lens[j]
                self._chunk_masters(st, raw, j, c0)
            self._chunk_state[slot] = st
            self.results[rid] = {"tokens": [], "profile_trace": []}
            if self.record_events:
                self.admission_log.append(rid)
        self._post_admission(tok0, self.srv.engine.profile_names[pid],
                             [(j, rid, slot, blocks, None)
                              for j, (rid, slot, blocks) in enumerate(rows)])
        return len(allrows)

    @staticmethod
    def _chunk_masters(st: dict, raw, j: int, c0: int) -> None:
        """Append wave row ``j``'s raw K/V from padded column ``c0`` on to
        a chunk entry's f32 masters and fold them into its running amax."""
        new_k, new_v = (_f32(x[:, j, c0:]) for x in raw)
        ka = new_k.abs().amax(dim=(1, 3))
        va = new_v.abs().amax(dim=(1, 3))
        if st["mk"] is None:
            st["mk"], st["mv"], st["ka"], st["va"] = new_k, new_v, ka, va
            return
        st["mk"] = torch.cat([st["mk"], new_k], dim=1)
        st["mv"] = torch.cat([st["mv"], new_v], dim=1)
        st["ka"] = torch.maximum(st["ka"], ka)
        st["va"] = torch.maximum(st["va"], va)

    def _register_prefixes(self, rows, reqs, raw, bucket: int) -> None:
        """Offer each new prompt's block-aligned prefix chain for reuse
        (:meth:`~repro_torch.serving.paged.PrefixRegistry.register_chain`).
        At int KV (and kv16 with ``kv16_masters``) the chain's entries
        share one f32 master buffer cut from the wave's raw K/V; at kv16
        the bf16 blocks are the masters."""
        bs = self.block_size
        for j, (rid, slot, blocks) in enumerate(rows):
            n = len(reqs[j].tokens)
            j_max = (n - 1) // bs
            mk = mv = None
            if raw is not None and j_max >= 1:
                c0 = bucket - n
                mk, mv = (_f32(x[:, j, c0:c0 + j_max * bs]) for x in raw)
            self.registry.register_chain(
                self._prefix_keys.get(rid, []), j_max, blocks, mk, mv,
                share_blocks=self.srv.scfg.kv_bits == 16)

    def _call_continuation(self, pid: int, prompts, slen, sidx, dest,
                           bt_rows, plen_pre, pp: int, pre: list,
                           masters: bool = False):
        """Assemble the prefix operands of one continuation wave and
        dispatch it. ``pre``: one ``(n_tok, block_ids, mk, mv, ka, va)``
        per wave row. A bf16 pool without masters gathers the prefix from
        ``block_ids`` (:meth:`~repro_torch.serving.engine.AdaptiveServer.
        admit_shared_pool`); otherwise, and always with ``masters`` (the
        resume wave: its rows' blocks are gone), the f32 masters, cut to
        ``n_tok`` (chain entries share one buffer) and padded to ``pp``,
        are replayed with their raw amax. Returns ``(tok0, raw)``."""
        cfg, srv = self.srv.cfg, self.srv
        a = dest.shape[0]
        if not srv.masters_mode and not masters:
            pre_bids = np.full((a, pp // self.block_size),
                               self.allocator.n_blocks, np.int32)
            for j, (n_tok, bids, *_rest) in enumerate(pre):
                nbl = n_tok // self.block_size
                pre_bids[j, :nbl] = bids[:nbl]
            return srv.admit_shared_pool(pid, prompts, slen, sidx, dest,
                                         bt_rows, pre_bids, plen_pre,
                                         self._tok, self._pos, self._caches)
        dev = srv.device
        kpre = torch.zeros((cfg.n_layers, a, pp, cfg.n_kv, cfg.hd),
                           device=dev)
        vpre = torch.zeros_like(kpre)
        ka = torch.zeros((cfg.n_layers, a, cfg.n_kv), device=dev)
        va = torch.zeros_like(ka)
        for j, (n_tok, _, mk, mv, ka_j, va_j) in enumerate(pre):
            kpre[:, j, :n_tok] = mk[:, :n_tok]
            vpre[:, j, :n_tok] = mv[:, :n_tok]
            if ka_j is not None:
                ka[:, j], va[:, j] = ka_j, va_j
        return srv.admit_shared(pid, prompts, slen, sidx, dest, bt_rows,
                                kpre, vpre, ka, va, plen_pre, self._tok,
                                self._pos, self._caches)

    def _dispatch_shared(self, rows, chunked=()) -> int:
        """One continuation wave of registry hits: suffix-only prefill over
        the entries' prefixes, with ``bt_rows`` mapping the shared blocks
        and the private tail and ``dest`` writing the private tail only.

        ``chunked`` rows are hits whose suffix exceeds the chunk: they ride
        with the suffix's first chunk and then advance one chunk per round
        like a long cold prompt."""
        bs = self.block_size
        allrows = list(rows) + list(chunked)
        n_full = len(rows)
        reqs = [self._reqs[rid] for rid, _, _, _ in allrows]
        sufs = []
        for j, (r, (_, _, e, _)) in enumerate(zip(reqs, allrows)):
            suf = np.asarray(r.tokens, np.int32)[e.n_tokens:]
            sufs.append(suf if j < n_full else suf[:self.chunk])
        sb = _next_pow2(max(self.bucket_min, max(len(x) for x in sufs)))
        pp = bs * _next_pow2(max(-(-e.n_tokens // bs)
                                 for _, _, e, _ in allrows))
        a = _next_pow2(len(allrows))
        nb_oob = self.allocator.n_blocks
        prompts = np.zeros((a, sb), np.int32)
        slen = np.zeros((a,), np.int32)
        plen_pre = np.zeros((a,), np.int32)
        sidx = np.full((a,), self.n_slots, np.int32)
        dest = np.full((a, self.n_lblk), nb_oob, np.int32)
        bt_rows = np.full((a, self.n_lblk), nb_oob, np.int32)
        for j, ((rid, slot, e, blocks), suf) in enumerate(zip(allrows, sufs)):
            prompts[j, sb - len(suf):] = suf                 # left-pad
            slen[j] = len(suf)
            plen_pre[j] = e.n_tokens
            sidx[j] = slot
            ns = e.n_tokens // bs if e.block_ids is not None else 0
            if ns:
                bt_rows[j, :ns] = e.block_ids[:ns]           # mapped, shared
            bt_rows[j, ns:ns + len(blocks)] = blocks         # private tail
            dest[j, ns:ns + len(blocks)] = blocks            # only these are
        ents = [e for _, _, e, _ in allrows]                 # written (CoW)
        pid = self._bill(reqs)
        self.prefill_tokens += int(slen.sum())
        tok0, raw = self._call_continuation(
            pid, prompts, slen, sidx, dest, bt_rows, plen_pre, pp,
            [(e.n_tokens, e.block_ids, e.master_k, e.master_v, e.k_amax,
              e.v_amax) for e in ents])
        for off, (rid, slot, e, blocks) in enumerate(chunked):
            j = n_full + off
            ns = e.n_tokens // bs if e.block_ids is not None else 0
            st = {"rid": rid, "blocks": blocks,
                  "map": ([int(b) for b in e.block_ids[:ns]] if ns else [])
                  + list(blocks),
                  "entry": e, "n_shared": ns,
                  "done": e.n_tokens + len(sufs[j]),
                  "fresh": True, "pid": pid,
                  "mk": None, "mv": None, "ka": None, "va": None}
            if raw is not None:
                # the entry's prefix masters, then this wave's raw suffix
                st["mk"] = _f32(e.master_k[:, :e.n_tokens])
                st["mv"] = _f32(e.master_v[:, :e.n_tokens])
                st["ka"], st["va"] = e.k_amax, e.v_amax
                self._chunk_masters(st, raw, j, sb - len(sufs[j]))
            self._chunk_state[slot] = st
            self.results[rid] = {"tokens": [], "profile_trace": []}
            if self.record_events:
                self.admission_log.append(rid)
        self._post_admission(tok0, self.srv.engine.profile_names[pid],
                             [(j, rid, slot, blocks, e)
                              for j, (rid, slot, e, blocks)
                              in enumerate(rows)])
        return len(allrows)

    def _advance_chunks(self) -> None:
        """Advance every mid-admission row by one chunk, in one
        continuation wave per pinned profile. Rows admitted this round
        (``fresh``) wait for the next: a decode segment runs between two
        chunks of a prompt."""
        if not self._chunk_state:
            return
        waves: dict[int, list] = {}
        for slot in sorted(self._chunk_state):
            st = self._chunk_state[slot]
            if st.pop("fresh", False):
                continue
            t = np.asarray(self._reqs[st["rid"]].tokens, np.int32)
            clen = min(self.chunk, len(t) - st["done"])
            waves.setdefault(st["pid"], []).append(
                (slot, st, t[st["done"]:st["done"] + clen]))
        for pid, rows in waves.items():
            self._dispatch_chunks(pid, rows)

    def _dispatch_chunks(self, pid: int, rows) -> None:
        """One continuation wave over ``(slot, state, chunk_tokens)`` rows
        pinned to profile ``pid``. The prefix is the row's own processed
        span: gathered from its mapped blocks at kv16 (a hit's shared
        blocks included, read only), replayed from the accumulated masters
        at int KV. ``dest`` rewrites every private block, which lands the
        chunk and scrubs what the frozen row wrote between chunks (always
        past the shared span). The wave bills nothing: the request paid
        its one prefill inference at its first chunk. A row whose last
        chunk lands goes live as a cold admission does."""
        bs = self.block_size
        sb = _next_pow2(max(self.bucket_min,
                            max(len(c) for _, _, c in rows)))
        pp = bs * _next_pow2(max(st["done"] // bs for _, st, _ in rows))
        a = _next_pow2(len(rows))
        nb_oob = self.allocator.n_blocks
        prompts = np.zeros((a, sb), np.int32)
        slen = np.zeros((a,), np.int32)
        plen_pre = np.zeros((a,), np.int32)
        sidx = np.full((a,), self.n_slots, np.int32)
        dest = np.full((a, self.n_lblk), nb_oob, np.int32)
        bt_rows = np.full((a, self.n_lblk), nb_oob, np.int32)
        for j, (slot, st, chunk) in enumerate(rows):
            prompts[j, sb - len(chunk):] = chunk             # left-pad
            slen[j] = len(chunk)
            plen_pre[j] = st["done"]
            sidx[j] = slot
            ns = st["n_shared"]
            bt_rows[j, :len(st["map"])] = st["map"]
            dest[j, ns:ns + len(st["blocks"])] = st["blocks"]
        tok0, raw = self._call_continuation(
            pid, prompts, slen, sidx, dest, bt_rows, plen_pre, pp,
            [(st["done"], st["map"], st["mk"], st["mv"], st["ka"], st["va"])
             for _, st, _ in rows])
        self.chunk_waves += 1
        self.prefill_tokens += int(slen.sum())
        entry = {"kind": "admit", "toks": tok0,
                 "name": self.srv.engine.profile_names[pid],
                 "rows": [], "completes": []}
        clear = []
        for j, (slot, st, chunk) in enumerate(rows):
            st["done"] += len(chunk)
            if raw is not None:
                self._chunk_masters(st, raw, j, sb - len(chunk))
            rid = st["rid"]
            req = self._reqs[rid]
            if st["done"] < len(req.tokens):
                continue                       # more chunks to go
            del self._chunk_state[slot]
            entry["rows"].append((j, rid))
            self._register_chunked(rid, st)
            if req.max_new == 1:               # done on arrival
                entry["completes"].append(rid)
                self._release_blocks(st["blocks"])
                if st["entry"] is not None:
                    self.registry.release(st["entry"])
                clear.append(slot)
                continue
            self.slot_req[slot] = rid
            self._slot_crit[slot] = self.policy.bind_critical(req)
            self._slot_level[slot] = self.policy.klass(req).level
            self.remaining[slot] = req.max_new - 1
            self._slot_blocks[slot] = (st["blocks"], st["entry"])
            self._seed_spec(slot, req)
        if clear:
            self.srv.clear_rows(clear, self._caches)
        if entry["rows"]:
            self._inflight.append(entry)

    def _register_chunked(self, rid: int, st: dict) -> None:
        """Offer a finished chunked prompt's prefix chain for reuse, from
        the row's mapped blocks (kv16; a hit's chain includes the shared
        span) or its accumulated masters (one buffer for the chain)."""
        if self.registry is None:
            return
        n = len(self._reqs[rid].tokens)
        j_max = (n - 1) // self.block_size
        mk = mv = None
        if st["mk"] is not None and j_max >= 1:
            mk = st["mk"][:, :j_max * self.block_size]
            mv = st["mv"][:, :j_max * self.block_size]
        self.registry.register_chain(
            self._prefix_keys.get(rid, []), j_max, st["map"], mk, mv,
            share_blocks=self.srv.scfg.kv_bits == 16)

    def _post_admission(self, tok0, pname: str, rows) -> None:
        """Bookkeeping after a wave. ``rows``: ``(wave_row, rid, slot,
        private_blocks, registry_entry)``. ``max_new == 1`` rows complete
        at admission: on the paged pool their blocks and entry go straight
        back and their table is cleared (a contiguous row has nothing to
        clear)."""
        entry = {"kind": "admit", "toks": tok0, "name": pname,
                 "rows": [], "completes": []}
        clear = []
        for j, rid, slot, blocks, reg in rows:
            req = self._reqs[rid]
            self.results[rid] = {"tokens": [], "profile_trace": []}
            entry["rows"].append((j, rid))
            if self.record_events:
                self.admission_log.append(rid)
            if req.max_new == 1:
                entry["completes"].append(rid)
                if self.paged:
                    self._release_blocks(blocks)
                    if reg is not None:
                        self.registry.release(reg)
                    clear.append(slot)
                continue
            self.slot_req[slot] = rid
            self._slot_crit[slot] = self.policy.bind_critical(req)
            self._slot_level[slot] = self.policy.klass(req).level
            self.remaining[slot] = req.max_new - 1
            if self.paged:
                self._slot_blocks[slot] = (blocks, reg)
            self._seed_spec(slot, req)
        if clear:
            self.srv.clear_rows(clear, self._caches)
        self._inflight.append(entry)

    def _seed_spec(self, slot: int, req, history=None) -> None:
        """Reset slot ``slot``'s speculation state for its new occupant: an
        empty history (the admission flush lands the first token; a
        previous occupant's n-grams must never draft for this row) and the
        request's class speculation binding. ``history`` replays a resumed
        row's delivered tokens, so its drafter warm-starts (drafting
        quality only: verification never depends on the proposals)."""
        if not self.spec:
            return
        self._hist[slot] = -1
        if history:
            h = np.asarray(history[-self._hist.shape[1]:], np.int32)
            self._hist[slot, -len(h):] = h
        self._slot_spec[slot] = self.policy.bind_speculative(req)

    def _plan(self, n: int, draft_w: int = 1,
              provisional: bool = False) -> np.ndarray:
        """Profile ids for the next ``n`` steps (windows) over the live
        rows: zeros without a manager; per-class planning when the policy
        has more than one class (a bound class pins the steps its rows are
        live for, as do the rows' own critical flags)."""
        mgr = self.srv.manager
        if mgr is None:
            return np.zeros((n,), np.int32)
        if len(self.policy.classes) > 1:
            return mgr.plan_schedule_classes(
                n, self.remaining, self._slot_level,
                tuple(c.level for c in self.policy.classes
                      if c.accuracy_critical),
                row_critical=self._slot_crit, draft_w=draft_w,
                provisional=provisional)
        return mgr.plan_schedule_ragged(n, self.remaining, self._slot_crit,
                                        draft_w=draft_w,
                                        provisional=provisional)

    def _fault_operand(self) -> np.ndarray:
        """The segment's ``fault_step [B]`` operand: all −1 (never fires)
        unless the :class:`FaultSchedule` targets a live row's current
        attempt, which is poisoned at the segment's first step (first
        verify window). It always rides the segment as data."""
        fault = np.full((self.n_slots,), -1, np.int32)
        if self.faults is not None:
            for slot in range(self.n_slots):
                rid = self.slot_req[slot]
                if rid is None or self.remaining[slot] <= 0:
                    continue
                if self.faults.want_nan(rid, self._attempts.get(rid, 0)):
                    fault[slot] = 0
        return fault

    # --------------------------------------------------------------- decoding
    def run_segment(self) -> None:
        """One decode segment: plan ``quantum`` steps against the live rows,
        dispatch, then retire rows whose budget runs out (on the paged pool
        their blocks go back now; the segment already unmapped their
        tables). A speculative
        scheduler runs :meth:`_run_segment_spec` instead."""
        if self.spec:
            return self._run_segment_spec()
        q = self.quantum
        rem = self.remaining
        sched = self._plan(q)
        if self.record_events:
            for i in range(q):
                live_i = rem > i
                self.events.append((int(sched[i]), int(live_i.sum()),
                                    bool((self._slot_crit & live_i).any())))
        toks, ok, self._tok, self._pos, self._caches = self.srv.segment(
            sched, self._tok, self._pos, self._caches, self.remaining,
            self._fault_operand())
        self.segments_run += 1
        self.segments_chunking += bool(self.paged and self._chunk_state)
        self.decode_steps += q
        entry = {"kind": "seg", "toks": toks, "ok": ok, "sched": sched,
                 "rows": [], "completes": []}
        for slot in range(self.n_slots):
            rid = self.slot_req[slot]
            if rid is None:
                continue
            n = int(min(self.remaining[slot], q))
            entry["rows"].append((slot, rid, n))
            self.remaining[slot] -= n
            if self.remaining[slot] == 0:                # retire → refillable
                self.slot_req[slot] = None
                self._slot_crit[slot] = False
                self._slot_level[slot] = 0
                entry["completes"].append(rid)
                if self.paged:
                    self._retire_blocks(slot)
        self._inflight.append(entry)

    def _run_segment_spec(self) -> None:
        """One speculative segment: ``ceil(quantum / W)`` draft/verify
        windows with ``quota = quantum`` delivered tokens per row.

        The profile plan is provisional (ids bind now, the ledger advances
        at the flush with the tokens each window delivered), and retirement
        and block release move to :meth:`_flush_spec`, since the host
        learns which rows finished only when the delivered counts land.
        """
        self._flush(0)      # land admissions first: fresh rows' history
        w = self.draft_w    # must hold their first token
        n_iter = max(1, -(-self.quantum // w))
        rem = self.remaining
        sched = self._plan(n_iter, draft_w=w, provisional=True)
        if self.record_events:
            # the PLANNED clamped bill per window (what the provisional
            # plan fed select()); the actuals land in `spec_billed`
            for i in range(n_iter):
                live_i = rem > i * w
                self.events.append(
                    (int(sched[i]),
                     int(np.minimum(w, np.maximum(rem - i * w, 0)).sum()),
                     bool((self._slot_crit & live_i).any())))
        quota = np.full((self.n_slots,), self.quantum, np.int32)
        toks, ms, ok, self._tok, self._pos, self._caches = \
            self.srv.segment_spec(sched, self._hist, self._slot_spec,
                                  self._tok, self._pos, self._caches,
                                  self.remaining, quota,
                                  self._fault_operand())
        self.segments_run += 1
        self.segments_chunking += bool(self.paged and self._chunk_state)
        self.windows_run += n_iter
        self._inflight.append({
            "kind": "spec", "toks": toks, "ms": ms, "ok": ok,
            "sched": sched,
            "rows": [(s, self.slot_req[s]) for s in range(self.n_slots)
                     if self.slot_req[s] is not None],
            "completes": []})

    def _flush_spec(self, e: dict, arr: np.ndarray, names) -> None:
        """Land one speculative segment: distribute each window's delivered
        prefix, bill the ledger the tokens actually delivered, slide each
        row's drafter history, then retire rows whose budget hit zero and,
        on the paged pool, hand their blocks back (the segment already
        unmapped their tables). A row whose verify windows went non-finite
        goes to quarantine, as on the greedy path."""
        # repro: allow(host-sync) the flush boundary IS the sync point
        ms = e["ms"].cpu().numpy()                        # [B, n_iter]
        # repro: allow(host-sync) flush-boundary sync, same as ms
        ok = e["ok"].cpu().numpy()
        mgr = self.srv.manager
        sched = e["sched"]
        n_iter = ms.shape[1]
        h = self._hist.shape[1]
        self.spec_row_windows += int((ms > 0).sum())
        for i in range(n_iter):
            n_tok = int(ms[:, i].sum())   # idle rows deliver 0
            if mgr is not None:
                mgr.account(int(sched[i]), n_tok)
            if self.record_events:
                self.spec_billed.append((int(sched[i]), n_tok))
        for slot, rid in e["rows"]:
            res = self.results[rid]
            delivered: list[int] = []
            for i in range(n_iter):
                m = int(ms[slot, i])
                if m:
                    delivered.extend(arr[slot, i, :m].tolist())
                    res["profile_trace"].extend([names[sched[i]]] * m)
            res["tokens"].extend(delivered)
            if delivered:
                cat = np.concatenate([self._hist[slot],
                                      np.asarray(delivered, np.int32)])
                self._hist[slot] = cat[-h:]
            if delivered and not ok[slot] and rid not in self._nf_rows:
                self._nf_rows.append(rid)
            self.remaining[slot] -= len(delivered)
            if self.remaining[slot] == 0 and delivered:
                self.slot_req[slot] = None               # retire → refill
                self._slot_crit[slot] = False
                self._slot_level[slot] = 0
                e["completes"].append(rid)
                if self.paged:
                    self._retire_blocks(slot)

    def _flush(self, keep: int = 0) -> None:
        """Read in-flight token blocks into per-request results, leaving
        the newest ``keep`` entries unread (one segment ahead of the host).
        A request completes once its tokens are read. Fault detection lands
        here: a live row whose finite check failed is routed to quarantine
        (:meth:`_process_quarantine`) instead of completing."""
        if self.faults is not None and len(self._inflight) > keep:
            stall = self.faults.flush_stall(self._flush_idx)
            self._flush_idx += 1
            if stall > 0.0:
                time.sleep(stall)        # injected stall: watchdog fodder
        names = self.srv.engine.profile_names
        drained = len(self._inflight) > keep
        while len(self._inflight) > keep:
            e = self._inflight.pop(0)
            # repro: allow(host-sync) the flush boundary IS the sync point
            arr = e["toks"].cpu().numpy()                # waits for the device
            if e["kind"] == "admit":
                for j, rid in e["rows"]:
                    res = self.results[rid]
                    res["tokens"].append(int(arr[j]))
                    res["profile_trace"].append(e["name"])
                    if self.spec and rid in self.slot_req:
                        # the admission token is the row's current token:
                        # the drafter's history ends with it
                        self._hist[self.slot_req.index(rid), -1] = int(arr[j])
            elif e["kind"] == "spec":
                self._flush_spec(e, arr, names)
            else:
                # repro: allow(host-sync) flush-boundary sync, same as toks
                ok = e["ok"].cpu().numpy()
                for slot, rid, n in e["rows"]:
                    res = self.results[rid]
                    res["tokens"].extend(arr[slot, :n].tolist())
                    res["profile_trace"].extend(
                        names[p] for p in e["sched"][:n])
                    if n > 0 and not ok[slot] and rid not in self._nf_rows:
                        self._nf_rows.append(rid)
            for rid in e["completes"]:
                if rid in self._nf_rows:
                    continue             # quarantine owns this row now
                res = self.results[rid]
                res["status"] = RequestStatus.COMPLETED
                if rid in self._attempts:
                    res["retries"] = self._attempts[rid]
                if rid in self._q_t0:
                    self.recovery_latency.append(
                        self.clock() - self._q_t0.pop(rid))
                    self.recovered += 1
                self._done.append(rid)
                if self.durable is not None:
                    self.durable.on_final(rid)
        if drained and self.durable is not None:
            self.durable.on_flush()      # crash-point / consistency-cut mark

    # ------------------------------------------------------------------ drive
    def step(self) -> bool:
        """One engine round: expire overdue requests, reap cancelled and
        expired rows, quarantine flagged ones and requeue ripe retries at
        the front of their class; age the queue, admit (and advance
        mid-admission chunks, evict for an urgent head, resume suspended
        rows), then run one segment with one kept in flight (none in spec
        mode: delivered counts gate retirement). The step-time EMA counts
        rounds that ran a segment; then the watchdog, and ``paranoid``'s
        :meth:`check`. Returns False once everything is drained; rows still
        chunking in, suspended rows, rows to reap or quarantine and
        backoff retries keep the loop alive."""
        self._round += 1
        t0 = self.clock()
        self._expire()
        self._reap_marked()
        self._process_quarantine()
        if self._quarantine_q:
            ripe = [(r, rid) for r, rid in self._quarantine_q
                    if r <= self._round]
            if ripe:
                self._quarantine_q = [x for x in self._quarantine_q
                                      if x[0] > self._round]
                for _, rid in reversed(ripe):    # keep their relative order
                    self.policy.push_front(rid, self._reqs[rid])
        self.policy.age_tick()           # anti-starvation promotion (if on)
        n_adm = self.admit()
        if n_adm and self.durable is not None:
            self.durable.on_admit(n_adm)
        ran = bool(self.live_rows)
        if ran:
            self.run_segment()
            self._flush(keep=0 if self.spec else 1)
        else:
            self._flush()
        dt = self.clock() - t0
        if ran:
            self._seg_dt = (dt if self._seg_dt is None
                            else 0.5 * dt + 0.5 * self._seg_dt)
        if self.durable is not None:
            self.durable.on_step_end()   # checkpoint cadence
        if self.watchdog is not None:
            self.watchdog.record(f"round {self._round}", dt)
        if self.paranoid:
            self.check()
        return bool(self.live_rows or len(self.policy) or self._inflight
                    or (self.paged and self._chunk_state)
                    or self._to_reap or self._nf_rows or self._quarantine_q)

    def run(self) -> list[dict]:
        """Drain queue + pool; results in submission order (entries already
        claimed through :meth:`poll_completed` come back as None)."""
        while self.step():
            pass
        return [self.results.get(i) for i in range(self._n)]

    def drain(self) -> None:
        """Graceful shutdown: stop admitting, then step until every
        admitted row (live, chunking, in flight, to reap, quarantined) is
        terminal. Queued requests stay queued: a durability layer
        checkpoints them for the next process. The launcher's
        ``--drain-on-sigterm`` drives this."""
        self.draining = True
        if self.durable is not None:
            self.durable.on_drain()
        while (self.live_rows or self._inflight
               or (self.paged and self._chunk_state)
               or self._to_reap or self._nf_rows or self._quarantine_q):
            self.step()
