"""Continuous batching on the paged or the contiguous KV pool (port of
``repro/serving/scheduler.py``: FIFO policy, cold admission waves).

The scheduler owns a fixed ``[max_batch]`` slot pool whose decode state —
last token, position, the paged KV pool — lives on the device and is updated
in place by the server's primitives (the reference donates the same state
through its jit boundaries). A request holds one row from admission to
retirement; free rows idle with ``remaining == 0``.

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
:meth:`~repro_torch.core.manager.ProfileManager.plan_schedule_ragged` over
the rows actually live at each step, so the energy ledger bills exactly the
live rows; every billing event lands in :attr:`ContinuousScheduler.events`.

**Speculation** (``ServingConfig.speculate``): each segment runs
``ceil(quantum / W)`` draft/verify windows (``W = draft_k + 1``) with a
quota of ``quantum`` delivered tokens per row. A window's delivered count
is data the host needs for retirement, history and billing, so spec mode
is synchronous (``_flush(keep=0)``): the profile plan is provisional, and
the ledger bills the tokens each window actually delivered at the flush
(:attr:`ContinuousScheduler.spec_billed`, invariant 11 of the reference).
Speculation runs on the paged pool only (not ported on the contiguous one).

Not ported yet (later slices): the prefix registry and shared admission,
chunked prefill, priorities and preemption, deadlines, cancellation,
shedding, fault injection and quarantine, durability, and speculation's
composition with preemption/resume, cancellation, quarantine and
copy-on-write prefixes, which comes with them. A row whose logits go
non-finite raises at the flush (the reference quarantines it).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from .engine import AdaptiveServer, Request, RequestStatus, _next_pow2
from .paged import BlockAllocator
from .policy import SchedulingPolicy, make_policy

__all__ = ["ContinuousScheduler"]


class ContinuousScheduler:
    """Continuous batching on an :class:`AdaptiveServer`'s slot pool.

    ``quantum`` = decode steps per segment; ``prefill_bucket`` = minimum
    power-of-two prompt padding; ``record_events`` keeps the billing events
    and admission order (for the ledger-oracle tests — a long-lived server
    turns it off); ``policy`` defaults to the FIFO of
    :func:`~repro_torch.serving.policy.make_policy`.
    """

    def __init__(self, server: AdaptiveServer, quantum: int = 8,
                 prefill_bucket: int = 8, record_events: bool = True,
                 policy: Optional[SchedulingPolicy] = None):
        self.srv = server
        self.quantum = int(quantum)
        self.bucket_min = int(prefill_bucket)
        self.record_events = record_events
        cfg, scfg = server.cfg, server.scfg
        nslots = self.n_slots = scfg.max_batch
        self.policy = policy if policy is not None else make_policy(scfg)
        if self.policy.preemptive or len(self.policy.classes) > 1:
            raise NotImplementedError("priority classes and preemption are "
                                      "not ported")
        dev = server.device
        self.paged = bool(scfg.paged_kv)
        if self.paged:
            self.block_size = server.block_size
            self.n_lblk = server.n_lblk
            nb = (scfg.pool_blocks if scfg.pool_blocks is not None
                  else nslots * self.n_lblk)
            self._caches = T.init_paged_caches(
                cfg, nslots, scfg.slots, kv_bits=scfg.kv_bits,
                block_size=self.block_size, pool_blocks=nb, device=dev)
            self.allocator = BlockAllocator(nb, self.block_size)
            self._slot_blocks: list = [None] * nslots
            self.peak_used_blocks = 0
        else:
            if scfg.speculate:
                raise NotImplementedError("speculation on the contiguous "
                                          "pool is not ported")
            self._caches = T.init_caches(cfg, nslots, scfg.slots,
                                         kv_bits=scfg.kv_bits, device=dev)
            self.allocator = None
        self._tok = torch.zeros((nslots,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((nslots,), dtype=torch.int32, device=dev)
        self.remaining = np.zeros((nslots,), np.int64)   # tokens left to emit
        self.slot_req: list[Optional[int]] = [None] * nslots
        self._slot_crit = np.zeros((nslots,), bool)
        self._reqs: dict[int, Request] = {}
        self.results: dict[int, dict] = {}
        self._n = 0
        self.admission_log: list[int] = []               # rids, admission order
        self.events: list[tuple[int, int, bool]] = []    # (pid, n_rows, crit)
        self._done: list[int] = []                       # completions, in order
        self._inflight: list[dict] = []                  # dispatched, unread
        self.segments_run = 0
        self.decode_steps = 0
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

    # ------------------------------------------------------------- paged util
    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks a request touches over its life: prompt positions plus
        every decode write, capped at the row's logical table."""
        return min(self.n_lblk,
                   -(-(prompt_len + max_new) // self.block_size))

    def paged_stats(self) -> dict:
        """Block-pool occupancy (live / LRU-cached / free partition); the
        contiguous pool reports ``{"paged": False, "kv_bytes": ...}``."""
        if not self.paged:
            return {"paged": False, "kv_bytes": T.cache_bytes(self._caches)}
        live = self.allocator.used_blocks
        return {
            "paged": True,
            "block_size": self.block_size,
            "pool_blocks": self.allocator.n_blocks,
            "used_blocks": live,
            "live_blocks": live,
            "lru_cached_blocks": self.allocator.lru_blocks,
            "reclaimed_blocks": self.allocator.reclaimed_blocks,
            "peak_used_blocks": self.peak_used_blocks,
            "free_blocks": self.allocator.free_blocks,
            "kv_bytes": T.cache_bytes(self._caches),
        }

    # ------------------------------------------------------------------ queue
    def submit(self, request: Request) -> int:
        """Enqueue a request; returns its id. A request that could never fit
        the pool raises ``ValueError`` here."""
        if request.deadline_ms is not None:
            raise NotImplementedError("deadlines are not ported")
        if self.paged and request.max_new > 0:
            need = self._blocks_needed(len(request.tokens), request.max_new)
            if need > self.allocator.n_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool has only "
                    f"{self.allocator.n_blocks} "
                    f"(block_size={self.block_size})")
        rid = self._n
        self._n += 1
        self._reqs[rid] = request
        if request.max_new <= 0:        # nothing to generate: done on arrival
            self.results[rid] = {"tokens": [], "profile_trace": [],
                                 "status": RequestStatus.COMPLETED}
            self._done.append(rid)
            return rid
        self.policy.enqueue(rid, request)
        return rid

    @property
    def live_rows(self) -> int:
        """Pool rows still generating (``remaining > 0``)."""
        return int((self.remaining > 0).sum())

    @property
    def pending(self) -> int:
        """Requests queued but not yet admitted."""
        return len(self.policy)

    def poll_completed(self) -> list[tuple[int, dict]]:
        """``(rid, result)`` pairs finished since the last poll; ownership
        of each result passes to the caller."""
        done, self._done = self._done, []
        out = []
        for rid in done:
            out.append((rid, self.results.pop(rid)))
            self._reqs.pop(rid, None)
        return out

    # -------------------------------------------------------------- admission
    def admit(self) -> int:
        """Fill free slots from the queue in policy order, gated on blocks
        as well as slots on the paged pool; one cold admission wave per
        round. Returns the number of requests admitted."""
        free = [s for s in range(self.n_slots) if self.slot_req[s] is None]
        if not self.paged:
            rows = []
            while free and len(self.policy):
                rows.append((self.policy.pop_head(), free.pop(0), None))
            return self._dispatch_cold(rows) if rows else 0
        cold = []
        while free and len(self.policy):
            rid = self.policy.head()
            req = self._reqs[rid]
            blocks = self.allocator.alloc(
                self._blocks_needed(len(req.tokens), req.max_new))
            if blocks is None:           # backpressure: the head waits
                break
            self.policy.pop_head()
            cold.append((rid, free.pop(0), blocks))
        n = self._dispatch_cold(cold) if cold else 0
        if n:
            self.peak_used_blocks = max(self.peak_used_blocks,
                                        self.allocator.used_blocks)
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

    def _dispatch_cold(self, rows) -> int:
        """One admission wave: full ragged prefill, then a block scatter
        (paged pool) or whole-row writes (contiguous pool). ``rows``:
        ``(rid, slot, blocks)``, ``blocks`` None on the contiguous pool."""
        reqs = [self._reqs[rid] for rid, _, _ in rows]
        lens = [len(r.tokens) for r in reqs]
        bucket = _next_pow2(max(self.bucket_min, max(lens)))
        a = _next_pow2(len(rows))
        prompts = np.zeros((a, bucket), np.int32)
        plen = np.zeros((a,), np.int32)
        sidx = np.full((a,), self.n_slots, np.int32)
        for j, (rid, slot, _) in enumerate(rows):
            prompts[j, bucket - lens[j]:] = np.asarray(reqs[j].tokens,
                                                       np.int32)
            plen[j] = lens[j]
            sidx[j] = slot
        pid = self._bill(reqs)
        if self.paged:
            dest = np.full((a, self.n_lblk), self.allocator.n_blocks,
                           np.int32)
            for j, (_, _, blocks) in enumerate(rows):
                dest[j, :len(blocks)] = blocks
            tok0 = self.srv.admit_paged(pid, prompts, plen, sidx, dest,
                                        self._tok, self._pos, self._caches)
        else:
            tok0 = self.srv.admit(pid, prompts, plen, sidx, self._tok,
                                  self._pos, self._caches)
        self._post_admission(tok0, self.srv.engine.profile_names[pid],
                             [(j, rid, slot, blocks)
                              for j, (rid, slot, blocks) in enumerate(rows)])
        return len(rows)

    def _post_admission(self, tok0, pname: str, rows) -> None:
        """Bookkeeping after a wave. ``max_new == 1`` rows complete at
        admission: on the paged pool their blocks go straight back and
        their table is cleared (a contiguous row has nothing to clear)."""
        entry = {"kind": "admit", "toks": tok0, "name": pname,
                 "rows": [], "completes": []}
        clear = []
        for j, rid, slot, blocks in rows:
            req = self._reqs[rid]
            self.results[rid] = {"tokens": [], "profile_trace": []}
            entry["rows"].append((j, rid))
            if self.record_events:
                self.admission_log.append(rid)
            if req.max_new == 1:
                entry["completes"].append(rid)
                if self.paged:
                    self.allocator.release(blocks)
                    clear.append(slot)
                continue
            self.slot_req[slot] = rid
            self._slot_crit[slot] = self.policy.bind_critical(req)
            self.remaining[slot] = req.max_new - 1
            if self.paged:
                self._slot_blocks[slot] = blocks
            self._seed_spec(slot, req)
        if clear:
            self.srv.clear_rows(clear, self._caches)
        self._inflight.append(entry)

    def _seed_spec(self, slot: int, req) -> None:
        """Reset slot ``slot``'s speculation state for its new occupant: an
        empty history (the admission flush lands the first token; a
        previous occupant's n-grams must never draft for this row) and the
        request's class speculation binding."""
        if not self.spec:
            return
        self._hist[slot] = -1
        self._slot_spec[slot] = self.policy.bind_speculative(req)

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
        mgr = self.srv.manager
        rem = self.remaining
        if mgr is None:
            sched = np.zeros((q,), np.int32)
        else:
            sched = mgr.plan_schedule_ragged(q, rem, self._slot_crit)
        if self.record_events:
            for i in range(q):
                live_i = rem > i
                self.events.append((int(sched[i]), int(live_i.sum()),
                                    bool((self._slot_crit & live_i).any())))
        toks, ok, self._tok, self._pos, self._caches = self.srv.segment(
            sched, self._tok, self._pos, self._caches, self.remaining)
        self.segments_run += 1
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
                entry["completes"].append(rid)
                if self.paged:
                    self.allocator.release(self._slot_blocks[slot])
                    self._slot_blocks[slot] = None
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
        mgr = self.srv.manager
        rem = self.remaining
        if mgr is None:
            sched = np.zeros((n_iter,), np.int32)
        else:
            sched = mgr.plan_schedule_ragged(n_iter, rem, self._slot_crit,
                                             draft_w=w, provisional=True)
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
                                  self.remaining, quota)
        self.segments_run += 1
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
        row's drafter history, then retire rows whose budget hit zero and
        hand their blocks back (the segment already unmapped their
        tables)."""
        ms = e["ms"].cpu().numpy()                        # [B, n_iter]
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
        bad = [rid for slot, rid in e["rows"]
               if ms[slot].any() and not ok[slot]]
        if bad:
            raise RuntimeError(f"non-finite logits in requests {bad} "
                               f"(quarantine is not ported)")
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
            self.remaining[slot] -= len(delivered)
            if self.remaining[slot] == 0 and delivered:
                self.slot_req[slot] = None               # retire → refill
                self._slot_crit[slot] = False
                e["completes"].append(rid)
                self.allocator.release(self._slot_blocks[slot])
                self._slot_blocks[slot] = None

    def _flush(self, keep: int = 0) -> None:
        """Read in-flight token blocks into per-request results, leaving
        the newest ``keep`` entries unread (one segment ahead of the host).
        A request completes once its tokens are read."""
        names = self.srv.engine.profile_names
        while len(self._inflight) > keep:
            e = self._inflight.pop(0)
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
                ok = e["ok"].cpu().numpy()
                bad = [rid for slot, rid, n in e["rows"]
                       if n > 0 and not ok[slot]]
                if bad:
                    raise RuntimeError(
                        f"non-finite logits in requests {bad} (quarantine "
                        f"is not ported)")
                for slot, rid, n in e["rows"]:
                    res = self.results[rid]
                    res["tokens"].extend(arr[slot, :n].tolist())
                    res["profile_trace"].extend(
                        names[p] for p in e["sched"][:n])
            for rid in e["completes"]:
                self.results[rid]["status"] = RequestStatus.COMPLETED
                self._done.append(rid)

    # ------------------------------------------------------------------ drive
    def step(self) -> bool:
        """One engine round: admit, then run one segment with one kept in
        flight (none in spec mode: delivered counts gate retirement).
        Returns False once everything is drained."""
        self.admit()
        if self.live_rows:
            self.run_segment()
            self._flush(keep=0 if self.spec else 1)
        else:
            self._flush()
        return bool(self.live_rows or len(self.policy) or self._inflight)

    def run(self) -> list[dict]:
        """Drain queue + pool; results in submission order (entries already
        claimed through :meth:`poll_completed` come back as None)."""
        while self.step():
            pass
        return [self.results.get(i) for i in range(self._n)]
