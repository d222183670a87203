"""Crash-consistent serving: request journal, live-state checkpoints, recovery
(port of ``repro/serving/durability.py``).

Three pieces make :class:`~repro_torch.serving.scheduler.ContinuousScheduler`
crash-consistent; no accepted request is lost by a restart:

**Write-ahead request journal** (:class:`RequestJournal`): an append-only
JSONL file, one crc32-prefixed record per line, byte for byte the
reference's. The edges that change what the process owes its clients are
fsync'd before the scheduler's state moves on: ``submit`` (the whole
request, durable before its rid is observable), ``cancel``, ``final`` (the
whole result, so an undelivered result survives a crash and is delivered
again) and ``deliver`` (rids handed to the caller: replay drops exactly
those). ``admit`` / ``flush`` / ``ckpt`` / ``drain`` are unsynced markers.
A torn tail (the half-written last line of a crash mid-``write``) fails its
checksum and is truncated on reopen; every complete record before it stays.

**Live-state checkpoints** (:meth:`Durability.checkpoint`): a cut at a
flush boundary (``_flush(0)``: no token in flight) that captures every live
and suspended row as the :class:`~repro_torch.serving.paged.RowSnapshot` a
preemption takes (f32 KV masters, and at int KV the exact scales with their
amax preimages), the accumulated masters of rows mid-way through a chunked
prompt, the registry entries that carry masters, the queues with their
aging state, per-request bookkeeping, the energy ledger and every
robustness counter, written through :mod:`repro_torch.checkpoint.manager`
(atomic rename commit, crc32 per leaf). Device tensors move to the host
only at the cut. Physical block ids are not saved: they name storage that
dies with the process; recovery allocates afresh and the logical state
(masters and positions) restores bit-exactly.

**Restart recovery** (:func:`recover`): restore the newest committed
checkpoint (``strict=False``), replay the journal past the checkpoint's
byte position, then resume. Checkpointed rows become suspended snapshots
that re-admit through the scheduler's resume wave
(:meth:`~repro_torch.serving.scheduler.ContinuousScheduler._dispatch_resume`,
the master-replay continuation: pure data movement, so the recovered
streams equal an uninterrupted run's) and decode on through the paged
kernels; chunk rows replay their processed span into fresh blocks and go
on chunking. A row whose leaves fail their checksum is re-prefilled from
its prompt (tokens discarded, re-queued at the front of its class). The
restore path needs the paged pool on a ``supports_prefix_sharing`` stack
(``AdaptiveServer.can_restore``); a cut or a recovery that would need it
elsewhere raises ``ValueError``. Recovery ends with a fresh checkpoint,
so a crash during recovery replays the same prefix again.
"""
from __future__ import annotations

import json
import os
import time
import zlib

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import transformer as T
from .engine import Request, RequestStatus, _next_pow2
from .paged import RowSnapshot, prefix_keys

__all__ = ["RequestJournal", "Durability", "recover"]


class RequestJournal:
    """Append-only, checksummed, replayable request journal.

    Line format: ``"%08x %s\\n" % (crc32(payload), payload)`` with a
    compact, key-sorted JSON payload. Appends are a buffered write and a
    flush; ``sync=True`` adds an ``fsync`` (the write-ahead edges), timed
    into ``synced`` / ``sync_s``. Opening an existing journal truncates a
    torn tail (the first record whose checksum or framing fails, and
    everything after it).
    """

    def __init__(self, path: str):
        self.path = path
        self.synced = 0            # fsync'd appends
        self.sync_s = 0.0          # host seconds in them (write to fsync)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if os.path.exists(path):
            recs = self.scan(path)
            valid_end = recs[-1][0] if recs else 0
            if os.path.getsize(path) != valid_end:
                with open(path, "r+b") as f:     # torn tail from a crash
                    f.truncate(valid_end)
        self._f = open(path, "a", encoding="utf-8")

    def append(self, rec: dict, sync: bool = False) -> None:
        t0 = time.perf_counter()
        payload = json.dumps(rec, separators=(",", ":"), sort_keys=True)
        crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
        self._f.write(f"{crc:08x} {payload}\n")
        self._f.flush()
        if sync:
            os.fsync(self._f.fileno())
            self.synced += 1
            self.sync_s += time.perf_counter() - t0

    def position(self) -> int:
        """Current byte offset (every record so far ends before it)."""
        self._f.flush()
        return self._f.tell()

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def scan(path: str) -> list[tuple[int, dict]]:
        """``(end_offset, record)`` for every valid record, stopping at the
        first torn or corrupt line (the crash-consistent prefix)."""
        out: list[tuple[int, dict]] = []
        if not os.path.exists(path):
            return out
        off = 0
        with open(path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break                        # torn tail
                try:
                    head, payload = line[:-1].split(b" ", 1)
                    if int(head, 16) != zlib.crc32(payload) & 0xFFFFFFFF:
                        break
                    rec = json.loads(payload)
                except ValueError:
                    break
                off += len(line)
                out.append((off, rec))
        return out


class Durability:
    """The scheduler's durability layer: journal hooks and checkpoint
    cadence.

    Construction sets ``sched.durable = self``; the scheduler then calls the
    ``on_*`` hooks at every lifecycle edge. ``journal_dir`` holds the
    journal (``journal.jsonl``) and the checkpoint store
    (``checkpoints/``). ``checkpoint_every=N`` cuts a live-state checkpoint
    every N scheduler rounds (0: only explicit :meth:`checkpoint` calls;
    the journal alone loses no request, a checkpoint bounds the recompute
    of a recovery). ``cuts`` holds ``(bytes, seconds)`` per checkpoint:
    the leaves' bytes and the host time of the capture and the commit.
    """

    def __init__(self, sched, journal_dir: str, checkpoint_every: int = 0,
                 keep: int = 3):
        os.makedirs(journal_dir, exist_ok=True)
        self.sched = sched
        self.journal = RequestJournal(os.path.join(journal_dir,
                                                   "journal.jsonl"))
        self.manager = CheckpointManager(
            os.path.join(journal_dir, "checkpoints"), keep=keep)
        self.checkpoint_every = int(checkpoint_every)
        # checkpoint steps grow across restarts (the newest committed wins)
        self._step = (self.manager.latest_step() or 0)
        self.checkpoints_written = 0
        self.cuts: list[tuple[int, float]] = []
        sched.durable = self

    # ------------------------------------------------- write-ahead (fsync'd)
    def on_submit(self, rid: int, req) -> None:
        self.journal.append(
            {"t": "submit", "rid": rid,
             "tokens": [int(x) for x in np.asarray(req.tokens)],
             "max_new": int(req.max_new),
             "accuracy_critical": bool(req.accuracy_critical),
             "priority": int(req.priority),
             "deadline_ms": req.deadline_ms}, sync=True)

    def on_cancel(self, rid: int) -> None:
        self.journal.append({"t": "cancel", "rid": rid}, sync=True)

    def on_final(self, rid: int) -> None:
        res = self.sched.results.get(rid, {})
        status = res.get("status")
        self.journal.append(
            {"t": "final", "rid": rid,
             "status": getattr(status, "value", ""),
             "reason": res.get("reason"),
             "retries": res.get("retries"),
             "tokens": [int(x) for x in res.get("tokens", [])],
             "profile_trace": list(res.get("profile_trace", []))},
            sync=True)

    def on_deliver(self, rids: list) -> None:
        self.journal.append({"t": "deliver",
                             "rids": [int(r) for r in rids]}, sync=True)

    # ------------------------------------------------ markers (best-effort)
    def on_admit(self, n: int) -> None:
        self.journal.append({"t": "admit", "n": int(n),
                             "round": self.sched._round})

    def on_flush(self) -> None:
        self.journal.append({"t": "flush", "round": self.sched._round})

    def on_drain(self) -> None:
        self.journal.append({"t": "drain", "round": self.sched._round},
                            sync=True)

    def on_step_end(self) -> None:
        if (self.checkpoint_every
                and self.sched._round % self.checkpoint_every == 0):
            self.checkpoint()

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self) -> int:
        """One consistency cut: flush, capture, atomic commit. Returns the
        committed checkpoint step."""
        s = self.sched
        s._flush(0)                   # the cut is a flush boundary
        t0 = time.perf_counter()
        tree, meta = _capture(s)
        meta["journal_pos"] = self.journal.position()
        self._step += 1
        self.manager.save(self._step, tree, metadata=meta)
        self.cuts.append((_nbytes(tree), time.perf_counter() - t0))
        self.checkpoints_written += 1
        self.journal.append({"t": "ckpt", "step": self._step,
                             "pos": meta["journal_pos"]})
        return self._step


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------- capture
def _serialize_results(results: dict) -> dict:
    out = {}
    for rid, res in results.items():
        r = {"tokens": [int(x) for x in res.get("tokens", [])],
             "profile_trace": list(res.get("profile_trace", []))}
        if "status" in res:
            r["status"] = res["status"].value
        if "reason" in res:
            r["reason"] = res["reason"]
        if "retries" in res:
            r["retries"] = int(res["retries"])
        out[str(rid)] = r
    return out


def _need_restore(s) -> None:
    """Row state can be cut and restored only where the resume wave runs."""
    if not s.srv.can_restore:
        raise ValueError(
            "a live-state checkpoint of a row needs the paged KV pool on a "
            "supports_prefix_sharing stack: rows restore through the "
            "continuation-prefill resume wave")


def _row_arrays(snap: RowSnapshot) -> dict:
    arr = {"mk": snap.master_k, "mv": snap.master_v}
    if snap.k_amax is not None:
        arr["ka"], arr["va"] = snap.k_amax, snap.v_amax
        arr["ksc"], arr["vsc"] = snap.k_scale, snap.v_scale
    return arr


def _capture(s) -> tuple[dict, dict]:
    """Scheduler state at a flushed cut as ``(arrays_tree, meta)``: the
    arrays (checksummed npz leaves) are the rows' KV masters and amaxes,
    ``meta`` (JSON) all host bookkeeping."""
    now = s.clock()
    skip = set(s._nf_rows)            # quarantine re-prefills: no KV needed
    reap = {}
    for slot, status in s._to_reap.items():
        rid = (s._chunk_state[slot]["rid"]
               if s.paged and slot in s._chunk_state else s.slot_req[slot])
        if rid is not None:
            reap[str(rid)] = status.value
            skip.add(rid)
    rows_meta, rows_arr = {}, {}
    for slot in range(s.n_slots):
        rid = s.slot_req[slot]
        if rid is None or rid in skip:
            continue
        _need_restore(s)
        snap = s._snapshot_row(slot)
        rows_meta[str(rid)] = {"n_done": snap.n_done,
                               "last_tok": snap.last_tok,
                               "pid": snap.pid, "kind": "live"}
        rows_arr[str(rid)] = _row_arrays(snap)
    for rid, snap in s._suspended.items():
        if rid in skip:
            continue
        rows_meta[str(rid)] = {"n_done": snap.n_done,
                               "last_tok": snap.last_tok,
                               "pid": snap.pid, "kind": "suspended"}
        rows_arr[str(rid)] = _row_arrays(snap)
    chunks_meta, chunks_arr = {}, {}
    if s.paged:
        for slot, st in s._chunk_state.items():
            rid = st["rid"]
            if rid in skip:
                continue
            _need_restore(s)
            if st["mk"] is not None:          # masters mode: accumulated
                mk, mv = st["mk"], st["mv"]
                ka, va = st["ka"], st["va"]
            else:                             # kv16-plain: pool IS master
                mk, mv = T.paged_row_masters(s._caches["kv"], slot,
                                             st["map"], st["done"])
                ka = va = None
            chunks_meta[str(rid)] = {"done": int(st["done"]),
                                     "pid": int(st["pid"])}
            arr = {"mk": mk, "mv": mv}
            if ka is not None:
                arr["ka"], arr["va"] = ka, va
            chunks_arr[str(rid)] = arr
    reg_meta, reg_arr = [], {}
    if s.paged and s.registry is not None:
        for key, e in s.registry._entries.items():
            if e.master_k is None:
                continue          # pool-only entry: dies with the process
            hx = key.hex()
            reg_meta.append({"key": hx, "n_tokens": int(e.n_tokens)})
            reg_arr[hx] = {"mk": e.master_k, "mv": e.master_v}
            if e.k_amax is not None:
                reg_arr[hx]["ka"], reg_arr[hx]["va"] = e.k_amax, e.v_amax
    mgr = s.srv.manager
    meta = {
        "round": s._round, "n": s._n,
        "seg_dt": s._seg_dt, "flush_idx": s._flush_idx,
        "reqs": {str(rid): {
            "tokens": [int(x) for x in np.asarray(r.tokens)],
            "max_new": int(r.max_new),
            "accuracy_critical": bool(r.accuracy_critical),
            "priority": int(r.priority),
            "deadline_ms": r.deadline_ms,
            "deadline_left": (None if s._deadline.get(rid) is None
                              else s._deadline[rid] - now),
        } for rid, r in s._reqs.items()},
        "results": _serialize_results(s.results),
        "done": [int(r) for r in s._done],
        "attempts": {str(r): int(a) for r, a in s._attempts.items()},
        "q_elapsed": {str(r): now - t0 for r, t0 in s._q_t0.items()},
        "quarantine": [[int(rdy), int(rid)] for rdy, rid in s._quarantine_q],
        "nf_rows": [int(r) for r in s._nf_rows],
        "to_reap": reap,
        "queues": s.policy.queue_state(),
        "rows": rows_meta, "chunks": chunks_meta, "registry": reg_meta,
        "manager": (None if mgr is None
                    else {"spent_j": float(mgr.spent_j),
                          "saver": bool(mgr._saver)}),
        "counters": {k: int(getattr(s, k)) for k in (
            "preemptions", "resumes", "cancelled", "expired", "shed_count",
            "failed", "recovered", "faults_detected",
            "alloc_injected_rounds")},
        "recovery_latency": [float(x) for x in s.recovery_latency],
        "events": [[int(p), int(n), bool(c)] for p, n, c in s.events],
        "admission_log": [int(r) for r in s.admission_log],
        # audit breadcrumbs only: physical ids are process-local
        "allocator": (None if not s.paged else
                      {"free": s.allocator.free_blocks,
                       "lru": s.allocator.lru_blocks,
                       "used": s.allocator.used_blocks}),
    }
    tree = {}
    if rows_arr:
        tree["rows"] = rows_arr
    if chunks_arr:
        tree["chunks"] = chunks_arr
    if reg_arr:
        tree["registry"] = reg_arr
    return tree, meta


# ----------------------------------------------------------------- recovery
def _corrupt_groups(corrupt_keys) -> set:
    """``("rows", "7")``-style prefixes of corrupt leaves: the fallback
    unit is a whole row or entry (one bad leaf poisons its group)."""
    return {tuple(k.split("/")[:2]) for k in corrupt_keys}


def _refill(s, rid: int, kind: str, info: dict) -> None:
    """Corruption fallback: re-prefill ``rid`` from its prompt (as a
    quarantine retry: tokens discarded, re-queued at the front of its
    class, attempts and terminal-status semantics kept)."""
    s.results[rid] = {"tokens": [], "profile_trace": []}
    s._q_t0.setdefault(rid, s.clock())
    if kind != "suspended":     # suspended rids already sit in the queue
        s.policy.push_front(rid, s._reqs[rid])
    info["refilled"].append(rid)


def _apply_checkpoint(s, tree, meta, pending: dict, info: dict) -> None:
    md = meta["metadata"]
    if md["rows"] or md["chunks"]:
        _need_restore(s)
    bad = _corrupt_groups(meta.get("corrupt_keys", []))
    dev = s.srv.device

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    def opt(arr, k):
        return on_dev(arr[k]) if k in arr else None

    now = s.clock()
    s._round = int(md["round"])
    s._n = int(md["n"])
    s._seg_dt = md["seg_dt"]
    s._flush_idx = int(md["flush_idx"])
    for rid_s, r in md["reqs"].items():
        rid = int(rid_s)
        s._reqs[rid] = Request(
            tokens=np.asarray(r["tokens"], np.int32),
            max_new=r["max_new"],
            accuracy_critical=r["accuracy_critical"],
            priority=r["priority"], deadline_ms=r["deadline_ms"])
        if r["deadline_left"] is not None:
            # the SLO clock does not tick while the process is down: the
            # budget left at the cut re-arms from recovery time
            s._deadline[rid] = now + r["deadline_left"]
        if s.paged and s.registry is not None:
            s._prefix_keys[rid] = prefix_keys(
                np.asarray(r["tokens"], np.int32), s.block_size)
    for rid_s, res in md["results"].items():
        r = {"tokens": list(res["tokens"]),
             "profile_trace": list(res["profile_trace"])}
        if "status" in res:
            r["status"] = RequestStatus(res["status"])
        if "reason" in res:
            r["reason"] = res["reason"]
        if "retries" in res:
            r["retries"] = res["retries"]
        s.results[int(rid_s)] = r
    s._done = [int(r) for r in md["done"]]
    s._attempts = {int(r): a for r, a in md["attempts"].items()}
    s._q_t0 = {int(r): now - el for r, el in md["q_elapsed"].items()}
    s._quarantine_q = [(rdy, rid) for rdy, rid in md["quarantine"]]
    s._nf_rows = [int(r) for r in md["nf_rows"]]
    s.policy.restore_queue_state(md["queues"])
    mgr = s.srv.manager
    if mgr is not None and md["manager"] is not None:
        mgr.spent_j = md["manager"]["spent_j"]
        mgr._saver = md["manager"]["saver"]
    for k, v in md["counters"].items():
        setattr(s, k, v)
    s.recovery_latency = list(md["recovery_latency"])
    s.events = [(p, n, c) for p, n, c in md["events"]]
    s.admission_log = list(md["admission_log"])
    # cancel/expire marks pending at the cut: their tokens are flushed
    # (the cut is a flush boundary), so finalize now; no blocks exist yet
    for rid_s, status in md["to_reap"].items():
        s._finalize(int(rid_s), RequestStatus(status))
    int_kv = s.srv.scfg.kv_bits in (4, 8)
    for rid_s, rm in md["rows"].items():
        rid = int(rid_s)
        arr = tree.get("rows", {}).get(rid_s, {})
        if (("rows", rid_s) in bad or "mk" not in arr or "mv" not in arr
                or (int_kv and ("ka" not in arr or "ksc" not in arr))):
            _refill(s, rid, rm["kind"], info)
            continue
        s._suspended[rid] = RowSnapshot(
            rid=rid, n_done=int(rm["n_done"]),
            last_tok=int(rm["last_tok"]), pid=int(rm["pid"]),
            master_k=on_dev(arr["mk"]), master_v=on_dev(arr["mv"]),
            k_amax=opt(arr, "ka"), v_amax=opt(arr, "va"),
            k_scale=opt(arr, "ksc"), v_scale=opt(arr, "vsc"))
        if rm["kind"] == "live":
            # a live row was not queued at the cut (a suspended one was,
            # by evict_row): it resumes through the normal admission path
            s.policy.push_front(rid, s._reqs[rid])
        info["resumed_rows"] += 1
    for rid_s, cm in md["chunks"].items():
        rid = int(rid_s)
        arr = tree.get("chunks", {}).get(rid_s, {})
        if (("chunks", rid_s) in bad or "mk" not in arr
                or (int_kv and "ka" not in arr)):
            _refill(s, rid, "chunk", info)
            continue
        pending[rid] = {"done": int(cm["done"]), "pid": int(cm["pid"]),
                        "mk": on_dev(arr["mk"]), "mv": on_dev(arr["mv"]),
                        "ka": opt(arr, "ka"), "va": opt(arr, "va")}
    if s.paged and s.registry is not None:
        for ent in md["registry"]:
            hx = ent["key"]
            if ("registry", hx) in bad:
                continue              # a registry entry is only a cache
            arr = tree.get("registry", {}).get(hx, {})
            if "mk" not in arr or "mv" not in arr:
                continue
            # masters-only re-registration: the entry's pool blocks died
            # with the process; continuations replay from the masters
            s.registry.register(
                bytes.fromhex(hx), ent["n_tokens"], None,
                on_dev(arr["mk"]), on_dev(arr["mv"]),
                opt(arr, "ka"), opt(arr, "va"))


def _drop_everywhere(s, rid: int, pending: dict) -> None:
    """Remove a rid from every pre-admission structure (a replayed
    terminal record supersedes its checkpointed live or queued state)."""
    s.policy.remove(rid)
    s._suspended.pop(rid, None)
    pending.pop(rid, None)
    if rid in s._nf_rows:
        s._nf_rows.remove(rid)
    s._quarantine_q = [(rdy, r) for rdy, r in s._quarantine_q if r != rid]


def _replay_journal(s, path: str, pos: int, pending: dict,
                    info: dict) -> None:
    delivered: set = set()
    for off, rec in RequestJournal.scan(path):
        if off <= pos:
            continue
        t = rec["t"]
        if t == "submit":
            req = Request(tokens=np.asarray(rec["tokens"], np.int32),
                          max_new=rec["max_new"],
                          accuracy_critical=rec["accuracy_critical"],
                          priority=rec["priority"],
                          deadline_ms=rec["deadline_ms"])
            # admission control ran before the crash and its outcome is in
            # the journal (a shed request has a `final` record): the
            # replayed submit must not decide it again
            shed, s.shed = s.shed, None
            try:
                got = s.submit(req)
            finally:
                s.shed = shed
            if got != rec["rid"]:
                raise RuntimeError(f"journal replay rid drift: submit "
                                   f"{rec['rid']} replayed as {got}")
            info["replayed"] += 1
        elif t == "cancel":
            rid = rec["rid"]
            if not s.cancel(rid) and rid in pending:
                pending.pop(rid)
                s._finalize(rid, RequestStatus.CANCELLED)
        elif t == "final":
            rid = rec["rid"]
            res = {"tokens": list(rec["tokens"]),
                   "profile_trace": list(rec["profile_trace"])}
            status = RequestStatus(rec["status"])
            res["status"] = status
            if rec.get("reason") is not None:
                res["reason"] = rec["reason"]
            if rec.get("retries") is not None:
                res["retries"] = rec["retries"]
            already = ("status" in s.results.get(rid, {})
                       and rid in s._done)
            s.results[rid] = res        # the journal's result is final
            if not already:
                _drop_everywhere(s, rid, pending)
                s._done.append(rid)
                if status is RequestStatus.CANCELLED:
                    s.cancelled += 1
                elif status is RequestStatus.EXPIRED:
                    s.expired += 1
                elif status is RequestStatus.SHED:
                    s.shed_count += 1
                elif status is RequestStatus.FAILED:
                    s.failed += 1
        elif t == "deliver":
            delivered.update(rec["rids"])
    for rid in delivered:               # exactly once: the caller owns these
        if rid in s._done:
            s._done.remove(rid)
        s.results.pop(rid, None)
        s._reqs.pop(rid, None)
        s._deadline.pop(rid, None)
        s._attempts.pop(rid, None)
        s._q_t0.pop(rid, None)
        if s.paged and s.registry is not None:
            s._prefix_keys.pop(rid, None)


def _restore_chunks(s, pending: dict, info: dict) -> None:
    """Rebuild the surviving mid-admission chunk rows: one master-replay
    continuation wave per pinned profile writes each row's processed span
    (positions ``0..done-1``) into freshly allocated blocks (an empty
    suffix: the resume wave's data movement, no token produced, nothing
    billed); chunking goes on from ``done`` at the next round."""
    if not pending:
        return
    bs = s.block_size
    by_pid: dict[int, list] = {}
    for rid, st in pending.items():
        by_pid.setdefault(st["pid"], []).append((rid, st))
    for pid, items in by_pid.items():
        free = [sl for sl in range(s.n_slots)
                if s.slot_req[sl] is None and sl not in s._chunk_state]
        rows = []
        for rid, st in items:
            req = s._reqs[rid]
            blocks = s.allocator.alloc(
                s._blocks_needed(len(req.tokens), req.max_new))
            if blocks is None:
                raise RuntimeError("recovery pool smaller than the "
                                   "checkpointed one")
            rows.append((rid, free.pop(0), blocks, st))
        a = _next_pow2(len(rows))
        sb = _next_pow2(s.bucket_min)
        pp = bs * _next_pow2(max(-(-st["done"] // bs)
                                 for _, _, _, st in rows))
        prompts = np.zeros((a, sb), np.int32)
        slen = np.zeros((a,), np.int32)
        plen_pre = np.zeros((a,), np.int32)
        sidx = np.full((a,), s.n_slots, np.int32)
        dest = np.full((a, s.n_lblk), s.allocator.n_blocks, np.int32)
        for j, (rid, slot, blocks, st) in enumerate(rows):
            plen_pre[j] = st["done"]
            sidx[j] = slot
            dest[j, :len(blocks)] = blocks
        s._call_continuation(
            pid, prompts, slen, sidx, dest, dest, plen_pre, pp,
            [(st["done"], None, st["mk"], st["mv"], st["ka"], st["va"])
             for _, _, _, st in rows], masters=True)
        for rid, slot, blocks, st in rows:
            # kv16 without masters: the rewrite made the pool its own
            # master again, so later chunks gather from it; keeping the
            # restore-time masters would freeze them at `done`. Masters
            # mode keeps accumulating as usual.
            keep_m = s.srv.masters_mode
            s._chunk_state[slot] = {
                "rid": rid, "blocks": blocks, "done": st["done"],
                "map": list(blocks), "entry": None, "n_shared": 0,
                "pid": pid, "mk": st["mk"] if keep_m else None,
                "mv": st["mv"] if keep_m else None,
                "ka": st["ka"] if keep_m else None,
                "va": st["va"] if keep_m else None}
            info["chunk_rows"] += 1


def recover(server, journal_dir: str, checkpoint_every: int = 0,
            keep: int = 3, **sched_kwargs):
    """Build a scheduler on ``server`` and restore it from ``journal_dir``.

    1. **restore**: the newest committed checkpoint, ``strict=False``
       (corrupt leaves drop their row to a re-prefill; healthy rows keep
       their exact snapshots), masters placed on ``server.device``;
    2. **replay**: journal records past the checkpoint's byte position
       (submits re-enter the queue with the same rids, cancels re-apply,
       ``final`` records override checkpointed live or queued state,
       ``deliver`` records drop results the caller already owns);
    3. **resume**: chunk rows rewrite their processed span through the
       master-replay wave now; live rows wait as suspended snapshots and
       re-admit through the resume wave at the next step;
    4. **re-checkpoint**: a fresh cut, so a crash during recovery replays
       the same prefix again.

    Returns the scheduler, with ``sched.recover_info``: ``resumed_rows``,
    ``chunk_rows``, ``replayed`` journal submits, ``refilled`` rids,
    ``corrupt_keys``, ``journal_pos`` and ``recovery_s`` (host seconds).
    A fresh :class:`Durability` on the same directory is attached, so
    serving goes on journaled.
    """
    from .scheduler import ContinuousScheduler
    t_start = time.monotonic()
    sched = ContinuousScheduler(server, **sched_kwargs)
    jpath = os.path.join(journal_dir, "journal.jsonl")
    cm = CheckpointManager(os.path.join(journal_dir, "checkpoints"),
                           keep=keep)
    info = {"resumed_rows": 0, "chunk_rows": 0, "replayed": 0,
            "refilled": [], "corrupt_keys": [], "journal_pos": 0}
    pending: dict = {}
    if cm.latest_step() is not None:
        tree, meta = cm.restore(strict=False)
        info["corrupt_keys"] = list(meta.get("corrupt_keys", []))
        info["journal_pos"] = int(meta["metadata"].get("journal_pos", 0))
        _apply_checkpoint(sched, tree, meta, pending, info)
    _replay_journal(sched, jpath, info["journal_pos"], pending, info)
    _restore_chunks(sched, pending, info)
    dur = Durability(sched, journal_dir, checkpoint_every=checkpoint_every,
                     keep=keep)
    dur.checkpoint()
    info["recovery_s"] = time.monotonic() - t_start
    sched.recover_info = info
    return sched
