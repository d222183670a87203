"""Host-side paged-KV bookkeeping: block allocator + shared-prefix registry.

Copy of ``repro/serving/paged.py`` (numpy-only); the one array reduction
(``register_chain``'s raw amax) runs on torch tensors here. The port's
serving slice uses :class:`BlockAllocator`; the registry waits for the
shared-prefix slice.

The device side of the paged KV cache (:class:`repro_torch.models.attention.
PagedKVCache`) is deliberately dumb — a pool of blocks and per-row block
tables that are plain int32 *data*. Everything that decides **which** physical
block backs which logical block lives here, on the host, between decode
segments:

* :class:`BlockAllocator` — a free list with reference counts *and a
  retired-block LRU*. A block with ``refcount > 1`` is shared (several live
  rows map it); at refcount 0 it either returns to the plain free list or —
  when a registered prefix still wants its content — parks in the **LRU
  cached list**: still holding its bytes, immediately reclaimable under
  allocation pressure (oldest first, with an ``on_reclaim`` callback so the
  registry drops entries whose backing just vanished), and *resurrectable*
  by a later admission that hash-matches the retired prompt
  (:meth:`activate`). Retired prefixes are therefore never hard pool
  pressure: ``alloc`` sees ``free + lru`` capacity. The allocator never
  touches the device; exhaustion surfaces as ``alloc()`` returning ``None``,
  which the scheduler turns into queue backpressure (or a preemption
  decision) instead of corrupting a live row. Releasing an already-free
  block raises ``RuntimeError`` — loudly, not as a strippable ``assert`` —
  because a silent double-release would corrupt the refcounts of whatever
  request owns the block next.
* :class:`PrefixRegistry` — content-addressed prefix reuse. Prompts are
  hashed at *block granularity* (the hash of a prefix covers every token in
  it, so two prompts map the same entry iff their first ``k·block_size``
  tokens are identical), and a hit lets admission skip re-running the
  backbone over the prefix and (at kv16) map the already-resident blocks
  instead of re-storing them — **even after the owning row retired**, as
  long as real allocation pressure has not reclaimed the LRU-cached blocks.
  Entries snapshot the full-precision prefix K/V masters + raw max-|K|/|V|
  so a shared admission can replay *exactly* the attention reads and int-KV
  scale calibration a cold prefill would have done — what keeps shared
  admission token-identical to cold.

This mirrors the paper's decoupling of logical computation from physical
resource binding (the MDC/NN2CAM datapath-merging discipline): the traced
program never changes; only the binding tables do.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional

import numpy as np

__all__ = ["BlockAllocator", "PrefixRegistry", "PrefixEntry", "RowSnapshot",
           "prefix_keys"]


@dataclasses.dataclass
class RowSnapshot:
    """Everything a preempted row needs to resume **bit-exactly**.

    Captured by :meth:`ContinuousScheduler.evict_row` the moment a victim
    is suspended — after which its blocks flow back into the allocator (the
    LRU free-list for registered prefixes, the free list for the rest) and
    its slot refills. ``master_k``/``master_v`` (``[L, n_done, Hkv, hd]``
    float32) are ALL ``n_done`` KV positions the row had written,
    dequantized from its pool blocks under its then-current scales — at
    bf16 the float32 upcast round-trips, and for int KV the value whose
    re-quantization under the same scale reproduces the stored ints
    bit-for-bit. The resume wave replays them as the *whole* continuation
    prefix with an **empty suffix**: the restore is pure data movement
    through the existing continuation-prefill executable — nothing is
    recomputed, so the restored row is byte-identical to the suspended one
    by construction, not by floating-point luck (the repo's recompute-based
    continuation paths are exact only up to bf16 master rounding).
    ``last_tok`` is the last token the row *emitted* (already delivered):
    with an empty suffix the wave's argmax is meaningless, so the
    scheduler re-points the decode carry at the recorded value — together
    with ``pos = n_done`` that is exactly the carry an uninterrupted row
    holds. ``pid`` pins the wave to the profile of the row's last
    pre-eviction step (billing bookkeeping only — with an empty suffix no
    profile-dependent compute lands in the cache). ``k_amax``/``v_amax``
    (``[L, Hkv]``, int-KV only) are best-effort scale preimages
    (:func:`repro.models.transformer.amax_for_scale`, ``strict=False``)
    that land the restore recalibration on — or within a few ulp of —
    the suspended scales; ``k_scale``/``v_scale`` carry the exact
    suspended scales, forced over the restored row afterwards (see the
    field comment below).
    """

    rid: int
    n_done: int
    last_tok: int
    pid: int
    master_k: Any
    master_v: Any
    k_amax: Any
    v_amax: Any
    # Exact suspended scale rows ([L, Hkv] f32, int-KV only). The amax
    # preimage above is best-effort (``amax_for_scale(..., strict=False)``):
    # XLA's reciprocal-multiply lowering of /qmax can emit scales true f32
    # division never produces, so no preimage exists for the restore wave's
    # recalibration to hit. Re-quantization is insensitive to the resulting
    # few-ulp scale drift (``round(i·(1±ε)) == i`` for ``|i| ≤ qmax``) — the
    # ints land bit-exact regardless — and the scheduler then FORCES these
    # rows over the restored slot's scales, closing the loop by assignment.
    k_scale: Any = None
    v_scale: Any = None


def prefix_keys(tokens: np.ndarray, block_size: int) -> list[bytes]:
    """Block-aligned prefix hashes of a prompt, longest first.

    Key ``j`` (1-based) identifies tokens ``[0, j*block_size)`` via a
    *chained* digest — block ``j``'s hash is seeded with key ``j−1`` (the
    vLLM scheme), so hashing the whole chain is O(prompt) rather than
    O(prompt²/block) and two prompts share a key iff their whole prefix
    matches. Only prefixes *strictly shorter* than the prompt are keyed —
    a shared admission must keep at least one suffix token, whose logits
    seed the first generated token. Hashed once at enqueue; matched
    against the registry at admission.
    """
    t = np.ascontiguousarray(np.asarray(tokens, np.int32))
    j_max = (len(t) - 1) // block_size
    keys = []
    h = b""
    for j in range(1, j_max + 1):
        h = hashlib.sha1(
            h + t[(j - 1) * block_size:j * block_size].tobytes()).digest()
        keys.append(h)
    keys.reverse()
    return keys


class BlockAllocator:
    """Refcounted free list + retired-block LRU over the physical pool.

    ``alloc`` hands out blocks at refcount 1 (the owning row); ``retain``
    adds references (each additional sharer); ``release`` drops one
    reference per block and sends fully-released blocks to the free list —
    or, for ids named in its ``cache`` set, to the LRU cached list, where
    their content stays resurrectable (:meth:`activate`) until allocation
    pressure reclaims them oldest-first. All O(1)-per-block host operations
    — the device pool is never read or written here.
    """

    def __init__(self, n_blocks: int, block_size: int):
        """``n_blocks`` physical blocks of ``block_size`` tokens, all free."""
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._free: list[int] = list(range(self.n_blocks - 1, -1, -1))
        self._ref = np.zeros(self.n_blocks, np.int32)
        self._lru: dict[int, None] = {}      # insertion order = oldest first
        # called with each block id the moment pressure reclaims it from the
        # LRU (before the id is handed to its new owner) — the registry
        # hooks this to drop entries whose backing content just vanished
        self.on_reclaim: Optional[Callable[[int], None]] = None
        self.reclaimed_blocks = 0

    @property
    def free_blocks(self) -> int:
        """Blocks with neither a reference nor cached content."""
        return len(self._free)

    @property
    def lru_blocks(self) -> int:
        """Retired blocks parked in the LRU: content still resurrectable,
        capacity still allocatable — cached, not used, not quite free."""
        return len(self._lru)

    @property
    def available_blocks(self) -> int:
        """What ``alloc`` can satisfy: free blocks plus reclaimable LRU."""
        return len(self._free) + len(self._lru)

    @property
    def used_blocks(self) -> int:
        """Blocks with at least one live reference — derived from the
        refcounts themselves (the ground truth), not from the free-list
        length, so occupancy stats cannot drift from the reference state."""
        return int((self._ref > 0).sum())

    def refcounts(self) -> np.ndarray:
        """Copy of the per-block reference counts (occupancy reporting)."""
        return self._ref.copy()

    def alloc(self, n: int) -> Optional[list[int]]:
        """Take ``n`` blocks (refcount 1 each); ``None`` if fewer than ``n``
        are free-or-cached — the caller's backpressure signal, never a
        partial allocation. Free blocks go first; only then does pressure
        reclaim LRU-cached content, oldest first, announcing each casualty
        through ``on_reclaim`` so prefix entries backed by it die with it.
        """
        if n > len(self._free) + len(self._lru):
            return None
        ids: list[int] = []
        # free and LRU are re-consulted every draw: reclaiming one block can
        # kill an entry whose OTHER blocks then move LRU → free (uncache of
        # newly-orphaned companions), and those must be preferred over
        # reclaiming more cached content. free+lru is conserved by that
        # move, so the up-front capacity check stays sufficient.
        while len(ids) < n:
            if self._free:
                ids.append(self._free.pop())
                continue
            bid = next(iter(self._lru))              # oldest cached block
            del self._lru[bid]
            if self.on_reclaim is not None:
                self.on_reclaim(bid)
            self.reclaimed_blocks += 1
            ids.append(bid)
        for b in ids:
            self._ref[b] = 1
        return ids

    def retain(self, ids) -> None:
        """Add one reference to each live block (an extra sharer)."""
        for b in ids:
            if self._ref[b] <= 0:
                raise RuntimeError(f"retain of free block {b}")
            self._ref[b] += 1

    def activate(self, ids) -> bool:
        """All-or-nothing claim of possibly-retired blocks: live blocks gain
        a reference, LRU-cached blocks resurrect at refcount 1. ``False``
        (and no state change) if any id was already reclaimed — the
        registry-hit-on-retired-blocks path's validity check."""
        for b in ids:
            if self._ref[b] <= 0 and b not in self._lru:
                return False
        for b in ids:
            if self._ref[b] > 0:
                self._ref[b] += 1
            else:
                del self._lru[b]
                self._ref[b] = 1
        return True

    def release(self, ids, cache=()) -> None:
        """Drop one reference per block. Fully-released blocks become free —
        or park in the LRU cached list when named in ``cache`` (a registered
        prefix still wants their content). Releasing an id that is already
        free (including the same id twice in one call) raises
        ``RuntimeError`` instead of silently corrupting the refcount of the
        block's next owner."""
        for b in ids:
            if self._ref[b] <= 0:
                raise RuntimeError(
                    f"double release of block {b} (refcount already 0)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if b in cache:
                    self._lru[int(b)] = None         # MRU end
                else:
                    self._free.append(int(b))

    def uncache(self, ids) -> None:
        """Drop cached content claims (a registry entry died): LRU-parked
        ids move to the plain free list; live or already-free ids no-op."""
        for b in ids:
            if b in self._lru:
                del self._lru[b]
                self._free.append(int(b))

    def check(self, expected: Optional[np.ndarray] = None) -> None:
        """Invariant auditor: raise ``RuntimeError`` on any bookkeeping rot.

        Checked invariants (the ground truth every paged-serving property
        rests on):

        * refcounts are never negative;
        * the free list holds no duplicates and no id also parked in the
          LRU;
        * free-listed and LRU-cached blocks hold zero references;
        * live (``ref > 0``) / LRU-cached / free **partition** the pool
          exactly — in particular, a block with refcount 0 that sits in
          neither list is a *leak* and fails here;
        * with ``expected`` (a per-block refcount array derived from
          external bookkeeping — the scheduler's block tables plus the
          registry's sharer counts), the allocator's refcounts must match
          it element-for-element.

        O(pool) pure host work: cheap enough for a ``--paranoid`` serve
        loop to run after every step, and for property tests to run after
        every single operation.
        """
        ref = self._ref
        neg = np.nonzero(ref < 0)[0]
        if neg.size:
            raise RuntimeError(f"negative refcount on blocks {neg.tolist()}")
        free = [int(b) for b in self._free]
        if len(set(free)) != len(free):
            raise RuntimeError("duplicate ids on the free list")
        fs, ls = set(free), {int(b) for b in self._lru}
        both = fs & ls
        if both:
            raise RuntimeError(f"blocks {sorted(both)} free AND LRU-cached")
        held = [b for b in fs | ls if ref[b] != 0]
        if held:
            raise RuntimeError(
                f"free/LRU blocks {sorted(held)} hold references")
        live = {int(b) for b in np.nonzero(ref > 0)[0]}
        missing = set(range(self.n_blocks)) - live - fs - ls
        if missing:
            raise RuntimeError(
                f"leaked blocks {sorted(missing)}: refcount 0 but on "
                f"neither the free list nor the LRU")
        if len(live) + len(fs) + len(ls) != self.n_blocks:
            raise RuntimeError("live/LRU/free do not partition the pool")
        if expected is not None:
            exp = np.asarray(expected)
            if exp.shape != ref.shape or not np.array_equal(exp, ref):
                bad = np.nonzero(np.asarray(exp) != ref)[0]
                raise RuntimeError(
                    f"refcounts disagree with external bookkeeping on "
                    f"blocks {bad.tolist()[:16]} "
                    f"(allocator={ref[bad][:16].tolist()}, "
                    f"expected={exp[bad][:16].tolist()})")


@dataclasses.dataclass
class PrefixEntry:
    """One registered block-aligned prefix.

    ``block_ids`` are the pool blocks holding the prefix KV (kv16 only —
    int-KV rows carry per-row scales, so their blocks are not bit-shareable
    across rows and shared admissions requantize from the masters instead).
    They are a *soft* claim: while any sharer is live the blocks carry
    references; after the last sharer retires they park in the allocator's
    LRU, where a later hit resurrects them — and real allocation pressure
    reclaims them, killing the entry. ``master_k``/``master_v`` (per layer
    ``[L, n_tokens, Hkv, hd]``, full precision) and ``k_amax``/``v_amax``
    (``[L, Hkv]`` raw max-abs over the prefix) let a shared admission
    reproduce the cold path exactly. ``sharers`` counts live rows currently
    mapping ``block_ids``; an entry is capacity-evictable only at zero.
    """

    key: bytes
    n_tokens: int
    block_ids: Optional[list[int]]
    master_k: Any
    master_v: Any
    k_amax: Any
    v_amax: Any
    sharers: int = 0
    hits: int = 0


class PrefixRegistry:
    """LRU registry of reusable prompt prefixes.

    ``capacity`` bounds host+device memory held by masters. Block-backed
    (kv16) entries hold their blocks softly through the allocator's
    retired-block LRU: registration pins nothing, retirement parks, real
    pressure reclaims (the allocator's ``on_reclaim`` callback drops the
    affected entries the moment their backing goes). Lookup order is
    longest-prefix-first over the hashes computed at enqueue
    (:func:`prefix_keys`).
    """

    def __init__(self, allocator: BlockAllocator, capacity: int = 8):
        """Registry over ``allocator``'s pool, holding ≤ ``capacity`` entries."""
        self.alloc = allocator
        self.capacity = int(capacity)
        self._entries: dict[bytes, PrefixEntry] = {}   # insertion = LRU order
        self._by_block: dict[int, set[bytes]] = {}     # bid -> entry keys
        self.hits = 0
        self.misses = 0
        self.invalidated = 0           # entries killed by block reclaim
        allocator.on_reclaim = self._block_reclaimed

    def __len__(self) -> int:
        return len(self._entries)

    def contains(self, key: bytes) -> bool:
        """Membership test that does NOT touch LRU recency or hit counters."""
        return key in self._entries

    def lookup(self, keys: list[bytes]) -> Optional[PrefixEntry]:
        """Longest registered prefix among ``keys`` (ordered longest-first).

        Pure read: hit/miss counters and LRU recency move only when an
        admission actually commits (:meth:`record_admission`) — a request
        re-looked-up on every scheduler tick while backpressured must not
        inflate the stats or churn the eviction order. Block-backed entries
        are always resident when returned: reclaim invalidates eagerly.
        """
        for key in keys:
            e = self._entries.get(key)
            if e is not None:
                return e
        return None

    def record_admission(self, entry: Optional[PrefixEntry]) -> None:
        """Count one committed admission: a hit (refreshing the entry's LRU
        recency) when ``entry`` was reused, a miss for a cold admission."""
        if entry is None:
            self.misses += 1
            return
        if entry.key in self._entries:
            self._entries.pop(entry.key)
            self._entries[entry.key] = entry           # refresh recency
        entry.hits += 1
        self.hits += 1

    def register(self, key: bytes, n_tokens: int,
                 block_ids: Optional[list[int]],
                 master_k, master_v, k_amax, v_amax) -> Optional[PrefixEntry]:
        """Record a prefix for reuse (no-op if already registered).

        ``block_ids`` are claimed *softly*: no refcount moves here — the
        owning row's live references keep them resident now, and its
        retirement parks them in the allocator LRU (the scheduler passes
        :meth:`covered` ids to ``release``). Over-capacity registration
        evicts the least recently used idle entry first; if every entry is
        in live use the new one is simply not registered.
        """
        if key in self._entries:
            return self._entries[key]
        while len(self._entries) >= self.capacity:
            if not self._evict_one():
                return None
        e = PrefixEntry(key=key, n_tokens=n_tokens,
                        block_ids=None if block_ids is None
                        else list(block_ids),
                        master_k=master_k, master_v=master_v,
                        k_amax=k_amax, v_amax=v_amax)
        self._entries[key] = e
        for b in (e.block_ids or ()):
            self._by_block.setdefault(int(b), set()).add(key)
        return e

    def register_chain(self, keys: list[bytes], j_max: int, blocks,
                       mk, mv, share_blocks: Optional[bool] = None) -> None:
        """Offer every key of one prompt's block-aligned prefix chain,
        longest first — key ``i`` of ``keys`` covers ``(j_max − i)``
        blocks. Every key is offered (``register`` no-ops on present ones)
        because LRU/reclaim eviction removes single entries, so a present
        long key does NOT imply its shorter companions survived. At kv16
        (``mk is None``) each entry claims the row's leading blocks softly
        — the pool's bf16 blocks double as the masters, nothing else is
        stored. At int KV precisions entries share the ONE master buffer
        ``mk``/``mv`` (already truncated to ``j_max`` blocks) and snapshot
        per-length raw amax — O(chain), not O(chain²), memory.

        ``share_blocks`` marks the pool blocks bit-shareable (bf16 pool;
        int8 rows are quantized on the owner's per-row grid and are not).
        It defaults to ``mk is None`` — the classic two modes — and
        ``share_blocks=True`` *with* masters is the ``kv16_masters`` mode:
        entries keep the CoW block claim AND the full-precision masters,
        so shared admissions still map instead of re-store while the
        prefix compute replays the raw activations (structural
        bit-exactness + exact durable snapshots).
        """
        if j_max < 1 or not keys:
            return
        if share_blocks is None:
            share_blocks = mk is None
        bs = self.alloc.block_size
        for i, key in enumerate(keys):           # longest first
            if self.contains(key):
                continue
            n_blk = j_max - i
            n_tok = n_blk * bs
            bids = blocks[:n_blk] if share_blocks else None
            if mk is None:                       # kv16: pool blocks = masters
                self.register(key, n_tok, bids, None, None, None, None)
            else:
                ka = mk[:, :n_tok].abs().amax(dim=(1, 3))
                va = mv[:, :n_tok].abs().amax(dim=(1, 3))
                self.register(key, n_tok, bids, mk, mv, ka, va)

    def acquire(self, entry: PrefixEntry) -> None:
        """A row starts mapping the entry's blocks: live blocks gain a
        reference, retired-but-cached ones resurrect from the LRU. Entries
        handed out by :meth:`lookup` are resident by construction (eager
        invalidation), so activation cannot fail."""
        entry.sharers += 1
        if entry.block_ids is not None:
            ok = self.alloc.activate(entry.block_ids)
            if not ok:                           # unreachable by contract
                raise RuntimeError(
                    f"registry entry {entry.key.hex()[:8]} outlived its "
                    f"blocks — reclaim invalidation failed")

    def release(self, entry: PrefixEntry) -> None:
        """A sharing row retired; its block references drop — and blocks
        reaching refcount 0 park in the allocator LRU (the entry still
        wants them) instead of the free list."""
        entry.sharers -= 1
        assert entry.sharers >= 0
        if entry.block_ids is not None:
            self.alloc.release(entry.block_ids,
                               cache=self.covered(entry.block_ids))

    def add_expected_refs(self, out: np.ndarray) -> None:
        """Accumulate the per-block references the registry's live sharers
        account for (``sharers`` per entry block — each :meth:`acquire`
        activated every ``block_ids`` member once) into ``out``. One half
        of the :meth:`BlockAllocator.check` cross-audit; the scheduler adds
        the other half from its slot block tables."""
        for e in self._entries.values():
            if e.block_ids is not None and e.sharers:
                for b in e.block_ids:
                    out[int(b)] += e.sharers

    def covered(self, ids) -> set:
        """The subset of ``ids`` some registered entry still claims — the
        ``cache`` set for :meth:`BlockAllocator.release`: covered blocks
        park in the LRU at refcount 0, uncovered ones go straight free."""
        return {int(b) for b in ids if int(b) in self._by_block}

    def _unindex(self, e: PrefixEntry) -> None:
        """Remove an entry's block claims; blocks left wholly unclaimed
        lose their LRU parking spot (content nobody can ever hit again)."""
        orphans = []
        for b in (e.block_ids or ()):
            keys = self._by_block.get(int(b))
            if keys is None:
                continue
            keys.discard(e.key)
            if not keys:
                del self._by_block[int(b)]
                orphans.append(int(b))
        if orphans:
            self.alloc.uncache(orphans)

    def _block_reclaimed(self, bid: int) -> None:
        """Allocator callback: pressure reclaimed a cached block — every
        entry backed by it is now unreproducible and dies with it. Entries
        with live sharers are unreachable here (their blocks carry
        references and cannot sit in the LRU)."""
        for key in list(self._by_block.get(int(bid), ())):
            e = self._entries.pop(key, None)
            if e is None:
                continue
            assert e.sharers == 0, "live-shared entry backed by LRU block"
            self.invalidated += 1
            # the reclaimed id itself is being handed out by alloc();
            # only the entry's *other* blocks need their claims dropped
            e.block_ids = [b for b in e.block_ids if int(b) != int(bid)]
            self._unindex(e)
        self._by_block.pop(int(bid), None)

    def _evict_one(self) -> bool:
        for key, e in self._entries.items():
            if e.sharers == 0:
                self._entries.pop(key)
                self._unindex(e)
                return True
        return False

    def nbytes(self) -> int:
        """Device bytes pinned by prefix masters (counted by the bench as
        part of the paged KV footprint). Chain entries share one master
        buffer, so bytes are counted per unique array, not per entry."""
        total = 0
        seen: set[int] = set()
        for e in self._entries.values():
            for arr in (e.master_k, e.master_v, e.k_amax, e.v_amax):
                if arr is not None and id(arr) not in seen:
                    seen.add(id(arr))            # kv16 stores no masters at
                    total += int(arr.nbytes)     # all — pool blocks double
        return total                             # as the masters there
