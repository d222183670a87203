"""The port's ``BlockAllocator`` against the reference's, in lockstep, under
the reference's random interleavings.

``tests/test_allocator_property.py`` drives an allocator through long random
interleavings of ``alloc`` / ``retain`` / ``release`` (with and without LRU
caching) / ``activate`` / ``uncache`` / pressure reclaim and double
releases, mirrors each in an independent model and audits with ``check``
after every operation. Here its op executor (``_apply_op``, ``_drain``) runs on a
:class:`Lockstep` that forwards every call to
``repro_torch.serving.paged.BlockAllocator`` and to the reference's: both
must return the same values, raise the same errors, reclaim the same blocks
and hold the same refcounts, free list and LRU order after every operation,
and both pass ``check``. The reference's corruption cases run on the
port's allocator.
"""
import numpy as np
import pytest

from repro.serving.paged import BlockAllocator as JAllocator
from repro_torch.serving.paged import BlockAllocator
from test_allocator_property import N_BLOCKS, OPS, _apply_op, _drain
from torch_threads import _one_thread  # noqa: F401

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False


class Lockstep:
    """Both allocators behind one interface; every call goes to both."""

    def __init__(self, n_blocks: int, block_size: int):
        self.port = BlockAllocator(n_blocks, block_size)
        self.ref = JAllocator(n_blocks, block_size)
        self.reclaimed = ([], [])
        self.port.on_reclaim = self.reclaimed[0].append
        self.ref.on_reclaim = self.reclaimed[1].append

    def _same_state(self):
        p, r = self.port, self.ref
        assert np.array_equal(p.refcounts(), r.refcounts())
        assert [int(b) for b in p._free] == [int(b) for b in r._free]
        assert [int(b) for b in p._lru] == [int(b) for b in r._lru]
        assert self.reclaimed[0] == self.reclaimed[1]

    def _both(self, name, *args, **kw):
        outs, errs = [], []
        for a in (self.port, self.ref):
            try:
                outs.append(getattr(a, name)(*args, **kw))
                errs.append(None)
            except RuntimeError as e:
                outs.append(None)
                errs.append(str(e))
        assert errs[0] == errs[1], (name, errs)
        assert outs[0] == outs[1], (name, outs)
        self._same_state()
        if errs[0] is not None:
            raise RuntimeError(errs[0])
        return outs[0]

    def alloc(self, n):
        return self._both("alloc", n)

    def retain(self, ids):
        return self._both("retain", list(ids))

    def activate(self, ids):
        return self._both("activate", list(ids))

    def release(self, ids, cache=()):
        return self._both("release", list(ids), cache=set(cache))

    def uncache(self, ids):
        return self._both("uncache", list(ids))

    def check(self, expected=None):
        self.port.check(expected=expected)
        self.ref.check(expected=expected)

    def __getattr__(self, name):          # counters and properties
        got, want = getattr(self.port, name), getattr(self.ref, name)
        assert got == want, name
        return got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_lockstep_random_interleaving(seed):
    """250 random ops on both allocators, audited after each."""
    rng = np.random.default_rng(seed)
    alloc = Lockstep(N_BLOCKS, 8)
    ref = np.zeros(N_BLOCKS, np.int64)
    lru: set = set()
    for _ in range(250):
        _apply_op(alloc, ref, lru, str(rng.choice(OPS)), rng)
    assert alloc.reclaimed_blocks == len(alloc.reclaimed[0])
    _drain(alloc, ref)


def test_check_flags_corruption():
    """The port's auditor bites on hand-rotted state, as the reference's."""
    alloc = BlockAllocator(4, 8)
    alloc._free.remove(2)                        # leak block 2
    with pytest.raises(RuntimeError, match="leaked"):
        alloc.check()
    alloc = BlockAllocator(4, 8)
    got = alloc.alloc(2)
    alloc.check(expected=[1, 1, 0, 0] if got == [0, 1] else None)
    alloc._ref[got[0]] = 0                       # refcount lies vs free list
    with pytest.raises(RuntimeError, match="leaked|partition"):
        alloc.check()
    alloc = BlockAllocator(4, 8)
    alloc.alloc(1)
    with pytest.raises(RuntimeError, match="disagree"):
        alloc.check(expected=np.zeros(4, np.int64))


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(ops=st.lists(st.sampled_from(OPS), max_size=120),
           seed=st.integers(0, 2**31 - 1))
    def test_allocator_lockstep_hypothesis(ops, seed):
        """The same lockstep under hypothesis shrinking."""
        rng = np.random.default_rng(seed)
        alloc = Lockstep(N_BLOCKS, 8)
        ref = np.zeros(N_BLOCKS, np.int64)
        lru: set = set()
        for op in ops:
            _apply_op(alloc, ref, lru, op, rng)
        _drain(alloc, ref)
else:                                                 # pragma: no cover
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_allocator_lockstep_hypothesis():
        pass
