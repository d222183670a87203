"""Chunked prefill, speculation over copy-on-write prefixes and f32 masters
at kv16 in the port, against the JAX reference on the same weights (smoke
granite-3-2b), on both of the port's backends — through
``test_torch_prefix.run_pair``, which compares tokens, profile traces,
billing events, admission order and registry counters and checks that the
allocator drains to 0 live blocks:

* long prompts admitted in block-aligned chunks give the reference's
  tokens at kv16 and kv8 (the kv8 masters accumulate a running amax);
* a chunking row lets live rows keep decoding, and rows frozen between
  chunks (which keep writing junk at their position) are rewritten whole
  by the next chunk, on the kernel backend's in-place writes too;
* a registry hit with a long suffix chunks from the hit;
* speculative rows decode over copy-on-write prefix blocks, billing what
  they deliver, and the shared blocks' bytes stay unchanged;
* ``kv16_masters`` replays f32 masters at kv16 (the tokens of a run
  without the cache, where gathering the bf16 prefix may flip a
  near-tie) and is refused elsewhere.
"""
import numpy as np
import pytest

from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from test_torch_prefix import (_raw, _sys_requests, parts,  # noqa: F401
                               run_pair)
from torch_threads import _one_thread  # noqa: F401


def _reqs(cfg, seed, shape, Req):
    rng = np.random.default_rng(seed)
    return [Req(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=m, accuracy_critical=(i == 0))
            for i, (n, m) in enumerate(shape)]


@pytest.mark.parametrize("kv_bits,managed", [(16, False), (8, True)])
def test_chunked_prefill_matches_reference(parts, kv_bits, managed):
    cfg = parts[0]

    def scenario(sched, Req):
        for r in _reqs(cfg, 41, [(40, 5), (33, 4), (6, 3)], Req):
            sched.submit(r)
        n = sched.admit()
        chunking = sorted(sched._chunk_state)
        sched.run()
        assert not sched._chunk_state
        return {"admitted": n, "chunking": chunking}

    out = run_pair(parts, dict(slots=64, max_batch=4, kv_bits=kv_bits,
                               block_size=8, prefill_chunk=16), scenario,
                   quantum=2, managed=managed)
    sched = out["kernel"]
    assert sched.srv.chunk_tokens == 16 and sched.chunk_waves >= 2
    assert sched.segments_chunking >= 1


def test_chunking_interleaves_decode(parts):
    """The short request completes while the long one is still chunking
    in: the long row sat frozen through those segments."""
    cfg = parts[0]

    def scenario(sched, Req):
        short, long = _reqs(cfg, 7, [(8, 4), (80, 4)], Req)
        sched.submit(short)
        sched.submit(long)
        sched.step()
        live = sched.live_rows
        done = []
        while sched._chunk_state:
            sched.step()
            done += [rid for rid, _ in sched.poll_completed()]
        sched.run()
        return {"live": live, "done_while_chunking": done}

    out = run_pair(parts, dict(slots=96, max_batch=4, block_size=8,
                               prefill_chunk=16), scenario, quantum=2)
    assert out["gather"].chunk_waves == 4     # chunks 2..5 of 80 tokens


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_chunk_from_registry_hit(parts, kv_bits):
    """The second request hits the 16-token system prompt and chunks its
    33-token suffix; at kv16 its chunks gather the shared blocks (read
    only) and the finished chain registers over them."""
    cfg = parts[0]

    def scenario(sched, Req):
        r1, r2 = _sys_requests(cfg, 11, (4, 33), (6, 5), Req)
        sched.submit(r1)
        sched.run()
        sched.submit(r2)
        sched.admit()
        from_hit = [st["n_shared"] for st in sched._chunk_state.values()]
        sched.run()
        return {"from_hit": from_hit, "n_reg": len(sched.registry)}

    out = run_pair(parts, dict(slots=80, max_batch=2, kv_bits=kv_bits,
                               block_size=8, prefill_chunk=16), scenario,
                   quantum=2)
    assert out["kernel"].registry.hits == 1


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_spec_shared_prefix_cow_rows(parts, kv_bits):
    """Speculation over copy-on-write rows: the second request maps the
    registered prefix, both rows draft and verify over the shared pool, the
    ledger bills the delivered tokens, and (kv16) the shared blocks' bytes
    never change."""
    cfg = parts[0]

    def scenario(sched, Req):
        reqs = _sys_requests(cfg, 37, (5, 8), (12, 10), Req)
        sched.submit(reqs[0])
        sched.step()                     # registers the shared prefix
        e = max(sched.registry._entries.values(), key=lambda x: x.n_tokens)
        bids = None if e.block_ids is None else np.asarray(e.block_ids)
        pool = sched._caches["kv"]
        snap = None if bids is None else _raw(pool.k[:, bids])
        sched.submit(reqs[1])            # maps it copy-on-write
        sched.run()
        if snap is not None:
            assert np.array_equal(_raw(sched._caches["kv"].k[:, bids]), snap)
        billed = len(sched.admission_log) + sum(
            n for _, n in sched.spec_billed)
        delivered = sum(len(r["tokens"]) for r in sched.results.values())
        assert billed == delivered
        return {"spec_billed": list(sched.spec_billed),
                "hits": sched.registry.hits}

    out = run_pair(parts, dict(slots=64, max_batch=2, kv_bits=kv_bits,
                               block_size=8, speculate=True, draft_k=2),
                   scenario, quantum=5, managed=True)
    assert out["kernel"].registry.hits == 1


def test_kv16_masters(parts):
    """f32 masters at kv16: a hit and the chunks of a long prompt replay
    the raw activations (the bf16 blocks stay shared), with the
    reference's tokens."""
    cfg = parts[0]

    def scenario(sched, Req):
        assert sched.srv.masters_mode
        r1, r2 = _sys_requests(cfg, 21, (5, 30), (6, 4), Req)
        sched.submit(r1)
        sched.run()
        e = max(sched.registry._entries.values(), key=lambda x: x.n_tokens)
        sched.submit(r2)
        sched.run()
        return {"shared": e.block_ids is not None,
                "masters": e.master_k is not None}

    run_pair(parts, dict(slots=64, max_batch=2, block_size=8,
                         prefill_chunk=16, kv16_masters=True), scenario,
             quantum=2)


def test_server_knobs(parts):
    _, tcfg, _, tp, _, teng, _ = parts

    def srv(**kw):
        return AdaptiveServer(tcfg, tp, teng, ServingConfig(
            slots=64, max_batch=2, block_size=8, **kw), device="cpu")

    assert srv(prefill_chunk=20).chunk_tokens == 16   # down to a block
    assert srv(prefill_chunk=3).chunk_tokens == 8     # at least one block
    assert srv().chunk_tokens is None
    s8 = srv(kv_bits=8)
    assert s8.masters_mode and s8._collect_masters and s8.prefix_sharing
    s16 = srv()
    assert not s16.masters_mode and not s16._collect_masters
    assert not srv(kv_bits=8, prefix_cache=False)._collect_masters
    with pytest.raises(ValueError, match="kv16_masters"):
        srv(kv_bits=8, kv16_masters=True)


def test_kv16_masters_give_cold_tokens(parts):
    """With f32 masters a kv16 continuation (a hit, a chunk) replays the
    raw K/V a cold prefill attends over, so the serve gives the tokens of
    the run without the prefix cache or chunks."""
    _, tcfg, _, tp, _, teng, _ = parts
    rng = np.random.default_rng(8)
    system = rng.integers(0, tcfg.vocab, 48).astype(np.int32)
    reqs = [Request(tokens=np.concatenate(
        [system, rng.integers(0, tcfg.vocab, int(n)).astype(np.int32)]),
        max_new=16) for n in rng.integers(16, 40, 8)]
    out = {}
    for name, kw in (("cold", dict(prefix_cache=False)),
                     ("masters", dict(kv16_masters=True, prefill_chunk=32))):
        sched = ContinuousScheduler(AdaptiveServer(tcfg, tp, teng,
                                                   ServingConfig(
            slots=128, max_batch=4, block_size=16, paged_backend="kernel",
            **kw), device="cpu"), quantum=8)
        for r in reqs:
            sched.submit(r)
        out[name] = [r["tokens"] for r in sched.run()]
    assert sched.registry.hits == 4 and sched.chunk_waves > 0
    assert out["masters"] == out["cold"]
