"""Serving launcher for the port: the adaptive engine behind a Profile
Manager with an energy budget.

  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      [--requests 12 --max-new 32 --kv-bits 8 --seed 0]
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \
      [--no-paged-kv] [--speculate --draft-k 4 --draft-model ngram]
      [--no-prefix-cache] [--prefill-chunk 128] [--kv16-masters]
      [--priority-classes 2 --preemption --aging 4]
      [--precision-policy policy.json]
      [--inject-faults --fault-seed 0 --retry-budget 2 --paranoid]
      [--deadline-ms 5000 --shed 8]
      [--journal-dir DIR --checkpoint-every 8 --drain-on-sigterm]

As in the reference launcher, ``--continuous`` decides the path. Without
it, the requests are served in static groups (``AdaptiveServer.serve``:
length-sorted groups of up to ``max_batch`` rows, one ragged generate per
group, on a contiguous KV cache). With it, they go through the continuous
scheduler's slot pool: the paged block pool, or contiguous rows with
``--no-paged-kv``. ``--speculate`` and ``--preemption`` need
``--continuous``; speculation runs on either pool, preemption on the paged
one. Under ``--priority-classes n`` every third request rides class 0
(critical), the rest the lowest class. ``--precision-policy`` reads the
schedule ``python -m repro_torch.launch.precision_frontier --json`` wrote:
profile 0 keeps KV at full precision in every layer, the other profiles
ride the schedule.

Fault tolerance (``--continuous`` only): ``--inject-faults`` arms a seeded
fault schedule (one guaranteed recoverable NaN in request 1, random NaNs
at about one per four requests, one dry allocator round), each NaN row
quarantined and retried at the accuracy target within ``--retry-budget``;
``--deadline-ms`` gives every request a deadline, ``--shed N`` refuses the
least urgent request once the queue passes ``N``; ``--paranoid`` audits
the block pool after every step. Each request's line then shows its
terminal status, a ``robustness:`` line the counters, and the closing
audit prints "block-pool audit clean".

Crash-consistent serving (``--continuous`` only): ``--journal-dir DIR``
journals every request edge write-ahead into ``DIR/journal.jsonl`` and
cuts a live-state checkpoint into ``DIR/checkpoints/`` every
``--checkpoint-every`` rounds (0: the journal alone). A boot on a
non-empty ``DIR`` recovers first (the newest checkpoint, then the journal
past it; the ``[serve] recovered`` line says what came back) and then
submits its own requests after the recovered ones; a ``[serve]
durability:`` line gives each cut's bytes and host ms, the fsync'd records
and the recovery's time. ``--drain-on-sigterm`` turns a SIGTERM into a
drain: admission stops, every admitted row finishes, a final checkpoint is
cut (with ``--journal-dir``) and the queued requests stay journaled for
the next process.

Runs on the GPU unless ``--device cpu`` is given. ``--arch`` picks
granite-3-2b (the default) or another ported arch (``ARCHS``: the MoE
qwen2-moe-a2.7b and deepseek-moe-16b, mamba2-130m, hymba-1.5b); an SSM
stack keeps the contiguous pool under ``--continuous`` (``--no-paged-kv``
is implied), and SSM, hybrid and MoE stacks refuse ``--speculate`` and
``--preemption``, as the reference does. ``--full`` serves the published
configuration (granite-3-2b: 40 layers, d_model 2048; qwen2-moe-a2.7b: 24
layers, d_model 2048, 60 experts), without it the smoke configuration;
either way with the reference launcher's workload: prompts of 4–23
tokens, ``slots=256`` and 4 rows. A caller that wants another workload
passes it to :func:`build_server` (``slots``, ``max_batch``),
:func:`make_requests` (``prompt_lens``) or :func:`main`, as
``chip_smoke.py`` does for the card (``slots=1024``, 8 rows, prompts of
64–512 tokens).
"""
from __future__ import annotations

import argparse
import json
import signal
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core.energy import H100_SXM, HWSpec, activity_factor, step_energy
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.manager import ProfileManager, ProfileStats
from repro_torch.core.profiles import paper_profiles
from repro_torch.models import transformer as T
from repro_torch.runtime import resolve_device
from repro_torch.serving.durability import recover
from repro_torch.serving.engine import (AdaptiveServer, Request, ServingConfig,
                                        check_servable)
from repro_torch.serving.faults import FaultSchedule
from repro_torch.serving.policy import ShedPolicy
from repro_torch.serving.scheduler import ContinuousScheduler

__all__ = ["profile_stats", "precision_policy", "build_server",
           "make_requests", "scheduler_kwargs", "serve", "durability_line",
           "main"]


def profile_stats(cfg, profs, n_params: int,
                  hw: HWSpec = H100_SXM) -> list[ProfileStats]:
    """Modeled per-inference energy per profile (the roofline energy model
    on ``hw``); accuracies are the paper's Table-1 shape."""
    acc_by_w = {8: 0.989, 4: 0.953, 32: 0.998}
    out = []
    t_est = 2.0 * n_params / hw.peak_flops  # one fwd, compute term
    for p in profs:
        a, w = next(iter(p.bits.values()))
        act = activity_factor(min(a, 16), min(w, 16), min(w, 16) / 16.0)
        name_acc = acc_by_w.get(w, 0.97) - (0.004 if p.name == "Mixed" else 0)
        out.append(ProfileStats(p.name, name_acc,
                                step_energy(t_est, act, hw=hw), t_est))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="the published configuration (default: smoke)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching slot pool "
                         "(ContinuousScheduler) instead of static groups")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-bits", type=int, default=16, choices=[4, 8, 16],
                    help="KV-cache precision: 16 = bf16, 8 = int8, 4 = "
                         "packed int4")
    ap.add_argument("--quantum", type=int, default=8,
                    help="decode steps per continuous-batching segment")
    ap.add_argument("--paged-kv", dest="paged_kv", action="store_true",
                    default=True,
                    help="paged KV pool for the continuous scheduler: "
                         "a global block pool and per-row block tables "
                         "(default)")
    ap.add_argument("--no-paged-kv", dest="paged_kv", action="store_false",
                    help="continuous scheduler on contiguous [max_batch, "
                         "slots] KV rows instead of the paged block pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block of the paged pool")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="physical KV blocks (default: the contiguous "
                         "footprint)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable shared-prefix reuse (block-hash registry "
                         "+ suffix-only admission prefill)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: admission prompts longer than "
                         "this many tokens prefill in block-aligned chunks "
                         "interleaved with decode segments (default: off)")
    ap.add_argument("--kv16-masters", action="store_true",
                    help="keep f32 KV masters for shared and chunked rows "
                         "at --kv-bits 16 too (continuations replay the raw "
                         "activations instead of the bf16 blocks)")
    ap.add_argument("--paged-backend", default="auto",
                    choices=["auto", "kernel", "pallas", "gather"],
                    help="'kernel' attends in place through the paged-"
                         "attention kernel (and reads a contiguous kv8 "
                         "cache through the int8-KV decode kernel), "
                         "'gather' builds the dense per-segment view (and "
                         "reads a contiguous cache through the reference's "
                         "einsum), 'auto' = kernel on CUDA; 'pallas' is "
                         "the reference's name for 'kernel'")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative decoding: each window drafts "
                         "--draft-k tokens (self-speculative n-gram lookup) "
                         "and verifies them in one batched pass — the same "
                         "tokens as greedy decode (needs --continuous)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="drafted tokens per speculative window (window = "
                         "draft-k + 1 positions; default: 4)")
    ap.add_argument("--draft-model", default=None,
                    choices=["ngram", "repeat"],
                    help="drafter: 'ngram' (default, self-speculative "
                         "longest-suffix lookup) or 'repeat' (repeat the "
                         "current token)")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="request priority classes for the continuous "
                         "scheduler: 1 = classless FIFO (default); >=2 "
                         "builds the critical/.../saver ladder — class 0 "
                         "admits first and is profile-bound to the "
                         "accuracy target (every 3rd request rides class "
                         "0, the rest the lowest class)")
    ap.add_argument("--preemption", action="store_true",
                    help="a critical arrival that cannot admit evicts "
                         "saver-class rows (snapshotted, resumed "
                         "bit-exactly through the continuation wave); "
                         "needs --continuous and the paged pool")
    ap.add_argument("--aging", type=int, default=None, metavar="ROUNDS",
                    help="anti-starvation: a request that has waited "
                         "ROUNDS rounds at the head of its class climbs "
                         "one level (default: off)")
    ap.add_argument("--precision-policy", default=None, metavar="PATH",
                    help="per-layer KV bit-width policy JSON (written by "
                         "python -m repro_torch.launch.precision_frontier "
                         "--json): profile 0, the accuracy-critical "
                         "binding, keeps every layer at 16 bits, every "
                         "other profile rides the searched schedule")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request completion deadline in ms from "
                         "submission: a request past it (or predicted "
                         "unable to meet it at admission) finalizes "
                         "EXPIRED; a live row is reaped at the next flush "
                         "boundary (needs --continuous)")
    ap.add_argument("--shed", type=int, default=None, metavar="DEPTH",
                    help="overload shedding: once the queue passes DEPTH, "
                         "the least urgent request finalizes SHED instead "
                         "of queuing (needs --continuous)")
    ap.add_argument("--inject-faults", action="store_true",
                    help="seeded chaos: NaN logits in live decode rows "
                         "(quarantined and retried at the accuracy "
                         "target) and one dry allocator round (needs "
                         "--continuous)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault schedule (with --inject-faults)")
    ap.add_argument("--retry-budget", type=int, default=2,
                    help="quarantine retries per request before it "
                         "finalizes FAILED (default: 2)")
    ap.add_argument("--paranoid", action="store_true",
                    help="audit the block pool (refcounts against the "
                         "free/LRU/live partition) after every scheduler "
                         "step (needs --continuous)")
    ap.add_argument("--journal-dir", default=None, metavar="DIR",
                    help="crash-consistent serving: a write-ahead request "
                         "journal and live-state checkpoints under DIR; a "
                         "non-empty DIR is recovered at boot (the newest "
                         "checkpoint, then the journal past it) and every "
                         "accepted request resumes token-identically "
                         "(needs --continuous)")
    ap.add_argument("--checkpoint-every", type=int, default=8,
                    metavar="ROUNDS",
                    help="live-state checkpoint cadence in scheduler rounds "
                         "(default: 8; 0 = the journal alone, which loses "
                         "nothing either: a checkpoint bounds the "
                         "recompute of a recovery). Only with --journal-dir")
    ap.add_argument("--drain-on-sigterm", action="store_true",
                    help="graceful shutdown: SIGTERM stops admission, runs "
                         "every admitted row to a terminal status, cuts a "
                         "final checkpoint (with --journal-dir) and exits; "
                         "queued requests stay journaled for the next "
                         "process (needs --continuous)")
    ap.add_argument("--budget-inferences", type=float, default=200,
                    help="energy budget in units of full-power inferences")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    if args.preemption and not args.continuous:
        raise SystemExit("--preemption needs --continuous (the slot pool)")
    if not args.continuous and (args.deadline_ms is not None
                                or args.shed is not None
                                or args.inject_faults or args.paranoid):
        raise SystemExit("--deadline-ms/--shed/--inject-faults/--paranoid "
                         "need --continuous (the fault-tolerant scheduler)")
    if args.speculate and not args.continuous:
        raise SystemExit("--speculate needs --continuous (draft/verify "
                         "windows run through the slot-pool segment)")
    if (args.journal_dir or args.drain_on_sigterm) and not args.continuous:
        raise SystemExit("--journal-dir/--drain-on-sigterm need --continuous "
                         "(durability hooks live on the slot-pool scheduler)")
    return args


def precision_policy(path: str, n_layers: int, n_profiles: int) -> tuple:
    """The ``[n_profiles, n_layers]`` policy from a frontier JSON's
    ``schedule``: profile 0 gets the all-16 row, the others the
    schedule. A schedule of another length is a ``SystemExit``."""
    with open(path) as f:
        row = tuple(int(b) for b in json.load(f)["schedule"])
    if len(row) != n_layers:
        raise SystemExit(f"--precision-policy schedule has {len(row)} "
                         f"layers, model has {n_layers}")
    return tuple((16,) * n_layers if i == 0 else row
                 for i in range(n_profiles))


def build_server(args: argparse.Namespace, *, slots: int = 256,
                 max_batch: int = 4):
    """Model, engine, manager and server for ``args`` → (cfg, server), with
    ``slots`` per row and ``max_batch`` rows (the reference launcher's 256
    and 4 by default)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    try:
        check_servable(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    names = T.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    policy = (None if args.precision_policy is None else
              precision_policy(args.precision_policy, cfg.n_layers,
                               len(profs)))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    engine = AdaptiveEngine(tuple(profs), QuantIndex(names))
    stats = profile_stats(cfg, profs, T.param_count(params))
    mgr = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                         budget_j=stats[0].energy_j * args.budget_inferences,
                         low_energy=0.5)
    scfg = ServingConfig(slots=slots, kv_bits=args.kv_bits,
                         max_batch=max_batch,
                         paged_kv=args.paged_kv,
                         block_size=args.block_size,
                         pool_blocks=args.pool_blocks,
                         prefix_cache=args.prefix_cache,
                         paged_backend=args.paged_backend,
                         prefill_chunk=args.prefill_chunk,
                         priority_classes=args.priority_classes,
                         preemption=args.preemption, aging=args.aging,
                         speculate=args.speculate, draft_k=args.draft_k,
                         draft_model=args.draft_model,
                         kv16_masters=args.kv16_masters,
                         precision_policy=policy)
    return cfg, AdaptiveServer(cfg, params, engine, scfg, manager=mgr,
                               device=device)


def make_requests(cfg, args: argparse.Namespace, *,
                  prompt_lens: tuple = (4, 24)) -> list[Request]:
    """``args.requests`` prompts from ``args.seed``, their lengths drawn
    from ``[lo, hi)`` of ``prompt_lens`` (the reference launcher's 4–23
    by default); every third request is accuracy-critical and of class 0,
    the rest of the lowest class, each with ``args.deadline_ms``, as in
    the reference launcher."""
    rng = np.random.default_rng(args.seed)
    lo, hi = prompt_lens
    n_cls = max(1, args.priority_classes)
    return [Request(tokens=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new=args.max_new, accuracy_critical=(i % 3 == 0),
                    priority=0 if i % 3 == 0 else n_cls - 1,
                    deadline_ms=args.deadline_ms)
            for i, n in enumerate(rng.integers(lo, hi, args.requests))]


def scheduler_kwargs(args: argparse.Namespace) -> dict:
    """The :class:`ContinuousScheduler`'s robustness arguments from the
    flags. ``--inject-faults`` builds the reference launcher's schedule:
    one guaranteed recoverable NaN (request 1, first attempt), random NaNs
    at ``p = 0.25`` capped at a quarter of the requests, and a dry
    allocator in admission round 2."""
    faults = None
    if args.inject_faults:
        faults = FaultSchedule(args.fault_seed, p_nan=0.25,
                               max_nan=max(1, args.requests // 4),
                               nan_at={min(1, args.requests - 1): (0,)},
                               alloc_at=(2,))
    return {"shed": (ShedPolicy(max_queue=args.shed)
                     if args.shed is not None else None),
            "faults": faults, "retry_budget": args.retry_budget,
            "paranoid": args.paranoid}


def serve(srv: AdaptiveServer, reqs: list[Request], quantum: int, *,
          continuous: bool, sched_kw: Optional[dict] = None,
          sched: Optional[ContinuousScheduler] = None,
          stop: Optional[dict] = None) -> dict:
    """Serve ``reqs``: through a :class:`ContinuousScheduler` stepped to
    the end (``continuous``; ``sched`` if given, such as a recovered one,
    else a fresh one built with ``sched_kw``), else in static groups
    (:meth:`AdaptiveServer.serve`). Once ``stop["drain"]`` is set (the
    SIGTERM handler) the scheduler drains, cuts a final checkpoint if it
    is journaled, and the serve ends with the queued requests' results
    ``None``. Returns the results (by rid), the scheduler (``None`` on
    the static path), the wall time and whether it drained."""
    if continuous:
        if sched is None:
            sched = ContinuousScheduler(srv, quantum=quantum,
                                        **(sched_kw or {}))
        for r in reqs:
            sched.submit(r)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    t0 = time.perf_counter()
    drained = False
    if continuous:
        while sched.step():
            if stop is not None and stop["drain"]:
                sched.drain()
                if sched.durable is not None:
                    sched.durable.checkpoint()
                drained = True
                break
        results = [sched.results.get(i) for i in range(sched._n)]
    else:
        results = srv.serve(reqs)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    return {"results": results, "sched": sched,
            "wall_s": time.perf_counter() - t0, "drained": drained}


def durability_line(sched: ContinuousScheduler) -> str:
    """The journaled scheduler's costs: each checkpoint cut's leaf bytes
    and host ms (capture and commit), the fsync'd journal records with
    their mean host ms, and the boot's recovery time."""
    dur = sched.durable
    cuts = ", ".join(f"{b} B in {1e3 * t:.3f} ms" for b, t in dur.cuts)
    j = dur.journal
    per = 1e3 * j.sync_s / j.synced if j.synced else 0.0
    return (f"[serve] durability: {len(dur.cuts)} checkpoint cuts [{cuts}]; "
            f"{j.synced} fsync'd records, {per:.4f} ms each; recovery "
            f"{1e3 * sched.recover_info['recovery_s']:.3f} ms")


def main(argv=None, *, slots: int = 256, max_batch: int = 4,
         prompt_lens: tuple = (4, 24)) -> None:
    """The launcher; the keyword arguments set the workload (the reference
    launcher's by default, see :func:`build_server` and
    :func:`make_requests`)."""
    args = parse_args(argv)
    stop = {"drain": False}
    if args.drain_on_sigterm:
        # installed before the (slow) build: a TERM during warm-up drains
        # at the first step boundary instead of killing the process
        signal.signal(signal.SIGTERM, lambda *_: stop.update(drain=True))
    cfg, srv = build_server(args, slots=slots, max_batch=max_batch)
    sched_kw = scheduler_kwargs(args) if args.continuous else None
    sched = None
    if args.journal_dir:
        sched = recover(srv, args.journal_dir,
                        checkpoint_every=args.checkpoint_every,
                        quantum=args.quantum, **sched_kw)
        ri = sched.recover_info
        if ri["resumed_rows"] or ri["chunk_rows"] or ri["replayed"]:
            print(f"[serve] recovered from {args.journal_dir}: "
                  f"{ri['resumed_rows']} live rows resumable, "
                  f"{ri['chunk_rows']} mid-prompt chunk rows rebuilt, "
                  f"{ri['replayed']} journal records replayed, "
                  f"{len(ri['refilled'])} re-prefilled after corruption "
                  f"({ri['recovery_s'] * 1e3:.0f} ms)")
    out = serve(srv, make_requests(cfg, args, prompt_lens=prompt_lens),
                args.quantum,
                continuous=args.continuous, sched_kw=sched_kw, sched=sched,
                stop=stop)
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    if out["drained"]:
        print(f"[serve] SIGTERM drain: {sched.pending} request(s) left "
              f"queued (journaled) after finishing all admitted rows")
    head = (f"[serve] {cfg.name} on {srv.device} ({srv.paged_backend} "
            f"backend, kv{srv.scfg.kv_bits})")
    if sched is None:
        print(f"{head}: static groups of {srv.scfg.max_batch} rows, "
              f"contiguous KV cache")
    elif sched.paged:
        st = sched.paged_stats()
        print(f"{head}: peak {st['peak_used_blocks']}/{st['pool_blocks']} "
              f"blocks of {st['block_size']} tokens, preemptions "
              f"{st['preemptions']} (resumes {st['resumes']})")
        if sched.registry is not None:
            print(f"[serve] prefix registry: {st['registry_hits']} hits, "
                  f"{st['registry_misses']} misses, "
                  f"{st['registry_entries']} entries")
        if sched.chunk:
            print(f"[serve] chunked prefill ({sched.chunk} tokens): "
                  f"{sched.chunk_waves} continuation waves, "
                  f"{sched.segments_chunking} segments while chunking")
    else:
        print(f"{head}: contiguous pool of {sched.n_slots} rows")
    for i, r in enumerate(results):
        if r is None:                # still queued after a SIGTERM drain
            print(f"[serve] req{i}: queued (journaled for the next process)")
            continue
        status = ""
        if "status" in r:
            status = f" [{r['status'].value}" + (
                f": {r['reason']}]" if r.get("reason") else "]")
        retries = r.get("retries", 0)
        if retries:
            status += (f" (recovered after {retries} escalated "
                       f"retr{'y' if retries == 1 else 'ies'})")
        print(f"[serve] req{i}: {len(r['tokens'])} tokens{status}, "
              f"profiles used: {sorted(set(r['profile_trace']))}")
    if sched is not None and (args.inject_faults or args.shed is not None
                              or args.deadline_ms is not None
                              or args.paranoid):
        rs = sched.robustness_stats()
        print(f"[serve] robustness: cancelled={rs['cancelled']} "
              f"expired={rs['expired']} shed={rs['shed']} "
              f"failed={rs['failed']} recovered={rs['recovered']} "
              f"faults_detected={rs['faults_detected']}")
        sched.check()    # the whole pool audit (raises on any leak)
        print("[serve] block-pool audit clean: refcounts, free list, and "
              "LRU partition the pool exactly")
    if args.journal_dir:
        print(durability_line(sched))
    n_tok = sum(len(r["tokens"]) for r in results if r)
    mgr = srv.manager
    if sched is None:
        steps = "static groups"
    elif sched.spec:
        steps = (f"{sched.windows_run} draft/verify windows of "
                 f"{sched.draft_w}")
    else:
        steps = f"{sched.decode_steps} decode steps"
    print(f"[serve] {n_tok} tokens in {wall:.2f}s ({n_tok / wall:.1f} tok/s, "
          f"{steps})")
    print(f"[serve] energy spent: {mgr.spent_j:.3e} J "
          f"({100 * (1 - mgr.remaining_fraction()):.0f}% of budget), "
          f"saver_mode={mgr._saver}")


if __name__ == "__main__":
    main()
