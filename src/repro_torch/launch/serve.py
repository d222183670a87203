"""Serving launcher for the port: the adaptive engine behind a Profile
Manager with an energy budget.

  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      [--requests 12 --max-new 32 --kv-bits 8 --seed 0]
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \
      [--no-paged-kv] [--speculate --draft-k 4 --draft-model ngram]

As in the reference launcher, ``--continuous`` decides the path. Without
it, the requests are served in static groups (``AdaptiveServer.serve``:
length-sorted groups of up to ``max_batch`` rows, one ragged generate per
group, on a contiguous KV cache). With it, they go through the continuous
scheduler's slot pool: the paged block pool, or contiguous rows with
``--no-paged-kv``. ``--speculate`` needs ``--continuous``.

Runs on the GPU unless ``--device cpu`` is given. ``--full`` serves the
published configuration (granite-3-2b: 40 layers, d_model 2048) with
prompts of 64–512 tokens, ``slots=1024`` and 8 rows; without it, the smoke
configuration with prompts of 4–23 tokens, ``slots=256`` and 4 rows.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core.energy import H100_SXM, HWSpec, activity_factor, step_energy
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.manager import ProfileManager, ProfileStats
from repro_torch.core.profiles import paper_profiles
from repro_torch.models import transformer as T
from repro_torch.runtime import resolve_device
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler

__all__ = ["profile_stats", "build_server", "serve", "main"]


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
    ap.add_argument("--no-paged-kv", dest="paged_kv", action="store_false",
                    help="continuous scheduler on contiguous [max_batch, "
                         "slots] KV rows instead of the paged block pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block of the paged pool")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="physical KV blocks (default: the contiguous "
                         "footprint)")
    ap.add_argument("--paged-backend", default="auto",
                    choices=["auto", "kernel", "gather"],
                    help="'kernel' attends in place through the paged-"
                         "attention kernel (and reads a contiguous kv8 "
                         "cache through the int8-KV decode kernel), "
                         "'gather' builds the dense per-segment view (and "
                         "reads a contiguous cache through the reference's "
                         "einsum), 'auto' = kernel on CUDA")
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
    ap.add_argument("--budget-inferences", type=float, default=200,
                    help="energy budget in units of full-power inferences")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    if args.speculate and not args.continuous:
        raise SystemExit("--speculate needs --continuous (draft/verify "
                         "windows run through the slot-pool segment)")
    return args


def build_server(args: argparse.Namespace):
    """Model, engine, manager and server for ``args`` → (cfg, server)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    names = T.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    engine = AdaptiveEngine(tuple(profs), QuantIndex(names))
    stats = profile_stats(cfg, profs, T.param_count(params))
    mgr = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                         budget_j=stats[0].energy_j * args.budget_inferences,
                         low_energy=0.5)
    scfg = ServingConfig(slots=1024 if args.full else 256,
                         kv_bits=args.kv_bits,
                         max_batch=8 if args.full else 4,
                         paged_kv=args.paged_kv,
                         block_size=args.block_size,
                         pool_blocks=args.pool_blocks,
                         paged_backend=args.paged_backend,
                         speculate=args.speculate, draft_k=args.draft_k,
                         draft_model=args.draft_model)
    return cfg, AdaptiveServer(cfg, params, engine, scfg, manager=mgr,
                               device=device)


def make_requests(cfg, args: argparse.Namespace) -> list[Request]:
    """``args.requests`` prompts from ``args.seed``; every third request is
    accuracy-critical, as in the reference launcher."""
    rng = np.random.default_rng(args.seed)
    lo, hi = (64, 513) if args.full else (4, 24)
    return [Request(tokens=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new=args.max_new, accuracy_critical=(i % 3 == 0))
            for i, n in enumerate(rng.integers(lo, hi, args.requests))]


def serve(srv: AdaptiveServer, reqs: list[Request], quantum: int, *,
          continuous: bool) -> dict:
    """Serve ``reqs``: through a fresh :class:`ContinuousScheduler` drained
    to the end (``continuous``), else in static groups
    (:meth:`AdaptiveServer.serve`). Returns the results (submission
    order), the scheduler (``None`` on the static path), and the wall
    time."""
    sched = None
    if continuous:
        sched = ContinuousScheduler(srv, quantum=quantum)
        for r in reqs:
            sched.submit(r)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    t0 = time.perf_counter()
    results = sched.run() if continuous else srv.serve(reqs)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    return {"results": results, "sched": sched,
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg, srv = build_server(args)
    out = serve(srv, make_requests(cfg, args), args.quantum,
                continuous=args.continuous)
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    head = (f"[serve] {cfg.name} on {srv.device} ({srv.paged_backend} "
            f"backend, kv{srv.scfg.kv_bits})")
    if sched is None:
        print(f"{head}: static groups of {srv.scfg.max_batch} rows, "
              f"contiguous KV cache")
    elif sched.paged:
        st = sched.paged_stats()
        print(f"{head}: peak {st['peak_used_blocks']}/{st['pool_blocks']} "
              f"blocks of {st['block_size']} tokens")
    else:
        print(f"{head}: contiguous pool of {sched.n_slots} rows")
    for i, r in enumerate(results):
        status = f" [{r['status'].value}]" if "status" in r else ""
        print(f"[serve] req{i}: {len(r['tokens'])} tokens{status}, "
              f"profiles used: {sorted(set(r['profile_trace']))}")
    n_tok = sum(len(r["tokens"]) for r in results)
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
