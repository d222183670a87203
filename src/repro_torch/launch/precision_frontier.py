"""Offline per-layer KV precision search → the ``--precision-policy`` file.

:meth:`~repro_torch.core.manager.ProfileManager.search_precision` walks
the bytes/accuracy frontier by lowering one layer's KV bit-width one rung
at a time (16 → 8 → 4), scoring each candidate schedule by its logit
deviation from the all-16 baseline on a fixed probe batch and costing it
by the analytic KV bytes one token stores. The winning schedule is a list
of ``n_layers`` ints, a row of the serving engine's precision policy.

  PYTHONPATH=src python -m repro_torch.launch.precision_frontier \
      --arch granite-3-2b --max-drop 0.05 --json policy.json [--device cpu]

The JSON feeds ``python -m repro_torch.launch.serve --precision-policy
policy.json`` (profile 0 keeps the all-16 row; the rest ride the
schedule). Its keys are those of the reference's
``benchmarks/precision_frontier.py``. Runs on the GPU unless ``--device
cpu`` is given; the probe prefill runs in f32 on either.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.manager import ProfileManager, ProfileStats
from repro_torch.core.profiles import paper_profiles
from repro_torch.models import transformer as T
from repro_torch.runtime import resolve_device, use_compute_dtype

__all__ = ["kv_bytes_per_token", "build_score_fn", "search", "main"]


def kv_bytes_per_token(cfg, sched) -> float:
    """Analytic KV bytes one token stores (K and V, all layers): each
    layer holds ``2 · n_kv · head_dim`` values at its own bit-width. The
    serving pool itself stays at ``kv_bits``; this is the cost the
    schedule would set on a pool sized per layer."""
    return float(sum(2 * cfg.n_kv * cfg.hd * int(b) / 8 for b in sched))


def build_score_fn(cfg, params, bits_row, probe_tokens: torch.Tensor,
                   slots: int = 32):
    """Proxy degradation: the mean last-token logit deviation from the
    all-16 row, relative to the baseline's mean magnitude. Every candidate
    is one prefill with ``kv_sched`` set; the all-16 row scores an exact
    0 (``kv_refine`` passes 16 through)."""
    batch = {"tokens": probe_tokens}

    def logits_of(sched):
        with use_compute_dtype(torch.float32):
            y, _ = T.prefill(params, cfg, bits_row, batch, slots,
                             kv_sched=sched)
        return y.double().cpu().numpy()

    base = logits_of(np.full((cfg.n_layers,), 16, np.int32))
    denom = float(np.abs(base).mean()) + 1e-12

    def score(sched) -> float:
        return float(np.abs(logits_of(sched) - base).mean()) / denom

    return score


def search(arch: str, max_drop: float, full: bool = False, seed: int = 0,
           *, device=None, params: Optional[dict] = None,
           n_layers: Optional[int] = None) -> dict:
    """Search ``arch``'s schedule (the published config with ``full``,
    else the smoke one; ``n_layers`` cuts its depth) on random weights
    from ``seed``, or on ``params`` where given, probing under the first
    paper profile's bits (A16-W8), as the reference does. Returns the JSON
    payload: ``schedule``, its ``score`` and ``bytes_per_token``, the
    all-16 bytes, and the accepted ``frontier``."""
    dev = resolve_device(device)
    cfg = get_config(arch) if full else get_smoke(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=int(n_layers))
    if not cfg.causal:
        raise SystemExit("encoder-only arch has no KV decode path")
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = T.init_params(cfg, gen, device=dev)
    names = T.quant_layer_names(cfg)
    eng = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                         QuantIndex(names))
    rng = np.random.default_rng(seed)
    probe = torch.as_tensor(
        rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32), device=dev)
    score_fn = build_score_fn(cfg, params, eng.table[0], probe)
    # the search is a ProfileManager method but needs no energy ledger
    mgr = ProfileManager([ProfileStats("hi", 0.99, 1.0, 1.0)],
                         accuracy_target=0.985, accuracy_floor=0.95,
                         budget_j=0.0)
    sched, frontier = mgr.search_precision(
        cfg.n_layers, score_fn, lambda s: kv_bytes_per_token(cfg, s),
        ladder=(16, 8, 4), max_drop=max_drop)
    return {
        "arch": arch, "n_layers": cfg.n_layers, "max_drop": max_drop,
        "schedule": [int(b) for b in sched],
        "score": frontier[-1]["score"],
        "bytes_per_token": frontier[-1]["bytes"],
        "bytes_per_token_all16": frontier[0]["bytes"],
        "frontier": frontier,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Search a per-layer KV bit-width schedule (16/8/4) on "
                    "the bytes/accuracy frontier; --json writes the "
                    "--precision-policy payload for "
                    "repro_torch.launch.serve.")
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCHS)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--max-drop", type=float, default=0.05,
                    help="proxy-score budget: max mean relative logit "
                         "deviation from the all-16 baseline (default "
                         "0.05)")
    ap.add_argument("--json", type=str, default=None, metavar="PATH",
                    help="write the searched schedule + frontier as JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = search(args.arch, args.max_drop, full=args.full, seed=args.seed,
                 device=args.device)
    print(f"# {args.arch}: schedule={out['schedule']} "
          f"score={out['score']:.4f} "
          f"bytes/token {out['bytes_per_token_all16']:.0f} -> "
          f"{out['bytes_per_token']:.0f} "
          f"({out['bytes_per_token']/out['bytes_per_token_all16']:.2f}x)")
    for st in out["frontier"]:
        print(f"frontier,{st['bytes']:.0f},{st['score']:.5f},"
              f"{'/'.join(str(b) for b in st['schedule'])}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"# json written to {args.json}", file=sys.stderr)


if __name__ == "__main__":
    main()
