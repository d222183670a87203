"""Quickstart: the paper's flow on the port (``examples/quickstart.py``).

1. Define a quantizable model (here: the granite-family smoke LM).
2. Build the paper's profile family (A16-W8 … A4-W4 + Mixed).
3. Merge them into ONE adaptive engine (MDC analogue): the profile is a
   row of the bits table picked at run time, not a new model.
4. Inspect the merge report (shared vs switched layers = resource sharing).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.configs import get_smoke
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.profiles import paper_profiles
from repro_torch.models import transformer as T
from repro_torch.runtime import resolve_device


def run(device=None, params: Optional[dict] = None,
        batch: Optional[dict] = None, seed: int = 0) -> dict:
    """The merge report and each profile's loss on one batch. ``params``
    and ``batch`` (``tokens``/``labels`` ``[2, 32]``) default to ones made
    from ``seed``."""
    device = resolve_device(device)
    cfg = get_smoke("granite-3-2b")
    if params is None:
        params = T.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(seed), device=device)
    print(f"model: {cfg.name}, {T.param_count(params)/1e6:.2f}M params")

    # per-layer quantization sites (the QONNX-graph analogue)
    names = T.quant_layer_names(cfg)
    print(f"quant sites: {len(names)} (first 6: {names[:6]})")

    # the paper's profiles; Mixed drops layer L1 to A4-W4
    inner = [n for n in names if n.startswith("L1.")]
    profs = paper_profiles(names, inner_layers=inner)

    engine = AdaptiveEngine(tuple(profs), QuantIndex(names),
                            lambda p, br, b: T.train_loss(p, cfg, br, b))
    report = engine.merge_report()
    print(f"merged engine: {report['n_layers']} sites, "
          f"{len(report['shared_layers'])} shared across all profiles, "
          f"sharing_ratio={report['sharing_ratio']:.2f}")

    if batch is None:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        batch = {k: torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                                  device=device)
                 for k in ("tokens", "labels")}
    losses = {}
    with torch.no_grad():
        for name in engine.profile_names:
            loss, _ = engine(params, engine.profile_id(name), batch)
            losses[name] = float(loss)
            print(f"  profile {name:7s}: loss {losses[name]:.4f}")
    print("one engine, six profiles — switching is a row of the bits table, "
          "not a new model.")
    return {"report": report, "losses": losses}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
