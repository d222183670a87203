"""End-to-end serving on the port (``examples/serve_adaptive_lm.py``):
a small LM behind the AdaptiveServer — batched prefill/decode, int8 KV
cache option, Profile Manager switching precision as the energy budget
drains.

The modeled per-inference energy uses the H100's figures
(``core/energy.py::H100_SXM``); the reference's 197 TFLOP/s is a TPU
figure. ``run(hw=TPU_V5E)`` gives the reference's.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_adaptive_lm \
          [--kv-bits 8] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.energy import H100_SXM, HWSpec, activity_factor, step_energy
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.manager import ProfileManager, ProfileStats
from repro_torch.core.profiles import paper_profiles
from repro_torch.models import transformer as T
from repro_torch.runtime import resolve_device
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig


def run(kv_bits: int = 16, requests: int = 8, device=None,
        params: Optional[dict] = None, hw: HWSpec = H100_SXM,
        seed: int = 0) -> dict:
    """Serve ``requests`` prompts in static groups; returns the results,
    the manager and the server. ``params`` default to weights from
    ``seed``."""
    device = resolve_device(device)
    cfg = get_smoke("granite-3-2b")
    if params is None:
        params = T.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(seed), device=device)
    names = T.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    engine = AdaptiveEngine(tuple(profs), QuantIndex(names))

    # modeled per-inference energy per profile → manager policy inputs
    t_est = 2.0 * T.param_count(params) / hw.peak_flops
    stats = []
    for p in profs:
        a, w = next(iter(p.bits.values()))
        acc = {8: 0.989, 4: 0.953}.get(w, 0.998)
        stats.append(ProfileStats(
            p.name, acc, step_energy(t_est, activity_factor(
                min(a, 16), min(w, 16), min(w, 16) / 16), hw=hw), t_est))
    mgr = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                         budget_j=stats[0].energy_j * 80, low_energy=0.5)

    srv = AdaptiveServer(cfg, params, engine,
                         ServingConfig(slots=128, kv_bits=kv_bits,
                                       max_batch=4), manager=mgr,
                         device=device)
    rng = np.random.default_rng(seed)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new=12, accuracy_critical=(i % 4 == 0))
            for i, n in enumerate(rng.integers(4, 20, requests))]
    results = srv.serve(reqs)
    for i, r in enumerate(results):
        print(f"req{i:02d}: {len(r['tokens'])} new tokens | "
              f"profiles {sorted(set(r['profile_trace']))}")
    print(f"\nkv_bits={kv_bits} (8 halves the decode memory-roofline term)"
          f"\nenergy: {mgr.spent_j:.2e} J spent, "
          f"{mgr.remaining_fraction()*100:.0f}% budget left, "
          f"saver_mode={mgr._saver}")
    return {"results": results, "manager": mgr, "server": srv}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-bits", type=int, default=16, choices=[8, 16])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(kv_bits=args.kv_bits, requests=args.requests,
               device=args.device)


if __name__ == "__main__":
    main()
