"""The paper's end-to-end scenario (§4) on the port
(``examples/adaptive_cnn.py``): QAT the tiny CNN at several ``Ax-Wy``
profiles on digit classification, merge A8-W8 + Mixed into an adaptive
engine, and run it against a battery budget with the Profile Manager —
the Table 1 / Fig. 4 story, through ``launch/repro_cnn.py``.

``--force`` is accepted for the reference's command line and does
nothing: the port's launcher keeps no ``artifacts/`` cache, every run
trains.

Run:  PYTHONPATH=src python -m repro_torch.examples.adaptive_cnn \
          [--steps 120] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch import repro_cnn


def run(steps: int = 120, device=None, channels: int = 64) -> dict:
    t1 = repro_cnn.run_table1(steps=steps, device=device, channels=channels)
    print("\n=== Table 1 analogue (per-profile engines) ===")
    print(f"{'profile':8s} {'acc%':>6s} {'lat_us':>7s} {'P_model(W)':>10s} "
          f"{'w_bytes':>8s}")
    for name, r in t1["rows"].items():
        print(f"{name:8s} {r['accuracy_pct']:6.2f} {r['latency_us']:7.3f} "
              f"{r['power_w_model']:10.3f} {r['weight_bytes']:8d}")
    print("(paper reference: A16-W8 98.9%@160mW … A8-W4 95.3%@132mW; "
          "latency constant across profiles)")

    f4 = repro_cnn.run_fig4(t1)
    print("\n=== Fig. 4 analogue (adaptive engine: A8-W8 + Mixed) ===")
    m = f4["merge"]
    print(f"shared layers: {m['shared_layers']}  switched: "
          f"{m['switched_layers']}")
    print(f"merged-engine overhead vs largest standalone: "
          f"{m['overhead_vs_largest']*100:.1f}% (paper: 'limited overhead')")
    print(f"profile switch: {f4['power_saving_pct']}% power saving at "
          f"{f4['accuracy_drop_pct']}% accuracy drop")
    b = f4["battery"]
    print(f"battery budget: adaptive {b['adaptive']['classifications']} vs "
          f"non-adaptive {b['non_adaptive']['classifications']} "
          f"classifications (+{b['extra_classifications_pct']}%)")
    return {"table1": t1, "fig4": f4}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--force", action="store_true",
                    help="accepted for the reference's command line; the "
                         "port keeps no cache, so every run trains")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(steps=args.steps, device=args.device)


if __name__ == "__main__":
    main()
