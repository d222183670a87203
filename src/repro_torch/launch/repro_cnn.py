"""The paper's experiment on the port (port of ``benchmarks/repro_cnn.py``):
Table 1 and Fig. 4 analogues, measured on the card.

  PYTHONPATH=src python -m repro_torch.launch.repro_cnn [--steps 120]
      [--device cpu] [--channels 64] [--json PATH]

Each paper profile trains separately from a shared init (QAT: K5 on every
quantizer's forward, the straight-through gradient behind it, the
reference's AdamW), as the paper builds one engine per configuration, with
the reference's seeds and sizes: 4096 hard training digits (seed 1), 2048
hard test digits (seed 2), batch 256, ``AdamConfig(lr=1e-3,
warmup_steps=10)``. Then:

* **Table 1**: test accuracy per profile on the fake path and through the
  profile's own native engine (integer weight images dequantized to f32);
  latency measured at batch 256 and 1 on both paths (CUDA events on the
  card; the host clock on the CPU, labelled so); weight-image bytes; power
  and energy per classification modelled under :data:`H100_SXM` from the
  measured batch-256 time per image. The reference holds latency constant
  across profiles (its FPGA schedule is precision-independent); here it is
  measured.
* **Fig. 4**: the merged adaptive engine (A8-W8 + Mixed: conv0 and fc
  shared, conv1 switched), its weight-byte overhead against the largest
  standalone engine, each profile's accuracy through it, and the battery
  simulation (classifications on a budget, adaptive against A8-W8 alone).

Everything runs in f32 with TF32 off, as the reference's CNN computes. It
writes nothing unless ``--json`` names a file. Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from repro_torch.core.energy import H100_SXM, activity_factor, step_energy
from repro_torch.core.manager import ProfileStats, battery_simulation
from repro_torch.core.merge import merge_plan
from repro_torch.core.profiles import paper_profiles, profile_table
from repro_torch.data.digits import batches, make_dataset
from repro_torch.models import cnn as C
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.runtime import resolve_device

__all__ = ["PAPER_TABLE1", "train_profile", "measure_ms", "profile_energy",
           "run_table1", "run_fig4", "main"]

# the paper's measured points (Table 1, KRIA FPGA), printed beside ours
PAPER_TABLE1 = {
    "A16-W8": {"acc": 98.9, "power_mw": 160},
    "A16-W4": {"acc": 95.3, "power_mw": 134},
    "A8-W8": {"acc": 98.8, "power_mw": 142},
    "A8-W4": {"acc": 95.3, "power_mw": 132},
    "A4-W4": {"acc": 95.8, "power_mw": 141},
}

BATCH = 256


def _inner_share(cfg: C.CNNConfig) -> float:
    """conv1's share of the network's multiply-accumulates."""
    s, c, k = cfg.size, cfg.channels, cfg.kernel
    macs = (s * s * k * k * cfg.in_ch * c
            + (s // 2) ** 2 * k * k * c * c + cfg.fc_in * cfg.n_classes)
    return (s // 2) ** 2 * k * k * c * c / macs


@contextlib.contextmanager
def _f32():
    """Convolutions and matmuls in true f32 on the card (no TF32)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _train_data():
    return make_dataset(4096, seed=1, difficulty="hard")


def _test_data():
    return make_dataset(2048, seed=2, difficulty="hard")


def train_profile(profile_idx: int, table, steps: int = 120, seed: int = 0,
                  device=None, channels: int = 64, data=None) -> dict:
    """QAT of one profile from the shared init (``seed``); ``data`` is the
    (images, labels) training set, rendered here when not given."""
    dev = resolve_device(device)
    cfg = C.CNNConfig(channels=channels)
    params = C.init_cnn(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    acfg = AdamConfig(lr=1e-3, total_steps=steps, warmup_steps=10)
    train_x, train_y = data if data is not None else _train_data()
    opt = adam_init(params)
    it = batches(train_x, train_y, BATCH, seed=3 + profile_idx)
    with _f32():
        for _ in range(steps):
            x, y = next(it)
            _, g = C.cnn_loss_and_grad(
                params, table[profile_idx],
                {"images": torch.as_tensor(x, device=dev),
                 "labels": torch.as_tensor(y, device=dev)})
            params, opt, _ = adam_update(acfg, g, opt, params)
    return params


@torch.no_grad()
def measure_ms(fn, device: torch.device, iters: int = 20,
               reps: int = 5) -> float:
    """Milliseconds per call of ``fn``: the median over ``reps`` windows of
    ``iters`` back-to-back calls, CUDA events around each window after a
    warm-up, on the card (the host's launch gaps included, as a caller
    sees them); one short window on the host clock on the CPU."""
    if device.type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        return (time.perf_counter() - t0) * 1e3 / 3
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def profile_energy(a_bits: int, w_bits: int,
                   latency_s: float) -> tuple[float, float]:
    """(power_w, energy_j) per classification under the activity model of
    :mod:`repro_torch.core.energy` on :data:`H100_SXM`."""
    mem_ratio = min(w_bits, 16) / 16.0
    act = activity_factor(min(a_bits, 16), min(w_bits, 16), mem_ratio)
    e = step_energy(latency_s, act, chips=1, hw=H100_SXM)
    return e / latency_s, e


def _selectors(plan, pi: int) -> list:
    return [plan.selector[ln][pi] for ln in C.CNN_LAYERS]


def _native_accuracy(params, plan, images, pi, bits_row, test_x,
                     test_y) -> float:
    sel = _selectors(plan, pi)
    return C.cnn_accuracy(params, bits_row, test_x, test_y, forward=lambda x:
                          C.cnn_forward_native(params, images, plan, sel,
                                               bits_row, x))


def run_table1(steps: int = 120, device=None, channels: int = 64) -> dict:
    """Train every paper profile and measure it. The result's ``rows`` map
    profile name → accuracy, latencies, bytes, modelled power and energy;
    ``params`` (kept out of the JSON) holds each profile's trained
    weights for :func:`run_fig4`."""
    dev = resolve_device(device)
    profs = paper_profiles(C.CNN_LAYERS, inner_layers=["conv1"])
    table = profile_table(profs, C.CNN_LAYERS)
    train = _train_data()
    test_x, test_y = _test_data()
    cfg = C.CNNConfig(channels=channels)
    shapes = C.cnn_weight_shapes(cfg)
    x256 = torch.as_tensor(test_x[:BATCH], device=dev)
    x1 = x256[:1]
    rows, params_by = {}, {}
    with _f32():
        for i, prof in enumerate(profs):
            t0 = time.perf_counter()
            params = train_profile(i, table, steps, device=dev,
                                   channels=channels, data=train)
            train_s = time.perf_counter() - t0
            params_by[prof.name] = params
            acc = C.cnn_accuracy(params, table[i], test_x, test_y)
            plan = merge_plan([prof])
            images = C.quantize_cnn_images(params, plan)
            acc_nat = _native_accuracy(params, plan, images, 0, table[i],
                                       test_x, test_y)
            lat = {}
            for b, x in ((BATCH, x256), (1, x1)):
                lat[f"fake_b{b}_ms"] = measure_ms(
                    lambda: C.cnn_forward(params, table[i], x), dev)
                lat[f"native_b{b}_ms"] = measure_ms(
                    lambda: C.cnn_forward_native(
                        params, images, plan, _selectors(plan, 0), table[i],
                        x), dev)
            per_image_s = lat[f"fake_b{BATCH}_ms"] * 1e-3 / BATCH
            ab, wb = prof.bits["conv0"]
            power_w, energy_j = profile_energy(ab, wb, per_image_s)
            if prof.name == "Mixed":      # inner conv at A4-W4: weighted
                p44, _ = profile_energy(4, 4, per_image_s)
                share = _inner_share(cfg)
                power_w = power_w * (1 - share) + p44 * share
                energy_j = power_w * per_image_s
            w_bytes = sum(int(np.prod(shapes[ln]))
                          * min(prof.bits[ln][1], 16) // 8
                          for ln in C.CNN_LAYERS)
            rows[prof.name] = {
                "accuracy_pct": round(acc * 100, 2),
                "native_accuracy_pct": round(acc_nat * 100, 2),
                "latency_us": per_image_s * 1e6,
                **lat,
                "weight_bytes": w_bytes,
                "power_w_model": power_w,
                "energy_j_model": energy_j,
                "train_s": train_s,
            }
            print(f"[table1] {prof.name:7s} acc {acc * 100:5.2f}% (native "
                  f"{acc_nat * 100:5.2f}%)  b256 {lat['fake_b256_ms']:.4f} "
                  f"ms (native {lat['native_b256_ms']:.4f})  b1 "
                  f"{lat['fake_b1_ms']:.4f} ms (native "
                  f"{lat['native_b1_ms']:.4f})  P={power_w:.1f}W  "
                  f"bytes={w_bytes}  train {train_s:.1f}s", flush=True)
    return {"rows": rows, "device": _device_name(dev),
            "clock": "cuda events" if dev.type == "cuda" else "host",
            "steps": steps, "channels": channels,
            "paper_reference": PAPER_TABLE1, "params": params_by}


def run_fig4(table1: dict) -> dict:
    """The merged adaptive engine (A8-W8 + Mixed) and the battery
    simulation, from :func:`run_table1`'s result."""
    profs = paper_profiles(C.CNN_LAYERS, inner_layers=["conv1"])
    by_name = {p.name: p for p in profs}
    pair = [by_name["A8-W8"], by_name["Mixed"]]
    plan = merge_plan(pair)
    cfg = C.CNNConfig(channels=table1["channels"])
    res = plan.resource_bytes(C.cnn_weight_shapes(cfg))
    pair_table = profile_table(pair, C.CNN_LAYERS)
    test_x, test_y = _test_data()
    merged_acc = {}
    with _f32():
        for pi, prof in enumerate(pair):
            params = table1["params"][prof.name]
            images = C.quantize_cnn_images(params, plan)
            merged_acc[prof.name] = round(100 * _native_accuracy(
                params, plan, images, pi, pair_table[pi], test_x, test_y), 2)
    rows = table1["rows"]
    stats = [ProfileStats(n, rows[n]["accuracy_pct"] / 100,
                          rows[n]["energy_j_model"],
                          rows[n]["latency_us"] * 1e-6)
             for n in ("A8-W8", "Mixed")]
    # the reference's budget: about 2M most-accurate classifications
    budget_j = stats[0].energy_j * 2_000_000
    adaptive = battery_simulation(stats, budget_j, accuracy_target=0.985,
                                  accuracy_floor=0.90, critical_every=10)
    fixed = battery_simulation(stats, budget_j, accuracy_target=0.985,
                               accuracy_floor=0.90, fixed_profile=0)
    out = {
        "merge": {"shared_layers": list(plan.shared_layers),
                  "switched_layers": list(plan.switched_layers),
                  "sharing_ratio": plan.sharing_ratio(), **res},
        "merged_native_accuracy_pct": merged_acc,
        "power_saving_pct": round(
            100 * (1 - stats[1].energy_j / stats[0].energy_j), 2),
        "accuracy_drop_pct": round(
            rows["A8-W8"]["accuracy_pct"] - rows["Mixed"]["accuracy_pct"], 2),
        "battery": {"adaptive": adaptive, "non_adaptive": fixed,
                    "extra_classifications_pct": round(
                        100 * (adaptive["classifications"]
                               / max(1, fixed["classifications"]) - 1), 2)},
    }
    return out


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="cpu to run without a GPU (default: cuda)")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--json", default=None,
                    help="write Table 1 and Fig. 4 to this file")
    args = ap.parse_args(argv)
    t1 = run_table1(steps=args.steps, device=args.device,
                    channels=args.channels)
    clock = "CUDA events" if t1["clock"] == "cuda events" else "host clock"
    print(f"\n=== Table 1 analogue (per-profile engines, {t1['device']}, "
          f"latency by {clock}) ===")
    print(f"{'profile':8s} {'acc%':>6s} {'nat%':>6s} {'lat_us':>8s} "
          f"{'b1_ms':>8s} {'P_model(W)':>10s} {'w_bytes':>8s}")
    for name, r in t1["rows"].items():
        print(f"{name:8s} {r['accuracy_pct']:6.2f} "
              f"{r['native_accuracy_pct']:6.2f} {r['latency_us']:8.3f} "
              f"{r['fake_b1_ms']:8.4f} {r['power_w_model']:10.3f} "
              f"{r['weight_bytes']:8d}")
    print("(paper, KRIA FPGA: A16-W8 98.9%@160mW … A8-W4 95.3%@132mW; "
          "latency constant across profiles)")
    f4 = run_fig4(t1)
    print("\n=== Fig. 4 analogue (adaptive engine: A8-W8 + Mixed) ===")
    m = f4["merge"]
    print(f"shared layers: {m['shared_layers']}  switched: "
          f"{m['switched_layers']}")
    print(f"merged-engine overhead vs largest standalone: "
          f"{m['overhead_vs_largest'] * 100:.1f}% (paper: 'limited "
          f"overhead')")
    print(f"merged engine accuracy: {f4['merged_native_accuracy_pct']}")
    print(f"profile switch: {f4['power_saving_pct']}% power saving at "
          f"{f4['accuracy_drop_pct']}% accuracy drop")
    b = f4["battery"]
    print(f"battery budget: adaptive {b['adaptive']['classifications']} vs "
          f"non-adaptive {b['non_adaptive']['classifications']} "
          f"classifications (+{b['extra_classifications_pct']}%)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"table1": {k: v for k, v in t1.items()
                                  if k != "params"}, "fig4": f4}, f, indent=1)
    return {"table1": t1, "fig4": f4}


if __name__ == "__main__":
    main()
