"""Roofline-derived latency/energy model (copy of ``repro/core/energy.py``).

``TPU_V5E`` keeps the reference's constants so ledger parity tests compare
like with like; ``H100_SXM`` is the port's own spec, used by its launcher.

The paper reports measured mW on a KRIA FPGA; this container has no TPU, so the
Profile Manager and the Fig.3/Fig.4 reproductions run on a documented *model*
(DESIGN §2, §9):

  T_est  = max(compute_term, memory_term, collective_term)          [s]
  E_step = T_est * (P_static + P_dyn_peak * activity(profile))      [J]

``activity`` scales the dynamic power with datapath bit-activity, the standard
first-order switching model (energy/MAC ∝ a_bits × w_bits) that underlies the
paper's measured power drop at reduced precision; memory activity scales with
bytes moved (weight-only quant reduces it). All constants are module-level and
overridable so the model is auditable.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HWSpec", "TPU_V5E", "H100_SXM", "roofline_terms", "step_energy", "activity_factor"]


@dataclasses.dataclass(frozen=True)
class HWSpec:
    """Per-chip hardware constants used by roofline + energy model."""

    name: str
    peak_flops: float          # bf16 FLOP/s
    hbm_bw: float              # B/s
    ici_bw: float              # B/s per link
    p_static: float            # W, idle/leakage+infra share
    p_dyn_peak: float          # W, dynamic at full-precision full utilization
    vmem_bytes: int = 128 * 2**20  # v5e VMEM (128 MiB)
    hbm_bytes: int = 16 * 2**30


# Brief-specified constants: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI.
TPU_V5E = HWSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    p_static=70.0,
    p_dyn_peak=130.0,
)

# NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3,
# 450 GB/s NVLink each way, 700 W board power (static share assumed 30%),
# 80 GB HBM, 227 KB of shared memory per SM standing in for VMEM.
H100_SXM = HWSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    p_static=210.0,
    p_dyn_peak=490.0,
    vmem_bytes=227 * 2**10,
    hbm_bytes=80 * 10**9,
)


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int, hw: HWSpec = TPU_V5E) -> dict:
    """The three roofline terms in seconds (brief §ROOFLINE formulas).

    ``flops``/``hbm_bytes``/``coll_bytes`` are *global* (whole-step, all chips).
    """
    c = max(1, chips)
    t_comp = flops / (c * hw.peak_flops)
    t_mem = hbm_bytes / (c * hw.hbm_bw)
    t_coll = coll_bytes / (c * hw.ici_bw)
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["t_step_s"] = max(t_comp, t_mem, t_coll)
    return terms


def activity_factor(mean_a_bits: float, mean_w_bits: float,
                    mem_bytes_ratio: float = 1.0,
                    compute_share: float = 0.6) -> float:
    """Relative dynamic-power activity of a profile vs full bf16 execution.

    ``compute_share`` splits dynamic power between datapath switching (scales
    with a_bits×w_bits, the multiplier-activity model) and data movement
    (scales with bytes moved, i.e. weight-quantization ratio).
    """
    mac = (min(mean_a_bits, 16.0) * min(mean_w_bits, 16.0)) / (16.0 * 16.0)
    return compute_share * mac + (1.0 - compute_share) * mem_bytes_ratio


def step_energy(t_step_s: float, act: float, chips: int = 1, hw: HWSpec = TPU_V5E) -> float:
    """Energy of one step in joules under the activity model."""
    return t_step_s * chips * (hw.p_static + hw.p_dyn_peak * act)
