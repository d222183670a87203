"""Declarative per-scenario invariant budgets.

Port of ``repro/analysis/budgets.py``. Each :class:`SegmentBudget` pins a
reference geometry (the BENCH_4 paged-pool point, its kv8 and packed-kv4
twins, the BENCH_6 chaos point, and the BENCH_8 speculative
``draft_k``-wide point) on the granite smoke config, and the ceilings a
traced decode segment must respect there:

- ``max_out_bytes`` — no materialized op output in the segment's trace
  (:func:`repro_torch.analysis.op_check.trace_ops`) may exceed this;
- ``forbid_gather_view`` — no output may have ``(B, n_lblk*bs, Hkv)``
  as adjacent dims (named invariant ``no-gather-view``; see
  :func:`~repro_torch.analysis.op_check.has_adjacent_dims` for the third
  dim).

The ceilings are the port's own: the kernel path's largest output at each
point, measured on the card (``chip_smoke.py`` phase 20), plus the
reference's ~25 % headroom. On the CPU the kernel backend runs the
paged-attention kernel's plain version, which builds exactly the
``[B, n_lblk*bs, ...]`` view (``kernels/paged_attention.py::_dense_rows``),
so the kernel-path budgets are checked on the card only; on any device
the gather backend must trip the view check.

Where the ceiling sits below the gather view's bytes (one layer's
``[B, n_lblk*bs, Hkv, D]`` in the pool's dtype), the byte ceiling alone
already separates the backends. At the smoke vocabulary the logits can
outgrow the view (``view_separates`` False): at ``bench10-kv4`` the packed
view is half of kv8's, and at ``bench8-spec-kv8`` the ``[B, W, V]`` f32
verify logits are larger than the int8 view; there, as at the reference's
``bench10-kv4``, the no-gather-view check alone separates them.

Runtime ceilings enforced by the scenario audit
(``python -m repro_torch.analysis.check_static`` +
:class:`repro_torch.analysis.tracker.SchedulerAudit`):

- ``max-prefill-waves`` — at most :data:`MAX_PREFILL_WAVES_PER_ROUND`
  prefill waves (cold / shared / resume / chunk continuation) per
  ``admit()`` round;
- ``no-per-token-dispatch`` — the server's stepwise oracle
  (``generate_stepwise``) is never called by the fused serving path;
- ``single-segment-executable`` — at most
  :data:`SEGMENT_GRAPHS_PER_PROFILE` CUDA-graph capture of the decode step
  (a speculative scheduler's: of the draft/verify window) per profile id
  in use over a pool lifetime (so at most ``P``), where the reference
  compiles one executable with the profile id as data: the port's graphs
  read a profile's bf16 weight images by pointer;
- ``no-retrace`` — no capture after warm-up: an id already captured is
  never captured again in the lifetime.

Both capture checks run on a CUDA device, where the scheduler, greedy or
speculative, replays graphs (:mod:`repro_torch.serving.graphs`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.analysis import op_check

__all__ = ["MAX_PREFILL_WAVES_PER_ROUND", "SEGMENT_GRAPHS_PER_PROFILE",
           "SegmentBudget",
           "REFERENCE_BUDGETS", "smoke_parts", "segment_inputs",
           "trace_segment", "BudgetReport", "check_budget", "pool_carries"]

MAX_PREFILL_WAVES_PER_ROUND = 2
SEGMENT_GRAPHS_PER_PROFILE = 1


@dataclass(frozen=True)
class SegmentBudget:
    """Output-byte ceiling for a decode-segment trace at a fixed geometry."""

    name: str
    arch: str
    batch: int
    slots: int           # per-row token capacity
    block_size: int
    pool_blocks: int | None
    kv_bits: int
    steps: int
    max_out_bytes: int
    forbid_gather_view: bool = True
    draft_k: int = 0     # > 0: trace the speculative W = k+1 segment

    @property
    def slots_padded(self) -> int:
        return -(-self.slots // self.block_size) * self.block_size

    def view_dims(self, cfg) -> tuple[int, int, int]:
        """The gather view's signature ``(B, n_lblk*bs, Hkv)``."""
        return (self.batch, self.slots_padded, cfg.n_kv)

    def view_bytes(self, cfg) -> int:
        """One layer's gather view ``[B, n_lblk*bs, Hkv, D]`` in the
        pool's dtype (``D/2`` bytes per head at kv4)."""
        per_head = {16: 2 * cfg.hd, 8: cfg.hd, 4: cfg.hd // 2}[self.kv_bits]
        return self.batch * self.slots_padded * cfg.n_kv * per_head

    def view_separates(self, cfg) -> bool:
        """The byte ceiling alone catches a materialized view."""
        return self.max_out_bytes < self.view_bytes(cfg)


# Ceilings: the kernel path's largest output at each point on the card
# (chip_smoke.py phase 20 prints them), plus ~25 % headroom, rounded up
# to a KiB.
REFERENCE_BUDGETS: tuple[SegmentBudget, ...] = (
    # BENCH_4 paged-pool reference point: 64-block pool, bs=16, batch 8.
    SegmentBudget(name="bench4-kv16", arch="granite-3-2b", batch=8,
                  slots=128, block_size=16, pool_blocks=64, kv_bits=16,
                  steps=4, max_out_bytes=20_480),
    SegmentBudget(name="bench4-kv8", arch="granite-3-2b", batch=8,
                  slots=128, block_size=16, pool_blocks=64, kv_bits=8,
                  steps=4, max_out_bytes=20_480),
    # BENCH_10 packed-int4 point: same geometry, half the kv8 pool bytes.
    SegmentBudget(name="bench10-kv4", arch="granite-3-2b", batch=8,
                  slots=128, block_size=16, pool_blocks=64, kv_bits=4,
                  steps=4, max_out_bytes=20_480),
    # BENCH_6 chaos point: tiny 10-block pool under drought, batch 4.
    SegmentBudget(name="bench6-chaos-kv16", arch="granite-3-2b", batch=4,
                  slots=40, block_size=16, pool_blocks=10, kv_bits=16,
                  steps=4, max_out_bytes=10_240),
    # BENCH_8 speculative point: every activation in the verify window is
    # W = draft_k + 1 wide; the multi-query kernel folds W into its grid
    # instead of materializing per-query pool views.
    SegmentBudget(name="bench8-spec-kv8", arch="granite-3-2b", batch=8,
                  slots=128, block_size=16, pool_blocks=64, kv_bits=8,
                  steps=2, max_out_bytes=102_400, draft_k=4),
)


def smoke_parts(arch: str = "granite-3-2b", device=None, seed: int = 0):
    """``(cfg, params, engine)`` of the smoke config: random weights from
    ``seed`` and the paper's six profiles."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.models import transformer as T

    cfg = get_smoke(arch)
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    params = T.init_params(cfg, gen, device=device)
    names = T.quant_layer_names(cfg)
    eng = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                         QuantIndex(names))
    return cfg, params, eng


def segment_inputs(parts, budget: SegmentBudget, device=None) -> dict:
    """The arguments of one decode segment at the budget's geometry: an
    empty pool (``init_paged_caches``), zero tokens, positions and
    budgets, profile 0 at every step, and the per-profile weight images."""
    from repro_torch.models import transformer as T

    cfg, params, eng = parts
    b = budget.batch
    z = torch.zeros((b,), dtype=torch.int32, device=device)
    return dict(
        caches=T.init_paged_caches(cfg, b, budget.slots,
                                   kv_bits=budget.kv_bits,
                                   block_size=budget.block_size,
                                   pool_blocks=budget.pool_blocks,
                                   device=device),
        prequant=T.prequant_decode_weights(params, cfg, eng.table),
        schedule=[0] * budget.steps, tok0=z, pos0=z.clone(),
        remaining=[0] * b)


def run_segment(parts, backend: str, budget: SegmentBudget, inputs: dict):
    """One ``decode_segment`` (``decode_segment_spec`` at ``draft_k``)."""
    from repro_torch.models import transformer as T

    cfg, params, eng = parts
    args = (params, cfg, eng.table, inputs["schedule"], inputs["tok0"],
            inputs["pos0"], inputs["caches"], inputs["remaining"])
    if budget.draft_k:
        return T.decode_segment_spec(*args, prequant=inputs["prequant"],
                                     paged_backend=backend,
                                     draft_k=budget.draft_k)
    return T.decode_segment(*args, prequant=inputs["prequant"],
                            paged_backend=backend)


def trace_segment(parts, backend: str, budget: SegmentBudget,
                  device=None) -> op_check.OpTrace:
    """Trace ``decode_segment`` at the budget's geometry.

    ``parts`` is the ``(cfg, params, engine)`` triple of
    :func:`smoke_parts`. Returns the op trace; pair with
    :func:`~repro_torch.analysis.op_check.check_bytes_budget` /
    :func:`~repro_torch.analysis.op_check.has_adjacent_dims` to enforce
    the budget."""
    inputs = segment_inputs(parts, budget, device)
    with torch.no_grad():
        return op_check.trace_ops(run_segment, parts, backend, budget, inputs)


def pool_carries(kv) -> dict:
    """A stacked paged pool's per-layer K/V slices, the carries
    :func:`~repro_torch.analysis.op_check.verify_in_place` holds."""
    out = {}
    for l in range(kv.k.shape[0]):
        out[f"k[{l}]"], out[f"v[{l}]"] = kv.k[l], kv.v[l]
    return out


@dataclass(frozen=True)
class BudgetReport:
    budget: SegmentBudget
    backend: str
    max_bytes: int
    violations: tuple
    gather_view: bool
    transfers: op_check.Transfers

    @property
    def ok(self) -> bool:
        if self.violations:
            return False
        if self.budget.forbid_gather_view and self.gather_view:
            return False
        return True

    def render(self) -> str:
        status = "ok" if self.ok else "FAIL"
        lines = [
            f"[{status}] {self.budget.name} ({self.backend}): "
            f"max out {self.max_bytes:,} B / budget "
            f"{self.budget.max_out_bytes:,} B, gather view "
            f"{'present' if self.gather_view else 'absent'}, transfers "
            f"d2h {self.transfers.d2h} h2d {self.transfers.h2d} per segment"
        ]
        for v in self.violations[:5]:
            lines.append(f"    over budget: {v.render()}")
        if self.budget.forbid_gather_view and self.gather_view:
            lines.append(
                f"    gather view present: adjacent dims "
                f"({self.budget.batch}, {self.budget.slots_padded}, Hkv)"
            )
        return "\n".join(lines)


def check_budget(parts, budget: SegmentBudget, backend: str = "kernel",
                 device=None) -> BudgetReport:
    """Trace the segment at the budget point and evaluate every ceiling."""
    trace = trace_segment(parts, backend, budget, device)
    return BudgetReport(
        budget=budget,
        backend=backend,
        max_bytes=op_check.max_out_bytes(trace),
        violations=tuple(op_check.check_bytes_budget(trace,
                                                     budget.max_out_bytes)),
        gather_view=op_check.has_adjacent_dims(trace,
                                               budget.view_dims(parts[0])),
        transfers=op_check.count_transfers(trace),
    )
