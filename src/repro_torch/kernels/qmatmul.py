"""Dequant-matmul: the Hopper kernel's wrapper (K3) and its plain version.

:func:`qmatmul` replaces the Pallas TPU kernel ``qmatmul_pallas`` of
``repro/kernels/qmatmul.py``; source ``csrc/qmatmul.cu``, built and bound by
:mod:`repro_torch.kernels.build`. It computes ``x[M, K] @ dequant(w_q)[K,
N]`` with the reference's numerics: ``x`` rounded to bf16, each weight
dequantized as ``(q · scale)`` in f32 and then rounded to bf16, f32
accumulation, and an optional fused requant of the accumulator onto the
``out_bits`` grid of ``out_scale``.

Layout: ``w_q`` int8 ``[K, N]`` for bits 5–8, or packed int4 ``[K, N/2]``
for bits ≤ 4 (low nibble = even column); ``scale`` f32 ``[N]``; output f32
``[M, N]``. The kernel masks ragged M/K/N edges itself.

Decode (M ≤ 16) is bound by the weight bytes. Its kernel splits K: the grid
is column tiles (``split_plan``: 128 columns at int8, 256 at int4) times
K-splits of whole 64-row steps, a few blocks per SM, and each block streams
its int8/int4 rows through a 3-stage ``cp.async`` ring in shared memory and
dequantizes them into registers for ``mma.sync``. With more than one split,
each writes an f32 partial into scratch that this wrapper allocates, and a
second launch adds the partials in split order (no atomics: two calls are
bitwise equal) and applies the fused requant.

Prefill (M > 16) is bound by operations. Where TMA can describe the operands
(:func:`route_of`: bf16 x, K a multiple of 8, weight rows a multiple of 16
bytes, both bases 16-byte aligned) it runs the ``wgmma`` kernel: one block
per :func:`prefill_rows` × 128 output tile, a producer warp keeping a 4-stage
TMA ring of bf16 x and raw int8/int4 weight tiles in flight, and two
consumer warpgroups that dequantize each raw tile on chip into a swizzled
bf16 tile and multiply it with ``wgmma``. Every other prefill call (f32 x,
or strides TMA cannot describe) runs the ``mma.sync`` kernel, one block per
64 × 128 tile with no pipelining. Neither gives way to the other: a refused
build or launch raises.

The wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors — it never falls back from one to the other. The flattening,
scalar-scale and gradient wrapper is :func:`repro_torch.kernels.ops.qmatmul`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qtypes import unpack_int4
from repro_torch.kernels.build import SM_COUNT, check, lib, target

__all__ = ["qmatmul", "qmatmul_ref", "dequant_ref", "requant_ref",
           "split_plan", "route_of", "prefill_rows", "DECODE_ROWS",
           "STEP_ROWS", "MAX_SPLIT_STEPS", "WGMMA_COLS"]

DECODE_ROWS = 16              # M at or below which the split-K kernel runs
STEP_ROWS = 64                # K rows per ring stage of the split-K kernel
MAX_SPLIT_STEPS = 16          # steps per split at most (x's slice in smem)
PREFILL_COLS = 128            # columns per block of the mma.sync prefill
WGMMA_COLS = 128              # columns per block of the wgmma prefill
BLOCKS_PER_SM = 3             # the split planner's grid: at most 3 per SM


def split_plan(m: int, k: int, n: int, bits: int) -> tuple[int, int, int]:
    """``(columns per block, splits, K rows per split)`` of one call.

    Decode (``m <= DECODE_ROWS``): 128 columns per block at int8, 256 at
    int4 (128 weight bytes per row either way), and as many K-splits as
    bring the grid to at most ``BLOCKS_PER_SM · SM_COUNT`` blocks, but at
    least ``ceil(steps / MAX_SPLIT_STEPS)`` and at most one per 64-row step.
    Split ``s`` covers rows ``[s·per, min(k, (s + 1)·per))``: whole steps,
    only the last ragged, none empty. Prefill is never split."""
    if m > DECODE_ROWS:
        return PREFILL_COLS, 1, k
    cols = 256 if bits <= 4 else 128
    steps = -(-k // STEP_ROWS)
    if steps == 0:
        return cols, 1, STEP_ROWS
    tiles = max(1, -(-n // cols))
    want = max(1, BLOCKS_PER_SM * SM_COUNT // tiles)
    splits = min(steps, max(want, -(-steps // MAX_SPLIT_STEPS)))
    per = -(-steps // splits)
    return cols, -(-steps // per), per * STEP_ROWS


def route_of(m: int, k: int, n: int, bits: int, x_dtype,
             x_ptr: int = 0, w_ptr: int = 0) -> str:
    """The kernel a call runs: ``"splitk"`` for decode (``m <= 16``);
    ``"wgmma"`` for prefill whose operands TMA can describe — bf16 x, ``k``
    a positive multiple of 8 (x's row stride a multiple of 16 bytes), weight
    rows a multiple of 16 bytes (``n % 16`` at int8, ``n % 32`` at packed
    int4), both base pointers 16-byte aligned; ``"mma_sync"`` for every
    other prefill call (f32 x, or strides TMA cannot describe)."""
    if m <= DECODE_ROWS:
        return "splitk"
    row_bytes = n // 2 if bits <= 4 else n
    if (x_dtype == torch.bfloat16 and k > 0 and k % 8 == 0
            and row_bytes % 16 == 0 and x_ptr % 16 == 0
            and w_ptr % 16 == 0):
        return "wgmma"
    return "mma_sync"


def prefill_rows(m: int) -> int:
    """Output rows per block of the wgmma kernel (its tiles are 128 columns
    wide): 256, which dequantizes each weight tile once for 256 rows of x —
    the dequantization is what holds the kernel back, and on an H100 256-row
    tiles beat 128-row ones at every granite-3-2b linear, even where they
    leave the last wave part empty (``chip_smoke.py``'s prefill sweep) — or
    128 when ``m <= 128``, where a 256-row tile would multiply mostly zero
    rows."""
    return 256 if m > 128 else 128


def dequant_ref(w_q: torch.Tensor, scale, bits: int) -> torch.Tensor:
    """Dequantize an int8 carrier (packed two per byte when ``bits <= 4``)
    to f32; ``scale`` broadcasts against the dequantized ``[K, N]``."""
    q = unpack_int4(w_q) if bits <= 4 else w_q
    return q.float() * torch.as_tensor(scale, dtype=torch.float32,
                                       device=w_q.device)


def requant_ref(acc: torch.Tensor, out_scale, out_bits: int) -> torch.Tensor:
    """Static fixed-point requant: ``clip(round_half_away(acc / s)) · s`` at
    ``out_bits``."""
    qmax = 2.0 ** (out_bits - 1) - 1.0
    qmin = -(2.0 ** (out_bits - 1))
    s = torch.as_tensor(out_scale, dtype=torch.float32, device=acc.device)
    r = acc / s
    q = torch.clamp(torch.sign(r) * torch.floor(torch.abs(r) + 0.5),
                    qmin, qmax)
    return q * s


def qmatmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale, bits: int,
                out_scale=None, out_bits: Optional[int] = None
                ) -> torch.Tensor:
    """Plain version (port of ``repro/kernels/ref.py::qmatmul_ref``): the
    operands rounded to bf16 and multiplied in f32 — every product of two
    bf16 values is exact in f32, so only the order of the sums differs
    from the kernel — then the optional requant."""
    w = dequant_ref(w_q, scale, bits).bfloat16().float()
    acc = x.bfloat16().float() @ w
    if out_scale is not None:
        if out_bits is None:
            raise ValueError("out_scale needs out_bits")
        acc = requant_ref(acc, out_scale, out_bits)
    return acc


def qmatmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, *,
            bits: int = 8, out_bits: Optional[int] = None,
            out_scale: Optional[float] = None) -> torch.Tensor:
    """``x[M, K] @ dequant(w_q, scale)[K, N]`` → ``[M, N]`` f32. CPU
    tensors take the plain version; ``meta`` tensors are validated as CUDA
    ones, then take the plain version (shape arithmetic only); CUDA
    tensors launch the kernel that
    :func:`route_of` names (counted in ``qmatmul.launches``, once per call,
    also when a decode call launches the merge as well; named in
    ``qmatmul.last_route``) or raise."""
    if (out_bits is None) != (out_scale is None):
        raise ValueError("out_bits and out_scale go together")
    if x.device.type == "cpu":
        return qmatmul_ref(x, w_q, scale, bits, out_scale=out_scale,
                           out_bits=out_bits)
    if not 1 <= bits <= 8:
        raise ValueError(f"weight bits must be 1..8, got {bits}")
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"x and w_q must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(w_q.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    m, k = x.shape
    n = w_q.shape[1] * (2 if bits <= 4 else 1)
    on = target(x)
    check(x, "x", x.dtype, (m, k), on)
    check(w_q, "w_q", torch.int8, (k, w_q.shape[1]), on)
    check(scale, "scale", torch.float32, (n,), on)
    if on == "meta":
        return qmatmul_ref(x, w_q, scale, bits, out_scale=out_scale,
                           out_bits=out_bits)
    route = route_of(m, k, n, bits, x.dtype, x.data_ptr(), w_q.data_ptr())
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _, splits, per = split_plan(m, k, n, bits)
    part = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 and m * n else None)
    rows = prefill_rows(m) if route == "wgmma" else 0
    row_bytes = w_q.shape[1]
    vec_ok = int(w_q.data_ptr() % 16 == 0 and row_bytes % 16 == 0)
    requant = out_bits is not None
    qmax = float(2 ** (out_bits - 1) - 1) if requant else 0.0
    qmin = -float(2 ** (out_bits - 1)) if requant else 0.0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib("qmatmul").repro_qmatmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        int(x.dtype == torch.bfloat16), m, k, n, bits, int(requant), vec_ok,
        splits, per, rows, float(out_scale) if requant else 1.0, qmin, qmax,
        stream)
    if err != 0:
        raise RuntimeError(f"qmatmul kernel launch failed ({route}): CUDA "
                           f"error {err}")
    qmatmul.launches += 1
    qmatmul.last_route = route
    return out


qmatmul.launches = 0
qmatmul.last_route = None
