"""Per-tensor dynamic fake-quant: the Hopper kernel's wrapper (K5) and its
plain version.

:func:`aquant` replaces the Pallas TPU kernel ``aquant_pallas`` of
``repro/kernels/aquant.py``; source ``csrc/aquant.cu``, built and bound by
:mod:`repro_torch.kernels.build`. Over the whole tensor: ``amax`` floored at
1e-9, ``scale = amax / 2^(b−1)`` (with ``po2``: ``2^ceil(log2 scale)``),
round half away from zero, clip to the signed ``bits`` grid, arithmetic in
f32, written in ``x``'s type or, with ``out_dtype=torch.bfloat16``, as bf16
from an f32 ``x`` (the cast a bf16 caller makes, fused into the store). With
``return_scale`` the kernel also writes the scale it derived, which the
straight-through gradient's clip band needs. It is the per-tensor case of
:func:`repro_torch.core.quantizers.fake_quant_dynamic`, which calls it.

The kernel is one cooperative launch of a persistent grid with a grid-wide
barrier between the amax and the quantization; :func:`plan` decides its grid
and the share of ``x`` each block keeps on chip across the barrier (read
from device memory once where the tensor fits, twice above that). Its bound
is one read of ``x`` and one write of the output in the output's type.

The amax is shape-agnostic, so any contiguous shape goes through as a flat
array. The wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors — it never falls back from one to the other.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.qtypes import exp2_int
from repro_torch.kernels.build import SM_COUNT, lib

__all__ = ["aquant", "aquant_ref", "plan", "launch_plan", "Plan"]

THREADS = 512                 # threads of a block (csrc/aquant.cu)
VEC_BYTES = 16                # one load: a uint4
REG_VECS = 4 * THREADS        # vectors a block keeps in registers
TILE = 4 * THREADS            # vectors of one streamed tile (4 a thread)
SMEM_BYTES = 112 * 1024       # shared memory a block keeps x in (2 per SM)
_WS_WORDS = 8                 # one workspace: 6 counting words, padded
_WS_SLOTS = 64                # workspaces per device (one per stream)


class Plan(NamedTuple):
    """One call's launch: ``grid`` blocks; block ``b`` keeps vectors ``[b ·
    kept, (b + 1) · kept)`` of the aligned body on chip across the barrier
    (``kept = keep_smem + keep_reg``: the first ``keep_smem`` in shared
    memory, the rest in registers); the ``n_vec − grid · kept`` vectors
    after them (if any) are streamed in ``n_tiles`` tiles of ``TILE``
    vectors that the blocks claim, and read again after the barrier.
    ``head`` elements precede the body's first 16-byte boundary; ``tail``
    elements follow its last vector."""
    grid: int
    keep_smem: int
    keep_reg: int
    n_tiles: int
    head: int
    n_vec: int
    tail: int


@functools.lru_cache(maxsize=4096)
def plan(n: int, elt_bytes: int, sm_count: int, blocks_per_sm: int,
         smem_bytes: int, offset: int = 0) -> Plan:
    """The launch of one K5 call over ``n`` elements of ``elt_bytes`` whose
    first element sits ``offset`` elements past a 16-byte boundary: at most
    ``sm_count · blocks_per_sm`` co-resident blocks (one per ``THREADS``
    vectors for a small tensor; a lone block needs no grid barrier), each
    keeping an equal share of the body as far as ``smem_bytes`` of shared
    memory and then its registers hold it; the rest in tiles."""
    ve = VEC_BYTES // elt_bytes
    head = min(n, (-offset) % ve)
    n_vec = (n - head) // ve
    grid = max(1, min(sm_count * blocks_per_sm, -(-n_vec // THREADS)))
    kept = min(-(-n_vec // grid), smem_bytes // VEC_BYTES + REG_VECS)
    keep_smem = min(kept, smem_bytes // VEC_BYTES)
    n_tiles = -(-max(0, n_vec - grid * kept) // TILE)
    return Plan(grid, keep_smem, kept - keep_smem, n_tiles, head, n_vec,
                n - head - n_vec * ve)


def _out_dtype(x_dtype: torch.dtype, out_dtype) -> torch.dtype:
    """The output type of a call: ``x``'s own, or bf16 from f32. Any other
    pair is refused (bf16 → f32 would round twice against the plain
    version's ``.to`` chain)."""
    if out_dtype is None or out_dtype == x_dtype:
        return x_dtype
    if x_dtype == torch.float32 and out_dtype == torch.bfloat16:
        return out_dtype
    raise ValueError(f"aquant writes x's dtype, or bf16 from f32; not "
                     f"{x_dtype} -> {out_dtype}")


def _scale(amax: torch.Tensor, bits: int, po2: bool) -> torch.Tensor:
    """The grid's f32 scale from a tensor's ``max|x|``."""
    scale = amax.clamp_min(1e-9) / 2.0 ** (bits - 1)
    return exp2_int(torch.ceil(torch.log2(scale))) if po2 else scale


def aquant_ref(x: torch.Tensor, bits: int = 8, po2: bool = True,
               return_scale: bool = False, out_dtype=None):
    """Plain version (port of ``repro/kernels/ref.py::aquant_ref``): the
    reference's ``fake_quant`` numerics with an exact power-of-two scale,
    then ``.to(x.dtype).to(out_dtype)``. With ``return_scale``, also the
    0-d f32 scale of the grid."""
    out_dtype = _out_dtype(x.dtype, out_dtype)
    xf = x.float()
    half = 2.0 ** (bits - 1)
    scale = _scale(xf.abs().amax(), bits, po2)
    r = xf / scale
    q = torch.clamp(torch.sign(r) * torch.floor(torch.abs(r) + 0.5),
                    -half, half - 1.0)
    out = (q * scale).to(x.dtype).to(out_dtype)
    return (out, scale) if return_scale else out


_BLOCKS: dict = {}            # (device, x bf16, out bf16) -> blocks per SM
_WS: dict = {}                # device -> (workspace pool, {stream: slot})


def _blocks_per_sm(dev: torch.device, x_bf16: bool, out_bf16: bool) -> int:
    """Co-resident blocks per SM of the kernel for this dtype pair at
    ``SMEM_BYTES`` (the query also raises the kernel's shared-memory limit,
    which its launches need), once per device."""
    key = (dev.index, x_bf16, out_bf16)
    if key not in _BLOCKS:
        with torch.cuda.device(dev):
            got = lib("aquant").repro_aquant_blocks_per_sm(
                int(x_bf16), int(out_bf16), SMEM_BYTES)
        if got <= 0:
            raise RuntimeError(f"aquant occupancy query failed: CUDA error "
                               f"{-got}" if got else "aquant: no block fits")
        _BLOCKS[key] = got
    return _BLOCKS[key]


def _workspace(dev: torch.device, stream: int) -> int:
    """This stream's workspace (6 words, zero, left zero by every call).
    Work on one stream is ordered, so its calls never overlap; two streams
    never share one. A CUDA graph keeps the workspace of the stream it was
    captured on, so two graphs captured on one stream must not replay at
    once. The pool is zeroed when it is made, which cannot be inside a
    capture (the fill would run only at replay)."""
    if dev.index not in _WS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("aquant: call it once on this device before "
                               "capturing it in a CUDA graph")
        _WS[dev.index] = (torch.zeros(_WS_WORDS * _WS_SLOTS,
                                      dtype=torch.int32, device=dev), {})
    pool, slots = _WS[dev.index]
    if stream not in slots:
        if len(slots) == _WS_SLOTS:
            raise RuntimeError(f"aquant: more than {_WS_SLOTS} streams")
        slots[stream] = len(slots)
    return pool.data_ptr() + slots[stream] * _WS_WORDS * 4


def _offset(x: torch.Tensor) -> int:
    """Elements between the last 16-byte boundary and ``x``'s first."""
    elt = x.element_size()
    return (x.data_ptr() // elt) % (VEC_BYTES // elt)


def launch_plan(x: torch.Tensor, out_dtype=None) -> Plan:
    """:func:`plan` of :func:`aquant`'s launch on the contiguous CUDA
    tensor ``x``: the grid the kernel's occupancy allows on ``SM_COUNT``
    SMs with ``SMEM_BYTES`` of shared memory per block, at ``x``'s
    alignment."""
    bf16 = torch.bfloat16
    bps = _blocks_per_sm(x.device, x.dtype == bf16,
                         _out_dtype(x.dtype, out_dtype) == bf16)
    return plan(x.numel(), x.element_size(), SM_COUNT, bps, SMEM_BYTES,
                _offset(x))


def _empty_like_aligned(x: torch.Tensor, dtype, offset: int, ve: int):
    """An output for ``x`` whose first element sits ``offset`` elements past
    a 16-byte boundary of the input's vectors, as ``x``'s does, so the
    kernel's vector stores line up with its loads."""
    n = x.numel()
    out = torch.empty(n, dtype=dtype, device=x.device)
    elt = out.element_size()
    if (out.data_ptr() // elt) % ve != offset:
        buf = torch.empty(n + ve, dtype=dtype, device=x.device)
        o = (offset - buf.data_ptr() // elt) % ve
        out = buf[o:o + n]
    return out.view(x.shape)


def aquant(x: torch.Tensor, bits: int = 8, po2: bool = True,
           return_scale: bool = False, out_dtype=None):
    """Fake-quantize ``x`` onto its dynamic per-tensor ``bits`` grid (same
    shape; ``x``'s type, or ``out_dtype`` bf16 from f32); with
    ``return_scale``, also the grid's 0-d f32 scale, which the kernel
    writes beside its output (no second pass, no host sync). CPU tensors
    take the plain version; ``meta`` tensors are validated as CUDA ones,
    then take the plain version (shape arithmetic only: a meta tensor has
    no device to launch on); CUDA tensors launch the kernel (one
    cooperative launch, counted in ``aquant.launches``) or raise."""
    if x.device.type == "cpu":
        return aquant_ref(x, bits, po2, return_scale, out_dtype)
    if not 2 <= bits <= 16:
        raise ValueError(f"aquant supports bits 2..16, got {bits}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    out_dtype = _out_dtype(x.dtype, out_dtype)
    if x.device.type == "meta":
        return aquant_ref(x, bits, po2, return_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    xc = x.contiguous()
    n = xc.numel()
    out = _empty_like_aligned(xc, out_dtype, _offset(xc),
                              VEC_BYTES // xc.element_size())
    if n == 0:
        if return_scale:
            return out, _scale(torch.zeros((), device=x.device), bits, po2)
        return out
    scale = (torch.empty((), dtype=torch.float32, device=x.device)
             if return_scale else None)
    p = launch_plan(xc, out_dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib("aquant").repro_aquant(
        xc.data_ptr(), out.data_ptr(), _workspace(x.device, stream),
        None if scale is None else scale.data_ptr(), n,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(bits), int(bool(po2)), p.grid, p.keep_smem, p.keep_reg, p.head,
        stream)
    if err != 0:
        raise RuntimeError(f"aquant kernel launch failed: CUDA error {err}")
    aquant.launches += 1
    return (out, scale) if return_scale else out


aquant.launches = 0
