"""Decode attention over a contiguous int8 KV cache: the Hopper kernel's
wrapper and its plain version.

K4 :func:`qkv_attention` ← ``qkv_attention_pallas``
(``repro/kernels/qkv_attention.py``), source ``csrc/qkv_attention.cu``,
built and bound by :mod:`repro_torch.kernels.build` like the port's other
kernels.

The function, per GQA group ``g`` (one row's KV head) with ``len = lengths[g]``:
dequantize ``K = k_q·ks`` and ``V = v_q·vs``, scores ``(q·Kᵀ)·D^-½``, mask
``col < len``, softmax over the S columns, output ``p·V`` in f32. A group of
length 0 has every column masked, so — as in the Pallas kernel — its weights
are uniform and its output is the mean of the dequantized V over all S
columns.

Two layouts:

* the Pallas kernel's, for :func:`qkv_attention_ref`: q ``[G, Hg, D]``,
  k_q/v_q ``[G, S, D]`` int8, scales ``[G]``, lengths ``[G]``;
* the contiguous cache's own (:class:`repro_torch.models.attention.KVCache`),
  for :func:`qkv_attention`: q ``[B, Hkv, Hg, D]``, k/v ``[B, S, Hkv, D]``
  int8, scales ``[B, Hkv]``, lengths ``[B, Hkv]``, out ``[B, Hkv, Hg, D]``
  f32. The kernel reads the cache through its strides: nothing transposes
  the cache per call.

The kernel is split-context: each group's S columns are cut into 64-column
tiles (:data:`TILE_COLS`) and the tiles into contiguous splits
(:func:`split_plan`, from B, Hkv and S alone: the lengths stay on the
device, so a call can be captured in a CUDA graph), one block per (group,
split). A split at or past its group's length returns at once; the others
stream their raw int8 K/V rows through a cp.async ring and write an f32
``(m, l, acc)`` partial into scratch allocated here, which a second launch
merges in split order (no atomics: two calls are bitwise equal). q·K runs
on the bf16 tensor cores for bf16 q with D a multiple of 16, else on the
f32 CUDA cores (:func:`route_of`). Each call counts one launch
(``qkv_attention.launches``), though it makes two CUDA launches when it
has more than one split.

The wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors — it never falls back from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import SM_COUNT, build
from repro_torch.kernels.build import check as _check

__all__ = ["qkv_attention", "qkv_attention_ref", "qkv_attention_cache_ref",
           "supports", "split_plan", "route_of", "MAX_D", "MAX_HG",
           "TILE_COLS", "MAX_SPLIT_TILES"]

NEG_INF = -1e30
MAX_D, MAX_HG = 256, 16
TILE_COLS = 64                # cache columns per tile
MAX_SPLIT_TILES = 2           # tiles a split walks: the ring's prologue
                              # (3 stages) has all of them in flight
BLOCKS_PER_SM = 4             # the split planner's grid: about 4 per SM
# the C entry's route codes; "serial" is the first port's kernel (one
# block per group), which no call takes unless ``route_of`` is set aside
ROUTES = {"cuda_cores": 0, "tensor_cores": 1, "serial": 2}


def supports(d: int, hg: int) -> Optional[str]:
    """Why K4 cannot take head dim ``d`` with ``hg`` query heads per KV
    head (it copies at least four int8 values at a time and keeps the
    query rows of a group in one 16-row tile), or ``None`` when it can. The
    wrapper calls it before any build, and
    :class:`~repro_torch.serving.engine.AdaptiveServer` at construction."""
    if d % 4 or not 4 <= d <= MAX_D:
        return f"head dim D={d} must be a multiple of 4 and at most {MAX_D}"
    if not 1 <= hg <= MAX_HG:
        return f"Hg={hg} query heads per KV head must be 1..{MAX_HG}"
    return None


def split_plan(b: int, hkv: int, s: int) -> tuple[int, int]:
    """``(splits, tiles per split)`` for ``b·hkv`` groups of ``s`` cache
    columns: enough splits for a grid of about ``BLOCKS_PER_SM·SM_COUNT``
    blocks (one wave at 4 blocks per SM), at least ``ceil(n_tiles /
    MAX_SPLIT_TILES)`` (a long row's tiles are walked in parallel) and at
    most one per tile. Split ``i`` covers column tiles ``[i·per,
    min(n_tiles, (i + 1)·per))``; no split is empty."""
    n_tiles = -(-s // TILE_COLS)
    if n_tiles == 0:
        return 1, 1
    want = -(-BLOCKS_PER_SM * SM_COUNT // max(1, b * hkv))
    splits = min(n_tiles, max(want, -(-n_tiles // MAX_SPLIT_TILES)))
    per = -(-n_tiles // splits)
    return -(-n_tiles // per), per


def route_of(q_dtype: torch.dtype, d: int) -> str:
    """Where q·K runs: ``"tensor_cores"`` (mma.sync bf16, f32 sums) for
    bf16 q with ``d`` a multiple of 16, else ``"cuda_cores"`` (f32)."""
    if q_dtype == torch.bfloat16 and d % 16 == 0:
        return "tensor_cores"
    return "cuda_cores"


def qkv_attention_ref(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 in the Pallas kernel's layout (q ``[G, Hg, D]``,
    k_q/v_q ``[G, S, D]``, scales and lengths ``[G]``): dequantize first,
    ``(q·Kᵀ)·D^-½``, mask ``col < len``, softmax, ``·V``. Returns
    ``[G, Hg, D]`` f32."""
    d = q.shape[-1]
    s = k_q.shape[1]
    kf = k_q.float() * k_scale.float().reshape(-1, 1, 1)
    vf = v_q.float() * v_scale.float().reshape(-1, 1, 1)
    scores = torch.einsum("ghd,gsd->ghs", q.float(), kf) * d ** -0.5
    col = torch.arange(s, device=q.device)
    keep = col[None, :] < lengths.reshape(-1, 1).to(torch.int64)
    scores = torch.where(keep[:, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("ghs,gsd->ghd", p, vf)


def qkv_attention_cache_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_scale: torch.Tensor,
                            v_scale: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """:func:`qkv_attention_ref` on the contiguous cache's layout (q
    ``[B, Hkv, Hg, D]``, k/v ``[B, S, Hkv, D]``, scales and lengths
    ``[B, Hkv]``): groups are ``(row, KV head)`` pairs. Returns
    ``[B, Hkv, Hg, D]`` f32."""
    b, hkv, hg, d = q.shape
    s = k.shape[1]

    def groups(x):
        return x.permute(0, 2, 1, 3).reshape(b * hkv, s, d)

    out = qkv_attention_ref(q.reshape(b * hkv, hg, d), groups(k), groups(v),
                            k_scale.reshape(-1), v_scale.reshape(-1),
                            lengths.reshape(-1))
    return out.reshape(b, hkv, hg, d)


def qkv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  k_scale: torch.Tensor, v_scale: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over the contiguous int8 cache (layout in the module
    docstring). Returns ``[B, Hkv, Hg, D]`` f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    ``qkv_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return qkv_attention_cache_ref(q, k, v, k_scale, v_scale, lengths)
    b, hkv, hg, d = q.shape
    s = k.shape[1]
    why = supports(d, hg)
    if why is not None:
        raise ValueError(f"unsupported shape: {why}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    _check(q, "q", q.dtype, (b, hkv, hg, d))
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.int8:
            raise ValueError(f"{name} must be an int8 tensor on {q.device}")
        if tuple(t.shape) != (b, s, hkv, d):
            raise ValueError(f"{name} must have shape {(b, s, hkv, d)}, "
                             f"got {tuple(t.shape)}")
        # cp.async of at least 4 bytes: D contiguous, rows 4-byte aligned
        if (t.stride(3) != 1 or t.data_ptr() % 4
                or any(x % 4 for x in t.stride()[:3])):
            raise ValueError(f"{name} must have a contiguous D axis and "
                             f"4-byte aligned rows")
    _check(k_scale, "k_scale", torch.float32, (b, hkv))
    _check(v_scale, "v_scale", torch.float32, (b, hkv))
    _check(lengths, "lengths", torch.int32, (b, hkv))
    splits, per = split_plan(b, hkv, s)
    out = torch.empty((b, hkv, hg, d), dtype=torch.float32, device=q.device)
    part = ml = None
    if splits > 1:
        part = torch.empty((b * hkv * splits, hg, d), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((b * hkv * splits, hg, 2), dtype=torch.float32,
                         device=q.device)
    lib = build()["qkv_attention"]["lib"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_qkv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if ml is None else ml.data_ptr(),
        int(q.dtype == torch.bfloat16), ROUTES[route_of(q.dtype, d)], b, hkv,
        hg, d, s, splits, per, k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"int8-KV decode-attention kernel launch failed: "
                           f"CUDA error {err}")
    qkv_attention.launches += 1
    return out


qkv_attention.launches = 0
