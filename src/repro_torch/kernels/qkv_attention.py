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

The wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors — it never falls back from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import build
from repro_torch.kernels.build import check as _check

__all__ = ["qkv_attention", "qkv_attention_ref", "qkv_attention_cache_ref",
           "supports", "MAX_D", "MAX_HG"]

NEG_INF = -1e30
MAX_D, MAX_HG = 256, 16


def supports(d: int, hg: int) -> Optional[str]:
    """Why K4 cannot take head dim ``d`` with ``hg`` query heads per KV
    head (it loads four int8 values per thread and keeps one accumulator row
    per query head), or ``None`` when it can. The wrapper calls it before
    any build, and :class:`~repro_torch.serving.engine.AdaptiveServer` at
    construction."""
    if d % 4 or not 4 <= d <= MAX_D:
        return f"head dim D={d} must be a multiple of 4 and at most {MAX_D}"
    if not 1 <= hg <= MAX_HG:
        return f"Hg={hg} query heads per KV head must be 1..{MAX_HG}"
    return None


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
        # char4 loads: D contiguous and every row start 4-byte aligned
        if (t.stride(3) != 1 or t.data_ptr() % 4
                or any(x % 4 for x in t.stride()[:3])):
            raise ValueError(f"{name} must have a contiguous D axis and "
                             f"4-byte aligned rows")
    _check(k_scale, "k_scale", torch.float32, (b, hkv))
    _check(v_scale, "v_scale", torch.float32, (b, hkv))
    _check(lengths, "lengths", torch.int32, (b, hkv))
    out = torch.empty((b, hkv, hg, d), dtype=torch.float32, device=q.device)
    lib = build()["qkv_attention"]["lib"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_qkv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, hkv, hg, d, s,
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"int8-KV decode-attention kernel launch failed: "
                           f"CUDA error {err}")
    qkv_attention.launches += 1
    return out


qkv_attention.launches = 0
