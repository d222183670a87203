"""Attention: GQA prefill, block-skipping sliding-window prefill, cached
decode, and the paged KV pool (port of ``repro/models/attention.py``).

Caches are updated **in place** (the reference threads them through donated
jit carries; here the owner keeps one set of tensors). Stacked ``[L, ...]``
caches expose per-layer views through ``.layer(l)``: writes to a view land
in the stack.

Out-of-range writes. JAX's ``.at[...].set(mode="drop")`` drops writes to
unmapped block-table entries; torch indexing would raise or wrap. The paged
pool therefore carries one extra physical block past ``n_blocks``: the
**write sink**. A write whose table entry is unmapped (``< 0`` or
``>= n_blocks``) is redirected there. Nothing ever reads the sink — readers
test ``0 <= entry < n_blocks`` and fill unmapped blocks as empty.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.qtypes import pack_int4, unpack_int4

from .pshard import constrain

__all__ = ["gqa_attention", "swa_attention", "prefix_attention",
           "decode_attention", "decode_attention_window", "KVCache",
           "init_kv_cache", "kv_scale", "update_kv_cache",
           "update_kv_cache_window", "PagedKVCache", "init_paged_kv_cache",
           "update_paged_kv_cache", "update_paged_kv_cache_window",
           "paged_view", "paged_decode_attention",
           "paged_decode_attention_window", "stack_layers", "kv_refine"]

NEG_INF = -1e30


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, block_k: int = 512,
                  kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blockwise GQA attention with an online softmax over key blocks.

    q ``[B, S, H, D]``; k/v ``[B, Skv, Hkv, D]``; returns ``[B, S, H, D]``.
    ``window`` masks keys further back than it (full attention when
    ``>= Skv``); ``kv_valid [B, Skv]`` masks per-row invalid (left-pad) keys.
    Scores and the accumulator are f32 (the reference's
    ``preferred_element_type``).
    """
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    hg = h // hkv
    bk = min(block_k, skv)
    n_blk = -(-skv // bk)
    qh = (q * (d ** -0.5)).to(q.dtype).reshape(b, s, hkv, hg, d)
    qh = qh.permute(0, 2, 3, 1, 4).float()                 # [B, Hkv, Hg, S, D]
    # sequence-sharded attention compute: S over "tp" (GQA head counts
    # rarely divide the model axis); KV replicated across the s-shards
    qh = constrain(qh, "dp", None, None, "tp", None)
    kb = constrain(k.permute(0, 2, 1, 3),                 # [B, Hkv, Skv, D]
                   "dp", None, None, None)
    vb = constrain(v.permute(0, 2, 1, 3), "dp", None, None, None)
    win = skv + s if window is None else int(window)
    dev = q.device
    qpos = q_offset + torch.arange(s, dtype=torch.int64, device=dev)
    m = constrain(torch.full((b, hkv, hg, s, 1), NEG_INF, device=dev),
                  "dp", None, None, "tp", None)
    l = constrain(torch.zeros((b, hkv, hg, s, 1), device=dev),
                  "dp", None, None, "tp", None)
    acc = constrain(torch.zeros((b, hkv, hg, s, d), device=dev),
                    "dp", None, None, "tp", None)
    for blk in range(n_blk):
        j0 = blk * bk
        kblk = kb[:, :, j0:j0 + bk].to(q.dtype).float()
        vblk = vb[:, :, j0:j0 + bk].float()
        w = kblk.shape[2]
        scores = torch.einsum("bkgsd,bkud->bkgsu", qh, kblk)
        jpos = j0 + torch.arange(w, dtype=torch.int64, device=dev)
        if causal:
            keep = (jpos[None, :] <= qpos[:, None]) & \
                   (qpos[:, None] - jpos[None, :] < win)     # [S, w]
        else:
            keep = torch.ones((s, w), dtype=torch.bool, device=dev)
        if kv_valid is not None:
            keep = keep[None] & kv_valid[:, None, j0:j0 + w]  # [B, S, w]
            keep = keep[:, None, None]
        else:
            keep = keep[None, None, None]
        scores = torch.where(keep, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgsu,bkud->bkgsd", p, vblk)
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, block_q: int = 512,
                  kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sliding-window self-attention with block skipping: each query block
    of ``block_q`` rows attends to the ``window + block_q`` keys it can
    see, so work and peak memory grow with ``S·(window + block_q)``, not
    ``S²``.

    q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]``; returns ``[B, S, H, D]``.
    ``kv_valid [B, S]`` masks per-row left-pad keys. The reference's own
    arithmetic: q is scaled in f32 (not rounded back to ``q.dtype`` as in
    :func:`gqa_attention`), keys and values are read in f32, and each
    block takes a plain softmax over its slice.
    """
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    assert s == skv, "swa_attention is self-attention prefill"
    hg = h // hkv
    bq = min(block_q, s)
    pad_q = (-s) % bq
    nq = (s + pad_q) // bq
    w = int(window)
    width = w + bq                     # the keys one query block can see
    dev = q.device
    qh = q.float() * d ** -0.5
    qh = torch.nn.functional.pad(qh, (0, 0, 0, 0, 0, pad_q))
    qh = qh.reshape(b, nq, bq, hkv, hg, d).permute(1, 0, 3, 4, 2, 5)
    qh = constrain(qh, None, "dp", None, None, "tp", None)
    # keys left-padded by the window, so block i's slice starts at i·bq
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, w, pad_q))
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, w, pad_q))
    kp = constrain(kp, "dp", None, None, None)
    vp = constrain(vp, "dp", None, None, None)
    kvp = (None if kv_valid is None else
           torch.nn.functional.pad(kv_valid, (w, pad_q)))   # pads invalid
    out = torch.empty((nq, b, hkv, hg, bq, d), device=dev)
    for i in range(nq):
        j0 = i * bq
        ks = kp[:, j0:j0 + width].permute(0, 2, 1, 3)       # [B, Hkv, W, D]
        vs = vp[:, j0:j0 + width].permute(0, 2, 1, 3)
        scores = torch.einsum("bkgsd,bkud->bkgsu", qh[i], ks)
        qpos = j0 + torch.arange(bq, device=dev)
        jpos = j0 - w + torch.arange(width, device=dev)
        keep = ((jpos[None, :] >= 0) & (jpos[None, :] <= qpos[:, None])
                & (qpos[:, None] - jpos[None, :] < w)
                & (qpos[:, None] < s) & (jpos[None, :] < s))  # [bq, W]
        keep = keep[None, None, None]
        if kvp is not None:
            keep = keep & kvp[:, None, None, None, j0:j0 + width]
        scores = torch.where(keep, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out[i] = torch.einsum("bkgsu,bkud->bkgsd", p, vs)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, s + pad_q, h, d)
    return out[:, :s].to(q.dtype)


def prefix_attention(q: torch.Tensor, k_pre: torch.Tensor,
                     v_pre: torch.Tensor, k_suf: torch.Tensor,
                     v_suf: torch.Tensor, *, positions: torch.Tensor,
                     prefix_len: torch.Tensor,
                     suffix_valid: torch.Tensor) -> torch.Tensor:
    """Continuation-prefill attention: suffix queries against
    ``[prefix ++ suffix]`` keys, as a dense masked softmax in f32.

    ``q [B, S, H, D]`` and ``k_suf``/``v_suf [B, S, Hkv, D]`` are the
    left-padded suffix projections; ``k_pre``/``v_pre [B, Pp, Hkv, D]`` the
    prefix keys and values, zero past ``prefix_len[row]``; ``positions
    [B, S]`` the suffix tokens' absolute positions (negative on pads) and
    ``suffix_valid [B, S]`` the pad mask. Prefix key ``j`` sits at absolute
    position ``j``. Full causal attention only.
    """
    b, s, h, d = q.shape
    pp, hkv = k_pre.shape[1], k_pre.shape[2]
    hg = h // hkv
    qh = (q.float() * d ** -0.5).reshape(b, s, hkv, hg, d)
    qh = qh.permute(0, 2, 3, 1, 4)                        # [B, Hkv, Hg, S, D]
    kc = torch.cat([k_pre.float(), k_suf.float()], dim=1).permute(0, 2, 1, 3)
    vc = torch.cat([v_pre.float(), v_suf.float()], dim=1).permute(0, 2, 1, 3)
    scores = torch.einsum("bkgsd,bkud->bkgsu", qh, kc)
    pos = positions.long()
    ppos = torch.arange(pp, device=q.device)
    keep_pre = ((ppos[None, None, :] < prefix_len.long()[:, None, None])
                & (ppos[None, None, :] <= pos[:, :, None]))   # [B, S, Pp]
    keep_suf = suffix_valid[:, None, :] & (pos[:, None, :] <= pos[:, :, None])
    keep = torch.cat([keep_pre, keep_suf], dim=-1)           # [B, S, Pp+S]
    scores = torch.where(keep[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsu,bkud->bkgsd", p, vc)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# decode path with a contiguous KV cache (optionally int8 / packed int4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """KV cache, one layer or stacked ``[L, ...]``.

    ``k``/``v``: ``[B, S_slots, Hkv, D]`` — bf16 (kv16), f32 (kv32), int8
    (kv8), or int4 packed two per byte along D (``[..., D/2]``, kv4).
    ``k_scale``/``v_scale``: per-``[B, Hkv]`` dequant scales. ``token_idx``:
    ``[B, S_slots]`` absolute token index per slot, −1 = empty.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    token_idx: torch.Tensor
    bits: int = 16

    def layer(self, l: int) -> "KVCache":
        """Per-layer view of a stacked cache (writes land in the stack)."""
        return KVCache(self.k[l], self.v[l], self.k_scale[l],
                       self.v_scale[l], self.token_idx[l], self.bits)


def _kv_storage(bits: int, d: int, dtype: torch.dtype):
    if bits == 4:
        if d % 2:
            raise ValueError("kv4 packs pairs along D: D must be even")
        return d // 2, torch.int8
    return d, (torch.int8 if bits == 8 else dtype)


def init_kv_cache(batch: int, slots: int, hkv: int, d: int, *,
                  bits: int = 16, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    dk, cdt = _kv_storage(bits, d, dtype)
    shape = (batch, slots, hkv, dk)
    return KVCache(
        k=torch.zeros(shape, dtype=cdt, device=device),
        v=torch.zeros(shape, dtype=cdt, device=device),
        k_scale=torch.ones((batch, hkv), device=device),
        v_scale=torch.ones((batch, hkv), device=device),
        token_idx=torch.full((batch, slots), -1, dtype=torch.int32,
                             device=device),
        bits=bits,
    )


def kv_refine(x: torch.Tensor, eff_bits: int) -> torch.Tensor:
    """Per-layer precision-policy fake-quant of fresh K/V projections.

    ``eff_bits`` is one entry of a profile's per-layer KV bit-width row
    (host int). Applied right after the QKV projection and rope wherever
    K/V are born (prefill, continuation suffixes, decode steps), so the
    attention read, the cache write and the collected masters all see the
    refined values; replayed masters were refined at birth and must not
    pass here again (the recomputed scale is not bit-stable).

    Per position: ``amax`` over the head dim, ``qmax = 2^(b − 1) − 1``,
    ``scale = max(amax, 1e-9) / qmax`` (a true division, as the reference
    computes it with a traced bit-width), round half to even, clip. In f32,
    cast back to ``x.dtype``. ``eff_bits >= 16`` returns ``x`` itself: the
    reference's f32 round trip is exact there. ``qmax`` divides as a
    tensor: CUDA turns a division by a host scalar into a multiplication
    by its reciprocal, one ulp off in some elements.
    """
    eff = int(eff_bits)
    if eff >= 16:
        return x
    qmax = float(2 ** (min(eff, 15) - 1) - 1)
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-9) / amax.new_full((), qmax)
    fq = torch.clamp(torch.round(xf / scale), -qmax, qmax) * scale
    return fq.to(x.dtype)


def kv_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Int-KV dequant scale ``amax / qmax + 1e-9`` as the reference computes
    it: XLA lowers the expression to one fused multiply-add,
    ``fma(amax, f32(1/qmax), f32(1e-9))``, rounded once to f32. The f32
    product is exact in f64, so the f64 sum rounded to f32 is that fma.
    True division differs from it by one ulp in most elements."""
    inv = float(np.float32(1.0 / qmax))
    eps = float(np.float32(1e-9))
    return (amax.double() * inv + eps).float()


def _quantize_kv(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize K/V rows onto the per-(B, Hkv) int grid. ``torch.round``
    rounds half to even, like the reference's ``jnp.round``."""
    s = scale[:, None, :, None]
    qmax = 127 if bits == 8 else 7
    q = torch.clamp(torch.round(x.float() / s), -qmax, qmax).to(torch.int8)
    return pack_int4(q) if bits == 4 else q


def _dequantize_kv(data: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    q = unpack_int4(data) if bits == 4 else data
    return q.float() * scale[:, None, :, None]


def _kv_step_quantize(cache, k_new: torch.Tensor, v_new: torch.Tensor):
    """Decode-step scale update + row quantization, shared by the contiguous
    and paged writers. Int caches keep a running max-abs scale (monotone, so
    rows written earlier stay valid); bf16 caches just cast. Returns
    ``(k_scale, v_scale, k_row, v_row)``."""
    if cache.bits in (4, 8):
        qmax = 127.0 if cache.bits == 8 else 7.0
        k_amax = k_new.float().abs().amax(dim=(1, 3))
        v_amax = v_new.float().abs().amax(dim=(1, 3))
        k_scale = torch.maximum(cache.k_scale, kv_scale(k_amax, qmax))
        v_scale = torch.maximum(cache.v_scale, kv_scale(v_amax, qmax))
        k_row = _quantize_kv(k_new, k_scale, cache.bits)[:, 0]
        v_row = _quantize_kv(v_new, v_scale, cache.bits)[:, 0]
    else:
        k_scale, v_scale = cache.k_scale, cache.v_scale
        k_row = k_new[:, 0].to(cache.k.dtype)
        v_row = v_new[:, 0].to(cache.v.dtype)
    return k_scale, v_scale, k_row, v_row


def update_kv_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: torch.Tensor) -> KVCache:
    """Write one decode step (``k_new [B, 1, Hkv, D]``) at ring slot
    ``pos % slots``, in place; int caches update their running scales."""
    b, slots = cache.token_idx.shape
    slot = (pos % slots).long()
    k_scale, v_scale, k_row, v_row = _kv_step_quantize(cache, k_new, v_new)
    bidx = torch.arange(b, device=pos.device)
    cache.k[bidx, slot] = k_row
    cache.v[bidx, slot] = v_row
    cache.token_idx[bidx, slot] = pos.to(torch.int32)
    if cache.bits in (4, 8):
        cache.k_scale.copy_(k_scale)
        cache.v_scale.copy_(v_scale)
    return cache


def _kv_window_quantize(cache, k_new: torch.Tensor, v_new: torch.Tensor):
    """W-token form of :func:`_kv_step_quantize` for a draft/verify window
    (``k_new``/``v_new`` ``[B, W, Hkv, D]``).

    Int caches get a per-position **scale ladder** ``[B, W, Hkv]``: entry
    ``j`` is the running-max scale the stepwise path would hold after
    folding position ``j`` (``cummax`` of the per-position scales, floored
    at the committed scale; max is associative, so this equals folding one
    step at a time). Position ``j`` is quantized under ``ladder[:, j]``;
    the committed scales are left to the caller, who commits the entry of
    the last accepted position. kv8 only at int precision, as in the
    reference. Returns ``(k_ladder, v_ladder, k_rows, v_rows)``.
    """
    b, w = k_new.shape[:2]
    if cache.bits in (4, 8):
        assert cache.bits == 8, "speculative windows require kv8/kv16"
        qmax = 127.0
        k_amax = k_new.float().abs().amax(dim=3)
        v_amax = v_new.float().abs().amax(dim=3)
        k_lad = torch.maximum(cache.k_scale[:, None],
                              torch.cummax(kv_scale(k_amax, qmax), 1).values)
        v_lad = torch.maximum(cache.v_scale[:, None],
                              torch.cummax(kv_scale(v_amax, qmax), 1).values)

        def quant(x, lad):
            q = torch.round(x.float() / lad[..., None])
            return torch.clamp(q, -qmax, qmax).to(torch.int8)

        k_rows, v_rows = quant(k_new, k_lad), quant(v_new, v_lad)
    else:
        shape = (b, w) + tuple(cache.k_scale.shape[1:])
        k_lad = cache.k_scale[:, None].expand(shape)
        v_lad = cache.v_scale[:, None].expand(shape)
        k_rows = k_new.to(cache.k.dtype)
        v_rows = v_new.to(cache.v.dtype)
    return k_lad, v_lad, k_rows, v_rows


def _window_positions(pos: torch.Tensor, w: int) -> torch.Tensor:
    """``[B, W]`` absolute positions ``pos + j`` of a window (int64)."""
    return pos.long()[:, None] + torch.arange(w, device=pos.device)[None]


def update_kv_cache_window(cache: KVCache, k_new: torch.Tensor,
                           v_new: torch.Tensor, pos: torch.Tensor):
    """Write a W-token window at ring slots ``(pos + j) % slots``, in
    place. The committed scales stay unchanged: rejected tail slots hold
    junk that the next window's writes cover before any query reads them.
    Returns ``(cache, k_ladder, v_ladder)``."""
    b, slots = cache.token_idx.shape
    qpos = _window_positions(pos, k_new.shape[1])
    slot = qpos % slots
    k_lad, v_lad, k_rows, v_rows = _kv_window_quantize(cache, k_new, v_new)
    bidx = torch.arange(b, device=pos.device)[:, None]
    cache.k[bidx, slot] = k_rows
    cache.v[bidx, slot] = v_rows
    cache.token_idx[bidx, slot] = qpos.to(torch.int32)
    return cache, k_lad, v_lad


def decode_attention(q: torch.Tensor, cache: KVCache, pos: torch.Tensor, *,
                     window: Optional[int] = None,
                     kernel: bool = False) -> torch.Tensor:
    """One-token attention vs the cache. q ``[B, 1, H, D]`` → ``[B, 1, H, D]``.

    kv8 contracts on the int grid and folds the scale into the scores and
    the output (counted in ``decode_attention.kv8_einsum_calls``); kv4
    dequantizes first. Masking uses the per-slot ``token_idx``, so ring
    wraparound is safe.

    ``kernel=True`` reads a kv8 cache through the int8-KV decode kernel
    (:func:`repro_torch.kernels.qkv_attention.qkv_attention`, K4; its plain
    version on the CPU) with per-row lengths ``min(pos + 1, slots)``,
    computed on the device. For full causal attention that is the
    ``token_idx`` mask: a row's slots hold its tokens ``max(0, pos − slots +
    1) … pos`` and softmax does not depend on slot order. A sliding window
    (``window < slots``) has no such form and raises. kv16 and kv4 have no
    kernel, in the reference either, and take the einsum path.
    """
    b, _, h, d = q.shape
    slots, hkv = cache.k.shape[1], cache.k.shape[2]
    hg = h // hkv
    if kernel and cache.bits == 8:
        if window is not None and int(window) < slots:
            raise ValueError(f"the int8-KV decode kernel attends to full "
                             f"causal attention only: window {window} < "
                             f"{slots} slots")
        from repro_torch.kernels.qkv_attention import qkv_attention
        lengths = torch.clamp(pos.to(torch.int32) + 1, max=slots)
        out = qkv_attention(q.reshape(b, hkv, hg, d).contiguous(), cache.k,
                            cache.v, cache.k_scale, cache.v_scale,
                            lengths[:, None].expand(b, hkv).contiguous())
        return out.reshape(b, 1, h, d).to(q.dtype)
    qh = (q.float() * d ** -0.5).reshape(b, hkv, hg, d)
    if cache.bits == 8:
        decode_attention.kv8_einsum_calls += 1
        scores = torch.einsum("bkgd,bskd->bkgs", qh, cache.k.float())
        scores = scores * cache.k_scale[:, :, None, None]
    else:
        kf = (_dequantize_kv(cache.k, cache.k_scale, cache.bits)
              if cache.bits == 4 else cache.k.float())
        scores = torch.einsum("bkgd,bskd->bkgs", qh, kf)
    win = slots + 1 if window is None else int(window)
    tidx = cache.token_idx
    keep = (tidx >= 0) & (tidx <= pos[:, None]) & (pos[:, None] - tidx < win)
    scores = torch.where(keep[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if cache.bits == 8:
        out = torch.einsum("bkgs,bskd->bkgd", p, cache.v.float())
        out = out * cache.v_scale[:, :, None, None]
    else:
        vf = (_dequantize_kv(cache.v, cache.v_scale, cache.bits)
              if cache.bits == 4 else cache.v.float())
        out = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return out.reshape(b, 1, h, d).to(q.dtype)


decode_attention.kv8_einsum_calls = 0


def decode_attention_window(q: torch.Tensor, cache: KVCache,
                            pos: torch.Tensor, k_ladder: torch.Tensor,
                            v_ladder: torch.Tensor, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """W-query attention vs the cache for a draft/verify window. q
    ``[B, W, H, D]`` → ``[B, W, H, D]``; query ``j`` sits at ``pos + j``
    and attends causally through the per-slot ``token_idx``. kv8 contracts
    on the int grid and folds query ``j``'s ladder entry ``[B, W, Hkv]``
    into its scores and output — the scale the stepwise path holds after
    writing position ``j``."""
    b, w, h, d = q.shape
    slots, hkv = cache.k.shape[1], cache.k.shape[2]
    hg = h // hkv
    qh = (q.float() * d ** -0.5).reshape(b, w, hkv, hg, d)
    if cache.bits not in (8, 16):
        raise ValueError("speculative windows require kv8/kv16")
    scores = torch.einsum("bwkgd,bskd->bwkgs", qh, cache.k.float())
    if cache.bits == 8:
        scores = scores * k_ladder[..., None, None]
    win = slots + 1 if window is None else int(window)
    t = cache.token_idx[:, None, :].long()                   # [B, 1, S]
    qp = _window_positions(pos, w)[:, :, None]               # [B, W, 1]
    keep = (t >= 0) & (t <= qp) & (qp - t < win)
    scores = torch.where(keep[:, :, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bwkgs,bskd->bwkgd", p, cache.v.float())
    if cache.bits == 8:
        out = out * v_ladder[..., None, None]
    return out.reshape(b, w, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# paged KV cache: global block pool + per-row block tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache, one layer or stacked ``[L, ...]``.

    ``k``/``v``: ``[n_blocks + 1, bs, Hkv, D]`` (``[..., D/2]`` packed at
    kv4); block ``n_blocks`` is the write sink (module docstring).
    ``token_idx``: ``[n_blocks + 1, bs]``, −1 = empty. ``k_scale``/
    ``v_scale``: per *row* ``[B, Hkv]``. ``block_table``: ``[B, n_lblk]``
    int32; an entry is mapped iff ``0 <= entry < n_blocks``.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    token_idx: torch.Tensor
    block_table: torch.Tensor
    n_blocks: int
    bits: int = 16

    def layer(self, l: int) -> "PagedKVCache":
        """Per-layer view of a stacked pool (writes land in the stack)."""
        return PagedKVCache(self.k[l], self.v[l], self.k_scale[l],
                            self.v_scale[l], self.token_idx[l],
                            self.block_table[l], self.n_blocks, self.bits)


def stack_layers(cache, n_layers: int):
    """Stack one layer's cache ``n_layers`` times on a new axis 0."""
    out = {}
    for f in dataclasses.fields(cache):
        x = getattr(cache, f.name)
        if isinstance(x, torch.Tensor):
            x = x.unsqueeze(0).expand(n_layers, *x.shape).clone()
        out[f.name] = x
    return type(cache)(**out)


def init_paged_kv_cache(batch: int, n_blocks: int, block_size: int,
                        n_lblk: int, hkv: int, d: int, *, bits: int = 16,
                        dtype=torch.bfloat16, device=None) -> PagedKVCache:
    """Empty pool of ``n_blocks`` blocks (plus the write sink); every row's
    table unmapped."""
    dk, cdt = _kv_storage(bits, d, dtype)
    shape = (n_blocks + 1, block_size, hkv, dk)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=cdt, device=device),
        v=torch.zeros(shape, dtype=cdt, device=device),
        k_scale=torch.ones((batch, hkv), device=device),
        v_scale=torch.ones((batch, hkv), device=device),
        token_idx=torch.full((n_blocks + 1, block_size), -1,
                             dtype=torch.int32, device=device),
        block_table=torch.full((batch, n_lblk), n_blocks, dtype=torch.int32,
                               device=device),
        n_blocks=n_blocks, bits=bits,
    )


def _mapped(entries: torch.Tensor, n_blocks: int):
    """``(mapped mask, index with unmapped entries sent to the sink)``."""
    ok = (entries >= 0) & (entries < n_blocks)
    return ok, torch.where(ok, entries, n_blocks).long()


def paged_view(cache: PagedKVCache) -> KVCache:
    """Dense per-row view of one layer's pool: ``[B, n_lblk*bs, ...]``.

    Unmapped logical blocks read as empty (zeros, ``token_idx`` −1) — the
    contiguous cache's pad representation — so :func:`decode_attention`
    runs on the view unchanged. This is the gather backend and the oracle
    of the in-place kernel.
    """
    paged_view.calls += 1
    b, n_lblk = cache.block_table.shape
    bs = cache.k.shape[1]
    ok, idx = _mapped(cache.block_table, cache.n_blocks)

    def gather(pool, fill):
        g = pool[idx]                                # [B, n_lblk, bs, ...]
        mask = ok.reshape(b, n_lblk, *([1] * (g.ndim - 2)))
        g = torch.where(mask, g, torch.full((), fill, dtype=g.dtype,
                                            device=g.device))
        return g.reshape(b, n_lblk * bs, *pool.shape[2:])

    return KVCache(k=gather(cache.k, 0), v=gather(cache.v, 0),
                   k_scale=cache.k_scale.clone(),
                   v_scale=cache.v_scale.clone(),
                   token_idx=gather(cache.token_idx, -1), bits=cache.bits)


paged_view.calls = 0


def update_paged_kv_cache(cache: PagedKVCache, k_new: torch.Tensor,
                          v_new: torch.Tensor,
                          pos: torch.Tensor) -> PagedKVCache:
    """Write one decode step through the block table, in place.

    Virtual ring slot ``pos % (n_lblk*bs)`` resolves to physical block
    ``block_table[row, slot // bs]``, offset ``slot % bs`` — the contiguous
    ring's placement. Rows whose entry is unmapped write into the sink.
    """
    b, n_lblk = cache.block_table.shape
    bs = cache.k.shape[1]
    slot = (pos % (n_lblk * bs)).long()
    entry = cache.block_table.gather(1, (slot // bs)[:, None])[:, 0]
    _, phys = _mapped(entry, cache.n_blocks)
    off = slot % bs
    k_scale, v_scale, k_row, v_row = _kv_step_quantize(cache, k_new, v_new)
    cache.k[phys, off] = k_row
    cache.v[phys, off] = v_row
    cache.token_idx[phys, off] = pos.to(torch.int32)
    if cache.bits in (4, 8):
        cache.k_scale.copy_(k_scale)
        cache.v_scale.copy_(v_scale)
    return cache


def update_paged_kv_cache_window(cache: PagedKVCache, k_new: torch.Tensor,
                                 v_new: torch.Tensor, pos: torch.Tensor):
    """Write a W-token window through the block table, in place, with the
    placement of :func:`update_paged_kv_cache` per position. Unmapped
    entries and window positions at or past the row's capacity
    ``n_lblk·bs`` write into the sink: a speculative tail never wraps onto
    logical block 0, which may be a shared prefix. Committed scales stay
    unchanged. Returns ``(cache, k_ladder, v_ladder)``."""
    b, n_lblk = cache.block_table.shape
    bs = cache.k.shape[1]
    cap = n_lblk * bs
    qpos = _window_positions(pos, k_new.shape[1])
    slot = qpos % cap
    entry = cache.block_table.gather(1, slot // bs)
    entry = torch.where(qpos < cap, entry, cache.n_blocks)
    _, phys = _mapped(entry, cache.n_blocks)
    off = slot % bs
    k_lad, v_lad, k_rows, v_rows = _kv_window_quantize(cache, k_new, v_new)
    cache.k[phys, off] = k_rows
    cache.v[phys, off] = v_rows
    cache.token_idx[phys, off] = qpos.to(torch.int32)
    return cache, k_lad, v_lad


def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache,
                           pos: torch.Tensor, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """One-token attention **in place** against the paged pool through the
    paged-attention kernel (its plain version for CPU tensors). q
    ``[B, 1, H, D]`` → ``[B, 1, H, D]``; ``window`` None or ``>= slots`` is
    full attention."""
    from repro_torch.kernels.paged_attention import paged_attention
    b, _, h, d = q.shape
    bs, hkv = cache.k.shape[1], cache.k.shape[2]
    hg = h // hkv
    slots = cache.block_table.shape[1] * bs
    win = 0 if window is None or int(window) > slots else int(window)
    out = paged_attention(
        q.reshape(b, hkv, hg, d), cache.k, cache.v, cache.k_scale,
        cache.v_scale, cache.token_idx, cache.block_table, pos,
        bits=cache.bits, window=win, n_blocks=cache.n_blocks)
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_decode_attention_window(q: torch.Tensor, cache: PagedKVCache,
                                  pos: torch.Tensor, k_ladder: torch.Tensor,
                                  v_ladder: torch.Tensor, *,
                                  window: Optional[int] = None
                                  ) -> torch.Tensor:
    """W-query window attention **in place** against the paged pool through
    the multi-query paged-attention kernel (its plain version for CPU
    tensors). q ``[B, W, H, D]`` → ``[B, W, H, D]``; query ``j`` at
    ``pos + j``; ladders ``[B, W, Hkv]`` (read at kv8 only)."""
    from repro_torch.kernels.paged_attention import paged_attention_multi
    b, w, h, d = q.shape
    bs, hkv = cache.k.shape[1], cache.k.shape[2]
    slots = cache.block_table.shape[1] * bs
    win = 0 if window is None or int(window) > slots else int(window)
    out = paged_attention_multi(
        q.reshape(b, w, hkv, h // hkv, d), cache.k, cache.v,
        k_ladder.contiguous(), v_ladder.contiguous(), cache.token_idx,
        cache.block_table, pos, bits=cache.bits, window=win,
        n_blocks=cache.n_blocks)
    return out.reshape(b, w, h, d).to(q.dtype)
