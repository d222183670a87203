"""Paged decode attention: the Hopper kernels' wrappers and their plain
versions.

Two kernels, each replacing a Pallas TPU kernel of
``repro/kernels/paged_attention.py``:

* K1 :func:`paged_attention` ← ``paged_attention_pallas``: one query per row
  (greedy decode), source ``csrc/paged_attention.cu``;
* K2 :func:`paged_attention_multi` ← ``paged_attention_pallas_multi``: the
  ``W`` queries of a speculative draft/verify window per row, source
  ``csrc/paged_attention_multi.cu``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use and called through ``ctypes``
(:mod:`repro_torch.kernels.build`, which also builds the port's other
kernels; ``build``, ``SOURCES`` and ``BUILD_DIR`` are re-exported here).

Layout (the reference's, see :class:`repro_torch.models.attention.
PagedKVCache`):

  q        [B, Hkv, Hg, D]          f32 or bf16 — one decode token per row
           [B, W, Hkv, Hg, D]       K2: query j at position pos + j
  k/v pool [nb, bs, Hkv, D]         bf16 (kv16) or int8 (kv8);
           [nb, bs, Hkv, D/2]       int8 at kv4, two nibbles per byte (K1)
  tidx     [nb, bs]                 int32 absolute token index, −1 = empty
  scales   [B, Hkv]                 f32 per-row dequant scales (K1, kv8/kv4)
  ladders  [B, W, Hkv]              f32 per-query dequant scales (K2, kv8)
  bt       [B, n_lblk]              int32 block table
  pos      [B]                      int32 current absolute position
  → out    [B, Hkv, Hg, D]          f32 (K2: [B, W, Hkv, Hg, D])

An entry is mapped iff ``0 <= entry < n_blocks`` (``n_blocks`` defaults to
the pool's block count; the port's pools pass it explicitly because they
carry a write-sink block past it).

Each wrapper runs the plain version for CPU tensors and the kernel for
CUDA tensors — it never falls back from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.qtypes import unpack_int4
from repro_torch.kernels.build import BUILD_DIR, SOURCES, build
from repro_torch.kernels.build import check as _check

__all__ = ["paged_attention", "paged_attention_ref", "paged_attention_multi",
           "paged_attention_multi_ref", "build", "SOURCES", "BUILD_DIR",
           "MAX_D", "MAX_HG", "MAX_BS", "MAX_WHG"]

NEG_INF = -1e30
MAX_D, MAX_HG, MAX_BS = 256, 16, 64
MAX_WHG = 64                  # K2: W·Hg query rows per (row, KV head) ...
MAX_WHG_D = 8192              # ... and W·Hg·D accumulators per thread block


def _dense_rows(pool: torch.Tensor, block_table: torch.Tensor, nb: int,
                fill) -> torch.Tensor:
    """Gather each row's logical blocks into ``[B, n_lblk·bs, ...]``;
    unmapped entries (``< 0`` or ``>= nb``) read as ``fill``."""
    b, n_lblk = block_table.shape
    ok = (block_table >= 0) & (block_table < nb)
    g = pool[torch.where(ok, block_table, 0).long()]    # [B, n_lblk, bs, ...]
    mask = ok.reshape(b, n_lblk, *([1] * (g.ndim - 2)))
    g = torch.where(mask, g, torch.full((), fill, dtype=g.dtype,
                                        device=g.device))
    return g.reshape(b, n_lblk * pool.shape[1], *pool.shape[2:])


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, k_scale: torch.Tensor,
                        v_scale: torch.Tensor, token_idx: torch.Tensor,
                        block_table: torch.Tensor, pos: torch.Tensor, *,
                        bits: int = 16, window: int = 0,
                        n_blocks: Optional[int] = None) -> torch.Tensor:
    """Plain version (port of ``repro/kernels/ref.py::paged_attention_ref``):
    a dense gather of each row's blocks (unmapped entries fill with zeros /
    ``token_idx`` −1), then the masked softmax of ``decode_attention`` in
    its operation order — kv8 contracts on the int grid and scales the
    scores and the output, kv4 unpacks and dequantizes first. Rows with no
    attendable key return exact zeros."""
    b, hkv, hg, d = q.shape
    nb = k_pool.shape[0] if n_blocks is None else int(n_blocks)

    def gather(pool, fill):
        return _dense_rows(pool, block_table, nb, fill)

    ks = k_scale.float().reshape(b, hkv)
    vs = v_scale.float().reshape(b, hkv)
    if bits == 4:
        kf = unpack_int4(gather(k_pool, 0)).float() * ks[:, None, :, None]
        vf = unpack_int4(gather(v_pool, 0)).float() * vs[:, None, :, None]
    else:
        kf = gather(k_pool, 0).float()                  # [B, S, Hkv, D]
        vf = gather(v_pool, 0).float()
    tidx = gather(token_idx, -1)                        # [B, S]
    qh = q.float() * d ** -0.5
    scores = torch.einsum("bkgd,bskd->bkgs", qh, kf)
    if bits == 8:
        scores = scores * ks[:, :, None, None]
    win = window if window > 0 else tidx.shape[1] + 1  # S = n_lblk·bs
    p_ = pos.long()[:, None]
    keep = (tidx >= 0) & (tidx <= p_) & (p_ - tidx < win)
    scores = torch.where(keep[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vf)
    if bits == 8:
        out = out * vs[:, :, None, None]
    alive = keep.any(dim=-1)[:, None, None, None]
    return torch.where(alive, out, torch.zeros((), device=out.device))


# ---------------------------------------------------------------------------
# the CUDA kernels: launch (build and bind: repro_torch.kernels.build)
# ---------------------------------------------------------------------------

def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, k_scale: torch.Tensor,
                    v_scale: torch.Tensor, token_idx: torch.Tensor,
                    block_table: torch.Tensor, pos: torch.Tensor, *,
                    bits: int = 16, window: int = 0,
                    n_blocks: Optional[int] = None) -> torch.Tensor:
    """In-place paged decode attention; ``window <= 0`` is full attention.
    Returns ``[B, Hkv, Hg, D]`` f32. CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in ``paged_attention.launches``)
    or raise."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   token_idx, block_table, pos, bits=bits,
                                   window=window, n_blocks=n_blocks)
    if bits not in (4, 8, 16):
        raise ValueError(f"paged kernel supports kv16/kv8/kv4, got kv{bits}")
    b, hkv, hg, d = q.shape
    nb_alloc, bs = token_idx.shape
    n_lblk = block_table.shape[1]
    nb = nb_alloc if n_blocks is None else int(n_blocks)
    if not (d % 2 == 0 and d <= MAX_D and hg <= MAX_HG and bs <= MAX_BS):
        raise ValueError(f"unsupported shape: D={d} (even, <= {MAX_D}), "
                         f"Hg={hg} (<= {MAX_HG}), bs={bs} (<= {MAX_BS})")
    if not 0 <= nb <= nb_alloc:
        raise ValueError(f"n_blocks={nb} exceeds the pool's {nb_alloc}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    _check(q, "q", q.dtype, (b, hkv, hg, d))
    kv_dtype = torch.bfloat16 if bits == 16 else torch.int8
    dk = d // 2 if bits == 4 else d
    _check(k_pool, "k_pool", kv_dtype, (nb_alloc, bs, hkv, dk))
    _check(v_pool, "v_pool", kv_dtype, (nb_alloc, bs, hkv, dk))
    _check(token_idx, "token_idx", torch.int32, (nb_alloc, bs))
    _check(k_scale, "k_scale", torch.float32, (b, hkv))
    _check(v_scale, "v_scale", torch.float32, (b, hkv))
    _check(block_table, "block_table", torch.int32, (b, n_lblk))
    _check(pos, "pos", torch.int32, (b,))
    out = torch.empty((b, hkv, hg, d), dtype=torch.float32, device=q.device)
    lib = build()["paged_attention"]["lib"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        token_idx.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, hkv, hg, d, nb, bs, n_lblk,
        bits, int(window), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"paged-attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


# ---------------------------------------------------------------------------
# K2: the W queries of a speculative draft/verify window
# ---------------------------------------------------------------------------

def _multi_window(window: int, n_lblk: int, bs: int, w: int) -> int:
    """Mask width: ``window``, or for full attention (``window <= 0``) the
    reference's sentinel ``n_lblk·bs + W``, which exceeds every
    ``pos + j − tidx``."""
    return window if window > 0 else n_lblk * bs + w


def paged_attention_multi_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_ladder: torch.Tensor,
                              v_ladder: torch.Tensor, token_idx: torch.Tensor,
                              block_table: torch.Tensor, pos: torch.Tensor,
                              *, bits: int = 16, window: int = 0,
                              n_blocks: Optional[int] = None) -> torch.Tensor:
    """Plain version of K2: a dense gather of each row's blocks (unmapped
    entries read as empty), then ``decode_attention_window``'s operation
    order — kv8 contracts on the int grid and scales query ``j``'s scores
    by ``k_ladder[:, j]`` and its output by ``v_ladder[:, j]``; kv16
    ignores the ladders. Query ``j`` sits at ``pos + j``. A query with no
    attendable key returns exact zeros."""
    if bits not in (8, 16):
        raise ValueError(f"the window kernel supports kv16/kv8, got kv{bits}")
    b, w, hkv, hg, d = q.shape
    bs = token_idx.shape[1]
    n_lblk = block_table.shape[1]
    nb = k_pool.shape[0] if n_blocks is None else int(n_blocks)
    kf = _dense_rows(k_pool, block_table, nb, 0).float()   # [B, S, Hkv, D]
    vf = _dense_rows(v_pool, block_table, nb, 0).float()
    tidx = _dense_rows(token_idx, block_table, nb, -1).long()  # [B, S]
    qh = q.float() * d ** -0.5
    scores = torch.einsum("bwkgd,bskd->bwkgs", qh, kf)
    if bits == 8:
        scores = scores * k_ladder.float()[..., None, None]
    win = _multi_window(window, n_lblk, bs, w)
    qp = pos.long()[:, None, None] + torch.arange(w, device=q.device)[None, :,
                                                                      None]
    t = tidx[:, None, :]
    keep = (t >= 0) & (t <= qp) & (qp - t < win)        # [B, W, S]
    scores = torch.where(keep[:, :, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bwkgs,bskd->bwkgd", p, vf)
    if bits == 8:
        out = out * v_ladder.float()[..., None, None]
    alive = keep.any(dim=-1)[:, :, None, None, None]
    return torch.where(alive, out, torch.zeros((), device=out.device))


def paged_attention_multi(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, k_ladder: torch.Tensor,
                          v_ladder: torch.Tensor, token_idx: torch.Tensor,
                          block_table: torch.Tensor, pos: torch.Tensor, *,
                          bits: int = 16, window: int = 0,
                          n_blocks: Optional[int] = None) -> torch.Tensor:
    """In-place paged attention for a W-query window; ``window <= 0`` is
    full attention. Returns ``[B, W, Hkv, Hg, D]`` f32. CPU tensors take
    the plain version; CUDA tensors launch the kernel (counted in
    ``paged_attention_multi.launches``) or raise."""
    if q.device.type == "cpu":
        return paged_attention_multi_ref(
            q, k_pool, v_pool, k_ladder, v_ladder, token_idx, block_table,
            pos, bits=bits, window=window, n_blocks=n_blocks)
    if bits not in (8, 16):
        raise ValueError(f"the window kernel supports kv16/kv8, got kv{bits}")
    b, w, hkv, hg, d = q.shape
    nb_alloc, bs = token_idx.shape
    n_lblk = block_table.shape[1]
    nb = nb_alloc if n_blocks is None else int(n_blocks)
    if not (d % 2 == 0 and d <= MAX_D and bs <= MAX_BS
            and w * hg <= MAX_WHG and w * hg * d <= MAX_WHG_D):
        raise ValueError(f"unsupported shape: D={d} (even, <= {MAX_D}), "
                         f"bs={bs} (<= {MAX_BS}), W·Hg={w * hg} (<= "
                         f"{MAX_WHG}), W·Hg·D={w * hg * d} (<= {MAX_WHG_D})")
    if not 0 <= nb <= nb_alloc:
        raise ValueError(f"n_blocks={nb} exceeds the pool's {nb_alloc}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    _check(q, "q", q.dtype, (b, w, hkv, hg, d))
    kv_dtype = torch.bfloat16 if bits == 16 else torch.int8
    _check(k_pool, "k_pool", kv_dtype, (nb_alloc, bs, hkv, d))
    _check(v_pool, "v_pool", kv_dtype, (nb_alloc, bs, hkv, d))
    _check(token_idx, "token_idx", torch.int32, (nb_alloc, bs))
    _check(k_ladder, "k_ladder", torch.float32, (b, w, hkv))
    _check(v_ladder, "v_ladder", torch.float32, (b, w, hkv))
    _check(block_table, "block_table", torch.int32, (b, n_lblk))
    _check(pos, "pos", torch.int32, (b,))
    out = torch.empty((b, w, hkv, hg, d), dtype=torch.float32,
                      device=q.device)
    lib = build()["paged_attention_multi"]["lib"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_paged_attention_multi(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        token_idx.data_ptr(), k_ladder.data_ptr(), v_ladder.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, w, hkv, hg, d, nb, bs, n_lblk,
        bits, _multi_window(int(window), n_lblk, bs, w), float(d ** -0.5),
        stream)
    if err != 0:
        raise RuntimeError(f"window paged-attention kernel launch failed: "
                           f"CUDA error {err}")
    paged_attention_multi.launches += 1
    return out


paged_attention_multi.launches = 0
