"""Paged decode attention: the Hopper kernels' wrappers, their plain
versions and the host-side planners of the split-context design.

Two kernels, each replacing a Pallas TPU kernel of
``repro/kernels/paged_attention.py``:

* K1 :func:`paged_attention` ← ``paged_attention_pallas``: one query per row
  (greedy decode), source ``csrc/paged_attention.cu``;
* K2 :func:`paged_attention_multi` ← ``paged_attention_pallas_multi``: the
  ``W`` queries of a speculative draft/verify window per row, source
  ``csrc/paged_attention_multi.cu``.

Both sources include ``csrc/paged_attention_split.cuh``: one split-context
("flash-decoding") algorithm, K1 being K2 with ``W = 1``. What bounds them
on an H100 is the bytes of the attended K/V rows (K2 at kv8 also its f32
operations); what held the first port back was parallelism — one block per
(row, KV head), 64 blocks on 132 SMs, no load/compute overlap. The design:

* the ``W·Hg`` query rows of a (row, KV head) are cut into equal row tiles
  of at most 32 rows (16 when ``D > 128``; :func:`row_plan`), a grid axis;
* a row's logical columns are cut into 64-column tiles (column ``c`` is
  slot ``c % bs`` of block-table entry ``c / bs``), so any block size
  works, and the tiles into contiguous splits of at most 8
  (:func:`split_plan`: a grid of about ``4 × SM_COUNT`` blocks);
* each split skips the tiles no query of its row tile can reach, stages
  the rest through a cp.async ring, and writes per query row an f32
  ``(m, l, acc[D])`` partial into scratch that the wrapper allocates; a
  second launch merges the partials in split order (no atomics: two calls
  are bitwise equal). With one split the kernel writes the output itself;
* bf16 q at kv16/kv8 (D a multiple of 16) computes q·K on the bf16 tensor
  cores (exact products, f32 sums); f32 q and kv4 on the f32 CUDA cores;
  P·V always in f32 on the CUDA cores.

The kernels' one remaining limit is ``D`` even and ``<= 256``
(:func:`supports`, which the server checks at construction).
Each wrapper is one call and counts one launch (``.launches``), though a
call makes two CUDA launches when it has more than one split.

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
from repro_torch.kernels.build import BUILD_DIR, SM_COUNT, SOURCES, build
from repro_torch.kernels.build import check as _check, target

__all__ = ["paged_attention", "paged_attention_ref", "paged_attention_multi",
           "paged_attention_multi_ref", "supports", "row_plan", "split_plan",
           "build", "SOURCES", "BUILD_DIR", "MAX_D", "TILE_COLS",
           "MAX_SPLIT_TILES"]

NEG_INF = -1e30
MAX_D = 256                   # head dim: even and at most this
TILE_COLS = 64                # logical key columns per tile, any block size
MAX_SPLIT_TILES = 8           # tiles one split walks (bounds its smem)
BLOCKS_PER_SM = 4             # the split planner's grid: about 4 per SM


def supports(d: int, hg: int, bs: int, w: int = 1) -> Optional[str]:
    """Why K1 (``w == 1``) or K2 (a window of ``w`` queries) cannot take
    head dim ``d``, ``hg`` query heads per KV head and block size ``bs``;
    ``None`` when it can. The wrappers call it before any build, and
    :class:`~repro_torch.serving.engine.AdaptiveServer` at construction."""
    if d % 2 or not 2 <= d <= MAX_D:
        return f"head dim D={d} must be even and at most {MAX_D}"
    if hg < 1 or bs < 1 or w < 1:
        return f"Hg={hg}, block size {bs} and W={w} must be positive"
    return None


def row_plan(w: int, hg: int, d: int) -> tuple[int, int]:
    """``(row tiles, rows per tile)`` for the ``w·hg`` query rows of one
    (row, KV head): equal tiles of at most 32 rows (16 when ``d > 128``,
    where a thread holds more of each row's accumulators). Tile ``i``
    covers rows ``[i·rows_per_tile, min(w·hg, (i + 1)·rows_per_tile))``."""
    rows = w * hg
    cap = 32 if d <= 128 else 16
    n = -(-rows // cap)
    return n, -(-rows // n)


def split_plan(b: int, hkv: int, row_tiles: int,
               n_cols: int) -> tuple[int, int]:
    """``(splits, tiles per split)`` for a table of ``n_cols`` logical
    columns: enough splits for a grid of about ``BLOCKS_PER_SM·SM_COUNT``
    blocks (of which up to 3 fit on an SM at once, so about 2–3 × SM_COUNT
    run at a time), at least ``ceil(n_tiles / MAX_SPLIT_TILES)`` and at most
    one per tile. Split ``s`` covers column tiles ``[s·per, min(n_tiles,
    (s + 1)·per))``; no split is empty."""
    n_tiles = -(-n_cols // TILE_COLS)
    if n_tiles == 0:
        return 1, 1
    want = -(-BLOCKS_PER_SM * SM_COUNT // max(1, b * hkv * row_tiles))
    splits = min(n_tiles, max(want, -(-n_tiles // MAX_SPLIT_TILES)))
    per = -(-n_tiles // splits)
    return -(-n_tiles // per), per


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

def _require(why: Optional[str]) -> None:
    if why is not None:
        raise ValueError(f"unsupported shape: {why}")


def _validate(q_shape, q_dtype, k_pool: torch.Tensor, v_pool: torch.Tensor,
              token_idx: torch.Tensor, block_table: torch.Tensor,
              pos: torch.Tensor, bits: int, n_blocks: Optional[int],
              on: str) -> None:
    """Raise unless K1's or K2's shared operands (q of ``q_shape`` ``[B, W,
    Hkv, Hg, D]``) are what the kernel takes, on device ``on``."""
    b, w, hkv, hg, d = q_shape
    nb_alloc, bs = token_idx.shape
    n_lblk = block_table.shape[1]
    nb = nb_alloc if n_blocks is None else int(n_blocks)
    if not 0 <= nb <= nb_alloc:
        raise ValueError(f"n_blocks={nb} exceeds the pool's {nb_alloc}")
    if q_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q_dtype}")
    kv_dtype = torch.bfloat16 if bits == 16 else torch.int8
    dk = d // 2 if bits == 4 else d
    _check(k_pool, "k_pool", kv_dtype, (nb_alloc, bs, hkv, dk), on)
    _check(v_pool, "v_pool", kv_dtype, (nb_alloc, bs, hkv, dk), on)
    _check(token_idx, "token_idx", torch.int32, (nb_alloc, bs), on)
    _check(block_table, "block_table", torch.int32, (b, n_lblk), on)
    _check(pos, "pos", torch.int32, (b,), on)


def _launch(name: str, q: torch.Tensor, k_pool: torch.Tensor,
            v_pool: torch.Tensor, k_scale: torch.Tensor,
            v_scale: torch.Tensor, token_idx: torch.Tensor,
            block_table: torch.Tensor, pos: torch.Tensor, bits: int,
            window: int, n_blocks: Optional[int]) -> torch.Tensor:
    """Plan and launch K1 or K2 (``name``) on validated q ``[B, W, Hkv,
    Hg, D]`` with per-query scales ``[B, W, Hkv]``; returns ``[B, W, Hkv,
    Hg, D]`` f32. The split partials live in scratch allocated here."""
    b, w, hkv, hg, d = q.shape
    nb_alloc, bs = token_idx.shape
    n_lblk = block_table.shape[1]
    nb = nb_alloc if n_blocks is None else int(n_blocks)
    row_tiles, row_tile = row_plan(w, hg, d)
    splits, per = split_plan(b, hkv, row_tiles, n_lblk * bs)
    out = torch.empty((b, w, hkv, hg, d), dtype=torch.float32,
                      device=q.device)
    part = ml = None
    if splits > 1:
        part = torch.empty((b * hkv * splits, w * hg, d), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((b * hkv * splits, w * hg, 2), dtype=torch.float32,
                         device=q.device)
    lib = build()[name]["lib"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, f"repro_{name}")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        token_idx.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if ml is None else ml.data_ptr(),
        int(q.dtype == torch.bfloat16), b, w, hkv, hg, d, nb, bs, n_lblk,
        bits, _multi_window(int(window), n_lblk, bs, w), row_tile, row_tiles,
        splits, per, float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, k_scale: torch.Tensor,
                    v_scale: torch.Tensor, token_idx: torch.Tensor,
                    block_table: torch.Tensor, pos: torch.Tensor, *,
                    bits: int = 16, window: int = 0,
                    n_blocks: Optional[int] = None) -> torch.Tensor:
    """In-place paged decode attention; ``window <= 0`` is full attention.
    Returns ``[B, Hkv, Hg, D]`` f32. CPU tensors take the plain version;
    ``meta`` tensors are validated as CUDA ones, then take the plain
    version (shape arithmetic only); CUDA tensors launch the kernel
    (counted in ``paged_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   token_idx, block_table, pos, bits=bits,
                                   window=window, n_blocks=n_blocks)
    if bits not in (4, 8, 16):
        raise ValueError(f"paged kernel supports kv16/kv8/kv4, got kv{bits}")
    b, hkv, hg, d = q.shape
    _require(supports(d, hg, token_idx.shape[1]))
    on = target(q)
    _check(q, "q", q.dtype, (b, hkv, hg, d), on)
    _check(k_scale, "k_scale", torch.float32, (b, hkv), on)
    _check(v_scale, "v_scale", torch.float32, (b, hkv), on)
    _validate((b, 1, hkv, hg, d), q.dtype, k_pool, v_pool, token_idx,
              block_table, pos, bits, n_blocks, on)
    if on == "meta":
        return paged_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   token_idx, block_table, pos, bits=bits,
                                   window=window, n_blocks=n_blocks)
    out = _launch("paged_attention", q.unsqueeze(1), k_pool, v_pool, k_scale,
                  v_scale, token_idx, block_table, pos, bits, window,
                  n_blocks)
    paged_attention.launches += 1
    return out.squeeze(1)


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
    the plain version; ``meta`` tensors are validated as CUDA ones, then
    take the plain version (shape arithmetic only); CUDA tensors launch
    the kernel (counted in ``paged_attention_multi.launches``) or raise."""
    if q.device.type == "cpu":
        return paged_attention_multi_ref(
            q, k_pool, v_pool, k_ladder, v_ladder, token_idx, block_table,
            pos, bits=bits, window=window, n_blocks=n_blocks)
    if bits not in (8, 16):
        raise ValueError(f"the window kernel supports kv16/kv8, got kv{bits}")
    b, w, hkv, hg, d = q.shape
    _require(supports(d, hg, token_idx.shape[1], w))
    on = target(q)
    _check(q, "q", q.dtype, (b, w, hkv, hg, d), on)
    _check(k_ladder, "k_ladder", torch.float32, (b, w, hkv), on)
    _check(v_ladder, "v_ladder", torch.float32, (b, w, hkv), on)
    _validate(q.shape, q.dtype, k_pool, v_pool, token_idx, block_table,
              pos, bits, n_blocks, on)
    if on == "meta":
        return paged_attention_multi_ref(
            q, k_pool, v_pool, k_ladder, v_ladder, token_idx, block_table,
            pos, bits=bits, window=window, n_blocks=n_blocks)
    out = _launch("paged_attention_multi", q, k_pool, v_pool, k_ladder,
                  v_ladder, token_idx, block_table, pos, bits, window,
                  n_blocks)
    paged_attention_multi.launches += 1
    return out


paged_attention_multi.launches = 0
