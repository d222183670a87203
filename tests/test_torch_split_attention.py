"""The split-context design of the paged-attention kernels (K1, K2), on the
CPU: the host-side planners, and a plain-torch model of the kernels'
split-and-merge algorithm against the plain versions
(``paged_attention_ref``, ``paged_attention_multi_ref``).

The model follows the kernels step by step: a row's logical columns in
64-column tiles (any block size), contiguous splits of tiles, tiles that no
query of the row tile can reach skipped, an online softmax over each
split's tiles giving an f32 ``(m, l, acc)`` partial per query row, then the
merge in split order with the output scale applied after it. It must equal
the plain versions within 1e-6 at 1, 2, 3 and 7 splits, with splits that
hold no valid key, a dead row (exact zeros) and a row whose only valid keys
lie in the last split. The bound is 1e-6 times the larger of 1 and the
case's largest output: both sides sum in f32 in different orders, and
kv8's sums run on the int grid (up to 127 per element) before the output
scale, so its outputs reach 5 and an element's rounding follows the size
of the sums, not of the element. The CUDA kernels themselves are checked against the
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.qtypes import unpack_int4
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.paged_attention import _dense_rows

NEG = -1e30


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hkv,bs,n_lblk", [
    (8, 8, 16, 64), (8, 8, 16, 256), (8, 8, 16, 1), (1, 1, 16, 1),
    (8, 8, 24, 43), (8, 8, 128, 8), (4, 8, 128, 1), (1, 8, 16, 2048),
    (64, 32, 16, 64), (3, 2, 7, 1000)])
@pytest.mark.parametrize("row_tiles", [1, 3])
def test_split_plan_covers_every_column_tile_once(b, hkv, bs, n_lblk,
                                                  row_tiles):
    n_cols = n_lblk * bs
    n_tiles = -(-n_cols // PA.TILE_COLS)
    splits, per = PA.split_plan(b, hkv, row_tiles, n_cols)
    assert 1 <= per <= PA.MAX_SPLIT_TILES
    seen = np.zeros(n_tiles, int)
    for s in range(splits):
        lo, hi = s * per, min(n_tiles, (s + 1) * per)
        assert lo < hi                            # no split is empty
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    if b * hkv * row_tiles * n_tiles >= 2 * PA.SM_COUNT:
        assert b * hkv * row_tiles * splits >= PA.SM_COUNT   # the card fills


def test_split_plan_at_the_main_path_shapes():
    """About 4 × 132 blocks at phase 2's shapes (B·Hkv = 64, one row
    tile): 8 splits of 2 tiles at n_lblk 64, 8 of 8 at 256."""
    assert PA.split_plan(8, 8, 1, 64 * 16) == (8, 2)
    assert PA.split_plan(8, 8, 1, 256 * 16) == (8, 8)
    assert PA.split_plan(8, 8, 1, 0) == (1, 1)


@pytest.mark.parametrize("w,hg", [(1, 4), (5, 4), (33, 2), (17, 4), (5, 16),
                                  (1, 1), (1, 40), (9, 8)])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_row_plan_covers_every_query_row_once(w, hg, d):
    """Row tiles cover every r = j·Hg + g exactly once, at most 32 rows
    (16 for D > 128): W·Hg 4, 20, 66, 68, 80, …"""
    n, rows = PA.row_plan(w, hg, d)
    assert rows <= (32 if d <= 128 else 16)
    seen = np.zeros(w * hg, int)
    for i in range(n):
        lo, hi = i * rows, min(w * hg, (i + 1) * rows)
        assert lo < hi
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    assert PA.row_plan(5, 4, 64) == (1, 20)       # the serve: one tile


def test_supports_names_the_limits_that_stay():
    for d, hg, bs, w in [(64, 4, 16, 1), (64, 4, 128, 17), (64, 16, 24, 5),
                         (80, 40, 7, 33), (256, 1, 1, 1), (2, 1, 1, 1)]:
        assert PA.supports(d, hg, bs, w) is None
    assert "head dim" in PA.supports(63, 4, 16)
    assert "head dim" in PA.supports(258, 4, 16)
    assert PA.supports(64, 0, 16) is not None


# ---------------------------------------------------------------------------
# the split-and-merge model
# ---------------------------------------------------------------------------

def split_merge_model(q, k_pool, v_pool, k_scale, v_scale, token_idx,
                      block_table, pos, *, bits, window, n_splits,
                      row_tile=None):
    """The kernels' algorithm in plain torch (f32), for K1 (q ``[B, Hkv,
    Hg, D]``, scales ``[B, Hkv]``) or K2 (q ``[B, W, Hkv, Hg, D]``, ladders
    ``[B, W, Hkv]``). ``n_splits`` splits as the kernel cuts them (``per``
    tiles each, the last shorter); ``row_tile`` rows per row tile."""
    k1 = q.dim() == 4
    if k1:
        q, k_scale, v_scale = q[:, None], k_scale[:, None], v_scale[:, None]
    b, w, hkv, hg, d = q.shape
    bs = token_idx.shape[1]
    n_lblk = block_table.shape[1]
    nb = k_pool.shape[0]
    rows = w * hg
    row_tile = rows if row_tile is None else row_tile
    n_cols = n_lblk * bs
    n_tiles = -(-n_cols // PA.TILE_COLS)
    per = -(-n_tiles // n_splits)
    splits = -(-n_tiles // per)
    win = window if window > 0 else n_cols + w
    kf = _dense_rows(k_pool, block_table, nb, 0)         # [B, S, Hkv, Dk]
    vf = _dense_rows(v_pool, block_table, nb, 0)
    tidx = _dense_rows(token_idx, block_table, nb, -1).long()   # [B, S]
    ks = k_scale.float().permute(0, 2, 1)                # [B, Hkv, W]
    vs = v_scale.float().permute(0, 2, 1)
    if bits == 4:
        kf = unpack_int4(kf).float() * ks[:, None, :, :1]
        vf = unpack_int4(vf).float() * vs[:, None, :, :1]
    kf, vf = kf.float(), vf.float()
    qh = (q.float() * d ** -0.5).permute(0, 2, 1, 3, 4).reshape(b, hkv,
                                                                  rows, d)
    j_of = torch.arange(rows) // hg                     # query of each row
    qp = pos.long()[:, None] + j_of[None, :]            # [B, rows]
    out = torch.zeros(b, hkv, rows, d)
    for r0 in range(0, rows, row_tile):
        sl = slice(r0, min(rows, r0 + row_tile))
        j_lo, j_hi = int(j_of[sl][0]), int(j_of[sl][-1])
        parts = []
        for s in range(splits):
            m = torch.full((b, hkv, sl.stop - r0), NEG)
            l = torch.zeros(b, hkv, sl.stop - r0)
            acc = torch.zeros(b, hkv, sl.stop - r0, d)
            for t0 in range(s * per, min(n_tiles, (s + 1) * per)):
                cols = slice(t0 * PA.TILE_COLS,
                             min(n_cols, (t0 + 1) * PA.TILE_COLS))
                t = tidx[:, cols]                         # [B, C]
                p_ = pos.long()[:, None]
                live = (t >= 0) & (t <= p_ + j_hi) & (p_ + j_lo - t < win)
                if not bool(live.any()):
                    continue                              # the kernel skips
                sc = torch.einsum("bkrd,bckd->bkrc", qh[:, :, sl],
                                  kf[:, cols])
                if bits == 8:
                    sc = sc * ks[:, :, j_of[sl], None]
                qq = qp[:, sl][:, None, :, None]
                tt = t[:, None, None, :]
                keep = (tt >= 0) & (tt <= qq) & (qq - tt < win)
                sc = torch.where(keep, sc, torch.tensor(NEG))
                m_new = torch.maximum(m, sc.max(dim=-1).values)
                p = torch.where(keep, torch.exp(sc - m_new[..., None]), 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkrc,bckd->bkrd", p, vf[:, cols])
                m = m_new
            parts.append((m, l, acc))
        big_m = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        big_l = torch.zeros_like(big_m)
        o = torch.zeros(b, hkv, sl.stop - r0, d)
        for m, l, acc in parts:                          # split order
            wgt = torch.exp(m - big_m)
            big_l = big_l + l * wgt
            o = o + acc * wgt[..., None]
        o = o / big_l.clamp_min(1e-30)[..., None]
        if bits == 8:
            o = o * vs[:, :, j_of[sl], None]
        out[:, :, sl] = torch.where((big_m > -5e29)[..., None], o, 0.0)
    out = out.reshape(b, hkv, w, hg, d).permute(0, 2, 1, 3, 4)
    return out[:, 0] if k1 else out


def _close(got, want):
    tol = 1e-6 * max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)


BS, HKV, HG, D = 16, 2, 2, 16
N_LBLK = 56                        # 896 columns: 14 tiles of 64


def _inputs(bits: int, w=None, seed=0):
    """Rows: near full (keys in every split), short (later splits empty),
    keys only in the last 3 logical blocks (earlier splits empty), a hole
    in the middle, and a dead row; shuffled physical blocks; unmapped
    entries alternate −1 and ≥ n_blocks."""
    rng = np.random.default_rng(seed + bits + 10 * (w or 0))
    nw = 1 if w is None else w
    cap = N_LBLK * BS
    lengths = [cap - nw - 3, 40, cap - nw - 1, 500, 0]
    b = len(lengths)
    n_blocks = b * N_LBLK + 3
    perm = list(rng.permutation(n_blocks))
    bt = np.zeros((b, N_LBLK), np.int32)
    tidx = np.full((n_blocks, BS), -1, np.int32)
    pos = np.zeros((b,), np.int32)
    for r, n in enumerate(lengths):
        pos[r] = max(n, 1)
        for lb in range(N_LBLK):
            mapped = n > 0 and lb * BS < n + nw
            if r == 2:
                mapped = lb >= N_LBLK - 3
            if r == 3 and 10 <= lb < 20:
                mapped = False
            if mapped:
                phys = perm.pop()
                bt[r, lb] = phys
                t = lb * BS + np.arange(BS)
                tidx[phys] = np.where(t < n + nw + 2, t, -1)
            else:
                bt[r, lb] = -1 if (r + lb) % 2 else n_blocks + lb
    dk = D // 2 if bits == 4 else D
    shape = (n_blocks, BS, HKV, dk)
    if bits == 16:
        k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        k, v = k.bfloat16(), v.bfloat16()
    else:
        lo = -128 if bits == 4 else -127
        k = torch.from_numpy(rng.integers(lo, 128, shape).astype(np.int8))
        v = torch.from_numpy(rng.integers(lo, 128, shape).astype(np.int8))
    sshape = (b, HKV) if w is None else (b, w, HKV)
    ks = torch.from_numpy(rng.uniform(0.01, 0.05, sshape).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.01, 0.05, sshape).astype(np.float32))
    qshape = (b, HKV, HG, D) if w is None else (b, w, HKV, HG, D)
    q = torch.from_numpy(rng.standard_normal(qshape).astype(np.float32))
    names = ("k_scale", "v_scale") if w is None else ("k_ladder", "v_ladder")
    return dict(q=q, k_pool=k, v_pool=v, token_idx=torch.from_numpy(tidx),
                block_table=torch.from_numpy(bt), pos=torch.from_numpy(pos),
                **dict(zip(names, (ks, vs))))


@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_split_merge_model_matches_plain_k1(bits, window, n_splits):
    x = _inputs(bits)
    want = PA.paged_attention_ref(**x, bits=bits, window=window)
    got = split_merge_model(**x, bits=bits, window=window, n_splits=n_splits)
    _close(got, want)
    assert torch.all(got[-1] == 0)                # dead row: exact zeros
    assert torch.all(want[2] != 0)                # last-split-only row lives


@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("w,row_tile", [(5, None), (17, 12)])
def test_split_merge_model_matches_plain_k2(bits, window, n_splits, w,
                                            row_tile):
    """K2: the serve's window (one row tile) and a 17-query window cut into
    row tiles of 12 rows (W·Hg 34 → 3 tiles), so tiles span queries."""
    x = _inputs(bits, w=w)
    want = PA.paged_attention_multi_ref(**x, bits=bits, window=window)
    ladders = dict(x, k_scale=x["k_ladder"], v_scale=x["v_ladder"])
    del ladders["k_ladder"], ladders["v_ladder"]
    got = split_merge_model(**ladders, bits=bits, window=window,
                            n_splits=n_splits, row_tile=row_tile)
    _close(got, want)
    assert torch.all(got[-1] == 0)
