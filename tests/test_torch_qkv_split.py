"""The split-context design of K4 (int8-KV decode attention on the
contiguous cache), on the CPU: the host planner, and a plain-torch model of
the kernel's algorithm against its plain version
(``qkv_attention_cache_ref``) and the JAX package
(``qkv_attention_pallas`` in interpret mode, ``ref.qkv_attention_ref``).

The model follows the kernel step by step: a group's columns ``min(len,
S)`` (all S when ``len <= 0``: every column masked, uniform weights) in
64-column tiles, contiguous splits of tiles, splits at or past the group's
columns skipped (split 0 always runs), an online softmax over each split's
tiles on the int grid (k_scale and D^-½ after the contraction) giving an
f32 ``(m, l, acc)`` partial per query row, then — for a group with more
than one live split — the merge in split order, v_scale after it. It must
equal the plain version within 1e-6 times the larger of 1 and the case's
largest output at 1, 2, 3 and 7 splits: both sides sum in f32 in different
orders, on the int grid here (sums up to 127 per element before the
scales). A group's valid columns are a prefix, so a split is dead only
when every later one is; the edge the merge sees is a last split holding
one valid column. The CUDA kernel itself is held to the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.qkv_attention import qkv_attention_pallas
from repro_torch.kernels import qkv_attention as QK

NEG = -1e30
T = QK.TILE_COLS


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hkv,s", [
    (8, 8, 1024), (8, 8, 4096), (1, 8, 4096), (8, 8, 1), (1, 1, 1),
    (8, 8, 1000), (1, 1, 1000), (1, 1, 4096), (3, 2, 200), (64, 32, 1024),
    (8, 8, 64), (8, 8, 65), (4, 8, 256), (1, 1, 65536)])
def test_split_plan_covers_every_column_tile_once(b, hkv, s):
    n_tiles = -(-s // T)
    splits, per = QK.split_plan(b, hkv, s)
    assert 1 <= per <= QK.MAX_SPLIT_TILES
    seen = np.zeros(n_tiles, int)
    for i in range(splits):
        lo, hi = i * per, min(n_tiles, (i + 1) * per)
        assert lo < hi                            # no split is empty
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    if b * hkv * n_tiles >= 2 * QK.SM_COUNT:
        assert b * hkv * splits >= QK.SM_COUNT    # the card fills


def test_split_plan_at_the_main_path_shapes():
    """Phase 2's and the serve's shape (B·Hkv 64, S 1024): 8 splits of 2
    tiles, 512 blocks, one wave at 4 per SM; S 4096: splits of at most 2
    tiles; one group of S 4096: a split per tile; no columns: one split."""
    assert QK.split_plan(8, 8, 1024) == (8, 2)
    assert QK.split_plan(8, 8, 4096) == (32, 2)
    assert QK.split_plan(1, 8, 4096) == (64, 1)
    assert QK.split_plan(8, 8, 0) == (1, 1)
    assert QK.split_plan(8, 8, 1) == (1, 1)


def test_route_rule_and_limits():
    assert QK.route_of(torch.bfloat16, 64) == "tensor_cores"
    assert QK.route_of(torch.bfloat16, 36) == "cuda_cores"
    assert QK.route_of(torch.float32, 64) == "cuda_cores"
    for d, hg in [(64, 4), (4, 1), (256, 16), (36, 5)]:
        assert QK.supports(d, hg) is None
    assert "head dim" in QK.supports(66, 4)
    assert "head dim" in QK.supports(260, 4)
    assert "Hg" in QK.supports(64, 17)


# ---------------------------------------------------------------------------
# the split-and-merge model
# ---------------------------------------------------------------------------

def split_merge_model(q, k, v, k_scale, v_scale, lengths, *, n_splits):
    """K4's algorithm in plain torch (f32) on the cache's layout (q ``[B,
    Hkv, Hg, D]``, k/v ``[B, S, Hkv, D]`` int8, scales and lengths ``[B,
    Hkv]``), with ``n_splits`` splits as the kernel cuts them (``per``
    tiles each, the last shorter). Returns the output and the number of
    live splits per group."""
    b, hkv, hg, d = q.shape
    s = k.shape[1]
    n_tiles = max(1, -(-s // T))
    per = -(-n_tiles // n_splits)
    splits = -(-n_tiles // per)
    qh = q.float() * d ** -0.5
    out = torch.zeros(b, hkv, hg, d)
    live = torch.zeros(b, hkv, dtype=torch.int64)
    for bi in range(b):
        for hi in range(hkv):
            n = int(lengths[bi, hi])
            uniform = n <= 0
            n_cols = s if uniform else min(n, s)
            kf = k[bi, :, hi].float()                    # the int grid
            vf = v[bi, :, hi].float()
            parts = []
            for sp in range(splits):
                c0 = sp * per * T
                if sp > 0 and c0 >= n_cols:
                    continue                              # returns at once
                m = torch.full((hg,), NEG)
                l = torch.zeros(hg)
                acc = torch.zeros(hg, d)
                for t in range(per):
                    cb = c0 + t * T
                    if cb >= n_cols:
                        break
                    cols = slice(cb, min(cb + T, n_cols))
                    if uniform:
                        sc = torch.zeros(hg, cols.stop - cb)
                    else:
                        sc = (qh[bi, hi] @ kf[cols].T) * k_scale[bi, hi]
                    m_new = torch.maximum(m, sc.max(dim=-1).values)
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ vf[cols]
                    m = m_new
                parts.append((m, l, acc))
            live[bi, hi] = len(parts)
            if len(parts) == 1:                           # written directly
                m, l, acc = parts[0]
                o = acc / l.clamp_min(1e-30)[:, None]
            else:
                big_m = torch.stack([m for m, _, _ in parts]).max(0).values
                big_l = torch.zeros(hg)
                o = torch.zeros(hg, d)
                for m, l, acc in parts:                  # split order
                    w = torch.exp(m - big_m)
                    big_l = big_l + l * w
                    o = o + acc * w[:, None]
                o = o / big_l.clamp_min(1e-30)[:, None]
            out[bi, hi] = o * v_scale[bi, hi]
    return out, live


S, HKV, HG, D = 448, 2, 4, 16        # 7 column tiles
# per row (head 0, head 1): every column masked (len 0, uniform over all S,
# every split live) and a short prefix; len >= S (the ring wrap) and S
# exactly; later splits wholly past len (20) and a tile edge (65); the last
# split holds one column at 3 and 7 splits (385 = 6·64 + 1) and len 1
ROWS = [(0, 30), (S + 5, S), (20, 65), (385, 1)]


def _inputs(qdtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    b = len(ROWS)
    k = rng.integers(-127, 128, (b, S, HKV, D)).astype(np.int8)
    v = rng.integers(-127, 128, (b, S, HKV, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.025, (b, HKV)).astype(np.float32)
    vs = rng.uniform(0.005, 0.025, (b, HKV)).astype(np.float32)
    q = rng.standard_normal((b, HKV, HG, D)).astype(np.float32)
    x = dict(q=torch.from_numpy(q).to(qdtype), k=torch.from_numpy(k),
             v=torch.from_numpy(v), k_scale=torch.from_numpy(ks),
             v_scale=torch.from_numpy(vs),
             lengths=torch.tensor(ROWS, dtype=torch.int32))
    return x


def _close(got, want):
    tol = 1e-6 * max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_split_merge_model_matches_plain(n_splits, qdtype):
    x = _inputs(qdtype, seed=n_splits)
    want = QK.qkv_attention_cache_ref(**x)
    got, live = split_merge_model(**x, n_splits=n_splits)
    _close(got, want)
    per = -(-7 // n_splits)
    splits = -(-7 // per)
    assert live[0, 0] == splits                   # len 0: every split live
    assert live[1, 0] == live[1, 1] == splits     # len >= S: all S columns
    assert live[2, 0] == 1                        # 20: later splits skipped
    assert live[3, 1] == 1
    if n_splits in (3, 7):                        # 385: the last split holds
        assert live[3, 0] == splits               # column 384 alone
    # len 0: the mean of the dequantized V over all S columns
    mean_v = x["v"][0, :, 0].float().mean(dim=0) * x["v_scale"][0, 0]
    _close(got[0, 0], mean_v.expand(HG, D))


@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_split_merge_model_matches_jax(n_splits, qdtype):
    """The same model against ``qkv_attention_pallas`` (interpret mode, the
    Pallas layout ``[G, S, D]``, 64-column blocks) and, on each group's
    valid prefix, against ``ref.qkv_attention_ref``. Tolerance 1e-5 as in
    ``tests/test_torch_qkv_attention.py``: JAX dequantizes before the dot,
    the model scales after it."""
    x = _inputs(qdtype, seed=10 + n_splits)
    got, _ = split_merge_model(**x, n_splits=n_splits)
    b = len(ROWS)

    def groups(t):
        return jnp.asarray(t.numpy().transpose(0, 2, 1, 3).reshape(
            b * HKV, S, D))

    qj = jnp.asarray(x["q"].float().numpy().reshape(b * HKV, HG, D))
    if qdtype == torch.bfloat16:
        qj = qj.astype(jnp.bfloat16)
    want = qkv_attention_pallas(
        qj, groups(x["k"]), groups(x["v"]),
        jnp.asarray(x["k_scale"].numpy().reshape(-1)),
        jnp.asarray(x["v_scale"].numpy().reshape(-1)),
        jnp.asarray(x["lengths"].numpy().reshape(-1)), block_s=64,
        interpret=True)
    flat = got.numpy().reshape(b * HKV, HG, D)
    np.testing.assert_allclose(flat, np.asarray(want), atol=1e-5, rtol=0)
    for gi, n in enumerate(x["lengths"].numpy().reshape(-1)):
        bi, hi = divmod(gi, HKV)
        n = S if n <= 0 else min(int(n), S)
        kq = jnp.asarray(x["k"][bi, :n, hi].numpy())
        vq = jnp.asarray(x["v"][bi, :n, hi].numpy())
        one = ref.qkv_attention_ref(
            qj[gi][None, :, None, :],
            jnp.broadcast_to(kq[None, None], (1, HG, n, D)),
            jnp.broadcast_to(vq[None, None], (1, HG, n, D)),
            float(x["k_scale"][bi, hi]), float(x["v_scale"][bi, hi]))
        if int(x["lengths"][bi, hi]) <= 0:       # uniform: the mean of V
            one = jnp.broadcast_to(
                (vq.astype(jnp.float32) * float(x["v_scale"][bi, hi]))
                .mean(axis=0), (1, HG, 1, D))
        np.testing.assert_allclose(flat[gi], np.asarray(one)[0, :, 0, :],
                                   atol=1e-5, rtol=0)


def test_wrapper_on_the_cpu_takes_the_plain_version():
    """CPU tensors take the plain version and count no launch."""
    x = _inputs()
    n0 = QK.qkv_attention.launches
    got = QK.qkv_attention(**x)
    assert QK.qkv_attention.launches == n0
    assert torch.equal(got, QK.qkv_attention_cache_ref(**x))
