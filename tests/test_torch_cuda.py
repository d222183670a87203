"""The port's CUDA kernels against their plain versions, on the card: K1
and K2 (paged attention: small tables, and long ones that the kernels cut
into several splits, block sizes 24 and 128, windows of 68 and 80 query
rows, two calls bitwise equal), K3 (dequant-matmul: within the summation-order
bound 4·K·2^-24·(|x|@|w|), products of bf16 operands being exact in f32;
the split-K decode path at M 1–16 with one and many splits, ragged and
unaligned shapes, two calls bitwise equal; the prefill paths, wgmma where
TMA can describe the operands and mma.sync elsewhere, at M 17–2048 with
ragged K and N),
K4 (int8-KV decode attention on the contiguous cache) and K5 (per-tensor
fake-quant: bit for bit).

These tests need an NVIDIA GPU with ``nvcc`` (the kernels have no CPU mode)
and skip elsewhere; they import no JAX, so they run on a machine that has
only the port's dependencies:

  python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import aquant as AQ
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import qkv_attention as QK
from repro_torch.kernels import qmatmul as QM


def _inputs(bits: int, gen: torch.Generator, b=6, hkv=2, hg=4, d=64,
            bs=8, n_lblk=6):
    """Fragmented tables with both unmapped sentinels, ragged lengths
    (7, 8, 9, 16, 17 at bs 8) and one dead row, on the card."""
    lengths = (7, 8, 9, 16, 17)
    n_blocks = b * n_lblk + 2
    perm = torch.randperm(n_blocks, generator=gen).tolist()
    bt = torch.full((b, n_lblk), n_blocks, dtype=torch.int32)
    tidx = torch.full((n_blocks, bs), -1, dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int32)
    for r, n in enumerate(lengths):
        pos[r] = n - 1
        for lb in range(n_lblk):
            if lb * bs < n:
                phys = perm.pop()
                bt[r, lb] = phys
                t = lb * bs + torch.arange(bs)
                tidx[phys] = torch.where(t < n, t, -1).int()
            elif lb % 2:
                bt[r, lb] = -1
    bt[-1] = -1                                   # the dead row
    dk = d // 2 if bits == 4 else d
    shape = (n_blocks, bs, hkv, dk)
    if bits == 16:
        k, v = (torch.randn(shape, generator=gen).bfloat16() for _ in "kv")
    else:
        k, v = (torch.randint(-127, 128, shape, generator=gen).to(torch.int8)
                for _ in "kv")
    ks, vs = (0.01 + 0.04 * torch.rand((b, hkv), generator=gen)
              for _ in "kv")
    q = torch.randn((b, hkv, hg, d), generator=gen).bfloat16()
    x = dict(q=q, k_pool=k, v_pool=v, k_scale=ks, v_scale=vs,
             token_idx=tidx, block_table=bt, pos=pos)
    return {name: t.cuda() for name, t in x.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_paged_attention_kernel_matches_plain(bits, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x = _inputs(bits, torch.Generator().manual_seed(bits + window))
    n0 = PA.paged_attention.launches
    got = PA.paged_attention(**x, bits=bits, window=window)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == n0 + 1
    want = PA.paged_attention_ref(**x, bits=bits, window=window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.all(got[-1] == 0)                # dead row: exact zeros
    assert np.isfinite(got.cpu().numpy()).all()


def _window_inputs(bits: int, gen: torch.Generator, w=5, b=6, hkv=2, hg=4,
                   d=64, bs=8, n_lblk=6):
    """Window inputs: fragmented tables with both sentinels, rows whose
    window starts at 7, 8, 9, 16 and 43 (the last runs past capacity),
    and one dead row, on the card."""
    starts = (7, 8, 9, 16, n_lblk * bs - 5)
    n_blocks = b * n_lblk + 2
    perm = torch.randperm(n_blocks, generator=gen).tolist()
    bt = torch.full((b, n_lblk), n_blocks, dtype=torch.int32)
    tidx = torch.full((n_blocks, bs), -1, dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int32)
    for r, n in enumerate(starts):
        pos[r] = n
        for lb in range(n_lblk):
            if lb * bs < n + w:
                phys = perm.pop()
                bt[r, lb] = phys
                t = lb * bs + torch.arange(bs)
                tidx[phys] = torch.where(t < n + w, t, -1).int()
            elif lb % 2:
                bt[r, lb] = -1
    bt[-1] = -1                                   # the dead row
    shape = (n_blocks, bs, hkv, d)
    if bits == 16:
        k, v = (torch.randn(shape, generator=gen).bfloat16() for _ in "kv")
    else:
        k, v = (torch.randint(-127, 128, shape, generator=gen).to(torch.int8)
                for _ in "kv")
    kl, vl = (0.01 + 0.04 * torch.rand((b, w, hkv), generator=gen)
              for _ in "kv")
    q = torch.randn((b, w, hkv, hg, d), generator=gen).bfloat16()
    x = dict(q=q, k_pool=k, v_pool=v, k_ladder=kl, v_ladder=vl,
             token_idx=tidx, block_table=bt, pos=pos)
    return {name: t.cuda() for name, t in x.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bits", [16, 8])
def test_paged_attention_multi_kernel_matches_plain(bits, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x = _window_inputs(bits, torch.Generator().manual_seed(bits + window))
    n0 = PA.paged_attention_multi.launches
    got = PA.paged_attention_multi(**x, bits=bits, window=window)
    torch.cuda.synchronize()
    assert PA.paged_attention_multi.launches == n0 + 1
    want = PA.paged_attention_multi_ref(**x, bits=bits, window=window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.all(got[-1] == 0)                # dead row: exact zeros
    assert np.isfinite(got.cpu().numpy()).all()


def _split_inputs(bits: int, gen: torch.Generator, *, w=None, b=6, hkv=2,
                  hg=4, d=64, bs=16, n_lblk=256):
    """Long tables that the kernels cut into several splits: row 0 near
    full context, row 1 whose keys all lie in the last 4 logical blocks
    (every other split empty), rows of random length with unmapped holes
    (both sentinels), and a dead last row; on the card. ``w`` makes K2's
    window inputs (ladders, row 0's window past capacity)."""
    nw = 1 if w is None else w
    cap = n_lblk * bs
    n_blocks = b * n_lblk + 3
    perm = torch.randperm(n_blocks, generator=gen).tolist()
    bt = torch.full((b, n_lblk), n_blocks, dtype=torch.int32)
    tidx = torch.full((n_blocks, bs), -1, dtype=torch.int32)
    pos = torch.randint(1, cap - nw, (b,), generator=gen, dtype=torch.int32)
    pos[0] = pos[1] = cap - 2
    for r in range(b - 1):
        for lb in range(n_lblk):
            live = lb * bs <= pos[r] + nw - 1 and (r != 1 or lb >= n_lblk - 4)
            if live and lb % 7 != 5:
                phys = perm.pop()
                bt[r, lb] = phys
                t = lb * bs + torch.arange(bs)
                tidx[phys] = torch.where(t <= pos[r] + nw + 1, t, -1).int()
            else:
                bt[r, lb] = -1 if lb % 2 else n_blocks + 1
    dk = d // 2 if bits == 4 else d
    shape = (n_blocks, bs, hkv, dk)
    if bits == 16:
        k, v = (torch.randn(shape, generator=gen).bfloat16() for _ in "kv")
    else:
        lo = -128 if bits == 4 else -127
        k, v = (torch.randint(lo, 128, shape, generator=gen).to(torch.int8)
                for _ in "kv")
    sshape = (b, hkv) if w is None else (b, w, hkv)
    ks, vs = (0.01 + 0.04 * torch.rand(sshape, generator=gen) for _ in "kv")
    qshape = (b, hkv, hg, d) if w is None else (b, w, hkv, hg, d)
    q = torch.randn(qshape, generator=gen).bfloat16()
    names = ("k_scale", "v_scale") if w is None else ("k_ladder", "v_ladder")
    x = dict(q=q, k_pool=k, v_pool=v, token_idx=tidx, block_table=bt,
             pos=pos, **dict(zip(names, (ks, vs))))
    return {name: t.cuda() for name, t in x.items()}


def _check_split_kernel(fn, ref, x, kw, splits_at_least):
    q = x["q"]
    w = 1 if q.dim() == 4 else q.shape[1]
    row_tiles, _ = PA.row_plan(w, q.shape[-2], q.shape[-1])
    splits, _ = PA.split_plan(q.shape[0], q.shape[-3], row_tiles,
                              x["block_table"].shape[1] * x["token_idx"].shape[1])
    assert splits >= splits_at_least
    got = fn(**x, **kw)
    again = fn(**x, **kw)
    torch.cuda.synchronize()
    want = ref(**x, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(got, again)                # bitwise deterministic
    assert torch.all(got[-1] == 0)                # dead row: exact zeros
    assert np.isfinite(got.cpu().numpy()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_paged_attention_kernel_many_splits(bits, window):
    """K1 at n_lblk 256 (several splits), the last-split-only row, both
    windows; two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x = _split_inputs(bits, torch.Generator().manual_seed(20 + bits + window))
    _check_split_kernel(PA.paged_attention, PA.paged_attention_ref, x,
                        dict(bits=bits, window=window), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,n_lblk", [(24, 43), (128, 8)])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_paged_attention_kernel_any_block_size(bits, bs, n_lblk):
    """K1 at block sizes the first port refused or tiled unevenly: 24 (does
    not divide a 64-column tile) and 128 (two tiles per block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x = _split_inputs(bits, torch.Generator().manual_seed(bs + bits),
                      bs=bs, n_lblk=n_lblk)
    _check_split_kernel(PA.paged_attention, PA.paged_attention_ref, x,
                        dict(bits=bits, window=0), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("w,hkv,hg,d", [(17, 2, 4, 64), (5, 2, 16, 128),
                                        (5, 2, 4, 64)])
@pytest.mark.parametrize("bits", [16, 8])
def test_paged_attention_multi_kernel_wide_windows(bits, w, hkv, hg, d):
    """K2 at W·Hg 68 (Hg 4, draft_k 16: three row tiles) and 80 (Hg 16,
    W 5, D 128), and the serve's 20, over several splits; two calls
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x = _split_inputs(bits, torch.Generator().manual_seed(w * hg + bits),
                      w=w, hkv=hkv, hg=hg, d=d, n_lblk=64)
    _check_split_kernel(PA.paged_attention_multi,
                        PA.paged_attention_multi_ref, x,
                        dict(bits=bits, window=0), 2)


@pytest.mark.cuda
def test_server_refuses_k4_shapes_on_cuda_auto():
    """On the card ``"auto"`` resolves to the kernel backend, and a kv8
    model that K4 cannot take (Hg 17) is refused at construction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    cfg = get_smoke("granite-3-2b")
    bad = dataclasses.replace(cfg, n_heads=34, n_kv=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    with pytest.raises(ValueError, match="Hg=17.*gather"):
        AdaptiveServer(bad, params, engine, ServingConfig(
            slots=32, kv_bits=8, paged_backend="auto"), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 2048, 3072), (5, 100, 70),
                                   (33, 96, 40), (300, 1000, 256)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_qmatmul_kernel_matches_plain(m, k, n, bits, xdtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(m + k + n + bits)
    x = torch.randn((m, k), generator=gen).to(xdtype).cuda()
    if bits <= 4:
        w_q = torch.randint(-128, 128, (k, n // 2), generator=gen)
    else:
        w_q = torch.randint(-127, 128, (k, n), generator=gen)
    w_q = w_q.to(torch.int8).cuda()
    scale = (0.001 + 0.01 * torch.rand((n,), generator=gen)).cuda()
    n0 = QM.qmatmul.launches
    got = QM.qmatmul(x, w_q, scale, bits=bits)
    torch.cuda.synchronize()
    assert QM.qmatmul.launches == n0 + 1
    want = QM.qmatmul_ref(x, w_q, scale, bits)
    wb = QM.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * k * 2.0 ** -24 * (x.bfloat16().float().abs() @ wb.abs())
    assert bool(((got - want).abs() <= tol).all())
    fused = QM.qmatmul(x, w_q, scale, bits=bits, out_bits=6, out_scale=0.5)
    assert torch.equal(fused, QM.requant_ref(got, 0.5, 6))


def _qmatmul_case(m, k, n, bits, xdtype, seed, x_offset=0, w_offset=0):
    """x and the weights on the card; ``x_offset`` / ``w_offset`` elements
    shift each into a larger buffer, so its pointer is not 16-byte
    aligned."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((m * k + x_offset,), generator=gen).to(xdtype).cuda()
    x = x[x_offset:].view(m, k)
    cols = n // 2 if bits <= 4 else n
    lo = -128 if bits <= 4 else -127
    w_q = torch.randint(lo, 128, (k * cols + w_offset,), generator=gen)
    w_q = w_q.to(torch.int8).cuda()[w_offset:].view(k, cols)
    scale = (0.001 + 0.01 * torch.rand((n,), generator=gen)).cuda()
    return x, w_q, scale


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bits,offsets", [
    (1, 2048, 3072, 8, (0, 0)), (8, 2048, 3072, 8, (0, 0)),
    (16, 2048, 3072, 4, (0, 0)), (17, 2048, 3072, 8, (0, 0)),
    (8, 40, 256, 8, (0, 0)),            # K smaller than one 64-row step
    (8, 64, 512, 4, (0, 0)),            # one split
    (8, 8256, 2048, 8, (0, 0)),         # many splits, the last one step
    (5, 1000, 384, 4, (0, 0)),          # K not a multiple of the split
    (8, 640, 69, 8, (0, 0)),            # N odd at W8
    (8, 2048, 70, 8, (0, 0)),           # rows not 16-byte aligned (W8)
    (8, 2048, 40, 4, (0, 0)),           # rows not 16-byte aligned (W4)
    (16, 1024, 256, 8, (1, 3)),         # x and w_q pointers unaligned
    (8, 2048, 16384, 4, (0, 0)), (8, 8192, 2048, 4, (0, 0))])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_qmatmul_decode_split_kernel(m, k, n, bits, offsets, xdtype):
    """The split-K decode path (and M 17, the first prefill M) within the
    summation-order bound, two calls bitwise equal, one launch counted per
    call, the fused requant equal to ``requant_ref`` of the kernel's own
    sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, w_q, scale = _qmatmul_case(m, k, n, bits, xdtype, m + k + n + bits,
                                  *offsets)
    n0 = QM.qmatmul.launches
    got = QM.qmatmul(x, w_q, scale, bits=bits)
    again = QM.qmatmul(x, w_q, scale, bits=bits)
    torch.cuda.synchronize()
    assert QM.qmatmul.launches == n0 + 2
    assert torch.equal(got, again)
    want = QM.qmatmul_ref(x, w_q, scale, bits)
    wb = QM.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * k * 2.0 ** -24 * (x.bfloat16().float().abs() @ wb.abs())
    assert bool(((got - want).abs() <= tol).all())
    for out_bits, out_scale in ((8, 0.25), (4, 0.5)):
        fused = QM.qmatmul(x, w_q, scale, bits=bits, out_bits=out_bits,
                           out_scale=out_scale)
        assert torch.equal(fused, QM.requant_ref(got, out_scale, out_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bits,offsets,route", [
    (17, 2048, 3072, 8, (0, 0), "wgmma"),     # the first prefill M
    (128, 2048, 3072, 4, (0, 0), "wgmma"),    # one row tile
    (2048, 2048, 3072, 8, (0, 0), "wgmma"),   # 128-column tiles
    (2048, 2048, 16384, 4, (0, 0), "wgmma"),  # 256-column tiles
    (300, 8192, 2048, 8, (0, 0), "wgmma"),    # ragged M, 128 K steps
    (100, 2056, 3072, 8, (0, 0), "wgmma"),    # ragged K: TMA's zero fill
    (100, 2056, 3072, 4, (0, 0), "wgmma"),
    (100, 2048, 3104, 8, (0, 0), "wgmma"),    # ragged N: masked store
    (100, 2048, 3104, 4, (0, 0), "wgmma"),
    (100, 2048, 3080, 8, (0, 0), "mma_sync"),  # rows not 16-byte multiples
    (100, 2048, 70, 8, (0, 0), "mma_sync"),
    (100, 1024, 256, 8, (1, 0), "mma_sync"),  # x base not 16-byte aligned
    (100, 1024, 256, 4, (0, 3), "mma_sync")])  # w base not 16-byte aligned
def test_qmatmul_prefill_kernel(m, k, n, bits, offsets, route):
    """Prefill (bf16 x) on the route the rule gives: within the
    summation-order bound, two calls bitwise equal, one launch counted per
    call, the fused requant equal to ``requant_ref`` of the kernel's own
    sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, w_q, scale = _qmatmul_case(m, k, n, bits, torch.bfloat16,
                                  m + k + n + bits, *offsets)
    n0 = QM.qmatmul.launches
    got = QM.qmatmul(x, w_q, scale, bits=bits)
    assert QM.qmatmul.last_route == route
    again = QM.qmatmul(x, w_q, scale, bits=bits)
    torch.cuda.synchronize()
    assert QM.qmatmul.launches == n0 + 2
    assert torch.equal(got, again)
    want = QM.qmatmul_ref(x, w_q, scale, bits)
    wb = QM.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * k * 2.0 ** -24 * (x.float().abs() @ wb.abs())
    assert bool(((got - want).abs() <= tol).all())
    for out_bits, out_scale in ((8, 0.25), (4, 0.5)):
        fused = QM.qmatmul(x, w_q, scale, bits=bits, out_bits=out_bits,
                           out_scale=out_scale)
        assert QM.qmatmul.last_route == route
        assert torch.equal(fused, QM.requant_ref(got, out_scale, out_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_qmatmul_prefill_routes_agree(bits, monkeypatch):
    """The mma.sync kernel, given operands the rule sends to wgmma, lies
    within the same bound; an f32 x takes it by the rule; the entry point
    refuses the wgmma kernel for operands TMA cannot describe."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, w_q, scale = _qmatmul_case(256, 2048, 3072, bits, torch.bfloat16, 7)
    want = QM.qmatmul_ref(x, w_q, scale, bits)
    wb = QM.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * 2048 * 2.0 ** -24 * (x.float().abs() @ wb.abs())
    got = QM.qmatmul(x, w_q, scale, bits=bits)
    torch.cuda.synchronize()
    assert QM.qmatmul.last_route == "wgmma"
    assert bool(((got - want).abs() <= tol).all())
    got = QM.qmatmul(x.float(), w_q, scale, bits=bits)
    torch.cuda.synchronize()
    assert QM.qmatmul.last_route == "mma_sync"
    assert bool(((got - want).abs() <= tol).all())
    monkeypatch.setattr(QM, "route_of", lambda *a: "mma_sync")
    got = QM.qmatmul(x, w_q, scale, bits=bits)
    torch.cuda.synchronize()
    assert QM.qmatmul.last_route == "mma_sync"
    assert bool(((got - want).abs() <= tol).all())
    monkeypatch.setattr(QM, "route_of", lambda *a: "wgmma")
    with pytest.raises(RuntimeError, match="wgmma"):
        QM.qmatmul(x.float(), w_q, scale, bits=bits)


@pytest.mark.cuda
def test_qmatmul_decode_edges_m0_k0():
    """M 0 gives an empty result; K 0 gives zeros (and requant of zeros)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    w = torch.zeros((0, 64), dtype=torch.int8, device="cuda")
    s = torch.ones(64, device="cuda")
    out = QM.qmatmul(torch.zeros((8, 0), device="cuda"), w, s, bits=8,
                     out_bits=8, out_scale=0.25)
    torch.cuda.synchronize()
    assert out.shape == (8, 64) and not out.any()
    w = torch.zeros((32, 64), dtype=torch.int8, device="cuda")
    out = QM.qmatmul(torch.zeros((0, 32), device="cuda"), w, s, bits=8)
    assert out.shape == (0, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(257, 96), (2048, 4099), (3,)])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("po2", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aquant_kernel_matches_plain_bitwise(shape, bits, po2, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(bits + len(shape))
    x = (torch.randn(shape, generator=gen) * 3.7).to(dtype).cuda()
    n0 = AQ.aquant.launches
    got = AQ.aquant(x, bits, po2)
    torch.cuda.synchronize()
    assert AQ.aquant.launches == n0 + 1
    want = AQ.aquant_ref(x, bits, po2)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got.view(view), want.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [200, 1024])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
def test_qkv_attention_kernel_matches_plain(s, qdtype, strided):
    """K4 on the contiguous cache's layout at a ragged S, with lengths 0
    (uniform weights over all S), 1, a tile edge (63, 64, 65) and S;
    ``strided`` reads K/V as a view with one padding KV head per slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(s + int(strided))
    b, hkv, hg, d = 3, 2, 4, 64
    lens = torch.tensor([[0, 1], [63, 64], [65, s]], dtype=torch.int32)
    kv = [torch.randint(-127, 128, (b, s, hkv + int(strided), d),
                        generator=gen).to(torch.int8) for _ in "kv"]
    k, v = (x.cuda()[:, :, :hkv] for x in kv)
    assert k.is_contiguous() != strided
    ks, vs = ((0.005 + 0.02 * torch.rand((b, hkv), generator=gen)).cuda()
              for _ in "kv")
    q = torch.randn((b, hkv, hg, d), generator=gen).to(qdtype).cuda()
    n0 = QK.qkv_attention.launches
    got = QK.qkv_attention(q, k, v, ks, vs, lens.cuda())
    torch.cuda.synchronize()
    assert QK.qkv_attention.launches == n0 + 1
    want = QK.qkv_attention_cache_ref(q, k, v, ks, vs, lens.cuda())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    mean_v = (v[0, :, 0].float() * vs[0, 0]).mean(dim=0)   # length 0
    torch.testing.assert_close(got[0, 0], mean_v.expand(hg, d), atol=1e-5,
                               rtol=0)


def _qkv_case(b, s, hkv, hg, d, lens, qdtype, seed):
    """q, a K/V layer view of a stacked int8 cache ``[2, B, S, Hkv, D]``,
    scales and per-row lengths ``[B, Hkv]`` on the card."""
    gen = torch.Generator().manual_seed(seed)
    k, v = (torch.randint(-127, 128, (2, b, s, hkv, d), generator=gen)
            .to(torch.int8).cuda()[1] for _ in "kv")
    ks, vs = ((0.005 + 0.02 * torch.rand((b, hkv), generator=gen)).cuda()
              for _ in "kv")
    q = torch.randn((b, hkv, hg, d), generator=gen).to(qdtype).cuda()
    lengths = torch.tensor(lens, dtype=torch.int32)[:, None].expand(b, hkv)
    return q, k, v, ks, vs, lengths.contiguous().cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hkv,hg,d,lens", [
    (3, 1000, 2, 4, 64, [1000, 0, 937]),        # ragged S, 16 splits of 1
    (2, 64, 2, 4, 64, [64, 0]),                 # one split
    (8, 1024, 8, 4, 64, [0, 1, 63, 64, 65, 1024, 300, 544]),  # 8 x 2
    (1, 4096, 1, 16, 128, [4096]),              # 64 splits, Hg 16
    (2, 300, 3, 1, 256, [129, 300]),            # Hg 1, D 256
    (2, 200, 2, 5, 36, [0, 77])])               # D % 16 != 0
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_qkv_attention_split_kernel(b, s, hkv, hg, d, lens, qdtype):
    """The split-context K4 against its plain version within 1e-5, two
    calls bitwise equal, one counted launch per call; bf16 q also on the
    CUDA-core q·K route where the rule sends it to the tensor cores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x = _qkv_case(b, s, hkv, hg, d, lens, qdtype, s + d)
    want = QK.qkv_attention_cache_ref(*x)
    routes = [QK.route_of(qdtype, d)]
    if routes[0] == "tensor_cores":
        routes.append("cuda_cores")
    rule = QK.route_of
    try:
        for route in routes:
            QK.route_of = lambda *a, route=route: route  # noqa: E731
            n0 = QK.qkv_attention.launches
            got = QK.qkv_attention(*x)
            again = QK.qkv_attention(*x)
            torch.cuda.synchronize()
            assert QK.qkv_attention.launches == n0 + 2
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
            assert torch.equal(got, again), route
    finally:
        QK.route_of = rule


@pytest.mark.cuda
def test_qkv_attention_kernel_in_a_cuda_graph():
    """A K4 call (two launches: splits and merge) captured in a CUDA graph
    replays to the eager call's output, after the lengths change on the
    device: the wrapper never reads them on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    q, k, v, ks, vs, lengths = _qkv_case(
        4, 1024, 2, 4, 64, [1, 700, 0, 1024], torch.bfloat16, 5)
    QK.qkv_attention(q, k, v, ks, vs, lengths)       # build and warm up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = QK.qkv_attention(q, k, v, ks, vs, lengths)
    lengths.copy_(torch.tensor([[900, 900], [2, 2], [65, 65], [0, 0]],
                               dtype=torch.int32, device="cuda"))
    g.replay()
    torch.cuda.synchronize()
    want = QK.qkv_attention(q, k, v, ks, vs, lengths)
    assert torch.equal(out, want)
    torch.testing.assert_close(
        out, QK.qkv_attention_cache_ref(q, k, v, ks, vs, lengths),
        atol=1e-5, rtol=0)
