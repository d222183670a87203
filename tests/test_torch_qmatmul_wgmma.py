"""The wgmma prefill design of the dequant-matmul kernel (K3, M > 16), on the
CPU: the dispatch rule that sends a call to it, a model of the on-chip
layouts it relies on, and a plain tiled model of its K-ring.

Route (a) of ``csrc/qmatmul.cu``: a TMA ring brings the bf16 x tile (128-byte
swizzle) and the RAW int8/int4 weight tile; the consumer threads dequantize
the raw tile into a bf16 ``[64, 128]`` N-major B tile written in the
canonical 128-byte-swizzled layout (atoms of 8 K rows × 64 columns, 1024
bytes, ``[K row / 8][column / 64]``, the 16-byte chunk ``c`` of a row stored
at chunk ``c ^ (row % 8)``), and SS ``wgmma`` reads it back through a
matrix descriptor (N atoms ``LBO`` = 1024 bytes apart, 8-row K groups
``SBO`` = 2048 bytes apart, the address bits 4–6 XORed with bits 7–9).
The model below writes every element as the kernel's threads do, reads it
back as the descriptor addresses it, and must give ``dequant_ref``'s bf16
values bit for bit; likewise x as TMA swizzles it and the A descriptor
reads it, the accumulator fragment's store map, and the grouped raster.

The tiled model follows the kernel's K-ring step by step: ragged K, M and N
read as zeros (TMA's zero fill), each 64-row stage dequantized as the kernel
does it in registers, f32 sums per stage in ring order, the fused requant
(the kernel's formula) in the epilogue, and the M/N edges masked. Its sums
are held against the plain version and against the JAX reference
``qmatmul_pallas(..., interpret=True)`` on the zero-padded shapes, within
``4·K·2^-24·(|x|@|w|)`` elementwise: both sides multiply the same bf16
operands, whose products are exact in f32, and differ only in the order of
the f32 sums (the bound ``chip_smoke.py`` holds the kernel to). The fused
requant is compared bit for bit with ``requant_ref`` of the model's own
sums, and within one grid step (``out_scale``) of the reference's fused
requant, whose sums may round to the other side of a step boundary. The
CUDA kernel itself is checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul import qmatmul_pallas
from repro_torch.kernels import qmatmul as K
from repro_torch.kernels.build import SM_COUNT
from torch_threads import _one_thread  # noqa: F401

GRANITE = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)]
BK = 64                            # K rows per ring stage
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# the dispatch rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [17, 2048, 4096])
@pytest.mark.parametrize("k,n", GRANITE)
@pytest.mark.parametrize("bits", [8, 4])
def test_main_path_prefill_takes_wgmma(m, k, n, bits):
    """The four granite-3-2b linears at every prefill M, W8 and W4, from
    16-byte aligned bases."""
    assert K.route_of(m, k, n, bits, BF16, 256, 4096) == "wgmma"


@pytest.mark.parametrize("m,k,n,bits,dtype,x_ptr,w_ptr,route", [
    (1, 2048, 3072, 8, BF16, 0, 0, "splitk"),
    (16, 2048, 3072, 4, BF16, 0, 0, "splitk"),       # the last decode M
    (16, 2048, 3072, 8, torch.float32, 0, 0, "splitk"),
    (17, 2048, 3072, 8, BF16, 0, 0, "wgmma"),        # the first prefill M
    (17, 2048, 3072, 8, torch.float32, 0, 0, "mma_sync"),   # f32 x
    (2048, 2056, 3072, 8, BF16, 0, 0, "wgmma"),      # ragged K, K % 8 == 0
    (2048, 2052, 3072, 8, BF16, 0, 0, "mma_sync"),   # x rows not 16 bytes
    (2048, 2048, 3104, 8, BF16, 0, 0, "wgmma"),      # ragged N, N % 16 == 0
    (2048, 2048, 3104, 4, BF16, 0, 0, "wgmma"),      # N % 32 == 0 at int4
    (2048, 2048, 3088, 8, BF16, 0, 0, "wgmma"),
    (2048, 2048, 3088, 4, BF16, 0, 0, "mma_sync"),   # 1544-byte int4 rows
    (2048, 2048, 3080, 8, BF16, 0, 0, "mma_sync"),   # N % 16 == 8
    (2048, 2048, 3080, 4, BF16, 0, 0, "mma_sync"),
    (2048, 2048, 70, 8, BF16, 0, 0, "mma_sync"),     # 70-byte rows
    (2048, 2048, 70, 4, BF16, 0, 0, "mma_sync"),
    (100, 1024, 256, 8, BF16, 2, 0, "mma_sync"),     # x base off by 2 bytes
    (100, 1024, 256, 8, BF16, 0, 3, "mma_sync"),     # w base off by 3 bytes
    (100, 1024, 256, 8, BF16, 16, 48, "wgmma"),
    (100, 0, 256, 8, BF16, 0, 0, "mma_sync"),        # K 0: no tensor map
    (33, 96, 40, 8, BF16, 0, 0, "mma_sync"),
    (33, 96, 64, 4, BF16, 0, 0, "wgmma"),
])
def test_route_of(m, k, n, bits, dtype, x_ptr, w_ptr, route):
    assert K.route_of(m, k, n, bits, dtype, x_ptr, w_ptr) == route


TILES = ((256, 128), (128, 128))   # the wgmma kernel's output tiles


@pytest.mark.parametrize("m,rows", [(17, 128), (100, 128), (128, 128),
                                    (129, 256), (300, 256), (2048, 256),
                                    (4096, 256)])
def test_prefill_rows(m, rows):
    """256-row tiles (each weight tile dequantized once for 256 rows of x)
    wherever M exceeds one 128-row tile; 128 where a 256-row tile would
    multiply mostly zero rows."""
    assert K.prefill_rows(m) == rows
    assert (rows, K.WGMMA_COLS) in TILES


# ---------------------------------------------------------------------------
# the on-chip layouts of route (a)
# ---------------------------------------------------------------------------

def _sw128(addr):
    """The 128-byte swizzle: address bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _magic_dequant(w_q, scale, bits):
    """The kernel's in-register dequantization: the biased byte/nibble b as
    the f32 2^23 + b, minus 2^23 + bias, times the column's scale in f32,
    rounded to bf16 (bitwise ``dequant_ref`` in f32 then bf16)."""
    u = w_q.numpy().view(np.uint8)
    if bits <= 4:
        u = u ^ 0x88
        b = np.stack([u & 0x0F, u >> 4], -1).reshape(u.shape[0], -1)
        bias = 8
    else:
        b, bias = u ^ 0x80, 128
    q = (np.float32(2.0 ** 23) + b.astype(np.float32)) \
        - np.float32(2.0 ** 23 + bias)
    return torch.from_numpy(q * scale.numpy().astype(np.float32)).bfloat16()


def _b_tile_image(deq: torch.Tensor, bn: int) -> np.ndarray:
    """The shared-memory bytes of one bf16 B tile ([64, bn] dequantized
    weights) as the kernel's 256 consumer threads write them: thread ``tid``
    owns columns ``16·cg .. 16·cg + 15`` (``cg = tid % (bn / 16)``) of K rows
    ``r0 + p·rows`` and stores them as two 16-byte chunks ``c = 2·(cg % 4)``
    and ``c + 1`` of atom ``(k / 8)·(bn / 64) + cg / 4``, row ``k % 8``."""
    words = deq.view(torch.int16).numpy().view(np.uint16)
    img = np.full(BK * bn, 0xFFFF, np.uint32)     # 2-byte slots, unwritten
    n_cg = bn // 16
    rows = 256 // n_cg
    atoms_n = bn // 64
    for tid in range(256):
        cg, r0 = tid % n_cg, tid // n_cg
        c = 2 * (cg & 3)
        for p in range(BK // rows):
            k = r0 + p * rows
            r = k & 7
            row = ((k >> 3) * atoms_n + (cg >> 2)) * 1024 + r * 128
            for h in range(2):
                base = row + (((c + h) ^ r) << 4)
                for e in range(8):
                    slot = (base + 2 * e) // 2
                    assert img[slot] == 0xFFFF, "two writes to one address"
                    img[slot] = words[k, 16 * cg + 8 * h + e]
    assert not (img == 0xFFFF).any(), "an address never written"
    return img.astype(np.uint16)


def _b_descriptor_read(img: np.ndarray, kk: int, bn: int) -> np.ndarray:
    """What SS wgmma reads as B (16 K rows × bn columns, N-major, 128-byte
    swizzle) at K step ``kk``: start ``kk·2·SBO``, LBO 1024 between 64-column
    atoms, SBO ``bn / 64`` KB between 8-row K groups, rows 128 bytes apart
    inside an atom."""
    lbo, sbo = 1024, (bn // 64) * 1024
    start = kk * 2 * sbo
    out = np.empty((16, bn), np.uint16)
    for kl in range(16):
        for n in range(bn):
            a = (start + (n // 64) * lbo + (kl // 8) * sbo + (kl % 8) * 128
                 + (n % 64) * 2)
            out[kl, n] = img[_sw128(a) // 2]
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bits", [8, 4])
def test_b_tile_swizzle_roundtrips_to_dequant_ref(seed, bits):
    """Every weight of a stage lands at one address, and the descriptor's
    reads give ``dequant_ref``'s bf16 value of (k, n) bit for bit."""
    bn = K.WGMMA_COLS
    rng = np.random.default_rng(seed + bits)
    cols = bn // 2 if bits <= 4 else bn
    w_q = torch.from_numpy(rng.integers(-128, 128, (BK, cols)).astype(np.int8))
    scale = torch.from_numpy(
        (0.001 + 0.05 * rng.random(bn)).astype(np.float32))
    deq = _magic_dequant(w_q, scale, bits)
    want = K.dequant_ref(w_q, scale, bits).bfloat16()
    assert torch.equal(deq.view(torch.int16), want.view(torch.int16))
    img = _b_tile_image(deq, bn)
    ref = want.view(torch.int16).numpy().view(np.uint16)
    for kk in range(BK // 16):
        assert np.array_equal(_b_descriptor_read(img, kk, bn),
                              ref[16 * kk:16 * kk + 16])


def test_b_tile_stores_are_spread_over_the_banks():
    """A warp's 16-byte B-tile stores touch each of the eight 16-byte bank
    groups of a 128-byte line equally often (4 wavefronts for 512 bytes, the
    least there can be)."""
    for bn in (K.WGMMA_COLS,):
        n_cg = bn // 16
        atoms_n = bn // 64
        for warp in range(8):
            for h in range(2):
                hits = np.zeros(8, int)
                for tid in range(32 * warp, 32 * warp + 32):
                    cg, k = tid % n_cg, tid // n_cg
                    r = k & 7
                    addr = (((k >> 3) * atoms_n + (cg >> 2)) * 1024 + r * 128
                            + (((2 * (cg & 3) + h) ^ r) << 4))
                    hits[(addr % 128) // 16] += 1
                assert (hits == 4).all(), (bn, warp, h, hits)


@pytest.mark.parametrize("bm", [128, 256])
def test_x_tile_tma_swizzle_and_a_descriptor(bm):
    """x as TMA lays a [bm, 64] bf16 box down with the 128-byte swizzle
    (row m at 128·m, 16-byte chunk j at j ^ (m % 8)), read back as the
    K-major A of warpgroup ``wg``'s wgmma ``mt`` (rows ``bm/2·wg + 64·mt``):
    start ``128·(bm/2·wg + 64·mt) + 32·kk``, SBO 1024 between 8-row
    groups."""
    rng = np.random.default_rng(bm)
    x = rng.integers(0, 2 ** 16, (bm, BK)).astype(np.uint16)
    img = np.empty(bm * BK, np.uint16)
    for m in range(bm):
        for k in range(BK):
            img[(m * 128 + (((k // 8) ^ (m % 8)) * 16) + (k % 8) * 2) // 2] = \
                x[m, k]
    for wg in range(2):
        for mt in range(bm // 128):
            row0 = wg * bm // 2 + 64 * mt
            for kk in range(BK // 16):
                start = 128 * row0 + 32 * kk
                for ml in range(64):
                    for kl in range(16):
                        a = start + (ml // 8) * 1024 + (ml % 8) * 128 + kl * 2
                        assert img[_sw128(a) // 2] == \
                            x[row0 + ml, 16 * kk + kl]


@pytest.mark.parametrize("tile", TILES)
def test_accumulator_store_map_covers_the_tile_once(tile):
    """acc[mt][4i + 2h + q] of lane (g, t) in warp w of warpgroup wg is row
    bm/2·wg + 64·mt + 16w + g + 8h, column 8i + 2t + q: each element of the
    bm × bn tile once."""
    bm, bn = tile
    seen = np.zeros((bm, bn), int)
    for wg in range(2):
        for mt in range(bm // 128):
            for w in range(4):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for i in range(bn // 8):
                        for h in range(2):
                            for q in range(2):
                                row = bm // 2 * wg + 64 * mt + 16 * w + g
                                seen[row + 8 * h, 8 * i + 2 * t + q] += 1
    assert (seen == 1).all()


def _raster(block, m, n, bm, bn, group=8):
    """The kernel's grouped raster: ``block`` → (row tile, column tile)."""
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    per_group = group * tiles_n
    first = (block // per_group) * group
    size = min(tiles_m - first, group)
    inside = block % per_group
    return first + inside % size, inside // size


@pytest.mark.parametrize("m,n", [(2048, 16384), (2048, 3072), (4096, 3072),
                                 (17, 3104), (1000, 2048), (2176, 3104)])
@pytest.mark.parametrize("tile", TILES)
def test_grouped_raster_visits_every_tile_once(m, n, tile):
    bm, bn = tile
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    got = [_raster(b, m, n, bm, bn) for b in range(tiles_m * tiles_n)]
    assert sorted(got) == [(i, j) for i in range(tiles_m)
                           for j in range(tiles_n)]
    # eight neighbouring blocks share one column tile of weights, so the
    # first wave of 132 blocks reads at most ceil(132 / 8) of them
    if tiles_m >= 8:
        assert len({j for _, j in got[:SM_COUNT]}) <= -(-SM_COUNT // 8)


# ---------------------------------------------------------------------------
# a plain tiled model of the kernel's K-ring
# ---------------------------------------------------------------------------

def _requant(acc, out_scale, out_bits):
    """The kernel's fused requant: r = v / s; sign(r)·floor(|r| + 0.5),
    clamped to the out_bits grid, times s."""
    r = acc / torch.tensor(out_scale, dtype=torch.float32)
    sg = (r > 0).float() - (r < 0).float()
    q = sg * torch.floor(r.abs() + 0.5)
    q = torch.clamp(q, -2.0 ** (out_bits - 1), 2.0 ** (out_bits - 1) - 1)
    return q * torch.tensor(out_scale, dtype=torch.float32)


def _ring_model(x, w_q, scale, bits, out_scale=None, out_bits=None,
                tile=None):
    """(f32 sums, stored output) of the wgmma kernel with output tiles
    ``tile`` (by default :func:`prefill_rows` × 128), tile by tile: x rows and
    weight rows/columns outside the operands read as zeros, one f32 product
    per 64-row stage added in ring order, the requant, the masked store."""
    m, k = x.shape
    n = scale.numel()
    bm, bn = tile or (K.prefill_rows(m), K.WGMMA_COLS)
    steps = -(-k // BK)
    xp = torch.zeros(-(-m // bm) * bm, steps * BK)
    xp[:m, :k] = x.bfloat16().float()
    deq = _magic_dequant(w_q, scale, bits).float()
    wp = torch.zeros(steps * BK, -(-n // bn) * bn)
    wp[:k, :n] = deq
    acc = torch.zeros(xp.shape[0], wp.shape[1])
    tiles_m, tiles_n = xp.shape[0] // bm, wp.shape[1] // bn
    for block in range(tiles_m * tiles_n):
        tm, tn = _raster(block, m, n, bm, bn)
        rs, cs = slice(tm * bm, tm * bm + bm), slice(tn * bn, tn * bn + bn)
        a = torch.zeros(bm, bn)
        for it in range(steps):
            ks = slice(it * BK, it * BK + BK)
            a = a + xp[rs, ks] @ wp[ks, cs]
        acc[rs, cs] = a
    sums = acc[:m, :n]
    if out_bits is None:
        return sums, sums.clone()
    return sums, _requant(sums, out_scale, out_bits)


def _inputs(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    cols = n // 2 if bits <= 4 else n
    lo = -128 if bits <= 4 else -127
    w_q = torch.from_numpy(rng.integers(lo, 128, (k, cols)).astype(np.int8))
    scale = torch.from_numpy((0.001 + 0.01 * rng.random(n)).astype(np.float32))
    return x, w_q, scale


def _jax_padded(x, w_q, scale, bits, out_bits=None, out_scale=None):
    """``qmatmul_pallas`` in interpret mode on the zero-padded operands (its
    shapes must divide its blocks), cut back to [M, N]."""
    m, k = x.shape
    n = scale.numel()
    mp, kp, np_ = -(-m // 128) * 128, -(-k // BK) * BK, -(-n // 128) * 128
    xp = np.zeros((mp, kp), np.float32)
    xp[:m, :k] = x.numpy()
    wcols = np_ // 2 if bits <= 4 else np_
    wp = np.zeros((kp, wcols), np.int8)
    wp[:k, :w_q.shape[1]] = w_q.numpy()
    sp = np.zeros(np_, np.float32)
    sp[:n] = scale.numpy()
    y = qmatmul_pallas(jnp.asarray(xp), jnp.asarray(wp), jnp.asarray(sp),
                       bits=bits, blocks=(128, BK, 128), out_bits=out_bits,
                       out_scale=out_scale, interpret=True)
    return np.asarray(y)[:m, :n]


@pytest.mark.parametrize("m,k,n,tile", [
    (17, 64, 128, None),         # the first prefill M, one stage
    (128, 200, 256, None),       # ragged K: 200 = 3 stages + 8 rows
    (130, 136, 160, None),       # ragged M (two row tiles), K and N
    (40, 512, 96, None),         # eight stages, N below one tile
    (300, 200, 416, (256, 128)),     # both tile shapes, all edges ragged
    (300, 200, 416, (128, 128))])
@pytest.mark.parametrize("bits", [8, 4])
def test_ring_model_matches_plain_and_pallas(m, k, n, tile, bits):
    x, w_q, scale = _inputs(m, k, n, bits, seed=m + k + n + bits)
    assert K.route_of(m, k, n, bits, BF16) == "wgmma"
    got, _ = _ring_model(x, w_q, scale, bits, tile=tile)
    want = K.qmatmul_ref(x, w_q, scale, bits)
    want_jax = _jax_padded(x, w_q, scale, bits)
    wb = K.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * k * 2.0 ** -24 * (x.bfloat16().float().abs() @ wb.abs())
    assert got.shape == (m, n)
    assert bool(((got - want).abs() <= tol).all())
    assert np.all(np.abs(got.numpy() - want_jax) <= tol.numpy())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("out_bits,out_scale", [(8, 0.25), (4, 0.5),
                                                (6, 0.03125)])
def test_ring_model_fused_requant(bits, out_bits, out_scale):
    x, w_q, scale = _inputs(130, 136, 160, bits, seed=out_bits)
    acc, fused = _ring_model(x, w_q, scale, bits, out_scale=out_scale,
                             out_bits=out_bits, tile=(256, 128))
    assert torch.equal(fused, K.requant_ref(acc, out_scale, out_bits))
    want_jax = _jax_padded(x, w_q, scale, bits, out_bits=out_bits,
                           out_scale=out_scale)
    assert np.abs(fused.numpy() - want_jax).max() <= out_scale
