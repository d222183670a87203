"""The split-K decode design of the dequant-matmul kernel (K3), on the CPU:
the host-side planner, and a plain-torch model of the kernel's arithmetic
against the plain version (``qmatmul_ref``) and the JAX reference
(``repro.kernels.ref.qmatmul_ref``).

The model follows the kernel step by step: each weight is dequantized as the
kernel does it in registers (the biased byte or nibble read as the float
2^23 + b, the bias subtracted, times the column's scale in f32, rounded to
bf16) and must equal the plain ``dequant_ref`` bit for bit; a block's
columns are permuted across m16n8k16 fragments as the kernel reads them and
stored back through the kernel's map, which must be the identity; each
split's K-range gives an f32 partial and the partials are added in split
order, then the fused requant (the kernel's formula) is applied to the sum.

Tolerance of the merged sums: both sides multiply the same bf16 operands,
whose products are exact in f32, and differ only in the order of the f32
sums, so ``|model − reference| <= 4·K·2^-24·(|x|@|w|)`` elementwise, the bound
``chip_smoke.py`` holds the kernel to. The requant is compared bit for bit
with ``requant_ref`` of the model's own sums. The CUDA kernel itself is
checked against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import qmatmul as K
from repro_torch.kernels.build import SM_COUNT

GRANITE = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)]


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k,n", GRANITE + [
    (0, 64), (1, 64), (63, 64), (64, 64), (96, 2048), (100, 70),
    (8256, 2048), (16384, 70), (100000, 128), (2048, 1)])
@pytest.mark.parametrize("bits", [8, 4])
def test_split_plan_covers_k_exactly_once(m, k, n, bits):
    cols, splits, per = K.split_plan(m, k, n, bits)
    assert cols == (256 if bits <= 4 else 128)
    assert splits >= 1 and per % K.STEP_ROWS == 0
    assert K.STEP_ROWS <= per <= K.MAX_SPLIT_STEPS * K.STEP_ROWS
    seen = np.zeros(k, int)
    for s in range(splits):
        lo, hi = s * per, min(k, (s + 1) * per)
        assert lo < hi or k == 0                  # no split is empty
        if s < splits - 1:
            assert hi - lo == per                 # only the last is ragged
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    if k == 0:
        assert splits == 1


@pytest.mark.parametrize("bits", [8, 4])
def test_split_plan_at_the_granite_decode_shapes(bits):
    """At the four linears of a decode step the grid is at most
    ``BLOCKS_PER_SM`` blocks per SM and at least half that (whole-step
    splits round it down), unless every split is one 64-row step already
    (W4 o: 8 column tiles × 32 steps); the same plan for M 1, 8 and 16."""
    top = K.BLOCKS_PER_SM * SM_COUNT
    for k, n in GRANITE:
        cols, splits, per = K.split_plan(8, k, n, bits)
        blocks = -(-n // cols) * splits
        assert blocks <= top
        assert 2 * blocks >= top or per == K.STEP_ROWS, (k, n, blocks)
        assert K.split_plan(1, k, n, bits) == K.split_plan(16, k, n, bits)
    # the plans phase 2 of chip_smoke.py reports (3 blocks per SM)
    if bits == 8:
        assert K.split_plan(8, 2048, 3072, 8) == (128, 16, 128)
        assert K.split_plan(8, 2048, 2048, 8) == (128, 16, 128)
        assert K.split_plan(8, 2048, 16384, 8) == (128, 3, 704)
        assert K.split_plan(8, 8192, 2048, 8) == (128, 22, 384)


@pytest.mark.parametrize("m,k,n", [(17, 2048, 3072), (2048, 8192, 2048),
                                   (33, 96, 40), (300, 100000, 64)])
def test_split_plan_never_splits_prefill(m, k, n):
    assert K.split_plan(m, k, n, 8) == (K.PREFILL_COLS, 1, k)


# ---------------------------------------------------------------------------
# a plain-torch model of the kernel
# ---------------------------------------------------------------------------

def _magic_dequant(w_q: torch.Tensor, scale: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """The kernel's dequantization: biased byte/nibble b as the f32 value
    2^23 + b minus 2^23 + bias, times the scale in f32, rounded to bf16."""
    u = w_q.numpy().view(np.uint8)
    if bits <= 4:
        u = u ^ 0x88
        b = np.stack([u & 0x0F, u >> 4], axis=-1).reshape(u.shape[0],
                                                           2 * u.shape[1])
        bias = 8
    else:
        b, bias = u ^ 0x80, 128
    f = np.float32(2.0 ** 23) + b.astype(np.float32)      # exact
    q = f - np.float32(2.0 ** 23 + bias)                   # exact
    v = q * scale.numpy().astype(np.float32)               # f32, RN
    return torch.from_numpy(v).bfloat16()


def _fragment_map(bits: int) -> np.ndarray:
    """For each (warp, fragment j, fragment column c) the block column the
    kernel reads it from (word g's element j) and the column it stores it
    to: returned as [read, stored], each a flat array over the block."""
    per_word = 8 if bits <= 4 else 4
    cols = 256 if bits <= 4 else 128
    read, stored = [], []
    for warp in range(4):
        for j in range(per_word):
            for c in range(8):
                # word g = c sits at byte 32·warp + 4c of the stage row;
                # int8: byte j is column 4c + j; int4: byte j // 2, nibble
                # j % 2 (low = even) is column 2·(4c + j // 2) + j % 2
                byte = 32 * warp + 4 * c + (j if per_word == 4 else j // 2)
                read.append(byte if per_word == 4 else 2 * byte + j % 2)
                stored.append(warp * cols // 4 + per_word * c + j)
    return np.array([read, stored])


def _splitk_model(x, w_q, scale, bits, out_scale=None, out_bits=None,
                  plan=None):
    """(merged f32 sums, after the fused requant) under ``plan`` = (splits,
    rows per split), by default the planner's."""
    m, k = x.shape
    n = scale.numel()
    splits, per = plan or K.split_plan(m, k, n, bits)[1:]
    xb = x.bfloat16().float()
    wb = _magic_dequant(w_q, scale, bits).float()
    parts = [xb[:, s * per:min(k, (s + 1) * per)]
             @ wb[s * per:min(k, (s + 1) * per)] for s in range(splits)]
    acc = parts[0]
    for p in parts[1:]:                           # in split order
        acc = acc + p
    if out_bits is None:
        return acc, acc
    # the kernel's requant: r = v / s; sign(r)·floor(|r| + 0.5), clamped
    r = acc / torch.tensor(out_scale, dtype=torch.float32)
    sg = (r > 0).float() - (r < 0).float()
    q = sg * torch.floor(r.abs() + 0.5)
    q = torch.minimum(torch.maximum(q, torch.tensor(-2.0 ** (out_bits - 1))),
                      torch.tensor(2.0 ** (out_bits - 1) - 1))
    return acc, q * torch.tensor(out_scale, dtype=torch.float32)


def _inputs(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    if bits <= 4:
        w_q = rng.integers(-128, 128, (k, n // 2))
    else:
        w_q = rng.integers(-127, 128, (k, n))
    w_q = torch.from_numpy(w_q.astype(np.int8))
    scale = torch.from_numpy(
        (0.001 + 0.01 * rng.random(n)).astype(np.float32))
    return x, w_q, scale


@pytest.mark.parametrize("bits", [8, 4])
def test_fragment_map_stores_every_column_where_it_read_it(bits):
    read, stored = _fragment_map(bits)
    cols = 256 if bits <= 4 else 128
    assert sorted(read) == list(range(cols))
    assert np.array_equal(read, stored)


@pytest.mark.parametrize("bits", [8, 4])
def test_kernel_dequant_is_bitwise_the_plain_one(bits):
    """Every int8 value (every nibble pair at int4) × a column of scales."""
    vals = np.arange(-128, 128, dtype=np.int8)
    w_q = torch.from_numpy(np.tile(vals[:, None], (1, 64)))
    rng = np.random.default_rng(1)
    n = 128 if bits <= 4 else 64
    scale = torch.from_numpy(np.concatenate([
        rng.random(n - 4).astype(np.float32) * 0.05,
        np.float32([1.0, 2.0 ** -7, 0.1, 3.0e-5])]))
    got = _magic_dequant(w_q, scale, bits)
    want = K.dequant_ref(w_q, scale, bits).bfloat16()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("m,k,n", [
    (16, 64, 130), (8, 96, 256), (1, 100, 70), (16, 640, 130),
    (8, 1088, 512), (5, 8256, 64), (8, 0, 64)])
@pytest.mark.parametrize("bits", [8, 4])
def test_splitk_model_matches_plain_and_jax(m, k, n, bits):
    """Ragged K (96, 100, 1088; 8256, whose last split is one step), one
    split (K 64 and K 0) and many, W8 and W4."""
    x, w_q, scale = _inputs(m, k, n, bits, seed=m * 7 + k + n + bits)
    _, splits, _ = K.split_plan(m, k, n, bits)
    got, _ = _splitk_model(x, w_q, scale, bits)
    want = K.qmatmul_ref(x, w_q, scale, bits)
    want_jax = np.asarray(ref.qmatmul_ref(
        jnp.asarray(x.numpy()), jnp.asarray(w_q.numpy()),
        jnp.asarray(scale.numpy()), bits))
    wb = K.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * k * 2.0 ** -24 * (x.bfloat16().float().abs() @ wb.abs())
    assert got.shape == (m, n)
    assert bool(((got - want).abs() <= tol).all())
    assert np.all(np.abs(got.numpy() - want_jax) <= tol.numpy())
    if k == 0:
        assert splits == 1 and not got.any()


@pytest.mark.parametrize("bits", [8, 4])
def test_splitk_model_one_and_many_splits(bits):
    """The same inputs (K 1024, the longest split) as one split, as the
    planner gives it when N fills the card, and as 16, as it gives it at
    N 256: both within the bound, and the planner's choices pinned."""
    assert K.split_plan(8, 1024, 256 * 528, bits)[1:] == (1, 1024)
    assert K.split_plan(8, 1024, 256, bits)[1:] == (16, 64)
    x, w_q, scale = _inputs(8, 1024, 256, bits, seed=bits)
    want = K.qmatmul_ref(x, w_q, scale, bits)
    wb = K.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * 1024 * 2.0 ** -24 * (x.bfloat16().float().abs() @ wb.abs())
    for plan in ((1, 1024), (16, 64), (3, 384)):
        got, _ = _splitk_model(x, w_q, scale, bits, plan=plan)
        assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("out_bits,out_scale", [(8, 0.25), (4, 0.5),
                                                (6, 0.03125)])
def test_fused_requant_after_the_merge_is_requant_ref(bits, out_bits,
                                                      out_scale):
    x, w_q, scale = _inputs(8, 8256, 128, bits, seed=out_bits)
    acc, fused = _splitk_model(x, w_q, scale, bits, out_scale=out_scale,
                               out_bits=out_bits)
    assert K.split_plan(8, 8256, 128, bits)[1] > 1
    assert torch.equal(fused, K.requant_ref(acc, out_scale, out_bits))
