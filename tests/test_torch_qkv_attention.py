"""K4, the int8-KV decode attention, against the JAX package on the CPU:

* the plain version (``qkv_attention_ref``) against ``qkv_attention_pallas``
  in interpret mode on ``tests/test_kernels.py``'s grid, length 0 included
  (every column masked: uniform weights, the mean of the dequantized V);
* a ragged S (no multiple of any block) against ``ref.qkv_attention_ref`` on
  each group's valid prefix;
* the wrapper on the contiguous cache's own layout (``[B, S, Hkv, D]``)
  against the Pallas kernel on the transposed ``[G, S, D]`` arrays;
* the mask K4 is given on the serving path, ``col < min(pos + 1, slots)``,
  against the reference's ``token_idx`` mask after a ragged prefill and
  decode steps, ring wrap and pad rows included;
* ``decode_attention`` at kv8 on the kernel backend (K4's plain version
  here) against the JAX ``decode_attention`` on the same cache.

Inputs come from numpy seeds; tolerances are f32 summation-order bounds
(the two sides sum the same products in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.qkv_attention import qkv_attention_pallas
from repro.models import attention as JA
from repro_torch.configs import get_smoke
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.kernels import qkv_attention as QK
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from torch_threads import _one_thread  # noqa: F401

ATOL = 1e-5


def _groups(rng, g, s, hg=2, d=32):
    """q ``[G, Hg, D]`` f32, int8 K/V ``[G, S, D]`` on each group's amax/127
    grid and their scales ``[G]`` (as ``tests/test_kernels.py`` builds them)."""
    q = rng.standard_normal((g, hg, d)).astype(np.float32)
    k = rng.standard_normal((g, s, d)).astype(np.float32)
    v = rng.standard_normal((g, s, d)).astype(np.float32)
    ks = (np.abs(k).max(axis=(1, 2)) / 127.0).astype(np.float32)
    vs = (np.abs(v).max(axis=(1, 2)) / 127.0).astype(np.float32)
    kq = np.clip(np.round(k / ks[:, None, None]), -127, 127).astype(np.int8)
    vq = np.clip(np.round(v / vs[:, None, None]), -127, 127).astype(np.int8)
    return q, kq, vq, ks, vs


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("s,block", [(128, 64), (256, 256), (192, 64)])
def test_plain_matches_pallas_interpret(s, block):
    rng = np.random.default_rng(s + block)
    lengths = np.asarray([s, s // 2, 3, 1, 0], np.int32)
    q, kq, vq, ks, vs = _groups(rng, len(lengths), s)
    want = qkv_attention_pallas(jnp.asarray(q), jnp.asarray(kq),
                                jnp.asarray(vq), jnp.asarray(ks),
                                jnp.asarray(vs), jnp.asarray(lengths),
                                block_s=block, interpret=True)
    got = QK.qkv_attention_ref(*_t(q, kq, vq, ks, vs, lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # length 0: uniform weights over all S columns = the mean of V·vs
    mean_v = (vq[-1].astype(np.float32) * vs[-1]).mean(axis=0)
    np.testing.assert_allclose(got[-1].numpy(), np.broadcast_to(
        mean_v, got[-1].shape), atol=ATOL, rtol=0)


def test_plain_bf16_query_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    s, lengths = 128, np.asarray([128, 77, 1, 0], np.int32)
    q, kq, vq, ks, vs = _groups(rng, len(lengths), s)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    want = qkv_attention_pallas(qb, jnp.asarray(kq), jnp.asarray(vq),
                                jnp.asarray(ks), jnp.asarray(vs),
                                jnp.asarray(lengths), block_s=64,
                                interpret=True)
    qt = torch.tensor(np.asarray(qb.astype(jnp.float32))).bfloat16()
    got = QK.qkv_attention_ref(qt, *_t(kq, vq, ks, vs, lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_ragged_s_matches_oracle_on_valid_prefix():
    """S = 100 is no multiple of a block; each group agrees with the
    reference oracle on its valid prefix."""
    rng = np.random.default_rng(100)
    s, lengths = 100, np.asarray([100, 50, 3, 1], np.int32)
    q, kq, vq, ks, vs = _groups(rng, len(lengths), s, hg=4, d=64)
    got = QK.qkv_attention_ref(*_t(q, kq, vq, ks, vs, lengths)).numpy()
    for gi, n in enumerate(lengths):
        want = ref.qkv_attention_ref(
            jnp.asarray(q[gi])[None, :, None, :],
            jnp.broadcast_to(jnp.asarray(kq[gi, :n])[None, None],
                             (1, q.shape[1], n, q.shape[2])),
            jnp.broadcast_to(jnp.asarray(vq[gi, :n])[None, None],
                             (1, q.shape[1], n, q.shape[2])),
            float(ks[gi]), float(vs[gi]))[0, :, 0, :]
        np.testing.assert_allclose(got[gi], np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_cache_layout_wrapper_matches_pallas_per_group(qdtype):
    """The wrapper takes the cache's ``[B, S, Hkv, D]`` layout and
    ``[B, Hkv]`` scales and lengths; the Pallas kernel, the same data
    transposed to ``[G = B·Hkv, S, D]``."""
    rng = np.random.default_rng(11)
    b, hkv, hg, d, s = 3, 2, 4, 32, 128
    k = rng.integers(-127, 128, (b, s, hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (b, s, hkv, d)).astype(np.int8)
    ks = (0.005 + 0.02 * rng.random((b, hkv))).astype(np.float32)
    vs = (0.005 + 0.02 * rng.random((b, hkv))).astype(np.float32)
    lengths = np.asarray([[128, 64], [65, 1], [0, 3]], np.int32)
    q = torch.from_numpy(rng.standard_normal((b, hkv, hg, d))
                         .astype(np.float32)).to(qdtype)
    got = QK.qkv_attention(q, *_t(k, v, ks, vs, lengths))
    assert got.shape == (b, hkv, hg, d) and got.dtype == torch.float32

    def groups(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * hkv, s, d))

    qj = jnp.asarray(q.float().numpy().reshape(b * hkv, hg, d))
    if qdtype == torch.bfloat16:
        qj = qj.astype(jnp.bfloat16)
    want = qkv_attention_pallas(qj, groups(k), groups(v),
                                jnp.asarray(ks.reshape(-1)),
                                jnp.asarray(vs.reshape(-1)),
                                jnp.asarray(lengths.reshape(-1)),
                                block_s=64, interpret=True)
    np.testing.assert_allclose(got.numpy().reshape(b * hkv, hg, d),
                               np.asarray(want), atol=ATOL, rtol=0)


def test_kernel_mask_equals_token_idx_mask_after_prefill_and_decode():
    """After the port's ragged left-padded prefill (one pad row, one prompt
    longer than the ring) and decode steps that wrap the ring (pos ≥
    slots), the reference's ``token_idx`` mask is exactly
    ``col < min(pos + 1, slots)`` in every row at every step."""
    cfg = get_smoke("granite-3-2b")
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, device="cpu")
    names = T.quant_layer_names(cfg)
    table = TE.AdaptiveEngine(tuple(TP.paper_profiles(names)),
                              TE.QuantIndex(names)).table[0]
    slots = 12
    lens = np.asarray([5, 9, 14, 0], np.int32)        # 14 > slots; 0 = pad
    rng = np.random.default_rng(3)
    prompts = np.zeros((len(lens), 14), np.int32)
    for j, n in enumerate(lens):
        prompts[j, 14 - n:] = rng.integers(0, cfg.vocab, n)
    logits, caches = T.prefill(params, cfg, table,
                               {"tokens": torch.from_numpy(prompts),
                                "prompt_len": lens}, slots, kv_bits=8)
    pos = torch.from_numpy(lens.copy())
    tok = logits.argmax(-1).to(torch.int32)
    col = torch.arange(slots)
    for _ in range(10):
        logits, caches = T.decode_step(params, cfg, table, tok[:, None], pos,
                                       caches)
        tidx = caches["kv"].token_idx[0]
        p = pos[:, None]
        keep = (tidx >= 0) & (tidx <= p) & (p - tidx < slots + 1)
        n = torch.clamp(pos + 1, max=slots)
        assert torch.equal(keep, col[None] < n[:, None]), pos.tolist()
        tok = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
    assert int(pos.max()) > slots                     # the ring wrapped


def test_decode_attention_kernel_backend_matches_jax():
    """A kv8 cache whose rows hold ``min(pos + 1, slots)`` tokens in ring
    order (one row wrapped, one at the first step): the kernel backend of
    ``decode_attention`` (K4's plain version on the CPU) against the JAX
    ``decode_attention``."""
    rng = np.random.default_rng(21)
    b, slots, hkv, hg, d = 4, 16, 2, 4, 32
    pos = np.asarray([3, 15, 40, 0], np.int32)
    tidx = np.full((b, slots), -1, np.int32)
    for r, p in enumerate(pos):
        for t in range(max(0, p - slots + 1), p + 1):
            tidx[r, t % slots] = t
    k = rng.integers(-127, 128, (b, slots, hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (b, slots, hkv, d)).astype(np.int8)
    ks = (0.005 + 0.02 * rng.random((b, hkv))).astype(np.float32)
    vs = (0.005 + 0.02 * rng.random((b, hkv))).astype(np.float32)
    q = rng.standard_normal((b, 1, hkv * hg, d)).astype(np.float32)
    jc = JA.KVCache(*(jnp.asarray(x) for x in (k, v, ks, vs, tidx)), bits=8)
    want = JA.decode_attention(jnp.asarray(q), jc, jnp.asarray(pos))
    tc = A.KVCache(*_t(k, v, ks, vs, tidx), bits=8)
    n0 = A.decode_attention.kv8_einsum_calls
    got = A.decode_attention(torch.from_numpy(q), tc, torch.from_numpy(pos),
                             kernel=True)
    assert A.decode_attention.kv8_einsum_calls == n0   # K4, not the einsum
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    gather = A.decode_attention(torch.from_numpy(q), tc,
                                torch.from_numpy(pos))
    assert A.decode_attention.kv8_einsum_calls == n0 + 1
    np.testing.assert_allclose(gather.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    with pytest.raises(ValueError, match="full causal"):
        A.decode_attention(torch.from_numpy(q), tc, torch.from_numpy(pos),
                           window=8, kernel=True)
