"""Paged decode attention of the PyTorch port: its plain version against
the JAX reference (``ref.paged_attention_ref`` and the Pallas kernel in
interpret mode). The Hopper kernel itself is tested on the card in
``tests/test_torch_cuda.py``.

Cases: kv16, kv8 and kv4; row lengths 7, 8, 9, 16 and 17 at block size 8;
fragmented, out-of-order tables with both unmapped sentinels (−1 and
≥ n_blocks); full and windowed attention; a dead row, whose output must be
exactly zero. Tolerance ``atol=1e-5``: both sides compute in f32 and differ
only in summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.ref import paged_attention_ref as jax_ref
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import attention as A

LENGTHS = (7, 8, 9, 16, 17)
BS, HKV, HG, D, N_LBLK = 8, 2, 2, 16, 4


def _inputs(bits: int, seed: int = 0):
    """numpy inputs: one row per length plus a dead row; physical blocks
    shuffled; unmapped entries alternate between −1 and ≥ n_blocks."""
    rng = np.random.default_rng(seed + bits)
    b = len(LENGTHS) + 1
    n_blocks = b * N_LBLK + 3
    perm = list(rng.permutation(n_blocks))
    bt = np.zeros((b, N_LBLK), np.int32)
    tidx = np.full((n_blocks, BS), -1, np.int32)
    pos = np.zeros((b,), np.int32)
    for r in range(b):
        n = LENGTHS[r] if r < len(LENGTHS) else 0
        pos[r] = max(n - 1, 0)
        for lb in range(N_LBLK):
            if r < len(LENGTHS) and lb * BS < n:
                phys = perm.pop()
                bt[r, lb] = phys
                t = lb * BS + np.arange(BS)
                tidx[phys] = np.where(t < n, t, -1)
            else:
                bt[r, lb] = -1 if (r + lb) % 2 else n_blocks + lb
    dk = D // 2 if bits == 4 else D
    shape = (n_blocks, BS, HKV, dk)
    if bits == 16:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    else:
        lo, hi = (-127, 128) if bits == 8 else (-128, 128)
        k = rng.integers(lo, hi, shape).astype(np.int8)
        v = rng.integers(lo, hi, shape).astype(np.int8)
    ks = rng.uniform(0.01, 0.05, (b, HKV)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (b, HKV)).astype(np.float32)
    q = rng.standard_normal((b, HKV, HG, D)).astype(np.float32)
    return dict(q=q, k_pool=k, v_pool=v, k_scale=ks, v_scale=vs,
                token_idx=tidx, block_table=bt, pos=pos)


def _torch(x: dict, bits: int, device="cpu") -> dict:
    out = {name: torch.from_numpy(a).to(device) for name, a in x.items()}
    if bits == 16:
        out["k_pool"] = out["k_pool"].bfloat16()
        out["v_pool"] = out["v_pool"].bfloat16()
    return out


def _jax(x: dict, bits: int) -> dict:
    out = {name: jnp.asarray(a) for name, a in x.items()}
    if bits == 16:
        out["k_pool"] = out["k_pool"].astype(jnp.bfloat16)
        out["v_pool"] = out["v_pool"].astype(jnp.bfloat16)
    return out


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_plain_matches_jax_ref_and_pallas_interpret(bits, window):
    x = _inputs(bits)
    got = PA.paged_attention(**_torch(x, bits), bits=bits, window=window)
    assert got.dtype == torch.float32
    got = got.numpy()
    ref = np.asarray(jax_ref(**_jax(x, bits), bits=bits, window=window))
    pallas = np.asarray(paged_attention_pallas(**_jax(x, bits), bits=bits,
                                               window=window, interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    assert np.all(got[-1] == 0.0)                 # dead row: exact zeros
    assert PA.paged_attention.launches == 0       # CPU tensors never launch


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_plain_matches_gather_view_oracle(bits):
    """The in-place path equals :func:`paged_view` + ``decode_attention``
    (the gather backend) on the port's own pool layout with its write sink."""
    x = _torch(_inputs(bits, seed=3), bits)
    n_blocks = x["token_idx"].shape[0]
    pad = {"k_pool": 0, "v_pool": 0, "token_idx": -1}
    for name, fill in pad.items():          # the sink block: never read
        sink = torch.full_like(x[name][:1], fill) + (7 if fill == 0 else 0)
        x[name] = torch.cat([x[name], sink.to(x[name].dtype)])
    cache = A.PagedKVCache(k=x["k_pool"], v=x["v_pool"], k_scale=x["k_scale"],
                           v_scale=x["v_scale"], token_idx=x["token_idx"],
                           block_table=x["block_table"], n_blocks=n_blocks,
                           bits=bits)
    b = x["q"].shape[0]
    q = x["q"].reshape(b, 1, HKV * HG, D)
    kernel = A.paged_decode_attention(q, cache, x["pos"])
    gather = A.decode_attention(q, A.paged_view(cache), x["pos"])
    np.testing.assert_allclose(kernel.numpy(), gather.numpy(), atol=1e-5,
                               rtol=0)
