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
fake-quant: bit for bit in f32 and bf16 outputs, on and off the grid's
on-chip store, at 2-, 4- and 12-byte offsets with odd ``n``, replayed in a
CUDA graph, on two streams at once, and under autograd with the fused
cast); K1 and K2 on tables whose rows share prefix
blocks, a scheduler run with a registry hit on the card, and preemption on
the kernel backend (the resumed row bitwise equal to the suspended one, the
victim's unmapped table leaving the next owner's blocks unchanged); the
precision policy's ``kv_refine`` on the card (the CPU's bits, no host sync)
and a mixed-row paged serve through K1 (the gather backend's tokens); fault
tolerance on the kernel backend (a reaped and a quarantined row's table
unmapped before the next segment, so the blocks' next owner keeps its
bytes; a NaN in a copy-on-write sharer leaving the shared blocks and the
neighbour's bytes, scales and tokens those of the serve without it); at
hymba-1.5b's shapes, K1 at Hg 5 on wrapped sliding-window rings, K4 at Hg
5, K3 at ``ssm_in`` (N 6482), the untied head (N 32001) and ``mlp_in``, and
the hymba smoke model's paged serve equal to its contiguous one; K5 on
qwen2-moe's routed stacks and the MoE smoke forward; at qwen2-vl-2b's and
hubert-xlarge's shapes, K1 and K4 at Hg 6, D 128, K3 at N 17920, 3840 and
504 (hubert's head, on mma.sync), the qwen2-vl smoke model's paged decode
through K1 equal to the gather backend's, and the hubert smoke encoder on
the card equal to the CPU; the scheduler's decode segments and admission
waves (kv16, native W8, chunked prefill with prefix hits) replayed from
CUDA graphs equal to the eager ones.

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


def _shared_inputs(bits: int, gen: torch.Generator, *, w=None, b=6,
                   hkv=2, hg=4, d=64, bs=8, n_lblk=12, n_shared=4):
    """Tables whose live rows all map their first ``n_shared`` logical
    blocks to the same physical blocks (a shared prefix), then private
    tails to ragged positions with stale indices past them and both
    sentinels; a dead last row. Returns the inputs and the same attention
    on distinct tables (each row its own copy of the shared bytes)."""
    nw = 1 if w is None else w
    cap = n_lblk * bs
    n_blocks = n_shared + b * (n_lblk - n_shared)
    perm = torch.randperm(n_blocks, generator=gen).tolist()
    shared = [perm.pop() for _ in range(n_shared)]
    bt = torch.full((b, n_lblk), -1, dtype=torch.int32)
    tidx = torch.full((n_blocks, bs), -1, dtype=torch.int32)
    pos = torch.randint(n_shared * bs, cap - nw, (b,), generator=gen,
                        dtype=torch.int32)
    for lb, phys in enumerate(shared):
        tidx[phys] = (lb * bs + torch.arange(bs)).int()
    for r in range(b - 1):
        bt[r, :n_shared] = torch.tensor(shared, dtype=torch.int32)
        for lb in range(n_shared, n_lblk):
            if lb * bs <= pos[r] + nw - 1:
                phys = perm.pop()
                bt[r, lb] = phys
                t = lb * bs + torch.arange(bs)
                tidx[phys] = torch.where(t <= pos[r] + nw + 1, t, -1).int()
            elif lb % 2:
                bt[r, lb] = n_blocks + lb
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
    grow = b * n_shared
    sid = torch.tensor(shared).repeat(b)
    xd = dict(x, k_pool=torch.cat([k, k[sid]]), v_pool=torch.cat([v, v[sid]]),
              token_idx=torch.cat([tidx, tidx[sid]]),
              block_table=torch.where(bt >= n_blocks, bt + grow, bt))
    xd["block_table"][:, :n_shared] = torch.where(
        bt[:, :n_shared] >= 0,
        n_blocks + torch.arange(grow).reshape(b, n_shared), -1).int()
    return ({n: t.cuda() for n, t in x.items()},
            {n: t.cuda() for n, t in xd.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("w,bits", [(None, 16), (None, 8), (None, 4),
                                    (5, 16), (5, 8)])
def test_paged_attention_kernels_on_shared_tables(bits, w):
    """K1 (and K2 at W 5, which takes kv16 and kv8) read a prefix that
    several rows map in place: within 1e-5 of the plain version, two calls
    bitwise equal, and bitwise equal to the same attention on distinct
    tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, xd = _shared_inputs(bits, torch.Generator().manual_seed(40 + bits),
                           w=w)
    fn, ref = ((PA.paged_attention, PA.paged_attention_ref) if w is None
               else (PA.paged_attention_multi, PA.paged_attention_multi_ref))
    _check_split_kernel(fn, ref, x, dict(bits=bits, window=0), 1)
    assert torch.equal(fn(**x, bits=bits), fn(**xd, bits=bits))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_scheduler_registry_hit_on_card(kv_bits):
    """A registry hit on the card (smoke config, f32 compute, TF32 off,
    kernel backend): the shared admission's tokens equal those of the run
    without the prefix cache, and every decode step went through K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import (AdaptiveServer, Request,
                                            ServingConfig)
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg = get_smoke("granite-3-2b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab, 32).astype(np.int32)
    reqs = [Request(tokens=np.concatenate(
        [system, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
        max_new=8) for n in (5, 11, 3)]
    out = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with use_compute_dtype(torch.float32):
        for cache in (False, True):
            sched = ContinuousScheduler(AdaptiveServer(
                cfg, params, engine, ServingConfig(
                    slots=64, max_batch=2, kv_bits=kv_bits, block_size=8,
                    prefix_cache=cache, paged_backend="kernel"),
                device="cuda"), quantum=4)
            n0 = PA.paged_attention.launches
            for r in reqs:
                sched.submit(r)
            out[cache] = [r["tokens"] for r in sched.run()]
            assert PA.paged_attention.launches - n0 == \
                cfg.n_layers * sched.decode_steps
            assert sched.allocator.used_blocks == 0
    torch.backends.cuda.matmul.allow_tf32 = tf32
    assert sched.registry.hits == 2
    assert out[True] == out[False]


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


_K5_PAIRS = {"f32>f32": (torch.float32, torch.float32),
             "f32>bf16": (torch.float32, torch.bfloat16),
             "bf16>bf16": (torch.bfloat16, torch.bfloat16)}


def _k5_check(x, out_dtype, bits=8, po2=True):
    """One K5 call in ``out_dtype``: one launch, the shape and type asked
    for, bitwise the plain version's (integer views)."""
    n0 = AQ.aquant.launches
    got = AQ.aquant(x, bits, po2, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert AQ.aquant.launches == n0 + 1
    want = AQ.aquant_ref(x, bits, po2, out_dtype=out_dtype)
    view = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert got.dtype == out_dtype and got.shape == x.shape
    assert torch.equal(got.view(view), want.view(view))
    return got


def _k5_store(dtype) -> int:
    """Elements of ``dtype`` the full grid keeps on chip across its
    barrier."""
    probe = torch.empty(1 << 24, dtype=dtype, device="cuda")
    p = AQ.launch_plan(probe)
    return (p.grid * (AQ.SMEM_BYTES // AQ.VEC_BYTES + AQ.REG_VECS)
            * AQ.VEC_BYTES // probe.element_size())


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(_K5_PAIRS))
@pytest.mark.parametrize("where", ["below", "above"])
@pytest.mark.parametrize("bits,po2", [(8, True), (4, False)])
def test_aquant_fused_kernel_on_and_off_chip(pair, where, bits, po2):
    """The fused kernel just below its grid's on-chip store (every vector
    kept across the barrier, registers included) and just above it (a
    vector per block read again), in each output type it takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    xd, od = _K5_PAIRS[pair]
    cap = _k5_store(xd)
    n = cap - 5 if where == "below" else cap + 777
    gen = torch.Generator(device="cuda").manual_seed(n % 1000 + bits)
    x = (torch.randn(n, generator=gen, device="cuda") * 0.3).to(xd)
    p = AQ.launch_plan(x, od)
    assert (p.n_tiles == 0) == (where == "below")
    assert p.keep_reg > 0
    _k5_check(x, od, bits, po2)


@pytest.mark.cuda
@pytest.mark.parametrize("xd,offset_bytes", [(torch.float32, 4),
                                             (torch.float32, 12),
                                             (torch.bfloat16, 2),
                                             (torch.bfloat16, 4)])
@pytest.mark.parametrize("n", [1, 3, 7, 4099, 1000003])
def test_aquant_unaligned_pointer_and_odd_n(xd, offset_bytes, n):
    """A view whose data pointer sits 2, 4 or 12 bytes past a 16-byte
    boundary, with ``n`` not a multiple of the vector width: the scalar
    head and tail in block 0, the output placed at the same offset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(n + offset_bytes)
    big = (torch.randn(n + 16, generator=gen, device="cuda") * 2).to(xd)
    x = big[offset_bytes // big.element_size():][:n]
    assert x.data_ptr() % 16 == offset_bytes
    for od in ((torch.float32, torch.bfloat16) if xd == torch.float32
               else (torch.bfloat16,)):
        got = _k5_check(x, od)
        elt = got.element_size()
        assert ((got.data_ptr() // elt) % (16 // x.element_size())
                == offset_bytes // x.element_size())


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(_K5_PAIRS))
def test_aquant_graph_replays_over_new_data(pair):
    """One K5 call captured in a CUDA graph and replayed three times over
    new data copied into its input buffer: bitwise each time, so the
    workspace the kernel leaves behind is as it found it (all zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    xd, od = _K5_PAIRS[pair]
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(3 << 20, generator=gen, device="cuda").to(xd)
    AQ.aquant(x, 8, True, out_dtype=od)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = AQ.aquant(x, 8, True, out_dtype=od)
    view = torch.int16 if od == torch.bfloat16 else torch.int32
    for rep in range(3):
        x.copy_(torch.randn(3 << 20, generator=gen, device="cuda")
                * (0.01 + rep))
        g.replay()
        torch.cuda.synchronize()
        want = AQ.aquant_ref(x, 8, True, out_dtype=od)
        assert torch.equal(y.view(view), want.view(view)), rep
    pool, _ = AQ._WS[x.device.index]
    assert int(pool.abs().sum()) == 0
    _k5_check(x, od)                      # an eager call after the replays


@pytest.mark.cuda
def test_aquant_on_two_streams_at_once():
    """Two streams launch K5 together, each on its own workspace: both
    outputs bitwise, in both output types."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = [torch.randn(30 << 20, generator=gen, device="cuda") * (1 + i)
          for i in range(2)]
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    for od in (torch.float32, torch.bfloat16):
        outs = []
        for st, x in zip(streams, xs):
            with torch.cuda.stream(st):
                outs.append(AQ.aquant(x, 8, True, out_dtype=od))
        torch.cuda.synchronize()
        view = torch.int16 if od == torch.bfloat16 else torch.int32
        for x, y in zip(xs, outs):
            want = AQ.aquant_ref(x, 8, True, out_dtype=od)
            assert torch.equal(y.view(view), want.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_dynamic_fused_cast_under_autograd_on_card(bits):
    """``fake_quant_dynamic(w, out_dtype=bf16)`` on the card under
    autograd: the values and the f32 gradient of the unfused
    ``fake_quant_dynamic(w).to(bf16)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    from repro_torch.core.quantizers import fake_quant_dynamic
    gen = torch.Generator(device="cuda").manual_seed(bits)
    w = torch.randn((300, 70), generator=gen, device="cuda")
    w[0, 0] = 40.0                        # values outside the clip band
    g = torch.randn((300, 70), generator=gen, device="cuda").bfloat16()
    grads, outs = [], []
    for fused in (True, False):
        wl = w.clone().requires_grad_(True)
        y = (fake_quant_dynamic(wl, bits, out_dtype=torch.bfloat16) if fused
             else fake_quant_dynamic(wl, bits).to(torch.bfloat16))
        (y.float() * g.float()).sum().backward()
        outs.append(y.detach())
        grads.append(wl.grad)
    assert outs[0].dtype == torch.bfloat16 and grads[0].dtype == torch.float32
    assert torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))
    assert torch.equal(grads[0], grads[1])


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


def _smoke_server_parts():
    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.models import transformer as T
    cfg = get_smoke("granite-3-2b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    names = T.quant_layer_names(cfg)
    return cfg, params, AdaptiveEngine(tuple(paper_profiles(names)),
                                       QuantIndex(names))


def _preempt_requests(cfg):
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(17)
    sys_p = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    savers = [Request(tokens=np.concatenate(
        [sys_p, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
        max_new=m, priority=1) for n, m in ((4, 18), (7, 16))]
    crit = Request(tokens=rng.integers(0, cfg.vocab, 7).astype(np.int32),
                   max_new=4, priority=0)
    return savers, crit


def _row_bytes(sched, slot, n_tok):
    """Pool row ``slot``'s first ``n_tok`` positions (K, V, token_idx as
    raw bytes, through its table), its scales and its carry."""
    kv = sched._caches["kv"]
    bs = kv.k.shape[2]
    bt = kv.block_table[0, slot, :-(-n_tok // bs)].long()

    def pos(x):
        g = x[:, bt]
        g = g.reshape(g.shape[0], -1, *g.shape[3:])[:, :n_tok]
        return g.view(torch.int16) if g.dtype == torch.bfloat16 else g

    return {"k": pos(kv.k), "v": pos(kv.v), "tidx": pos(kv.token_idx),
            "ks": kv.k_scale[:, slot].clone(),
            "vs": kv.v_scale[:, slot].clone(),
            "tok": int(sched._tok[slot]), "pos": int(sched._pos[slot])}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_preemption_restore_bitwise_on_card(kv_bits):
    """Preemption on the kernel backend (smoke config, f32, TF32 off): the
    resumed row's bytes, scales, token_idx and carry equal the suspended
    row's bit for bit; the savers' tokens equal a serve without the
    critical arrival; every decode step went through K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg, params, engine = _smoke_server_parts()
    savers, crit = _preempt_requests(cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    toks = {}
    with use_compute_dtype(torch.float32):
        for arrival in (False, True):
            sched = ContinuousScheduler(AdaptiveServer(
                cfg, params, engine, ServingConfig(
                    slots=64, max_batch=2, block_size=8, kv_bits=kv_bits,
                    priority_classes=2, preemption=True,
                    paged_backend="kernel"), device="cuda"), quantum=2)
            before, after = {}, {}
            snap_fn, resume_fn = sched._snapshot_row, sched._dispatch_resume

            def snapshot(slot, _s=sched, _fn=snap_fn, _b=before):
                snap = _fn(slot)
                _b[snap.rid] = (snap.n_done,
                                _row_bytes(_s, slot, snap.n_done))
                return snap

            def resume(rows, _s=sched, _fn=resume_fn, _b=before, _a=after):
                n = _fn(rows)
                for rid, slot, _ in rows:
                    _a[rid] = _row_bytes(_s, slot, _b[rid][0])
                return n

            sched._snapshot_row, sched._dispatch_resume = snapshot, resume
            n0 = PA.paged_attention.launches
            sched.submit(savers[0])
            sched.step()
            sched.submit(savers[1])
            sched.step()
            sched.step()
            if arrival:
                sched.submit(crit)
            while sched.step():
                pass
            assert PA.paged_attention.launches - n0 == \
                cfg.n_layers * sched.decode_steps
            toks[arrival] = [sched.results[i]["tokens"] for i in range(2)]
            assert sched.allocator.used_blocks == 0
    torch.backends.cuda.matmul.allow_tf32 = tf32
    assert sched.preemptions >= 1 and sched.resumes == sched.preemptions
    assert before and before.keys() == after.keys()
    for rid, (_, was) in before.items():
        for key, x in was.items():
            y = after[rid][key]
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), (rid, key)
    assert toks[True] == toks[False]


@pytest.mark.cuda
def test_unmapped_victim_table_keeps_next_owner_blocks():
    """The evicted row's table is unmapped in the round that evicts it, so
    the frozen victim's decode writes during the next segment (kernel
    backend, in place) cannot land in blocks the critical row now owns:
    every live row's written positions are unchanged by the segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg, params, engine = _smoke_server_parts()
    savers, crit = _preempt_requests(cfg)
    sched = ContinuousScheduler(AdaptiveServer(
        cfg, params, engine, ServingConfig(
            slots=64, max_batch=2, block_size=8, priority_classes=2,
            preemption=True, paged_backend="kernel"), device="cuda"),
        quantum=2)
    sched.submit(savers[0])
    sched.step()
    sched.submit(savers[1])
    sched.step()
    sched.step()
    sched.submit(crit)
    sched._flush(0)
    sched.admit()                       # evicts a saver, admits the critical
    assert sched.preemptions == 1
    kv = sched._caches["kv"]
    victim = next(iter(sched._suspended))
    owners = {s: r for s, r in enumerate(sched.slot_req) if r is not None}
    assert victim not in owners.values()
    free = [s for s in range(sched.n_slots) if sched.slot_req[s] is None]
    for s in free:
        assert bool((kv.block_table[:, s] == kv.n_blocks).all())
    sched._flush(0)
    was = {s: _row_bytes(sched, s, int(sched._pos[s])) for s in owners}
    sched.run_segment()
    sched._flush(0)
    for s in owners:
        now = _row_bytes(sched, s, was[s]["pos"])
        for key in ("k", "v", "tidx"):
            assert torch.equal(now[key], was[s][key]), (s, key)
    while sched.step():
        pass
    assert sched.resumes == 1 and sched.allocator.used_blocks == 0


@pytest.mark.cuda
def test_kv_refine_on_card_equals_cpu_without_syncs():
    """The precision policy's fake-quant on the card equals the CPU's bit
    for bit (f32 and bf16, 4/8/16 bits, an all-zero row) and makes no
    host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.models.attention import kv_refine
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 17, 8, 64, generator=gen) * 3
    x[0, 0] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(dtype)
        xg = xc.cuda()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [kv_refine(xg, b) for b in (4, 8, 16)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for b, g in zip((4, 8, 16), got):
            assert torch.equal(g.cpu(), kv_refine(xc, b)), (dtype, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_mixed_row_paged_decode_kernel_equals_gather(kv_bits):
    """A mixed precision-policy row (4/8 on the smoke config's two layers)
    through the continuous scheduler: K1 in every layer of every step on
    the kernel backend, the gather backend's tokens, f32, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import (AdaptiveServer, Request,
                                            ServingConfig)
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg, params, engine = _smoke_server_parts()
    row = tuple((4, 8, 16)[l % 3] for l in range(cfg.n_layers))
    policy = tuple(row for _ in engine.profile_names)
    rng = np.random.default_rng(37)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=m) for n, m in [(7, 6), (9, 5), (17, 6)]]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    toks = {}
    with use_compute_dtype(torch.float32):
        for backend in ("kernel", "gather"):
            sched = ContinuousScheduler(AdaptiveServer(
                cfg, params, engine, ServingConfig(
                    slots=64, max_batch=4, block_size=8, kv_bits=kv_bits,
                    paged_backend=backend, precision_policy=policy),
                device="cuda"), quantum=4)
            n0 = PA.paged_attention.launches
            for r in reqs:
                sched.submit(r)
            toks[backend] = [r["tokens"] for r in sched.run()]
            k1 = PA.paged_attention.launches - n0
            assert k1 == (cfg.n_layers * sched.decode_steps
                          if backend == "kernel" else 0)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    assert toks["kernel"] == toks["gather"]


def _fault_sched(cfg, params, engine, faults=None, **kw):
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    return ContinuousScheduler(AdaptiveServer(
        cfg, params, engine, ServingConfig(
            slots=64, block_size=8, paged_backend="kernel", **kw),
        device="cuda"), quantum=2, faults=faults, paranoid=True)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["reap", "quarantine"])
def test_reaped_and_quarantined_tables_unmapped_before_next_segment(how):
    """A cancelled row reaped at the flush boundary, or a NaN row
    quarantined, has its table unmapped before the next segment: its
    freed blocks go to a new request in another slot, and the frozen row's
    in-place decode writes (kernel backend) leave every live row's written
    positions unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.serving.engine import Request
    from repro_torch.serving.faults import FaultSchedule
    cfg, params, engine = _smoke_server_parts()
    rng = np.random.default_rng(19)

    def req(n, m):
        return Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                       max_new=m)

    x, a, b, c = req(6, 2), req(10, 6), req(10, 20), req(7, 9)
    sched = _fault_sched(
        cfg, params, engine, max_batch=3, pool_blocks=7, prefix_cache=False,
        faults=FaultSchedule(nan_at={1: (0,)}) if how == "quarantine"
        else None)
    for r in (x, a, b):
        sched.submit(r)
    while "status" not in sched.results.get(0, {}):
        sched.step()
    slot_a = sched.slot_req.index(1)
    blocks_a = set(sched._slot_blocks[slot_a][0])
    if how == "reap":
        assert sched.cancel(1)
        sched._reap_marked()
        assert sched.results[1]["status"].value == "cancelled"
    else:
        sched._flush(0)
        assert 1 in sched._nf_rows
        sched._process_quarantine()
        assert sched.faults_detected == 1
    kv = sched._caches["kv"]
    assert sched.slot_req[slot_a] is None
    assert bool((kv.block_table[:, slot_a] == kv.n_blocks).all())
    sched.submit(c)
    assert sched.admit() == 1
    slot_c = sched.slot_req.index(3)
    assert slot_c != slot_a
    assert set(sched._slot_blocks[slot_c][0]) & blocks_a
    sched._flush(0)
    owners = [s for s, r in enumerate(sched.slot_req) if r is not None]
    was = {s: _row_bytes(sched, s, int(sched._pos[s])) for s in owners}
    sched.run_segment()
    sched._flush(0)
    for s in owners:
        now = _row_bytes(sched, s, was[s]["pos"])
        for key in ("k", "v", "tidx", "ks", "vs"):
            assert torch.equal(now[key], was[s][key]), (how, s, key)
    while sched.step():
        pass
    assert sched.allocator.used_blocks == 0
    done = {rid: r["status"].value for rid, r in sched.results.items()}
    assert done[0] == done[2] == done[3] == "completed"
    assert done[1] == ("cancelled" if how == "reap" else "completed")


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_nan_injection_leaves_neighbour_and_shared_blocks(kv_bits):
    """A NaN poisons a copy-on-write sharer on the kernel backend (f32,
    TF32 off): the shared prefix blocks, the neighbour row's written
    positions and its scales are bitwise those of the same serve without
    the fault, the neighbour's tokens too, and the recovered row's tokens
    equal a clean accuracy-critical run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import Request
    from repro_torch.serving.faults import FaultSchedule
    cfg, params, engine = _smoke_server_parts()
    rng = np.random.default_rng(23)
    base = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    prompts = [np.concatenate([base, rng.integers(0, cfg.vocab, n)
                               .astype(np.int32)]) for n in (3, 5)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    seen = {}
    with use_compute_dtype(torch.float32):
        for faulty in (False, True):
            sched = _fault_sched(
                cfg, params, engine, max_batch=2, kv_bits=kv_bits,
                faults=FaultSchedule(nan_at={1: (0,)}) if faulty else None)
            sched.submit(Request(tokens=prompts[0], max_new=12))
            sched.step()                     # registers the shared prefix
            sched.submit(Request(tokens=prompts[1], max_new=12))
            for _ in range(3):
                sched.step()
            sched._flush(0)
            kv = sched._caches["kv"]
            slot = sched.slot_req.index(0)
            e = max(sched.registry._entries.values(),
                    key=lambda x: x.n_tokens)
            shared = (None if e.block_ids is None else
                      kv.k[:, torch.as_tensor(e.block_ids).long()].clone())
            seen[faulty] = (_row_bytes(sched, slot, int(sched._pos[slot])),
                            shared)
            assert sched.faults_detected == int(faulty)
            while sched.step():
                pass
            seen[faulty] += (sched.results[0]["tokens"],
                             sched.results[1], sched.registry.hits)
            assert sched.allocator.used_blocks == 0
        crit = _fault_sched(cfg, params, engine, max_batch=2,
                            kv_bits=kv_bits)
        crit.submit(Request(tokens=prompts[1], max_new=12,
                            accuracy_critical=True))
        clean = crit.run()[0]["tokens"]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    (row0, sh0, tok0, _, hits0), (row1, sh1, tok1, res1, _) = \
        seen[False], seen[True]
    for key, x in row0.items():
        y = row1[key]
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), key
    assert hits0 >= 1
    if sh0 is not None:
        assert torch.equal(sh0, sh1)
    assert tok0 == tok1
    assert res1["retries"] == 1 and res1["tokens"] == clean


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_recovery_on_card_lands_masters_on_cuda(tmp_path, kv_bits):
    """Crash recovery on the kernel backend (smoke config, f32, TF32 off):
    a scheduler abandoned mid-serve is recovered into a new server; the
    restored snapshots' masters (and int-KV scales) lie on the card, the
    resumed rows decode through K1 (launches = layers × decode steps after
    the restart) and the tokens equal the uninterrupted serve's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving import durability as D
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg, params, engine = _smoke_server_parts()
    savers, crit = _preempt_requests(cfg)
    reqs = savers + [crit]

    def server():
        return AdaptiveServer(cfg, params, engine, ServingConfig(
            slots=64, max_batch=4, block_size=8, kv_bits=kv_bits,
            paged_backend="kernel"), device="cuda")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with use_compute_dtype(torch.float32):
            twin = ContinuousScheduler(server(), quantum=2)
            for r in reqs:
                twin.submit(r)
            want = [r["tokens"] for r in twin.run()]
            s1 = ContinuousScheduler(server(), quantum=2)
            D.Durability(s1, str(tmp_path), checkpoint_every=1)
            for r in reqs:
                s1.submit(r)
            for _ in range(3):
                s1.step()
            seen = []
            apply = D._apply_checkpoint

            def spy(s, tree, meta, pending, info):
                apply(s, tree, meta, pending, info)
                seen.extend(s._suspended.values())

            D._apply_checkpoint = spy
            try:
                s2 = D.recover(server(), str(tmp_path), quantum=2)
            finally:
                D._apply_checkpoint = apply
            assert seen and s2.recover_info["resumed_rows"] == len(seen)
            for snap in seen:
                assert snap.master_k.device.type == "cuda"
                assert snap.master_v.device.type == "cuda"
                if kv_bits == 8:
                    assert snap.k_scale.device.type == "cuda"
            n0 = PA.paged_attention.launches
            while s2.step():
                pass
            assert PA.paged_attention.launches - n0 == \
                cfg.n_layers * s2.decode_steps > 0
            assert [s2.results[i]["tokens"] for i in range(3)] == want
            s2.check()
            assert s2.allocator.used_blocks == 0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_checkpoint_restores_onto_cuda(tmp_path):
    """A checkpoint restores onto the card: with a template every leaf is
    a tensor there of the template's dtype (bf16 bitwise), without one
    ``device="cuda"`` places the host arrays there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.checkpoint.manager import restore, save
    gen = torch.Generator(device="cuda").manual_seed(3)
    t = {"mk": torch.randn(2, 9, 2, 4, generator=gen, device="cuda"),
         "w": torch.randn(5, 7, generator=gen,
                          device="cuda").to(torch.bfloat16),
         "ids": torch.arange(6, dtype=torch.int32, device="cuda")}
    save(str(tmp_path), 1, t)
    out, _ = restore(str(tmp_path), {k: torch.empty_like(v)
                                     for k, v in t.items()}, device="cuda")
    bare, _ = restore(str(tmp_path), device="cuda")
    for got in (out, bare):
        for k, v in t.items():
            assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
            a, b = ((x.view(torch.int16) if x.dtype == torch.bfloat16
                     else x) for x in (got[k], v))
            assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 28, 28, 1), (3, 3, 8, 8),
                                   (16, 392), (392, 10)])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_aquant_kernel_returns_its_scale(shape, bits):
    """K5 with ``return_scale`` at the CNN's site shapes (small batch):
    the output bitwise the plain version's, the scale the plain scalar,
    one launch, the same output as without the scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(bits)
    x = torch.randn(shape, generator=gen, device="cuda") * 1.7
    n0 = AQ.aquant.launches
    got, s = AQ.aquant(x, bits, True, return_scale=True)
    torch.cuda.synchronize()
    assert AQ.aquant.launches == n0 + 1
    want, ws = AQ.aquant_ref(x, bits, True, return_scale=True)
    assert s.shape == () and s.device.type == "cuda"
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(s, ws)
    assert torch.equal(got, AQ.aquant(x, bits, True))


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["A8-W8", "Mixed", "A16-W4"])
def test_cnn_gradient_kernel_equals_plain(profile, monkeypatch):
    """One CNN training step's loss and gradients at a small width: K5
    (forward, scale for the straight-through mask) against its plain
    version swapped in, bit for bit (cuDNN deterministic, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    from repro_torch.core import quantizers as QZ
    from repro_torch.core.profiles import paper_profiles, profile_table
    from repro_torch.models import cnn as C
    profs = paper_profiles(C.CNN_LAYERS, inner_layers=["conv1"])
    row = profile_table(profs, C.CNN_LAYERS)[
        [p.name for p in profs].index(profile)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = C.init_cnn(C.CNNConfig(channels=16), gen, "cuda")
    batch = {"images": torch.rand((32, 28, 28, 1), generator=gen,
                                  device="cuda"),
             "labels": torch.arange(32, device="cuda") % 10}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        n0 = AQ.aquant.launches
        (l1, _), g1 = C.cnn_loss_and_grad(params, row, batch)
        torch.cuda.synchronize()
        assert AQ.aquant.launches - n0 == sum(
            int(b) < 17 for b in row.reshape(-1))
        monkeypatch.setattr(QZ, "aquant", AQ.aquant_ref)
        (l2, _), g2 = C.cnn_loss_and_grad(params, row, batch)
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert torch.equal(l1, l2)
    for ln in g1:
        for k in g1[ln]:
            assert torch.equal(g1[ln][k], g2[ln][k]), (ln, k)
            assert g1[ln][k].abs().sum() > 0 or k == "b"


@pytest.mark.cuda
@pytest.mark.parametrize("m,route", [(1, "splitk"), (8, "splitk"),
                                     (16, "splitk"), (512, "mma_sync")])
@pytest.mark.parametrize("bits", [8, 4])
def test_qmatmul_at_mamba2_ssm_in(m, route, bits):
    """K3 at mamba2-130m's ``ssm_in`` (K 768, N 3352): weight rows of 3352
    bytes at W8 and 1676 at W4 are not 16-byte multiples, so decode runs
    split-K with bytewise loads and prefill the mma.sync kernel; within the
    summation-order bound, two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, w_q, scale = _qmatmul_case(m, 768, 3352, bits, torch.bfloat16,
                                  m + bits)
    got = QM.qmatmul(x, w_q, scale, bits=bits)
    assert QM.qmatmul.last_route == route
    again = QM.qmatmul(x, w_q, scale, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = QM.qmatmul_ref(x, w_q, scale, bits)
    wb = QM.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * 768 * 2.0 ** -24 * (x.bfloat16().float().abs() @ wb.abs())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_aquant_on_a_mamba2_ssm_in_image(bits):
    """K5 on one layer's ``ssm_in`` weight image, ``[768, 3352]`` f32, bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(bits)
    x = (torch.randn((768, 3352), generator=gen) / 768 ** 0.5).cuda()
    got = AQ.aquant(x, bits, True)
    torch.cuda.synchronize()
    want = AQ.aquant_ref(x, bits, True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_mamba2_serve_on_card_equals_cpu():
    """The 2-layer mamba2 smoke model served (ragged static groups and the
    continuous scheduler) on the card in f32, TF32 off, gives the CPU's
    tokens; the card builds its weight images through K5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import (AdaptiveServer, Request,
                                            ServingConfig)
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg = get_smoke("mamba2-130m")
    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(23)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=m) for n, m in ((4, 6), (9, 3), (17, 8),
                                            (40, 5), (6, 7))]
    flag = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with use_compute_dtype(torch.float32):
            for dev in ("cpu", "cuda"):
                p = _to(params, dev)
                n0 = AQ.aquant.launches
                srv = AdaptiveServer(cfg, p, engine, ServingConfig(
                    slots=64, max_batch=4), device=dev)
                static = [r["tokens"] for r in srv.serve(reqs)]
                sched = ContinuousScheduler(srv, quantum=4)
                assert not sched.paged
                for r in reqs:
                    sched.submit(r)
                res = sched.run()
                out[dev] = (static, [res[i]["tokens"]
                                     for i in range(len(reqs))])
                if dev == "cuda":
                    assert AQ.aquant.launches > n0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert out["cuda"] == out["cpu"]
    assert out["cpu"][0] == out["cpu"][1]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------- hymba

def _ring_inputs(bits: int, gen: torch.Generator, b=6, hkv=5, hg=5, d=64,
                 bs=16, n_lblk=64):
    """K1's operands on hymba-1.5b's sliding-window ring (5 KV heads, 5
    query heads each, 1024 slots in blocks of 16): shuffled tables, slot
    ``j`` holding the newest token ``t <= pos`` with ``t % 1024 == j``;
    rows at 300 (not wrapped), 1023, 1024, 1029 and 3071; one dead row."""
    cap = n_lblk * bs
    n_blocks = b * n_lblk + 3
    pos = torch.tensor([300, cap - 1, cap, cap + 5, 3 * cap - 1, 0][:b],
                       dtype=torch.int32)
    bt = torch.randperm(n_blocks, generator=gen)[:b * n_lblk].reshape(
        b, n_lblk).int()
    bt[-1] = -1
    tidx = torch.full((n_blocks, bs), -1, dtype=torch.int32)
    slot = torch.arange(cap)
    for r in range(b - 1):
        p = int(pos[r])
        t = p - (p - slot) % cap
        tidx[bt[r].long()] = torch.where(t >= 0, t, -1).int().reshape(
            n_lblk, bs)
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
@pytest.mark.parametrize("window", [1024, 1000])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_paged_attention_kernel_on_hymba_ring(bits, window):
    """K1 at Hg 5 on wrapped rings: hymba's window of 1024 (every live
    slot inside it) and 1000 (the oldest slots masked), against the plain
    version; the dead row exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x = _ring_inputs(bits, torch.Generator().manual_seed(bits + window))
    n0 = PA.paged_attention.launches
    got = PA.paged_attention(**x, bits=bits, window=window)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == n0 + 1
    want = PA.paged_attention_ref(**x, bits=bits, window=window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.all(got[-1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_qkv_attention_kernel_at_hg5(qdtype):
    """K4 at hymba's 5 KV heads of 5 query heads, S 1024 (the ring), with
    lengths 0, 1, 65, 544, 1024 and 1024 (a wrapped ring is full)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    q, k, v, ks, vs, lens = _qkv_case(6, 1024, 5, 5, 64,
                                      [0, 1, 65, 544, 1024, 1024], qdtype, 5)
    n0 = QK.qkv_attention.launches
    got = QK.qkv_attention(q, k, v, ks, vs, lens)
    torch.cuda.synchronize()
    assert QK.qkv_attention.launches == n0 + 1
    want = QK.qkv_attention_cache_ref(q, k, v, ks, vs, lens)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bits,route", [
    (8, 1600, 6482, 8, "splitk"),        # ssm_in: 6482-byte rows
    (8, 1600, 6482, 4, "splitk"),        # 3241-byte packed rows, odd
    (300, 1600, 6482, 8, "mma_sync"),
    (300, 1600, 6482, 4, "mma_sync"),
    (8, 1600, 32001, 8, "splitk"),       # the untied head, N odd
    (300, 1600, 32001, 8, "mma_sync"),
    (300, 1600, 11008, 8, "wgmma")])     # mlp_in
def test_qmatmul_kernel_at_hymba_sites(m, k, n, bits, route):
    """K3 at hymba-1.5b's ``ssm_in`` (N 6482), untied head (N 32001) and
    ``mlp_in`` on the route the rule gives, bf16 x: within the
    summation-order bound, two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, w_q, scale = _qmatmul_case(m, k, n, bits, torch.bfloat16, m + n + bits)
    got = QM.qmatmul(x, w_q, scale, bits=bits)
    assert QM.qmatmul.last_route == route
    again = QM.qmatmul(x, w_q, scale, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = QM.qmatmul_ref(x, w_q, scale, bits)
    wb = QM.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * k * 2.0 ** -24 * (x.float().abs() @ wb.abs())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_hymba_paged_serve_equals_contiguous(kv_bits):
    """The hymba smoke model (window 16) served by the continuous scheduler
    on the card in f32, TF32 off: the paged pool through K1 (layers x
    decode steps launches) gives the contiguous ring's tokens (through K4
    at kv8), with rows reused and rings that wrap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import (AdaptiveServer, Request,
                                            ServingConfig)
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg = get_smoke("hymba-1.5b")
    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    rng = np.random.default_rng(29)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=m) for n, m in ((17, 9), (4, 20), (19, 12),
                                            (9, 12), (6, 7))]
    flag = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with use_compute_dtype(torch.float32):
            for paged in (True, False):
                sched = ContinuousScheduler(AdaptiveServer(
                    cfg, params, engine, ServingConfig(
                        slots=64, max_batch=2, kv_bits=kv_bits,
                        paged_kv=paged, paged_backend="kernel"),
                    device="cuda"), quantum=4)
                assert sched.paged == paged
                n1, n4 = PA.paged_attention.launches, QK.qkv_attention.launches
                for r in reqs:
                    sched.submit(r)
                res = sched.run()
                out[paged] = [res[i]["tokens"] for i in range(len(reqs))]
                k1 = PA.paged_attention.launches - n1
                k4 = QK.qkv_attention.launches - n4
                steps = cfg.n_layers * sched.decode_steps
                assert k1 == (steps if paged else 0)
                assert k4 == (steps if not paged and kv_bits == 8 else 0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert out[True] == out[False]


# ---------------------------------------------------------------- MoE

@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((60, 2048, 2816), torch.float32),   # qwen2-moe's routed w_in, 346 M
    ((60, 1408, 2048), torch.float32),   # its routed w_out
    ((16, 60, 22, 2048), torch.bfloat16)])   # a prefill dispatch buffer
@pytest.mark.parametrize("bits", [8, 4])
def test_aquant_on_stacked_expert_shapes(shape, dtype, bits):
    """K5 on qwen2-moe-a2.7b's stacked routed-expert masters (one layer)
    and a wave's ``[G, E, cap, d]`` dispatch buffer, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(bits + len(shape))
    x = (torch.randn(shape, generator=gen, device="cuda")
         * shape[-2] ** -0.5).to(dtype)
    n0 = AQ.aquant.launches
    got = AQ.aquant(x, bits, True)
    torch.cuda.synchronize()
    assert AQ.aquant.launches == n0 + 1
    want = AQ.aquant_ref(x, bits, True)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(view), want.view(view))


@pytest.mark.cuda
def test_moe_forward_on_card_equals_cpu():
    """The 2-layer qwen2-moe smoke model's ragged forward (pad tokens
    masked out of the dispatch) on the card in f32, TF32 off, at the float
    profile: hidden states and aux within 1e-4 of the port on the CPU. At
    bf16 and A8-W8 the card's forward runs the four routed fake-quants of
    every layer through K5 and gives finite hidden states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_smoke
    from repro_torch.core.profiles import (Profile, paper_profiles,
                                           profile_table)
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    cfg = get_smoke("qwen2-moe-a2.7b")
    names = T.quant_layer_names(cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(31)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    batch = {"prompt_len": np.array([16, 5, 11, 2], np.int32)}
    f32 = profile_table([Profile.float32(names)], names)[0]
    flag = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with use_compute_dtype(torch.float32):
            for dev in ("cpu", "cuda"):
                b = dict(batch, tokens=torch.from_numpy(toks).to(dev))
                h, aux, _ = T.forward(_to(params, dev), cfg, f32, b)
                out[dev] = (h.cpu(), aux.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=0,
                               rtol=1e-4)
    a8w8 = profile_table(paper_profiles(names, inner_layers=[]), names)[2]
    p = _to(params, "cuda")
    n0 = AQ.aquant.launches
    h, _, _ = T.forward(p, cfg, a8w8, dict(
        batch, tokens=torch.from_numpy(toks).cuda()))
    torch.cuda.synchronize()
    # 4 routed fake-quants + 5 weight fake-quants of the linears per layer
    # (no images: the masters are quantized per call), the embedding's one
    assert AQ.aquant.launches - n0 == cfg.n_layers * (4 + 5) + 1
    assert h.dtype == torch.bfloat16 and bool(torch.isfinite(h).all())


# ---------------------------------------------------------------- qwen2-vl, hubert

@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_paged_attention_kernel_at_hg6_d128(bits):
    """K1 at qwen2-vl-2b's 2 KV heads of 6 query heads, D 128, against the
    plain version; the dead row exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x = _inputs(bits, torch.Generator().manual_seed(60 + bits), hkv=2, hg=6,
                d=128)
    n0 = PA.paged_attention.launches
    got = PA.paged_attention(**x, bits=bits)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == n0 + 1
    want = PA.paged_attention_ref(**x, bits=bits)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.all(got[-1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_qkv_attention_kernel_at_hg6_d128(qdtype):
    """K4 at qwen2-vl-2b's 2 KV heads of 6 query heads, D 128, over a
    cache of 544 slots, with lengths 0, 1, 257, 320, 543 and 544."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    q, k, v, ks, vs, lens = _qkv_case(6, 544, 2, 6, 128,
                                      [0, 1, 257, 320, 543, 544], qdtype, 6)
    n0 = QK.qkv_attention.launches
    got = QK.qkv_attention(q, k, v, ks, vs, lens)
    torch.cuda.synchronize()
    assert QK.qkv_attention.launches == n0 + 1
    want = QK.qkv_attention_cache_ref(q, k, v, ks, vs, lens)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bits,route", [
    (8, 1536, 17920, 8, "splitk"),       # qwen2-vl mlp_in, decode
    (8, 1536, 17920, 4, "splitk"),
    (300, 1536, 17920, 8, "wgmma"),      # a prefill wave
    (500, 512, 1280, 8, "wgmma"),        # hubert's embed over features
    (500, 1280, 3840, 8, "wgmma"),       # hubert qkv
    (500, 1280, 3840, 4, "wgmma"),
    (500, 1280, 504, 8, "mma_sync"),     # hubert's head: 504-byte rows
    (500, 1280, 504, 4, "mma_sync")])    # 252-byte packed rows
def test_qmatmul_kernel_at_vlm_and_audio_sites(m, k, n, bits, route):
    """K3 at qwen2-vl-2b's ``mlp_in`` (N 17920) and hubert-xlarge's embed,
    ``qkv`` (N 3840) and head (N 504) on the route the rule gives, bf16 x:
    within the summation-order bound, two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    x, w_q, scale = _qmatmul_case(m, k, n, bits, torch.bfloat16, m + n + bits)
    got = QM.qmatmul(x, w_q, scale, bits=bits)
    assert QM.qmatmul.last_route == route
    again = QM.qmatmul(x, w_q, scale, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = QM.qmatmul_ref(x, w_q, scale, bits)
    wb = QM.dequant_ref(w_q, scale, bits).bfloat16().float()
    tol = 4 * k * 2.0 ** -24 * (x.float().abs() @ wb.abs())
    assert bool(((got - want).abs() <= tol).all())


def _paged_copy(kv, bs: int):
    """A paged pool holding the rows of the contiguous stacked cache
    ``kv``: row ``b``'s table maps blocks ``b·n_lblk ..`` in order, plus
    the write sink."""
    from repro_torch.models.attention import PagedKVCache
    L, B, slots = kv.token_idx.shape
    n_lblk = slots // bs
    nb = B * n_lblk

    def blocks(x, fill):
        out = torch.full((L, nb + 1, bs, *x.shape[3:]), fill, dtype=x.dtype,
                         device=x.device)
        out[:, :nb] = x.reshape(L, nb, bs, *x.shape[3:])
        return out

    table = torch.arange(nb, dtype=torch.int32, device=kv.k.device)
    return PagedKVCache(
        k=blocks(kv.k, 0), v=blocks(kv.v, 0), k_scale=kv.k_scale.clone(),
        v_scale=kv.v_scale.clone(), token_idx=blocks(kv.token_idx, -1),
        block_table=table.reshape(1, B, n_lblk).expand(L, -1, -1).clone(),
        n_blocks=nb, bits=kv.bits)


@pytest.mark.cuda
def test_vlm_paged_decode_kernel_equals_gather():
    """The qwen2-vl smoke model (M-RoPE, a vision prefix of 8 patches) on
    the card in f32, TF32 off: an image + text prefill copied into a bf16
    paged pool, then 6 greedy decode steps through K1 (layers x steps
    launches) and through the gather backend — logits within 1e-5, the
    same tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_smoke
    from repro_torch.core.profiles import Profile, profile_table
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    cfg = get_smoke("qwen2-vl-2b")
    names = T.quant_layer_names(cfg)
    br = profile_table([Profile.float32(names)], names)[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 14), generator=gen,
                                     device="cuda"),
             "patch_embeds": 0.02 * torch.randn(
                 (2, cfg.n_patches, cfg.d_model), generator=gen,
                 device="cuda")}
    flag = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with use_compute_dtype(torch.float32):
            for backend in ("kernel", "gather"):
                logits, caches = T.prefill(params, cfg, br, batch, 32)
                caches["kv"] = _paged_copy(caches["kv"], 8)
                n0 = PA.paged_attention.launches
                toks, steps = [], []
                for i in range(6):
                    tok = logits.argmax(-1).to(torch.int32)
                    toks.append(tok)
                    logits, caches = T.decode_step(
                        params, cfg, br, tok[:, None],
                        torch.full((2,), 14 + i, dtype=torch.int32,
                                   device="cuda"), caches,
                        paged_backend=backend)
                    steps.append(logits)
                k1 = PA.paged_attention.launches - n0
                assert k1 == (cfg.n_layers * 6 if backend == "kernel" else 0)
                out[backend] = (torch.stack(toks), torch.stack(steps))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    assert torch.equal(out["kernel"][0], out["gather"][0])
    torch.testing.assert_close(out["kernel"][1], out["gather"][1], atol=1e-5,
                               rtol=0)


@pytest.mark.cuda
def test_hubert_forward_on_card_equals_cpu():
    """The hubert smoke encoder (layer norms, bidirectional attention,
    GELU) on a left-padded ragged batch of frame features, on the card in
    f32, TF32 off, at the float profile: hidden states within 1e-4 of the
    port on the CPU. At bf16 and A8-W8 the card's forward and frame logits
    fake-quantize each linear through K5 (4 per layer, the embed and the
    head) and give finite logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_smoke
    from repro_torch.core.profiles import (Profile, paper_profiles,
                                           profile_table)
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    cfg = get_smoke("hubert-xlarge")
    names = T.quant_layer_names(cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(30)
    feats = rng.standard_normal((3, 40, cfg.feature_dim)).astype(np.float32)
    plen = np.array([40, 23, 9], np.int32)
    f32 = profile_table([Profile.float32(names)], names)[0]
    flag = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with use_compute_dtype(torch.float32):
            for dev in ("cpu", "cuda"):
                h, _, _ = T.forward(_to(params, dev), cfg, f32, {
                    "features": torch.from_numpy(feats).to(dev),
                    "prompt_len": plen})
                out[dev] = h.cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    valid = torch.from_numpy(np.arange(40)[None] >= (40 - plen)[:, None])
    torch.testing.assert_close(out["cuda"][valid], out["cpu"][valid],
                               atol=1e-4, rtol=0)
    a8w8 = profile_table(paper_profiles(names, inner_layers=[]), names)[2]
    p = _to(params, "cuda")
    n0 = AQ.aquant.launches
    h, _, _ = T.forward(p, cfg, a8w8, {
        "features": torch.from_numpy(feats).cuda(), "prompt_len": plen})
    logits = T._logits(cfg, p, a8w8, h)
    torch.cuda.synchronize()
    assert AQ.aquant.launches - n0 == cfg.n_layers * 4 + 2
    assert h.dtype == torch.bfloat16 and logits.shape == (3, 40, 512)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------- training

def _train_smoke(dev, steps=2, pids=(2, 5), remat=True):
    """The launcher's granite smoke setup on ``dev`` (weights from seed 0
    on the CPU, moved over), remat on, its data at B 2 × S 32 and the
    profiles ``pids`` in turn."""
    import dataclasses
    from repro_torch.launch import train as LT
    run = LT.setup(LT.parse_args(["--device", "cpu", "--batch", "2",
                                  "--seq", "32", "--steps", str(steps)]))
    run.cfg = dataclasses.replace(run.cfg, remat=remat)
    cfg = run.cfg
    from repro_torch.models import transformer as T
    run.engine = type(run.engine)(run.engine.profiles, run.engine.index,
                                  lambda p, br, b: T.train_loss(p, cfg, br,
                                                                b))
    run.params = _to(run.params, dev)
    base = run.data_at

    def data_at(step):
        b = base(step)
        return {"tokens": b["tokens"].to(dev), "labels": b["labels"].to(dev),
                "profile_id": pids[step % len(pids)]}

    def loss_fn(p, b):
        return run.engine(p, b["profile_id"], {"tokens": b["tokens"],
                                               "labels": b["labels"]})
    run.data_at, run.loss_fn = data_at, loss_fn
    return run


@pytest.mark.cuda
def test_training_step_on_card_equals_cpu():
    """One training step of the granite smoke LM (remat on, A8-W8) on the
    card in f32, TF32 off, through K5 (the embed, 8 layer sites, the head;
    again in the recompute), against the port on the CPU: the loss within
    1e-5, every gradient leaf within 1e-4 of its max-abs, and the in-place
    AdamW step on the CPU's gradients within 1e-6 of the CPU's (the update
    is elementwise; fed the card's own gradients, an element near zero
    may take the other sign, and Adam's first step is ``lr · sign``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.train.loop import _flatten, value_and_grad
    from repro_torch.optim.adam import adam_init, adam_update_
    flag = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with use_compute_dtype(torch.float32):
            for dev in ("cpu", "cuda"):
                run = _train_smoke(dev)
                n0 = AQ.aquant.launches
                (loss, m), g = value_and_grad(run.loss_fn, run.params,
                                              run.data_at(0))
                torch.cuda.synchronize()
                if dev == "cuda":
                    assert AQ.aquant.launches - n0 == 1 + 2 * (8 + 1)
                grads = [t.to("cpu", copy=True) for t in _flatten(g)[0]]
                if dev == "cpu":
                    g_cpu = g
                adam_update_(run.adam_cfg, _to(g_cpu, dev),
                             adam_init(run.params), run.params)
                out[dev] = (loss.cpu(), grads,
                            [t.cpu() for t in _flatten(run.params)[0]])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    (l0, g0, p0), (l1, g1, p1) = out["cpu"], out["cuda"]
    assert abs(float(l0) - float(l1)) <= 1e-5
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())
    for a, b in zip(p0, p1):
        assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_aquant_inside_a_checkpoint_recompute_is_bitwise(out_dtype):
    """K5 replayed by ``torch.utils.checkpoint``'s recompute (on the
    autograd engine's thread, on the forward's stream, with its workspace)
    writes the forward's output and scale bit for bit, leaves the
    workspace zeroed, and the gradient equals the one without the
    checkpoint."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    from torch.utils.checkpoint import checkpoint
    from repro_torch.core.quantizers import fake_quant_dynamic
    gen = torch.Generator(device="cuda").manual_seed(32)
    w = torch.randn(3, 256, 1000, generator=gen, device="cuda")
    x = torch.randn(7, 256, generator=gen, device="cuda")
    seen = []

    def f(w, x):
        q = fake_quant_dynamic(w[1], 8, out_dtype=out_dtype)
        seen.append(q.detach().clone())
        return (x.to(out_dtype) @ q).float().square().sum()

    grads = []
    for ck in (False, True):
        wl = w.detach().requires_grad_(True)
        n0 = AQ.aquant.launches
        loss = checkpoint(f, wl, x, use_reentrant=False) if ck else f(wl, x)
        loss.backward()
        torch.cuda.synchronize()
        assert AQ.aquant.launches - n0 == (2 if ck else 1)
        grads.append(wl.grad)
    assert len(seen) == 3
    view = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(seen[1].view(view), seen[2].view(view))
    assert torch.equal(seen[0].view(view), seen[1].view(view))
    assert torch.equal(grads[0], grads[1])
    pool, _ = AQ._WS[torch.device("cuda").index or 0]
    assert int(pool.abs().sum()) == 0


_DETERMINISM = r'''
import os, sys
sys.path.insert(0, "src")
import torch
torch.use_deterministic_algorithms(True)
sys.path.insert(0, "tests")
from test_torch_cuda import _train_smoke
from repro_torch.train.loop import _flatten, train, TrainConfig
outs = []
for _ in range(2):
    run = _train_smoke("cuda", steps=2)
    o = train(run.params, run.loss_fn, run.data_at, TrainConfig(steps=2,
              log_every=100), run.adam_cfg, step_factory=run.step_factory,
              log=lambda s: None)
    torch.cuda.synchronize()
    outs.append([t.cpu() for tree in (o["params"], o["opt"].mu, o["opt"].nu)
                 for t in _flatten(tree)[0]])
assert all(torch.equal(a, b) for a, b in zip(*outs))
print("deterministic", len(outs[0]))
'''


@pytest.mark.cuda
def test_training_steps_are_deterministic_on_card():
    """Two training steps of the granite smoke LM on the card in bf16 under
    ``torch.use_deterministic_algorithms(True)`` (in a subprocess, with
    ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts): no op refuses,
    and a second run gives the same parameters and moments bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = subprocess.run([sys.executable, "-c", _DETERMINISM], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "deterministic" in res.stdout


@pytest.mark.cuda
def test_resumed_run_on_card_is_bitwise(tmp_path):
    """The granite smoke LM on the card in bf16: a run that fails at step 3
    and resumes from its step-2 checkpoint ends with the parameters and
    moments of the uninterrupted run, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    from repro_torch.train.loop import TrainConfig, _flatten, train
    outs = []
    for name, fail in (("ref", None), ("fail", 3)):
        run = _train_smoke("cuda", steps=5)
        cfg = TrainConfig(steps=5, ckpt_dir=str(tmp_path / name),
                          ckpt_every=2, log_every=100, fail_at_step=fail)
        kw = dict(step_factory=run.step_factory, log=lambda s: None)
        if fail is not None:
            with pytest.raises(RuntimeError, match="injected failure"):
                train(run.params, run.loss_fn, run.data_at, cfg,
                      run.adam_cfg, **kw)
            cfg.fail_at_step = None
        o = train(run.params, run.loss_fn, run.data_at, cfg, run.adam_cfg,
                  **kw)
        outs.append((o["history"], [
            t.cpu() for tree in (o["params"], o["opt"].mu, o["opt"].nu)
            for t in _flatten(tree)[0]]))
    (h0, a), (h1, b) = outs
    assert h1 == h0[3:]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the decode segment replayed from CUDA graphs (serving/graphs.py)
# ---------------------------------------------------------------------------

def _graph_serve(scfg, graphs, reqs, rounds=1):
    """The granite smoke model on the card in bf16 under the launcher's
    manager (a small budget: profile switches), served by a scheduler with
    ``graphs`` on or off in ``rounds`` submission rounds; each graphed
    segment runs under ``set_sync_debug_mode("error")``. Returns the
    scheduler, the per-round audits and the K1/K4 launches."""
    from repro_torch.analysis.tracker import SchedulerAudit
    from repro_torch.core.manager import ProfileManager
    from repro_torch.launch.serve import profile_stats
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg, params, engine = _smoke_server_parts()
    stats = profile_stats(cfg, engine.profiles, T.param_count(params))
    mgr = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                         budget_j=stats[0].energy_j * 30, low_energy=0.5)
    srv = AdaptiveServer(cfg, params, engine, ServingConfig(
        slots=64, max_batch=4, block_size=8, paged_backend="kernel",
        **scfg), manager=mgr, device="cuda")
    seg = srv.segment

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error" if graphs else 0)
        try:
            return seg(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    srv.segment = guarded
    sched = ContinuousScheduler(srv, quantum=4, graphs=graphs)
    n0 = PA.paged_attention.launches, QK.qkv_attention.launches
    audits = []
    for part in np.array_split(np.arange(len(reqs)), rounds):
        with SchedulerAudit(sched) as audit:
            for i in part:
                sched.submit(reqs[i])
            sched.run()
        audits.append(audit)
    torch.cuda.synchronize()
    return sched, audits, (PA.paged_attention.launches - n0[0],
                           QK.qkv_attention.launches - n0[1])


def _graph_requests(cfg, seed=41):
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=m, accuracy_critical=(i % 3 == 0))
            for i, (n, m) in enumerate([(7, 9), (12, 5), (5, 13), (20, 6),
                                        (9, 11), (6, 4), (15, 8)])]


@pytest.mark.cuda
@pytest.mark.parametrize("scfg", [dict(kv_bits=16), dict(kv_bits=8),
                                  dict(kv_bits=4),
                                  dict(kv_bits=8, paged_kv=False)],
                         ids=["kv16", "kv8", "kv4", "kv8-contiguous"])
def test_graphed_segments_equal_eager_on_card(scfg):
    """Segment graphs on the card: the scheduler's tokens, traces and
    events equal the eager segment's; K1 (paged) or K4 (contiguous)
    launches equal too, counted as launches per capture x replays; one
    capture per profile id; no synchronizing call in a graphed segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_smoke
    reqs = _graph_requests(get_smoke("granite-3-2b"))
    runs = {g: _graph_serve(scfg, g, reqs) for g in (False, True)}
    (eager, _, n_e), (graphed, (audit,), n_g) = runs[False], runs[True]
    assert eager.graphs is None and graphed.graphs is not None
    for rid in eager.results:
        for key in ("tokens", "profile_trace"):
            assert graphed.results[rid][key] == eager.results[rid][key]
    assert graphed.events == eager.events
    assert n_g == n_e and max(n_g) == graphed.srv.cfg.n_layers * \
        graphed.decode_steps
    audit.assert_single_segment()
    assert len(graphed.graphs.used) >= 2
    assert graphed.graphs.replays == graphed.decode_steps - len(
        graphed.graphs.captured)


@pytest.mark.cuda
def test_no_capture_on_a_warm_pool_on_card():
    """A second submission round on the warm pool replays the graphs the
    first captured: no profile id is captured again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_smoke
    reqs = _graph_requests(get_smoke("granite-3-2b"), seed=43)
    sched, (first, warm), _ = _graph_serve(dict(kv_bits=16), True,
                                           reqs + reqs, rounds=2)
    first.assert_single_segment()
    warm.assert_single_segment()
    warm.assert_no_retrace()
    assert sched.graphs.lifetimes == 1
    assert sched.graphs.capture_count() <= len(sched.srv.engine.table)


# ---------------------------------------------------------------------------
# the speculative segment and the static decode replayed from CUDA graphs
# ---------------------------------------------------------------------------

def _guarded(fn, on: bool):
    """``fn`` under ``set_sync_debug_mode("error")`` when ``on``."""
    def run(*a, **k):
        torch.cuda.set_sync_debug_mode("error" if on else 0)
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return run


def _spec_graph_serve(scfg, graphs, reqs):
    """The granite smoke model on the card under the launcher's manager,
    served by a speculative scheduler (``draft_k`` 3) with ``graphs`` on
    or off; each graphed speculative segment runs under
    ``set_sync_debug_mode("error")`` (the flush before it syncs by
    design, so the guard wraps the segment alone). Returns the scheduler,
    its audit and the K2 launches."""
    from repro_torch.analysis.tracker import SchedulerAudit
    from repro_torch.core.manager import ProfileManager
    from repro_torch.launch.serve import profile_stats
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg, params, engine = _smoke_server_parts()
    stats = profile_stats(cfg, engine.profiles, T.param_count(params))
    mgr = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                         budget_j=stats[0].energy_j * 30, low_energy=0.5)
    srv = AdaptiveServer(cfg, params, engine, ServingConfig(
        slots=64, max_batch=4, block_size=8, paged_backend="kernel",
        speculate=True, draft_k=3, **scfg), manager=mgr, device="cuda")
    srv.segment_spec = _guarded(srv.segment_spec, graphs is not False)
    sched = ContinuousScheduler(srv, quantum=4, graphs=graphs)
    n0 = PA.paged_attention_multi.launches
    with SchedulerAudit(sched) as audit:
        for r in reqs:
            sched.submit(r)
        sched.run()
    torch.cuda.synchronize()
    return sched, audit, PA.paged_attention_multi.launches - n0


@pytest.mark.cuda
@pytest.mark.parametrize("scfg", [dict(kv_bits=16), dict(kv_bits=8),
                                  dict(kv_bits=8, paged_kv=False)],
                         ids=["kv16", "kv8", "kv8-contiguous"])
def test_graphed_spec_segments_equal_eager_on_card(scfg):
    """Window graphs on the card: a speculative scheduler replays them by
    default; tokens, traces, events and ``spec_billed`` equal the eager
    segment's; K2 launches (paged) equal too, ``n_layers`` × windows;
    one capture per profile id; billed tokens equal delivered ones; no
    synchronizing call inside a graphed segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.configs import get_smoke
    from repro_torch.serving import graphs as G
    reqs = _graph_requests(get_smoke("granite-3-2b"), seed=47)
    runs = {g: _spec_graph_serve(scfg, g, reqs) for g in (False, None)}
    (eager, _, k2_e), (graphed, audit, k2_g) = runs[False], runs[None]
    assert eager.graphs is None
    assert isinstance(graphed.graphs, G.SpecSegmentGraphs)
    for rid in eager.results:
        for key in ("tokens", "profile_trace"):
            assert graphed.results[rid][key] == eager.results[rid][key]
    assert graphed.events == eager.events
    assert graphed.spec_billed == eager.spec_billed
    paged = scfg.get("paged_kv", True)
    assert k2_g == k2_e == (graphed.srv.cfg.n_layers * graphed.windows_run
                            if paged else 0)
    audit.assert_single_segment()
    delivered = sum(len(r["tokens"]) for r in graphed.results.values())
    assert len(graphed.admission_log) + sum(
        n for _, n in graphed.spec_billed) == delivered


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [8, 16])
def test_graphed_static_generate_equals_eager_on_card(kv_bits):
    """The static path's decode on graphs (the card's default): the serve's
    tokens and traces equal the eager ``decode_many``'s from the same
    manager state; K4 launches (kv8) equal, ``n_layers`` × decode steps;
    one capture per profile id of the group shape, none on a second serve;
    no synchronizing call inside the graphed decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import copy
    from repro_torch.core.manager import ProfileManager
    from repro_torch.launch.serve import profile_stats
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    cfg, params, engine = _smoke_server_parts()
    stats = profile_stats(cfg, engine.profiles, T.param_count(params))
    mgr = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                         budget_j=stats[0].energy_j * 12, low_energy=0.5)
    srv = AdaptiveServer(cfg, params, engine, ServingConfig(
        slots=64, max_batch=4, kv_bits=kv_bits, paged_backend="kernel"),
        manager=mgr, device="cuda")
    reqs = _graph_requests(cfg, seed=53)
    out = {}
    for graphs in (False, None, None):
        srv.manager = copy.deepcopy(mgr)
        srv.decode_static = _guarded(
            AdaptiveServer.decode_static.__get__(srv), graphs is None)
        n0 = QK.qkv_attention.launches
        res = srv.serve(reqs, graphs=graphs)
        torch.cuda.synchronize()
        out.setdefault(graphs, []).append(
            (res, QK.qkv_attention.launches - n0,
             {k: list(g.captured) for k, (g, _) in
              srv.static_graphs.items()}))
    del srv.decode_static
    (eager, k4_e, _), = out[False]
    (first, k4_g, caps), (second, k4_2, caps2) = out[None]
    for res in (first, second):
        for g, e in zip(res, eager):
            assert g["tokens"] == e["tokens"]
            assert g["profile_trace"] == e["profile_trace"]
    order = sorted(reqs, key=lambda r: len(r.tokens))
    steps = sum(max(r.max_new for r in order[i:i + 4]) - 1
                for i in range(0, len(order), 4))
    assert k4_g == k4_e == k4_2 == (cfg.n_layers * steps if kv_bits == 8
                                    else 0)
    assert list(caps) == [(4, 64, kv_bits)] and caps == caps2
    used = {p for r in first for p in r["profile_trace"]}
    assert len(caps[(4, 64, kv_bits)]) <= len(used)



def _static_card_server(kv_bits):
    import copy
    from repro_torch.core.manager import ProfileManager
    from repro_torch.launch.serve import profile_stats
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    cfg, params, engine = _smoke_server_parts()
    stats = profile_stats(cfg, engine.profiles, T.param_count(params))
    mgr = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                         budget_j=stats[0].energy_j * 12, low_energy=0.5)
    srv = AdaptiveServer(cfg, params, engine, ServingConfig(
        slots=64, max_batch=4, kv_bits=kv_bits, paged_backend="kernel"),
        manager=copy.deepcopy(mgr), device="cuda")
    return srv, mgr


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [8, 16])
def test_graphed_static_prefill_equals_eager_on_card(kv_bits):
    """The static path on graphs, prefill included (the card's default):
    two serves of the same groups equal the eager serve's tokens, traces
    and ledger from one manager state; the first captures each exact
    prefill key once, the second nothing, its prefill replays passing
    ``set_sync_debug_mode("error")``; K4 launches (kv8) equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import copy
    from repro_torch.analysis.tracker import (assert_static_executables,
                                              static_captures)
    from repro_torch.serving import graphs as G
    srv, mgr = _static_card_server(kv_bits)
    reqs = _graph_requests(srv.cfg, seed=59)
    runs = []
    fill = G.StaticGraphs.prefill_group
    for graphs, guard in ((False, False), (None, False), (None, True)):
        srv.manager = copy.deepcopy(mgr)
        n0 = QK.qkv_attention.launches
        G.StaticGraphs.prefill_group = _guarded(fill, guard)
        try:
            res = srv.serve(reqs, graphs=graphs)
        finally:
            G.StaticGraphs.prefill_group = fill
        torch.cuda.synchronize()
        runs.append((res, srv.manager.spent_j,
                     QK.qkv_attention.launches - n0, static_captures(srv)))
        if graphs is False:                    # the eager serve comes first
            assert not srv.static_graphs
    (eager, j_e, k4_e, _), (first, j_1, k4_1, caps), (second, j_2, k4_2,
                                                      caps2) = runs
    assert first == eager and second == eager and j_1 == j_2 == j_e
    assert k4_1 == k4_2 == k4_e and (k4_e > 0) == (kv_bits == 8)
    assert caps == caps2 and len(caps) == 1
    assert_static_executables(srv)
    (g, _), = srv.static_graphs.values()
    assert g.prefill.replays >= len(g.prefill.captured) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [8, 16])
def test_graphed_stepwise_equals_eager_on_card(kv_bits):
    """The stepwise oracle on graphs (the uniform prefill key, one step
    graph per profile id, the host reading the logits buffer) equals the
    eager loop: tokens, trace, ledger, K4 launches (kv8: ``n_layers`` ×
    steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import copy
    srv, mgr = _static_card_server(kv_bits)
    prompts = np.random.default_rng(kv_bits).integers(
        0, srv.cfg.vocab, (4, 9)).astype(np.int32)
    out = []
    for graphs in (False, None):
        srv.manager = copy.deepcopy(mgr)
        n0 = QK.qkv_attention.launches
        res = srv.generate_stepwise(prompts, 12, graphs=graphs)
        out.append((res, srv.manager.spent_j,
                    QK.qkv_attention.launches - n0))
    (eager, j_e, k4_e), (got, j_g, k4_g) = out
    assert got == eager and j_g == j_e
    assert k4_g == k4_e == (srv.cfg.n_layers * 11 if kv_bits == 8 else 0)
    (g, _), = srv.static_graphs.values()
    names = srv.engine.profile_names
    used = {names.index(p) for p in got["profile_trace"][1:]}
    assert sorted(g.steps.captured) == sorted(used)
    assert g.steps.replays == 11 - len(used)

_SYNCING_DRAFTER = r"""
import numpy as np, torch
from repro_torch.configs import get_smoke
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.profiles import paper_profiles
from repro_torch.models import transformer as T
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
cfg = get_smoke("granite-3-2b")
params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
names = T.quant_layer_names(cfg)
eng = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))

def drafter(hist, tok):
    k = int(tok.max())                    # a host read: synchronizes
    return torch.full((tok.shape[0], 2), k, dtype=torch.int32,
                      device=tok.device)

srv = AdaptiveServer(cfg, params, eng, ServingConfig(
    slots=64, max_batch=2, block_size=8, speculate=True, draft_k=2),
    device="cuda", draft_fn=drafter)
sched = ContinuousScheduler(srv, quantum=4)
assert sched.graphs is not None
sched.submit(Request(tokens=np.arange(5, dtype=np.int32), max_new=6))
try:
    sched.run()
except RuntimeError as e:
    print("capture raised:", str(e).splitlines()[0])
else:
    raise SystemExit("a synchronizing drafter was captured")
"""


@pytest.mark.cuda
def test_a_synchronizing_drafter_makes_the_capture_raise():
    """A drafter that reads a device value on the host cannot be captured:
    the window graph's capture raises, and nothing falls back to the eager
    segment. Run in a child process, whose CUDA stream the failed capture
    may leave unusable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _SYNCING_DRAFTER], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "capture raised" in out.stdout


# ---------------------------------------------------------------------------
# the admission waves replayed from CUDA graphs
# ---------------------------------------------------------------------------

def _wave_requests(cfg, seed, sys_len):
    """``_graph_requests``' lengths behind a system prompt of ``sys_len``
    tokens, from ``seed``."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, cfg.vocab, sys_len).astype(np.int32)
    return [Request(tokens=np.concatenate(
        [sys_p, rng.integers(0, cfg.vocab, n).astype(np.int32)]), max_new=m)
        for n, m in [(7, 9), (12, 5), (5, 13), (20, 6), (9, 11), (6, 4),
                     (15, 8)]]


def _wave_serve(scfg, graphs, native, sys_len):
    """The granite smoke model on the card (``native`` weight bits or the
    bf16 images) served by one scheduler in two passes of the same prompt
    lengths (the second from another seed, so wave keys recur) with
    ``graphs`` on or off. A replayed wave runs under
    ``set_sync_debug_mode("error")``. Returns the scheduler, the pool and
    the carries after every wave (the write sink cut off) and K3's
    launches."""
    import dataclasses
    from repro_torch.models.native import to_native
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    cfg, params, engine = _smoke_server_parts()
    if native is not None:
        params = to_native(params, native)
    srv = AdaptiveServer(cfg, params, engine, ServingConfig(
        slots=64, max_batch=4, block_size=8, paged_backend="kernel",
        **scfg), device="cuda")
    sched = ContinuousScheduler(srv, quantum=4, graphs=graphs)
    seen = []
    wave = sched._wave

    def watched(kind, pid, plan, pre=(), pp=0):
        w = sched.waves
        replay = w is not None and w.key(kind, pid, plan, pp) in w._graphs
        torch.cuda.set_sync_debug_mode("error" if replay else 0)
        try:
            out = wave(kind, pid, plan, pre, pp)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        state = {"tok": sched._tok.cpu(), "pos": sched._pos.cpu(),
                 "tok0": out[0].cpu()}
        for key, c in sched._caches.items():
            for f in dataclasses.fields(c):
                x = getattr(c, f.name)
                if isinstance(x, torch.Tensor):
                    if f.name in ("k", "v", "token_idx") and key == "kv" \
                            and sched.paged:
                        x = x[:, :c.n_blocks]
                    state[f"{key}.{f.name}"] = x.cpu()
        seen.append((kind, replay, state))
        return out

    sched._wave = watched
    k3 = QM.qmatmul.launches
    for seed in (51, 52):
        for r in _wave_requests(cfg, seed, sys_len):
            sched.submit(r)
        sched.run()
    torch.cuda.synchronize()
    del sched._wave                # no cycle keeps the graphs alive
    return sched, seen, QM.qmatmul.launches - k3


WAVE_CASES = {"kv16": (dict(kv_bits=16), None, 0),
              "native-w8": (dict(kv_bits=16), 8, 0),
              "kv16-chunked-prefix": (dict(kv_bits=16, prefill_chunk=8),
                                      None, 16),
              "kv8-chunked-prefix": (dict(kv_bits=8, prefill_chunk=8), None,
                                     16)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WAVE_CASES))
def test_graphed_waves_equal_eager_on_card(case):
    """Wave graphs on the card: over two passes, every wave of the
    graphed scheduler leaves the pool (its blocks but the write sink, its
    tables, scales and carries) and first tokens bitwise those of the
    eager waves, replays the keys of the first pass under
    ``set_sync_debug_mode("error")``, and captures each key once; K3's
    launches (native W8: 4 per layer per wave and per decode step) are
    equal on both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    scfg, native, sys_len = WAVE_CASES[case]
    runs = {g: _wave_serve(scfg, g, native, sys_len) for g in (False, None)}
    (eager, e_seen, k3_e), (graphed, g_seen, k3_g) = runs[False], runs[None]
    assert eager.waves is None and graphed.waves is not None
    assert [k for k, _, _ in e_seen] == [k for k, _, _ in g_seen]
    for i, ((_, _, a), (_, _, b)) in enumerate(zip(e_seen, g_seen)):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key].contiguous().view(torch.uint8),
                               b[key].contiguous().view(torch.uint8)), \
                (i, key)
    for rid in eager.results:
        assert graphed.results[rid] == eager.results[rid]
    assert graphed.events == eager.events
    w = graphed.waves
    assert sorted(w.captured) == sorted(w.used)
    assert len(set(w.captured)) == len(w.captured)
    assert w.replays == sum(r for _, r, _ in g_seen) > 0
    assert k3_g == k3_e
    n_layers = graphed.srv.cfg.n_layers
    assert k3_g == (4 * n_layers * (graphed.decode_steps + len(g_seen))
                    if native else 0)
    if sys_len:
        assert graphed.registry.hits > 0 and graphed.chunk_waves > 0


@pytest.mark.cuda
def test_the_collector_is_held_off_during_a_capture():
    """``cuda_capture`` disables Python's garbage collector while it
    captures (a collected cycle holding another graph would release its
    memory into the capture and invalidate it) and restores it after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import gc
    from repro_torch.serving import graphs as G
    x = torch.arange(8.0, device="cuda")
    y = torch.zeros_like(x)
    seen = []
    stream = torch.cuda.Stream()

    def step():
        seen.append(gc.isenabled())
        y.copy_(x * 2)

    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()
    torch.cuda.current_stream().wait_stream(stream)
    assert gc.isenabled()
    replay = G.cuda_capture(step, stream, torch.cuda.graph_pool_handle())
    assert seen == [True, False] and gc.isenabled()
    x.add_(1)
    replay()
    torch.cuda.synchronize()
    assert y.tolist() == [2.0 * (i + 1) for i in range(8)]
