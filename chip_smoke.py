"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

  python3 chip_smoke.py            # all phases (needs one CUDA GPU)
  python3 chip_smoke.py --phases 1,2

Phases:
 1. environment: versions, the card, and the build of every kernel (one
    nvcc per source, sm_90a, all started together);
 2. each kernel against its plain PyTorch version on the card, at the
    shapes the serving path gives it, with times, the bound and the
    library yardstick: K1 (one-query paged decode; bs 16, 24 and 128,
    n_lblk up to 256, a row whose keys lie in the last split, window 5)
    and K2 (the W-query speculative verify window; W·Hg 20, 68 and 80),
    each also bitwise equal across two calls and timed on the device
    through a CUDA graph, then both for grids of 2, 4 and 8 blocks per SM; K3 (the dequant-matmul of the native
    integer-weight linears: decode's split-K kernel at M 1, 8 and 16 and
    its edges; prefill's wgmma kernel at M 17–4096, ragged K and N, beside
    the mma.sync kernel it replaced on those shapes (step 0) and that still
    takes f32 x and strides TMA cannot describe (N 70, N 3080); each line
    names its route; two calls bitwise equal, the fused requant bit for
    bit, device time from a CUDA graph with cold weights beside
    torch.matmul's, K3's device time per decode step and per prefill wave,
    then decode for grids of at most 2, 3 and 4 blocks per SM and prefill
    with 128-row and 256-row tiles), K4 (decode attention over the
    contiguous int8 cache: the split-context kernel beside step 0, the
    first port's one-block-per-group kernel, and SDPA on the
    pre-dequantized cache, device times from CUDA graphs over cold cache
    copies at phase 2's shape, the static serve's own lengths, S 4096 and
    every length 1; ragged S, Hg 1 and 16, D 128 and 256 at f32 and bf16
    q, a last split holding one column; two calls bitwise equal; then
    grids of 2, 4 and 8 blocks per SM) and K5 (per-tensor dynamic
    fake-quant, bit for bit);
 3. path parity at full width (granite-3-2b widths, 4 layers, f32, TF32
    off): the same requests through the continuous scheduler with the
    kernel and the gather backends give identical greedy tokens at kv16,
    kv8 and kv4, and the speculative scheduler gives those same tokens
    with either backend at kv16 and kv8; static ``serve`` at kv8 gives the
    same tokens through K4 as through the reference's einsum (a flip only
    at a top-2 logit margin under 1e-3); then the native path in bf16 at
    W8 and W4: prefill logits on the card (K3, K5) against the CPU's;
 4. serve: the launcher's path on granite-3-2b's full 40-layer config in
    bf16 — 12 requests, 32 new tokens each — counting kernel launches
    (and K5's, which builds the weight images); then 4 requests × 16
    tokens with ``--block-size 128``, K1 launches = 40 × steps;
 5. speculative serve: phase 4's requests through the launcher's
    ``--speculate --draft-k 4`` path, counting K2 launches per window and
    checking that the tokens billed are the tokens delivered; then
    ``--draft-k 16`` (W·Hg 68) on 4 requests × 16 tokens in f32, K2
    launches = 40 × windows and the tokens equal greedy's;
 6. native serve: phase 4's requests served from ``to_native(params, 8)``
    (then 4 requests × 16 tokens at W4) through ``AdaptiveServer`` +
    ``ContinuousScheduler``, counting K3 launches per linear, K1 per step
    and K5 per tied-head image, and checking that the dequantize-then-matmul
    branch never runs;
 7. the contiguous int8 cache on the full config in bf16: phase 4's
    requests through the launcher's static path (no ``--continuous``,
    ``--kv-bits 8``) and its contiguous pool (``--continuous --no-paged-kv
    --kv-bits 8``), counting K4 launches per layer per decode step, with
    K1 and the kv8 einsum never.
The last lines are the card, the kernel table (JSON) and the result (JSON).
Any failed check raises, so the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12          # bf16 dense tensor cores
ATOL = 1e-4                       # kernel vs plain, f32 outputs


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def paged_inputs(gen, *, bits, w=None, B=8, Hkv=8, Hg=4, D=64, bs=16,
                 n_lblk=64, dev="cuda"):
    """Fragmented, out-of-order block tables with both unmapped sentinels
    (−1 and ≥ n_blocks), a hole inside a row, stale token indices past
    ``pos``, ragged positions and one dead row. ``w`` gives K2's inputs: a
    window of ``w`` queries at ``pos .. pos + w − 1`` per row (row 0's
    runs past capacity) and per-query ladders."""
    nw = 1 if w is None else w
    cap = n_lblk * bs
    n_blocks = B * n_lblk + n_lblk // 2
    perm = torch.randperm(n_blocks, generator=gen, device=dev).tolist()
    pos = torch.randint(1, cap - 1, (B,), generator=gen, device=dev)
    pos[0] = cap - 2                               # one row near full context
    pos_h = pos.tolist()
    bt = torch.full((B, n_lblk), n_blocks, dtype=torch.int32)
    tidx = torch.full((n_blocks, bs), -1, dtype=torch.int32)
    for b in range(B):
        if b == B - 1:                             # the dead row: all unmapped
            bt[b] = torch.where(torch.arange(n_lblk) % 2 == 0, -1, n_blocks + 3)
            continue
        need = min(n_lblk, (pos_h[b] + nw - 1) // bs + 1)
        for lb in range(n_lblk):
            if lb < need and not (b == 1 and lb == need // 2):
                phys = perm.pop()
                bt[b, lb] = phys
                t = lb * bs + torch.arange(bs)
                # slots past pos hold stale larger indices, must be masked
                tidx[phys] = torch.where(t <= pos_h[b] + nw + 2, t, -1).int()
            else:
                bt[b, lb] = -1 if lb % 3 == 0 else n_blocks + lb
    dk = D // 2 if bits == 4 else D
    shape = (n_blocks, bs, Hkv, dk)
    if bits == 16:
        k = torch.randn(shape, generator=gen, device=dev).bfloat16()
        v = torch.randn(shape, generator=gen, device=dev).bfloat16()
        ks = vs = torch.ones((B, Hkv), device=dev)
    elif bits == 8:                                # amax/127 grid, as written
        k = (torch.randn(shape, generator=gen, device=dev) * 40).round()
        v = (torch.randn(shape, generator=gen, device=dev) * 40).round()
        k, v = k.clamp(-127, 127).to(torch.int8), v.clamp(-127, 127).to(torch.int8)
    else:                                          # kv4: any byte is 2 nibbles
        k = torch.randint(-128, 128, shape, generator=gen, device=dev).to(torch.int8)
        v = torch.randint(-128, 128, shape, generator=gen, device=dev).to(torch.int8)
    if bits != 16:
        ks = 0.005 + 0.02 * torch.rand((B, Hkv), generator=gen, device=dev)
        vs = 0.005 + 0.02 * torch.rand((B, Hkv), generator=gen, device=dev)
    if w is not None:
        q = torch.randn((B, w, Hkv, Hg, D), generator=gen, device=dev).bfloat16()
        if bits == 16:
            ks = vs = torch.ones((B, w, Hkv), device=dev)
        else:               # ladders: non-decreasing along the window
            ks = ks[:, None] * (1 + 0.1 * torch.rand(
                (B, w, Hkv), generator=gen, device=dev)).cummax(1).values
            vs = vs[:, None] * (1 + 0.1 * torch.rand(
                (B, w, Hkv), generator=gen, device=dev)).cummax(1).values
        return dict(q=q, k_pool=k, v_pool=v, k_ladder=ks.float().contiguous(),
                    v_ladder=vs.float().contiguous(), token_idx=tidx.to(dev),
                    block_table=bt.to(dev), pos=pos.int())
    q = torch.randn((B, Hkv, Hg, D), generator=gen, device=dev).bfloat16()
    return dict(q=q, k_pool=k, v_pool=v, k_scale=ks.float().contiguous(),
                v_scale=vs.float().contiguous(), token_idx=tidx.to(dev),
                block_table=bt.to(dev), pos=pos.int())


def ops_ms(qk_flops, pv_flops, tensor_cores) -> float:
    """Least time for the operations: q·K at the bf16 tensor-core rate
    where the kernel runs it there (bf16 q at kv16/kv8, D % 16 == 0), else
    at the f32 rate; P·V at the f32 rate (it runs on the CUDA cores). The
    two units can run at once, so the larger of the two times."""
    qk_rate = H100_BF16_FLOPS if tensor_cores else H100_F32_FLOPS
    return max(qk_flops / qk_rate, pv_flops / H100_F32_FLOPS) * 1e3


def on_tensor_cores(q, bits) -> bool:
    return q.dtype == torch.bfloat16 and bits != 4 and q.shape[-1] % 16 == 0


def paged_bound(x, bits) -> dict:
    """Least time for this call on an H100 SXM: the bytes it must move
    (attended keys' K and V, mapped blocks' token indices, q, scales,
    table, positions, output) over HBM bandwidth, and its operations
    (:func:`ops_ms`)."""
    q, bt, tidx, pos = x["q"], x["block_table"], x["token_idx"], x["pos"]
    B, Hkv, Hg, D = q.shape
    n_blocks, bs = tidx.shape
    ok = (bt >= 0) & (bt < n_blocks)
    t = tidx[torch.where(ok, bt, 0).long()]                   # [B, n_lblk, bs]
    keep = ok[..., None] & (t >= 0) & (t <= pos[:, None, None])
    n_keys = int(keep.sum())
    elt = 2 if bits == 16 else 1
    dk = D // 2 if bits == 4 else D
    nbytes = (2 * n_keys * Hkv * dk * elt + int(ok.sum()) * bs * 4
              + q.numel() * q.element_size() + B * Hkv * Hg * D * 4
              + 2 * B * Hkv * 4 + bt.numel() * 4 + B * 4)
    flops = 4 * n_keys * Hkv * Hg * D
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops_ms(flops / 2, flops / 2, on_tensor_cores(q, bits))
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "keys": n_keys}


def sdpa_fn(x):
    """One ``scaled_dot_product_attention`` call on a dense view gathered
    beforehand (kv16 only; the gather is not timed), as a callable."""
    import torch.nn.functional as F
    q, bt, tidx, pos = x["q"], x["block_table"], x["token_idx"], x["pos"]
    B, Hkv, Hg, D = q.shape
    n_blocks, bs = tidx.shape
    ok = (bt >= 0) & (bt < n_blocks)
    idx = torch.where(ok, bt, 0).long()
    k = torch.where(ok[..., None, None, None], x["k_pool"][idx], 0)
    v = torch.where(ok[..., None, None, None], x["v_pool"][idx], 0)
    S = idx.shape[1] * bs
    k = k.reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    v = v.reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    t = torch.where(ok[..., None], tidx[idx], -1).reshape(B, S)
    mask = ((t >= 0) & (t <= pos[:, None]))[:, None, None, :]
    qq = q.reshape(B, Hkv * Hg, 1, D)
    try:
        F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                       enable_gqa=True)
        fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, k, v, attn_mask=mask, enable_gqa=True)
    except TypeError:                 # torch without enable_gqa
        k2 = k.repeat_interleave(Hg, dim=1)
        v2 = v.repeat_interleave(Hg, dim=1)
        fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, k2, v2, attn_mask=mask)
    return fn


def window_keep(x, window=0):
    """``[B, W, S]`` attendable columns of K2's dense view, with the
    kernel's full-attention sentinel, and the gather indices."""
    q, bt, tidx, pos = x["q"], x["block_table"], x["token_idx"], x["pos"]
    B, W = q.shape[:2]
    n_blocks, bs = tidx.shape
    n_lblk = bt.shape[1]
    ok = (bt >= 0) & (bt < n_blocks)
    idx = torch.where(ok, bt, 0).long()
    t = torch.where(ok[..., None], tidx[idx], -1).reshape(B, 1, -1).long()
    qp = pos.long()[:, None, None] + torch.arange(W, device=q.device)[None, :, None]
    win = window if window > 0 else n_lblk * bs + W
    return (t >= 0) & (t <= qp) & (qp - t < win), ok, idx


def window_bound(x, bits) -> dict:
    """Least time for one K2 call on an H100 SXM: the bytes it must move
    (K and V of the columns the window's last query attends, mapped
    blocks' token indices, q, ladders, table, positions, the f32 output)
    over HBM bandwidth, and the operations each query's attended keys need
    (4·Hkv·Hg·D per key, half q·K and half P·V; :func:`ops_ms`)."""
    q, bt = x["q"], x["block_table"]
    B, W, Hkv, Hg, D = q.shape
    keep, ok, _ = window_keep(x)
    n_keys = int(keep[:, -1].sum())               # the last query's columns
    q_keys = int(keep.sum())                      # summed over the W queries
    elt = 2 if bits == 16 else 1
    bs = x["token_idx"].shape[1]
    nbytes = (2 * n_keys * Hkv * D * elt + int(ok.sum()) * bs * 4
              + q.numel() * q.element_size() + B * W * Hkv * Hg * D * 4
              + 2 * B * W * Hkv * 4 + bt.numel() * 4 + B * 4)
    flops = 4 * q_keys * Hkv * Hg * D
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops_ms(flops / 2, flops / 2, on_tensor_cores(q, bits))
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "keys": n_keys}


def window_sdpa_fn(x):
    """One ``scaled_dot_product_attention`` call on K2's dense view (kv16;
    the gather is not timed), with the per-query causal mask
    ``[B, 1, W, S]`` and ``enable_gqa``, as a callable."""
    import torch.nn.functional as F
    q = x["q"]
    B, W, Hkv, Hg, D = q.shape
    keep, ok, idx = window_keep(x)
    S = keep.shape[-1]
    k = torch.where(ok[..., None, None, None], x["k_pool"][idx], 0)
    v = torch.where(ok[..., None, None, None], x["v_pool"][idx], 0)
    k = k.reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    v = v.reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    qq = q.reshape(B, W, Hkv * Hg, D).transpose(1, 2).contiguous()
    mask = keep[:, None]
    return lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, enable_gqa=True)


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time per call: CUDA events around the replays of a CUDA graph
    that holds ``n`` calls of ``fn`` (back-to-back eager calls of a kernel
    this short time the host's issue rate, not the kernel). The inputs
    stay in L2 between calls, as for :func:`cuda_time_ms`."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / (reps * n)


def library_times(make_fn):
    """(per-call ms, device ms) of one library call; the device time is
    ``None`` where the call cannot be captured in a CUDA graph."""
    fn = make_fn()
    per_call = cuda_time_ms(fn)
    try:
        dev = graph_ms(fn)
    except RuntimeError as e:             # capture refused: report, go on
        print(f"[lib] CUDA-graph capture failed ({str(e)[:80]}); device "
              f"time not measured")
        torch.cuda.synchronize()
        dev = None
    return per_call, dev


def last_split_only(x):
    """Row 1 keeps only the last 4 logical blocks of row 0 (shared
    physical blocks, row 0's position): every split but the last has no
    valid key for it."""
    bt, pos = x["block_table"].clone(), x["pos"].clone()
    bt[1] = -1
    bt[1, -4:] = bt[0, -4:]
    pos[1] = pos[0]
    return dict(x, block_table=bt, pos=pos)


def plan_of(PA, x, w=1) -> tuple:
    """(splits, tiles per split, row tiles, rows per tile) of a call."""
    q = x["q"]
    b, hkv, hg, d = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
    rt, rows = PA.row_plan(w, hg, d)
    n_cols = x["block_table"].shape[1] * x["token_idx"].shape[1]
    return (*PA.split_plan(b, hkv, rt, n_cols), rt, rows)


def check_case(tag, fn, ref, x, kw, label) -> float:
    """Kernel against its plain version: max abs error within ATOL, the
    dead row exactly zero, two calls bitwise equal. Returns the error."""
    got = fn(**x, **kw)
    torch.cuda.synchronize()
    want = ref(**x, **kw)
    again = fn(**x, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    dead = float(got[-1].abs().max())
    same = torch.equal(got, again)
    print(f"[{tag}] {label}: max_abs_err={err:.3e} (tol {ATOL:g}), dead row "
          f"max |out|={dead}, two calls bitwise equal: {same}")
    if not err <= ATOL or dead != 0.0 or not same:
        raise AssertionError(f"{tag} disagrees with its plain version at "
                             f"{label}")
    return err


def phase_window_kernel(seed: int) -> dict:
    """K2 against its plain version: the speculative serve shape (B=8, W=5,
    Hkv=8, Hg=4, D=64, bs=16) at n_lblk 64 and 256; W·Hg 68 (Hg 4,
    draft_k 16) and 80 (Hkv 2, Hg 16, D 128, W 5) at n_lblk 64; each at
    kv16 and kv8, timed. Untimed at n_lblk 256: a row whose keys all lie
    in the last split, and window 5 (every split but the last empty)."""
    from repro_torch.kernels import paged_attention as PA
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    fn, ref = PA.paged_attention_multi, PA.paged_attention_multi_ref
    cases = [(dict(w=5, n_lblk=n), f"n_lblk={n}") for n in (64, 256)]
    cases += [(dict(w=17, n_lblk=64), "W·Hg=68 (W 17, Hg 4), n_lblk=64"),
              (dict(w=5, n_lblk=64, Hkv=2, Hg=16, D=128),
               "W·Hg=80 (W 5, Hkv 2, Hg 16, D 128), n_lblk=64")]
    main = None
    for shape, label in cases:
        for bits in (16, 8):
            x = paged_inputs(gen, bits=bits, **shape)
            kw = dict(bits=bits, window=0)
            lab = f"{label} kv{bits}"
            err = check_case("K2", fn, ref, x, kw, lab)
            splits, per, rt, rows = plan_of(PA, x, shape["w"])
            ms = cuda_time_ms(lambda: fn(**x, **kw))
            dev = graph_ms(lambda: fn(**x, **kw))
            plain = cuda_time_ms(lambda: ref(**x, **kw), iters=50)
            lib = lib_dev = None
            if bits == 16:
                lib, lib_dev = library_times(lambda: window_sdpa_fn(x))
            bd = window_bound(x, bits)
            print(f"[K2] {lab}: {splits} splits x {per} tiles, {rt} row "
                  f"tile(s) of {rows}; device {dev:.4f} ms, per call "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa "
                  f"{_ms(lib)} (device {_ms(lib_dev)}), bound "
                  f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
                  f"{bd['bytes']} B, {bd['flops']} flop, {bd['keys']} keys)")
            if main is None:
                main = {"max_abs_err": err, "ms": ms, "device_ms": dev,
                        "plain_ms": plain, "library_ms": lib,
                        "library_device_ms": lib_dev, "splits": splits, **bd}
    for bits in (16, 8):
        x = paged_inputs(gen, bits=bits, w=5, n_lblk=256)
        check_case("K2", fn, ref, last_split_only(x), dict(bits=bits),
                   f"n_lblk=256 kv{bits}, row 1's keys in the last split only")
        check_case("K2", fn, ref, x, dict(bits=bits, window=5),
                   f"n_lblk=256 kv{bits}, window 5")
    PA.paged_attention_multi.launches = 0  # comparison launches do not count
    return main


def split_sweep(seed: int) -> None:
    """K1 and K2 device times at phase 2's shapes for grids of 2, 4 and 8
    blocks per SM (``BLOCKS_PER_SM``, the planner's one tuning knob), and
    K1's fixed cost per call (the launches, each split's table reads, the
    merge) on a table whose rows are 40 tokens long."""
    from repro_torch.kernels import paged_attention as PA
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    keep = PA.BLOCKS_PER_SM
    for n_lblk in (64, 256):
        for w, bits in ((None, 16), (None, 8), (5, 16), (5, 8)):
            x = paged_inputs(gen, bits=bits, w=w, n_lblk=n_lblk)
            fn = PA.paged_attention if w is None else PA.paged_attention_multi
            line = []
            for per_sm in (2, 4, 8):
                PA.BLOCKS_PER_SM = per_sm
                splits, per, _, _ = plan_of(PA, x, w or 1)
                dev = graph_ms(lambda: fn(**x, bits=bits))
                line.append(f"{per_sm}/SM: {splits}x{per} {dev:.4f} ms")
            PA.BLOCKS_PER_SM = keep
            print(f"[sweep] {'K1' if w is None else 'K2'} n_lblk={n_lblk} "
                  f"kv{bits}: " + "; ".join(line))
        # the fixed cost of a call: every row 40 tokens long, so all but
        # one column tile of each row is skipped
        x = paged_inputs(gen, bits=16, n_lblk=n_lblk)
        x["pos"] = torch.full_like(x["pos"], 40)
        dev = graph_ms(lambda: PA.paged_attention(**x, bits=16))
        print(f"[sweep] K1 n_lblk={n_lblk} kv16, every row 40 tokens: "
              f"device {dev:.4f} ms")
    PA.paged_attention.launches = PA.paged_attention_multi.launches = 0


def _ms(t) -> str:
    return "n/a" if t is None else f"{t:.4f} ms"


def phase_kernels(seed: int) -> list[dict]:
    """K1 against its plain version: B=8, Hkv=8, Hg=4, D=64 at bs 16 with
    n_lblk 64 (phase 4's table) and 256 (``ServingConfig.slots=4096``),
    kv16/kv8/kv4; bs 24 (n_lblk 43) and 128 (n_lblk 8) at kv16 and kv8;
    all timed. Untimed at n_lblk 256: a row whose keys all lie in the last
    split, and window 5."""
    from repro_torch.kernels import paged_attention as PA
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fn, ref = PA.paged_attention, PA.paged_attention_ref
    cases = [(dict(n_lblk=n), bits, f"n_lblk={n}") for n in (64, 256)
             for bits in (16, 8, 4)]
    cases += [(dict(bs=bs, n_lblk=n), bits, f"bs={bs} n_lblk={n}")
              for bs, n in ((24, 43), (128, 8)) for bits in (16, 8)]
    rows, main = [], None
    for shape, bits, label in cases:
        x = paged_inputs(gen, bits=bits, **shape)
        kw = dict(bits=bits, window=0)
        lab = f"{label} kv{bits}"
        err = check_case("K1", fn, ref, x, kw, lab)
        splits, per, rt, nrow = plan_of(PA, x)
        ms = cuda_time_ms(lambda: fn(**x, **kw))
        dev = graph_ms(lambda: fn(**x, **kw))
        plain = cuda_time_ms(lambda: ref(**x, **kw), iters=50)
        lib = lib_dev = None
        if bits == 16:
            lib, lib_dev = library_times(lambda: sdpa_fn(x))
        bd = paged_bound(x, bits)
        row = {"label": lab, "max_abs_err": err, "ms": ms, "device_ms": dev,
               "plain_ms": plain, "library_ms": lib,
               "library_device_ms": lib_dev, "splits": splits, **bd}
        print(f"[K1] {lab}: {splits} splits x {per} tiles, {rt} row tile(s) "
              f"of {nrow}; device {dev:.4f} ms, per call {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {_ms(lib)} (device {_ms(lib_dev)}), "
              f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
              f"{bd['bytes']} B, {bd['flops']} flop, {bd['keys']} keys)")
        rows.append(row)
        if main is None:
            main = row
    for bits in (16, 8, 4):
        x = paged_inputs(gen, bits=bits, n_lblk=256)
        check_case("K1", fn, ref, last_split_only(x), dict(bits=bits),
                   f"n_lblk=256 kv{bits}, row 1's keys in the last split only")
        check_case("K1", fn, ref, x, dict(bits=bits, window=5),
                   f"n_lblk=256 kv{bits}, window 5")
    PA.paged_attention.launches = 0       # comparison launches do not count
    return rows, main


# ---------------------------------------------------------------------------
# phase 2: K3 (dequant-matmul) and K5 (per-tensor fake-quant)
# ---------------------------------------------------------------------------

def rotating(make, nbytes: int, budget: int = 256 << 20, cap: int = 64):
    """Copies of an operand that together exceed the 50 MB L2 cache, so a
    timed loop that cycles through them reads each one cold, as a layer's
    weights are on the serving path (40 layers of them between reuses)."""
    n = max(1, min(cap, -(-budget // max(1, nbytes))))
    return [make() for _ in range(n)]


def cycle_time_ms(fn, operands, iters: int) -> float:
    it = itertools.cycle(operands)
    return cuda_time_ms(lambda: fn(next(it)), iters=iters,
                        warmup=min(20, iters))


def cycle_graph_ms(fn, operands, n: int = 20) -> float:
    """Device time per call from a CUDA graph of at least ``n`` calls, each
    reading the next of ``operands`` (copies from :func:`rotating`), so
    every call finds its operand cold in L2 as the serving path does."""
    it = itertools.cycle(operands)
    return graph_ms(lambda: fn(next(it)), n=max(n, len(operands)))


def qmatmul_bound(m, k, n, bits) -> dict:
    """Least time for one K3 call on an H100 SXM: the bytes it must move
    (packed weights, bf16 x, f32 out, f32 scales) over HBM bandwidth, and
    2·M·K·N over the bf16 dense tensor-core rate."""
    nbytes = k * n * bits // 8 + m * k * 2 + m * n * 4 + n * 4
    flops = 2 * m * k * n
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


GRANITE_LINEARS = ((2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048))


def phase_qmatmul(seed: int) -> dict:
    """K3 against its plain version on the card: decode (M = 8) and prefill
    (M = 2048, and 4096 at W8) at granite-3-2b's four linear shapes, int8
    and packed int4, bf16 x as the serving path gives it; decode's edges (M
    1 and 16, K 96, K 8256, N 70 at W8 whose rows are not 16-byte aligned);
    prefill's edges (M 17, 100 and 128; a ragged K 2056; ragged N 3104,
    which the wgmma kernel masks, and 3080 and 70, whose rows TMA cannot
    describe, so the mma.sync kernel takes them; an f32 x, which the
    mma.sync kernel takes too); the odd shapes of the reference's kernel
    tests; the fused requant. Each line names the route the call took.

    Tolerance: both sides multiply the same bf16 operands, whose products
    are exact in f32, and differ only in the order of the f32 sums. Each
    side is within gamma_K·(|x|@|w|) of the exact sum (gamma_K ≈ K·2^-24),
    so |kernel − plain| <= 4·K·2^-24·(|x|@|w|) elementwise leaves a factor
    2 for the tensor cores' accumulation; each line prints the worst
    element's share of it. Two calls are bitwise equal. The fused requant
    is checked bit for bit against the plain requant of the kernel's own
    sums (the kernel's sum order is deterministic), and within one grid
    step of the plain version's.

    Times: "device" from CUDA events around a CUDA graph of at least 20
    calls, each reading its own cold copy of the weights; "per call" from
    events around eager calls (the host's issue rate through ctypes as much
    as the kernel); torch.matmul on the bf16 weight image, the same two
    ways. Step 0: the mma.sync prefill kernel, given (by setting the
    wrapper's rule aside) the bf16 granite cases the rule sends to wgmma,
    timed on the device the same way."""
    from repro_torch.core.qtypes import QuantSpec
    from repro_torch.core.quantizers import quantize_native
    from repro_torch.kernels import qmatmul as QM
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    u = 2.0 ** -24
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(m, k, n, bits, bf16) for m in (8, 2048)
             for k, n in GRANITE_LINEARS for bits in (8, 4)]
    cases += [(4096, k, n, 8, bf16) for k, n in GRANITE_LINEARS]
    cases += [(m, 2048, 3072, 8, bf16) for m in (1, 16, 17, 100, 128)]
    cases += [(8, k, 2048, bits, bf16) for k in (96, 8256) for bits in (8, 4)]
    cases += [(8, 2048, 70, 8, bf16), (2048, 2048, 70, 8, bf16)]
    cases += [(2048, 2056, 3072, bits, bf16) for bits in (8, 4)]
    cases += [(2048, 2048, n, bits, bf16) for n in (3104, 3080)
              for bits in (8, 4)]
    cases += [(2048, 2048, 3072, 8, f32)]
    cases += [(m, k, n, bits, bf16) for m, k, n in ((5, 100, 70), (33, 96, 40))
              for bits in (8, 4)]
    fused_at = {(2048, 2048, 2048, 8), (4096, 2048, 2048, 8)}
    main, main_prefill, decode, prefill = None, None, [], {}
    for m, k, n, bits, xdtype in cases:
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        spec = QuantSpec(bits=bits, per_channel=True, channel_axis=-1,
                         po2_scale=False)
        qt = quantize_native(w, spec)
        scale = qt.scale.reshape(-1).contiguous()
        x = torch.randn((m, k), generator=gen, device="cuda").to(xdtype)
        label = f"M={m} K={k} N={n} W{bits}" + (" f32 x" if xdtype == f32
                                                 else "")
        got = QM.qmatmul(x, qt.data, scale, bits=bits)
        route = QM.qmatmul.last_route
        if (m > 16 and (k, n) in GRANITE_LINEARS and xdtype == bf16
                and route != "wgmma"):
            raise AssertionError(f"K3 at the main path's {label} took "
                                 f"{route}, not the wgmma kernel")
        again = QM.qmatmul(x, qt.data, scale, bits=bits)
        torch.cuda.synchronize()
        want = QM.qmatmul_ref(x, qt.data, scale, bits)
        wb = QM.dequant_ref(qt.data, scale, bits).bfloat16().float()
        tol = 4 * k * u * (x.bfloat16().float().abs() @ wb.abs())
        diff = (got - want).abs()
        err = float(diff.max())
        worst = float((diff / tol.clamp_min(1e-30)).max())
        same = torch.equal(got, again)
        if not bool((diff <= tol).all()) or not same:
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"{label} ({route}): max err {err:.3e}, "
                                 f"{worst:.2f}x the tolerance; two calls "
                                 f"equal: {same}")
        big = m * k * n > 1e9
        ws = rotating(lambda: qt.data.clone(), qt.data.numel())
        kern = lambda wq: QM.qmatmul(x, wq, scale, bits=bits)  # noqa: E731
        ms = cycle_time_ms(kern, ws, 50 if big else 200)
        dev = cycle_graph_ms(kern, ws)
        step0 = None
        if route == "wgmma" and (k, n) in GRANITE_LINEARS and bits == 8:
            rule = QM.route_of          # the mma.sync kernel takes any call
            QM.route_of = lambda *a: "mma_sync"  # noqa: E731
            step0 = cycle_graph_ms(kern, ws)
            QM.route_of = rule
        plain = cycle_time_ms(lambda wq: QM.qmatmul_ref(x, wq, scale, bits),
                              ws[:4], 10 if big else 50)
        del ws
        x16 = x.bfloat16()
        wl = rotating(lambda: wb.bfloat16(), wb.numel() * 2)
        lib = cycle_time_ms(lambda w16: torch.matmul(x16, w16), wl,
                            50 if big else 200)
        lib_dev = cycle_graph_ms(lambda w16: torch.matmul(x16, w16), wl)
        del wl
        bd = qmatmul_bound(m, k, n, bits)
        if route == "splitk":
            cols, splits, per = QM.split_plan(m, k, n, bits)
            plan = (f"{-(-n // cols)} column tiles x {splits} splits of "
                    f"{per} rows")
        elif route == "wgmma":
            rows, cols, splits = QM.prefill_rows(m), QM.WGMMA_COLS, 1
            plan = (f"{-(-m // rows)} x {-(-n // cols)} tiles of {rows} x "
                    f"{cols}")
        else:
            splits = 1
            plan = f"{-(-m // 64)} x {-(-n // 128)} tiles of 64 x 128"
        old = "" if step0 is None else (
            f"; step 0 (mma.sync) device {step0:.4f} ms, "
            f"{step0 / dev:.2f}x the new kernel")
        print(f"[K3] {label}: route {route} ({plan}); max_abs_err={err:.3e} "
              f"({worst:.3f}x tol), two calls bitwise equal; device "
              f"{dev:.4f} ms, per call {ms:.4f} ms, plain {plain:.4f} ms, "
              f"torch.matmul bf16 device {lib_dev:.4f} / per call "
              f"{lib:.4f} ms ({dev / lib_dev:.2f}x), bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
              f"{bd['bound_ms'] / dev:.3f} of it); "
              f"{bd['flops'] / dev / 1e9:.1f} TFLOP/s, "
              f"{bd['bytes'] / dev / 1e6:.1f} GB/s on the device{old}")
        row = {"max_abs_err": err, "ms": ms, "device_ms": dev,
               "plain_ms": plain, "library_ms": lib,
               "library_device_ms": lib_dev, "splits": splits, **bd}
        if m <= 16 and (k, n) in GRANITE_LINEARS:
            decode.append((label, dev))
        if step0 is not None:
            prefill[(m, k, n)] = (dev, step0, lib_dev)
        if (m, k, n, bits) == (8, 2048, 16384, 8):
            main = row
        if (m, k, n, bits) == (2048, 2048, 16384, 8):
            main_prefill = row
        if m <= 16 and bits == 8 or (m, k, n, bits) in fused_at:
            for ob, os_ in ((8, 0.25), (4, 0.5)):
                fused = QM.qmatmul(x, qt.data, scale, bits=bits, out_bits=ob,
                                   out_scale=os_)
                same = torch.equal(fused, QM.requant_ref(got, os_, ob))
                plain_rq = QM.qmatmul_ref(x, qt.data, scale, bits,
                                          out_scale=os_, out_bits=ob)
                step = float((fused - plain_rq).abs().max())
                flips = float((fused != plain_rq).float().mean())
                print(f"[K3] {label} fused requant A{ob} s={os_} "
                      f"({QM.qmatmul.last_route}): equal to the plain "
                      f"requant of the kernel's sums: {same}; vs plain "
                      f"version max err {step:g} ({100 * flips:.4f}% of "
                      f"elements one step apart)")
                if not same or step > os_:
                    raise AssertionError("K3's fused requant disagrees")
    per_step = sum(dev for lab, dev in decode if lab.startswith("M=8 ")
                   and lab.endswith("W8"))
    print(f"[K3] decode step at M=8 W8: 40 layers x the four linears' device "
          f"times = {40 * per_step:.3f} ms")
    for m in (2048, 4096):
        wave = [40 * sum(prefill[(m, k, n)][i] for k, n in GRANITE_LINEARS)
                for i in range(3)]
        bound = 40 * sum(qmatmul_bound(m, k, n, 8)["bound_ms"]
                         for k, n in GRANITE_LINEARS)
        print(f"[K3] prefill wave at M={m} W8: 40 layers x the four linears' "
              f"device times = {wave[0]:.3f} ms (step 0 mma.sync "
              f"{wave[1]:.3f} ms, torch.matmul bf16 {wave[2]:.3f} ms, "
              f"operations bound {bound:.3f} ms)")
    main["prefill"] = {"shape": "M=2048 K=2048 N=16384 W8", "route": "wgmma",
                       **{key: main_prefill[key] for key in (
                           "max_abs_err", "ms", "device_ms", "plain_ms",
                           "library_ms", "library_device_ms", "bound_ms",
                           "bound_by")}}
    QM.qmatmul.launches = 0               # comparison launches do not count
    return main


def qmatmul_sweep(seed: int) -> None:
    """K3's device time at the four decode linears (M = 8, W8 and W4,
    weights cold) for grids of at most 2, 3 and 4 blocks per SM
    (``BLOCKS_PER_SM``, the split planner's one tuning knob)."""
    from repro_torch.kernels import qmatmul as QM
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    keep = QM.BLOCKS_PER_SM
    for (k, n), bits in itertools.product(GRANITE_LINEARS, (8, 4)):
        nb = k * n * bits // 8
        ws = rotating(lambda: torch.randint(
            -128, 128, (k, n * bits // 8), generator=gen, device="cuda",
            dtype=torch.int8), nb)
        scale = 0.001 + 0.01 * torch.rand(n, generator=gen, device="cuda")
        x = torch.randn((8, k), generator=gen, device="cuda").bfloat16()
        line = []
        for per_sm in (2, 3, 4):
            QM.BLOCKS_PER_SM = per_sm
            cols, splits, per = QM.split_plan(8, k, n, bits)
            dev = cycle_graph_ms(
                lambda wq: QM.qmatmul(x, wq, scale, bits=bits), ws)
            line.append(f"{per_sm}/SM: {-(-n // cols)}x{splits} {dev:.4f} ms "
                        f"({nb / dev / 1e6:.0f} GB/s)")
        QM.BLOCKS_PER_SM = keep
        del ws
        print(f"[sweep] K3 M=8 K={k} N={n} W{bits}: " + "; ".join(line))
    QM.qmatmul.launches = 0


def qmatmul_prefill_sweep(seed: int) -> None:
    """K3's wgmma prefill at the four granite linears (M 2048 and 4096, W8,
    weights cold) with 128-row and 256-row output tiles (``prefill_rows``,
    the prefill rule's one knob), device time beside torch.matmul bf16."""
    from repro_torch.kernels import qmatmul as QM
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    rule = QM.prefill_rows
    for m, (k, n) in itertools.product((2048, 4096), GRANITE_LINEARS):
        ws = rotating(lambda: torch.randint(
            -127, 128, (k, n), generator=gen, device="cuda",
            dtype=torch.int8), k * n)
        scale = 0.001 + 0.01 * torch.rand(n, generator=gen, device="cuda")
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        line = []
        for rows in (128, 256):
            QM.prefill_rows = lambda _m, rows=rows: rows  # noqa: E731
            dev = cycle_graph_ms(
                lambda wq: QM.qmatmul(x, wq, scale, bits=8), ws)
            line.append(f"{rows} x 128 tiles {dev:.4f} ms "
                        f"({2 * m * k * n / dev / 1e9:.0f} TFLOP/s)")
        QM.prefill_rows = rule
        del ws
        w16 = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        wl = rotating(lambda: w16.clone(), k * n * 2)
        lib = cycle_graph_ms(lambda w: torch.matmul(x, w), wl)
        del wl
        print(f"[sweep] K3 M={m} K={k} N={n} W8 (rule: {rule(m)} rows): "
              + "; ".join(line) + f"; torch.matmul bf16 {lib:.4f} ms")
    QM.qmatmul.launches = 0


def phase_aquant(seed: int) -> dict:
    """K5 against its plain version on the card, bit for bit: the shapes of
    the prequant images ([2048, 16384], [8192, 2048]) and the tied head's
    dequantized table (49155 x 2048 values), bits 4/6/8, power-of-two scale
    on and off; a bf16 input; and amax exactly at a power of two and one
    f32 step above it, where ceil(log2(.)) decides the grid."""
    from repro_torch.kernels import aquant as AQ
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)

    def bits_of(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    cases = []
    for shape in ((2048, 16384), (8192, 2048), (2048, 49155)):
        x = torch.randn(shape, generator=gen, device="cuda") * 0.05
        for bits in (4, 6, 8):
            for po2 in (True, False):
                cases.append((f"{shape[0]}x{shape[1]} f32", x, bits, po2))
    xb = (torch.randn((2048, 16384), generator=gen, device="cuda")
          * 0.05).bfloat16()
    cases += [("2048x16384 bf16", xb, b, True) for b in (4, 8)]
    for label, top in (("amax = 2^-3", 0.125),
                       ("amax = 2^-3 + 1 ulp",
                        float(np.nextafter(np.float32(0.125), np.float32(1))))):
        x = (torch.rand((8192, 2048), generator=gen, device="cuda") - 0.5) * 0.2
        x[17, 5] = -top
        cases += [(f"8192x2048 {label}", x, b, po2) for b in (4, 8)
                  for po2 in (True, False)]
    main = None
    for label, x, bits, po2 in cases:
        got = AQ.aquant(x, bits, po2)
        torch.cuda.synchronize()
        want = AQ.aquant_ref(x, bits, po2)
        same = torch.equal(bits_of(got), bits_of(want))
        err = float((got.float() - want.float()).abs().max())
        if not same:
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"{label} bits={bits} po2={po2}: max err "
                                 f"{err:g}")
        timed = "+" not in label and "= 2^" not in label and (
            bits == 8 or "49155" in label)
        if timed:
            nbytes = 2 * x.numel() * x.element_size()
            bound = nbytes / H100_BYTES_PER_S * 1e3
            ms = cuda_time_ms(lambda: AQ.aquant(x, bits, po2), iters=50,
                              warmup=5)
            plain = cuda_time_ms(lambda: AQ.aquant_ref(x, bits, po2),
                                 iters=10, warmup=2)
            print(f"[K5] {label} bits={bits} po2={po2}: bitwise equal; "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                  f"{bound:.4f} ms (bytes: {nbytes} B), "
                  f"{nbytes / ms / 1e6:.1f} GB/s; no single PyTorch call "
                  f"computes it")
            if label.startswith("2048x49155") and bits == 8 and po2:
                main = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "library_ms": None, "bound_ms": bound,
                        "bound_by": "bytes"}
        else:
            print(f"[K5] {label} bits={bits} po2={po2}: bitwise equal")
    AQ.aquant.launches = 0                # comparison launches do not count
    return main


# ---------------------------------------------------------------------------
# phase 2: K4 (decode attention over the contiguous int8 cache)
# ---------------------------------------------------------------------------

def qkv_bound(q, lengths, s) -> dict:
    """Least time for one K4 call on an H100 SXM: the bytes it must move
    (each group's valid K and V prefix at one byte per element — all S
    rows of V for a length-0 group, whose output is their mean — q, the
    f32 output, scales and lengths) over HBM bandwidth, and
    4·Σlen·Hg·D operations over the f32 rate."""
    b, hkv, hg, d = q.shape
    n = lengths.long().clamp(max=s)
    k_rows = int(n.sum())
    v_rows = int(torch.where(n > 0, n, s).sum())
    nbytes = ((k_rows + v_rows) * d + q.numel() * q.element_size()
              + b * hkv * hg * d * 4 + 3 * b * hkv * 4)
    flops = 4 * k_rows * hg * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def qkv_inputs(gen, row_len, *, b=8, hkv=8, hg=4, d=64, s=1024,
               qdtype=torch.bfloat16) -> dict:
    """One K4 call's operands as the static serve gives them: q ``[B, Hkv,
    Hg, D]``, K and V as layer 1 of a two-layer stacked int8 cache ``[2, B,
    S, Hkv, D]`` (a strided view, as ``KVCache`` holds a layer), per-(row,
    head) scales, and ``lengths [B, Hkv]`` from the per-row ``row_len``."""
    cache = [torch.randint(-127, 128, (2, b, s, hkv, d), generator=gen,
                           device="cuda", dtype=torch.int16).to(torch.int8)
             for _ in "kv"]
    ks, vs = (0.005 + 0.02 * torch.rand((b, hkv), generator=gen,
                                        device="cuda") for _ in "kv")
    lengths = torch.as_tensor(row_len, dtype=torch.int32, device="cuda")
    q = torch.randn((b, hkv, hg, d), generator=gen, device="cuda").to(qdtype)
    return {"q": q, "cache": cache, "k_scale": ks, "v_scale": vs,
            "lengths": lengths[:, None].expand(b, hkv).contiguous()}


def k4_args(x, cache=None):
    k, v = (c[1] for c in (cache or x["cache"]))
    return (x["q"], k, v, x["k_scale"], x["v_scale"], x["lengths"])


class route_as:
    """Within the block, every K4 call takes ``route`` (``None``: the
    wrapper's own rule), by setting ``qkv_attention.route_of`` aside."""

    def __init__(self, QK, route):
        self.QK, self.route = QK, route

    def __enter__(self):
        self.rule = self.QK.route_of
        if self.route is not None:
            self.QK.route_of = lambda *a: self.route  # noqa: E731

    def __exit__(self, *exc):
        self.QK.route_of = self.rule


def k4_device_ms(QK, x, copies, route=None) -> float:
    """K4's device time per call: a CUDA graph of >= 20 calls, each on the
    next cold copy of the stacked cache."""
    with route_as(QK, route):
        return cycle_graph_ms(lambda c: QK.qkv_attention(*k4_args(x, c)),
                              copies)


def k4_copies(x):
    """Copies of the stacked cache that together exceed L2 by the bytes a
    call reads, so each call of a cycle finds its K and V cold."""
    b, hkv, _, d = x["q"].shape
    s = x["cache"][0].shape[2]
    n = x["lengths"].long().clamp(max=s)
    touched = int(n.sum() + torch.where(n > 0, n, s).sum()) * d
    return rotating(lambda: [c.clone() for c in x["cache"]], touched)


def qkv_sdpa_times(x) -> dict:
    """``scaled_dot_product_attention`` on the cache dequantized beforehand
    to q's type (not timed) in ``[B, Hkv, S, D]``, with the ``col < len``
    mask and ``enable_gqa``: device time from a CUDA graph over cold copies
    (``None`` if capture is refused) and per-call time."""
    import torch.nn.functional as F
    q = x["q"]
    b, hkv, hg, d = q.shape
    k, v = (c[1] for c in x["cache"])
    s = k.shape[1]
    kd = (k.float() * x["k_scale"][:, None, :, None]).to(q.dtype)
    vd = (v.float() * x["v_scale"][:, None, :, None]).to(q.dtype)
    kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :]
            < x["lengths"][:, :1].long())[:, None, None, :]
    qq = q.reshape(b, hkv * hg, 1, d)
    copies = rotating(lambda: (kd.clone(), vd.clone()),
                      2 * kd.numel() * kd.element_size())
    fn = lambda c: F.scaled_dot_product_attention(  # noqa: E731
        qq, c[0], c[1], attn_mask=mask, enable_gqa=True)
    per_call = cycle_time_ms(fn, copies, 200)
    try:
        dev = cycle_graph_ms(fn, copies)
    except RuntimeError as e:             # capture refused: report, go on
        print(f"[lib] CUDA-graph capture failed ({str(e)[:80]}); device "
              f"time not measured")
        torch.cuda.synchronize()
        dev = None
    return {"library_ms": per_call, "library_device_ms": dev}


def check_k4(QK, x, label, route=None) -> float:
    """K4 against its plain version within 1e-5 (both sides sum the same
    f32 products in different orders; outputs are O(0.1)), finite, and
    bitwise equal across two calls. Returns the max abs error."""
    with route_as(QK, route):
        got = QK.qkv_attention(*k4_args(x))
        again = QK.qkv_attention(*k4_args(x))
    torch.cuda.synchronize()
    want = QK.qkv_attention_cache_ref(*k4_args(x))
    err = float((got - want).abs().max())
    same = torch.equal(got, again)
    q = x["q"]
    s = x["cache"][0].shape[2]
    splits, per = QK.split_plan(q.shape[0], q.shape[1], s)
    print(f"[K4] {label}: route {route or QK.route_of(q.dtype, q.shape[-1])}"
          f", {splits} splits x {per} tiles; max_abs_err={err:.3e} (tol "
          f"1e-5), two calls bitwise equal: {same}")
    if not err <= 1e-5 or not bool(torch.isfinite(got).all()) or not same:
        raise AssertionError(f"K4 disagrees with its plain version at "
                             f"{label}")
    return err


def serve_lengths(seed: int) -> list:
    """Per-row K4 lengths ``min(pos + 1, slots)`` of the static serve's
    decode steps (``--full --requests 12 --max-new 32``): prompts from
    ``launch/serve.py::make_requests``, sorted into groups of 8 rows (pad
    rows have prompt length 0), at each group's first and last decode step
    (pos = prompt length and prompt length + 30). Returns ``(label,
    lengths)`` pairs."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    args = S.parse_args(["--full", "--requests", "12", "--max-new", "32",
                         "--seed", str(seed)])
    reqs = S.make_requests(get_config(args.arch), args)
    plen = sorted(len(r.tokens) for r in reqs)
    out = []
    for gi in range(0, len(plen), 8):
        grp = plen[gi:gi + 8] + [0] * (8 - len(plen[gi:gi + 8]))
        for step, label in ((0, "first"), (args.max_new - 2, "last")):
            out.append((f"group {gi // 8 + 1} {label} decode step",
                        [min(p + step + 1, 1024) for p in grp]))
    return out


def phase_qkv_attention(seed: int) -> dict:
    """K4 against its plain version, timed on the device beside step 0 (the
    first port's one-block-per-group kernel, the ``serial`` route) and SDPA
    on the pre-dequantized cache, at 8 rows × 8 KV heads, Hg 4, D 64: S
    1024 with per-row lengths 0, 1, 63, 64, 65 (a 64-column tile edge ±
    1), 1024, 300 and 544 (bf16 q, on both q·K routes, and f32 q); the
    static serve's own lengths at each group's first and last decode step;
    S 4096 with one row at 4096; every length 1 (the fixed cost of a
    call). Untimed: a ragged S 1000, Hg 1 and 16, D 128 and 256 at f32 and
    bf16 q, a contiguous (not layer-view) cache, and a row whose last split
    holds one valid column."""
    from repro_torch.kernels import qkv_attention as QK
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    main_len = [0, 1, 63, 64, 65, 1024, 300, 544]
    cases = [("S=1024 q bf16", dict(row_len=main_len)),
             ("S=1024 q float32", dict(row_len=main_len,
                                        qdtype=torch.float32))]
    cases += [(f"S=1024 serve {lab}", dict(row_len=n))
              for lab, n in serve_lengths(seed)]
    cases += [("S=4096 one row at 4096", dict(
        row_len=[4096, 1, 63, 64, 65, 1024, 300, 544], s=4096)),
              ("S=1024 every length 1", dict(row_len=[1] * 8))]
    main, steps = None, {}
    for label, kw in cases:
        x = qkv_inputs(gen, **kw)
        q = x["q"]
        routes = [None, "serial"]
        if q.dtype == torch.bfloat16 and label == "S=1024 q bf16":
            routes.append("cuda_cores")        # q·K off the tensor cores
        err = max(check_k4(QK, x, label, r) for r in routes)
        copies = k4_copies(x)
        dev = {r: k4_device_ms(QK, x, copies, r) for r in routes}
        fn = lambda c: QK.qkv_attention(*k4_args(x, c))  # noqa: E731
        ms = cycle_time_ms(fn, copies, 200)
        del copies
        plain = cuda_time_ms(lambda: QK.qkv_attention_cache_ref(
            *k4_args(x)), iters=20, warmup=2)
        lib = qkv_sdpa_times(x)
        bd = qkv_bound(q, x["lengths"], x["cache"][0].shape[2])
        splits, per = QK.split_plan(q.shape[0], q.shape[1],
                                    x["cache"][0].shape[2])
        new, old = dev[None], dev["serial"]
        sdpa = lib["library_device_ms"]
        other = ("" if "cuda_cores" not in dev else
                 f"; q.K on the CUDA cores {dev['cuda_cores']:.4f} ms")
        print(f"[K4] {label}: {splits} splits x {per} tiles; device "
              f"{new:.4f} ms (step 0 {old:.4f} ms, {old / new:.2f}x; SDPA "
              f"on the pre-dequantized cache, dequant not timed, "
              f"{_ms(sdpa)}"
              + ("" if sdpa is None else f", {new / sdpa:.2f}x of it")
              + f"){other}; per call {ms:.4f} ms (SDPA "
              f"{lib['library_ms']:.4f}), plain {plain:.4f} ms; bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: {bd['bytes']} B, "
              f"{bd['flops']} flop; {bd['bound_ms'] / new:.3f} of it); "
              f"lengths {kw['row_len']}")
        if "serve" in label:
            steps[label] = (new, old)
        if main is None:
            main = {"max_abs_err": err, "plain_ms": plain, "ms": ms,
                    "device_ms": new, "step0_device_ms": old,
                    "splits": splits, **lib, **bd}
    for label, (new, old) in steps.items():
        print(f"[K4] {label}: 40 layers x device time = {40 * new:.4f} ms "
              f"per decode step (step 0 {40 * old:.4f} ms)")
    edges = [("S=1000 (ragged) q bf16", dict(
        row_len=[1000, 999, 0, 1, 64, 936, 937, 500], s=1000)),
             ("S=1000 (ragged) q float32", dict(
                 row_len=[1000, 999, 0, 1, 64, 936, 937, 500], s=1000,
                 qdtype=torch.float32))]
    for hg in (1, 16):
        edges += [(f"Hg={hg} q {str(dt)[6:]}", dict(
            row_len=main_len, hg=hg, qdtype=dt))
            for dt in (torch.bfloat16, torch.float32)]
    for d in (128, 256):
        edges += [(f"D={d} Hkv=2 q {str(dt)[6:]}", dict(
            row_len=main_len, d=d, hkv=2, qdtype=dt))
            for dt in (torch.bfloat16, torch.float32)]
    # the last split of S 1024 (8 splits x 2 tiles) holds one valid column
    edges += [("S=1024 last split holds one column", dict(
        row_len=[897, 1, 1024, 0, 896, 128, 129, 2]))]
    for label, kw in edges:
        x = qkv_inputs(gen, **kw)
        check_k4(QK, x, label)
    x = qkv_inputs(gen, row_len=main_len)
    x["cache"] = [torch.stack([c[1].contiguous()] * 2) for c in x["cache"]]
    check_k4(QK, x, "S=1024 contiguous cache")
    QK.qkv_attention.launches = 0          # comparison launches do not count
    return main


def qkv_sweep(seed: int) -> None:
    """K4's device time for grids of about 2, 4 and 8 blocks per SM
    (``BLOCKS_PER_SM``) at phase 2's shape, the serve's longest decode step
    and S 4096, and at S 4096 for splits of at most 2, 4 and 8 tiles
    (``MAX_SPLIT_TILES``): the split planner's two knobs."""
    from repro_torch.kernels import qkv_attention as QK
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    keep = QK.BLOCKS_PER_SM
    last = serve_lengths(seed)[-1]
    for label, kw in (("S=1024", dict(row_len=[0, 1, 63, 64, 65, 1024, 300,
                                                 544])),
                      (f"S=1024 serve {last[0]}", dict(row_len=last[1])),
                      ("S=4096 one row at 4096", dict(
                          row_len=[4096, 1, 63, 64, 65, 1024, 300, 544],
                          s=4096))):
        x = qkv_inputs(gen, **kw)
        copies = k4_copies(x)
        line = []
        for per_sm in (2, 4, 8):
            QK.BLOCKS_PER_SM = per_sm
            splits, per = QK.split_plan(8, 8, x["cache"][0].shape[2])
            line.append(f"{per_sm}/SM: {splits}x{per} "
                        f"{k4_device_ms(QK, x, copies):.4f} ms")
        QK.BLOCKS_PER_SM = keep
        if x["cache"][0].shape[2] == 4096:
            cap = QK.MAX_SPLIT_TILES
            for tiles in (2, 4, 8):
                QK.MAX_SPLIT_TILES = tiles
                splits, per = QK.split_plan(8, 8, 4096)
                line.append(f"at most {tiles} tiles: {splits}x{per} "
                            f"{k4_device_ms(QK, x, copies):.4f} ms")
            QK.MAX_SPLIT_TILES = cap
        del copies
        print(f"[sweep] K4 {label}: " + "; ".join(line))
    QK.qkv_attention.launches = 0


# ---------------------------------------------------------------------------
# phase 3: kernel vs gather backends at full width, f32
# ---------------------------------------------------------------------------

def phase_parity(seed: int) -> None:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=4)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, device="cuda")
    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    rng = np.random.default_rng(seed)
    cases = [(17, 9), (64, 12), (33, 5), (120, 10), (8, 7), (96, 1), (50, 11)]
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=m) for n, m in cases]
    with use_compute_dtype(torch.float32):
        for bits in (16, 8, 4):
            out = {}
            for backend in ("kernel", "gather"):
                srv = AdaptiveServer(cfg, params, engine, ServingConfig(
                    slots=256, kv_bits=bits, max_batch=4, block_size=16,
                    paged_backend=backend), device="cuda")
                PA.paged_attention.launches = 0
                A.paged_view.calls = 0
                sched = ContinuousScheduler(srv, quantum=4)
                for r in reqs:
                    sched.submit(r)
                out[backend] = [r["tokens"] for r in sched.run()]
                used = (PA.paged_attention.launches if backend == "kernel"
                        else A.paged_view.calls)
                if used == 0:
                    raise AssertionError(f"{backend} backend never ran")
                del srv, sched
            same = out["kernel"] == out["gather"]
            print(f"[parity] full width x4 layers, f32, kv{bits}: kernel vs "
                  f"gather greedy tokens identical: {same} "
                  f"({sum(map(len, out['kernel']))} tokens)")
            if not same:
                raise AssertionError(f"kv{bits}: {out}")
            if bits == 4:                 # speculation runs at kv16/kv8
                continue
            for backend in ("kernel", "gather"):
                srv = AdaptiveServer(cfg, params, engine, ServingConfig(
                    slots=256, kv_bits=bits, max_batch=4, block_size=16,
                    paged_backend=backend, speculate=True, draft_k=4),
                    device="cuda")
                PA.paged_attention_multi.launches = 0
                A.paged_view.calls = 0
                sched = ContinuousScheduler(srv, quantum=4)
                for r in reqs:
                    sched.submit(r)
                spec = [r["tokens"] for r in sched.run()]
                used = (PA.paged_attention_multi.launches
                        if backend == "kernel" else A.paged_view.calls)
                if used == 0:
                    raise AssertionError(f"spec {backend} backend never ran")
                same = spec == out["kernel"]
                print(f"[parity] full width x4 layers, f32, kv{bits}: "
                      f"speculative ({backend}, k=4, {sched.windows_run} "
                      f"windows) vs greedy tokens identical: {same}")
                if not same:
                    first_divergence(cfg, params, engine, reqs, spec,
                                     out["kernel"], bits)
                    raise AssertionError(f"kv{bits} spec {backend}: {spec}")
                del srv, sched
        static_parity(cfg, params, engine, reqs)
    del params
    torch.cuda.empty_cache()


def static_parity(cfg, params, engine, reqs) -> None:
    """The static path at kv8 (``AdaptiveServer.serve``, contiguous cache):
    K4 (``paged_backend="kernel"``) against the reference's einsum
    (``"gather"``). K4 dequantizes before the dot where the einsum scales
    after it, so a greedy token may flip only where the top-2 logits
    nearly tie: a divergence fails unless its margin is under 1e-3."""
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig
    out = {}
    for backend in ("kernel", "gather"):
        srv = AdaptiveServer(cfg, params, engine, ServingConfig(
            slots=256, kv_bits=8, max_batch=4, paged_backend=backend),
            device="cuda")
        QK.qkv_attention.launches = A.decode_attention.kv8_einsum_calls = 0
        out[backend] = [r["tokens"] for r in srv.serve(reqs)]
        used = (QK.qkv_attention.launches, A.decode_attention.kv8_einsum_calls)
        print(f"[parity] static serve kv8 {backend}: K4 launches {used[0]}, "
              f"kv8 einsum calls {used[1]}")
        if (used[0] > 0) != (backend == "kernel") or \
                (used[1] > 0) != (backend == "gather"):
            raise AssertionError(f"static {backend} backend took the wrong "
                                 f"kv8 read")
        del srv
    same = out["kernel"] == out["gather"]
    print(f"[parity] full width x4 layers, f32, kv8 static serve: K4 vs "
          f"einsum greedy tokens identical: {same} "
          f"({sum(map(len, out['kernel']))} tokens)")
    if not same:
        margin = first_divergence(cfg, params, engine, reqs, out["kernel"],
                                  out["gather"], 8)
        if not margin < 1e-3:
            raise AssertionError(f"static kv8: K4 tokens diverge at a "
                                 f"top-2 margin of {margin:.3e}")
    QK.qkv_attention.launches = A.decode_attention.kv8_einsum_calls = 0


def first_divergence(cfg, params, engine, reqs, spec, greedy, bits) -> float:
    """Where two token lists first differ: the request, the position, and
    the top-2 margin of the second list's logits there (a solo replay
    through ``decode_step`` on a contiguous cache, the reference's
    arithmetic), which it returns."""
    from repro_torch.models import transformer as T
    for i, (a, b) in enumerate(zip(spec, greedy)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        tokens = torch.as_tensor(reqs[i].tokens[None], device="cuda")
        table = engine.table
        logits, caches = T.prefill(params, cfg, table[0], {"tokens": tokens},
                                   len(reqs[i].tokens) + len(b) + 1,
                                   kv_bits=bits)
        pos = torch.tensor([tokens.shape[1]], dtype=torch.int32, device="cuda")
        for n in range(j):
            logits, caches = T.decode_step(
                params, cfg, table[0], torch.tensor([[b[n]]], device="cuda"),
                pos, caches)
            pos = pos + 1
        top = logits[0].float().topk(2).values
        margin = float(top[0] - top[1])
        print(f"[parity] first divergence: request {i}, token {j}: "
              f"{a[j]} vs {b[j]}; top-2 logit margin {margin:.3e}")
        return margin
    return float("inf")


def phase_native_parity(seed: int) -> None:
    """The native path at full width (granite-3-2b widths, 4 layers, bf16
    compute), W8 and W4: ragged prefill logits on the card (every linear
    through K3, the tied head's fake-quant through K5) against the same
    function on the CPU (their plain versions), on the same weights.

    Checked at the A16 profile of the weights' width (A16-W8 on W8
    carriers, A16-W4 on W4): |card − CPU| <= 0.05·max|CPU logits|. Both
    sides round the same bf16 activations at the same points, but their f32
    sums and transcendentals differ in the last f32 bit, so a bf16 rounding
    can flip by one ulp (2^-8 relative) and the flips compound over the
    layers; a wrong kernel is off by the logits' own size. A4-W4 is
    reported without a bound: a 4-bit activation grid turns a one-ulp flip
    into a whole grid step (1/8 of the row's amax), so there the two
    devices diverge by construction, whatever the kernels do.
    Greedy-token identity is not required (bf16 outputs round); argmax
    agreement is reported."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import qmatmul as QM
    from repro_torch.models import layers as LY
    from repro_torch.models import transformer as T
    from repro_torch.models.native import to_native
    from repro_torch.runtime import use_compute_dtype

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=4)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    params = T.init_params(cfg, gen, device="cuda")
    names = T.quant_layer_names(cfg)
    table = AdaptiveEngine(tuple(paper_profiles(names)),
                           QuantIndex(names)).table
    rng = np.random.default_rng(seed)
    lens = (64, 37, 5)
    prompts = np.zeros((len(lens), 64), np.int32)
    for j, n in enumerate(lens):
        prompts[j, 64 - n:] = rng.integers(0, cfg.vocab, n)
    plen = np.asarray(lens, np.int32)
    for w_bits in (8, 4):
        nat = to_native(params, w_bits)
        nat_cpu = _to_cpu(nat)
        checked = 0 if w_bits == 8 else 1          # A16-W8 / A16-W4
        for pid in (checked, 4):                    # ..., then A4-W4
            QM.qmatmul.launches = AQ.aquant.launches = 0
            LY.dequant_matmul.calls = 0
            with use_compute_dtype(torch.bfloat16):
                got, _ = T.prefill(nat, cfg, table[pid],
                                   {"tokens": torch.as_tensor(prompts,
                                                              device="cuda"),
                                    "prompt_len": plen}, 128)
                torch.cuda.synchronize()
                k3, k5 = QM.qmatmul.launches, AQ.aquant.launches
                want, _ = T.prefill(nat_cpu, cfg, table[pid],
                                    {"tokens": torch.as_tensor(prompts),
                                     "prompt_len": plen}, 128)
            got = got.float().cpu()
            want = want.float()
            err = float((got - want).abs().max())
            bound = 0.05 * float(want.abs().max())
            agree = (got.argmax(-1) == want.argmax(-1)).tolist()
            print(f"[native] full width x4 layers, bf16, W{w_bits}, profile "
                  f"{pid}: prefill logits card vs CPU max_abs_err={err:.4e} "
                  f"({'bound' if pid == checked else 'not checked, 5 %:'} "
                  f"{bound:.4e}); argmax agrees {agree}; K3 launches "
                  f"{k3} (= 4 x {cfg.n_layers} layers), K5 launches {k5}, "
                  f"dequant-matmul calls {LY.dequant_matmul.calls}")
            if not np.isfinite(got.numpy()).all() or (pid == checked
                                                      and err > bound):
                raise AssertionError(f"native prefill W{w_bits} profile "
                                     f"{pid}: card and CPU disagree")
            if k3 != 4 * cfg.n_layers or k5 != 1 or LY.dequant_matmul.calls:
                raise AssertionError("the native prefill did not run "
                                     "through K3 and K5 alone")
        del nat, nat_cpu
    QM.qmatmul.launches = AQ.aquant.launches = 0
    del params
    torch.cuda.empty_cache()


def _to_cpu(tree):
    from repro_torch.core.quantizers import QTensor
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.data.cpu(), tree.scale.cpu(), tree.bits,
                       tree.orig_last)
    return tree.cpu()


# ---------------------------------------------------------------------------
# phase 4: serve the full config through the launcher's path
# ---------------------------------------------------------------------------

def phase_serve(seed: int) -> dict:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import RequestStatus

    from repro_torch.kernels import aquant as AQ
    args = S.parse_args(["--continuous", "--full", "--requests", "12",
                         "--max-new", "32", "--kv-bits", "16",
                         "--quantum", "8", "--block-size", "16",
                         "--seed", str(seed)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    AQ.aquant.launches = 0
    cfg, srv = S.build_server(args)
    torch.cuda.synchronize()
    k5 = AQ.aquant.launches
    n_images = len({t.data_ptr() for t in _leaves(srv.prequant)})
    print(f"[serve] built {cfg.name} ({cfg.n_layers} layers, "
          f"{sum(p.numel() for p in _leaves(srv.params)) / 1e9:.3f} B params) "
          f"with {n_images} distinct weight images in "
          f"{time.perf_counter() - t0:.1f}s; K5 launches building them: {k5}")
    if k5 == 0:
        raise AssertionError("the prequant images did not go through K5")
    reqs = S.make_requests(cfg, args)
    PA.paged_attention.launches = 0
    A.paged_view.calls = 0
    out = S.serve(srv, reqs, args.quantum, continuous=True)
    launches, gathers = PA.paged_attention.launches, A.paged_view.calls
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    for i, r in enumerate(results):
        if r["status"] is not RequestStatus.COMPLETED or len(r["tokens"]) != 32:
            raise AssertionError(f"request {i}: {r['status']}, "
                                 f"{len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"request {i}: token out of vocab")
    expect = cfg.n_layers * sched.decode_steps
    print(f"[serve] K1 launches {launches} = {cfg.n_layers} layers x "
          f"{sched.decode_steps} decode steps: {launches == expect}; "
          f"gather path calls: {gathers}")
    if launches != expect or launches == 0 or gathers != 0:
        raise AssertionError("the serve path did not run through K1 alone")
    n_tok = sum(len(r["tokens"]) for r in results)
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] {len(results)} requests, prompts "
          f"{min(len(r.tokens) for r in reqs)}-{max(len(r.tokens) for r in reqs)} "
          f"tokens, {n_tok} tokens in {wall:.3f}s = {n_tok / wall:.2f} tok/s; "
          f"{sched.segments_run} segments; peak memory {peak / 2**30:.2f} GiB")
    for i, r in enumerate(results):
        trace = r["profile_trace"]
        runs = [(p, sum(1 for _ in g)) for p, g in itertools.groupby(trace)]
        print(f"[serve] req{i}: prompt {len(reqs[i].tokens)}, "
              f"profile trace {runs}")
    mgr = srv.manager
    print(f"[serve] energy ledger: spent {mgr.spent_j:.6e} J of "
          f"{mgr.budget_j:.6e} J ({100 * (1 - mgr.remaining_fraction()):.1f}%)"
          f", saver_mode={mgr._saver}, events={len(sched.events)}")
    return {"launches": launches, "tok_s": n_tok / wall, "peak": peak,
            "k5": k5}


def phase_spec_serve(seed: int, greedy: dict) -> dict:
    """The launcher's speculative path on the full config: phase 4's
    requests with ``--speculate --draft-k 4``. Every layer of every window
    must attend through K2 and nothing else, and the ledger must bill
    exactly the tokens delivered."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import RequestStatus

    args = S.parse_args(["--continuous", "--full", "--requests", "12",
                         "--max-new", "32", "--kv-bits", "16",
                         "--quantum", "8", "--block-size", "16",
                         "--speculate", "--draft-k", "4",
                         "--seed", str(seed)])
    torch.cuda.reset_peak_memory_stats()
    cfg, srv = S.build_server(args)
    reqs = S.make_requests(cfg, args)
    PA.paged_attention.launches = 0
    PA.paged_attention_multi.launches = 0
    A.paged_view.calls = 0
    out = S.serve(srv, reqs, args.quantum, continuous=True)
    k1, k2 = PA.paged_attention.launches, PA.paged_attention_multi.launches
    gathers = A.paged_view.calls
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    for i, r in enumerate(results):
        if r["status"] is not RequestStatus.COMPLETED or len(r["tokens"]) != 32:
            raise AssertionError(f"request {i}: {r['status']}, "
                                 f"{len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"request {i}: token out of vocab")
    expect = cfg.n_layers * sched.windows_run
    print(f"[spec] K2 launches {k2} = {cfg.n_layers} layers x "
          f"{sched.windows_run} windows: {k2 == expect}; K1 launches {k1}; "
          f"gather path calls {gathers}")
    if k2 != expect or k2 == 0 or k1 != 0 or gathers != 0:
        raise AssertionError("the speculative path did not run through K2 "
                             "alone")
    n_tok = sum(len(r["tokens"]) for r in results)
    billed = len(sched.admission_log) + sum(n for _, n in sched.spec_billed)
    print(f"[spec] tokens billed {billed} (admission {len(sched.admission_log)}"
          f" + windows {billed - len(sched.admission_log)}) = delivered "
          f"{n_tok}: {billed == n_tok}")
    if billed != n_tok:
        raise AssertionError("billed tokens differ from delivered tokens")
    peak = torch.cuda.max_memory_allocated()
    per_window = (billed - len(sched.admission_log)) / sched.spec_row_windows
    print(f"[spec] {n_tok} tokens in {wall:.3f}s = {n_tok / wall:.2f} tok/s "
          f"(greedy, phase 4: {greedy.get('tok_s', float('nan')):.2f} tok/s); "
          f"{sched.segments_run} segments, {sched.windows_run} windows, "
          f"{per_window:.3f} tokens delivered per live row per window; "
          f"peak memory {peak / 2**30:.2f} GiB")
    return {"launches": k2, "tok_s": n_tok / wall, "peak": peak}


def phase_serve_block128(seed: int) -> None:
    """The launcher's ``--continuous --block-size 128`` path on the full
    config in bf16: 4 requests × 16 tokens, every layer of every decode step
    through K1 (a block size the first port's K1 refused), no gather."""
    import gc
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import RequestStatus

    gc.collect()
    torch.cuda.empty_cache()
    args = S.parse_args(["--continuous", "--full", "--requests", "4",
                         "--max-new", "16", "--kv-bits", "16", "--quantum",
                         "8", "--block-size", "128", "--seed", str(seed)])
    cfg, srv = S.build_server(args)
    reqs = S.make_requests(cfg, args)
    PA.paged_attention.launches = 0
    A.paged_view.calls = 0
    out = S.serve(srv, reqs, args.quantum, continuous=True)
    k1, gathers = PA.paged_attention.launches, A.paged_view.calls
    results, sched = out["results"], out["sched"]
    for i, r in enumerate(results):
        if r["status"] is not RequestStatus.COMPLETED or len(r["tokens"]) != 16:
            raise AssertionError(f"bs 128 request {i}: {r['status']}, "
                                 f"{len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"bs 128 request {i}: token out of vocab")
    expect = cfg.n_layers * sched.decode_steps
    n_tok = sum(len(r["tokens"]) for r in results)
    print(f"[serve] --block-size {srv.block_size}: K1 launches {k1} = "
          f"{cfg.n_layers} layers x {sched.decode_steps} decode steps: "
          f"{k1 == expect}; gather calls {gathers}; {n_tok} tokens in "
          f"{out['wall_s']:.3f}s")
    if srv.block_size != 128 or k1 != expect or k1 == 0 or gathers:
        raise AssertionError("the bs-128 serve did not run through K1 alone")
    del srv, out


def phase_spec_wide(seed: int) -> None:
    """``--speculate --draft-k 16`` (W·Hg = 68) on the full config: the
    launcher's 4 requests × 16 tokens, served greedy (K1) and then
    speculatively (K2) by ``AdaptiveServer`` + ``ContinuousScheduler`` in
    f32 with TF32 off and no manager (one profile, so windows and steps use
    the same weights). K2 launches = n_layers × windows, K1 and gather
    none; the tokens equal greedy's. The verify forward multiplies 17
    tokens per row where greedy multiplies one, so the two differ in f32
    summation order: a flip is allowed only at a top-2 logit margin under
    1e-3 (``first_divergence``), as in phase 3's static kv8 check."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import AdaptiveServer, ServingConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = S.parse_args(["--continuous", "--full", "--requests", "4",
                         "--max-new", "16", "--kv-bits", "16", "--quantum",
                         "8", "--speculate", "--draft-k", "16", "--seed",
                         str(seed)])
    cfg = get_config(args.arch)
    reqs = S.make_requests(cfg, args)
    toks = {}
    with use_compute_dtype(torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = T.init_params(cfg, gen, device="cuda")
        names = T.quant_layer_names(cfg)
        engine = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                                QuantIndex(names))
        for spec in (False, True):
            srv = AdaptiveServer(cfg, params, engine, ServingConfig(
                slots=1024, kv_bits=16, max_batch=8, block_size=16,
                speculate=spec, draft_k=args.draft_k), device="cuda")
            PA.paged_attention.launches = 0
            PA.paged_attention_multi.launches = 0
            A.paged_view.calls = 0
            out = S.serve(srv, reqs, args.quantum, continuous=True)
            k1, k2 = (PA.paged_attention.launches,
                      PA.paged_attention_multi.launches)
            gathers = A.paged_view.calls
            sched = out["sched"]
            toks[spec] = [r["tokens"] for r in out["results"]]
            if any(len(t) != 16 for t in toks[spec]):
                raise AssertionError(f"draft-k 16 (spec={spec}): short "
                                     f"request")
            if spec:
                expect = cfg.n_layers * sched.windows_run
                print(f"[spec] --draft-k 16 (W·Hg {17 * cfg.n_heads // cfg.n_kv}"
                      f"), f32: K2 launches {k2} = {cfg.n_layers} layers x "
                      f"{sched.windows_run} windows: {k2 == expect}; K1 "
                      f"launches {k1}; gather calls {gathers}")
                if k2 != expect or k2 == 0 or k1 or gathers:
                    raise AssertionError("the draft-k 16 serve did not run "
                                         "through K2 alone")
            elif k1 != cfg.n_layers * sched.decode_steps or k2 or gathers:
                raise AssertionError("the greedy f32 serve did not run "
                                     "through K1 alone")
            del srv, out, sched
            gc.collect()
            torch.cuda.empty_cache()
        same = toks[True] == toks[False]
        print(f"[spec] --draft-k 16 vs greedy, full config, f32: tokens "
              f"identical: {same} ({sum(map(len, toks[True]))} tokens)")
        if not same:
            margin = first_divergence(cfg, params, engine, reqs, toks[True],
                                      toks[False], 16)
            if not margin < 1e-3:
                raise AssertionError(f"draft-k 16 tokens diverge from greedy "
                                     f"at a top-2 margin of {margin:.3e}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_native_serve(seed: int, requests: int, max_new: int,
                       w_bits: int) -> dict:
    """The native integer-weight path at full width: phase 4's config and
    requests (``requests`` × ``max_new`` of them) served from
    ``to_native(params, w_bits)`` through ``AdaptiveServer`` +
    ``ContinuousScheduler`` on the paged pool, bf16, kv16. Every native
    linear of every prefill forward and decode step must launch K3, every
    decode step K1 in each layer, the tied head's images K5 (once per
    distinct head bits), and the dequantize-then-matmul branch never. The
    f32 masters are freed before the peak-memory window opens, so the peak
    is the native deployment's."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.manager import ProfileManager
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qmatmul as QM
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.models import layers as LY
    from repro_torch.models import transformer as T
    from repro_torch.models.native import to_native
    from repro_torch.serving.engine import (AdaptiveServer, RequestStatus,
                                            ServingConfig)

    args = S.parse_args(["--continuous", "--full", "--requests",
                         str(requests), "--max-new", str(max_new),
                         "--kv-bits", "16", "--quantum", "8",
                         "--block-size", "16", "--seed", str(seed)])
    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = T.init_params(cfg, gen, device="cuda")
    names = T.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    engine = AdaptiveEngine(tuple(profs), QuantIndex(names))
    stats = S.profile_stats(cfg, profs, T.param_count(params))
    mgr = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                         budget_j=stats[0].energy_j * args.budget_inferences,
                         low_energy=0.5)
    t0 = time.perf_counter()
    nat = to_native(params, w_bits)
    del params
    gc.collect()
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    QM.qmatmul.launches = AQ.aquant.launches = PA.paged_attention.launches = 0
    LY.dequant_matmul.calls = A.paged_view.calls = 0
    srv = AdaptiveServer(cfg, nat, engine, ServingConfig(
        slots=1024, kv_bits=16, max_batch=8, block_size=args.block_size),
        manager=mgr, device="cuda")
    reqs = S.make_requests(cfg, args)
    out = S.serve(srv, reqs, args.quantum, continuous=True)
    k3, k5, k1 = (QM.qmatmul.launches, AQ.aquant.launches,
                  PA.paged_attention.launches)
    deq, gathers = LY.dequant_matmul.calls, A.paged_view.calls
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    for i, r in enumerate(results):
        if (r["status"] is not RequestStatus.COMPLETED
                or len(r["tokens"]) != max_new):
            raise AssertionError(f"native request {i}: {r['status']}, "
                                 f"{len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"native request {i}: token out of vocab")
    waves = len(sched.events) - sched.decode_steps   # one event per wave
    head_bits = {int(T.split_bits(cfg, row)[1][1]) for row in engine.table}
    want_k3 = 4 * cfg.n_layers * (sched.decode_steps + waves)
    want_k1 = cfg.n_layers * sched.decode_steps
    print(f"[native] W{w_bits}: converted in {t_conv:.1f}s; K3 launches {k3} "
          f"= 4 x {cfg.n_layers} layers x ({sched.decode_steps} decode steps "
          f"+ {waves} prefill waves): {k3 == want_k3}; K1 launches {k1} = "
          f"{cfg.n_layers} x {sched.decode_steps}: {k1 == want_k1}; K5 "
          f"launches {k5} = {len(head_bits)} tied-head images: "
          f"{k5 == len(head_bits)}; dequant-matmul calls {deq}; gather "
          f"calls {gathers}")
    if (k3 != want_k3 or k1 != want_k1 or k5 != len(head_bits) or deq
            or gathers or k3 == 0):
        raise AssertionError(f"the native W{w_bits} serve did not run "
                             f"through K3, K1 and K5 alone")
    n_tok = sum(len(r["tokens"]) for r in results)
    peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(nat))
    print(f"[native] W{w_bits}: {len(results)} requests, {n_tok} tokens in "
          f"{wall:.3f}s = {n_tok / wall:.2f} tok/s; {sched.segments_run} "
          f"segments; native weights {weight_bytes / 2**30:.2f} GiB; peak "
          f"memory {peak / 2**30:.2f} GiB")
    return {"k3": k3, "k5": k5, "tok_s": n_tok / wall, "peak": peak}


def phase_contiguous_serve(seed: int, continuous: bool) -> dict:
    """The contiguous int8 cache on the full config in bf16: phase 4's 12
    requests × 32 tokens through the launcher at ``--kv-bits 8``, on the
    static path (no ``--continuous``: ``AdaptiveServer.serve``, groups of
    8 rows) or on the continuous scheduler's contiguous pool
    (``--continuous --no-paged-kv``). Every layer of every decode step must
    read the cache through K4: 40 × decode steps launches, K1 and the kv8
    einsum never."""
    import gc
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A

    argv = ["--full", "--requests", "12", "--max-new", "32", "--kv-bits",
            "8", "--quantum", "8", "--seed", str(seed)]
    if continuous:
        argv += ["--continuous", "--no-paged-kv"]
    args = S.parse_args(argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, srv = S.build_server(args)
    reqs = S.make_requests(cfg, args)
    QK.qkv_attention.launches = PA.paged_attention.launches = 0
    A.decode_attention.kv8_einsum_calls = A.paged_view.calls = 0
    out = S.serve(srv, reqs, args.quantum, continuous=continuous)
    k4, k1 = QK.qkv_attention.launches, PA.paged_attention.launches
    einsum, gathers = A.decode_attention.kv8_einsum_calls, A.paged_view.calls
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    for i, r in enumerate(results):
        if len(r["tokens"]) != 32 or (continuous and r["status"].value
                                      != "completed"):
            raise AssertionError(f"request {i}: {len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"request {i}: token out of vocab")
    if continuous:
        steps, label = sched.decode_steps, "contiguous pool"
        if sched.paged:
            raise AssertionError("--no-paged-kv built a paged pool")
    else:
        n_groups = -(-len(reqs) // srv.scfg.max_batch)
        steps, label = n_groups * (args.max_new - 1), "static serve"
    expect = cfg.n_layers * steps
    print(f"[contig] {label} kv8: K4 launches {k4} = {cfg.n_layers} layers x "
          f"{steps} decode steps: {k4 == expect}; K1 launches {k1}; kv8 "
          f"einsum calls {einsum}; gather calls {gathers}")
    if k4 != expect or k4 == 0 or k1 or einsum or gathers:
        raise AssertionError(f"the {label} did not read the int8 cache "
                             f"through K4 alone")
    n_tok = sum(len(r["tokens"]) for r in results)
    peak = torch.cuda.max_memory_allocated()
    print(f"[contig] {label} kv8: {len(results)} requests, {n_tok} tokens "
          f"in {wall:.3f}s = {n_tok / wall:.2f} tok/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    del srv, out
    return {"launches": k4, "tok_s": n_tok / wall, "peak": peak}


def phase_profile(seed: int) -> None:
    """Where one decode segment's time goes (``--profile``): wall time on
    the host against device-busy time from ``torch.profiler``, with the
    kernels that take the most device time, on the full 40-layer config."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as S
    from repro_torch.serving.scheduler import ContinuousScheduler

    args = S.parse_args(["--full", "--requests", "8", "--max-new", "32",
                         "--seed", str(seed)])
    cfg, srv = S.build_server(args)
    sched = ContinuousScheduler(srv, quantum=8)
    for r in S.make_requests(cfg, args):
        sched.submit(r)
    sched.admit()
    sched.run_segment()                     # warm
    sched._flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.run_segment()
        sched._flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) is not None
          and str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in ev) / 1e3   # ms
    n_launch = sum(e.count for e in ev)
    print(f"[profile] one segment (8 steps x {cfg.n_layers} layers, 8 rows): "
          f"wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / (wall * 1e3):.1f}%), {n_launch} device kernels")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def kernel_entry(name, source, replaces, launches, row) -> dict:
    """One row of the kernel table: the main path's launch count and the
    phase-2 row of the kernel at its main-path shape (K1–K4 also carry
    their device time from a CUDA graph and their split count, K4 its step
    0's device time)."""
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{source}",
             "replaces": replaces, "launches": launches,
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
    if "device_ms" in row:
        entry.update(device_ms=row["device_ms"],
                     library_device_ms=row["library_device_ms"])
    if "splits" in row:
        entry["splits"] = row["splits"]
    if "step0_device_ms" in row:
        entry["step0_device_ms"] = row["step0_device_ms"]
    if "prefill" in row:
        entry["prefill"] = row["prefill"]
    return entry


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5,6,7")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also break one full-width decode segment down "
                         "with torch.profiler")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"[env] {card}")
    from repro_torch.kernels import build as B
    libs = B.build()
    for name, info in libs.items():
        print(f"[env] built {name} ({B.SOURCES[name].name}, sm_90a) in "
              f"{info['seconds']:.1f}s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[env] ptxas {name}: {line.strip()}")
    rows = {}
    if 2 in phases:
        _, rows["k1"] = phase_kernels(args.seed)
        rows["k2"] = phase_window_kernel(args.seed)
        split_sweep(args.seed)
        rows["k3"] = phase_qmatmul(args.seed)
        qmatmul_sweep(args.seed)
        qmatmul_prefill_sweep(args.seed)
        rows["k4"] = phase_qkv_attention(args.seed)
        qkv_sweep(args.seed)
        rows["k5"] = phase_aquant(args.seed)
    if 3 in phases:
        phase_parity(args.seed)
        phase_native_parity(args.seed)
    served = phase_serve(args.seed) if 4 in phases else {"launches": 0}
    if 4 in phases:
        phase_serve_block128(args.seed)
    spec = (phase_spec_serve(args.seed, served) if 5 in phases
            else {"launches": 0})
    if 5 in phases:
        phase_spec_wide(args.seed)
    native = {"k3": 0, "k5": 0}
    if 6 in phases:
        native = phase_native_serve(args.seed, 12, 32, 8)
        phase_native_serve(args.seed, 4, 16, 4)
    static = {"launches": 0}
    if 7 in phases:
        static = phase_contiguous_serve(args.seed, continuous=False)
        phase_contiguous_serve(args.seed, continuous=True)
    if args.profile:
        phase_profile(args.seed)
    kernels = []
    if rows:
        kernels.append(kernel_entry(
            "paged_attention", "paged_attention.cu",
            "src/repro/kernels/paged_attention.py:116", served["launches"],
            rows["k1"]))
        kernels.append(kernel_entry(
            "paged_attention_multi", "paged_attention_multi.cu",
            "src/repro/kernels/paged_attention.py:247", spec["launches"],
            rows["k2"]))
        kernels.append(kernel_entry(
            "qmatmul", "qmatmul.cu", "src/repro/kernels/qmatmul.py:88",
            native["k3"], rows["k3"]))
        kernels.append(kernel_entry(
            "qkv_attention", "qkv_attention.cu",
            "src/repro/kernels/qkv_attention.py:68", static["launches"],
            rows["k4"]))
        kernels.append(kernel_entry(
            "aquant", "aquant.cu", "src/repro/kernels/aquant.py:59",
            native["k5"], rows["k5"]))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
