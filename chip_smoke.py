"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

  python3 chip_smoke.py            # all phases (needs one CUDA GPU)
  python3 chip_smoke.py --phases 1,2

Phases:
 1. environment: versions, the card, and the build of every kernel (one
    nvcc per source, sm_90a, all started together);
 2. each kernel against its plain PyTorch version on the card, at the
    shapes the serving path gives it, with times, the bound and the
    library yardstick: K1 (one-query paged decode) and K2 (the W-query
    speculative verify window);
 3. path parity at full width (granite-3-2b widths, 4 layers, f32, TF32
    off): the same requests through the continuous scheduler with the
    kernel and the gather backends give identical greedy tokens at kv16,
    kv8 and kv4, and the speculative scheduler gives those same tokens
    with either backend at kv16 and kv8;
 4. serve: the launcher's path on granite-3-2b's full 40-layer config in
    bf16 — 12 requests, 32 new tokens each — counting kernel launches;
 5. speculative serve: phase 4's requests through the launcher's
    ``--speculate --draft-k 4`` path, counting K2 launches per window and
    checking that the tokens billed are the tokens delivered.
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


def paged_bound(x, bits) -> dict:
    """Least time for this call on an H100 SXM: the bytes it must move
    (attended keys' K and V, mapped blocks' token indices, q, scales,
    table, positions, output) over HBM bandwidth, and its operations over
    the f32 rate (the kernel's arithmetic type)."""
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
    t_ops = flops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "keys": n_keys}


def sdpa_ms(x) -> float:
    """One ``scaled_dot_product_attention`` call on a dense view gathered
    beforehand (kv16 only; the gather is not timed)."""
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
    return cuda_time_ms(fn)


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
    (4·Hkv·Hg·D per key) over the f32 rate."""
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
    t_ops = flops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "keys": n_keys}


def window_sdpa_ms(x) -> float:
    """One ``scaled_dot_product_attention`` call on K2's dense view (kv16;
    the gather is not timed), with the per-query causal mask
    ``[B, 1, W, S]`` and ``enable_gqa``."""
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
    fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qq, k, v, attn_mask=mask, enable_gqa=True)
    return cuda_time_ms(fn)


def phase_window_kernel(seed: int) -> dict:
    """K2 against its plain version at the speculative serve shape: B=8,
    W=5, Hkv=8, Hg=4, D=64, bs=16, n_lblk 64 and 256, kv16 and kv8."""
    from repro_torch.kernels import paged_attention as PA
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    main = None
    for n_lblk in (64, 256):
        for bits in (16, 8):
            x = paged_inputs(gen, bits=bits, w=5, n_lblk=n_lblk)
            kw = dict(bits=bits, window=0)
            got = PA.paged_attention_multi(**x, **kw)
            torch.cuda.synchronize()
            want = PA.paged_attention_multi_ref(**x, **kw)
            err = float((got - want).abs().max())
            dead = float(got[-1].abs().max())
            print(f"[K2] n_lblk={n_lblk} kv{bits}: max_abs_err={err:.3e} "
                  f"(tol {ATOL:g}), dead row max |out|={dead}")
            if not err <= ATOL or dead != 0.0:
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"at n_lblk={n_lblk} kv{bits}")
            ms = cuda_time_ms(lambda: PA.paged_attention_multi(**x, **kw))
            plain = cuda_time_ms(
                lambda: PA.paged_attention_multi_ref(**x, **kw), iters=50)
            lib = window_sdpa_ms(x) if bits == 16 else None
            bd = window_bound(x, bits)
            print(f"[K2] n_lblk={n_lblk} kv{bits}: kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, sdpa "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                  f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
                  f"{bd['bytes']} B, {bd['flops']} flop, {bd['keys']} keys)")
            if n_lblk == 64 and bits == 16:
                main = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "library_ms": lib, **bd}
    PA.paged_attention_multi.launches = 0  # comparison launches do not count
    return main


def phase_kernels(seed: int) -> list[dict]:
    from repro_torch.kernels import paged_attention as PA
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, main = [], None
    for n_lblk in (64, 256):
        for bits in (16, 8, 4):
            x = paged_inputs(gen, bits=bits, n_lblk=n_lblk)
            kw = dict(bits=bits, window=0)
            got = PA.paged_attention(**x, **kw)
            torch.cuda.synchronize()
            want = PA.paged_attention_ref(**x, **kw)
            err = float((got - want).abs().max())
            dead = float(got[-1].abs().max())
            print(f"[K1] n_lblk={n_lblk} kv{bits}: max_abs_err={err:.3e} "
                  f"(tol {ATOL:g}), dead row max |out|={dead}")
            if not err <= ATOL or dead != 0.0:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at n_lblk={n_lblk} kv{bits}")
            ms = cuda_time_ms(lambda: PA.paged_attention(**x, **kw))
            plain = cuda_time_ms(lambda: PA.paged_attention_ref(**x, **kw),
                                 iters=50)
            lib = sdpa_ms(x) if bits == 16 else None
            bd = paged_bound(x, bits)
            row = {"n_lblk": n_lblk, "bits": bits, "max_abs_err": err,
                   "ms": ms, "plain_ms": plain, "library_ms": lib, **bd}
            print(f"[K1] n_lblk={n_lblk} kv{bits}: kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, sdpa "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                  f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
                  f"{bd['bytes']} B, {bd['flops']} flop, {bd['keys']} keys)")
            rows.append(row)
            if n_lblk == 64 and bits == 16:
                main = row
    PA.paged_attention.launches = 0       # comparison launches do not count
    return rows, main


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
    del params
    torch.cuda.empty_cache()


def first_divergence(cfg, params, engine, reqs, spec, greedy, bits) -> None:
    """Where speculative and greedy tokens first differ: the request, the
    position, and the top-2 margin of the greedy logits there (a solo
    replay through ``decode_step`` on a contiguous cache)."""
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
        print(f"[parity] first divergence: request {i}, token {j}: spec "
              f"{a[j]} vs greedy {b[j]}; greedy top-2 logit margin "
              f"{float(top[0] - top[1]):.3e}")


# ---------------------------------------------------------------------------
# phase 4: serve the full config through the launcher's path
# ---------------------------------------------------------------------------

def phase_serve(seed: int) -> dict:
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import RequestStatus

    args = S.parse_args(["--continuous", "--full", "--requests", "12",
                         "--max-new", "32", "--kv-bits", "16",
                         "--quantum", "8", "--block-size", "16",
                         "--seed", str(seed)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, srv = S.build_server(args)
    torch.cuda.synchronize()
    print(f"[serve] built {cfg.name} ({cfg.n_layers} layers, "
          f"{sum(p.numel() for p in _leaves(srv.params)) / 1e9:.3f} B params) "
          f"with {len({t.data_ptr() for t in _leaves(srv.prequant)})} distinct weight "
          f"images in {time.perf_counter() - t0:.1f}s")
    reqs = S.make_requests(cfg, args)
    PA.paged_attention.launches = 0
    A.paged_view.calls = 0
    out = S.serve(srv, reqs, args.quantum)
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
    return {"launches": launches, "tok_s": n_tok / wall, "peak": peak}


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
    out = S.serve(srv, reqs, args.quantum)
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
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5")
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
    from repro_torch.kernels import paged_attention as PA
    libs = PA.build()
    for name, info in libs.items():
        print(f"[env] built {name} ({PA.SOURCES[name].name}, sm_90a) in "
              f"{info['seconds']:.1f}s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[env] ptxas {name}: {line.strip()}")
    k1_row = k2_row = None
    if 2 in phases:
        _, k1_row = phase_kernels(args.seed)
        k2_row = phase_window_kernel(args.seed)
    if 3 in phases:
        phase_parity(args.seed)
    served = phase_serve(args.seed) if 4 in phases else {"launches": 0}
    spec = (phase_spec_serve(args.seed, served) if 5 in phases
            else {"launches": 0})
    if args.profile:
        phase_profile(args.seed)
    kernels = []
    if k1_row is not None:
        kernels.append(kernel_entry(
            "paged_attention", "paged_attention.cu",
            "src/repro/kernels/paged_attention.py:116", served["launches"],
            k1_row))
        kernels.append(kernel_entry(
            "paged_attention_multi", "paged_attention_multi.cu",
            "src/repro/kernels/paged_attention.py:247", spec["launches"],
            k2_row))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
