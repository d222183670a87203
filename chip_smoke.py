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
    through a CUDA graph, both also on a shared table (8 rows mapping the
    same 24 prefix blocks; bitwise equal to distinct tables, timed beside
    them), then both for grids of 2, 4 and 8 blocks per SM; K3 (the dequant-matmul of the native
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
    fake-quant, bit for bit with f32 and bf16 outputs, on and off the
    grid's on-chip store, at 2- and 4-byte offsets, in a replayed CUDA
    graph and on two streams at once; device time from a CUDA graph,
    over cold copies where the tensor fits in L2, beside step 0's, the
    first port's two launches);
 3. path parity at full width (granite-3-2b widths, 4 layers, f32, TF32
    off): the same requests through the continuous scheduler with the
    kernel and the gather backends give identical greedy tokens at kv16,
    kv8 and kv4, and the speculative scheduler gives those same tokens
    with either backend at kv16 and kv8; static ``serve`` at kv8 gives the
    same tokens through K4 as through the reference's einsum (a flip only
    at a top-2 logit margin under 1e-3); a shared-system-prompt workload
    with the prefix cache gives the tokens of the run without it (both
    backends at kv16/kv8/kv4; ``prefill_chunk=32`` at kv16/kv8;
    speculation at kv16), with the registry hits the host computes;
    preemption (two saver rows, one a copy-on-write sharer, evicted for a
    critical arrival on a full 2-row pool, both backends at kv16 and kv8,
    and speculative at kv16): every restore bitwise equal to its eviction
    snapshot, the savers' tokens equal to the serve without the critical
    arrival; speculation on the contiguous pool at kv16 and kv8 against
    its greedy tokens; then the native path in bf16 at W8 and W4: prefill
    logits on the card (K3, K5) against the CPU's;
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
    K1 and the kv8 einsum never; then the contiguous pool with
    ``--speculate --draft-k 4`` (windows, billed = delivered, tok/s);
 8. shared prefixes and chunked prefill through the launcher's
    ``--continuous`` path in bf16 at granite-3-2b's ``FEATURE_LAYERS``
    (40) layers: 12 requests on one 384-token system
    prompt at kv16 and kv8, with and without ``--no-prefix-cache``
    (registry hits, prefill tokens, peak blocks, tok/s; K1 launches = 40 ×
    decode steps, no gather; the shared blocks' bytes unchanged), then
    phase 4's requests with ``--prefill-chunk 128``;
 9. priority classes and preemption in bf16 at granite's
    ``FEATURE_LAYERS`` (``--priority-classes 2 --preemption``): 8 saver requests
    fill the pool, 4 critical ones arrive after 2 rounds; at kv16 and kv8
    under slot pressure and at kv16 under block pressure: preemptions =
    resumes >= 1, the first restore bitwise equal to its snapshot, billed =
    delivered, K1 = 40 × decode steps; tok/s, peak blocks and the critical
    requests' rounds to their first token;
10. the per-layer KV precision policy (profile 0 all-16, profiles 1–5 a
    striped 4/8/16 row, a small energy budget moving the serve into them):
    at granite-3-2b widths, 4 layers, f32, the kernel backend's tokens
    equal the gather backend's at kv16, kv8 and kv4, the all-16 policy
    gives the tokens of no policy, the striped one changes a stream,
    static kv8 gives the same tokens through K4 as through the einsum, and
    the frontier search runs on the card; then the launcher's
    ``--continuous --precision-policy`` in bf16 at granite's
    ``FEATURE_LAYERS`` (phase 4's requests, a striped row of that depth in
    the frontier's JSON format: K1 = layers × decode steps, billed =
    delivered,
    tok/s and peak memory beside the serve without the policy, the
    refine's own cost per call) and its static path at ``--kv-bits 8`` (K4
    = 40 × decode steps);
11. fault-tolerant serving: (a) at granite-3-2b widths, 4 layers, f32,
    one scenario (a recoverable NaN, a NaN on every attempt that exhausts
    ``retry_budget=2``, a dry allocator round, a flush stall the watchdog
    flags, a live copy-on-write sharer and a queued request cancelled, a
    deadline expired through a virtual clock, ``paranoid``) through the
    kernel and gather backends at kv16, kv8 and kv4, on the contiguous kv8
    pool (K4) and speculatively at kv16 (K2): statuses, tokens, retries,
    events and the robustness counters equal across backends, the
    recovered tokens equal a clean accuracy-critical run's, 0 used blocks
    at drain; (b) the launcher's ``--continuous --inject-faults
    --paranoid`` in bf16 at granite's ``FEATURE_LAYERS`` beside the
    serve without faults (K1 = 40 × decode steps, faults detected = NaNs
    injected, tok/s, the audit's host ms per step), then a direct serve
    with a shed policy, a cancel and an expiry (billed = delivered, 0 used
    blocks);
12. crash-consistent serving: (a) at granite-3-2b widths, 4 layers, f32,
    the reference durability test's servers (kv16 with speculation, kv8
    with chunked prefill, two classes, copy-on-write prefixes) on the
    kernel and gather backends: abandoned after each of at most 8 round
    boundaries and recovered (checkpoint + journal) into a new server,
    every serve ends with the uninterrupted tokens, a clean audit and 0
    blocks in use, K1 = 4 × decode steps and K2 = 4 × windows after the
    restart; a corrupted leaf re-prefills its request, a drained run
    restarts and completes; (b) a real crash at granite's widths and
    ``FEATURE_LAYERS``: the launcher's ``--full --continuous --journal-dir
    D --checkpoint-every 8`` as a child process (depth cut as
    ``cut_depth`` cuts it), SIGKILLed after its second cut, restarted on
    ``D``, beside an
    uninterrupted child and one without the journal: every first-boot rid
    has exactly one ``final`` record with the uninterrupted tokens; bytes
    and ms per cut, ms per fsync'd record, ``recovery_s``, tok/s with and
    without the journal;
13. the paper's CNN (``CNNConfig()``: 64 channels, 28x28, f32, TF32 off):
    (a) K5 bitwise against its plain version at the six per-tensor sites
    of a batch-256 forward at bits 16/8/4, with the scale it returns for
    the straight-through mask; (b) one training step (forward and
    backward) at A8-W8 and Mixed through K5 and through the plain version
    swapped in, cuDNN deterministic: loss and gradients bitwise equal;
    (c) the forward of all six profiles on the card against the port on
    the CPU under the tests' tie rule; (d) the launcher's Table 1
    (``run_table1(steps=120)``: per-profile QAT, fake and native accuracy,
    latency at batch 256 and 1 by CUDA events, modelled power and energy)
    and Fig. 4 (the merged A8-W8 + Mixed engine, overhead, battery),
    failing under 0.75 test accuracy, a native engine more than 0.5 points
    from the fake path, or no K5 launch; K5's launches over (d) are its
    ``cnn_launches``; (e) where the time goes: the A8-W8 forward's eager
    latency beside its device time from a CUDA graph, and one training
    step's device-busy share under ``torch.profiler``.
14. the mamba2 SSM family at mamba2-130m's full width (24 layers, d_model
    768, 24 SSD heads of 64, d_state 128, chunk 256, vocab 50280, tied
    embeddings): (a) in f32, TF32 off: prefill(31) + decode_step against
    forward(32) at ``rel < 5e-5``, a ragged serve of prompts 4/300/517
    against each prompt's solo generate, generate against
    generate_stepwise, and a ``ContinuousScheduler`` asked for the paged
    pool running contiguous with the static serve's tokens (a greedy flip
    only at a top-2 margin under 1e-3); (b) K5 bit for bit on the
    ``ssm_in``/``ssm_out``/tied-table images at bits 8 and 4, and K3 at
    ``ssm_in`` (N 3352, rows not 16-byte aligned: bytewise split-K decode,
    mma.sync prefill) and ``ssm_out`` (N 768) at M 1/8/16/512/4096, W8 and
    W4, bf16 and f32 x, each with its route and device time beside
    torch.matmul's; (c) the launcher's ``--arch mamba2-130m --full
    --continuous`` workload (12 requests, 32 new tokens, 8 rows, bf16) with
    fake-quant weights, then from ``to_native`` at W8 and W4: tok/s, peak
    memory, the SSM state's bytes, K5 launches, K3 launches = 2 x 24 x
    (decode steps + prefill waves) on the native runs; (d) under
    ``torch.profiler``: one admission wave and one decode segment, their
    device-busy share and top device operations.
15. the hybrid family at hymba-1.5b's full width (32 layers, d_model 1600,
    25 query heads over 5 KV heads, a sliding window of 1024, 50 SSD heads
    of 64, d_state 16, untied head of 32001): (a) in f32, TF32 off:
    prefill(31) + decode_step against forward(32) at ``rel < 5e-5``;
    prefill(1000) into ``slots=2048`` (a ring of 1024) and 60
    teacher-forced decode steps across position 1024 against forward(1060)
    (the block-skipping window prefill) at every decoded position, ``rel <
    5e-5``, and the same steps on a bf16 paged pool through K1 (window
    1024 on the wrapped ring) against the gather backend; (b) K1 at Hg 5 on
    wrapped rings (kv16/8/4, windows 1024 and 1000), K4 at Hg 5 at the
    static serve's lengths, K3 at every hymba site (``ssm_in`` N 6482 and
    the head N 32001 take the bytewise split-K and mma.sync routes), K5 bit
    for bit on hymba's images at bits 8 and 4, each timed beside its
    library call and bound; (c) the launcher's ``--arch hymba-1.5b --full``
    workload at hymba's ``HYMBA_FEATURE_LAYERS`` layers
    on the paged pool (K1 = layers x decode steps), ``--kv-bits 8`` static
    (K4 = layers x 62) and from ``to_native(params, 8)`` (K3 = 193 x (decode steps
    + prefill waves)): tok/s, peak memory, KV and SSM bytes;
    (d) under ``torch.profiler``: one admission wave and one decode
    segment.
16. the MoE family at qwen2-moe-a2.7b's full width (24 layers, d_model
    2048, 16 heads of 128 with qkv bias, 60 routed experts top-4 of width
    1408 and 4 shared, vocab 151936, untied; 57.26 GB of f32 masters): (a)
    in f32, TF32 off, at capacity factor 16 (nothing drops): prefill(31) +
    decode_step against forward(32) at ``B = 16``, ``rel < 5e-5``; at the
    published 1.25, 12 greedy steps of 8 rows on a bf16 paged pool through
    K1 against the gather backend, tokens identical (a divergence only
    after a router top-k margin under 1e-6 or a top-2 logit margin under
    1e-3); (b) K5 bit for bit on the routed stacks (``w_in`` 346 M f32
    elements, ``w_out``) and a prefill wave's bf16 dispatch buffer at bits
    8 and 4, K1 and K4 at Hkv 16, Hg 1, D 128, K3 at the router (N 60,
    W8/W4), ``qkv``, ``shared_in``, ``shared_out`` and the head at M 8 and
    4096, each timed beside its library call and bound; (c) the launcher's
    ``--arch qwen2-moe-a2.7b --full --continuous`` workload on the paged
    kv16 pool (K1 = 24 x steps, K5 = image build + 96 x (steps + waves)),
    with ``--no-paged-kv --kv-bits 8`` (K4 = 24 x steps) and from
    ``to_native(params, 8)`` (K3 = 121 x (steps + waves), routed
    dequantizations and K5 = 48 x (steps + waves)): tok/s, peak memory,
    decode steps, prefill waves; (d) under ``torch.profiler``: one
    admission wave and one decode segment, with K5's share and the
    copies' and casts'.
17. the vision-language family at qwen2-vl-2b's full width (28 layers,
    d_model 1536, 12 heads of 128 over 2 KV heads with qkv bias, M-RoPE
    sections (16, 24, 24), a vision prefix of 256 patches, tied head of
    151936; 6.2 GB of f32 masters): (a) in f32, TF32 off: ``apply_mrope``
    on three distinct streams against float64 and text M-RoPE = RoPE bit
    for bit; prefill(256 patches + 44 tokens) + decode_step against
    forward(301) at ``rel < 5e-5``; 12 greedy steps on a bf16 paged pool
    through K1 against the gather backend, and on the int8 contiguous
    cache through K4 against the einsum (tokens identical, a divergence
    only after a top-2 margin under 1e-3); (b) K1 and K4 at Hkv 2, Hg 6, D
    128, K3 at its four linears at M 8 and 4096, W8 and W4, K5 bit for bit
    on its images and the tied table, each timed beside its library call
    and bound; (c) a model-level generate in bf16 (the server takes token
    prompts only): 8 requests of 256 patches + 64–256 text tokens, each
    prefilled alone, then 31 greedy steps of 8 rows, as kv16 paged (K1 = 28
    x steps), int8 contiguous (K4 = 28 x steps) and native W8 (K3 = 4 x 28
    x (steps + waves)): tok/s, peak memory, KV bytes;
18. the audio family at hubert-xlarge's full width (48 layers, d_model
    1280, 16 heads of 80, layer norms, GELU, bidirectional, 512-dim frame
    features, 504 units; 3.8 GB of f32 masters): (a) in f32, TF32 off: the
    card's forward and frame logits against the CPU's, and a left-padded
    ragged batch (500, 317, 93 frames) against each clip's solo forward,
    ``rel < 5e-5``; (b) K3 at its six linears (the head at N 504 on
    mma.sync) at M 4000, W8 and W4, K5 bit for bit on every site's image;
    (c) the forward over 8 clips x 500 frames in bf16 at A8-W8,
    fake-quant (K5 = 194 per forward) and native W8 and W4 (K3 = 194 per
    forward): frames/s, peak memory, and one forward's device-busy share
    under ``torch.profiler``.
19. LM training at granite-3-2b's full width (40 layers, d_model 2048,
    vocab 49155, tied; 10.13 GB of f32 masters): (a) the smoke LM's
    ``train_loss`` and every gradient leaf (remat on, A8-W8 and Mixed) on
    the card against the CPU in f32, TF32 off; (b) K5 bit for bit, with
    its scale, on each weight site's stacked-leaf view and the tied table,
    timed over cold copies, and inside a ``torch.utils.checkpoint``
    recompute; (c) the launcher's setup through the port's ``train()``:
    bf16 over f32 masters, B 8 x S 512, AdamW in place, remat on, the six
    profiles in turn, 2 warm-up and 6 timed steps: losses, tokens/s, ms
    per step, peak memory, K5 = 323 launches per step as worked out from
    the code, one step under ``torch.profiler``; (d) the same with
    ``--grad-compression`` for 3 steps (peak memory, ms per step, the
    error-feedback invariant); (e) at 2 layers, SIGTERM → checkpoint →
    exit, an injected failure, and the resumed run's parameters and
    moments bitwise the uninterrupted run's.
20. the hot-path analysis (``repro_torch.analysis``): (a) the static gate
    on the card: the lint of ``src/repro_torch`` clean, the five budget
    points on the granite smoke config passing on the kernel backend (each
    point's largest output beside its ceiling; K1 = layers x steps, K2 =
    layers x windows) and tripping the no-gather-view check on the gather
    backend, and the scenario audit (<= 2 prefill waves per admission
    round, no stepwise oracle call); (b) granite-3-2b as phase 4 builds it
    (40 layers, bf16, 1024 slots, 8 rows, bs 16), its rows admitted from
    phase 4's requests, one 8-step kv16 segment traced on the kernel path
    and on the gather path: the largest output, the view, the pool updated
    in place, device->host and host->device transfers per segment, aten
    ops per decode step, K1 launches (= 40 x 8 on the kernel path); then
    a warm graphed segment and one traced graphed segment on the same
    plan (no capture in it; aten ops per step, one host->device copy).
21. multi-device on the one card: four spawned ranks (``torch.cuda.
    set_device(0)``, a gloo group, activations and gradients hop through
    host memory): (a) the reference test's toy pipeline (L 8, D 16, B 12,
    4 stages, 4 microbatches, ``tanh``) against the sequential stack, <=
    1e-5; (b) granite-3-2b at full width, 40 layers in 4 stages of 10,
    8 microbatches of 1 x 512 tokens, A8-W8 fake-quant: f32 (TF32 off)
    against the single-process stack over the same microbatches (rel <=
    1e-5, bitwise or not), then bf16 timed beside that stack (pipeline
    and sequential ms, the bubble 3/11, bytes and ms per hop, each rank's
    peak memory), K5 = 10 layers x 4 sites x 8 microbatches = 320 per
    rank; (c) ``compressed_psum`` of each rank's gradients (one
    ``train_loss`` backward of granite's widths at 2 layers, B 2 x S 128
    of its own) against the plain mean of the ranks' q.s on the card,
    <= 1e-6 of each leaf's max-abs, ms per reduction and bytes on the
    wire; (d) meanwhile in this process, the dry run on meta: qwen2-72b
    and qwen1.5-110b at train_4k and decode_32k on the 256- and
    512-device meshes, status, per-device argument bytes beside this
    card's memory, flops per device. The times describe four processes
    sharing one card, not a multi-GPU host.
22. the decode segment replayed from CUDA graphs (``serving/graphs.py``):
    granite-3-2b at full width on phase 4's workload, kv16, kv8 and kv4
    paged, kv8 contiguous and native W8 through ``--continuous``, the
    speculative segment (``--speculate --draft-k 4``) at kv16 and kv8
    paged and kv8 contiguous, each served through the launcher's path
    eagerly (``graphs=False``) and then graphed, from one manager state:
    tokens, traces, statuses, events, ``spec_billed``, admission order and
    the ledger equal; captures = the distinct profile ids the segments
    used, in one pool lifetime; every graphed segment (the speculative one
    without its flush) under ``set_sync_debug_mode("error")``; K1, K2, K4
    or K3 launches equal on both (counted as launches per capture x
    replays on the graphed one); billed = delivered when speculating; peak
    memory within 10 % of the eager serve's; tok/s of both; one steady
    kv16 segment of each under ``torch.profiler`` (wall, device busy).
    The static path at kv8 (prefill graphs per exact group key, decode
    graphs per profile id over the group shape's kept cache) in two passes
    of the same 12 requests on one server, each eager then graphed: equal
    tokens, traces and ledger, K4 equal, pass 2 capturing nothing, its
    prefill replays and decodes under ``set_sync_debug_mode("error")``,
    the prefill's host wall, tok/s, peak and reserved memory and the graph
    pool's bytes, and in a third, untimed serve no write over a whole leaf
    of the kept cache; then the
    stepwise oracle on 8 rows of one length, eager then graphed (one step
    graph per profile id): equal tokens, trace, ledger and K4, per-token
    host wall, and one prefill graph's first and later replays. The
    admission waves, at ``FEATURE_LAYERS``, replayed
    from one CUDA graph per wave key (``WaveGraphs``): kv16 paged, kv8
    paged with the prefix registry and ``--prefill-chunk 128``, kv8
    contiguous and native W8, each served by one scheduler in two passes
    (phase 4's 12 requests, then 12 of the same lengths from another
    seed), eagerly and then graphed: per pass everything above equal, K3
    per wave 4 x the layers on both (native), each key captured once and
    none of pass 1's again in pass 2, every replayed wave under
    ``set_sync_debug_mode("error")``, peak memory within 10 %; each
    ``admit()`` round's host wall, tok/s, captures and replays of both.
Segment graphs: on the card every scheduler, speculative or not, on the
kernel backend or a contiguous pool replays its decode steps (or
draft/verify windows) from CUDA graphs (one capture per profile id per
pool lifetime) and its admission waves from one graph per wave key, and
the static path replays its prefill (one graph per exact group key) and
its decode from graphs kept per group shape, so phases 3–12 and 14–16
serve graphed (phase 5's
speculative serve and phase 7's static and speculative ones included);
the (c) serves of phases 14–16 are also served eagerly once and held
equal, and phase 20 (b) traces a graphed segment beside the eager ones.
Depth: phases 8, 9, 10 (its launcher serves), 11 (b), 12 (b), 15 (c)
and phase 22's wave modes serve at ``FEATURE_LAYERS`` /
``HYMBA_FEATURE_LAYERS`` (``cut_depth``; 12 (b)'s children cut the same
way): 10 and 8 layers, cut from the published 40 and 32 to make room for
phase 22's static modes at full depth; a run that outgrows its limit
cuts these first, depth and never width.
Each phase prints its seconds, and the run its total.
The last lines are the card, the kernel table (JSON) and the result (JSON).
Any failed check raises, so the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
K5_KERNEL = "aquant_fused_kernel"  # K5's one kernel, as the profiler names it
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12          # bf16 dense tensor cores
ATOL = 1e-4                       # kernel vs plain, f32 outputs
# The card's serving workload, from phase 4 on. The launcher's defaults are
# the reference launcher's (256 slots, 4 rows, prompts of 4-23 tokens).
CARD_SERVER = dict(slots=1024, max_batch=8)
CARD_PROMPTS = dict(prompt_lens=(64, 513))
# Depth of the serving phases that check a feature on the main path's
# widths rather than the main path itself (8, 9, 10 (b)-(c), 11 (b), 12 (b)
# and 22's wave modes: granite; 15 (c): hymba), the first thing to cut
# should the phases outgrow the run's time limit: 10 of granite's 40 and 8
# of hymba's 32 since phase 22 serves its admission waves and its static
# path twice over (eager and graphed, two passes).
FEATURE_LAYERS = 10
HYMBA_FEATURE_LAYERS = 8


@contextlib.contextmanager
def cut_depth(n_layers: int):
    """The launcher's published configs with their depth cut to
    ``n_layers`` (every width unchanged) while the block runs."""
    import dataclasses
    from repro_torch.launch import serve as S
    full = S.get_config
    S.get_config = lambda arch: dataclasses.replace(full(arch),
                                                    n_layers=n_layers)
    try:
        yield
    finally:
        S.get_config = full


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


def shared_inputs(gen, *, bits, w=None, B=8, Hkv=8, Hg=4, D=64, bs=16,
                  n_lblk=64, n_shared=24, dev="cuda"):
    """K1's (``w`` None) or K2's inputs on a table whose rows all map their
    first ``n_shared`` logical blocks to the same physical blocks (a shared
    system prompt, every slot valid), then a private tail up to a ragged
    position, with stale token indices past it and both unmapped
    sentinels after it."""
    nw = 1 if w is None else w
    cap = n_lblk * bs
    n_blocks = n_shared + B * (n_lblk - n_shared)
    perm = torch.randperm(n_blocks, generator=gen, device=dev).tolist()
    pos = torch.randint(n_shared * bs, cap - nw, (B,), generator=gen,
                        device=dev)
    pos_h = pos.tolist()
    bt = torch.full((B, n_lblk), n_blocks, dtype=torch.int32)
    tidx = torch.full((n_blocks, bs), -1, dtype=torch.int32)
    shared = [perm.pop() for _ in range(n_shared)]
    for lb, phys in enumerate(shared):
        tidx[phys] = (lb * bs + torch.arange(bs)).int()
    for b in range(B):
        bt[b, :n_shared] = torch.tensor(shared, dtype=torch.int32)
        need = min(n_lblk, (pos_h[b] + nw - 1) // bs + 1)
        for lb in range(n_shared, n_lblk):
            if lb < need:
                phys = perm.pop()
                bt[b, lb] = phys
                t = lb * bs + torch.arange(bs)
                tidx[phys] = torch.where(t <= pos_h[b] + nw + 2, t, -1).int()
            else:
                bt[b, lb] = -1 if lb % 2 else n_blocks + lb
    x = paged_inputs(gen, bits=bits, w=w, B=B, Hkv=Hkv, Hg=Hg, D=D, bs=bs,
                     n_lblk=n_lblk, dev=dev)
    shape = (n_blocks,) + tuple(x["k_pool"].shape[1:])
    x["k_pool"] = x["k_pool"].reshape(-1)[:int(np.prod(shape))].reshape(shape)
    x["v_pool"] = x["v_pool"].reshape(-1)[:int(np.prod(shape))].reshape(shape)
    return dict(x, token_idx=tidx.to(dev), block_table=bt.to(dev),
                pos=pos.int())


def unshare(x, n_shared):
    """The same attention with every row holding its own copy of the
    shared blocks' bytes at new physical ids (no two rows map a block);
    unmapped entries stay unmapped in the larger pool."""
    bt, tidx = x["block_table"].clone(), x["token_idx"]
    n_blocks = tidx.shape[0]
    B = bt.shape[0]
    shared = bt[0, :n_shared].long()
    grow = B * n_shared
    bt = torch.where(bt >= n_blocks, bt + grow, bt)
    bt[:, :n_shared] = (n_blocks + torch.arange(
        grow, device=bt.device).reshape(B, n_shared)).int()

    def cat(pool):
        return torch.cat([pool, pool[shared].repeat(B, *([1] * (pool.dim()
                                                               - 1)))])

    return dict(x, k_pool=cat(x["k_pool"]), v_pool=cat(x["v_pool"]),
                token_idx=cat(tidx), block_table=bt)


def phase_shared_tables(seed: int) -> None:
    """K1 and K2 (W 5) on tables whose 8 rows all map their first 24
    logical blocks to the same 24 physical blocks (a 384-token system
    prompt at bs 16) with private tails, at kv16 and kv8: against the plain
    version (ATOL), two calls bitwise equal, and bitwise equal to the same
    attention on distinct tables (each row its own copy of the prefix);
    device times of both in the same call, for information."""
    from repro_torch.kernels import paged_attention as PA
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    for name, fn, ref, w in (("K1", PA.paged_attention,
                              PA.paged_attention_ref, None),
                             ("K2", PA.paged_attention_multi,
                              PA.paged_attention_multi_ref, 5)):
        for bits in (16, 8):
            x = shared_inputs(gen, bits=bits, w=w)
            xd = unshare(x, 24)
            kw = dict(bits=bits, window=0)
            got = fn(**x, **kw)
            again = fn(**x, **kw)
            dist = fn(**xd, **kw)
            torch.cuda.synchronize()
            err = float((got - ref(**x, **kw)).abs().max())
            same, same_d = torch.equal(got, again), torch.equal(got, dist)
            dev_s = graph_ms(lambda: fn(**x, **kw))
            dev_d = graph_ms(lambda: fn(**xd, **kw))
            bound = (paged_bound if w is None else window_bound)(x, bits)
            print(f"[{name}] shared table (8 rows x 24 shared blocks, bs 16, "
                  f"n_lblk 64{'' if w is None else ', W 5'}) kv{bits}: "
                  f"max_abs_err={err:.3e} (tol {ATOL:g}), two calls bitwise "
                  f"equal: {same}, equal to distinct tables: {same_d}; "
                  f"device {dev_s:.4f} ms shared, {dev_d:.4f} ms distinct; "
                  f"bound {bound['bound_ms']:.4f} ms (each row's keys)")
            if not err <= ATOL or not same or not same_d:
                raise AssertionError(f"{name} on a shared table kv{bits}")
    PA.paged_attention.launches = PA.paged_attention_multi.launches = 0


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


def k3_case(gen, m: int, k: int, n: int, bits: int, xdtype,
            time_step0: bool = False) -> dict:
    """One K3 call against its plain version (the tolerance and the times
    of :func:`phase_qmatmul`'s docstring): random ``[k, n]`` weights
    quantized per channel, ``x [m, k]`` in ``xdtype``; raises where they
    disagree or two calls differ, prints the line and returns its row
    (with the call's route, step 0's device time where ``time_step0`` and
    the route is wgmma, and the operands)."""
    from repro_torch.core.qtypes import QuantSpec
    from repro_torch.core.quantizers import quantize_native
    from repro_torch.kernels import qmatmul as QM
    u = 2.0 ** -24
    f32 = torch.float32
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
    if route == "wgmma" and time_step0:
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
    return {"max_abs_err": err, "ms": ms, "device_ms": dev,
            "plain_ms": plain, "library_ms": lib,
            "library_device_ms": lib_dev, "splits": splits, **bd,
            "route": route, "label": label, "step0": step0, "x": x,
            "qt": qt, "scale": scale, "got": got}


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
    from repro_torch.kernels import qmatmul as QM
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
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
        r = k3_case(gen, m, k, n, bits, xdtype, time_step0=(
            (k, n) in GRANITE_LINEARS and bits == 8))
        route, label, dev, step0 = (r["route"], r["label"], r["device_ms"],
                                    r["step0"])
        if (m > 16 and (k, n) in GRANITE_LINEARS and xdtype == bf16
                and route != "wgmma"):
            raise AssertionError(f"K3 at the main path's {label} took "
                                 f"{route}, not the wgmma kernel")
        x, qt, scale, got = r["x"], r["qt"], r["scale"], r["got"]
        row = {key: r[key] for key in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "splits", "bound_ms", "bound_by", "bytes",
            "flops")}
        if m <= 16 and (k, n) in GRANITE_LINEARS:
            decode.append((label, dev))
        if step0 is not None:
            prefill[(m, k, n)] = (dev, step0, r["library_device_ms"])
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


def k5_step0(x, bits: int, po2: bool):
    """Step 0 of K5 on the contiguous ``x``: the first port's two launches
    (``repro_aquant_step0``), output in ``x``'s type, timed beside the
    fused kernel (:func:`repro_torch.kernels.aquant.aquant` never reaches
    it)."""
    from repro_torch.kernels import build as B
    out = torch.empty_like(x)
    n = x.numel()
    n_partial = max(1, min(1024, -(-n // 4096)))
    partial = torch.empty((n_partial,), dtype=torch.float32, device=x.device)
    err = B.lib("aquant").repro_aquant_step0(
        x.data_ptr(), out.data_ptr(), partial.data_ptr(), None, n,
        int(x.dtype == torch.bfloat16), bits, int(po2), n_partial,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 step 0 launch failed: CUDA error {err}")
    return out


def k5_bound(x, out_dtype) -> dict:
    """K5's bytes bound on the card (``x`` read once, the output written
    once in ``out_dtype``) and its plan's floor: the vectors its grid
    cannot keep on chip across the barrier are read a second time."""
    from repro_torch.kernels import aquant as AQ
    p = AQ.launch_plan(x, out_dtype)
    kept = min(p.n_vec, p.grid * (p.keep_smem + p.keep_reg))
    once = x.numel() * (x.element_size() + torch.finfo(out_dtype).bits // 8)
    floor = once + (p.n_vec - kept) * AQ.VEC_BYTES
    return {"bound_ms": once / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": once, "floor_ms": floor / H100_BYTES_PER_S * 1e3,
            "floor_bytes": floor, "on_chip": kept == p.n_vec,
            "grid": p.grid}


def k5_case(label: str, x, bits: int, po2: bool, timed: bool,
            cold: bool = False) -> dict:
    """K5 on ``x`` against its plain version, bit for bit, for each output
    type it takes from ``x`` (``x``'s own; bf16 from f32), raising where
    they differ. With ``timed`` also, per output type: its device time
    from a CUDA graph (with ``cold``, over :func:`rotating` copies, so each
    call reads its ``x`` cold from device memory) beside step 0's (the
    first port's two launches, then the cast for a bf16 output) in the
    same graph form, per call and the plain version's, the bytes bound (x
    read once, the output written once) and the plan's floor (the part of
    x not kept on chip read twice). Returns the kernel-table row of the
    x-typed output, the bf16 one under ``"bf16"`` (``None`` untimed)."""
    from repro_torch.kernels import aquant as AQ
    outs = [x.dtype] + ([torch.bfloat16] if x.dtype == torch.float32
                        else [])
    errs = {}
    for od in outs:
        view = torch.int16 if od == torch.bfloat16 else torch.int32
        got = AQ.aquant(x, bits, po2, out_dtype=od)
        torch.cuda.synchronize()
        want = AQ.aquant_ref(x, bits, po2, out_dtype=od)
        errs[od] = float((got.float() - want.float()).abs().max())
        if got.dtype != od or not torch.equal(got.view(view),
                                              want.view(view)):
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"{label} bits={bits} po2={po2} -> {od}: "
                                 f"max err {errs[od]:g}")
        del got, want
    names = " and ".join(str(od).replace("torch.", "") for od in outs)
    if not timed:
        print(f"[K5] {label} bits={bits} po2={po2}: bitwise equal ({names} "
              f"out)")
        return None
    view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    if not torch.equal(k5_step0(x, bits, po2).view(view),
                       AQ.aquant_ref(x, bits, po2).view(view)):
        raise AssertionError(f"K5's step 0 differs at {label}")
    if cold:
        copies = rotating(lambda: x.clone(), x.numel() * x.element_size())

        def device(fn):
            return cycle_graph_ms(fn, copies)
    else:
        def device(fn):
            return graph_ms(lambda: fn(x))
    row = None
    for od in outs:
        bd = k5_bound(x, od)
        ms = cuda_time_ms(lambda: AQ.aquant(x, bits, po2, out_dtype=od),
                          iters=50, warmup=5)
        dev = device(lambda t: AQ.aquant(t, bits, po2, out_dtype=od))
        dev0 = device(lambda t: k5_step0(t, bits, po2).to(od))
        plain = cuda_time_ms(lambda: AQ.aquant_ref(x, bits, po2,
                                                   out_dtype=od),
                             iters=10, warmup=2)
        tag = str(od).replace("torch.", "")
        fit = ("on chip: x read once" if bd["on_chip"] else
               f"floor {bd['floor_ms']:.4f} ms ({bd['floor_bytes']} B: the "
               f"part not kept on chip read twice, "
               f"{bd['floor_ms'] / dev:.3f} of it)")
        print(f"[K5] {label} bits={bits} po2={po2} -> {tag}: bitwise equal; "
              f"device {dev:.4f} ms{' (cold copies)' if cold else ''}, step 0"
              f"{' + cast' if od != x.dtype else ''} {dev0:.4f} ms "
              f"({dev0 / dev:.2f}x), per call {ms:.4f} ms, plain "
              f"{plain:.4f} ms; bound {bd['bound_ms']:.4f} ms (bytes: "
              f"{bd['bytes']} B, x read once, {bd['bound_ms'] / dev:.3f} of "
              f"it), {fit}; grid {bd['grid']}, "
              f"{bd['bytes'] / dev / 1e6:.1f} GB/s; no single PyTorch call "
              f"computes it")
        r = {"max_abs_err": errs[od], "ms": ms, "device_ms": dev,
             "step0_device_ms": dev0, "plain_ms": plain, "library_ms": None,
             "library_device_ms": None, **bd}
        if row is None:
            row = r
        else:
            row["bf16"] = r
    if cold:
        del copies
    return row


def k5_edges(gen) -> None:
    """K5 bit for bit where its plan changes shape: just below and just
    above the grid's on-chip store (f32 to f32 and to bf16, bf16), an odd
    ``n``, data pointers 2 and 4 bytes past a 16-byte boundary, a tensor of
    one element; a CUDA graph of one call replayed over new data in the
    same buffer three times (the workspace resets itself); and two streams
    calling it at once."""
    from repro_torch.kernels import aquant as AQ
    f32, bf16 = torch.float32, torch.bfloat16

    def check(label, x, od):
        view = torch.int16 if od == bf16 else torch.int32
        got = AQ.aquant(x, 8, True, out_dtype=od)
        torch.cuda.synchronize()
        want = AQ.aquant_ref(x, 8, True, out_dtype=od)
        if not torch.equal(got.view(view), want.view(view)):
            raise AssertionError(f"K5 differs at {label} -> {od}")

    cases = []
    for dtype in (f32, bf16):
        probe = torch.empty(1 << 24, dtype=dtype, device="cuda")
        p = AQ.launch_plan(probe)                 # the full grid
        ve = AQ.VEC_BYTES // probe.element_size()
        cap = p.grid * (AQ.SMEM_BYTES // AQ.VEC_BYTES + AQ.REG_VECS)
        del probe
        for n, what in ((cap * ve - 3, "just below on-chip size"),
                        (cap * ve + 1001, "just above on-chip size"),
                        (1000003, "odd n"), (1, "one element")):
            big = torch.randn(n + 8, generator=gen, device="cuda").to(dtype)
            cases += [(f"{what} ({n} {dtype})", big[:n]),
                      (f"{what} ({n} {dtype}), 4 bytes past 16",
                       big[4 // big.element_size():][:n])]
            if dtype == bf16:
                cases.append((f"{what} ({n} bf16), 2 bytes past 16",
                              big[1:][:n]))
        print(f"[K5] {dtype}: the grid's on-chip store {cap * AQ.VEC_BYTES}"
              f" B ({p.grid} blocks)")
    for label, x in cases:
        for od in ((f32, bf16) if x.dtype == f32 else (bf16,)):
            check(label, x, od)
    print(f"[K5] bitwise equal at {len(cases)} edge tensors (on-chip "
          f"boundary, odd n, 2- and 4-byte offsets, one element), f32 and "
          f"bf16 out")
    x = torch.empty(3 << 20, device="cuda")
    x.copy_(torch.randn(3 << 20, generator=gen, device="cuda"))
    AQ.aquant(x, 8, True, out_dtype=bf16)             # warm, off the graph
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = AQ.aquant(x, 8, True, out_dtype=bf16)
    for rep in range(3):
        x.copy_(torch.randn(3 << 20, generator=gen, device="cuda")
                * (0.1 + rep))
        g.replay()
        torch.cuda.synchronize()
        want = AQ.aquant_ref(x, 8, True, out_dtype=bf16)
        if not torch.equal(y.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"K5 in a CUDA graph differs at replay "
                                 f"{rep}")
    del g
    print("[K5] one call captured in a CUDA graph, replayed 3 times over "
          "new data in its buffer: bitwise equal each time")
    xs = [torch.randn(40 << 20, generator=gen, device="cuda") * (1 + i)
          for i in range(2)]
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    outs = []
    for st, xi in zip(streams, xs):
        with torch.cuda.stream(st):
            outs.append(AQ.aquant(xi, 8, True))
    torch.cuda.synchronize()
    for xi, oi in zip(xs, outs):
        if not torch.equal(oi.view(torch.int32),
                           AQ.aquant_ref(xi, 8, True).view(torch.int32)):
            raise AssertionError("K5 on two streams at once differs")
    print("[K5] two streams at once (40 M f32 each): bitwise equal")


def phase_aquant(seed: int) -> dict:
    """K5 against its plain version on the card, bit for bit: the shapes of
    the prequant images ([2048, 16384], [8192, 2048]) and the tied head's
    dequantized table (49155 x 2048 values), bits 4/6/8, power-of-two scale
    on and off; a bf16 input; and amax exactly at a power of two and one
    f32 step above it, where ceil(log2(.)) decides the grid; the plan's
    edges (:func:`k5_edges`). Timed beside step 0 at the table's shapes:
    the tied table (f32 and bf16 out), qwen2-moe's routed ``w_in``, and,
    over cold copies, hubert's ``mlp_in`` (under the on-chip store) and a
    prefill wave's bf16 MoE dispatch buffer, and the CNN's conv1
    activations. Returns the tied table's row at bits 8, po2."""
    from repro_torch.kernels import aquant as AQ
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
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
        timed = "+" not in label and "= 2^" not in label and (
            bits == 8 or "49155" in label)
        row = k5_case(label, x, bits, po2, timed)
        if label.startswith("2048x49155") and bits == 8 and po2:
            main = row
    del cases, x, xb
    for label, shape, std, dtype, cold in (
            ("qwen2-moe w_in 60x2048x2816", (60, 2048, 2816), 2048 ** -0.5,
             torch.float32, False),
            ("hubert mlp_in 1280x5120", (1280, 5120), 1280 ** -0.5,
             torch.float32, True),
            ("qwen2-moe dispatch 16x60x22x2048", (16, 60, 22, 2048), 1.0,
             torch.bfloat16, True),
            ("cnn conv1 act 256x14x14x64", (256, 14, 14, 64), 1.0,
             torch.float32, False)):
        x = (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)
        k5_case(label, x, 8, True, timed=True, cold=cold)
        del x
    torch.cuda.empty_cache()
    k5_edges(gen)
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
    reqs = S.make_requests(get_config(args.arch), args, **CARD_PROMPTS)
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


def phase_prefix_parity(seed: int) -> None:
    """Shared prefixes and chunked prefill at full width (granite-3-2b
    widths, 4 layers, f32, TF32 off): 8 requests on one 64-token system
    prompt with unique tails of 5–60 tokens, served with the prefix cache
    on, give the tokens of the run without it on the kernel and the gather
    backends at kv16, kv8 and kv4, with the registry hits the host
    computes (every request after the first); chunked runs
    (``prefill_chunk=32``) at kv16 and kv8, and speculation over the
    copy-on-write rows at kv16, give those tokens too. A token may flip
    only at a top-2 logit margin under 1e-3 (``first_divergence``)."""
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
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    params = T.init_params(cfg, gen, device="cuda")
    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    rng = np.random.default_rng(seed + 3)
    system = rng.integers(0, cfg.vocab, 64).astype(np.int32)
    shape = [(5, 8), (17, 10), (33, 6), (60, 12), (9, 7), (48, 9), (12, 11),
             (26, 8)]
    reqs = [Request(tokens=np.concatenate(
        [system, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
        max_new=m) for n, m in shape]

    def run(bits, backend, **kw):
        srv = AdaptiveServer(cfg, params, engine, ServingConfig(
            slots=256, kv_bits=bits, max_batch=4, block_size=16,
            paged_backend=backend, **kw), device="cuda")
        PA.paged_attention.launches = PA.paged_attention_multi.launches = 0
        A.paged_view.calls = 0
        sched = ContinuousScheduler(srv, quantum=4)
        for r in reqs:
            sched.submit(r)
        toks = [r["tokens"] for r in sched.run()]
        used = (PA.paged_attention.launches + PA.paged_attention_multi.launches
                if backend == "kernel" else A.paged_view.calls)
        if used == 0:
            raise AssertionError(f"{backend} backend never ran")
        if sched.allocator.used_blocks:
            raise AssertionError("live blocks left after the drain")
        return toks, sched

    def same(label, got, want, bits):
        ok = got == want
        print(f"[parity] full width x4 layers, f32, kv{bits}: {label} vs no "
              f"prefix cache: tokens identical: {ok} "
              f"({sum(map(len, got))} tokens)")
        if not ok:
            margin = first_divergence(cfg, params, engine, reqs, got, want,
                                      bits)
            if not margin < 1e-3:
                raise AssertionError(f"kv{bits} {label}: tokens diverge at "
                                     f"a top-2 margin of {margin:.3e}")

    with use_compute_dtype(torch.float32):
        for bits in (16, 8, 4):
            base, _ = run(bits, "kernel", prefix_cache=False)
            for backend in ("kernel", "gather"):
                toks, sched = run(bits, backend)
                hits = sched.registry.hits
                print(f"[parity] kv{bits} {backend}: registry hits {hits} "
                      f"(host: {len(reqs) - 1}), misses "
                      f"{sched.registry.misses}, prefill tokens "
                      f"{sched.prefill_tokens} of "
                      f"{sum(len(r.tokens) for r in reqs)}")
                if hits != len(reqs) - 1:
                    raise AssertionError(f"kv{bits} {backend}: {hits} hits")
                same(f"prefix cache ({backend})", toks, base, bits)
                if bits == 4:
                    continue
                toks, sched = run(bits, backend, prefill_chunk=32)
                if sched.chunk_waves == 0:
                    raise AssertionError("no chunk continuation ran")
                same(f"prefill_chunk=32 ({backend}, {sched.chunk_waves} "
                     f"continuation waves)", toks, base, bits)
            if bits == 16:
                toks, sched = run(bits, "kernel", speculate=True, draft_k=4)
                if sched.registry.hits != len(reqs) - 1:
                    raise AssertionError("speculative run missed the hits")
                same(f"speculation over shared rows (kernel, "
                     f"{sched.windows_run} windows)", toks, base, bits)
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


def first_divergence(cfg, params, engine, reqs, spec, greedy, bits,
                     traces=None, kv_table=None) -> float:
    """Where two token lists first differ: the request, the position, and
    the top-2 margin of the second list's logits there (a solo replay
    through ``decode_step`` on a contiguous cache, the reference's
    arithmetic), which it returns. ``traces`` (the second list's profile
    names per token; default profile 0 throughout) and ``kv_table`` (a
    precision policy) replay each token under its own profile's bits and
    KV row."""
    from repro_torch.models import transformer as T
    for i, (a, b) in enumerate(zip(spec, greedy)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        pids = ([0] * len(b) if traces is None else
                [engine.profile_names.index(p) for p in traces[i]])

        def rows(n):
            return engine.table[pids[n]], (None if kv_table is None
                                           else kv_table[pids[n]])

        tokens = torch.as_tensor(reqs[i].tokens[None], device="cuda")
        bits_row, ks = rows(0)
        logits, caches = T.prefill(params, cfg, bits_row, {"tokens": tokens},
                                   len(reqs[i].tokens) + len(b) + 1,
                                   kv_bits=bits, kv_sched=ks)
        pos = torch.tensor([tokens.shape[1]], dtype=torch.int32, device="cuda")
        for n in range(j):
            bits_row, ks = rows(n + 1)
            logits, caches = T.decode_step(
                params, cfg, bits_row, torch.tensor([[b[n]]], device="cuda"),
                pos, caches, kv_sched=ks)
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
    cfg, srv = S.build_server(args, **CARD_SERVER)
    torch.cuda.synchronize()
    k5 = AQ.aquant.launches
    n_images = len({t.data_ptr() for t in _leaves(srv.prequant)})
    print(f"[serve] built {cfg.name} ({cfg.n_layers} layers, "
          f"{sum(p.numel() for p in _leaves(srv.params)) / 1e9:.3f} B params) "
          f"with {n_images} distinct weight images in "
          f"{time.perf_counter() - t0:.1f}s; K5 launches building them: {k5}")
    if k5 == 0:
        raise AssertionError("the prequant images did not go through K5")
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
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
            "k5": k5, "tokens": [r["tokens"] for r in results]}


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
    cfg, srv = S.build_server(args, **CARD_SERVER)
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
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
    g = sched.graphs
    if g is None:
        raise AssertionError("the speculative serve did not replay its "
                             "window graphs (the card's default)")
    print(f"[spec] window graphs (the default): captures {g.captured} = "
          f"profile ids {sorted(g.used)}, {g.replays} replays of "
          f"{sched.windows_run} windows")
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
    cfg, srv = S.build_server(args, **CARD_SERVER)
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
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
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
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
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
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


def phase_contiguous_serve(seed: int, continuous: bool,
                           policy: str | None = None) -> dict:
    """The contiguous int8 cache on the launcher's config in bf16 (40
    layers in phase 7, ``FEATURE_LAYERS`` in phase 10): phase 4's 12
    requests × 32 tokens through the launcher at ``--kv-bits 8``, on the
    static path (no ``--continuous``: ``AdaptiveServer.serve``, groups of
    8 rows) or on the continuous scheduler's contiguous pool
    (``--continuous --no-paged-kv``), with ``--precision-policy policy``
    where given. Every layer of every decode step must read the cache
    through K4: n_layers × decode steps launches, K1 and the kv8 einsum
    never."""
    import gc
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A

    argv = ["--full", "--requests", "12", "--max-new", "32", "--kv-bits",
            "8", "--quantum", "8", "--seed", str(seed)]
    if continuous:
        argv += ["--continuous", "--no-paged-kv"]
    if policy:
        argv += ["--precision-policy", policy]
    args = S.parse_args(argv)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, srv = S.build_server(args, **CARD_SERVER)
    if (srv.kv_table is not None) != bool(policy):
        raise AssertionError("--precision-policy did not reach the server")
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
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
        g = sched.graphs
    else:
        n_groups = -(-len(reqs) // srv.scfg.max_batch)
        steps, label = n_groups * (args.max_new - 1), "static serve"
        g = next(iter(srv.static_graphs.values()), (None,))[0]
    if g is None:
        raise AssertionError(f"the {label} did not replay graphs (the "
                             f"card's default)")
    print(f"[contig] {label} graphs (the default): captures {g.captured}, "
          f"{g.replays} replays")
    if policy:
        label += " with the precision policy"
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


# ---------------------------------------------------------------------------
# phase 8: shared prefixes and chunked prefill through the launcher's path
# ---------------------------------------------------------------------------

def phase_prefix_serve(seed: int) -> None:
    """The launcher's ``--continuous`` path in bf16 with the prefix cache,
    at granite's widths and the launcher's depth (``FEATURE_LAYERS`` in
    ``main``; servers built by ``build_server`` and, for the other
    settings, on its params). 12 requests, each one 384-token system
    prompt (24 blocks of 16) plus a unique tail of 16–128 tokens, 32 new
    tokens each, from ``--seed``, at kv16 and kv8, with and without
    ``--no-prefix-cache`` (served with, without, without, with, so each
    setting runs first once): 11 registry hits (the first round dedups 7
    of its 8 rows), K1 launches = n_layers × decode steps, no gather, and
    at kv16 the shared blocks' bytes unchanged by the serve. Then phase 4's
    12 requests with ``--prefill-chunk 128``: every request completes."""
    import copy
    import dataclasses
    import gc
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import (AdaptiveServer, Request,
                                            RequestStatus)
    from repro_torch.serving.scheduler import ContinuousScheduler

    gc.collect()
    torch.cuda.empty_cache()
    args = S.parse_args(["--continuous", "--full", "--requests", "12",
                         "--max-new", "32", "--kv-bits", "16", "--quantum",
                         "8", "--block-size", "16", "--seed", str(seed)])
    cfg, srv = S.build_server(args, **CARD_SERVER)
    params, engine, scfg = srv.params, srv.engine, srv.scfg
    mgr0 = copy.deepcopy(srv.manager)
    rng = np.random.default_rng(seed + 8)
    system = rng.integers(0, cfg.vocab, 384).astype(np.int32)
    reqs = [Request(tokens=np.concatenate(
        [system, rng.integers(0, cfg.vocab, int(n)).astype(np.int32)]),
        max_new=32, accuracy_critical=(i % 3 == 0))
        for i, n in enumerate(rng.integers(16, 129, 12))]

    def build(**kw):
        return AdaptiveServer(cfg, params, engine,
                              dataclasses.replace(scfg, **kw),
                              manager=copy.deepcopy(mgr0), device="cuda")

    def serve(srv, reqs, label, shared=True):
        sched = ContinuousScheduler(srv, quantum=args.quantum)
        for r in reqs:
            sched.submit(r)
        PA.paged_attention.launches = A.paged_view.calls = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.step()                  # the first round: 8 rows admitted
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        snap = bids = None
        if shared and sched.registry is not None and \
                srv.scfg.kv_bits == 16:
            e = max(sched.registry._entries.values(),
                    key=lambda x: x.n_tokens)
            bids = torch.as_tensor(e.block_ids[:24], device="cuda")
            pool = sched._caches["kv"]
            snap = [getattr(pool, n)[:, bids].clone()
                    for n in ("k", "v", "token_idx")]
        while sched.step():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, gathers = PA.paged_attention.launches, A.paged_view.calls
        results = [sched.results[i] for i in range(len(reqs))]
        for i, r in enumerate(results):
            if (r["status"] is not RequestStatus.COMPLETED
                    or len(r["tokens"]) != 32
                    or not all(0 <= t < cfg.vocab for t in r["tokens"])):
                raise AssertionError(f"{label} request {i}: {r['status']}, "
                                     f"{len(r['tokens'])} tokens")
        expect = cfg.n_layers * sched.decode_steps
        if k1 != expect or k1 == 0 or gathers:
            raise AssertionError(f"{label}: K1 launches {k1} != {expect} or "
                                 f"gather calls {gathers}")
        if snap is not None:
            pool = sched._caches["kv"]
            for n, was in zip(("k", "v", "token_idx"), snap):
                if not torch.equal(getattr(pool, n)[:, bids], was):
                    raise AssertionError(f"{label}: shared blocks' {n} "
                                         f"changed")
        st = sched.paged_stats()
        n_tok = sum(len(r["tokens"]) for r in results)
        peak = torch.cuda.max_memory_allocated()
        reg = (f"registry hits {st['registry_hits']}, misses "
               f"{st['registry_misses']}, entries {st['registry_entries']} "
               f"({st['registry_bytes'] / 2**20:.1f} MiB of masters); "
               if sched.registry is not None else "no registry; ")
        print(f"[prefix] {label}: {reg}prefill tokens {sched.prefill_tokens}"
              f" of {sum(len(r.tokens) for r in reqs)} prompt tokens; "
              f"peak_used_blocks {st['peak_used_blocks']}; K1 launches {k1} "
              f"= {cfg.n_layers} x {sched.decode_steps} decode steps, gather "
              f"calls {gathers}; shared blocks unchanged: "
              f"{'checked' if snap is not None else 'n/a'}; {n_tok} tokens in "
              f"{wall:.3f}s = {n_tok / wall:.2f} tok/s (first round, its "
              f"admission waves and one segment: {t_first:.3f}s; "
              f"{sched.segments_run} segments in all); peak memory "
              f"{peak / 2**30:.2f} GiB")
        return sched, results, n_tok / wall

    for bits in (16, 8):
        if bits == 8:
            srv = build(kv_bits=8)
        srv_off = build(kv_bits=bits, prefix_cache=False)
        runs = {True: [], False: []}
        # with, without, without, with: each pair in both orders, each
        # serve on a fresh scheduler and a fresh copy of the ledger
        for cache in (True, False, False, True):
            s = srv if cache else srv_off
            s.manager = copy.deepcopy(mgr0)
            label = (f"kv{bits} prefix cache" if cache
                     else f"kv{bits} --no-prefix-cache")
            sched, res, tps = serve(s, reqs, label)
            if cache and sched.registry.hits != 11:
                raise AssertionError(f"kv{bits}: {sched.registry.hits} "
                                     f"registry hits, host arithmetic says "
                                     f"11")
            runs[cache].append((res, tps))
            del sched
        del srv, srv_off
        gc.collect()
        torch.cuda.empty_cache()
        on, off = runs[True][0][0], runs[False][0][0]
        n_same = sum(a == b for x, y in zip(on, off)
                     for a, b in zip(x["tokens"], y["tokens"]))
        n_trace = sum(x["profile_trace"] == y["profile_trace"]
                      for x, y in zip(on, off))
        tps = {c: ", ".join(f"{t:.2f}" for _, t in runs[c]) for c in runs}
        print(f"[prefix] kv{bits}: {n_same} of {32 * len(on)} tokens equal "
              f"with and without the cache, {n_trace} of {len(on)} profile "
              f"traces (information only: bf16 continuation reads, and the "
              f"first round's one wave becomes a cold and a shared wave "
              f"billed apart); tok/s with the cache {tps[True]} (first and "
              f"last serve), without {tps[False]}")
    srv = build(prefill_chunk=128)
    sched, _, _ = serve(srv, S.make_requests(cfg, args, **CARD_PROMPTS),
                        "phase 4's requests, --prefill-chunk 128",
                        shared=False)
    print(f"[prefix] --prefill-chunk {sched.chunk}: {sched.chunk_waves} "
          f"continuation waves, {sched.segments_chunking} of "
          f"{sched.segments_run} segments ran while chunks were in flight")
    if sched.chunk_waves == 0 or sched.segments_chunking == 0:
        raise AssertionError("the chunked serve did not interleave chunks")
    del srv, sched, params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# preemption: phase 3's parity at 4 layers and phase 9's full-width serve
# ---------------------------------------------------------------------------

def row_bytes(sched, slot: int, n_tok: int) -> dict:
    """Pool row ``slot``'s first ``n_tok`` positions (K, V and token_idx as
    raw bytes, read through its table), its scales and its carry."""
    kv = sched._caches["kv"]
    bs = kv.k.shape[2]
    bt = kv.block_table[0, slot, :-(-n_tok // bs)].long()

    def pos(x):
        g = x[:, bt]
        g = g.reshape(g.shape[0], -1, *g.shape[3:])[:, :n_tok]
        return g.view(torch.int16) if g.dtype == torch.bfloat16 else g.clone()

    return {"k": pos(kv.k), "v": pos(kv.v), "token_idx": pos(kv.token_idx),
            "k_scale": kv.k_scale[:, slot].clone(),
            "v_scale": kv.v_scale[:, slot].clone(),
            "tok": int(sched._tok[slot]), "pos": int(sched._pos[slot])}


def watch_restores(sched) -> dict:
    """Record each suspended row's bytes at its eviction and again right
    after its resume wave (``row_bytes``); returns ``{rid: (before,
    after)}``, filled as the serve runs."""
    seen: dict = {}
    snap_fn, resume_fn = sched._snapshot_row, sched._dispatch_resume

    def snapshot(slot):
        snap = snap_fn(slot)
        seen.setdefault(snap.rid, []).append(
            [snap.n_done, row_bytes(sched, slot, snap.n_done), None])
        return snap

    def resume(rows):
        n = resume_fn(rows)
        for rid, slot, _ in rows:
            rec = seen[rid][-1]
            rec[2] = row_bytes(sched, slot, rec[0])
        return n

    sched._snapshot_row, sched._dispatch_resume = snapshot, resume
    return seen


def restores_equal(seen: dict, first_only: bool = False) -> int:
    """Check every recorded restore (or the first) bitwise: bytes, scales,
    token_idx and carry equal the snapshot's. Returns the restores
    checked."""
    recs = [r for rid in sorted(seen) for r in seen[rid] if r[2] is not None]
    if first_only:
        recs = recs[:1]
    if not recs:
        raise AssertionError("no resume was recorded")
    for n_done, was, now in recs:
        for key, x in was.items():
            y = now[key]
            same = (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y)
            if not same:
                raise AssertionError(f"restore of a {n_done}-token row: "
                                     f"{key} differs")
    return len(recs)


def phase_preempt_parity(seed: int) -> None:
    """Preemption and contiguous speculation at full width (granite-3-2b
    widths, 4 layers, f32, TF32 off, no manager): two saver rows on a
    64-token system prompt (the second maps it copy-on-write), then a
    critical arrival on the full 2-row pool, on the kernel and gather
    backends at kv16 and kv8. The evicted row resumes bitwise (bytes,
    scales, token_idx, carry) and every saver's tokens equal the same serve
    without the critical arrival; K1 launches = 4 × decode steps. Then the
    same at kv16 with speculation (K2 = 4 × windows), and the contiguous
    pool with speculation at kv16 and kv8 against its greedy tokens (a flip
    only at a top-2 margin under 1e-3, ``first_divergence``)."""
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
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    params = T.init_params(cfg, gen, device="cuda")
    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    rng = np.random.default_rng(seed + 5)
    system = rng.integers(0, cfg.vocab, 64).astype(np.int32)
    savers = [Request(tokens=np.concatenate(
        [system, rng.integers(0, cfg.vocab, n).astype(np.int32)]),
        max_new=m, priority=1) for n, m in ((9, 24), (30, 20))]
    crit = Request(tokens=rng.integers(0, cfg.vocab, 40).astype(np.int32),
                   max_new=8, priority=0)

    def run(bits, backend, arrival, **kw):
        sched = ContinuousScheduler(AdaptiveServer(cfg, params, engine,
                                    ServingConfig(
            slots=256, kv_bits=bits, max_batch=2, block_size=16,
            priority_classes=2, preemption=True, paged_backend=backend,
            **kw), device="cuda"), quantum=4)
        seen = watch_restores(sched)
        PA.paged_attention.launches = PA.paged_attention_multi.launches = 0
        A.paged_view.calls = 0
        sched.submit(savers[0])
        sched.step()
        sched.submit(savers[1])
        sched.step()
        sched.step()
        if arrival:
            sched.submit(crit)
        while sched.step():
            pass
        k1, k2 = PA.paged_attention.launches, PA.paged_attention_multi.launches
        if backend == "kernel":
            want = (0, cfg.n_layers * sched.windows_run) if sched.spec else \
                (cfg.n_layers * sched.decode_steps, 0)
            if (k1, k2) != want or A.paged_view.calls:
                raise AssertionError(f"kv{bits} {backend}: K1/K2 launches "
                                     f"{(k1, k2)} != {want}")
        elif A.paged_view.calls == 0:
            raise AssertionError("the gather backend never ran")
        toks = [sched.results[i]["tokens"] for i in range(len(savers))]
        if sched.allocator.used_blocks or sched.preemptions != sched.resumes:
            raise AssertionError(f"kv{bits} {backend}: live blocks or "
                                 f"unresumed rows left")
        return toks, sched, seen

    with use_compute_dtype(torch.float32):
        for bits, backend, kw in [(16, "kernel", {}), (16, "gather", {}),
                                  (8, "kernel", {}), (8, "gather", {}),
                                  (16, "kernel", {"speculate": True,
                                                  "draft_k": 4})]:
            calm, _, _ = run(bits, backend, False, **kw)
            toks, sched, seen = run(bits, backend, True, **kw)
            if sched.preemptions < 1 or sched.registry.hits < 1:
                raise AssertionError(f"kv{bits} {backend}: no preemption "
                                     f"or no copy-on-write sharer")
            n = restores_equal(seen)
            same = toks == calm
            label = "speculative " if kw else ""
            print(f"[preempt] full width x4 layers, f32, kv{bits} "
                  f"{label}{backend}: {sched.preemptions} preemptions, "
                  f"{sched.resumes} resumes, {n} restores bitwise equal; "
                  f"savers' tokens equal the serve without the critical "
                  f"arrival: {same} ({sum(map(len, toks))} tokens)")
            if not same:
                raise AssertionError(f"kv{bits} {backend}{kw}: {toks} vs "
                                     f"{calm}")
        reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                        max_new=m) for n, m in
                [(17, 9), (64, 12), (33, 5), (120, 10), (8, 7), (50, 11)]]
        for bits in (16, 8):
            out = {}
            for spec in (False, True):
                sched = ContinuousScheduler(AdaptiveServer(
                    cfg, params, engine, ServingConfig(
                        slots=256, kv_bits=bits, max_batch=4,
                        paged_kv=False, speculate=spec, draft_k=4),
                    device="cuda"), quantum=4)
                for r in reqs:
                    sched.submit(r)
                out[spec] = [r["tokens"] for r in sched.run()]
            same = out[True] == out[False]
            print(f"[preempt] contiguous pool, full width x4 layers, f32, "
                  f"kv{bits}: speculative (k=4, {sched.windows_run} windows) "
                  f"vs greedy tokens identical: {same}")
            if not same:
                margin = first_divergence(cfg, params, engine, reqs,
                                          out[True], out[False], bits)
                if not margin < 1e-3:
                    raise AssertionError(f"contiguous kv{bits} speculation "
                                         f"diverges at a top-2 margin of "
                                         f"{margin:.3e}")
    del params
    torch.cuda.empty_cache()


def phase_contiguous_spec_serve(seed: int) -> dict:
    """The launcher's ``--continuous --no-paged-kv --speculate --draft-k 4``
    path at ``--kv-bits 8`` on the full config in bf16: phase 4's 12
    requests × 32 tokens. The verify windows attend through the plain
    window attention (no Pallas kernel lies there in the reference either),
    so K1, K2 and K4 launch never; billed tokens equal delivered ones."""
    import gc
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.launch import serve as S

    args = S.parse_args(["--full", "--requests", "12", "--max-new", "32",
                         "--kv-bits", "8", "--quantum", "8", "--continuous",
                         "--no-paged-kv", "--speculate", "--draft-k", "4",
                         "--seed", str(seed)])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, srv = S.build_server(args, **CARD_SERVER)
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
    QK.qkv_attention.launches = PA.paged_attention.launches = 0
    PA.paged_attention_multi.launches = 0
    out = S.serve(srv, reqs, args.quantum, continuous=True)
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    launched = (PA.paged_attention.launches, PA.paged_attention_multi.launches,
                QK.qkv_attention.launches)
    for i, r in enumerate(results):
        if len(r["tokens"]) != 32 or r["status"].value != "completed" or \
                not all(0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"contiguous spec request {i}")
    n_tok = sum(len(r["tokens"]) for r in results)
    billed = len(sched.admission_log) + sum(n for _, n in sched.spec_billed)
    print(f"[contig] contiguous pool kv8, --speculate --draft-k 4: "
          f"{sched.windows_run} windows, tokens billed {billed} = delivered "
          f"{n_tok}: {billed == n_tok}; K1/K2/K4 launches {launched}; "
          f"{n_tok} tokens in {wall:.3f}s = {n_tok / wall:.2f} tok/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if sched.paged or billed != n_tok or any(launched) or \
            sched.windows_run == 0 or sched.graphs is None:
        raise AssertionError("the contiguous speculative serve went wrong")
    del srv, out
    return {"tok_s": n_tok / wall}


def phase_preempt_serve(seed: int) -> None:
    """Priority classes and preemption at full width: granite-3-2b's
    widths at the launcher's depth (``FEATURE_LAYERS`` in ``main``), bf16,
    ``slots=1024``, ``max_batch=8``, ``block_size=16``, quantum 8,
    ``--priority-classes 2 --preemption`` (servers on the launcher's params
    and manager). 8 saver requests (prompts 64–512 tokens from seed 9, 32
    new tokens) fill the pool; after 2 rounds 4 critical requests arrive
    (prompts 64–256, 16 new tokens). Run at kv16 and kv8 under slot
    pressure, and at kv16 under block pressure (12 rows, so a slot stays
    free, and ``pool_blocks`` just covering the 8 savers). Each
    serve: ``preemptions == resumes >= 1``, every request completes with
    ``max_new`` tokens, billed inferences = delivered tokens, the first
    resume's bytes and scales bitwise equal to its eviction snapshot, K1 =
    n_layers × decode steps. Printed: tok/s, peak blocks, the rounds from
    each critical submission to its admission and to its first token on the
    host, and the savers' tokens that agree with a serve without the
    critical arrivals (a count: bf16 at full width is not held to token
    identity)."""
    import copy
    import dataclasses
    import gc
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import (AdaptiveServer, Request,
                                            RequestStatus)
    from repro_torch.serving.scheduler import ContinuousScheduler

    gc.collect()
    torch.cuda.empty_cache()
    args = S.parse_args(["--continuous", "--full", "--kv-bits", "16",
                         "--quantum", "8", "--block-size", "16",
                         "--priority-classes", "2", "--preemption",
                         "--seed", str(seed)])
    cfg, srv = S.build_server(args, **CARD_SERVER)
    params, engine, scfg = srv.params, srv.engine, srv.scfg
    mgr0 = copy.deepcopy(srv.manager)
    del srv
    rng = np.random.default_rng(9)
    savers = [Request(tokens=rng.integers(0, cfg.vocab, int(n))
                      .astype(np.int32), max_new=32, priority=1)
              for n in rng.integers(64, 513, 8)]
    crits = [Request(tokens=rng.integers(0, cfg.vocab, int(n))
                     .astype(np.int32), max_new=16, priority=0)
             for n in rng.integers(64, 257, 4)]
    bs = scfg.block_size
    saver_blocks = sum(-(-(len(r.tokens) + r.max_new) // bs) for r in savers)

    def serve(label, arrival, **kw):
        srv = AdaptiveServer(cfg, params, engine,
                             dataclasses.replace(scfg, **kw),
                             manager=copy.deepcopy(mgr0), device="cuda")
        sched = ContinuousScheduler(srv, quantum=args.quantum)
        seen = watch_restores(sched)
        for r in savers:
            sched.submit(r)
        PA.paged_attention.launches = A.paged_view.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rnd, c_rids, first = 0, [], {}
        more = True
        while more:
            if arrival and rnd == 2:
                c_rids = [sched.submit(r) for r in crits]
            more = sched.step()
            rnd += 1
            for rid in c_rids:
                if rid not in first and sched.results.get(rid, {}).get(
                        "tokens"):
                    first[rid] = rnd - 2
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = PA.paged_attention.launches
        allreq = savers + (crits if arrival else [])
        results = [sched.results[i] for i in range(len(allreq))]
        for i, (r, req) in enumerate(zip(results, allreq)):
            if r["status"] is not RequestStatus.COMPLETED or \
                    len(r["tokens"]) != req.max_new or \
                    not all(0 <= t < cfg.vocab for t in r["tokens"]):
                raise AssertionError(f"{label} request {i}: {r['status']}, "
                                     f"{len(r['tokens'])} tokens")
        n_tok = sum(len(r["tokens"]) for r in results)
        billed = sum(n for _, n, _ in sched.events)
        expect = cfg.n_layers * sched.decode_steps
        if billed != n_tok or k1 != expect or A.paged_view.calls:
            raise AssertionError(f"{label}: billed {billed} vs delivered "
                                 f"{n_tok}, K1 {k1} vs {expect}")
        st = sched.paged_stats()
        line = (f"[preempt] {label}: {n_tok} tokens in {wall:.3f}s = "
                f"{n_tok / wall:.2f} tok/s; peak_used_blocks "
                f"{st['peak_used_blocks']} of {st['pool_blocks']}; "
                f"preemptions {sched.preemptions}, resumes {sched.resumes}; "
                f"K1 launches {k1} = {cfg.n_layers} x {sched.decode_steps} "
                f"decode steps; billed {billed} = delivered {n_tok}")
        if arrival:
            if sched.preemptions < 1 or sched.preemptions != sched.resumes:
                raise AssertionError(f"{label}: {sched.preemptions} "
                                     f"preemptions, {sched.resumes} resumes")
            restores_equal(seen, first_only=True)
            adm = [sched.admission_log.index(r) for r in c_rids]
            line += (f"; first resume bitwise equal to its eviction "
                     f"snapshot; critical rounds to first token on the host "
                     f"{[first[r] for r in c_rids]} (admission order "
                     f"positions {adm})")
        print(line)
        del srv
        return [r["tokens"] for r in results[:len(savers)]], sched

    runs = [("kv16, slot pressure", {}), ("kv8, slot pressure",
                                          {"kv_bits": 8}),
            ("kv16, block pressure", {"max_batch": 12,
                                      "pool_blocks": saver_blocks})]
    for label, kw in runs:
        toks, sched = serve(label, True, **kw)
        calm, _ = serve(label + ", no critical arrivals", False, **kw)
        n_same = sum(a == b for x, y in zip(toks, calm)
                     for a, b in zip(x, y))
        print(f"[preempt] {label}: {n_same} of {32 * len(savers)} saver "
              f"tokens equal the serve without the critical arrivals "
              f"(information only)")
        del sched
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# phase 10: the per-layer KV precision policy
# ---------------------------------------------------------------------------

STRIPE = (4, 8, 16)


def striped_row(n_layers: int) -> tuple:
    return tuple(STRIPE[l % 3] for l in range(n_layers))


def policy_json(n_layers: int) -> str:
    """A striped ``n_layers`` schedule in the frontier's JSON format,
    written under ``build/`` (not searched: ``score`` is null)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import precision_frontier as F
    cfg = get_config("granite-3-2b")
    row = list(striped_row(n_layers))
    all16 = F.kv_bytes_per_token(cfg, [16] * n_layers)
    out = {"arch": "granite-3-2b", "n_layers": n_layers, "max_drop": None,
           "schedule": row, "score": None,
           "bytes_per_token": F.kv_bytes_per_token(cfg, row),
           "bytes_per_token_all16": all16,
           "frontier": [{"schedule": [16] * n_layers, "score": 0.0,
                         "bytes": all16}]}
    path = Path(__file__).resolve().parent / "build" / "policy_striped.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))
    return str(path)


def phase_policy_parity(seed: int) -> None:
    """Phase 10 (a), at granite-3-2b widths, 4 layers, f32, TF32 off:
    profile 0 keeps the all-16 row, profiles 1–5 ride a striped row (4, 8,
    16, 4), and a manager with a 12-inference budget moves the serve into
    the saver profiles. Phase 3's requests through the continuous
    scheduler at kv16, kv8 and kv4: the kernel backend's tokens equal the
    gather backend's (K1 = 4 × decode steps; the saver profiles' A4
    activations put logits on a coarse grid, so a flip is allowed only
    where the gather run's top-2 logits lie under 1e-3 apart, as for K4
    below), the all-16 policy gives the tokens of no policy, and the
    striped policy changes at least one stream. Static ``serve`` at kv8 under the policy: K4's tokens equal
    the einsum's (a flip only at a top-2 margin under 1e-3). Then the
    frontier search on the card."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.manager import ProfileManager
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.launch import precision_frontier as F
    from repro_torch.launch import serve as S
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
    profs = paper_profiles(names)
    engine = AdaptiveEngine(tuple(profs), QuantIndex(names))
    stats = S.profile_stats(cfg, profs, T.param_count(params))
    mgr0 = ProfileManager(stats, accuracy_target=0.985, accuracy_floor=0.95,
                          budget_j=stats[0].energy_j * 12, low_energy=0.5)
    row = striped_row(cfg.n_layers)
    n_prof = len(profs)
    policies = {"striped": ((16,) * cfg.n_layers,) + (row,) * (n_prof - 1),
                "all-16": ((16,) * cfg.n_layers,) * n_prof, "none": None}
    rng = np.random.default_rng(seed)
    cases = [(17, 9), (64, 12), (33, 5), (120, 10), (8, 7), (96, 1), (50, 11)]
    reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new=m) for n, m in cases]
    changed = 0
    with use_compute_dtype(torch.float32):
        for bits in (16, 8, 4):
            out = {}
            for label, backend in (("striped", "kernel"),
                                   ("striped", "gather"),
                                   ("all-16", "kernel"), ("none", "kernel")):
                srv = AdaptiveServer(cfg, params, engine, ServingConfig(
                    slots=256, kv_bits=bits, max_batch=4, block_size=16,
                    paged_backend=backend,
                    precision_policy=policies[label]),
                    manager=copy.deepcopy(mgr0), device="cuda")
                PA.paged_attention.launches = A.paged_view.calls = 0
                sched = ContinuousScheduler(srv, quantum=4)
                for r in reqs:
                    sched.submit(r)
                res = sched.run()
                k1, views = PA.paged_attention.launches, A.paged_view.calls
                if backend == "kernel" and (
                        k1 != cfg.n_layers * sched.decode_steps or views):
                    raise AssertionError(f"kv{bits} {label}: K1 {k1} for "
                                         f"{sched.decode_steps} steps")
                if backend == "gather" and (k1 or not views):
                    raise AssertionError(f"kv{bits} {label}: gather unused")
                saver = {p for r in res for p in r["profile_trace"]} - \
                    {engine.profile_names[0]}
                if not saver:
                    raise AssertionError("the serve never left profile 0")
                out[(label, backend)] = [r["tokens"] for r in res]
                if (label, backend) == ("striped", "gather"):
                    traces = [r["profile_trace"] for r in res]
                del srv, sched
            same = out[("striped", "kernel")] == out[("striped", "gather")]
            margin = float("inf") if same else first_divergence(
                cfg, params, engine, reqs, out[("striped", "kernel")],
                out[("striped", "gather")], bits, traces=traces,
                kv_table=np.asarray(policies["striped"]))
            passthrough = out[("all-16", "kernel")] == out[("none", "kernel")]
            moved = sum(a != b for a, b in zip(out[("striped", "kernel")],
                                               out[("none", "kernel")]))
            changed += moved
            print(f"[policy] full width x4 layers, f32, kv{bits}, striped "
                  f"row {row} on profiles 1-5: kernel vs gather tokens "
                  f"identical: {same}; all-16 policy = no policy: "
                  f"{passthrough}; streams the striped row changed: {moved} "
                  f"of {len(reqs)}")
            if not (margin < 1e-3 or same) or not passthrough:
                raise AssertionError(f"kv{bits}: {out}")
        if not changed:
            raise AssertionError("the striped policy changed no stream")
        res = {}
        for backend in ("kernel", "gather"):
            srv = AdaptiveServer(cfg, params, engine, ServingConfig(
                slots=256, kv_bits=8, max_batch=4, paged_backend=backend,
                precision_policy=policies["striped"]),
                manager=copy.deepcopy(mgr0), device="cuda")
            QK.qkv_attention.launches = A.decode_attention.kv8_einsum_calls = 0
            res[backend] = srv.serve(reqs)
            used = (QK.qkv_attention.launches,
                    A.decode_attention.kv8_einsum_calls)
            if (used[0] > 0) != (backend == "kernel") or \
                    (used[1] > 0) != (backend == "gather"):
                raise AssertionError(f"static {backend}: reads {used}")
            del srv
        toks = {b: [r["tokens"] for r in v] for b, v in res.items()}
        same = toks["kernel"] == toks["gather"]
        print(f"[policy] static serve kv8 under the striped policy: K4 vs "
              f"einsum greedy tokens identical: {same} "
              f"({sum(map(len, toks['kernel']))} tokens)")
        if not same:
            margin = first_divergence(
                cfg, params, engine, reqs, toks["kernel"], toks["gather"], 8,
                traces=[r["profile_trace"] for r in res["gather"]],
                kv_table=np.asarray(policies["striped"]))
            if not margin < 1e-3:
                raise AssertionError(f"static kv8 policy: K4 tokens diverge "
                                     f"at a top-2 margin of {margin:.3e}")
        QK.qkv_attention.launches = A.decode_attention.kv8_einsum_calls = 0
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    front = F.search("granite-3-2b", 0.05, full=True, seed=seed,
                     device="cuda", n_layers=4)
    torch.cuda.synchronize()
    print(f"[policy] frontier search on the card (granite-3-2b widths, 4 "
          f"layers, f32 probe of 4 x 12 tokens, max-drop 0.05): schedule "
          f"{front['schedule']}, score {front['score']:.5f}, bytes/token "
          f"{front['bytes_per_token']:.0f} of "
          f"{front['bytes_per_token_all16']:.0f}, frontier length "
          f"{len(front['frontier'])}, {time.perf_counter() - t0:.2f}s")
    if sorted(front) != sorted(["arch", "n_layers", "max_drop", "schedule",
                                "score", "bytes_per_token", "frontier",
                                "bytes_per_token_all16"]) or \
            len(front["schedule"]) != 4:
        raise AssertionError(f"frontier payload: {front}")


def phase_policy_serve(seed: int, path: str) -> dict:
    """Phase 10 (b): the launcher's ``--continuous --precision-policy``
    path in bf16 at granite's widths and the launcher's depth
    (``FEATURE_LAYERS`` in ``main``), phase 4's 12 requests × 32 tokens,
    the policy a striped row of that depth for profiles 1–5 read from
    the frontier-format JSON ``path``. Served twice with the policy (the
    launcher's server) and twice without it (a server on the same weights
    and manager settings), in the order policy, none, none, policy: K1 =
    n_layers × decode steps and billed = delivered in each; tok/s and peak
    memory side by side. Then the refine's own cost: one ``kv_refine``
    call at a decode step's K shape, per call (CUDA events around eager
    calls) and on the device (a CUDA graph)."""
    import copy
    import dataclasses
    import gc
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import AdaptiveServer, RequestStatus

    gc.collect()
    torch.cuda.empty_cache()
    args = S.parse_args(["--continuous", "--full", "--requests", "12",
                         "--max-new", "32", "--kv-bits", "16",
                         "--quantum", "8", "--block-size", "16",
                         "--seed", str(seed), "--precision-policy", path])
    cfg, srv = S.build_server(args, **CARD_SERVER)
    if srv.kv_table is None or \
            srv.kv_table[0].tolist() != [16] * cfg.n_layers or \
            srv.kv_table[1].tolist() != list(striped_row(cfg.n_layers)):
        raise AssertionError("the launcher did not bind the policy rows")
    params, engine, scfg = srv.params, srv.engine, srv.scfg
    mgr0 = copy.deepcopy(srv.manager)
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
    out = {"policy": [], "none": []}
    for i, label in enumerate(("policy", "none", "none", "policy")):
        if i:                       # the launcher's server serves first
            srv = AdaptiveServer(cfg, params, engine, dataclasses.replace(
                scfg, precision_policy=(scfg.precision_policy
                                        if label == "policy" else None)),
                manager=copy.deepcopy(mgr0), device="cuda")
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        PA.paged_attention.launches = A.paged_view.calls = 0
        res = S.serve(srv, reqs, args.quantum, continuous=True)
        k1, views = PA.paged_attention.launches, A.paged_view.calls
        results, sched, wall = res["results"], res["sched"], res["wall_s"]
        for i, r in enumerate(results):
            if r["status"] is not RequestStatus.COMPLETED or \
                    len(r["tokens"]) != 32 or \
                    not all(0 <= t < cfg.vocab for t in r["tokens"]):
                raise AssertionError(f"{label} request {i}: {r['status']}")
        n_tok = sum(len(r["tokens"]) for r in results)
        billed = sum(n for _, n, _ in sched.events)
        expect = cfg.n_layers * sched.decode_steps
        if k1 != expect or views or billed != n_tok:
            raise AssertionError(f"{label}: K1 {k1} vs {expect}, gathers "
                                 f"{views}, billed {billed} vs {n_tok}")
        peak = torch.cuda.max_memory_allocated()
        saver = sum(p != engine.profile_names[0]
                    for r in results for p in r["profile_trace"])
        print(f"[policy] serve {label}: {n_tok} tokens in {wall:.3f}s = "
              f"{n_tok / wall:.2f} tok/s; K1 launches {k1} = "
              f"{cfg.n_layers} x {sched.decode_steps} decode steps; billed "
              f"{billed} = delivered {n_tok}; tokens under profiles 1-5: "
              f"{saver}; peak_used_blocks "
              f"{sched.paged_stats()['peak_used_blocks']}; peak memory "
              f"{peak / 2**30:.2f} GiB")
        out[label].append({"tok_s": n_tok / wall, "peak": peak, "k1": k1,
                           "tokens": [r["tokens"] for r in results]})
        del srv, sched, res
    same = sum(a == b for x, y in zip(out["policy"][0]["tokens"],
                                      out["none"][0]["tokens"])
               for a, b in zip(x, y))
    print(f"[policy] tokens equal with and without the policy: {same} of "
          f"{12 * 32} (information only: bf16 at {cfg.n_layers} layers)")
    k = torch.randn(8, 1, 8, 64, device="cuda").bfloat16()
    per_call = cuda_time_ms(lambda: A.kv_refine(k, 8))
    device = graph_ms(lambda: A.kv_refine(k, 8))
    refined = sum(b < 16 for b in striped_row(cfg.n_layers))
    print(f"[policy] kv_refine at a decode step's K [8, 1, 8, 64] bf16: "
          f"{per_call:.4f} ms per call, {device:.4f} ms on the device; "
          f"2 x {refined} refined layers per step = "
          f"{2 * refined * per_call:.2f} ms per decode step")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": out["policy"][0]["k1"]}



# ---------------------------------------------------------------------------
# phase 11: fault-tolerant serving
# ---------------------------------------------------------------------------

FAULT_KEYS = ("cancelled", "expired", "shed", "failed", "recovered",
              "faults_detected", "alloc_injected_rounds", "watchdog_stalls",
              "injected_nan", "injected_alloc", "injected_stall")


def fault_scenario(cfg, sched, Request, box) -> list:
    """Phase 11 (a)'s scenario on ``sched`` (its clock reads ``box``), on
    a 6-row pool: 0 plain; 1 a recoverable NaN (attempt 0); 2 a NaN on
    every attempt; 3 registers a 48-token system prompt that 4 maps
    copy-on-write in the same round (intra-wave dedup); 5 carries a 5 s
    deadline; 6 is cancelled while queued. 4 is cancelled live after
    round 2, the clock jumps past 5's deadline after round 3, and the
    scheduler drains. Returns the requests."""
    rng = np.random.default_rng(11)
    sys_p = rng.integers(0, cfg.vocab, 48).astype(np.int32)

    def rand(n):
        return rng.integers(0, cfg.vocab, n).astype(np.int32)

    reqs = [Request(tokens=rand(17), max_new=9),
            Request(tokens=rand(33), max_new=10),
            Request(tokens=rand(20), max_new=8),
            Request(tokens=np.concatenate([sys_p, rand(5)]), max_new=12),
            Request(tokens=np.concatenate([sys_p, rand(9)]), max_new=30),
            Request(tokens=rand(12), max_new=40, deadline_ms=5000.0),
            Request(tokens=rand(8), max_new=5)]
    for r in reqs:
        sched.submit(r)
    if not sched.cancel(6):
        raise AssertionError("the queued request did not cancel")
    sched.step()
    sched.step()
    if not sched.cancel(4):
        raise AssertionError("the live sharer did not cancel")
    sched.step()
    box[0] = 10.0
    while sched.step():
        pass
    return reqs


def phase_fault_parity(seed: int) -> dict:
    """Phase 11 (a), at granite-3-2b widths, 4 layers, f32, TF32 off, no
    manager: :func:`fault_scenario` under a ``FaultSchedule`` (``nan_at``
    {1: (0,), 2: (0, 1, 2)}, a dry allocator in round 4, a 50 ms stall at
    flush 3), ``retry_budget=2``, ``watchdog_s=0.02``, ``paranoid=True``
    and a virtual clock that advances by each injected stall (so the
    watchdog flags exactly that round). Run through the kernel and the
    gather backends on the paged pool at kv16, kv8 and kv4, on the
    contiguous kv8 pool (K4 against the einsum) and speculatively at kv16
    (K2). Each run: the expected statuses, 4 faults detected, request 1
    retried once and request 2 three times, one watchdog stall, the
    kernel's launches per step (or its absence on the other backend) and
    0 used blocks at drain. Within each pair: statuses, reasons, retries,
    traces, billing events, decode steps (windows) and the robustness
    counters equal, and the tokens equal (K4 may flip one only under a
    1e-3 top-2 margin, as in phase 3); the recovered request's tokens
    equal a clean ``accuracy_critical=True`` run's. Returns the kernel
    runs' K2 and K4 launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import (AdaptiveServer, Request,
                                            ServingConfig)
    from repro_torch.serving.faults import FaultSchedule
    from repro_torch.serving.scheduler import ContinuousScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=4)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, device="cuda")
    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    want = ["completed", "completed", "failed", "completed", "cancelled",
            "expired", "cancelled"]
    variants = [("paged kv16", dict(kv_bits=16)),
                ("paged kv8", dict(kv_bits=8)),
                ("paged kv4", dict(kv_bits=4)),
                ("contiguous kv8", dict(kv_bits=8, paged_kv=False)),
                ("speculative kv16", dict(kv_bits=16, speculate=True,
                                          draft_k=4))]
    launches = {"k2": 0, "k4": 0}

    def reset():
        PA.paged_attention.launches = 0
        PA.paged_attention_multi.launches = 0
        QK.qkv_attention.launches = 0
        A.paged_view.calls = 0
        A.decode_attention.kv8_einsum_calls = 0

    with use_compute_dtype(torch.float32):
        for label, kw in variants:
            scfg = dict(slots=256, max_batch=6, block_size=16, **kw)
            spec = bool(kw.get("speculate"))
            runs = {}
            for backend in ("kernel", "gather"):
                srv = AdaptiveServer(cfg, params, engine, ServingConfig(
                    paged_backend=backend, **scfg), device="cuda")
                box = [0.0]
                faults = FaultSchedule(nan_at={1: (0,), 2: (0, 1, 2)},
                                       alloc_at=(4,), stall_at=(3,),
                                       stall_s=0.05)
                sched = ContinuousScheduler(
                    srv, quantum=4, faults=faults, retry_budget=2,
                    watchdog_s=0.02, paranoid=True,
                    clock=lambda b=box, f=faults:
                        b[0] + f.injected_stall * f.stall_s)
                reset()
                reqs = fault_scenario(cfg, sched, Request, box)
                k1, k2, k4 = (PA.paged_attention.launches,
                              PA.paged_attention_multi.launches,
                              QK.qkv_attention.launches)
                views = A.paged_view.calls
                einsum = A.decode_attention.kv8_einsum_calls
                res = [sched.results[i] for i in range(7)]
                got = [r["status"].value for r in res]
                stats = sched.robustness_stats()
                if got != want or stats["watchdog_stalls"] != 1 or \
                        stats["faults_detected"] != 4 or \
                        res[1].get("retries") != 1 or \
                        res[2].get("retries") != 3 or \
                        res[2]["reason"] != "retry budget exhausted" or \
                        res[2]["tokens"]:
                    raise AssertionError(f"{label} {backend}: {got}, "
                                         f"{stats}")
                paged = sched.paged
                if paged:
                    sched.check()
                    if sched.allocator.used_blocks:
                        raise AssertionError(
                            f"{label} {backend}: "
                            f"{sched.allocator.used_blocks} blocks left")
                kern = backend == "kernel"
                per_step = cfg.n_layers * sched.decode_steps
                reads = {"K1": k1 == (per_step if kern and paged
                                      and not spec else 0),
                         "K2": (k2 > 0) == (kern and paged and spec),
                         "K4": k4 == (per_step if kern and not paged else 0),
                         "gather": (views > 0) == (not kern and paged),
                         "einsum": (einsum == 0 if kern
                                    else paged or einsum > 0)}
                if not all(reads.values()):
                    raise AssertionError(f"{label} {backend}: reads {reads}:"
                                         f" {k1} {k2} {k4} {views} {einsum}")
                if kern and spec:
                    launches["k2"] = k2
                if kern and not paged:
                    launches["k4"] = k4
                runs[backend] = {
                    "status": got, "tokens": [r["tokens"] for r in res],
                    "traces": [r["profile_trace"] for r in res],
                    "retries": [r.get("retries") for r in res],
                    "reasons": [r.get("reason") for r in res],
                    "events": list(sched.events),
                    "stats": {k: stats.get(k) for k in FAULT_KEYS},
                    "steps": (sched.windows_run if spec
                              else sched.decode_steps),
                    "k": (k1, k2, k4)}
                del srv, sched
            srv = AdaptiveServer(cfg, params, engine, ServingConfig(
                paged_backend="kernel", **scfg), device="cuda")
            clean = ContinuousScheduler(srv, quantum=4)
            crid = clean.submit(Request(tokens=reqs[1].tokens, max_new=10,
                                        accuracy_critical=True))
            clean_tok = clean.run()[crid]["tokens"]
            del srv, clean
            a, b = runs["kernel"], runs["gather"]
            same = {k: a[k] == b[k] for k in a if k != "k"}
            recovered = a["tokens"][1] == clean_tok
            unit = "windows" if spec else "decode steps"
            print(f"[faults] full width x4 layers, f32, {label}: statuses "
                  f"{a['status']}, retries {a['retries'][1]}/"
                  f"{a['retries'][2]}, counters {a['stats']}; kernel vs "
                  f"gather equal: {same}; recovered tokens = clean critical "
                  f"run: {recovered}; {a['steps']} {unit}, kernel launches "
                  f"K1/K2/K4 {a['k']}")
            if not all(v for k, v in same.items() if k != "tokens") or \
                    not recovered:
                raise AssertionError(f"{label}: {same}")
            if not same["tokens"]:
                if paged:
                    raise AssertionError(f"{label}: {a['tokens']} vs "
                                         f"{b['tokens']}")
                margin = first_divergence(cfg, params, engine, reqs,
                                          a["tokens"], b["tokens"], 8)
                if not margin < 1e-3:
                    raise AssertionError(f"{label}: K4 tokens diverge at a "
                                         f"top-2 margin of {margin:.3e}")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_fault_serve(seed: int) -> dict:
    """Phase 11 (b), at granite's widths and the launcher's depth
    (``FEATURE_LAYERS`` in ``main``), bf16, kv16: phase 4's
    12 requests × 32 tokens through the launcher's ``--continuous
    --inject-faults --paranoid`` path, beside the same serve without the
    flags, in the order plain, faults, faults, plain (the manager reset to
    the launcher's before each). Each faulted serve: ``faults_detected ==
    injected_nan``, every request completed with 32 tokens or failed with
    none, delivered = 32 × (12 − failed), K1 = n_layers × decode steps, 0
    used blocks; printed with the counters, tok/s and the paranoid audit's host
    ms per step. Each plain serve: billed = delivered = 384. Then a
    direct ``ContinuousScheduler`` on the same server with a virtual
    clock and ``ShedPolicy(max_queue=8)`` over the 12 submissions (the
    last 4 shed), one live cancel after round 2 and request 5's 5 s
    deadline passed after round 3: billed = delivered (nothing is
    discarded without a quarantine), K1 = n_layers × decode steps, the
    pool back to 0 used blocks. Returns a faulted serve's K1 launches."""
    import copy
    import dataclasses
    import gc
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import RequestStatus
    from repro_torch.serving.policy import ShedPolicy
    from repro_torch.serving.scheduler import ContinuousScheduler

    gc.collect()
    torch.cuda.empty_cache()
    base = ["--continuous", "--full", "--requests", "12", "--max-new", "32",
            "--kv-bits", "16", "--quantum", "8", "--block-size", "16",
            "--seed", str(seed)]
    flags = {"plain": S.parse_args(base),
             "faults": S.parse_args(base + ["--inject-faults",
                                            "--paranoid"])}
    cfg, srv = S.build_server(flags["faults"], **CARD_SERVER)
    mgr0 = copy.deepcopy(srv.manager)
    reqs = S.make_requests(cfg, flags["plain"], **CARD_PROMPTS)
    audit: list = []
    check = ContinuousScheduler.check

    def timed_check(self):
        t0 = time.perf_counter()
        check(self)
        audit.append(time.perf_counter() - t0)

    k1_faults = 0
    for label in ("plain", "faults", "faults", "plain"):
        args = flags[label]
        srv.manager = copy.deepcopy(mgr0)
        PA.paged_attention.launches = A.paged_view.calls = 0
        n_audit = len(audit)
        ContinuousScheduler.check = timed_check
        try:
            out = S.serve(srv, reqs, args.quantum, continuous=True,
                          sched_kw=S.scheduler_kwargs(args))
        finally:
            ContinuousScheduler.check = check
        k1, views = PA.paged_attention.launches, A.paged_view.calls
        results, sched, wall = out["results"], out["sched"], out["wall_s"]
        rs = sched.robustness_stats()
        failed = [i for i, r in enumerate(results)
                  if r["status"] is RequestStatus.FAILED]
        for i, r in enumerate(results):
            n = 0 if i in failed else 32
            if r["status"] not in (RequestStatus.COMPLETED,
                                   RequestStatus.FAILED) or \
                    len(r["tokens"]) != n or \
                    not all(0 <= t < cfg.vocab for t in r["tokens"]):
                raise AssertionError(f"{label} request {i}: {r['status']}")
        n_tok = sum(len(r["tokens"]) for r in results)
        billed = sum(n for _, n, _ in sched.events)
        expect = cfg.n_layers * sched.decode_steps
        sched.check()
        if k1 != expect or views or n_tok != 32 * (12 - len(failed)) or \
                sched.allocator.used_blocks:
            raise AssertionError(f"{label}: K1 {k1} vs {expect}, gathers "
                                 f"{views}, delivered {n_tok}")
        line = (f"[faults] serve {label}: {n_tok} tokens in {wall:.3f}s = "
                f"{n_tok / wall:.2f} tok/s; {sched.decode_steps} decode "
                f"steps, K1 launches {k1} = {cfg.n_layers} x "
                f"{sched.decode_steps}; billed {billed}, delivered {n_tok}")
        if label == "plain":
            if billed != n_tok or n_tok != 384:
                raise AssertionError(f"plain: billed {billed} vs {n_tok}")
            print(line)
            continue
        if rs["faults_detected"] != rs["injected_nan"] or \
                rs["faults_detected"] == 0 or \
                rs["alloc_injected_rounds"] != 1:
            raise AssertionError(f"faults: {rs}")
        k1_faults = k1
        spent = audit[n_audit:]
        print(f"{line}; faults_detected {rs['faults_detected']} = "
              f"injected_nan {rs['injected_nan']}, recovered "
              f"{rs['recovered']}, failed {rs['failed']}, "
              f"alloc_injected_rounds {rs['alloc_injected_rounds']}, "
              f"retried requests {[i for i, r in enumerate(results) if r.get('retries')]}; "
              f"paranoid audit {1e3 * sum(spent) / len(spent):.4f} ms of "
              f"host per step over {len(spent)} steps")
        del out, sched
    srv.manager = copy.deepcopy(mgr0)
    box = [0.0]
    sched = ContinuousScheduler(srv, quantum=8, shed=ShedPolicy(max_queue=8),
                                clock=lambda: box[0], paranoid=True)
    PA.paged_attention.launches = 0
    for i, r in enumerate(reqs):
        sched.submit(dataclasses.replace(r, deadline_ms=5000.0) if i == 5
                     else r)
    sched.step()
    sched.step()
    if not sched.cancel(2):
        raise AssertionError("request 2 did not cancel")
    sched.step()
    box[0] = 10.0
    while sched.step():
        pass
    k1 = PA.paged_attention.launches
    got = [sched.results[i]["status"].value for i in range(12)]
    want = (["completed"] * 2 + ["cancelled"] + ["completed"] * 2
            + ["expired"] + ["completed"] * 2 + ["shed"] * 4)
    n_tok = sum(len(r["tokens"]) for r in sched.results.values())
    billed = sum(n for _, n, _ in sched.events)
    rs = sched.robustness_stats()
    sched.check()
    print(f"[faults] direct serve, ShedPolicy(max_queue=8), one cancel, one "
          f"deadline: statuses {got}; delivered "
          f"{[len(sched.results[i]['tokens']) for i in range(12)]}; billed "
          f"{billed} = delivered {n_tok}: {billed == n_tok}; K1 {k1} = "
          f"{cfg.n_layers} x {sched.decode_steps}; used blocks "
          f"{sched.allocator.used_blocks}; counters "
          f"{ {k: rs[k] for k in ('cancelled', 'expired', 'shed')} }")
    if got != want or billed != n_tok or sched.allocator.used_blocks or \
            k1 != cfg.n_layers * sched.decode_steps:
        raise AssertionError("the direct fault-tolerant serve")
    del srv, sched
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": k1_faults}


# ---------------------------------------------------------------------------
# phase 12: crash-consistent serving
# ---------------------------------------------------------------------------

DURABLE_DIR = Path(__file__).resolve().parent / "build" / "durable"
DURABLE_BASE = dict(slots=64, max_batch=4, block_size=8, pool_blocks=64,
                    priority_classes=2)
DURABLE_CONFIGS = {"kv16-spec": dict(speculate=True, draft_k=2),
                   "kv8-chunked": dict(kv_bits=8, prefill_chunk=16)}


def durable_workload(cfg, Request, seed: int = 0) -> list:
    """Phase 12 (a)'s workload (the reference's durability test's): two
    classes, a 16-token system prefix two block-aligned prompts share
    copy-on-write, and a 40-token prompt that chunks at 16."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, cfg.vocab, 16).astype(np.int32)

    def mk(n):
        return rng.integers(0, cfg.vocab, n).astype(np.int32)

    return [Request(tokens=np.concatenate([sys_p, mk(5)]), max_new=6,
                    priority=1),
            Request(tokens=np.concatenate([sys_p, mk(7)]), max_new=5,
                    priority=0),
            Request(tokens=mk(40), max_new=4, priority=1),
            Request(tokens=mk(6), max_new=8, priority=0),
            Request(tokens=mk(9), max_new=6, priority=1),
            Request(tokens=mk(5), max_new=4, priority=0)]


def durable_pattern(sched, reqs, stop_after=None) -> int:
    """Four requests up front, the rest after round 1; stops after
    ``stop_after`` rounds (the crash). Returns the rounds stepped."""
    for r in reqs[:4]:
        sched.submit(r)
    steps = 0
    while stop_after is None or steps < stop_after:
        more = sched.step()
        steps += 1
        if steps == 1 and len(reqs) > 4:
            for r in reqs[4:]:
                sched.submit(r)
            more = True
        if not more:
            break
    return steps


def durable_finish(sched, reqs) -> None:
    """Run a recovered scheduler to the end, submitting the arrivals the
    crash predates."""
    for r in reqs[sched._n:]:
        sched.submit(r)
    while sched.step():
        pass


def durable_done(sched, n: int, want, label: str) -> list:
    """Every request completed with ``want``'s tokens (when given), the
    pool audit clean and no block in use; returns the tokens."""
    from repro_torch.serving.engine import RequestStatus
    got = [list(sched.results[i]["tokens"]) for i in range(n)]
    bad = [i for i in range(n)
           if sched.results[i]["status"] is not RequestStatus.COMPLETED]
    sched.check()
    if bad or sched.allocator.used_blocks or (want is not None
                                              and got != want):
        raise AssertionError(f"{label}: not completed {bad}, "
                             f"{sched.allocator.used_blocks} blocks in use, "
                             f"tokens equal: {want is None or got == want}")
    return got


def phase_durable_parity(seed: int) -> dict:
    """Phase 12 (a), at granite-3-2b widths, 4 layers, f32, TF32 off: the
    reference durability test's two servers (kv16 with speculation,
    ``draft_k=2``; kv8 with ``prefill_chunk=16``; both two classes with
    copy-on-write prefixes) on the kernel and the gather backends. For
    each of at most 8 round boundaries the scheduler journals and
    checkpoints every round, is abandoned there, and recovers into a new
    ``AdaptiveServer`` built from the same parameters (no device state
    carries over): statuses and tokens equal the uninterrupted serve's,
    ``check()`` clean, 0 blocks in use; from the restart on K1 launches =
    4 × decode steps (kv8) and K2 launches = 4 × windows (kv16-spec) on
    the kernel backend, neither on the gather one. Kernel tokens equal
    gather tokens. Then a live row's master-K leaf flipped in the newest
    cut re-prefills that request from its prompt, and a drained run
    restarted cold completes. Returns the kernel runs' K1/K2 launches
    after the restarts."""
    import dataclasses
    import gc
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.durability import Durability, recover
    from repro_torch.serving.engine import (AdaptiveServer, Request,
                                            ServingConfig)
    from repro_torch.serving.scheduler import ContinuousScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=4)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, device="cuda")
    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                            QuantIndex(names))
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    launches = {"k1": 0, "k2": 0}

    def server(which, backend):
        return AdaptiveServer(cfg, params, engine, ServingConfig(
            paged_backend=backend, **DURABLE_BASE,
            **DURABLE_CONFIGS[which]), device="cuda")

    def reset():
        PA.paged_attention.launches = 0
        PA.paged_attention_multi.launches = 0
        A.paged_view.calls = 0

    def serve_all(srv, reqs):
        sched = ContinuousScheduler(srv, quantum=4)
        for r in reqs:
            sched.submit(r)
        sched.run()
        return sched

    with use_compute_dtype(torch.float32):
        for which in DURABLE_CONFIGS:
            spec = which == "kv16-spec"
            toks = {}
            for backend in ("kernel", "gather"):
                srv = server(which, backend)
                reqs = durable_workload(cfg, Request)
                twin_s = ContinuousScheduler(srv, quantum=4)
                rounds = durable_pattern(twin_s, reqs)
                twin = durable_done(twin_s, 6, None, f"{which} {backend}")
                toks[backend] = twin
                kern = backend == "kernel"
                seen = {"k1": 0, "k2": 0, "steps": 0, "windows": 0,
                        "resumed": 0, "chunk": 0, "recovery_s": []}
                for k in range(min(rounds, 8)):
                    jd = DURABLE_DIR / f"{which}-{backend}-k{k}"
                    s1 = ContinuousScheduler(srv, quantum=4)
                    Durability(s1, str(jd), checkpoint_every=1)
                    durable_pattern(s1, durable_workload(cfg, Request),
                                    stop_after=k)
                    del s1                           # the crash
                    fresh = server(which, backend)
                    reset()
                    s2 = recover(fresh, str(jd), checkpoint_every=1,
                                 quantum=4)
                    durable_finish(s2, durable_workload(cfg, Request))
                    k1, k2 = (PA.paged_attention.launches,
                              PA.paged_attention_multi.launches)
                    views = A.paged_view.calls
                    durable_done(s2, 6, twin, f"{which} {backend} k={k}")
                    steps = cfg.n_layers * s2.decode_steps
                    windows = cfg.n_layers * s2.windows_run
                    want = ((0, windows) if kern and spec else
                            (steps, 0) if kern else (0, 0))
                    if (k1, k2) != want or (kern and views) or \
                            (not kern and s2.decode_steps and not views):
                        raise AssertionError(
                            f"{which} {backend} k={k}: K1/K2 {k1}/{k2}, "
                            f"expected {want}; gathers {views}")
                    info = s2.recover_info
                    seen["k1"] += k1
                    seen["k2"] += k2
                    seen["steps"] += s2.decode_steps
                    seen["windows"] += s2.windows_run
                    seen["resumed"] += info["resumed_rows"]
                    seen["chunk"] += info["chunk_rows"]
                    seen["recovery_s"].append(info["recovery_s"])
                    del fresh, s2
                if not seen["resumed"] + seen["chunk"]:
                    raise AssertionError(f"{which} {backend}: no crash "
                                         f"point left a row to resume")
                if kern:
                    launches["k2" if spec else "k1"] += \
                        seen["k2" if spec else "k1"]
                print(f"[durable] full width x4 layers, f32, {which} "
                      f"{backend}: {min(rounds, 8)} crash boundaries of "
                      f"{rounds} rounds, each recovered into a new server "
                      f"with the uninterrupted tokens; {seen['resumed']} "
                      f"rows resumed, {seen['chunk']} chunk rows rebuilt; "
                      f"after the restarts K1 {seen['k1']}, K2 "
                      f"{seen['k2']} over {seen['steps']} decode steps "
                      f"({seen['windows']} windows) of {cfg.n_layers} "
                      f"layers; recovery_s "
                      f"{[round(x, 4) for x in seen['recovery_s']]}")
                del srv, twin_s
                gc.collect()
            print(f"[durable] {which}: kernel tokens = gather tokens: "
                  f"{toks['kernel'] == toks['gather']}")
            if toks["kernel"] != toks["gather"]:
                raise AssertionError(f"{which}: kernel vs gather tokens")
        # a corrupted leaf re-prefills its request from the prompt
        srv = server("kv16-spec", "kernel")
        reqs = durable_workload(cfg, Request, 7)
        twin = durable_done(serve_all(srv, reqs), 6, None, "corrupt twin")
        for k in range(2, 8):
            jd = DURABLE_DIR / f"corrupt-k{k}"
            s1 = ContinuousScheduler(srv, quantum=4)
            dur = Durability(s1, str(jd), checkpoint_every=1)
            durable_pattern(s1, reqs, stop_after=k)
            sdir = Path(dur.manager.directory) / \
                f"step_{dur.manager.latest_step():09d}"
            with np.load(sdir / "arrays.npz") as z:
                flat = {n: z[n] for n in z.files}
            victims = [n for n in flat
                       if n.startswith("rows/") and n.endswith("/mk")]
            if not victims:
                continue
            flat[victims[0]] = flat[victims[0]] + 1.0
            np.savez(sdir / "arrays.npz", **flat)
            s2 = recover(server("kv16-spec", "kernel"), str(jd),
                         checkpoint_every=1, quantum=4)
            rid = int(victims[0].split("/")[1])
            refilled = s2.recover_info["refilled"]
            durable_finish(s2, reqs)
            durable_done(s2, 6, twin, "corrupted leaf")
            print(f"[durable] corrupted leaf {victims[0]} at round {k}: "
                  f"refilled {refilled} from the prompt, tokens = the "
                  f"uninterrupted serve's")
            if refilled != [rid]:
                raise AssertionError(f"refilled {refilled}, not [{rid}]")
            break
        else:
            raise AssertionError("no cut held a live row to corrupt")
        # drain, final cut, cold restart
        reqs = durable_workload(cfg, Request, 13)[:5]
        twin = durable_done(serve_all(srv, reqs), 5, None, "drain twin")
        jd = DURABLE_DIR / "drain"
        s1 = ContinuousScheduler(srv, quantum=4)
        dur = Durability(s1, str(jd), checkpoint_every=2)
        for r in reqs:
            s1.submit(r)
        s1.step()
        s1.drain()
        queued = s1.pending
        dur.checkpoint()
        s2 = recover(server("kv16-spec", "kernel"), str(jd),
                     checkpoint_every=2, quantum=4)
        if queued != 1 or s2.pending != 1 or s2.draining:
            raise AssertionError(f"drain: {queued} queued, {s2.pending} "
                                 f"after the restart")
        durable_finish(s2, reqs)
        durable_done(s2, 5, twin, "drain restart")
        print("[durable] drain: 4 admitted rows finished, 1 request left "
              "queued, the cold restart completed it with the "
              "uninterrupted tokens")
    del params, srv
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    return launches


def _durable_child(args: list, log: Path) -> subprocess.Popen:
    """The launcher's ``main(args)`` at the card's workload and
    ``FEATURE_LAYERS`` (its configs' depth cut as :func:`cut_depth` cuts
    it) in a child process from the checkout, its output in ``log``."""
    import os
    env = dict(os.environ)
    root = Path(__file__).resolve().parent
    env["PYTHONPATH"] = str(root / "src")
    main = ("import dataclasses, sys; import repro_torch.launch.serve as S; "
            "full = S.get_config; S.get_config = lambda arch: "
            f"dataclasses.replace(full(arch), n_layers={FEATURE_LAYERS}); "
            f"S.main(sys.argv[1:], **{CARD_SERVER!r}, **{CARD_PROMPTS!r})")
    return subprocess.Popen([sys.executable, "-c", main, *args], cwd=root,
                            env=env,
                            stdout=log.open("w"), stderr=subprocess.STDOUT)


def _finals(jd: Path) -> dict:
    from repro_torch.serving.durability import RequestJournal
    out: dict = {}
    for _, rec in RequestJournal.scan(str(jd / "journal.jsonl")):
        if rec["t"] == "final":
            out.setdefault(rec["rid"], []).append(rec)
    return out


def _child_line(log: Path, head: str) -> str:
    lines = [x for x in log.read_text().splitlines() if x.startswith(head)]
    if not lines:
        raise AssertionError(f"no '{head}' line in {log}:\n"
                             f"{log.read_text()[-3000:]}")
    return lines[-1]


def _tok_s(log: Path) -> float:
    """The launcher's tok/s (its "[serve] N tokens in Ts (R tok/s" line)."""
    line = [x for x in log.read_text().splitlines()
            if x.startswith("[serve] ") and " tok/s" in x]
    if not line:
        raise AssertionError(f"no tok/s line in {log}")
    return float(line[-1].split("(")[1].split(" tok/s")[0])


def phase_durable_serve(seed: int) -> dict:
    """Phase 12 (b), a real crash at granite's widths and
    ``FEATURE_LAYERS`` (bf16, kv16):
    phase 4's 12 requests (80 new tokens each, so that the serve outlasts
    two cuts at ``--checkpoint-every 8``) through ``python -m
    repro_torch.launch.serve --full --continuous --journal-dir D
    --checkpoint-every 8``. The first child is killed with SIGKILL once
    the journal holds the second ``ckpt`` record past its boot's own; the
    same command then runs on ``D`` (it recovers, then serves its own 12
    submissions), an uninterrupted child runs on a fresh directory, and
    one without ``--journal-dir``. Every rid of the first boot has exactly
    one ``final`` record in ``D``, with the uninterrupted child's tokens.
    Prints each cut's bytes and host ms, ms per fsync'd record,
    ``recovery_s`` and tok/s with and without the journal."""
    import gc
    import shutil
    import signal
    from repro_torch.serving.durability import RequestJournal

    gc.collect()
    torch.cuda.empty_cache()        # the children need the card's memory
    base = ["--full", "--continuous", "--requests", "12", "--max-new", "80",
            "--kv-bits", "16", "--quantum", "8", "--block-size", "16",
            "--seed", str(seed), "--checkpoint-every", "8"]
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    DURABLE_DIR.mkdir(parents=True)
    crash, clean = DURABLE_DIR / "crash", DURABLE_DIR / "clean"
    logs = {k: DURABLE_DIR / f"{k}.log" for k in
            ("boot1", "boot2", "clean", "plain")}
    t0 = time.perf_counter()
    child = _durable_child(base + ["--journal-dir", str(crash)],
                           logs["boot1"])
    ckpts = 0
    while ckpts < 3:
        if child.poll() is not None:
            raise AssertionError(
                f"the first boot ended (rc {child.returncode}) after "
                f"{ckpts} ckpt records:\n{logs['boot1'].read_text()[-3000:]}")
        time.sleep(0.05)
        ckpts = sum(1 for _, r in RequestJournal.scan(
            str(crash / "journal.jsonl")) if r["t"] == "ckpt")
    child.send_signal(signal.SIGKILL)
    child.wait(timeout=60)
    t_kill = time.perf_counter() - t0
    recs = [r for _, r in RequestJournal.scan(str(crash / "journal.jsonl"))]
    first = sorted(r["rid"] for r in recs if r["t"] == "submit")
    done_before = sorted(r["rid"] for r in recs if r["t"] == "final")
    kill_round = max((r.get("round", 0) for r in recs), default=0)
    print(f"[durable] boot 1 SIGKILLed {t_kill:.1f}s after start, at round "
          f"~{kill_round}, after {ckpts} ckpt records; {len(first)} rids "
          f"journaled, {len(done_before)} final before the kill")
    for name, args in (("boot2", ["--journal-dir", str(crash)]),
                       ("plain", []),
                       ("clean", ["--journal-dir", str(clean)])):
        proc = _durable_child(base + args, logs[name])
        if proc.wait(timeout=600) != 0:
            raise AssertionError(f"{name} failed:\n"
                                 f"{logs[name].read_text()[-3000:]}")
    got, want = _finals(crash), _finals(clean)
    if first != list(range(12)) or sorted(want) != list(range(12)):
        raise AssertionError(f"rids: boot 1 {first}, clean {sorted(want)}")
    for rid in first:
        if len(got.get(rid, [])) != 1:
            raise AssertionError(f"rid {rid}: {len(got.get(rid, []))} "
                                 f"final records")
        a, b = got[rid][0], want[rid][0]
        if a["status"] != "completed" or len(a["tokens"]) != 80 or \
                a["tokens"] != b["tokens"]:
            pos = next((i for i, (x, y) in enumerate(
                zip(a["tokens"], b["tokens"])) if x != y), None)
            raise AssertionError(f"rid {rid}: {a['status']}, tokens "
                                 f"diverge from the uninterrupted serve's "
                                 f"at position {pos}")
    later = sorted(r for r in got if r >= 12)
    if later != list(range(12, 24)) or any(len(got[r]) != 1 for r in later):
        raise AssertionError(f"boot 2's own requests: {later}")
    recovered = _child_line(logs["boot2"], "[serve] recovered")
    print(f"[durable] boot 2: {recovered[len('[serve] '):]}")
    for name in ("boot2", "clean"):
        print(f"[durable] {name}: "
              f"{_child_line(logs[name], '[serve] durability:')[8:]}")
    tok = {name: _tok_s(logs[name]) for name in ("plain", "clean", "boot2")}
    print(f"[durable] all 12 first-boot rids have one final record each, "
          f"with the uninterrupted serve's tokens; boot 2's own 12 "
          f"completed. tok/s without --journal-dir {tok['plain']:.2f}, with "
          f"it {tok['clean']:.2f} (uninterrupted), {tok['boot2']:.2f} "
          f"(boot 2, 24 requests after recovery)")
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    return tok


def phase_profile(seed: int) -> None:
    """Where one decode segment's time goes (``--profile``): wall time on
    the host against device-busy time from ``torch.profiler``, with the
    kernels that take the most device time, on the full 40-layer config."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as S
    from repro_torch.serving.scheduler import ContinuousScheduler

    args = S.parse_args(["--full", "--requests", "8", "--max-new", "32",
                         "--seed", str(seed)])
    cfg, srv = S.build_server(args, **CARD_SERVER)
    sched = ContinuousScheduler(srv, quantum=8)
    for r in S.make_requests(cfg, args, **CARD_PROMPTS):
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


# ---------------------------------------------------------------------------
# phase 13: the paper's CNN (QAT through K5, the native engine, Table 1 /
# Fig. 4)
# ---------------------------------------------------------------------------

def cnn_site_inputs(gen) -> list:
    """The six per-tensor fake-quant sites of one full-width CNN forward
    at batch 256 (``CNNConfig()``): (label, tensor) with values shaped
    like each site's (digit pixels in [0, 1], BN-normalised activations,
    He-scaled weights)."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    return [
        ("conv0 act [256,28,28,1]",
         torch.rand((256, 28, 28, 1), generator=gen, device="cuda")),
        ("conv0 w [3,3,1,64]", randn(3, 3, 1, 64, scale=1 / 3)),
        ("conv1 act [256,14,14,64]", randn(256, 14, 14, 64)),
        ("conv1 w [3,3,64,64]", randn(3, 3, 64, 64, scale=1 / 24)),
        ("fc act [256,3136]", randn(256, 3136)),
        ("fc w [3136,10]", randn(3136, 10, scale=0.02)),
    ]


def phase_cnn_sites(seed: int) -> None:
    """Phase 13 (a): K5 against its plain version, bitwise, at the CNN's
    six sites at batch 256 and bits 16 / 8 / 4, the scale it returns for
    the straight-through mask equal to the plain scalar; each site's
    device time (CUDA graph) beside step 0's, the plain version's and its
    bound."""
    from repro_torch.kernels import aquant as AQ
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    for label, x in cnn_site_inputs(gen):
        for bits in (16, 8, 4):
            got, s = AQ.aquant(x, bits, True, return_scale=True)
            torch.cuda.synchronize()
            want, ws = AQ.aquant_ref(x, bits, True, return_scale=True)
            if not (torch.equal(got.view(torch.int32),
                                want.view(torch.int32))
                    and torch.equal(s, ws)):
                raise AssertionError(
                    f"K5 differs from its plain version at the CNN's "
                    f"{label}, bits {bits}: max err "
                    f"{float((got - want).abs().max()):g}, scale "
                    f"{float(s):g} vs {float(ws):g}")
        nbytes = 2 * x.numel() * 4
        dev = graph_ms(lambda: AQ.aquant(x, 8, True))
        dev0 = graph_ms(lambda: k5_step0(x, 8, True))
        plain = cuda_time_ms(lambda: AQ.aquant_ref(x, 8, True), iters=50,
                             warmup=5)
        print(f"[cnn] K5 at {label} ({x.numel()} f32): bitwise equal at "
              f"bits 16/8/4, scale equal; bits 8 device {dev:.4f} ms, step 0 "
              f"{dev0:.4f} ms, plain {plain:.4f} ms, bound "
              f"{nbytes / H100_BYTES_PER_S * 1e3:.4f} ms (bytes: {nbytes} B)")
    AQ.aquant.launches = 0                # comparison launches do not count


def _cnn_batch(n: int, device) -> dict:
    from repro_torch.data.digits import make_dataset
    x, y = make_dataset(n, seed=2, difficulty="hard")
    return {"images": torch.as_tensor(x, device=device),
            "labels": torch.as_tensor(y, device=device)}


def phase_cnn_grad(seed: int) -> None:
    """Phase 13 (b) and (c) at full width (``CNNConfig()``: 64 channels,
    28x28), batch 256, f32, TF32 off, cuDNN deterministic. (b) one
    ``cnn_loss`` forward and backward at A8-W8 and Mixed through K5 (6
    launches: every quantizer's forward; the straight-through masks read
    the scale K5 returned), then with ``quantizers.aquant`` swapped for
    the plain version: loss and every gradient bitwise equal. (c) the
    forward of all six profiles on the card against the port on the CPU
    under the tests' tie rule (``cnn.tie_aware_check``)."""
    from repro_torch.core import quantizers as QZ
    from repro_torch.core.profiles import paper_profiles, profile_table
    from repro_torch.kernels import aquant as AQ
    from repro_torch.models import cnn as C
    profs = paper_profiles(C.CNN_LAYERS, inner_layers=["conv1"])
    table = profile_table(profs, C.CNN_LAYERS)
    names = [p.name for p in profs]
    params = C.init_cnn(C.CNNConfig(),
                        torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    batch = _cnn_batch(256, "cuda")
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name in ("A8-W8", "Mixed"):
            row = table[names.index(name)]
            n0 = AQ.aquant.launches
            (l1, m1), g1 = C.cnn_loss_and_grad(params, row, batch)
            torch.cuda.synchronize()
            n_k5 = AQ.aquant.launches - n0
            if n_k5 != 6:
                raise AssertionError(f"K5 launched {n_k5} times in one "
                                     f"{name} training step, not 6")
            kernel_aquant = QZ.aquant
            QZ.aquant = AQ.aquant_ref
            try:
                (l2, _), g2 = C.cnn_loss_and_grad(params, row, batch)
            finally:
                QZ.aquant = kernel_aquant
            same = torch.equal(l1, l2) and all(
                torch.equal(g1[ln][k], g2[ln][k]) for ln in g1
                for k in g1[ln])
            if not same:
                raise AssertionError(f"{name}: loss or gradients through K5 "
                                     f"differ from the plain version's")
            gmax = max(float(g.abs().max()) for p in g1.values()
                       for g in p.values())
            print(f"[cnn] (b) {name} training step at full width, batch "
                  f"256: loss {float(l1):.6f}, acc {float(m1['acc']):.4f}, "
                  f"largest gradient {gmax:.4g}; K5 {n_k5} launches; loss "
                  f"and all 10 gradients bitwise equal with the plain "
                  f"version")
        cpu = {ln: {k: v.cpu() for k, v in p.items()}
               for ln, p in params.items()}
        x_cpu = batch["images"].cpu()
        with torch.no_grad():
            for pid, name in enumerate(names):
                ref = C.cnn_sites(cpu, table[pid], x_cpu)
                got = C.cnn_sites(params, table[pid], batch["images"])
                flips = C.tie_aware_check(ref, got, table[pid])
                d = float((got["logits"].cpu() - ref["logits"]).abs().max())
                print(f"[cnn] (c) {name}: card vs CPU logits max diff "
                      f"{d:.3g}, quantized activations differing per site "
                      f"{flips}: tie rule holds")
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    AQ.aquant.launches = 0


def phase_cnn_paper(seed: int) -> dict:
    """Phase 13 (d): the launcher's ``run_table1(steps=120)`` and
    ``run_fig4`` at full width on the card, K5's launches counted over
    both. Fails if a profile's test accuracy is under 0.75 (the
    reference's own bar), if a native engine's accuracy (each profile's
    own, and A8-W8 / Mixed through the merged engine) is more than 0.5
    points from the fake path's, or if K5 never launched."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.launch import repro_cnn as L
    AQ.aquant.launches = 0
    t0 = time.perf_counter()
    t1 = L.run_table1(steps=120)
    f4 = L.run_fig4(t1)
    wall = time.perf_counter() - t0
    launches = AQ.aquant.launches
    rows = t1["rows"]
    print(f"[cnn] (d) Table 1 on {t1['device']} ({card_line()}), 120 steps "
          f"per profile, {wall:.1f} s with the measurements; K5 "
          f"{launches} launches")
    for name, r in rows.items():
        paper = L.PAPER_TABLE1.get(name)
        print(f"[cnn] (d) {name}: accuracy fake {r['accuracy_pct']:.2f}% / "
              f"native {r['native_accuracy_pct']:.2f}%; latency b256 fake "
              f"{r['fake_b256_ms']:.4f} ms / native "
              f"{r['native_b256_ms']:.4f} ms, b1 fake {r['fake_b1_ms']:.4f} "
              f"ms / native {r['native_b1_ms']:.4f} ms; per image "
              f"{r['latency_us']:.4f} us; modelled power "
              f"{r['power_w_model']:.2f} W, energy "
              f"{r['energy_j_model']:.4g} J; weight bytes "
              f"{r['weight_bytes']}; trained in {r['train_s']:.2f} s"
              + (f" (paper, KRIA FPGA: {paper['acc']}%, "
                 f"{paper['power_mw']} mW)" if paper else ""))
    m = f4["merge"]
    b = f4["battery"]
    print(f"[cnn] (d) Fig. 4: shared {m['shared_layers']}, switched "
          f"{m['switched_layers']}, merged {m['merged_bytes']} B, "
          f"overhead_vs_largest {m['overhead_vs_largest']:.4f}; merged "
          f"engine accuracy {f4['merged_native_accuracy_pct']}; "
          f"power_saving_pct {f4['power_saving_pct']}, accuracy_drop_pct "
          f"{f4['accuracy_drop_pct']}; battery adaptive "
          f"{b['adaptive']['classifications']} vs non-adaptive "
          f"{b['non_adaptive']['classifications']} classifications "
          f"(+{b['extra_classifications_pct']}%)")
    bad = [n for n, r in rows.items() if r["accuracy_pct"] < 75.0]
    if bad:
        raise AssertionError(f"test accuracy under 0.75 after 120 steps: "
                             f"{ {n: rows[n]['accuracy_pct'] for n in bad} }")
    gaps = {n: abs(r["native_accuracy_pct"] - r["accuracy_pct"])
            for n, r in rows.items()}
    gaps.update({f"merged {n}": abs(a - rows[n]["accuracy_pct"])
                 for n, a in f4["merged_native_accuracy_pct"].items()})
    if max(gaps.values()) > 0.5:
        raise AssertionError(f"native engine more than 0.5 points from "
                             f"the fake path: {gaps}")
    if launches == 0:
        raise AssertionError("K5 never launched on the CNN path")
    return {"k5": launches}


def phase_cnn_profile(seed: int) -> None:
    """Phase 13 (e): where the CNN's time goes at full width, A8-W8, f32,
    TF32 off. The forward at batch 256 and 1, fake path and native
    engine: eager latency (CUDA events, the launcher's ``measure_ms``)
    beside the device time of the same forward replayed from a CUDA
    graph; then one training step (forward, backward, AdamW) under
    ``torch.profiler``: wall time, device-busy time and share, K5's
    device time, and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.merge import merge_plan
    from repro_torch.core.profiles import paper_profiles, profile_table
    from repro_torch.kernels import aquant as AQ
    from repro_torch.launch import repro_cnn as L
    from repro_torch.models import cnn as C
    from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
    profs = paper_profiles(C.CNN_LAYERS, inner_layers=["conv1"])
    row = profile_table(profs, C.CNN_LAYERS)[2]             # A8-W8
    params = C.init_cnn(C.CNNConfig(),
                        torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    plan = merge_plan([profs[2]])
    images = C.quantize_cnn_images(params, plan)
    batch = _cnn_batch(256, "cuda")
    dev = torch.device("cuda")
    with L._f32(), torch.no_grad():
        for b in (256, 1):
            x = batch["images"][:b]
            for path, fn in (
                    ("fake", lambda: C.cnn_forward(params, row, x)),
                    ("native", lambda: C.cnn_forward_native(
                        params, images, plan, [0, 0, 0], row, x))):
                eager = L.measure_ms(fn, dev)
                device = graph_ms(fn)
                print(f"[cnn] (e) A8-W8 {path} forward at batch {b}: eager "
                      f"{eager:.4f} ms (CUDA events), device {device:.4f} "
                      f"ms (CUDA graph), device busy "
                      f"{100 * device / eager:.1f}% of the eager call")
    acfg = AdamConfig(lr=1e-3, total_steps=120, warmup_steps=10)
    opt = adam_init(params)

    def step():
        _, g = C.cnn_loss_and_grad(params, row, batch)
        return adam_update(acfg, g, opt, params)

    with L._f32():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 5
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) is not None
          and str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / 5   # ms
    k5 = sum(e.self_device_time_total for e in ev
             if K5_KERNEL in e.key) / 1e3 / 5
    n = sum(e.count for e in ev) / 5
    print(f"[cnn] (e) one A8-W8 training step at batch 256 (mean of 5): "
          f"wall {wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.1f}%), {n:.0f} device kernels, "
          f"K5 {k5:.4f} ms of device time")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[cnn] (e)   {e.self_device_time_total / 1e3 / 5:9.4f} ms "
              f"{e.count / 5:5.0f}x  {e.key[:90]}")
    AQ.aquant.launches = 0

# ---------------------------------------------------------------------------
# phase 14: the mamba2 SSM family at mamba2-130m's full width
# ---------------------------------------------------------------------------

MAMBA2 = "mamba2-130m"
MAMBA2_LINEARS = ((768, 3352), (1536, 768))    # ssm_in, ssm_out as (K, N)


def mamba2_state_bytes(rows: int) -> int:
    """f32 SSM state of ``rows`` rows of mamba2-130m: 24 layers of ``h``
    (24 heads x 64 x d_state 128) and the conv window (3 x conv_dim
    1792)."""
    return rows * 24 * (24 * 64 * 128 + 3 * 1792) * 4


def check_tokens(cfg, params, engine, reqs, got, want, what: str) -> None:
    """``got`` must equal ``want`` token for token; a greedy flip passes
    only where the top-2 logits of ``want``'s solo replay lie within 1e-3
    (another batching moves the chunk boundaries of the f32 sums)."""
    same = got == want
    print(f"[mamba2] (a) {what}: tokens identical: {same} "
          f"({sum(map(len, got))} tokens)")
    if not same:
        margin = first_divergence(cfg, params, engine, reqs, got, want, 16)
        if not margin < 1e-3:
            raise AssertionError(f"{what}: tokens diverge at a top-2 margin "
                                 f"of {margin:.3e}")


def phase_ssm_parity(seed: int) -> None:
    """Phase 14 (a): mamba2-130m's full config (24 layers, d_model 768,
    chunk 256), random weights from ``seed``, f32, TF32 off. Prefill of 31
    tokens then one ``decode_step`` against ``forward`` over 32 at the float
    profile (the reference's relation, ``rel < 5e-5``); a ragged ``serve``
    of prompts 4, 300 and 517 (inside one chunk, past the first chunk, three
    chunks) against each prompt's solo ``generate``; ``generate`` against
    ``generate_stepwise``; a ``ContinuousScheduler`` asked for the paged
    pool runs contiguous and gives the static serve's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import Profile, paper_profiles, profile_table
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
    from repro_torch.serving.scheduler import ContinuousScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MAMBA2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, device="cuda")
    names = T.quant_layer_names(cfg)
    with use_compute_dtype(torch.float32):
        br = profile_table([Profile.float32(names)], names)[0]
        toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                             device="cuda")
        hidden, _, _ = T.forward(params, cfg, br, {"tokens": toks})
        full = T._logits(cfg, params, br, hidden[:, -1:])[:, 0]
        _, caches = T.prefill(params, cfg, br, {"tokens": toks[:, :31]}, 36)
        dec, _ = T.decode_step(params, cfg, br, toks[:, 31:],
                               torch.full((2,), 31, dtype=torch.int32,
                                          device="cuda"), caches)
        rel = float((dec - full).abs().max()) / max(
            1e-9, float(full.abs().max()))
        print(f"[mamba2] (a) full width ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}), f32: prefill(31) + decode_step vs forward(32)"
              f" logits rel {rel:.3e} (< 5e-5: {rel < 5e-5})")
        if not rel < 5e-5:
            raise AssertionError(f"prefill + decode != forward: rel {rel}")
        engine = AdaptiveEngine(tuple(paper_profiles(names)),
                                QuantIndex(names))
        rng = np.random.default_rng(seed)
        reqs = [Request(tokens=rng.integers(0, cfg.vocab, n).astype(np.int32),
                        max_new=8) for n in (4, 300, 517)]
        srv = AdaptiveServer(cfg, params, engine, ServingConfig(
            slots=1024, max_batch=4), device="cuda")
        ragged = [r["tokens"] for r in srv.serve(reqs)]
        solo = [srv.generate(r.tokens[None], r.max_new)["tokens"][0]
                for r in reqs]
        check_tokens(cfg, params, engine, reqs, ragged, solo,
                     "ragged serve of prompts 4/300/517 vs solo generate")
        prompts = np.stack([reqs[1].tokens,
                            rng.integers(0, cfg.vocab, 300).astype(np.int32)])
        fused = srv.generate(prompts, 8)["tokens"]
        stepwise = srv.generate_stepwise(prompts, 8)["tokens"]
        print(f"[mamba2] (a) generate vs generate_stepwise (2 x 300 "
              f"tokens, 8 new): identical: {fused == stepwise}")
        if fused != stepwise:
            raise AssertionError(f"generate {fused} != stepwise {stepwise}")
        sched = ContinuousScheduler(AdaptiveServer(
            cfg, params, engine, ServingConfig(slots=1024, max_batch=4,
                                               paged_kv=True),
            device="cuda"), quantum=4)
        print(f"[mamba2] (a) ContinuousScheduler with paged_kv=True: paged "
              f"{sched.paged}, caches {sorted(sched._caches)}")
        if sched.paged or set(sched._caches) != {"ssm"}:
            raise AssertionError("an SSM stack must run the contiguous pool")
        for r in reqs:
            sched.submit(r)
        res = sched.run()
        check_tokens(cfg, params, engine, reqs,
                     [res[i]["tokens"] for i in range(len(reqs))], ragged,
                     "continuous scheduler vs static serve")
    del params, srv, sched
    torch.cuda.empty_cache()


def phase_ssm_kernels(seed: int) -> None:
    """Phase 14 (b): K5 and K3 at mamba2-130m's shapes against their plain
    versions. K5 bit for bit on each weight image it builds — ``ssm_in``
    ``[768, 3352]``, ``ssm_out`` ``[1536, 768]`` (one layer each), the
    tied embedding table ``50280 x 768`` — at bits 8 and 4, device time
    from a CUDA graph beside the bytes bound. K3 (:func:`k3_case`: the
    tolerance, device time with cold weights beside torch.matmul's) at M 1,
    8 and 16 (decode, the split-K kernel) and 512 and 4096 (a prefill wave
    of 1 and 8 rows of 512), at ``ssm_in`` (N 3352: rows of 3352 bytes at
    W8 and 1676 at W4, not 16-byte multiples, so decode loads bytewise and
    prefill takes the mma.sync kernel) and ``ssm_out`` (N 768), W8 and W4,
    bf16 and f32 x; then K3's device time per decode step (M 8) and per
    prefill wave (M 4096), 24 layers x both linears, bf16 W8."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import qmatmul as QM
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    sites = [("ssm_in 768x3352", (768, 3352), 768 ** -0.5),
             ("ssm_out 1536x768", (1536, 768), 1536 ** -0.5),
             ("embed / tied head 50280x768", (50280, 768), 0.02)]
    for label, shape, std in sites:
        x = torch.randn(shape, generator=gen, device="cuda") * std
        for bits in (8, 4):
            k5_case(f"mamba2 {label}", x, bits, True, timed=True)
    bf16, f32 = torch.bfloat16, torch.float32
    dev_ms = {}
    for k, n in MAMBA2_LINEARS:
        for bits in (8, 4):
            for xdtype in (bf16, f32):
                for m in (1, 8, 16, 512, 4096):
                    r = k3_case(gen, m, k, n, bits, xdtype)
                    dev_ms[(m, k, n, bits, xdtype)] = (
                        r["device_ms"], r["library_device_ms"])
    for m, what in ((8, "decode step"), (4096, "prefill wave")):
        k3 = 24 * sum(dev_ms[(m, k, n, 8, bf16)][0] for k, n in MAMBA2_LINEARS)
        lib = 24 * sum(dev_ms[(m, k, n, 8, bf16)][1]
                       for k, n in MAMBA2_LINEARS)
        bound = 24 * sum(qmatmul_bound(m, k, n, 8)["bound_ms"]
                         for k, n in MAMBA2_LINEARS)
        print(f"[mamba2] (b) K3 per {what} at M={m} W8 bf16: 24 layers x "
              f"ssm_in + ssm_out device {k3:.4f} ms, torch.matmul bf16 "
              f"{lib:.4f} ms, bound {bound:.4f} ms")
    QM.qmatmul.launches = AQ.aquant.launches = 0   # comparisons do not count


def phase_ssm_serve(seed: int, w_bits=None) -> dict:
    """Phase 14 (c): the launcher's ``--arch mamba2-130m --full
    --continuous`` workload — 12 requests, prompts of 64–512 tokens from
    ``seed``, 32 new tokens, 8 rows, bf16 — with fake-quant weights
    (``w_bits`` None: the launcher's own ``build_server``) or from
    ``to_native(params, w_bits)`` (the f32 masters freed first). The
    counts are zeroed just before the server is built (its weight images
    are K5's work) and read after the serve. The pool must be contiguous
    and hold ``mamba2_state_bytes(8)``; every request completes with 32
    in-vocabulary tokens; K5 launches; on the native runs K3 launches 2 x
    24 x (decode steps + prefill waves) and the dequantize-then-matmul
    branch never, on the fake-quant run K3 never."""
    import gc
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.manager import ProfileManager
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import qmatmul as QM
    from repro_torch.launch import serve as S
    from repro_torch.models import layers as LY
    from repro_torch.models import transformer as T
    from repro_torch.models.native import to_native
    from repro_torch.serving.engine import (AdaptiveServer, RequestStatus,
                                            ServingConfig)

    args = S.parse_args(["--arch", MAMBA2, "--continuous", "--full",
                         "--requests", "12", "--max-new", "32",
                         "--quantum", "8", "--seed", str(seed)])
    tag = "fake-quant" if w_bits is None else f"native W{w_bits}"
    nat = None
    if w_bits is not None:
        from repro_torch.configs import get_config
        cfg = get_config(args.arch)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = T.init_params(cfg, gen, device="cuda")
        nat = to_native(params, w_bits)
        del params
        gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    QM.qmatmul.launches = AQ.aquant.launches = LY.dequant_matmul.calls = 0
    if nat is None:
        cfg, srv = S.build_server(args, **CARD_SERVER)
    else:
        names = T.quant_layer_names(cfg)
        profs = paper_profiles(names, inner_layers=[])
        engine = AdaptiveEngine(tuple(profs), QuantIndex(names))
        stats = S.profile_stats(cfg, profs, T.param_count(nat))
        mgr = ProfileManager(stats, accuracy_target=0.985,
                             accuracy_floor=0.95,
                             budget_j=stats[0].energy_j
                             * args.budget_inferences, low_energy=0.5)
        srv = AdaptiveServer(cfg, nat, engine, ServingConfig(
            slots=1024, max_batch=8), manager=mgr, device="cuda")
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
    mgr0 = copy.deepcopy(srv.manager)
    out = S.serve(srv, reqs, args.quantum, continuous=True)
    k3, k5, deq = (QM.qmatmul.launches, AQ.aquant.launches,
                   LY.dequant_matmul.calls)
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    for i, r in enumerate(results):
        if r["status"] is not RequestStatus.COMPLETED or len(r["tokens"]) != 32:
            raise AssertionError(f"mamba2 {tag} request {i}: {r['status']}, "
                                 f"{len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"mamba2 {tag} request {i}: token out of "
                                 f"vocab")
    state = sched.paged_stats()["kv_bytes"]
    want_state = mamba2_state_bytes(sched.n_slots)
    steps = sched.decode_steps
    waves = len(sched.events) - steps          # one billing event per wave
    want_k3 = 2 * cfg.n_layers * (steps + waves) if w_bits else 0
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r["tokens"]) for r in results)
    print(f"[mamba2] (c) {tag}: {len(results)} requests, prompts "
          f"{min(len(r.tokens) for r in reqs)}-"
          f"{max(len(r.tokens) for r in reqs)}, {n_tok} tokens in "
          f"{wall:.3f}s = {n_tok / wall:.2f} tok/s; {steps} decode steps, "
          f"{waves} prefill waves, {sched.segments_run} segments; peak "
          f"memory {peak / 2**30:.3f} GiB; SSM state {state} B = 8 x 24 x "
          f"(24*64*128 + 3*1792) x 4 B: {state == want_state}; paged "
          f"{sched.paged}")
    print(f"[mamba2] (c) {tag}: K5 launches {k5}; K3 launches {k3} = 2 x "
          f"{cfg.n_layers} layers x ({steps} decode steps + {waves} prefill "
          f"waves) = {want_k3}: {k3 == want_k3}; dequant-matmul calls {deq}")
    if sched.paged or state != want_state:
        raise AssertionError(f"mamba2 {tag}: the SSM pool is not the "
                             f"contiguous {want_state} B state")
    if k5 == 0 or k3 != want_k3 or deq:
        raise AssertionError(f"mamba2 {tag} did not run through K5 and K3 "
                             f"as counted")
    if w_bits is None:
        check_graphed(f"[mamba2] (c) {tag}", srv, reqs, args.quantum, out,
                      mgr0)
    del srv, sched, out, nat
    torch.cuda.empty_cache()
    return {"k3": k3, "k5": k5, "tok_s": n_tok / wall, "peak": peak}


def phase_ssm_profile(seed: int, arch: str = MAMBA2,
                      tag: str = "mamba2") -> None:
    """Phase 14 (d), and 15 (d) and 16 (d) with ``arch`` hymba-1.5b and
    qwen2-moe-a2.7b: where the time goes on the (c) phase's fake-quant
    server, bf16, under ``torch.profiler``: one admission wave of 8 prompts
    (a first wave on another scheduler warms the server) and one decode
    segment of 8 steps after a warm one: wall time, device-busy time and
    share, K5's share of it, and the device operations that take the
    most."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as S
    from repro_torch.serving.scheduler import ContinuousScheduler

    args = S.parse_args(["--arch", arch, "--full", "--requests", "8",
                         "--max-new", "32", "--seed", str(seed)])
    cfg, srv = S.build_server(args, **CARD_SERVER)
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
    warm = ContinuousScheduler(srv, quantum=8)
    for r in reqs:
        warm.submit(r)
    warm.admit()
    del warm
    sched = ContinuousScheduler(srv, quantum=8)
    for r in reqs:
        sched.submit(r)

    def traced(label, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        k5 = [e for e in ev if K5_KERNEL in e.key]
        k5_ms = sum(e.self_device_time_total for e in k5) / 1e3
        cp = [e for e in ev if "copy_kernel" in e.key]
        cp_ms = sum(e.self_device_time_total for e in cp) / 1e3
        print(f"[{tag}] (d) {label}: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}%), "
              f"{sum(e.count for e in ev)} device kernels; K5 "
              f"({K5_KERNEL}) {k5_ms:.3f} ms in {sum(e.count for e in k5)} "
              f"kernels, {100 * k5_ms / max(busy, 1e-9):.1f}% of the device "
              f"time; copies and casts (copy_kernel) {cp_ms:.3f} ms in "
              f"{sum(e.count for e in cp)} kernels, "
              f"{100 * cp_ms / max(busy, 1e-9):.1f}%")
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[{tag}] (d)   {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:90]}")

    lens = sorted(len(r.tokens) for r in reqs)
    traced(f"one admission wave (8 prompts of {lens[0]}-{lens[-1]} tokens, "
           f"the prefill of {cfg.n_layers} layers)", sched.admit)
    sched.run_segment()                        # warm
    sched._flush()
    traced(f"one decode segment (8 steps x {cfg.n_layers} layers, 8 rows)",
           lambda: (sched.run_segment(), sched._flush()))


# ---------------------------------------------------------------------------
# phase 15: the hybrid family (hymba-1.5b) at full width
# ---------------------------------------------------------------------------

HYMBA = "hymba-1.5b"
# (site, K, N) of hymba-1.5b's linears, one layer each, and the untied head
HYMBA_LINEARS = (("qkv", 1600, 2240), ("attn_out", 1600, 1600),
                 ("ssm_in", 1600, 6482), ("ssm_out", 3200, 1600),
                 ("mlp_in", 1600, 11008), ("mlp_out", 5504, 1600),
                 ("lm_head", 1600, 32001))


def hymba_state_bytes(rows: int, n_layers: int = 32) -> int:
    """f32 SSM state of ``rows`` rows of hymba-1.5b: ``n_layers`` layers of
    ``h`` (50 heads x 64 x d_state 16) and the conv window (3 x conv_dim
    3232)."""
    return rows * n_layers * (50 * 64 * 16 + 3 * 3232) * 4


def paged_from_dense(kv, bs: int):
    """A paged pool holding the rows of the contiguous stacked cache ``kv``
    (``[L, B, slots, ...]``): row ``b``'s table maps blocks ``b·n_lblk ..``
    in order, plus the pool's write sink."""
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


def phase_hybrid_parity(seed: int) -> dict:
    """Phase 15 (a): hymba-1.5b's full config (32 layers, d_model 1600, 25
    query heads over 5 KV heads, a sliding window of 1024, 50 SSD heads of
    64, d_state 16, chunk 256, untied head of 32001), random weights from
    ``seed``, f32, TF32 off. Prefill of 31 tokens into an f32 cache then
    one ``decode_step`` against ``forward`` over 32 at the float profile
    (``rel < 5e-5``). Then prefill of 1000 tokens into ``slots=2048`` (a
    ring of ``min(2048, 1024)`` slots), and 60 teacher-forced decode steps
    across position 1024 (the ring wraps) against ``forward`` over 1060
    (past the window: the block-skipping prefill) at every decoded
    position, ``rel < 5e-5`` each, on the f32 contiguous cache; the same
    steps on a bf16 paged pool of blocks of 16 through K1 (window 1024 on
    the wrapped ring; 32 x 60 launches) against the gather backend on the
    same pool within ``rel < 1e-4``, and beside ``forward`` (reported)."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile, profile_table
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(HYMBA)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, device="cuda")
    names = T.quant_layer_names(cfg)
    dev = "cuda"

    def rel(a, b):
        return float((a - b).abs().max()) / max(1e-9, float(b.abs().max()))

    with use_compute_dtype(torch.float32):
        br = profile_table([Profile.float32(names)], names)[0]
        toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=dev)
        hidden, _, _ = T.forward(params, cfg, br, {"tokens": toks})
        full = T._logits(cfg, params, br, hidden[:, -1:])[:, 0]
        _, caches = T.prefill(params, cfg, br, {"tokens": toks[:, :31]}, 36,
                              kv_bits=32)
        dec, _ = T.decode_step(params, cfg, br, toks[:, 31:],
                               torch.full((2,), 31, dtype=torch.int32,
                                          device=dev), caches)
        r = rel(dec, full)
        print(f"[hymba] (a) full width ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}), f32: prefill(31) + decode_step vs forward(32)"
              f" logits rel {r:.3e} (< 5e-5: {r < 5e-5})")
        if not r < 5e-5:
            raise AssertionError(f"prefill + decode != forward: rel {r}")
        p0, n_dec = 1000, 60
        toks = torch.randint(0, cfg.vocab, (2, p0 + n_dec), generator=gen,
                             device=dev)
        t0 = time.perf_counter()
        hidden, _, _ = T.forward(params, cfg, br, {"tokens": toks})
        want = T._logits(cfg, params, br, hidden[:, p0 - 1:])
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        del hidden
        runs = {}
        for kv_bits, backend in ((32, None), (16, "kernel"), (16, "gather")):
            logits, caches = T.prefill(params, cfg, br,
                                       {"tokens": toks[:, :p0]}, 2048,
                                       kv_bits=kv_bits)
            ring = caches["kv"].token_idx.shape[-1]
            if ring != 1024:
                raise AssertionError(f"a hymba row holds {ring} slots, "
                                     f"not min(2048, 1024)")
            if backend is not None:
                caches["kv"] = paged_from_dense(caches["kv"], 16)
            PA.paged_attention.launches = 0
            rels = [rel(logits, want[:, 0])]
            for i in range(n_dec):
                pos = torch.full((2,), p0 + i, dtype=torch.int32, device=dev)
                logits, caches = T.decode_step(
                    params, cfg, br, toks[:, p0 + i:p0 + i + 1], pos, caches,
                    paged_backend=backend or "gather")
                rels.append(rel(logits, want[:, i + 1]))
            runs[(kv_bits, backend)] = (logits, rels,
                                        PA.paged_attention.launches)
            top = int(caches["kv"].token_idx.max())
            if top != p0 + n_dec - 1:
                raise AssertionError(f"the ring's newest token is {top}")
        _, rels32, _ = runs[(32, None)]
        print(f"[hymba] (a) forward(1060) in {t_fwd:.3f}s (block-skipping "
              f"window attention); prefill(1000) into slots=2048 (a ring of "
              f"1024) + {n_dec} decode steps across position 1024, f32 "
              f"cache: logits rel vs forward max {max(rels32):.3e} over "
              f"{len(rels32)} positions (< 5e-5: {max(rels32) < 5e-5})")
        if not max(rels32) < 5e-5:
            raise AssertionError(f"decode across the window != forward: "
                                 f"{rels32}")
        kl, krels, k1 = runs[(16, "kernel")]
        gl, grels, g1 = runs[(16, "gather")]
        kg = rel(kl, gl)
        print(f"[hymba] (a) bf16 paged pool (blocks of 16, window 1024 on "
              f"the wrapped ring): K1 launches {k1} = {cfg.n_layers} x "
              f"{n_dec}: {k1 == cfg.n_layers * n_dec}; gather backend "
              f"launches {g1}; last logits K1 vs gather rel {kg:.3e} "
              f"(< 1e-4: {kg < 1e-4}); rel vs forward max K1 "
              f"{max(krels):.3e}, gather {max(grels):.3e}")
        if k1 != cfg.n_layers * n_dec or g1 or not kg < 1e-4:
            raise AssertionError("the paged hymba decode through K1 "
                                 "disagrees with the gather backend")
    PA.paged_attention.launches = 0
    del params, caches, runs
    torch.cuda.empty_cache()
    return {"rel_decode": max(rels32)}


def ring_inputs(gen, *, bits, B=8, Hkv=5, Hg=5, D=64, bs=16, n_lblk=64):
    """K1's operands on a sliding-window ring as hymba's paged pool holds
    it: each live row maps ``n_lblk`` shuffled physical blocks, and slot
    ``j`` holds the newest token ``t <= pos`` with ``t % cap == j`` (every
    token of ``pos − cap + 1 .. pos`` once the ring has wrapped). Rows at
    positions 300 (not wrapped), cap − 1, cap, cap + 5, 2·cap + 17, 3·cap
    − 1 and 5000; the last row dead (all entries unmapped)."""
    cap = n_lblk * bs
    x = paged_inputs(gen, bits=bits, B=B, Hkv=Hkv, Hg=Hg, D=D, bs=bs,
                     n_lblk=n_lblk)
    n_blocks = x["token_idx"].shape[0]
    pos = [300, cap - 1, cap, cap + 5, 2 * cap + 17, 3 * cap - 1, 5000, 0]
    pos = torch.tensor(pos[:B], dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    bt = perm[:B * n_lblk].reshape(B, n_lblk).int()
    bt[-1] = -1
    tidx = x["token_idx"].clone()
    slot = torch.arange(cap, device="cuda")
    for b in range(B - 1):
        p = int(pos[b])
        t = p - (p - slot) % cap
        tidx[bt[b].long()] = torch.where(t >= 0, t, -1).int().reshape(
            n_lblk, bs)
    return dict(x, token_idx=tidx, block_table=bt, pos=pos)


def phase_hybrid_kernels(seed: int) -> None:
    """Phase 15 (b): the kernels at hymba-1.5b's shapes against their plain
    versions. K1 at Hkv 5, Hg 5, D 64 on wrapped rings of 1024 slots
    (blocks of 16) at kv16/kv8/kv4, with window 1024 (hymba's: every live
    slot is inside it) timed beside SDPA (kv16) and its bound, and window
    1000 (the mask bites) untimed; K4 at 8 rows x 5 KV heads, Hg 5, S 1024
    at the static serve's own lengths, bf16 and f32 q, beside SDPA and its
    bound; K3 (:func:`k3_case`) at every hymba site — decode (M 8) and a
    prefill wave (M 4096) at W8, ``ssm_in`` (N 6482: 3241-byte packed rows)
    also at W4 and with f32 x, the head (N 32001, odd: no W4) at M 8 —
    each with its route, device time beside torch.matmul's and its bound;
    K5 bit for bit on every site's weight image, the head and the
    embedding table at bits 8 and 4 (``ssm_in``, ``mlp_in`` and the head
    timed)."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.kernels import qmatmul as QM
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    fn, ref = PA.paged_attention, PA.paged_attention_ref
    for bits in (16, 8, 4):
        x = ring_inputs(gen, bits=bits)
        kw = dict(bits=bits, window=1024)
        lab = f"hymba ring Hkv 5 Hg 5 kv{bits} window 1024"
        check_case("K1", fn, ref, x, kw, lab)
        check_case("K1", fn, ref, x, dict(bits=bits, window=1000),
                   f"hymba ring Hkv 5 Hg 5 kv{bits} window 1000")
        splits, per, rt, nrow = plan_of(PA, x)
        ms = cuda_time_ms(lambda: fn(**x, **kw))
        dev = graph_ms(lambda: fn(**x, **kw))
        plain = cuda_time_ms(lambda: ref(**x, **kw), iters=50)
        lib = lib_dev = None
        if bits == 16:
            lib, lib_dev = library_times(lambda: sdpa_fn(x))
        bd = paged_bound(x, bits)
        print(f"[K1] {lab}: {splits} splits x {per} tiles, {rt} row tile(s) "
              f"of {nrow}; device {dev:.4f} ms, per call {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {_ms(lib)} (device {_ms(lib_dev)}), "
              f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
              f"{bd['bytes']} B, {bd['flops']} flop, {bd['keys']} keys)")
    for label, lens in serve_lengths(seed):
        for qdtype in (torch.bfloat16, torch.float32):
            x = qkv_inputs(gen, lens, hkv=5, hg=5, qdtype=qdtype)
            lab = (f"hymba {label} Hkv 5 Hg 5 "
                   f"{'bf16' if qdtype == torch.bfloat16 else 'f32'} q")
            check_k4(QK, x, lab)
            if qdtype != torch.bfloat16:
                continue
            copies = k4_copies(x)
            dev = k4_device_ms(QK, x, copies)
            del copies
            lib = qkv_sdpa_times(x)
            bd = qkv_bound(x["q"], x["lengths"], 1024)
            print(f"[K4] {lab}: device {dev:.4f} ms, sdpa device "
                  f"{_ms(lib['library_device_ms'])} / per call "
                  f"{_ms(lib['library_ms'])}, bound {bd['bound_ms']:.4f} ms "
                  f"({bd['bound_by']}: {bd['bytes']} B)")
    bf16 = torch.bfloat16
    for site, k, n in HYMBA_LINEARS:
        for bits in ((8, 4) if site == "ssm_in" else (8,)):
            for m in ((8,) if site == "lm_head" else (8, 4096)):
                r = k3_case(gen, m, k, n, bits, bf16)
                print(f"[hymba] (b) K3 {site} M={m} W{bits}: route "
                      f"{r['route']}, device {r['device_ms']:.4f} ms, "
                      f"torch.matmul {r['library_device_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms")
                del r
    r = k3_case(gen, 8, 1600, 6482, 8, torch.float32)
    del r
    images = [(f"{site} {k}x{n}", (k, n), k ** -0.5)
              for site, k, n in HYMBA_LINEARS if site != "lm_head"]
    images += [("lm_head 1600x32001", (1600, 32001), 0.02),
               ("embed 32001x1600", (32001, 1600), 0.02)]
    for label, shape, std in images:
        w = torch.randn(shape, generator=gen, device="cuda") * std
        for bits in (8, 4):
            k5_case(f"hymba {label}", w, bits, True, timed=label.startswith(
                ("ssm_in", "mlp_in", "lm_head")))
    QM.qmatmul.launches = AQ.aquant.launches = 0   # comparisons do not count
    PA.paged_attention.launches = QK.qkv_attention.launches = 0


def phase_hybrid_serve(seed: int, mode: str) -> dict:
    """Phase 15 (c): the launcher's ``--arch hymba-1.5b --full`` workload
    (12 requests, prompts of 64–512 tokens from ``seed``, 32 new tokens, 8
    rows, bf16) at hymba's widths and the launcher's depth
    (``HYMBA_FEATURE_LAYERS`` in ``main``) in one of three modes:
    ``"paged"`` — ``--continuous``, the paged pool of blocks of 16 on the
    kernel backend (K1 = n_layers x decode steps); ``"kv8"`` —
    ``--kv-bits 8`` static groups on the contiguous int8 ring (K4 =
    n_layers x 2 groups x 31 steps, K1 and the kv8 einsum never);
    ``"native"`` — ``to_native(params, 8)`` through ``AdaptiveServer`` +
    ``ContinuousScheduler`` on the paged pool (K3 = (6 x n_layers + 1) x
    (decode steps + prefill waves), K1 = n_layers x decode steps, the
    dequantize-then-matmul branch never). The counts are zeroed just before
    the server is built (its weight images are K5's work) and read after
    the serve. Every request completes with 32 in-vocabulary tokens; the
    pool holds ``hymba_state_bytes(8, n_layers)`` of SSM state beside the
    KV."""
    import gc
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.manager import ProfileManager
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.kernels import qmatmul as QM
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.models import layers as LY
    from repro_torch.models import transformer as T
    from repro_torch.models.native import to_native
    from repro_torch.serving.engine import (AdaptiveServer, RequestStatus,
                                            ServingConfig)

    argv = ["--arch", HYMBA, "--full", "--requests", "12", "--max-new",
            "32", "--quantum", "8", "--seed", str(seed)]
    argv += ["--kv-bits", "8"] if mode == "kv8" else ["--continuous"]
    args = S.parse_args(argv)
    nat = None
    if mode == "native":
        cfg = S.get_config(HYMBA)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = T.init_params(cfg, gen, device="cuda")
        nat = to_native(params, 8)
        del params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    QM.qmatmul.launches = AQ.aquant.launches = LY.dequant_matmul.calls = 0
    PA.paged_attention.launches = QK.qkv_attention.launches = 0
    A.decode_attention.kv8_einsum_calls = A.paged_view.calls = 0
    if nat is None:
        cfg, srv = S.build_server(args, **CARD_SERVER)
    else:
        names = T.quant_layer_names(cfg)
        profs = paper_profiles(names, inner_layers=[])
        engine = AdaptiveEngine(tuple(profs), QuantIndex(names))
        stats = S.profile_stats(cfg, profs, T.param_count(nat))
        mgr = ProfileManager(stats, accuracy_target=0.985,
                             accuracy_floor=0.95,
                             budget_j=stats[0].energy_j
                             * args.budget_inferences, low_energy=0.5)
        srv = AdaptiveServer(cfg, nat, engine, ServingConfig(
            slots=1024, max_batch=8), manager=mgr, device="cuda")
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
    mgr0 = copy.deepcopy(srv.manager)
    out = S.serve(srv, reqs, args.quantum, continuous=mode != "kv8")
    k1, k3, k4, k5 = (PA.paged_attention.launches, QM.qmatmul.launches,
                      QK.qkv_attention.launches, AQ.aquant.launches)
    deq, einsum, gathers = (LY.dequant_matmul.calls,
                            A.decode_attention.kv8_einsum_calls,
                            A.paged_view.calls)
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    for i, r in enumerate(results):
        if len(r["tokens"]) != 32 or (sched is not None and r["status"]
                                      is not RequestStatus.COMPLETED):
            raise AssertionError(f"hymba {mode} request {i}: "
                                 f"{len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"hymba {mode} request {i}: token out of "
                                 f"vocab")
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r["tokens"]) for r in results)
    L = cfg.n_layers
    line = (f"[hymba] (c) {mode}: {len(results)} requests, prompts "
            f"{min(len(r.tokens) for r in reqs)}-"
            f"{max(len(r.tokens) for r in reqs)}, {n_tok} tokens in "
            f"{wall:.3f}s = {n_tok / wall:.2f} tok/s; peak memory "
            f"{peak / 2**30:.3f} GiB")
    if sched is None:                    # static groups of 8 rows
        steps = -(-len(reqs) // srv.scfg.max_batch) * (args.max_new - 1)
        print(f"{line}; K4 launches {k4} = {L} layers x {steps} decode "
              f"steps: {k4 == L * steps}; K1 {k1}, kv8 einsum {einsum}, "
              f"K3 {k3}, K5 {k5}")
        if k4 != L * steps or k1 or einsum or gathers or k5 == 0:
            raise AssertionError("the hymba kv8 static serve did not read "
                                 "the int8 ring through K4 alone")
        return {"k4": k4, "k5": k5, "tok_s": n_tok / wall, "peak": peak}
    kv = T.cache_bytes({"kv": sched._caches["kv"]})
    state = T.cache_bytes({"ssm": sched._caches["ssm"]})
    pool = sched._caches["kv"]
    kv_data = 2 * pool.k.numel() * pool.k.element_size()
    steps = sched.decode_steps
    waves = len(sched.events) - steps          # one billing event per wave
    want_k3 = (6 * L + 1) * (steps + waves) if mode == "native" else 0
    print(f"{line}; {steps} decode steps, {waves} prefill waves, "
          f"{sched.segments_run} segments; paged {sched.paged}, blocks of "
          f"{sched.block_size}, {sched.n_lblk} per row; KV pool {kv} B "
          f"(K/V {kv_data} B = {L} x {pool.k.shape[1]} blocks x 16 x 5 x "
          f"64 x 2 x 2 B), SSM state {state} B = 8 x {L} x (50*64*16 + "
          f"3*3232) x 4 B: {state == hymba_state_bytes(8, L)}")
    print(f"[hymba] (c) {mode}: K1 launches {k1} = {L} x {steps}: "
          f"{k1 == L * steps}; K3 launches {k3} = (6 x {L} + 1) x ({steps} "
          f"+ {waves}) = {want_k3}: {k3 == want_k3}; K5 launches {k5}; K4 "
          f"{k4}; dequant-matmul calls {deq}; gather calls {gathers}")
    if (not sched.paged or state != hymba_state_bytes(8, L)
            or sched.n_lblk != 64 or k1 != L * steps or k3 != want_k3
            or deq or gathers or k4 or (mode == "paged" and k5 == 0)):
        raise AssertionError(f"the hymba {mode} serve did not run as "
                             f"counted")
    if mode == "paged":
        check_graphed("[hymba] (c) paged", srv, reqs, args.quantum, out,
                      mgr0)
    del srv, sched, out, nat
    torch.cuda.empty_cache()
    return {"k1": k1, "k3": k3, "k5": k5, "tok_s": n_tok / wall,
            "peak": peak}


# ---------------------------------------------------------------------------
# phase 16: the MoE family (qwen2-moe-a2.7b) at full width
# ---------------------------------------------------------------------------

QWEN_MOE = "qwen2-moe-a2.7b"
# (site, K, N) of qwen2-moe-a2.7b's native linears (K3), one layer each, and
# the untied head; the routed stacks are dequantized, then multiplied
MOE_LINEARS = (("router", 2048, 60), ("qkv", 2048, 6144),
               ("shared_in", 2048, 11264), ("shared_out", 5632, 2048),
               ("lm_head", 2048, 151936))


def free_card(tag: str) -> None:
    """Drop what earlier phases left on the card and print what stays."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[{tag}] memory allocated at the start: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")


def phase_moe_parity(seed: int) -> dict:
    """Phase 16 (a): qwen2-moe-a2.7b's full config (24 layers, d_model 2048,
    16 heads of 128 with qkv bias, 60 routed experts top-4 of width 1408, 4
    shared, vocab 151936, untied), random weights from ``seed``, f32, TF32
    off, the float profile. At ``capacity_factor`` 16 (``cap >= tg``:
    nothing drops, as the reference's own test sets 8.0 on its smoke
    config) and ``B = 16`` (16 dispatch groups of a row each): prefill of
    31 tokens into an f32 cache, then one ``decode_step`` against
    ``forward`` over 32, ``rel < 5e-5``. Then at the published 1.25: 8
    rows of 32 tokens prefilled into a bf16 cache of 64 slots, copied into
    a paged pool of blocks of 16, and 12 greedy decode steps through K1
    (24 x 12 launches) and through the gather backend: the tokens must be
    identical, except after a step whose router top-k margin (the smallest
    gap between a token's 4th and 5th expert probability) is below 1e-6 or
    whose top-2 logit margin is below 1e-3, which is printed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile, profile_table
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import moe as MO
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype

    free_card("moe")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pub = get_config(QWEN_MOE)
    wide = dataclasses.replace(pub, moe=dataclasses.replace(
        pub.moe, capacity_factor=16.0))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = T.init_params(pub, gen, device="cuda")
    torch.cuda.synchronize()
    n_par = T.param_count(params)
    print(f"[moe] (a) {pub.name}: {n_par} parameters "
          f"({T.active_param_count(pub, params)} active), "
          f"{4 * n_par / 1e9:.2f} GB of f32 masters, drawn in "
          f"{time.perf_counter() - t0:.2f}s; allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    names = T.quant_layer_names(pub)
    dev = "cuda"

    def rel(a, b):
        return float((a - b).abs().max()) / max(1e-9, float(b.abs().max()))

    with use_compute_dtype(torch.float32):
        br = profile_table([Profile.float32(names)], names)[0]
        toks = torch.randint(0, pub.vocab, (16, 32), generator=gen, device=dev)
        hidden, aux, _ = T.forward(params, wide, br, {"tokens": toks})
        full = T._logits(wide, params, br, hidden[:, -1:])[:, 0]
        _, caches = T.prefill(params, wide, br, {"tokens": toks[:, :31]}, 36,
                              kv_bits=32)
        dec, _ = T.decode_step(params, wide, br, toks[:, 31:],
                               torch.full((16,), 31, dtype=torch.int32,
                                          device=dev), caches)
        r = rel(dec, full)
        print(f"[moe] (a) full width ({pub.n_layers} layers, d_model "
              f"{pub.d_model}, {pub.moe.n_routed} experts top-"
              f"{pub.moe.top_k}), f32, capacity factor 16: "
              f"prefill(31) + decode_step vs forward(32) at B=16 logits rel "
              f"{r:.3e} (< 5e-5: {r < 5e-5}); aux (load balance + router "
              f"z, {pub.n_layers} layers) {float(aux):.6f}")
        if not r < 5e-5 or not bool(torch.isfinite(aux)):
            raise AssertionError(f"prefill + decode != forward: rel {r}")
        del hidden, caches, full, dec
        margins: list = []
        plain_topk = MO.top_k_stable

        def watched(probs, k):           # records the step's top-k margins
            vals, idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
            margins.append(float((vals[..., k - 1] - vals[..., k]).min()))
            return vals[..., :k], idx[..., :k]

        toks = torch.randint(0, pub.vocab, (8, 32), generator=gen, device=dev)
        runs = {}
        MO.top_k_stable = watched
        try:
            for backend in ("kernel", "gather"):
                logits, caches = T.prefill(params, pub, br, {"tokens": toks},
                                           64, kv_bits=16)
                caches["kv"] = paged_from_dense(caches["kv"], 16)
                PA.paged_attention.launches = 0
                tok = logits.argmax(-1).to(torch.int32)
                out, info = [tok], []
                for i in range(12):
                    margins.clear()
                    pos = torch.full((8,), 32 + i, dtype=torch.int32,
                                     device=dev)
                    logits, caches = T.decode_step(
                        params, pub, br, tok[:, None], pos, caches,
                        paged_backend=backend)
                    top2 = logits.float().topk(2, dim=-1).values
                    info.append((min(margins),
                                 float((top2[:, 0] - top2[:, 1]).min())))
                    tok = logits.argmax(-1).to(torch.int32)
                    out.append(tok)
                runs[backend] = (torch.stack(out, 1).cpu(), info,
                                 PA.paged_attention.launches)
                del caches, logits
        finally:
            MO.top_k_stable = plain_topk
    kt, kinfo, k1 = runs["kernel"]
    gt, ginfo, g1 = runs["gather"]
    diverged = None
    for j in range(kt.shape[1]):
        if not torch.equal(kt[:, j], gt[:, j]):
            diverged = j
            break
    line = (f"[moe] (a) capacity factor {pub.moe.capacity_factor}, bf16 "
            f"paged pool (blocks of 16, "
            f"8 rows): K1 launches {k1} = {pub.n_layers} x 12: "
            f"{k1 == pub.n_layers * 12}; gather backend launches {g1}; "
            f"smallest router top-k margin {min(m for m, _ in kinfo):.3e}, "
            f"top-2 logit margin {min(t for _, t in kinfo):.3e}")
    if diverged is None:
        print(f"{line}; 13 greedy tokens per row identical")
    else:
        step = diverged - 1              # the decode step that produced it
        rm = min(kinfo[step][0], ginfo[step][0])
        lm = min(kinfo[step][1], ginfo[step][1])
        print(f"{line}; first divergence at token {diverged} (decode step "
              f"{step}): router top-k margin {rm:.3e}, top-2 logit margin "
              f"{lm:.3e}; tokens equal before it")
        if not (rm < 1e-6 or lm < 1e-3):
            raise AssertionError("K1 and gather diverge on a step with "
                                 "clear margins")
    if k1 != pub.n_layers * 12 or g1:
        raise AssertionError("the paged MoE decode did not run through K1")
    PA.paged_attention.launches = 0
    del params, runs
    torch.cuda.empty_cache()
    return {"rel_decode": r}


def phase_moe_kernels(seed: int) -> dict:
    """Phase 16 (b): the kernels at qwen2-moe-a2.7b's shapes against their
    plain versions. K5 bit for bit on one layer's routed stacks (``w_in``
    ``[60, 2048, 2816]`` f32, 346 M elements; ``w_out`` ``[60, 1408,
    2048]``) and on a prefill wave's bf16 dispatch buffer (8 x 512 tokens:
    16 groups x 60 experts x cap 22 x 2048) at bits 8 and 4, timed at 8
    beside its bytes bound; K1 at Hkv 16, Hg 1, D 128 (phase 2's tables)
    at kv16/8/4 beside SDPA (kv16) and its bound; K4 at 8 rows x 16 KV
    heads, Hg 1, D 128 at the static serve's lengths (bf16 and f32 q);
    K3 (:func:`k3_case`) at every native linear of the MoE layer and the
    head at M 8 (decode) and 4096 (a prefill wave; the head only at M 8),
    W8, the router also W4 (30-byte packed rows), each with its route,
    device time beside torch.matmul's and its bound. Returns the timed K5
    row of ``w_in`` at bits 8 and the K1/K3/K4 rows keyed by label."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.kernels import qmatmul as QM
    free_card("moe")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    f32, bf16 = torch.float32, torch.bfloat16
    rows: dict = {}
    for label, shape, std, dtype in (
            ("w_in 60x2048x2816 f32", (60, 2048, 2816), 2048 ** -0.5, f32),
            ("w_out 60x1408x2048 f32", (60, 1408, 2048), 1408 ** -0.5, f32),
            ("dispatch 16x60x22x2048 bf16", (16, 60, 22, 2048), 1.0, bf16)):
        x = (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)
        for bits in (8, 4):
            row = k5_case(f"qwen2-moe {label}", x, bits, True,
                          timed=bits == 8, cold="dispatch" in label)
            if row is not None:
                rows[f"k5 {label}"] = row
                print(f"[moe] (b) K5 {label} bits 8: {row['device_ms']:.4f} "
                      f"ms on the device, {row['bound_ms'] / row['device_ms']:.3f}"
                      f" of its bytes bound ({row['bound_ms']:.4f} ms)")
        del x
    fn, ref = PA.paged_attention, PA.paged_attention_ref
    for bits in (16, 8, 4):
        x = paged_inputs(gen, bits=bits, B=8, Hkv=16, Hg=1, D=128)
        kw = dict(bits=bits)
        lab = f"qwen2-moe Hkv 16 Hg 1 D 128 kv{bits}"
        err = check_case("K1", fn, ref, x, kw, lab)
        splits, per, rt, nrow = plan_of(PA, x)
        ms = cuda_time_ms(lambda: fn(**x, **kw))
        dev = graph_ms(lambda: fn(**x, **kw))
        plain = cuda_time_ms(lambda: ref(**x, **kw), iters=50)
        lib = lib_dev = None
        if bits == 16:
            lib, lib_dev = library_times(lambda: sdpa_fn(x))
        bd = paged_bound(x, bits)
        rows[f"k1 kv{bits}"] = {"max_abs_err": err, "ms": ms,
                                "device_ms": dev, "plain_ms": plain,
                                "library_ms": lib, **bd}
        print(f"[K1] {lab}: {splits} splits x {per} tiles, {rt} row tile(s) "
              f"of {nrow}; device {dev:.4f} ms, per call {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {_ms(lib)} (device {_ms(lib_dev)}), "
              f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
              f"{bd['bytes']} B, {bd['flops']} flop, {bd['keys']} keys)")
    for label, lens in serve_lengths(seed):
        for qdtype in (bf16, f32):
            x = qkv_inputs(gen, lens, hkv=16, hg=1, d=128, qdtype=qdtype)
            lab = (f"qwen2-moe {label} Hkv 16 Hg 1 D 128 "
                   f"{'bf16' if qdtype == bf16 else 'f32'} q")
            err = check_k4(QK, x, lab)
            if qdtype != bf16:
                continue
            copies = k4_copies(x)
            dev = k4_device_ms(QK, x, copies)
            del copies
            lib = qkv_sdpa_times(x)
            bd = qkv_bound(x["q"], x["lengths"], 1024)
            rows[f"k4 {label}"] = {"max_abs_err": err, "device_ms": dev,
                                   **lib, **bd}
            print(f"[K4] {lab}: device {dev:.4f} ms, sdpa device "
                  f"{_ms(lib['library_device_ms'])} / per call "
                  f"{_ms(lib['library_ms'])}, bound {bd['bound_ms']:.4f} ms "
                  f"({bd['bound_by']}: {bd['bytes']} B)")
    for site, k, n in MOE_LINEARS:
        for bits in ((8, 4) if site == "router" else (8,)):
            for m in ((8,) if site == "lm_head" else (8, 4096)):
                r = k3_case(gen, m, k, n, bits, bf16)
                note = " (qkv's bias is added after the kernel, as qlinear " \
                       "does)" if site == "qkv" else ""
                print(f"[moe] (b) K3 {site} M={m} W{bits}: route "
                      f"{r['route']}, device {r['device_ms']:.4f} ms, "
                      f"torch.matmul {r['library_device_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms{note}")
                rows[f"k3 {site} M={m} W{bits}"] = {
                    key: r[key] for key in ("max_abs_err", "ms", "device_ms",
                                            "plain_ms", "library_ms",
                                            "library_device_ms", "bound_ms",
                                            "bound_by", "route")}
                del r
    QM.qmatmul.launches = AQ.aquant.launches = 0   # comparisons do not count
    PA.paged_attention.launches = QK.qkv_attention.launches = 0
    return rows


def phase_moe_serve(seed: int, mode: str) -> dict:
    """Phase 16 (c): the launcher's ``--arch qwen2-moe-a2.7b --full
    --continuous`` workload (12 requests, prompts of 64–512 tokens from
    ``seed``, 32 new tokens, 8 rows, quantum 8, bf16) in one of three
    modes: ``"paged"`` — the paged kv16 pool of blocks of 16 on the kernel
    backend with fake-quant weights: K1 = 24 x decode steps, K5 = the
    image build + 96 x (steps + waves) (each forward fake-quantizes the
    dispatch buffer, ``w_in``, the hidden buffer and ``w_out`` of every
    layer); ``"kv8"`` — ``--no-paged-kv --kv-bits 8``, the contiguous int8
    pool: K4 = 24 x steps, K1 0, K5 as paged; ``"native"`` —
    ``to_native(params, 8)`` (the f32 masters freed once it is built)
    through ``AdaptiveServer`` + ``ContinuousScheduler`` on the paged
    pool: K3 = 121 x (steps + waves) (5 sites x 24 layers + the head),
    routed dequantizations = 48 x (steps + waves), K5 = 48 x (steps +
    waves), the dequantize-then-matmul branch never. The counts are zeroed
    just before the server is built, the image build's K5 read after it,
    and the rest after the serve. Every request completes with 32
    in-vocabulary tokens."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.manager import ProfileManager
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.kernels import qmatmul as QM
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.models import layers as LY
    from repro_torch.models import moe as MO
    from repro_torch.models import transformer as T
    from repro_torch.models.native import to_native
    from repro_torch.serving.engine import (AdaptiveServer, RequestStatus,
                                            ServingConfig)

    free_card("moe")
    argv = ["--arch", QWEN_MOE, "--full", "--continuous", "--requests", "12",
            "--max-new", "32", "--quantum", "8", "--seed", str(seed)]
    if mode == "kv8":
        argv += ["--no-paged-kv", "--kv-bits", "8"]
    args = S.parse_args(argv)
    nat = None
    if mode == "native":
        cfg = get_config(QWEN_MOE)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = T.init_params(cfg, gen, device="cuda")
        nat = to_native(params, 8)
        del params
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    QM.qmatmul.launches = AQ.aquant.launches = LY.dequant_matmul.calls = 0
    PA.paged_attention.launches = QK.qkv_attention.launches = 0
    A.decode_attention.kv8_einsum_calls = A.paged_view.calls = 0
    MO.routed_dequant.calls = 0
    t0 = time.perf_counter()
    if nat is None:
        cfg, srv = S.build_server(args, **CARD_SERVER)
    else:
        names = T.quant_layer_names(cfg)
        profs = paper_profiles(names, inner_layers=[])
        engine = AdaptiveEngine(tuple(profs), QuantIndex(names))
        stats = S.profile_stats(cfg, profs, T.param_count(nat))
        mgr = ProfileManager(stats, accuracy_target=0.985,
                             accuracy_floor=0.95,
                             budget_j=stats[0].energy_j
                             * args.budget_inferences, low_energy=0.5)
        srv = AdaptiveServer(cfg, nat, engine, ServingConfig(
            slots=1024, max_batch=8), manager=mgr, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    k5_build = AQ.aquant.launches
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
    mgr0 = copy.deepcopy(srv.manager)
    out = S.serve(srv, reqs, args.quantum, continuous=True)
    k1, k3, k4 = (PA.paged_attention.launches, QM.qmatmul.launches,
                  QK.qkv_attention.launches)
    k5 = AQ.aquant.launches - k5_build
    deq, routed = LY.dequant_matmul.calls, MO.routed_dequant.calls
    einsum, gathers = (A.decode_attention.kv8_einsum_calls,
                       A.paged_view.calls)
    results, sched, wall = out["results"], out["sched"], out["wall_s"]
    for i, r in enumerate(results):
        if (len(r["tokens"]) != 32
                or r["status"] is not RequestStatus.COMPLETED):
            raise AssertionError(f"qwen2-moe {mode} request {i}: "
                                 f"{len(r['tokens'])} tokens, {r['status']}")
        if not all(0 <= t < cfg.vocab for t in r["tokens"]):
            raise AssertionError(f"qwen2-moe {mode} request {i}: token out "
                                 f"of vocab")
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r["tokens"]) for r in results)
    L = cfg.n_layers
    steps = sched.decode_steps
    waves = len(sched.events) - steps          # one billing event per wave
    fw = steps + waves
    kv = T.cache_bytes(sched._caches)
    print(f"[moe] (c) {mode}: {len(results)} requests, prompts "
          f"{min(len(r.tokens) for r in reqs)}-"
          f"{max(len(r.tokens) for r in reqs)}, {n_tok} tokens in "
          f"{wall:.3f}s = {n_tok / wall:.2f} tok/s; peak memory "
          f"{peak / 2**30:.3f} GiB; server built in {t_build:.2f}s; "
          f"{steps} decode steps, {waves} prefill waves, "
          f"{sched.segments_run} segments; paged {sched.paged}; KV "
          f"{kv} B")
    want = {"k1": L * steps if mode != "kv8" else 0,
            "k4": L * steps if mode == "kv8" else 0,
            "k3": (5 * L + 1) * fw if mode == "native" else 0,
            "k5": (2 if mode == "native" else 4) * L * fw,
            "routed": 2 * L * fw if mode == "native" else 0}
    got = {"k1": k1, "k4": k4, "k3": k3, "k5": k5, "routed": routed}
    print(f"[moe] (c) {mode}: K1 {k1}, K4 {k4}, K3 {k3}, K5 {k5} after the "
          f"image build's {k5_build}, routed dequantizations {routed}; want "
          f"{want}: {got == want}; dequant-matmul calls {deq}, kv8 einsum "
          f"{einsum}, gather calls {gathers}")
    if (got != want or deq or einsum or gathers
            or sched.paged != (mode != "kv8")
            or (mode == "native") != (k5_build == 0)):
        raise AssertionError(f"the qwen2-moe {mode} serve did not run as "
                             f"counted")
    if mode == "paged":
        check_graphed("[moe] (c) paged", srv, reqs, args.quantum, out, mgr0)
    del srv, sched, out, nat
    torch.cuda.empty_cache()
    return {**got, "k5_build": k5_build, "tok_s": n_tok / wall, "peak": peak,
            "steps": steps, "waves": waves}


# ---------------------------------------------------------------------------
# phase 17: the vision-language family (qwen2-vl-2b) at full width
# ---------------------------------------------------------------------------

QWEN_VL = "qwen2-vl-2b"
# (site, K, N) of qwen2-vl-2b's linears, one layer each (the head is tied)
VLM_LINEARS = (("qkv", 1536, 2048), ("attn_out", 1536, 1536),
               ("mlp_in", 1536, 17920), ("mlp_out", 8960, 1536))
VLM_SLOTS = 544                  # 256 patches + 256 text + 31 decode writes


def vlm_texts(seed: int) -> list:
    """The text lengths (64–256 tokens) of phase 17 (c)'s 8 requests."""
    rng = np.random.default_rng(seed + 17)
    return [int(n) for n in rng.integers(64, 257, 8)]


def vlm_batch(cfg, gen, text: int, rows: int = 1) -> dict:
    """``rows`` prompts of an image (``n_patches`` patch embeddings of the
    model's width, drawn like its token table, N(0, 0.02²)) followed by
    ``text`` tokens, from ``gen`` on the card."""
    s = cfg.n_patches + text
    return {"tokens": torch.randint(0, cfg.vocab, (rows, s), generator=gen,
                                    device="cuda"),
            "patch_embeds": 0.02 * torch.randn(
                (rows, cfg.n_patches, cfg.d_model), generator=gen,
                device="cuda")}


def greedy_steps(step, tok, n: int):
    """``n`` greedy decode steps from ``tok [B]`` (``step(tok, i)`` gives
    the logits of step ``i``): the tokens ``[B, n + 1]`` (``tok`` first)
    and each step's smallest top-2 logit margin."""
    out, margins = [tok], []
    for i in range(n):
        logits = step(tok, i)
        top2 = logits.float().topk(2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, 1).cpu(), margins


def same_greedy(tag: str, what: str, a, b) -> str:
    """Two :func:`greedy_steps` runs give the same tokens, or first part
    after a step whose top-2 margin (on either side) is under 1e-3 (a
    near tie that f32 rounding may break either way); raises otherwise.
    Returns the line's verdict."""
    (ta, ma), (tb, mb) = a, b
    for j in range(ta.shape[1]):
        if not torch.equal(ta[:, j], tb[:, j]):
            m = min(ma[j - 1], mb[j - 1])
            if not m < 1e-3:
                raise AssertionError(f"[{tag}] {what}: tokens part at "
                                     f"{j} with a top-2 margin of {m:.3e}")
            return (f"first divergence at token {j} after a top-2 margin of "
                    f"{m:.3e} (< 1e-3); tokens equal before it")
    return (f"{ta.shape[1]} greedy tokens per row identical (smallest top-2 "
            f"margin {min(ma + mb):.3e})")


def phase_vlm_parity(seed: int) -> dict:
    """Phase 17 (a): qwen2-vl-2b's full config (28 layers, d_model 1536, 12
    heads of 128 over 2 KV heads with qkv bias, M-RoPE sections (16, 24,
    24), a vision prefix of 256 patches, tied head of 151936), random
    weights from ``seed``, f32, TF32 off, the float profile. M-RoPE on
    three distinct streams against a float64 evaluation of the same
    formula (``rel < 1e-4``), and text M-RoPE = RoPE bit for bit on the
    card. Prefill of an image + 44 text tokens (300 columns) into an f32
    cache, then one ``decode_step`` against ``forward`` over 301, ``rel <
    5e-5``. The same prefill into a bf16 cache of 544 slots copied into a
    paged pool of blocks of 16, then 12 greedy decode steps through K1
    (28 x 12 launches) against the gather backend; and into an int8
    contiguous cache, 12 steps through K4 (28 x 12 launches) against the
    reference's einsum: tokens identical, a divergence only after a top-2
    logit margin under 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile, profile_table
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.models import attention as A
    from repro_torch.models import rotary as R
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype

    free_card("vlm")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(QWEN_VL)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_par = T.param_count(params)
    print(f"[vlm] (a) {cfg.name}: {n_par} parameters, {4 * n_par / 1e9:.2f}"
          f" GB of f32 masters, drawn in {time.perf_counter() - t0:.2f}s")
    names = T.quant_layer_names(cfg)
    dev = "cuda"

    def rel(a, b):
        return float((a - b).abs().max()) / max(1e-9, float(b.abs().max()))

    hd, secs = cfg.hd, cfg.mrope_sections
    x = torch.randn((2, 300, cfg.n_heads, hd), generator=gen, device=dev)
    ar = torch.arange(300, device=dev)
    streams = torch.stack([ar, 7 + ar // 16, 3 + ar % 16])   # t, h, w
    pos = torch.stack([streams, streams + 5]).int()          # [2, 3, 300]
    got = R.apply_mrope(x, pos, secs, cfg.rope_theta)
    inv = 1.0 / cfg.rope_theta ** (torch.arange(
        0, hd, 2, dtype=torch.float64, device=dev) / hd)
    stream_of = torch.repeat_interleave(
        torch.arange(3, device=dev), torch.tensor(secs, device=dev))
    ang = pos.double()[:, stream_of].transpose(1, 2) * inv   # [2, 300, 64]
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.double().chunk(2, dim=-1)
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    r_mrope = rel(got.double(), want)
    p = pos[:, 0]
    text_equal = torch.equal(
        R.apply_mrope(x, R.text_mrope_positions(p), secs, cfg.rope_theta),
        R.apply_rope(x, p, cfg.rope_theta))
    print(f"[vlm] (a) apply_mrope sections {secs} on three distinct streams "
          f"(positions up to 305) vs float64: rel {r_mrope:.3e} (< 1e-4: "
          f"{r_mrope < 1e-4}); text M-RoPE = RoPE bitwise on the card: "
          f"{text_equal}")
    if not r_mrope < 1e-4 or not text_equal:
        raise AssertionError("apply_mrope disagrees with its formula")
    del x, got, want
    s0 = cfg.n_patches + 44                     # 300 columns at full width
    with use_compute_dtype(torch.float32):
        br = profile_table([Profile.float32(names)], names)[0]
        b = vlm_batch(cfg, gen, 45, rows=2)
        hidden, _, _ = T.forward(params, cfg, br, b)
        full = T._logits(cfg, params, br, hidden[:, -1:])[:, 0]
        pre = {"tokens": b["tokens"][:, :s0],
               "patch_embeds": b["patch_embeds"]}
        _, caches = T.prefill(params, cfg, br, pre, s0 + 4, kv_bits=32)
        dec, _ = T.decode_step(params, cfg, br, b["tokens"][:, s0:],
                               torch.full((2,), s0, dtype=torch.int32,
                                          device=dev), caches)
        r = rel(dec, full)
        print(f"[vlm] (a) full width ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}), f32: prefill({cfg.n_patches} patches + 44 "
              f"tokens) + decode_step vs forward({s0 + 1}) logits rel "
              f"{r:.3e} (< 5e-5: {r < 5e-5})")
        if not r < 5e-5:
            raise AssertionError(f"prefill + decode != forward: rel {r}")
        del hidden, caches, full, dec
        n_dec = 12
        pos0 = torch.full((2,), s0, dtype=torch.int32, device=dev)
        runs, counts = {}, {}
        for kv_bits, backend in ((16, "kernel"), (16, "gather"),
                                 (8, "kernel"), (8, "gather")):
            logits, caches = T.prefill(params, cfg, br, pre, VLM_SLOTS,
                                       kv_bits=kv_bits)
            if kv_bits == 16:
                caches["kv"] = paged_from_dense(caches["kv"], 16)
            PA.paged_attention.launches = QK.qkv_attention.launches = 0
            A.decode_attention.kv8_einsum_calls = A.paged_view.calls = 0

            def step(tok, i):
                out, _ = T.decode_step(params, cfg, br, tok[:, None],
                                       pos0 + i, caches,
                                       paged_backend=backend)
                return out

            runs[(kv_bits, backend)] = greedy_steps(
                step, logits.argmax(-1).to(torch.int32), n_dec)
            counts[(kv_bits, backend)] = (
                PA.paged_attention.launches, QK.qkv_attention.launches,
                A.decode_attention.kv8_einsum_calls, A.paged_view.calls)
            del caches, logits
    L = cfg.n_layers
    k1 = counts[(16, "kernel")]
    k4 = counts[(8, "kernel")]
    line = same_greedy("vlm", "K1 vs gather", runs[(16, "kernel")],
                       runs[(16, "gather")])
    print(f"[vlm] (a) bf16 paged pool (blocks of 16, {VLM_SLOTS} slots), "
          f"{n_dec} greedy steps of 2 rows: K1 launches {k1[0]} = {L} x "
          f"{n_dec}: {k1[0] == L * n_dec}; gather backend K1 "
          f"{counts[(16, 'gather')][0]}; {line}")
    line = same_greedy("vlm", "K4 vs einsum", runs[(8, "kernel")],
                       runs[(8, "gather")])
    print(f"[vlm] (a) int8 contiguous cache: K4 launches {k4[1]} = {L} x "
          f"{n_dec}: {k4[1] == L * n_dec}, kv8 einsum {k4[2]}; einsum "
          f"backend: einsum {counts[(8, 'gather')][2]}, K4 "
          f"{counts[(8, 'gather')][1]}; {line}")
    if (k1[0] != L * n_dec or k1[1:] != (0, 0, 0)
            or counts[(16, "gather")][:2] != (0, 0)
            or k4[1] != L * n_dec or k4[0] or k4[2]
            or counts[(8, "gather")][:3] != (0, 0, L * n_dec)):
        raise AssertionError("the qwen2-vl decode did not run through K1 / "
                             "K4 as counted")
    PA.paged_attention.launches = QK.qkv_attention.launches = 0
    del params, runs
    torch.cuda.empty_cache()
    return {"rel_decode": r, "rel_mrope": r_mrope}


def phase_vlm_kernels(seed: int) -> None:
    """Phase 17 (b): the kernels at qwen2-vl-2b's shapes against their plain
    versions. K1 at Hkv 2, Hg 6, D 128 (phase 2's tables) at kv16/8/4
    beside SDPA (kv16) and its bound; K4 at 8 rows x 2 KV heads, Hg 6, D
    128 over a cache of 544 slots at the lengths of (c)'s first and last
    decode steps, bf16 and f32 q, beside SDPA and its bound; K3
    (:func:`k3_case`) at the four linears at M 8 (decode) and 4096 (a
    prefill wave), W8 and W4, with routes, device times beside
    torch.matmul's and bounds; K5 bit for bit on each linear's image and
    the tied table (151936 x 1536 f32, timed) at bits 8 and 4."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.kernels import qmatmul as QM
    free_card("vlm")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    f32, bf16 = torch.float32, torch.bfloat16
    fn, ref = PA.paged_attention, PA.paged_attention_ref
    for bits in (16, 8, 4):
        x = paged_inputs(gen, bits=bits, B=8, Hkv=2, Hg=6, D=128)
        kw = dict(bits=bits)
        lab = f"qwen2-vl Hkv 2 Hg 6 D 128 kv{bits}"
        check_case("K1", fn, ref, x, kw, lab)
        splits, per, rt, nrow = plan_of(PA, x)
        ms = cuda_time_ms(lambda: fn(**x, **kw))
        dev = graph_ms(lambda: fn(**x, **kw))
        plain = cuda_time_ms(lambda: ref(**x, **kw), iters=50)
        lib = lib_dev = None
        if bits == 16:
            lib, lib_dev = library_times(lambda: sdpa_fn(x))
        bd = paged_bound(x, bits)
        print(f"[K1] {lab}: {splits} splits x {per} tiles, {rt} row tile(s) "
              f"of {nrow}; device {dev:.4f} ms, per call {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {_ms(lib)} (device {_ms(lib_dev)}), "
              f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
              f"{bd['bytes']} B, {bd['flops']} flop, {bd['keys']} keys)")
    from repro_torch.configs import get_config
    plen = [get_config(QWEN_VL).n_patches + n for n in vlm_texts(seed)]
    for label, step in (("first", 0), ("last", 30)):
        lens = [p + step + 1 for p in plen]
        for qdtype in (bf16, f32):
            x = qkv_inputs(gen, lens, hkv=2, hg=6, d=128, s=VLM_SLOTS,
                           qdtype=qdtype)
            lab = (f"qwen2-vl {label} decode step Hkv 2 Hg 6 D 128 "
                   f"{'bf16' if qdtype == bf16 else 'f32'} q")
            check_k4(QK, x, lab)
            if qdtype != bf16:
                continue
            copies = k4_copies(x)
            dev = k4_device_ms(QK, x, copies)
            del copies
            lib = qkv_sdpa_times(x)
            bd = qkv_bound(x["q"], x["lengths"], VLM_SLOTS)
            print(f"[K4] {lab}: device {dev:.4f} ms, sdpa device "
                  f"{_ms(lib['library_device_ms'])} / per call "
                  f"{_ms(lib['library_ms'])}, bound {bd['bound_ms']:.4f} ms "
                  f"({bd['bound_by']}: {bd['bytes']} B)")
    for site, k, n in VLM_LINEARS:
        for bits in (8, 4):
            for m in (8, 4096):
                r = k3_case(gen, m, k, n, bits, bf16)
                note = " (qkv's bias is added after the kernel, as qlinear " \
                       "does)" if site == "qkv" else ""
                print(f"[vlm] (b) K3 {site} M={m} W{bits}: route "
                      f"{r['route']}, device {r['device_ms']:.4f} ms, "
                      f"torch.matmul {r['library_device_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms{note}")
                del r
    images = [(f"{site} {k}x{n}", (k, n), k ** -0.5)
              for site, k, n in VLM_LINEARS]
    images.append(("tied table 151936x1536", (151936, 1536), 0.02))
    for label, shape, std in images:
        w = torch.randn(shape, generator=gen, device="cuda") * std
        for bits in (8, 4):
            k5_case(f"qwen2-vl {label}", w, bits, True,
                    timed=bits == 8 and label.startswith(("mlp_in", "tied")))
        del w
    QM.qmatmul.launches = AQ.aquant.launches = 0   # comparisons do not count
    PA.paged_attention.launches = QK.qkv_attention.launches = 0



def phase_vlm_generate(seed: int, mode: str) -> dict:
    """Phase 17 (c): a model-level generate of qwen2-vl-2b at full width in
    bf16 (the server takes token prompts only, in both packages): 8
    requests, each an image of 256 patches and 64–256 text tokens from
    ``seed``, 32 new tokens each, at the A8-W8 profile. Each request is
    prefilled alone (a wave of one: a batch puts the image in its first
    256 columns, so left-padding would cut a shorter row's image) into its
    row of one 8-row cache of 544 slots; then ``decode_segment`` runs 31
    greedy steps of all 8 rows. Modes: ``"paged"`` — a bf16 cache copied
    into a paged pool of blocks of 16, decoded on the kernel backend (K1 =
    28 x 31, K5 = the weight images, 4 x 28 + 1); ``"kv8"`` — the int8
    contiguous cache through K4 (28 x 31, no K1, no einsum); ``"native"``
    — ``to_native(params, 8)`` on the paged pool (K3 = 4 x 28 x (31
    steps + 8 waves), K1 = 28 x 31, K5 = the tied head's image, the
    dequantize-then-matmul branch never). The counts are zeroed after the
    weights are drawn; the image build's K5 is read before the prefills.
    tok/s (prefills and decode, host clock ending in a sync), peak memory
    and the KV cache's bytes."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import paper_profiles, profile_table
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.kernels import qmatmul as QM
    from repro_torch.models import attention as A
    from repro_torch.models import layers as LY
    from repro_torch.models import transformer as T
    from repro_torch.models.native import to_native

    free_card("vlm")
    cfg = get_config(QWEN_VL)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, device="cuda")
    if mode == "native":
        nat = to_native(params, 8)
        del params
        params = nat
    names = T.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    pid = [p.name for p in profs].index("A8-W8")
    table = profile_table(profs, names)[pid:pid + 1]   # its images only
    texts = vlm_texts(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 170)
    batches = [vlm_batch(cfg, gen, n) for n in texts]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    QM.qmatmul.launches = AQ.aquant.launches = LY.dequant_matmul.calls = 0
    PA.paged_attention.launches = QK.qkv_attention.launches = 0
    A.decode_attention.kv8_einsum_calls = A.paged_view.calls = 0
    t0 = time.perf_counter()
    prequant = T.prequant_decode_weights(params, cfg, table)
    torch.cuda.synchronize()
    t_img = time.perf_counter() - t0
    k5_build = AQ.aquant.launches
    over = T.overlay_params(params, prequant[0])
    kv_bits = 8 if mode == "kv8" else 16
    rows, n_dec = len(batches), 31
    t0 = time.perf_counter()
    caches = T.init_caches(cfg, rows, VLM_SLOTS, kv_bits=kv_bits,
                           device="cuda")
    kv = caches["kv"]
    tok0, pos0 = [], []
    for r, b in enumerate(batches):
        logits, one = T.prefill(over, cfg, table[0], b, VLM_SLOTS,
                                kv_bits=kv_bits)
        for f in ("k", "v", "k_scale", "v_scale", "token_idx"):
            getattr(kv, f)[:, r] = getattr(one["kv"], f)[:, 0]
        tok0.append(logits.argmax(-1).to(torch.int32))
        pos0.append(b["tokens"].shape[1])
        del one
    if mode != "kv8":
        caches["kv"] = paged_from_dense(kv, 16)
        del kv
    tok0 = torch.cat(tok0)
    ys, ok, _, _, caches = T.decode_segment(
        params, cfg, table, np.zeros(n_dec, np.int32), tok0,
        torch.tensor(pos0, dtype=torch.int32, device="cuda"), caches,
        np.full(rows, n_dec, np.int32), prequant=prequant,
        paged_backend="kernel")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = torch.cat([tok0[:, None], ys], dim=1).cpu()
    k1, k3, k4 = (PA.paged_attention.launches, QM.qmatmul.launches,
                  QK.qkv_attention.launches)
    k5 = AQ.aquant.launches - k5_build
    deq, einsum, gathers = (LY.dequant_matmul.calls,
                            A.decode_attention.kv8_einsum_calls,
                            A.paged_view.calls)
    if (toks.shape != (rows, n_dec + 1) or not bool(ok.all())
            or not bool(((toks >= 0) & (toks < cfg.vocab)).all())):
        raise AssertionError(f"qwen2-vl {mode}: tokens {toks.shape}, finite "
                             f"{ok.tolist()}")
    peak = torch.cuda.max_memory_allocated()
    kv_b = T.cache_bytes({"kv": caches["kv"]})
    L, n_tok = cfg.n_layers, toks.numel()
    want = {"k1": L * n_dec if mode != "kv8" else 0,
            "k4": L * n_dec if mode == "kv8" else 0,
            "k3": 4 * L * (n_dec + rows) if mode == "native" else 0,
            "k5": 0,
            "k5_build": 1 if mode == "native" else 4 * L + 1}
    got = {"k1": k1, "k4": k4, "k3": k3, "k5": k5, "k5_build": k5_build}
    print(f"[vlm] (c) {mode}: {rows} requests of {cfg.n_patches} patches + "
          f"{min(texts)}-{max(texts)} text tokens, {n_tok} tokens "
          f"({rows} prefill waves, {n_dec} decode steps) in {wall:.3f}s = "
          f"{n_tok / wall:.2f} tok/s; weight images built in {t_img:.2f}s; "
          f"peak memory {peak / 2**30:.3f} GiB; KV {kv_b} B "
          f"({'paged, blocks of 16' if mode != 'kv8' else 'int8 contiguous'}"
          f", {VLM_SLOTS} slots)")
    print(f"[vlm] (c) {mode}: K1 {k1}, K4 {k4}, K3 {k3}, K5 {k5} after the "
          f"image build's {k5_build}; want {want}: {got == want}; "
          f"dequant-matmul calls {deq}, kv8 einsum {einsum}, gather calls "
          f"{gathers}")
    if got != want or deq or einsum or gathers:
        raise AssertionError(f"the qwen2-vl {mode} generate did not run as "
                             f"counted")
    del params, over, prequant, caches
    torch.cuda.empty_cache()
    return {**got, "tok_s": n_tok / wall, "peak": peak, "kv_bytes": kv_b}


# ---------------------------------------------------------------------------
# phase 18: the audio family (hubert-xlarge) at full width
# ---------------------------------------------------------------------------

HUBERT = "hubert-xlarge"
# (site, K, N) of hubert-xlarge's linears, one layer each, the embed over
# 512-dim frame features and the untied head over 504 units
HUBERT_LINEARS = (("embed", 512, 1280), ("qkv", 1280, 3840),
                  ("attn_out", 1280, 1280), ("mlp_in", 1280, 5120),
                  ("mlp_out", 5120, 1280), ("lm_head", 1280, 504))


def phase_audio_parity(seed: int) -> None:
    """Phase 18 (a): hubert-xlarge's full config (48 layers, d_model 1280,
    16 heads of 80, layer norms, GELU, bidirectional, 512-dim features, 504
    units), random weights from ``seed``, f32, TF32 off, the float profile.
    The card's forward and frame logits over 2 clips of 24 frames against
    the port on the CPU (``rel < 5e-5``); then clips of 500, 317 and 93
    frames left-padded to 500 (``prompt_len``): each clip's real frames
    against its solo forward, ``rel < 5e-5``."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile, profile_table
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype

    free_card("audio")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(HUBERT)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, device="cuda")
    n_par = T.param_count(params)
    print(f"[audio] (a) {cfg.name}: {n_par} parameters, "
          f"{4 * n_par / 1e9:.2f} GB of f32 masters")
    br = profile_table([Profile.float32(T.quant_layer_names(cfg))],
                       T.quant_layer_names(cfg))[0]

    def rel(a, b):
        return float((a - b).abs().max()) / max(1e-9, float(b.abs().max()))

    with use_compute_dtype(torch.float32):
        feats = torch.randn((2, 24, cfg.feature_dim), generator=gen,
                            device="cuda")
        h, _, _ = T.forward(params, cfg, br, {"features": feats})
        lg = T._logits(cfg, params, br, h)
        cpu = _to_cpu(params)
        t0 = time.perf_counter()
        hc, _, _ = T.forward(cpu, cfg, br, {"features": feats.cpu()})
        lc = T._logits(cfg, cpu, br, hc)
        t_cpu = time.perf_counter() - t0
        del cpu
        rh, rl = rel(h.cpu(), hc), rel(lg.cpu(), lc)
        print(f"[audio] (a) full width ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}), f32: the "
              f"card's forward over 2 x 24 frames vs the CPU's "
              f"({t_cpu:.1f}s): hidden rel {rh:.3e}, frame logits "
              f"{tuple(lg.shape)} rel {rl:.3e} (< 5e-5: "
              f"{max(rh, rl) < 5e-5})")
        if not max(rh, rl) < 5e-5:
            raise AssertionError("hubert on the card != on the CPU")
        lens = [500, 317, 93]
        feats = torch.randn((3, 500, cfg.feature_dim), generator=gen,
                            device="cuda")
        h, _, _ = T.forward(params, cfg, br, {"features": feats,
                                              "prompt_len": lens})
        rels = []
        for j, n in enumerate(lens):
            solo, _, _ = T.forward(params, cfg, br, {
                "features": feats[j:j + 1, 500 - n:]})
            rels.append(rel(h[j, 500 - n:], solo[0]))
        print(f"[audio] (a) clips of {lens} frames left-padded to 500: real "
              f"frames vs each clip's solo forward, hidden rel "
              f"{', '.join(f'{r:.3e}' for r in rels)} (< 5e-5: "
              f"{max(rels) < 5e-5})")
        if not max(rels) < 5e-5:
            raise AssertionError("a ragged hubert batch != its solo clips")
    del params, h, lg, hc, lc
    torch.cuda.empty_cache()


def phase_audio_kernels(seed: int) -> None:
    """Phase 18 (b): K3 (:func:`k3_case`) at hubert-xlarge's six linears at
    M 4000 (8 clips x 500 frames: hubert always runs whole clips), W8 and
    W4 — the embed (K 512), ``qkv`` (N 3840), ``attn_out``, ``mlp_in`` (N
    5120), ``mlp_out`` and the head (N 504: 504-byte int8 and 252-byte
    packed rows, not 16-byte multiples, so mma.sync) — each with its route,
    device time beside torch.matmul's and its bound; K5 bit for bit on each
    site's weight image at bits 8 and 4 (``mlp_in`` and the head timed)."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import qmatmul as QM
    free_card("audio")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    for site, k, n in HUBERT_LINEARS:
        for bits in (8, 4):
            r = k3_case(gen, 4000, k, n, bits, torch.bfloat16)
            print(f"[audio] (b) K3 {site} M=4000 W{bits}: route "
                  f"{r['route']}, device {r['device_ms']:.4f} ms, "
                  f"torch.matmul {r['library_device_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms")
            del r
    for site, k, n in HUBERT_LINEARS:
        std = 0.02 if site == "lm_head" else k ** -0.5
        w = torch.randn((k, n), generator=gen, device="cuda") * std
        for bits in (8, 4):
            k5_case(f"hubert {site} {k}x{n}", w, bits, True,
                    timed=bits == 8 and site in ("mlp_in", "lm_head"),
                    cold=site == "mlp_in")
    QM.qmatmul.launches = AQ.aquant.launches = 0   # comparisons do not count


def phase_audio_forward(seed: int, mode: str) -> dict:
    """Phase 18 (c): hubert-xlarge's forward and frame logits at full width
    in bf16 over 8 clips x 500 frames (10 s at 50 frames/s) of seeded
    features, at the A8-W8 profile, in one of three modes: ``"fake"`` —
    the f32 masters, each linear fake-quantized per call (K5 = 48 x 4 + 2
    = 194 per forward: the layers, the embed and the head); ``"w8"`` /
    ``"w4"`` — ``to_native(params, bits)`` (K3 = 194 per forward, K5 0,
    the dequantize-then-matmul branch never). The counts are zeroed just
    before one forward and read after it; then frames/s over 3 forwards
    (host clock ending in a sync, after a warm one), the peak memory, and
    one forward under ``torch.profiler``: wall, device-busy share and the
    device operations that take the most."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import paper_profiles, profile_table
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import qmatmul as QM
    from repro_torch.models import layers as LY
    from repro_torch.models import transformer as T
    from repro_torch.models.native import to_native

    free_card("audio")
    cfg = get_config(HUBERT)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(cfg, gen, device="cuda")
    if mode != "fake":
        nat = to_native(params, int(mode[1:]))
        del params
        params = nat
    names = T.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    row = profile_table(profs, names)[[p.name for p in profs].index("A8-W8")]
    feats = torch.randn((8, 500, cfg.feature_dim), generator=gen,
                        device="cuda")
    batch = {"features": feats}

    def run():
        h, _, _ = T.forward(params, cfg, row, batch)
        return T._logits(cfg, params, row, h)

    run()                                              # warm
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    QM.qmatmul.launches = AQ.aquant.launches = LY.dequant_matmul.calls = 0
    logits = run()
    torch.cuda.synchronize()
    k3, k5, deq = (QM.qmatmul.launches, AQ.aquant.launches,
                   LY.dequant_matmul.calls)
    if (logits.shape != (8, 500, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"hubert {mode}: logits {tuple(logits.shape)}")
    L = cfg.n_layers
    want = {"k3": (4 * L + 2) if mode != "fake" else 0,
            "k5": (4 * L + 2) if mode == "fake" else 0}
    got = {"k3": k3, "k5": k5}
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fps = 3 * 8 * 500 / wall
    print(f"[audio] (c) {mode}: 8 clips x 500 frames, forward + frame logits "
          f"{tuple(logits.shape)}: {1e3 * wall / 3:.2f} ms per forward = "
          f"{fps:.1f} frames/s; peak memory {peak / 2**30:.3f} GiB; K3 {k3},"
          f" K5 {k5} per forward, want {want}: {got == want}; "
          f"dequant-matmul calls {deq}")
    if got != want or deq:
        raise AssertionError(f"the hubert {mode} forward did not run as "
                             f"counted")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) is not None
          and str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    print(f"[audio] (c) {mode}: one forward under torch.profiler: wall "
          f"{pwall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / pwall:.1f}%), {sum(e.count for e in ev)} device "
          f"kernels")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[audio] (c)   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    del params, logits, batch, feats
    torch.cuda.empty_cache()
    return {**got, "frames_s": fps, "peak": peak,
            "busy": busy / pwall}


# ---------------------------------------------------------------------------
# phase 19: LM training at granite-3-2b's full width
# ---------------------------------------------------------------------------

GRANITE = "granite-3-2b"
# granite's weight sites as paths into params["layers"] (stacked [40, K, N])
GRANITE_SITES = (("qkv", ("qkv", "w")), ("attn_out", ("attn_out", "w")),
                 ("mlp_in", ("mlp", "w_in", "w")),
                 ("mlp_out", ("mlp", "w_out", "w")))
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "train_ckpt"


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _train_batch(cfg, dev, seed: int, b: int = 2, s: int = 32) -> dict:
    """Tokens and labels from the launcher's stream, a few labels -100."""
    from repro_torch.data.tokens import TokenStream
    x = TokenStream(vocab=cfg.vocab, seq_len=s, batch=b,
                    seed=seed).batch_at(0)
    labels = x["labels"].copy()
    labels[0, :5] = -100
    return {"tokens": torch.from_numpy(x["tokens"]).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def phase_train_parity(seed: int) -> None:
    """Phase 19 (a): the granite smoke LM's ``train_loss`` and the gradient
    of every parameter leaf (``train.loop.value_and_grad``, remat on) on
    the card against the port on the CPU, in f32 with TF32 off, at A8-W8
    and Mixed (K5 on every weight site, again in the recompute): the loss
    within 1e-5, each gradient leaf within 1e-4 of its max-abs."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.core.profiles import paper_profiles, profile_table
    from repro_torch.kernels import aquant as AQ
    from repro_torch.models import transformer as T
    from repro_torch.runtime import use_compute_dtype
    from repro_torch.train.loop import _flatten, value_and_grad
    cfg = dataclasses.replace(get_smoke(GRANITE), remat=True)
    names = T.quant_layer_names(cfg)
    table = profile_table(paper_profiles(
        names, inner_layers=[n for n in names if n.startswith("L0.")]),
        names)
    params = T.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with use_compute_dtype(torch.float32):
            for pid, name in ((2, "A8-W8"), (5, "Mixed")):
                out = {}
                for dev in ("cpu", "cuda"):
                    p = _to_dev(params, dev)
                    n0 = AQ.aquant.launches
                    (loss, m), g = value_and_grad(
                        lambda p_, b_: T.train_loss(p_, cfg, table[pid], b_),
                        p, _train_batch(cfg, dev, seed))
                    torch.cuda.synchronize()
                    out[dev] = (float(loss), float(m["xent"]),
                                [t.cpu() for t in _flatten(g)[0]],
                                AQ.aquant.launches - n0)
                (l0, x0, g0, _), (l1, x1, g1, k5) = out["cpu"], out["cuda"]
                want = 1 + 2 * (4 * cfg.n_layers + 1)
                if k5 != want:
                    raise AssertionError(f"(a) K5 launched {k5} times in one "
                                         f"smoke step, not {want}")
                dl = abs(l0 - l1)
                worst = max(float((a - b).abs().max())
                            / max(float(a.abs().max()), 1e-30)
                            for a, b in zip(g0, g1))
                if dl > 1e-5 or worst > 1e-4:
                    raise AssertionError(f"(a) {name}: card vs CPU loss "
                                         f"{dl:.3g}, worst gradient leaf "
                                         f"{worst:.3g} of its max-abs")
                print(f"[train] (a) smoke {name} f32: loss {l1:.6f} (xent "
                      f"{x1:.6f}), card vs CPU {dl:.3g} (tol 1e-5); "
                      f"{len(g1)} gradient leaves, worst {worst:.3g} of its "
                      f"max-abs (tol 1e-4); K5 {k5} launches")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    AQ.aquant.launches = 0


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_train_kernels(params, n_layers: int) -> None:
    """Phase 19 (b): K5 at the training shapes, on views of the full-width
    masters: each granite site's first and last layer as a view of its
    stacked leaf and the 49155 x 2048 tied table, bit for bit in f32 and
    bf16 output, and with the scale it returns for the straight-through
    mask (layer 0 and the table timed over cold copies); then K5 replayed
    by ``torch.utils.checkpoint``'s recompute on ``mlp_in``'s view: the
    recomputed output bitwise the forward's, the gradient equal to the one
    without the checkpoint, the stream's workspace left zeroed."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.core.quantizers import fake_quant_dynamic
    from repro_torch.kernels import aquant as AQ
    views = []
    for site, path in GRANITE_SITES:
        leaf = _at(params["layers"], path)
        views += [(f"{site} layer 0 view {tuple(leaf[0].shape)}", leaf[0],
                   True),
                  (f"{site} layer {n_layers - 1} view", leaf[-1], False)]
    views.append((f"tied table {tuple(params['embed']['w'].shape)}",
                  params["embed"]["w"], True))
    for label, x, timed in views:
        k5_case(f"(b) {label}", x, 8, True, timed, cold=True)
        for od in (torch.float32, torch.bfloat16):
            got, s = AQ.aquant(x, 8, True, return_scale=True, out_dtype=od)
            want, ws = AQ.aquant_ref(x, 8, True, return_scale=True,
                                     out_dtype=od)
            view = torch.int16 if od == torch.bfloat16 else torch.int32
            if not (torch.equal(got.view(view), want.view(view))
                    and torch.equal(s, ws)):
                raise AssertionError(f"(b) K5 with its scale differs at "
                                     f"{label} -> {od}")
            del got, want
        print(f"[train] (b) {label}: with return_scale, output and scale "
              f"bitwise equal (f32 and bf16 out)")
    w = _at(params["layers"], ("mlp", "w_in", "w"))
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(64, w.shape[1], generator=gen, device="cuda")
    seen, grads = [], []
    last = w.shape[0] - 1

    def f(wl, x):
        q = fake_quant_dynamic(wl.unbind(0)[last], 8,
                               out_dtype=torch.bfloat16)
        seen.append(q.detach().clone())
        return (x.to(torch.bfloat16) @ q).float().square().sum()

    for ck in (False, True):
        wl = w.detach().requires_grad_(True)
        n0 = AQ.aquant.launches
        loss = checkpoint(f, wl, x, use_reentrant=False) if ck else f(wl, x)
        (g,) = torch.autograd.grad(loss, wl)
        torch.cuda.synchronize()
        n = AQ.aquant.launches - n0
        if n != (2 if ck else 1):
            raise AssertionError(f"(b) K5 launched {n} times, checkpoint "
                                 f"{ck}")
        grads.append(g[last].clone())
        del g, loss
    pool, _ = AQ._WS[torch.cuda.current_device()]
    if not (len(seen) == 3 and all(torch.equal(seen[0].view(torch.int16),
                                               t.view(torch.int16))
                                   for t in seen[1:])
            and torch.equal(grads[0], grads[1])
            and int(pool.abs().sum()) == 0):
        raise AssertionError("(b) K5 in the checkpoint recompute differs")
    print(f"[train] (b) K5 inside a checkpoint recompute on mlp_in's layer "
          f"{last} view: the recomputed bf16 image bitwise the forward's, the "
          f"gradient equal to the plain backward's, the workspace zero")
    del seen, grads, x
    AQ.aquant.launches = 0


def k5_per_step(cfg, bits_row, seq: int) -> int:
    """K5's launches in one training step, from the code: the embed's
    table, each layer site and the head once per loss chunk (the tied
    table) where the weight grid is at most 16 bits; remat's recompute
    runs the layer sites and the head's chunks again."""
    from repro_torch.models import transformer as T
    eb, hb, lb = T.split_bits(cfg, bits_row)
    q = lambda b: int(int(b[1]) < 17)
    layers = sum(q(lb[l, s]) for l in range(cfg.n_layers)
                 for s in range(lb.shape[1]))
    chunks = seq // min(cfg.loss_chunk, seq)
    once = q(eb) + layers + chunks * q(hb)
    return once + (layers + chunks * q(hb) if cfg.remat else 0)


def _step_counter(run, rec: list):
    """The launcher's step, recording each step's profile and K5
    launches."""
    from repro_torch.kernels import aquant as AQ
    make = run.step_factory

    def factory(loss_fn, acfg):
        step = make(loss_fn, acfg)

        def counted(params, opt, batch):
            n0 = AQ.aquant.launches
            out = step(params, opt, batch)
            rec.append((batch["profile_id"], AQ.aquant.launches - n0))
            return out
        return counted
    return factory


def _trace_step(tag: str, run, params, opt, step: int) -> None:
    """One more training step under ``torch.profiler``: wall time,
    device-busy share, K5's share and the top device operations."""
    from torch.profiler import ProfilerActivity, profile
    train_step = run.step_factory(run.loss_fn, run.adam_cfg)
    batch = run.data_at(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = train_step(params, opt, batch)
        float(m["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) is not None
          and str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    k5 = [e for e in ev if K5_KERNEL in e.key]
    k5_ms = sum(e.self_device_time_total for e in k5) / 1e3
    print(f"[train] {tag} one step under torch.profiler (profile "
          f"{batch['profile_id']}): wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}%), "
          f"{sum(e.count for e in ev)} device kernels; K5 ({K5_KERNEL}) "
          f"{k5_ms:.3f} ms in {sum(e.count for e in k5)} kernels, "
          f"{100 * k5_ms / max(busy, 1e-9):.1f}% of the device time")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[train] {tag}   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def phase_train_full(seed: int) -> dict:
    """Phase 19 (b) and (c): granite-3-2b as published (40 layers, d_model
    2048, vocab 49155, tied), from seed ``seed``, through the launcher's
    setup and the port's ``train()``: bf16 compute over f32 masters, B 8 x
    S 512, AdamW in place, remat on, the six profiles in turn, 2 warm-up
    steps then 6 timed. Prints every loss (finite), tokens/s and ms per
    step on the host clock (each step ends in the loss's read-back), the
    peak of ``torch.cuda.max_memory_allocated``, K5's launches per step
    against :func:`k5_per_step`, then one more step under the profiler.
    Returns K5's launches over the 8 steps."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    free_card("train")
    args = LT.parse_args(["--full", "--steps", "8", "--batch", "8", "--seq",
                          "512", "--seed", str(seed)])
    run = LT.setup(args)
    n = T.param_count(run.params)
    print(f"[train] (c) {run.cfg.name}: {n} parameters, "
          f"{4 * n / 1e9:.2f} GB of f32 masters, remat {run.cfg.remat} "
          f"({run.cfg.remat_policy}), loss chunk "
          f"{min(run.cfg.loss_chunk, args.seq)}")
    phase_train_kernels(run.params, run.cfg.n_layers)
    rec: list = []
    run.step_factory = _step_counter(run, rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    AQ.aquant.launches = 0
    out = run.run(log=lambda s: print(f"[train] (c) {s[8:]}"))
    torch.cuda.synchronize()
    launches = AQ.aquant.launches
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    if len(hist) != 8 or not np.isfinite(hist).all():
        raise AssertionError(f"(c) losses {hist}")
    for i, (pid, k5) in enumerate(rec):
        want = k5_per_step(run.cfg, run.engine.bits_row(pid), args.seq)
        print(f"[train] (c) step {i} profile "
              f"{run.engine.profile_names[pid]}: loss {hist[i]:.6f}, "
              f"{out['times'][i] * 1e3:.1f} ms, K5 {k5} launches (from the "
              f"code: {want})")
        if k5 != want:
            raise AssertionError(f"(c) step {i}: K5 {k5} != {want}")
    if launches != sum(k for _, k in rec):
        raise AssertionError("(c) K5 launches outside the steps")
    timed = out["times"][2:]
    ms = 1e3 * float(np.mean(timed))
    tok = args.batch * args.seq
    print(f"[train] (c) full width, B {args.batch} x S {args.seq}: "
          f"{ms:.1f} ms per step (mean of {len(timed)} after 2 warm-up, "
          f"min {1e3 * min(timed):.1f}, max {1e3 * max(timed):.1f}), "
          f"{tok / ms * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB ({peak} B); K5 {launches} launches in 8 "
          f"steps; loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    _trace_step("(c)", run, out["params"], out["opt"], 8)
    AQ.aquant.launches = 0
    del run, out
    free_card("train")
    return {"k5": launches}


def phase_train_compressed(seed: int) -> None:
    """Phase 19 (d): (c) with ``--grad-compression`` for 3 steps (1 warm-up,
    2 timed): ms per step, peak memory, and the error-feedback invariant
    on ``attn_out``'s leaf at every step: the sent int8 · scale plus the
    new residual equals the gradient plus the old residual (the residual
    is ``corrected − q·s`` itself, so within 1e-6 of the leaf's max)."""
    from repro_torch.launch import train as LT
    path = ("layers", "attn_out", "w")
    orig = LT.compress_tree
    errs = []

    def checked(grads, state, gen, release=False):
        total = _at(grads, path) + _at(state.residual, path)
        q, s, st = orig(grads, state, gen, release=release)
        sent = _at(q, path).float() * _at(s, path)
        errs.append(float(((sent + _at(st.residual, path)) - total).abs()
                          .max() / total.abs().max()))
        del total, sent
        return q, s, st

    args = LT.parse_args(["--full", "--steps", "3", "--batch", "8", "--seq",
                          "512", "--seed", str(seed), "--grad-compression"])
    run = LT.setup(args)
    LT.compress_tree = checked
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run.run(log=lambda s: None)
        torch.cuda.synchronize()
    finally:
        LT.compress_tree = orig
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    if len(hist) != 3 or not np.isfinite(hist).all() or max(errs) > 1e-6:
        raise AssertionError(f"(d) losses {hist}, invariant {errs}")
    ms = 1e3 * float(np.mean(out["times"][1:]))
    print(f"[train] (d) --grad-compression, full width, B {args.batch} x S "
          f"{args.seq}: "
          f"{ms:.1f} ms per step (mean of 2 after 1 warm-up), peak memory "
          f"{peak / 2**30:.2f} GiB ({peak} B); losses "
          f"{', '.join(f'{h:.6f}' for h in hist)}; error feedback on "
          f"attn_out: |sent + residual - (gradient + old residual)| <= "
          f"{max(errs):.3g} of its max")
    del run, out
    free_card("train")


def phase_train_restart(seed: int) -> None:
    """Phase 19 (e): restart bit for bit on the card, at granite's
    published widths cut to 2 layers (40 layers' masters and moments would
    write 30 GB per checkpoint), B 8 x S 512, bf16: an uninterrupted run of
    3 steps; a run on a checkpoint directory that receives SIGTERM during
    step 1, checkpoints it and exits; a run that resumes from it and fails
    at step 2 (``fail_at_step``); a run that resumes again and finishes.
    The final parameters and moments equal the uninterrupted run's bit for
    bit, and so do the last step's loss. The last resume's peak of
    allocated memory above what was allocated before its setup is at most
    the uninterrupted run's (the restore allocates no moments before it
    reads, and the handed-over initial weights go before it)."""
    import dataclasses
    import os
    import shutil
    import signal
    from repro_torch.checkpoint.manager import latest_step
    from repro_torch.launch import train as LT
    from repro_torch.train.loop import _flatten
    get_config = LT.get_config
    LT.get_config = lambda a: dataclasses.replace(get_config(a), n_layers=2)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    base = ["--full", "--steps", "3", "--batch", "8", "--seq", "512",
            "--seed", str(seed)]
    t0 = time.perf_counter()

    def peak_of(launch):
        torch.cuda.synchronize()
        base_b = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = launch()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base_b

    try:
        ref, ref_peak = peak_of(
            lambda: LT.setup(LT.parse_args(base)).run(log=lambda s: None))
        d = ["--ckpt-dir", str(TRAIN_DIR)]
        run = LT.setup(LT.parse_args(base + d))
        data_at = run.data_at

        def sigterm_at_1(step):
            if step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return data_at(step)
        run.data_at = sigterm_at_1
        logs = []
        pre = run.run(log=logs.append)
        if pre["last_step"] != 1 or latest_step(str(TRAIN_DIR)) != 1:
            raise AssertionError(f"(e) SIGTERM: last step "
                                 f"{pre['last_step']}, checkpoint "
                                 f"{latest_step(str(TRAIN_DIR))}")
        run = LT.setup(LT.parse_args(base + d))
        run.train_cfg = dataclasses.replace(run.train_cfg, fail_at_step=2)
        try:
            run.run(log=logs.append)
            raise AssertionError("(e) the injected failure did not raise")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        del pre, run
        res, res_peak = peak_of(
            lambda: LT.setup(LT.parse_args(base + d)).run(log=logs.append))
    finally:
        LT.get_config = get_config
    same = [torch.equal(a, b) for tree in ("params", "mu", "nu")
            for a, b in zip(
                _flatten(ref[tree] if tree == "params"
                         else getattr(ref["opt"], tree))[0],
                _flatten(res[tree] if tree == "params"
                         else getattr(res["opt"], tree))[0])]
    if not all(same) or res["history"] != ref["history"][2:] or \
            int(res["opt"].step) != 3:
        raise AssertionError(f"(e) resumed run differs: {sum(same)} of "
                             f"{len(same)} leaves equal, losses "
                             f"{res['history']} vs {ref['history']}")
    if res_peak > ref_peak + 2**20:
        raise AssertionError(f"(e) the resume's peak {res_peak} B exceeds "
                             f"the uninterrupted run's {ref_peak} B")
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(TRAIN_DIR) for f in fs)
    print(f"[train] (e) 2 layers at published widths: SIGTERM during step "
          f"1 checkpointed step 1 and exited; the resumed run failed at "
          f"step 2 as injected; resumed again, its {len(same)} parameter "
          f"and moment leaves equal the uninterrupted run's bit for bit "
          f"(last loss {res['history'][-1]:.6f}); "
          f"{' | '.join(l for l in logs if 'resumed' in l or 'preempted' in l)}"
          f"; {nbytes / 1e9:.2f} GB on disk, {time.perf_counter() - t0:.1f}s")
    print(f"[train] (e) peak allocated above the setup's start: "
          f"uninterrupted run {ref_peak / 2**30:.3f} GiB ({ref_peak} B), "
          f"last resume (setup, restore, 1 step) {res_peak / 2**30:.3f} GiB "
          f"({res_peak} B)")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    del ref, res
    free_card("train")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


# ---------------------------------------------------------------------------
# phase 20: the hot-path analysis on the card
# ---------------------------------------------------------------------------

def phase_static_gate(seed: int) -> dict:
    """Phase 20 (a): the port's static gate on the card
    (``repro_torch.analysis.check_static``'s stages): the lint clean, every
    budget point passing on the kernel backend (its largest output and
    ceiling printed) and tripping the view check on the gather backend,
    and the scenario audit. K1 launches = layers x steps over the greedy
    points, K2 = layers x windows at the speculative one. Returns the
    failures (reported after (b) runs) and the launch counts."""
    from repro_torch.analysis import budgets as BG
    from repro_torch.analysis import check_static as CS
    from repro_torch.kernels import paged_attention as PA

    failed = []
    if CS.run_lint(None):
        failed.append("lint")
    dev = torch.device("cuda")
    with torch.no_grad():
        parts = BG.smoke_parts(device=dev, seed=seed)
    cfg = parts[0]
    PA.paged_attention.launches = PA.paged_attention_multi.launches = 0
    if CS.run_budgets(parts, dev):
        failed.append("budgets")
    k1, k2 = PA.paged_attention.launches, PA.paged_attention_multi.launches
    want1 = sum(cfg.n_layers * b.steps for b in BG.REFERENCE_BUDGETS
                if not b.draft_k)
    want2 = sum(cfg.n_layers * b.steps for b in BG.REFERENCE_BUDGETS
                if b.draft_k)
    print(f"[gate] budget traces: K1 launches {k1} (= {want1}), K2 "
          f"{k2} (= {want2})")
    if (k1, k2) != (want1, want2):
        failed.append("budget launches")
    for b in BG.REFERENCE_BUDGETS:
        g = BG.check_budget(parts, b, backend="gather", device=dev)
        print(f"[gate] {b.name} gather: max out {g.max_bytes:,} B, view "
              f"{b.view_bytes(cfg):,} B, ceiling {b.max_out_bytes:,} B, "
              f"view present: {g.gather_view}")
        if not g.gather_view:
            failed.append(f"{b.name} gather view")
    if CS.run_scenarios(parts, dev):
        failed.append("scenarios")
    return {"failed": failed, "k1": k1, "k2": k2}


def phase_segment_trace(seed: int) -> dict:
    """Phase 20 (b): granite-3-2b as phase 4 builds it (40 layers, bf16,
    ``slots=1024``, 8 rows, bs 16), its 8 rows admitted from phase 4's
    requests, then one 8-step kv16 ``decode_segment`` through
    ``AdaptiveServer.segment`` under ``trace_ops``, on the kernel path and
    then the gather path: the largest output, the view, ``verify_in_place``
    on the pool's per-layer K/V, transfers per segment, aten ops per step,
    K1 launches (= 40 x 8 on the kernel path, 0 on the gather path)."""
    from repro_torch.analysis import budgets as BG
    from repro_torch.analysis import op_check as O
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import serve as S
    from repro_torch.models import attention as A
    from repro_torch.serving.scheduler import ContinuousScheduler

    free_card("trace")
    args = S.parse_args(["--continuous", "--full", "--requests", "12",
                         "--max-new", "32", "--kv-bits", "16",
                         "--quantum", "8", "--block-size", "16",
                         "--seed", str(seed)])
    cfg, srv = S.build_server(args, **CARD_SERVER)
    sched = ContinuousScheduler(srv, quantum=args.quantum)
    for r in S.make_requests(cfg, args, **CARD_PROMPTS):
        sched.submit(r)
    n_adm = sched.admit()
    torch.cuda.synchronize()
    steps = args.quantum
    kv = sched._caches["kv"]
    b, slots_p = kv.block_table.shape[1], kv.block_table.shape[2] * kv.k.shape[2]
    dims = (b, slots_p, cfg.n_kv)
    out, failed = {}, []
    for backend in ("kernel", "gather"):
        srv.paged_backend = backend
        plan = sched._plan(steps)
        PA.paged_attention.launches = A.paged_view.calls = 0
        with torch.no_grad():
            rep = O.verify_in_place(
                srv.segment, BG.pool_carries(sched._caches["kv"]), plan,
                sched._tok, sched._pos, sched._caches, sched.remaining,
                after=lambda res: BG.pool_carries(res[-1]["kv"]))
        torch.cuda.synchronize()
        _, _, sched._tok, sched._pos, sched._caches = rep.trace.result
        sched.remaining = sched.remaining - np.minimum(sched.remaining, steps)
        tr = O.count_transfers(rep.trace)
        view = O.has_adjacent_dims(rep.trace, dims)
        ops = len(rep.trace) / steps
        k1 = PA.paged_attention.launches
        top = sorted(O.count_ops(rep.trace).items(), key=lambda kv_: -kv_[1])
        print(f"[trace] {backend}: {cfg.n_layers} layers, {b} rows "
              f"({n_adm} admitted), {steps} steps: max out "
              f"{O.max_out_bytes(rep.trace):,} B, gather view "
              f"{'present' if view else 'absent'}, in place "
              f"{'ok' if rep.ok else 'no'} ({len(rep.moved)} carries moved, "
              f"{len(rep.allocations)} allocations of a layer's K or V), "
              f"transfers per segment d2h {tr.d2h} h2d {tr.h2d}, "
              f"{ops:.1f} aten ops per step, K1 launches {k1}, "
              f"paged_view calls {A.paged_view.calls}")
        print(f"[trace] {backend}: top ops {top[:8]}")
        out[backend] = {"max_bytes": O.max_out_bytes(rep.trace), "view": view,
                        "in_place": rep.ok, "d2h": tr.d2h, "h2d": tr.h2d,
                        "ops_per_step": ops, "k1": k1}
    srv.paged_backend = "kernel"
    # the graphed path: a warm segment captures its profile ids, then the
    # same plan replays under the trace (graph replays dispatch no aten op)
    g = sched.graphs
    plan = sched._plan(steps)
    with torch.no_grad():
        _, _, sched._tok, sched._pos, sched._caches = srv.segment(
            plan, sched._tok, sched._pos, sched._caches, sched.remaining,
            graphs=g)
    sched.remaining = sched.remaining - np.minimum(sched.remaining, steps)
    caps = g.capture_count()
    PA.paged_attention.launches = A.paged_view.calls = 0
    with torch.no_grad():
        rep = O.verify_in_place(
            lambda *a: srv.segment(*a, graphs=g),
            BG.pool_carries(sched._caches["kv"]), plan, sched._tok,
            sched._pos, sched._caches, sched.remaining,
            after=lambda res: BG.pool_carries(res[-1]["kv"]))
    torch.cuda.synchronize()
    tr = O.count_transfers(rep.trace)
    out["graphed"] = {"max_bytes": O.max_out_bytes(rep.trace),
                      "view": O.has_adjacent_dims(rep.trace, dims),
                      "in_place": rep.ok, "d2h": tr.d2h, "h2d": tr.h2d,
                      "ops_per_step": len(rep.trace) / steps,
                      "k1": PA.paged_attention.launches, "captures": caps,
                      "captured_in_trace": g.capture_count() - caps}
    gr = out["graphed"]
    print(f"[trace] graphed: {caps} captures ({g.captured}) in the warm "
          f"segment, {gr['captured_in_trace']} in the traced one; max out "
          f"{gr['max_bytes']:,} B, gather view "
          f"{'present' if gr['view'] else 'absent'}, in place "
          f"{'ok' if gr['in_place'] else 'no'}, transfers per segment d2h "
          f"{gr['d2h']} h2d {gr['h2d']}, {gr['ops_per_step']:.1f} aten ops "
          f"per step (eager kernel path {out['kernel']['ops_per_step']:.1f})"
          f", K1 launches {gr['k1']} (launches per capture x replays)")
    print(f"[trace] graphed: ops {sorted(O.count_ops(rep.trace).items())}")
    kern, gath = out["kernel"], out["gather"]
    if kern["view"] or not kern["in_place"]:
        failed.append("kernel path view or in-place")
    if kern["k1"] != cfg.n_layers * steps or gath["k1"] != 0:
        failed.append(f"K1 launches {kern['k1']} / {gath['k1']}")
    if not gath["view"] or gath["in_place"]:
        failed.append("the gather path went unseen")
    if (gr["view"] or not gr["in_place"] or gr["k1"] != cfg.n_layers * steps
            or gr["captured_in_trace"] or not caps
            or (gr["d2h"], gr["h2d"]) != (0, 1)):
        failed.append(f"graphed path {gr}")
    del sched, srv
    free_card("trace")
    return {"failed": failed, "k1": kern["k1"] + gr["k1"], "trace": out}


# ---------------------------------------------------------------------------
# phase 21: multi-device over a gloo group of ranks on the one card
# ---------------------------------------------------------------------------

DISTRIB_DIR = Path(__file__).resolve().parent / "build" / "distrib"
DISTRIB_RANKS = 4
DISTRIB_MB = 8                   # (b): microbatches of one row
TOY = dict(L=8, D=16, B=12)      # (a): the reference test's toy pipeline


def toy_inputs(seed: int):
    rng = np.random.default_rng(seed)
    d = TOY["D"]
    ws = rng.standard_normal((TOY["L"], d, d)) / np.sqrt(d)
    x = rng.standard_normal((TOY["B"], d))
    return (torch.from_numpy(ws.astype(np.float32)),
            torch.from_numpy(x.astype(np.float32)))


def toy_stage(sp, h):
    for w in sp["w"]:
        h = torch.tanh(h @ w)
    return h


def granite_setup(seed: int, n_layers=None):
    """granite-3-2b as published (or cut to ``n_layers``, depth only) from
    ``seed``, its A8-W8 bits row and ``(B 8, S 512)`` tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.models import transformer as T
    cfg = get_config(GRANITE)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device("cuda")
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                           device=dev)
    names = T.quant_layer_names(cfg)
    eng = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names))
    bits = eng.bits_row(eng.profile_id("A8-W8"))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (8, 512)).astype(np.int64)).to(dev)
    return cfg, params, bits, tokens


def stack_by_microbatch(cfg, layers, layer_bits, x0):
    """The single-process stack over each microbatch of one row (the
    activation fake-quant is per tensor, so a microbatch is a batch)."""
    from repro_torch.models import transformer as T
    return torch.cat([T.layer_stack(cfg, layers, layer_bits, x0[i:i + 1])
                      for i in range(x0.shape[0])])


def _distrib_rank(rank: int, world: int, pg: str, seed: int) -> None:
    """Phase 21's rank ``rank`` of ``world`` (a spawned process on card 0,
    a gloo group): (a) the toy pipeline, (b) granite-3-2b's 40 layers in 4
    stages of 10, f32 then bf16 (a warm-up, then a timed run), (c)
    ``compressed_psum`` of its own gradients. Writes
    ``DISTRIB_DIR/rank<r>.pt``."""
    import torch.distributed as dist
    from repro_torch import runtime
    from repro_torch.distrib import pipeline as P
    from repro_torch.distrib.pipeline import pipeline_forward, stage_split
    from repro_torch.kernels import aquant as AQ
    from repro_torch.models import transformer as T
    from repro_torch.optim.compression import (compress_tree,
                                               compressed_psum,
                                               init_error_feedback)
    from repro_torch.train.loop import value_and_grad
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{pg}", rank=rank,
                            world_size=world)
    dev = torch.device("cuda")
    res: dict = {}
    # (a) the toy pipeline on the card
    ws, x = (t.to(dev) for t in toy_inputs(seed))
    res["toy"] = pipeline_forward(toy_stage,
                                  stage_split({"w": ws}, world)[rank], x,
                                  n_microbatches=4).cpu()
    # (b) granite-3-2b, 10 layers per stage
    cfg, params, bits, tokens = granite_setup(seed)
    _, _, layer_bits = T.split_bits(cfg, bits)
    n = cfg.n_layers // world
    stage = _clone(stage_split(params["layers"], world)[rank])
    embed = {"embed": params["embed"]}
    del params
    torch.cuda.empty_cache()
    bits_s = layer_bits[rank * n:(rank + 1) * n]

    def fn(sp, xm):
        return T.layer_stack(cfg, sp, bits_s, xm)
    hops: list = []
    exchange = P.exchange

    def timed_exchange(send, dst, recv, src, group=None):
        """The pipeline's hop, timed alone: (bytes sent, seconds)."""
        if send is None:
            return exchange(send, dst, recv, src, group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exchange(send, dst, recv, src, group)
        hops.append((send.numel() * send.element_size(),
                     time.perf_counter() - t0))
        return out
    P.exchange = timed_exchange
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with runtime.use_compute_dtype(dt):
            x0, _, _ = T._embed_inputs(cfg, embed, bits, {"tokens": tokens})
            if name == "bf16":                     # warm-up
                pipeline_forward(fn, stage, x0, n_microbatches=DISTRIB_MB)
            hops.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            AQ.aquant.launches = 0
            t0 = time.perf_counter()
            y = pipeline_forward(fn, stage, x0, n_microbatches=DISTRIB_MB)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            res[name] = {"k5": AQ.aquant.launches, "want": 4 * n * DISTRIB_MB,
                         "ms": ms, "hops": list(hops),
                         "peak": torch.cuda.max_memory_allocated(),
                         "y": y.cpu() if rank == 0 else None}
    P.exchange = exchange
    del stage, embed, x0, y
    torch.cuda.empty_cache()
    # (c) compressed_psum of each rank's gradients (2 layers, full width)
    cfg, params, bits, _ = granite_setup(seed, n_layers=2)
    from repro_torch.data.tokens import TokenStream
    b = TokenStream(vocab=cfg.vocab, seq_len=128, batch=2,
                    seed=seed).batch_at(rank)
    batch = {k: torch.from_numpy(b[k]).to(dev) for k in ("tokens", "labels")}
    (_, _), grads = value_and_grad(
        lambda p, bt: T.train_loss(p, cfg, bits, bt), params, batch)
    del params
    gseed = 1000 * seed + rank
    q, s, _ = compress_tree(grads, init_error_feedback(grads),
                            torch.Generator(dev).manual_seed(gseed))
    res["q"] = {k: v.cpu() for k, v in _flat_items(q)}
    res["s"] = {k: v.cpu() for k, v in _flat_items(s)}
    del q, s
    wire = [4 * g.numel() for _, g in _flat_items(grads)]   # f32 payloads
    state = init_error_feedback(grads)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    mean, _ = compressed_psum(grads, state,
                              torch.Generator(dev).manual_seed(gseed))
    torch.cuda.synchronize()
    res["psum"] = {"ms": 1e3 * (time.perf_counter() - t0),
                   "wire": sum(wire), "leaves": len(wire),
                   "mean": ({k: v.cpu() for k, v in _flat_items(mean)}
                            if rank == 0 else None)}
    torch.save(res, DISTRIB_DIR / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _flat_items(tree, pre=""):
    for k in sorted(tree):
        v, p = tree[k], f"{pre}/{k}" if pre else k
        if isinstance(v, dict):
            yield from _flat_items(v, p)
        else:
            yield p, v


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def phase_distrib_reference(seed: int) -> dict:
    """Phase 21's single-process references on the card: the toy stack, and
    granite-3-2b's 40-layer stack over each microbatch in f32 (TF32 off)
    and, timed, in bf16."""
    from repro_torch import runtime
    from repro_torch.models import transformer as T
    free_card("distrib")
    dev = torch.device("cuda")
    ws, x = (t.to(dev) for t in toy_inputs(seed))
    toy = x
    for w in ws:
        toy = torch.tanh(toy @ w)
    out = {"toy": toy.cpu()}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, bits, tokens = granite_setup(seed)
    out["n_layers"] = cfg.n_layers
    _, _, layer_bits = T.split_bits(cfg, bits)
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with runtime.use_compute_dtype(dt):
            x0, _, _ = T._embed_inputs(cfg, params, bits, {"tokens": tokens})
            if name == "bf16":                     # warm-up
                stack_by_microbatch(cfg, params["layers"], layer_bits, x0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = stack_by_microbatch(cfg, params["layers"], layer_bits, x0)
            torch.cuda.synchronize()
            out[name] = {"y": y.cpu(), "ms": 1e3 * (time.perf_counter() - t0)}
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    del params, x0, y
    free_card("distrib")
    return out


def phase_distrib_dryrun() -> None:
    """Phase 21 (d): the dry run on meta, qwen2-72b and qwen1.5-110b at
    train_4k and decode_32k on the 256- and 512-device meshes (a cell's
    meta run is shared by its two meshes): status, per-device argument
    bytes beside this card's memory, flops per device."""
    from repro_torch.launch import dryrun as D
    cap = torch.cuda.get_device_properties(0).total_memory
    runs: dict = {}
    for arch in ("qwen2-72b", "qwen1.5-110b"):
        for shape in ("train_4k", "decode_32k"):
            for mesh in ("pod1", "pod2"):
                t0 = time.perf_counter()
                rec = D.run_cell(arch, shape, mesh, native_bits=None,
                                 kv_bits=16, analysis=False, verbose=False,
                                 runs=runs)
                if rec["status"] != "ok":
                    raise AssertionError(f"(d) {arch} x {shape} x {mesh}: "
                                         f"{rec}")
                prod = rec["production"]
                arg = prod["memory"]["argument_bytes"]
                print(f"[distrib] (d) {arch} x {shape} x {mesh} on meta: "
                      f"{rec['status']}, {rec['devices']} devices, "
                      f"per-device arguments {arg} B = {arg / cap:.3f} of "
                      f"this card's {cap} B, outputs "
                      f"{prod['memory']['output_bytes']} B, flops per "
                      f"device {prod['flops']:.4e}, layout collectives "
                      f"{prod['collectives']['total']} B per device, "
                      f"{time.perf_counter() - t0:.1f}s")


def phase_distrib(seed: int) -> dict:
    """Phase 21: (a)-(c) on ``DISTRIB_RANKS`` spawned ranks sharing card 0
    through a gloo group, with (d) run in this process meanwhile; the
    ranks' results held against the single-process references. Returns
    K5's launches over the ranks' timed bf16 pipeline run."""
    import shutil
    import torch.multiprocessing as mp
    ref = phase_distrib_reference(seed)
    shutil.rmtree(DISTRIB_DIR, ignore_errors=True)
    DISTRIB_DIR.mkdir(parents=True)
    ctx = mp.start_processes(
        _distrib_rank, args=(DISTRIB_RANKS, str(DISTRIB_DIR / "pg"), seed),
        nprocs=DISTRIB_RANKS, join=False, start_method="spawn")
    try:
        phase_distrib_dryrun()
        deadline = time.monotonic() + 600
        while not ctx.join(timeout=10):
            if time.monotonic() > deadline:
                raise AssertionError("phase 21: the ranks did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = [torch.load(DISTRIB_DIR / f"rank{r}.pt", weights_only=False)
           for r in range(DISTRIB_RANKS)]
    failed = []
    # (a)
    err_a = max(float((r["toy"] - ref["toy"]).abs().max()) for r in res)
    print(f"[distrib] (a) toy pipeline (L {TOY['L']}, D {TOY['D']}, B "
          f"{TOY['B']}, {DISTRIB_RANKS} stages, 4 microbatches) on the card "
          f"vs the sequential stack: max |diff| {err_a:.3e} on every rank")
    if err_a > 1e-5:
        failed.append(f"(a) {err_a}")
    # (b)
    for name in ("f32", "bf16"):
        want = res[0][name]["want"]          # 4 sites x layers x microbatches
        y, y_ref = res[0][name]["y"], ref[name]["y"]
        rel = float((y.float() - y_ref.float()).abs().max()
                    / y_ref.float().abs().max())
        same = torch.equal(y, y_ref)
        k5 = [r[name]["k5"] for r in res]
        ms = max(r[name]["ms"] for r in res)
        hops = [h for r in res for h in r[name]["hops"]]
        hop_b = sorted({h[0] for h in hops})
        hop_ms = [1e3 * h[1] for h in hops]
        peaks = [r[name]["peak"] for r in res]
        print(f"[distrib] (b) granite-3-2b, {ref['n_layers']} layers in "
              f"{DISTRIB_RANKS} "
              f"stages, {DISTRIB_MB} microbatches of 1 x 512, {name}, A8-W8 "
              f"fake-quant: pipeline vs the single-process stack rel "
              f"{rel:.3e} ({'bitwise' if same else 'not bitwise'}); K5 "
              f"launches per rank {k5} (= {want}), {sum(k5)} in all")
        print(f"[distrib] (b) {name}: pipeline {ms:.1f} ms (slowest rank) vs "
              f"sequential {ref[name]['ms']:.1f} ms, bubble "
              f"{DISTRIB_RANKS - 1}/{DISTRIB_MB + DISTRIB_RANKS - 1}; "
              f"{len(hops)} hops of {hop_b} B, ms per hop median "
              f"{np.median(hop_ms):.3f} (min {min(hop_ms):.3f}, max "
              f"{max(hop_ms):.3f}); peak memory per rank "
              f"{[f'{p / 2**30:.2f}' for p in peaks]} GiB; four processes "
              f"share one card through host-staged gloo hops")
        # both runs go through the same kernels at the same shapes: the
        # bf16 run, whose launches and times are reported, must be bitwise
        if rel > 1e-5 or (name == "bf16" and not same):
            failed.append(f"(b) {name} rel {rel}, bitwise {same}")
        if k5 != [want] * DISTRIB_RANKS:
            failed.append(f"(b) {name} K5 {k5}")
    # (c)
    dev = torch.device("cuda")
    worst = 0.0
    for path, got in res[0]["psum"]["mean"].items():
        acc = None
        for r in res:
            qs = r["q"][path].to(dev).float() * r["s"][path].to(dev)
            acc = qs if acc is None else acc + qs
        plain = acc / DISTRIB_RANKS
        err = float((got.to(dev) - plain).abs().max()
                    / plain.abs().max().clamp_min(1e-30))
        worst = max(worst, err)
    ps = [r["psum"] for r in res]
    print(f"[distrib] (c) compressed_psum over {DISTRIB_RANKS} ranks, "
          f"granite-3-2b widths at 2 layers, B 2 x S 128 per rank: "
          f"{ps[0]['leaves']} leaves, {ps[0]['wire']} B of f32 payload on "
          f"the wire per rank, {max(p['ms'] for p in ps):.1f} ms per "
          f"reduction (slowest rank, compress included); vs the plain mean "
          f"of the ranks' q.s on the card: worst leaf {worst:.3e} of its "
          f"max-abs")
    if worst > 1e-6:
        failed.append(f"(c) {worst}")
    shutil.rmtree(DISTRIB_DIR, ignore_errors=True)
    if failed:
        raise AssertionError(f"phase 21: {failed}")
    return {"k5": sum(r["bf16"]["k5"] for r in res)}


# ---------------------------------------------------------------------------
# phase 22: the decode segment replayed from CUDA graphs
# ---------------------------------------------------------------------------

# (label, the launcher's arguments, native weight bits or None); a mode
# without --continuous serves the static path (AdaptiveServer.serve)
SPEC4 = ["--speculate", "--draft-k", "4"]
GRAPH_MODES = (("kv16 paged", ["--continuous", "--kv-bits", "16"], None),
               ("kv8 paged", ["--continuous", "--kv-bits", "8"], None),
               ("kv4 paged", ["--continuous", "--kv-bits", "4"], None),
               ("kv8 contiguous", ["--continuous", "--kv-bits", "8",
                                   "--no-paged-kv"], None),
               ("native W8", ["--continuous", "--kv-bits", "16"], 8),
               ("spec kv16 paged", ["--continuous", "--kv-bits", "16",
                                    *SPEC4], None),
               ("spec kv8 paged", ["--continuous", "--kv-bits", "8",
                                   *SPEC4], None),
               ("spec kv8 contiguous", ["--continuous", "--kv-bits", "8",
                                        "--no-paged-kv", *SPEC4], None))


@contextlib.contextmanager
def sync_errors():
    """``torch.cuda.set_sync_debug_mode("error")`` while the block runs:
    a synchronizing CUDA call raises (a capture's own synchronize is let
    through by ``serving/graphs.py::cuda_capture``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def watch_segments(srv, schedules: list, guard: bool,
                   name: str = "segment", skip: int = 0) -> None:
    """Record every decode segment's schedule on ``srv`` and, with
    ``guard``, run each under :func:`sync_errors` (an instance attribute
    shadowing ``AdaptiveServer.<name>``; ``delattr(srv, name)``
    restores). ``name`` is ``"segment"``, ``"segment_spec"`` (the guard
    then leaves out the flush before the segment, which syncs by design)
    or ``"decode_static"`` (the static path's decode, whose first
    ``skip=1`` profile id is the prefill's)."""
    orig = getattr(srv, name)

    def segment(schedule, *a, **k):
        schedules.append([int(p) for p in schedule][skip:])
        if not guard:
            return orig(schedule, *a, **k)
        with sync_errors():
            return orig(schedule, *a, **k)
    setattr(srv, name, segment)


def served(out, srv=None) -> dict:
    """What an eager and a graphed serve must agree on: each request's
    tokens, profile trace and status, the billing events (a speculative
    scheduler's ``spec_billed`` too), the admission order and the ledger's
    spent energy. A static serve (no scheduler) has tokens, traces and
    the ledger of ``srv``."""
    sched = out["sched"]
    if sched is None:
        return {"tokens": [r["tokens"] for r in out["results"]],
                "traces": [r["profile_trace"] for r in out["results"]],
                "spent_j": (None if srv.manager is None
                            else srv.manager.spent_j)}
    got = {"tokens": [r["tokens"] for r in out["results"]],
           "traces": [r["profile_trace"] for r in out["results"]],
           "status": [r["status"].value for r in out["results"]],
           "events": list(sched.events),
           "admission": list(sched.admission_log),
           "spent_j": (None if sched.srv.manager is None
                       else sched.srv.manager.spent_j)}
    if sched.spec:
        got["spec_billed"] = list(sched.spec_billed)
    return got


def graph_counts(graphs: list, schedules: list) -> dict:
    """A graphed serve's captures against the profile ids its segments
    used: one capture per distinct id in each graph set (a scheduler's
    one set, or the static path's one per group shape), none of an id
    already captured, one lifetime each."""
    if not graphs:
        raise AssertionError("the serve did not run on segment graphs")
    used = sorted({p for s in schedules for p in s})
    caps = []
    for g in graphs:
        if len(set(g.captured)) != len(g.captured) or \
                sorted(g.captured) != sorted(g.used):
            raise AssertionError(f"captures {g.captured} for profile ids "
                                 f"{sorted(g.used)}")
        if g.lifetimes != 1:
            raise AssertionError(f"{g.lifetimes} pool lifetimes in one serve")
        caps += g.captured
    if sorted(set(caps)) != used:
        raise AssertionError(f"captures {caps} for profile ids {used}")
    return {"captures": len(caps), "pids": used,
            "replays": sum(g.replays for g in graphs)}


def check_graphed(tag: str, srv, reqs, quantum: int, graphed, mgr0) -> None:
    """The families' (c) check: ``graphed``, the launcher's serve of
    ``reqs`` on ``srv`` (segment graphs, the default on the card), equals
    the same serve through the eager segment (``graphs=False``) from the
    same manager state ``mgr0`` (:func:`served`); one capture per profile
    id the segments used (:func:`graph_counts`)."""
    from repro_torch.launch import serve as S

    sched = graphed["sched"]
    want = served(graphed)
    g = graph_counts([sched.graphs], [[p] for p in sched.graphs.used])
    srv.manager = copy.deepcopy(mgr0)
    out = S.serve(srv, reqs, quantum, continuous=True,
                  sched_kw={"graphs": False})
    if out["sched"].graphs is not None:
        raise AssertionError(f"{tag}: the eager serve ran on graphs")
    got = served(out)
    for key in got:
        if got[key] != want[key]:
            raise AssertionError(f"{tag}: eager and graphed serves differ "
                                 f"in {key}")
    n_tok = sum(len(t) for t in got["tokens"])
    print(f"{tag}: eager = graphed (tokens, traces, statuses, "
          f"{len(want['events'])} events, admission order, ledger); "
          f"captures {g['captures']} = profile ids {g['pids']}, replays "
          f"{g['replays']}; eager {out['wall_s']:.3f}s = "
          f"{n_tok / out['wall_s']:.2f} tok/s, graphed "
          f"{graphed['wall_s']:.3f}s = {n_tok / graphed['wall_s']:.2f} "
          f"tok/s")


def profile_segment(srv, reqs, quantum: int, graphs: bool) -> dict:
    """One steady decode segment (8 rows admitted, a warm segment first:
    its captures) under ``torch.profiler``: wall and device-busy ms, and
    the captures the profiled segment made (0: the caller serves one
    profile)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(srv, quantum=quantum, graphs=graphs)
    for r in reqs:
        sched.submit(r)
    sched.admit()
    sched.run_segment()
    sched._flush()
    before = 0 if sched.graphs is None else sched.graphs.capture_count()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.run_segment()
        sched._flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) is not None
          and str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    after = 0 if sched.graphs is None else sched.graphs.capture_count()
    del sched
    return {"wall_ms": wall, "busy_ms": busy, "captures": after - before,
            "kernels": sum(e.count for e in ev)}


def phase_graphs(seed: int) -> dict:
    """Phase 22: granite-3-2b at full width on phase 4's workload (the
    launcher's ``--full``, 12 requests of 64–512 tokens, 32 new tokens, 8
    rows, quantum 8, bf16) through ``--continuous`` at kv16, kv8 and kv4
    paged, kv8 contiguous and native W8, and with ``--speculate
    --draft-k 4`` at kv16 and kv8 paged and kv8 contiguous, each served
    eagerly (``graphs=False``) and then from CUDA graphs (the decode
    step's, the draft/verify window's), one manager state for both:
    tokens, traces, statuses, events, ``spec_billed``, admission order and
    the ledger equal; captures = the distinct profile ids the segments
    used, none of an id already captured, in one pool lifetime; every
    graphed segment (the speculative segment without the flush before it)
    under ``set_sync_debug_mode("error")``; K1 (paged), K2 (speculative
    paged), K4 (contiguous) or K3 (native) launches as counted on the
    eager path, equal on the graphed one; billed = delivered when
    speculating; peak memory within 10 % of the eager serve's; tok/s of
    both; and for kv16 paged, one steady segment of each without the
    manager (one profile) under ``torch.profiler`` (wall, device busy,
    busy share, 0 captures). The static path: :func:`phase_static_graphs`."""
    import gc
    from repro_torch.launch import serve as S
    from repro_torch.models.native import to_native
    from repro_torch.serving import graphs as G
    from repro_torch.serving.engine import AdaptiveServer

    out = {}
    for label, extra, w_bits in GRAPH_MODES:
        free_card("graphs")
        spec = "--speculate" in extra
        args = S.parse_args(["--full", "--requests", "12",
                             "--max-new", "32", "--quantum", "8",
                             "--block-size", "16", "--seed", str(seed),
                             *extra])
        cfg, srv = S.build_server(args, **CARD_SERVER)
        if w_bits is not None:
            nat = to_native(srv.params, w_bits)
            srv = AdaptiveServer(cfg, nat, srv.engine, srv.scfg,
                                 manager=srv.manager, device="cuda")
            del nat
        gc.collect()
        reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
        mgr0 = copy.deepcopy(srv.manager)
        watched = "segment_spec" if spec else "segment"
        runs = {}
        for path in ("eager", "graphed"):
            graphed = path == "graphed"
            srv.manager = copy.deepcopy(mgr0)
            schedules: list = []
            watch_segments(srv, schedules, guard=graphed, name=watched)
            c0 = [getattr(f, a) for f, a in G.counters()]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res = S.serve(srv, reqs, args.quantum, continuous=True,
                          sched_kw={"graphs": graphed})
            delattr(srv, watched)
            counts = {f"{f.__name__}.{a}": getattr(f, a) - c
                      for (f, a), c in zip(G.counters(), c0)}
            sched = res["sched"]
            sets = [sched.graphs] if graphed else []
            runs[path] = {"served": served(res, srv), "wall": res["wall_s"],
                          "peak": torch.cuda.max_memory_allocated(),
                          "counts": counts,
                          "steps": sum(len(x) for x in schedules),
                          "segments": len(schedules),
                          "billed": (None if not spec else
                                     len(sched.admission_log) + sum(
                                         n for _, n in sched.spec_billed)),
                          "graphs": (graph_counts(sets, schedules)
                                     if graphed else None)}
            if not graphed and sched.graphs is not None:
                raise AssertionError(f"{label}: the eager serve ran on graphs")
            del res, sched, sets         # the graphs hold the server
        e, g = runs["eager"], runs["graphed"]
        for key in e["served"]:
            if e["served"][key] != g["served"][key]:
                raise AssertionError(f"[graphs] {label}: eager and graphed "
                                     f"differ in {key}")
        if e["counts"] != g["counts"] or e["steps"] != g["steps"]:
            raise AssertionError(f"[graphs] {label}: launches eager "
                                 f"{e['counts']} graphed {g['counts']}")
        paged = "--no-paged-kv" not in extra
        kname = ("qmatmul.launches" if w_bits else
                 "paged_attention_multi.launches" if spec else
                 "qkv_attention.launches" if not paged
                 else "paged_attention.launches")
        per = (4 if w_bits else 1) * cfg.n_layers
        if w_bits:
            waves = len(g["served"]["events"]) - g["steps"]
            want = per * (g["steps"] + waves)
        elif spec and not paged:
            want = 0              # plain window attention: no kernel
        else:
            want = per * g["steps"]
        if g["counts"][kname] != want:
            raise AssertionError(f"[graphs] {label}: {kname} "
                                 f"{g['counts'][kname]} != {want}")
        n_tok = sum(len(t) for t in g["served"]["tokens"])
        if spec and not e["billed"] == g["billed"] == n_tok:
            raise AssertionError(f"[graphs] {label}: billed {g['billed']} "
                                 f"!= delivered {n_tok}")
        ratio = g["peak"] / e["peak"]
        unit = "windows" if spec else "decode steps"
        what = (f"statuses, {len(g['served']['events'])} events, "
                f"admission order, ")
        if spec:
            what += f"spec_billed, billed = delivered {n_tok}, "
        print(f"[graphs] {label}: eager = graphed (tokens, traces, {what}"
              f"ledger "
              f"{g['served']['spent_j']:.6e} J); {kname} {g['counts'][kname]}"
              f" = {want} on both; captures {g['graphs']['captures']} = "
              f"profile ids {g['graphs']['pids']}, replays "
              f"{g['graphs']['replays']}, {g['segments']} segments, "
              f"{g['steps']} {unit}; {n_tok} tokens: eager "
              f"{e['wall']:.3f}s = {n_tok / e['wall']:.2f} tok/s, graphed "
              f"{g['wall']:.3f}s = {n_tok / g['wall']:.2f} tok/s "
              f"({e['wall'] / g['wall']:.2f}x); peak memory eager "
              f"{e['peak'] / 2**30:.3f} GiB, graphed {g['peak'] / 2**30:.3f}"
              f" GiB ({ratio:.4f})")
        if ratio > 1.10:
            raise AssertionError(f"[graphs] {label}: graphed peak memory "
                                 f"{ratio:.3f} x the eager serve's")
        row = {"eager_tok_s": n_tok / e["wall"], "graphed_tok_s":
               n_tok / g["wall"], "peak_ratio": ratio,
               "captures": g["graphs"]["captures"], kname: want}
        if label == "kv16 paged":
            srv.manager = None               # one profile: a steady segment
            for path, graphed in (("eager", False), ("graphed", True)):
                p = profile_segment(srv, reqs[:8], args.quantum, graphed)
                row[path] = p
                print(f"[graphs] {label}: one steady segment {path} (8 "
                      f"steps x {cfg.n_layers} layers, 8 rows): wall "
                      f"{p['wall_ms']:.2f} ms, device busy "
                      f"{p['busy_ms']:.2f} ms "
                      f"({100 * p['busy_ms'] / p['wall_ms']:.1f}%), "
                      f"{p['kernels']} device kernels, captures in it "
                      f"{p['captures']}")
                if p["captures"]:
                    raise AssertionError(f"[graphs] a steady {path} segment "
                                         f"captured {p['captures']}")
        out[label] = row
        del srv
    free_card("graphs")
    return out


def watch_prefills(srv, graphed: bool, guard: bool) -> tuple:
    """Record the host wall (ms, no sync) of each static-path prefill on
    ``srv``: the eager ``_prefill`` (an instance attribute), or graphed
    ``StaticGraphs.prefill_group`` (the class's, under
    :func:`sync_errors` with ``guard``). Returns ``(walls, restore)``."""
    from repro_torch.serving import graphs as G

    walls: list = []
    owner, name = (G.StaticGraphs, "prefill_group") if graphed else \
        (srv, "_prefill")
    orig = getattr(owner, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        with (sync_errors() if guard else contextlib.nullcontext()):
            out = orig(*a, **k)
        walls.append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(owner, name, timed)

    def restore():
        if graphed:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)
    return walls, restore


def pool_bytes(pool) -> int | None:
    """The bytes the caching allocator holds in the private memory pool
    ``pool`` (a graph pool handle), from its segments in
    ``torch.cuda.memory_snapshot()``; ``None`` where the snapshot does not
    name a segment's pool."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(x["total_size"] for x in segs
               if tuple(x["segment_pool_id"]) == tuple(pool))


class WholeWrites(TorchDispatchMode):
    """Count in-place ops whose destination is a whole tensor of
    ``leaves`` (same storage start, same size): a copy into the static
    path's kept cache would be one."""

    def __init__(self, leaves):
        super().__init__()
        self.leaves = {(x.data_ptr(), x.numel()) for x in leaves}
        self.hits: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dst = args[0] if args else None
        if (func._schema.name.endswith("_") and isinstance(dst, torch.Tensor)
                and (dst.data_ptr(), dst.numel()) in self.leaves):
            self.hits.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def _static_parts(srv) -> dict:
    """Captures and replays of each part of each group shape's static set
    (prefill, decode, step)."""
    return {name: (len(part.captured), part.replays)
            for g, _ in srv.static_graphs.values()
            for name, part in zip(("prefill", "decode", "step"), g.parts())}


def phase_static_graphs(seed: int) -> dict:
    """Phase 22's static path: granite-3-2b at full width, the launcher's
    static server at ``--kv-bits 8`` on phase 4's 12 requests (64–512
    tokens, 32 new, groups of 8 rows), served in two passes on one server,
    each pass eagerly (``graphs=False``) and then graphed, every serve
    from one manager state. The graphed path replays each group's prefill
    from the graph of its exact key (written straight into the group
    shape's kept cache) and its decode steps from one graph per profile
    id. Per pass: tokens, traces and the ledger equal; the kernels'
    counters equal (K4 = 40 × decode steps); pass 1 captures each prefill
    key and decode profile id once, pass 2 nothing, its prefill replays
    and every graphed decode under ``set_sync_debug_mode("error")``; the
    prefill's host wall summed, tok/s, peak memory of both, the reserved
    memory and the graph pool's bytes. The kept cache: its leaves are the
    prefill and decode graphs' and stay put over both passes, and no op of
    pass 2's graphed serve writes one of them whole. Then ``stepwise
    kv8``: ``generate_stepwise`` on 8 rows of one prompt length, 32
    tokens, managed, eager then graphed (the uniform prefill key, one step
    graph per profile id): tokens, trace, ledger and K4 equal, step
    captures = the profile ids used, per-token host wall of both; and
    :func:`prefill_replay_probe`. Reserved memory is read after
    ``empty_cache``: live tensors and the graphs' pools."""
    import gc
    from repro_torch.analysis.tracker import (assert_static_executables,
                                              static_captures)
    from repro_torch.launch import serve as S
    from repro_torch.serving import graphs as G

    free_card("graphs")
    args = S.parse_args(["--full", "--requests", "12", "--max-new", "32",
                         "--quantum", "8", "--block-size", "16", "--seed",
                         str(seed), "--kv-bits", "8"])
    cfg, srv = S.build_server(args, **CARD_SERVER)
    gc.collect()
    reqs = S.make_requests(cfg, args, **CARD_PROMPTS)
    mgr0 = copy.deepcopy(srv.manager)
    kname, label = "qkv_attention.launches", "[graphs] static kv8"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = [torch.cuda.memory_reserved()]
    row, ptrs = {}, None
    for i in (1, 2):
        runs = {}
        for path in ("eager", "graphed"):
            graphed = path == "graphed"
            srv.manager = copy.deepcopy(mgr0)
            schedules: list = []
            watch_segments(srv, schedules, guard=graphed,
                           name="decode_static", skip=1)
            walls, restore = watch_prefills(srv, graphed, graphed and i == 2)
            c0 = [getattr(f, a) for f, a in G.counters()]
            p0 = _static_parts(srv)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res = S.serve(srv, reqs, args.quantum, continuous=False,
                          sched_kw={"graphs": graphed})
            restore()
            delattr(srv, "decode_static")
            counts = {f"{f.__name__}.{a}": getattr(f, a) - c
                      for (f, a), c in zip(G.counters(), c0)}
            p1 = _static_parts(srv)
            runs[path] = {
                "served": served(res, srv), "wall": res["wall_s"],
                "peak": torch.cuda.max_memory_allocated(), "counts": counts,
                "steps": sum(len(x) for x in schedules),
                "groups": len(schedules), "prefill_ms": sum(walls),
                "parts": {k: (p1[k][0] - p0.get(k, (0, 0))[0],
                              p1[k][1] - p0.get(k, (0, 0))[1]) for k in p1}}
            if not graphed and p1 != p0:
                raise AssertionError(f"{label}: the eager serve ran on "
                                     f"graphs")
            del res
        e, g = runs["eager"], runs["graphed"]
        for key in e["served"]:
            if e["served"][key] != g["served"][key]:
                raise AssertionError(f"{label} pass {i}: eager and graphed "
                                     f"differ in {key}")
        if e["counts"] != g["counts"] or e["steps"] != g["steps"]:
            raise AssertionError(f"{label} pass {i}: launches eager "
                                 f"{e['counts']} graphed {g['counts']}")
        want = cfg.n_layers * g["steps"]
        if g["counts"][kname] != want:
            raise AssertionError(f"{label} pass {i}: {kname} "
                                 f"{g['counts'][kname]} != {want}")
        assert_static_executables(srv)
        parts = g["parts"]
        if i == 1:
            pids = sorted({p for x in schedules for p in x})
            (gset, kept), = srv.static_graphs.values()
            if parts["decode"][0] != len(pids) or parts["prefill"][0] < 1:
                raise AssertionError(f"{label} pass 1: captures {parts} "
                                     f"for decode profile ids {pids}")
            ptrs = G._leaves(kept)
            if not (gset._pool_leaves == ptrs
                    == gset.prefill._pool_leaves[:len(ptrs)]):
                raise AssertionError(f"{label}: the prefill and decode "
                                     f"graphs do not share the kept cache")
        elif any(c for c, _ in parts.values()):
            raise AssertionError(f"{label} pass 2 captured: {parts}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
        (gset, kept), = srv.static_graphs.values()
        pool = pool_bytes(gset.pool)
        n_tok = sum(len(t) for t in g["served"]["tokens"])
        ratio = g["peak"] / e["peak"]
        print(f"{label} pass {i}: eager = graphed (tokens, traces, ledger "
              f"{g['served']['spent_j']:.6e} J); {kname} "
              f"{g['counts'][kname]} = {want} on both; {g['groups']} "
              f"groups, {g['steps']} decode steps; captures / replays: "
              f"prefill {parts['prefill'][0]} / {parts['prefill'][1]}, "
              f"decode {parts['decode'][0]} / {parts['decode'][1]}; prefill "
              f"host wall summed eager {e['prefill_ms']:.2f} ms, graphed "
              f"{g['prefill_ms']:.2f} ms; {n_tok} tokens: eager "
              f"{e['wall']:.3f}s = {n_tok / e['wall']:.2f} tok/s, graphed "
              f"{g['wall']:.3f}s = {n_tok / g['wall']:.2f} tok/s; peak "
              f"memory eager {e['peak'] / 2**30:.3f} GiB, graphed "
              f"{g['peak'] / 2**30:.3f} GiB ({ratio:.4f}); reserved "
              f"{reserved[0]} B before the static passes, {reserved[-1]} B "
              f"now; the set's graph pool "
              f"{'not measured' if pool is None else f'{pool} B'}; "
              f"{card_line()}")
        if ratio > 1.10:
            raise AssertionError(f"{label} pass {i}: graphed peak memory "
                                 f"{ratio:.3f} x the eager serve's")
        row[f"pass {i}"] = {
            "eager_tok_s": n_tok / e["wall"], "graphed_tok_s":
            n_tok / g["wall"], "peak_ratio": ratio, "parts": parts,
            "prefill_ms": (e["prefill_ms"], g["prefill_ms"]),
            "reserved": reserved[-1], "pool_bytes": pool}
        row.setdefault(kname, want)
    # untimed: a first replay under the dispatch mode took seconds of host
    # wall on the card, so the mode stays out of the timed passes
    srv.manager = copy.deepcopy(mgr0)
    leaves = [x for _, _, x in _kept_leaves(kept)]
    p0 = _static_parts(srv)
    with WholeWrites(leaves) as mode:
        res = S.serve(srv, reqs, args.quantum, continuous=False,
                      sched_kw={"graphs": True})
    if (served(res, srv) != g["served"] or mode.hits
            or G._leaves(kept) != ptrs
            or any(c != p0[k][0] for k, (c, _) in
                   _static_parts(srv).items())):
        raise AssertionError(f"{label}: a third serve differs, captured, "
                             f"moved the kept cache or wrote a leaf whole "
                             f"({mode.hits})")
    del res
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"{label}: the kept cache of {tuple(srv.static_graphs)} (rows, "
          f"slots, kv bits), {nbytes} B, is the one the prefill and decode "
          f"graphs were captured on (data_ptr) in all passes; a third "
          f"graphed serve under a dispatch mode (untimed): the same "
          f"results, no capture, 0 in-place ops over a whole leaf (nothing "
          f"copies into the kept cache)")
    out = {"static kv8": row,
           "stepwise kv8": phase_stepwise_graphs(srv, cfg, reqs, mgr0)}
    assert_static_executables(srv)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved.append(torch.cuda.memory_reserved())
    print(f"[graphs] static kv8 + stepwise: captures {static_captures(srv)};"
          f" reserved {reserved[0]} B before, {reserved[-1]} B after; the "
          f"graph pool {pool_bytes(gset.pool)} B; {card_line()}")
    row["replay_probe"] = prefill_replay_probe(srv, cfg, reqs)
    del srv, gset, kept
    free_card("graphs")
    return out


def _kept_leaves(kept: dict) -> list:
    return [(k, f.name, getattr(c, f.name)) for k, c in sorted(kept.items())
            for f in dataclasses.fields(c)
            if isinstance(getattr(c, f.name), torch.Tensor)]


def prefill_replay_probe(srv, cfg, reqs) -> dict:
    """The host wall of one static prefill graph's replays: on a
    ``StaticGraphs`` of its own (outside ``srv.static_graphs``, so the
    audited sets keep their counts), one key of 8 rows at the longest
    request's length, half of them padding, is captured (a real run plus
    the capture), then replayed three times, each replay's host wall (no
    sync) and time to the device's end beside the eager prefill's; the
    set is dropped after."""
    import gc
    from repro_torch.serving import engine as E
    from repro_torch.serving import graphs as G

    rows = CARD_SERVER["max_batch"]
    s = max(len(r.tokens) for r in reqs)
    prompts = np.random.default_rng(s).integers(
        0, cfg.vocab, (rows, s)).astype(np.int32)
    plen = np.where(np.arange(rows) < rows // 2, s, 0).astype(np.int32)
    probe = G.StaticGraphs(srv, rows, E.STATIC_STEPS)

    def timed(fn) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

    def replay():
        probe.prefill_group(0, prompts, plen)
    cap = timed(replay)
    reps = [timed(replay) for _ in range(3)]
    eager = [timed(lambda: srv._prefill(0, prompts, srv.scfg.slots, plen))
             for _ in range(2)]
    if probe.prefill.captured != [("static", 0, rows, s, 0)] or \
            probe.prefill.replays != 3:
        raise AssertionError(f"[graphs] replay probe: captures "
                             f"{probe.prefill.captured}, replays "
                             f"{probe.prefill.replays}")
    print(f"[graphs] static kv8 replay probe: one prefill graph of {rows} x "
          f"{s} tokens ({rows // 2} padding rows): capture (a real run "
          f"and the capture) {cap[1]:.2f} ms; replays, host wall / to the "
          f"device's end: "
          + ", ".join(f"{h:.2f} / {d:.2f}" for h, d in reps)
          + " ms; the eager prefill: "
          + ", ".join(f"{h:.2f} / {d:.2f}" for h, d in eager)
          + f" ms; {card_line()}")
    del probe, replay
    gc.collect()                # the set and its followers form a cycle
    return {"capture_ms": cap[1], "replays_ms": reps, "eager_ms": eager}


def phase_stepwise_graphs(srv, cfg, reqs, mgr0) -> dict:
    """Phase 22's ``stepwise kv8``: ``generate_stepwise`` on 8 rows of the
    first request's prompt length (tokens from a seed), 32 tokens, on the
    static server from manager state ``mgr0``, eager then graphed: the
    tokens, trace and ledger equal, K4 = 40 × 31 on both, the graphed
    run's captures the uniform prefill key and one step graph per profile
    id its steps used. Host walls from the loop's profile selections (one
    before the prefill, one before each step): the prefill to the first
    step, and per token the steps' mean (captures included) and
    median."""
    from repro_torch.serving import graphs as G

    s = len(reqs[0].tokens)
    prompts = np.random.default_rng(s).integers(
        0, cfg.vocab, (CARD_SERVER["max_batch"], s)).astype(np.int32)
    n_new, kname = 32, "qkv_attention.launches"
    runs = {}
    for path in ("eager", "graphed"):
        graphed = path == "graphed"
        srv.manager = copy.deepcopy(mgr0)
        stamps: list = []
        select = srv._select_profile

        def stamped(critical, select=select, stamps=stamps):
            stamps.append(time.perf_counter())
            return select(critical)
        srv._select_profile = stamped
        c0 = [getattr(f, a) for f, a in G.counters()]
        p0 = _static_parts(srv)
        torch.cuda.synchronize()
        res = srv.generate_stepwise(prompts, n_new, graphs=graphed)
        end = time.perf_counter()
        del srv._select_profile
        p1 = _static_parts(srv)
        runs[path] = {"res": res, "spent_j": srv.manager.spent_j,
                      "counts": {f"{f.__name__}.{a}": getattr(f, a) - c
                                 for (f, a), c in zip(G.counters(), c0)},
                      "prefill_ms": (stamps[1] - stamps[0]) * 1e3,
                      "token_ms": (end - stamps[1]) * 1e3 / (n_new - 1),
                      "median_ms": float(np.median(np.diff(
                          stamps[1:] + [end]))) * 1e3,
                      "wall": end - stamps[0],
                      "parts": {k: p1[k][0] - p0.get(k, (0, 0))[0]
                                for k in p1}}
    e, g = runs["eager"], runs["graphed"]
    if e["res"] != g["res"] or e["spent_j"] != g["spent_j"]:
        raise AssertionError("[graphs] stepwise kv8: eager and graphed "
                             "differ")
    want = cfg.n_layers * (n_new - 1)
    if e["counts"] != g["counts"] or g["counts"][kname] != want:
        raise AssertionError(f"[graphs] stepwise kv8: launches eager "
                             f"{e['counts']} graphed {g['counts']}, "
                             f"{kname} want {want}")
    names = srv.engine.profile_names
    used = sorted({names.index(p) for p in g["res"]["profile_trace"][1:]})
    if g["parts"]["step"] != len(used) or g["parts"]["prefill"] != 1:
        raise AssertionError(f"[graphs] stepwise kv8: captures "
                             f"{g['parts']} for step profile ids {used}")
    print(f"[graphs] stepwise kv8: {prompts.shape[0]} rows x {s} tokens, "
          f"{n_new} new, "
          f"eager = graphed (tokens, trace over "
          f"{sorted(set(g['res']['profile_trace']))}, ledger "
          f"{g['spent_j']:.6e} J); {kname} {want} on both; captures: "
          f"prefill 1 (the uniform key), step {len(used)} = profile ids "
          f"{used}; per-token host wall eager {e['token_ms']:.3f} ms "
          f"(median {e['median_ms']:.3f}), graphed {g['token_ms']:.3f} ms "
          f"(median {g['median_ms']:.3f}); prefill to the first step "
          f"eager {e['prefill_ms']:.2f} ms, graphed {g['prefill_ms']:.2f} "
          f"ms; total eager {e['wall']:.3f}s, graphed {g['wall']:.3f}s; "
          f"{card_line()}")
    return {kname: want, "token_ms": (e["token_ms"], g["token_ms"]),
            "median_ms": (e["median_ms"], g["median_ms"]),
            "captures": g["parts"]}


# phase 22, the admission waves: (label, the launcher's arguments, native
# weight bits or None), each served in two passes on one scheduler
WAVE_MODES = (("kv16 paged", ["--kv-bits", "16"], None),
              ("kv8 paged, registry, chunk 128",
               ["--kv-bits", "8", "--prefill-chunk", "128"], None),
              ("kv8 contiguous", ["--kv-bits", "8", "--no-paged-kv"], None),
              ("native W8", ["--kv-bits", "16"], 8))


def second_pass(cfg, reqs, seed: int) -> list:
    """``reqs`` again with new tokens from ``seed``: the same lengths,
    budgets and classes, so the second pass's waves reuse the first's
    keys."""
    rng = np.random.default_rng(seed)
    return [dataclasses.replace(r, tokens=rng.integers(
        0, cfg.vocab, len(r.tokens)).astype(np.int32)) for r in reqs]


def watch_waves(sched, guard: bool) -> dict:
    """Record ``sched``'s admission waves (kind, whether it replayed a
    graph, K3 launches in it) and each ``admit()`` round that dispatched
    one (host wall ms, no sync; waves). With ``guard`` a replayed wave
    runs under :func:`sync_errors`."""
    from repro_torch.kernels import qmatmul as QM

    rec = {"waves": [], "rounds": []}
    wave, admit = sched._wave, sched.admit

    def watched(kind, pid, plan, pre=(), pp=0):
        w = sched.waves
        replay = w is not None and w.key(kind, pid, plan, pp) in w._graphs
        k3 = QM.qmatmul.launches
        with (sync_errors() if guard and replay
              else contextlib.nullcontext()):
            out = wave(kind, pid, plan, pre, pp)
        rec["waves"].append((kind, replay, QM.qmatmul.launches - k3))
        return out

    def timed_admit():
        n = len(rec["waves"])
        t0 = time.perf_counter()
        out = admit()
        ms = (time.perf_counter() - t0) * 1e3
        if len(rec["waves"]) > n:
            rec["rounds"].append((ms, len(rec["waves"]) - n))
        return out

    sched._wave = watched
    sched.admit = timed_admit
    return rec


def _walls(rounds) -> str:
    return "[" + ", ".join(f"{ms:.2f}" for ms, _ in rounds) + "]"


def phase_wave_graphs(seed: int) -> dict:
    """Phase 22's admission waves: granite-3-2b at its widths (at
    ``FEATURE_LAYERS`` in ``main``) on phase 4's workload through the
    scheduler at kv16 paged, kv8 paged with the
    prefix registry and ``--prefill-chunk 128`` (continuation and chunk
    waves from masters), kv8 contiguous and native W8, each served by one
    scheduler in two passes (phase 4's 12 requests, then 12 of the same
    lengths from another seed, so wave keys recur), eagerly
    (``graphs=False``) and then graphed, from one manager state. Per pass:
    tokens, traces, statuses, events, admission order and the ledger
    equal; the kernels' counters equal, K3's per wave too (native W8: 4 ×
    the layers a wave); the graphed waves capture each key once, pass 2
    none that
    pass 1 captured; every replayed wave under
    ``set_sync_debug_mode("error")``; peak memory within 10 % of the
    eager serve's. Prints each ``admit()`` round's host wall, tok/s,
    captures, replays and peak memory of both."""
    import gc
    from repro_torch.launch import serve as S
    from repro_torch.models.native import to_native
    from repro_torch.serving import graphs as G
    from repro_torch.serving.engine import AdaptiveServer
    from repro_torch.serving.scheduler import ContinuousScheduler

    out = {}
    for label, extra, w_bits in WAVE_MODES:
        free_card("waves")
        args = S.parse_args(["--full", "--continuous", "--requests", "12",
                             "--max-new", "32", "--quantum", "8",
                             "--block-size", "16", "--seed", str(seed),
                             *extra])
        cfg, srv = S.build_server(args, **CARD_SERVER)
        if w_bits is not None:
            nat = to_native(srv.params, w_bits)
            srv = AdaptiveServer(cfg, nat, srv.engine, srv.scfg,
                                 manager=srv.manager, device="cuda")
            del nat
        gc.collect()
        first = S.make_requests(cfg, args, **CARD_PROMPTS)
        passes = (first, second_pass(cfg, first, seed + 1))
        mgr0 = copy.deepcopy(srv.manager)
        runs = {}
        for path in ("eager", "graphed"):
            graphed = path == "graphed"
            srv.manager = copy.deepcopy(mgr0)
            sched = ContinuousScheduler(srv, quantum=args.quantum,
                                        graphs=graphed)
            if graphed != (sched.waves is not None):
                raise AssertionError(f"[waves] {label}: {path} serve on "
                                     f"the wrong route")
            rec = watch_waves(sched, guard=graphed)
            runs[path] = []
            for i, reqs in enumerate(passes):
                c0 = [getattr(f, a) for f, a in G.counters()]
                caps0 = len(sched.waves.captured) if graphed else 0
                rep0 = sched.waves.replays if graphed else 0
                n_w, n_r = len(rec["waves"]), len(rec["rounds"])
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                res = S.serve(srv, reqs, args.quantum, continuous=True,
                              sched=sched)
                mine = res["results"][i * len(first):]
                runs[path].append({
                    "served": served(res), "wall": res["wall_s"],
                    "peak": torch.cuda.max_memory_allocated(),
                    "counts": [getattr(f, a) - c for (f, a), c
                               in zip(G.counters(), c0)],
                    "waves": rec["waves"][n_w:],
                    "rounds": rec["rounds"][n_r:],
                    "tokens": sum(len(r["tokens"]) for r in mine),
                    "new": (list(sched.waves.captured[caps0:]) if graphed
                            else []),
                    "replays": (sched.waves.replays - rep0 if graphed
                                else 0)})
                del res, mine
            if graphed and (
                    len(set(sched.waves.captured)) != len(sched.waves.captured)
                    or set(sched.waves.captured) != sched.waves.used
                    or sched.waves.lifetimes != 1):
                raise AssertionError(
                    f"[waves] {label}: captures {sched.waves.captured} for "
                    f"the keys used {sorted(sched.waves.used)}")
            del sched, rec
            gc.collect()     # the wrappers hold the scheduler in a cycle
        row = {}
        for i in range(len(passes)):
            e, g = runs["eager"][i], runs["graphed"][i]
            tag = f"[waves] {label} pass {i + 1}"
            for key in e["served"]:
                if e["served"][key] != g["served"][key]:
                    raise AssertionError(f"{tag}: eager and graphed differ "
                                         f"in {key}")
            if e["counts"] != g["counts"]:
                raise AssertionError(f"{tag}: launches eager {e['counts']} "
                                     f"graphed {g['counts']}")
            k3 = [n for _, _, n in g["waves"]]
            want = 4 * cfg.n_layers if w_bits else 0
            if [n for _, _, n in e["waves"]] != k3 or \
                    any(n != want for n in k3):
                raise AssertionError(f"{tag}: K3 launches per wave eager "
                                     f"{[n for _, _, n in e['waves']]} "
                                     f"graphed {k3}, not {want} each")
            if i and set(g["new"]) & set(runs["graphed"][0]["new"]):
                raise AssertionError(f"{tag}: captured again a key pass 1 "
                                     f"captured: {g['new']}")
            replayed = sum(r for _, r, _ in g["waves"])
            if replayed != g["replays"]:
                raise AssertionError(f"{tag}: {replayed} replayed waves, "
                                     f"{g['replays']} replays")
            ratio = g["peak"] / e["peak"]
            kinds = sorted({k for k, _, _ in g["waves"]})
            e_ms = sum(ms for ms, _ in e["rounds"])
            g_ms = sum(ms for ms, _ in g["rounds"])
            n_tok = g["tokens"]
            print(f"{tag}: eager = graphed (tokens, traces, statuses, "
                  f"{len(g['served']['events'])} events, admission order, "
                  f"ledger {g['served']['spent_j']:.6e} J, counters; K3 "
                  f"{sum(k3)} in waves = {want} x {len(k3)}); "
                  f"{len(g['waves'])} waves {kinds} in {len(g['rounds'])} "
                  f"admit() rounds; captures {len(g['new'])} new keys, "
                  f"replays {g['replays']} (each under sync errors); "
                  f"admit() host wall per round eager {_walls(e['rounds'])}"
                  f" ms = {e_ms:.2f} ms, graphed {_walls(g['rounds'])} ms "
                  f"= {g_ms:.2f} ms; {n_tok} tokens: eager "
                  f"{e['wall']:.3f}s = {n_tok / e['wall']:.2f} tok/s, "
                  f"graphed {g['wall']:.3f}s = {n_tok / g['wall']:.2f} "
                  f"tok/s; peak memory eager {e['peak'] / 2**30:.3f} GiB, "
                  f"graphed {g['peak'] / 2**30:.3f} GiB ({ratio:.4f}), "
                  f"{card_line()}")
            if ratio > 1.10:
                raise AssertionError(f"{tag}: graphed peak memory "
                                     f"{ratio:.3f} x the eager serve's")
            row[f"pass{i + 1}"] = {
                "eager_tok_s": n_tok / e["wall"],
                "graphed_tok_s": n_tok / g["wall"],
                "eager_admit_ms": [ms for ms, _ in e["rounds"]],
                "graphed_admit_ms": [ms for ms, _ in g["rounds"]],
                "captures": len(g["new"]), "replays": g["replays"],
                "peak_ratio": ratio, "k3_waves": sum(k3)}
        row["k3_waves"] = sum(row[f"pass{i + 1}"]["k3_waves"]
                              for i in range(len(passes)))
        out[label] = row
        del srv
    free_card("waves")
    return out


def kernel_entry(name, source, replaces, launches, row, **extra) -> dict:
    """One row of the kernel table: the main path's launch count and the
    phase-2 row of the kernel at its main-path shape (every kernel also
    carries its device time from a CUDA graph, K1–K4 their split count, K4
    and K5 their step 0's device time, K5 its plan's floor and its bf16
    output's row), plus ``extra``
    keys (phase 10's launches under the precision policy, phase 11's
    under injected faults, phase 12's after restarts, phase 13's on the
    CNN path, phase 14's on the mamba2 path: K3's native W8 serve, K5's
    fake-quant one; phase 15's on the hymba path: K1's paged serve, K4's
    kv8 static serve, K3's native W8 serve, K5's fake-quant one; phase
    16's on the qwen2-moe path: K1's paged serve, K4's contiguous kv8
    serve, K3's native W8 serve, K5's fake-quant serve after its image
    build; phase 17's on the qwen2-vl path: K1's paged generate, K4's kv8
    generate, K3's native W8 generate, K5's image build; phase 18's on the
    hubert path: K3's native W8 forward, K5's fake-quant forward; phase
    19's on the training path: K5's launches over the 8 full-width
    granite steps; phase 20's under the static gate's budget traces and,
    for K1, the full-width segment traces, eager and graphed; phase 21's,
    for K5, over the four ranks' timed bf16 pipeline run; phase 22's on
    the graphed segment: K1's kv16 paged serve, K2's speculative kv16
    paged one, K4's kv8 contiguous one and its static kv8 serve, K3's
    native W8 one, and K3's in the two-pass native W8 serve's graphed
    admission waves)."""
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
    if "floor_ms" in row:
        entry["floor_ms"] = row["floor_ms"]
    if "bf16" in row:
        entry["bf16_out"] = {key: row["bf16"][key] for key in (
            "device_ms", "step0_device_ms", "ms", "plain_ms", "bound_ms",
            "floor_ms", "max_abs_err")}
    entry.update(extra)
    return entry


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,"
                            "18,19,20,21,22")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also break one full-width decode segment down "
                         "with torch.profiler")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    t_start = time.perf_counter()
    secs: dict = {}

    @contextlib.contextmanager
    def timed(n):
        t0 = time.perf_counter()
        yield
        secs[n] = time.perf_counter() - t0
        print(f"[time] phase {n}: {secs[n]:.1f}s")

    card = card_line()
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"[env] {card}")
    from repro_torch.kernels import build as B
    with timed(1):
        libs = B.build()
    for name, info in libs.items():
        print(f"[env] built {name} ({B.SOURCES[name].name}, sm_90a) in "
              f"{info['seconds']:.1f}s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[env] ptxas {name}: {line.strip()}")
    rows = {}
    if 2 in phases:
        with timed(2):
            _, rows["k1"] = phase_kernels(args.seed)
            rows["k2"] = phase_window_kernel(args.seed)
            phase_shared_tables(args.seed)
            split_sweep(args.seed)
            rows["k3"] = phase_qmatmul(args.seed)
            qmatmul_sweep(args.seed)
            qmatmul_prefill_sweep(args.seed)
            rows["k4"] = phase_qkv_attention(args.seed)
            qkv_sweep(args.seed)
            rows["k5"] = phase_aquant(args.seed)
    if 3 in phases:
        with timed(3):
            phase_parity(args.seed)
            phase_prefix_parity(args.seed)
            phase_preempt_parity(args.seed)
            phase_native_parity(args.seed)
    served = {"launches": 0}
    if 4 in phases:
        with timed(4):
            served = phase_serve(args.seed)
            phase_serve_block128(args.seed)
    spec = {"launches": 0}
    if 5 in phases:
        with timed(5):
            spec = phase_spec_serve(args.seed, served)
            phase_spec_wide(args.seed)
    native = {"k3": 0, "k5": 0}
    if 6 in phases:
        with timed(6):
            native = phase_native_serve(args.seed, 12, 32, 8)
            phase_native_serve(args.seed, 4, 16, 4)
    static = {"launches": 0}
    if 7 in phases:
        with timed(7):
            static = phase_contiguous_serve(args.seed, continuous=False)
            phase_contiguous_serve(args.seed, continuous=True)
            phase_contiguous_spec_serve(args.seed)
    if 8 in phases:
        with timed(8), cut_depth(FEATURE_LAYERS):
            phase_prefix_serve(args.seed)
    if 9 in phases:
        with timed(9), cut_depth(FEATURE_LAYERS):
            phase_preempt_serve(args.seed)
    policy = {"k1": 0, "k4": 0}
    if 10 in phases:
        with timed(10):
            phase_policy_parity(args.seed)
            path = policy_json(FEATURE_LAYERS)
            with cut_depth(FEATURE_LAYERS):
                policy["k1"] = phase_policy_serve(args.seed,
                                                  path)["launches"]
                policy["k4"] = phase_contiguous_serve(
                    args.seed, continuous=False, policy=path)["launches"]
    faults = {"k1": 0, "k2": 0, "k4": 0}
    if 11 in phases:
        with timed(11):
            faults.update(phase_fault_parity(args.seed))
            with cut_depth(FEATURE_LAYERS):
                faults["k1"] = phase_fault_serve(args.seed)["launches"]
    durable = {"k1": 0, "k2": 0}
    if 12 in phases:
        with timed(12):
            durable.update(phase_durable_parity(args.seed))
            phase_durable_serve(args.seed)
    cnn = {"k5": 0}
    if 13 in phases:
        with timed(13):
            phase_cnn_sites(args.seed)
            phase_cnn_grad(args.seed)
            cnn = phase_cnn_paper(args.seed)
            phase_cnn_profile(args.seed)
    mamba2 = {"k3": 0, "k5": 0}
    if 14 in phases:
        with timed(14):
            phase_ssm_parity(args.seed)
            phase_ssm_kernels(args.seed)
            mamba2["k5"] = phase_ssm_serve(args.seed)["k5"]
            mamba2["k3"] = phase_ssm_serve(args.seed, 8)["k3"]
            phase_ssm_serve(args.seed, 4)
            phase_ssm_profile(args.seed)
    hymba = {"k1": 0, "k3": 0, "k4": 0, "k5": 0}
    if 15 in phases:
        with timed(15):
            phase_hybrid_parity(args.seed)
            phase_hybrid_kernels(args.seed)
            with cut_depth(HYMBA_FEATURE_LAYERS):
                paged = phase_hybrid_serve(args.seed, "paged")
                hymba["k1"], hymba["k5"] = paged["k1"], paged["k5"]
                hymba["k4"] = phase_hybrid_serve(args.seed, "kv8")["k4"]
                hymba["k3"] = phase_hybrid_serve(args.seed,
                                                 "native")["k3"]
            phase_ssm_profile(args.seed, HYMBA, "hymba")
    moe = {"k1": 0, "k3": 0, "k4": 0, "k5": 0}
    if 16 in phases:
        with timed(16):
            phase_moe_parity(args.seed)
            phase_moe_kernels(args.seed)
            paged = phase_moe_serve(args.seed, "paged")
            moe["k1"], moe["k5"] = paged["k1"], paged["k5"]
            moe["k4"] = phase_moe_serve(args.seed, "kv8")["k4"]
            moe["k3"] = phase_moe_serve(args.seed, "native")["k3"]
            free_card("moe")
            phase_ssm_profile(args.seed, QWEN_MOE, "moe")
    vlm = {"k1": 0, "k3": 0, "k4": 0, "k5": 0}
    if 17 in phases:
        with timed(17):
            phase_vlm_parity(args.seed)
            phase_vlm_kernels(args.seed)
            paged = phase_vlm_generate(args.seed, "paged")
            vlm["k1"], vlm["k5"] = paged["k1"], paged["k5_build"]
            vlm["k4"] = phase_vlm_generate(args.seed, "kv8")["k4"]
            vlm["k3"] = phase_vlm_generate(args.seed, "native")["k3"]
    audio = {"k3": 0, "k5": 0}
    if 18 in phases:
        with timed(18):
            phase_audio_parity(args.seed)
            phase_audio_kernels(args.seed)
            audio["k5"] = phase_audio_forward(args.seed, "fake")["k5"]
            audio["k3"] = phase_audio_forward(args.seed, "w8")["k3"]
            phase_audio_forward(args.seed, "w4")
    train = {"k5": 0}
    if 19 in phases:
        with timed(19):
            phase_train_parity(args.seed)
            train = phase_train_full(args.seed)
            phase_train_compressed(args.seed)
            phase_train_restart(args.seed)
    gate = {"k1": 0, "k2": 0}
    if 20 in phases:
        with timed(20):
            gate = phase_static_gate(args.seed)
            seg = phase_segment_trace(args.seed)
            failed = gate["failed"] + seg["failed"]
            if failed:
                raise AssertionError(f"phase 20: {failed}")
            gate["k1"] += seg["k1"]
    distrib = {"k5": 0}
    if 21 in phases:
        with timed(21):
            distrib = phase_distrib(args.seed)
    graphs, waves = {}, {}
    if 22 in phases:
        with timed(22):
            graphs = phase_graphs(args.seed)
            graphs.update(phase_static_graphs(args.seed))
            with cut_depth(FEATURE_LAYERS):
                waves = phase_wave_graphs(args.seed)
    if args.profile:
        phase_profile(args.seed)
    kernels = []
    if rows:
        kernels.append(kernel_entry(
            "paged_attention", "paged_attention.cu",
            "src/repro/kernels/paged_attention.py:116", served["launches"],
            rows["k1"], policy_launches=policy["k1"],
            fault_launches=faults["k1"], durable_launches=durable["k1"],
            hymba_launches=hymba["k1"], moe_launches=moe["k1"],
            vlm_launches=vlm["k1"], analysis_launches=gate["k1"],
            graph_launches=graphs.get("kv16 paged", {}).get(
                "paged_attention.launches", 0)))
        kernels.append(kernel_entry(
            "paged_attention_multi", "paged_attention_multi.cu",
            "src/repro/kernels/paged_attention.py:247", spec["launches"],
            rows["k2"], fault_launches=faults["k2"],
            durable_launches=durable["k2"], analysis_launches=gate["k2"],
            graph_launches=graphs.get("spec kv16 paged", {}).get(
                "paged_attention_multi.launches", 0)))
        kernels.append(kernel_entry(
            "qmatmul", "qmatmul.cu", "src/repro/kernels/qmatmul.py:88",
            native["k3"], rows["k3"], mamba2_launches=mamba2["k3"],
            hymba_launches=hymba["k3"], moe_launches=moe["k3"],
            vlm_launches=vlm["k3"], audio_launches=audio["k3"],
            graph_launches=graphs.get("native W8", {}).get(
                "qmatmul.launches", 0),
            wave_graph_launches=waves.get("native W8", {}).get(
                "k3_waves", 0)))
        kernels.append(kernel_entry(
            "qkv_attention", "qkv_attention.cu",
            "src/repro/kernels/qkv_attention.py:68", static["launches"],
            rows["k4"], policy_launches=policy["k4"],
            fault_launches=faults["k4"], hymba_launches=hymba["k4"],
            moe_launches=moe["k4"], vlm_launches=vlm["k4"],
            graph_launches=graphs.get("kv8 contiguous", {}).get(
                "qkv_attention.launches", 0),
            static_graph_launches=graphs.get("static kv8", {}).get(
                "qkv_attention.launches", 0)))
        kernels.append(kernel_entry(
            "aquant", "aquant.cu", "src/repro/kernels/aquant.py:59",
            native["k5"], rows["k5"], cnn_launches=cnn["k5"],
            mamba2_launches=mamba2["k5"], hymba_launches=hymba["k5"],
            moe_launches=moe["k5"], vlm_launches=vlm["k5"],
            audio_launches=audio["k5"], train_launches=train["k5"],
            distrib_launches=distrib["k5"]))
    print(f"[time] total {time.perf_counter() - t_start:.1f}s "
          f"({', '.join(f'phase {n} {t:.1f}s' for n, t in secs.items())})")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
