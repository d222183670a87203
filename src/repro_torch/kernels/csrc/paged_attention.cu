// K1: paged decode attention for Hopper (sm_90a), called through a plain C
// interface (ctypes) from repro_torch/kernels/paged_attention.py.
//
// Replaces: the Pallas TPU kernel `paged_attention_pallas` (body `_kernel`)
// in repro/kernels/paged_attention.py — one-query decode attention that reads
// the KV pool in place through a per-row block table, at kv16 (bf16), kv8
// (int8) and kv4 (packed int4).
//
// Bound on an H100 SXM: bytes. Each (row, KV head) reads its attended K and
// V rows once, 2·B·ctx·Hkv·D·bytes — at kv16, B=8, Hkv=8, D=64 and a
// 1024-token table about 8 MB of live keys, 2.5 us at 3.35 TB/s — against
// 4·B·ctx·Hkv·Hg·D flops, under 1 us on the f32 CUDA cores.
//
// Design: the split-context kernel of paged_attention_split.cuh, as W = 1
// (its per-query scales are the row's k_scale/v_scale). The TPU walks a
// row's blocks in one sequential grid axis; on the H100 that leaves B·Hkv
// blocks (64 at the serve shape) on 132 SMs with nothing to overlap a
// tile's loads, which held the first version far from its bound.
// Here the context is cut into splits of at most 8 64-column tiles (a grid
// of about 4 × 132 blocks of 256 threads), each split stages its live tiles
// through a 3-stage cp.async ring, and a second launch merges the splits'
// (m, l, acc) partials in split order. bf16 q at kv16/kv8 computes q·K on
// the tensor cores (mma.sync, exact products, f32 sums); f32 q and kv4 on
// the f32 CUDA cores; P·V on the f32 CUDA cores. Column tiles follow
// logical columns, not blocks, so any block size works; the query heads of
// a KV head are cut into row tiles, so any Hg works. What remains between
// this kernel and its byte bound is a fixed cost per call (two launches,
// each split's block-table and token-index reads, the merge) and the
// per-tile barriers of each split.
//
// Limits: D even and <= 256.

#include "paged_attention_split.cuh"

extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* token_idx, const float* k_scale, const float* v_scale,
    const int* block_table, const int* pos, float* out, float* part_acc,
    float* part_ml, int q_bf16, int B, int W, int Hkv, int Hg, int D,
    int n_blocks, int bs, int n_lblk, int bits, int win, int row_tile,
    int row_tiles, int splits, int tiles_per_split, float sm_scale,
    void* stream) {
  if (W != 1) return (int)cudaErrorInvalidValue;
  return repro_pa::entry<true>(
      q, k_pool, v_pool, token_idx, k_scale, v_scale, block_table, pos, out,
      part_acc, part_ml, q_bf16, B, W, Hkv, Hg, D, n_blocks, bs, n_lblk, bits,
      win, row_tile, row_tiles, splits, tiles_per_split, sm_scale, stream);
}
