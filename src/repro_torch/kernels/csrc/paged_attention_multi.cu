// K2: paged attention for a speculative draft/verify window on Hopper
// (sm_90a), called through a plain C interface (ctypes) from
// repro_torch/kernels/paged_attention.py.
//
// Replaces: the Pallas TPU kernel `paged_attention_pallas_multi` (body
// `_kernel_multi`) in repro/kernels/paged_attention.py — the W queries of a
// window attend in place to the KV pool through a per-row block table;
// query j sits at absolute position pos + j under its own causal mask, and
// at kv8 dequantizes under its own scale-ladder entry.
//
// Bound on an H100 SXM: bytes or f32 operations, about equally. Each
// (row, KV head) must read its attended K and V once, 2·B·ctx·Hkv·D·bytes,
// the traffic of one-query decode, but does W times its flops,
// 4·B·ctx·Hkv·W·Hg·D. At the serve shape (Hg=4, D=64, W=5) that is 20 flops
// per K/V byte at kv16 and 40 at kv8, against the card's f32 CUDA-core
// ridge of 67 TFLOP/s / 3.35 TB/s = 20.
//
// Design: the split-context kernel of paged_attention_split.cuh, shared
// with K1. The W·Hg query rows (r = j·Hg + g) of a (row, KV head) are cut
// into equal row tiles of at most 32 rows (16 when D > 128), a grid axis,
// so any window fits; at the serve shape (W·Hg = 20) there is one row tile
// and each K/V byte is read once per window. The context is cut into
// splits of at most 8 64-column tiles (any block size, a grid of about
// 4 × 132 blocks); each split stages the tiles some query of its row tile
// can reach through a cp.async ring, and a second launch merges the splits
// in split order and applies v_ladder after the merge. bf16 q computes q·K
// on the tensor cores (mma.sync m16n8k16, the row tile padded to 16 or 32
// rows; products exact in f32), which removes the half of the operations
// that bound the first port; P·V, the other half, stays on the f32 CUDA
// cores. The host passes the resolved mask width (window, or n_lblk·bs + W
// for full attention).
//
// Limits: kv16/kv8, D even and <= 256.

#include "paged_attention_split.cuh"

extern "C" int repro_paged_attention_multi(
    const void* q, const void* k_pool, const void* v_pool,
    const int* token_idx, const float* k_ladder, const float* v_ladder,
    const int* block_table, const int* pos, float* out, float* part_acc,
    float* part_ml, int q_bf16, int B, int W, int Hkv, int Hg, int D,
    int n_blocks, int bs, int n_lblk, int bits, int win, int row_tile,
    int row_tiles, int splits, int tiles_per_split, float sm_scale,
    void* stream) {
  return repro_pa::entry<false>(
      q, k_pool, v_pool, token_idx, k_ladder, v_ladder, block_table, pos,
      out, part_acc, part_ml, q_bf16, B, W, Hkv, Hg, D, n_blocks, bs, n_lblk,
      bits, win, row_tile, row_tiles, splits, tiles_per_split, sm_scale,
      stream);
}
