// Paged attention for a speculative draft/verify window on Hopper (sm_90a),
// called through a plain C interface (ctypes) from
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
// ridge of 67 TFLOP/s / 3.35 TB/s = 20: kv16 sits on the ridge, kv8 is
// bound by operations at the f32 rate.
//
// Design (simple and right first):
//  * one thread block per (row b, KV head h); its W·Hg query rows (row
//    r = j·Hg + g) share every K/V tile staged in shared memory, so each
//    K/V byte is read once per window, not W times;
//  * a loop over tiles of up to 64 key columns (64/bs logical blocks) takes
//    the place of the TPU's sequential grid axis; each tile reads its own
//    block-table entries and token indices, and is skipped before any K/V
//    load when no query of the window can attend to any of its columns —
//    judged on the window's widest range: tidx <= pos + W - 1 and
//    pos - tidx < window (query j = max(0, tidx - pos) is the one that
//    could reach it);
//  * scores, running max m, denominator l and the accumulator are f32,
//    online softmax per query row;
//  * operation order of the reference: kv8 contracts on the int grid, then
//    scales query j's scores by k_ladder[b, j, h] and its output by
//    v_ladder[b, j, h]; kv16 ignores the ladders; masked columns contribute
//    exactly p = 0; a query with no valid key writes exact zeros;
//  * the host passes the resolved mask width (window, or n_lblk·bs + W for
//    full attention).
// What the design does about the bound: the window's W queries cost one
// pass over the mapped, needed blocks. It does not overlap loads with
// compute (no cp.async/TMA) and runs only B·Hkv blocks: latency-bound, as
// K1. wgmma, TMA and splitting the context across blocks are later work.
//
// Supported: kv16/kv8, D even and <= 256, bs <= 64, W·Hg <= 64 and
// W·Hg·D <= 8192.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 64;
constexpr int kMaxRows = 64;          // W·Hg
constexpr int kMaxOut = 8192;         // W·Hg·D
constexpr int kMaxD = 256;
constexpr int kMaxBs = 64;
constexpr int kAccPerThread = kMaxOut / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory layout in floats; the host computes the same size.
__host__ __device__ constexpr int smem_floats(int rows, int d) {
  return rows * d                     // q, pre-scaled
         + 2 * kTileCols * (d + 1)    // K and V tiles, rows padded by one
         + rows * kTileCols           // scores, then probabilities
         + 3 * kMaxRows               // m, l, alpha
         + 2 * kTileCols;             // token index per column, block ids
}

// Query j at qp may attend column token t.
__device__ __forceinline__ bool attends(int t, int qp, int win) {
  return t >= 0 && t <= qp && qp - t < win;
}

template <int BITS, typename QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_multi_kernel(const QT* __restrict__ q,
                             const void* __restrict__ k_pool,
                             const void* __restrict__ v_pool,
                             const int* __restrict__ token_idx,
                             const float* __restrict__ k_ladder,
                             const float* __restrict__ v_ladder,
                             const int* __restrict__ block_table,
                             const int* __restrict__ pos,
                             float* __restrict__ out, int W, int Hkv, int Hg,
                             int D, int n_blocks, int bs, int n_lblk,
                             int win, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = D + 1;
  const int rows = W * Hg;
  const int lblk_per_tile = kTileCols / bs;

  float* s_q = smem;
  float* s_k = s_q + rows * D;
  float* s_v = s_k + kTileCols * ld;
  float* s_p = s_v + kTileCols * ld;
  float* s_m = s_p + rows * kTileCols;
  float* s_l = s_m + kMaxRows;
  float* s_a = s_l + kMaxRows;
  int* s_t = reinterpret_cast<int*>(s_a + kMaxRows);
  int* s_phys = s_t + kTileCols;

  const int p_b = pos[b];
  const int last = p_b + W - 1;       // the window's last query position

  // q [B, W, Hkv, Hg, D] -> s_q[(j·Hg + g)·D + x]
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int x = i - r * D;
    const int j = r / Hg;
    const int g = r - j * Hg;
    const size_t src = ((((size_t)b * W + j) * Hkv + h) * Hg + g) * D + x;
    s_q[i] = to_f32(q[src]) * sm_scale;
  }
  if (tid < kMaxRows) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }

  float acc[kAccPerThread];
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) acc[r] = 0.f;
  const int n_out = rows * D;

  for (int lb0 = 0; lb0 < n_lblk; lb0 += lblk_per_tile) {
    const int nl = min(lblk_per_tile, n_lblk - lb0);
    const int ncols = nl * bs;
    __syncthreads();  // the previous tile's readers are done with smem

    if (tid < nl) {
      const int e = block_table[b * n_lblk + lb0 + tid];
      s_phys[tid] = (e >= 0 && e < n_blocks) ? e : -1;
    }
    int any = 0;
    if (tid < ncols) {
      const int e = block_table[b * n_lblk + lb0 + tid / bs];
      int t = -1;
      if (e >= 0 && e < n_blocks) t = token_idx[(size_t)e * bs + tid % bs];
      s_t[tid] = t;
      any = t >= 0 && t <= last && p_b - t < win;
    }
    if (!__syncthreads_or(any)) continue;  // no query attends: no loads

    // stage the K and V tiles as f32 (kv8 on the int grid)
    for (int i = tid; i < ncols * D; i += kThreads) {
      const int c = i / D;
      const int x = i - c * D;
      const int phys = s_phys[c / bs];
      float* kr = s_k + c * ld;
      float* vr = s_v + c * ld;
      if (phys < 0) {
        kr[x] = vr[x] = 0.f;
        continue;
      }
      const size_t off = (((size_t)phys * bs + (c % bs)) * Hkv + h) * D + x;
      if constexpr (BITS == 16) {
        kr[x] = __bfloat162float(static_cast<const __nv_bfloat16*>(k_pool)[off]);
        vr[x] = __bfloat162float(static_cast<const __nv_bfloat16*>(v_pool)[off]);
      } else {
        kr[x] = static_cast<float>(static_cast<const int8_t*>(k_pool)[off]);
        vr[x] = static_cast<float>(static_cast<const int8_t*>(v_pool)[off]);
      }
    }
    __syncthreads();

    // scores [rows, ncols]
    for (int i = tid; i < rows * ncols; i += kThreads) {
      const int r = i / ncols;
      const int c = i - r * ncols;
      const int j = r / Hg;
      float s = kNegInf;
      if (attends(s_t[c], p_b + j, win)) {
        const float* qr = s_q + r * D;
        const float* kr = s_k + c * ld;
        float a = 0.f;
        for (int x = 0; x < D; ++x) a = fmaf(qr[x], kr[x], a);
        s = BITS == 8 ? a * k_ladder[((size_t)b * W + j) * Hkv + h] : a;
      }
      s_p[r * kTileCols + c] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int r = warp; r < rows; r += kWarps) {
      const int qp = p_b + r / Hg;
      float* row = s_p + r * kTileCols;
      float mx = kNegInf;
      for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, row[c]);
      mx = warp_max(mx);
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < ncols; c += 32) {
        const float p = attends(s_t[c], qp, win) ? expf(row[c] - m_new) : 0.f;
        row[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_a[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r, x] = acc * alpha[r] + sum_c p[r, c] * V[c, x]
#pragma unroll
    for (int k = 0; k < kAccPerThread; ++k) {
      const int e = tid + k * kThreads;
      if (e < n_out) {
        const int r = e / D;
        const int x = e - r * D;
        const float* pr = s_p + r * kTileCols;
        float a = acc[k] * s_a[r];
        for (int c = 0; c < ncols; ++c) a = fmaf(pr[c], s_v[c * ld + x], a);
        acc[k] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kAccPerThread; ++k) {
    const int e = tid + k * kThreads;
    if (e < n_out) {
      const int r = e / D;
      const int x = e - r * D;
      const int j = r / Hg;
      const int g = r - j * Hg;
      float o = acc[k] / fmaxf(s_l[r], 1e-30f);
      if (BITS == 8) o *= v_ladder[((size_t)b * W + j) * Hkv + h];
      const size_t dst = ((((size_t)b * W + j) * Hkv + h) * Hg + g) * D + x;
      out[dst] = s_m[r] > kNegInf * 0.5f ? o : 0.f;
    }
  }
}

template <int BITS, typename QT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* token_idx, const float* k_ladder,
                   const float* v_ladder, const int* block_table,
                   const int* pos, float* out, int B, int W, int Hkv, int Hg,
                   int D, int n_blocks, int bs, int n_lblk, int win,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(W * Hg, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_multi_kernel<BITS, QT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_multi_kernel<BITS, QT><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), k_pool, v_pool, token_idx, k_ladder,
      v_ladder, block_table, pos, out, W, Hkv, Hg, D, n_blocks, bs, n_lblk,
      win, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); the caller
// raises on anything else. Nothing here synchronises or allocates.
extern "C" int repro_paged_attention_multi(
    const void* q, const void* k_pool, const void* v_pool,
    const int* token_idx, const float* k_ladder, const float* v_ladder,
    const int* block_table, const int* pos, float* out, int q_bf16, int B,
    int W, int Hkv, int Hg, int D, int n_blocks, int bs, int n_lblk,
    int bits, int win, float sm_scale, void* stream_ptr) {
  if (D % 2 || D > kMaxD || bs > kMaxBs || bs < 1 || Hg < 1 || W < 1 ||
      W * Hg > kMaxRows || W * Hg * D > kMaxOut || win < 1)
    return (int)cudaErrorInvalidValue;
  if (B * Hkv == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define REPRO_PAM_LAUNCH(BITS, QT)                                           \
  launch<BITS, QT>(q, k_pool, v_pool, token_idx, k_ladder, v_ladder,         \
                   block_table, pos, out, B, W, Hkv, Hg, D, n_blocks, bs,    \
                   n_lblk, win, sm_scale, stream)
  cudaError_t e;
  if (bits == 16)
    e = q_bf16 ? REPRO_PAM_LAUNCH(16, __nv_bfloat16) : REPRO_PAM_LAUNCH(16, float);
  else if (bits == 8)
    e = q_bf16 ? REPRO_PAM_LAUNCH(8, __nv_bfloat16) : REPRO_PAM_LAUNCH(8, float);
  else
    e = cudaErrorInvalidValue;
#undef REPRO_PAM_LAUNCH
  return (int)e;
}
