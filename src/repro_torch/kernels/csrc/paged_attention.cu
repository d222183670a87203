// Paged decode attention for Hopper (sm_90a), called through a plain C
// interface (ctypes) from repro_torch/kernels/paged_attention.py.
//
// Replaces: the Pallas TPU kernel `paged_attention_pallas` (body `_kernel`)
// in repro/kernels/paged_attention.py — one-query decode attention that reads
// the KV pool in place through a per-row block table, with an online softmax
// over logical blocks, at kv16 (bf16), kv8 (int8) and kv4 (packed int4).
//
// Bound on an H100 SXM: bytes. Each (row, KV head) reads its mapped K and V
// blocks once: 2·B·ctx·Hkv·D·bytes — at kv16, B=8 and a 1024-token context
// that is 16.8 MB, about 5 us at 3.35 TB/s — against 4·B·H·D·ctx flops
// (0.07 GFLOP, about 1 us on the f32 CUDA cores).
//
// Design (simple and right first):
//  * one thread block per (row b, KV head h); its Hg query heads share every
//    K/V tile staged in shared memory, so each K/V byte is read once;
//  * a loop over tiles of up to 64 key columns (64/bs logical blocks) takes
//    the place of the TPU's sequential grid axis; each tile reads its own
//    block-table entries, and a tile with no attendable column is skipped
//    before any K/V load (unmapped entries — < 0 or >= n_blocks — and dead
//    rows cost no K/V traffic; the TPU clamps the DMA and masks instead,
//    which is the same result since masked columns contribute p = 0);
//  * scores, running max m, denominator l and the accumulator are f32;
//  * operation order of the reference: kv8 contracts on the int grid, then
//    scales the scores by ks and the output by vs; kv4 unpacks the nibbles
//    (low nibble = even index, sign-extended) and dequantizes before the
//    contraction; masked columns contribute exactly p = 0; a row with no
//    valid key writes exact zeros;
//  * window masking is 0 <= tidx <= pos and pos - tidx < window.
// What the design does about the bound: it moves only the mapped, needed
// blocks, once. It does not yet overlap loads with compute (no cp.async/TMA
// pipeline) and runs only B·Hkv blocks, so it is latency-bound, not
// bandwidth-bound; wgmma, TMA and splitting the context across blocks are
// later work.
//
// Supported: D even and <= 256, Hg <= 16, bs <= 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 64;
constexpr int kMaxHg = 16;
constexpr int kMaxD = 256;
constexpr int kMaxBs = 64;
constexpr int kAccPerThread = kMaxHg * kMaxD / kThreads;
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
__host__ __device__ constexpr int smem_floats(int hg, int d) {
  return hg * d                       // q, pre-scaled
         + 2 * kTileCols * (d + 1)    // K and V tiles, rows padded by one
         + hg * kTileCols             // scores, then probabilities
         + 3 * kMaxHg                 // m, l, alpha
         + 2 * kTileCols;             // keep flags, physical block ids (int)
}

template <int BITS, typename QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const void* __restrict__ k_pool,
                       const void* __restrict__ v_pool,
                       const int* __restrict__ token_idx,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_table,
                       const int* __restrict__ pos, float* __restrict__ out,
                       int Hkv, int Hg, int D, int n_blocks, int bs,
                       int n_lblk, int window, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = D + 1;
  const int lblk_per_tile = kTileCols / bs;
  const int Dk = BITS == 4 ? D / 2 : D;

  float* s_q = smem;
  float* s_k = s_q + Hg * D;
  float* s_v = s_k + kTileCols * ld;
  float* s_p = s_v + kTileCols * ld;
  float* s_m = s_p + Hg * kTileCols;
  float* s_l = s_m + kMaxHg;
  float* s_a = s_l + kMaxHg;
  int* s_keep = reinterpret_cast<int*>(s_a + kMaxHg);
  int* s_phys = s_keep + kTileCols;

  const float ks = k_scale[b * Hkv + h];
  const float vs = v_scale[b * Hkv + h];
  const int p_b = pos[b];
  const int win = window > 0 ? window : n_lblk * bs + 1;

  const QT* qb = q + (size_t)(b * Hkv + h) * Hg * D;
  for (int i = tid; i < Hg * D; i += kThreads) s_q[i] = to_f32(qb[i]) * sm_scale;
  if (tid < kMaxHg) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }

  float acc[kAccPerThread];
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) acc[r] = 0.f;
  const int n_out = Hg * D;

  for (int lb0 = 0; lb0 < n_lblk; lb0 += lblk_per_tile) {
    const int nl = min(lblk_per_tile, n_lblk - lb0);
    const int ncols = nl * bs;
    __syncthreads();  // the previous tile's readers are done with smem

    if (tid < nl) {
      const int e = block_table[b * n_lblk + lb0 + tid];
      s_phys[tid] = (e >= 0 && e < n_blocks) ? e : -1;
    }
    int keep = 0;
    if (tid < ncols) {
      const int e = block_table[b * n_lblk + lb0 + tid / bs];
      if (e >= 0 && e < n_blocks) {
        const int t = token_idx[(size_t)e * bs + tid % bs];
        keep = (t >= 0) && (t <= p_b) && (p_b - t < win);
      }
      s_keep[tid] = keep;
    }
    if (!__syncthreads_or(keep)) continue;  // nothing attendable: no loads

    // stage the K and V tiles as f32 (kv4 dequantized, kv8 on the int grid)
    for (int i = tid; i < ncols * Dk; i += kThreads) {
      const int c = i / Dk;
      const int x = i - c * Dk;
      const int phys = s_phys[c / bs];
      float* kr = s_k + c * ld;
      float* vr = s_v + c * ld;
      if (phys < 0) {
        if (BITS == 4) {
          kr[2 * x] = kr[2 * x + 1] = 0.f;
          vr[2 * x] = vr[2 * x + 1] = 0.f;
        } else {
          kr[x] = vr[x] = 0.f;
        }
        continue;
      }
      const size_t off = (((size_t)phys * bs + (c % bs)) * Hkv + h) * Dk + x;
      if constexpr (BITS == 16) {
        kr[x] = __bfloat162float(static_cast<const __nv_bfloat16*>(k_pool)[off]);
        vr[x] = __bfloat162float(static_cast<const __nv_bfloat16*>(v_pool)[off]);
      } else if constexpr (BITS == 8) {
        kr[x] = static_cast<float>(static_cast<const int8_t*>(k_pool)[off]);
        vr[x] = static_cast<float>(static_cast<const int8_t*>(v_pool)[off]);
      } else {
        const int kb = static_cast<const int8_t*>(k_pool)[off];
        const int vb = static_cast<const int8_t*>(v_pool)[off];
        kr[2 * x] = static_cast<float>(((kb & 0xF) ^ 8) - 8) * ks;
        kr[2 * x + 1] = static_cast<float>(kb >> 4) * ks;
        vr[2 * x] = static_cast<float>(((vb & 0xF) ^ 8) - 8) * vs;
        vr[2 * x + 1] = static_cast<float>(vb >> 4) * vs;
      }
    }
    __syncthreads();

    // scores [Hg, ncols]
    for (int i = tid; i < Hg * ncols; i += kThreads) {
      const int g = i / ncols;
      const int c = i - g * ncols;
      float s = kNegInf;
      if (s_keep[c]) {
        const float* qr = s_q + g * D;
        const float* kr = s_k + c * ld;
        float a = 0.f;
        for (int x = 0; x < D; ++x) a = fmaf(qr[x], kr[x], a);
        s = BITS == 8 ? a * ks : a;
      }
      s_p[g * kTileCols + c] = s;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < Hg; g += kWarps) {
      float* row = s_p + g * kTileCols;
      float mx = kNegInf;
      for (int c = lane; c < ncols; c += 32) mx = fmaxf(mx, row[c]);
      mx = warp_max(mx);
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < ncols; c += 32) {
        const float p = s_keep[c] ? expf(row[c] - m_new) : 0.f;
        row[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_a[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, x] = acc * alpha[g] + sum_c p[g, c] * V[c, x]
#pragma unroll
    for (int r = 0; r < kAccPerThread; ++r) {
      const int e = tid + r * kThreads;
      if (e < n_out) {
        const int g = e / D;
        const int x = e - g * D;
        const float* pr = s_p + g * kTileCols;
        float a = acc[r] * s_a[g];
        for (int c = 0; c < ncols; ++c) a = fmaf(pr[c], s_v[c * ld + x], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  float* ob = out + (size_t)(b * Hkv + h) * Hg * D;
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) {
    const int e = tid + r * kThreads;
    if (e < n_out) {
      const int g = e / D;
      float o = acc[r] / fmaxf(s_l[g], 1e-30f);
      if (BITS == 8) o *= vs;
      ob[e] = s_m[g] > kNegInf * 0.5f ? o : 0.f;
    }
  }
}

template <int BITS, typename QT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* token_idx, const float* k_scale,
                   const float* v_scale, const int* block_table,
                   const int* pos, float* out, int B, int Hkv, int Hg, int D,
                   int n_blocks, int bs, int n_lblk, int window,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Hg, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<BITS, QT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_kernel<BITS, QT><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), k_pool, v_pool, token_idx, k_scale, v_scale,
      block_table, pos, out, Hkv, Hg, D, n_blocks, bs, n_lblk, window,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); the caller
// raises on anything else. Nothing here synchronises or allocates.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* token_idx, const float* k_scale, const float* v_scale,
    const int* block_table, const int* pos, float* out, int q_bf16, int B,
    int Hkv, int Hg, int D, int n_blocks, int bs, int n_lblk, int bits,
    int window, float sm_scale, void* stream_ptr) {
  if (D % 2 || D > kMaxD || Hg > kMaxHg || bs > kMaxBs || bs < 1 || Hg < 1)
    return (int)cudaErrorInvalidValue;
  if (B * Hkv == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define REPRO_PA_LAUNCH(BITS, QT)                                            \
  launch<BITS, QT>(q, k_pool, v_pool, token_idx, k_scale, v_scale,           \
                   block_table, pos, out, B, Hkv, Hg, D, n_blocks, bs,       \
                   n_lblk, window, sm_scale, stream)
  cudaError_t e;
  if (bits == 16)
    e = q_bf16 ? REPRO_PA_LAUNCH(16, __nv_bfloat16) : REPRO_PA_LAUNCH(16, float);
  else if (bits == 8)
    e = q_bf16 ? REPRO_PA_LAUNCH(8, __nv_bfloat16) : REPRO_PA_LAUNCH(8, float);
  else if (bits == 4)
    e = q_bf16 ? REPRO_PA_LAUNCH(4, __nv_bfloat16) : REPRO_PA_LAUNCH(4, float);
  else
    e = cudaErrorInvalidValue;
#undef REPRO_PA_LAUNCH
  return (int)e;
}
