// Decode attention over a contiguous int8 KV cache for Hopper (sm_90a),
// called through a plain C interface (ctypes) from
// repro_torch/kernels/qkv_attention.py.
//
// Replaces: the Pallas TPU kernel `qkv_attention_pallas` (body `_kernel`) in
// repro/kernels/qkv_attention.py — per GQA group (one row's KV head), one
// decode query per q-head of the group against an S-slot int8 cache:
// dequantize K = k_q·ks and V = v_q·vs, scores (q·Kᵀ)·D^-½, mask col < len,
// online softmax over S, output p·V in f32.
//
// Bound on an H100 SXM: bytes. A group reads the valid prefix of its K and
// V rows once, at one byte per element: 2·Σlen·D bytes over all groups. At
// the serving shape (B=8 rows × Hkv=8 heads, Hg=4, D=64, S=1024, lengths
// up to 1024) that is at most 8.4 MB, 2.5 us at 3.35 TB/s, against
// 4·Σlen·Hg·D f32 operations (at most 67 MFLOP, 1 us at 67 TFLOP/s).
//
// Design (simple and right first):
//  * one thread block per group (row b, KV head h); its Hg query rows share
//    every K/V tile staged in shared memory, so each cache byte is read
//    once;
//  * the cache is read in its own layout [B, S, Hkv, D] through the strides
//    the wrapper passes (no per-call transpose to [G, S, D]); each thread
//    loads four int8 values at a time (char4) and dequantizes them in
//    registers before they are staged as f32;
//  * a loop over tiles of up to 64 columns takes the place of the TPU's
//    sequential grid axis; tiles at or past len are never loaded, and the
//    ragged last tile is cut at len in the kernel (the Pallas wrapper
//    required S % block_s == 0; this kernel takes any S);
//  * len <= 0 follows the Pallas kernel: every column is masked there, so
//    its weights are uniform and the output is the mean of the dequantized
//    V over all S columns (here: every column read with score 0);
//  * scores, running max m, denominator l and the accumulator are f32, in
//    the plain version's order: dequantize, dot, scale by D^-½.
// What the design does about the bound: it moves only the valid prefix,
// once, at one byte per element. It does not overlap loads with compute
// (no cp.async/TMA pipeline) and runs only B·Hkv blocks (64 at the serving
// shape, half of the 132 SMs), so it is latency-bound; splitting S across
// blocks, cp.async/TMA and tensor cores are later work.
//
// Supported: D a multiple of 4 and <= 256, 1 <= Hg <= 16; the D axis
// contiguous and every row start 4-byte aligned (checked by the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 64;
constexpr int kMaxHg = 16;
constexpr int kMaxD = 256;
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
  return hg * d                       // q
         + 2 * kTileCols * (d + 1)    // dequantized K and V tiles, padded
         + hg * kTileCols             // scores, then probabilities
         + 3 * kMaxHg;                // m, l, alpha
}

template <typename QT>
__global__ void __launch_bounds__(kThreads)
qkv_attention_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ lengths, float* __restrict__ out,
                     int Hkv, int Hg, int D, int S, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, float sm_scale) {
  extern __shared__ float smem[];
  const int grp = blockIdx.x;  // = b * Hkv + h, the layout of scales/lengths
  const int b = grp / Hkv;
  const int h = grp % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = D + 1;
  const int d4 = D / 4;

  float* s_q = smem;
  float* s_k = s_q + Hg * D;
  float* s_v = s_k + kTileCols * ld;
  float* s_p = s_v + kTileCols * ld;
  float* s_m = s_p + Hg * kTileCols;
  float* s_l = s_m + kMaxHg;
  float* s_a = s_l + kMaxHg;

  const float ks = k_scale[grp];
  const float vs = v_scale[grp];
  const int len = lengths[grp];
  const bool uniform = len <= 0;           // every column masked
  const int n_cols = uniform ? S : min(len, S);
  const int8_t* kb = k + b * k_sb + h * k_sh;
  const int8_t* vb = v + b * v_sb + h * v_sh;

  const QT* qb = q + (size_t)grp * Hg * D;
  for (int i = tid; i < Hg * D; i += kThreads) s_q[i] = to_f32(qb[i]);
  if (tid < kMaxHg) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }

  float acc[kAccPerThread];
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) acc[r] = 0.f;
  const int n_out = Hg * D;

  for (int c0 = 0; c0 < n_cols; c0 += kTileCols) {
    const int nc = min(kTileCols, n_cols - c0);
    __syncthreads();  // the previous tile's readers are done with smem

    // stage the tile: four int8 values per load, dequantized in registers
    for (int i = tid; i < nc * d4; i += kThreads) {
      const int c = i / d4;
      const int x = 4 * (i - c * d4);
      const long long col = c0 + c;
      const char4 kk = *reinterpret_cast<const char4*>(kb + col * k_ss + x);
      const char4 vv = *reinterpret_cast<const char4*>(vb + col * v_ss + x);
      float* kr = s_k + c * ld + x;
      float* vr = s_v + c * ld + x;
      kr[0] = static_cast<float>(kk.x) * ks;
      kr[1] = static_cast<float>(kk.y) * ks;
      kr[2] = static_cast<float>(kk.z) * ks;
      kr[3] = static_cast<float>(kk.w) * ks;
      vr[0] = static_cast<float>(vv.x) * vs;
      vr[1] = static_cast<float>(vv.y) * vs;
      vr[2] = static_cast<float>(vv.z) * vs;
      vr[3] = static_cast<float>(vv.w) * vs;
    }
    __syncthreads();

    // scores [Hg, nc]; every staged column is valid (c0 + c < n_cols)
    for (int i = tid; i < Hg * nc; i += kThreads) {
      const int g = i / nc;
      const int c = i - g * nc;
      float s = 0.f;
      if (!uniform) {
        const float* qr = s_q + g * D;
        const float* kr = s_k + c * ld;
        float a = 0.f;
        for (int x = 0; x < D; ++x) a = fmaf(qr[x], kr[x], a);
        s = a * sm_scale;
      }
      s_p[g * kTileCols + c] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < Hg; g += kWarps) {
      float* row = s_p + g * kTileCols;
      float mx = kNegInf;
      for (int c = lane; c < nc; c += 32) mx = fmaxf(mx, row[c]);
      mx = warp_max(mx);
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < nc; c += 32) {
        const float p = expf(row[c] - m_new);
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
        for (int c = 0; c < nc; ++c) a = fmaf(pr[c], s_v[c * ld + x], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  float* ob = out + (size_t)grp * Hg * D;
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) {
    const int e = tid + r * kThreads;
    if (e < n_out) ob[e] = acc[r] / fmaxf(s_l[e / D], 1e-30f);
  }
}

template <typename QT>
cudaError_t launch(const void* q, const int8_t* k, const int8_t* v,
                   const float* k_scale, const float* v_scale,
                   const int* lengths, float* out, int B, int Hkv, int Hg,
                   int D, int S, long long k_sb, long long k_ss,
                   long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Hg, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        qkv_attention_kernel<QT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  qkv_attention_kernel<QT><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), k, v, k_scale, v_scale, lengths, out, Hkv,
      Hg, D, S, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); the caller
// raises on anything else. Nothing here synchronises or allocates.
extern "C" int repro_qkv_attention(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* lengths, float* out, int q_bf16, int B,
    int Hkv, int Hg, int D, int S, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float sm_scale, void* stream_ptr) {
  if (D % 4 || D > kMaxD || D < 4 || Hg > kMaxHg || Hg < 1 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (B * Hkv == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  cudaError_t e =
      q_bf16 ? launch<__nv_bfloat16>(q, kp, vp, k_scale, v_scale, lengths,
                                     out, B, Hkv, Hg, D, S, k_sb, k_ss, k_sh,
                                     v_sb, v_ss, v_sh, sm_scale, stream)
             : launch<float>(q, kp, vp, k_scale, v_scale, lengths, out, B,
                             Hkv, Hg, D, S, k_sb, k_ss, k_sh, v_sb, v_ss,
                             v_sh, sm_scale, stream);
  return (int)e;
}
