// Dequant-matmul for Hopper (sm_90a), called through a plain C interface
// (ctypes) from repro_torch/kernels/qmatmul.py.
//
// Replaces: the Pallas TPU kernel `qmatmul_pallas` (body `_qmatmul_kernel`,
// `_unpack_int4_tile`) in repro/kernels/qmatmul.py —
//   out[M, N] = x[M, K] @ dequant(w_q)[K, N]   (f32 out)
// with int8 weight carriers [K, N] (bits 5-8) or packed int4 [K, N/2]
// (bits <= 4, low nibble = even column, both nibbles sign-extended), a
// per-output-channel f32 scale [N], and an optional fused requant of the f32
// accumulator onto a static fixed-point grid.
//
// Numerics, exactly the reference's: x is rounded to bf16; each weight is
// dequantized as (float)q * scale[n] in f32 and THEN rounded to bf16 (the
// scale is never folded in after the dot); bf16 x bf16 products accumulate
// in f32 on the tensor cores (mma.sync m16n8k16). Every product of two bf16
// values is exact in f32, so the kernel and its plain version differ only in
// the order of the f32 sums. The fused requant is clip(round_half_away(
// acc / out_scale)) * out_scale with IEEE division.
//
// Bound on an H100 SXM: at decode (M = 8) bytes — the weights are read once,
// K·N·bits/8 (granite-3-2b's MLP-in at W8: 33.6 MB, about 10 us at
// 3.35 TB/s) — and at prefill (M in the thousands) operations, 2·M·K·N on the
// bf16 tensor cores (989 TFLOP/s dense).
//
// Design (simple and right first):
//  * one thread block per (BM x BN) output tile walks K in BK steps; the x
//    tile is staged as bf16 and the weight tile is dequantized to bf16 into
//    shared memory (int8 bytes move from HBM, never a bf16 weight image);
//  * each warp owns a (BM/WM x BN/WN) sub-tile of m16n8k16 fragments with
//    f32 accumulators in registers; fragments are read from shared memory
//    with 32-bit loads (A) and packed from two 16-bit loads (B), with row
//    pitches padded so a warp's fragment loads hit distinct banks;
//  * two tile shapes: 16 x 64 (BK 64, 4 warps) when M <= 16 (decode), so the
//    few rows do not waste a 64-row tile, and 64 x 128 (BK 32, 8 warps)
//    otherwise (prefill);
//  * ragged M, K and N edges are masked in the loads (zeros) and the store,
//    so the wrapper needs no padding copies; weight rows are read 16 bytes
//    per thread when the rows are 16-byte aligned, byte by byte otherwise.
// What the design does about the bound: weights move as int8/int4 and are
// dequantized in shared memory, so decode reads 2-4x fewer bytes than a bf16
// image would need. It does not overlap loads with compute (no cp.async/TMA
// pipeline, no split-K for decode's few output tiles) and uses mma.sync, not
// wgmma; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (float)q * s rounded to f32, then to bf16: the reference's dequant order
__device__ __forceinline__ __nv_bfloat16 dequant(int q, float s) {
  float v = (float)q * s;
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// clip(round_half_away(v / s), qmin, qmax) * s, as the plain requant_ref
__device__ __forceinline__ float requant(float v, float s, float qmin,
                                         float qmax) {
  float r = v / s;
  float sg = (float)((r > 0.f) - (r < 0.f));
  float q = sg * floorf(fabsf(r) + 0.5f);
  q = fminf(fmaxf(q, qmin), qmax);
  return q * s;
}

template <int BM, int BN, int BK, int WM, int WN, typename XT, bool INT4>
__global__ void __launch_bounds__(WM * WN * 32)
qmatmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scale, float* __restrict__ out,
               int M, int K, int N, int do_requant, int vec_ok,
               float out_scale, float qmin, float qmax) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kWarpRows = BM / WM;
  constexpr int kWarpCols = BN / WN;
  constexpr int kMI = kWarpRows / 16;
  constexpr int kNI = kWarpCols / 8;
  constexpr int kAPitch = BK + 8;      // bf16 elements per As row
  constexpr int kBPitch = BN + 8;      // bf16 elements per Bs row
  constexpr int kRowBytes = INT4 ? BN / 2 : BN;   // weight bytes per tile row
  constexpr int kChunksPerRow = kRowBytes / 16;
  constexpr int kChunks = BK * kChunksPerRow;
  static_assert(kMI >= 1 && kNI >= 1 && BK % 16 == 0, "tile shape");
  static_assert(kRowBytes % 16 == 0, "16-byte weight chunks");

  __shared__ __align__(16) __nv_bfloat16 As[BM][kAPitch];
  __shared__ __align__(16) __nv_bfloat16 Bs[BK][kBPitch];
  __shared__ float Ss[BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int64_t wpitch = INT4 ? N / 2 : N;        // bytes per weight row
  const int64_t nb0 = INT4 ? n0 / 2 : n0;         // tile's first byte column

  for (int j = tid; j < BN; j += kThreads)
    Ss[j] = (n0 + j < N) ? scale[n0 + j] : 0.f;

  float acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  __syncthreads();                                  // Ss visible

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile -> As, rounded to bf16 (zeros past M and K)
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      const float v = (m < M && k < K) ? to_f32(x[(int64_t)m * K + k]) : 0.f;
      As[r][c] = __float2bfloat16_rn(v);
    }
    // weight tile -> Bs, dequantized to bf16 (zeros past K and N)
    for (int c = tid; c < kChunks; c += kThreads) {
      const int kk = c / kChunksPerRow;
      const int cb = (c % kChunksPerRow) * 16;      // byte offset in the tile
      const int k = k0 + kk;
      const int64_t gb = nb0 + cb;                  // byte column in the row
      union {
        uint4 v;
        int8_t b[16];
      } chunk;
      if (vec_ok && k < K && gb + 16 <= wpitch) {
        chunk.v = *reinterpret_cast<const uint4*>(wq + (int64_t)k * wpitch + gb);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          chunk.b[j] = (k < K && gb + j < wpitch)
                           ? wq[(int64_t)k * wpitch + gb + j] : (int8_t)0;
      }
      if (INT4) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int8_t p = chunk.b[j];
          const int lo = (int)(int8_t)(p << 4) >> 4;  // even column
          const int hi = (int)p >> 4;                 // odd column
          const int n = 2 * (cb + j);
          Bs[kk][n] = dequant(lo, Ss[n]);
          Bs[kk][n + 1] = dequant(hi, Ss[n + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          Bs[kk][cb + j] = dequant((int)chunk.b[j], Ss[cb + j]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[kMI][4], b[kNI][2];
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int r = wm * kWarpRows + i * 16 + g;
        a[i][0] = ld32(&As[r][kk + 2 * t]);
        a[i][1] = ld32(&As[r + 8][kk + 2 * t]);
        a[i][2] = ld32(&As[r][kk + 2 * t + 8]);
        a[i][3] = ld32(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        const int n = wn * kWarpCols + j * 8 + g;
        b[j][0] = pack2(Bs[kk + 2 * t][n], Bs[kk + 2 * t + 1][n]);
        b[j][1] = pack2(Bs[kk + 2 * t + 8][n], Bs[kk + 2 * t + 9][n]);
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int row = m0 + wm * kWarpRows + i * 16 + g + 8 * h;
          const int col = n0 + wn * kWarpCols + j * 8 + 2 * t + q;
          float v = acc[i][j][2 * h + q];
          if (do_requant) v = requant(v, out_scale, qmin, qmax);
          if (row < M && col < N) out[(int64_t)row * N + col] = v;
        }
}

template <int BM, int BN, int BK, int WM, int WN>
cudaError_t launch(const void* x, const void* wq, const float* scale,
                   float* out, int x_bf16, int M, int K, int N, bool int4,
                   int do_requant, int vec_ok, float out_scale, float qmin,
                   float qmax, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const dim3 block(WM * WN * 32);
  const int8_t* w = static_cast<const int8_t*>(wq);
#define REPRO_QMM(XT, I4)                                                   \
  qmatmul_kernel<BM, BN, BK, WM, WN, XT, I4><<<grid, block, 0, stream>>>(   \
      static_cast<const XT*>(x), w, scale, out, M, K, N, do_requant,        \
      vec_ok, out_scale, qmin, qmax)
  if (int4) {
    if (x_bf16) REPRO_QMM(__nv_bfloat16, true);
    else REPRO_QMM(float, true);
  } else {
    if (x_bf16) REPRO_QMM(__nv_bfloat16, false);
    else REPRO_QMM(float, false);
  }
#undef REPRO_QMM
  return cudaGetLastError();
}

}  // namespace

// out[M, N] (f32) = x[M, K] (f32 or bf16) @ dequant(wq, scale); wq is int8
// [K, N] for bits 5-8 or packed int4 [K, N/2] for bits <= 4; scale [N] f32.
// do_requant: clip(round_half_away(acc / out_scale), qmin, qmax) * out_scale.
// vec_ok: wq and every weight row are 16-byte aligned. All buffers are
// contiguous. Returns cudaGetLastError() of the launch.
extern "C" int repro_qmatmul(const void* x, const void* wq,
                             const float* scale, float* out, int x_bf16,
                             int M, int K, int N, int bits, int do_requant,
                             int vec_ok, float out_scale, float qmin,
                             float qmax, void* stream_ptr) {
  if (M < 0 || K < 0 || N < 0 || bits < 1 || bits > 8 ||
      (bits <= 4 && N % 2))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool int4 = bits <= 4;
  cudaError_t e;
  if (M <= 16)
    e = launch<16, 64, 64, 1, 4>(x, wq, scale, out, x_bf16, M, K, N, int4,
                                 do_requant, vec_ok, out_scale, qmin, qmax,
                                 stream);
  else
    e = launch<64, 128, 32, 2, 4>(x, wq, scale, out, x_bf16, M, K, N, int4,
                                  do_requant, vec_ok, out_scale, qmin, qmax,
                                  stream);
  return (int)e;
}
