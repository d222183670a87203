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
// Bound on an H100 SXM: at decode (M <= 16) bytes — the weights are read
// once, K·N·bits/8 (granite-3-2b's MLP-in at W8: 33.6 MB, about 10 us at
// 3.35 TB/s) — and at prefill (M in the thousands) operations, 2·M·K·N on the
// bf16 tensor cores (989 TFLOP/s dense).
//
// Two kernels, chosen by M:
//  * decode (M <= 16), split-K weight streaming. The grid is column tiles
//    (128 columns at int8, 256 at int4: 128 weight bytes per row either way)
//    times K-splits, sized by the host's planner (`split_plan` in
//    qmatmul.py) to a few blocks per SM, so that enough weight bytes are in
//    flight to approach HBM bandwidth; each split covers whole 64-row steps
//    and only the last is ragged. A block stages its rows of x for its
//    K-range as bf16 in shared memory once, then walks the range through a
//    3-stage ring of raw int8/int4 bytes filled with 16-byte cp.async.cg
//    (commit/wait groups), so stages t+1 and t+2 arrive while stage t is
//    multiplied; weight rows that are not 16-byte aligned go into the same
//    ring by plain byte loads. Each warp owns 32 (int8) or 64 (int4)
//    columns. A thread reads one 32-bit word of each of the four K rows of
//    its m16n8k16 B fragment and dequantizes it into registers (int -> f32
//    by a magic-number add, x scale in f32, round to bf16): the word's 4 (8)
//    neighbouring columns go to 4 (8) different fragments, so fragment j's
//    column g is physical column 4g + j (8g + j), and the store maps back.
//    When there is more than one split, each writes an f32 partial
//    [split, M, N] (float4 rows) and a second launch, a programmatic
//    dependent of the first so that its launch overlaps it, adds the
//    partials in split order and applies the fused requant; with one split
//    the kernel writes out itself. No atomics: two calls on the same inputs
//    are bitwise equal.
//  * prefill (M > 16): one block per 64 x 128 output tile walks K in 32-row
//    steps (8 warps); the x tile is staged as bf16 and the weight tile is
//    dequantized to bf16 into shared memory (int8 bytes move from HBM,
//    never a bf16 weight image). Each warp owns a 32 x 32 sub-tile of
//    m16n8k16 fragments with f32 accumulators; ragged M, K and N edges are
//    masked in the loads (zeros) and the store. It does not overlap loads
//    with compute and uses mma.sync, not wgmma: its wgmma/TMA redesign is
//    the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// ---------------------------------------------------------------------------
// decode (M <= 16): split-K weight streaming through a cp.async ring
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;          // 4 warps side by side along N
constexpr int kDecBK = 64;                // K rows per ring stage
constexpr int kDecStages = 3;
constexpr int kDecRowBytes = 128;         // weight bytes per stage row
constexpr int kDecPitch = kDecRowBytes + 16;   // 36 words: conflict-free reads
constexpr int kDecRingBytes = kDecStages * kDecBK * kDecPitch;
constexpr int kDecMaxSplitK = 1024;       // longest K-range of one split
constexpr int kDecMaxSmem = kDecRingBytes + 16 * (kDecMaxSplitK + 8) * 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Byte i of `biased` (an unsigned value b in 0..255) as the float 2^23 + b,
// minus `magic` (2^23 + the bias): the signed integer, exactly.
__device__ __forceinline__ float byte_to_f32(uint32_t biased, int i,
                                             float magic) {
  return __fsub_rn(__int_as_float(__byte_perm(biased, 0x4B000000u,
                                               0x7440u | i)), magic);
}

// (q * s rounded to f32) of two K rows, each then rounded to bf16, packed
// as one B-fragment register (lower K row in the low half)
__device__ __forceinline__ uint32_t deq2(float q0, float q1, float s) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(__fmul_rn(q0, s), __fmul_rn(q1, s));
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename XT, bool INT4>
__global__ void __launch_bounds__(kDecThreads)
qmatmul_splitk_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                      const float* __restrict__ scale, float* __restrict__ out,
                      float* __restrict__ part, int M, int K, int N,
                      int n_tiles, int k_per_split, int do_requant,
                      int vec_ok, int x_vec, float out_scale, float qmin,
                      float qmax) {
  constexpr int kCols = INT4 ? 256 : 128;          // columns per block
  constexpr int kWarpCols = kCols / 4;
  constexpr int kFrags = INT4 ? 8 : 4;             // n8 fragments per warp
  constexpr int kColsPerWord = INT4 ? 8 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                      // [stage][BK][kDecPitch]
  __nv_bfloat16* xs =                              // [rows][k_per_split + 8]
      reinterpret_cast<__nv_bfloat16*>(smem + kDecRingBytes);
  const int xpitch = k_per_split + 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the merge launch (if any) may be placed from now on
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tile = blockIdx.x % n_tiles, split = blockIdx.x / n_tiles;
  const int n0 = tile * kCols;
  const int kb = split * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int steps = (ke - kb + kDecBK - 1) / kDecBK;
  const int64_t wpitch = INT4 ? N / 2 : N;        // bytes per weight row
  const int64_t nb0 = (int64_t)tile * kDecRowBytes;
  const int xrows = M <= 8 ? 8 : 16;

  // one 64-row step of weight bytes -> ring slot; rows past the split's end
  // and bytes past the row are zeros
  auto load_stage = [&](int step, int slot) {
    unsigned char* dst = ring + slot * (kDecBK * kDecPitch);
    const int k0 = kb + step * kDecBK;
    for (int c = tid; c < kDecBK * (kDecRowBytes / 16); c += kDecThreads) {
      const int r = c / (kDecRowBytes / 16);
      const int cb = (c % (kDecRowBytes / 16)) * 16;
      const int k = k0 + r;
      const int64_t gb = nb0 + cb;
      unsigned char* d = dst + r * kDecPitch + cb;
      if (vec_ok) {                 // rows are whole 16-byte chunks
        const bool in = k < ke && gb < wpitch;
        cp_async16(d, in ? wq + (int64_t)k * wpitch + gb : wq, in ? 16 : 0);
      } else {
        union {
          uint4 v;
          int8_t b[16];
        } chunk;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          chunk.b[j] = (k < ke && gb + j < wpitch)
                           ? wq[(int64_t)k * wpitch + gb + j] : (int8_t)0;
        *reinterpret_cast<uint4*>(d) = chunk.v;
      }
    }
  };

  // x[:, kb:ke] -> xs as bf16 (zeros past M and ke), in the first group
  const int xcols = steps * kDecBK;
  if (x_vec) {                      // bf16 rows of whole 16-byte chunks
    const int cpr = xcols / 8;
    for (int c = tid; c < xrows * cpr; c += kDecThreads) {
      const int r = c / cpr, kc = (c % cpr) * 8;
      const bool in = r < M && kb + kc < ke;
      cp_async16(xs + r * xpitch + kc,
                 in ? static_cast<const void*>(x + (int64_t)r * K + kb + kc)
                    : static_cast<const void*>(x),
                 in ? 16 : 0);
    }
  }
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  if (!x_vec) {
    for (int e = tid; e < xrows * xcols; e += kDecThreads) {
      const int r = e / xcols, c = e % xcols;
      const float v = (r < M && kb + c < ke)
                          ? to_f32(x[(int64_t)r * K + kb + c]) : 0.f;
      xs[r * xpitch + c] = __float2bfloat16_rn(v);
    }
  }

  // this thread's columns: fragment j's column g is word g's column j
  const int wc0 = n0 + warp * kWarpCols + kColsPerWord * g;
  float sc[kFrags];
#pragma unroll
  for (int j = 0; j < kFrags; ++j)
    sc[j] = wc0 + j < N ? scale[wc0 + j] : 0.f;

  float acc[kFrags][4];
#pragma unroll
  for (int j = 0; j < kFrags; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();                // stage `it` (and x) visible to all;
                                    // slot (it - 1) % S free again
    if (it + kDecStages - 1 < steps)
      load_stage(it + kDecStages - 1, (it + kDecStages - 1) % kDecStages);
    cp_async_commit();

    const unsigned char* st = ring + (it % kDecStages) * (kDecBK * kDecPitch) +
                              warp * 32 + 4 * g;
    const __nv_bfloat16* xr = xs + g * xpitch + it * kDecBK + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kDecBK; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(xr + kk);
      a[2] = ld32(xr + kk + 8);
      if (M > 8) {
        a[1] = ld32(xr + 8 * xpitch + kk);
        a[3] = ld32(xr + 8 * xpitch + kk + 8);
      } else {
        a[1] = a[3] = 0u;
      }
      // the fragment's four K rows: 2t, 2t + 1, 2t + 8, 2t + 9
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(
            st + (kk + 2 * t + (r & 1) + 8 * (r >> 1)) * kDecPitch);
      if (INT4) {
        uint32_t lo[4], hi[4];      // nibble + 8 in each byte
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t u = w[r] ^ 0x88888888u;
          lo[r] = u & 0x0F0F0F0Fu;
          hi[r] = (u >> 4) & 0x0F0F0F0Fu;
        }
#pragma unroll
        for (int j = 0; j < kFrags; ++j) {
          const uint32_t* src = (j & 1) ? hi : lo;   // odd column: high nibble
          const int i = j >> 1;
          uint32_t b[2];
          b[0] = deq2(byte_to_f32(src[0], i, 8388616.f),
                      byte_to_f32(src[1], i, 8388616.f), sc[j]);
          b[1] = deq2(byte_to_f32(src[2], i, 8388616.f),
                      byte_to_f32(src[3], i, 8388616.f), sc[j]);
          mma_bf16(acc[j], a, b);
        }
      } else {
        uint32_t u[4];              // byte + 128
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = w[r] ^ 0x80808080u;
#pragma unroll
        for (int j = 0; j < kFrags; ++j) {
          uint32_t b[2];
          b[0] = deq2(byte_to_f32(u[0], j, 8388736.f),
                      byte_to_f32(u[1], j, 8388736.f), sc[j]);
          b[1] = deq2(byte_to_f32(u[2], j, 8388736.f),
                      byte_to_f32(u[3], j, 8388736.f), sc[j]);
          mma_bf16(acc[j], a, b);
        }
      }
    }
  }
  cp_async_wait<0>();               // no copy outlives the block

  // c0, c1: row g, fragment columns 2t, 2t+1; c2, c3: row g + 8. Fragment
  // j's column c is physical column kColsPerWord * c + j of the warp's slice.
  // So a thread's values of one row and one q are kFrags neighbouring
  // columns, stored as float4s when the rows allow it.
  float* dst = part ? part + (int64_t)split * M * N : out;
  const bool rq = do_requant && part == nullptr;
  const int cw0 = n0 + warp * kWarpCols;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c0 = cw0 + kColsPerWord * (2 * t + q);
      float v[kFrags];
#pragma unroll
      for (int j = 0; j < kFrags; ++j) {
        v[j] = acc[j][2 * h + q];
        if (rq) v[j] = requant(v[j], out_scale, qmin, qmax);
      }
      float* o = dst + (int64_t)row * N + c0;
      if (N % 4 == 0 && c0 + kFrags <= N) {
#pragma unroll
        for (int j = 0; j < kFrags; j += 4)
          *reinterpret_cast<float4*>(o + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < kFrags; ++j)
          if (c0 + j < N) o[j] = v[j];
      }
    }
  }
}

// out = sum of the splits' partials in split order, then the fused requant.
// Launched as a programmatic dependent of the split kernel: its blocks are
// placed while the split kernel runs and wait here for its writes.
__global__ void __launch_bounds__(256)
qmatmul_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int64_t mn, int splits, int do_requant, float out_scale,
                     float qmin, float qmax) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += stride) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[(int64_t)s * mn + i];
    if (do_requant) v = requant(v, out_scale, qmin, qmax);
    out[i] = v;
  }
}

template <typename XT, bool INT4>
cudaError_t launch_splitk(const void* x, const int8_t* wq, const float* scale,
                          float* out, float* part, int M, int K, int N,
                          int splits, int k_per_split, int do_requant,
                          int vec_ok, int x_vec, float out_scale, float qmin,
                          float qmax, cudaStream_t stream) {
  static bool smem_set = false;     // this library's own (anonymous namespace)
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmatmul_splitk_kernel<XT, INT4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kDecMaxSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int cols = INT4 ? 256 : 128;
  const int n_tiles = (N + cols - 1) / cols;
  const size_t smem =                // x's rows: 8 when M <= 8, else 16
      kDecRingBytes + (size_t)(M <= 8 ? 8 : 16) * (k_per_split + 8) * 2;
  qmatmul_splitk_kernel<XT, INT4>
      <<<(unsigned)((int64_t)n_tiles * splits), kDecThreads, smem, stream>>>(
          static_cast<const XT*>(x), wq, scale, out,
          splits > 1 ? part : nullptr, M, K, N, n_tiles, k_per_split,
          do_requant, vec_ok, x_vec, out_scale, qmin, qmax);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t mn = (int64_t)M * N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =                      // at most 4 blocks per SM of an H100
      dim3((unsigned)std::min<int64_t>((mn + 255) / 256, 4 * 132));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, qmatmul_merge_kernel,
                            static_cast<const float*>(part), out, mn, splits,
                            do_requant, out_scale, qmin, qmax);
}

}  // namespace

// out[M, N] (f32) = x[M, K] (f32 or bf16) @ dequant(wq, scale); wq is int8
// [K, N] for bits 5-8 or packed int4 [K, N/2] for bits <= 4; scale [N] f32.
// do_requant: clip(round_half_away(acc / out_scale), qmin, qmax) * out_scale.
// vec_ok: wq and every weight row are 16-byte aligned. All buffers are
// contiguous. M <= 16 runs the split-K decode kernel with the host's plan:
// `splits` K-ranges of `k_per_split` rows (a multiple of 64, at most 1024;
// only the last range ragged) and, when splits > 1, an f32 scratch `part` of
// splits * M * N values; M > 16 runs the prefill kernel and ignores the
// plan. Returns cudaGetLastError() of the launches.
extern "C" int repro_qmatmul(const void* x, const void* wq,
                             const float* scale, float* out, float* part,
                             int x_bf16, int M, int K, int N, int bits,
                             int do_requant, int vec_ok, int splits,
                             int k_per_split, float out_scale, float qmin,
                             float qmax, void* stream_ptr) {
  if (M < 0 || K < 0 || N < 0 || bits < 1 || bits > 8 ||
      (bits <= 4 && N % 2))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool int4 = bits <= 4;
  if (M > 16)
    return (int)launch<64, 128, 32, 2, 4>(x, wq, scale, out, x_bf16, M, K, N,
                                          int4, do_requant, vec_ok, out_scale,
                                          qmin, qmax, stream);
  // the plan covers K exactly once with whole 64-row steps
  if (splits < 1 || k_per_split < kDecBK || k_per_split % kDecBK ||
      k_per_split > kDecMaxSplitK ||
      (int64_t)splits * k_per_split < K ||
      (K > 0 ? (int64_t)(splits - 1) * k_per_split >= K : splits != 1) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(wq);
  const int x_vec = x_bf16 && K % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t e;
#define REPRO_SPLITK(XT, I4)                                               \
  e = launch_splitk<XT, I4>(x, w, scale, out, part, M, K, N, splits,       \
                            k_per_split, do_requant, vec_ok, x_vec,        \
                            out_scale, qmin, qmax, stream)
  if (int4) {
    if (x_bf16) REPRO_SPLITK(__nv_bfloat16, true);
    else REPRO_SPLITK(float, true);
  } else {
    if (x_bf16) REPRO_SPLITK(__nv_bfloat16, false);
    else REPRO_SPLITK(float, false);
  }
#undef REPRO_SPLITK
  return (int)e;
}
