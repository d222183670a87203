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
// in f32 on the tensor cores (mma.sync or wgmma). Every product of two bf16
// values is exact in f32, so the kernel and its plain version differ only in
// the order of the f32 sums. The fused requant is clip(round_half_away(
// acc / out_scale)) * out_scale with IEEE division.
//
// Bound on an H100 SXM: at decode (M <= 16) bytes — the weights are read
// once, K·N·bits/8 (granite-3-2b's MLP-in at W8: 33.6 MB, about 10 us at
// 3.35 TB/s) — and at prefill (M in the thousands) operations, 2·M·K·N on the
// bf16 tensor cores (989 TFLOP/s dense).
//
// Three kernels, chosen by M and by what TMA can describe (the rule is
// `route_of` in qmatmul.py; this entry point re-checks it and refuses a call
// that breaks it, never falling back from one kernel to another):
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
//  * prefill (M > 16) with bf16 x whose strides TMA can describe (K % 8,
//    weight rows a multiple of 16 bytes, 16-byte aligned bases): the port
//    of repro/kernels/qmatmul.py::qmatmul_pallas at prefill, wgmma fed by a
//    TMA ring, bound by operations (2·M·K·N at 989 TFLOP/s). One block
//    per BM x 128 output tile (BM 256, or 128 when M <= 128), in a grouped
//    raster (8 row tiles per group, so neighbouring blocks share a weight
//    column tile and x row tiles in L2). A producer warpgroup (one thread
//    issues; registers given back with setmaxnreg) keeps a 4-stage ring of
//    64-row K steps in flight with TMA, each stage the bf16 x tile (128-byte
//    swizzle) and the RAW int8/int4 weight tile (TMA cannot convert),
//    completed on mbarriers; ragged K, M and N arrive as TMA's zero fill.
//    Route (a): the two consumer warpgroups (BM/2 rows each, as BM/128
//    wgmmas of 64 rows) dequantize the raw stage on chip into a bf16
//    [64, 128] N-major B tile in the canonical 128-byte-swizzled layout
//    (atoms of 8 K rows x 64 columns; a thread owns 16 columns, whose
//    scales stay in registers, and writes two 16-byte chunks per K row),
//    then fence.proxy.async, a named barrier, and SS wgmma m64n128k16 with
//    x as the K-major A and the B tile read transposed. Three B tiles
//    rotate, so the dequantization of stage t overlaps the wgmma of stage
//    t - 1 (wgmma.wait_group 1). The dequantization is what holds the
//    kernel back: a 256-row tile dequantizes each weight tile once for 256
//    rows of x, half as often per product as a 128-row tile. The f32
//    accumulators are stored (with the fused requant) masked at the M and
//    N edges. No split-K, no atomics: two calls are bitwise equal.
//  * prefill otherwise (f32 x, or strides TMA cannot describe, e.g. N 70):
//    one block per 64 x 128 output tile walks K in 32-row steps (8 warps)
//    with mma.sync m16n8k16; the x tile is staged as bf16 and the weight
//    tile is dequantized to bf16 into shared memory; ragged M, K and N
//    edges are masked in the loads (zeros) and the store. Loads do not
//    overlap compute.

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// prefill (M > 16, bf16 x, TMA-describable operands): wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kPreBN = 128;               // output columns per block
constexpr int kPreBK = 64;                // K rows per stage: 128 bytes of x
constexpr int kPreStages = 4;             // TMA ring
constexpr int kPreBTiles = 3;             // dequantized bf16 B tiles
constexpr int kPreConsumers = 256;        // two warpgroups of BM/2 rows each
constexpr int kPreThreads = kPreConsumers + 128;   // + the producer
constexpr int kPreGroupM = 8;             // row tiles per raster group
constexpr int kPreBarrier = 1;            // named barrier of the consumers

template <int BM, bool INT4>
struct PreTile {
  static constexpr int kMT = BM / 128;               // m64 wgmmas per WG
  static constexpr int kXBytes = BM * kPreBK * 2;               // bf16 x
  static constexpr int kWRow = INT4 ? kPreBN / 2 : kPreBN;      // raw bytes
  static constexpr int kWBytes = kPreBK * kWRow;
  static constexpr int kStage = kXBytes + kWBytes;   // multiple of 1024
  static constexpr int kBTile = kPreBK * kPreBN * 2;  // bf16 [64, 128]
  static constexpr int kAtomsN = kPreBN / 64;         // 64-column atoms
  static constexpr int kBars = kPreStages * kStage + kPreBTiles * kBTile;
  static constexpr int kSmem = kBars + 2 * kPreStages * 8 + 1024;  // + align
  static_assert(kStage % 1024 == 0 && kBTile % 1024 == 0, "1024-B atoms");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// box of `map` at coordinates (c0 innermost, c1) -> shared `dst`, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (each >> 4), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// acc[64] += A (64 x 16, K-major, SW128) . B (16 x 128, N-major, SW128)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// (float)q * s rounded to f32 for two neighbouring columns, each rounded to
// bf16, packed with the lower column in the low half
__device__ __forceinline__ uint32_t deq_pair(float q0, float s0, float q1,
                                             float s1) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(__fmul_rn(q0, s0), __fmul_rn(q1, s1));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One K row of a thread's 16 columns (16 int8 bytes or 8 packed-int4 bytes
// at `src`) dequantized: w[j] holds columns 2j and 2j + 1.
template <bool INT4>
__device__ __forceinline__ void deq16(const unsigned char* src,
                                      const float (&sc)[16],
                                      uint32_t (&w)[8]) {
  if (INT4) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    const uint32_t word[2] = {v.x, v.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // byte i: columns 8h + 2i (low nibble)
      const uint32_t u = word[h] ^ 0x88888888u;     // nibble + 8
      const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[4 * h + i] = deq_pair(byte_to_f32(lo, i, 8388616.f),
                                sc[8 * h + 2 * i],
                                byte_to_f32(hi, i, 8388616.f),
                                sc[8 * h + 2 * i + 1]);
    }
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const uint32_t word[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {   // byte i: column 4h + i
      const uint32_t u = word[h] ^ 0x80808080u;     // byte + 128
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w[2 * h + i] = deq_pair(byte_to_f32(u, 2 * i, 8388736.f),
                                sc[4 * h + 2 * i],
                                byte_to_f32(u, 2 * i + 1, 8388736.f),
                                sc[4 * h + 2 * i + 1]);
    }
  }
}

template <int BM, bool INT4>
__global__ void __launch_bounds__(kPreThreads, 1)
qmatmul_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int M, int K, int N, int do_requant, float out_scale,
                     float qmin, float qmax) {
  using T = PreTile<BM, INT4>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the 128-byte swizzle is a function of address bits
  // 4-9, and every x tile and B atom starts on a 1024-byte boundary
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(smem);
  const uint32_t full0 = s0 + T::kBars;            // [stage] TMA landed
  const uint32_t empty0 = full0 + 8 * kPreStages;  // [stage] slot free
  const int tid = threadIdx.x;

  // grouped raster: blocks walk kPreGroupM row tiles down one column tile
  // before the next, so neighbours share weights and x rows in L2
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + kPreBN - 1) / kPreBN;
  const int per_group = kPreGroupM * tiles_n;
  const int first_m = (blockIdx.x / per_group) * kPreGroupM;
  const int group_m = min(tiles_m - first_m, kPreGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * kPreBN;
  const int steps = (K + kPreBK - 1) / kPreBK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kPreStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kPreConsumers) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kPreConsumers) {
      for (int it = 0; it < steps; ++it) {
        const int slot = it % kPreStages;
        if (it >= kPreStages)             // released by step it - stages
          mbar_wait(empty0 + 8 * slot, (it / kPreStages - 1) & 1);
        const uint32_t st = s0 + slot * T::kStage;
        mbar_expect_tx(full0 + 8 * slot, T::kStage);
        tma_load_2d(st, &tmap_x, full0 + 8 * slot, it * kPreBK, m0);
        tma_load_2d(st + T::kXBytes, &tmap_w, full0 + 8 * slot,
                    INT4 ? n0 / 2 : n0, it * kPreBK);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // consumers: thread tid dequantizes columns 16cg..16cg+15 of K rows
  // r0, r0 + kRows, ... of each stage; warpgroup wg multiplies rows
  // wg·BM/2 .. (wg + 1)·BM/2 - 1 of the tile, as kMT wgmmas of 64 rows
  constexpr int kCG = kPreBN / 16;
  constexpr int kRows = kPreConsumers / kCG;
  const int cg = tid % kCG, r0 = tid / kCG;
  const int wg = tid / 128;
  float sc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 16 * cg + j;
    sc[j] = n < N ? scale[n] : 0.f;
  }
  float acc[T::kMT][kPreBN / 2];
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < kPreBN / 2; ++i) acc[mt][i] = 0.f;
  // the B tile: atoms of 8 K rows x 64 columns (1024 bytes, 128 per row),
  // [K row / 8][column / 64]; the 16-byte chunk c of a row lies at chunk
  // c ^ (row % 8). A thread's columns are chunks c and c + 1 of atom cg / 4.
  const int c = 2 * (cg & 3);

  for (int it = 0; it < steps; ++it) {
    const int slot = it % kPreStages;
    mbar_wait(full0 + 8 * slot, (it / kPreStages) & 1);
    const unsigned char* raw = smem + slot * T::kStage + T::kXBytes;
    unsigned char* bt =
        smem + kPreStages * T::kStage + (it % kPreBTiles) * T::kBTile;
#pragma unroll
    for (int p = 0; p < kPreBK / kRows; ++p) {
      const int k = r0 + p * kRows;
      uint32_t w[8];
      deq16<INT4>(raw + k * T::kWRow + (INT4 ? 8 : 16) * cg, sc, w);
      const int r = k & 7;
      unsigned char* row =
          bt + ((k >> 3) * T::kAtomsN + (cg >> 2)) * 1024 + r * 128;
      *reinterpret_cast<uint4*>(row + ((c ^ r) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(row + (((c + 1) ^ r) << 4)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
    // the B tile's generic writes, visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wgmma_wait<1>();                  // this warpgroup's step it - 2 is done
#pragma unroll
    for (int mt = 0; mt < T::kMT; ++mt) fence_acc(acc[mt]);
    asm volatile("bar.sync %0, %1;\n"
                 :: "n"(kPreBarrier), "n"(kPreConsumers) : "memory");
    // both warpgroups are past step it - 2: its x tile and raw bytes may
    // be overwritten (the raw bytes were read before the previous barrier)
    if (tid == 0 && it >= 2)
      mbar_arrive(empty0 + 8 * ((it - 2) % kPreStages));
    wgmma_fence();
    const uint32_t xa = s0 + slot * T::kStage + wg * (BM / 2) * 128;
    const uint32_t ba =
        s0 + kPreStages * T::kStage + (it % kPreBTiles) * T::kBTile;
#pragma unroll
    for (int kk = 0; kk < kPreBK / 16; ++kk) {
      // A: 64 rows of 128 bytes, 8-row groups 1024 bytes apart; its K slice
      // of 16 starts 32 bytes further per step. B: the K rows 16kk.., N
      // atoms 1024 bytes apart (leading), 8-row groups kAtomsN KB (stride).
      const uint64_t db = sw128_desc(ba + kk * 2 * T::kAtomsN * 1024, 1024,
                                     T::kAtomsN * 1024);
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt) {
        const uint64_t da = sw128_desc(xa + mt * 64 * 128 + 32 * kk, 16, 1024);
        wgmma_n128(acc[mt], da, db);
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt) fence_acc(acc[mt]);

  // acc[mt][4i + 2h + q]: row 64·mt + 16·warp + g + 8h, column 8i + 2t + q
  // of the warpgroup's BM/2 x 128; N % 16 == 0, so column 2t + 1 is in
  // range with 2t
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * (BM / 2) + mt * 64 + warp * 16 + g + 8 * h;
    if (row >= M) continue;
    float* o = out + (int64_t)row * N;
#pragma unroll
    for (int i = 0; i < kPreBN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t;
      if (col >= N) continue;
      float v0 = acc[mt][4 * i + 2 * h], v1 = acc[mt][4 * i + 2 * h + 1];
      if (do_requant) {
        v0 = requant(v0, out_scale, qmin, qmax);
        v1 = requant(v1, out_scale, qmin, qmax);
      }
      *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// the driver's tensor-map encoder, fetched through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [outer, inner] tensor of `row_bytes` per row, cut into boxes
// of box_outer x box_inner elements; out-of-bounds elements read as zeros
cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, uint64_t inner, uint64_t outer,
                          uint64_t row_bytes, uint32_t box_inner,
                          uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides,
                         box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BM, bool INT4>
cudaError_t launch_wgmma(const void* x, const void* wq, const float* scale,
                         float* out, int M, int K, int N, int do_requant,
                         float out_scale, float qmin, float qmax,
                         cudaStream_t stream) {
  using T = PreTile<BM, INT4>;
  static bool smem_set = false;     // this library's own (anonymous namespace)
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmatmul_wgmma_kernel<BM, INT4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const uint64_t wrow = INT4 ? N / 2 : N;          // weight bytes per row
  CUtensorMap mx, mw;
  cudaError_t e = tensor_map_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K,
                                M, (uint64_t)K * 2, kPreBK, BM,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  e = tensor_map_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, wrow, K, wrow,
                    T::kWRow, kPreBK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  const int64_t tiles =
      (int64_t)((M + BM - 1) / BM) * ((N + kPreBN - 1) / kPreBN);
  qmatmul_wgmma_kernel<BM, INT4>
      <<<(unsigned)tiles, kPreThreads, T::kSmem, stream>>>(
          mx, mw, scale, out, M, K, N, do_requant, out_scale, qmin, qmax);
  return cudaGetLastError();
}

}  // namespace

// out[M, N] (f32) = x[M, K] (f32 or bf16) @ dequant(wq, scale); wq is int8
// [K, N] for bits 5-8 or packed int4 [K, N/2] for bits <= 4; scale [N] f32.
// do_requant: clip(round_half_away(acc / out_scale), qmin, qmax) * out_scale.
// vec_ok: wq and every weight row are 16-byte aligned. All buffers are
// contiguous. M <= 16 runs the split-K decode kernel with the host's plan:
// `splits` K-ranges of `k_per_split` rows (a multiple of 64, at most 1024;
// only the last range ragged) and, when splits > 1, an f32 scratch `part` of
// splits * M * N values. M > 16 ignores the plan and runs, by
// `prefill_rows`, the wgmma kernel with tiles of prefill_rows x 128 (128 or
// 256; bf16 x, K % 8 == 0, weight rows a multiple of 16 bytes, x and wq
// 16-byte aligned, or the call is refused) or, when it is 0, the mma.sync
// kernel. Returns cudaGetLastError() of the launches (or the refusal).
extern "C" int repro_qmatmul(const void* x, const void* wq,
                             const float* scale, float* out, float* part,
                             int x_bf16, int M, int K, int N, int bits,
                             int do_requant, int vec_ok, int splits,
                             int k_per_split, int prefill_rows,
                             float out_scale, float qmin, float qmax,
                             void* stream_ptr) {
  if (M < 0 || K < 0 || N < 0 || bits < 1 || bits > 8 ||
      (bits <= 4 && N % 2))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool int4 = bits <= 4;
  if (M > 16 && prefill_rows != 0) {
    const int wrow = int4 ? N / 2 : N;
    if ((prefill_rows != 128 && prefill_rows != 256) || !x_bf16 || K <= 0 ||
        K % 8 || wrow % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(wq) % 16)
      return (int)cudaErrorInvalidValue;
    cudaError_t e;
#define REPRO_WGMMA(BM, I4)                                                \
  e = launch_wgmma<BM, I4>(x, wq, scale, out, M, K, N, do_requant,         \
                           out_scale, qmin, qmax, stream)
    if (prefill_rows == 256) {
      if (int4) REPRO_WGMMA(256, true);
      else REPRO_WGMMA(256, false);
    } else {
      if (int4) REPRO_WGMMA(128, true);
      else REPRO_WGMMA(128, false);
    }
#undef REPRO_WGMMA
    return (int)e;
  }
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
