// Per-tensor dynamic fake-quant for Hopper (sm_90a), called through a plain
// C interface (ctypes) from repro_torch/kernels/aquant.py.
//
// Replaces: the Pallas TPU kernel `aquant_pallas` (body `_kernel`) in
// repro/kernels/aquant.py — over the whole tensor x:
//   amax  = max(max|x|, 1e-9)
//   scale = amax / 2^(b-1), with po2: 2^ceil(log2(scale))
//   out   = clip(round_half_away(x / scale), -2^(b-1), 2^(b-1) - 1) * scale
// arithmetic in f32, written in the caller's type: x's own (f32 or bf16), or
// bf16 from an f32 x (the cast every bf16 caller made right after).
//
// Bit for bit with the plain version (aquant_ref, fake_quant_dynamic): the
// max is exact in any order; amax / 2^(b-1) is exact; the exponent is
// ceilf(log2f(s)), the libdevice log2f that torch.log2 calls on the card (no
// fast math); 2^e is built exactly with ldexpf; x / scale is an IEEE
// division (nvcc's default -prec-div=true), and for a power-of-two scale the
// product x · 2^-e, which is the same correctly rounded value (2^-e is exact,
// subnormals are kept); the sign is (r > 0) - (r < 0) as torch.sign computes
// it, so small negatives round to -0.0 as there. An f32 → bf16 store rounds
// the f32 product q · scale once (__float2bfloat16_rn): that is
// aquant(x).to(torch.bfloat16) bit for bit, signed zeros included.
//
// Bound on an H100 SXM: bytes. x is read once and the output written once:
// n · (elt_in + elt_out) bytes. The amax must be known before the first
// value is quantized, so whatever of x the grid cannot hold on chip across
// the barrier is read a second time: a tensor above the grid's on-chip
// store (aquant.plan: 112 KB of shared memory and 4 16-byte registers per
// thread in each of 2 blocks of 512 threads per SM, 38.9 MB on 132 SMs) is
// held to n · (2 · elt_in + elt_out) bytes less what it kept.
//
// Design (one cooperative launch of a persistent grid, occupancy × SMs):
//  * phase 1: each block keeps an equal share of x on chip — the first part
//    in shared memory (cp.async, every 16-byte copy in flight at once), the
//    next in registers — and the rest of x is streamed in 32 KB tiles that
//    the blocks claim from a counter (16-byte loads, 4 in flight a thread),
//    so a block that streams faster takes more tiles; the block's max|x|
//    goes to the workspace with one atomicMax on its f32 bits (the values
//    are non-negative: their bits order as they do);
//  * a grid-wide barrier on the workspace's arrival counter (release
//    increments, acquire polls); a tensor of at most 512 vectors gets one
//    block, which needs none. The cooperative launch makes the runtime
//    guarantee the co-residency it needs or refuse the launch, and it
//    captures into a CUDA graph (chip_smoke.py times it in one);
//  * phase 2: every block derives the scale and quantizes its register
//    part, then the streamed tiles, claimed again in reverse order (the
//    tiles read last are the likeliest still in L2), then its shared-memory
//    part. Stores are evict-first, so the output does not push the tiles
//    still to be read out of L2;
//  * the last block past the barrier, and the last one done, zero what
//    they counted, so the workspace is left as found: back-to-back calls
//    and graph replays need no memset (two streams get two workspaces from
//    the wrapper);
//  * a head before x's first 16-byte boundary and a tail under one vector
//    are done by block 0 with scalar loads; offsets are 64-bit.
// Block 0 also writes the scale to scale_out when the caller asks for it
// (the straight-through gradient's clip band is [qmin·scale, qmax·scale]).
//
// Step 0 (repro_aquant_step0): the first port's two launches (amax_kernel,
// quant_kernel: x read twice, scalar loads), kept to be timed beside the
// fused kernel; aquant() never reaches it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // step 0's blocks
constexpr int kFusedThreads = 512;
constexpr int kUnroll = 4;                // 16-byte loads in flight a thread
constexpr int kRegVecs = 4;               // 16-byte vectors a thread keeps
constexpr int kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// max over the block, returned to every thread
template <int kN>
__device__ float block_max(float v) {
  __shared__ float warp_max[kN / 32];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  float m = warp_max[0];
  for (int w = 1; w < kN / 32; ++w) m = fmaxf(m, warp_max[w]);
  __syncthreads();
  return m;
}

// ---------------------------------------------------------------- step 0

template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ x, int64_t n, float* __restrict__ partial) {
  float m = 0.f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    m = fmaxf(m, fabsf(to_f32(x[i])));
  m = block_max<kThreads>(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
             const float* __restrict__ partial, int n_partial, int bits,
             int po2, float* __restrict__ scale_out) {
  float m = 0.f;
  for (int i = threadIdx.x; i < n_partial; i += kThreads)
    m = fmaxf(m, partial[i]);
  m = block_max<kThreads>(m);
  const float amax = fmaxf(m, 1e-9f);
  float scale = amax / (float)(1 << (bits - 1));
  if (po2) scale = ldexpf(1.0f, (int)ceilf(log2f(scale)));
  if (scale_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *scale_out = scale;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const float qmin = -(float)(1 << (bits - 1));
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float r = to_f32(x[i]) / scale;
    const float sg = (float)((r > 0.f) - (r < 0.f));
    float q = sg * floorf(fabsf(r) + 0.5f);
    q = fminf(fmaxf(q, qmin), qmax);
    out[i] = from_f32<T>(q * scale);
  }
}

template <typename T>
cudaError_t launch_step0(const void* x, void* out, float* partial,
                         float* scale_out, int64_t n, int bits, int po2,
                         int n_partial, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  amax_kernel<T><<<n_partial, kThreads, 0, stream>>>(xt, n, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  quant_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      xt, static_cast<T*>(out), n, partial, n_partial, bits, po2, scale_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------- fused kernel

// The grid of one call, derived from amax in every block.
struct QGrid {
  float scale, inv, qmin, qmax;
  int po2;
};

__device__ __forceinline__ float fq(float v, const QGrid& g) {
  const float r = g.po2 ? v * g.inv : v / g.scale;
  const float sg = (float)((r > 0.f) - (r < 0.f));
  float q = sg * floorf(fabsf(r) + 0.5f);
  q = fminf(fmaxf(q, g.qmin), g.qmax);
  return q * g.scale;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// One 16-byte vector of Tin: its |max| and its quantized store into Tout.
template <typename Tin, typename Tout> struct Io;

template <> struct Io<float, float> {
  static constexpr int kVe = 4;
  __device__ static float absmax(const uint4& v) {
    return fmaxf(fmaxf(fabsf(__uint_as_float(v.x)), fabsf(__uint_as_float(v.y))),
                 fmaxf(fabsf(__uint_as_float(v.z)), fabsf(__uint_as_float(v.w))));
  }
  __device__ static void store(float* out, int64_t i, const uint4& v,
                               const QGrid& g) {
    uint4 o;
    o.x = __float_as_uint(fq(__uint_as_float(v.x), g));
    o.y = __float_as_uint(fq(__uint_as_float(v.y), g));
    o.z = __float_as_uint(fq(__uint_as_float(v.z), g));
    o.w = __float_as_uint(fq(__uint_as_float(v.w), g));
    __stcs(reinterpret_cast<uint4*>(out) + i, o);
  }
};

template <> struct Io<float, __nv_bfloat16> {
  static constexpr int kVe = 4;
  __device__ static float absmax(const uint4& v) {
    return Io<float, float>::absmax(v);
  }
  __device__ static void store(__nv_bfloat16* out, int64_t i, const uint4& v,
                               const QGrid& g) {
    uint2 o;
    o.x = bf16_bits(fq(__uint_as_float(v.x), g)) |
          (bf16_bits(fq(__uint_as_float(v.y), g)) << 16);
    o.y = bf16_bits(fq(__uint_as_float(v.z), g)) |
          (bf16_bits(fq(__uint_as_float(v.w), g)) << 16);
    __stcs(reinterpret_cast<uint2*>(out) + i, o);
  }
};

template <> struct Io<__nv_bfloat16, __nv_bfloat16> {
  static constexpr int kVe = 8;
  // bf16 -> f32 is exact: the bits moved to the top half
  __device__ static float lo(uint32_t w) { return __uint_as_float(w << 16); }
  __device__ static float hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  __device__ static float absmax(const uint4& v) {
    float m = fmaxf(fabsf(lo(v.x)), fabsf(hi(v.x)));
    m = fmaxf(m, fmaxf(fabsf(lo(v.y)), fabsf(hi(v.y))));
    m = fmaxf(m, fmaxf(fabsf(lo(v.z)), fabsf(hi(v.z))));
    return fmaxf(m, fmaxf(fabsf(lo(v.w)), fabsf(hi(v.w))));
  }
  __device__ static uint32_t pair(uint32_t w, const QGrid& g) {
    return bf16_bits(fq(lo(w), g)) | (bf16_bits(fq(hi(w), g)) << 16);
  }
  __device__ static void store(__nv_bfloat16* out, int64_t i, const uint4& v,
                               const QGrid& g) {
    uint4 o;
    o.x = pair(v.x, g);
    o.y = pair(v.y, g);
    o.z = pair(v.z, g);
    o.w = pair(v.w, g);
    __stcs(reinterpret_cast<uint4*>(out) + i, o);
  }
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// p += 1, ordered after every earlier access of this thread
__device__ __forceinline__ void red_release_inc(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
               :: "l"(p) : "memory");
}

// p += 1, returning the old value; ordered after every earlier access of
// this thread and before every later one
__device__ __forceinline__ unsigned atom_acq_rel_inc(unsigned* p) {
  unsigned v;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(uint4* smem, const uint4* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

// ws: [0] amax as f32 bits, [1] blocks arrived, [2] blocks departed,
// [3] phase-1 tiles claimed, [4] phase-2 tiles claimed, [5] blocks done;
// all 0 on entry and on exit. Block b keeps vectors [b·kb, (b+1)·kb) of x's
// aligned body (kb = keep_smem + keep_reg, clipped to n_vec): the first
// keep_smem in shared memory (cp.async, all in flight at once), the next
// keep_reg in registers (vector rs + r·512 + tid in reg[r]). The rest of
// the body, [grid·kb, n_vec), is streamed in tiles of kTile vectors that
// the blocks claim from a counter (thread 0 claims the next tile while the
// block works on this one): in order in phase 1, in reverse order in phase
// 2 (the tiles read last are the likeliest still in L2), so a block that
// streams faster takes more tiles and none waits on a slow one.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kFusedThreads, 2)
aquant_fused_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                    unsigned* __restrict__ ws, float* __restrict__ scale_out,
                    int64_t n, int head, int keep_smem, int keep_reg,
                    int bits, int po2) {
  using IO = Io<Tin, Tout>;
  constexpr int kVe = IO::kVe;
  constexpr int64_t kTile = (int64_t)kUnroll * kFusedThreads;
  extern __shared__ uint4 kept[];
  __shared__ float s_amax;
  __shared__ unsigned s_tile[2];
  const int tid = threadIdx.x;
  const int64_t n_vec = (n - head) / kVe;
  const int64_t tail0 = head + n_vec * kVe;
  const int tail = (int)(n - tail0);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  Tout* ov = out + head;
  const int64_t kb = (int64_t)keep_smem + keep_reg;
  const int64_t s = lmin((int64_t)blockIdx.x * kb, n_vec);
  const int64_t rs = lmin(s + keep_smem, n_vec);
  const int64_t re = lmin(rs + keep_reg, n_vec);
  const int64_t s0 = lmin((int64_t)gridDim.x * kb, n_vec);
  const unsigned n_tiles = (unsigned)((n_vec - s0 + kTile - 1) / kTile);
  const int n_kept = (int)(rs - s);

  // ---- phase 1: max|x|, keeping what fits ----
  for (int j = tid; j < n_kept; j += kFusedThreads)
    cp_async16(kept + j, xv + s + j);
  asm volatile("cp.async.commit_group;" ::: "memory");
  float m = 0.f, hv = 0.f, tv = 0.f;
  if (blockIdx.x == 0) {
    if (tid < head) {
      hv = to_f32(x[tid]);
      m = fabsf(hv);
    }
    if (tid < tail) {
      tv = to_f32(x[tail0 + tid]);
      m = fmaxf(m, fabsf(tv));
    }
  }
  uint4 reg[kRegVecs];
#pragma unroll
  for (int r = 0; r < kRegVecs; ++r) {
    const int64_t k = rs + r * kFusedThreads + tid;
    reg[r] = k < re ? __ldcs(xv + k) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int r = 0; r < kRegVecs; ++r) m = fmaxf(m, IO::absmax(reg[r]));
  if (n_tiles > 0) {
    if (tid == 0) s_tile[0] = atomicAdd(ws + 3, 1u);
    __syncthreads();
    for (int buf = 0;; buf ^= 1) {
      const unsigned t = s_tile[buf];
      if (t >= n_tiles) break;
      if (tid == 0) s_tile[buf ^ 1] = atomicAdd(ws + 3, 1u);
      const int64_t base = s0 + t * kTile + tid;
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * kFusedThreads < n_vec)
          v[u] = __ldg(xv + base + u * kFusedThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * kFusedThreads < n_vec)
          m = fmaxf(m, IO::absmax(v[u]));
      __syncthreads();                   // s_tile[buf] is free again
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  for (int j = tid; j < n_kept; j += kFusedThreads)   // this thread's copies
    m = fmaxf(m, IO::absmax(kept[j]));

  // ---- the grid-wide barrier ----
  // (the arrival releases this block's atomicMax; the acquire that sees
  // every arrival sees every block's max)
  // A lone block holding all of x (a small tensor) has the amax already.
  float amax = block_max<kFusedThreads>(m);
  if (gridDim.x > 1 || n_tiles > 0) {
    if (tid == 0) {
      atomicMax(ws, __float_as_uint(amax));
      red_release_inc(ws + 1);
      while (ld_acquire(ws + 1) < gridDim.x) __nanosleep(64);
      s_amax = __uint_as_float(ld_acquire(ws));
    }
    __syncthreads();
    amax = s_amax;
    if (tid == 0 && atom_acq_rel_inc(ws + 2) == gridDim.x - 1) {
      ws[0] = 0u;                        // every block has read the amax and
      ws[1] = 0u;                        // made its last phase-1 claim
      ws[2] = 0u;
      ws[3] = 0u;
    }
  }

  // ---- phase 2: the scale, then quantize ----
  QGrid g;
  g.scale = fmaxf(amax, 1e-9f) / (float)(1 << (bits - 1));
  g.inv = 0.f;
  g.po2 = po2;
  if (po2) {
    const int ex = (int)ceilf(log2f(g.scale));
    g.scale = ldexpf(1.0f, ex);
    g.inv = ldexpf(1.0f, -ex);
  }
  g.qmax = (float)((1 << (bits - 1)) - 1);
  g.qmin = -(float)(1 << (bits - 1));
  if (scale_out != nullptr && blockIdx.x == 0 && tid == 0)
    *scale_out = g.scale;
  if (blockIdx.x == 0) {
    if (tid < head) out[tid] = from_f32<Tout>(fq(hv, g));
    if (tid < tail) out[tail0 + tid] = from_f32<Tout>(fq(tv, g));
  }
#pragma unroll
  for (int r = 0; r < kRegVecs; ++r) {
    const int64_t k = rs + r * kFusedThreads + tid;
    if (k < re) IO::store(ov, k, reg[r], g);
  }
  if (n_tiles > 0) {
    if (tid == 0) s_tile[0] = atomicAdd(ws + 4, 1u);
    __syncthreads();
    for (int buf = 0;; buf ^= 1) {
      const unsigned c = s_tile[buf];
      if (c >= n_tiles) break;
      if (tid == 0) s_tile[buf ^ 1] = atomicAdd(ws + 4, 1u);
      const int64_t base = s0 + (int64_t)(n_tiles - 1 - c) * kTile + tid;
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * kFusedThreads < n_vec)
          v[u] = __ldcs(xv + base + u * kFusedThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * kFusedThreads < n_vec)
          IO::store(ov, base + u * kFusedThreads, v[u], g);
      __syncthreads();
    }
  }
  for (int j = tid; j < n_kept; j += kFusedThreads)
    IO::store(ov, s + j, kept[j], g);
  if (n_tiles > 0 && tid == 0 && atom_acq_rel_inc(ws + 5) == gridDim.x - 1) {
    ws[4] = 0u;                          // every block has made its last
    ws[5] = 0u;                          // phase-2 claim
  }
}

template <typename Tin, typename Tout>
cudaError_t set_smem(int smem_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      aquant_fused_kernel<Tin, Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(aquant_fused_kernel<Tin, Tout>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename Tin, typename Tout>
int blocks_per_sm(int smem_bytes) {
  cudaError_t e = set_smem<Tin, Tout>(smem_bytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, aquant_fused_kernel<Tin, Tout>, kFusedThreads, smem_bytes);
  return e == cudaSuccess ? blocks : -(int)e;
}

template <typename Tin, typename Tout>
cudaError_t launch_fused(const void* x, void* out, unsigned* ws,
                         float* scale_out, int64_t n, int bits, int po2,
                         int grid, int keep_smem, int keep_reg, int head,
                         cudaStream_t stream) {
  constexpr int kVe = Io<Tin, Tout>::kVe;
  constexpr int64_t kTile = (int64_t)kUnroll * kFusedThreads;
  const Tin* xt = static_cast<const Tin*>(x);
  Tout* ot = static_cast<Tout*>(out);
  const int64_t n_vec = (n - head) / kVe;
  if (head < 0 || head >= kVe || head > n || keep_smem < 0 ||
      keep_smem > kMaxSmemBytes / 16 || keep_reg < 0 ||
      keep_reg > kRegVecs * kFusedThreads ||
      (n_vec - (int64_t)grid * (keep_smem + keep_reg)) / kTile >= 0xffffffffLL)
    return cudaErrorInvalidValue;
  // the body's vectors and their stores must be aligned: the wrapper gives
  // out the same offset, in elements, from a 16-byte boundary as x
  if (n_vec > 0 &&
      (reinterpret_cast<uintptr_t>(xt + head) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(ot + head) % (kVe * sizeof(Tout)) != 0))
    return cudaErrorMisalignedAddress;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kFusedThreads);
  cfg.dynamicSmemBytes = (size_t)keep_smem * 16;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, aquant_fused_kernel<Tin, Tout>,
                                     xt, ot, ws, scale_out, n, head,
                                     keep_smem, keep_reg, bits, po2);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace

// Blocks of the fused kernel that fit on one SM with smem_bytes of dynamic
// shared memory (after raising the kernel's limit to it), for x bf16 or f32
// and the output bf16 or f32; a negative CUDA error where the query fails.
extern "C" int repro_aquant_blocks_per_sm(int x_bf16, int out_bf16,
                                          int smem_bytes) {
  if (smem_bytes < 0 || smem_bytes > kMaxSmemBytes)
    return -(int)cudaErrorInvalidValue;
  if (x_bf16) {
    if (!out_bf16) return -(int)cudaErrorInvalidValue;
    return blocks_per_sm<__nv_bfloat16, __nv_bfloat16>(smem_bytes);
  }
  return out_bf16 ? blocks_per_sm<float, __nv_bfloat16>(smem_bytes)
                  : blocks_per_sm<float, float>(smem_bytes);
}

// out = fake_quant(x) over all n elements of the contiguous x (f32 or bf16,
// x_bf16 says which), stored as bf16 when out_bf16 (from f32 or bf16 x) and
// as f32 otherwise (f32 x only). ws is this stream's 6-word workspace
// (zero, and left zero). The plan (aquant.plan) gives the grid, the 16-byte
// vectors each block keeps in shared memory and in registers, and x's head
// (elements before its first 16-byte boundary; out must sit at the same
// offset). scale_out, unless null, receives the f32 scale. Returns the
// launch's error (cudaGetLastError()); a refused cooperative launch is an
// error like any other.
extern "C" int repro_aquant(const void* x, void* out, unsigned* ws,
                            float* scale_out, int64_t n, int x_bf16,
                            int out_bf16, int bits, int po2, int grid,
                            int keep_smem, int keep_reg, int head,
                            void* stream_ptr) {
  if (n < 0 || bits < 2 || bits > 16 || grid < 1 || ws == nullptr ||
      (x_bf16 && !out_bf16))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e;
  if (x_bf16)
    e = launch_fused<__nv_bfloat16, __nv_bfloat16>(
        x, out, ws, scale_out, n, bits, po2, grid, keep_smem, keep_reg, head,
        stream);
  else if (out_bf16)
    e = launch_fused<float, __nv_bfloat16>(
        x, out, ws, scale_out, n, bits, po2, grid, keep_smem, keep_reg, head,
        stream);
  else
    e = launch_fused<float, float>(x, out, ws, scale_out, n, bits, po2, grid,
                                   keep_smem, keep_reg, head, stream);
  return (int)e;
}

// Step 0, the first port's design: out = fake_quant(x) in x's type by two
// launches; partial is scratch of n_partial floats (1..1024). Returns
// cudaGetLastError() of the launches.
extern "C" int repro_aquant_step0(const void* x, void* out, float* partial,
                                  float* scale_out, int64_t n, int x_bf16,
                                  int bits, int po2, int n_partial,
                                  void* stream_ptr) {
  if (n < 0 || bits < 2 || bits > 16 || n_partial < 1 || n_partial > 1024)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e = x_bf16
      ? launch_step0<__nv_bfloat16>(x, out, partial, scale_out, n, bits, po2,
                                    n_partial, stream)
      : launch_step0<float>(x, out, partial, scale_out, n, bits, po2,
                            n_partial, stream);
  return (int)e;
}
