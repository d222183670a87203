// Per-tensor dynamic fake-quant for Hopper (sm_90a), called through a plain
// C interface (ctypes) from repro_torch/kernels/aquant.py.
//
// Replaces: the Pallas TPU kernel `aquant_pallas` (body `_kernel`) in
// repro/kernels/aquant.py — over the whole tensor x:
//   amax  = max(max|x|, 1e-9)
//   scale = amax / 2^(b-1), with po2: 2^ceil(log2(scale))
//   out   = clip(round_half_away(x / scale), -2^(b-1), 2^(b-1) - 1) * scale
// in x's type (f32 or bf16; arithmetic in f32).
//
// Bit for bit with the plain version (aquant_ref, fake_quant_dynamic): the
// max is exact in any order; amax / 2^(b-1) is exact; the exponent is
// ceilf(log2f(s)), the libdevice log2f that torch.log2 calls on the card (no
// fast math); 2^e is built exactly with ldexpf; x / scale is an IEEE
// division (nvcc's default -prec-div=true) and exact anyway for a power of
// two; the sign is (r > 0) - (r < 0) as torch.sign computes it, so small
// negatives round to -0.0 as there.
//
// Bound on an H100 SXM: bytes. The function must read x once and write it
// once: 2·n·elt bytes (the tied head's [2048, 49155] f32 table: 805 MB,
// about 0.24 ms at 3.35 TB/s).
//
// Design (two launches on one stream, the TPU's sequential two-phase grid
// unrolled): the first grid-strides over x and writes one partial max per
// block; the second has every block reduce the (at most 1024) partials
// itself, derive the scale, and quantize its grid-stride slice. The scalar
// never leaves the device and nothing is synchronised with the host. x is
// read twice (once per pass), the output written once: 1.5x the bound's
// bytes; a single pass with a grid-wide barrier is later work. Block 0 also
// writes the scale it derived to scale_out when the caller asks for it (the
// straight-through gradient's clip band is [qmin·scale, qmax·scale]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
__device__ float block_max(float v) {
  __shared__ float warp_max[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  float m = warp_max[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
  __syncthreads();
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const T* __restrict__ x, int64_t n, float* __restrict__ partial) {
  float m = 0.f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    m = fmaxf(m, fabsf(to_f32(x[i])));
  m = block_max(m);
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
  m = block_max(m);
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
cudaError_t launch(const void* x, void* out, float* partial, float* scale_out,
                   int64_t n, int bits, int po2, int n_partial,
                   cudaStream_t stream) {
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

}  // namespace

// out = fake_quant(x) over all n elements of the contiguous x (f32 or bf16,
// x_bf16 says which); partial is scratch of n_partial floats (1..1024);
// scale_out, unless null, receives the one f32 scale of the grid.
// Returns cudaGetLastError() of the launches.
extern "C" int repro_aquant(const void* x, void* out, float* partial,
                            float* scale_out, int64_t n, int x_bf16,
                            int bits, int po2, int n_partial,
                            void* stream_ptr) {
  if (n < 0 || bits < 2 || bits > 16 || n_partial < 1 || n_partial > 1024)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e = x_bf16
      ? launch<__nv_bfloat16>(x, out, partial, scale_out, n, bits, po2,
                              n_partial, stream)
      : launch<float>(x, out, partial, scale_out, n, bits, po2, n_partial,
                      stream);
  return (int)e;
}
