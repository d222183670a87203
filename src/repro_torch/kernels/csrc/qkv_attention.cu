// Decode attention over a contiguous int8 KV cache for Hopper (sm_90a),
// called through a plain C interface (ctypes) from
// repro_torch/kernels/qkv_attention.py.
//
// Replaces: the Pallas TPU kernel `qkv_attention_pallas` (body `_kernel`) in
// repro/kernels/qkv_attention.py — per GQA group (one row's KV head), one
// decode query per q-head of the group against an S-slot int8 cache:
// dequantize K = k_q·ks and V = v_q·vs, scores (q·Kᵀ)·D^-½, mask col < len,
// online softmax over S, output p·V in f32. A group with len <= 0 has every
// column masked: its weights are uniform and its output is the mean of the
// dequantized V over all S columns. len >= S reads all S columns.
//
// Bound on an H100 SXM: bytes. A group reads the valid prefix of its K and
// V rows once, at one byte per element (2·Σlen·D bytes; at the serving
// shape, 8 rows × 8 KV heads, Hg 4, D 64, S 1024, at most 8.4 MB, 2.5 us at
// 3.35 TB/s), against 4·Σlen·Hg·D operations. At the serve's sizes a call
// moves 1–3 MB, so what bounds it in practice is latency: how many blocks
// have loads in flight, and the fixed cost of a launch.
//
// The first port ran one block per group (64 blocks on 132 SMs) that walked
// its context serially, 64 columns a tile, with uncovered load latency per
// tile and K/V staged as f32. It stays as the `serial` route (step 0 of the
// redesign, timed beside it by chip_smoke.py phase 2); no call reaches it
// unless the wrapper's route rule is set aside.
//
// The design (split-context, "flash-decoding"):
//  * launch 1, grid (B·Hkv groups, splits), 256 threads: a split is a
//    contiguous range of `per` 64-column tiles (at most 2, so the ring's
//    prologue has every tile of a split in flight at once), planned on the
//    host from B, Hkv and S alone (the lengths are device data, never read
//    on the host: a call can be captured in a CUDA graph). A split whose first column is
//    at or past its group's columns (min(len, S), or S when len <= 0)
//    returns at once;
//  * K and V rows are copied raw (int8) from the cache's own layout
//    [B, S, Hkv, D] through the strides the wrapper passes, with cp.async of
//    16 bytes where D, the strides and the base pointers allow (else 8 or
//    4), into a ring of 2 or 3 shared-memory stages: tiles t+1 and t+2 load
//    while tile t computes, one barrier per tile publishes tile t and frees
//    the stage of tile t-1. Staging the bytes raw (not as f32) takes a
//    quarter of the shared memory per stage, so more blocks fit on an SM;
//    columns past len are never copied, and a length-0 group copies no K;
//  * scores: bf16 q with D % 16 == 0 on the tensor cores (mma.sync
//    m16n8k16, the Hg rows padded to 16; int8 values are exact in bf16 and
//    a product of two bf16 values is exact in f32), f32 q and other D on
//    the f32 CUDA cores; both contract on the int grid and scale by k_scale
//    and D^-½ after the contraction;
//  * online softmax per query row in f32 (one warp per row), P·V in f32 on
//    the CUDA cores (the threads split into groups over D, the rows and the
//    tile's columns; the column groups' sums are added in group order);
//  * each split writes an f32 (m, l, unnormalised acc[D]) partial per query
//    row into scratch that the wrapper allocates; a group with one live
//    split (every group when splits == 1) is normalised and written by that
//    split directly, times v_scale;
//  * launch 2 (only when splits > 1; a programmatic dependent launch, so it
//    is resident before launch 1 drains): one thread per output element of
//    a group with more than one live split merges the live splits in split
//    order (M = max m_s, weights exp(m_s − M)), then scales by v_scale.
//    No atomics: two calls on the same inputs are bitwise equal.
//
// Supported: D a multiple of 4 and <= 256, 1 <= Hg <= 16, S >= 0; the D
// axis contiguous and every row start 4-byte aligned (checked by the
// wrapper).

#include "paged_attention_split.cuh"

namespace {

namespace pa = repro_pa;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 64;
constexpr int kMaxHg = 16;
constexpr int kMaxD = 256;
constexpr int kPStride = kTileCols + 4;     // scores row stride (floats)
constexpr int kRowsPerWarp = kMaxHg / kWarps;
constexpr int kColThreads = kThreads / kTileCols;   // f32 scores: per column
constexpr int kScoreRows = kMaxHg / kColThreads;    // rows per thread
constexpr int kMaxPvRows = 8;     // per thread in P·V (2 elements of D each)
constexpr float kNegInf = -1e30f;
constexpr float kDead = -5e29f;   // below: a masked score

enum Route { kCudaCores = 0, kTensorCores = 1, kSerial = 2 };

struct Params {
  const void* q;                  // [B, Hkv, Hg, D] f32 or bf16
  const unsigned char* k;         // [B, S, Hkv, D] int8 through the strides
  const unsigned char* v;
  const float* k_scale;           // [B, Hkv]
  const float* v_scale;
  const int* lengths;             // [B, Hkv]
  float* out;                     // [B, Hkv, Hg, D]
  float* part_acc;                // [B·Hkv·splits, Hg, D]   (splits > 1)
  float* part_ml;                 // [B·Hkv·splits, Hg, 2]
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, Hkv, Hg, D, S, splits, per;
  int srow;       // shared-memory stride of a staged row (bytes)
  int nchunk;     // 16-byte chunks the f32 score loop reads per row
  int qlen;       // floats per staged f32 q row (nchunk · 16)
  int qh_stride;  // bf16 elements per staged q row (tensor cores)
  int cw;         // cp.async width: 16, 8 or 4
  int stages;     // 2 or 3
  int pv_rg, pv_cg;
  float sm_scale;
};

// Shared-memory layout (bytes); the host sizes the launch with the same.
struct Layout {
  int q, p, small, total;
};

__host__ __device__ inline Layout layout(const Params& p, int stages,
                                         bool tc) {
  Layout L;
  const int ring = stages * 2 * kTileCols * p.srow;
  const int red = p.pv_cg * p.Hg * p.D * 4;   // the epilogue reuses the ring
  L.q = ring > red ? ring : red;
  const int qbytes = tc ? 16 * p.qh_stride * 2 : p.Hg * p.qlen * 4;
  L.p = L.q + (qbytes + 15) / 16 * 16;
  L.small = L.p + kMaxHg * kPStride * 4;
  L.total = L.small + 3 * kMaxHg * 4;         // alpha, m, l per row
  return L;
}

// The columns a group attends: min(len, S), or all S when len <= 0.
__device__ __forceinline__ int group_cols(int len, int S) {
  return len <= 0 ? S : min(len, S);
}

// Splits of a group that hold at least one of its columns (split 0 always
// runs, so a group of no columns still writes its zeros).
__device__ __forceinline__ int live_splits(int n_cols, int per) {
  const int span = per * kTileCols;
  return max(1, (n_cols + span - 1) / span);
}

template <typename QT, bool TC>
__global__ void __launch_bounds__(kThreads, 4) split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the merge launch may start now: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = blockIdx.x;            // = b · Hkv + h
  const int b = grp / p.Hkv;
  const int h = grp - b * p.Hkv;
  const int split = blockIdx.y;
  const int len = p.lengths[grp];
  const bool uniform = len <= 0;
  const int n_cols = group_cols(len, p.S);
  const int c0 = split * p.per * kTileCols;
  if (split > 0 && c0 >= n_cols) return;  // wholly past the group's columns
  const int ntl = min(p.per, (n_cols - c0 + kTileCols - 1) / kTileCols);
  const bool direct = live_splits(n_cols, p.per) == 1;
  const int Hg = p.Hg, D = p.D;
  const int stages = p.stages;

  const Layout L = layout(p, stages, TC);
  unsigned char* s_stage = smem;
  float* s_p = reinterpret_cast<float*>(smem + L.p);
  float* s_alpha = reinterpret_cast<float*>(smem + L.small);
  float* s_m = s_alpha + kMaxHg;
  float* s_l = s_m + kMaxHg;

  // q: as it is for the tensor cores (bf16, rows zero up to 16), else f32
  // pre-scaled by D^-½ and zero past D (the score loop reads whole chunks)
  const size_t qo = (size_t)grp * Hg * D;
  if constexpr (TC) {
    __nv_bfloat16* s_qh = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + qo;
    for (int i = tid; i < 16 * D; i += kThreads) {
      const int r = i / D;
      const int x = i - r * D;
      s_qh[r * p.qh_stride + x] = r < Hg ? qg[i] : __float2bfloat16(0.f);
    }
  } else {
    float* s_q = reinterpret_cast<float*>(smem + L.q);
    const QT* qg = static_cast<const QT*>(p.q) + qo;
    for (int i = tid; i < Hg * p.qlen; i += kThreads) {
      const int r = i / p.qlen;
      const int x = i - r * p.qlen;
      s_q[i] = x < D ? pa::to_f32(qg[r * D + x]) * p.sm_scale : 0.f;
    }
  }
  const float ks = p.k_scale[grp];
  const float vs = p.v_scale[grp];

  // the copy loop: (column, chunk) of this thread's first copy and its
  // strides, the same for every tile
  const int cw = p.cw;
  const int nch = D / cw;
  const int cc0 = tid / nch, ck0 = tid - cc0 * nch;
  const int dcc = kThreads / nch, dck = kThreads - dcc * nch;
  const unsigned char* kg = p.k + b * p.k_sb + h * p.k_sh;
  const unsigned char* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int tile_bytes = kTileCols * p.srow;
  auto load_tile = [&](int t, int stage) {
    unsigned char* sk = s_stage + stage * 2 * tile_bytes;
    unsigned char* sv = sk + tile_bytes;
    const int cb = c0 + t * kTileCols;
    const int nc = min(kTileCols, n_cols - cb);   // columns past len: none
    int c = cc0, k2 = ck0;
    for (int i = tid; i < nc * nch; i += kThreads) {
      const long long col = cb + c;
      const int off = k2 * cw;
      const unsigned char* gk = kg + col * p.k_ss + off;
      const unsigned char* gv = vg + col * p.v_ss + off;
      unsigned char* dk = sk + c * p.srow + off;
      unsigned char* dv = sv + c * p.srow + off;
      if (cw == 16) {
        if (!uniform) pa::cp_async<16>(dk, gk, 16);
        pa::cp_async<16>(dv, gv, 16);
      } else if (cw == 8) {
        if (!uniform) pa::cp_async<8>(dk, gk, 8);
        pa::cp_async<8>(dv, gv, 8);
      } else {
        if (!uniform) pa::cp_async<4>(dk, gk, 4);
        pa::cp_async<4>(dv, gv, 4);
      }
      c += dcc;
      k2 += dck;
      if (k2 >= nch) {
        k2 -= nch;
        ++c;
      }
    }
  };

  // softmax state: warp w owns rows w and w + 8
  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  // P·V: thread (xp, cg, rg) owns elements 2xp, 2xp+1 of rows rg,
  // rg + n_rg, ... over the tile's columns [cg·cpg, (cg + 1)·cpg)
  const int npair = D / 2;
  const int n_rg = p.pv_rg, n_cg = p.pv_cg;
  const int cpg = kTileCols / n_cg;
  const int xp = tid % npair;
  const int pgrp = tid / npair;
  const int cg = pgrp % n_cg;
  const int rg = pgrp / n_cg;
  const bool pv_active = pgrp < n_cg * n_rg;
  float acc[2 * kMaxPvRows];
#pragma unroll
  for (int i = 0; i < 2 * kMaxPvRows; ++i) acc[i] = 0.f;

  for (int t = 0; t < stages - 1; ++t) {
    if (t < ntl) load_tile(t, t);
    pa::cp_async_commit();
  }
  for (int t = 0; t < ntl; ++t) {
    // tile t has landed (tile t+1 may still be in flight), and every thread
    // is done with tile t-1, whose stage is refilled next
    if (stages == 3)
      pa::cp_async_wait<1>();
    else
      pa::cp_async_wait<0>();
    __syncthreads();
    const int nt = t + stages - 1;
    if (nt < ntl) load_tile(nt, nt % stages);
    pa::cp_async_commit();

    const int stage = t % stages;
    const unsigned char* sk = s_stage + stage * 2 * tile_bytes;
    const unsigned char* sv = sk + tile_bytes;
    const int cb = c0 + t * kTileCols;

    if (uniform) {
      // every column masked in the reference: score 0 on each of the S
      for (int i = tid; i < Hg * kTileCols; i += kThreads) {
        const int r = i / kTileCols;
        const int c = i - r * kTileCols;
        s_p[r * kPStride + c] = cb + c < n_cols ? 0.f : kNegInf;
      }
    } else if constexpr (TC) {
      // warp w: the 8 columns [8w, 8w + 8), the 16 (padded) rows, every
      // 16-wide k-step of D
      const int g8 = lane >> 2;
      const int t4 = lane & 3;
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(smem + L.q);
      const int qs = p.qh_stride / 2;         // words per staged q row
      const int nb = warp * 8;
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* krow = sk + (nb + g8) * p.srow;
      for (int k0 = 0; k0 < D; k0 += 16) {
        const uint32_t b0 = pa::k_pair_bf16<8>(krow, k0 + 2 * t4);
        const uint32_t b1 = pa::k_pair_bf16<8>(krow, k0 + 2 * t4 + 8);
        const uint32_t* qa = qw + g8 * qs + k0 / 2 + t4;
        const uint32_t a[4] = {qa[0], qa[8 * qs], qa[4], qa[8 * qs + 4]};
        pa::mma_bf16(c4, a, b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g8 + (e >= 2 ? 8 : 0);
        const int c = nb + 2 * t4 + (e & 1);
        if (r < Hg)
          s_p[r * kPStride + c] =
              cb + c < n_cols ? c4[e] * p.sm_scale * ks : kNegInf;
      }
    } else {
      // thread (column c, row group rh) computes rows rh, rh + 4, ...
      const float* s_q = reinterpret_cast<const float*>(smem + L.q);
      const int c = tid & (kTileCols - 1);
      const int rh = tid / kTileCols;
      float sc[kScoreRows];
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) sc[i] = 0.f;
      const unsigned char* krow = sk + c * p.srow;
      for (int ch = 0; ch < p.nchunk; ++ch) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + ch * 16);
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
          float kf[8];
          pa::decode8<8>(raw, sub, kf, 0.f);
#pragma unroll
          for (int i = 0; i < kScoreRows; ++i) {
            const int r = rh + kColThreads * i;
            if (r >= Hg) break;
            const float* qr = s_q + r * p.qlen + ch * 16 + 8 * sub;
            const float4 q0 = *reinterpret_cast<const float4*>(qr);
            const float4 q1 = *reinterpret_cast<const float4*>(qr + 4);
            float a = sc[i];
            a = fmaf(q0.x, kf[0], a);
            a = fmaf(q0.y, kf[1], a);
            a = fmaf(q0.z, kf[2], a);
            a = fmaf(q0.w, kf[3], a);
            a = fmaf(q1.x, kf[4], a);
            a = fmaf(q1.y, kf[5], a);
            a = fmaf(q1.z, kf[6], a);
            a = fmaf(q1.w, kf[7], a);
            sc[i] = a;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) {
        const int r = rh + kColThreads * i;
        if (r >= Hg) break;
        s_p[r * kPStride + c] = cb + c < n_cols ? sc[i] * ks : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row; masked columns give p = 0 exactly
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= Hg) break;
      float* row = s_p + r * kPStride;
      const float v0 = row[lane];
      const float v1 = row[lane + 32];
      const float mx = pa::warp_max(fmaxf(v0, v1));
      const float m_new = fmaxf(m_r[i], mx);
      const float p0 = v0 > kDead ? expf(v0 - m_new) : 0.f;
      const float p1 = v1 > kDead ? expf(v1 - m_new) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      const float sum = pa::warp_sum(p0 + p1);
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
      if (lane == 0) s_alpha[r] = alpha;
    }
    __syncthreads();

    // acc = acc·alpha + P·V on the int grid of V (v_scale after the merge);
    // a column past len has p = 0 and finite stale bytes in its stage
    if (pv_active) {
#pragma unroll
      for (int i = 0; i < kMaxPvRows; ++i) {
        const int r = rg + n_rg * i;
        if (r >= Hg) break;
        const float a = s_alpha[r];
        acc[2 * i] *= a;
        acc[2 * i + 1] *= a;
      }
      for (int c = cg * cpg; c < (cg + 1) * cpg; c += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vv[u] = pa::v_pair<8>(sv + (c + u) * p.srow, xp, 0.f);
#pragma unroll
        for (int i = 0; i < kMaxPvRows; ++i) {
          const int r = rg + n_rg * i;
          if (r >= Hg) break;
          const float4 pp =
              *reinterpret_cast<const float4*>(s_p + r * kPStride + c);
          float a0 = acc[2 * i], a1 = acc[2 * i + 1];
          a0 = fmaf(pp.x, vv[0].x, a0);
          a1 = fmaf(pp.x, vv[0].y, a1);
          a0 = fmaf(pp.y, vv[1].x, a0);
          a1 = fmaf(pp.y, vv[1].y, a1);
          a0 = fmaf(pp.z, vv[2].x, a0);
          a1 = fmaf(pp.z, vv[2].y, a1);
          a0 = fmaf(pp.w, vv[3].x, a0);
          a1 = fmaf(pp.w, vv[3].y, a1);
          acc[2 * i] = a0;
          acc[2 * i + 1] = a1;
        }
      }
    }
  }

  // -- epilogue: the column groups' partial sums meet in shared memory (over
  //    the free stage ring) and are added in group order
  pa::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= Hg) break;
    if (lane == 0) {
      s_m[r] = m_r[i];
      s_l[r] = l_r[i];
    }
  }
  float* s_red = reinterpret_cast<float*>(s_stage);
  __syncthreads();                     // the last tile's readers are done
  if (pv_active) {
#pragma unroll
    for (int i = 0; i < kMaxPvRows; ++i) {
      const int r = rg + n_rg * i;
      if (r >= Hg) break;
      float* dst = s_red + (cg * Hg + r) * D + 2 * xp;
      dst[0] = acc[2 * i];
      dst[1] = acc[2 * i + 1];
    }
  }
  __syncthreads();
  const size_t part = (size_t)grp * p.splits + split;
  for (int e = tid; e < Hg * D; e += kThreads) {
    const int r = e / D;
    const int x = e - r * D;
    float a = 0.f;
    for (int g = 0; g < n_cg; ++g) a += s_red[(g * Hg + r) * D + x];
    if (direct) {
      p.out[qo + e] = a / fmaxf(s_l[r], 1e-30f) * vs;
    } else {
      p.part_acc[part * Hg * D + e] = a;
      if (x == 0) {
        p.part_ml[(part * Hg + r) * 2] = s_m[r];
        p.part_ml[(part * Hg + r) * 2 + 1] = s_l[r];
      }
    }
  }
}

// Launch 2: merge the live splits' partials in split order, for the groups
// with more than one live split.
__global__ void __launch_bounds__(256) merge_kernel(const Params p) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)p.B * p.Hkv * p.Hg * p.D;
  if (idx >= n) return;
  const size_t grp = idx / ((size_t)p.Hg * p.D);
  const int live = live_splits(group_cols(p.lengths[grp], p.S), p.per);
  if (live == 1) return;               // the split kernel wrote it
  const int e = static_cast<int>(idx - grp * p.Hg * p.D);
  const int r = e / p.D;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* ml = p.part_ml + (grp * p.splits * p.Hg + r) * 2;
  const float* pa_ = p.part_acc + grp * p.splits * p.Hg * p.D + e;
  const size_t ml_step = (size_t)p.Hg * 2;
  const size_t pa_step = (size_t)p.Hg * p.D;
  float M = kNegInf;
  for (int s = 0; s < live; ++s) M = fmaxf(M, ml[s * ml_step]);
  float Lsum = 0.f, O = 0.f;
  for (int s = 0; s < live; ++s) {
    const float w = expf(ml[s * ml_step] - M);
    Lsum = fmaf(ml[s * ml_step + 1], w, Lsum);
    O = fmaf(pa_[s * pa_step], w, O);
  }
  p.out[idx] = O / fmaxf(Lsum, 1e-30f) * p.v_scale[grp];
}

template <typename QT, bool TC>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  const size_t smem = layout(p, p.stages, TC).total;
  // set once per instantiation (not a stream operation, so a call inside a
  // CUDA-graph capture after the first does not touch it)
  static size_t s_allowed = 48 * 1024;
  if (smem > s_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<QT, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    s_allowed = smem;
  }
  split_kernel<QT, TC><<<dim3(p.B * p.Hkv, p.splits), kThreads, smem,
                         stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const size_t n = (size_t)p.B * p.Hkv * p.Hg * p.D;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, merge_kernel, p);
}

// ---------------------------------------------------------------------------
// Step 0: the first port's kernel (one block per group, the context walked
// serially, K/V dequantized and staged as f32), kept as the `serial` route
// so that phase 2 times it beside the split design.
// ---------------------------------------------------------------------------

constexpr int kAccPerThread = kMaxHg * kMaxD / kThreads;

__host__ __device__ constexpr int serial_smem_floats(int hg, int d) {
  return hg * d                       // q
         + 2 * kTileCols * (d + 1)    // dequantized K and V tiles, padded
         + hg * kTileCols             // scores, then probabilities
         + 3 * kMaxHg;                // m, l, alpha
}

template <typename QT>
__global__ void __launch_bounds__(kThreads)
serial_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k,
              const int8_t* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ lengths, float* __restrict__ out,
              int Hkv, int Hg, int D, int S, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              float sm_scale) {
  extern __shared__ float smem_f[];
  const int grp = blockIdx.x;
  const int b = grp / Hkv;
  const int h = grp % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = D + 1;
  const int d4 = D / 4;

  float* s_q = smem_f;
  float* s_k = s_q + Hg * D;
  float* s_v = s_k + kTileCols * ld;
  float* s_p = s_v + kTileCols * ld;
  float* s_m = s_p + Hg * kTileCols;
  float* s_l = s_m + kMaxHg;
  float* s_a = s_l + kMaxHg;

  const float ks = k_scale[grp];
  const float vs = v_scale[grp];
  const int len = lengths[grp];
  const bool uniform = len <= 0;
  const int n_cols = uniform ? S : min(len, S);
  const int8_t* kb = k + b * k_sb + h * k_sh;
  const int8_t* vb = v + b * v_sb + h * v_sh;

  const QT* qb = q + (size_t)grp * Hg * D;
  for (int i = tid; i < Hg * D; i += kThreads) s_q[i] = pa::to_f32(qb[i]);
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
    __syncthreads();
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
    for (int g = warp; g < Hg; g += kWarps) {
      float* row = s_p + g * kTileCols;
      float mx = kNegInf;
      for (int c = lane; c < nc; c += 32) mx = fmaxf(mx, row[c]);
      mx = pa::warp_max(mx);
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < nc; c += 32) {
        const float pr = expf(row[c] - m_new);
        row[c] = pr;
        sum += pr;
      }
      sum = pa::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_a[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
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
cudaError_t launch_serial(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * serial_smem_floats(p.Hg, p.D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        serial_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  serial_kernel<QT><<<p.B * p.Hkv, kThreads, smem, stream>>>(
      static_cast<const QT*>(p.q), reinterpret_cast<const int8_t*>(p.k),
      reinterpret_cast<const int8_t*>(p.v), p.k_scale, p.v_scale, p.lengths,
      p.out, p.Hkv, p.Hg, p.D, p.S, p.k_sb, p.k_ss, p.k_sh, p.v_sb, p.v_ss,
      p.v_sh, p.sm_scale);
  return cudaGetLastError();
}

// The widest cp.async (16, 8 or 4 bytes) that every row start and D allow.
int copy_width(int D, const long long* strides, uintptr_t k, uintptr_t v) {
  for (int w = 16; w > 4; w >>= 1) {
    bool ok = D % w == 0 && k % w == 0 && v % w == 0;
    for (int i = 0; i < 6; ++i) ok = ok && strides[i] % w == 0;
    if (ok) return w;
  }
  return 4;
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = launched),
// cudaErrorInvalidValue for arguments the kernel does not take. Nothing here
// synchronises or allocates: the caller passes the output and, when
// splits > 1, the scratch for the partials.
extern "C" int repro_qkv_attention(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* lengths, float* out, float* part_acc,
    float* part_ml, int q_bf16, int route, int B, int Hkv, int Hg, int D,
    int S, int splits, int tiles_per_split, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float sm_scale, void* stream_ptr) {
  const long long n_tiles = ((long long)S + kTileCols - 1) / kTileCols;
  if (D % 4 || D > kMaxD || D < 4 || Hg > kMaxHg || Hg < 1 || S < 0 ||
      route < kCudaCores || route > kSerial ||
      (route == kTensorCores && (!q_bf16 || D % 16)) || splits < 1 ||
      tiles_per_split < 1 || (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= (n_tiles > 0 ? n_tiles : 1) ||
      (splits > 1 && (!part_acc || !part_ml)))
    return (int)cudaErrorInvalidValue;
  if (B * Hkv == 0) return 0;
  const long long strides[6] = {k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  Params p;
  p.q = q;
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.lengths = lengths;
  p.out = out;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.B = B;
  p.Hkv = Hkv;
  p.Hg = Hg;
  p.D = D;
  p.S = S;
  p.splits = splits;
  p.per = tiles_per_split;
  p.nchunk = (D + 15) / 16;
  p.srow = p.nchunk * 16;
  if ((p.srow / 16) % 2 == 0) p.srow += 16;  // odd 16-byte stride: no bank
                                             // conflicts on 16-byte reads
  p.qlen = p.nchunk * 16;
  p.qh_stride = D + 8;        // odd 16-byte stride: conflict-free fragments
  p.cw = copy_width(D, strides, reinterpret_cast<uintptr_t>(k),
                    reinterpret_cast<uintptr_t>(v));
  p.sm_scale = sm_scale;
  pa::pv_groups(D, Hg, &p.pv_rg, &p.pv_cg);
  const bool tc = route == kTensorCores;
  p.stages = layout(p, 3, tc).total <= 72 * 1024 ? 3 : 2;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e;
  if (route == kSerial)
    e = q_bf16 ? launch_serial<__nv_bfloat16>(p, stream)
               : launch_serial<float>(p, stream);
  else if (tc)
    e = launch_split<__nv_bfloat16, true>(p, stream);
  else
    e = q_bf16 ? launch_split<__nv_bfloat16, false>(p, stream)
               : launch_split<float, false>(p, stream);
  return (int)e;
}
