// Split-context ("flash-decoding") paged attention for Hopper (sm_90a): the
// device code shared by K1 (paged_attention.cu, one query per row) and K2
// (paged_attention_multi.cu, the W queries of a draft/verify window). Each
// source includes this header and instantiates the cases it serves; both
// export the same C signature (see `entry` below).
//
// One algorithm serves both kernels. A (row b, KV head h) has W·Hg query
// rows r = j·Hg + g, query j at absolute position pos + j (K1: W = 1). The
// per-query dequant scales are [B, W, Hkv] (K1 passes its per-row scales
// [B, Hkv] as W = 1).
//
// Launch 1, the split kernel, grid (B·Hkv·row_tiles, splits), 256 threads:
//  * a row tile is at most 32 query rows (16 when D > 128); the host cuts
//    the W·Hg rows into equal tiles, so any window fits;
//  * a column tile is 64 consecutive logical columns c of the row, with
//    c -> (block table entry c / bs, slot c % bs): any block size works;
//  * a split walks a contiguous range of at most 8 column tiles. It first
//    reads its block-table entries and token indices into shared memory
//    (all table loads in flight at once, then all token-index loads),
//    marks a column live when some query of the row tile may attend it
//    (mapped, tidx >= 0, tidx <= pos + j_hi, pos + j_lo - tidx < window),
//    and keeps only the tiles with a live column;
//  * the live tiles' K and V rows are staged with cp.async into a ring of
//    2 or 3 shared-memory stages (tiles t+1 and t+2 load while tile t
//    computes; one barrier per tile both publishes tile t and frees the
//    stage of tile t-1 for the next copy). Copies are 16 bytes wide where
//    the row's bytes and the pool's alignment allow, else 8 or 4, else
//    byte loads; a column that is not live is zero-filled and never read
//    from the pool;
//  * scores q·K: see "Which path each case takes" below. kv8 contracts on
//    the int grid and then scales by k_scale[b, j, h]; kv4 unpacks the
//    nibbles in registers (low nibble = even index) and dequantizes before
//    the contraction;
//  * online softmax per query row in f32; masked columns give p = 0
//    exactly; P·V in f32 on the CUDA cores, the threads split into groups
//    over D, the rows and the tile's columns, so each V element is
//    converted once per row group; the column groups' sums are added in
//    group order at the end of the split;
//  * the split writes (m, l, unnormalised acc[D]) per query row to the
//    caller's scratch, or, when there is one split, the normalised output
//    directly (kv8 times v_scale[b, j, h]; exact zeros for a query with no
//    attendable key).
// Launch 2, the merge kernel (only when splits > 1): one thread per output
// element merges the splits in split order (M = max m_s, weights
// exp(m_s - M)), applies the kv8 output scale after the merge, and writes
// exact zeros where no split saw a valid key. A split with no valid key
// has m = -1e30, l = 0, acc = 0 and contributes nothing. There are no
// atomics: two calls on the same inputs are bitwise equal.
//
// Which path each case takes. bf16 q at kv16 or kv8 with D % 16 == 0: q·K
// on the bf16 tensor cores (mma.sync m16n8k16, f32 accumulate; the query
// rows padded to 16 or 32; kv8's int8 values are exact in bf16, and every
// product of two bf16 values is exact in f32), then scaled by D^-1/2 (and
// k_scale at kv8). f32 q (the port's f32 compute), kv4 (dequantized before
// the contraction) and other D: q·K on the f32 CUDA cores. P·V always runs
// on the f32 CUDA cores: rounding P to bf16 would lose the f32 softmax.
//
// Limits: D even, 2 <= D <= 256. No limit on the block size, Hg or W.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_pa {
// Internal linkage: the two libraries that include this header each keep
// their own copy (a template's static local would otherwise be one object
// per process, shared between the libraries).
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 64;
constexpr int kMaxSplitTiles = 8;
constexpr int kColIters = kMaxSplitTiles * kTileCols / kThreads;
constexpr int kMaxRowTile = 32;       // D <= 128; 16 above
constexpr int kMaxD = 256;
constexpr int kPStride = kTileCols + 4;  // scores row stride (floats)
constexpr int kRowsPerWarp = kMaxRowTile / kWarps;
constexpr int kColThreads = kThreads / kTileCols;  // f32 scores: per column
constexpr int kScoreRows = kMaxRowTile / kColThreads;   // rows per thread
constexpr int kMaxPvRows = 8;         // per thread in P·V (2 elements of D each)
constexpr float kNegInf = -1e30f;
constexpr float kDead = -5e29f;       // below: no valid key seen

struct Params {
  const void* q;
  const unsigned char* k_pool;
  const unsigned char* v_pool;
  const int* token_idx;
  const float* k_scale;     // [B, W, Hkv]
  const float* v_scale;
  const int* block_table;   // [B, n_lblk]
  const int* pos;           // [B]
  float* out;               // [B, W, Hkv, Hg, D]
  float* part_acc;          // [B·Hkv·splits, rows, D]   (splits > 1)
  float* part_ml;           // [B·Hkv·splits, rows, 2]
  int B, W, Hkv, Hg, D, n_blocks, bs, n_lblk, win;
  int rows;                 // W·Hg
  int row_tile, row_tiles, splits, tiles_per_split;
  int rowbytes;             // bytes of one pool row: D·elt (D/2 at kv4)
  int srow;                 // shared-memory stride of a staged row (bytes)
  int nchunk;               // 16-byte chunks the score loop reads per row
  int qlen;                 // floats per staged q row (nchunk · elements)
  int cw;                   // cp.async width: 16, 8, 4, or 0 (byte loads)
  int stages;               // 2 or 3
  int pv_rg, pv_cg;         // P·V: row groups × column groups of threads
  int use_tc;               // q·K on bf16 tensor cores (bf16 q, kv16/kv8,
                            // D % 16 == 0)
  int qh_stride;            // bf16 elements per staged q row (tensor cores)
  float sm_scale;
};

// Elements of one 16-byte chunk of a pool row.
template <int BITS>
__host__ __device__ constexpr int chunk_elems() {
  return BITS == 16 ? 8 : (BITS == 8 ? 16 : 32);
}

// Shared-memory layout (bytes); the host sizes the launch with the same.
struct Layout {
  int stage, q, qh, p, small, cols, total;
};

// P·V's thread groups: 2 elements of D per thread, D/2 threads per group;
// the groups split the rows (rg, each thread at most kMaxPvRows rows) and
// the tile's columns (cg, a power of two, at least 4 columns each), so a
// V element is read and converted by one group of each row group.
__host__ __device__ inline void pv_groups(int D, int row_tile, int* rg,
                                          int* cg) {
  const int n_grp = kThreads / (D / 2);
  *rg = (row_tile + kMaxPvRows - 1) / kMaxPvRows;
  *cg = 1;
  while (*cg * 2 * *rg <= n_grp && *cg < kTileCols / 4) *cg *= 2;
}

__host__ __device__ inline Layout layout(const Params& p, int stages) {
  Layout L;
  L.stage = 0;
  const int ring = stages * 2 * kTileCols * p.srow;
  const int red = p.pv_cg * p.row_tile * p.D * 4;  // the epilogue reuses it
  L.q = L.stage + (ring > red ? ring : red);
  L.qh = L.q + (p.use_tc ? 0 : p.row_tile * p.qlen * 4);
  const int m_tiles = (p.row_tile + 15) / 16;
  L.p = L.qh + (p.use_tc ? (m_tiles * 16 * p.qh_stride * 2 + 15) / 16 * 16 : 0);
  L.small = L.p + p.row_tile * kPStride * 4;
  // kl, vl, alpha, m, l per row; the live-tile list, the half-tile flags
  // and the live count; 16-byte aligned
  L.cols = L.small + 5 * kMaxRowTile * 4 +
           ((3 * kMaxSplitTiles + 1) * 4 + 15) / 16 * 16;
  L.total = L.cols + 2 * p.tiles_per_split * kTileCols * 4;
  return L;
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// cp.async of N bytes; src_bytes = 0 zero-fills without reading.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(N), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D = A·B + C on the tensor cores: A 16×16 bf16 (row), B 16×8 bf16 (col),
// C and D 16×8 f32. The products of bf16 values are exact in f32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Elements d, d + 1 of a staged K row as a bf16 pair (kv8: the int grid,
// exact in bf16).
template <int BITS>
__device__ __forceinline__ uint32_t k_pair_bf16(const unsigned char* row,
                                                int d) {
  if constexpr (BITS == 16) {
    return *reinterpret_cast<const uint32_t*>(row + 2 * d);
  } else {
    const char2 v = *reinterpret_cast<const char2*>(row + d);
    __nv_bfloat162 hv = __floats2bfloat162_rn(static_cast<float>(v.x),
                                              static_cast<float>(v.y));
    return *reinterpret_cast<uint32_t*>(&hv);
  }
}

// Elements 8s .. 8s + 7 of a 16-byte chunk of a K row as f32 (kv4:
// dequantized by ks).
template <int BITS>
__device__ __forceinline__ void decode8(const uint4& raw, int s, float* f,
                                        float ks) {
  if constexpr (BITS == 16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else if constexpr (BITS == 8) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw) + 8 * s;
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(c[i]);
  } else {
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw) + 4 * s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = c[i];
      f[2 * i] = static_cast<float>(((b & 0xF) ^ 8) - 8) * ks;
      f[2 * i + 1] = static_cast<float>(b >> 4) * ks;
    }
  }
}

// Elements 2·xp and 2·xp + 1 of a V row as f32 (kv4: dequantized by vs).
template <int BITS>
__device__ __forceinline__ float2 v_pair(const unsigned char* row, int xp,
                                         float vs) {
  if constexpr (BITS == 16) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + 4 * xp));
  } else if constexpr (BITS == 8) {
    const char2 c = *reinterpret_cast<const char2*>(row + 2 * xp);
    return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
  } else {
    const int b = static_cast<int8_t>(row[xp]);
    return make_float2(static_cast<float>(((b & 0xF) ^ 8) - 8) * vs,
                       static_cast<float>(b >> 4) * vs);
  }
}

template <int BITS, typename QT>
__global__ void __launch_bounds__(kThreads, 3)
split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x / p.row_tiles;
  const int rt = blockIdx.x - bh * p.row_tiles;
  const int b = bh / p.Hkv;
  const int h = bh - b * p.Hkv;
  const int split = blockIdx.y;
  const int r0 = rt * p.row_tile;
  const int nr = min(p.row_tile, p.rows - r0);
  const int j_lo = r0 / p.Hg;
  const int j_hi = (r0 + nr - 1) / p.Hg;
  const int pos_b = p.pos[b];
  const int n_cols = p.n_lblk * p.bs;
  const int tile0 = split * p.tiles_per_split;
  const int ntl = max(0, min(p.tiles_per_split,
                             (n_cols + kTileCols - 1) / kTileCols - tile0));
  const int c0 = tile0 * kTileCols;
  const int stages = p.stages;

  const Layout L = layout(p, stages);
  unsigned char* s_stage = smem + L.stage;
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  float* s_p = reinterpret_cast<float*>(smem + L.p);
  float* s_kl = reinterpret_cast<float*>(smem + L.small);
  float* s_vl = s_kl + kMaxRowTile;
  float* s_alpha = s_vl + kMaxRowTile;
  float* s_m = s_alpha + kMaxRowTile;
  float* s_l = s_m + kMaxRowTile;
  int* s_list = reinterpret_cast<int*>(s_l + kMaxRowTile);
  int* s_half = s_list + kMaxSplitTiles;
  int* s_nlive = s_half + kMaxSplitTiles * 2;
  int* s_prow = reinterpret_cast<int*>(smem + L.cols);
  int* s_t = s_prow + p.tiles_per_split * kTileCols;

  // -- the split's columns: pool row and token index, -1 where no query of
  //    this row tile can attend (unmapped, empty, too new, out of window).
  //    All table loads are issued, then all token-index loads: two round
  //    trips to memory, not two per column.
  int prow_r[kColIters], t_r[kColIters];
#pragma unroll
  for (int it = 0; it < kColIters; ++it) {
    const int i = tid + it * kThreads;
    const int c = c0 + i;
    prow_r[it] = -1;
    if (i < ntl * kTileCols && c < n_cols) {
      const int lb = c / p.bs;
      const int e = p.block_table[(size_t)b * p.n_lblk + lb];
      if (e >= 0 && e < p.n_blocks) prow_r[it] = e * p.bs + (c - lb * p.bs);
    }
  }
#pragma unroll
  for (int it = 0; it < kColIters; ++it)
    t_r[it] = prow_r[it] >= 0 ? p.token_idx[prow_r[it]] : -1;
#pragma unroll
  for (int it = 0; it < kColIters; ++it) {
    const int i = tid + it * kThreads;
    const int t = t_r[it];
    const bool live = t >= 0 && t <= pos_b + j_hi && pos_b + j_lo - t < p.win;
    if (i < ntl * kTileCols) {   // the row of (slot, head h) in the pool
      s_prow[i] = live ? prow_r[it] * p.Hkv + h : -1;
      s_t[i] = live ? t : -1;
    }
    // a warp's 32 columns are one half of a tile
    const bool any = __any_sync(0xffffffffu, live);
    if (lane == 0) s_half[warp + kWarps * it] = any;
  }
  // q rows of the tile: for the tensor cores as they are (bf16, zero rows
  // up to a multiple of 16), else pre-scaled f32 zero past D
  const QT* qg = static_cast<const QT*>(p.q);
  constexpr bool kTC = BITS != 4 && std::is_same<QT, __nv_bfloat16>::value;
  __nv_bfloat16* s_qh = reinterpret_cast<__nv_bfloat16*>(smem + L.qh);
  const int m_tiles = (nr + 15) / 16;
  if (kTC && p.use_tc) {
    for (int i = tid; i < m_tiles * 16 * p.D; i += kThreads) {
      const int r = i / p.D;
      const int x = i - r * p.D;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (r < nr) {
        const int R = r0 + r;
        const int j = R / p.Hg;
        const int g = R - j * p.Hg;
        v = reinterpret_cast<const __nv_bfloat16*>(qg)[
            ((((size_t)b * p.W + j) * p.Hkv + h) * p.Hg + g) * p.D + x];
      }
      s_qh[r * p.qh_stride + x] = v;
    }
  }
  for (int i = tid; i < (p.use_tc ? 0 : nr * p.qlen); i += kThreads) {
    const int r = i / p.qlen;
    const int x = i - r * p.qlen;
    float v = 0.f;
    if (x < p.D) {
      const int R = r0 + r;
      const int j = R / p.Hg;
      const int g = R - j * p.Hg;
      v = to_f32(qg[((((size_t)b * p.W + j) * p.Hkv + h) * p.Hg + g) * p.D +
                    x]) * p.sm_scale;
    }
    s_q[i] = v;
  }
  if (tid < nr) {
    const int j = (r0 + tid) / p.Hg;
    s_kl[tid] = p.k_scale[((size_t)b * p.W + j) * p.Hkv + h];
    s_vl[tid] = p.v_scale[((size_t)b * p.W + j) * p.Hkv + h];
  }
  // the score loop reads whole 16-byte chunks: keep the tail past the row's
  // bytes zero in every stage (copies never write it)
  if (p.nchunk * 16 > p.rowbytes) {
    uint4* z = reinterpret_cast<uint4*>(s_stage);
    const int n = stages * 2 * kTileCols * p.srow / 16;
    for (int i = tid; i < n; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // -- the live tiles, in order
  if (warp == 0) {
    const bool any = lane < ntl && (s_half[2 * lane] | s_half[2 * lane + 1]);
    const unsigned mask = __ballot_sync(0xffffffffu, any);
    if (any) s_list[__popc(mask & ((1u << lane) - 1u))] = lane;
    if (lane == 0) *s_nlive = __popc(mask);
  }
  __syncthreads();
  const int n_live = *s_nlive;

  const float ks0 = s_kl[0];   // kv4 (W = 1): the row's scales
  const float vs0 = s_vl[0];

  // softmax state: warp w owns rows w, w + 4, ...
  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  // P·V: thread (xp, cg, rg) owns elements 2xp, 2xp+1 of rows rg,
  // rg + n_rg, ... over the tile's columns [cg·cpg, (cg + 1)·cpg)
  const int npair = p.D / 2;
  const int n_rg = p.pv_rg;
  const int n_cg = p.pv_cg;
  const int cpg = kTileCols / n_cg;
  const int xp = tid % npair;
  const int grp = tid / npair;
  const int cg = grp % n_cg;
  const int rg = grp / n_cg;
  const bool pv_active = grp < n_cg * n_rg;
  float acc[2 * kMaxPvRows];
#pragma unroll
  for (int i = 0; i < 2 * kMaxPvRows; ++i) acc[i] = 0.f;

  const int tile_bytes = kTileCols * p.srow;
  // the copy loop's (column, chunk) of its first element and its strides,
  // the same for every tile
  const int nch = p.cw ? p.rowbytes / p.cw : 1;
  const int cc0 = tid / nch, ck0 = tid - (tid / nch) * nch;
  const int dcc = kThreads / nch, dck = kThreads - (kThreads / nch) * nch;
  auto load_tile = [&](int k, int stage) {
    const int tl = s_list[k];
    unsigned char* sk = s_stage + stage * 2 * tile_bytes;
    unsigned char* sv = sk + tile_bytes;
    const int* prow_t = s_prow + tl * kTileCols;
    const int cw = p.cw;
    if (cw == 0) {              // rows not a multiple of 4 bytes
      for (int i = tid; i < kTileCols * p.rowbytes; i += kThreads) {
        const int c = i / p.rowbytes;
        const int x = i - c * p.rowbytes;
        const int prow = prow_t[c];
        unsigned char kb = 0, vb = 0;
        if (prow >= 0) {
          const size_t off = (size_t)prow * p.rowbytes + x;
          kb = p.k_pool[off];
          vb = p.v_pool[off];
        }
        sk[c * p.srow + x] = kb;
        sv[c * p.srow + x] = vb;
      }
      return;
    }
    int c = cc0, k2 = ck0;
    for (int i = tid; i < kTileCols * nch; i += kThreads) {
      const int prow = prow_t[c];
      const bool ok = prow >= 0;
      const size_t off = ok ? (size_t)prow * p.rowbytes + k2 * cw : 0;
      unsigned char* dk = sk + c * p.srow + k2 * cw;
      unsigned char* dv = sv + c * p.srow + k2 * cw;
      if (cw == 16) {
        cp_async<16>(dk, p.k_pool + off, ok ? 16 : 0);
        cp_async<16>(dv, p.v_pool + off, ok ? 16 : 0);
      } else if (cw == 8) {
        cp_async<8>(dk, p.k_pool + off, ok ? 8 : 0);
        cp_async<8>(dv, p.v_pool + off, ok ? 8 : 0);
      } else {
        cp_async<4>(dk, p.k_pool + off, ok ? 4 : 0);
        cp_async<4>(dv, p.v_pool + off, ok ? 4 : 0);
      }
      c += dcc;
      k2 += dck;
      if (k2 >= nch) {
        k2 -= nch;
        ++c;
      }
    }
  };

  constexpr int E = chunk_elems<BITS>();
  for (int k = 0; k < stages - 1; ++k) {
    if (k < n_live) load_tile(k, k);
    cp_async_commit();
  }
  for (int k = 0; k < n_live; ++k) {
    // tile k has landed (tiles k+1 .. k+stages-2 may still be in flight),
    // and every thread is done with tile k-1, whose stage is refilled next
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int nk = k + stages - 1;
    if (nk < n_live) load_tile(nk, nk % stages);
    cp_async_commit();

    const int stage = k % stages;
    const unsigned char* sk = s_stage + stage * 2 * tile_bytes;
    const unsigned char* sv = sk + tile_bytes;
    const int cb = s_list[k] * kTileCols;

    if (kTC && p.use_tc) {
      // scores on the tensor cores: warp w owns the 8-column n-tiles
      // w·kNT ... w·kNT + kNT − 1, every 16-row m-tile and every 16-wide
      // k-step of D
      const int g8 = lane >> 2;
      const int t4 = lane & 3;
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(s_qh);
      const int qs = p.qh_stride / 2;         // words per staged q row
      constexpr int kNT = kTileCols / 8 / kWarps;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int nb = (kNT * warp + n) * 8;
        float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const unsigned char* krow = sk + (nb + g8) * p.srow;
        for (int k0 = 0; k0 < p.D; k0 += 16) {
          const uint32_t b0 = k_pair_bf16<BITS>(krow, k0 + 2 * t4);
          const uint32_t b1 = k_pair_bf16<BITS>(krow, k0 + 2 * t4 + 8);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (m >= m_tiles) break;
            const uint32_t* qa = qw + (m * 16 + g8) * qs + k0 / 2 + t4;
            const uint32_t a[4] = {qa[0], qa[8 * qs], qa[4], qa[8 * qs + 4]};
            mma_bf16(c[m], a, b0, b1);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m >= m_tiles) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = m * 16 + g8 + (e >= 2 ? 8 : 0);
            const int col = nb + 2 * t4 + (e & 1);
            if (r < nr) {
              const int t = s_t[cb + col];
              const int qp = pos_b + (r0 + r) / p.Hg;
              const bool keep = t >= 0 && t <= qp && qp - t < p.win;
              float sv = c[m][e] * p.sm_scale;
              if (BITS == 8) sv *= s_kl[r];
              s_p[r * kPStride + col] = keep ? sv : kNegInf;
            }
          }
        }
      }
    } else {
    // scores: thread (column c, half rh) computes rows rh, rh + 2, ...
      const int c = tid & (kTileCols - 1);
      const int rh = tid / kTileCols;
      const int t = s_t[cb + c];
      float sc[kScoreRows];
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) sc[i] = 0.f;
      const unsigned char* krow = sk + c * p.srow;
      for (int ch = 0; ch < p.nchunk; ++ch) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + ch * 16);
#pragma unroll
        for (int sub = 0; sub < E / 8; ++sub) {
          float kf[8];
          decode8<BITS>(raw, sub, kf, ks0);
#pragma unroll
          for (int i = 0; i < kScoreRows; ++i) {
            const int r = rh + kColThreads * i;
            if (r >= nr) break;
            const float* qr = s_q + r * p.qlen + ch * E + 8 * sub;
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
        if (r >= nr) break;
        const int qp = pos_b + (r0 + r) / p.Hg;
        const bool keep = t >= 0 && t <= qp && qp - t < p.win;
        s_p[r * kPStride + c] =
            keep ? (BITS == 8 ? sc[i] * s_kl[r] : sc[i]) : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= nr) break;
      float* row = s_p + r * kPStride;
      const float v0 = row[lane];
      const float v1 = row[lane + 32];
      const float mx = warp_max(fmaxf(v0, v1));
      const float m_new = fmaxf(m_r[i], mx);
      const float p0 = v0 > kDead ? expf(v0 - m_new) : 0.f;
      const float p1 = v1 > kDead ? expf(v1 - m_new) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
      if (lane == 0) s_alpha[r] = alpha;
    }
    __syncthreads();

    // acc = acc·alpha + P·V
    if (pv_active) {
#pragma unroll
      for (int i = 0; i < kMaxPvRows; ++i) {
        const int r = rg + n_rg * i;
        if (r >= nr) break;
        const float a = s_alpha[r];
        acc[2 * i] *= a;
        acc[2 * i + 1] *= a;
      }
      for (int c = cg * cpg; c < (cg + 1) * cpg; c += 4) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = v_pair<BITS>(sv + (c + u) * p.srow, xp, vs0);
#pragma unroll
        for (int i = 0; i < kMaxPvRows; ++i) {
          const int r = rg + n_rg * i;
          if (r >= nr) break;
          const float4 pp =
              *reinterpret_cast<const float4*>(s_p + r * kPStride + c);
          float a0 = acc[2 * i], a1 = acc[2 * i + 1];
          a0 = fmaf(pp.x, v[0].x, a0);
          a1 = fmaf(pp.x, v[0].y, a1);
          a0 = fmaf(pp.y, v[1].x, a0);
          a1 = fmaf(pp.y, v[1].y, a1);
          a0 = fmaf(pp.z, v[2].x, a0);
          a1 = fmaf(pp.z, v[2].y, a1);
          a0 = fmaf(pp.w, v[3].x, a0);
          a1 = fmaf(pp.w, v[3].y, a1);
          acc[2 * i] = a0;
          acc[2 * i + 1] = a1;
        }
      }
    }
  }

  // -- epilogue: the column groups' partial sums meet in shared memory
  //    (over the free stage ring) and are added in group order
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= nr) break;
    if (lane == 0) {
      s_m[r] = m_r[i];
      s_l[r] = l_r[i];
    }
  }
  float* s_red = reinterpret_cast<float*>(s_stage);
  __syncthreads();                 // the last tile's readers are done
  if (pv_active) {
#pragma unroll
    for (int i = 0; i < kMaxPvRows; ++i) {
      const int r = rg + n_rg * i;
      if (r >= nr) break;
      float* dst = s_red + (cg * p.row_tile + r) * p.D + 2 * xp;
      dst[0] = acc[2 * i];
      dst[1] = acc[2 * i + 1];
    }
  }
  __syncthreads();
  const size_t part = (size_t)bh * p.splits + split;
  for (int e = tid; e < nr * p.D; e += kThreads) {
    const int r = e / p.D;
    const int x = e - r * p.D;
    float a = 0.f;
    for (int g = 0; g < n_cg; ++g) a += s_red[(g * p.row_tile + r) * p.D + x];
    const int R = r0 + r;
    const float m = s_m[r];
    if (p.splits == 1) {
      const int j = R / p.Hg;
      const int g = R - j * p.Hg;
      float o = a / fmaxf(s_l[r], 1e-30f);
      if (BITS == 8) o *= s_vl[r];
      p.out[((((size_t)b * p.W + j) * p.Hkv + h) * p.Hg + g) * p.D + x] =
          m > kDead ? o : 0.f;
    } else {
      p.part_acc[(part * p.rows + R) * p.D + x] = a;
      if (x == 0) {
        p.part_ml[(part * p.rows + R) * 2] = m;
        p.part_ml[(part * p.rows + R) * 2 + 1] = s_l[r];
      }
    }
  }
}

// Launch 2: merge the splits' partials in split order.
template <int BITS>
__global__ void __launch_bounds__(256) merge_kernel(const Params p) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)p.B * p.Hkv * p.rows * p.D;
  if (idx >= n) return;
  const int x = static_cast<int>(idx % p.D);
  const int R = static_cast<int>((idx / p.D) % p.rows);
  const size_t bh = idx / ((size_t)p.D * p.rows);
  const float* ml = p.part_ml + (bh * p.splits * p.rows + R) * 2;
  const float* pa = p.part_acc + (bh * p.splits * p.rows + R) * p.D + x;
  const size_t ml_step = (size_t)p.rows * 2;
  const size_t pa_step = (size_t)p.rows * p.D;
  float M = kNegInf;
  for (int s = 0; s < p.splits; ++s) M = fmaxf(M, ml[s * ml_step]);
  float Lsum = 0.f, O = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float w = expf(ml[s * ml_step] - M);
    Lsum = fmaf(ml[s * ml_step + 1], w, Lsum);
    O = fmaf(pa[s * pa_step], w, O);
  }
  const int b = static_cast<int>(bh / p.Hkv);
  const int h = static_cast<int>(bh - (size_t)b * p.Hkv);
  const int j = R / p.Hg;
  const int g = R - j * p.Hg;
  float o = O / fmaxf(Lsum, 1e-30f);
  if (BITS == 8) o *= p.v_scale[((size_t)b * p.W + j) * p.Hkv + h];
  p.out[((((size_t)b * p.W + j) * p.Hkv + h) * p.Hg + g) * p.D + x] =
      M > kDead ? o : 0.f;
}

template <int BITS, typename QT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = layout(p, p.stages).total;
  // set once per instantiation (not a stream operation, so a call inside a
  // CUDA-graph capture after the first does not touch it)
  static size_t s_allowed = 48 * 1024;
  if (smem > s_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<BITS, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    s_allowed = smem;
  }
  const dim3 grid(p.B * p.Hkv * p.row_tiles, p.splits);
  split_kernel<BITS, QT><<<grid, kThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const size_t n = (size_t)p.B * p.Hkv * p.rows * p.D;
  merge_kernel<BITS><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

inline int largest_copy_width(int rowbytes, uintptr_t a, uintptr_t b) {
  for (int w = 16; w >= 4; w >>= 1)
    if (rowbytes % w == 0 && a % w == 0 && b % w == 0) return w;
  return 0;
}

// The C entry of both libraries. Returns cudaGetLastError() after the
// launches (0 = launched), cudaErrorInvalidValue for arguments the kernel
// does not take. Nothing here synchronises or allocates: the caller passes
// the output and, when splits > 1, the scratch for the partials.
template <bool KV4>
int entry(const void* q, const void* k_pool, const void* v_pool,
          const int* token_idx, const float* k_scale, const float* v_scale,
          const int* block_table, const int* pos, float* out, float* part_acc,
          float* part_ml, int q_bf16, int B, int W, int Hkv, int Hg, int D,
          int n_blocks, int bs, int n_lblk, int bits, int win, int row_tile,
          int row_tiles, int splits, int tiles_per_split, float sm_scale,
          void* stream_ptr) {
  const int rows = W * Hg;
  const int n_tiles = (n_lblk * bs + kTileCols - 1) / kTileCols;
  const int max_rt = D <= 128 ? kMaxRowTile : kMaxRowTile / 2;
  if (D % 2 || D < 2 || D > kMaxD || Hg < 1 || W < 1 || bs < 1 ||
      n_lblk < 0 || win < 1 || row_tile < 1 || row_tile > max_rt ||
      row_tiles * row_tile < rows || (row_tiles - 1) * row_tile >= rows ||
      tiles_per_split < 1 || tiles_per_split > kMaxSplitTiles ||
      splits < 1 || (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= (n_tiles > 0 ? n_tiles : 1) ||
      (splits > 1 && (!part_acc || !part_ml)))
    return (int)cudaErrorInvalidValue;
  if (!(bits == 16 || bits == 8 || (KV4 && bits == 4)) || (bits == 4 && W != 1))
    return (int)cudaErrorInvalidValue;
  if (B * Hkv == 0) return 0;
  Params p;
  p.q = q;
  p.k_pool = static_cast<const unsigned char*>(k_pool);
  p.v_pool = static_cast<const unsigned char*>(v_pool);
  p.token_idx = token_idx;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.block_table = block_table;
  p.pos = pos;
  p.out = out;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.B = B;
  p.W = W;
  p.Hkv = Hkv;
  p.Hg = Hg;
  p.D = D;
  p.n_blocks = n_blocks;
  p.bs = bs;
  p.n_lblk = n_lblk;
  p.win = win;
  p.rows = rows;
  p.row_tile = row_tile;
  p.row_tiles = row_tiles;
  p.splits = splits;
  p.tiles_per_split = tiles_per_split;
  p.rowbytes = bits == 16 ? 2 * D : (bits == 8 ? D : D / 2);
  p.nchunk = (p.rowbytes + 15) / 16;
  p.srow = p.nchunk * 16;
  if ((p.srow / 16) % 2 == 0) p.srow += 16;  // odd 16-byte stride: no bank
                                             // conflicts on 16-byte reads
  const int elems = bits == 16 ? 8 : (bits == 8 ? 16 : 32);
  p.qlen = p.nchunk * elems;
  p.cw = largest_copy_width(p.rowbytes, reinterpret_cast<uintptr_t>(k_pool),
                            reinterpret_cast<uintptr_t>(v_pool));
  p.sm_scale = sm_scale;
  pv_groups(D, row_tile, &p.pv_rg, &p.pv_cg);
  if (p.pv_rg * p.pv_cg > kThreads / (D / 2)) return (int)cudaErrorInvalidValue;
  p.use_tc = q_bf16 && bits != 4 && D % 16 == 0;
  p.qh_stride = D + 8;        // odd 16-byte stride: conflict-free fragments
  p.stages = layout(p, 3).total <= 116 * 1024 ? 3 : 2;
  if (layout(p, p.stages).total > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e;
  if (bits == 16)
    e = q_bf16 ? launch<16, __nv_bfloat16>(p, stream) : launch<16, float>(p, stream);
  else if (bits == 8)
    e = q_bf16 ? launch<8, __nv_bfloat16>(p, stream) : launch<8, float>(p, stream);
  else if constexpr (KV4)
    e = q_bf16 ? launch<4, __nv_bfloat16>(p, stream) : launch<4, float>(p, stream);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace
}  // namespace repro_pa
