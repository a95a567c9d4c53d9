// Neighborhood attention for Hopper (sm_90a): K10 forward, K11 dQ, K12 dK/dV,
// bf16 in, fp32 accumulate, bf16 out.
//
// Replaces cosmos_predict2_tpu/ops/neighborhood_attention.py::_na_fwd_kernel
// (driven by _na_forward), ::_na_dq_kernel and ::_na_dkv_kernel (driven by
// _na_bwd_rule). Same contract: the tiled, head-major layout
// (B, heads, S_pad, 128) made by permute_in (tokens in (tile_h, tile_w, t,
// ih, iw) order, 4 x 16 spatial tiles, so a 64-row tile is one t-slice of one
// spatial tile and the row r of a tile sits at h = h0 + (r >> 4),
// w = w0 + (r & 15)); the host-built block tables (table / counts for the
// forward and dQ, its exact transpose tableT / countsT for dK/dV, since
// clamped NA is not symmetric); block coordinates `coords` (n_blocks, 3) =
// (t0, h0, w0); the effective window and stride (dilation is a class-major
// reorder done by permute_in, so it never reaches a kernel). A key is visible
// to a query iff, on every axis, it lies in the query's clamped window
// (window < 0 or >= the axis length: the whole axis; the GNA stride gives
// every query its group representative's window). Pad slots (t, h or w past
// the video) are neither keys nor queries. Masked pairs take the finite
// logit -1e30 and an explicit P = 0; row sums are clamped at 1e-20 so fully
// masked (pad) rows stay finite, with out = 0 there. P is rounded to bf16
// before P V and P^T dO, dS before dS K and dS^T Q, where the TPU kernels
// round them. lse and delta are (B, heads, S_pad) fp32; delta = rowsum(dO O)
// is computed outside the kernels.
//
// What bounds them on the H100: per visible (q, k) pair K10 does 2 products
// of 2*128 FLOPs, K11 3 and K12 4, against 2*128*2 bytes per q or kv row read
// once. At the main path's windows (hundreds to thousands of visible keys per
// query) that is far above the card's ~295 FLOP/byte line: the bound is the
// tensor-core rate on the visible pairs. The block tables are coarser than
// the windows (the 4 x 16 tiles and the 512-row blocks of the plan), so the
// kernels compute more pairs than are visible.
//
// Design of K10 and K12 (warp-specialised, on the bodies of K1 and K8 in
// flash_attention_fwd.cu and flash_attention_bwd.cu; helpers in
// sm90_bf16.cuh). What the first versions (4 warps of mma.sync on 64 x 64
// tiles, synchronous 16-byte staging with two __syncthreads per tile, K12 on
// 32-row q sub-tiles) lacked, and what these do about it:
// 1. Overlap and tensor cores. 384 threads: a producer warpgroup
//    (setmaxnreg down to 24; one thread issues TMA) and two consumer
//    warpgroups (up to 240) running wgmma; the streamed tiles go through a
//    two-stage ring of "full" (TMA bytes) and "empty" (one arrival per
//    consumer warp) mbarriers; no __syncthreads in the loop.
// 2. 128-row tiles that never cross a block. A CTA owns 128 rows, two
//    t-slices of one block (build_plan makes bt even), one per consumer
//    warpgroup: every row of a warpgroup has the same t, and each thread's
//    rows share h (h0 + warp) and sit at w0 + g and w0 + g + 8.
// 3. The walk comes from the plan, built on the host
//    (ops/neighborhood_attention.py: fwd_walk, dkv_walk; tested on the CPU
//    against the dense mask). K10: for each 128-row q tile, the 128-row kv
//    tiles of its table row's blocks that some row of the tile sees on the
//    t axis, each with 4 bits (warpgroup, kv half): which 64-row half each
//    warpgroup sees. K12: for each 128-row kv tile, the 64-row q t-slices of
//    its transposed table row whose t-window holds one of its t-slices, with
//    a bit per warpgroup. Producer and consumers read the same list, so
//    they walk the same tiles; a warpgroup waits for and releases a tile it
//    does not see without computing. Pad frames are never listed.
// 4. The mask on the accumulator. Entry i of a thread's accumulator (row
//    16 warp + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1))
//    is bit i of one word: the low 3 bits of i pick the thread's w test
//    (its row and column parity; 8 range tests) and the rest the column's
//    h row (and K10's kv half): 4 range tests. It is built while the first
//    product is in flight; in K10 a warp whose entries are all visible
//    skips the selects.
// - K10: K1's body. S = Q K^T (m64n128k16, both K-major), online softmax in
//   fp32, P rounded to bf16 as the register A operand of O += P V (V
//   MN-major). The producer puts each stage's bits and its kv block's
//   (h0, w0) beside the tiles. O / l is staged in the q tile's rows and
//   written with 16-byte stores.
// - K12: K8's body. K and V are loaded once; 64-row q tiles stream with
//   dO, lse, delta and the tile's 4 h and 16 w key ranges (the producer
//   warp computes them). S^T = K Q^T and dP^T = V dO^T (m64n64k16), then
//   dV += P^T dO and dK += dS^T Q from registers (m64n128k16, dO and Q
//   MN-major). No splits (the grid is several waves at the main shapes)
//   and no atomics: deterministic.
// K11 is still the first version: K7's structure over the table on 4 warps
// of mma.sync, one block of 4 warps per 64-row q tile, the t test per
// (q tile, kv tile), the h/w mask from the fragment layout, Q and dO staged
// once, S = Q K^T and dP = dO V^T per kv tile, dS in registers as the A
// operand of dQ += dS K.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90_bf16.cuh"

namespace {

using cosmos_kernels::ld_pair;
using cosmos_kernels::mma_16816;
using cosmos_kernels::pack_float_pair;
using cosmos_kernels::pack_pair;
using namespace cosmos_sm90;

constexpr int kD = 128;
constexpr int kTile = 64;  // rows of one t-slice of a 4 x 16 spatial tile
constexpr float kNegInf = -1e30f;
constexpr float kMinSum = 1e-20f;

// K11 (mma.sync)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;  // padded shared-memory row, in bf16 elements
constexpr int kDqSmemBytes = 4 * kTile * kLds * 2;

// K10 and K12 (warp-specialised)
constexpr int kRows = 2 * kTile;  // a CTA's q (K10) or kv (K12) tile: two t-slices of one block
constexpr int kStages = 2;
constexpr int kConsumerThreads = 256;
constexpr int kWsThreads = kConsumerThreads + 128;  // plus the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Geom {
  int T, H, W;           // true video size
  int win_t, win_h, win_w;  // effective window (< 0 or >= the axis length: whole axis)
  int str_t, str_h, str_w;  // effective stride
};

struct Tables {
  const int* table;   // (n_blocks, max_cnt) block ids
  const int* counts;  // (n_blocks,)
  const int* coords;  // (n_blocks, 3): t0, h0, w0
  int bt;             // t-slices (64-row tiles) per block
  int max_cnt;
};

// [lo, hi] of the keys along one axis in the clamped window of coordinate c
__device__ __forceinline__ int2 axis_range(int c, int L, int w, int st) {
  if (w < 0 || w >= L) return make_int2(0, L - 1);
  const int r_lo = (w - 1) / 2;
  const int r_hi = w - 1 - r_lo;
  if (st > 1) c = (c / st) * st + (st - 1) / 2;  // once per row, not per element: a division is fine
  c = min(max(c, r_lo), L - 1 - r_hi);
  return make_int2(c - r_lo, c + r_hi);
}

__device__ __forceinline__ bool in_range(int x, int2 r) { return x >= r.x && x <= r.y; }

// `rows` contiguous rows of 128 bf16 into a padded shared tile
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows, int tid) {
  for (int i = tid; i < rows * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * kLds + c) = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * kD + c);
  }
}

// the A fragment (16 x 16, k-step kk over D) of the 16 rows starting at `row`
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row, int kk, int g, int t) {
  const __nv_bfloat16* p = tile + (row + g) * kLds + kk * 16 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * kLds);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * kLds + 8);
}

// The key ranges of this thread's two query rows (r = warp * 16 + g and
// r + 8 of a 64-row q tile at (t_q, h0, w0)): both rows share h = h0 + warp;
// w = w0 + g and w0 + g + 8. Pad queries get empty ranges.
__device__ __forceinline__ void query_ranges(const Geom& geo, int t_q, int h0, int w0, int warp, int g, int2& hr,
                                             int2 (&wr)[2]) {
  const int2 empty = make_int2(1, 0);
  const int hq = h0 + warp;
  const bool ok = t_q < geo.T && hq < geo.H;
  hr = ok ? axis_range(hq, geo.H, geo.win_h, geo.str_h) : empty;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int wq = w0 + g + 8 * r;
    wr[r] = (ok && wq < geo.W) ? axis_range(wq, geo.W, geo.win_w, geo.str_w) : empty;
  }
}

// visibility bits of a 16 x 64 S fragment (bit 4 * j + e for s[j][e]):
// column c = 8 j + 2 t + (e & 1) of the kv tile at (h0k, w0k) sits at
// h = h0k + (j >> 1), w = w0k + 8 (j & 1) + 2 t + (e & 1)
__device__ __forceinline__ uint32_t fragment_mask(int2 hr, const int2 (&wr)[2], int h0k, int w0k, int t) {
  uint32_t vis = 0;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const bool h_ok = in_range(h0k + (j >> 1), hr);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int wk = w0k + 8 * (j & 1) + 2 * t + (e & 1);
      if (h_ok && in_range(wk, wr[e >> 1])) vis |= 1u << (4 * j + e);
    }
  }
  return vis;
}

// ------------------------------------ K11 ------------------------------------

__global__ void __launch_bounds__(kThreads)
na_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                 Tables tab, Geom geo, int heads, int S_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + kTile * kLds;
  __nv_bfloat16* sK = sdO + kTile * kLds;
  __nv_bfloat16* sV = sK + kTile * kLds;

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t bh_row = (static_cast<size_t>(b) * heads + h) * S_pad;
  const size_t q_row = bh_row + static_cast<size_t>(tile) * kTile;
  const int qblk = tile / tab.bt;
  const int t_q = tab.coords[3 * qblk] + tile % tab.bt;
  int2 hr, wr[2];
  query_ranges(geo, t_q, tab.coords[3 * qblk + 1], tab.coords[3 * qblk + 2], warp, g, hr, wr);
  const int2 tr = axis_range(t_q, geo.T, geo.win_t, geo.str_t);
  const int n = t_q < geo.T ? tab.counts[qblk] : 0;

  stage_rows(sQ, q + q_row * kD, kTile, tid);
  stage_rows(sdO, dout + q_row * kD, kTile, tid);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = q_row + warp * 16 + g + 8 * r;
    lse_r[r] = lse[row];
    delta_r[r] = delta[row];
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int nn = 0; nn < kD / 8; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;

  for (int jb = 0; jb < n; ++jb) {
    const int kblk = tab.table[qblk * tab.max_cnt + jb];
    const int t0k = tab.coords[3 * kblk], h0k = tab.coords[3 * kblk + 1], w0k = tab.coords[3 * kblk + 2];
    for (int u = 0; u < tab.bt; ++u) {
      if (!in_range(t0k + u, tr) || t0k + u >= geo.T) continue;  // uniform over the block
      const size_t kv_row = bh_row + static_cast<size_t>(kblk * tab.bt + u) * kTile;
      __syncthreads();  // every warp is done with the previous K/V tile (and Q/dO are staged)
      stage_rows(sK, k + kv_row * kD, kTile, tid);
      stage_rows(sV, v + kv_row * kD, kTile, tid);
      __syncthreads();

      // ---- S = Q K^T and dP = dO V^T: 16 x 64 per warp ----
      float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t qa[4], da[4];
        load_a(qa, sQ, warp * 16, kk, g, t);
        load_a(da, sdO, warp * 16, kk, g, t);
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          const int off = (j * 8 + g) * kLds + kk * 16 + 2 * t;
          mma_16816(s[j], qa, ld_pair(sK + off), ld_pair(sK + off + 8));
          mma_16816(dp[j], da, ld_pair(sV + off), ld_pair(sV + off + 8));
        }
      }

      // ---- P = exp(scale S - lse) in the window, 0 off it; dS = P (dP - delta), kept in s ----
      const uint32_t vis = fragment_mask(hr, wr, h0k, w0k, t);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = (vis >> (4 * j + e)) & 1u ? __expf(s[j][e] * scale - lse_r[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - delta_r[r]);
        }
      }

      // ---- dQ += dS K: dS (bf16) from registers as the A operand ----
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_float_pair(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_float_pair(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_float_pair(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_float_pair(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const __nv_bfloat16* kp = sK + (kk * 16 + 2 * t) * kLds + g;
#pragma unroll
        for (int nn = 0; nn < kD / 8; ++nn) {
          const __nv_bfloat16* p = kp + nn * 8;
          mma_16816(acc[nn], a, pack_pair(p[0], p[kLds]), pack_pair(p[8 * kLds], p[9 * kLds]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* drow = dq + (q_row + warp * 16 + g + 8 * r) * kD;
#pragma unroll
    for (int nn = 0; nn < kD / 8; ++nn) {
      *reinterpret_cast<uint32_t*>(drow + nn * 8 + 2 * t) =
          pack_float_pair(acc[nn][2 * r] * scale, acc[nn][2 * r + 1] * scale);
    }
  }
}

// --------------------------- K10 and K12: shared ----------------------------

// a host-built walk (ops/neighborhood_attention.py: fwd_walk for K10,
// dkv_walk for K12): row x lists the tiles that CTA x loads, in order
struct Walk {
  const int* entries;  // (S_pad / 128, max_len)
  const int* counts;   // (S_pad / 128,)
  const int* coords;   // (n_blocks, 3): t0, h0, w0
  int bt;              // t-slices per block
  int max_len;
};

// This thread's w tests of a tile: bit 4 jj + 2 r + e is whether the w
// coordinate w_col0 + 8 jj + 2 t + e of a tile column lies in range r
// (K10: the key ranges of the thread's two query rows), or whether the
// thread's kv row r (at w_row[r]) lies in the key range of the tile's q
// column 8 jj + 2 t + e (K12). Bit i & 7 of the accumulator's entry i.
__device__ __forceinline__ uint32_t w_bits_fwd(int w0k, int t, const int2 (&wr)[2]) {
  uint32_t bits = 0;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (in_range(w0k + 8 * jj + 2 * t + e, wr[r])) bits |= 1u << (4 * jj + 2 * r + e);
  return bits;
}

// the visibility word of `groups` column groups of 8 entries: entry i is
// visible iff group i >> 3 is (bit of `group_bits`) and w bit i & 7 is set
template <int kGroups>
__device__ __forceinline__ uint64_t spread_bits(uint32_t group_bits, uint32_t w_bits) {
  uint64_t vis = 0;
#pragma unroll
  for (int a = 0; a < kGroups; ++a)
    if ((group_bits >> a) & 1u) vis |= static_cast<uint64_t>(w_bits) << (8 * a);
  return vis;
}

// ------------------------------------ K10 ------------------------------------

struct FwdSmem {
  alignas(1024) unsigned char q[Tile<kRows>::kBytes];  // the q tile, then each warpgroup's output rows
  alignas(1024) unsigned char k[kStages][Tile<kRows>::kBytes];
  alignas(1024) unsigned char v[kStages][Tile<kRows>::kBytes];
  int4 info[kStages];  // the stage's (warpgroup, half) bits and its kv block's h0, w0
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};

// the online softmax of one S tile in fp32, in place: entries whose bit of
// `vis` is clear get the logit -1e30 and P = 0 (where `masked`); the
// running row max (times scale * log2(e)) and this lane's part of the
// running sum; corr: the factor for O
__device__ __forceinline__ void na_softmax_tile(float (&sc)[kRows / 2], float (&m_run)[2], float (&l_run)[2],
                                                float (&corr)[2], uint64_t vis, bool masked, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i)
      if (!((vis >> i) & 1u)) sc[i] = kNegInf;
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
    corr[r] = exp2_approx(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) {
    const int r = (i >> 1) & 1;
    float pv = exp2_approx(fmaf(sc[i], scale_log2, -m_run[r]));
    if (masked && !((vis >> i) & 1u)) pv = 0.f;
    sc[i] = pv;
    psum[r] += pv;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + psum[r];
}

__global__ void __launch_bounds__(kWsThreads, 1)
na_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              const Walk walk, const Geom geo, int heads, int S_pad, float scale) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = smem_storage<FwdSmem>(smem_raw);
  const int tile = blockIdx.x;  // 128-row q tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int n = walk.counts[tile];
  const int* entries = walk.entries + static_cast<size_t>(tile) * walk.max_len;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0 && n > 0) {
      mbar_arrive_expect_tx(&sm.q_full, Tile<kRows>::kBytes);
      tma_tile_head_major<kRows>(sm.q, &map_q, &sm.q_full, tile * kRows, h, b);
      for (int it = 0; it < n; ++it) {
        const int s = it % kStages;
        const int e = entries[it];
        const int kv_tile = e >> 4;
        const int kblk = kv_tile / (walk.bt / 2);
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        sm.info[s] = make_int4(e & 15, walk.coords[3 * kblk + 1], walk.coords[3 * kblk + 2], 0);
        mbar_arrive_expect_tx(&sm.k_full[s], Tile<kRows>::kBytes);
        mbar_arrive_expect_tx(&sm.v_full[s], Tile<kRows>::kBytes);
        tma_tile_head_major<kRows>(sm.k[s], &map_k, &sm.k_full[s], kv_tile * kRows, h, b);
        tma_tile_head_major<kRows>(sm.v[s], &map_v, &sm.v_full[s], kv_tile * kRows, h, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane / 4;
    const int t = lane % 4;
    const float scale_log2 = scale * kLog2e;
    // key ranges of this thread's query rows (16 warp + g and + 8 of the
    // warpgroup's t-slice: h = h0 + warp, w = w0 + g and w0 + g + 8); pad
    // rows get empty ones. Pad frames are never in the walk.
    const int qblk = tile / (walk.bt / 2);
    const int2 empty = make_int2(1, 0);
    const int hq = walk.coords[3 * qblk + 1] + warp;
    const int2 hr = hq < geo.H ? axis_range(hq, geo.H, geo.win_h, geo.str_h) : empty;
    int2 wr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int wq = walk.coords[3 * qblk + 2] + g + 8 * r;
      wr[r] = hq < geo.H && wq < geo.W ? axis_range(wq, geo.W, geo.win_w, geo.str_w) : empty;
    }

    const unsigned char* q_rows = sm.q + 64 * wg * 128;  // this warpgroup's 64 rows in each q box
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};  // running row max of the logits times scale * log2(e)
    float l_run[2] = {0.f, 0.f};          // this lane's part of the running row sum
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    };

    if (n > 0) mbar_wait(&sm.q_full, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      mbar_wait(&sm.k_full[s], parity);
      const int4 info = sm.info[s];
      const uint32_t halves = (info.x >> (2 * wg)) & 3u;  // the kv tile's t-slices this warpgroup sees
      if (halves == 0) {
        mbar_wait(&sm.v_full[s], parity);
        release(s);
        continue;
      }
      float sc[kRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int box = kk / 4;
        wgmma_ss<0>(sc, kmajor_desc(q_rows + box * Tile<kRows>::kBoxBytes, kk % 4),
                    kmajor_desc(sm.k[s] + box * Tile<kRows>::kBoxBytes, kk % 4), kk > 0);
      }
      wgmma_commit();
      // the mask while S is in flight: column group a = 4 half + ih sits at
      // h = h0k + ih of t-slice `half`
      uint32_t groups = 0;
#pragma unroll
      for (int a = 0; a < 8; ++a)
        if (((halves >> (a >> 2)) & 1u) && in_range(info.y + (a & 3), hr)) groups |= 1u << a;
      const uint64_t vis = spread_bits<8>(groups, w_bits_fwd(info.z, t, wr));
      const bool masked = !__all_sync(0xffffffffu, vis == ~0ull);
      wgmma_wait<0>();
      fence_operands(sc);
      float corr[2];
      na_softmax_tile(sc, m_run, l_run, corr, vis, masked, scale_log2);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
      uint32_t pa[kRows / 16][4];  // P (bf16) as the register A operand of P V
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) a_fragment(pa[kk], sc, kk);
      mbar_wait(&sm.v_full[s], parity);
      wgmma_fence();
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs<1>(o, pa[kk], mnmajor_desc(sm.v[s], Tile<kRows>::kBoxBytes, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      release(s);
    }

    // ------------------------------ epilogue ------------------------------
    // O = acc / max(l, 1e-20), lse = m + log l; a row that saw no key (a pad
    // row) gets out 0 and the lse -1e30 + log(1e-20) = -1e30 in fp32
    float inv_l[2], row_lse[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv_l[r] = 1.f / fmaxf(l_run[r], kMinSum);
      row_lse[r] = l_run[r] > 0.f ? (m_run[r] + __log2f(l_run[r])) * kLn2 : kNegInf;
    }
    const size_t row0 = (static_cast<size_t>(b) * heads + h) * S_pad + static_cast<size_t>(tile) * kRows + 64 * wg;
    // O / l in bf16, staged in this warpgroup's rows of the q tile (chunk c
    // of row r at chunk c ^ (r % 8) of its box), then 16-byte stores
    named_barrier_sync(1 + wg, 128);  // every warp of the warpgroup is done reading its q rows
    unsigned char* stage = sm.q + 64 * wg * 128;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row_l = 16 * warp + g + 8 * r;
        *reinterpret_cast<uint32_t*>(stage + (j / 8) * Tile<kRows>::kBoxBytes + row_l * 128 +
                                     (((j % 8) ^ (row_l % 8)) * 16) + 4 * t) =
            pack_bf16(o[4 * j + 2 * r] * inv_l[r], o[4 * j + 2 * r + 1] * inv_l[r]);
      }
    }
    named_barrier_sync(1 + wg, 128);
    const int tid = threadIdx.x % 128;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = i * 128 + tid;
      const int row_l = idx / 16, c16 = idx % 16;
      const uint4 val = *reinterpret_cast<const uint4*>(stage + (c16 / 8) * Tile<kRows>::kBoxBytes + row_l * 128 +
                                                        (((c16 % 8) ^ (row_l % 8)) * 16));
      *reinterpret_cast<uint4*>(out + (row0 + row_l) * kD + 8 * c16) = val;
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) lse[row0 + 16 * warp + g + 8 * r] = row_lse[r];
    }
  }
}

// ------------------------------------ K12 ------------------------------------

struct DkvSmem {
  alignas(1024) unsigned char k[Tile<kRows>::kBytes];
  alignas(1024) unsigned char v[Tile<kRows>::kBytes];
  alignas(1024) unsigned char q[kStages][Tile<kTile>::kBytes];
  alignas(1024) unsigned char dout[kStages][Tile<kTile>::kBytes];
  float lse[kStages][kTile];  // lse * log2(e)
  float delta[kStages][kTile];
  int2 hr[kStages][4];   // key ranges along h of the q tile's 4 rows of tokens (empty past H)
  int2 wr[kStages][16];  // key ranges along w of its 16 columns (empty past W)
  int bits[kStages];     // the warpgroups that see this q t-slice
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

__global__ void __launch_bounds__(kWsThreads, 1)
na_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                  const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, const Walk walk, const Geom geo, int heads, int S_pad, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = smem_storage<DkvSmem>(smem_raw);
  const int tile = blockIdx.x;  // 128-row kv tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int n = walk.counts[tile];
  const int* entries = walk.entries + static_cast<size_t>(tile) * walk.max_len;
  const size_t bh_row = (static_cast<size_t>(b) * heads + h) * S_pad;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes (lse, delta, ranges), one with the TMA bytes
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && n > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.kv_full, 2 * Tile<kRows>::kBytes);
        tma_tile_head_major<kRows>(sm.k, &map_k, &sm.kv_full, tile * kRows, h, b);
        tma_tile_head_major<kRows>(sm.v, &map_v, &sm.kv_full, tile * kRows, h, b);
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % kStages;
        const int e = entries[it];
        const int q_slice = e >> 2;
        const int qblk = q_slice / walk.bt;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
#pragma unroll
        for (int r = lane; r < kTile; r += 32) {
          sm.lse[s][r] = lse[bh_row + q_slice * kTile + r] * kLog2e;
          sm.delta[s][r] = delta[bh_row + q_slice * kTile + r];
        }
        if (lane < 4) {
          const int hq = walk.coords[3 * qblk + 1] + lane;
          sm.hr[s][lane] = hq < geo.H ? axis_range(hq, geo.H, geo.win_h, geo.str_h) : make_int2(1, 0);
        } else if (lane < 20) {
          const int wq = walk.coords[3 * qblk + 2] + lane - 4;
          sm.wr[s][lane - 4] = wq < geo.W ? axis_range(wq, geo.W, geo.win_w, geo.str_w) : make_int2(1, 0);
        }
        if (lane == 0) {
          sm.bits[s] = e & 3;
          mbar_arrive_expect_tx(&sm.full[s], 2 * Tile<kTile>::kBytes);
          tma_tile_head_major<kTile>(sm.q[s], &map_q, &sm.full[s], q_slice * kTile, h, b);
          tma_tile_head_major<kTile>(sm.dout[s], &map_do, &sm.full[s], q_slice * kTile, h, b);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane / 4;
    const int t = lane % 4;
    const float scale_log2 = scale * kLog2e;
    // this thread's kv rows (16 warp + g and + 8 of the warpgroup's
    // t-slice): h = h0 + warp, w = w0 + g and w0 + g + 8. Pad keys lie in
    // no query's range.
    const int kblk = tile / (walk.bt / 2);
    const int hk = walk.coords[3 * kblk + 1] + warp;
    const int wk = walk.coords[3 * kblk + 2] + g;
    float acc_k[64], acc_v[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
    const int wg_off = 64 * wg * 128;  // this warpgroup's 64 rows in each K / V box

    if (n > 0) mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      mbar_wait(&sm.full[s], (it / kStages) & 1);
      if (!((sm.bits[s] >> wg) & 1)) {  // this warpgroup's t-slice is in no row's t-window
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[s]);
        continue;
      }

      // S^T = K Q^T and dP^T = V dO^T (64 kv x 64 q per warpgroup)
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int box = kk / 4;
        wgmma_ss<0>(st, kmajor_desc(sm.k + box * Tile<kRows>::kBoxBytes + wg_off, kk % 4),
                    kmajor_desc(sm.q[s] + box * Tile<kTile>::kBoxBytes, kk % 4), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int box = kk / 4;
        wgmma_ss<0>(dpt, kmajor_desc(sm.v + box * Tile<kRows>::kBoxBytes + wg_off, kk % 4),
                    kmajor_desc(sm.dout[s] + box * Tile<kTile>::kBoxBytes, kk % 4), kk > 0);
      }
      wgmma_commit();
      // the mask while the products run: q column 8 j + 2 t + e sits at
      // h = h0q + (j >> 1) (column group j >> 1), w = w0q + 8 (j & 1) + 2 t + e
      uint32_t groups = 0, w_bits = 0;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (in_range(hk, sm.hr[s][a])) groups |= 1u << a;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (in_range(wk + 8 * r, sm.wr[s][8 * jj + 2 * t + e])) w_bits |= 1u << (4 * jj + 2 * r + e);
      const uint32_t vis = static_cast<uint32_t>(spread_bits<4>(groups, w_bits));
      wgmma_wait<0>();
      fence_operands(st);
      fence_operands(dpt);

      // P^T (in st) and dS^T = P^T (dP^T - delta) (in dpt); 0 off the window
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;  // q column within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[s][c]);
        const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[s][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float p = (vis >> i) & 1u ? exp2f(st[i] * scale_log2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - ((e & 1) ? dl.y : dl.x));
        }
      }

      // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q MN-major
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a_fragment(pa[kk], st, kk);
        a_fragment(da[kk], dpt, kk);
      }
      wgmma_fence();
      fence_operands(acc_v);
      fence_operands(acc_k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(acc_v, pa[kk], mnmajor_desc(sm.dout[s], Tile<kTile>::kBoxBytes, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(acc_k, da[kk], mnmajor_desc(sm.q[s], Tile<kTile>::kBoxBytes, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc_v);
      fence_operands(acc_k);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    const size_t row0 = bh_row + static_cast<size_t>(tile) * kRows + 64 * wg + 16 * warp + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t off = (row0 + 8 * r) * kD;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t) =
            pack_bf16(acc_k[4 * j + 2 * r] * scale, acc_k[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t) =
            pack_bf16(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
      }
    }
  }
}

Geom make_geom(int T, int H, int W, int win_t, int win_h, int win_w, int str_t, int str_h, int str_w) {
  return Geom{T, H, W, win_t, win_h, win_w, str_t, str_h, str_w};
}

}  // namespace

// dynamic shared memory a CTA of K10 (kernel 0) or K12 (kernel 1) takes, in bytes
extern "C" int cosmos_na_smem_bytes(int kernel) {
  return static_cast<int>(kernel ? sizeof(DkvSmem) : sizeof(FwdSmem)) + 1024;
}

// q, k, v, out: (B, heads, S_pad, 128) bf16, contiguous, 16-byte aligned, in
// the tiled layout; lse: (B, heads, S_pad) fp32; walk (S_pad / 128, max_len),
// walk_counts (S_pad / 128,) from fwd_walk and coords (n_blocks, 3): int32
// on the device. S_pad is a multiple of 64 * bt, bt even. Returns the CUDA
// error code (0 on success).
extern "C" int cosmos_na_fwd(const void* q, const void* k, const void* v, void* out, void* lse, const void* walk,
                             const void* walk_counts, const void* coords, int B, int heads, int S_pad, int bt,
                             int max_len, int T, int H, int W, int win_t, int win_h, int win_w, int str_t, int str_h,
                             int str_w, float scale, void* stream) {
  if (bt < 2 || bt % 2 || S_pad % (kTile * bt)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int err = make_head_major_map(&mq, q, B, heads, S_pad, S_pad, kRows);
  if (!err) err = make_head_major_map(&mk, k, B, heads, S_pad, S_pad, kRows);
  if (!err) err = make_head_major_map(&mv, v, B, heads, S_pad, S_pad, kRows);
  if (err) return err;
  static bool configured[kMaxDevices] = {};
  const int smem = cosmos_na_smem_bytes(0);
  const cudaError_t cerr = set_smem_once(reinterpret_cast<const void*>(na_fwd_kernel), smem, configured);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const Walk w{static_cast<const int*>(walk), static_cast<const int*>(walk_counts), static_cast<const int*>(coords), bt,
               max_len};
  const dim3 grid(S_pad / kRows, heads, B);
  na_fwd_kernel<<<grid, kWsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), w,
      make_geom(T, H, W, win_t, win_h, win_w, str_t, str_h, str_w), heads, S_pad, scale);
  return static_cast<int>(cudaGetLastError());
}

// as above, with dout, dq (B, heads, S_pad, 128) bf16 and delta (B, heads, S_pad) fp32.
extern "C" int cosmos_na_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, const void* table, const void* counts, const void* coords,
                                int B, int heads, int S_pad, int bt, int max_cnt, int T, int H, int W, int win_t,
                                int win_h, int win_w, int str_t, int str_h, int str_w, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(na_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables tab{static_cast<const int*>(table), static_cast<const int*>(counts), static_cast<const int*>(coords), bt,
                   max_cnt};
  const dim3 grid(S_pad / kTile, heads, B);
  na_bwd_dq_kernel<<<grid, kThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), tab, make_geom(T, H, W, win_t, win_h, win_w, str_t, str_h, str_w), heads, S_pad,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// as K10, with dout, dk, dv (B, heads, S_pad, 128) bf16, lse and delta
// (B, heads, S_pad) fp32, and walkT / walkT_counts from dkv_walk.
extern "C" int cosmos_na_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, const void* walkT, const void* walkT_counts,
                                 const void* coords, int B, int heads, int S_pad, int bt, int max_len, int T, int H,
                                 int W, int win_t, int win_h, int win_w, int str_t, int str_h, int str_w, float scale,
                                 void* stream) {
  if (bt < 2 || bt % 2 || S_pad % (kTile * bt)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mdo;
  int err = make_head_major_map(&mq, q, B, heads, S_pad, S_pad, kTile);
  if (!err) err = make_head_major_map(&mdo, dout, B, heads, S_pad, S_pad, kTile);
  if (!err) err = make_head_major_map(&mk, k, B, heads, S_pad, S_pad, kRows);
  if (!err) err = make_head_major_map(&mv, v, B, heads, S_pad, S_pad, kRows);
  if (err) return err;
  static bool configured[kMaxDevices] = {};
  const int smem = cosmos_na_smem_bytes(1);
  const cudaError_t cerr = set_smem_once(reinterpret_cast<const void*>(na_bwd_dkv_kernel), smem, configured);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const Walk w{static_cast<const int*>(walkT), static_cast<const int*>(walkT_counts), static_cast<const int*>(coords),
               bt, max_len};
  const dim3 grid(S_pad / kRows, heads, B);
  na_bwd_dkv_kernel<<<grid, kWsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), w,
      make_geom(T, H, W, win_t, win_h, win_w, str_t, str_h, str_w), heads, S_pad, scale);
  return static_cast<int>(cudaGetLastError());
}
