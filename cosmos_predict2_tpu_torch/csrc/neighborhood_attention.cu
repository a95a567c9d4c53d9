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
// Design (first, simple version; the structure of K1, K7 and K8):
// - The TPU kernels run a grid (b, h, q block, table entry) with scalar-
//   prefetched tables and carry the accumulators across the table axis in
//   VMEM. Here one block of 4 warps owns a 64-row tile (one t-slice of a
//   spatial tile), reads its own counts and table row, and loops over the
//   listed blocks' 64-row tiles; the sums stay in registers. The loop stops
//   at counts[i]: the table's padding repeats the last id.
// - Along t every row of a 64-row tile has the same coordinate, so the t-axis
//   test is uniform for a (q tile, kv tile) pair: tiles of pad frames or
//   outside the t-window are skipped whole. On h and w each thread computes
//   its rows' key ranges [lo, hi] once (stride representative, clamp; a pad
//   query gets an empty range), and the per-element mask is two range tests
//   on bit math of the column index.
// - K10: K1's online softmax (row max and sum across the 4 lanes of a quad),
//   P reused from registers as the A operand of O += P V.
// - K11: K7's structure: Q and dO tiles staged once; S = Q K^T and
//   dP = dO V^T per kv tile, dS in registers as the A operand of dQ += dS K.
// - K12: K8's structure over the transposed table: one block per 64-row kv
//   tile, 32-row q sub-tiles (with their lse, delta and key ranges staged in
//   shared memory), S^T = K Q^T and dP^T = V dO^T with the kv rows as M, so
//   P^T and dS^T feed dV += P^T dO and dK += dS^T Q from registers. No
//   atomics: deterministic, as K7 and K8.
// TMA, wgmma, asynchronous copies and folding the layout permutation into the
// addressing are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using cosmos_kernels::ld_pair;
using cosmos_kernels::mma_16816;
using cosmos_kernels::pack_float_pair;
using cosmos_kernels::pack_pair;

constexpr int kD = 128;
constexpr int kTile = 64;  // rows of one t-slice of a 4 x 16 spatial tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;  // padded shared-memory row, in bf16 elements
constexpr float kNegInf = -1e30f;
constexpr float kMinSum = 1e-20f;
constexpr int kDkvQ = 32;  // K12's q sub-tile

constexpr int kFwdSmemBytes = 3 * kTile * kLds * 2;
constexpr int kDqSmemBytes = 4 * kTile * kLds * 2;
constexpr int kDkvSmemBytes = (2 * kTile + 2 * kDkvQ) * kLds * 2 + 2 * kDkvQ * 4 + 2 * kDkvQ * 8;

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

// ------------------------------------ K10 ------------------------------------

__global__ void __launch_bounds__(kThreads)
na_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              Tables tab, Geom geo, int heads, int S_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kTile * kLds;
  __nv_bfloat16* sV = sK + kTile * kLds;

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t bh_row = (static_cast<size_t>(b) * heads + h) * S_pad;  // first row of this (batch, head)
  const size_t q_row = bh_row + static_cast<size_t>(tile) * kTile;
  const int qblk = tile / tab.bt;
  const int t_q = tab.coords[3 * qblk] + tile % tab.bt;
  int2 hr, wr[2];
  query_ranges(geo, t_q, tab.coords[3 * qblk + 1], tab.coords[3 * qblk + 2], warp, g, hr, wr);
  const int2 tr = axis_range(t_q, geo.T, geo.win_t, geo.str_t);
  const int n = t_q < geo.T ? tab.counts[qblk] : 0;

  stage_rows(sQ, q + q_row * kD, kTile, tid);
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) load_a(qf[kk], sQ, warp * 16, kk, g, t);

  float o[kD / 8][4];
#pragma unroll
  for (int nn = 0; nn < kD / 8; ++nn) o[nn][0] = o[nn][1] = o[nn][2] = o[nn][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's partial row sums; quad-reduced at the end

  for (int jb = 0; jb < n; ++jb) {
    const int kblk = tab.table[qblk * tab.max_cnt + jb];
    const int t0k = tab.coords[3 * kblk], h0k = tab.coords[3 * kblk + 1], w0k = tab.coords[3 * kblk + 2];
    for (int u = 0; u < tab.bt; ++u) {
      if (!in_range(t0k + u, tr) || t0k + u >= geo.T) continue;  // uniform over the block
      const size_t kv_row = bh_row + static_cast<size_t>(kblk * tab.bt + u) * kTile;
      __syncthreads();  // every warp is done with the previous K/V tile
      stage_rows(sK, k + kv_row * kD, kTile, tid);
      stage_rows(sV, v + kv_row * kD, kTile, tid);
      __syncthreads();

      // ---- S = Q K^T: 16 x 64 per warp ----
      float s[kTile / 8][4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const __nv_bfloat16* kp = sK + (j * 8 + g) * kLds + 2 * t;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) mma_16816(s[j], qf[kk], ld_pair(kp + kk * 16), ld_pair(kp + kk * 16 + 8));
      }

      // ---- masks, online softmax in fp32 with an explicit P = 0 off the window ----
      const uint32_t vis = fragment_mask(hr, wr, h0k, w0k, t);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = (vis >> (4 * j + e)) & 1u ? s[j][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        corr[r] = __expf(m_run[r] - m_new);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = (vis >> (4 * j + e)) & 1u ? __expf(s[j][e] - m_run[e >> 1]) : 0.f;
          psum[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + psum[r];
#pragma unroll
      for (int nn = 0; nn < kD / 8; ++nn) {
        o[nn][0] *= corr[0];
        o[nn][1] *= corr[0];
        o[nn][2] *= corr[1];
        o[nn][3] *= corr[1];
      }

      // ---- O += P V: P (bf16) from registers as the A operand ----
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_float_pair(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_float_pair(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_float_pair(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_float_pair(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const __nv_bfloat16* vp = sV + (kk * 16 + 2 * t) * kLds + g;
#pragma unroll
        for (int nn = 0; nn < kD / 8; ++nn) {
          const __nv_bfloat16* p = vp + nn * 8;
          mma_16816(o[nn], pa, pack_pair(p[0], p[kLds]), pack_pair(p[8 * kLds], p[9 * kLds]));
        }
      }
    }
  }

  // ---- finalize: O = acc / max(l, 1e-20), lse = m + log l ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], kMinSum);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = q_row + warp * 16 + g + 8 * r;
    __nv_bfloat16* orow = out + row * kD;
#pragma unroll
    for (int nn = 0; nn < kD / 8; ++nn) {
      *reinterpret_cast<uint32_t*>(orow + nn * 8 + 2 * t) =
          pack_float_pair(o[nn][2 * r] / l_run[r], o[nn][2 * r + 1] / l_run[r]);
    }
    if (t == 0) lse[row] = m_run[r] + logf(l_run[r]);
  }
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

// ------------------------------------ K12 ------------------------------------

__global__ void __launch_bounds__(kThreads)
na_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, Tables tabT, Geom geo, int heads, int S_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kTile * kLds;
  __nv_bfloat16* sQ = sV + kTile * kLds;
  __nv_bfloat16* sdO = sQ + kDkvQ * kLds;
  float* sLse = reinterpret_cast<float*>(sdO + kDkvQ * kLds);
  float* sDelta = sLse + kDkvQ;
  int2* sHr = reinterpret_cast<int2*>(sDelta + kDkvQ);  // key ranges of the staged q rows
  int2* sWr = sHr + kDkvQ;

  const int tile = blockIdx.x;  // 64-row kv tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t bh_row = (static_cast<size_t>(b) * heads + h) * S_pad;
  const size_t kv_row = bh_row + static_cast<size_t>(tile) * kTile;
  const int kblk = tile / tabT.bt;
  const int t_k = tabT.coords[3 * kblk] + tile % tabT.bt;
  // this thread's kv rows r = warp * 16 + g and r + 8: h = h0 + warp, w = w0 + g (+ 8)
  const int hk = tabT.coords[3 * kblk + 1] + warp;
  const int wk[2] = {tabT.coords[3 * kblk + 2] + g, tabT.coords[3 * kblk + 2] + g + 8};
  const int n = t_k < geo.T ? tabT.counts[kblk] : 0;

  stage_rows(sK, k + kv_row * kD, kTile, tid);
  stage_rows(sV, v + kv_row * kD, kTile, tid);

  float acc_k[kD / 8][4], acc_v[kD / 8][4];
#pragma unroll
  for (int nn = 0; nn < kD / 8; ++nn) {
    acc_k[nn][0] = acc_k[nn][1] = acc_k[nn][2] = acc_k[nn][3] = 0.f;
    acc_v[nn][0] = acc_v[nn][1] = acc_v[nn][2] = acc_v[nn][3] = 0.f;
  }

  for (int jb = 0; jb < n; ++jb) {
    const int qblk = tabT.table[kblk * tabT.max_cnt + jb];
    const int t0q = tabT.coords[3 * qblk], h0q = tabT.coords[3 * qblk + 1], w0q = tabT.coords[3 * qblk + 2];
    for (int uq = 0; uq < tabT.bt; ++uq) {
      const int t_q = t0q + uq;
      // uniform over the block: pad frames are no queries, and t_k must lie in t_q's window
      if (t_q >= geo.T || !in_range(t_k, axis_range(t_q, geo.T, geo.win_t, geo.str_t))) continue;
      for (int half = 0; half < kTile / kDkvQ; ++half) {
        if (h0q + half * (kDkvQ / 16) >= geo.H) continue;  // every row of this sub-tile is a pad row
        const size_t q_row = bh_row + static_cast<size_t>(qblk * tabT.bt + uq) * kTile + half * kDkvQ;
        __syncthreads();  // every warp is done with the previous Q/dO sub-tile (and K/V are staged)
        stage_rows(sQ, q + q_row * kD, kDkvQ, tid);
        stage_rows(sdO, dout + q_row * kD, kDkvQ, tid);
        if (tid < kDkvQ) {
          const int hq = h0q + half * (kDkvQ / 16) + (tid >> 4);
          const int wq = w0q + (tid & 15);
          const bool ok = hq < geo.H && wq < geo.W;
          sLse[tid] = lse[q_row + tid];
          sDelta[tid] = delta[q_row + tid];
          sHr[tid] = ok ? axis_range(hq, geo.H, geo.win_h, geo.str_h) : make_int2(1, 0);
          sWr[tid] = ok ? axis_range(wq, geo.W, geo.win_w, geo.str_w) : make_int2(1, 0);
        }
        __syncthreads();

        // ---- S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 q columns per warp ----
        float st[kDkvQ / 8][4], dpt[kDkvQ / 8][4];
#pragma unroll
        for (int j = 0; j < kDkvQ / 8; ++j) {
          st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
          dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          uint32_t ka[4], va[4];
          load_a(ka, sK, warp * 16, kk, g, t);
          load_a(va, sV, warp * 16, kk, g, t);
#pragma unroll
          for (int j = 0; j < kDkvQ / 8; ++j) {
            const int off = (j * 8 + g) * kLds + kk * 16 + 2 * t;
            mma_16816(st[j], ka, ld_pair(sQ + off), ld_pair(sQ + off + 8));
            mma_16816(dpt[j], va, ld_pair(sdO + off), ld_pair(sdO + off + 8));
          }
        }

        // ---- P^T (in st) and dS^T = P^T (dP^T - delta) (in dpt); 0 off the window ----
#pragma unroll
        for (int j = 0; j < kDkvQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = j * 8 + 2 * t + (e & 1);  // q row within the sub-tile
            const bool visible = in_range(hk, sHr[c]) && in_range(wk[e >> 1], sWr[c]);
            const float p = visible ? __expf(st[j][e] * scale - sLse[c]) : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - sDelta[c]);
          }
        }

        // ---- dV += P^T dO and dK += dS^T Q: A from registers, B by transposed pair loads ----
#pragma unroll
        for (int kk = 0; kk < kDkvQ / 16; ++kk) {
          uint32_t pa[4], da[4];
          pa[0] = pack_float_pair(st[2 * kk][0], st[2 * kk][1]);
          pa[1] = pack_float_pair(st[2 * kk][2], st[2 * kk][3]);
          pa[2] = pack_float_pair(st[2 * kk + 1][0], st[2 * kk + 1][1]);
          pa[3] = pack_float_pair(st[2 * kk + 1][2], st[2 * kk + 1][3]);
          da[0] = pack_float_pair(dpt[2 * kk][0], dpt[2 * kk][1]);
          da[1] = pack_float_pair(dpt[2 * kk][2], dpt[2 * kk][3]);
          da[2] = pack_float_pair(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
          da[3] = pack_float_pair(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
          const int base = (kk * 16 + 2 * t) * kLds + g;
#pragma unroll
          for (int nn = 0; nn < kD / 8; ++nn) {
            const __nv_bfloat16* po = sdO + base + nn * 8;
            const __nv_bfloat16* pq = sQ + base + nn * 8;
            mma_16816(acc_v[nn], pa, pack_pair(po[0], po[kLds]), pack_pair(po[8 * kLds], po[9 * kLds]));
            mma_16816(acc_k[nn], da, pack_pair(pq[0], pq[kLds]), pack_pair(pq[8 * kLds], pq[9 * kLds]));
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = (kv_row + warp * 16 + g + 8 * r) * kD;
#pragma unroll
    for (int nn = 0; nn < kD / 8; ++nn) {
      *reinterpret_cast<uint32_t*>(dk + off + nn * 8 + 2 * t) =
          pack_float_pair(acc_k[nn][2 * r] * scale, acc_k[nn][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + nn * 8 + 2 * t) = pack_float_pair(acc_v[nn][2 * r], acc_v[nn][2 * r + 1]);
    }
  }
}

Geom make_geom(int T, int H, int W, int win_t, int win_h, int win_w, int str_t, int str_h, int str_w) {
  return Geom{T, H, W, win_t, win_h, win_w, str_t, str_h, str_w};
}

}  // namespace

// q, k, v, out: (B, heads, S_pad, 128) bf16, contiguous, 16-byte aligned, in
// the tiled layout; lse: (B, heads, S_pad) fp32; table (n_blocks, max_cnt),
// counts (n_blocks,), coords (n_blocks, 3): int32 on the device. S_pad is a
// multiple of 64 * bt. Returns the CUDA error code (0 on success).
extern "C" int cosmos_na_fwd(const void* q, const void* k, const void* v, void* out, void* lse, const void* table,
                             const void* counts, const void* coords, int B, int heads, int S_pad, int bt, int max_cnt,
                             int T, int H, int W, int win_t, int win_h, int win_w, int str_t, int str_h, int str_w,
                             float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(na_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables tab{static_cast<const int*>(table), static_cast<const int*>(counts), static_cast<const int*>(coords), bt,
                   max_cnt};
  const dim3 grid(S_pad / kTile, heads, B);
  na_fwd_kernel<<<grid, kThreads, kFwdSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), tab,
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

// as above, with dk, dv (B, heads, S_pad, 128) bf16 and the transposed table
// (tableT (n_blocks, max_cntT), countsT) in place of the forward's.
extern "C" int cosmos_na_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, const void* tableT, const void* countsT,
                                 const void* coords, int B, int heads, int S_pad, int bt, int max_cntT, int T, int H,
                                 int W, int win_t, int win_h, int win_w, int str_t, int str_h, int str_w, float scale,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(na_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables tabT{static_cast<const int*>(tableT), static_cast<const int*>(countsT), static_cast<const int*>(coords),
                    bt, max_cntT};
  const dim3 grid(S_pad / kTile, heads, B);
  na_bwd_dkv_kernel<<<grid, kThreads, kDkvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), tabT,
      make_geom(T, H, W, win_t, win_h, win_w, str_t, str_h, str_w), heads, S_pad, scale);
  return static_cast<int>(cudaGetLastError());
}
