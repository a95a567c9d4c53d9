// Flash-attention forward (K1), the KV-cache decode (K5) and its row-windowed
// form (K6) for Hopper (sm_90a), bf16 in, fp32 accumulate: one
// warp-specialised body, three entry points.
//
// K1 replaces cosmos_predict2_tpu/ops/flash_attention.py::_fwd_kernel (the
// Pallas TPU kernel driven by _fwd / flash_attention). Contract:
// non-causal online-softmax attention, BSHD q (B, Sq, H, 128) and k, v
// (B, Skv, H, 128) in, the output (B, Sq, H, 128) in bf16 and the row
// logsumexp `lse` (B, H, Sq) in fp32 out, scale 1/sqrt(128), the kv tail
// masked, and the optional frame-block mask (key i visible to query j iff
// i / frame_group <= j / frame_group) with fully masked kv tiles skipped.
//
// K5 replaces ::_fwd_cache_kernel (driven by _flash_kv_cache_impl /
// flash_attention_kv_cache): the queries of a new frame block, q (B, Sq, H,
// 128) token-major, attend over the first kv_valid positions of HEAD-MAJOR
// ring buffers k_buf / v_buf (B, H, S_max, 128); the block sees itself whole
// (no mask inside it); output (B, Sq, H, 128) bf16, no lse.
//
// K6 replaces ::_fwd_cache_window_kernel (driven by
// _flash_kv_cache_window_impl / flash_attention_kv_cache_window): as K5,
// but q holds whole frames of a gh x gw token grid, row-major (frame, row,
// col), the buffers' S axis is whole frames too, and query row yq sees, in
// every filled frame, only the full-width key rows [s, s + wh) with
// s = clamp(yq - (wh-1)/2, 0, gh - wh). kv_valid is a whole number of
// frames (the wrapper checks; the TPU kernel gave NaN otherwise,
// flash_attention.py:391). There are no bands, so any gh works (the TPU
// banding went dense for a prime gh, flash_attention.py:357).
//
// All three round P to bf16 before P V, as the TPU kernels do. Masked logits
// take the finite -1e30 (the TPU kernel's _NEG_INF) and masked entries an
// explicit P = 0, so the lse matches the plain version's and a masked entry
// adds exactly nothing.
//
// What bounds them on the H100: 4 * 128 FLOPs per visible (query, key) pair
// against 2 * 128 * 2 bytes per q, k, v or output row read or written once.
// At K1's main-path shapes (5,760 to 84,480 tokens, or 512 text keys) and at
// K5's (a block of 880 to 3,520 queries over a 3,520- to 31,680-row cache)
// that is hundreds to thousands of FLOP per byte, above the card's ~295
// FLOP/byte line: the bound is the tensor-core rate, 989 TFLOP/s. K6 at the
// interactive steady state (7 of 22 rows) does a third of K5's products over
// the same cache: on paper the bytes bound it (0.039 ms at 3.35 TB/s).
//
// Design. One CTA per (128 q rows, head, batch) of 384 threads: a producer
// warpgroup (setmaxnreg down to 24; one thread starts the TMA copies) and two consumer
// warpgroups of 64 q rows each (setmaxnreg up to 240). What the first
// versions (mma.sync m16n8k16, 4 warps, 64 x 64 tiles, synchronous 16-byte
// staging with two __syncthreads per tile, V read through scalar pairs)
// lacked, and what this one does about it:
// 1. Overlap. The q tile is loaded once; K and V stream in kv tiles
//    through a ring of kStages stages, K and V of a stage on mbarriers of
//    their own (S = Q K^T starts while V lands) and one "empty" mbarrier
//    (one arrival per consumer warp). No __syncthreads in the kv loop. The
//    tensor maps are 4-d, so TMA fills rows past the sequence (K1: past Sq
//    or Skv inside each batch; K5, K6: at or past kv_valid, whatever the
//    cache holds there, NaN included) with zeros.
// 2. Tensor cores. S = Q K^T is wgmma m64nBKVk16 with both operands
//    K-major in shared memory; the online softmax runs in fp32 on the
//    accumulator's layout (row max and sum over the quad with shfl_xor 1
//    and 2); P is rounded to bf16 in registers and fed as the register A
//    operand of O += P V (wgmma m64n128k16, V MN-major): P never touches
//    shared memory.
// 3. Masks only where needed (K1, K5). The kv-tail mask runs on the tile
//    that holds the end of the keys, the frame mask only on the tiles past
//    the keys that every row of a consumer warpgroup sees; tiles no row of
//    a warpgroup sees are skipped by it, and those no row of the CTA sees
//    are not loaded. 64-row kv tiles, a third ring stage and a ping-pong of
//    the two consumer warpgroups on named barriers were slower or no faster
//    for K1 and K5 (scripts/flash_fwd_variants.py), so 128 rows, two
//    stages, no ping-pong.
// 4. Epilogue. O / l is rounded to bf16, staged in the warpgroup's own rows
//    of the q tile and written with 16-byte stores; lse = m + log l in fp32.
// 5. K5's grid can leave SMs idle while each CTA walks the whole cache.
//    Split-KV (flash-decoding): the wrapper cuts the cache's kv tiles into
//    `splits` runs (ops/flash_attention.py::kv_cache_split_plan; run s
//    covers tiles [s T / splits, (s + 1) T / splits)) where that pays; each
//    CTA writes its rows' normalised fp32 partial O and partial lse, and a
//    second kernel combines them in split order (max-shifted, lse-weighted),
//    so the result is deterministic. With one split (the interactive
//    path's one-frame block: 112 CTAs are one wave whatever the split) the
//    main kernel writes bf16 directly.
// 6. K6's walk. A CTA's rows see, in each filled frame, the contiguous
//    window union [seg_lo, seg_hi) in tokens from the frame's start (s() is
//    monotone in the row; a q tile that crosses a frame takes the whole
//    frame). The walk is that union of every filled frame in turn, cut into
//    kWindowBlockKV-row tiles from the union's start, which is any row: TMA
//    takes any row coordinate. Producer and consumers compute the same
//    closed form (window_walk), so they count the same tiles. The mask runs
//    on every tile: each row's window [lo, hi) against the key's position
//    from the start of the frame being walked, two compares per element, so
//    a key past the union (a row of another window, or of the next frame)
//    is masked and each visible key counts once. A consumer warpgroup waits
//    for and releases, without computing, a tile that misses its own rows'
//    union. Split-KV as K5, over runs of whole frames
//    (ops/flash_attention.py::kv_window_split_plan, a model of the CTAs'
//    unequal walks on the SMs): one split at the interactive steady state
//    (112 CTAs), two to four where the grid is more than a wave
//    (scripts/kv_window_variants.py sweeps 1-4). 64-row kv tiles load
//    fewer pairs (1.46x the visible ones at the steady state, not 1.66x)
//    but were no faster there and slower at 720p and with two-frame
//    blocks, so 128 rows, as K1's.
// The host sets the shared-memory attribute once per kernel and device and
// encodes the tensor maps per call (K5's and K6's fill changes every block).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_bf16.cuh"

namespace {

using namespace cosmos_sm90;

constexpr int kD = 128;
constexpr int kBlockQ = 128;  // two consumer warpgroups of 64 rows
constexpr int kBlockKV = 128;  // K1, K5
constexpr int kWindowBlockKV = 128;  // K6
constexpr int kStages = 2;
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 128;  // plus the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;

enum Mode { kFwd, kCache, kWindow };  // K1, K5, K6

template <int BKV>
struct Smem {
  alignas(1024) unsigned char q[Tile<kBlockQ>::kBytes];  // the q tile, then each warpgroup's output rows
  alignas(1024) unsigned char k[kStages][Tile<BKV>::kBytes];
  alignas(1024) unsigned char v[kStages][Tile<BKV>::kBytes];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};

template <int BKV>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Smem<BKV>)) + 1024;
}

struct Params {
  __nv_bfloat16* out;  // (B, Sq, H, 128)
  float* lse;          // K1: (B, H, Sq)
  float* partial_o;    // K5, K6 with splits > 1: (splits, B, Sq, H, 128)
  float* partial_lse;  // K5, K6 with splits > 1: (splits, B, Sq, H)
  int Sq;
  int Skv;  // K5, K6: kv_valid
  int H;
  int frame_group;  // K1; 0: none
  int splits;       // K5, K6; 1 for K1
  int gh, gw, wh;   // K6: the token grid and the visible rows per query
  float scale;
};

__device__ __forceinline__ int window_start(int y, int gh, int wh) { return min(max(y - (wh - 1) / 2, 0), gh - wh); }

// K6: the window union [lo, hi), in tokens from a frame's start, of the
// query rows [first, min(first + rows, Sq)); empty past Sq. A run of rows
// that crosses a frame sees every row of it.
__device__ __forceinline__ void window_union(const Params& p, int first, int rows, int& lo, int& hi) {
  const int frame = p.gh * p.gw;
  const int last = min(first + rows, p.Sq) - 1;
  if (last < first) {
    lo = hi = 0;
    return;
  }
  int y_min = (first % frame) / p.gw, y_max = (last % frame) / p.gw;
  if (first / frame != last / frame) y_min = 0, y_max = p.gh - 1;
  lo = window_start(y_min, p.gh, p.wh) * p.gw;
  hi = (window_start(y_max, p.gh, p.wh) + p.wh) * p.gw;
}

// K6's walk for a CTA whose rows' union is [seg_lo, seg_hi): tiles_per_frame
// tiles in each of the kv_valid / (gh gw) filled frames; tile `it` starts at
// cache row `row`, `local` tokens after the start of its frame
struct WindowWalk {
  int seg_lo, tiles_per_frame, frame;
  __device__ __forceinline__ void tile(int it, int& row, int& local) const {
    const int f = it / tiles_per_frame;
    local = seg_lo + (it - f * tiles_per_frame) * kWindowBlockKV;
    row = f * frame + local;
  }
};

__device__ __forceinline__ WindowWalk window_walk(const Params& p, int q0) {
  int lo, hi;
  window_union(p, q0, kBlockQ, lo, hi);
  return WindowWalk{lo, (hi - lo + kWindowBlockKV - 1) / kWindowBlockKV, p.gh * p.gw};
}

// S = Q K^T of this warpgroup's 64 q rows and one kv tile, started asynchronously
template <int BKV>
__device__ __forceinline__ void mma_qk(float (&sc)[BKV / 2], const unsigned char* q, const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int box = kk / 4;
    wgmma_ss<0>(sc, kmajor_desc(q + box * Tile<kBlockQ>::kBoxBytes, kk % 4),
                kmajor_desc(k + box * Tile<BKV>::kBoxBytes, kk % 4), kk > 0);
  }
}

// O += P V with P (bf16) from registers and V MN-major, started asynchronously
template <int BKV>
__device__ __forceinline__ void mma_pv(float (&o)[64], const uint32_t (&pa)[BKV / 16][4], const unsigned char* v) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs<1>(o, pa[kk], mnmajor_desc(v, Tile<BKV>::kBoxBytes, kk), 1);
}

// the online softmax of one S tile in fp32, in place: where `masked`, the
// entries visible(r, c) rejects (r: the thread's row 0 or 1, c: the column
// in the tile) take logit -1e30 and P = 0; the running row max (times
// scale * log2(e)) and this lane's part of the running sum; corr: the
// factor for O
template <int BKV, typename Visible>
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2], float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], int t, bool masked, Visible visible,
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      if (!visible((i >> 1) & 1, 8 * (i >> 2) + 2 * t + (i & 1))) sc[i] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
  for (int i = 0; i < BKV / 2; ++i) {
    const int r = (i >> 1) & 1;
    float pv = exp2_approx(fmaf(sc[i], scale_log2, -m_run[r]));
    if (masked && !visible(r, 8 * (i >> 2) + 2 * t + (i & 1))) pv = 0.f;
    sc[i] = pv;
    psum[r] += pv;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + psum[r];
}

template <int kMode, int BKV>
__device__ __forceinline__ void attention_fwd_body(const CUtensorMap* map_q, const CUtensorMap* map_k,
                                                   const CUtensorMap* map_v, const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  Smem<BKV>& sm = smem_storage<Smem<BKV>>(smem_raw);
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z / p.splits;
  const int split = blockIdx.z % p.splits;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int fg = kMode == kFwd ? p.frame_group : 0;

  // the kv tiles this CTA walks: [tile_begin, tile_end); K6: window_walk
  const int kv_tiles = (p.Skv + BKV - 1) / BKV;
  int tile_begin = 0, tile_end = kv_tiles;
  WindowWalk walk{};
  if constexpr (kMode == kCache) {
    tile_begin = split * kv_tiles / p.splits;
    tile_end = (split + 1) * kv_tiles / p.splits;
  } else if constexpr (kMode == kWindow) {
    walk = window_walk(p, q0);  // split s walks frames [s F / splits, (s + 1) F / splits) of the F filled
    const int n_frames = p.Skv / walk.frame;
    tile_begin = split * n_frames / p.splits * walk.tiles_per_frame;
    tile_end = (split + 1) * n_frames / p.splits * walk.tiles_per_frame;
  } else if (fg > 0) {  // past the last frame group any row of this q tile sees: skipped
    const int q_last = min(q0 + kBlockQ, p.Sq) - 1;
    tile_end = (min(p.Skv, (q_last / fg + 1) * fg) + BKV - 1) / BKV;
  }
  const int n_tiles = tile_end - tile_begin;

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
    if (warp == 0 && lane == 0) {
      mbar_arrive_expect_tx(&sm.q_full, Tile<kBlockQ>::kBytes);
      tma_tile_bshd<kBlockQ>(sm.q, map_q, &sm.q_full, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        int row = (tile_begin + it) * BKV, local = 0;
        if constexpr (kMode == kWindow) walk.tile(tile_begin + it, row, local);
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.k_full[s], Tile<BKV>::kBytes);
        mbar_arrive_expect_tx(&sm.v_full[s], Tile<BKV>::kBytes);
        if constexpr (kMode == kFwd) {
          tma_tile_bshd<BKV>(sm.k[s], map_k, &sm.k_full[s], row, h, b);
          tma_tile_bshd<BKV>(sm.v[s], map_v, &sm.v_full[s], row, h, b);
        } else {
          tma_tile_head_major<BKV>(sm.k[s], map_k, &sm.k_full[s], row, h, b);
          tma_tile_head_major<BKV>(sm.v[s], map_v, &sm.v_full[s], row, h, b);
        }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane / 4;
    const int t = lane % 4;
    const float scale_log2 = p.scale * kLog2e;
    const int wg_row0 = q0 + 64 * wg;
    // this thread's two query rows; K1: the end of the keys each sees; K6:
    // each one's window [lo, hi) in tokens from a frame's start (empty past Sq)
    int rows[2], kmax[2], lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = wg_row0 + 16 * warp + g + 8 * r;
      kmax[r] = fg > 0 ? min(p.Skv, (rows[r] / fg + 1) * fg) : p.Skv;
      if constexpr (kMode == kWindow) window_union(p, rows[r], 1, lo[r], hi[r]);
    }
    // K1, K5: keys below wg_full are seen by every row of this warpgroup
    // (no mask); keys at or past wg_end by none of them (the tile is
    // skipped). K6: the warpgroup's own union [wg_lo, wg_hi)
    int wg_full = p.Skv, wg_end = p.Skv, wg_lo = 0, wg_hi = 0;
    if constexpr (kMode == kFwd) {
      if (fg > 0) {
        const int last = min(wg_row0 + 64, p.Sq) - 1;
        wg_full = min(p.Skv, (wg_row0 / fg + 1) * fg);
        wg_end = last < wg_row0 ? 0 : min(p.Skv, (last / fg + 1) * fg);
      }
    } else if constexpr (kMode == kWindow) {
      window_union(p, wg_row0, 64, wg_lo, wg_hi);
    }

    // K1, K5: the tiles this warpgroup computes are the CTA's below wg_end (a prefix)
    const int n_wg = min(n_tiles, max(0, (wg_end - tile_begin * BKV + BKV - 1) / BKV));
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

    mbar_wait(&sm.q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      int kv0 = (tile_begin + it) * BKV, local = 0;
      if constexpr (kMode == kWindow) walk.tile(tile_begin + it, kv0, local);
      const bool computes = kMode == kWindow ? local < wg_hi && local + BKV > wg_lo : it < n_wg;
      if (!computes) {  // a tile no row of this warpgroup sees: released as it lands
        mbar_wait(&sm.k_full[s], parity);
        mbar_wait(&sm.v_full[s], parity);
        release(s);
        continue;
      }
      mbar_wait(&sm.k_full[s], parity);
      float sc[BKV / 2];
      wgmma_fence();
      mma_qk<BKV>(sc, q_rows, sm.k[s]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      float corr[2];
      if constexpr (kMode == kWindow) {
        softmax_tile<BKV>(sc, m_run, l_run, corr, t, true,
                          [&](int r, int c) { return local + c >= lo[r] && local + c < hi[r]; }, scale_log2);
      } else {
        softmax_tile<BKV>(sc, m_run, l_run, corr, t, kv0 + BKV > wg_full,
                          [&](int r, int c) { return kv0 + c < kmax[r]; }, scale_log2);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= corr[(i >> 1) & 1];
      uint32_t pa[BKV / 16][4];  // P (bf16) as the register A operand of P V
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) a_fragment(pa[kk], sc, kk);
      mbar_wait(&sm.v_full[s], parity);
      wgmma_fence();
      fence_operands(o);
      mma_pv<BKV>(o, pa, sm.v[s]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      release(s);
    }

    // ------------------------------ epilogue ------------------------------
    float inv_l[2], row_lse[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv_l[r] = 1.f / l_run[r];
      row_lse[r] = (m_run[r] + __log2f(l_run[r])) * kLn2;  // natural log, unscaled logits
    }
    const size_t seq_stride = static_cast<size_t>(p.H) * kD;
    if (kMode != kFwd && p.splits > 1) {
      // normalised fp32 partial O and partial lse of this split
      const int B = gridDim.z / p.splits;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= p.Sq) continue;
        const size_t row_idx = ((static_cast<size_t>(split) * B + b) * p.Sq + rows[r]) * p.H + h;
        float* dst = p.partial_o + row_idx * kD;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) =
              make_float2(o[4 * j + 2 * r] * inv_l[r], o[4 * j + 2 * r + 1] * inv_l[r]);
        if (t == 0) p.partial_lse[row_idx] = row_lse[r];
      }
    } else {
      // O / l in bf16, staged in this warpgroup's rows of the q tile (chunk c
      // of row r at chunk c ^ (r % 8) of its box), then 16-byte stores
      named_barrier_sync(1 + wg, 128);  // every warp of the warpgroup is done reading its q rows
      unsigned char* stage = sm.q + 64 * wg * 128;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row_l = 16 * warp + g + 8 * r;
          *reinterpret_cast<uint32_t*>(stage + (j / 8) * Tile<kBlockQ>::kBoxBytes + row_l * 128 +
                                       (((j % 8) ^ (row_l % 8)) * 16) + 4 * t) =
              pack_bf16(o[4 * j + 2 * r] * inv_l[r], o[4 * j + 2 * r + 1] * inv_l[r]);
        }
      }
      named_barrier_sync(1 + wg, 128);
      const int tid = threadIdx.x % 128;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int idx = n * 128 + tid;
        const int row_l = idx / 16, c16 = idx % 16;
        const int row = wg_row0 + row_l;
        if (row >= p.Sq) continue;
        const uint4 val = *reinterpret_cast<const uint4*>(stage + (c16 / 8) * Tile<kBlockQ>::kBoxBytes + row_l * 128 +
                                                          (((c16 % 8) ^ (row_l % 8)) * 16));
        *reinterpret_cast<uint4*>(p.out + (static_cast<size_t>(b) * p.Sq + row) * seq_stride +
                                  static_cast<size_t>(h) * kD + 8 * c16) = val;
      }
      if (kMode == kFwd && t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < p.Sq) p.lse[(static_cast<size_t>(b) * p.H + h) * p.Sq + rows[r]] = row_lse[r];
      }
    }
  }
}

// one kernel symbol per entry point, so that profiles name them apart
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const Params p) {
  attention_fwd_body<kFwd, kBlockKV>(&map_q, &map_k, &map_v, p);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_kv_cache_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const Params p) {
  attention_fwd_body<kCache, kBlockKV>(&map_q, &map_k, &map_v, p);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_kv_cache_window_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v, const Params p) {
  attention_fwd_body<kWindow, kWindowBlockKV>(&map_q, &map_k, &map_v, p);
}

// K5's and K6's second pass on the split route: per (batch, query, head) row, the
// partials' lse-weighted sum in split order, shifted by their max, in fp32,
// then bf16. One thread per 8 columns of a row.
__global__ void __launch_bounds__(256)
kv_cache_combine_kernel(const float* __restrict__ partial_o, const float* __restrict__ partial_lse,
                        __nv_bfloat16* __restrict__ out, size_t n_rows, int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n_rows * 16;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / 16;
    const int c = static_cast<int>(i % 16) * 8;
    float m = kNegInf;
    for (int s = 0; s < splits; ++s) m = fmaxf(m, partial_lse[s * n_rows + row]);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float wsum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = __expf(partial_lse[s * n_rows + row] - m);
      const float4* src = reinterpret_cast<const float4*>(partial_o + (s * n_rows + row) * kD + c);
      const float4 a = src[0], b = src[1];
      acc[0] += w * a.x, acc[1] += w * a.y, acc[2] += w * a.z, acc[3] += w * a.w;
      acc[4] += w * b.x, acc[5] += w * b.y, acc[6] += w * b.z, acc[7] += w * b.w;
      wsum += w;
    }
    const float inv = 1.f / wsum;
    *reinterpret_cast<uint4*>(out + row * kD + c) =
        make_uint4(pack_bf16(acc[0] * inv, acc[1] * inv), pack_bf16(acc[2] * inv, acc[3] * inv),
                   pack_bf16(acc[4] * inv, acc[5] * inv), pack_bf16(acc[6] * inv, acc[7] * inv));
  }
}

int combine(const void* partial_o, const void* partial_lse, void* out, size_t n_rows, int splits,
            cudaStream_t stream) {
  const int blocks = static_cast<int>(std::min<size_t>((n_rows * 16 + 255) / 256, 132 * 8));
  kv_cache_combine_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(partial_o),
                                                      static_cast<const float*>(partial_lse),
                                                      static_cast<__nv_bfloat16*>(out), n_rows, splits);
  return static_cast<int>(cudaGetLastError());
}

using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const Params);

template <int BKV>
int launch(Kernel kernel, bool (&configured)[kMaxDevices], const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const Params& p, int B, cudaStream_t stream) {
  const cudaError_t err = set_smem_once(reinterpret_cast<const void*>(kernel), smem_bytes<BKV>(), configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, B * p.splits);
  kernel<<<grid, kThreads, smem_bytes<BKV>(), stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1. q, out: (B, Sq, H, 128) bf16; k, v: (B, Skv, H, 128) bf16; all
// contiguous and 16-byte aligned; lse: (B, H, Sq) fp32. Returns the CUDA
// error code (0 on success).
extern "C" int cosmos_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                                          int B, int Sq, int Skv, int H, int frame_group, float scale,
                                          void* stream) {
  CUtensorMap mq, mk, mv;
  int err = make_bshd_map(&mq, q, B, Sq, H, kBlockQ);
  if (!err) err = make_bshd_map(&mk, k, B, Skv, H, kBlockKV);
  if (!err) err = make_bshd_map(&mv, v, B, Skv, H, kBlockKV);
  if (err) return err;
  const Params p{static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), nullptr, nullptr, Sq, Skv, H,
                 frame_group, 1, 0, 0, 0, scale};
  static bool configured[kMaxDevices] = {};
  return launch<kBlockKV>(flash_attention_fwd_kernel, configured, mq, mk, mv, p, B, static_cast<cudaStream_t>(stream));
}

// K5. q, out: (B, Sq, H, 128) bf16; k_buf, v_buf: (B, H, S_max, 128) bf16;
// all contiguous and 16-byte aligned; 0 < kv_valid <= S_max. splits > 1:
// partial_o (splits, B, Sq, H, 128) and partial_lse (splits, B, Sq, H), fp32
// scratch, and at most one split per kv tile of 128 rows. Returns the CUDA
// error code (0 on success).
extern "C" int cosmos_flash_kv_cache(const void* q, const void* k_buf, const void* v_buf, void* out, void* partial_o,
                                     void* partial_lse, int B, int Sq, int S_max, int H, int kv_valid, int splits,
                                     float scale, void* stream) {
  if (splits < 1 || splits > (kv_valid + kBlockKV - 1) / kBlockKV ||
      (splits > 1 && (partial_o == nullptr || partial_lse == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int err = make_bshd_map(&mq, q, B, Sq, H, kBlockQ);
  if (!err) err = make_head_major_map(&mk, k_buf, B, H, kv_valid, S_max, kBlockKV);
  if (!err) err = make_head_major_map(&mv, v_buf, B, H, kv_valid, S_max, kBlockKV);
  if (err) return err;
  const Params p{static_cast<__nv_bfloat16*>(out), nullptr, static_cast<float*>(partial_o),
                 static_cast<float*>(partial_lse), Sq, kv_valid, H, 0, splits, 0, 0, 0, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool configured[kMaxDevices] = {};
  err = launch<kBlockKV>(flash_kv_cache_kernel, configured, mq, mk, mv, p, B, st);
  if (err || splits == 1) return err;
  return combine(partial_o, partial_lse, out, static_cast<size_t>(B) * Sq * H, splits, st);
}

// K6. q, out: (B, Sq, H, 128) bf16; k_buf, v_buf: (B, H, S_max, 128) bf16;
// all contiguous and 16-byte aligned; Sq, S_max and kv_valid whole frames of
// gh * gw tokens, 0 < kv_valid <= S_max; 1 <= wh <= gh visible rows per
// query; splits and the scratch as K5's, at most one split per filled
// frame. Returns the CUDA error code (0 on success).
extern "C" int cosmos_flash_kv_cache_window(const void* q, const void* k_buf, const void* v_buf, void* out,
                                            void* partial_o, void* partial_lse, int B, int Sq, int S_max, int H,
                                            int kv_valid, int gh, int gw, int wh, int splits, float scale,
                                            void* stream) {
  if (gh < 1 || gw < 1 || wh < 1 || wh > gh || kv_valid % (gh * gw) || Sq % (gh * gw) || splits < 1 ||
      splits > kv_valid / (gh * gw) || (splits > 1 && (partial_o == nullptr || partial_lse == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int err = make_bshd_map(&mq, q, B, Sq, H, kBlockQ);
  if (!err) err = make_head_major_map(&mk, k_buf, B, H, kv_valid, S_max, kWindowBlockKV);
  if (!err) err = make_head_major_map(&mv, v_buf, B, H, kv_valid, S_max, kWindowBlockKV);
  if (err) return err;
  const Params p{static_cast<__nv_bfloat16*>(out), nullptr, static_cast<float*>(partial_o),
                 static_cast<float*>(partial_lse), Sq, kv_valid, H, 0, splits, gh, gw, wh, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool configured[kMaxDevices] = {};
  err = launch<kWindowBlockKV>(flash_kv_cache_window_kernel, configured, mq, mk, mv, p, B, st);
  if (err || splits == 1) return err;
  return combine(partial_o, partial_lse, out, static_cast<size_t>(B) * Sq * H, splits, st);
}

// dynamic shared memory a CTA of K1 or K5 (window 0) or of K6 (window 1) takes, in bytes
extern "C" int cosmos_flash_attention_fwd_smem_bytes(int window) {
  return window ? smem_bytes<kWindowBlockKV>() : smem_bytes<kBlockKV>();
}
