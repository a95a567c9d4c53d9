// Flash-attention backward for Hopper (sm_90a): dQ (K7) and dK/dV (K8),
// bf16 in, fp32 accumulate, bf16 out.
//
// Replaces cosmos_predict2_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (the Pallas TPU kernels driven by _bwd). Same contract:
// BSHD q/k/v/dO/dQ/dK/dV, head_dim 128, scale 1/sqrt(128), the forward's
// row logsumexp `lse` (B, H, Sq) and delta = rowsum(dO * O) (B, H, Sq),
// both fp32 and computed outside. With P = exp(scale * Q K^T - lse),
// dP = dO V^T and dS = P * (dP - delta):
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO.
// P is rounded to bf16 before P^T dO and dS before dS K and dS^T Q, as the
// TPU kernels do. Masked entries (kv tail, q tail, frame-block mask: key i
// visible to query j iff i / frame_group <= j / frame_group) take an
// explicit P = 0 (the finite logit -1e30 of the plain version), so they
// contribute exactly 0 whatever lse holds; TMA fills rows past the sequence
// with zeros, so 0 * garbage cannot inject NaN. Fully masked tiles are
// skipped, the bound of each TPU kernel. No atomics: results are
// deterministic.
//
// What bounds them on the H100: K7 does 3 matrix products of 2*D FLOPs per
// visible (q, kv) pair (S, dP, dS K) and K8 four (S^T, dP^T, P^T dO,
// dS^T Q), against 2*D*2 bytes per q or kv row read once: hundreds to
// thousands of FLOP per byte at the main path's 5,760 tokens (512 text
// tokens for cross-attention), far above the card's ~295 FLOP/byte line,
// so the bound is the tensor-core rate: 6 and 8 * B*H*pairs*D FLOPs at
// 989 TFLOP/s.
//
// Design (Hopper). Each kernel is warp-specialised: one producer warpgroup
// (setmaxnreg down to 24; one thread issues TMA loads) and two consumer
// warpgroups (setmaxnreg up to 240) that run wgmma. What the first version
// (mma.sync m16n8k16, 4 warps) lacked and what this one does about it:
// 1. Transposed operands: every tile lands in shared memory by TMA with the
//    128-byte swizzle, and wgmma reads it through a descriptor, K-major for
//    Q K^T-style products and MN-major (the transpose flag) for dS K,
//    P^T dO and dS^T Q: no scalar loads, no bank conflicts.
// 2. Overlap: the streamed operand goes through a ring of kStages buffers,
//    each with a "full" mbarrier (TMA transaction bytes) and an "empty" one
//    (one arrival per consumer warp); loads for the next tiles are in flight
//    while the consumers compute, and no __syncthreads is left in the loop.
// 3. Tensor cores: wgmma m64nNk16, asynchronous, with the fp32 products in
//    registers; P^T, dS^T and dS are rounded to bf16 in registers and fed
//    back as the register A operand (the accumulator layout is the A
//    fragment layout), never touching shared memory.
// 4. Work per synchronisation and occupancy: each consumer warpgroup owns
//    64 rows and each step is a 64 x 64 x 128 product pair plus a 64 x 128
//    x 64 pair, against 16 x 32 x 128 per warp before; one 384-thread CTA
//    per SM.
// - K7: one CTA per (128 q rows, head, batch). Q, dO, lse and delta are
//   loaded once; K and V stream in 64-row tiles. S = Q K^T and dP = dO V^T
//   (m64n64k16, both operands from shared memory), dS masked in registers,
//   dQ += dS K (m64n128k16, dS from registers, K MN-major). 128-row kv
//   tiles (twice the S and dP registers) and a third ring stage were no
//   faster at any shape scripts/flash_bwd_variants.py times (PERF.md §6),
//   so K7 takes 64 rows and both kernels two stages.
// - K8: one CTA per (128 kv rows, head, batch, q split). K and V are loaded
//   once; Q, dO, lse and delta stream in 64-row tiles. S^T = K Q^T and
//   dP^T = V dO^T put kv rows on the M side, so P^T and dS^T are the A
//   operands of dV += P^T dO and dK += dS^T Q (dO and Q MN-major); dK and
//   dV are 2 x 64 x 128 fp32 per warpgroup. When the (kv tile, head, batch)
//   grid is under one wave of the card, the wrapper splits each kv tile's q
//   range over `splits` CTAs (ops/flash_attention.py::dkv_split_plan, the
//   same chunks as dkv_q_chunk below); each writes fp32 partials and a
//   second kernel sums them in split order, scales dK and casts.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_bf16.cuh"

namespace {

using namespace cosmos_sm90;

constexpr int kD = 128;
constexpr int kConsumerThreads = 256;          // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // plus the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// K7: 128 q rows (two warpgroups of 64), 64-row kv tiles
constexpr int kDqBlockQ = 128;
constexpr int kDqBlockKV = 64;
struct DqSmem {
  alignas(1024) unsigned char q[Tile<kDqBlockQ>::kBytes];
  alignas(1024) unsigned char dout[Tile<kDqBlockQ>::kBytes];
  alignas(1024) unsigned char k[kStages][Tile<kDqBlockKV>::kBytes];
  alignas(1024) unsigned char v[kStages][Tile<kDqBlockKV>::kBytes];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// K8: 128 kv rows (two warpgroups of 64), 64-row q tiles
constexpr int kDkvBlockKV = 128;
constexpr int kDkvBlockQ = 64;
struct DkvSmem {
  alignas(1024) unsigned char k[Tile<kDkvBlockKV>::kBytes];
  alignas(1024) unsigned char v[Tile<kDkvBlockKV>::kBytes];
  alignas(1024) unsigned char q[kStages][Tile<kDkvBlockQ>::kBytes];
  alignas(1024) unsigned char dout[kStages][Tile<kDkvBlockQ>::kBytes];
  float lse[kStages][kDkvBlockQ];  // lse * log2(e)
  float delta[kStages][kDkvBlockQ];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// the q tiles [begin, end) (of 64 rows) that split `split` of kv tile
// `kv_tile` covers: the tiles from the first one a query of which sees the
// tile's first key, cut into `splits` runs of equal length (the last ones may
// be short or empty)
__device__ __forceinline__ void dkv_q_chunk(int kv_tile, int split, int splits, int Sq, int frame_group, int& begin,
                                            int& end) {
  const int q_tiles = (Sq + kDkvBlockQ - 1) / kDkvBlockQ;
  int first = 0;
  if (frame_group > 0) first = (kv_tile * kDkvBlockKV / frame_group) * frame_group / kDkvBlockQ;
  const int n = q_tiles > first ? q_tiles - first : 0;
  const int per = (n + splits - 1) / splits;
  begin = min(first + split * per, q_tiles);
  end = min(begin + per, q_tiles);
}

// ------------------------------------ K7 ------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int frame_group, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = smem_storage<DqSmem>(smem_raw);
  const int q0 = blockIdx.x * kDqBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  // frame-causal: kv tiles past the last frame group visible to any row of
  // this q tile are skipped (the TPU kernel's bound)
  int kv_end = Skv;
  if (frame_group > 0) {
    const int q_last = min(q0 + kDqBlockQ, Sq) - 1;
    kv_end = min(Skv, (q_last / frame_group + 1) * frame_group);
  }
  const int n_tiles = (kv_end + kDqBlockKV - 1) / kDqBlockKV;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      mbar_arrive_expect_tx(&sm.q_full, 2 * Tile<kDqBlockQ>::kBytes);
      tma_tile_bshd<kDqBlockQ>(sm.q, &map_q, &sm.q_full, q0, h, b);
      tma_tile_bshd<kDqBlockQ>(sm.dout, &map_do, &sm.q_full, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * Tile<kDqBlockKV>::kBytes);
        tma_tile_bshd<kDqBlockKV>(sm.k[s], &map_k, &sm.full[s], it * kDqBlockKV, h, b);
        tma_tile_bshd<kDqBlockKV>(sm.v[s], &map_v, &sm.full[s], it * kDqBlockKV, h, b);
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane / 4;
    const int t = lane % 4;
    const float scale_log2 = scale * kLog2e;
    int rows[2], kmax[2];
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = q0 + 64 * wg + 16 * warp + g + 8 * r;
      const bool valid = rows[r] < Sq;
      const size_t idx = (static_cast<size_t>(b) * H + h) * Sq + (valid ? rows[r] : 0);
      lse2[r] = valid ? lse[idx] * kLog2e : 0.f;
      dlt[r] = valid ? delta[idx] : 0.f;
      kmax[r] = frame_group > 0 ? min(Skv, (rows[r] / frame_group + 1) * frame_group) : Skv;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const int wg_off = 64 * wg * 128;  // this warpgroup's 64 rows in each Q / dO box

    mbar_wait(&sm.q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      mbar_wait(&sm.full[s], (it / kStages) & 1);

      // S = Q K^T and dP = dO V^T (64 x 64 per warpgroup)
      float sc[kDqBlockKV / 2], dp[kDqBlockKV / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int box = (kk / 4);
        wgmma_ss<0>(sc, kmajor_desc(sm.q + box * Tile<kDqBlockQ>::kBoxBytes + wg_off, kk % 4),
                              kmajor_desc(sm.k[s] + box * Tile<kDqBlockKV>::kBoxBytes, kk % 4), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int box = (kk / 4);
        wgmma_ss<0>(dp, kmajor_desc(sm.dout + box * Tile<kDqBlockQ>::kBoxBytes + wg_off, kk % 4),
                              kmajor_desc(sm.v[s] + box * Tile<kDqBlockKV>::kBoxBytes, kk % 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      fence_operands(dp);

      // dS = P (dP - delta), P = exp(scale S - lse) on visible entries, else 0
      const int kv0 = it * kDqBlockKV;
#pragma unroll
      for (int i = 0; i < kDqBlockKV / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int col = kv0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const float p = col < kmax[r] ? exp2f(sc[i] * scale_log2 - lse2[r]) : 0.f;
        sc[i] = p * (dp[i] - dlt[r]);
      }

      // dQ += dS K: dS (bf16) from registers, K MN-major
      uint32_t a[kDqBlockKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqBlockKV / 16; ++kk) a_fragment(a[kk], sc, kk);
      wgmma_fence();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < kDqBlockKV / 16; ++kk)
        wgmma_rs<1>(acc, a[kk], mnmajor_desc(sm.k[s], Tile<kDqBlockKV>::kBoxBytes, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    const size_t seq_stride = static_cast<size_t>(H) * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= Sq) continue;
      __nv_bfloat16* drow = dq + (static_cast<size_t>(b) * Sq + rows[r]) * seq_stride + static_cast<size_t>(h) * kD;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(drow + 8 * j + 2 * t) =
            pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ------------------------------------ K8 ------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               float* __restrict__ partial_k, float* __restrict__ partial_v, int B, int Sq, int Skv,
                               int H, int frame_group, int splits, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = smem_storage<DkvSmem>(smem_raw);
  const int kv0 = blockIdx.x * kDkvBlockKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  int tile_begin, tile_end;
  dkv_q_chunk(blockIdx.x, split, splits, Sq, frame_group, tile_begin, tile_end);
  const int n_tiles = tile_end - tile_begin;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes (lse and delta), one with the TMA bytes
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------ producer ------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && n_tiles > 0) {
      const float* lse_bh = lse + (static_cast<size_t>(b) * H + h) * Sq;
      const float* delta_bh = delta + (static_cast<size_t>(b) * H + h) * Sq;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.kv_full, 2 * Tile<kDkvBlockKV>::kBytes);
        tma_tile_bshd<kDkvBlockKV>(sm.k, &map_k, &sm.kv_full, kv0, h, b);
        tma_tile_bshd<kDkvBlockKV>(sm.v, &map_v, &sm.kv_full, kv0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int qt0 = (tile_begin + it) * kDkvBlockQ;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
#pragma unroll
        for (int r = lane; r < kDkvBlockQ; r += 32) {
          const bool valid = qt0 + r < Sq;
          sm.lse[s][r] = valid ? lse_bh[qt0 + r] * kLog2e : 0.f;
          sm.delta[s][r] = valid ? delta_bh[qt0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[s], 2 * Tile<kDkvBlockQ>::kBytes);
          tma_tile_bshd<kDkvBlockQ>(sm.q[s], &map_q, &sm.full[s], qt0, h, b);
          tma_tile_bshd<kDkvBlockQ>(sm.dout[s], &map_do, &sm.full[s], qt0, h, b);
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
    // kv rows of this thread's accumulator entries, and the first query that
    // sees each (past the sequence: none)
    int krows[2], qmin[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      krows[r] = kv0 + 64 * wg + 16 * warp + g + 8 * r;
      qmin[r] = krows[r] >= Skv ? 0x7fffffff : frame_group > 0 ? (krows[r] / frame_group) * frame_group : 0;
    }
    float acc_k[64], acc_v[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
    const int wg_off = 64 * wg * 128;  // this warpgroup's 64 rows in each K / V box

    if (n_tiles > 0) mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int qt0 = (tile_begin + it) * kDkvBlockQ;
      mbar_wait(&sm.full[s], (it / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T (64 kv x 64 q per warpgroup)
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int box = kk / 4;
        wgmma_ss<0>(st, kmajor_desc(sm.k + box * Tile<kDkvBlockKV>::kBoxBytes + wg_off, kk % 4),
                              kmajor_desc(sm.q[s] + box * Tile<kDkvBlockQ>::kBoxBytes, kk % 4), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int box = kk / 4;
        wgmma_ss<0>(dpt, kmajor_desc(sm.v + box * Tile<kDkvBlockKV>::kBoxBytes + wg_off, kk % 4),
                              kmajor_desc(sm.dout[s] + box * Tile<kDkvBlockQ>::kBoxBytes, kk % 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(st);
      fence_operands(dpt);

      // P^T (in st) and dS^T = P^T (dP^T - delta) (in dpt)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;  // q column within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[s][c]);
        const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[s][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int qcol = qt0 + c + (e & 1);
          const bool visible = qcol >= qmin[e >> 1] && qcol < Sq;
          const float p = visible ? exp2f(st[i] * scale_log2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
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
        wgmma_rs<1>(acc_v, pa[kk], mnmajor_desc(sm.dout[s], Tile<kDkvBlockQ>::kBoxBytes, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(acc_k, da[kk], mnmajor_desc(sm.q[s], Tile<kDkvBlockQ>::kBoxBytes, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc_v);
      fence_operands(acc_k);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    const size_t seq_stride = static_cast<size_t>(H) * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (krows[r] >= Skv) continue;
      const size_t off = (static_cast<size_t>(b) * Skv + krows[r]) * seq_stride + static_cast<size_t>(h) * kD;
      if (splits > 1) {
        const size_t part = static_cast<size_t>(split) * B * Skv * seq_stride + off;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<float2*>(partial_k + part + 8 * j + 2 * t) =
              make_float2(acc_k[4 * j + 2 * r], acc_k[4 * j + 2 * r + 1]);
          *reinterpret_cast<float2*>(partial_v + part + 8 * j + 2 * t) =
              make_float2(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
        }
      } else {
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
}

// K8's second pass on the split route: dK = scale * sum of the partials and
// dV = their sum, in split order, cast to bf16
__global__ void __launch_bounds__(256)
flash_attention_bwd_dkv_reduce_kernel(const float4* __restrict__ partial_k, const float4* __restrict__ partial_v,
                                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int splits,
                                      size_t n4, float scale) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 sk = partial_k[i], sv = partial_v[i];
    for (int s = 1; s < splits; ++s) {
      const float4 pk = partial_k[s * n4 + i], pv = partial_v[s * n4 + i];
      sk.x += pk.x, sk.y += pk.y, sk.z += pk.z, sk.w += pk.w;
      sv.x += pv.x, sv.y += pv.y, sv.z += pv.z, sv.w += pv.w;
    }
    *reinterpret_cast<uint2*>(dk + 4 * i) = make_uint2(pack_bf16(sk.x * scale, sk.y * scale),
                                                       pack_bf16(sk.z * scale, sk.w * scale));
    *reinterpret_cast<uint2*>(dv + 4 * i) = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  }
}

}  // namespace

extern "C" int cosmos_flash_attention_bwd_smem_bytes(int dkv);

// q, dout, dq: (B, Sq, H, 128) bf16; k, v: (B, Skv, H, 128) bf16; all
// contiguous and 16-byte aligned. lse, delta: (B, H, Sq) fp32. Returns the
// CUDA error code (0 on success).
extern "C" int cosmos_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                             const void* lse, const void* delta, void* dq, int B, int Sq, int Skv,
                                             int H, int frame_group, float scale, void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  int err = make_bshd_map(&mq, q, B, Sq, H, kDqBlockQ);
  if (!err) err = make_bshd_map(&mdo, dout, B, Sq, H, kDqBlockQ);
  if (!err) err = make_bshd_map(&mk, k, B, Skv, H, kDqBlockKV);
  if (!err) err = make_bshd_map(&mv, v, B, Skv, H, kDqBlockKV);
  if (err) return err;
  const int smem = cosmos_flash_attention_bwd_smem_bytes(0);
  static bool configured[kMaxDevices] = {};
  cudaError_t cerr = set_smem_once(reinterpret_cast<const void*>(flash_attention_bwd_dq_kernel), smem, configured);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((Sq + kDqBlockQ - 1) / kDqBlockQ, H, B);
  flash_attention_bwd_dq_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, frame_group, scale);
  return static_cast<int>(cudaGetLastError());
}

// as above; dk, dv: (B, Skv, H, 128) bf16. splits > 1: each kv tile's q
// range is cut into `splits` chunks whose fp32 partials go to partial_k and
// partial_v, (splits, B, Skv, H, 128) each, and a second kernel sums them.
extern "C" int cosmos_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                              const void* lse, const void* delta, void* dk, void* dv, void* partial_k,
                                              void* partial_v, int B, int Sq, int Skv, int H, int frame_group,
                                              int splits, float scale, void* stream) {
  CUtensorMap mq, mk, mv, mdo;
  int err = make_bshd_map(&mq, q, B, Sq, H, kDkvBlockQ);
  if (!err) err = make_bshd_map(&mdo, dout, B, Sq, H, kDkvBlockQ);
  if (!err) err = make_bshd_map(&mk, k, B, Skv, H, kDkvBlockKV);
  if (!err) err = make_bshd_map(&mv, v, B, Skv, H, kDkvBlockKV);
  if (err) return err;
  if (splits < 1 || (splits > 1 && (partial_k == nullptr || partial_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = cosmos_flash_attention_bwd_smem_bytes(1);
  static bool configured[kMaxDevices] = {};
  cudaError_t cerr = set_smem_once(reinterpret_cast<const void*>(flash_attention_bwd_dkv_kernel), smem, configured);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Skv + kDkvBlockKV - 1) / kDkvBlockKV, H, B * splits);
  flash_attention_bwd_dkv_kernel<<<grid, kThreads, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), static_cast<float*>(partial_k),
      static_cast<float*>(partial_v), B, Sq, Skv, H, frame_group, splits, scale);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess || splits == 1) return static_cast<int>(cerr);
  const size_t n4 = static_cast<size_t>(B) * Skv * H * kD / 4;
  const int blocks = static_cast<int>(std::min<size_t>((n4 + 255) / 256, 132 * 8));
  flash_attention_bwd_dkv_reduce_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float4*>(partial_k), static_cast<const float4*>(partial_v), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), splits, n4, scale);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory a CTA of K7 (dkv 0) or K8 (dkv 1) takes, in bytes
extern "C" int cosmos_flash_attention_bwd_smem_bytes(int dkv) {
  return static_cast<int>(dkv ? sizeof(DkvSmem) : sizeof(DqSmem)) + 1024;
}
