// Flash attention with a fused forward-mode derivative (JVP, K9) for Hopper
// (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces cosmos_predict2_tpu/ops/flash_attention_jvp.py::_jvp_kernel (the
// Pallas TPU kernel driven by _jvp_bhsd under flash_attention_fwdmode's
// custom JVP). Same contract: BSHD in and out, head_dim 128, scale
// 1/sqrt(128); inputs q, k, v and their tangents dq, dk, dv; outputs the
// primal o and its tangent do in bf16. With s = scale q k^T and
// ds = scale (dq k^T + q dk^T), one online-softmax pass over the KV tiles
// keeps per query row
//   acc_o += P V,   acc_t += (P*dS) V + P dV,   l, m, r = sum P*dS,
// all rescaled by exp(m_prev - m_new); at the end o = acc_o / l and
// do = acc_t / l - (r / l) o, with o the fp32 quotient (JAX
// flash_attention_jvp.py:111-116). P and P*dS are rounded to bf16 before
// their products with V and dV. The kv tail is masked; the optional
// frame-block mask (key i visible to query j iff i / frame_group <=
// j / frame_group) skips whole KV tiles past the last visible frame. Masked
// logits take the finite -1e30 like the TPU kernel, with an explicit P = 0;
// rows of k, dk, v and dv past Skv are zero-filled by TMA, so dS is finite
// (0) there and P*dS = 0, never 0 * NaN.
//
// What bounds it on the H100: six products of 2*Sq*Skv*D FLOPs per
// (batch, head): q k^T, dq k^T, q dk^T, P V, (P*dS) V, P dV, against the
// eight BSHD tensors read or written once. At the main-path shapes
// (Sq = Skv = 5,760 to 8,320, D = 128) that is thousands of FLOPs per
// byte, far above the card's ~295 FLOP/byte line: the bound is the
// tensor-core rate (12*B*H*Sq*Skv*D FLOPs at 989 TFLOP/s).
//
// Design: K1's warp-specialised body (flash_attention_fwd.cu; helpers in
// sm90_bf16.cuh). What the first version (4 warps of mma.sync on 64-row q
// tiles, 32-row kv tiles staged synchronously with two __syncthreads per
// tile, the q and dq A fragments re-read from shared memory at every
// k-step, V's and dV's B operands built from scalar pairs; 19% of the bf16
// peak) lacked, and what this one does about it:
// 1. Overlap. One CTA per (128 q rows, head, batch) of 384 threads: a
//    producer warpgroup (setmaxnreg down to 24; one thread starts the TMA copies) and
//    two consumer warpgroups of 64 q rows (setmaxnreg up to 240). The q and
//    dq tiles are loaded once; k, dk, v and dv stream through a ring of
//    kStages stages, each tile on its own "full" mbarrier (S starts while
//    dK, V and dV land), with one "empty" mbarrier per stage (one arrival
//    per consumer warp). No __syncthreads in the kv loop.
// 2. Tensor cores, operands in place. S = Q K^T and dS = dQ K^T + Q dK^T
//    (two products into one accumulator) are wgmma m64n64k16 with both
//    operands K-major in shared memory: q and dq are never held in
//    registers. P and P*dS, rounded to bf16 in registers, are the register
//    A operands of acc_o += P V, acc_t += (P*dS) V and acc_t += P dV
//    (m64n128k16, V and dV MN-major).
// 3. The register budget. Per consumer thread acc_o and acc_t take 64 + 64
//    fp32 registers and S and dS over a 64-row kv tile 32 + 32; the bf16
//    fragments replace S and dS. 64-row kv tiles fit under 240 registers;
//    128-row ones would not. Shared memory: q + dq 64 KB, two stages of
//    64-row k, dk, v, dv 128 KB. S and dS are committed as two groups, so
//    the softmax of S runs while dS is in flight: in one group ptxas spilled
//    (20 bytes) and it was no faster; one consumer warpgroup per CTA was
//    26-36% slower (scripts/jvp_variants.py).
// 4. Masks only where needed, as K1: the kv-tail mask on the tile holding
//    the end of the keys, the frame mask on the tiles past the keys that
//    every row of a warpgroup sees; tiles no row of a warpgroup sees are
//    released without computing, those no row of the CTA sees not loaded.
// 5. Epilogue. o and do, rounded to bf16, are staged in the warpgroup's own
//    rows of the q and dq tiles and written with 16-byte stores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_bf16.cuh"

namespace {

using namespace cosmos_sm90;

constexpr int kD = 128;
constexpr int kConsumerWGs = 2;  // of 64 q rows each
constexpr bool kTwoGroups = true;  // S and dS committed apart, the softmax of S while dS is in flight
constexpr int kBlockQ = 64 * kConsumerWGs;
constexpr int kBlockKV = 64;
constexpr int kStages = 2;
constexpr int kConsumerThreads = 128 * kConsumerWGs;
constexpr int kThreads = kConsumerThreads + 128;  // plus the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

struct Smem {
  alignas(1024) unsigned char q[Tile<kBlockQ>::kBytes];   // the q tile, then each warpgroup's o rows
  alignas(1024) unsigned char dq[Tile<kBlockQ>::kBytes];  // the dq tile, then each warpgroup's do rows
  alignas(1024) unsigned char k[kStages][Tile<kBlockKV>::kBytes];
  alignas(1024) unsigned char dk[kStages][Tile<kBlockKV>::kBytes];
  alignas(1024) unsigned char v[kStages][Tile<kBlockKV>::kBytes];
  alignas(1024) unsigned char dv[kStages][Tile<kBlockKV>::kBytes];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t dk_full[kStages];
  uint64_t v_full[kStages];
  uint64_t dv_full[kStages];
  uint64_t empty[kStages];
};

constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;

struct Params {
  __nv_bfloat16* out;   // (B, Sq, H, 128)
  __nv_bfloat16* dout;  // (B, Sq, H, 128)
  int Sq;
  int Skv;
  int H;
  int frame_group;  // 0: none
  float scale;
};

// D (64 x 64) += A B^T over the head dimension, A this warpgroup's 64 rows
// of a q-sized tile and B a kv tile, both K-major; scale_d 0 for the first
// product into D
__device__ __forceinline__ void mma_logits(float (&d)[kBlockKV / 2], const unsigned char* a, const unsigned char* b,
                                             bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int box = kk / 4;
    wgmma_ss<0>(d, kmajor_desc(a + box * Tile<kBlockQ>::kBoxBytes, kk % 4),
                kmajor_desc(b + box * Tile<kBlockKV>::kBoxBytes, kk % 4), accumulate || kk > 0);
  }
}

// D += P X with P (bf16) from registers and X a kv tile, MN-major
__device__ __forceinline__ void mma_px(float (&d)[64], const uint32_t (&pa)[kBlockKV / 16][4],
                                         const unsigned char* x) {
#pragma unroll
  for (int kk = 0; kk < kBlockKV / 16; ++kk) wgmma_rs<1>(d, pa[kk], mnmajor_desc(x, Tile<kBlockKV>::kBoxBytes, kk), 1);
}

// `vals` in bf16 into this warpgroup's 64 rows of a staged tile (chunk c of
// row r at chunk c ^ (r % 8) of its box)
__device__ __forceinline__ void stage_rows(unsigned char* stage, int warp, int g, int t, const float (&vals)[64]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row_l = 16 * warp + g + 8 * r;
      *reinterpret_cast<uint32_t*>(stage + (j / 8) * Tile<kBlockQ>::kBoxBytes + row_l * 128 +
                                   (((j % 8) ^ (row_l % 8)) * 16) + 4 * t) =
          pack_bf16(vals[4 * j + 2 * r], vals[4 * j + 2 * r + 1]);
    }
  }
}

// this warpgroup's 64 staged rows to (B, Sq, H, 128) with 16-byte stores
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const unsigned char* stage, const Params& p, int b,
                                           int h, int row0) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int idx = n * 128 + tid;
    const int row_l = idx / 16, c16 = idx % 16;
    const int row = row0 + row_l;
    if (row >= p.Sq) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(stage + (c16 / 8) * Tile<kBlockQ>::kBoxBytes + row_l * 128 +
                                                      (((c16 % 8) ^ (row_l % 8)) * 16));
    *reinterpret_cast<uint4*>(dst + ((static_cast<size_t>(b) * p.Sq + row) * p.H + h) * kD + 8 * c16) = val;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_jvp_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_dq,
                           const __grid_constant__ CUtensorMap map_dk, const __grid_constant__ CUtensorMap map_dv,
                           const Params p) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = smem_storage<Smem>(smem_raw);
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int fg = p.frame_group;

  // the kv tiles this CTA walks: [0, n_tiles); past the last frame group any
  // row of this q tile sees: skipped
  int n_tiles = (p.Skv + kBlockKV - 1) / kBlockKV;
  if (fg > 0) {
    const int q_last = min(q0 + kBlockQ, p.Sq) - 1;
    n_tiles = (min(p.Skv, (q_last / fg + 1) * fg) + kBlockKV - 1) / kBlockKV;
  }

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.dk_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.dv_full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumerWGs) {
    // ------------------------------ producer ------------------------------
    if (kConsumerWGs == 2) setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      mbar_arrive_expect_tx(&sm.q_full, 2 * Tile<kBlockQ>::kBytes);
      tma_tile_bshd<kBlockQ>(sm.q, &map_q, &sm.q_full, q0, h, b);
      tma_tile_bshd<kBlockQ>(sm.dq, &map_dq, &sm.q_full, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int row = it * kBlockKV;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.k_full[s], Tile<kBlockKV>::kBytes);
        mbar_arrive_expect_tx(&sm.dk_full[s], Tile<kBlockKV>::kBytes);
        mbar_arrive_expect_tx(&sm.v_full[s], Tile<kBlockKV>::kBytes);
        mbar_arrive_expect_tx(&sm.dv_full[s], Tile<kBlockKV>::kBytes);
        tma_tile_bshd<kBlockKV>(sm.k[s], &map_k, &sm.k_full[s], row, h, b);
        tma_tile_bshd<kBlockKV>(sm.dk[s], &map_dk, &sm.dk_full[s], row, h, b);
        tma_tile_bshd<kBlockKV>(sm.v[s], &map_v, &sm.v_full[s], row, h, b);
        tma_tile_bshd<kBlockKV>(sm.dv[s], &map_dv, &sm.dv_full[s], row, h, b);
      }
    }
    return;
  }

  // ------------------------------- consumers --------------------------------
  if (kConsumerWGs == 2) setmaxnreg_inc<kConsumerRegs>();
  const int g = lane / 4;
  const int t = lane % 4;
  const float scale_log2 = p.scale * kLog2e;
  const int wg_row0 = q0 + 64 * wg;
  // the end of the keys each of this thread's two query rows sees
  int kmax[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg_row0 + 16 * warp + g + 8 * r;
    kmax[r] = fg > 0 ? min(p.Skv, (row / fg + 1) * fg) : p.Skv;
  }
  // keys below wg_full are seen by every row of this warpgroup (no mask);
  // keys at or past wg_end by none of them (the tile is released unused)
  int wg_full = p.Skv, wg_end = p.Skv;
  if (fg > 0) {
    const int last = min(wg_row0 + 64, p.Sq) - 1;
    wg_full = min(p.Skv, (wg_row0 / fg + 1) * fg);
    wg_end = last < wg_row0 ? 0 : min(p.Skv, (last / fg + 1) * fg);
  }
  const int n_wg = min(n_tiles, (wg_end + kBlockKV - 1) / kBlockKV);
  const unsigned char* q_rows = sm.q + 64 * wg * 128;  // this warpgroup's 64 rows in each box
  const unsigned char* dq_rows = sm.dq + 64 * wg * 128;

  float o[64], tg[64];  // acc_o and acc_t
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = tg[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // running row max of the logits times scale * log2(e)
  float l_run[2] = {0.f, 0.f};          // this lane's part of the running row sum of P
  float r_run[2] = {0.f, 0.f};          // and of P*dS
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  };

  mbar_wait(&sm.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    if (it >= n_wg) {  // a tile no row of this warpgroup sees
      mbar_wait(&sm.k_full[s], parity);
      mbar_wait(&sm.dk_full[s], parity);
      mbar_wait(&sm.v_full[s], parity);
      mbar_wait(&sm.dv_full[s], parity);
      release(s);
      continue;
    }
    const int kv0 = it * kBlockKV;
    const bool masked = kv0 + kBlockKV > wg_full;
    auto visible = [&](int i) { return kv0 + 8 * (i >> 2) + 2 * t + (i & 1) < kmax[(i >> 1) & 1]; };

    // ---- S = Q K^T and dS = dQ K^T + Q dK^T ----
    // (every wait comes before the products it feeds: a wait between two
    // products would make ptxas serialise them)
    float sc[kBlockKV / 2], ds[kBlockKV / 2];
    mbar_wait(&sm.k_full[s], parity);
    mbar_wait(&sm.dk_full[s], parity);
    wgmma_fence();
    mma_logits(sc, q_rows, sm.k[s], false);
    if (kTwoGroups) wgmma_commit();
    mma_logits(ds, dq_rows, sm.k[s], false);
    mma_logits(ds, q_rows, sm.dk[s], true);
    wgmma_commit();
    if (kTwoGroups) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
      fence_operands(ds);
    }
    fence_operands(sc);

    // ---- online softmax in fp32: P into sc ----
    if (masked) {
#pragma unroll
      for (int i = 0; i < kBlockKV / 2; ++i)
        if (!visible(i)) sc[i] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf}, corr[2];
#pragma unroll
    for (int i = 0; i < kBlockKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      corr[r] = exp2_approx(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f}, rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBlockKV / 2; ++i) {
      float pv = exp2_approx(fmaf(sc[i], scale_log2, -m_run[(i >> 1) & 1]));
      if (masked && !visible(i)) pv = 0.f;
      sc[i] = pv;
      psum[(i >> 1) & 1] += pv;
    }
    if (kTwoGroups) {
      wgmma_wait<0>();
      fence_operands(ds);
    }
    // ---- P*dS into ds ----
#pragma unroll
    for (int i = 0; i < kBlockKV / 2; ++i) {
      ds[i] *= sc[i] * p.scale;
      rsum[(i >> 1) & 1] += ds[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * corr[r] + psum[r];
      r_run[r] = r_run[r] * corr[r] + rsum[r];
    }
    uint32_t pa[kBlockKV / 16][4], pda[kBlockKV / 16][4];  // P and P*dS (bf16) as register A operands
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      a_fragment(pa[kk], sc, kk);
      a_fragment(pda[kk], ds, kk);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {  // after the fragments, so that S and dS are dead
      o[i] *= corr[(i >> 1) & 1];
      tg[i] *= corr[(i >> 1) & 1];
    }

    // ---- acc_o += P V, acc_t += (P*dS) V + P dV ----
    mbar_wait(&sm.v_full[s], parity);
    mbar_wait(&sm.dv_full[s], parity);
    wgmma_fence();
    fence_operands(o);
    fence_operands(tg);
    mma_px(o, pa, sm.v[s]);
    mma_px(tg, pda, sm.v[s]);
    mma_px(tg, pa, sm.dv[s]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(tg);
    release(s);
  }

  // -------------------------------- epilogue --------------------------------
  // o = acc_o / l and do = acc_t / l - (r / l) o, with o the fp32 quotient
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    r_run[r] += __shfl_xor_sync(0xffffffffu, r_run[r], 1);
    r_run[r] += __shfl_xor_sync(0xffffffffu, r_run[r], 2);
    l_run[r] = 1.f / l_run[r];  // now 1 / l
    r_run[r] *= l_run[r];       // now r / l
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    o[i] *= l_run[r];
    tg[i] = tg[i] * l_run[r] - r_run[r] * o[i];
  }
  named_barrier_sync(1 + wg, 128);  // every warp of the warpgroup is done reading its q and dq rows
  unsigned char* stage_o = sm.q + 64 * wg * 128;
  unsigned char* stage_do = sm.dq + 64 * wg * 128;
  stage_rows(stage_o, warp, g, t, o);
  stage_rows(stage_do, warp, g, t, tg);
  named_barrier_sync(1 + wg, 128);
  store_rows(p.out, stage_o, p, b, h, wg_row0);
  store_rows(p.dout, stage_do, p, b, h, wg_row0);
}

}  // namespace

// q, dq, out, dout: (B, Sq, H, 128); k, v, dk, dv: (B, Skv, H, 128); all
// bf16, contiguous, 16-byte aligned. Returns the CUDA error code (0 on success).
extern "C" int cosmos_flash_attention_jvp(const void* q, const void* k, const void* v, const void* dq, const void* dk,
                                          const void* dv, void* out, void* dout, int B, int Sq, int Skv, int H,
                                          int frame_group, float scale, void* stream) {
  CUtensorMap mq, mk, mv, mdq, mdk, mdv;
  int err = make_bshd_map(&mq, q, B, Sq, H, kBlockQ);
  if (!err) err = make_bshd_map(&mdq, dq, B, Sq, H, kBlockQ);
  if (!err) err = make_bshd_map(&mk, k, B, Skv, H, kBlockKV);
  if (!err) err = make_bshd_map(&mdk, dk, B, Skv, H, kBlockKV);
  if (!err) err = make_bshd_map(&mv, v, B, Skv, H, kBlockKV);
  if (!err) err = make_bshd_map(&mdv, dv, B, Skv, H, kBlockKV);
  if (err) return err;
  static bool configured[kMaxDevices] = {};
  const cudaError_t set =
      set_smem_once(reinterpret_cast<const void*>(flash_attention_jvp_kernel), kSmemBytes, configured);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Params p{static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(dout), Sq, Skv, H, frame_group, scale};
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_jvp_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, mdq, mdk,
                                                                                                mdv, p);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory a CTA of K9 takes, in bytes
extern "C" int cosmos_flash_attention_jvp_smem_bytes() { return kSmemBytes; }
