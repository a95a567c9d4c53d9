// Flash-attention backward for Hopper (sm_90a): dQ (K7) and dK/dV (K8),
// bf16 in, fp32 accumulate, bf16 out.
//
// Replaces cosmos_predict2_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (the Pallas TPU kernels driven by _bwd). Same contract:
// BSHD q/k/v/dO/dQ/dK/dV, head_dim 128, scale 1/sqrt(128), the forward's
// row logsumexp `lse` (B, H, Sq) and delta = rowsum(dO * O) (B, H, Sq),
// both fp32. With P = exp(scale * Q K^T - lse), dP = dO V^T and
// dS = P * (dP - delta):
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO.
// P is rounded to bf16 before P^T dO and dS before dS K and dS^T Q, as the
// TPU kernels do. Masked entries (kv tail, q tail, frame-block mask: key i
// visible to query j iff i / frame_group <= j / frame_group) take the
// finite logit -1e30 and an explicit P = 0, so they contribute exactly 0
// whatever lse holds; the tails of the tiles in shared memory are
// zero-filled so 0 * garbage cannot inject NaN. Fully masked tiles are
// skipped, the bound of each TPU kernel.
//
// What bounds them on the H100: K7 does 3 matrix products of 2*D FLOPs per
// (q, kv) pair (S, dP, dS K) and K8 four (S^T, dP^T, P^T dO, dS^T Q), against
// 2*D*2 bytes per q or kv row read once: at the main path's 5,760 tokens
// (and 512 text tokens for cross-attention) that is hundreds to thousands
// of FLOP per byte, far above the card's ~295 FLOP/byte line, so the bound
// is the tensor-core rate (6 and 8 * B*H*Sq*Skv*D FLOPs at 989 TFLOP/s).
//
// Design (first, simple version). The TPU kernels carry dq_acc, dk_acc and
// dv_acc across a sequential grid axis in VMEM; GPU blocks run in no order,
// so that axis becomes a loop inside one block and the accumulators live in
// registers. Two kernels, no atomics: results are deterministic.
// - K7: one block of 4 warps per (64-row q tile, head, batch). Q and dO tiles
//   sit in shared memory; a loop walks 64-row K/V tiles. Each warp owns 16 q
//   rows: S = Q K^T and dP = dO V^T on the tensor cores (mma.sync m16n8k16),
//   P and dS in fp32 registers, dS rounded to bf16 and reused from the
//   accumulator registers as the A operand of dQ += dS K (K as the B operand
//   by a transposed pair load from shared memory); 16 x 128 fp32 dQ per warp.
// - K8: one block of 4 warps per (64-row kv tile, head, batch). K and V tiles
//   sit in shared memory; a loop walks 32-row Q/dO tiles (with lse and delta
//   staged beside them). Each warp owns 16 kv rows and computes S^T = K Q^T
//   and dP^T = V dO^T directly with the kv rows as the M dimension, as the
//   TPU kernel does, so P^T and dS^T land in the accumulator layout and feed
//   dV += P^T dO and dK += dS^T Q as A operands straight from registers; dO
//   and Q are the B operands, read k-major by a transposed pair load. The q
//   tile is 32 rows so that dK and dV (2 x 16 x 128 fp32 per warp) and the
//   S^T / dP^T tiles fit the register file without spilling.
// wgmma, TMA, ldmatrix and warp specialisation are later work.
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
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;  // padded shared-memory row, in bf16 elements
constexpr float kNegInf = -1e30f;

// K7 tiles
constexpr int kDqBlockQ = 64;
constexpr int kDqBlockKV = 64;
constexpr int kDqSmemBytes = (2 * kDqBlockQ + 2 * kDqBlockKV) * kLds * 2;
// K8 tiles
constexpr int kDkvBlockKV = 64;
constexpr int kDkvBlockQ = 32;
constexpr int kDkvSmemBytes = (2 * kDkvBlockKV + 2 * kDkvBlockQ) * kLds * 2 + 2 * kDkvBlockQ * 4;

// rows [row0, row0 + rows) of a (S, H, D) sequence at head h into a padded
// shared tile; rows past `limit` are zero
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src_bh, size_t seq_stride,
                                           int row0, int rows, int limit, int tid) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < rows * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = zero;
    if (row0 + r < limit) val = *reinterpret_cast<const uint4*>(src_bh + static_cast<size_t>(row0 + r) * seq_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLds + c) = val;
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

__device__ __forceinline__ bool frame_visible(int key, int query, int frame_group) {
  return frame_group <= 0 || (key / frame_group) <= (query / frame_group);
}

// ------------------------------------ K7 ------------------------------------

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int frame_group, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + kDqBlockQ * kLds;
  __nv_bfloat16* sK = sdO + kDqBlockQ * kLds;
  __nv_bfloat16* sV = sK + kDqBlockKV * kLds;

  const int q0 = blockIdx.x * kDqBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t seq_stride = static_cast<size_t>(H) * kD;
  const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * kD;
  const size_t kv_off = (static_cast<size_t>(b) * Skv * H + h) * kD;

  stage_rows(sQ, q + q_off, seq_stride, q0, kDqBlockQ, Sq, tid);
  stage_rows(sdO, dout + q_off, seq_stride, q0, kDqBlockQ, Sq, tid);

  const int row0 = q0 + warp * 16 + g;  // query row of c[0], c[1]; row0 + 8 for c[2], c[3]
  const int rows[2] = {row0, row0 + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = rows[r] < Sq;
    const size_t idx = (static_cast<size_t>(b) * H + h) * Sq + (valid ? rows[r] : 0);
    lse_r[r] = valid ? lse[idx] : 0.f;
    delta_r[r] = valid ? delta[idx] : 0.f;
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // frame-causal: kv tiles past the last frame group visible to any row of
  // this q tile are skipped (the TPU kernel's bound)
  int kv_end = Skv;
  if (frame_group > 0) {
    const long long q_last = q0 + kDqBlockQ - 1;
    const long long max_visible = (q_last / frame_group) * frame_group + frame_group;
    if (max_visible < kv_end) kv_end = static_cast<int>(max_visible);
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kDqBlockKV) {
    __syncthreads();  // every warp is done with the previous K/V tile (and Q/dO are staged)
    stage_rows(sK, k + kv_off, seq_stride, kv0, kDqBlockKV, Skv, tid);
    stage_rows(sV, v + kv_off, seq_stride, kv0, kDqBlockKV, Skv, tid);
    __syncthreads();

    // ---- S = Q K^T and dP = dO V^T: 16 x 64 per warp ----
    float s[kDqBlockKV / 8][4], dp[kDqBlockKV / 8][4];
#pragma unroll
    for (int j = 0; j < kDqBlockKV / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, sQ, warp * 16, kk, g, t);
      load_a(da, sdO, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < kDqBlockKV / 8; ++j) {
        const int off = (j * 8 + g) * kLds + kk * 16 + 2 * t;
        mma_16816(s[j], qa, ld_pair(sK + off), ld_pair(sK + off + 8));
        mma_16816(dp[j], da, ld_pair(sV + off), ld_pair(sV + off + 8));
      }
    }

    // ---- P = exp(scale S - lse) with masks, dS = P (dP - delta), kept in s ----
#pragma unroll
    for (int j = 0; j < kDqBlockKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const bool visible = col < Skv && frame_visible(col, rows[r], frame_group);
        const float logit = visible ? s[j][e] * scale : kNegInf;
        const float p = visible ? __expf(logit - lse_r[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[r]);
      }
    }

    // ---- dQ += dS K: dS (bf16) from registers as the A operand ----
#pragma unroll
    for (int kk = 0; kk < kDqBlockKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_float_pair(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_float_pair(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_float_pair(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_float_pair(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* kp = sK + (kk * 16 + 2 * t) * kLds + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const __nv_bfloat16* p = kp + n * 8;
        mma_16816(acc[n], a, pack_pair(p[0], p[kLds]), pack_pair(p[8 * kLds], p[9 * kLds]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    __nv_bfloat16* drow = dq + q_off + static_cast<size_t>(rows[r]) * seq_stride;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(drow + n * 8 + 2 * t) =
          pack_float_pair(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

// ------------------------------------ K8 ------------------------------------

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                               int H, int frame_group, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kDkvBlockKV * kLds;
  __nv_bfloat16* sQ = sV + kDkvBlockKV * kLds;
  __nv_bfloat16* sdO = sQ + kDkvBlockQ * kLds;
  float* sLse = reinterpret_cast<float*>(sdO + kDkvBlockQ * kLds);
  float* sDelta = sLse + kDkvBlockQ;

  const int kv0 = blockIdx.x * kDkvBlockKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t seq_stride = static_cast<size_t>(H) * kD;
  const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * kD;
  const size_t kv_off = (static_cast<size_t>(b) * Skv * H + h) * kD;
  const float* lse_bh = lse + (static_cast<size_t>(b) * H + h) * Sq;
  const float* delta_bh = delta + (static_cast<size_t>(b) * H + h) * Sq;

  stage_rows(sK, k + kv_off, seq_stride, kv0, kDkvBlockKV, Skv, tid);
  stage_rows(sV, v + kv_off, seq_stride, kv0, kDkvBlockKV, Skv, tid);

  const int krow0 = kv0 + warp * 16 + g;  // kv row of c[0], c[1]; krow0 + 8 for c[2], c[3]
  const int krows[2] = {krow0, krow0 + 8};

  float acc_k[kD / 8][4], acc_v[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  // frame-causal: q tiles that end before the first query that can see this
  // kv tile are skipped (the TPU kernel's bound)
  int q_start = 0;
  if (frame_group > 0) q_start = ((kv0 / frame_group) * frame_group / kDkvBlockQ) * kDkvBlockQ;

  for (int qt0 = q_start; qt0 < Sq; qt0 += kDkvBlockQ) {
    __syncthreads();  // every warp is done with the previous Q/dO tile (and K/V are staged)
    stage_rows(sQ, q + q_off, seq_stride, qt0, kDkvBlockQ, Sq, tid);
    stage_rows(sdO, dout + q_off, seq_stride, qt0, kDkvBlockQ, Sq, tid);
    if (tid < kDkvBlockQ) {
      const bool valid = qt0 + tid < Sq;
      sLse[tid] = valid ? lse_bh[qt0 + tid] : 0.f;
      sDelta[tid] = valid ? delta_bh[qt0 + tid] : 0.f;
    }
    __syncthreads();

    // ---- S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 q columns per warp ----
    float st[kDkvBlockQ / 8][4], dpt[kDkvBlockQ / 8][4];
#pragma unroll
    for (int j = 0; j < kDkvBlockQ / 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, warp * 16, kk, g, t);
      load_a(va, sV, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < kDkvBlockQ / 8; ++j) {
        const int off = (j * 8 + g) * kLds + kk * 16 + 2 * t;
        mma_16816(st[j], ka, ld_pair(sQ + off), ld_pair(sQ + off + 8));
        mma_16816(dpt[j], va, ld_pair(sdO + off), ld_pair(sdO + off + 8));
      }
    }

    // ---- P^T (in st) and dS^T = P^T (dP^T - delta) (in dpt) ----
#pragma unroll
    for (int j = 0; j < kDkvBlockQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);  // q column within the tile
        const int qcol = qt0 + c;
        const int krow = krows[e >> 1];
        const bool visible = qcol < Sq && krow < Skv && frame_visible(krow, qcol, frame_group);
        const float logit = visible ? st[j][e] * scale : kNegInf;
        const float p = visible ? __expf(logit - sLse[c]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sDelta[c]);
      }
    }

    // ---- dV += P^T dO and dK += dS^T Q: A from registers, B by transposed pair loads ----
#pragma unroll
    for (int kk = 0; kk < kDkvBlockQ / 16; ++kk) {
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
      for (int n = 0; n < kD / 8; ++n) {
        const __nv_bfloat16* po = sdO + base + n * 8;
        const __nv_bfloat16* pq = sQ + base + n * 8;
        mma_16816(acc_v[n], pa, pack_pair(po[0], po[kLds]), pack_pair(po[8 * kLds], po[9 * kLds]));
        mma_16816(acc_k[n], da, pack_pair(pq[0], pq[kLds]), pack_pair(pq[8 * kLds], pq[9 * kLds]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krows[r] >= Skv) continue;
    const size_t off = kv_off + static_cast<size_t>(krows[r]) * seq_stride;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t) =
          pack_float_pair(acc_k[n][2 * r] * scale, acc_k[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t) = pack_float_pair(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

}  // namespace

// q, dout, dq: (B, Sq, H, 128) bf16; k, v: (B, Skv, H, 128) bf16; all
// contiguous and 16-byte aligned. lse, delta: (B, H, Sq) fp32. Returns the
// CUDA error code (0 on success).
extern "C" int cosmos_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                             const void* lse, const void* delta, void* dq, int B, int Sq, int Skv,
                                             int H, int frame_group, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDqSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kDqBlockQ - 1) / kDqBlockQ, H, B);
  flash_attention_bwd_dq_kernel<<<grid, kThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, frame_group, scale);
  return static_cast<int>(cudaGetLastError());
}

// as above; dk, dv: (B, Skv, H, 128) bf16.
extern "C" int cosmos_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                              const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                                              int Skv, int H, int frame_group, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + kDkvBlockKV - 1) / kDkvBlockKV, H, B);
  flash_attention_bwd_dkv_kernel<<<grid, kThreads, kDkvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Skv, H,
      frame_group, scale);
  return static_cast<int>(cudaGetLastError());
}
