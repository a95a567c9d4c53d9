// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces cosmos_predict2_tpu/ops/flash_attention.py::_fwd_kernel (the
// Pallas TPU kernel driven by _fwd / flash_attention). Same contract:
// non-causal online-softmax attention, BSHD in and out, head_dim 128,
// scale 1/sqrt(128), output in bf16 and the row logsumexp `lse`
// (B, H, Sq) in fp32, the kv tail masked, and the optional frame-block
// mask (key i visible to query j iff i / frame_group <= j / frame_group)
// with fully masked kv tiles skipped. Masked logits take the finite value
// -1e30 like the TPU kernel (_NEG_INF), so exp(m_prev - m_new) never sees
// inf - inf.
//
// What bounds it on the H100: at the main-path shapes (Sq = Skv = 5,760 to
// 84,480 tokens, D = 128) the kernel does ~4*Skv*D FLOPs per query row
// against 2*D*2 bytes of that row's q and output, and re-reads K/V once per
// 64-row q tile: arithmetic intensity in the hundreds to thousands of
// FLOP/byte, far above the card's ~295 FLOP/byte line, so the bound is the
// tensor-core rate.
//
// Design (first, simple version): one block of 4 warps per (64-row q tile,
// head, batch). The q tile is staged in shared memory once and held in
// registers as mma.sync A fragments; a loop inside the block walks 64-row
// K/V tiles staged in shared memory (zero-filled past Skv). Each warp owns
// 16 query rows: S = Q K^T on the tensor cores in fp32, scale and masks,
// the online softmax in fp32 (row max / sum reduced across the 4 lanes of
// a quad), P rounded to bf16 and reused from registers as the A operand of
// O += P V, an fp32 accumulator rescaled per tile; O = acc / l and
// lse = m + log l at the end. The TPU's VMEM-driven block auto-pick is not
// carried over: tiles are fixed at 64 x 64 for 227 KB of shared memory and
// occupancy. wgmma, TMA and warp specialisation are later work.
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
constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;  // padded shared-memory row, in bf16 elements
constexpr float kNegInf = -1e30f;
constexpr int kSmemBytes = (kBlockQ + 2 * kBlockKV) * kLds * 2;

__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Skv, int H, int frame_group, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBlockQ * kLds;
  __nv_bfloat16* sV = sK + kBlockKV * kLds;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t seq_stride = static_cast<size_t>(H) * kD;  // elements between sequence positions
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * kD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Skv * H + h) * kD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Skv * H + h) * kD;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // ---- stage the q tile (rows past Sq are zero) ----
  for (int i = tid; i < kBlockQ * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = zero;
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(q0 + r) * seq_stride + c);
    *reinterpret_cast<uint4*>(sQ + r * kLds + c) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as A fragments, 8 k-steps of 16 over D
  uint32_t qf[kD / 16][4];
  {
    const __nv_bfloat16* p0 = sQ + (warp * 16 + g) * kLds + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const __nv_bfloat16* p = p0 + kk * 16;
      qf[kk][0] = ld_pair(p);
      qf[kk][1] = ld_pair(p + 8 * kLds);
      qf[kk][2] = ld_pair(p + 8);
      qf[kk][3] = ld_pair(p + 8 * kLds + 8);
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's partial row sums; quad-reduced at the end

  const int row0 = q0 + warp * 16 + g;  // query row of c[0], c[1]; row0 + 8 for c[2], c[3]
  const int rows[2] = {row0, row0 + 8};

  // frame-causal: kv tiles past the last frame group visible to any row
  // of this q tile are skipped (same bound as the TPU kernel)
  int kv_end = Skv;
  if (frame_group > 0) {
    const long long q_last = q0 + kBlockQ - 1;
    const long long max_visible = (q_last / frame_group) * frame_group + frame_group;
    if (max_visible < kv_end) kv_end = static_cast<int>(max_visible);
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBlockKV * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8);
      const int c = (i % (kD / 8)) * 8;
      uint4 kval = zero, vval = zero;
      if (kv0 + r < Skv) {
        const size_t off = static_cast<size_t>(kv0 + r) * seq_stride + c;
        kval = *reinterpret_cast<const uint4*>(kb + off);
        vval = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(sK + r * kLds + c) = kval;
      *reinterpret_cast<uint4*>(sV + r * kLds + c) = vval;
    }
    __syncthreads();

    // ---- S = Q K^T: 16 x 64 per warp, 8 n-tiles of 8 kv columns ----
    float s[kBlockKV / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kp = sK + (j * 8 + g) * kLds + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        mma_16816(s[j], qf[kk], ld_pair(kp + kk * 16), ld_pair(kp + kk * 16 + 8));
      }
    }

    // ---- scale, kv-tail and frame masks ----
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        const int row = rows[e >> 1];
        bool visible = col < Skv;
        if (frame_group > 0) visible = visible && (col / frame_group) <= (row / frame_group);
        s[j][e] = visible ? s[j][e] * scale : kNegInf;
      }
    }

    // ---- online softmax in fp32 ----
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
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
    for (int j = 0; j < kBlockKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m_run[e >> 1]);
        psum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + psum[r];
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // ---- O += P V: P (bf16) straight from registers as the A operand ----
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_float_pair(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_float_pair(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_float_pair(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_float_pair(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp = sV + (kk * 16 + 2 * t) * kLds + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const __nv_bfloat16* p = vp + n * 8;
        const uint32_t b0 = pack_pair(p[0], p[kLds]);
        const uint32_t b1 = pack_pair(p[8 * kLds], p[9 * kLds]);
        mma_16816(o[n], pa, b0, b1);
      }
    }
  }

  // ---- finalize: O = acc / l, lse = m + log l ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + (static_cast<size_t>(b) * Sq + row) * seq_stride + static_cast<size_t>(h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const uint32_t packed = pack_float_pair(o[n][2 * r] / l_run[r], o[n][2 * r + 1] / l_run[r]);
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = packed;
    }
    if (t == 0) lse[(static_cast<size_t>(b) * H + h) * Sq + row] = m_run[r] + logf(l_run[r]);
  }
}

}  // namespace

// q, k, v, out: (B, S, H, 128) bf16, contiguous, 16-byte aligned;
// lse: (B, H, Sq) fp32. Returns the CUDA error code (0 on success).
extern "C" int cosmos_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                                          int B, int Sq, int Skv, int H, int frame_group, float scale,
                                          void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, Skv,
      H, frame_group, scale);
  return static_cast<int>(cudaGetLastError());
}
