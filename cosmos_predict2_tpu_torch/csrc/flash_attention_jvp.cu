// Flash attention with a fused forward-mode derivative (JVP) for Hopper
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
// do = acc_t / l - (r / l) o, with o the fp32 quotient. P and P*dS are
// rounded to bf16 before their products with V and dV. The kv tail is
// masked; the optional frame-block mask (key i visible to query j iff
// i / frame_group <= j / frame_group) skips whole KV tiles past the last
// visible frame. Masked logits take the finite -1e30 like the TPU kernel,
// so P = 0 there; rows of k, dk, v and dv past Skv are zero-filled, so dS
// is finite (0) there and P*dS = 0, never 0 * NaN.
//
// What bounds it on the H100: six products of 2*Sq*Skv*D FLOPs per
// (batch, head): q k^T, dq k^T, q dk^T, P V, (P*dS) V, P dV, against the
// eight BSHD tensors read or written once. At the main-path shapes
// (Sq = Skv = 5,760 to 8,320, D = 128) that is thousands of FLOPs per
// byte, far above the card's ~295 FLOP/byte line: the bound is the
// tensor-core rate (12*B*H*Sq*Skv*D FLOPs at 989 TFLOP/s).
//
// Design (first, simple version), from K1 (flash_attention_fwd.cu): one
// block of 4 warps per (64-row q tile, head, batch); the q and dq tiles
// are staged in shared memory once; a loop inside the block walks 32-row
// tiles of k, dk, v and dv in shared memory (68 KB in all). Each warp
// owns 16 query rows. Two 16x128 fp32 accumulators (o and t, 128
// registers a thread) and the 16x32 s and ds tiles live in registers, so
// the q and dq A fragments are read from shared memory per 16-wide k-step
// instead of being held in registers as K1 holds q. KV tiles of 64 rows,
// as K1's, need 255 registers and spill (ptxas -v); 32 rows take 240 and
// none. S and dS on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate: dq k^T and q dk^T summed into one
// fragment), the online softmax in fp32 (row max, sum and r reduced
// across the 4 lanes of a quad at the end), P and P*dS rounded to bf16
// and reused from registers as the A operands of the three products with
// V and dV. wgmma, TMA and warp specialisation are later work.
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
constexpr int kBlockKV = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;  // padded shared-memory row, in bf16 elements
constexpr float kNegInf = -1e30f;
constexpr int kSmemBytes = (2 * kBlockQ + 4 * kBlockKV) * kLds * 2;

// rows [row0, row0 + rows) of one head of a BSHD tensor into shared memory,
// zero past `limit`
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int rows,
                                           int limit, size_t seq_stride, int tid) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < rows * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = zero;
    if (row0 + r < limit) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * seq_stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLds + c) = val;
  }
}

// this lane's A fragment (16 x 16, k-step kk) of a warp's 16 rows in shared memory
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* p) {
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * kLds);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * kLds + 8);
}

__global__ void __launch_bounds__(kThreads)
flash_attention_jvp_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dq,
                           const __nv_bfloat16* __restrict__ dk, const __nv_bfloat16* __restrict__ dv,
                           __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ dout, int Sq, int Skv, int H,
                           int frame_group, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdQ = sQ + kBlockQ * kLds;
  __nv_bfloat16* sK = sdQ + kBlockQ * kLds;
  __nv_bfloat16* sdK = sK + kBlockKV * kLds;
  __nv_bfloat16* sV = sdK + kBlockKV * kLds;
  __nv_bfloat16* sdV = sV + kBlockKV * kLds;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t seq_stride = static_cast<size_t>(H) * kD;  // elements between sequence positions
  const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * kD;
  const size_t kv_off = (static_cast<size_t>(b) * Skv * H + h) * kD;

  stage_rows(sQ, q + q_off, q0, kBlockQ, Sq, seq_stride, tid);
  stage_rows(sdQ, dq + q_off, q0, kBlockQ, Sq, seq_stride, tid);

  float acc_o[kD / 8][4], acc_t[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[n][e] = acc_t[n][e] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's partial row sums of P; quad-reduced at the end
  float r_run[2] = {0.f, 0.f};  // this lane's partial row sums of P*dS

  const int row0 = q0 + warp * 16 + g;  // query row of c[0], c[1]; row0 + 8 for c[2], c[3]
  const int rows[2] = {row0, row0 + 8};
  const int a_off = (warp * 16 + g) * kLds + 2 * t;

  // frame-causal: kv tiles past the last frame group visible to any row
  // of this q tile are skipped (same bound as the TPU kernel)
  int kv_end = Skv;
  if (frame_group > 0) {
    const long long q_last = q0 + kBlockQ - 1;
    const long long max_visible = (q_last / frame_group) * frame_group + frame_group;
    if (max_visible < kv_end) kv_end = static_cast<int>(max_visible);
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // every warp is done with the previous tiles (and the q tiles are staged)
    stage_rows(sK, k + kv_off, kv0, kBlockKV, Skv, seq_stride, tid);
    stage_rows(sdK, dk + kv_off, kv0, kBlockKV, Skv, seq_stride, tid);
    stage_rows(sV, v + kv_off, kv0, kBlockKV, Skv, seq_stride, tid);
    stage_rows(sdV, dv + kv_off, kv0, kBlockKV, Skv, seq_stride, tid);
    __syncthreads();

    // ---- S = Q K^T and dS = dQ K^T + Q dK^T: 16 x 32 per warp ----
    float s[kBlockKV / 8][4], ds[kBlockKV / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = ds[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4], dqa[4];
      load_a(qa, sQ + a_off + kk * 16);
      load_a(dqa, sdQ + a_off + kk * 16);
#pragma unroll
      for (int j = 0; j < kBlockKV / 8; ++j) {
        const int boff = (j * 8 + g) * kLds + 2 * t + kk * 16;
        const uint32_t kb0 = ld_pair(sK + boff), kb1 = ld_pair(sK + boff + 8);
        const uint32_t dkb0 = ld_pair(sdK + boff), dkb1 = ld_pair(sdK + boff + 8);
        mma_16816(s[j], qa, kb0, kb1);
        mma_16816(ds[j], dqa, kb0, kb1);
        mma_16816(ds[j], qa, dkb0, dkb1);
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
        ds[j][e] *= scale;
      }
    }

    // ---- online softmax in fp32; P into s, P*dS into ds ----
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], psum[2] = {0.f, 0.f}, rsum[2] = {0.f, 0.f};
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
        ds[j][e] *= s[j][e];
        psum[e >> 1] += s[j][e];
        rsum[e >> 1] += ds[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * corr[r] + psum[r];
      r_run[r] = r_run[r] * corr[r] + rsum[r];
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc_o[n][0] *= corr[0];
      acc_o[n][1] *= corr[0];
      acc_o[n][2] *= corr[1];
      acc_o[n][3] *= corr[1];
      acc_t[n][0] *= corr[0];
      acc_t[n][1] *= corr[0];
      acc_t[n][2] *= corr[1];
      acc_t[n][3] *= corr[1];
    }

    // ---- O += P V, T += (P*dS) V + P dV: P and P*dS (bf16) from registers as A ----
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      uint32_t pa[4], pda[4];
      pa[0] = pack_float_pair(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_float_pair(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_float_pair(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_float_pair(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      pda[0] = pack_float_pair(ds[2 * kk][0], ds[2 * kk][1]);
      pda[1] = pack_float_pair(ds[2 * kk][2], ds[2 * kk][3]);
      pda[2] = pack_float_pair(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
      pda[3] = pack_float_pair(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
      const int boff = (kk * 16 + 2 * t) * kLds + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const __nv_bfloat16* pv = sV + boff + n * 8;
        const __nv_bfloat16* pdv = sdV + boff + n * 8;
        const uint32_t vb0 = pack_pair(pv[0], pv[kLds]);
        const uint32_t vb1 = pack_pair(pv[8 * kLds], pv[9 * kLds]);
        const uint32_t dvb0 = pack_pair(pdv[0], pdv[kLds]);
        const uint32_t dvb1 = pack_pair(pdv[8 * kLds], pdv[9 * kLds]);
        mma_16816(acc_o[n], pa, vb0, vb1);
        mma_16816(acc_t[n], pda, vb0, vb1);
        mma_16816(acc_t[n], pa, dvb0, dvb1);
      }
    }
  }

  // ---- finalize: o = acc_o / l, do = acc_t / l - (r / l) o ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    r_run[r] += __shfl_xor_sync(0xffffffffu, r_run[r], 1);
    r_run[r] += __shfl_xor_sync(0xffffffffu, r_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= Sq) continue;
    const float inv_l = 1.f / l_run[r];
    const float rl = r_run[r] * inv_l;
    const size_t off = (static_cast<size_t>(b) * Sq + row) * seq_stride + static_cast<size_t>(h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const float o0 = acc_o[n][2 * r] * inv_l, o1 = acc_o[n][2 * r + 1] * inv_l;
      const float t0 = acc_t[n][2 * r] * inv_l - rl * o0, t1 = acc_t[n][2 * r + 1] * inv_l - rl * o1;
      *reinterpret_cast<uint32_t*>(out + off + n * 8 + 2 * t) = pack_float_pair(o0, o1);
      *reinterpret_cast<uint32_t*>(dout + off + n * 8 + 2 * t) = pack_float_pair(t0, t1);
    }
  }
}

}  // namespace

// q, dq, out, dout: (B, Sq, H, 128); k, v, dk, dv: (B, Skv, H, 128); all
// bf16, contiguous, 16-byte aligned. Returns the CUDA error code (0 on success).
extern "C" int cosmos_flash_attention_jvp(const void* q, const void* k, const void* v, const void* dq, const void* dk,
                                          const void* dv, void* out, void* dout, int B, int Sq, int Skv, int H,
                                          int frame_group, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_jvp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_jvp_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dq),
      static_cast<const __nv_bfloat16*>(dk), static_cast<const __nv_bfloat16*>(dv),
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(dout), Sq, Skv, H, frame_group, scale);
  return static_cast<int>(cudaGetLastError());
}
