// Row-windowed KV-cache decode attention (K6) for Hopper (sm_90a), bf16 in,
// fp32 accumulate.
//
// Replaces cosmos_predict2_tpu/ops/flash_attention.py::_fwd_cache_window_kernel
// (driven by _flash_kv_cache_window_impl / flash_attention_kv_cache_window):
// the queries of a new frame block, q (B, Sq, H, 128) token-major, attend
// over the first kv_valid positions of HEAD-MAJOR ring buffers k_buf / v_buf
// (B, H, S_max, 128); output (B, Sq, H, 128) bf16, no lse. q holds whole
// frames of a gh x gw token grid, row-major (frame, row, col), and the
// buffers' S axis is whole frames too. Query row yq sees, in every filled
// frame, the full-width key rows [s, s + wh) with s = clamp(yq - (wh-1)/2,
// 0, gh - wh). kv_valid is a whole number of frames (the wrapper checks).
// The dense cache decode (K5) is in flash_attention_fwd.cu.
//
// It rounds P to bf16 before P V, as the TPU kernel does, and gives masked
// entries an explicit P = 0, so a tile in which a row sees nothing adds
// nothing to it (the TPU window kernel's exp(-inf - -inf) gave NaN there,
// flash_attention.py:391).
//
// What bounds it on the H100: at the interactive path's steady state
// (352x640, cache 16 + 1 frames: Sq 880, kv_valid 14,960, B1 H16) with 7 of
// 22 rows it does a third of a dense decode's 1.08e11 FLOPs and reads the
// same 130 MB: memory bound on paper (0.039 ms at 3.35 TB/s).
//
// Design (first, simple version): one block of 4 warps per (64-row q tile,
// head, batch); the q tile staged once in shared memory and held as
// mma.sync A fragments; a loop over 64-row K/V tiles of the head's
// contiguous (S_max, 128) slice of the buffers (no relayout of the cache:
// the head-major layout is the one the kernel reads), staged in shared
// memory and zero-filled past the range's end; online softmax in fp32 per
// warp (16 query rows). It walks, in each filled frame, only the tiles of
// the rows that the union of the tile's windows covers: s() is monotone in
// the row, so that union is the contiguous row range [s(y_min), s(y_max) +
// wh), computed once per block; each thread computes its two rows' window
// bounds once, and the mask is two compares per element. Unlike the TPU
// kernel there is no band unrolling, so no band-divisor constraint on gh
// (the TPU banding went dense for a prime gh, flash_attention.py:357) and
// no gw % 8 rule.
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

__device__ __forceinline__ int window_start(int yq, int gh, int wh) {
  return min(max(yq - (wh - 1) / 2, 0), gh - wh);
}

__global__ void __launch_bounds__(kThreads)
flash_kv_cache_window_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_buf,
                             const __nv_bfloat16* __restrict__ v_buf, __nv_bfloat16* __restrict__ out, int Sq,
                             int S_max, int H, int kv_valid, int gh, int gw, int wh, float scale) {
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

  const size_t q_stride = static_cast<size_t>(H) * kD;  // q / out: token-major
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * kD;
  const size_t head = (static_cast<size_t>(b) * H + h) * static_cast<size_t>(S_max) * kD;  // buffers: head-major
  const __nv_bfloat16* kb = k_buf + head;
  const __nv_bfloat16* vb = v_buf + head;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // ---- stage the q tile (rows past Sq are zero) ----
  for (int i = tid; i < kBlockQ * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = zero;
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(q0 + r) * q_stride + c);
    *reinterpret_cast<uint4*>(sQ + r * kLds + c) = val;
  }
  __syncthreads();

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

  // in each of the kv_valid / F filled frames, the token range [seg_lo,
  // seg_hi) of the tile's window union; each row's own window [lo, hi) in
  // tokens from its frame's start (empty for a row past Sq)
  const int frame = gh * gw;
  const int n_frames = kv_valid / frame;
  int lo[2] = {0, 0}, hi[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < Sq) {
      const int s = window_start((rows[r] % frame) / gw, gh, wh);
      lo[r] = s * gw;
      hi[r] = (s + wh) * gw;
    }
  }
  const int first = q0, last = min(q0 + kBlockQ, Sq) - 1;
  int y_min = (first % frame) / gw, y_max = (last % frame) / gw;
  if (first / frame != last / frame) y_min = 0, y_max = gh - 1;  // the tile ends one frame and starts the next
  const int seg_lo = window_start(y_min, gh, wh) * gw;
  const int seg_hi = (window_start(y_max, gh, wh) + wh) * gw;

  for (int f = 0; f < n_frames; ++f) {
    const int base = f * frame;
    const int end = base + seg_hi;
    for (int kv0 = base + seg_lo; kv0 < end; kv0 += kBlockKV) {
      __syncthreads();  // every warp is done with the previous K/V tile
      for (int i = tid; i < kBlockKV * (kD / 8); i += kThreads) {
        const int r = i / (kD / 8);
        const int c = (i % (kD / 8)) * 8;
        uint4 kval = zero, vval = zero;
        if (kv0 + r < end) {
          const size_t off = static_cast<size_t>(kv0 + r) * kD + c;
          kval = *reinterpret_cast<const uint4*>(kb + off);
          vval = *reinterpret_cast<const uint4*>(vb + off);
        }
        *reinterpret_cast<uint4*>(sK + r * kLds + c) = kval;
        *reinterpret_cast<uint4*>(sV + r * kLds + c) = vval;
      }
      __syncthreads();

      // ---- S = Q K^T: 16 x 64 per warp ----
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

      // ---- scale and mask: the row window ----
#pragma unroll
      for (int j = 0; j < kBlockKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int local = kv0 + j * 8 + 2 * t + (e & 1) - base;
          const bool visible = local >= lo[e >> 1] && local < hi[e >> 1];
          s[j][e] = visible ? s[j][e] * scale : kNegInf;
        }
      }

      // ---- online softmax in fp32; masked entries give P = 0 exactly ----
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
        corr[r] = __expf(m_run[r] - m_new);  // both finite: 1 while a row has seen nothing
        m_run[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kBlockKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = s[j][e] == kNegInf ? 0.f : __expf(s[j][e] - m_run[e >> 1]);
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
  }

  // ---- finalize: O = acc / l (a row that saw nothing, only past Sq, gives 0) ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-20f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + (static_cast<size_t>(b) * Sq + row) * q_stride + static_cast<size_t>(h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const uint32_t packed = pack_float_pair(o[n][2 * r] / l_run[r], o[n][2 * r + 1] / l_run[r]);
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = packed;
    }
  }
}

}  // namespace

// K6. q, out: (B, Sq, H, 128) bf16; k_buf, v_buf: (B, H, S_max, 128) bf16;
// all contiguous and 16-byte aligned; Sq, S_max and kv_valid whole frames of
// gh * gw tokens, 0 < kv_valid <= S_max; wh = min(window_rows, gh) visible
// rows per query. Returns the CUDA error code (0 on success).
extern "C" int cosmos_flash_kv_cache_window(const void* q, const void* k_buf, const void* v_buf, void* out, int B,
                                            int Sq, int S_max, int H, int kv_valid, int gh, int gw, int wh,
                                            float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_kv_cache_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_kv_cache_window_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_buf),
      static_cast<const __nv_bfloat16*>(v_buf), static_cast<__nv_bfloat16*>(out), Sq, S_max, H, kv_valid, gh, gw,
      wh, scale);
  return static_cast<int>(cudaGetLastError());
}
