// Causal 3x3x3 conv as an implicit GEMM for Hopper (sm_90a), bf16 in,
// fp32 accumulate, bf16 out.
//
// Replaces cosmos_predict2_tpu/ops/conv3d.py::_conv_kernel_ring (the
// default streaming-VAE conv, driven by conv3d_causal_ring) and computes
// the same function as its siblings _conv_kernel (conv3d_causal_taps) and
// _conv_kernel_folded (conv3d_causal_folded). Contract: x (1, T_out + 2,
// H, W, Cin) NDHWC with the stream's 2 cached frames prepended, w
// (3, 3, 3, Cin, Cout) DHWIO, bias (Cout,) fp32; "valid" in time, SAME
// (pad 1) in space; the 27 tap products summed in fp32, plus the bias,
// rounded once to bf16: out (1, T_out, H, W, Cout).
//
// What bounds it on the H100: as a GEMM it is M = T_out*H*W output pixels,
// N = Cout, K = 27*Cin. At the VAE decoder's shapes (Cin, Cout in
// {96, 192, 384}) each output pixel costs 2*27*Cin*Cout FLOPs against
// ~2*(Cin + Cout) bytes of input and output, i.e. thousands of FLOP/byte,
// far above the ~295 FLOP/byte line: the bound is the tensor-core rate.
//
// Design (first, simple version): one block of 4 warps per (128-pixel
// tile of M, 64-channel tile of N). The block loops over the 27 taps and,
// inside each, over Cin in chunks of 32: it gathers the 128 x 32 activation
// slab of that tap into shared memory itself, zero-filling the spatial halo
// and the pixels past M, stages the 32 x 64 weight slab beside it, and
// accumulates with mma.sync m16n8k16 (each warp owns 32 pixels x 64
// channels). Only valid pixels are written. None of the TPU layout
// workarounds are carried over: no channel padding to 128, no W padding or
// roll, no W % 8 requirement, no frame ring; the kernel needs Cin and Cout
// to be multiples of 16. cp.async / TMA pipelining and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using cosmos_kernels::ld_pair;
using cosmos_kernels::mma_16816;
using cosmos_kernels::pack_float_pair;
using cosmos_kernels::pack_pair;

constexpr int kBlockM = 128;
constexpr int kBlockN = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 128;
constexpr int kLda = kBlockK + 8;  // padded rows (bf16 elements), 16-byte multiples
constexpr int kLdb = kBlockN + 8;

__global__ void __launch_bounds__(kThreads)
conv3d_causal_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int T_out, int H, int W,
                     int Cin, int Cout) {
  __shared__ __align__(16) __nv_bfloat16 sA[kBlockM * kLda];
  __shared__ __align__(16) __nv_bfloat16 sB[kBlockK * kLdb];

  const int HW = H * W;
  const int M = T_out * HW;
  const int m0 = blockIdx.x * kBlockM;
  const int n0 = blockIdx.y * kBlockN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // activation loader: this thread fills 8 channels (chunk cq) of the
  // pixel rows tid/4 + 32*r of the tile; their coordinates are fixed
  const int cq = (tid & 3) * 8;
  int pt[4], ph[4], pw[4];
  bool pvalid[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + (tid >> 2) + 32 * r;
    pvalid[r] = m < M;
    const int mm = pvalid[r] ? m : 0;
    pt[r] = mm / HW;
    const int rem = mm - pt[r] * HW;
    ph[r] = rem / W;
    pw[r] = rem - ph[r] * W;
  }

  float acc[2][kBlockN / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int tap = 0; tap < 27; ++tap) {
    const int dt = tap / 9;
    const int dh = (tap / 3) % 3 - 1;
    const int dw = tap % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += kBlockK) {
      __syncthreads();  // every warp is done with the previous slabs
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = c0 + cq;
        const int hh = ph[r] + dh;
        const int ww = pw[r] + dw;
        uint4 val = zero;
        if (pvalid[r] && c < Cin && hh >= 0 && hh < H && ww >= 0 && ww < W) {
          const size_t pix = (static_cast<size_t>(pt[r] + dt) * H + hh) * W + ww;
          val = *reinterpret_cast<const uint4*>(x + pix * Cin + c);
        }
        *reinterpret_cast<uint4*>(sA + ((tid >> 2) + 32 * r) * kLda + cq) = val;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = tid + kThreads * r;
        const int kr = i / (kBlockN / 8);
        const int nc = (i % (kBlockN / 8)) * 8;
        const int c = c0 + kr;
        const int n = n0 + nc;
        uint4 val = zero;
        if (c < Cin && n < Cout) val = *reinterpret_cast<const uint4*>(w + (static_cast<size_t>(tap) * Cin + c) * Cout + n);
        *reinterpret_cast<uint4*>(sB + kr * kLdb + nc) = val;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* ap = sA + (warp * 32 + mt * 16 + g) * kLda + kk * 16 + 2 * t;
          af[mt][0] = ld_pair(ap);
          af[mt][1] = ld_pair(ap + 8 * kLda);
          af[mt][2] = ld_pair(ap + 8);
          af[mt][3] = ld_pair(ap + 8 * kLda + 8);
        }
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) {
          const __nv_bfloat16* bp = sB + (kk * 16 + 2 * t) * kLdb + nt * 8 + g;
          const uint32_t b0 = pack_pair(bp[0], bp[kLdb]);
          const uint32_t b1 = pack_pair(bp[8 * kLdb], bp[9 * kLdb]);
          mma_16816(acc[0][nt], af[0], b0, b1);
          mma_16816(acc[1][nt], af[1], b0, b1);
        }
      }
    }
  }

  // ---- epilogue: + bias in fp32, one rounding to bf16, valid pixels only ----
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
    const int n = n0 + nt * 8 + 2 * t;
    if (n >= Cout) continue;
    const float b0 = bias[n];
    const float b1 = bias[n + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = m0 + warp * 32 + mt * 16 + g;
      if (m < M)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m) * Cout + n) =
            pack_float_pair(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      if (m + 8 < M)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m + 8) * Cout + n) =
            pack_float_pair(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
}

}  // namespace

// x: (1, T_out + 2, H, W, Cin) bf16; w: (3, 3, 3, Cin, Cout) bf16; bias:
// (Cout,) fp32; out: (1, T_out, H, W, Cout) bf16. All contiguous and
// 16-byte aligned, Cin and Cout multiples of 16. Returns the CUDA error
// code (0 on success).
extern "C" int cosmos_conv3d_causal(const void* x, const void* w, const void* bias, void* out, int T_out, int H,
                                    int W, int Cin, int Cout, void* stream) {
  const long long M = static_cast<long long>(T_out) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBlockM - 1) / kBlockM), (Cout + kBlockN - 1) / kBlockN);
  conv3d_causal_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), T_out, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}
