// Causal 3x3x3 conv as an implicit GEMM for Hopper (sm_90a), bf16 in,
// fp32 accumulate, bf16 out.
//
// Replaces cosmos_predict2_tpu/ops/conv3d.py::_conv_kernel_ring (the
// default streaming-VAE conv, driven by conv3d_causal_ring) and computes
// the same function as its siblings _conv_kernel (conv3d_causal_taps) and
// _conv_kernel_folded (conv3d_causal_folded). Contract: x (1, T_out + 2,
// H, W, Cin) NDHWC with the stream's 2 cached frames prepended, the weights
// K-major per tap, (27, Cout, Cin) (ops/conv3d.py::conv_weight_taps of the
// (3, 3, 3, Cin, Cout) DHWIO weight; tap = 9 dt + 3 dh + dw), bias (Cout,)
// fp32; "valid" in time, SAME (pad 1) in space; the 27 tap products summed
// in fp32, plus the bias, rounded once to bf16: out (1, T_out, H, W, Cout).
//
// What bounds it on the H100: as a GEMM it is M = T_out*H*W output pixels,
// N = Cout, K = 27*Cin, thousands of FLOPs per byte of device memory at the
// VAE's shapes (Cin, Cout in {96, 192, 384}): the bound is the tensor-core
// rate. But the operands come through L2: with each tap's A operand loaded
// as its own box, a (tap, 32-channel chunk) step of an M x N tile reads
// M*C + N*C bf16 for 2*M*N*C FLOPs, M*N/(M+N) FLOPs per byte (55 at
// M = 128, N = 96), and that version (TMA box moved per tap, both operands
// from shared memory) stopped at 31% of the bf16 peak at the 96-channel
// shapes on an H100, L2's rate (PERF.md). This one reads A once per 9
// taps.
//
// Design (warp-specialised, the shape of K1, K7 and K8; helpers in
// sm90_bf16.cuh):
// 1. One producer warpgroup (setmaxnreg down to 24; one thread issues TMA)
//    and two consumer warpgroups (up to 240) that run wgmma. Two rings of
//    shared-memory stages with "full" (TMA bytes) and "empty" (one arrival
//    per consumer warp) mbarriers: the slabs, and the weights per (tap,
//    chunk); no __syncthreads in the loop. CTAs are persistent, one per
//    SM, and walk the tiles, so a tile's epilogue overlaps the next tile's
//    loads.
// 2. The M tile is a BH x BW rectangle of one output frame (8 x 16 or
//    16 x 8, ops/conv3d.py::conv_plan's choice; 64 pixels per consumer
//    warpgroup). For each input frame dt and 32-channel chunk, one TMA box
//    brings the halo'd slab, (BH + 2) x (BW + 2) pixels from (h0 - 1,
//    w0 - 1), from a 4-d tensor map over (Cin, W, H, T_in). TMA's zero fill
//    outside H and W, negative coordinates included, is the SAME padding
//    and the ragged H and W tails: there is no gather code.
// 3. The 9 spatial taps' A operands come from the slab by ldmatrix into
//    wgmma's register A operand: each lane gives its own row's address,
//    (i + dh) (BW + 2) + j + dw, with the 64-byte swizzle's XOR applied by
//    hand. A batch of taps is loaded while no product is in flight and
//    their products are then issued back to back (a register an
//    asynchronous product reads is rewritten only after it completes;
//    otherwise ptxas serialises the products).
// 4. Channels go in chunks of 32 (64-byte rows under the 64-byte swizzle),
//    so Cin = 96 is three chunks and is never padded to 128; a Cin that is
//    an odd multiple of 16 reads a last chunk half of zeros.
// 5. The B operand is the weights' (tap, chunk) box of N rows x 32
//    channels, K-major. N is all of Cout up to 256 in one wgmma m64nNk16
//    (one instantiation per N: 64, 80, 96, 128, 192, 256); Cout = 384
//    takes 2 x 192, Cout = 80 N = 80: no column is computed for nothing at
//    the VAE's widths.
// 6. Epilogue: the bias in fp32, one rounding to bf16, and stores of the
//    pixels inside H and W and the columns below Cout only. No atomics: the
//    result is the same bits on every call.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_bf16.cuh"

namespace {

using namespace cosmos_sm90;

constexpr int kTaps = 27;
constexpr int kChunk = 32;                 // input channels per step
constexpr int kRowBytes = kChunk * 2;      // one pixel's (or output channel's) row of a chunk
constexpr int kBlockM = 128;               // output pixels of a tile
constexpr int kConsumerThreads = 256;      // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // plus the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRingBytes = 200 * 1024;  // shared memory given to the two rings
constexpr int kMaxStages = 16;     // weight stages

// the slab: the halo'd (BH + 2) x (BW + 2) = 180 pixels of one frame and
// chunk, loaded once for the 9 spatial taps
constexpr int kSlabBytes = 180 * kRowBytes;
constexpr int kSlabSlotBytes = 12 * 1024;  // a slot, rounded to the 1,024-byte alignment
constexpr int kSlabStages = 2;
constexpr int kSlabBatchTaps = 9;  // taps whose A operands are loaded together (a divisor of 9)

template <int N>
struct ConvSmem {
  static constexpr int kBBytes = N * kRowBytes;
  static constexpr int kFit = (kRingBytes - kSlabStages * kSlabSlotBytes) / kBBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  alignas(1024) unsigned char slab[kSlabStages][kSlabSlotBytes];
  alignas(1024) unsigned char b[kStages][kBBytes];
  uint64_t slab_full[kSlabStages];
  uint64_t slab_empty[kSlabStages];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

struct ConvGeom {
  int T_out, H, W, Cin, Cout;
  int box_w_log2;  // BW = 1 << box_w_log2, BH = 128 >> box_w_log2
  int tiles_h, tiles_w, n_split, num_tiles, chunks;
};

// tile -> output frame t, the rectangle's corner (h0, w0) and first output
// channel n0; the N split is innermost, so the CTAs that read the same
// slabs run side by side
__device__ __forceinline__ void decode_tile(const ConvGeom& geo, int tile, int n, int& t, int& h0, int& w0, int& n0) {
  const int m = tile / geo.n_split;
  n0 = (tile - m * geo.n_split) * n;
  const int per_frame = geo.tiles_h * geo.tiles_w;
  t = m / per_frame;
  const int r = m - t * per_frame;
  const int th = r / geo.tiles_w;
  h0 = th << (7 - geo.box_w_log2);
  w0 = (r - th * geo.tiles_w) << geo.box_w_log2;
}

// The epilogue: the bias in fp32, one rounding to bf16, stores of the pixels
// inside H and W and the columns below Cout only. Entry i of the
// accumulator: pixel 16 warp + g + 8 ((i >> 1) & 1) of the warpgroup's 64,
// output channel n0 + 8 (i >> 2) + 2 t + (i & 1).
template <int R>
__device__ __forceinline__ void store_tile(const float (&acc)[R], const float* __restrict__ bias,
                                           __nv_bfloat16* __restrict__ out, const ConvGeom& geo, int t, int h0, int w0,
                                           int n0, int wg, int warp, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = 64 * wg + 16 * warp + g + 8 * r;
    const int hh = h0 + (p >> geo.box_w_log2);
    const int ww = w0 + (p & ((1 << geo.box_w_log2) - 1));
    if (hh >= geo.H || ww >= geo.W) continue;
    __nv_bfloat16* orow = out + ((static_cast<size_t>(t) * geo.H + hh) * geo.W + ww) * geo.Cout;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      if (col >= geo.Cout) continue;  // Cout is a multiple of 16: col + 1 < Cout too
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
      *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(acc[4 * j + 2 * r] + b.x, acc[4 * j + 2 * r + 1] + b.y);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_causal_kernel(const __grid_constant__ CUtensorMap map_slab, const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, const ConvGeom geo) {
  using Smem = ConvSmem<N>;
  constexpr int kStages = Smem::kStages;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = smem_storage<Smem>(smem_raw);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int groups = 3 * geo.chunks;  // (dt, chunk) slabs of one tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlabStages; ++s) {
      mbar_init(&sm.slab_full[s], 1);
      mbar_init(&sm.slab_empty[s], kConsumerWarps);
    }
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
      int it = 0, is = 0;
      for (int tile = blockIdx.x; tile < geo.num_tiles; tile += gridDim.x) {
        int t, h0, w0, n0;
        decode_tile(geo, tile, N, t, h0, w0, n0);
        for (int grp = 0; grp < groups; ++grp, ++is) {
          const int dt = grp / geo.chunks, c = grp % geo.chunks;
          const int ss = is % kSlabStages;
          mbar_wait(&sm.slab_empty[ss], ((is / kSlabStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.slab_full[ss], kSlabBytes);
          tma_load_4d(sm.slab[ss], &map_slab, &sm.slab_full[ss], c * kChunk, w0 - 1, h0 - 1, t + dt);
          for (int s9 = 0; s9 < 9; ++s9, ++it) {
            const int s = it % kStages;
            mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
            mbar_arrive_expect_tx(&sm.full[s], Smem::kBBytes);
            tma_load_4d(sm.b[s], &map_w, &sm.full[s], c * kChunk, n0, 9 * dt + s9, 0);
          }
        }
      }
    }
  } else {
    // ------------------------------ consumers -----------------------------
    setmaxnreg_inc<kConsumerRegs>();
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // this lane's ldmatrix row: pixel m = lane % 16 of the warp's 16, at
    // slab row (i + dh) (BW + 2) + j + dw for tap (dh, dw); columns 8
    // (lane / 16) .. + 7 of each k16 step
    const int pitch = (1 << geo.box_w_log2) + 2;
    const int p = 64 * wg + 16 * warp + (lane % 16);
    const int row0 = (p >> geo.box_w_log2) * pitch + (p & ((1 << geo.box_w_log2) - 1));
    const int khalf = lane / 16;
    // a batch of taps' A operands: loaded together while no product is in
    // flight (a register that an asynchronous product reads is rewritten
    // only after it completes), then their products issued back to back
    constexpr int kBatch = N > 192 ? 3 : kSlabBatchTaps;
    uint32_t frag[kBatch][kChunk / 16][4];
    int it = 0, is = 0;
    for (int tile = blockIdx.x; tile < geo.num_tiles; tile += gridDim.x) {
      int t, h0, w0, n0;
      decode_tile(geo, tile, N, t, h0, w0, n0);
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      for (int grp = 0; grp < groups; ++grp, ++is) {
        const int ss = is % kSlabStages;
        mbar_wait(&sm.slab_full[ss], (is / kSlabStages) & 1);
        const uint32_t slab = smem_addr(sm.slab[ss]);
#pragma unroll
        for (int b0 = 0; b0 < 9; b0 += kBatch) {
          wgmma_wait<0>();  // the previous batch's products are done with their registers
          fence_operands(acc);
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int row = row0 + ((b0 + j) / 3) * pitch + (b0 + j) % 3;
#pragma unroll
            for (int kk = 0; kk < kChunk / 16; ++kk)
              ldmatrix_x4(frag[j][kk], slab + row * kRowBytes + (((2 * kk + khalf) ^ ((row >> 1) & 3)) << 4));
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j, ++it) {
            const int s = it % kStages;
            mbar_wait(&sm.full[s], (it / kStages) & 1);
            fence_operands(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kChunk / 16; ++kk)
              wgmma_rs<0>(acc, frag[j][kk], kmajor_sw64_desc(sm.b[s], kk), 1);
            wgmma_commit();
            // the previous tap's product is done: its B stage goes back to the producer
            wgmma_wait<1>();
            fence_operands(acc);
            if (grp > 0 || b0 + j > 0) release(&sm.empty[(it - 1) % kStages]);
          }
        }
        // every fragment of this slab has reached a product that was
        // issued, so its ldmatrix reads are done: the producer may refill
        // it (a release right after the ldmatrix let a TMA write race the
        // reads still in flight)
        release(&sm.slab_empty[ss]);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      release(&sm.empty[(it - 1) % kStages]);
      store_tile(acc, bias, out, geo, t, h0, w0, n0, wg, warp, lane);
    }
  }
}

template <int N>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(ConvSmem<N>)) + 1024;
}

template <int N>
int launch(const CUtensorMap& map_slab, const CUtensorMap& map_w, const float* bias, __nv_bfloat16* out,
           const ConvGeom& geo, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem_once(reinterpret_cast<const void*>(conv3d_causal_kernel<N>), smem_bytes<N>(), configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = geo.num_tiles < sms ? geo.num_tiles : sms;
  conv3d_causal_kernel<N><<<grid, kThreads, smem_bytes<N>(), stream>>>(map_slab, map_w, bias, out, geo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dynamic shared memory a CTA of the instantiation for width `n` takes, in
// bytes; 0 for a width that is not built
extern "C" int cosmos_conv3d_causal_smem_bytes(int n) {
  switch (n) {
    case 64: return smem_bytes<64>();
    case 80: return smem_bytes<80>();
    case 96: return smem_bytes<96>();
    case 128: return smem_bytes<128>();
    case 192: return smem_bytes<192>();
    case 256: return smem_bytes<256>();
    default: return 0;
  }
}

// x: (1, T_out + 2, H, W, Cin) bf16; w_taps: (27, Cout, Cin) bf16; bias:
// (Cout,) fp32; out: (1, T_out, H, W, Cout) bf16. All contiguous and
// 16-byte aligned, Cin and Cout multiples of 16. box_w (8 or 16), the
// wgmma width n and the N split n_split (n * n_split >= Cout) come from
// ops/conv3d.py::conv_plan. Returns the CUDA error code (0 on success).
extern "C" int cosmos_conv3d_causal(const void* x, const void* w_taps, const void* bias, void* out, int T_out, int H,
                                    int W, int Cin, int Cout, int box_w, int n, int n_split, void* stream) {
  if ((box_w != 8 && box_w != 16) || Cin % 16 || Cout % 16 || n_split < 1 || n * n_split < Cout ||
      cosmos_conv3d_causal_smem_bytes(n) == 0 || T_out < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int box_h = kBlockM / box_w;
  ConvGeom geo{T_out, H, W, Cin, Cout, box_w == 16 ? 4 : 3, (H + box_h - 1) / box_h, (W + box_w - 1) / box_w,
               n_split, 0, (Cin + kChunk - 1) / kChunk};
  geo.num_tiles = T_out * geo.tiles_h * geo.tiles_w * n_split;
  CUtensorMap map_slab, map_w;
  const cuuint64_t row = static_cast<cuuint64_t>(Cin) * 2;  // bytes of one pixel or one output channel
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(T_out + 2)};
  const cuuint64_t x_strides[3] = {row, row * W, row * W * H};
  // the slab: the tile's rectangle and one pixel around it
  const cuuint32_t x_box[4] = {kChunk, static_cast<cuuint32_t>(box_w + 2), static_cast<cuuint32_t>(box_h + 2), 1};
  int err = make_map_4d(&map_slab, x, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_64B);
  const cuuint64_t w_dims[4] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(Cout), kTaps, 1};
  const cuuint64_t w_strides[3] = {row, row * Cout, row * Cout * kTaps};
  const cuuint32_t w_box[4] = {kChunk, static_cast<cuuint32_t>(n), 1, 1};
  if (!err) err = make_map_4d(&map_w, w_taps, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  const float* b = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 64: return launch<64>(map_slab, map_w, b, o, geo, st);
    case 80: return launch<80>(map_slab, map_w, b, o, geo, st);
    case 96: return launch<96>(map_slab, map_w, b, o, geo, st);
    case 128: return launch<128>(map_slab, map_w, b, o, geo, st);
    case 192: return launch<192>(map_slab, map_w, b, o, geo, st);
    default: return launch<256>(map_slab, map_w, b, o, geo, st);
  }
}
