// Hopper (sm_90a) building blocks shared by the port's warp-specialised
// kernels: TMA tile loads into shared memory, mbarriers, shared-memory matrix
// descriptors for 128-byte-swizzled tiles, and warpgroup matrix products
// (wgmma, bf16 x bf16 -> fp32) with A from shared memory or from registers;
// on the host, the 4-d tensor maps of (B, S, H, 128) and head-major
// (B, H, S, 128) bf16 tensors and the one-time shared-memory attribute.
//
// Tiles. A TMA box of R rows x 64 bf16 (128 bytes a row) loaded with
// CU_TENSOR_MAP_SWIZZLE_128B lands as R rows of 128 bytes, the 16-byte chunk
// c of row r at chunk c ^ (r % 8); eight rows (1,024 bytes) form one swizzle
// atom, so the tile's base must be 1,024-byte aligned. A 128-wide head row
// is two such boxes, one after the other.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"): start address >> 4 in
// bits 0-13, leading byte offset >> 4 in 16-29, stride byte offset >> 4 in
// 32-45, layout 1 (128-byte swizzle) in bits 62-63.
// - K-major operand (the reduction index contiguous: Q or K read as
//   Q K^T): the stride byte offset is one atom (1,024 bytes) between groups
//   of 8 rows; the leading offset is unused. The k16 step kk of a box starts
//   kk * 32 bytes into it (the hardware applies the swizzle to the address).
// - MN-major operand (the output column contiguous: K read as B of dS K):
//   rows of the tile run along the reduction, so the stride byte offset is
//   one atom (8 reduction rows) and the leading byte offset is the distance
//   between the two 64-column boxes; the k16 step kk starts kk * 16 rows
//   (2,048 bytes) in.
//
// Accumulator layout of an m64nN product (fp32, N / 2 registers a thread):
// warp w of the warpgroup holds rows 16 w .. 16 w + 15; lane 4 g + t holds
// d[i] at row 16 w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1).
// The register A operand of a k16 step takes the same layout, so columns
// 16 kk .. 16 kk + 15 of an accumulator, rounded to bf16, feed step kk
// directly (a_fragment).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cosmos_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------- mbarrier ---------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` from asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------ TMA ------------------------------------

// the box at coordinates (c0 innermost .. c3) of a 4-d tensor map into shared
// memory, completing `bar`'s transaction count; rows outside the tensor read
// as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a tile of R rows x 128 columns as two swizzled 64-column boxes of R x 128 bytes
template <int R>
struct Tile {
  static constexpr int kBoxBytes = R * 128;
  static constexpr int kBytes = 2 * kBoxBytes;
};

// R rows from sequence row `row` of head h, batch b: a (B, S, H, 128) map
// (make_bshd_map) or a head-major (B, H, S, 128) one (make_head_major_map)
template <int R>
__device__ __forceinline__ void tma_tile_bshd(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row, int h,
                                              int b) {
  tma_load_4d(dst, map, bar, 0, h, row, b);
  tma_load_4d(dst + Tile<R>::kBoxBytes, map, bar, 64, h, row, b);
}

template <int R>
__device__ __forceinline__ void tma_tile_head_major(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                                    int h, int b) {
  tma_load_4d(dst, map, bar, 0, row, h, b);
  tma_load_4d(dst + Tile<R>::kBoxBytes, map, bar, 64, row, h, b);
}

// dynamic shared memory rounded up to the 1,024-byte swizzle atom
template <typename T>
__device__ __forceinline__ T& smem_storage(unsigned char* raw) {
  const uint32_t addr = smem_addr(raw);
  return *reinterpret_cast<T*>(raw + (((addr + 1023) & ~1023u) - addr));
}

// ------------------------------- small helpers -------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit (flushes denormals: 2^x < 2^-126 gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------ register budget ------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -------------------------------- descriptors --------------------------------

__device__ __forceinline__ uint64_t sw128_desc(const void* tile, uint32_t leading_bytes, uint32_t stride_bytes) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((leading_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major tile (rows x 64 of one box), k16 step kk (0..3) of the box
__device__ __forceinline__ uint64_t kmajor_desc(const void* box, int kk) {
  return sw128_desc(static_cast<const char*>(box) + kk * 32, 16, 1024);
}

// MN-major tile of two 64-column boxes `box_bytes` apart, k16 step kk along
// its rows
__device__ __forceinline__ uint64_t mnmajor_desc(const void* box0, uint32_t box_bytes, int kk) {
  return sw128_desc(static_cast<const char*>(box0) + kk * 2048, box_bytes, 1024);
}

// ----------------------------------- wgmma -----------------------------------
// wgmma_ss / wgmma_rs: one m64nNk16 product, N given by the accumulator's
// size (N / 2 registers a thread); an overload per N that K7, K8 or the
// variants scripts/flash_bwd_variants.py builds use

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// columns 16 kk .. 16 kk + 15 of an accumulator, rounded to bf16, as the
// register A operand of one k16 step
template <int R>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float (&d)[R], int kk) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 v = __floats2bfloat162_rn(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
    a[j] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// D (64 x 64) += A (64 x 16) B (16 x 64), A and B in shared memory. A is
// K-major; B is K-major (TransB 0) or MN-major (TransB 1). scale_d 0
// overwrites D.
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D (64 x 128) += A (64 x 16) B (16 x 128), A and B in shared memory. A is
// K-major; B is K-major (TransB 0) or MN-major (TransB 1). scale_d 0
// overwrites D.
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D (64 x 128) += A (64 x 16) B (16 x 128): A from registers, four bf16 pairs per
// thread in the accumulator's fragment layout (see a_fragment), B in shared
// memory, K-major (TransB 0) or MN-major (TransB 1).
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// ----------------------------------- host ------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, found through the
// runtime's entry-point query, so the library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 4-d bf16 tensor map of innermost extent 128 and boxes of 64 x 1 x ... ,
// 128-byte swizzled; reads outside `dims` give zeros. strides in bytes.
inline int make_map_4d(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
                       const cuuint32_t (&box)[4]) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a (B, S, H, 128) bf16 tensor in boxes of `rows` x 64 (tma_tile_bshd);
// reads past S give zeros
inline int make_bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int rows) {
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {256, static_cast<cuuint64_t>(H) * 256, static_cast<cuuint64_t>(S) * H * 256};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return make_map_4d(map, ptr, dims, strides, box);
}

// the first `S` rows of each head of a head-major (B, H, S_max, 128) bf16
// tensor in boxes of `rows` x 64 (tma_tile_head_major); reads at or past S
// give zeros, whatever the buffer holds there
inline int make_head_major_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int S_max, int rows) {
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {256, static_cast<cuuint64_t>(S_max) * 256, static_cast<cuuint64_t>(H) * S_max * 256};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return make_map_4d(map, ptr, dims, strides, box);
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// device: `done` is the caller's flag per device for this kernel
constexpr int kMaxDevices = 64;
inline cudaError_t set_smem_once(const void* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace cosmos_sm90
