// Plane rows staged in shared memory by the Tensor Memory Accelerator and
// read into the mma accumulator layout by ldmatrix (Hopper, sm_90a): the
// row path of the bf16 dense-decode trunk kernels (dense_decode.cu; in
// dense_decode_feats.cu also bf16 feature rows, whose same ldmatrix.x4
// addresses give the A fragments of an m16n8k16 product: matrix i's rows
// are points, its 8 columns a 16-byte chunk of channels).
//
// A row is one head's 32 bf16 columns, 64 bytes. TMA writes boxes of rows
// with the 64-byte swizzle (CU_TENSOR_MAP_SWIZZLE_64B, CUTLASS's
// Swizzle<2,4,3>): in a box that starts on a 512-byte boundary, 16-byte
// chunk c of row r lies at r * 64 + 16 * (c ^ ((r / 2) % 4)). The eight rows
// an ldmatrix reads then fall in eight distinct bank groups, whichever eight
// rows of a box they are.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices, lanes 8 i .. 8 i + 7 giving
// the rows of matrix i; lane l receives row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each. With matrix i = (points 16 m + 8 (i % 2) + 0..7,
// columns of n-tile n), that is exactly the register pair
// Tile::v[m][n][2 (i % 2) + {0, 1}] of trunk_mma.cuh's accumulator layout:
// two ldmatrix.x4 bring a 16-point m-tile's 32 columns, one instruction per
// 16 x 16 sub-tile, where the read-only path took eight 4-byte loads and
// their address arithmetic.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>

#include "trunk_mma.cuh"

namespace rows {

constexpr int ROW_BYTES = 64;  // one head's 32 bf16 columns
constexpr int ALIGN = 1024;    // every box starts on a multiple of this

__host__ __device__ constexpr int align_up(int n, int a) { return (n + a - 1) / a * a; }

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled box.
__host__ __device__ __forceinline__ unsigned offset(int row, int chunk) {
  return (unsigned)(row * ROW_BYTES + ((chunk ^ ((row >> 1) & 3)) << 4));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned bar, unsigned count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA writes before the phase ends.
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A phase that never
// completes (a TMA that faulted or a count that is wrong) traps after ~2^34
// clocks, some seconds, so the launch fails instead of holding the card.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  if (bar_try(bar, parity)) return;
  const long long start = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// -- TMA ---------------------------------------------------------------------

// Order this thread's earlier shared-memory accesses before later TMA writes.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Box (c0, c1, c2) of a 3D tensor map into shared memory at `dst`,
// completing `bytes` of the mbarrier's transaction count.
__device__ __forceinline__ void load_3d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                        int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -- ldmatrix into the accumulator layout --------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The point of m-tile m whose row address lane `lane` gives to ldmatrix, and
// the 16-byte chunk (n-tile) it gives for the first of the two loads.
__device__ __forceinline__ int lane_point(int m, int lane) {
  return 16 * m + 8 * ((lane >> 3) & 1) + (lane & 7);
}
__device__ __forceinline__ int lane_chunk(int lane) { return lane >> 4; }

// net[m] (+)= the rows of a box at `box` (shared address, 512-byte aligned)
// whose swizzled offsets for this lane's ldmatrix rows are off[m]
// (offset(row of lane_point(m, lane), lane_chunk(lane))), widened exactly
// to float32 and added one rounding per value, as tc::rows adds them.
template <bool kSet, int MT>
__device__ __forceinline__ void add(tc::Tile<MT>& net, unsigned box, const unsigned (&off)[MT]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    unsigned r[2][4];
    const unsigned a = box + off[m];
    ldsm_x4(r[0], a);        // n-tiles 0, 1
    ldsm_x4(r[1], a ^ 32u);  // n-tiles 2, 3: the chunk index's bit 1
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * q + i / 2, h = i % 2;
        const float lo = __uint_as_float(r[q][i] << 16);
        const float hi = __uint_as_float(r[q][i] & 0xffff0000u);
        if (kSet) {
          net.v[m][n][2 * h] = lo;
          net.v[m][n][2 * h + 1] = hi;
        } else {
          net.v[m][n][2 * h] += lo;
          net.v[m][n][2 * h + 1] += hi;
        }
      }
  }
}

// -- the tensor map ------------------------------------------------------------

// A 3D tensor map over bf16 rows of `cols` columns (`rows` rows per outer
// index, `outer` of those), boxes of 32 columns x `box_rows` rows x 1, the
// 64-byte swizzle. cuTensorMapEncodeTiled lives in libcuda: its address is
// asked of the CUDA runtime once (cudaGetDriverEntryPointByVersion), so the
// library links no libcuda. Returns 0 or a CUDA error code.
inline int encode_rows(CUtensorMap* map, const void* ptr, unsigned long long cols,
                       unsigned long long rows, unsigned long long outer, unsigned box_rows) {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {cols, rows, outer};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
  const cuuint32_t box[3] = {32, box_rows, 1}, elems[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace rows
