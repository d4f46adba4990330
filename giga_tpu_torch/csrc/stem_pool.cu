// Fused conv stem + triplane axis-mean pooling, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel giga_tpu/ops/pallas/stem_kernel.py::
// fused_stem_pool_batched (pallas_call at :120, body _stem_pool_kernel :37):
// Conv3d(1 -> C, k=3, zero 'same' padding) + bias + ReLU over a (B, X, Y, Z)
// TSDF, then the mean over each dropped axis, written straight into the
// three plane layouts the encoder uses (row = second plane axis):
//   xz (B, Z, X, C) = mean over y,  xy (B, Y, X, C) = mean over z,
//   yz (B, Z, Y, C) = mean over x.
// The (B, X, Y, Z, C) voxel volume is never written to device memory.
//
// What bounds it: at the serving shape (B=64, R=40, C=32) it does 27 FMAs
// per voxel and channel (~7.1 GFLOP) against ~16 MB read and ~10 MB
// written, so it is bound by fp32 CUDA-core arithmetic, not by bytes.
//
// Design: one block per (scene, group of CG=4 channels). A block owns its
// scene's three planes for its channels, so every plane sum is made by one
// block in a fixed order: no float atomics, results are bit-reproducible.
// The block sweeps x; a rolling window of three zero-padded (Y+2)(Z+2) TSDF
// slabs lives in shared memory (the whole 256 KB scene would not fit), so
// each tap is a shared-memory read reused by the CG channels. Each thread
// owns up to MAXP (y, z) voxels of the slab: it keeps their yz sums over x
// in registers and stores the ReLU'd conv values of the current slab in a
// shared tile, from which the block then reduces the slab's xy (over z) and
// xz (over y) rows, each sum by one thread in index order. Means divide by
// the axis length, as the plain ``.mean`` does.

#include <cuda_runtime.h>

namespace {

constexpr int CG = 4;         // channels per block
constexpr int THREADS = 320;  // threads per block
constexpr int MAXP = 8;       // (y, z) voxels per thread: Y*Z <= 2560

__global__ void __launch_bounds__(THREADS)
stem_pool_kernel(const float* __restrict__ tsdf, const float* __restrict__ weight,
                 const float* __restrict__ bias, float* __restrict__ xz,
                 float* __restrict__ xy, float* __restrict__ yz,
                 int X, int Y, int Z, int C) {
  extern __shared__ float smem[];
  const int PY = Y + 2, PZ = Z + 2, slab = PY * PZ, YZ = Y * Z;
  float* slabs = smem;              // 3 zero-padded TSDF slabs
  float* tile = smem + 3 * slab;    // (Y*Z, CG) ReLU'd conv values of one x
  __shared__ float w[CG * 27];
  __shared__ float bsh[CG];

  const int groups = C / CG;
  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * CG;
  const int tid = threadIdx.x;
  const float* vol = tsdf + (size_t)b * X * YZ;

  for (int i = tid; i < CG * 27; i += THREADS) w[i] = weight[(c0 + i / 27) * 27 + i % 27];
  if (tid < CG) bsh[tid] = bias[c0 + tid];

  // slab of x-index xx lives at slot (xx + 3) % 3; out-of-range x is zeros
  auto load_slab = [&](int xx) {
    float* dst = slabs + ((xx + 3) % 3) * slab;
    for (int i = tid; i < slab; i += THREADS) {
      int yy = i / PZ - 1, zz = i % PZ - 1;
      float v = 0.f;
      if (xx >= 0 && xx < X && yy >= 0 && yy < Y && zz >= 0 && zz < Z)
        v = vol[((size_t)xx * Y + yy) * Z + zz];
      dst[i] = v;
    }
  };
  load_slab(-1);
  load_slab(0);

  float acc[MAXP][CG];
#pragma unroll
  for (int k = 0; k < MAXP; ++k)
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[k][c] = 0.f;

  for (int x = 0; x < X; ++x) {
    load_slab(x + 1);
    __syncthreads();
    const float* s0 = slabs + ((x + 2) % 3) * slab;  // x - 1
    const float* s1 = slabs + (x % 3) * slab;        // x
    const float* s2 = slabs + ((x + 1) % 3) * slab;  // x + 1
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      int p = tid + k * THREADS;
      if (p < YZ) {
        int y = p / Z, z = p % Z;
        float v[CG];
#pragma unroll
        for (int c = 0; c < CG; ++c) v[c] = 0.f;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* s = dx == 0 ? s0 : (dx == 1 ? s1 : s2);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dz = 0; dz < 3; ++dz) {
              float t = s[(y + dy) * PZ + z + dz];
#pragma unroll
              for (int c = 0; c < CG; ++c) v[c] = fmaf(w[c * 27 + dx * 9 + dy * 3 + dz], t, v[c]);
            }
        }
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          float r = fmaxf(v[c] + bsh[c], 0.f);
          acc[k][c] += r;
          tile[p * CG + c] = r;
        }
      }
    }
    __syncthreads();
    // xy[b, y, x, c] = mean over z; xz[b, z, x, c] = mean over y
    for (int s = tid; s < (Y + Z) * CG; s += THREADS) {
      int c = s % CG, row = s / CG;
      float sum = 0.f;
      if (row < Y) {
        for (int z = 0; z < Z; ++z) sum += tile[(row * Z + z) * CG + c];
        xy[(((size_t)b * Y + row) * X + x) * C + c0 + c] = sum / (float)Z;
      } else {
        int z = row - Y;
        for (int y = 0; y < Y; ++y) sum += tile[(y * Z + z) * CG + c];
        xz[(((size_t)b * Z + z) * X + x) * C + c0 + c] = sum / (float)Y;
      }
    }
  }
  // yz[b, z, y, c] = mean over x
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    int p = tid + k * THREADS;
    if (p < YZ) {
      int y = p / Z, z = p % Z;
#pragma unroll
      for (int c = 0; c < CG; ++c)
        yz[(((size_t)b * Z + z) * Y + y) * C + c0 + c] = acc[k][c] / (float)X;
    }
  }
}

}  // namespace

extern "C" int stem_pool_f32(const float* tsdf, const float* weight, const float* bias,
                             float* xz, float* xy, float* yz, int B, int X, int Y, int Z,
                             int C, void* stream) {
  if (C % CG != 0 || Y * Z > THREADS * MAXP) return (int)cudaErrorInvalidValue;
  size_t shmem = (size_t)(3 * (Y + 2) * (Z + 2) + Y * Z * CG) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stem_pool_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  stem_pool_kernel<<<B * (C / CG), THREADS, shmem, (cudaStream_t)stream>>>(
      tsdf, weight, bias, xz, xy, yz, X, Y, Z, C);
  return (int)cudaGetLastError();
}

extern "C" int stem_pool_max_yz() { return THREADS * MAXP; }
