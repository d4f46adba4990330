// Fused conv stem + triplane axis-mean pooling, for Hopper (sm_90a), in two
// modes: stem_pool_f32 (float32 TSDF, weights and planes) and stem_pool_bf16
// (the TPU kernel's compute_dtype=bf16: bf16 TSDF and weights, widened to
// float32 as they are loaded, which is exact, so every product is the bf16
// product and every sum, the bias, the ReLU and the means stay float32; the
// planes are rounded to bf16 as they are written, the U-Net's input dtype).
// Both modes run the same code on float32 values in shared memory: only the
// loads from and the stores to device memory differ.
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
// What bounds it: at the serving shape (B=64, R=40, C=32) it does 27 FMAs,
// a bias add and three pooling adds per voxel and channel (7.60 GFLOP,
// 0.113 ms at the H100's 67 TFLOP/s fp32 rate) against 55.7 MB moved
// (0.017 ms at 3.35 TB/s): bound by fp32 CUDA-core arithmetic. An SM
// issues one warp instruction a clock on each of its four schedulers and
// runs four warp FFMAs a clock, so every other instruction takes an FFMA's
// slot: the design keeps the FFMAs the bulk of what is issued.
//
// Design, against the four faults of the kernel it replaces (one block per
// scene and 4 channels, one point per thread, 14% of the bound):
//  1. Loads per FMA. A tap thread owns a micro-tile of TZ = 4 consecutive z
//     by the block's CB = 8 channels at one (y, x); the block's tap threads
//     tile the (y, z) slab. Per (dx, dy) column a thread reads its 6 TSDF
//     values (z - 1 .. z + 4) as one float4 and one float2, and per tap the
//     CB weights as broadcast float4s (every lane reads the same address):
//     72 shared loads feed 864 FFMAs a slab (was about one per FMA). The
//     taps run dx, dy, dz ascending, one fmaf each from zero, then the bias
//     add and ReLU: the parent's order, so every value is the parent's bit
//     for bit. The weights sit in shared memory, not in registers.
//  2. Pooling. yz (the mean over x) is each tap thread's own sum in
//     registers over the x sweep. The ReLU'd values of slab x go to one of
//     two tiles in shared memory, [y][c][z] with row strides chosen so that
//     the 16-byte reads below are free of bank conflicts. POOL_WARPS = 6
//     warps of their own sum slab x - 1's xy rows (a thread per (y, 4 c), z
//     in order) and xz rows (a thread per (4 z, c), y in order), four
//     independent sums a thread, while the tap warps run slab x into the
//     other tile. Every sum is made by one thread in index order: no float
//     atomics, the parent's sums bit for bit.
//  3. Grid. One block per (scene, CB channels): B * C / CB blocks (256 of
//     400 tap and 192 pooling threads at the serving shape), each reading
//     its scene once through a ring of four zero-padded x-slabs in shared
//     memory; one barrier per slab (the ring and the two tiles make a
//     second unnecessary). A tap thread fetches its part of slab x + 2 into
//     registers before slab x's taps run and stores it after them.
//  4. Index math. A tap thread's (y, z-run) is fixed for the whole sweep and
//     it loads its own z-run of each slab: no division or modulo per
//     element. The padding of the ring is written once.
//
// Resources and time (ptxas for sm_90a; chip_smoke.py prints them): 96
// registers, 84/56 bytes of spill stores/loads, 144,384 bytes of shared
// memory and 608 threads a block, one block per SM. On an NVIDIA H100 80GB
// HBM3 at 700 W, 0.325-0.328 ms at B=64, R=40, C=32: 35% of the bound. The design
// A/B (ab_stem_pool.py, PERF.md) puts the rest in the pooling (about 0.08
// ms: without it the kernel takes 0.24 ms) and in issue slots and shared
// loads the taps share with it: fewer pooling warps leave the tap warps
// waiting at the barrier, 8-z micro-tiles spill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The design (ab_stem_pool.py rewrites these constants in a copy of this
// source to time the alternatives):
constexpr int CB = 8;            // channels per block, and per thread's micro-tile
constexpr int TZ = 4;            // z of a thread's micro-tile (4 or 8: float4s of a slab row)
constexpr int POOL_WARPS = 6;    // warps that pool slab x - 1 while the others run slab x
constexpr int SUMS = 4;          // independent sums a pooling thread carries (4 or 8)
constexpr int MAX_THREADS = 608;  // threads a block: Y * ceil(Z / TZ) + 32 * POOL_WARPS at most
constexpr int MIN_BLOCKS = 1;    // resident blocks per SM asked of ptxas
constexpr int RING = 4;          // x-slabs in shared memory
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use on sm_90

struct Layout {
  int nzr;   // z-runs of TZ per slab row
  int nzq;   // z-quads per slab row
  int zp;    // floats per slab row: zero, z = 0 .. TZ*nzr - 1, zeros (16-byte rows)
  int slab;  // floats per zero-padded (Y + 2, zp) slab
  int zt;    // floats per (y, c) row of a tile
  int ys;    // floats per y of a tile: CB rows and 4 floats of padding
  int tile;  // floats per tile
  __host__ __device__ Layout(int Y, int Z) {
    nzr = (Z + TZ - 1) / TZ;
    nzq = TZ * nzr / 4;
    zp = TZ * nzr + 4;
    slab = (Y + 2) * zp;
    // an odd zt / 4 puts the rows of a y's channels on distinct groups of 4
    // banks, and the padding of ys those of neighbouring y
    zt = TZ * nzr + (nzq % 2 ? 0 : 4);
    ys = CB * zt + 4;
    tile = Y * ys;
  }
  __host__ __device__ int floats() const { return 28 * CB + RING * slab + 2 * tile; }
};
static_assert(CB % SUMS == 0 && SUMS % 4 == 0 && TZ % 4 == 0,
              "whole float4s of channels and z");

// Device-memory element types: a value widened to float32, four consecutive
// values as a float4 (one 16-byte or 8-byte load), and the stores back.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
stem_pool_kernel(const T* __restrict__ tsdf, const T* __restrict__ weight,
                 const T* __restrict__ bias, T* __restrict__ xz,
                 T* __restrict__ xy, T* __restrict__ yz, int X, int Y, int Z, int C) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(Y, Z);
  float* wsh = smem;                     // (27, CB): tap-major, the CB channels contiguous
  float* bsh = smem + 27 * CB;           // (CB)
  float* ring = smem + 28 * CB;          // RING zero-padded slabs; slab xx at slot xx & 3
  float* tiles = ring + RING * L.slab;   // 2 tiles; slab x's ReLU'd values at tile x & 1

  const int groups = C / CB;
  const int b = blockIdx.x / groups, c0 = (blockIdx.x % groups) * CB;
  const int tid = threadIdx.x;
  const int ntaps = Y * L.nzr;                // threads that run the taps
  const int pool0 = (ntaps + 31) / 32 * 32;  // the first of the pooling warps
  const bool taps = tid < ntaps;
  const int y = tid / L.nzr, z0 = (tid - y * L.nzr) * TZ;  // a tap thread's (y, z-run)
  const T* vol = tsdf + (size_t)b * X * Y * Z;
  // rows of the TSDF are read four values at a time where every row start is aligned
  const bool vec = Z % 4 == 0 && reinterpret_cast<size_t>(tsdf) % (4 * sizeof(T)) == 0;

  for (int i = tid; i < 27 * CB; i += blockDim.x) {
    const int t = i / CB, c = i % CB;
    wsh[i] = widen(weight[(c0 + c) * 27 + t]);
  }
  for (int c = tid; c < CB; c += blockDim.x) bsh[c] = widen(bias[c0 + c]);
  for (int i = tid; i < RING * L.slab; i += blockDim.x) ring[i] = 0.f;

  // this thread's z-run of slab xx (zeros past Z and outside 0 .. X-1)
  auto fetch = [&](int xx, float (&v)[TZ]) {
#pragma unroll
    for (int j = 0; j < TZ; ++j) v[j] = 0.f;
    if (xx < 0 || xx >= X) return;
    const T* src = vol + ((size_t)xx * Y + y) * Z + z0;
    if (vec) {  // Z % 4 == 0: a quad of the run lies wholly inside or outside the row
#pragma unroll
      for (int q = 0; q < TZ / 4; ++q) {
        if (z0 + 4 * q >= Z) break;
        const float4 u = load4(src + 4 * q);
        v[4 * q] = u.x, v[4 * q + 1] = u.y, v[4 * q + 2] = u.z, v[4 * q + 3] = u.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < TZ; ++j)
        if (z0 + j < Z) v[j] = widen(__ldg(src + j));
    }
  };
  // slab row y + 1 holds y; row entry z + 1 holds z (entries past Z stay zero)
  auto put = [&](int xx, const float (&v)[TZ]) {
    float* dst = ring + (xx & (RING - 1)) * L.slab + (y + 1) * L.zp + z0 + 1;
#pragma unroll
    for (int j = 0; j < TZ; ++j) dst[j] = v[j];
  };

  float next[TZ];
  __syncthreads();  // the ring's zeros before the first slabs
  if (taps) {
    fetch(0, next);
    put(0, next);
    fetch(1, next);
    put(1, next);
  }
  __syncthreads();

  // xy[b, y', xp, c] = mean over z (a thread per (y', SUMS c)), then
  // xz[b, z, xp, c] = mean over y (a thread per (SUMS z, c)), from slab xp's
  // tile; each thread carries SUMS independent sums, each in index order
  auto pool_slab = [&](int xp, int first, int stride) {
    constexpr int QS = SUMS / 4;  // z-quads of an xz task
    const float* tile = tiles + (xp & 1) * L.tile;
    const int nzg = (L.nzq + QS - 1) / QS;
    const int nxy = Y * (CB / SUMS), ntask = nxy + nzg * CB;
    for (int task = first; task < ntask; task += stride) {
      float sum[SUMS];
#pragma unroll
      for (int k = 0; k < SUMS; ++k) sum[k] = 0.f;
      if (task < nxy) {
        const int yy = task / (CB / SUMS), c = task % (CB / SUMS) * SUMS;
        const float* row = tile + yy * L.ys + c * L.zt;
        int z = 0;
#pragma unroll 2
        for (; z + 4 <= Z; z += 4) {
#pragma unroll
          for (int k = 0; k < SUMS; ++k) {
            const float4 u = ld4(row + k * L.zt + z);
            sum[k] += u.x;
            sum[k] += u.y;
            sum[k] += u.z;
            sum[k] += u.w;
          }
        }
        for (; z < Z; ++z)
#pragma unroll
          for (int k = 0; k < SUMS; ++k) sum[k] += row[k * L.zt + z];
        T* dst = xy + (((size_t)b * Y + yy) * X + xp) * C + c0 + c;
#pragma unroll
        for (int q = 0; q < QS; ++q)
          store4(dst + 4 * q, make_float4(sum[4 * q] / (float)Z, sum[4 * q + 1] / (float)Z,
                                          sum[4 * q + 2] / (float)Z, sum[4 * q + 3] / (float)Z));
      } else {
        const int k = task - nxy, c = k / nzg, zq = (k - c * nzg) * SUMS;
        const float* col = tile + c * L.zt + zq;
        const bool whole = zq + SUMS <= 4 * L.nzq;  // else only the first quad is in the row
#pragma unroll 4
        for (int yy = 0; yy < Y; ++yy) {
#pragma unroll
          for (int q = 0; q < QS; ++q) {
            if (q > 0 && !whole) break;
            const float4 u = ld4(col + yy * L.ys + 4 * q);
            sum[4 * q] += u.x;
            sum[4 * q + 1] += u.y;
            sum[4 * q + 2] += u.z;
            sum[4 * q + 3] += u.w;
          }
        }
#pragma unroll
        for (int j = 0; j < SUMS; ++j)
          if (zq + j < Z)
            store1(xz + (((size_t)b * Z + zq + j) * X + xp) * C + c0 + c, sum[j] / (float)Y);
      }
    }
  };

  float pool_yz[TZ][CB];
#pragma unroll
  for (int j = 0; j < TZ; ++j)
#pragma unroll
    for (int c = 0; c < CB; ++c) pool_yz[j][c] = 0.f;

  for (int x = 0; x < X; ++x) {
    if (taps) {
      fetch(x + 2, next);  // slab x + 2, for slab x + 1's taps; its load overlaps this slab's
      float acc[TZ][CB];
#pragma unroll
      for (int j = 0; j < TZ; ++j)
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[j][c] = 0.f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* s = ring + ((x + dx - 1) & (RING - 1)) * L.slab;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* col = s + (y + dy) * L.zp + z0;  // z0 - 1 .. z0 + TZ
          float t[TZ + 2];
#pragma unroll
          for (int q = 0; q < TZ / 4; ++q) {
            const float4 u = ld4(col + 4 * q);
            t[4 * q] = u.x, t[4 * q + 1] = u.y, t[4 * q + 2] = u.z, t[4 * q + 3] = u.w;
          }
          const float2 hi = ld2(col + TZ);
          t[TZ] = hi.x, t[TZ + 1] = hi.y;
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const float* w = wsh + ((dx * 3 + dy) * 3 + dz) * CB;
#pragma unroll
            for (int q = 0; q < CB / 4; ++q) {
              const float4 u = ld4(w + 4 * q);
              const float wq[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
              for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int j = 0; j < TZ; ++j)
                  acc[j][4 * q + k] = fmaf(wq[k], t[j + dz], acc[j][4 * q + k]);
            }
          }
        }
      }
      float* tile = tiles + (x & 1) * L.tile;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        float r[TZ];
#pragma unroll
        for (int j = 0; j < TZ; ++j) {
          r[j] = fmaxf(acc[j][c] + bsh[c], 0.f);
          pool_yz[j][c] += r[j];
        }
#pragma unroll
        for (int q = 0; q < TZ / 4; ++q)
          reinterpret_cast<float4*>(tile + y * L.ys + c * L.zt + z0)[q] =
              make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
      }
      if (x + 1 < X) put(x + 2, next);
    } else if (tid >= pool0 && x > 0) {
      pool_slab(x - 1, tid - pool0, 32 * POOL_WARPS);
    }
    __syncthreads();  // slab x's tile is whole; slab x + 2 is in the ring
  }
  pool_slab(X - 1, tid, blockDim.x);
  if (!taps) return;
  // yz[b, z, y, c] = mean over x
#pragma unroll
  for (int j = 0; j < TZ; ++j) {
    if (z0 + j >= Z) break;
    T* dst = yz + (((size_t)b * Z + z0 + j) * Y + y) * C + c0;
#pragma unroll
    for (int q = 0; q < CB / 4; ++q)
      store4(dst + 4 * q,
             make_float4(pool_yz[j][4 * q] / (float)X, pool_yz[j][4 * q + 1] / (float)X,
                         pool_yz[j][4 * q + 2] / (float)X, pool_yz[j][4 * q + 3] / (float)X));
  }
}

}  // namespace

// Launch configuration for these shapes into info[4] = {blocks, threads per
// block, dynamic shared bytes per block, channels per block}; returns
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int stem_pool_config(int B, int X, int Y, int Z, int C, int* info) {
  const Layout L(Y, Z);
  const int threads = (Y * L.nzr + 31) / 32 * 32 + 32 * POOL_WARPS;
  const size_t shmem = (size_t)L.floats() * sizeof(float);
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || C < CB || C % CB != 0 || threads > MAX_THREADS ||
      shmem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  info[0] = B * (C / CB);
  info[1] = threads;
  info[2] = (int)shmem;
  info[3] = CB;
  return 0;
}

namespace {

// The kernel of element type T on a stream, configured by stem_pool_config.
template <typename T>
int launch(const T* tsdf, const T* weight, const T* bias, T* xz, T* xy, T* yz, int B, int X,
           int Y, int Z, int C, void* stream) {
  int info[4];
  int err = stem_pool_config(B, X, Y, Z, C, info);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(stem_pool_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, info[2]);
  if (e != cudaSuccess) return (int)e;
  stem_pool_kernel<T><<<info[0], info[1], info[2], (cudaStream_t)stream>>>(
      tsdf, weight, bias, xz, xy, yz, X, Y, Z, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stem_pool_f32(const float* tsdf, const float* weight, const float* bias,
                             float* xz, float* xy, float* yz, int B, int X, int Y, int Z,
                             int C, void* stream) {
  return launch(tsdf, weight, bias, xz, xy, yz, B, X, Y, Z, C, stream);
}

// bf16 TSDF (B, X, Y, Z), weights (C, 27) and bias (C) -> bf16 planes.
extern "C" int stem_pool_bf16(const __nv_bfloat16* tsdf, const __nv_bfloat16* weight,
                              const __nv_bfloat16* bias, __nv_bfloat16* xz, __nv_bfloat16* xy,
                              __nv_bfloat16* yz, int B, int X, int Y, int Z, int C,
                              void* stream) {
  return launch(tsdf, weight, bias, xz, xy, yz, B, X, Y, Z, C, stream);
}
