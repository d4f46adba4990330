// Fused conv stem + triplane axis-mean pooling, for Hopper (sm_90a), in two
// modes, each a kernel of its own: stem_pool_f32 (float32 TSDF, weights and
// planes; stem_pool_kernel below) and stem_pool_bf16 (the TPU kernel's
// compute_dtype=bf16: bf16 TSDF and weights, bf16 products summed in float32
// on the tensor cores, the bias, the ReLU and the means in float32, the
// planes rounded to bf16 as they are written, the U-Net's input dtype;
// stem_pool_bf16_kernel, further down, with its own design notes).
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

// Device-memory element types: a value as float32, four consecutive values as
// a float4 (one 16-byte load), and the stores back, in float32 (this kernel)
// or rounded to bf16 (the bf16 kernel's pooling).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
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

extern "C" int stem_pool_f32(const float* tsdf, const float* weight, const float* bias,
                             float* xz, float* xy, float* yz, int B, int X, int Y, int Z,
                             int C, void* stream) {
  int info[4];
  int err = stem_pool_config(B, X, Y, Z, C, info);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(stem_pool_kernel<float>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, info[2]);
  if (e != cudaSuccess) return (int)e;
  stem_pool_kernel<float><<<info[0], info[1], info[2], (cudaStream_t)stream>>>(
      tsdf, weight, bias, xz, xy, yz, X, Y, Z, C);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1's bf16 mode: the conv taps on the tensor cores.
//
// The TPU kernel takes the taps as bf16 products with float32 sums (_mm,
// decoder_kernel.py:43-48, called at stem_kernel.py:50-53): tensor-core
// work, 3.54 G multiply-adds at the serving shape, which as float32 FFMAs
// on the CUDA cores alone would take ~14x its bound (0.0083 ms by its 27.9
// MB of bytes). Here the taps of 16 voxels (consecutive z at one (x, y), an
// m16 tile) and the block's 8 channels are mma.sync.m16n8k16 products, bf16
// operands and float32 accumulators: A = 16 voxels x 16 taps, B = 16 taps
// x 8 channels, D = 16 voxels x 8 channels, three k-steps a tile.
//
// Pair slabs. An A register holds two consecutive taps of one voxel, and
// each is one aligned 32-bit shared load with no packing: the x-slabs in
// shared memory hold pair words, word j of a slab row the bf16 pair
// (s[j - 1], s[j]) of the zero-padded TSDF row, so every value sits in two
// words. A (dx, dy) column's taps dz = 0, 1, 2 of voxel z are two pairs:
// (dz 0, dz 1) is word z, (dz 1, dz 2) word z + 1 with its dz 1 weight zero.
// K-step s is dx = s. Its pairs 0-3 (registers 0/1 of lanes t = 0-3) are
// columns dy = 0 and 1; its pairs 4-5 (registers 2/3 of lanes t = 0, 1)
// column dy = 2; pairs 6-7 pad K to 48 with zero weights, their lanes (t =
// 2, 3) reading column dy = 2's words again. So a zero-weight tap only reads
// a value that one of the voxel's own taps reads (0 x NaN is NaN: a NaN in
// the TSDF reaches the outputs that the plain version's conv carries it to,
// and no others). One load instruction's lanes read words [w, w + 8] and
// [w + ZP, w + ZP + 8] of one slab; ZP, the words of a slab row, is 12 or 20
// mod 32, so the two runs never share a bank.
//
// Tiles. Tap warp w owns the NTZ m16 tiles (NTZ = ceil(Z / 16), a template
// argument) of each of up to ROWS = 12 / NTZ consecutive y-rows for the
// whole x sweep: 4 rows of 3 tiles a warp at R = 40. The last tile of a row
// is ragged: its voxels past Z are computed on zero words and never summed
// into xy or yz (their xz sums are never read). NTZ and ZP are compile-time,
// so a lane's 12 loads a tile are immediates of 6 base addresses it forms
// once a slab. It keeps the block's B fragments (6 words a lane) and its two
// channels' biases in registers. A tile is 12 loads and 3 MMAs; then on its
// 4 accumulators (the D layout: voxels g and g + 8, channels 2t and 2t + 1)
// a lane adds the bias and applies the ReLU.
//
// Pooling in the tap warps. Each lane sums its values in registers, with
// adds alone:
//   yz (mean over x): the lane's 4 values of each of its tiles, over the sweep;
//   xy (mean over z): a row's values (voxels g and g + 8 of its tiles),
//     stored each row as the lane's [g][c] sums (one 8-byte store);
//   xz (mean over y): the lane's values over the warp's rows, stored each
//     slab as the warp's [z][c] sums (two 8-byte stores a tile column).
// The 6 pooling warps run a loop of their own (so the tap warps' sums take
// none of their registers): while the tap warps run slab x, they finish
// slab x - 1's planes (xy adds a row's 8 lanes, xz the 10 warps, each in
// order, a job's loads issued at once) and fetch slab x + 2 (4-z runs of
// bf16 into registers, then pair words by byte permutes, one 16-byte store
// a run) into a ring of four zero-padded x-slabs. One barrier a slab; the
// grid is the float32 kernel's (a block per scene and 8 channels).
//
// Why this shape (ab_stem_pool.py --bf16; PERF.md §6): values pooled through
// a float [y][c][z] tile, as the float32 kernel pools, double the kernel's
// time; reducing xy across a row's lanes by __shfl_xor ends every row on
// three dependent shuffles that stall the in-order warp; one loop for both
// roles keeps the yz sums live through the pooling code and spills. What is
// left is paced by shared-memory traffic, the taps' ~1,440 loads and ~430
// other wavefronts a slab: without the pooling warps' adds the kernel takes
// ~0.135 ms of its ~0.19.
//
// Numerics: bf16 x bf16 products, exact in float32, summed by the tensor
// core in float32 in its own order; the float32 bias add and ReLU; the
// means in float32; the planes rounded to bf16 as written. The sum order is
// not the float32 kernel's fmaf chain, so a plane value agrees with the
// plain version's to float32 rounding before its bf16 rounding, which that
// can move by one bf16 step, rarely (chip_smoke.check_bf16 holds it).

namespace {

constexpr int BF_TAP_WARPS = 10;   // warps that run the taps and pool them
constexpr int BF_POOL_WARPS = 6;   // warps that fetch the slabs and finish the sums
constexpr int BF_MAX_TILES = 12;   // m16 tiles a tap warp carries through the sweep
constexpr int BF_TAP_THREADS = 32 * BF_TAP_WARPS;
constexpr int BF_POOL_THREADS = 32 * BF_POOL_WARPS;
constexpr int BF_THREADS = BF_TAP_THREADS + BF_POOL_THREADS;
// 4-z runs of a slab a pooling thread fetches: at most 4 a tile
constexpr int BF_FETCH = (4 * BF_MAX_TILES * BF_TAP_WARPS + BF_POOL_THREADS - 1) / BF_POOL_THREADS;
constexpr int WORD0 = 3;  // index of pair word 0 in a slab row (words 1-4 of a run 16-byte aligned)
// floats per y of the lanes' xy sums, [g][c] and padding: a quarter-warp's
// 16-byte reads of four rows fall on distinct banks
constexpr int XYS = 72;
static_assert(BF_TAP_WARPS >= 8, "a pooling job holds a row's 8 lanes' xy sums at once");

// The geometry of a lattice of NTZ m16 tiles a slab row (Z up to 16 NTZ),
// fixed at compile time so that every tile's shared-memory offsets are
// immediates of a few per-slab base addresses.
template <int NTZ>
struct PairGeometry {
  // 32-bit words per slab row: zeros, word 0 .. word 16 NTZ, zeros; 20 or 12
  // mod 32, so the two runs of words a load instruction reads miss each
  // other's banks
  static constexpr int ZP = 16 * NTZ + WORD0 + 1 + (NTZ % 2 ? 0 : 8);
  static constexpr int ROWS = BF_MAX_TILES / NTZ;  // y-rows of tiles a tap warp takes at most
  static constexpr int PW = 16 * NTZ * 8;  // floats of a tap warp's xz sums of a slab, [z][c]
  static_assert(ZP % 32 >= 9 && ZP % 32 <= 23 && ZP % 4 == 0, "banks");
  // 32-bit words of shared memory a block: the ring of slabs, and for two
  // slabs every tap warp's xz sums and every lane's xy sums, [y][g][c]
  static int words(int Y) { return RING * (Y + 2) * ZP + 2 * (BF_TAP_WARPS * PW + Y * XYS); }
};

// d = a @ b + d on one m16n8k16 tile (bf16 operands, float32 accumulators).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The block's barrier, for code where the tap and pooling warps reach it from
// loops of their own: barrier.sync without .aligned (which __syncthreads
// compiles to) is defined when whole warps take different paths; both roles
// arrive at it the same number of times.
__device__ __forceinline__ void block_barrier() { asm volatile("barrier.sync 0;" ::: "memory"); }

template <int NTZ>
__global__ void __launch_bounds__(BF_THREADS, 1)
stem_pool_bf16_kernel(const __nv_bfloat16* __restrict__ tsdf,
                      const __nv_bfloat16* __restrict__ weight,
                      const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ xz,
                      __nv_bfloat16* __restrict__ xy, __nv_bfloat16* __restrict__ yz, int X,
                      int Y, int Z, int C) {
  using G = PairGeometry<NTZ>;
  constexpr int ZP = G::ZP, ROWS = G::ROWS, PW = G::PW;
  extern __shared__ __align__(16) unsigned pair_smem[];
  const int slab = (Y + 2) * ZP, nzr = (Z + 3) / 4;
  unsigned* ring = pair_smem;  // RING pair slabs; slab xx at slot xx & 3
  // slab x's xz sums of tap warp w at part + (x & 1) * BF_TAP_WARPS * PW + w * PW,
  // its lanes' xy sums of row y at part_xy + (x & 1) * Y * XYS + y * XYS
  float* part = reinterpret_cast<float*>(pair_smem + RING * slab);
  float* part_xy = part + 2 * BF_TAP_WARPS * PW;

  const int groups = C / 8;
  const int b = blockIdx.x / groups, c0 = (blockIdx.x % groups) * 8;
  const int tid = threadIdx.x, warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  const bool taps = warp < BF_TAP_WARPS;
  const int pt = tid - BF_TAP_THREADS;  // a pooling thread's index
  const unsigned short* vol = reinterpret_cast<const unsigned short*>(tsdf) + (size_t)b * X * Y * Z;
  // rows of the TSDF are read four values at a time where every row start is aligned
  const bool vec = Z % 4 == 0 && reinterpret_cast<size_t>(tsdf) % 8 == 0;

  for (int i = tid; i < RING * slab; i += blockDim.x) ring[i] = 0u;

  // a pooling thread's 4-z runs (y, z0) of a slab; y < 0 where it has none
  const int nrun = Y * nzr;
  int ry[BF_FETCH], rz[BF_FETCH];
#pragma unroll
  for (int k = 0; k < BF_FETCH; ++k) {
    const int r = pt + k * BF_POOL_THREADS;
    ry[k] = !taps && r < nrun ? r / nzr : -1;
    rz[k] = 4 * (r % nzr);
  }
  // the runs of slab xx as bf16 bits, s[z0 .. z0 + 3] in v and s[z0 + 4] in e
  // (zeros past Z and outside 0 .. X-1)
  auto fetch = [&](int xx, uint2 (&v)[BF_FETCH], unsigned (&e)[BF_FETCH]) {
#pragma unroll
    for (int k = 0; k < BF_FETCH; ++k) {
      v[k] = make_uint2(0u, 0u);
      e[k] = 0u;
      if (ry[k] < 0 || xx < 0 || xx >= X) continue;
      const int z0 = rz[k];
      const unsigned short* src = vol + ((size_t)xx * Y + ry[k]) * Z + z0;
      if (vec) {  // Z % 4 == 0: the run lies wholly inside the row
        v[k] = __ldg(reinterpret_cast<const uint2*>(src));
      } else {
        unsigned s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = z0 + j < Z ? __ldg(src + j) : 0u;
        v[k] = make_uint2(s[0] | s[1] << 16, s[2] | s[3] << 16);
      }
      if (z0 + 4 < Z) e[k] = __ldg(src + 4);
    }
  };
  // a run's pair words z0 + 1 .. z0 + 4 into row y + 1 of slab xx (word j at
  // index WORD0 + j), and word 0 = (0, s[0]) from the run at z0 = 0
  auto put = [&](int xx, const uint2 (&v)[BF_FETCH], const unsigned (&e)[BF_FETCH]) {
    unsigned* dst0 = ring + (xx & (RING - 1)) * slab;
#pragma unroll
    for (int k = 0; k < BF_FETCH; ++k) {
      if (ry[k] < 0) continue;
      unsigned* dst = dst0 + (ry[k] + 1) * ZP + WORD0 + rz[k] + 1;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(v[k].x, __byte_perm(v[k].x, v[k].y, 0x5432), v[k].y,
                     __byte_perm(v[k].y, e[k], 0x5432));
      if (rz[k] == 0) dst[-1] = v[k].x << 16;
    }
  };

  // the tap warps' rows: the NTZ tiles of each of `mine` y-rows from y0, in
  // the first nw warps
  const int rows = (Y + BF_TAP_WARPS - 1) / BF_TAP_WARPS, nw = (Y + rows - 1) / rows;
  const int y0 = warp * rows, mine = taps ? min(rows, Y - y0) : 0;
  // slab xp's planes from the tap warps' sums: xy[b, y, xp, c] = mean over z,
  // a pooling thread per (y, 4 channels) adding the row's 8 lanes of each t
  // in lane order; xz[b, z, xp, c] = mean over y, a pooling thread per (z, 4
  // channels) adding the warps' sums over their rows in warp order
  auto pool = [&](int xp, int first, int stride) {
    const float* sums = part + (xp & 1) * BF_TAP_WARPS * PW;
    const float* sums_xy = part_xy + (xp & 1) * Y * XYS;
    for (int job = first; job < 2 * (Y + Z); job += stride) {
      const int c = job % 2 * 4;
      float4 u[BF_TAP_WARPS];
      int n;
      __nv_bfloat16* dst;
      float inv;
      if (job < 2 * Y) {
        const int yy = job / 2;
#pragma unroll
        for (int k = 0; k < 8; ++k) u[k] = ld4(sums_xy + yy * XYS + 8 * k + c);
        n = 8;
        dst = xy + (((size_t)b * Y + yy) * X + xp) * C;
        inv = (float)Z;
      } else {
        const int z = job / 2 - Y;
#pragma unroll
        for (int w = 0; w < BF_TAP_WARPS; ++w)
          if (w < nw) u[w] = ld4(sums + w * PW + z * 8 + c);
        n = nw;
        dst = xz + (((size_t)b * Z + z) * X + xp) * C;
        inv = (float)Y;
      }
      float4 sum = u[0];
#pragma unroll
      for (int k = 1; k < BF_TAP_WARPS; ++k) {
        if (k >= n) break;
        sum.x += u[k].x;
        sum.y += u[k].y;
        sum.z += u[k].z;
        sum.w += u[k].w;
      }
      store4(dst + c0 + c, make_float4(sum.x / inv, sum.y / inv, sum.z / inv, sum.w / inv));
    }
  };

  __syncthreads();  // the ring's zeros before the first slabs

  // The pooling warps: slabs 0 and 1, then each slab x: load slab x + 2,
  // finish slab x - 1's planes, store slab x + 2.
  if (!taps) {
    uint2 nv[BF_FETCH];
    unsigned ne[BF_FETCH];
    fetch(0, nv, ne);
    put(0, nv, ne);
    fetch(1, nv, ne);
    put(1, nv, ne);
    block_barrier();
    for (int x = 0; x < X; ++x) {
      fetch(x + 2, nv, ne);  // its load overlaps the sums
      if (x > 0) pool(x - 1, pt, BF_POOL_THREADS);
      if (x + 1 < X) put(x + 2, nv, ne);
      block_barrier();  // slab x's sums are whole, and slab x + 2 sits in the ring
    }
    pool(X - 1, pt, BF_POOL_THREADS);
    return;
  }

  // The tap warps.
  // the block's B fragments (k-step s; lane (g, t) holds channel c0 + g's
  // taps of pairs t and t + 4) and the biases of its accumulators' channels
  uint2 bw[3];
  const unsigned short* wc = reinterpret_cast<const unsigned short*>(weight) + (c0 + g) * 27;
  // column (dx, dy)'s pair: (dz 0, dz 1) for even t, (0, dz 2) for odd t
  auto pair = [&](int dx, int dy) {
    const unsigned short* col = wc + (dx * 3 + dy) * 3;
    return t % 2 == 0 ? (unsigned)__ldg(col) | (unsigned)__ldg(col + 1) << 16
                      : (unsigned)__ldg(col + 2) << 16;
  };
#pragma unroll
  for (int s = 0; s < 3; ++s) bw[s] = make_uint2(pair(s, t / 2), t < 2 ? pair(s, 2) : 0u);
  const float bias0 = __bfloat162float(bias[c0 + 2 * t]);
  const float bias1 = __bfloat162float(bias[c0 + 2 * t + 1]);

  // a lane's words in a slab for row g of tile (y0, z 0..15): registers 0/1
  // take pair t (column dy = t / 2), registers 2/3 pair t + 4 (column dy = 2)
  const int o0 = (y0 + t / 2) * ZP + WORD0 + g + t % 2, o1 = (y0 + 2) * ZP + WORD0 + g + t % 2;
  // whether the lane's voxels g and g + 8 of a row's last tile lie inside Z
  const bool in0 = 16 * (NTZ - 1) + g < Z, in8 = 16 * (NTZ - 1) + g + 8 < Z;

  float pool_yz[ROWS][NTZ][4];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int zt = 0; zt < NTZ; ++zt)
#pragma unroll
      for (int k = 0; k < 4; ++k) pool_yz[j][zt][k] = 0.f;

  block_barrier();  // slabs 0 and 1 sit in the ring
  for (int x = 0; x < X; ++x) {
    if (mine > 0) {
      const unsigned* p0[3];  // slabs x - 1, x, x + 1 at the lane's words of tile (y0, 0)
      const unsigned* p1[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        p0[s] = ring + ((x + s - 1) & (RING - 1)) * slab + o0;
        p1[s] = ring + ((x + s - 1) & (RING - 1)) * slab + o1;
      }
      float sxz[NTZ][4];  // the lane's values summed over the warp's rows
#pragma unroll
      for (int zt = 0; zt < NTZ; ++zt)
#pragma unroll
        for (int k = 0; k < 4; ++k) sxz[zt][k] = 0.f;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (j >= mine) break;
        float sxy[2] = {0.f, 0.f};  // the lane's values of row j summed over its z
#pragma unroll
        for (int zt = 0; zt < NTZ; ++zt) {
          const int w = j * ZP + 16 * zt;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            const unsigned a[4] = {p0[s][w], p0[s][w + 8], p1[s][w], p1[s][w + 8]};
            mma_bf16(d, a, bw[s]);
          }
          const float r[4] = {fmaxf(d[0] + bias0, 0.f), fmaxf(d[1] + bias1, 0.f),
                              fmaxf(d[2] + bias0, 0.f), fmaxf(d[3] + bias1, 0.f)};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            pool_yz[j][zt][k] += r[k];
            sxz[zt][k] += r[k];
          }
          if (zt < NTZ - 1 || in0) sxy[0] += r[0], sxy[1] += r[1];
          if (zt < NTZ - 1 || in8) sxy[0] += r[2], sxy[1] += r[3];
        }
        // the lane's xy sums of row y0 + j, [g][c], for the pooling warps
        float* row_xy = part_xy + ((x & 1) * Y + y0 + j) * XYS + g * 8 + 2 * t;
        *reinterpret_cast<float2*>(row_xy) = make_float2(sxy[0], sxy[1]);
      }
      // the warp's xz sums of slab x, [z][c], for the pooling warps
      float* sums = part + (x & 1) * BF_TAP_WARPS * PW + warp * PW + g * 8 + 2 * t;
#pragma unroll
      for (int zt = 0; zt < NTZ; ++zt) {
        *reinterpret_cast<float2*>(sums + 16 * zt * 8) = make_float2(sxz[zt][0], sxz[zt][1]);
        *reinterpret_cast<float2*>(sums + (16 * zt + 8) * 8) =
            make_float2(sxz[zt][2], sxz[zt][3]);
      }
    }
    block_barrier();
  }
  // yz[b, z, y, c] = mean over x, a bf16 pair of channels a store
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (j >= mine) break;
#pragma unroll
    for (int zt = 0; zt < NTZ; ++zt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int z = 16 * zt + g + 8 * h;
        if (z < Z)
          *reinterpret_cast<__nv_bfloat162*>(yz + (((size_t)b * Z + z) * Y + y0 + j) * C + c0 +
                                             2 * t) =
              __floats2bfloat162_rn(pool_yz[j][zt][2 * h] / (float)X,
                                    pool_yz[j][zt][2 * h + 1] / (float)X);
      }
  }
}

// m16 tiles a slab row at Z (each kernel instance takes one count)
int tiles_per_row(int Z) { return (Z + 15) / 16; }

// the dynamic shared bytes of the instance for Z, or 0 for a Z none takes
int bf16_shared_bytes(int Y, int Z) {
  switch (tiles_per_row(Z)) {
    case 1: return 4 * PairGeometry<1>::words(Y);
    case 2: return 4 * PairGeometry<2>::words(Y);
    case 3: return 4 * PairGeometry<3>::words(Y);
    default: return 0;
  }
}

template <int NTZ>
int launch_bf16(const __nv_bfloat16* tsdf, const __nv_bfloat16* weight,
                const __nv_bfloat16* bias, __nv_bfloat16* xz, __nv_bfloat16* xy,
                __nv_bfloat16* yz, const int* info, int X, int Y, int Z, int C, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(stem_pool_bf16_kernel<NTZ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, info[2]);
  if (e != cudaSuccess) return (int)e;
  stem_pool_bf16_kernel<NTZ><<<info[0], info[1], info[2], (cudaStream_t)stream>>>(
      tsdf, weight, bias, xz, xy, yz, X, Y, Z, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch configuration of the bf16 kernel for these shapes, as
// stem_pool_config's: info[4] = {blocks, threads per block, dynamic shared
// bytes per block, channels per block}, or cudaErrorInvalidValue. It takes
// Z up to 48 (three m16 tiles a row) and Y up to 10 warps' rows of tiles
// (40 at Z > 32, 60 at Z > 16, else 120).
extern "C" int stem_pool_bf16_config(int B, int X, int Y, int Z, int C, int* info) {
  const int ntz = tiles_per_row(Z);
  const size_t shmem = Z < 1 || Y < 1 ? 0 : (size_t)bf16_shared_bytes(Y, Z);
  if (B < 1 || X < 1 || shmem == 0 || C < 8 || C % 8 != 0 ||
      (Y + BF_TAP_WARPS - 1) / BF_TAP_WARPS * ntz > BF_MAX_TILES || shmem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  info[0] = B * (C / 8);
  info[1] = BF_THREADS;
  info[2] = (int)shmem;
  info[3] = 8;
  return 0;
}

// bf16 TSDF (B, X, Y, Z), weights (C, 27) and bias (C) -> bf16 planes.
extern "C" int stem_pool_bf16(const __nv_bfloat16* tsdf, const __nv_bfloat16* weight,
                              const __nv_bfloat16* bias, __nv_bfloat16* xz, __nv_bfloat16* xy,
                              __nv_bfloat16* yz, int B, int X, int Y, int Z, int C,
                              void* stream) {
  int info[4];
  int err = stem_pool_bf16_config(B, X, Y, Z, C, info);
  if (err) return err;
  switch (tiles_per_row(Z)) {
    case 1: return launch_bf16<1>(tsdf, weight, bias, xz, xy, yz, info, X, Y, Z, C, stream);
    case 2: return launch_bf16<2>(tsdf, weight, bias, xz, xy, yz, info, X, Y, Z, C, stream);
    default: return launch_bf16<3>(tsdf, weight, bias, xz, xy, yz, info, X, Y, Z, C, stream);
  }
}
