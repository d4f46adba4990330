// K6 grid decode: the GIGA affordance decoder on the R^3 query lattice of B
// scenes, straight from each scene's 3D feature grid, for Hopper (sm_90a).
// One entry point, grid_decode_f32.
//
// It replaces no Pallas kernel. The JAX package decodes a feature-grid model
// (giga_grid: ConvONet's 3D grid encoder under GIGA's heads) with XLA:
// giga_tpu/inference/dense_decode.py, ``_lattice_features`` (the grid
// sampled trilinearly on the lattice), then ``decode_dense_batched``'s dense
// branch. The port's module path runs the same two steps in PyTorch
// (giga_tpu_torch/inference/dense_decode.py, ops/sampling.py); this kernel
// is the two fused, for the batched planning program in float32.
//
// For every point (x, y, z) of scene b's lattice and every head e (qual,
// rot, width):
//   f    = grid[b] (G^3 cells of C = 32 channels, laid out [z, y, x, c])
//          sampled at the point: on each axis the lower and upper taps i0,
//          i1 and the upper weight w of ops/sampling._axis_taps (the same
//          three (R,) vectors on the three axes of a cubic grid and
//          lattice), interpolated x first, then y, then z, each step
//          a * (1 - w) + b * w
//   net  = (px[x] + py[y]) + pz[z]                  (fc_p terms, bias in px)
//   for each block i:
//     net = (net + f @ wc[i, e]) + bc[i, e]        (fc_c and its bias)
//     net += relu(relu(net) @ w0[i,e] + b0[i,e]) @ w1[i,e] + b1[i,e]
//   out = relu(net) @ wout[e] + bout[e]             (OE = 4 values)
// Only the grid is read and only the heads are written: out (B, E*OE, R^3),
// K2's layout, points flattened as (x*R + y)*R + z.
//
// What bounds it: at B=64, R=G=40, C=32, 5 blocks and 3 heads the count is
// 395 GFLOP (96,492 operations a point: the 8-tap sample, fc_p, and per
// head and block fc_c, fc_0, fc_1 and their biases and adds, then the
// head) against 721 MB (the grids read once, the heads written once):
// 5.90 ms at the H100's 67 TFLOP/s fp32 rate against 0.22 ms at 3.35 TB/s,
// ~550 operations a byte, far above fp32's ridge of ~20. It is bound by
// fp32 FMA issue on the CUDA cores. The module path it replaces turns that
// work into cuBLAS GEMMs on 96 x 96 block-diagonal trunk weights (3x the
// multiply-adds) and elementwise passes over a (B, R^3, 96) float32 hidden
// state (1.57 GB a tensor at B=64): memory-bound, ~98 ms.
//
// Design:
//  1. K2's register-tiled per-head trunk (trunk_tiled.cuh, included
//     unchanged) and its persistent blocks: the grid is (blocks per head,
//     heads); a block copies its head's trunk weights, fc_c weights (NB, C,
//     H) and fc_c biases into shared memory once; its warps stride over
//     (scene, P-point tile) pairs with no block barrier, a lane a TP-point x
//     TC-column micro-tile of the residual stream, in registers. Each head
//     runs as its own 32-wide trunk: no zero multiply-adds.
//  2. fc_c is a third product in every block, read from a per-warp feature
//     buffer laid out as the trunk's activation buffer ([c][S]), so it runs
//     on the same register tiles and shared-memory broadcasts as fc_0 and
//     fc_1.
//  3. The sampling fills that buffer once a tile and every block reads it.
//     Lane c owns channel c, so each of a point's 8 taps is one coalesced
//     128-byte row of the grid, through the read-only path, and 4 points'
//     values reach shared memory as one 16-byte store, free of bank
//     conflicts. The interpolation is __fmul_rn / __fadd_rn in the module
//     path's order, so the features equal the module path's bit for bit.
//  4. Two buffers a warp (activations and features, 4.6 KB each for a 4 x 8
//     micro-tile, 32 points a tile) and the head's 63.9 KB of weights fit
//     16 warps a block, one block an SM (211,344 bytes of shared memory at
//     NB = 5): four warps on each of an SM's schedulers. A lane's 32
//     accumulators and 32 residual values take 123 registers, no spills.
// The A/B at B=64, R=40 (NVIDIA H100 80GB HBM3, 700 W; a copy of this
// source with other constants): 8 x 8 micro-tiles at 8 warps 13.3 ms; 4 x 8
// at 12 warps 12.8, at 16 warps 12.0 (8 x 4 the same); the product's k loop
// unrolled 4 steps at a time 11.1 (1: 12.7, 8: 11.7). Without the sampling
// the kernel takes 9.7 ms. A branchy reuse of each z-tap's row between
// consecutive points, and the taps of one point a lane passed by shuffles,
// were no faster; tap loads made branch-free were slower.
// The residual and hidden streams never leave registers and shared memory.
// Sums run as K2's, one fmaf per term with k ascending; the fc_c sum is
// (net + f @ wc) + bc, the module path's order. The ragged last tile
// computes clamped points and masks their stores. Resources and time:
// PERF.md §6 (chip_smoke.py phase 40 prints them).

#include <mutex>

#include "trunk_tiled.cuh"

namespace {

using trunk::H;
using trunk::OE;
// The design (an A/B rewrites these constants in a copy of this source):
constexpr int TP = 4;          // points of a lane's micro-tile
constexpr int TC = 8;          // columns of a lane's micro-tile
constexpr int WARPS = 16;      // warps per block
constexpr int MIN_BLOCKS = 1;  // resident blocks per SM asked of ptxas
constexpr int KUNROLL = 4;     // k steps of a product unrolled at a time
constexpr int C = 32;          // feature channels: one a lane
constexpr int THREADS = 32 * WARPS;
using Lane = tiled::Lane<TP, TC, KUNROLL>;
constexpr int P = Lane::P;
static_assert(C == H, "fc_c runs on the trunk's (H, H) products");
static_assert(P % 4 == 0, "the sampling stores 4 points at a time");

size_t shared_bytes(int NB) {
  return ((size_t)trunk::weight_floats(NB) + (size_t)NB * (C * H + H) +
          (size_t)WARPS * 2 * Lane::ACT_FLOATS) * sizeof(float);
}

// a * (1 - w) + b * w, each operation rounded on its own as the module
// path's elementwise operations round it (no fused multiply-add)
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, w)), __fmul_rn(b, w));
}

// feat[lane * S + p] = channel `lane` of the trilinear sample at tile point
// p, for the P points from `base` (points past N - 1 repeat N - 1). `g` is
// the scene's grid, offset by the lane's channel; i0, i1 and w are the
// (R,) taps and upper weights of every axis.
__device__ __forceinline__ void sample_tile(float* feat, const float* __restrict__ g,
                                            const int* __restrict__ i0,
                                            const int* __restrict__ i1,
                                            const float* __restrict__ w, int base, int N, int R,
                                            int G, int lane) {
  const int GC = G * C, GGC = G * GC;
  int n = base, x = n / (R * R), y = (n / R) % R, z = n % R;
  int ox0, ox1, oy0, oy1;
  float wx, wy;
  auto xy_taps = [&]() {  // row offsets and weights of x and y: new at each z-line
    ox0 = __ldg(i0 + x) * C;
    ox1 = __ldg(i1 + x) * C;
    wx = __ldg(w + x);
    oy0 = __ldg(i0 + y) * GC;
    oy1 = __ldg(i1 + y) * GC;
    wy = __ldg(w + y);
  };
  xy_taps();
  float* dst = feat + lane * Lane::S;
  for (int p0 = 0; p0 < P; p0 += 4) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* r0 = g + __ldg(i0 + z) * GGC;
      const float* r1 = g + __ldg(i1 + z) * GGC;
      const float wz = __ldg(w + z);
      const float c00 = lerp(__ldg(r0 + oy0 + ox0), __ldg(r0 + oy0 + ox1), wx);
      const float c01 = lerp(__ldg(r0 + oy1 + ox0), __ldg(r0 + oy1 + ox1), wx);
      const float c10 = lerp(__ldg(r1 + oy0 + ox0), __ldg(r1 + oy0 + ox1), wx);
      const float c11 = lerp(__ldg(r1 + oy1 + ox0), __ldg(r1 + oy1 + ox1), wx);
      v[q] = lerp(lerp(c00, c01, wy), lerp(c10, c11, wy), wz);
      if (n < N - 1) {
        ++n;
        if (++z == R) {
          z = 0;
          if (++y == R) {
            y = 0;
            ++x;
          }
          xy_taps();
        }
      }
    }
    *reinterpret_cast<float4*>(dst + p0) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
grid_decode_kernel(const float* __restrict__ grid, const int* __restrict__ taps,
                   const float* __restrict__ tw, const float* __restrict__ px,
                   const float* __restrict__ py, const float* __restrict__ pz,
                   const float* __restrict__ wc, const float* __restrict__ bc,
                   const float* __restrict__ w0, const float* __restrict__ b0,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ wout, const float* __restrict__ bout,
                   float* __restrict__ out, int B, int R, int G, int E, int NB) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.y, F = E * H, col = e * H;
  const trunk::Weights s = trunk::load_weights(smem, w0, b0, w1, b1, wout, bout, e, E, NB);
  float* swc = smem + trunk::weight_floats(NB);  // (NB, C, H): the head's fc_c columns
  float* sbc = swc + NB * C * H;                  // (NB, H)
  for (int i = threadIdx.x; i < NB * C * H; i += blockDim.x)
    swc[i] = wc[(size_t)(i / H) * F + col + i % H];
  for (int i = threadIdx.x; i < NB * H; i += blockDim.x)
    sbc[i] = bc[(size_t)(i / H) * F + col + i % H];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* act = sbc + NB * H + warp * 2 * Lane::ACT_FLOATS;
  float* feat = act + Lane::ACT_FLOATS;
  const Lane ln(lane);
  __syncthreads();

  const int RR = R * R, N = RR * R;
  const int tiles = (N + P - 1) / P;
  const long units = (long)B * tiles;
  const size_t scene = (size_t)G * G * G * C;
  for (long u = (long)blockIdx.x * WARPS + warp; u < units; u += (long)gridDim.x * WARPS) {
    const int b = (int)(u / tiles);
    const int base = (int)(u % tiles) * P;
    __syncwarp();  // the last tile's reads of `feat` are done
    sample_tile(feat, grid + b * scene + lane, taps, taps + R, tw, base, N, R, G, lane);
    __syncwarp();
    float net[TP][TC];
    {
      const float* rx[TP];
      const float* ry[TP];
      const float* rz[TP];
#pragma unroll
      for (int p = 0; p < TP; ++p) {
        const int n = min(base + ln.point(p), N - 1);  // the ragged tile's clamped points
        rx[p] = px + (size_t)(n / RR) * F + col;
        ry[p] = py + (size_t)((n / R) % R) * F + col;
        rz[p] = pz + (size_t)(n % R) * F + col;
      }
      tiled::set_rows(net, rx, ln);
      tiled::add_rows(net, ry, ln);
      tiled::add_rows(net, rz, ln);
    }
    for (int blk = 0; blk < NB; ++blk) {
      float acc[TP][TC];
      tiled::product(acc, feat, swc + blk * C * H, ln);
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float bias = sbc[blk * H + ln.column(c)];
#pragma unroll
        for (int p = 0; p < TP; ++p) net[p][c] = (net[p][c] + acc[p][c]) + bias;
      }
      tiled::resnet_block<false>(net, act, s, blk, ln);
    }
    float4 o[Lane::OUTS];
    tiled::head_out(o, net, act, s, ln, lane);
#pragma unroll
    for (int i = 0; i < Lane::OUTS; ++i) {
      const int n = base + lane + 32 * i;
      if (lane + 32 * i >= P || n >= N) break;
      float* dst = out + ((size_t)b * E * OE + e * OE) * N + n;
      dst[0] = o[i].x;
      dst[N] = o[i].y;
      dst[2 * (size_t)N] = o[i].z;
      dst[3 * (size_t)N] = o[i].w;
    }
  }
}

// The resident blocks per SM and the SMs of the current device for NB
// blocks, found once per device and NB (cudaFuncSetAttribute and the
// occupancy query cost microseconds); later launches reuse them. As K2's:
// the largest carve-out first, then the one that holds those blocks (1 KB
// reserved a block), the rest of the SM's 256 KB left to L1.
int occupancy(int NB, int* per_sm, int* sms) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static int cached[kDevices][3];  // {NB + 1, per_sm, sms}; 0 is empty
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kDevices && cached[dev][0] == NB + 1) {
    *per_sm = cached[dev][1];
    *sms = cached[dev][2];
    return 0;
  }
  const size_t shmem = shared_bytes(NB);
  const void* kernel = (const void*)grid_decode_kernel;
  int limit = 0;
  if ((err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return (int)err;
  if (shmem > (size_t)limit) return (int)cudaErrorInvalidConfiguration;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)shmem)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS, shmem)))
    return (int)err;
  const int carveout = (int)((*per_sm * (shmem + 1024) * 100 + 228 * 1024 - 1) / (228 * 1024));
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  carveout < 100 ? carveout : 100)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS, shmem)) ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (dev < kDevices) {
    cached[dev][0] = NB + 1;
    cached[dev][1] = *per_sm;
    cached[dev][2] = *sms;
  }
  return 0;
}

// Launch configuration: info = {resident blocks per SM, SMs, blocks per head
// (grid.x), heads (grid.y), threads per block, dynamic shared bytes, warps}.
// Refuses (cudaErrorInvalidValue) the shapes the kernel does not take: C
// other than 32, and point or grid offsets past 32-bit ints.
int configure(int B, int R, int G, int Cin, int E, int NB, int* info) {
  if (B < 1 || R < 1 || G < 1 || E < 1 || NB < 0 || Cin != C ||
      (long long)R * R * R > 0x7fffffffLL || (long long)G * G * G * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const int err = occupancy(NB, &per_sm, &sms);
  if (err) return err;
  const long long units = (long long)B * (((long long)R * R * R + P - 1) / P);
  long long per_head = (long long)per_sm * sms / E;
  per_head = per_head < 1 ? 1 : per_head;
  const long long needed = (units + WARPS - 1) / WARPS;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = (int)(per_head < needed ? per_head : needed);
  info[3] = E;
  info[4] = THREADS;
  info[5] = (int)shared_bytes(NB);
  info[6] = WARPS;
  return 0;
}

}  // namespace

// K6: grid (B, G, G, G, C) [b, z, y, x, c]; taps (2, R) int32 (lower, upper)
// and tw (R,) upper weights of every axis; px/py/pz (R, E*H), the fc_p bias
// in px; wc (NB, C, E*H), bc (NB, E*H); the per-head trunk and head weights
// (trunk.cuh) -> out (B, E*OE, R^3).
extern "C" int grid_decode_f32(const float* grid, const int* taps, const float* tw,
                               const float* px, const float* py, const float* pz,
                               const float* wc, const float* bc, const float* w0,
                               const float* b0, const float* w1, const float* b1,
                               const float* wout, const float* bout, float* out, int B, int R,
                               int G, int Cin, int E, int NB, void* stream) {
  int info[7];
  const int err = configure(B, R, G, Cin, E, NB, info);
  if (err) return err;
  grid_decode_kernel<<<dim3(info[2], E), THREADS, info[5], (cudaStream_t)stream>>>(
      grid, taps, tw, px, py, pz, wc, bc, w0, b0, w1, b1, wout, bout, out, B, R, G, E, NB);
  return (int)cudaGetLastError();
}

// The launch configuration K6 takes for these shapes, into info[7] (see
// configure).
extern "C" int grid_decode_config(int B, int R, int G, int Cin, int E, int NB, int* info) {
  return configure(B, R, G, Cin, E, NB, info);
}

extern "C" int grid_decode_hidden() { return H; }
extern "C" int grid_decode_outputs() { return OE; }
extern "C" int grid_decode_channels() { return C; }
