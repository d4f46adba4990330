// Dense-decode trunk of the GIGA affordance decoder from precomputed plane
// projections, for Hopper (sm_90a). Four entry points:
//
//   K2 dense_decode_f32: replaces giga_tpu/ops/pallas/decoder_kernel.py::
//      fused_dense_decode_batched (pallas_call at :348, body
//      _trunk_kernel_batched :161), B scenes, output (B, E*OE, R^3).
//   K3 dense_decode_single_f32: replaces decoder_kernel.py::
//      fused_dense_decode (pallas_call at :153, body _trunk_kernel :75),
//      one scene, output (R, R, R, E*OE) indexed [x, y, z, o].
//   dense_decode_bf16, dense_decode_single_bf16: the same two in the TPU
//      kernels' compute_dtype=bf16 mode (every input bf16, the products'
//      operands bf16, their sums float32; the output float32), on the
//      tensor cores: see "bf16 mode" below.
//   K2's numeric options, as fused_dense_decode_batched takes them (K3 has
//   none): dense_decode_f32_fold and dense_decode_bf16_fold (fold_b1: the
//   caller folded block i's b1 into block i+1's pxz, so every block but the
//   last skips its b1 add); dense_decode_bf16_resident and
//   dense_decode_bf16_resident_fold (resident_bf16: the residual stream held
//   in bf16, rounded after the block-0 assembly, after each plane add and
//   after each residual add). hidden_bf16 is the bf16 mode's own function
//   (trunk_mma.cuh), so it has no entry point. Each option is a template
//   instance of its mode's kernel; fold_b1 picks the instance of the tiled
//   trunk per block, the mma trunk takes a flag (the faster of the two
//   forms for each, by ab_dense_decode.py --options). At B=64, R=40 on an
//   NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 19; ptxas for sm_90a):
//   f32_fold 168 registers, 308/364 bytes of spills, 7.66 ms (default
//   7.61). The bf16 instances share the bf16 kernel's design below; PERF.md
//   §6 has their registers, spills and times.
//
// For every point (x, y, z) of the R^3 query lattice of scene b, and every
// head e (qual, rot, width):
//   net  = px[x] + py[y] + pz[z]                      (fc_p terms, bias in px)
//   for each block i:
//     net += pxz[b,i,x,z] + pxy[b,i,x,y] + pyz[b,i,y,z]  (fc_c terms, bias in pxz)
//     net += relu(relu(net) @ w0[i,e] + b0[i,e]) @ w1[i,e] + b1[i,e]
//   out = relu(net) @ wout[e] + bout[e]               (OE = 4 values)
// Only the OE outputs per head and point reach device memory.
//
// What bounds it: the TPU kernels run the three heads as one 96-wide trunk
// with block-diagonal weights. The off-diagonal blocks are exact zeros, so
// each head runs here as its own 32-wide trunk: the same sums with a third of
// the FMAs. At the serving shape (B=64, R=40, 5 blocks) that is ~10.4k FMAs
// and ~1k adds per point and head, 267 GFLOP per batch (3.99 ms at the
// H100's 67 TFLOP/s fp32 rate), against ~590 MB of projections read and
// ~197 MB of output written (0.23 ms at 3.35 TB/s): bound by fp32 FFMA. K3 is
// the same work for one scene (4.18 GFLOP, 12.3 MB; 0.062 ms).
//
// Design (trunk_tiled.cuh), against the four faults of the one-point-per-
// thread kernel it replaces, which reached 28.5% of that bound:
//  1. Shared loads per FMA. A warp owns a tile of 64 consecutive lattice
//     points x the head's 32 columns, a lane an 8-point x 8-column micro-
//     tile. Each layer is a warp-level product from a per-warp activation
//     buffer: per k, four 16-byte shared loads feed 64 FMAs, 4 FMAs per
//     float loaded (was 1), which is what an SM's 128 bytes a clock from
//     shared memory needs to keep its 128 FMA lanes busy.
//  2. Registers and occupancy. 64 accumulators and the 64 matching `net`
//     values a lane; one block of 12 warps per SM under
//     __launch_bounds__(384, 1), 168 registers a thread. The product's k
//     loop is unrolled two steps at a time: fully unrolled, ptxas hoists
//     the shared loads of many steps and runs out of registers.
//  3. Weight copies. Blocks are persistent: the grid is (resident blocks per
//     SM x SMs / heads, heads), sized from cudaOccupancyMaxActiveBlocksPer-
//     Multiprocessor once per device and NB, then reused. Each block copies
//     its head's weights (42.8 KB at 5 blocks) into shared memory once; its
//     warps then stride over (scene, tile) pairs with no block barrier.
//  4. Row reads. A lane adds only its 8 points x 8 columns of each plane row
//     (two 16-byte loads per point and plane; the 4 lanes of a point group
//     read the row's 128 bytes together), loaded from device memory as the
//     block adds them. K2 writes each output channel as 32 consecutive
//     floats per warp, K3 each point's 4 head outputs as one 16-byte store.
// The sums run in the one-point-per-thread kernel's order, one fmaf per term
// with k ascending, so the outputs equal it bit for bit. The ragged last
// tile (R^3 not a multiple of 64) computes clamped points and masks their
// stores.
//
// Resources at NB = 5 (ptxas for sm_90a; chip_smoke.py prints them from the
// build log): 168 registers, 268/276 bytes of spill stores/loads (K2;
// 320/328 for K3), 147,216 bytes of shared memory per block. On an NVIDIA
// H100 80GB HBM3 at 700 W (132 SMs) that is one block per SM, a grid of
// 44 x 3 blocks, and K2 takes 7.61 ms at B=64, R=40, 52% of its bound
// (chip_smoke.py). ab_dense_decode.py times the alternatives and ablations
// (PERF.md): at B=64 the plane-row loads cost K2 about 1.3 ms, the second
// product of every block about 1.8 ms, the activation stores about 0.1 ms.

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "rows_tma.cuh"
#include "trunk_mma.cuh"
#include "trunk_tiled.cuh"

namespace {

using trunk::H;
using trunk::OE;
// The design (ab_dense_decode.py rewrites these constants in a copy of this
// source to time the alternatives):
constexpr int TP = 8;          // points of a lane's micro-tile
constexpr int TC = 8;          // columns of a lane's micro-tile
constexpr int WARPS = 12;      // warps per block
constexpr int MIN_BLOCKS = 1;  // resident blocks per SM asked of ptxas
constexpr int KUNROLL = 2;     // k steps of a product unrolled at a time
constexpr int THREADS = 32 * WARPS;
using Lane = tiled::Lane<TP, TC, KUNROLL>;
constexpr int P = Lane::P;

size_t shared_bytes(int NB) {
  return ((size_t)trunk::weight_floats(NB) + (size_t)WARPS * Lane::ACT_FLOATS) * sizeof(float);
}

template <bool kPointMajor, bool kFoldB1>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_decode_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    const float* __restrict__ pz, const float* __restrict__ pxz,
                    const float* __restrict__ pxy, const float* __restrict__ pyz,
                    const float* __restrict__ w0, const float* __restrict__ b0,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ wout, const float* __restrict__ bout,
                    float* __restrict__ out, int B, int R, int E, int NB) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.y, F = E * H;
  const trunk::Weights s = trunk::load_weights(smem, w0, b0, w1, b1, wout, bout, e, E, NB);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* act = smem + trunk::weight_floats(NB) + warp * Lane::ACT_FLOATS;
  const Lane ln(lane);
  __syncthreads();

  const int RR = R * R, N = RR * R;
  const int tiles = (N + P - 1) / P;
  const long units = (long)B * tiles;
  const int col = e * H;
  for (long u = (long)blockIdx.x * WARPS + warp; u < units; u += (long)gridDim.x * WARPS) {
    const int b = (int)(u / tiles);
    const int base = (int)(u % tiles) * P;
    int xz[TP], xy[TP], yz[TP];
    float net[TP][TC];
    {
      const float* rx[TP];
      const float* ry[TP];
      const float* rz[TP];
#pragma unroll
      for (int p = 0; p < TP; ++p) {
        const int n = min(base + ln.point(p), N - 1);  // the ragged tile's clamped points
        const int x = n / RR, y = (n / R) % R, z = n % R;
        xz[p] = x * R + z;
        xy[p] = x * R + y;
        yz[p] = y * R + z;
        rx[p] = px + (size_t)x * F + col;
        ry[p] = py + (size_t)y * F + col;
        rz[p] = pz + (size_t)z * F + col;
      }
      tiled::set_rows(net, rx, ln);
      tiled::add_rows(net, ry, ln);
      tiled::add_rows(net, rz, ln);
    }
    for (int blk = 0; blk < NB; ++blk) {
      const size_t plane = ((size_t)b * NB + blk) * RR;
      const float* rows[3][TP];
#pragma unroll
      for (int p = 0; p < TP; ++p) {
        rows[0][p] = pxz + (plane + xz[p]) * F + col;
        rows[1][p] = pxy + (plane + xy[p]) * F + col;
        rows[2][p] = pyz + (plane + yz[p]) * F + col;
      }
      tiled::add_rows(net, rows[0], ln);
      tiled::add_rows(net, rows[1], ln);
      tiled::add_rows(net, rows[2], ln);
      if (kFoldB1 && blk < NB - 1)
        tiled::resnet_block<true>(net, act, s, blk, ln);
      else
        tiled::resnet_block<false>(net, act, s, blk, ln);
    }
    float4 o[Lane::OUTS];
    tiled::head_out(o, net, act, s, ln, lane);
#pragma unroll
    for (int i = 0; i < Lane::OUTS; ++i) {
      const int n = base + lane + 32 * i;
      if (lane + 32 * i >= P || n >= N) break;
      if (kPointMajor) {
        reinterpret_cast<float4*>(out)[((size_t)b * N + n) * E + e] = o[i];
      } else {
        float* dst = out + ((size_t)b * E * OE + e * OE) * N + n;
        dst[0] = o[i].x;
        dst[N] = o[i].y;
        dst[2 * (size_t)N] = o[i].z;
        dst[3 * (size_t)N] = o[i].w;
      }
    }
  }
}

// bf16 mode (trunk_mma.cuh, rows_tma.cuh). The same work on the tensor
// cores: 267 GFLOP at B=64 is 0.270 ms at the H100's 989 TFLOP/s dense bf16
// rate, against ~295 MB of bf16 inputs read and ~197 MB of float32 output
// written (0.147 ms at 3.35 TB/s), so its bound is the tensor cores'. A warp
// carries 32 points x a head's 32 columns through mma.sync m16n8k16 (bf16
// operands, float32 accumulators), the residual stream in the accumulator
// layout, each layer's output rounded straight into the next product's A
// fragments (trunk_mma.cuh).
//
// The plane rows. Ablations of the design before this one (32-point tiles
// in flattened order, each lane reading its rows as 4-byte bf16 pairs
// through the read-only path) put ~1.0 of its 2.2 ms at B=64 in the row
// loads, more than any other part (ab_dense_decode.py --bf16, PERF.md §6).
// So the rows follow the lattice here:
//  - A slab is a chunk of an x-plane of one scene: Yc y-lines x Zc
//    z-columns (BfShape). A block works through a contiguous run of the
//    head's slabs; a warp's tile is 32 consecutive points of a slab in
//    (y, z) order, so its 32 pyz rows are consecutive: either the slab
//    spans whole z-lines (Zc = R) or a tile lies in one line (BF_P | Zc).
//    Every point of a slab reads the same px row, its Yc py and pxy rows
//    and its Zc pz and pxz rows: a producer warp brings those 3 + 2 x NB
//    boxes in by TMA, once per slab, into a ring of slab stages, each with
//    a `full` mbarrier (the TMA's bytes) and an `empty` one (one arrival
//    per consumer warp). Every consumer warp waits for each slab of its
//    block's run in turn and releases it once past it, tiles or none: a
//    warp then never waits on a stage's phase before the one it has seen
//    complete, which is what a parity wait can tell apart.
//  - The slab's shape is the host's choice (bf16_shape): whole x-planes
//    (Yc = Zc = R) in BF_SLAB_STAGES stages where they fit a block's shared
//    memory, as at R = 40; else fewer stages, then fewer y-lines, then
//    z-chunks of whole tiles. Only a shape whose weights and smallest
//    slab outgrow the block (NB above ~22 at 15 consumer warps) is refused.
//  - pyz[b,k,y,z] of a tile is 32 consecutive rows, read once: each
//    consumer warp's lane 0 brings them in by TMA, one box per (tile,
//    block), into the warp's own ring of BF_PYZ_STAGES boxes, the next
//    box in flight while the warp computes on this one. Tile and slab
//    indices are 32-bit, the next tile's found once a tile: with 64-bit
//    divisions in every step's fetch the kernel took ~0.1 ms longer.
//  - Every row reaches the registers by ldmatrix, already in the
//    accumulator layout (rows_tma.cuh): one instruction per 16 x 16
//    sub-tile and one shared address a lane per m-tile and plane.
// The values and sums are the previous design's, in its order ((px + py) +
// pz; per block + pxz, + pxy, + pyz; the same MMAs), so the outputs are
// equal to it bit for bit. At NB = 5, R = 40: 15 consumer warps and the
// producer, one block an SM (resources and times: PERF.md §6). The A/B
// there put behind it products by wgmma (bit-equal, ~0.1-0.3 ms slower),
// slab rows widened to float32 once by the producer (no faster), 12 or 16
// consumer warps and deeper rings.
constexpr int BF_MT = 2;           // m16 tiles of a warp: 32 points
constexpr int BF_WARPS = 15;       // consumer warps per block, beside one producer warp
constexpr int BF_MIN_BLOCKS = 1;   // resident blocks per SM asked of ptxas
constexpr int BF_PYZ_STAGES = 2;   // pyz boxes of a consumer warp's ring
constexpr int BF_SLAB_STAGES = 2;  // most slabs of the block's ring
constexpr int BF_THREADS = 32 * (BF_WARPS + 1);
using BfTile = tc::Tile<BF_MT>;
constexpr int BF_P = BfTile::P;
constexpr int BF_PYZ_BYTES = BF_P * rows::ROW_BYTES;
constexpr int BF_MAX_BOX = 256;  // rows of a TMA box at most
using bf16 = __nv_bfloat16;
static_assert(OE % 2 == 0, "head outputs in pairs");
static_assert(H * sizeof(bf16) == rows::ROW_BYTES, "a head's row is one 64-byte TMA row");
static_assert(BF_PYZ_STAGES >= 2, "one pyz box in flight while another is read");

// The slabs: zc z-columns (R, or a multiple of BF_P below R) x yc y-lines
// of an x-plane, cz x cy of them a plane; `stages` slabs in the ring.
struct BfShape {
  int zc, yc, cz, cy, stages;
};

// Byte offsets of the bf16 kernel's shared memory from its 1024-aligned
// base: the head's weights, the slab ring (each slab: the px box, the py
// box and NB pxy boxes of yc rows, the pz box and NB pxz boxes of zc rows),
// the consumer warps' pyz rings, the mbarriers (full and empty per slab
// stage, one per pyz box).
struct BfLayout {
  int ybox, zbox, ys, zs, slab, slabs, pyz, bars, bytes;
  __host__ __device__ BfLayout(const BfShape& s, int NB) {
    ybox = rows::align_up(s.yc * rows::ROW_BYTES, rows::ALIGN);
    zbox = rows::align_up(s.zc * rows::ROW_BYTES, rows::ALIGN);
    ys = rows::ALIGN;  // after the px box
    zs = ys + (NB + 1) * ybox;
    slab = zs + (NB + 1) * zbox;
    slabs = rows::align_up(tc::weight_words(NB) * (int)sizeof(unsigned), rows::ALIGN);
    pyz = slabs + s.stages * slab;
    bars = pyz + BF_WARPS * BF_PYZ_STAGES * BF_PYZ_BYTES;
    bytes = bars + 8 * (2 * s.stages + BF_WARPS * BF_PYZ_STAGES) + rows::ALIGN;
  }
};

// A slab's scene, x and first (y, z) point; slabs run (b, x, y chunk, z
// chunk) with the z chunk fastest. Whole planes (cz = cy = 1) skip the
// chunks' divisions, which every tile would pay.
struct Slab {
  int b, x, y0, z0;
  __device__ Slab(int sl, int R, const BfShape& s) {
    int zi = 0, yi = 0;
    if (s.cz > 1) {
      zi = sl % s.cz;
      sl /= s.cz;
    }
    if (s.cy > 1) {
      yi = sl % s.cy;
      sl /= s.cy;
    }
    x = sl % R;
    b = sl / R;
    y0 = yi * s.yc;
    z0 = zi * s.zc;
  }
};

// The first slab shape in the order of preference above whose layout takes
// at most `limit` bytes, or none (false).
bool bf16_shape(int R, int NB, size_t limit, BfShape* out) {
  int zcs[1 + BF_MAX_BOX / BF_P], n_z = 0;
  if (R <= BF_MAX_BOX) zcs[n_z++] = R;
  for (int c = BF_MAX_BOX / BF_P * BF_P; c >= BF_P; c -= BF_P)  // z-chunks of whole tiles
    if (c < R) zcs[n_z++] = c;  // below R, the least padding past R first
  std::stable_sort(zcs + (R <= BF_MAX_BOX), zcs + n_z,
                   [R](int a, int b) { return (R + a - 1) / a * a < (R + b - 1) / b * b; });
  for (int st = BF_SLAB_STAGES; st >= 1; --st)
    for (int i = 0; i < n_z; ++i)
      for (int cy = (R + BF_MAX_BOX - 1) / BF_MAX_BOX; cy <= R; ++cy) {
        const int yc = (R + cy - 1) / cy;
        if ((R + yc - 1) / yc != cy) continue;  // the same yc as a smaller cy
        const BfShape s{zcs[i], yc, (R + zcs[i] - 1) / zcs[i], cy, st};
        if ((size_t)BfLayout(s, NB).bytes <= limit) {
          *out = s;
          return true;
        }
      }
  return false;
}

template <bool kPointMajor, bool kFoldB1, bool kResident>
__global__ void __launch_bounds__(BF_THREADS, BF_MIN_BLOCKS)
dense_decode_bf16_tma_kernel(const __grid_constant__ CUtensorMap mx,
                             const __grid_constant__ CUtensorMap my,
                             const __grid_constant__ CUtensorMap mz,
                             const __grid_constant__ CUtensorMap mxz,
                             const __grid_constant__ CUtensorMap mxy,
                             const __grid_constant__ CUtensorMap myz, const bf16* __restrict__ w0,
                             const bf16* __restrict__ b0, const bf16* __restrict__ w1,
                             const bf16* __restrict__ b1, const bf16* __restrict__ wout,
                             const bf16* __restrict__ bout, float* __restrict__ out, int B, int R,
                             int E, int NB, const BfShape sh) {
  extern __shared__ __align__(16) unsigned char bsmem[];
  const unsigned raw = rows::smem_addr(bsmem);
  const unsigned base = (raw + rows::ALIGN - 1) & ~(unsigned)(rows::ALIGN - 1);
  unsigned char* gbase = bsmem + (base - raw);
  const BfLayout L(sh, NB);
  const int e = blockIdx.y, col = e * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RR = R * R, N = RR * R, YZ = sh.yc * sh.zc;
  const int tps = (YZ + BF_P - 1) / BF_P;  // tiles per slab
  // the block's tiles: a contiguous run of the head's (slab, tile) order
  const int units = B * R * sh.cy * sh.cz * tps;  // under 2^31 (configure checks)
  const int U0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int U1 = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  if (U0 >= U1) return;
  const int S0 = U0 / tps, S1 = (U1 - 1) / tps;
  const unsigned full = base + L.bars, empty = full + 8 * sh.stages;
  const unsigned pyz_full = empty + 8 * sh.stages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < sh.stages; ++i) {
      rows::bar_init(full + 8 * i, 1);
      rows::bar_init(empty + 8 * i, BF_WARPS);
    }
    for (int i = 0; i < BF_WARPS * BF_PYZ_STAGES; ++i) rows::bar_init(pyz_full + 8 * i, 1);
    rows::bar_init_fence();
  }
  const tc::Weights s = tc::load_weights(reinterpret_cast<unsigned*>(gbase), w0, b0, w1, b1,
                                         wout, bout, e, E, NB);
  __syncthreads();

  if (warp == BF_WARPS) {
    // the producer: each slab's boxes into a slab stage once the slab that
    // used it before is released by every consumer warp
    if (lane == 0) {
      const unsigned bytes = (1 + (NB + 1) * (sh.yc + sh.zc)) * rows::ROW_BYTES;
      for (int sl = S0; sl <= S1; ++sl) {
        const int i = (sl - S0) % sh.stages, use = (sl - S0) / sh.stages;
        if (use > 0) rows::bar_wait(empty + 8 * i, (use - 1) & 1);
        const unsigned bar = full + 8 * i, dst = base + L.slabs + i * L.slab;
        const Slab at(sl, R, sh);
        rows::bar_expect(bar, bytes);
        rows::load_3d(dst, &mx, bar, col, at.x, 0);
        rows::load_3d(dst + L.ys, &my, bar, col, at.y0, 0);
        rows::load_3d(dst + L.zs, &mz, bar, col, at.z0, 0);
        for (int k = 0; k < NB; ++k) {
          const int plane = (at.b * NB + k) * R + at.x;
          rows::load_3d(dst + L.ys + (1 + k) * L.ybox, &mxy, bar, col, at.y0, plane);
          rows::load_3d(dst + L.zs + (1 + k) * L.zbox, &mxz, bar, col, at.z0, plane);
        }
      }
    }
    return;
  }

  // the slab whose rows the warp holds: waited for, not yet released
  int held = S0 - 1;
  auto next_slab = [&]() {
    if (held >= S0) {
      __syncwarp();  // every lane is done with the slab's rows
      if (lane == 0) rows::bar_arrive(empty + 8 * ((held - S0) % sh.stages), 1);
    }
    if (++held <= S1)
      rows::bar_wait(full + 8 * ((held - S0) % sh.stages), (unsigned)((held - S0) / sh.stages) & 1);
  };
  const int chunk = rows::lane_chunk(lane);
  unsigned off_p[BF_MT], off_x[BF_MT];  // a tile's pyz rows are its points; px is one row
#pragma unroll
  for (int m = 0; m < BF_MT; ++m) {
    off_p[m] = rows::offset(rows::lane_point(m, lane), chunk);
    off_x[m] = rows::offset(0, chunk);
  }
  const unsigned pyz = base + L.pyz + warp * BF_PYZ_STAGES * BF_PYZ_BYTES;
  const unsigned pyz_bar = pyz_full + 8 * BF_PYZ_STAGES * warp;
  // where the tile of unit uu lies: its slab, scene, x and the chunk's first
  // (y, z); its first point f0 in the slab's (y, z) order; the first of its
  // 32 consecutive pyz rows, y R + z of that point; and how many of its
  // points lie in the lattice (the rest are padding: past the slab, or past
  // R in a z-chunk)
  struct At {
    int sl, b, x, y0, z0, f0, row, valid;
  };
  auto at = [&](int uu) {
    At a;
    a.sl = uu / tps;
    a.f0 = (uu - a.sl * tps) * BF_P;
    const Slab sb(a.sl, R, sh);
    a.b = sb.b;
    a.x = sb.x;
    a.y0 = sb.y0;
    a.z0 = sb.z0;
    if (sh.zc == R) {  // whole z-lines: the slab's points run on through its lines
      a.row = a.y0 * R + a.f0;
      a.valid = min(YZ - a.f0, RR - a.row);
    } else {  // a z-chunk: the tile lies in one line
      const int yl = a.f0 / sh.zc, z = a.z0 + a.f0 - yl * sh.zc;
      a.row = (a.y0 + yl) * R + z;
      a.valid = min(RR - a.row, R - z);
    }
    return a;
  };
  // lane 0 brings in the pyz box of block k of a tile into a stage
  auto fetch = [&](const At& a, int k, unsigned stage) {
    rows::fence_async();
    rows::bar_expect(pyz_bar + 8 * stage, BF_PYZ_BYTES);
    rows::load_3d(pyz + stage * BF_PYZ_BYTES, &myz, pyz_bar + 8 * stage, col,
                  min(a.row, RR - 1), a.b * NB + k);  // a tile past the plane is padding
  };
  constexpr int AHEAD = BF_PYZ_STAGES - 1;  // steps a fetch runs ahead (configure: NB >= AHEAD)
  int u = U0 + warp;
  At next = at(u);
  if (lane == 0 && u < U1)
    for (int d = 0; d < AHEAD; ++d) fetch(next, d, d);
  unsigned step = 0;
  for (; u < U1; u += BF_WARPS) {
    const At cur = next;
    const bool more = u + BF_WARPS < U1;
    if (more) next = at(u + BF_WARPS);
    const int i = (cur.sl - S0) % sh.stages;
    // each lane's ldmatrix rows of the slab's y and z boxes; padding points
    // past the slab are clamped to its last
    unsigned off_y[BF_MT], off_z[BF_MT];
#pragma unroll
    for (int m = 0; m < BF_MT; ++m) {
      const int f = min(cur.f0 + rows::lane_point(m, lane), YZ - 1);
      const int yl = f / sh.zc;
      off_y[m] = rows::offset(yl, chunk);
      off_z[m] = rows::offset(f - yl * sh.zc, chunk);
    }
    while (held < cur.sl) next_slab();
    const unsigned slab = base + L.slabs + i * L.slab;
    const unsigned ys = slab + L.ys, zs = slab + L.zs;
    BfTile net;
    rows::add<true>(net, slab, off_x);
    rows::add<false>(net, ys, off_y);
    rows::add<false>(net, zs, off_z);
    if (kResident) tc::round_tile(net);
    for (int k = 0; k < NB; ++k, ++step) {
      const unsigned stage = step % BF_PYZ_STAGES;
      __syncwarp();  // the stage refilled now was read a step ago
      if (lane == 0) {
        const unsigned ahead = (step + AHEAD) % BF_PYZ_STAGES;
        if (k + AHEAD < NB)
          fetch(cur, k + AHEAD, ahead);
        else if (more)
          fetch(next, k + AHEAD - NB, ahead);
      }
      rows::add<false>(net, zs + (1 + k) * L.zbox, off_z);
      if (kResident) tc::round_tile(net);
      rows::add<false>(net, ys + (1 + k) * L.ybox, off_y);
      if (kResident) tc::round_tile(net);
      rows::bar_wait(pyz_bar + 8 * stage, (step / BF_PYZ_STAGES) & 1);
      rows::add<false>(net, pyz + stage * BF_PYZ_BYTES, off_p);
      if (kResident) tc::round_tile(net);
      tc::resnet_block<kFoldB1, kResident>(net, s, k, lane, k == NB - 1);
    }
    float o[BF_MT][4];
    tc::head_out(o, net, s, lane);
    // lanes with c >= OE hold padding columns; no early exit, so the warp
    // stays converged for the next tile's mma.sync
    const int c = 2 * (lane % 4);  // this lane's head outputs c, c + 1
#pragma unroll
    for (int m = 0; m < BF_MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = tc::point(m, h, lane);
        const int n = cur.x * RR + cur.row + p;
        if (c < OE && p < cur.valid) {
          if (kPointMajor) {
            reinterpret_cast<float2*>(out)[(((size_t)cur.b * N + n) * E * OE + e * OE + c) / 2] =
                make_float2(o[m][2 * h], o[m][2 * h + 1]);
          } else {
            float* dst = out + ((size_t)cur.b * E * OE + e * OE + c) * N + n;
            dst[0] = o[m][2 * h];
            dst[N] = o[m][2 * h + 1];
          }
        }
      }
  }
  while (held <= S1) next_slab();  // release the rest of the run, tiles or none
}

// A kernel and its launch shape: kBf16 picks the bf16 mode, kPointMajor
// K3's output layout, kFoldB1 and kResident K2's options.
template <bool kBf16, bool kPointMajor, bool kFoldB1 = false, bool kResident = false>
struct Kernel {
  static_assert(kBf16 || !kResident, "the resident stream is a bf16 mode's");
  static constexpr bool bf16 = kBf16;
  static constexpr int threads = kBf16 ? BF_THREADS : THREADS;
  static constexpr int warps = kBf16 ? BF_WARPS : WARPS;  // warps that take tiles
  static constexpr int stages = kBf16 ? BF_PYZ_STAGES : 0;  // a warp's ring of pyz boxes
  // shared bytes a block: the bf16 mode's from its slab shape
  static size_t shared(const BfShape& sh, int NB) {
    return kBf16 ? (size_t)BfLayout(sh, NB).bytes : shared_bytes(NB);
  }
  // warp tiles of B scenes: R^3 points in 64-point runs (float32), slabs
  // in 32-point runs (bf16)
  static long long units(int B, int R, const BfShape& sh) {
    if (kBf16)
      return (long long)B * R * sh.cy * sh.cz * ((sh.yc * sh.zc + BF_P - 1) / BF_P);
    return (long long)B * ((R * R * R + P - 1) / P);
  }
  static const void* function() {
    if constexpr (kBf16)
      return reinterpret_cast<const void*>(
          dense_decode_bf16_tma_kernel<kPointMajor, kFoldB1, kResident>);
    else
      return reinterpret_cast<const void*>(dense_decode_kernel<kPointMajor, kFoldB1>);
  }
};

// Resident blocks per SM and SMs of the current device for a kernel with
// `shmem` bytes of shared memory a block. The first launch on a device (or
// with another size) sets the kernel's shared-memory attributes and asks the
// occupancy; later launches reuse the answer.
struct Occupancy {
  size_t shmem = 0;
  int per_sm = 0, sms = 0;
};

template <class K>
int occupancy(size_t shmem, Occupancy* occ) {
  constexpr int kDevices = 16;
  static std::mutex mu;
  static Occupancy cached[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kDevices && cached[dev].shmem == shmem) {
    *occ = cached[dev];
    return 0;
  }
  const void* kernel = K::function();
  int per_sm = 0, sms = 0;
  // the blocks that registers and the largest carve-out allow; then ask for
  // the carve-out that holds them (1 KB reserved per block), leaving the
  // rest of the SM's 256 KB to L1, and read the occupancy that gives
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)shmem)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K::threads, shmem)))
    return (int)err;
  const int carveout = (int)((per_sm * (shmem + 1024) * 100 + 228 * 1024 - 1) / (228 * 1024));
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  carveout < 100 ? carveout : 100)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K::threads, shmem)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  occ->shmem = shmem;
  occ->per_sm = per_sm;
  occ->sms = sms;
  if (dev < kDevices) cached[dev] = *occ;
  return 0;
}

// Launch configuration: info = {resident blocks per SM, SMs, blocks per head
// (grid.x), heads (grid.y), threads per block, dynamic shared bytes, warps
// that take tiles, stages of a warp's pyz ring, and the bf16 slabs: stages,
// z-columns, y-lines (0 in float32)}; the bf16 slab shape into `shape`.
template <class K>
int configure(int B, int R, int E, int NB, int* info, BfShape* shape = nullptr) {
  BfShape sh{0, 0, 1, 1, 0};
  if (K::bf16) {
    int dev = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e || (e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
      return (int)e;
    // a pyz fetch runs BF_PYZ_STAGES - 1 steps ahead, into the next tile at most
    if (NB < BF_PYZ_STAGES - 1 || !bf16_shape(R, NB, (size_t)limit, &sh))
      return (int)cudaErrorInvalidConfiguration;
  }
  Occupancy occ;
  const int err = occupancy<K>(K::shared(sh, NB), &occ);
  if (err) return err;
  const long long units = K::units(B, R, sh);
  if (K::bf16 && units > 0x7fffffff) return (int)cudaErrorInvalidValue;  // int indices
  long per_head = (long)occ.per_sm * occ.sms / E;
  per_head = per_head < 1 ? 1 : per_head;
  const long needed = (units + K::warps - 1) / K::warps;
  info[0] = occ.per_sm;
  info[1] = occ.sms;
  info[2] = (int)(per_head < needed ? per_head : needed);
  info[3] = E;
  info[4] = K::threads;
  info[5] = (int)K::shared(sh, NB);
  info[6] = K::warps;
  info[7] = K::stages;
  info[8] = sh.stages;
  info[9] = sh.zc;
  info[10] = sh.yc;
  if (shape) *shape = sh;
  return 0;
}

template <bool kPointMajor, bool kFoldB1 = false, bool kResident = false, typename T>
int launch(const T* px, const T* py, const T* pz, const T* pxz, const T* pxy, const T* pyz,
           const T* w0, const T* b0, const T* w1, const T* b1, const T* wout, const T* bout,
           float* out, int B, int R, int E, int NB, void* stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  int info[11];
  BfShape sh;
  int err = configure<Kernel<kBf16, kPointMajor, kFoldB1, kResident>>(B, R, E, NB, info, &sh);
  if (err) return err;
  dim3 grid(info[2], E);
  if constexpr (kBf16) {
    // the row boxes of a slab: px one row, py and pxy (B*NB*R x-rows of R
    // rows) sh.yc rows, pz and pxz sh.zc rows; pyz (B*NB planes of R^2
    // rows) a tile's BF_P
    CUtensorMap mx, my, mz, mxz, mxy, myz;
    const unsigned long long F = E * H, RR = (unsigned long long)R * R, planes = B * NB;
    if ((err = rows::encode_rows(&mx, px, F, R, 1, 1)) ||
        (err = rows::encode_rows(&my, py, F, R, 1, sh.yc)) ||
        (err = rows::encode_rows(&mz, pz, F, R, 1, sh.zc)) ||
        (err = rows::encode_rows(&mxz, pxz, F, R, planes * R, sh.zc)) ||
        (err = rows::encode_rows(&mxy, pxy, F, R, planes * R, sh.yc)) ||
        (err = rows::encode_rows(&myz, pyz, F, RR, planes, BF_P)))
      return err;
    dense_decode_bf16_tma_kernel<kPointMajor, kFoldB1, kResident>
        <<<grid, BF_THREADS, info[5], (cudaStream_t)stream>>>(
            mx, my, mz, mxz, mxy, myz, w0, b0, w1, b1, wout, bout, out, B, R, E, NB, sh);
  } else
    dense_decode_kernel<kPointMajor, kFoldB1><<<grid, THREADS, info[5], (cudaStream_t)stream>>>(
        px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out, B, R, E, NB);
  return (int)cudaGetLastError();
}

}  // namespace

// K2: pxz/pxy/pyz (B, NB, R, R, E*H) -> out (B, E*OE, R^3).
extern "C" int dense_decode_f32(const float* px, const float* py, const float* pz,
                                const float* pxz, const float* pxy, const float* pyz,
                                const float* w0, const float* b0, const float* w1,
                                const float* b1, const float* wout, const float* bout,
                                float* out, int B, int R, int E, int NB, void* stream) {
  return launch<false>(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out,
                       B, R, E, NB, stream);
}

// K3: pxz/pxy/pyz (NB, R, R, E*H) -> out (R, R, R, E*OE).
extern "C" int dense_decode_single_f32(const float* px, const float* py, const float* pz,
                                       const float* pxz, const float* pxy, const float* pyz,
                                       const float* w0, const float* b0, const float* w1,
                                       const float* b1, const float* wout, const float* bout,
                                       float* out, int R, int E, int NB, void* stream) {
  return launch<true>(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out,
                      1, R, E, NB, stream);
}

// K2 in the bf16 mode: every input bf16 (shapes as dense_decode_f32's) ->
// out (B, E*OE, R^3) float32.
extern "C" int dense_decode_bf16(const bf16* px, const bf16* py, const bf16* pz,
                                 const bf16* pxz, const bf16* pxy, const bf16* pyz,
                                 const bf16* w0, const bf16* b0, const bf16* w1, const bf16* b1,
                                 const bf16* wout, const bf16* bout, float* out, int B, int R,
                                 int E, int NB, void* stream) {
  return launch<false>(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out,
                       B, R, E, NB, stream);
}

// K2 with fold_b1, float32 and bf16: inputs from prepare_projections_batched(
// fold_b1=True), every block but the last without its b1 add.
extern "C" int dense_decode_f32_fold(const float* px, const float* py, const float* pz,
                                     const float* pxz, const float* pxy, const float* pyz,
                                     const float* w0, const float* b0, const float* w1,
                                     const float* b1, const float* wout, const float* bout,
                                     float* out, int B, int R, int E, int NB, void* stream) {
  return launch<false, true>(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out,
                             B, R, E, NB, stream);
}

extern "C" int dense_decode_bf16_fold(const bf16* px, const bf16* py, const bf16* pz,
                                      const bf16* pxz, const bf16* pxy, const bf16* pyz,
                                      const bf16* w0, const bf16* b0, const bf16* w1,
                                      const bf16* b1, const bf16* wout, const bf16* bout,
                                      float* out, int B, int R, int E, int NB, void* stream) {
  return launch<false, true>(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out,
                             B, R, E, NB, stream);
}

// K2 bf16 with resident_bf16, without and with fold_b1.
extern "C" int dense_decode_bf16_resident(const bf16* px, const bf16* py, const bf16* pz,
                                          const bf16* pxz, const bf16* pxy, const bf16* pyz,
                                          const bf16* w0, const bf16* b0, const bf16* w1,
                                          const bf16* b1, const bf16* wout, const bf16* bout,
                                          float* out, int B, int R, int E, int NB,
                                          void* stream) {
  return launch<false, false, true>(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out,
                                    B, R, E, NB, stream);
}

extern "C" int dense_decode_bf16_resident_fold(const bf16* px, const bf16* py, const bf16* pz,
                                               const bf16* pxz, const bf16* pxy,
                                               const bf16* pyz, const bf16* w0, const bf16* b0,
                                               const bf16* w1, const bf16* b1,
                                               const bf16* wout, const bf16* bout, float* out,
                                               int B, int R, int E, int NB, void* stream) {
  return launch<false, true, true>(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out,
                                   B, R, E, NB, stream);
}

// K3 in the bf16 mode -> out (R, R, R, E*OE) float32.
extern "C" int dense_decode_single_bf16(const bf16* px, const bf16* py, const bf16* pz,
                                        const bf16* pxz, const bf16* pxy, const bf16* pyz,
                                        const bf16* w0, const bf16* b0, const bf16* w1,
                                        const bf16* b1, const bf16* wout, const bf16* bout,
                                        float* out, int R, int E, int NB, void* stream) {
  return launch<true>(px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out,
                      1, R, E, NB, stream);
}

// The launch configuration a kernel takes for these shapes, into info[11]
// (see configure). `mode` picks the kernel: 0 K2, 1 K3 (point-major), 2 K2
// with fold_b1; in the bf16 mode also 4 K2 with resident_bf16, 6 with both.
extern "C" int dense_decode_config(int mode, int B, int R, int E, int NB, int* info) {
  switch (mode) {
    case 0: return configure<Kernel<false, false>>(B, R, E, NB, info);
    case 1: return configure<Kernel<false, true>>(B, R, E, NB, info);
    case 2: return configure<Kernel<false, false, true>>(B, R, E, NB, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same for the bf16 mode.
extern "C" int dense_decode_bf16_config(int mode, int B, int R, int E, int NB, int* info) {
  switch (mode) {
    case 0: return configure<Kernel<true, false>>(B, R, E, NB, info);
    case 1: return configure<Kernel<true, true>>(B, R, E, NB, info);
    case 2: return configure<Kernel<true, false, true>>(B, R, E, NB, info);
    case 4: return configure<Kernel<true, false, false, true>>(B, R, E, NB, info);
    case 6: return configure<Kernel<true, false, true, true>>(B, R, E, NB, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dense_decode_hidden() { return H; }
extern "C" int dense_decode_outputs() { return OE; }
