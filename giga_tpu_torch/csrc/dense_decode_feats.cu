// Dense-decode trunk of the GIGA affordance decoder with the per-block fc_c
// plane projections formed from raw lattice features, for Hopper (sm_90a).
// Four entry points:
//
//   K4 dense_decode_feats_f32: replaces giga_tpu/ops/pallas/decoder_kernel.py::
//      fused_dense_decode_feats_batched (pallas_call at :608, body
//      _feats_kernel :507). All three projections from the raw features:
//        net += fxz[b,x,z] @ wxz[i] ; net += fxy[b,x,y] @ wxy[i] ;
//        net += fyz[b,y,z] @ wyz[i] ; net += bc[i]
//   K5 dense_decode_hybrid_f32: replaces decoder_kernel.py::
//      fused_dense_decode_hybrid_batched (pallas_call at :447, body
//      _trunk_kernel_hybrid :358). The xz/xy rows in-kernel, pyz read from
//      memory with the fc_c bias folded into it:
//        net += fxz[b,x,z] @ wxz[i] ; net += fxy[b,x,y] @ wxy[i] ; net += pyz[b,i,y,z]
//   dense_decode_feats_bf16, dense_decode_hybrid_bf16: the same two in the
//      TPU kernels' compute_dtype=bf16 mode (see "bf16 mode" below).
// All start from net = px[x] + py[y] + pz[z], run the per-head trunk (the
// same arithmetic as K2), and write (B, R, R, R, E*OE) float32 indexed
// [b, x, y, z, o].
//
// What bounds them: at B=64, R=40, 5 blocks, C=32 the trunk is ~267 GFLOP
// (heads run apart, as in K2); the projections, counted once per plane row,
// add ~9.4 GFLOP (K4) or ~6.3 GFLOP (K5): 278.8 GFLOP for K4, 4.16 ms at the
// H100's 67 TFLOP/s fp32 rate, 273.7 GFLOP for K5, 4.09 ms. K4 reads only the
// raw features (~39 MB) and writes ~197 MB (0.07 ms at 3.35 TB/s); K5 also
// reads pyz (~197 MB in float32). Both are bound by fp32 CUDA-core
// arithmetic.
//
// Design. A projection row is shared by every lattice point of its plane
// line (R points), so formed per point it would add half of the trunk's work
// (C*H against 2*H*H FMAs per block and head); formed in shared memory per
// block of points it needs each (x, block) pair's rows in every block that
// touches x, and the barriers around them (K4's first port: one point per
// thread, 213 KB of shared memory, 5.1x its bound). Here each call runs in
// two kinds of launch on the caller's stream, per pass of XR x-slabs:
//  1. project_kernel forms each plane's rows for all blocks and heads once,
//     (rows, C) @ (C, NB*F) in register tiles of 8 rows x 4 columns, into
//     scratch the wrapper allocates: the xz and xy rows (B, NB, XR, R, F)
//     of the pass and, in K4's first pass, pyz (B, NB, R, R, F) (K5 reads
//     its pyz from memory).
//  2. dense_decode_feats_kernel runs the pass's points through the register-
//     tiled trunk of trunk_tiled.cuh with K2's persistent blocks (each copies
//     its head's weights and fc_c biases to shared memory once; its warps
//     stride over (scene, 64-point tile) pairs, a lane an 8-point x 8-column
//     micro-tile), reading its rows as K2 reads its projections; K4 then
//     adds the fc_c bias.
// Every projection is a dot over c ascending, one fmaf each from zero, and
// the trunk adds ((((net + xz) + xy) + yz) + bc) per block (K4) or
// ((net + xz) + xy) + pyz (K5), in the order of the kernels they replace, so
// the outputs are those kernels' bit for bit and do not depend on XR. The
// plain versions' matrix products may sum in another order, hence the
// 1e-5*(1+|b|) tolerance.
//
// Resources and time (ptxas for sm_90a; chip_smoke.py prints them): the
// trunk 168 registers, 328/332 bytes of spill stores/loads (K5's instance,
// without the bias add, 412/432), 147,856 bytes of shared memory (K2's and
// the head's fc_c biases), 44 x 3 blocks of 384 threads on an H100's 132
// SMs; the projections 63 registers, no spills, 2*F threads and 8.7 KB a
// block. Scratch at B=64, R=40 and one pass: 590 MB (K4), 393 MB (K5). On
// an NVIDIA H100 80GB HBM3 at 700 W, at B=64 in one pass (XR = 40): K4
// 8.27-8.34 ms, 50% of its bound (8.8 ms in passes of 8); K5 8.32-8.36 ms,
// 49% of its bound. The A/B (ab_dense_decode_feats.py, PERF.md) puts ~0.27
// ms in K4's xz/xy projections, ~0.12 ms in pyz and ~0.13 ms in the
// separate fc_c bias add that K4's sum order needs; read through L1, the
// biases cost ~0.22 ms more.
//
// bf16 mode (trunk_mma.cuh, rows_tma.cuh). The TPU kernels take every input
// in float32 here (prepare_feats_inputs; prepare_hybrid_inputs, whose pyz
// alone is stored in bf16) and form each block's projections in the kernel
// as MXU products of bf16 operands with float32 sums; the rows stay float32.
// Its bound is the tensor cores': 278.8 GFLOP (K4) and 273.7 (K5) at 989
// TFLOP/s, 0.282 and 0.277 ms, against 236 MB and 321 MB read and written
// (0.070 and 0.096 ms at 3.35 TB/s).
//
// Design: K2 bf16's kernel (dense_decode.cu) with plane rows made on the
// tensor cores instead of read from memory, so no float32 row is ever
// written. The design before this one formed every row on the CUDA cores
// into float32 scratch (590 MB for K4 at B=64) and gathered it back a lane
// at a time, at 7-8 % of its bound.
//  1. A rounding prologue (round_features_kernel, one elementwise launch,
//     part of the call) rounds fxz and fxy (K4: and fyz) to bf16 into a
//     workspace the wrapper allocates, (planes, B, R, R, C): exactly the
//     rounding the TPU kernel gives those operands. TMA cannot convert.
//  2. A slab is one x-plane of one scene: the producer warp brings fxz[b, x]
//     and fxy[b, x], R rows of C = 32 bf16 (one 64-byte swizzled TMA row
//     each), into a ring of BF_SLAB_STAGES stages with `full` and `empty`
//     mbarriers, as K2 bf16's slabs. A consumer warp's tile is 32
//     consecutive (y, z) points of the slab.
//  3. Per block, each projection is the tile's (32, C) @ (C, 32) on mma.sync
//     m16n8k16 (16 MMAs) into a zeroed float32 tile, then added to net. Its A
//     fragments come by ldmatrix.x4, each lane giving its own row: row z of
//     the fxz slab (xz), row y of the fxy slab (xy), the tile's own row of
//     its fyz box (yz, K4). Its B fragments are wxz, wxy and wyz of the
//     block and head, rounded once to bf16 in shared memory as the trunk's.
//  4. K4's fyz rows of a tile are 32 consecutive rows: lane 0 brings them by
//     TMA as one 2 KB box into the warp's ring of BF_RING boxes, once for all
//     NB blocks, the next tile's box in flight. K5's given bf16 pyz keeps
//     K2 bf16's ring of one box per (tile, block), added by ldmatrix.
//  5. px, py and pz stay float32, read once a tile (tc::rows); the trunk and
//     the output write are K2 bf16's.
// Sums: net = (px + py) + pz, then per block (((net + xz) + xy) + yz) + bc
// (K4) or ((net + xz) + xy) + pyz (K5), the TPU kernels' order; only the
// order of each 32-term dot inside the tensor core differs from the
// function, as in the trunk's own products. One pass whatever x_chunk.
// Resources (ptxas for sm_90a; chip_smoke.py phase 18 prints them): 128
// registers, K4 68/88 bytes of spill stores/loads, K5 none; 129,296 (K4)
// and 118,032 (K5) bytes of shared memory at NB = 5, R = 40; 44 x 3 blocks
// of 15 consumer warps and the producer; the prologue 16 registers. On an
// NVIDIA H100 80GB HBM3 at 700 W, at B=64 (ab_dense_decode_feats.py
// --bf16, 6 rounds in turns): K4 2.24-2.29 ms (12.6 % of its bound), K5
// 1.99-2.05 ms (13.9 %), against the design before this one's 3.86-3.95
// and 3.28-3.35 ms in the same call.
//
// No float atomics: every float32 sum is in a fixed order.

#include <cuda_bf16.h>

#include "rows_tma.cuh"
#include "trunk_mma.cuh"
#include "trunk_tiled.cuh"

namespace {

using trunk::H;
using trunk::OE;
using bf16 = __nv_bfloat16;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use on sm_90

// K4's and K5's float32 trunk (ab_dense_decode_feats.py rewrites these
// constants in a copy of this source to time the alternatives):
constexpr int TP = 8;          // points of a lane's micro-tile
constexpr int TC = 8;          // columns of a lane's micro-tile
constexpr int WARPS = 12;      // warps per block
constexpr int MIN_BLOCKS = 1;  // resident blocks per SM asked of ptxas
constexpr int KUNROLL = 2;     // k steps of a product unrolled at a time
constexpr int THREADS = 32 * WARPS;
using Lane = tiled::Lane<TP, TC, KUNROLL>;
constexpr int P = Lane::P;
// The projections (rewritten by the A/B too): a block forms PROJ_ROWS plane
// rows for every block, a thread a PROJ_TR x PROJ_TC register tile at a time
constexpr int PROJ_ROWS = 64;
constexpr int PROJ_TR = 8;
constexpr int PROJ_TC = 4;
constexpr int PROJ_MAX_THREADS = 512;  // (PROJ_ROWS / PROJ_TR) * (F / PROJ_TC) at most
constexpr int PROJ_S = PROJ_ROWS + 4;  // floats per feature of the staged rows
// The bf16 mode: K2 bf16's design (dense_decode.cu)
constexpr int BF_MT = 2;            // m16 tiles of a warp: 32 points
constexpr int BF_WARPS = 15;        // consumer warps per block, beside one producer warp
constexpr int BF_MIN_BLOCKS = 1;    // resident blocks per SM asked of ptxas
constexpr int BF_RING = 2;          // boxes of a consumer warp's ring
constexpr int BF_SLAB_STAGES = 2;   // x-planes of the block's slab ring
constexpr int BF_C = 32;            // feature channels: one 64-byte TMA row
constexpr int BF_MAX_ROWS = 256;    // rows of a TMA box at most: R of a slab
constexpr int ROUND_THREADS = 256;  // threads a block of the rounding prologue
constexpr int BF_THREADS = 32 * (BF_WARPS + 1);
using BfTile = tc::Tile<BF_MT>;
constexpr int BF_P = BfTile::P;
constexpr int BF_BOX_BYTES = BF_P * rows::ROW_BYTES;  // a tile's 32 rows
static_assert(OE % 2 == 0, "head outputs in pairs");
static_assert(BF_C == H && tc::KS == 2, "a projection's k-steps are the trunk's two");
static_assert(BF_C * sizeof(bf16) == rows::ROW_BYTES && H * sizeof(bf16) == rows::ROW_BYTES,
              "a feature row and a head's pyz row are one 64-byte TMA row each");
static_assert(BF_RING >= 2, "one box in flight while another is read");

// The entry points, by kernel and mode (dense_decode_feats_config's `mode`).
enum Mode { K4_F32 = 0, K5_F32 = 1, K4_BF16 = 2, K5_BF16 = 3 };

// One plane's projection: out[(((b * NB + blk) * NA + a) * R + j) * F + f] =
// sum over c ascending of feat[b, a0 + a, j, c] * W[blk, c, f], one fmaf per
// term from zero, for the rows of slabs a0 .. a0 + NA - 1 and every block
// (feat (B, R, R, C), W (NB, C, F)).
struct ProjJob {
  const float* feat;
  const float* W;
  float* out;
  int a0, NA;
};
struct ProjJobs {
  ProjJob job[3];
};

// Job blockIdx.y of `jobs`: a block stages PROJ_ROWS feature rows in shared
// memory and forms their rows for all NB blocks, a thread PROJ_TR rows x
// PROJ_TC columns at a time, its weights read through L1.
// (PROJ_ROWS / PROJ_TR) * (F / PROJ_TC) threads.
__global__ void __launch_bounds__(PROJ_MAX_THREADS)
project_kernel(const ProjJobs jobs, int B, int R, int C, int F, int NB) {
  extern __shared__ __align__(16) float smem[];
  float* fs = smem;  // (C, PROJ_S): feature c of row r at fs[c * PROJ_S + r]
  // constant indices: a parameter indexed by blockIdx.y is copied to local memory
  const ProjJob jb = blockIdx.y == 0 ? jobs.job[0] : blockIdx.y == 1 ? jobs.job[1] : jobs.job[2];
  const float* __restrict__ feat = jb.feat;
  const float* __restrict__ W = jb.W;
  float* __restrict__ out = jb.out;
  const int a0 = jb.a0, NA = jb.NA, tid = threadIdx.x;
  const long m0 = (long)blockIdx.x * PROJ_ROWS, M = (long)B * NA * R;
  if (m0 >= M) return;
  for (int i = tid; i < PROJ_ROWS * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const long m = m0 + r;
    float v = 0.f;
    if (m < M) {
      const long ba = m / R;  // b * NA + a
      const long b = ba / NA;
      v = feat[((b * R + a0 + (ba - b * NA)) * R + (m - ba * R)) * C + c];
    }
    fs[c * PROJ_S + r] = v;
  }
  __syncthreads();

  const int rg = tid / (F / PROJ_TC), cg = tid % (F / PROJ_TC);
  for (int blk = 0; blk < NB; ++blk) {
    const float4* w4 = reinterpret_cast<const float4*>(W + (size_t)blk * C * F + cg * PROJ_TC);
    float acc[PROJ_TR][PROJ_TC];
#pragma unroll
    for (int r = 0; r < PROJ_TR; ++r)
#pragma unroll
      for (int k = 0; k < PROJ_TC; ++k) acc[r][k] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float a[PROJ_TR], w[PROJ_TC];
      tiled::load_vec(a, fs + c * PROJ_S + rg * PROJ_TR);
#pragma unroll
      for (int q = 0; q < PROJ_TC / 4; ++q) {
        const float4 u = __ldg(w4 + (size_t)c * (F / 4) + q);
        w[4 * q] = u.x, w[4 * q + 1] = u.y, w[4 * q + 2] = u.z, w[4 * q + 3] = u.w;
      }
#pragma unroll
      for (int r = 0; r < PROJ_TR; ++r)
#pragma unroll
        for (int k = 0; k < PROJ_TC; ++k) acc[r][k] = fmaf(a[r], w[k], acc[r][k]);
    }
#pragma unroll
    for (int r = 0; r < PROJ_TR; ++r) {
      const long m = m0 + rg * PROJ_TR + r;
      if (m >= M) break;
      const long ba = m / R, b = ba / NA;
      float4* dst = reinterpret_cast<float4*>(
          out + (((b * NB + blk) * NA + (ba - b * NA)) * R + (m - ba * R)) * F + cg * PROJ_TC);
#pragma unroll
      for (int q = 0; q < PROJ_TC / 4; ++q)
        dst[q] = make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]);
    }
  }
}

size_t project_shared_bytes(int C) { return (size_t)C * PROJ_S * sizeof(float); }
int project_threads(int F) { return PROJ_ROWS / PROJ_TR * (F / PROJ_TC); }

// The n jobs of `jobs` in one launch.
int project(const ProjJobs& jobs, int n, int B, int R, int C, int F, int NB, cudaStream_t stream) {
  if (n == 0) return 0;
  int na = 0;
  for (int i = 0; i < n; ++i) na = jobs.job[i].NA > na ? jobs.job[i].NA : na;
  const long M = (long)B * na * R;
  project_kernel<<<dim3((unsigned)((M + PROJ_ROWS - 1) / PROJ_ROWS), n), project_threads(F),
                   project_shared_bytes(C), stream>>>(jobs, B, R, C, F, NB);
  return (int)cudaGetLastError();
}

size_t trunk_shared_bytes(int NB) {
  return ((size_t)trunk::weight_floats(NB) + (size_t)WARPS * Lane::ACT_FLOATS + (size_t)NB * H) *
         sizeof(float);
}

// The float32 trunk over the points of x-slabs x0 .. x0 + XR - 1 of every
// scene: pxz and pxy hold the pass's rows (B, NB, XR, R, F), pyz
// (B, NB, R, R, F); kBias adds bc (NB, F) after them (K4).
template <bool kBias>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_decode_feats_kernel(const float* __restrict__ px, const float* __restrict__ py,
                          const float* __restrict__ pz, const float* __restrict__ pxz,
                          const float* __restrict__ pxy, const float* __restrict__ pyz,
                          const float* __restrict__ bc, const float* __restrict__ w0,
                          const float* __restrict__ b0, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ wout,
                          const float* __restrict__ bout, float* __restrict__ out, int B, int R,
                          int E, int NB, int x0, int XR) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.y, F = E * H;
  const trunk::Weights s = trunk::load_weights(smem, w0, b0, w1, b1, wout, bout, e, E, NB);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* act = smem + trunk::weight_floats(NB) + warp * Lane::ACT_FLOATS;
  float* bsh = smem + trunk::weight_floats(NB) + WARPS * Lane::ACT_FLOATS;  // (NB, H): head e's bc
  if (kBias)
    for (int i = threadIdx.x; i < NB * H; i += blockDim.x)
      bsh[i] = bc[(size_t)(i / H) * F + e * H + i % H];
  const Lane ln(lane);
  __syncthreads();

  const int RR = R * R, N = XR * RR;
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
        const int xl = n / RR, y = (n / R) % R, z = n % R;
        xz[p] = xl * R + z;
        xy[p] = xl * R + y;
        yz[p] = y * R + z;
        rx[p] = px + (size_t)(x0 + xl) * F + col;
        ry[p] = py + (size_t)y * F + col;
        rz[p] = pz + (size_t)z * F + col;
      }
      tiled::set_rows(net, rx, ln);
      tiled::add_rows(net, ry, ln);
      tiled::add_rows(net, rz, ln);
    }
    for (int blk = 0; blk < NB; ++blk) {
      const size_t slabs = ((size_t)b * NB + blk) * XR * R, plane = ((size_t)b * NB + blk) * RR;
      const float* rows[3][TP];
#pragma unroll
      for (int p = 0; p < TP; ++p) {
        rows[0][p] = pxz + (slabs + xz[p]) * F + col;
        rows[1][p] = pxy + (slabs + xy[p]) * F + col;
        rows[2][p] = pyz + (plane + yz[p]) * F + col;
      }
      tiled::add_rows(net, rows[0], ln);
      tiled::add_rows(net, rows[1], ln);
      tiled::add_rows(net, rows[2], ln);
      if (kBias) {
        float bias[TC];
#pragma unroll
        for (int q = 0; q < TC / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(bsh + blk * H + ln.column(4 * q));
          bias[4 * q] = v.x, bias[4 * q + 1] = v.y, bias[4 * q + 2] = v.z, bias[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int p = 0; p < TP; ++p)
#pragma unroll
          for (int c = 0; c < TC; ++c) net[p][c] += bias[c];
      }
      tiled::resnet_block(net, act, s, blk, ln);
    }
    float4 o[Lane::OUTS];
    tiled::head_out(o, net, act, s, ln, lane);
#pragma unroll
    for (int i = 0; i < Lane::OUTS; ++i) {
      const int n = base + lane + 32 * i;
      if (lane + 32 * i >= P || n >= N) break;
      reinterpret_cast<float4*>(out)[(((size_t)b * R + x0) * RR + n) * E + e] = o[i];
    }
  }
}

// -- the bf16 mode -------------------------------------------------------------

// The rounding prologue: plane blockIdx.y of `in` (n float32 values, n a
// multiple of 4) rounded to nearest bf16 into ws[blockIdx.y * n ..].
struct Planes {
  const float* f[3];
};

__global__ void __launch_bounds__(ROUND_THREADS)
round_features_kernel(const Planes in, bf16* __restrict__ ws, long n) {
  // constant indices: a parameter indexed by blockIdx.y is copied to local memory
  const float* f = blockIdx.y == 0 ? in.f[0] : blockIdx.y == 1 ? in.f[1] : in.f[2];
  const float4* __restrict__ src = reinterpret_cast<const float4*>(f);
  uint2* __restrict__ dst = reinterpret_cast<uint2*>(ws + (size_t)blockIdx.y * n);
  for (long i = (long)blockIdx.x * ROUND_THREADS + threadIdx.x; i < n / 4;
       i += (long)gridDim.x * ROUND_THREADS) {
    const float4 v = __ldg(src + i);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    dst[i] = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                        *reinterpret_cast<const unsigned*>(&hi));
  }
}

// Byte offsets of the bf16 kernel's shared memory from its 1024-aligned base:
// the head's trunk weights (tc::load_weights), the projections' B fragments
// (plane q's block k at proj + (q NB + k) FRAG_WORDS words; K4 three planes,
// K5 two), K4's fc_c biases (NB, H), the slab ring (each slab: the fxz box
// of R rows, then the fxy box at `xy`), the consumer warps' rings of
// BF_RING boxes, the mbarriers (full and empty per slab stage, one per ring
// box). decoder.py's _feats_bf16_layout_bytes mirrors `bytes`.
struct BfLayout {
  int proj, bias, slabs, xy, slab, ring, bars, bytes;
  __host__ __device__ BfLayout(int R, int NB, bool k4) {
    proj = tc::weight_words(NB) * (int)sizeof(unsigned);
    bias = proj + (k4 ? 3 : 2) * NB * tc::FRAG_WORDS * (int)sizeof(unsigned);
    slabs = rows::align_up(bias + (k4 ? NB * H * (int)sizeof(float) : 0), rows::ALIGN);
    xy = rows::align_up(R * rows::ROW_BYTES, rows::ALIGN);
    slab = 2 * xy;
    ring = slabs + BF_SLAB_STAGES * slab;
    bars = ring + BF_WARPS * BF_RING * BF_BOX_BYTES;
    bytes = bars + 8 * (2 * BF_SLAB_STAGES + BF_WARPS * BF_RING) + rows::ALIGN;
  }
};

// net += A @ W: A the tile's rows of a bf16 box at `box` (this lane's
// ldmatrix rows at box + off[m], in the A fragments' order), W one
// projection's B fragments; the product formed from zero, then added, one
// rounding per value.
__device__ __forceinline__ void add_projection(BfTile& net, unsigned box,
                                               const unsigned (&off)[BF_MT], const uint2* W,
                                               int lane) {
  unsigned a[BF_MT][tc::KS][4];
#pragma unroll
  for (int m = 0; m < BF_MT; ++m)
#pragma unroll
    for (int s = 0; s < tc::KS; ++s)
      rows::ldsm_x4(a[m][s], (box + off[m]) ^ (32u * s));  // k-step 1: chunks 2, 3
  BfTile acc;
  tc::product(acc, a, W, lane);
#pragma unroll
  for (int m = 0; m < BF_MT; ++m)
#pragma unroll
    for (int n = 0; n < tc::NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) net.v[m][n][r] = net.v[m][n][r] + acc.v[m][n][r];
}

// The bf16 mode of K4 (kK4) and K5 over the B R x-planes of every scene:
// mslab maps the workspace's fxz and fxy rows (C columns, R rows, 2 B R
// x-planes: fxz's, then fxy's), mbox K4's rounded fyz (C columns, R^2 rows,
// B scenes) or K5's bf16 pyz (E H columns, R^2 rows, B NB planes); every
// other input float32, the weights rounded to bf16 fragments as they are
// copied to shared memory.
template <bool kK4>
__global__ void __launch_bounds__(BF_THREADS, BF_MIN_BLOCKS)
dense_decode_feats_bf16_kernel(const __grid_constant__ CUtensorMap mslab,
                               const __grid_constant__ CUtensorMap mbox,
                               const float* __restrict__ px, const float* __restrict__ py,
                               const float* __restrict__ pz, const float* __restrict__ wxz,
                               const float* __restrict__ wxy, const float* __restrict__ wyz,
                               const float* __restrict__ bc, const float* __restrict__ w0,
                               const float* __restrict__ b0, const float* __restrict__ w1,
                               const float* __restrict__ b1, const float* __restrict__ wout,
                               const float* __restrict__ bout, float* __restrict__ out, int B,
                               int R, int E, int NB) {
  extern __shared__ __align__(16) unsigned char bsmem[];
  const unsigned raw = rows::smem_addr(bsmem);
  const unsigned base = (raw + rows::ALIGN - 1) & ~(unsigned)(rows::ALIGN - 1);
  unsigned char* gbase = bsmem + (base - raw);
  const BfLayout L(R, NB, kK4);
  const int e = blockIdx.y, col = e * H, F = E * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int RR = R * R;
  const int tps = (RR + BF_P - 1) / BF_P;  // tiles per slab
  // the block's tiles: a contiguous run of the head's (slab, tile) order
  const int units = B * R * tps;  // under 2^31 (configure checks)
  const int U0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int U1 = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  if (U0 >= U1) return;
  const int S0 = U0 / tps, S1 = (U1 - 1) / tps;
  const unsigned full = base + L.bars, empty = full + 8 * BF_SLAB_STAGES;
  const unsigned ring_full = empty + 8 * BF_SLAB_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < BF_SLAB_STAGES; ++i) {
      rows::bar_init(full + 8 * i, 1);
      rows::bar_init(empty + 8 * i, BF_WARPS);
    }
    for (int i = 0; i < BF_WARPS * BF_RING; ++i) rows::bar_init(ring_full + 8 * i, 1);
    rows::bar_init_fence();
  }
  const tc::Weights s = tc::load_weights(reinterpret_cast<unsigned*>(gbase), w0, b0, w1, b1,
                                         wout, bout, e, E, NB);
  constexpr int kPlanes = kK4 ? 3 : 2;
  unsigned* pf = reinterpret_cast<unsigned*>(gbase + L.proj);
  for (int i = threadIdx.x; i < kPlanes * NB * tc::FRAG_WORDS; i += blockDim.x) {
    const int qk = i / tc::FRAG_WORDS, q = qk / NB, k = qk - q * NB;
    const float* W = q == 0 ? wxz : q == 1 ? wxy : wyz;
    pf[i] = tc::fragment_word(W + (size_t)k * BF_C * F + col, H, tc::NT, i % tc::FRAG_WORDS, F);
  }
  float* bsh = reinterpret_cast<float*>(gbase + L.bias);  // (NB, H): head e's bc
  if (kK4)
    for (int i = threadIdx.x; i < NB * H; i += blockDim.x)
      bsh[i] = bc[(size_t)(i / H) * F + col + i % H];
  __syncthreads();

  if (warp == BF_WARPS) {
    // the producer: each slab's fxz and fxy boxes into a slab stage once the
    // slab that used it before is released by every consumer warp
    if (lane == 0) {
      const unsigned bytes = 2 * R * rows::ROW_BYTES;
      for (int sl = S0; sl <= S1; ++sl) {
        const int i = (sl - S0) % BF_SLAB_STAGES, use = (sl - S0) / BF_SLAB_STAGES;
        if (use > 0) rows::bar_wait(empty + 8 * i, (use - 1) & 1);
        const unsigned bar = full + 8 * i, dst = base + L.slabs + i * L.slab;
        rows::bar_expect(bar, bytes);
        rows::load_3d(dst, &mslab, bar, 0, 0, sl);  // slab sl = b R + x
        rows::load_3d(dst + L.xy, &mslab, bar, 0, 0, B * R + sl);
      }
    }
    return;
  }

  // the slab whose rows the warp holds: waited for, not yet released
  int held = S0 - 1;
  auto next_slab = [&]() {
    if (held >= S0) {
      __syncwarp();  // every lane is done with the slab's rows
      if (lane == 0) rows::bar_arrive(empty + 8 * ((held - S0) % BF_SLAB_STAGES), 1);
    }
    if (++held <= S1)
      rows::bar_wait(full + 8 * ((held - S0) % BF_SLAB_STAGES),
                     (unsigned)((held - S0) / BF_SLAB_STAGES) & 1);
  };
  const int chunk = rows::lane_chunk(lane);
  unsigned off_p[BF_MT];  // a tile's ring box holds its own 32 rows
#pragma unroll
  for (int m = 0; m < BF_MT; ++m) off_p[m] = rows::offset(rows::lane_point(m, lane), chunk);
  const unsigned ring = base + L.ring + warp * BF_RING * BF_BOX_BYTES;
  const unsigned ring_bar = ring_full + 8 * BF_RING * warp;
  const int nbox = kK4 ? (NB > 0) : NB;  // ring boxes a tile: K4's fyz once, K5's pyz per block
  // where the tile of unit uu lies: its slab (b R + x), scene, x, and its
  // first point in the x-plane's (y, z) order, the first of its 32 rows
  struct At {
    int sl, b, x, f0;
  };
  auto at = [&](int uu) {
    At a;
    a.sl = uu / tps;
    a.f0 = (uu - a.sl * tps) * BF_P;
    a.b = a.sl / R;
    a.x = a.sl - a.b * R;
    return a;
  };
  // lane 0 brings in ring box j of a tile (K4: its fyz rows; K5: block j's
  // pyz rows) into a stage; rows past the plane are padding, filled with 0
  auto fetch = [&](const At& a, int j, unsigned stage) {
    const unsigned bar = ring_bar + 8 * stage, dst = ring + stage * BF_BOX_BYTES;
    rows::fence_async();
    rows::bar_expect(bar, BF_BOX_BYTES);
    if (kK4)
      rows::load_3d(dst, &mbox, bar, 0, a.f0, a.b);
    else
      rows::load_3d(dst, &mbox, bar, col, a.f0, a.b * NB + j);
  };
  int u = U0 + warp;
  At next = at(u);
  if (lane == 0 && u < U1 && nbox > 0) fetch(next, 0, 0);
  unsigned step = 0;
  for (; u < U1; u += BF_WARPS) {
    const At cur = next;
    const bool more = u + BF_WARPS < U1;
    if (more) next = at(u + BF_WARPS);
    // one step of the warp's ring: box j + 1 (or the next tile's first) in
    // flight, then box j waited for; returns its shared address
    auto ring_step = [&](int j) {
      const unsigned stage = step % BF_RING;
      __syncwarp();  // the stage refilled now was read a step ago
      if (lane == 0) {
        const unsigned ahead = (step + 1) % BF_RING;
        if (j + 1 < nbox)
          fetch(cur, j + 1, ahead);
        else if (more)
          fetch(next, 0, ahead);
      }
      rows::bar_wait(ring_bar + 8 * stage, (step / BF_RING) & 1);
      ++step;
      return ring + stage * BF_BOX_BYTES;
    };
    // each lane's ldmatrix rows: row z of the fxz slab, row y of the fxy
    // slab; padding points past the plane are clamped to its last
    unsigned off_z[BF_MT], off_y[BF_MT];
#pragma unroll
    for (int m = 0; m < BF_MT; ++m) {
      const int f = min(cur.f0 + rows::lane_point(m, lane), RR - 1);
      const int y = f / R;
      off_y[m] = rows::offset(y, chunk);
      off_z[m] = rows::offset(f - y * R, chunk);
    }
    BfTile net;
    {
      int ix[BF_MT][2], iy[BF_MT][2], iz[BF_MT][2];
#pragma unroll
      for (int m = 0; m < BF_MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = min(cur.f0 + tc::point(m, h, lane), RR - 1);
          ix[m][h] = cur.x;
          iy[m][h] = f / R;
          iz[m][h] = f - iy[m][h] * R;
        }
      tc::rows<true>(net, px + col, ix, F, lane);
      tc::rows<false>(net, py + col, iy, F, lane);
      tc::rows<false>(net, pz + col, iz, F, lane);
    }
    while (held < cur.sl) next_slab();
    const unsigned xz = base + L.slabs + ((cur.sl - S0) % BF_SLAB_STAGES) * L.slab, xy = xz + L.xy;
    const uint2* W = reinterpret_cast<const uint2*>(pf);
    constexpr int FW = tc::FRAG_WORDS / 2;  // uint2 of one projection's fragments
    unsigned box = 0;
    if (kK4 && NB > 0) box = ring_step(0);
    for (int k = 0; k < NB; ++k) {
      if (!kK4) box = ring_step(k);
      add_projection(net, xz, off_z, W + k * FW, lane);
      add_projection(net, xy, off_y, W + (NB + k) * FW, lane);
      if (kK4) {
        add_projection(net, box, off_p, W + (2 * NB + k) * FW, lane);
        tc::add_columns(net, bsh + k * H, lane);
      } else {
        rows::add<false>(net, box, off_p);
      }
      tc::resnet_block(net, s, k, lane);
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
        const int f = cur.f0 + tc::point(m, h, lane);
        if (c < OE && f < RR)
          reinterpret_cast<float2*>(out)[((((size_t)cur.b * R + cur.x) * RR + f) * E * OE +
                                          e * OE + c) / 2] = make_float2(o[m][2 * h], o[m][2 * h + 1]);
      }
  }
  while (held <= S1) next_slab();  // release the rest of the run, tiles or none
}

// -- launch configurations and launches -------------------------------------------

// Resident blocks per SM of kernel `fn` at `threads` and `shmem` dynamic
// shared bytes a block (its limit set first), and the device's SMs.
int occupancy(const void* fn, int threads, size_t shmem, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads, shmem)) ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  return *per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

// info[7] = {resident blocks per SM, SMs, blocks per head (grid.x) of the
// largest pass, heads, threads per block, dynamic shared bytes, passes}:
// persistent blocks, at most those that `units` warp tiles keep busy.
void fill_info(int* info, int per_sm, int sms, long long units, int warps, int E, int threads,
               size_t shmem, int passes) {
  long per_head = (long)per_sm * sms / E;
  per_head = per_head < 1 ? 1 : per_head;
  const long needed = (long)((units + warps - 1) / warps);
  info[0] = per_sm;
  info[1] = sms;
  info[2] = (int)(per_head < needed ? per_head : needed);
  info[3] = E;
  info[4] = threads;
  info[5] = (int)shmem;
  info[6] = passes;
}

const void* f32_trunk(bool k4) {
  return k4 ? reinterpret_cast<const void*>(dense_decode_feats_kernel<true>)
            : reinterpret_cast<const void*>(dense_decode_feats_kernel<false>);
}

const void* bf16_kernel(bool k4) {
  return k4 ? reinterpret_cast<const void*>(dense_decode_feats_bf16_kernel<true>)
            : reinterpret_cast<const void*>(dense_decode_feats_bf16_kernel<false>);
}

// The float32 modes' launch configuration (the trunk kernel's) into info[7].
int configure_f32(bool k4, int B, int R, int C, int E, int NB, int XR, int* info) {
  const int F = E * H;
  if (XR < 1 || C < 1 || F % PROJ_TC != 0 || project_threads(F) > PROJ_MAX_THREADS ||
      project_shared_bytes(C) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = trunk_shared_bytes(NB);
  int per_sm = 0, sms = 0, err;
  if ((err = (int)cudaFuncSetAttribute(reinterpret_cast<const void*>(project_kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)project_shared_bytes(C))) ||
      (err = occupancy(f32_trunk(k4), THREADS, shmem, &per_sm, &sms)))
    return err;
  const int xr = XR < R ? XR : R;
  fill_info(info, per_sm, sms, (long long)B * ((xr * R * R + P - 1) / P), WARPS, E, THREADS,
            shmem, (R + xr - 1) / xr);
  return 0;
}

// The bf16 modes' launch configuration (the main kernel's; one pass) into
// info[7]: C = BF_C channels, R <= BF_MAX_ROWS (a slab's box), the layout
// within a block's shared memory, int tile indices.
int configure_bf16(bool k4, int B, int R, int C, int E, int NB, int XR, int* info) {
  if (XR < 1 || C != BF_C || R > BF_MAX_ROWS) return (int)cudaErrorInvalidValue;
  const size_t shmem = BfLayout(R, NB, k4).bytes;
  const long long units = (long long)B * R * ((R * R + BF_P - 1) / BF_P);
  if (shmem > SMEM_LIMIT || units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const int err = occupancy(bf16_kernel(k4), BF_THREADS, shmem, &per_sm, &sms);
  if (err) return err;
  fill_info(info, per_sm, sms, units, BF_WARPS, E, BF_THREADS, shmem, 1);
  return 0;
}

int configure(int mode, int B, int R, int C, int E, int NB, int XR, int* info) {
  if (mode < K4_F32 || mode > K5_BF16 || B < 1 || R < 1 || E < 1 || NB < 0)
    return (int)cudaErrorInvalidValue;
  return mode >= K4_BF16 ? configure_bf16(mode == K4_BF16, B, R, C, E, NB, XR, info)
                         : configure_f32(mode == K4_F32, B, R, C, E, NB, XR, info);
}

// A float32 mode's passes of XR x-slabs: the pass's xz and xy rows (and in
// K4's first pass the yz rows of all slabs into syz, which K4 passes as
// pyz), then the trunk over the pass's points.
template <Mode kMode>
int run(const float* px, const float* py, const float* pz, const float* fxz, const float* fxy,
        const float* fyz, const float* pyz, const float* wxz, const float* wxy, const float* wyz,
        const float* bc, const float* w0, const float* b0, const float* w1, const float* b1,
        const float* wout, const float* bout, float* out, float* sxz, float* sxy, float* syz,
        int B, int R, int C, int E, int NB, int XR, void* stream) {
  constexpr bool kK4 = kMode == K4_F32;
  int info[7];
  int err = configure(kMode, B, R, C, E, NB, XR, info);
  if (err) return err;
  const int F = E * H;
  cudaStream_t st = (cudaStream_t)stream;
  for (int x0 = 0; x0 < R; x0 += XR) {
    const int xr = R - x0 < XR ? R - x0 : XR;
    ProjJobs jobs{};
    int n = 0;
    jobs.job[n++] = {fxz, wxz, sxz, x0, xr};
    jobs.job[n++] = {fxy, wxy, sxy, x0, xr};
    if (kK4 && x0 == 0) jobs.job[n++] = {fyz, wyz, syz, 0, R};
    if ((err = project(jobs, n, B, R, C, F, NB, st))) return err;
    const long units = (long)B * ((xr * R * R + P - 1) / P);
    const long needed = (units + WARPS - 1) / WARPS;
    const dim3 grid((unsigned)(info[2] < needed ? info[2] : needed), E);
    dense_decode_feats_kernel<kK4><<<grid, THREADS, info[5], st>>>(
        px, py, pz, sxz, sxy, pyz, bc, w0, b0, w1, b1, wout, bout, out, B, R, E, NB, x0, xr);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

// A bf16 mode: the rounding prologue into the workspace ws (fxz, fxy and,
// for K4, fyz: (planes, B, R, R, C) bf16), then the main kernel.
template <bool kK4>
int run_bf16(const float* px, const float* py, const float* pz, const float* fxz,
             const float* fxy, const float* fyz, const bf16* pyz, const float* wxz,
             const float* wxy, const float* wyz, const float* bc, const float* w0,
             const float* b0, const float* w1, const float* b1, const float* wout,
             const float* bout, float* out, bf16* ws, int B, int R, int C, int E, int NB, int XR,
             void* stream) {
  int info[7];
  int err = configure(kK4 ? K4_BF16 : K5_BF16, B, R, C, E, NB, XR, info);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const long n = (long)B * R * R * C;
  const long blocks = (n / 4 + ROUND_THREADS - 1) / ROUND_THREADS;
  round_features_kernel<<<dim3((unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)), kK4 ? 3 : 2),
                          ROUND_THREADS, 0, st>>>(Planes{{fxz, fxy, fyz}}, ws, n);
  if ((err = (int)cudaGetLastError())) return err;
  // the slabs' boxes: R rows of an x-plane; the ring's: a tile's 32 rows
  CUtensorMap mslab, mbox;
  const unsigned long long RR = (unsigned long long)R * R;
  if ((err = rows::encode_rows(&mslab, ws, BF_C, R, 2ull * B * R, R))) return err;
  if (kK4)
    err = rows::encode_rows(&mbox, ws + 2 * n, BF_C, RR, B, BF_P);
  else if (NB > 0)
    err = rows::encode_rows(&mbox, pyz, (unsigned long long)E * H, RR,
                            (unsigned long long)B * NB, BF_P);
  else
    mbox = mslab;  // no block, no pyz box
  if (err) return err;
  dense_decode_feats_bf16_kernel<kK4><<<dim3(info[2], E), BF_THREADS, info[5], st>>>(
      mslab, mbox, px, py, pz, wxz, wxy, wyz, bc, w0, b0, w1, b1, wout, bout, out, B, R, E, NB);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: fxz/fxy/fyz (B, R, R, C), wxz/wxy/wyz (NB, C, E*H), bc (NB, E*H)
// -> out (B, R, R, R, E*OE), in passes of XR x-slabs; scratch syz
// (B, NB, R, R, E*H), sxz and sxy (B, NB, min(XR, R), R, E*H).
extern "C" int dense_decode_feats_f32(const float* px, const float* py, const float* pz,
                                      const float* fxz, const float* fxy, const float* fyz,
                                      const float* wxz, const float* wxy, const float* wyz,
                                      const float* bc, const float* w0, const float* b0,
                                      const float* w1, const float* b1, const float* wout,
                                      const float* bout, float* out, float* sxz, float* sxy,
                                      float* syz, int B, int R, int C, int E, int NB, int XR,
                                      void* stream) {
  return run<K4_F32>(px, py, pz, fxz, fxy, fyz, syz, wxz, wxy, wyz, bc, w0, b0, w1, b1, wout,
                     bout, out, sxz, sxy, syz, B, R, C, E, NB, XR, stream);
}

// K4 in the bf16 mode: every input float32, shapes as dense_decode_feats_f32's
// with C = 32; workspace ws (3, B, R, R, C) bf16. One pass whatever XR (>= 1).
extern "C" int dense_decode_feats_bf16(const float* px, const float* py, const float* pz,
                                       const float* fxz, const float* fxy, const float* fyz,
                                       const float* wxz, const float* wxy, const float* wyz,
                                       const float* bc, const float* w0, const float* b0,
                                       const float* w1, const float* b1, const float* wout,
                                       const float* bout, float* out, bf16* ws, int B, int R,
                                       int C, int E, int NB, int XR, void* stream) {
  return run_bf16<true>(px, py, pz, fxz, fxy, fyz, nullptr, wxz, wxy, wyz, bc, w0, b0, w1, b1,
                        wout, bout, out, ws, B, R, C, E, NB, XR, stream);
}

// K5: fxz/fxy (B, R, R, C), pyz (B, NB, R, R, E*H), wxz/wxy (NB, C, E*H)
// -> out (B, R, R, R, E*OE), in one pass; scratch sxz and sxy
// (B, NB, R, R, E*H).
extern "C" int dense_decode_hybrid_f32(const float* px, const float* py, const float* pz,
                                       const float* fxz, const float* fxy, const float* pyz,
                                       const float* wxz, const float* wxy, const float* w0,
                                       const float* b0, const float* w1, const float* b1,
                                       const float* wout, const float* bout, float* out,
                                       float* sxz, float* sxy, int B, int R, int C, int E, int NB,
                                       void* stream) {
  return run<K5_F32>(px, py, pz, fxz, fxy, nullptr, pyz, wxz, wxy, nullptr, nullptr, w0, b0, w1,
                     b1, wout, bout, out, sxz, sxy, nullptr, B, R, C, E, NB, R, stream);
}

// K5 in the bf16 mode: pyz bf16, every other input float32; shapes as
// dense_decode_hybrid_f32's with C = 32; workspace ws (2, B, R, R, C) bf16.
extern "C" int dense_decode_hybrid_bf16(const float* px, const float* py, const float* pz,
                                        const float* fxz, const float* fxy, const bf16* pyz,
                                        const float* wxz, const float* wxy, const float* w0,
                                        const float* b0, const float* w1, const float* b1,
                                        const float* wout, const float* bout, float* out,
                                        bf16* ws, int B, int R, int C, int E, int NB,
                                        void* stream) {
  return run_bf16<false>(px, py, pz, fxz, fxy, nullptr, pyz, wxz, wxy, nullptr, nullptr, w0, b0,
                         w1, b1, wout, bout, out, ws, B, R, C, E, NB, 1, stream);
}

// The launch configuration of `mode` (0 K4, 1 K5, 2 K4 bf16, 3 K5 bf16) for
// these shapes, into info[7] (see fill_info).
extern "C" int dense_decode_feats_config(int mode, int B, int R, int C, int E, int NB, int XR,
                                         int* info) {
  return configure(mode, B, R, C, E, NB, XR, info);
}
