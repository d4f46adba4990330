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
// bf16 mode (trunk_mma.cuh). The TPU kernels take every input in float32
// here (prepare_feats_inputs; prepare_hybrid_inputs, whose pyz alone is
// stored in bf16) and round operands to bf16 only at the products, with
// float32 sums. So project_kernel rounds each feature and weight to bf16
// before its fmaf (the products are exact, the sums float32, c ascending)
// and still writes float32 rows: rounding them would change the function.
// The trunk is K2 bf16's (dense_decode.cu): warps of 32-point tiles through
// mma.sync m16n8k16, the residual stream in the accumulator layout, the
// head's weights rounded once to bf16 B fragments in shared memory, blocks
// persistent. It reads float32 rows as float2 pairs (K5's bf16 pyz as bf16
// pairs) and adds K4's fc_c bias, kept in shared memory, as a fourth
// float32 row. Its bound is the tensor cores': 278.8 GFLOP (K4) and 273.7
// (K5) at 989 TFLOP/s, 0.282 and 0.277 ms, against 236 MB and 321 MB read
// and written (0.070 and 0.096 ms at 3.35 TB/s). Resources: the trunk 128
// registers, no spills, 22,928 bytes of shared memory, 44 x 3 blocks of 512
// threads; the projections 65 registers. On an NVIDIA H100 80GB HBM3 at
// 700 W, at B=64: K4 3.88-3.93 ms (7.2% of its bound), K5 3.29-3.30 ms
// (8.4%), against K2 bf16's 2.24 ms on bf16 rows: this design is the
// simple one, its float32 rows twice K2 bf16's bytes.
//
// No float atomics: every float32 sum is in a fixed order.

#include <cuda_bf16.h>

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
// The bf16 mode's trunk: K2 bf16's design
constexpr int BF_MT = 2;          // m16 tiles of a warp: 32 points
constexpr int BF_WARPS = 16;      // warps per block
constexpr int BF_MIN_BLOCKS = 1;  // resident blocks per SM asked of ptxas
constexpr int BF_THREADS = 32 * BF_WARPS;
using BfTile = tc::Tile<BF_MT>;
constexpr int BF_P = BfTile::P;
static_assert(OE % 2 == 0, "head outputs in pairs");

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

// A projection operand: as it is, or rounded to bf16 (kBf16).
template <bool kBf16>
__device__ __forceinline__ float proj_operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Job blockIdx.y of `jobs`: a block stages PROJ_ROWS feature rows in shared
// memory and forms their rows for all NB blocks, a thread PROJ_TR rows x
// PROJ_TC columns at a time, its weights read through L1. With kBf16 both
// operands of each product are rounded to bf16 first; the sums and the
// rows written stay float32. (PROJ_ROWS / PROJ_TR) * (F / PROJ_TC) threads.
template <bool kBf16>
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
    fs[c * PROJ_S + r] = proj_operand<kBf16>(v);
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
        w[4 * q] = proj_operand<kBf16>(u.x), w[4 * q + 1] = proj_operand<kBf16>(u.y);
        w[4 * q + 2] = proj_operand<kBf16>(u.z), w[4 * q + 3] = proj_operand<kBf16>(u.w);
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
template <bool kBf16>
int project(const ProjJobs& jobs, int n, int B, int R, int C, int F, int NB, cudaStream_t stream) {
  if (n == 0) return 0;
  int na = 0;
  for (int i = 0; i < n; ++i) na = jobs.job[i].NA > na ? jobs.job[i].NA : na;
  const long M = (long)B * na * R;
  project_kernel<kBf16><<<dim3((unsigned)((M + PROJ_ROWS - 1) / PROJ_ROWS), n),
                          project_threads(F), project_shared_bytes(C), stream>>>(jobs, B, R, C,
                                                                                 F, NB);
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

size_t bf16_trunk_shared_bytes(int NB) {
  return (size_t)tc::weight_words(NB) * sizeof(unsigned) + (size_t)NB * H * sizeof(float);
}

// The bf16 mode's trunk over the points of x-slabs x0 .. x0 + XR - 1: rows
// as dense_decode_feats_kernel's, float32 but for pyz (Pyz: float32 for
// K4's projected rows, bf16 for K5's given pyz); float32 weights, rounded to
// bf16 fragments as they are copied to shared memory.
template <typename Pyz, bool kBias>
__global__ void __launch_bounds__(BF_THREADS, BF_MIN_BLOCKS)
dense_decode_feats_bf16_kernel(const float* __restrict__ px, const float* __restrict__ py,
                               const float* __restrict__ pz, const float* __restrict__ pxz,
                               const float* __restrict__ pxy, const Pyz* __restrict__ pyz,
                               const float* __restrict__ bc, const float* __restrict__ w0,
                               const float* __restrict__ b0, const float* __restrict__ w1,
                               const float* __restrict__ b1, const float* __restrict__ wout,
                               const float* __restrict__ bout, float* __restrict__ out, int B,
                               int R, int E, int NB, int x0, int XR) {
  extern __shared__ __align__(16) unsigned wsmem[];
  const int e = blockIdx.y, F = E * H;
  const tc::Weights s = tc::load_weights(wsmem, w0, b0, w1, b1, wout, bout, e, E, NB);
  float* bsh = reinterpret_cast<float*>(wsmem + tc::weight_words(NB));  // (NB, H): head e's bc
  if (kBias)
    for (int i = threadIdx.x; i < NB * H; i += blockDim.x)
      bsh[i] = bc[(size_t)(i / H) * F + e * H + i % H];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();

  const int RR = R * R, N = XR * RR;
  const int tiles = (N + BF_P - 1) / BF_P;
  const long units = (long)B * tiles;
  const int col = e * H;
  for (long u = (long)blockIdx.x * BF_WARPS + warp; u < units; u += (long)gridDim.x * BF_WARPS) {
    const int b = (int)(u / tiles);
    const int base = (int)(u % tiles) * BF_P;
    int ixz[BF_MT][2], ixy[BF_MT][2], iyz[BF_MT][2];
    BfTile net;
    {
      int ix[BF_MT][2], iy[BF_MT][2], iz[BF_MT][2];
#pragma unroll
      for (int m = 0; m < BF_MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = min(base + tc::point(m, h, lane), N - 1);  // clamped past N
          const int xl = n / RR;
          ix[m][h] = x0 + xl;
          iy[m][h] = (n / R) % R;
          iz[m][h] = n % R;
          ixz[m][h] = xl * R + iz[m][h];
          ixy[m][h] = xl * R + iy[m][h];
          iyz[m][h] = iy[m][h] * R + iz[m][h];
        }
      tc::rows<true>(net, px + col, ix, F, lane);
      tc::rows<false>(net, py + col, iy, F, lane);
      tc::rows<false>(net, pz + col, iz, F, lane);
    }
    for (int k = 0; k < NB; ++k) {
      const size_t slabs = ((size_t)b * NB + k) * XR * R * F + col;
      const size_t plane = ((size_t)b * NB + k) * RR * F + col;
      tc::rows<false>(net, pxz + slabs, ixz, F, lane);
      tc::rows<false>(net, pxy + slabs, ixy, F, lane);
      tc::rows<false>(net, pyz + plane, iyz, F, lane);
      if (kBias) tc::add_columns(net, bsh + k * H, lane);
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
        const int n = base + tc::point(m, h, lane);
        if (c < OE && n < N)
          reinterpret_cast<float2*>(out)[((((size_t)b * R + x0) * RR + n) * E * OE + e * OE + c) /
                                         2] = make_float2(o[m][2 * h], o[m][2 * h + 1]);
      }
  }
}

// A mode's trunk kernel and its launch shape.
struct Trunk {
  const void* fn;
  int threads, warps, points;  // per block, per block, per warp tile
  size_t shmem;                // dynamic shared bytes per block
};

Trunk trunk_of(int mode, int NB) {
  switch (mode) {
    case K4_F32:
      return {reinterpret_cast<const void*>(dense_decode_feats_kernel<true>), THREADS, WARPS, P,
              trunk_shared_bytes(NB)};
    case K5_F32:
      return {reinterpret_cast<const void*>(dense_decode_feats_kernel<false>), THREADS, WARPS, P,
              trunk_shared_bytes(NB)};
    case K4_BF16:
      return {reinterpret_cast<const void*>(dense_decode_feats_bf16_kernel<float, true>),
              BF_THREADS, BF_WARPS, BF_P, bf16_trunk_shared_bytes(NB)};
    default:
      return {reinterpret_cast<const void*>(dense_decode_feats_bf16_kernel<bf16, false>),
              BF_THREADS, BF_WARPS, BF_P, bf16_trunk_shared_bytes(NB)};
  }
}

// A mode's launch configuration into info[7] = {resident trunk blocks per
// SM, SMs, trunk blocks per head (grid.x) of the largest pass, heads, trunk
// threads per block, trunk dynamic shared bytes, passes}.
int configure(int mode, int B, int R, int C, int E, int NB, int XR, int* info) {
  const int F = E * H;
  if (mode < K4_F32 || mode > K5_BF16 || XR < 1 || C < 1 || F % PROJ_TC != 0 ||
      project_threads(F) > PROJ_MAX_THREADS || project_shared_bytes(C) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Trunk t = trunk_of(mode, NB);
  const void* proj = mode >= K4_BF16 ? reinterpret_cast<const void*>(project_kernel<true>)
                                     : reinterpret_cast<const void*>(project_kernel<false>);
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaFuncSetAttribute(t.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)t.shmem)) ||
      (err = cudaFuncSetAttribute(proj, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)project_shared_bytes(C))) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, t.fn, t.threads, t.shmem)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int xr = XR < R ? XR : R;
  const long units = (long)B * ((xr * R * R + t.points - 1) / t.points);
  long per_head = (long)per_sm * sms / E;
  per_head = per_head < 1 ? 1 : per_head;
  const long needed = (units + t.warps - 1) / t.warps;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = (int)(per_head < needed ? per_head : needed);
  info[3] = E;
  info[4] = t.threads;
  info[5] = (int)t.shmem;
  info[6] = (R + xr - 1) / xr;
  return 0;
}

// One mode's passes of XR x-slabs: the pass's xz and xy rows (and in K4's
// first pass the yz rows of all slabs into syz, which K4 passes as pyz),
// then the trunk over the pass's points.
template <Mode kMode, typename Pyz>
int run(const float* px, const float* py, const float* pz, const float* fxz, const float* fxy,
        const float* fyz, const Pyz* pyz, const float* wxz, const float* wxy, const float* wyz,
        const float* bc, const float* w0, const float* b0, const float* w1, const float* b1,
        const float* wout, const float* bout, float* out, float* sxz, float* sxy, float* syz,
        int B, int R, int C, int E, int NB, int XR, void* stream) {
  constexpr bool kK4 = kMode == K4_F32 || kMode == K4_BF16, kBf16 = kMode >= K4_BF16;
  int info[7];
  int err = configure(kMode, B, R, C, E, NB, XR, info);
  if (err) return err;
  const int F = E * H;
  const Trunk t = trunk_of(kMode, NB);
  cudaStream_t st = (cudaStream_t)stream;
  for (int x0 = 0; x0 < R; x0 += XR) {
    const int xr = R - x0 < XR ? R - x0 : XR;
    ProjJobs jobs{};
    int n = 0;
    jobs.job[n++] = {fxz, wxz, sxz, x0, xr};
    jobs.job[n++] = {fxy, wxy, sxy, x0, xr};
    if (kK4 && x0 == 0) jobs.job[n++] = {fyz, wyz, syz, 0, R};
    if ((err = project<kBf16>(jobs, n, B, R, C, F, NB, st))) return err;
    const long units = (long)B * ((xr * R * R + t.points - 1) / t.points);
    const long needed = (units + t.warps - 1) / t.warps;
    const dim3 grid((unsigned)(info[2] < needed ? info[2] : needed), E);
    if constexpr (kBf16)
      dense_decode_feats_bf16_kernel<Pyz, kK4><<<grid, BF_THREADS, info[5], st>>>(
          px, py, pz, sxz, sxy, pyz, bc, w0, b0, w1, b1, wout, bout, out, B, R, E, NB, x0, xr);
    else
      dense_decode_feats_kernel<kK4><<<grid, THREADS, info[5], st>>>(
          px, py, pz, sxz, sxy, pyz, bc, w0, b0, w1, b1, wout, bout, out, B, R, E, NB, x0, xr);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
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

// K4 in the bf16 mode: every input float32, shapes as dense_decode_feats_f32's.
extern "C" int dense_decode_feats_bf16(const float* px, const float* py, const float* pz,
                                       const float* fxz, const float* fxy, const float* fyz,
                                       const float* wxz, const float* wxy, const float* wyz,
                                       const float* bc, const float* w0, const float* b0,
                                       const float* w1, const float* b1, const float* wout,
                                       const float* bout, float* out, float* sxz, float* sxy,
                                       float* syz, int B, int R, int C, int E, int NB, int XR,
                                       void* stream) {
  return run<K4_BF16>(px, py, pz, fxz, fxy, fyz, syz, wxz, wxy, wyz, bc, w0, b0, w1, b1, wout,
                      bout, out, sxz, sxy, syz, B, R, C, E, NB, XR, stream);
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
// dense_decode_hybrid_f32's.
extern "C" int dense_decode_hybrid_bf16(const float* px, const float* py, const float* pz,
                                        const float* fxz, const float* fxy, const bf16* pyz,
                                        const float* wxz, const float* wxy, const float* w0,
                                        const float* b0, const float* w1, const float* b1,
                                        const float* wout, const float* bout, float* out,
                                        float* sxz, float* sxy, int B, int R, int C, int E,
                                        int NB, void* stream) {
  return run<K5_BF16>(px, py, pz, fxz, fxy, nullptr, pyz, wxz, wxy, nullptr, nullptr, w0, b0, w1,
                      b1, wout, bout, out, sxz, sxy, nullptr, B, R, C, E, NB, R, stream);
}

// The launch configuration of `mode` (0 K4, 1 K5, 2 K4 bf16, 3 K5 bf16) for
// these shapes, into info[7] (see configure).
extern "C" int dense_decode_feats_config(int mode, int B, int R, int C, int E, int NB, int XR,
                                         int* info) {
  return configure(mode, B, R, C, E, NB, XR, info);
}
