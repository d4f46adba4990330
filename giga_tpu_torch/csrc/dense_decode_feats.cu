// Dense-decode trunk of the GIGA affordance decoder with the per-block fc_c
// plane projections formed from raw lattice features, fp32, for Hopper
// (sm_90a). Two entry points:
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
// Both start from net = px[x] + py[y] + pz[z], run the per-head trunk (the
// same arithmetic as K2), and write (B, R, R, R, E*OE) indexed [b, x, y, z, o],
// the four outputs of a head as one 16-byte store.
//
// What bounds them: at B=64, R=40, 5 blocks, C=32 the trunk is ~267 GFLOP
// (heads run apart, as in K2); the projections, counted once per plane row,
// add ~9.4 GFLOP (K4) or ~6.3 GFLOP (K5): 278.8 GFLOP for K4, 4.16 ms at the
// H100's 67 TFLOP/s fp32 rate. K4 reads only the raw features (~39 MB) and
// writes ~197 MB (0.07 ms at 3.35 TB/s). Both are bound by fp32 CUDA-core
// arithmetic.
//
// K4 design. A projection row is shared by every lattice point of its plane
// line (R points), so formed per point it would add half of the trunk's work
// (C*H against 2*H*H FMAs per block and head); formed in shared memory per
// block of points it needs each (x, block) pair's rows in every block that
// touches x, and the barriers around them (the kernel this replaces: one
// point per thread, 213 KB of shared memory, 5.1x its bound). Here K4 runs in
// two kinds of launch on the caller's stream:
//  1. project_kernel forms each plane's rows for all blocks and heads once,
//     (rows, C) @ (C, NB*F) in register tiles of 8 rows x 4 columns, into
//     scratch the wrapper allocates: pyz (B, NB, R, R, F) once per call, and
//     the xz and xy rows (B, NB, XR, R, F) of each pass of XR x-slabs.
//  2. dense_decode_feats_kernel runs the pass's points through the register-
//     tiled trunk of trunk_tiled.cuh with K2's persistent blocks (each copies
//     its head's weights and fc_c biases to shared memory once; its warps
//     stride over (scene, 64-point tile) pairs, a lane an 8-point x 8-column
//     micro-tile), reading its rows as K2 reads its projections, then adding
//     the fc_c bias.
// Every projection is a dot over c ascending, one fmaf each from zero, and
// the trunk adds ((((net + xz) + xy) + yz) + bc) per block in the order of
// the kernel this replaces, so the output is that kernel's bit for bit, and
// does not depend on XR. The plain version's matrix products may sum in
// another order, hence the 1e-5*(1+|b|) tolerance.
//
// Resources and time (ptxas for sm_90a; chip_smoke.py prints them): the
// trunk 168 registers, 328/332 bytes of spill stores/loads, 147,856 bytes
// of shared memory (K2's and the head's fc_c biases), 44 x 3 blocks of 384
// threads on an H100's 132 SMs; the projections 63 registers, no spills,
// 2*F threads and 8.7 KB a block. Scratch at B=64, R=40 and one pass: 590
// MB. On an NVIDIA H100 80GB HBM3 at 700 W, 8.27-8.34 ms at B=64 in one
// pass (XR = 40), 50% of the bound; 8.8 ms in passes of 8. The A/B
// (ab_dense_decode_feats.py, PERF.md) puts ~0.27 ms in the xz/xy
// projections, ~0.12 ms in pyz and ~0.13 ms in the separate fc_c bias add
// that the parent's sum order needs; read through L1, the biases cost
// ~0.22 ms more.
//
// K5 design: a block owns (x-slab, head, scene). It projects its slab's
// R rows of fxz and of fxy for every block into shared memory (2*NB*R*H
// floats, 58 KB at R=40 with padded rows) beside the head's trunk weights
// (43 KB), then its 256 threads walk the slab's R^2 points with the
// one-point-per-thread trunk of trunk.cuh. The rows cost ~2.5 % of the
// slab's trunk work.
//
// No float atomics, no tensor cores: every sum is fp32 in a fixed order.

#include "trunk_tiled.cuh"

namespace {

using trunk::H;
using trunk::OE;
constexpr int HP = H + 4;  // padded row of projected features: conflict-free 16-byte reads
constexpr int K5_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use on sm_90

// K4's trunk (ab_dense_decode_feats.py rewrites these constants in a copy of
// this source to time the alternatives):
constexpr int TP = 8;          // points of a lane's micro-tile
constexpr int TC = 8;          // columns of a lane's micro-tile
constexpr int WARPS = 12;      // warps per block
constexpr int MIN_BLOCKS = 1;  // resident blocks per SM asked of ptxas
constexpr int KUNROLL = 2;     // k steps of a product unrolled at a time
constexpr int THREADS = 32 * WARPS;
using Lane = tiled::Lane<TP, TC, KUNROLL>;
constexpr int P = Lane::P;
// K4's projections (rewritten by the A/B too): a block forms PROJ_ROWS plane
// rows for every block, a thread a PROJ_TR x PROJ_TC register tile at a time
constexpr int PROJ_ROWS = 64;
constexpr int PROJ_TR = 8;
constexpr int PROJ_TC = 4;
constexpr int PROJ_MAX_THREADS = 512;  // (PROJ_ROWS / PROJ_TR) * (F / PROJ_TC) at most
constexpr int PROJ_S = PROJ_ROWS + 4;  // floats per feature of the staged rows

// acc[h] = sum_c f[c] * w[c*F + h] for the head's H columns, c in order.
__device__ __forceinline__ float dot_col(const float* __restrict__ f, const float* __restrict__ w,
                                        int C, int F) {
  float acc = 0.f;
  for (int c = 0; c < C; ++c) acc = fmaf(f[c], __ldg(w + (size_t)c * F), acc);
  return acc;
}

// out[b, x, y, z, e*OE .. e*OE+3] = o
__device__ __forceinline__ void store_point(float* out, float4 o, int b, int x, int p, int R,
                                            int E, int e) {
  reinterpret_cast<float4*>(out)[(((size_t)b * R + x) * R * R + p) * E + e] = o;
}

__global__ void __launch_bounds__(K5_THREADS, 2)
dense_decode_hybrid_kernel(const float* __restrict__ px, const float* __restrict__ py,
                           const float* __restrict__ pz, const float* __restrict__ fxz,
                           const float* __restrict__ fxy, const float* __restrict__ pyz,
                           const float* __restrict__ wxz, const float* __restrict__ wxy,
                           const float* __restrict__ w0, const float* __restrict__ b0,
                           const float* __restrict__ w1, const float* __restrict__ b1,
                           const float* __restrict__ wout, const float* __restrict__ bout,
                           float* __restrict__ out, int R, int C, int E, int NB) {
  extern __shared__ __align__(16) float smem[];
  const int x = blockIdx.x, e = blockIdx.y, b = blockIdx.z, F = E * H, col = e * H;
  const trunk::Weights s = trunk::load_weights(smem, w0, b0, w1, b1, wout, bout, e, E, NB);
  float* rowz = smem + trunk::weight_floats(NB);  // (NB, R, HP): fxz[b, x, z] @ wxz[blk]
  float* rowy = rowz + NB * R * HP;               // (NB, R, HP): fxy[b, x, y] @ wxy[blk]

  const float* fz = fxz + ((size_t)b * R + x) * R * C;
  const float* fy = fxy + ((size_t)b * R + x) * R * C;
  for (int i = threadIdx.x; i < NB * R * H; i += blockDim.x) {
    const int h = i % H, r = (i / H) % R, blk = i / (H * R);
    const size_t w = (size_t)blk * C * F + col + h;
    rowz[(blk * R + r) * HP + h] = dot_col(fz + (size_t)r * C, wxz + w, C, F);
    rowy[(blk * R + r) * HP + h] = dot_col(fy + (size_t)r * C, wxy + w, C, F);
  }
  __syncthreads();

  for (int p = threadIdx.x; p < R * R; p += blockDim.x) {
    const int y = p / R, z = p % R;
    float net[H];
    trunk::set_row(net, px + (size_t)x * F + col);
    trunk::add_row(net, py + (size_t)y * F + col);
    trunk::add_row(net, pz + (size_t)z * F + col);
    for (int blk = 0; blk < NB; ++blk) {
      trunk::add_row(net, rowz + (blk * R + z) * HP);
      trunk::add_row(net, rowy + (blk * R + y) * HP);
      trunk::add_row(net, pyz + ((((size_t)b * NB + blk) * R + y) * R + z) * F + col);
      trunk::resnet_block(net, s, blk);
    }
    store_point(out, trunk::head_out(net, s), b, x, p, R, E, e);
  }
}

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

// The trunk over the points of x-slabs x0 .. x0 + XR - 1 of every scene: pxz
// and pxy hold the pass's rows (B, NB, XR, R, F), pyz (B, NB, R, R, F).
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

// K4's launch configuration into info[7] = {resident trunk blocks per SM,
// SMs, trunk blocks per head (grid.x) of the largest pass, heads, trunk
// threads per block, trunk dynamic shared bytes, passes}.
int feats_configure(int B, int R, int C, int E, int NB, int XR, int* info) {
  const int F = E * H;
  if (XR < 1 || C < 1 || F % PROJ_TC != 0 || project_threads(F) > PROJ_MAX_THREADS ||
      project_shared_bytes(C) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = trunk_shared_bytes(NB);
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaFuncSetAttribute(dense_decode_feats_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem)) ||
      (err = cudaFuncSetAttribute(project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)project_shared_bytes(C))) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_decode_feats_kernel,
                                                           THREADS, shmem)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int xr = XR < R ? XR : R;
  const long units = (long)B * ((xr * R * R + P - 1) / P);
  long per_head = (long)per_sm * sms / E;
  per_head = per_head < 1 ? 1 : per_head;
  const long needed = (units + WARPS - 1) / WARPS;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = (int)(per_head < needed ? per_head : needed);
  info[3] = E;
  info[4] = THREADS;
  info[5] = (int)shmem;
  info[6] = (R + xr - 1) / xr;
  return 0;
}

}  // namespace

// K5: fxz/fxy (B, R, R, C), pyz (B, NB, R, R, E*H), wxz/wxy (NB, C, E*H)
// -> out (B, R, R, R, E*OE).
extern "C" int dense_decode_hybrid_f32(const float* px, const float* py, const float* pz,
                                       const float* fxz, const float* fxy, const float* pyz,
                                       const float* wxz, const float* wxy, const float* w0,
                                       const float* b0, const float* w1, const float* b1,
                                       const float* wout, const float* bout, float* out,
                                       int B, int R, int C, int E, int NB, void* stream) {
  size_t shmem = ((size_t)trunk::weight_floats(NB) + 2 * (size_t)NB * R * HP) * sizeof(float);
  if (shmem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dense_decode_hybrid_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  dense_decode_hybrid_kernel<<<dim3(R, E, B), K5_THREADS, shmem, (cudaStream_t)stream>>>(
      px, py, pz, fxz, fxy, pyz, wxz, wxy, w0, b0, w1, b1, wout, bout, out, R, C, E, NB);
  return (int)cudaGetLastError();
}

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
  int info[7];
  int err = feats_configure(B, R, C, E, NB, XR, info);
  if (err) return err;
  const int F = E * H;
  cudaStream_t st = (cudaStream_t)stream;
  for (int x0 = 0; x0 < R; x0 += XR) {
    const int xr = R - x0 < XR ? R - x0 : XR;
    // the pass's xz and xy rows, and in the first pass the yz rows of all slabs
    ProjJobs jobs{};
    int n = 0;
    jobs.job[n++] = {fxz, wxz, sxz, x0, xr};
    jobs.job[n++] = {fxy, wxy, sxy, x0, xr};
    if (x0 == 0) jobs.job[n++] = {fyz, wyz, syz, 0, R};
    if ((err = project(jobs, n, B, R, C, F, NB, st))) return err;
    const long units = (long)B * ((xr * R * R + P - 1) / P);
    const long needed = (units + WARPS - 1) / WARPS;
    dense_decode_feats_kernel<<<dim3((unsigned)(info[2] < needed ? info[2] : needed), E),
                                THREADS, info[5], st>>>(
        px, py, pz, sxz, sxy, syz, bc, w0, b0, w1, b1, wout, bout, out, B, R, E, NB, x0, xr);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

// K4's launch configuration for these shapes, into info[7] (see feats_configure).
extern "C" int dense_decode_feats_config(int B, int R, int C, int E, int NB, int XR, int* info) {
  return feats_configure(B, R, C, E, NB, XR, info);
}
