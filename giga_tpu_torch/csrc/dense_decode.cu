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
//   7.61); bf16_fold 128 registers, 8/16 bytes, 2.15-2.17 ms (default
//   2.22-2.23); bf16_resident and bf16_resident_fold 128 registers, no
//   spills, 2.78 and 2.71 ms: the resident stream's five roundings a block
//   cost ~0.55 ms.
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

#include <mutex>
#include <type_traits>

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

// bf16 mode (trunk_mma.cuh). The same work on the tensor cores: 267 GFLOP at
// B=64 is 0.270 ms at the H100's 989 TFLOP/s dense bf16 rate, against ~295
// MB of bf16 inputs read and ~197 MB of float32 output written (0.147 ms at
// 3.35 TB/s), so its bound is the tensor cores'. A warp carries 32 points x
// a head's 32 columns through mma.sync m16n8k16 (bf16 operands, float32
// accumulators), the residual stream in the accumulator layout, and each
// layer's output rounds straight into the next product's A fragments: no
// activation buffer, so a block's shared memory is its head's weights alone
// (22.3 KB at 5 blocks: bf16 fragments, float biases). Rows are read as bf16
// pairs, a lane's two columns of each 8-column n-tile, addressed from their
// indices (pointers would cost registers). Blocks are persistent as in the
// float32 mode. Resources at NB = 5 (ptxas for sm_90a): 128 registers, no
// spills; 16 warps a block, one block an SM. The A/B (ab_dense_decode.py
// --bf16, PERF.md) put 64-point tiles (244 registers, 8 warps an SM) and
// 16-point tiles (spills at 64 registers) behind it; outputs are equal bit
// for bit across the designs, since each output's sums are the same MMAs.
constexpr int BF_MT = 2;           // m16 tiles of a warp: 32 points
constexpr int BF_WARPS = 16;       // warps per block
constexpr int BF_MIN_BLOCKS = 1;   // resident blocks per SM asked of ptxas
constexpr int BF_THREADS = 32 * BF_WARPS;
using BfTile = tc::Tile<BF_MT>;
constexpr int BF_P = BfTile::P;
using bf16 = __nv_bfloat16;
static_assert(OE % 2 == 0, "head outputs in pairs");

size_t bf16_shared_bytes(int NB) { return (size_t)tc::weight_words(NB) * sizeof(unsigned); }

template <bool kPointMajor, bool kFoldB1, bool kResident>
__global__ void __launch_bounds__(BF_THREADS, BF_MIN_BLOCKS)
dense_decode_bf16_kernel(const bf16* __restrict__ px, const bf16* __restrict__ py,
                         const bf16* __restrict__ pz, const bf16* __restrict__ pxz,
                         const bf16* __restrict__ pxy, const bf16* __restrict__ pyz,
                         const bf16* __restrict__ w0, const bf16* __restrict__ b0,
                         const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                         const bf16* __restrict__ wout, const bf16* __restrict__ bout,
                         float* __restrict__ out, int B, int R, int E, int NB) {
  extern __shared__ __align__(16) unsigned wsmem[];
  const int e = blockIdx.y, F = E * H;
  const tc::Weights s = tc::load_weights(wsmem, w0, b0, w1, b1, wout, bout, e, E, NB);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();

  const int RR = R * R, N = RR * R;
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
          ix[m][h] = n / RR;
          iy[m][h] = (n / R) % R;
          iz[m][h] = n % R;
          ixz[m][h] = ix[m][h] * R + iz[m][h];
          ixy[m][h] = ix[m][h] * R + iy[m][h];
          iyz[m][h] = iy[m][h] * R + iz[m][h];
        }
      tc::rows<true>(net, px + col, ix, F, lane);
      tc::rows<false>(net, py + col, iy, F, lane);
      tc::rows<false>(net, pz + col, iz, F, lane);
      if (kResident) tc::round_tile(net);
    }
    for (int k = 0; k < NB; ++k) {
      const size_t first = (((size_t)b * NB + k) * RR) * F + col;
      tc::rows<false>(net, pxz + first, ixz, F, lane);
      if (kResident) tc::round_tile(net);
      tc::rows<false>(net, pxy + first, ixy, F, lane);
      if (kResident) tc::round_tile(net);
      tc::rows<false>(net, pyz + first, iyz, F, lane);
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
        const int n = base + tc::point(m, h, lane);
        if (c < OE && n < N) {
          if (kPointMajor) {
            reinterpret_cast<float2*>(out)[(((size_t)b * N + n) * E * OE + e * OE + c) / 2] =
                make_float2(o[m][2 * h], o[m][2 * h + 1]);
          } else {
            float* dst = out + ((size_t)b * E * OE + e * OE + c) * N + n;
            dst[0] = o[m][2 * h];
            dst[N] = o[m][2 * h + 1];
          }
        }
      }
  }
}

// A kernel and its launch shape: kBf16 picks the bf16 mode, kPointMajor
// K3's output layout, kFoldB1 and kResident K2's options.
template <bool kBf16, bool kPointMajor, bool kFoldB1 = false, bool kResident = false>
struct Kernel {
  static_assert(kBf16 || !kResident, "the resident stream is a bf16 mode's");
  static constexpr int threads = kBf16 ? BF_THREADS : THREADS;
  static constexpr int warps = kBf16 ? BF_WARPS : WARPS;
  static constexpr int points = kBf16 ? BF_P : P;  // lattice points of a warp tile
  static size_t shared(int NB) { return kBf16 ? bf16_shared_bytes(NB) : shared_bytes(NB); }
  static const void* function() {
    if constexpr (kBf16)
      return reinterpret_cast<const void*>(
          dense_decode_bf16_kernel<kPointMajor, kFoldB1, kResident>);
    else
      return reinterpret_cast<const void*>(dense_decode_kernel<kPointMajor, kFoldB1>);
  }
};

// Resident blocks per SM and SMs of the current device for a kernel at NB
// blocks. The first launch on a device (or with another NB) sets the
// kernel's shared-memory attributes and asks the occupancy; later launches
// reuse the answer.
struct Occupancy {
  int nb = -1, per_sm = 0, sms = 0;
};

template <class K>
int occupancy(int NB, Occupancy* occ) {
  constexpr int kDevices = 16;
  static std::mutex mu;
  static Occupancy cached[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kDevices && cached[dev].nb == NB) {
    *occ = cached[dev];
    return 0;
  }
  const void* kernel = K::function();
  const size_t shmem = K::shared(NB);
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
  occ->nb = NB;
  occ->per_sm = per_sm;
  occ->sms = sms;
  if (dev < kDevices) cached[dev] = *occ;
  return 0;
}

// Launch configuration: info = {resident blocks per SM, SMs, blocks per head
// (grid.x), heads (grid.y), threads per block, dynamic shared bytes}.
template <class K>
int configure(int B, int R, int E, int NB, int* info) {
  Occupancy occ;
  const int err = occupancy<K>(NB, &occ);
  if (err) return err;
  const long units = (long)B * ((R * R * R + K::points - 1) / K::points);
  long per_head = (long)occ.per_sm * occ.sms / E;
  per_head = per_head < 1 ? 1 : per_head;
  const long needed = (units + K::warps - 1) / K::warps;
  info[0] = occ.per_sm;
  info[1] = occ.sms;
  info[2] = (int)(per_head < needed ? per_head : needed);
  info[3] = E;
  info[4] = K::threads;
  info[5] = (int)K::shared(NB);
  return 0;
}

template <bool kPointMajor, bool kFoldB1 = false, bool kResident = false, typename T>
int launch(const T* px, const T* py, const T* pz, const T* pxz, const T* pxy, const T* pyz,
           const T* w0, const T* b0, const T* w1, const T* b1, const T* wout, const T* bout,
           float* out, int B, int R, int E, int NB, void* stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  int info[6];
  int err = configure<Kernel<kBf16, kPointMajor, kFoldB1, kResident>>(B, R, E, NB, info);
  if (err) return err;
  dim3 grid(info[2], E);
  if constexpr (kBf16)
    dense_decode_bf16_kernel<kPointMajor, kFoldB1, kResident>
        <<<grid, BF_THREADS, info[5], (cudaStream_t)stream>>>(
            px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out, B, R, E, NB);
  else
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

// The launch configuration a kernel takes for these shapes, into info[6]
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
