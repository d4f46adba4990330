// Dense-decode trunk of the GIGA affordance decoder with the per-block fc_c
// plane projections formed in-kernel from raw lattice features, fp32, for
// Hopper (sm_90a). Two entry points:
//
//   K4 dense_decode_feats_f32: replaces giga_tpu/ops/pallas/decoder_kernel.py::
//      fused_dense_decode_feats_batched (pallas_call at :608, body
//      _feats_kernel :507). All three projections in-kernel:
//        net += fxz[b,x,z] @ wxz[i] ; net += fxy[b,x,y] @ wxy[i] ;
//        net += fyz[b,y,z] @ wyz[i] ; net += bc[i]
//   K5 dense_decode_hybrid_f32: replaces decoder_kernel.py::
//      fused_dense_decode_hybrid_batched (pallas_call at :447, body
//      _trunk_kernel_hybrid :358). The xz/xy rows in-kernel, pyz read from
//      memory with the fc_c bias folded into it:
//        net += fxz[b,x,z] @ wxz[i] ; net += fxy[b,x,y] @ wxy[i] ; net += pyz[b,i,y,z]
// Both start from net = px[x] + py[y] + pz[z] and run the per-head trunk of
// trunk.cuh (the same arithmetic as K2), and write (B, R, R, R, E*OE)
// indexed [b, x, y, z, o], the four outputs of a head as one 16-byte store.
//
// What bounds them: at B=64, R=40, 5 blocks, C=32 the trunk is ~267 GFLOP
// (heads run apart, as in K2); the projections, counted once per plane row,
// add ~9.4 GFLOP (K4) or ~6.3 GFLOP (K5). K4 reads only the raw features
// (~39 MB) and writes ~197 MB; K5 also reads the ~197 MB pyz. Both are bound
// by fp32 CUDA-core arithmetic, so the design's aim is to form each
// projection row few times over.
//
// K5 design: a block owns (x-slab, head, scene). It projects its slab's
// R rows of fxz and of fxy for every block into shared memory (2*NB*R*H
// floats, 58 KB at R=40 with padded rows) beside the head's trunk weights
// (43 KB), then its 256 threads walk the slab's R^2 points. The rows cost
// ~2.5 % of the slab's trunk work.
//
// K4 design: pyz[b,i,y,z] is the same for every x, and formed per point it
// would cost C*H FMAs per block against the trunk's 2*H*H. So a block owns
// a tile of 256 consecutive (y, z) points (one per thread), a run of XR
// x-slabs, a head and a scene. Each thread forms its point's pyz for all
// blocks once (NB*H floats, 160 KB of shared memory for the tile) and then
// loops over x; per x and block, the threads form the R rows of xz and the
// few rows of xy the tile touches into shared memory between two barriers
// (~9 % of the trunk work at R=40), and each runs its point's trunk block.
// One block of 8 warps per SM (213 KB of shared memory).
//
// No float atomics, no tensor cores: every sum is fp32 in a fixed order.
// The projection dots run over c in order; the plain version's matrix
// product may sum in another order, hence the 1e-5*(1+|b|) tolerance.

#include "trunk.cuh"

namespace {

using trunk::H;
using trunk::OE;
constexpr int HP = H + 4;  // padded row of projected features: conflict-free 16-byte reads
constexpr int K5_THREADS = 256;
constexpr int K4_TILE = 256;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use on sm_90

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

__global__ void __launch_bounds__(K4_TILE, 1)
dense_decode_feats_kernel(const float* __restrict__ px, const float* __restrict__ py,
                          const float* __restrict__ pz, const float* __restrict__ fxz,
                          const float* __restrict__ fxy, const float* __restrict__ fyz,
                          const float* __restrict__ wxz, const float* __restrict__ wxy,
                          const float* __restrict__ wyz, const float* __restrict__ bc,
                          const float* __restrict__ w0, const float* __restrict__ b0,
                          const float* __restrict__ w1, const float* __restrict__ b1,
                          const float* __restrict__ wout, const float* __restrict__ bout,
                          float* __restrict__ out, int R, int C, int E, int NB, int XR,
                          int NYMAX) {
  extern __shared__ __align__(16) float smem[];
  const int nxr = (R + XR - 1) / XR;
  const int e = blockIdx.y, b = blockIdx.z / nxr, x0 = (blockIdx.z % nxr) * XR;
  const int x1 = min(R, x0 + XR), F = E * H, col = e * H, RR = R * R;
  const trunk::Weights s = trunk::load_weights(smem, w0, b0, w1, b1, wout, bout, e, E, NB);
  float4* spyz = reinterpret_cast<float4*>(smem + trunk::weight_floats(NB));  // (NB, H/4, TILE)
  float* rowz = smem + trunk::weight_floats(NB) + NB * H * K4_TILE;            // (R, HP)
  float* rowy = rowz + R * HP;                                                 // (NYMAX, HP)

  const int p0 = blockIdx.x * K4_TILE, p = p0 + threadIdx.x;
  const bool live = p < RR;
  const int y = live ? p / R : 0, z = live ? p % R : 0;
  const int y0 = p0 / R, ny = (min(p0 + K4_TILE, RR) - 1) / R - y0 + 1;  // rows y0 .. y0+ny-1

  // this thread's pyz for every block, once for all x
  if (live) {
    const float* f = fyz + (((size_t)b * R + y) * R + z) * C;
    for (int blk = 0; blk < NB; ++blk) {
      float acc[H];
#pragma unroll
      for (int j = 0; j < H; ++j) acc[j] = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = f[c];
        const float4* w = reinterpret_cast<const float4*>(wyz + ((size_t)blk * C + c) * F + col);
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 u = __ldg(w + q);
          acc[4 * q + 0] = fmaf(v, u.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, u.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, u.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, u.w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int q = 0; q < H / 4; ++q)
        spyz[(blk * (H / 4) + q) * K4_TILE + threadIdx.x] =
            make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  }

  for (int x = x0; x < x1; ++x) {
    float net[H];
    if (live) {
      trunk::set_row(net, px + (size_t)x * F + col);
      trunk::add_row(net, py + (size_t)y * F + col);
      trunk::add_row(net, pz + (size_t)z * F + col);
    }
    const float* fz = fxz + ((size_t)b * R + x) * R * C;
    const float* fy = fxy + ((size_t)b * R + x) * R * C;
    for (int blk = 0; blk < NB; ++blk) {
      __syncthreads();  // the last block's rows are read (and, first time, the weights written)
      const size_t w = (size_t)blk * C * F + col;
      for (int i = threadIdx.x; i < (R + ny) * H; i += blockDim.x) {
        const int h = i % H, r = i / H;
        if (r < R) {
          rowz[r * HP + h] = dot_col(fz + (size_t)r * C, wxz + w + h, C, F);
        } else {
          rowy[(r - R) * HP + h] = dot_col(fy + (size_t)(y0 + r - R) * C, wxy + w + h, C, F);
        }
      }
      __syncthreads();
      if (live) {
        trunk::add_row(net, rowz + z * HP);
        trunk::add_row(net, rowy + (y - y0) * HP);
        const float4* t = spyz + blk * (H / 4) * K4_TILE + threadIdx.x;
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 u = t[q * K4_TILE];
          net[4 * q + 0] += u.x;
          net[4 * q + 1] += u.y;
          net[4 * q + 2] += u.z;
          net[4 * q + 3] += u.w;
        }
        trunk::add_row(net, bc + (size_t)blk * F + col);
        trunk::resnet_block(net, s, blk);
      }
    }
    if (live) store_point(out, trunk::head_out(net, s), b, x, p, R, E, e);
  }
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
// -> out (B, R, R, R, E*OE); XR x-slabs per block.
extern "C" int dense_decode_feats_f32(const float* px, const float* py, const float* pz,
                                      const float* fxz, const float* fxy, const float* fyz,
                                      const float* wxz, const float* wxy, const float* wyz,
                                      const float* bc, const float* w0, const float* b0,
                                      const float* w1, const float* b1, const float* wout,
                                      const float* bout, float* out, int B, int R, int C, int E,
                                      int NB, int XR, void* stream) {
  if (XR < 1) return (int)cudaErrorInvalidValue;
  const int span = (K4_TILE - 1) / R + 2;  // y rows one tile of (y, z) points touches
  const int nymax = span < R ? span : R;
  size_t shmem = ((size_t)trunk::weight_floats(NB) + (size_t)NB * H * K4_TILE +
                  (size_t)(R + nymax) * HP) * sizeof(float);
  if (shmem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dense_decode_feats_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R * R + K4_TILE - 1) / K4_TILE, E, B * ((R + XR - 1) / XR));
  dense_decode_feats_kernel<<<grid, K4_TILE, shmem, (cudaStream_t)stream>>>(
      px, py, pz, fxz, fxy, fyz, wxz, wxy, wyz, bc, w0, b0, w1, b1, wout, bout, out,
      R, C, E, NB, XR, nymax);
  return (int)cudaGetLastError();
}
