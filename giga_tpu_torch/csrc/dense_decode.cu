// Dense-decode trunk of the GIGA affordance decoder from precomputed plane
// projections, fp32, for Hopper (sm_90a). Two entry points:
//
//   K2 dense_decode_f32: replaces giga_tpu/ops/pallas/decoder_kernel.py::
//      fused_dense_decode_batched (pallas_call at :348, body
//      _trunk_kernel_batched :161), B scenes, output (B, E*OE, R^3).
//   K3 dense_decode_single_f32: replaces decoder_kernel.py::
//      fused_dense_decode (pallas_call at :153, body _trunk_kernel :75),
//      one scene, output (R, R, R, E*OE) indexed [x, y, z, o].
//
// For every point (x, y, z) of the R^3 query lattice of scene b, and every
// head e (qual, rot, width):
//   net  = px[x] + py[y] + pz[z]                      (fc_p terms, bias in px)
//   for each block i:
//     net += pxz[b,i,x,z] + pxy[b,i,x,y] + pyz[b,i,y,z]  (fc_c terms, bias in pxz)
//     net += relu(relu(net) @ w0[i,e] + b0[i,e]) @ w1[i,e] + b1[i,e]
//   out = relu(net) @ wout[e] + bout[e]               (OE = 4 values)
// Only the OE outputs per head and point reach device memory (trunk.cuh).
//
// What bounds it: the TPU kernels run the three heads as one 96-wide trunk
// with block-diagonal weights. The off-diagonal blocks are exact zeros, so
// this kernel runs each head as its own 32-wide trunk: the same sums with a
// third of the FMAs. At the serving shape (B=64, R=40, 5 blocks) that is
// ~10.4k FMAs per point and head, ~267 GFLOP per batch, against ~590 MB of
// projections read and ~197 MB of output written: bound by fp32 CUDA-core
// arithmetic. K3 is the same work for one scene (~4.2 GFLOP, ~12 MB).
//
// Design: one thread per lattice point and head, TILE=128 consecutive
// lattice rows per block, grid (row tiles, heads, scenes). At R=40 one scene
// is 500 row tiles x 3 heads = 1,500 blocks, enough for 132 SMs. K3 writes
// its four outputs as one 16-byte store into the point-major layout.

#include "trunk.cuh"

namespace {

using trunk::H;
using trunk::OE;
constexpr int TILE = 128;

template <bool kPointMajor>
__global__ void __launch_bounds__(TILE)
dense_decode_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    const float* __restrict__ pz, const float* __restrict__ pxz,
                    const float* __restrict__ pxy, const float* __restrict__ pyz,
                    const float* __restrict__ w0, const float* __restrict__ b0,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ wout, const float* __restrict__ bout,
                    float* __restrict__ out, int R, int E, int NB) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.y, b = blockIdx.z, F = E * H;
  const trunk::Weights s = trunk::load_weights(smem, w0, b0, w1, b1, wout, bout, e, E, NB);
  __syncthreads();

  const int N = R * R * R;
  const int n = blockIdx.x * TILE + threadIdx.x;
  if (n >= N) return;
  const int x = n / (R * R), y = (n / R) % R, z = n % R;
  const int col = e * H;

  float net[H];
  trunk::set_row(net, px + (size_t)x * F + col);
  trunk::add_row(net, py + (size_t)y * F + col);
  trunk::add_row(net, pz + (size_t)z * F + col);
  for (int blk = 0; blk < NB; ++blk) {
    const size_t plane = ((size_t)b * NB + blk) * R;
    trunk::add_row(net, pxz + ((plane + x) * R + z) * F + col);
    trunk::add_row(net, pxy + ((plane + x) * R + y) * F + col);
    trunk::add_row(net, pyz + ((plane + y) * R + z) * F + col);
    trunk::resnet_block(net, s, blk);
  }
  const float4 o = trunk::head_out(net, s);
  if (kPointMajor) {
    reinterpret_cast<float4*>(out)[((size_t)b * N + n) * E + e] = o;
  } else {
    float* dst = out + ((size_t)b * E * OE + e * OE) * N + n;
    dst[0] = o.x;
    dst[N] = o.y;
    dst[2 * (size_t)N] = o.z;
    dst[3 * (size_t)N] = o.w;
  }
}

template <bool kPointMajor>
int launch(const float* px, const float* py, const float* pz, const float* pxz,
           const float* pxy, const float* pyz, const float* w0, const float* b0,
           const float* w1, const float* b1, const float* wout, const float* bout,
           float* out, int B, int R, int E, int NB, void* stream) {
  size_t shmem = (size_t)trunk::weight_floats(NB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dense_decode_kernel<kPointMajor>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R * R * R + TILE - 1) / TILE, E, B);
  dense_decode_kernel<kPointMajor><<<grid, TILE, shmem, (cudaStream_t)stream>>>(
      px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out, R, E, NB);
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

extern "C" int dense_decode_hidden() { return H; }
extern "C" int dense_decode_outputs() { return OE; }
