// Dense-decode trunk of the GIGA affordance decoder, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel giga_tpu/ops/pallas/decoder_kernel.py::
// fused_dense_decode_batched (pallas_call at :348, body
// _trunk_kernel_batched :161). For every point (x, y, z) of the R^3 query
// lattice of every scene b, and every head e (qual, rot, width):
//   net  = px[x] + py[y] + pz[z]                      (fc_p terms, bias in px)
//   for each block i:
//     net += pxz[b,i,x,z] + pxy[b,i,x,y] + pyz[b,i,y,z]  (fc_c terms, bias in pxz)
//     hid  = relu(net) @ w0[i,e] + b0[i,e]
//     net += relu(hid) @ w1[i,e] + b1[i,e]
//   out[b, e*OE + o, (x*R + y)*R + z] = (relu(net) @ wout[e] + bout[e])[o]
// Only the OE=4 outputs per head and point reach device memory; the
// residual stream and hidden activations stay in registers.
//
// What bounds it: the TPU kernel runs the three heads as one 96-wide trunk
// with block-diagonal weights. The off-diagonal blocks are exact zeros, so
// this kernel runs each head as its own 32-wide trunk: the same sums with a
// third of the FMAs. At the serving shape (B=64, R=40, 5 blocks) that is
// ~10.4k FMAs per point and head, ~255 GFLOP per batch, against ~590 MB of
// projections read and ~197 MB of output written: bound by fp32 CUDA-core
// arithmetic.
//
// Design: one thread per lattice point and head, TILE=128 consecutive
// lattice rows per block, grid (row tiles, heads, scenes). A block copies
// its head's trunk weights (~43 KB) into shared memory once; every thread
// of a warp reads the same weight address, so the loads are broadcasts, and
// each 16-byte load feeds four FMAs. No tensor cores: fp32 parity with the
// reference is the contract, and TF32 would break it.

#include <cuda_runtime.h>

namespace {

constexpr int H = 32;    // hidden width per head
constexpr int OE = 4;    // outputs per head
constexpr int TILE = 128;

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
  float* sw0 = smem;                  // (NB, H, H)
  float* sw1 = sw0 + NB * H * H;      // (NB, H, H)
  float* sb0 = sw1 + NB * H * H;      // (NB, H)
  float* sb1 = sb0 + NB * H;          // (NB, H)
  float* swo = sb1 + NB * H;          // (H, OE)
  float* sbo = swo + H * OE;          // (OE)

  for (int i = threadIdx.x; i < NB * H * H; i += TILE) {
    int blk = i / (H * H), r = i % (H * H);
    sw0[i] = w0[((size_t)blk * E + e) * H * H + r];
    sw1[i] = w1[((size_t)blk * E + e) * H * H + r];
  }
  for (int i = threadIdx.x; i < NB * H; i += TILE) {
    int blk = i / H, r = i % H;
    sb0[i] = b0[((size_t)blk * E + e) * H + r];
    sb1[i] = b1[((size_t)blk * E + e) * H + r];
  }
  for (int i = threadIdx.x; i < H * OE; i += TILE) swo[i] = wout[(size_t)e * H * OE + i];
  if (threadIdx.x < OE) sbo[threadIdx.x] = bout[e * OE + threadIdx.x];
  __syncthreads();

  const int N = R * R * R;
  const int n = blockIdx.x * TILE + threadIdx.x;
  if (n >= N) return;
  const int x = n / (R * R), y = (n / R) % R, z = n % R;
  const int col = e * H;

  float net[H];
  {
    const float4* ax = reinterpret_cast<const float4*>(px + (size_t)x * F + col);
    const float4* ay = reinterpret_cast<const float4*>(py + (size_t)y * F + col);
    const float4* az = reinterpret_cast<const float4*>(pz + (size_t)z * F + col);
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      float4 a = ax[q], c = ay[q], d = az[q];
      net[4 * q + 0] = (a.x + c.x) + d.x;
      net[4 * q + 1] = (a.y + c.y) + d.y;
      net[4 * q + 2] = (a.z + c.z) + d.z;
      net[4 * q + 3] = (a.w + c.w) + d.w;
    }
  }

  for (int blk = 0; blk < NB; ++blk) {
    const size_t plane = ((size_t)b * NB + blk) * R;
    const float4* a = reinterpret_cast<const float4*>(pxz + ((plane + x) * R + z) * F + col);
    const float4* c = reinterpret_cast<const float4*>(pxy + ((plane + x) * R + y) * F + col);
    const float4* d = reinterpret_cast<const float4*>(pyz + ((plane + y) * R + z) * F + col);
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      float4 u = a[q], v = c[q], t = d[q];
      net[4 * q + 0] = ((net[4 * q + 0] + u.x) + v.x) + t.x;
      net[4 * q + 1] = ((net[4 * q + 1] + u.y) + v.y) + t.y;
      net[4 * q + 2] = ((net[4 * q + 2] + u.z) + v.z) + t.z;
      net[4 * q + 3] = ((net[4 * q + 3] + u.w) + v.w) + t.w;
    }

    float hid[H];
#pragma unroll
    for (int j = 0; j < H; ++j) hid[j] = 0.f;
    const float4* W0 = reinterpret_cast<const float4*>(sw0 + blk * H * H);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      float v = fmaxf(net[k], 0.f);
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        float4 w = W0[k * (H / 4) + q];
        hid[4 * q + 0] = fmaf(v, w.x, hid[4 * q + 0]);
        hid[4 * q + 1] = fmaf(v, w.y, hid[4 * q + 1]);
        hid[4 * q + 2] = fmaf(v, w.z, hid[4 * q + 2]);
        hid[4 * q + 3] = fmaf(v, w.w, hid[4 * q + 3]);
      }
    }
    float dx[H];
#pragma unroll
    for (int j = 0; j < H; ++j) dx[j] = 0.f;
    const float4* W1 = reinterpret_cast<const float4*>(sw1 + blk * H * H);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      float v = fmaxf(hid[k] + sb0[blk * H + k], 0.f);
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        float4 w = W1[k * (H / 4) + q];
        dx[4 * q + 0] = fmaf(v, w.x, dx[4 * q + 0]);
        dx[4 * q + 1] = fmaf(v, w.y, dx[4 * q + 1]);
        dx[4 * q + 2] = fmaf(v, w.z, dx[4 * q + 2]);
        dx[4 * q + 3] = fmaf(v, w.w, dx[4 * q + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < H; ++j) net[j] = net[j] + (dx[j] + sb1[blk * H + j]);
  }

  float o[OE];
#pragma unroll
  for (int j = 0; j < OE; ++j) o[j] = 0.f;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    float v = fmaxf(net[k], 0.f);
#pragma unroll
    for (int j = 0; j < OE; ++j) o[j] = fmaf(v, swo[k * OE + j], o[j]);
  }
#pragma unroll
  for (int j = 0; j < OE; ++j)
    out[((size_t)b * E * OE + e * OE + j) * N + n] = o[j] + sbo[j];
}

}  // namespace

extern "C" int dense_decode_f32(const float* px, const float* py, const float* pz,
                                const float* pxz, const float* pxy, const float* pyz,
                                const float* w0, const float* b0, const float* w1,
                                const float* b1, const float* wout, const float* bout,
                                float* out, int B, int R, int E, int NB, void* stream) {
  size_t shmem = (size_t)(NB * (2 * H * H + 2 * H) + H * OE + OE) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dense_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R * R * R + TILE - 1) / TILE, E, B);
  dense_decode_kernel<<<grid, TILE, shmem, (cudaStream_t)stream>>>(
      px, py, pz, pxz, pxy, pyz, w0, b0, w1, b1, wout, bout, out, R, E, NB);
  return (int)cudaGetLastError();
}

extern "C" int dense_decode_hidden() { return H; }
extern "C" int dense_decode_outputs() { return OE; }
