// Per-head ResnetBlockFC trunk of the GIGA affordance decoder: the widths
// and the float32 weight layout shared by the dense-decode kernels' trunks
// (trunk_tiled.cuh: K2-K5 in float32; trunk_mma.cuh: their bf16 modes).
//
// The trunk of one lattice point and head, in the order every float32
// kernel sums it, one rounding per add:
//   net  = (px + py) + pz, then per block the plane terms one at a time,
//   hid  = relu(net) @ w0 + b0, dx = relu(hid) @ w1 + b1, net = net + dx,
//   out  = relu(net) @ wout + bout.
// A head's trunk weights (~43 KB at 5 blocks) sit in shared memory as
// load_weights lays them out.

#pragma once

#include <cuda_runtime.h>

namespace trunk {

constexpr int H = 32;   // hidden width per head
constexpr int OE = 4;   // outputs per head

// Floats of one head's trunk weights in shared memory; a multiple of four,
// so what a kernel places after them stays 16-byte aligned.
__host__ __device__ inline int weight_floats(int NB) {
  return NB * (2 * H * H + 2 * H) + H * OE + OE;
}

struct Weights {
  const float* w0;  // (NB, H, H)
  const float* w1;  // (NB, H, H)
  const float* b0;  // (NB, H)
  const float* b1;  // (NB, H)
  const float* wo;  // (H, OE)
  const float* bo;  // (OE)
};

// Copy head e's weights from the per-head stacks w0/w1 (NB, E, H, H),
// b0/b1 (NB, E, H), wout (E, H, OE), bout (E, OE) into `smem`. Every thread
// of the block calls it; the caller synchronises before reading.
__device__ inline Weights load_weights(float* smem, const float* __restrict__ w0,
                                       const float* __restrict__ b0,
                                       const float* __restrict__ w1,
                                       const float* __restrict__ b1,
                                       const float* __restrict__ wout,
                                       const float* __restrict__ bout, int e, int E, int NB) {
  float* sw0 = smem;
  float* sw1 = sw0 + NB * H * H;
  float* sb0 = sw1 + NB * H * H;
  float* sb1 = sb0 + NB * H;
  float* swo = sb1 + NB * H;
  float* sbo = swo + H * OE;
  for (int i = threadIdx.x; i < NB * H * H; i += blockDim.x) {
    int blk = i / (H * H), r = i % (H * H);
    sw0[i] = w0[((size_t)blk * E + e) * H * H + r];
    sw1[i] = w1[((size_t)blk * E + e) * H * H + r];
  }
  for (int i = threadIdx.x; i < NB * H; i += blockDim.x) {
    int blk = i / H, r = i % H;
    sb0[i] = b0[((size_t)blk * E + e) * H + r];
    sb1[i] = b1[((size_t)blk * E + e) * H + r];
  }
  for (int i = threadIdx.x; i < H * OE; i += blockDim.x) swo[i] = wout[(size_t)e * H * OE + i];
  if (threadIdx.x < OE) sbo[threadIdx.x] = bout[e * OE + threadIdx.x];
  return {sw0, sw1, sb0, sb1, swo, sbo};
}

}  // namespace trunk
