// Per-head ResnetBlockFC trunk of the GIGA affordance decoder, fp32: the
// device code shared by the dense-decode kernels (dense_decode.cu: K2, K3;
// dense_decode_feats.cu: K4, K5).
//
// One thread carries one lattice point of one head: its H-wide residual
// stream `net` and the hidden activations stay in registers. The head's
// trunk weights (~43 KB at 5 blocks) sit in shared memory; every thread of
// a warp reads the same weight address, so the loads are broadcasts and
// each 16-byte load feeds four FMAs. No tensor cores: fp32 parity with the
// reference is the contract, and TF32 would break it.
//
// Sums run in the reference's order, one rounding per add:
//   net  = (px + py) + pz, then per block the plane terms one at a time,
//   hid  = relu(net) @ w0 + b0, dx = relu(hid) @ w1 + b1, net = net + dx,
//   out  = relu(net) @ wout + bout.

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

// net = row (H floats, 16-byte aligned)
__device__ __forceinline__ void set_row(float (&net)[H], const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    float4 u = r[q];
    net[4 * q + 0] = u.x;
    net[4 * q + 1] = u.y;
    net[4 * q + 2] = u.z;
    net[4 * q + 3] = u.w;
  }
}

// net += row (H floats, 16-byte aligned)
__device__ __forceinline__ void add_row(float (&net)[H], const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    float4 u = r[q];
    net[4 * q + 0] += u.x;
    net[4 * q + 1] += u.y;
    net[4 * q + 2] += u.z;
    net[4 * q + 3] += u.w;
  }
}

// One ResnetBlockFC on the residual stream: net += relu(relu(net) @ w0 + b0) @ w1 + b1.
__device__ __forceinline__ void resnet_block(float (&net)[H], const Weights& s, int blk) {
  float hid[H];
#pragma unroll
  for (int j = 0; j < H; ++j) hid[j] = 0.f;
  const float4* W0 = reinterpret_cast<const float4*>(s.w0 + blk * H * H);
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
  const float4* W1 = reinterpret_cast<const float4*>(s.w1 + blk * H * H);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    float v = fmaxf(hid[k] + s.b0[blk * H + k], 0.f);
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
  for (int j = 0; j < H; ++j) net[j] = net[j] + (dx[j] + s.b1[blk * H + j]);
}

// The head's OE outputs: relu(net) @ wout + bout.
__device__ __forceinline__ float4 head_out(const float (&net)[H], const Weights& s) {
  float o[OE];
#pragma unroll
  for (int j = 0; j < OE; ++j) o[j] = 0.f;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    float v = fmaxf(net[k], 0.f);
#pragma unroll
    for (int j = 0; j < OE; ++j) o[j] = fmaf(v, s.wo[k * OE + j], o[j]);
  }
  static_assert(OE == 4, "head_out returns one float4");
  return make_float4(o[0] + s.bo[0], o[1] + s.bo[1], o[2] + s.bo[2], o[3] + s.bo[3]);
}

}  // namespace trunk
