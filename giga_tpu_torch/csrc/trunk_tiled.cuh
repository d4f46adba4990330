// Register-tiled per-head ResnetBlockFC trunk of the GIGA affordance
// decoder, fp32: one warp carries a tile of P lattice points through one
// head's H = 32 columns (dense_decode.cu: K2, K3; dense_decode_feats.cu:
// K4, K5).
//
// Each lane holds a TP x TC micro-tile (TP points x TC columns) of the
// residual stream `net` and of the layer's accumulators. The warp's 32 lanes
// form PG point groups x CG column groups (CG = H / TC, PG = 32 / CG), so a
// tile has P = PG * TP points. A layer's input activation goes through a
// per-warp shared buffer `act`, laid out [k][S] (feature-major, S = P + 4
// floats per feature). Per k a lane loads its TP activations and its TC
// weights (16-byte loads; the warp shares each weight load) for TP * TC
// FMAs: at 8 x 8 that is 16 floats per 64 FMAs, at 4 x 8 12 per 32, against
// 32 per 32 when a thread carries a whole point. An SM moves
// 128 bytes a clock from shared memory into registers and issues 128 FMAs a
// clock, so a micro-tile under 4 FMAs per float loaded cannot keep its FMA
// lanes busy: 8 x 8 is the smallest that can.
//
// Lane l is point group l / CG and column group l % CG; a lane's columns
// are 4 * CG apart in groups of four, so the CG lanes of a point group read
// one contiguous run of each weight row and of each plane row.
//
// A product's k loop runs KU steps unrolled at a time: that bounds how far
// ptxas hoists shared loads ahead of their FMAs, and with it the registers.
//
// Only __syncwarp() separates a write of `act` from its reads: a warp's
// tile is its own, and no block-wide barrier runs inside the trunk.
//
// Sums run in the order of trunk.cuh, one fmaf per term with k ascending,
// so the outputs equal a one-point-per-thread trunk's bit for bit:
//   net = (px + py) + pz, then per block ((net + pxz) + pxy) + pyz,
//   hid = relu(net) @ w0, dx = relu(hid + b0) @ w1, net = net + (dx + b1),
//   out = relu(net) @ wout + bout;
// with b1 folded into the next block's pxz (kNoB1), net = net + dx.
// The weights sit in shared memory in trunk.cuh's layout (trunk::Weights).

#pragma once

#include "trunk.cuh"

namespace tiled {

using trunk::H;
using trunk::OE;

template <int TP, int TC, int KU = H>
struct Lane {
  static_assert(TP % 4 == 0 && TC % 4 == 0 && H % TC == 0 && 32 % (H / TC) == 0 &&
                    H % KU == 0, "16-byte point and column groups");
  static constexpr int CG = H / TC, PG = 32 / CG;
  static constexpr int P = PG * TP;          // lattice points per warp tile
  static constexpr int S = P + 4;            // floats per feature of `act`
  static constexpr int ACT_FLOATS = H * S;   // floats of one warp's `act`
  static constexpr int OUTS = (P + 31) / 32;  // head outputs per lane
  int pg, cg;  // point group and column group of this lane
  __device__ explicit Lane(int lane) : pg(lane / CG), cg(lane % CG) {}
  __device__ int point(int p) const { return pg * TP + p; }
  __device__ int column(int c) const { return (c / 4) * 4 * CG + 4 * cg + c % 4; }
};

// v[i] = src[i], i < N, by 16-byte loads (src 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* src) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 u = reinterpret_cast<const float4*>(src)[q];
    v[4 * q + 0] = u.x;
    v[4 * q + 1] = u.y;
    v[4 * q + 2] = u.z;
    v[4 * q + 3] = u.w;
  }
}

// net[p][c] = row_p[column(c)] for the lane's points (rows 16-byte aligned).
template <int TP, int TC, int KU>
__device__ __forceinline__ void set_rows(float (&net)[TP][TC], const float* const (&row)[TP],
                                         const Lane<TP, TC, KU>& ln) {
#pragma unroll
  for (int p = 0; p < TP; ++p) {
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(row[p] + ln.column(4 * q)));
      net[p][4 * q + 0] = u.x;
      net[p][4 * q + 1] = u.y;
      net[p][4 * q + 2] = u.z;
      net[p][4 * q + 3] = u.w;
    }
  }
}

// net[p][c] += row_p[column(c)].
template <int TP, int TC, int KU>
__device__ __forceinline__ void add_rows(float (&net)[TP][TC], const float* const (&row)[TP],
                                         const Lane<TP, TC, KU>& ln) {
#pragma unroll
  for (int p = 0; p < TP; ++p) {
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(row[p] + ln.column(4 * q)));
      net[p][4 * q + 0] += u.x;
      net[p][4 * q + 1] += u.y;
      net[p][4 * q + 2] += u.z;
      net[p][4 * q + 3] += u.w;
    }
  }
}

// act[column(c)][point(p)] = relu(v[p][c] + bias[column(c)]), or relu(v)
// without a bias. The caller separates this from earlier reads of `act`.
template <int TP, int TC, int KU>
__device__ __forceinline__ void store_act(float* act, const float (&v)[TP][TC],
                                          const float* bias, const Lane<TP, TC, KU>& ln) {
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    const float b = bias ? bias[ln.column(c)] : 0.f;
    float a[TP];
#pragma unroll
    for (int p = 0; p < TP; ++p) a[p] = fmaxf(bias ? v[p][c] + b : v[p][c], 0.f);
    float4* dst = reinterpret_cast<float4*>(act + ln.column(c) * ln.S + ln.point(0));
#pragma unroll
    for (int q = 0; q < TP / 4; ++q)
      dst[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
}

// acc[p][c] = sum over k ascending of act[k][point(p)] * W[k][column(c)],
// W an (H, H) matrix in shared memory, one fmaf per term from zero.
template <int TP, int TC, int KU>
__device__ __forceinline__ void product(float (&acc)[TP][TC], const float* act, const float* W,
                                        const Lane<TP, TC, KU>& ln) {
#pragma unroll
  for (int p = 0; p < TP; ++p)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[p][c] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < H; k0 += KU) {
#pragma unroll
    for (int kk = 0; kk < KU; ++kk) {
      const int k = k0 + kk;
      float a[TP], w[TC];
      load_vec(a, act + k * ln.S + ln.point(0));
#pragma unroll
      for (int q = 0; q < TC / 4; ++q) {
        const float4 u = *reinterpret_cast<const float4*>(W + k * H + ln.column(4 * q));
        w[4 * q + 0] = u.x;
        w[4 * q + 1] = u.y;
        w[4 * q + 2] = u.z;
        w[4 * q + 3] = u.w;
      }
#pragma unroll
      for (int p = 0; p < TP; ++p)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[p][c] = fmaf(a[p], w[c], acc[p][c]);
    }
  }
}

// One ResnetBlockFC on the warp's tile:
// net += relu(relu(net) @ w0 + b0) @ w1 + b1. With kNoB1 the block adds no
// b1: the caller folded it into the next block's pxz (the TPU kernel's
// fold_b1), so net += relu(relu(net) @ w0 + b0) @ w1. The caller picks the
// instance per block: a runtime flag here instead made K2's fold instance
// spill 40 more bytes and take 0.3 ms longer at B=64 (NVIDIA H100 80GB
// HBM3, 700 W; ab_dense_decode --options, PERF.md §6).
template <bool kNoB1 = false, int TP, int TC, int KU>
__device__ __forceinline__ void resnet_block(float (&net)[TP][TC], float* act,
                                             const trunk::Weights& s, int blk,
                                             const Lane<TP, TC, KU>& ln) {
  float acc[TP][TC];
  __syncwarp();
  store_act(act, net, nullptr, ln);
  __syncwarp();
  product(acc, act, s.w0 + blk * H * H, ln);
  __syncwarp();
  store_act(act, acc, s.b0 + blk * H, ln);
  __syncwarp();
  product(acc, act, s.w1 + blk * H * H, ln);
  if (kNoB1) {
#pragma unroll
    for (int p = 0; p < TP; ++p)
#pragma unroll
      for (int c = 0; c < TC; ++c) net[p][c] = net[p][c] + acc[p][c];
    return;
  }
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    const float b = s.b1[blk * H + ln.column(c)];
#pragma unroll
    for (int p = 0; p < TP; ++p) net[p][c] = net[p][c] + (acc[p][c] + b);
  }
}

// The head's OE outputs for tile points lane + 32 i, i < OUTS (points past
// P repeat point P - 1; the caller drops them): relu(net) @ wout + bout.
template <int TP, int TC, int KU>
__device__ __forceinline__ void head_out(float4 (&out)[Lane<TP, TC, KU>::OUTS],
                                         const float (&net)[TP][TC], float* act,
                                         const trunk::Weights& s, const Lane<TP, TC, KU>& ln,
                                         int lane) {
  static_assert(OE == 4, "head_out gives one float4 per point");
  __syncwarp();
  store_act(act, net, nullptr, ln);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < Lane<TP, TC, KU>::OUTS; ++i) {
    const int p = min(lane + 32 * i, Lane<TP, TC, KU>::P - 1);
    float o[OE] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float v = act[k * ln.S + p];
#pragma unroll
      for (int j = 0; j < OE; ++j) o[j] = fmaf(v, s.wo[k * OE + j], o[j]);
    }
    out[i] = make_float4(o[0] + s.bo[0], o[1] + s.bo[1], o[2] + s.bo[2], o[3] + s.bo[3]);
  }
}

}  // namespace tiled
