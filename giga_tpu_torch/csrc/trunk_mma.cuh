// Tensor-core per-head ResnetBlockFC trunk of the GIGA affordance decoder in
// the TPU kernels' bf16 mode (dense_decode.cu: K2 and K3 bf16;
// dense_decode_feats.cu: K4 and K5 bf16): the operands of every product are
// bf16, the sums float32; the plane-row assembly, the biases and the
// residual stream stay float32. Rows and weights come in bf16 (K2, K3) or
// float32 (K4, K5, whose inputs the TPU kernels take in float32): float32
// rows are added as they are, float32 weights rounded to bf16 once, as they
// are copied to shared memory, and float32 biases kept. K4 and K5 also run
// their plane projections through `product`, from A fragments that
// ldmatrix reads out of bf16 feature rows (rows_tma.cuh).
//
// One warp carries a tile of P = 16 * MT lattice points through one head's
// H = 32 columns with mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
// a product (P, 32) @ (32, 32) is MT x 4 n-tiles x 2 k-steps = 16 MMAs at
// MT = 2. Each lane holds the tile in the MMA accumulator layout
// (Tile::v[m][n][r]: point 16 m + g + 8 (r / 2), column 8 n + 2 t + r % 2,
// g = lane / 4, t = lane % 4), and that layout is also the A operand's: the
// accumulators of n-tiles 2 s and 2 s + 1 are, rounded to bf16 in pairs, the
// A fragment of k-step s. So a layer's output feeds the next product from
// registers, with no activation buffer, no shared-memory round trip and no
// __syncwarp; ReLU and the rounding are one cvt.rn.relu.bf16x2 per pair. The weights sit in shared memory as bf16 in B-fragment order,
// each lane's two registers of a (k-step, n-tile) one 8-byte load, the
// warp's 32 loads 256 contiguous bytes.
//
// Sums: the products of bf16 values are exact in float32; the tensor core
// adds them in its own order, so outputs agree with a float32 sum of the
// same products to float32 rounding, not bit for bit.
//
// K2 bf16 takes two of the TPU kernel's options as template flags of
// resnet_block: kFoldB1 (b1 folded into the next block's pxz) and
// kResident (the residual stream rounded to bf16 after every add). Its
// third, hidden_bf16, rounds the hidden stream to bf16 before its ReLU,
// where this trunk rounds relu(hidden): ReLU commutes with rounding, so
// that is this trunk's function as it stands.

#pragma once

#include <cuda_bf16.h>

#include "trunk.cuh"

namespace tc {

using trunk::H;
using trunk::OE;

constexpr int NT = H / 8;   // n-tiles of 8 columns across a head
constexpr int KS = H / 16;  // k-steps of 16 in a product
constexpr int FRAG_WORDS = KS * NT * 32 * 2;  // 32-bit words of one (H, H) matrix's fragments
constexpr int HEAD_WORDS = KS * 32 * 2;       // the head's (H, OE) matrix, padded to 8 columns
static_assert(H % 16 == 0 && OE <= 8, "whole k-steps; one n-tile of head outputs");

// 32-bit words of one head's trunk weights in shared memory at NB blocks:
// the fragments of w0 and w1 per block and of wout, then the float biases
// b0 and b1 per block and bout.
__host__ __device__ inline int weight_words(int NB) {
  return NB * 2 * FRAG_WORDS + HEAD_WORDS + NB * 2 * H + OE;
}

struct Weights {
  const uint2* w0;  // (NB) x fragments
  const uint2* w1;
  const uint2* wo;
  const float* b0;  // (NB, H)
  const float* b1;  // (NB, H)
  const float* bo;  // (OE)
};

// bf16x2 of relu(lo), relu(hi), rounded to nearest, in one conversion (ReLU
// commutes with rounding, so this is relu then round).
__device__ __forceinline__ unsigned pack_relu(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ unsigned pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const unsigned*>(&v);
}

// A weight as a product operand (bf16, rounded to nearest from float32) and
// as a bias (float32).
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// Two consecutive row values (8-byte aligned for float32, 4 for bf16) as
// float32, read through the read-only cache.
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Word w of the B fragments of a (K = H, N = cols) matrix W (row-major,
// rows ld apart; columns past cols are zero), n-tiles per k-step nt: lane l's
// register r of (k-step s, n-tile n) holds W[16 s + 8 r + 2 t + {0, 1}][8 n + g].
template <typename T>
__device__ __forceinline__ unsigned fragment_word(const T* __restrict__ W, int cols, int nt,
                                                  int w, int ld) {
  const int r = w % 2, lane = (w / 2) % 32, j = w / 64;
  const int s = j / nt, n = 8 * (j % nt) + lane / 4;
  const int k = 16 * s + 8 * r + 2 * (lane % 4);
  if (n >= cols) return 0u;
  return pack(to_bf16(W[k * ld + n]), to_bf16(W[(k + 1) * ld + n]));
}

// Copy head e's weights from the per-head stacks (T bf16 or float32)
// w0/w1 (NB, E, H, H), b0/b1 (NB, E, H), wout (E, H, OE), bout (E, OE) into
// `smem` (16-byte aligned). Every thread of the block calls it; the caller
// synchronises before reading.
template <typename T>
__device__ inline Weights load_weights(unsigned* smem, const T* __restrict__ w0,
                                       const T* __restrict__ b0, const T* __restrict__ w1,
                                       const T* __restrict__ b1, const T* __restrict__ wout,
                                       const T* __restrict__ bout, int e, int E, int NB) {
  unsigned* f0 = smem;
  unsigned* f1 = f0 + NB * FRAG_WORDS;
  unsigned* fo = f1 + NB * FRAG_WORDS;
  float* sb0 = reinterpret_cast<float*>(fo + HEAD_WORDS);
  float* sb1 = sb0 + NB * H;
  float* sbo = sb1 + NB * H;
  for (int i = threadIdx.x; i < NB * FRAG_WORDS; i += blockDim.x) {
    const int blk = i / FRAG_WORDS, w = i % FRAG_WORDS;
    const size_t m = ((size_t)blk * E + e) * H * H;
    f0[i] = fragment_word(w0 + m, H, NT, w, H);
    f1[i] = fragment_word(w1 + m, H, NT, w, H);
  }
  for (int i = threadIdx.x; i < HEAD_WORDS; i += blockDim.x)
    fo[i] = fragment_word(wout + (size_t)e * H * OE, OE, 1, i, OE);
  for (int i = threadIdx.x; i < NB * H; i += blockDim.x) {
    const int blk = i / H, r = i % H;
    sb0[i] = to_float(b0[((size_t)blk * E + e) * H + r]);
    sb1[i] = to_float(b1[((size_t)blk * E + e) * H + r]);
  }
  if (threadIdx.x < OE) sbo[threadIdx.x] = to_float(bout[e * OE + threadIdx.x]);
  return {reinterpret_cast<const uint2*>(f0), reinterpret_cast<const uint2*>(f1),
          reinterpret_cast<const uint2*>(fo), sb0, sb1, sbo};
}

// d = a @ b + d on one m16n8k16 tile (bf16 operands, float32 accumulators).
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

template <int MT>
struct Tile {
  static constexpr int P = 16 * MT;  // lattice points of a warp tile
  float v[MT][NT][4];
};

// Point (0 .. P-1) of the tile that register pair (m, h) of lane `lane` holds.
__device__ __forceinline__ int point(int m, int h, int lane) { return 16 * m + 8 * h + lane / 4; }

// net[m][n][2h + {0, 1}] (+)= row_{m,h}[8 n + 2 t + {0, 1}], where row_{m,h}
// = plane + idx[m][h] * F: a lane's two columns of each n-tile, one load
// each, of 4 bytes (bf16 rows) or 8 (float32 rows); plane and F keep every
// row aligned to it. Rows are addressed from their index, not held as
// pointers: a pointer costs two registers.
template <bool kSet, int MT, typename T>
__device__ __forceinline__ void rows(Tile<MT>& net, const T* __restrict__ plane,
                                     const int (&idx)[MT][2], int F, int lane) {
  const T* lane_plane = plane + 2 * (lane % 4);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const T* row = lane_plane + (size_t)idx[m][h] * F;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 u = load_pair(row + 8 * n);
        if (kSet) {
          net.v[m][n][2 * h] = u.x;
          net.v[m][n][2 * h + 1] = u.y;
        } else {
          net.v[m][n][2 * h] += u.x;
          net.v[m][n][2 * h + 1] += u.y;
        }
      }
    }
}

// net[m][n][2h + {0, 1}] += col[8 n + 2 t + {0, 1}] for every point of the
// tile: one float32 row the tile shares (a bias; 8-byte aligned).
template <int MT>
__device__ __forceinline__ void add_columns(Tile<MT>& net, const float* col, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 c = *reinterpret_cast<const float2*>(col + 8 * n + 2 * t);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      net.v[m][n][0] += c.x;
      net.v[m][n][1] += c.y;
      net.v[m][n][2] += c.x;
      net.v[m][n][3] += c.y;
    }
  }
}

// a[m][s] = the A fragments of bf16(relu(v + bias)) with kBias, else of
// bf16(relu(v)); bias indexed by column.
template <bool kBias, int MT>
__device__ __forceinline__ void operand(unsigned (&a)[MT][KS][4], const Tile<MT>& x,
                                        const float* bias, int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 2 * s + half;
      const float c0 = kBias ? bias[8 * n + 2 * t] : 0.f;
      const float c1 = kBias ? bias[8 * n + 2 * t + 1] : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* v = x.v[m][n];
        if (kBias) {
          a[m][s][2 * half] = pack_relu(v[0] + c0, v[1] + c1);
          a[m][s][2 * half + 1] = pack_relu(v[2] + c0, v[3] + c1);
        } else {
          a[m][s][2 * half] = pack_relu(v[0], v[1]);
          a[m][s][2 * half + 1] = pack_relu(v[2], v[3]);
        }
      }
    }
}

// acc = A @ W from zero, W's fragments in shared memory.
template <int MT>
__device__ __forceinline__ void product(Tile<MT>& acc, const unsigned (&a)[MT][KS][4],
                                        const uint2* W, int lane) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.v[m][n][r] = 0.f;
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint2 b = W[(s * NT + n) * 32 + lane];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma(acc.v[m][n], a[m][s], b);
    }
}

// lo, hi rounded to bf16 (to nearest) and widened back, in one conversion.
__device__ __forceinline__ void round_pair(float& lo, float& hi) {
  const float2 r = __bfloat1622float2(__floats2bfloat162_rn(lo, hi));
  lo = r.x;
  hi = r.y;
}

// Every value of the tile rounded to bf16 and widened back: the residual
// stream of the resident mode, held as bf16 values in float32 registers.
template <int MT>
__device__ __forceinline__ void round_tile(Tile<MT>& x) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      round_pair(x.v[m][n][0], x.v[m][n][1]);
      round_pair(x.v[m][n][2], x.v[m][n][3]);
    }
}

// One ResnetBlockFC on the warp's tile:
// net += relu(bf16(relu(net)) @ w0 + b0) rounded to bf16 @ w1 + b1.
// Options, the TPU kernel's: kFoldB1 drops the b1 add of every block but
// the `last` (the caller folded b1 into the next block's pxz); kResident
// keeps the residual stream in bf16, net = bf16(net + bf16(dx)), the caller
// rounding it after each of its own adds (its relu(net) operand is then
// exact).
template <bool kFoldB1 = false, bool kResident = false, int MT>
__device__ __forceinline__ void resnet_block(Tile<MT>& net, const Weights& s, int blk,
                                             int lane, bool last = true) {
  unsigned a[MT][KS][4];
  Tile<MT> acc;
  operand<false>(a, net, nullptr, lane);
  product(acc, a, s.w0 + blk * (FRAG_WORDS / 2), lane);
  operand<true>(a, acc, s.b0 + blk * H, lane);
  product(acc, a, s.w1 + blk * (FRAG_WORDS / 2), lane);
  if constexpr (kFoldB1 || kResident) {
    // dx = acc (+ b1), rounded with kResident; then net + dx, rounded
    if (!kFoldB1 || last) add_columns(acc, s.b1 + blk * H, lane);
    if (kResident) round_tile(acc);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) net.v[m][n][r] = net.v[m][n][r] + acc.v[m][n][r];
    if (kResident) round_tile(net);
  } else {
    // the default mode's same sums, kept in the form it was tuned in: with
    // the b1 add moved into acc as above, ptxas spilled 24/40 bytes here
    // and K2 bf16 slowed by ~2 % (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6)
    const int t = lane % 4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float c0 = s.b1[blk * H + 8 * n + 2 * t], c1 = s.b1[blk * H + 8 * n + 2 * t + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        net.v[m][n][0] = net.v[m][n][0] + (acc.v[m][n][0] + c0);
        net.v[m][n][1] = net.v[m][n][1] + (acc.v[m][n][1] + c1);
        net.v[m][n][2] = net.v[m][n][2] + (acc.v[m][n][2] + c0);
        net.v[m][n][3] = net.v[m][n][3] + (acc.v[m][n][3] + c1);
      }
    }
  }
}

// The head: o[m][r] = (bf16(relu(net)) @ wout + bout) for point
// 16 m + g + 8 (r / 2) and output 2 t + r % 2; lanes with t >= OE / 2 hold
// padding columns, which the caller drops.
template <int MT>
__device__ __forceinline__ void head_out(float (&o)[MT][4], const Tile<MT>& net,
                                         const Weights& s, int lane) {
  unsigned a[MT][KS][4];
  operand<false>(a, net, nullptr, lane);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[m][r] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint2 b = s.wo[ks * 32 + lane];
#pragma unroll
    for (int m = 0; m < MT; ++m) mma(o[m], a[m][ks], b);
  }
  const int c = 2 * (lane % 4);
  const float c0 = c < OE ? s.bo[c] : 0.f, c1 = c + 1 < OE ? s.bo[c + 1] : 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    o[m][0] += c0;
    o[m][1] += c1;
    o[m][2] += c0;
    o[m][3] += c1;
  }
}

}  // namespace tc
