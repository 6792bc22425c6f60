// Shared by the hidden-128 gated-FFN kernels for Hopper (fused_ffn128.cu,
// fused_ffn128_bwd.cu): the widths, the packed weight image both read, and
// the row work on a warp's m16n8 fragments (wgmma_common.cuh) with the
// roundings of ffn_common.cuh.
//
// The image (global, written once a call by pack_image): six slices of 64
// middle columns, slice c = [W1 rows 64c..64c+63 | W2 rows 64c.. | W3
// columns 64c..64c+63], 48 KB of bf16 in the 128-byte swizzled layout
// (SW128) that TMA writes and wgmma reads:
//   * W1 and W2 rows as [64 rows][128 cols], two [64][64] blocks of 8 KB:
//     K-major for n·W1ᵀ (the forward's and the backward's a1), MN-major
//     for ga1·W1 (the backward's g_h);
//   * W3 columns as [128 rows][64 cols], one block of 16 KB: K-major for
//     y += g·W3ᵀ (forward), MN-major for g_mid = g·W3 (backward);
// then the vectors b1, b2 [384], b3, scale2, scale [128] as bf16.
#pragma once

#include "ffn_common.cuh"
#include "wgmma_common.cuh"

namespace ffnw {

using ffn::bf2;
using bf16 = __nv_bfloat16;

constexpr int H = 128;      // hidden width
constexpr int W = 3 * H;    // middle width
constexpr int C = 64;       // middle columns of a slice
constexpr int NS = W / C;   // slices
constexpr int BLK = 64 * 128;           // a [64 rows][64 cols] SW128 block, bytes
constexpr int SL_W1 = 0, SL_W2 = 2 * BLK, SL_W3 = 4 * BLK, SLICE = 6 * BLK;
// the vectors (bf16 elements from the end of the slices)
constexpr int V_B1 = 0, V_B2 = W, V_B3 = 2 * W, V_S2 = V_B3 + H, V_S = V_S2 + H, V_N = V_S + H;
constexpr int VEC_BYTES = 2 * V_N;
constexpr int IMAGE_BYTES = NS * SLICE + VEC_BYTES;

__device__ __forceinline__ uint32_t bits(bf2 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ bf2 pair(uint32_t u) { return *reinterpret_cast<bf2*>(&u); }

// The image from the fp32 parameters (nn.Linear layout, [out, in]); b3 may
// be null (the backward's, which reads no b3). A grid-stride loop over the
// parameters' elements, each thread writing the bf16 of the ones it reads.
__device__ inline void pack_image(unsigned char* img, const float* w1, const float* b1,
                                  const float* w2, const float* b2, const float* w3,
                                  const float* b3, const float* scale2, const float* scale) {
  const int n = 3 * W * H + V_N;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    float v;
    int at;
    if (e < 2 * W * H) {  // W1, W2 [W][H]
      const int which = e / (W * H), r = e % (W * H), j = r / H, k = r % H;
      v = (which ? w2 : w1)[r];
      at = (j / C) * SLICE + which * 2 * BLK + (k / 64) * BLK + wg::sw128(j % C, k % 64);
    } else if (e < 3 * W * H) {  // W3 [H][W]
      const int r = e - 2 * W * H, o = r / W, j = r % W;
      v = w3[r];
      at = (j / C) * SLICE + SL_W3 + wg::sw128(o, j % C);
    } else {
      const int i = e - 3 * W * H;
      v = i < V_B2   ? b1[i]
          : i < V_B3 ? b2[i - V_B2]
          : i < V_S2 ? (b3 ? b3[i - V_B3] : 0.f)
          : i < V_S  ? scale2[i - V_S2]
                     : scale[i - V_S];
      at = NS * SLICE + 2 * i;
    }
    *reinterpret_cast<bf16*>(img + at) = __float2bfloat16_rn(v);
  }
}

constexpr int PACK_BLOCKS = (3 * W * H + V_N + 255) / 256;

// wg::bar_wait, also with acquire at cluster scope (CLUSTER: a barrier that
// the cluster arrives on remotely); a wait of more than 10 s (a fault in
// the hand-offs) traps, so that the launch fails with an error instead of
// holding the card
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

template <bool CLUSTER>
__device__ __forceinline__ void bwait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = wg::smem_u32(b);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    if constexpr (CLUSTER)
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 10000000000ull) {
      __trap();
    }
  }
}

// _rms_fwd of the two rows a lane holds in a warp's 16 x 128 fragments
// (f[2n + half]: row lane/4 + 8·half, columns 8n + 2(lane%4) + {0, 1}), in
// place: inv = 1/(sqrt(sum + 1e-24)/sqrt(H) + 1e-8) from the fp32 sum of
// the bf16 squares over the quad, then f = bf16(bf16(f · bf16(inv)) · scale)
// (scale: the bf16 pairs of the vector, by column / 2)
__device__ __forceinline__ void rms_rows(uint32_t (&f)[32], const bf2* scale, float (&inv)[2]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float g4[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, added in a fixed order
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const bf2 v = pair(f[2 * n + half]);
      const float2 sq = __bfloat1622float2(__hmul2_rn(v, v));
      g4[n & 3] += sq.x;
      g4[n & 3] += sq.y;
    }
    const float gs = tc::quad_sum((g4[0] + g4[1]) + (g4[2] + g4[3]));
    const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
    inv[half] = 1.0f / (rms + 1e-8f);
    const bf2 ib = __float2bfloat162_rn(inv[half]);
#pragma unroll
    for (int n = 0; n < 16; ++n)
      f[2 * n + half] = bits(ffn::mul3(pair(f[2 * n + half]), ib, scale[4 * n + q]));
  }
}

// The gate's activation of 16 bf16 pairs h (SILU: SiLU, else the exact
// GELU), and with GRAD its derivative, each value rounded once to bf16
// (ffn_common.cuh): one straight run of 32 independent chains, which the
// scheduler interleaves (a branch on the activation inside would cut it
// into 32 blocks run one after another)
template <bool SILU, bool GRAD>
__device__ __forceinline__ void act_run(const uint32_t (&h)[16], uint32_t (&act)[16],
                                        uint32_t (&d)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float2 v = __bfloat1622float2(pair(h[k]));
    float a0, a1, d0, d1;
    ffn::act_and_grad(v.x, SILU, a0, d0);
    ffn::act_and_grad(v.y, SILU, a1, d1);
    act[k] = bits(__floats2bfloat162_rn(a0, a1));
    if (GRAD) d[k] = bits(__floats2bfloat162_rn(d0, d1));
  }
}

template <bool GRAD>
__device__ __forceinline__ void act_pairs(const uint32_t (&h)[16], uint32_t (&act)[16],
                                          uint32_t (&d)[16], int silu) {
  if (silu)
    act_run<true, GRAD>(h, act, d);
  else
    act_run<false, GRAD>(h, act, d);
}

// bf16(bf16(acc) + bias) of an m64n64 accumulator's 16 pairs (columns
// 8n + 2(lane%4), bias: its pairs from column c0)
__device__ __forceinline__ void bias_pairs(uint32_t (&h)[16], const float (&acc)[8][4],
                                           const bf2* bias, int c0) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = 2 * half;
      const bf2 v = __floats2bfloat162_rn(acc[n][e], acc[n][e + 1]);
      h[2 * n + half] = bits(bias ? __hadd2_rn(v, bias[(c0 + 8 * n + 2 * (threadIdx.x & 3)) / 2])
                                  : v);
    }
}

}  // namespace ffnw
