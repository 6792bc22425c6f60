// Helpers shared by the gated-FFN kernels at hidden 32 and below
// (fused_ffn_small.cu, fused_ffn_small_bwd.cu), each source compiled once
// a width with -DFFN_SMALL_H=H, H one of 1, 2, 4, 8, 16, 32: the widths,
// their padding to the tensor-core tiles, a thread's row, and the RMS norm
// and its backward on that row.
//
// mma.sync.m16n8k16 takes K in steps of 16 and N in steps of 8. Below
// hidden 16 neither H nor the middle width W = 3H (24, 12, 6, 3) fits, and
// W = 48 at H = 16 is the only middle that does at 16 or below. So the
// products run on zero-padded tiles: H padded to HK = max(H, 16), W to
// WK = W rounded up to 16, the padding zero in the weights, the biases
// and the rows in shared memory. A zero product adds exactly 0 to an fp32
// sum, so the padding changes no value; the RMS statistics, the
// activation and every other elementwise step run over the true H (or W)
// only. At hidden 1 and 2 the padded products do 16x and 8x the work the
// function needs; the kernels stay bound by bytes there all the same
// (PERF.md §6), so one design serves every width.
//
// The elementwise work runs a thread a row in fp32 registers, each bf16
// rounding point written out: a product of two bf16 values is exact in
// fp32 and rounds once; a sum rounds in fp32, then to bf16, as PyTorch's
// bf16 arithmetic (the plain version) does.
#pragma once

#include "ffn_common.cuh"

#ifndef FFN_SMALL_H
#error "compile with -DFFN_SMALL_H=<hidden width: 1, 2, 4, 8, 16 or 32>"
#endif

namespace ffns {

constexpr int H = FFN_SMALL_H;   // hidden width
static_assert(H == 1 || H == 2 || H == 4 || H == 8 || H == 16 || H == 32,
              "hidden widths 1 to 32 dividing 128");
constexpr int W = 3 * H;                 // middle width
constexpr int HK = H < 16 ? 16 : H;      // H padded to the mma's k-step
constexpr int WK = (W + 15) / 16 * 16;   // W padded likewise
constexpr int HS = HK + 8;  // row stride (bf16) of [*, HK] tiles: 48 or 80 bytes
constexpr int WS = WK + 8;  // row stride (bf16) of [*, WK] tiles: an odd multiple of 16 bytes
constexpr int GS = HK + 4;  // row stride (fp32) of the [TM, HK] sums
constexpr int THREADS = 256;  // 8 warps
constexpr int TM = 128;       // rows a tile: 16 a warp for the products, and a thread a
                              // row (the first 4 warps) for the elementwise work

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// the H bf16 values of a row (2H-byte aligned) as floats; zeros for a
// row past the end
__device__ __forceinline__ void load_row(float (&v)[H], const __nv_bfloat16* p, bool valid) {
  if (!valid) {
#pragma unroll
    for (int o = 0; o < H; ++o) v[o] = 0.f;
    return;
  }
  if constexpr (H >= 8) {
#pragma unroll
    for (int i = 0; i < H / 8; ++i) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const uint32_t wd[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[8 * i + 2 * q] = __uint_as_float(wd[q] << 16);
        v[8 * i + 2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int o = 0; o < H; ++o) v[o] = __bfloat162float(p[o]);
  }
}

// v (bf16 values) stored to a row of H bf16 values (2H-byte aligned)
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&v)[H]) {
  if constexpr (H >= 8) {
#pragma unroll
    for (int i = 0; i < H / 8; ++i) {
      uint32_t wd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wd[q] = (__float_as_uint(v[8 * i + 2 * q]) >> 16) |
                (__float_as_uint(v[8 * i + 2 * q + 1]) & 0xffff0000u);
      reinterpret_cast<uint4*>(p)[i] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  } else {
#pragma unroll
    for (int o = 0; o < H; ++o) p[o] = __float2bfloat16_rn(v[o]);
  }
}

// v (bf16 values) into a row of a shared-memory tile; its padding stays
// as it was (zero)
__device__ __forceinline__ void put_row(__nv_bfloat16* p, const float (&v)[H]) {
#pragma unroll
  for (int o = 0; o < H; ++o) p[o] = __float2bfloat16_rn(v[o]);
}

__device__ __forceinline__ void get_row(float (&v)[H], const __nv_bfloat16* p) {
#pragma unroll
  for (int o = 0; o < H; ++o) v[o] = __bfloat162float(p[o]);
}

// _rms_fwd on a row: inv = 1/(sqrt(sum + 1e-24)/sqrt(H) + 1e-8) from the
// fp32 sum of the bf16 squares, u = bf16(v * bf16(inv)), out =
// bf16(u * scale) (scale: bf16 values); returns inv
__device__ __forceinline__ float rms_norm(float (&out)[H], const float (&v)[H],
                                          const float* scale) {
  float gs = 0.f;
#pragma unroll
  for (int o = 0; o < H; ++o) gs += bf(v[o] * v[o]);
  const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
  const float inv = 1.0f / (rms + 1e-8f);
  const float ib = bf(inv);
#pragma unroll
  for (int o = 0; o < H; ++o) out[o] = bf(bf(v[o] * ib) * scale[o]);
  return inv;
}

// _rms_bwd on a row, in place on g: v the norm's input, inv its
// statistic, scale its scale (bf16 values); ds gets the scale terms
// bf16(g * u), u = bf16(v * bf16(inv)) the norm's quotient:
//   g_u = bf16(g * scale);  dot = sum bf16(g_u * v);
//   corr = bf16(dot * inv^2 / (H * (1/inv - 1e-8)));
//   g = bf16(bf16(g_u * bf16(inv)) - bf16(v * corr))
__device__ __forceinline__ void rms_bwd(float (&g)[H], const float (&v)[H], float inv,
                                        const float* scale, float (&ds)[H]) {
  const float ib = bf(inv);
  float dot = 0.f;
#pragma unroll
  for (int o = 0; o < H; ++o) {
    ds[o] = bf(g[o] * bf(v[o] * ib));
    g[o] = bf(g[o] * scale[o]);  // g_u
    dot += bf(g[o] * v[o]);
  }
  const float rms = fmaxf(1.0f / inv - 1e-8f, 1e-30f);
  const float corr = bf(dot * (inv * inv) / (H * rms));
#pragma unroll
  for (int o = 0; o < H; ++o) g[o] = bf(bf(g[o] * ib) - bf(v[o] * corr));
}

// a weight [rows, cols] (fp32, row-major) as bf16 into a [*, stride] tile,
// transposed when asked; every padded place of the tile zero
__device__ __forceinline__ void stage_weight(__nv_bfloat16* dst, int stride, int tile_rows,
                                             const float* w, int rows, int cols, bool transpose,
                                             int tid) {
  for (int i = tid; i < tile_rows * stride; i += THREADS) {
    const int r = i / stride, c = i % stride;
    float val = 0.f;
    if (transpose ? (c < rows && r < cols) : (r < rows && c < cols))
      val = transpose ? w[c * cols + r] : w[r * cols + c];
    dst[i] = __float2bfloat16_rn(val);
  }
}

// a vector of n fp32 values as bf16 values in fp32, zero up to padded
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n, int padded,
                                          int tid) {
  for (int i = tid; i < padded; i += THREADS)
    dst[i] = i < n ? __bfloat162float(__float2bfloat16_rn(src[i])) : 0.f;
}

// a [TM, stride] bf16 tile, zero
__device__ __forceinline__ void zero_tile(__nv_bfloat16* dst, int stride, int tid) {
  for (int i = tid; i < TM * stride; i += THREADS) dst[i] = __float2bfloat16_rn(0.f);
}

// a pair of fp32 values as one bf16x2 register (lo in the low half)
__device__ __forceinline__ uint32_t bf2_bits(float lo, float hi) {
  return (__float_as_uint(bf(lo)) >> 16) | (__float_as_uint(bf(hi)) & 0xffff0000u);
}

}  // namespace ffns
