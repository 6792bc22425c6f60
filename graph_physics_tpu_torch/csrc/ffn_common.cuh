// Helpers shared by the gated-FFN kernels (fused_ffn.cu, fused_ffn_bwd.cu):
// the widths, bf16 rounding, row loads and the activation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ffn {

constexpr int H = 64;      // hidden width
constexpr int W = 3 * H;   // middle width
constexpr int THREADS = 256;

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// the 8 bf16 values of one 16-byte word as floats
__device__ __forceinline__ void unpack8(const uint4 u, float* v) {
  const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(wd[q] << 16);
    v[2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
  }
}

// the H bf16 values of one row (16-byte aligned) as floats
__device__ __forceinline__ void load_row(float (&v)[H], const __nv_bfloat16* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < H / 8; ++c) unpack8(__ldg(s + c), v + 8 * c);
}

// two floats (bf16 values) as one packed bf16 pair
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// _rms_fwd's statistic on one row of bf16 values: inv = 1/(rms + 1e-8), fp32
__device__ __forceinline__ float rms_inv(const float (&v)[H]) {
  float gs = 0.f;
#pragma unroll
  for (int o = 0; o < H; ++o) gs += bf(v[o] * v[o]);
  const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
  return 1.0f / (rms + 1e-8f);
}

// _rms_fwd on one row of bf16 values, in place: bf16(bf16(v * bf16(inv)) * scale)
__device__ __forceinline__ void rms_norm(float (&v)[H], const float* scale) {
  const float inv = bf(rms_inv(v));
#pragma unroll
  for (int o = 0; o < H; ++o) v[o] = bf(bf(v[o] * inv) * scale[o]);
}

// exact-erf GELU, or SiLU
__device__ __forceinline__ float act(float a, int silu) {
  return silu ? a / (1.0f + expf(-a)) : 0.5f * a * (1.0f + erff(a * 0.7071067811865476f));
}

}  // namespace ffn
