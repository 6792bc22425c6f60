// Helpers shared by the gated-FFN kernels (fused_ffn.cu, fused_ffn_bwd.cu),
// both on mma.sync tiles (mma_common.cuh): the widths, the activation and
// its derivative, and the bf16-pair elementwise work of a quad of lanes
// holding one row. The kernels of the other widths (ffn_wide.cuh,
// ffn_small.cuh) take the activation from here too.
//
// Elementwise work runs on bf16 pairs: a product or sum of two bf16
// values rounded once to bf16 (mul/add/sub .rn.bf16x2) equals the fp32
// operation rounded to bf16, so the pairs keep the JAX kernel's rounding
// with half the instructions and no conversions. The _rn intrinsics keep
// the compiler from contracting a product and a sum into one fma, which
// would round once where the JAX kernel rounds twice.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_common.cuh"
#include "mma_common.cuh"

namespace ffn {

constexpr int H = 64;      // hidden width
constexpr int W = 3 * H;   // middle width

using bf2 = __nv_bfloat162;

// exact-erf GELU, or SiLU as XLA evaluates it on bf16 (act_common.cuh)
__device__ __forceinline__ float act(float a, int silu) {
  return silu ? mlp_act::silu(a) : 0.5f * a * (1.0f + erff(a * 0.7071067811865476f));
}

// act(x) (above) and its derivative act'(x), sharing the one erff (GELU)
// or sigmoid chain (SiLU) both need: the same values as computing each
// alone
__device__ __forceinline__ void act_and_grad(float x, int silu, float& a, float& d) {
  if (silu) {
    mlp_act::silu_and_grad(x, a, d);
  } else {
    const float phi = 1.0f + erff(x * 0.7071067811865476f);
    a = 0.5f * x * phi;
    d = 0.5f * phi + x * expf(-0.5f * x * x) * 0.3989422804014327f;
  }
}

// 16 bf16 values (16-byte aligned) as 8 pairs, and back
__device__ __forceinline__ void load8(bf2 (&v)[8], const __nv_bfloat16* p) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
  *reinterpret_cast<uint4*>(v) = s[0];
  *reinterpret_cast<uint4*>(v + 4) = s[1];
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const bf2 (&v)[8]) {
  uint4* d = reinterpret_cast<uint4*>(p);
  d[0] = *reinterpret_cast<const uint4*>(v);
  d[1] = *reinterpret_cast<const uint4*>(v + 4);
}

// a * b * c, each product rounded to bf16
__device__ __forceinline__ bf2 mul3(bf2 a, bf2 b, bf2 c) { return __hmul2_rn(__hmul2_rn(a, b), c); }

// _rms_fwd's statistic of a row held by a quad, 16 values a lane: inv =
// 1/(sqrt(sum + 1e-24)/sqrt(H) + 1e-8), the fp32 sum of the bf16 squares
__device__ __forceinline__ float quad_rms_inv(const bf2 (&v)[8]) {
  float gs = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 sq = __bfloat1622float2(__hmul2_rn(v[i], v[i]));
    gs += sq.x;
    gs += sq.y;
  }
  gs = tc::quad_sum(gs);
  const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
  return 1.0f / (rms + 1e-8f);
}

// _rms_fwd on a quad's row in place: v = bf16(bf16(v * bf16(inv)) * scale)
// (scale: this lane's 8 pairs); returns inv
__device__ __forceinline__ float quad_rms_norm(bf2 (&v)[8], const bf2* scale) {
  const float inv = quad_rms_inv(v);
  const bf2 ib = __float2bfloat162_rn(inv);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = mul3(v[i], ib, scale[i]);
  return inv;
}

}  // namespace ffn
