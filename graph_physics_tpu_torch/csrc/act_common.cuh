// The MLP activations of the kernels, on one fp32 value holding a bf16
// value, with the JAX package's rounding points: the gated FFN's
// (ffn_common.cuh) and the GraphNetBlock's (gn_tile.cuh, gn_wide.cuh).
//
// SiLU follows XLA's evaluation of jax.nn.silu on bf16, every step
// rounded to bf16: s = bf16(1 / bf16(1 + bf16(exp(-x)))), silu =
// bf16(x · s); its derivative follows the Pallas kernels'
// _act_grad("silu", pre) (graph_physics_tpu/ops/fused_gnblock.py:141-143)
// on bf16: bf16(s · bf16(1 + bf16(x · bf16(1 - s)))). The plain versions
// compute the same chain (ops/activation.py). The exact GELU and its
// derivative are fp32, rounded once by the caller (:126-128, :144-148).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp_act {

// the MLP activations the GraphNetBlock kernels take, by the C interfaces'
// code
enum Kind : int { RELU = 0, SILU = 1, GELU = 2 };

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float silu_sigmoid(float x) {
  return bfr(1.0f / bfr(1.0f + bfr(expf(-x))));
}

__device__ __forceinline__ float silu(float x) { return bfr(x * silu_sigmoid(x)); }

// silu(x) and its derivative, sharing the sigmoid chain
__device__ __forceinline__ void silu_and_grad(float x, float& a, float& d) {
  const float s = silu_sigmoid(x);
  a = bfr(x * s);
  d = bfr(s * bfr(1.0f + bfr(x * bfr(1.0f - s))));
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// Φ(x) + x·φ(x), fp32
__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.0f + erff(x * 0.7071067811865476f)) +
         x * expf(-0.5f * x * x) * 0.3989422804014327f;
}

// act of a bf16 pair (its bits) for SILU or GELU, each half rounded once
__device__ __forceinline__ uint32_t act_pair(uint32_t u, int kind) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  const __nv_bfloat162 a = kind == SILU ? __floats2bfloat162_rn(silu(v.x), silu(v.y))
                                        : __floats2bfloat162_rn(gelu(v.x), gelu(v.y));
  return *reinterpret_cast<const uint32_t*>(&a);
}

// bf16(g · bf16(act'(pre))) of a pair for SILU or GELU: _mlp_bwd's
// g * _act_grad(pre), the derivative in pre's dtype
__device__ __forceinline__ uint32_t grad_pair(uint32_t g, uint32_t pre, int kind) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pre));
  const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g));
  float d0, d1;
  if (kind == SILU) {
    float a;
    silu_and_grad(v.x, a, d0);
    silu_and_grad(v.y, a, d1);
  } else {
    d0 = bfr(gelu_grad(v.x));
    d1 = bfr(gelu_grad(v.y));
  }
  const __nv_bfloat162 r = __floats2bfloat162_rn(gv.x * d0, gv.y * d1);
  return *reinterpret_cast<const uint32_t*>(&r);
}

}  // namespace mlp_act
