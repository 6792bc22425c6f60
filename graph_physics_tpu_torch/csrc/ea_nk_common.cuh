// Helpers shared by the NK edge-attention kernels (fused_edge_attention_nk.cu,
// fused_edge_attention_nk_bwd.cu): bf16 rounding and 16-byte vector loads and
// stores of one head's dh values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace ea_nk {

constexpr int THREADS = 256;
constexpr int MAXK = 32;  // most slots per receiver of the widest instance

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// the DH bf16 values at src (16-byte aligned) as floats
template <int DH>
__device__ __forceinline__ void load_vec(float (&v)[DH], const __nv_bfloat16* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const uint4 u = __ldg(s + c);
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[8 * c + 2 * q] = __uint_as_float(wd[q] << 16);
      v[8 * c + 2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
    }
  }
}

// v rounded to bf16 and stored at dst (16-byte aligned)
template <int DH>
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float (&v)[DH]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    uint32_t wd[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = __float_as_uint(bf(v[8 * c + 2 * q])) >> 16;
      const uint32_t hi = __float_as_uint(bf(v[8 * c + 2 * q + 1])) & 0xffff0000u;
      wd[q] = lo | hi;
    }
    d[c] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// one thread per (node, sample, head): the launch's grid, capped
inline long long grid_for(long long total) {
  const long long grid = (total + THREADS - 1) / THREADS;
  return grid > (1LL << 30) ? (1LL << 30) : grid;
}

}  // namespace ea_nk
