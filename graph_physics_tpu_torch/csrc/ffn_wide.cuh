// Helpers shared by the hidden-128 gated-FFN kernels (fused_ffn128.cu,
// fused_ffn128_bwd.cu): the widths, the weight chunks they stream, and the
// bf16-pair work of a quad of lanes holding one row, 32 values a lane
// (ffn_common.cuh's helpers at 16 a lane, with the same roundings).
#pragma once

#include "ffn_common.cuh"

namespace ffnw {

using ffn::act_and_grad;
using ffn::bf2;

constexpr int H = 128;      // hidden width
constexpr int W = 3 * H;    // middle width
constexpr int C = 64;       // middle columns of one streamed weight chunk
constexpr int NC = W / C;   // chunks
constexpr int XS = H + 8;   // row stride (bf16) of the row tiles and of [C][H] weight chunks
constexpr int TM = 128;     // rows a tile: 8 warps of 16 rows
constexpr int THREADS = 256;

// 32 bf16 values (16-byte aligned) as 16 pairs, and back
__device__ __forceinline__ void load16(bf2 (&v)[16], const __nv_bfloat16* p) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) *reinterpret_cast<uint4*>(v + 4 * i) = s[i];
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const bf2 (&v)[16]) {
  uint4* d = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = *reinterpret_cast<const uint4*>(v + 4 * i);
}

// _rms_fwd's statistic of a row held by a quad, 32 values a lane: inv =
// 1/(sqrt(sum + 1e-24)/sqrt(H) + 1e-8), the fp32 sum of the bf16 squares
__device__ __forceinline__ float quad_rms_inv(const bf2 (&v)[16]) {
  float gs = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 sq = __bfloat1622float2(__hmul2_rn(v[i], v[i]));
    gs += sq.x;
    gs += sq.y;
  }
  gs = tc::quad_sum(gs);
  const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
  return 1.0f / (rms + 1e-8f);
}

// _rms_fwd on a quad's row in place: v = bf16(bf16(v * bf16(inv)) * scale)
// (scale: this lane's 16 pairs); returns inv
__device__ __forceinline__ float quad_rms_norm(bf2 (&v)[16], const bf2* scale) {
  const float inv = quad_rms_inv(v);
  const bf2 ib = __float2bfloat162_rn(inv);
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = ffn::mul3(v[i], ib, scale[i]);
  return inv;
}

// _rms_bwd on a quad's row, in place on g (32 values a lane): v the norm's
// input, inv its statistic, scale its scale (this lane's 16 pairs); ds gets
// the scale terms bf16(g * u) (fused_ffn_bwd.cu's quad_rms_bwd)
__device__ __forceinline__ void quad_rms_bwd(bf2 (&g)[16], const bf2 (&v)[16], float inv,
                                             const bf2* scale, bf2 (&ds)[16]) {
  const bf2 inv_b = __float2bfloat162_rn(inv);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    ds[i] = __hmul2_rn(g[i], __hmul2_rn(v[i], inv_b));
    g[i] = __hmul2_rn(g[i], scale[i]);  // g_u
    const float2 p = __bfloat1622float2(__hmul2_rn(g[i], v[i]));
    dot += p.x;
    dot += p.y;
  }
  dot = tc::quad_sum(dot);
  const float rms = fmaxf(1.0f / inv - 1e-8f, 1e-30f);
  const bf2 corr = __float2bfloat162_rn(dot * (inv * inv) / (H * rms));
#pragma unroll
  for (int i = 0; i < 16; ++i) g[i] = __hsub2_rn(__hmul2_rn(g[i], inv_b), __hmul2_rn(v[i], corr));
}

__device__ __forceinline__ uint32_t bits(bf2 v) { return *reinterpret_cast<uint32_t*>(&v); }

// a contiguous run of 16-byte pieces, global -> shared, by the block
__device__ __forceinline__ void copy_pieces(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            int pieces, int tid) {
  for (int i = tid; i < pieces; i += THREADS) tc::cp_async16(dst + 8 * i, src + 8 * i, true);
}

// 128 rows of a [rows, H] bf16 array into a [TM][XS] tile; rows past the
// end are zero-filled
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row0, long long rows, int tid) {
#pragma unroll
  for (int q = 0; q < TM * (H / 8) / THREADS; ++q) {
    const int idx = tid + q * THREADS;
    const int r = idx >> 4, ch = idx & 15;
    const long long row = row0 + r;
    const bool valid = row < rows;
    tc::cp_async16(dst + r * XS + ch * 8, src + (valid ? row : 0) * H + ch * 8, valid);
  }
}

// a warp's 16 rows of a [TM][XS] tile out to a [rows, H] array, 16-byte stores
__device__ __forceinline__ void store_warp_rows(__nv_bfloat16* dst, const __nv_bfloat16* tile,
                                                long long row0, long long rows, int warp,
                                                int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = lane + 32 * i;
    const int r = 16 * warp + (idx >> 4), ch = idx & 15;
    const long long row = row0 + r;
    if (row < rows)
      *reinterpret_cast<uint4*>(dst + row * H + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + r * XS + ch * 8);
  }
}

}  // namespace ffnw
