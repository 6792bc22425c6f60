// Gated feed-forward half of the transformer block, backward, for Hopper
// (sm_90a), on the tensor cores.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
// _ffn_bwd_kernel (:99) with pre_norm=True, called by the custom VJP of
// fused_gated_ffn (run_bwd, :258). Same function, per row x of [N*B, H]
// with its cotangent g (H = 64, W = 3H = 192):
//   rematerialise t = RMS_norm2(x), n = RMS_0(t), a1, a2, act1 = bf16(act(a1)),
//     gmid = bf16(act1 * a2)                            (as fused_ffn.cu)
//   g_mid = bf16(g W3);  ga1 = bf16(bf16(g_mid * a2) * bf16(act'(a1)));
//   ga2 = bf16(g_mid * act1);  g_h = bf16(ga1 W1 + ga2 W2)   (fp32 sums)
//   _rms_bwd through the block's norm (v = t) and norm2 (v = x):
//     g_u = bf16(g_h * scale);  dot = sum bf16(g_u * v);
//     corr = bf16(dot * inv^2 / (H * (1/inv - 1e-8)));
//     g_in = bf16(bf16(g_u * bf16(inv)) - bf16(v * corr))
//   dx = bf16(g + g_in)
// and, summed over all rows in fp32: db3 = sum g, dW3 = g^T gmid,
// db1 = sum ga1, dW1 = ga1^T n, db2 = sum ga2, dW2 = ga2^T n,
// dscale = sum bf16(g_h * u), dscale2 = sum bf16(g_in1 * u0) (u = the
// rounded RMS quotients). Weights are used as bf16 values, as in the
// forward. Every bf16 rounding point is the JAX kernel's; only the order
// of the fp32 sums inside a product differs.
//
// What bounds it on this card: 8 products of 64 x 192 per row (2 to
// rematerialise, 3 for the cotangents, 3 for the weight gradients),
// 196,608 FLOP a row: on the graded transformer slice (27,008 x 16 =
// 432,128 rows) 85 GFLOP, 0.086 ms at the 989 TFLOP/s bf16 tensor-core
// peak; on the cylinder slice (122,880 rows) 24.2 GFLOP, 0.024 ms. The
// bytes (x and g read, dx written: 166 MB and 47 MB) take 0.050 and 0.014
// ms at 3.35 TB/s. So it is bound by operations.
//
// What the design does about it. All 8 products run as
// mma.sync.m16n8k16 bf16 -> fp32 tiles, one kernel pass over the rows, and
// no per-row scratch in device memory:
//   * persistent blocks, one per SM, each of two warpgroups (8 warps),
//     each walking a contiguous range of 64-row tiles; W1, W2 and W3^T are
//     staged once per block as bf16 [192][72] (rows padded by 16 bytes, so
//     the 8 row addresses of an ldmatrix fall in 8 distinct bank groups);
//   * x and g tiles come in with cp.async, double-buffered: tile t+1
//     loads while tile t computes; rows past the end are zero-filled, and
//     a zero row adds nothing to any gradient;
//   * the normalised tile n goes to shared memory (four threads a row,
//     the RMS sums reduced across the quad with shuffles);
//   * row products: warp (m, h) owns rows 16m..16m+15 and middle columns
//     96h..96h+95, 16 at a time: a1, a2 (A = n) and g_mid (A = g) against
//     ldmatrix'd weight fragments, the act/act' epilogue on the
//     accumulator fragments, and ga1, ga2 re-used straight from registers
//     as the A operand of g_h (two m16n8 accumulators are one m16k16 A
//     fragment). The two halves' g_h sums meet in shared memory;
//   * ga1, ga2 and gmid go to shared memory as bf16 [64][200] tiles, the
//     operands of the weight gradients: each warp keeps a 48 x 32 tile of
//     each of dW1, dW2 and dW3^T (144 fp32 accumulators a thread) across
//     all its block's tiles, contracting over the tile's 64 rows;
//   * the two RMS backwards and dx run four threads a row in shared
//     memory; the bias and scale sums are column sums of the staged tiles;
//   * all elementwise work between the products runs on bf16 pairs
//     (mul/add/sub.rn.bf16x2: the same roundings in half the instructions);
//   * each block writes its partial sums, [parts][G_TOTAL], and a second
//     kernel adds them in block order: bit-reproducible, no atomics.
// Shared memory: 224,768 bytes, one block per SM.

#include "ffn_common.cuh"

namespace {

using ffn::H;
using ffn::W;

constexpr int THREADS = 256;  // two warpgroups
constexpr int TM = 64;        // rows per tile
constexpr int WS = H + 8;     // row stride (bf16) of the weights and of the x, g, n tiles
constexpr int MS = W + 8;     // row stride (bf16) of the ga1, ga2, gmid tiles
constexpr int GS = H + 4;     // row stride (fp32) of the g_h tile
// shared memory, in bytes
constexpr int SZ_WT = W * WS * 2;  // one weight [192][72]
constexpr int SZ_T = TM * WS * 2;  // one [64][72] tile
constexpr int SZ_M = TM * MS * 2;  // one [64][200] tile
constexpr int OFF_W1 = 0, OFF_W2 = SZ_WT, OFF_W3 = 2 * SZ_WT;  // W1, W2 [W][H]; W3^T [W][H]
constexpr int OFF_X = 3 * SZ_WT;              // x tile, two stages
constexpr int OFF_G = OFF_X + 2 * SZ_T;       // g tile, two stages
constexpr int OFF_N = OFF_G + 2 * SZ_T;       // n tile
constexpr int OFF_GA1 = OFF_N + SZ_T;         // ga1 tile
constexpr int OFF_GA2 = OFF_GA1 + SZ_M;       // ga2 tile
constexpr int OFF_GMID = OFF_GA2 + SZ_M;      // gmid tile; later the two scale terms
constexpr int OFF_GH = OFF_GMID + SZ_M;       // g_h [64][68] fp32
constexpr int OFF_VEC = OFF_GH + TM * GS * 4;  // b1, b2, scale2, scale (bf16)
constexpr int V_B1 = 0, V_B2 = W, V_S2 = 2 * W, V_S = V_S2 + H, V_TOTAL = V_S + H;
constexpr int OFF_INV = OFF_VEC + V_TOTAL * 2;  // the rows' inv0, inv1 (fp32)
constexpr int SMEM = OFF_INV + 2 * TM * 4;
static_assert(SMEM <= 232448, "shared memory of one block");
// the gradient buffer: dW1, dW2 [W][H], dW3 [H][W], db1, db2, db3, dscale, dscale2
constexpr int G_W2 = W * H, G_W3 = 2 * W * H, G_B1 = 3 * W * H, G_B2 = G_B1 + W;
constexpr int G_B3 = G_B2 + W, G_S = G_B3 + H, G_S2 = G_S + H, G_TOTAL = G_S2 + H;

struct Args {
  const __nv_bfloat16* x;  // [rows, H]
  const __nv_bfloat16* g;  // [rows, H] cotangent of y
  __nv_bfloat16* dx;       // [rows, H]
  float* partials;         // [gridDim.x][G_TOTAL]
  float* grads;            // [G_TOTAL]
  const float* scale2;     // norm2 scale [H]
  const float* scale;      // the block's own RMSNorm scale [H]
  const float* w1;         // nn.Linear [W, H]
  const float* b1;         // [W]
  const float* w2;         // [W, H]
  const float* b2;         // [W]
  const float* w3;         // [H, W]
  long long rows;
  int silu;
};

// act(x) (ffn_common.cuh) and its derivative act'(x), sharing the one
// erff (GELU) or expf (SiLU) both need: the same values as computing each
// alone
__device__ __forceinline__ void act_and_grad(float x, int silu, float& a, float& d) {
  if (silu) {
    const float e = expf(-x);
    const float s = 1.0f / (1.0f + e);
    a = x / (1.0f + e);
    d = s * (1.0f + x * (1.0f - s));
  } else {
    const float phi = 1.0f + erff(x * 0.7071067811865476f);
    a = 0.5f * x * phi;
    d = 0.5f * phi + x * expf(-0.5f * x * x) * 0.3989422804014327f;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += A (16x16, row-major) * B (16x8, column-major), bf16 in, fp32 sums;
// d[0..1] are row lane/4, d[2..3] row lane/4 + 8, columns 2(lane%4) + {0, 1}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses for lane l. A from a row-major [m][k] tile:
__device__ __forceinline__ const __nv_bfloat16* a_rows(const __nv_bfloat16* t, int stride, int m0,
                                                       int k0, int l) {
  return t + (m0 + (l & 15)) * stride + k0 + (l >> 4) * 8;
}
// A from a [k][m] tile (A = its transpose), with ldsm_t
__device__ __forceinline__ const __nv_bfloat16* a_cols(const __nv_bfloat16* t, int stride, int m0,
                                                       int k0, int l) {
  return t + (k0 + (l & 7) + ((l >> 4) << 3)) * stride + m0 + ((l >> 3) & 1) * 8;
}
// B of two n-tiles (n0, n0 + 8) from an [n][k] tile, with ldsm: r[0..1] the
// first n-tile's two registers, r[2..3] the second's
__device__ __forceinline__ const __nv_bfloat16* b_rows(const __nv_bfloat16* t, int stride, int n0,
                                                       int k0, int l) {
  return t + (n0 + (l & 7) + ((l >> 4) << 3)) * stride + k0 + ((l >> 3) & 1) * 8;
}
// B of two n-tiles from a [k][n] tile, with ldsm_t
__device__ __forceinline__ const __nv_bfloat16* b_cols(const __nv_bfloat16* t, int stride, int n0,
                                                       int k0, int l) {
  return t + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * stride + n0 + (l >> 4) * 8;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Elementwise work runs on bf16 pairs: a product or sum of two bf16
// values rounded once to bf16 (mul/add/sub .rn.bf16x2) equals the fp32
// operation rounded to bf16, so the pairs keep the JAX kernel's rounding
// with half the instructions and no conversions. The _rn intrinsics keep
// the compiler from contracting a product and a sum into one fma, which
// would round once where the JAX kernel rounds twice.
using bf2 = __nv_bfloat162;

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

// _rms_fwd's statistic of a row held by a quad, 16 values a lane
__device__ __forceinline__ float quad_rms_inv(const bf2 (&v)[8]) {
  float gs = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 sq = __bfloat1622float2(__hmul2_rn(v[i], v[i]));
    gs += sq.x;
    gs += sq.y;
  }
  gs = quad_sum(gs);
  const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
  return 1.0f / (rms + 1e-8f);
}

// _rms_bwd on a quad's row, in place on g (16 values a lane): v the norm's
// input, inv its statistic, scale its scale (this lane's 8 pairs); ds gets
// the scale terms bf16(g * u)
__device__ __forceinline__ void quad_rms_bwd(bf2 (&g)[8], const bf2 (&v)[8], float inv,
                                             const bf2* scale, bf2 (&ds)[8]) {
  const bf2 inv_b = __float2bfloat162_rn(inv);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ds[i] = __hmul2_rn(g[i], __hmul2_rn(v[i], inv_b));
    g[i] = __hmul2_rn(g[i], scale[i]);  // g_u
    const float2 p = __bfloat1622float2(__hmul2_rn(g[i], v[i]));
    dot += p.x;
    dot += p.y;
  }
  dot = quad_sum(dot);
  const float rms = fmaxf(1.0f / inv - 1e-8f, 1e-30f);
  const bf2 corr = __float2bfloat162_rn(dot * (inv * inv) / (H * rms));
#pragma unroll
  for (int i = 0; i < 8; ++i) g[i] = __hsub2_rn(__hmul2_rn(g[i], inv_b), __hmul2_rn(v[i], corr));
}

__global__ void __launch_bounds__(THREADS, 1) ffn_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  __nv_bfloat16 *sW1 = tile(OFF_W1), *sW2 = tile(OFF_W2), *sW3 = tile(OFF_W3);
  __nv_bfloat16 *sN = tile(OFF_N), *sGA1 = tile(OFF_GA1), *sGA2 = tile(OFF_GA2);
  __nv_bfloat16* sGM = tile(OFF_GMID);
  __nv_bfloat16* sDS1 = sGM;         // after the weight gradients: bf16(g_h * u)
  __nv_bfloat16* sDS2 = sGM + TM * WS;  // and bf16(g_in1 * u0)
  float* sGH = reinterpret_cast<float*>(smem + OFF_GH);
  __nv_bfloat16* vec = tile(OFF_VEC);
  const bf2* vec2 = reinterpret_cast<const bf2*>(vec);  // the same, as pairs
  float* inv01 = reinterpret_cast<float*>(smem + OFF_INV);  // [TM] inv0, then [TM] inv1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

#pragma unroll 4
  for (int i = tid; i < W * H; i += THREADS) {
    const int j = i / H, k = i % H;  // W1, W2 [j][k]
    const int o = i / W, m3 = i % W;  // W3 [o][m3], staged as W3^T [m3][o]
    sW1[j * WS + k] = __float2bfloat16_rn(a.w1[i]);
    sW2[j * WS + k] = __float2bfloat16_rn(a.w2[i]);
    sW3[m3 * WS + o] = __float2bfloat16_rn(a.w3[i]);
  }
  for (int j = tid; j < W; j += THREADS) {
    vec[V_B1 + j] = __float2bfloat16_rn(a.b1[j]);
    vec[V_B2 + j] = __float2bfloat16_rn(a.b2[j]);
  }
  for (int o = tid; o < H; o += THREADS) {
    vec[V_S2 + o] = __float2bfloat16_rn(a.scale2[o]);
    vec[V_S + o] = __float2bfloat16_rn(a.scale[o]);
  }

  const long long tiles = (a.rows + TM - 1) / TM;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  auto load_tile = [&](int stage, long long t) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * THREADS;  // 64 rows x 8 chunks of 16 bytes
      const int r = idx >> 3, ch = idx & 7;
      const long long row = t * TM + r;
      const bool valid = row < a.rows;
      const long long src = (valid ? row : 0) * H + ch * 8;
      cp_async16(tile(OFF_X + stage * SZ_T) + r * WS + ch * 8, a.x + src, valid);
      cp_async16(tile(OFF_G + stage * SZ_T) + r * WS + ch * 8, a.g + src, valid);
    }
  };

  // the warp's weight-gradient tiles: middle rows 48mg..48mg+47, columns 32ng..32ng+31
  const int mg = warp & 3, ng = warp >> 2;
  float dw1[3][4][4], dw2[3][4][4], dw3[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw1[i][n][e] = dw2[i][n][e] = dw3[i][n][e] = 0.f;
  float cs0 = 0.f, cs1 = 0.f, cs2 = 0.f;  // column sums: db1, db2 | db3, dscale, dscale2

  // the row path: rows 16m..16m+15, middle columns 96h..96h+95; the quad
  // layout: row tid/4, columns 16(tid%4)..+15
  const int m = warp & 3, hh = warp >> 2;
  const int qr = tid >> 2, qc = (tid & 3) * 16;

  if (t0 < t1) load_tile(0, t0);
  asm volatile("cp.async.commit_group;\n");
  for (long long t = t0; t < t1; ++t) {
    const int st = static_cast<int>((t - t0) & 1);
    if (t + 1 < t1) load_tile(st ^ 1, t + 1);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 1;\n");
    __syncthreads();
    const __nv_bfloat16* sX = tile(OFF_X + st * SZ_T);
    const __nv_bfloat16* sG = tile(OFF_G + st * SZ_T);

    // n = RMS_0(RMS_norm2(x)), a quad a row
    {
      bf2 v[8];
      load8(v, sX + qr * WS + qc);
      const float inv0 = quad_rms_inv(v);
      const bf2 i0b = __float2bfloat162_rn(inv0);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = mul3(v[i], i0b, vec2[(V_S2 + qc) / 2 + i]);
      const float inv1 = quad_rms_inv(v);
      const bf2 i1b = __float2bfloat162_rn(inv1);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = mul3(v[i], i1b, vec2[(V_S + qc) / 2 + i]);
      store8(sN + qr * WS + qc, v);
      if ((tid & 3) == 0) {
        inv01[qr] = inv0;
        inv01[TM + qr] = inv1;
      }
    }
    __syncthreads();

    // row products, 16 middle columns at a time
    float gh[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gh[n][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < 6; ++c) {
      const int j0 = 96 * hh + 16 * c;
      float a1[2][4], a2[2][4], gm[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) a1[n][e] = a2[n][e] = gm[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        uint32_t an[4], ag[4], b[4];
        ldsm(an, a_rows(sN, WS, 16 * m, 16 * ks, lane));
        ldsm(ag, a_rows(sG, WS, 16 * m, 16 * ks, lane));
        ldsm(b, b_rows(sW1, WS, j0, 16 * ks, lane));
        mma(a1[0], an, b[0], b[1]);
        mma(a1[1], an, b[2], b[3]);
        ldsm(b, b_rows(sW2, WS, j0, 16 * ks, lane));
        mma(a2[0], an, b[0], b[1]);
        mma(a2[1], an, b[2], b[3]);
        ldsm(b, b_rows(sW3, WS, j0, 16 * ks, lane));
        mma(gm[0], ag, b[0], b[1]);
        mma(gm[1], ag, b[2], b[3]);
      }
      // the epilogue on the fragments; fa[2n + half] is the A fragment
      // register of row lane/4 + 8 half, columns j0 + 8n + 2(lane%4) + {0, 1}
      uint32_t fa1[4], fa2[4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * m + (lane >> 2) + 8 * half;
          const int j = j0 + 8 * n + 2 * (lane & 3);
          const int e = 2 * half;
          const bf2 h1 = __hadd2_rn(__floats2bfloat162_rn(a1[n][e], a1[n][e + 1]),
                                 vec2[(V_B1 + j) / 2]);
          const bf2 h2 = __hadd2_rn(__floats2bfloat162_rn(a2[n][e], a2[n][e + 1]),
                                 vec2[(V_B2 + j) / 2]);
          const bf2 g_mid = __floats2bfloat162_rn(gm[n][e], gm[n][e + 1]);
          const float2 hf = __bfloat1622float2(h1);
          float act0, act1, d0, d1;
          act_and_grad(hf.x, a.silu, act0, d0);
          act_and_grad(hf.y, a.silu, act1, d1);
          const bf2 act = __floats2bfloat162_rn(act0, act1);
          const bf2 v1 = mul3(g_mid, h2, __floats2bfloat162_rn(d0, d1));
          const bf2 v2 = __hmul2_rn(g_mid, act);
          const bf2 vm = __hmul2_rn(act, h2);
          fa1[2 * n + half] = *reinterpret_cast<const uint32_t*>(&v1);
          fa2[2 * n + half] = *reinterpret_cast<const uint32_t*>(&v2);
          *reinterpret_cast<bf2*>(sGA1 + row * MS + j) = v1;
          *reinterpret_cast<bf2*>(sGA2 + row * MS + j) = v2;
          *reinterpret_cast<bf2*>(sGM + row * MS + j) = vm;
        }
      // g_h += ga1 W1[j0..j0+15] + ga2 W2[j0..j0+15]
#pragma unroll
      for (int p = 0; p < H / 16; ++p) {
        uint32_t b[4];
        ldsm_t(b, b_cols(sW1, WS, 16 * p, j0, lane));
        mma(gh[2 * p], fa1, b[0], b[1]);
        mma(gh[2 * p + 1], fa1, b[2], b[3]);
        ldsm_t(b, b_cols(sW2, WS, 16 * p, j0, lane));
        mma(gh[2 * p], fa2, b[0], b[1]);
        mma(gh[2 * p + 1], fa2, b[2], b[3]);
      }
    }
    // the two middle halves' g_h sums meet in shared memory
    if (hh == 1) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(sGH + (16 * m + (lane >> 2) + 8 * half) * GS + 8 * n +
                                     2 * (lane & 3)) =
              make_float2(gh[n][2 * half], gh[n][2 * half + 1]);
    }
    __syncthreads();
    if (hh == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* p = reinterpret_cast<float2*>(sGH + (16 * m + (lane >> 2) + 8 * half) * GS +
                                                8 * n + 2 * (lane & 3));
          const float2 o = *p;
          *p = make_float2(gh[n][2 * half] + o.x, gh[n][2 * half + 1] + o.y);
        }
    }

    // weight gradients over the tile's 64 rows: dW1 = ga1^T n, dW2 = ga2^T n,
    // dW3^T = gmid^T g
#pragma unroll
    for (int ks = 0; ks < TM / 16; ++ks) {
      uint32_t bn[2][4], bg[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        ldsm_t(bn[p], b_cols(sN, WS, 32 * ng + 16 * p, 16 * ks, lane));
        ldsm_t(bg[p], b_cols(sG, WS, 32 * ng + 16 * p, 16 * ks, lane));
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int j0 = 48 * mg + 16 * i;
        uint32_t af[4];
        ldsm_t(af, a_cols(sGA1, MS, j0, 16 * ks, lane));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma(dw1[i][2 * p], af, bn[p][0], bn[p][1]);
          mma(dw1[i][2 * p + 1], af, bn[p][2], bn[p][3]);
        }
        ldsm_t(af, a_cols(sGA2, MS, j0, 16 * ks, lane));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma(dw2[i][2 * p], af, bn[p][0], bn[p][1]);
          mma(dw2[i][2 * p + 1], af, bn[p][2], bn[p][3]);
        }
        ldsm_t(af, a_cols(sGM, MS, j0, 16 * ks, lane));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma(dw3[i][2 * p], af, bg[p][0], bg[p][1]);
          mma(dw3[i][2 * p + 1], af, bg[p][2], bg[p][3]);
        }
      }
    }
    // bias sums: db1, db2 (threads < 192), db3 (the rest)
    if (tid < W) {
#pragma unroll 8
      for (int r = 0; r < TM; ++r) {
        cs0 += __bfloat162float(sGA1[r * MS + tid]);
        cs1 += __bfloat162float(sGA2[r * MS + tid]);
      }
    } else {
#pragma unroll 8
      for (int r = 0; r < TM; ++r) cs0 += __bfloat162float(sG[r * WS + tid - W]);
    }
    __syncthreads();

    // the two RMS backwards and dx, a quad a row
    {
      bf2 gq[8], xv[8], tv[8], ds[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 f = *reinterpret_cast<const float2*>(sGH + qr * GS + qc + 2 * i);
        gq[i] = __floats2bfloat162_rn(f.x, f.y);
      }
      load8(xv, sX + qr * WS + qc);
      const float inv0 = inv01[qr], inv1 = inv01[TM + qr];
      const bf2 i0b = __float2bfloat162_rn(inv0);
#pragma unroll
      for (int i = 0; i < 8; ++i) tv[i] = mul3(xv[i], i0b, vec2[(V_S2 + qc) / 2 + i]);
      quad_rms_bwd(gq, tv, inv1, vec2 + (V_S + qc) / 2, ds);
      store8(sDS1 + qr * WS + qc, ds);
      quad_rms_bwd(gq, xv, inv0, vec2 + (V_S2 + qc) / 2, ds);
      store8(sDS2 + qr * WS + qc, ds);
      const long long row = t * TM + qr;
      if (row < a.rows) {
        bf2 gv[8];
        load8(gv, sG + qr * WS + qc);
#pragma unroll
        for (int i = 0; i < 8; ++i) gq[i] = __hadd2_rn(gv[i], gq[i]);
        store8(a.dx + row * H + qc, gq);
      }
    }
    __syncthreads();
    if (tid >= W) {
#pragma unroll 8
      for (int r = 0; r < TM; ++r) {
        cs1 += __bfloat162float(sDS1[r * WS + tid - W]);
        cs2 += __bfloat162float(sDS2[r * WS + tid - W]);
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n");

  // the block's partial sums
  float* out = a.partials + static_cast<long long>(blockIdx.x) * G_TOTAL;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 48 * mg + 16 * i + (lane >> 2) + 8 * half;
        const int k = 32 * ng + 8 * n + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + j * H + k) =
            make_float2(dw1[i][n][2 * half], dw1[i][n][2 * half + 1]);
        *reinterpret_cast<float2*>(out + G_W2 + j * H + k) =
            make_float2(dw2[i][n][2 * half], dw2[i][n][2 * half + 1]);
        out[G_W3 + k * W + j] = dw3[i][n][2 * half];
        out[G_W3 + (k + 1) * W + j] = dw3[i][n][2 * half + 1];
      }
  if (tid < W) {
    out[G_B1 + tid] = cs0;
    out[G_B2 + tid] = cs1;
  } else {
    out[G_B3 + tid - W] = cs0;
    out[G_S + tid - W] = cs1;
    out[G_S2 + tid - W] = cs2;
  }
}

// grads[k] = sum over the parts of partials[part][k], in part order
__global__ void __launch_bounds__(THREADS) ffn_bwd_sum_kernel(const Args a, int parts) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= G_TOTAL) return;
  float s = 0.f;
#pragma unroll 8
  for (int p = 0; p < parts; ++p) s += a.partials[static_cast<long long>(p) * G_TOTAL + k];
  a.grads[k] = s;
}

}  // namespace

// x, g, dx: contiguous bf16 [rows, 64]; partials: fp32 [parts, 37440],
// one row per block (parts blocks are launched); grads: fp32 [37440], laid
// out dW1 [192, 64], dW2 [192, 64], dW3 [64, 192], db1, db2 [192], db3,
// dscale, dscale2 [64]; every weight and bias fp32 on the device,
// nn.Linear layout ([out, in]). Returns the CUDA error code of the
// launches (0 on success).
extern "C" int ffn_bwd(const void* x, const void* g, void* dx, void* partials, void* grads,
                       long long rows, const void* scale2, const void* scale, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* w3,
                       const void* b3, int silu, int parts, void* stream) {
  (void)b3;  // the output bias does not enter the backward
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.partials = static_cast<float*>(partials);
  a.grads = static_cast<float*>(grads);
  a.scale2 = static_cast<const float*>(scale2);
  a.scale = static_cast<const float*>(scale);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.w3 = static_cast<const float*>(w3);
  a.rows = rows;
  a.silu = silu;
  if (rows < 1 || parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(ffn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_kernel<<<parts, THREADS, SMEM, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_sum_kernel<<<(G_TOTAL + THREADS - 1) / THREADS, THREADS, 0, st>>>(a, parts);
  return static_cast<int>(cudaGetLastError());
}
