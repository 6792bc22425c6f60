// Gated feed-forward half of the transformer block at hidden 128,
// backward, for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
// _ffn_bwd_kernel (:99) with pre_norm=True at hidden 128 (the panels
// workload), called by the custom VJP of fused_gated_ffn (run_bwd, :258).
// The function and every bf16 rounding point are fused_ffn_bwd.cu's, with
// H = 128 and W = 3H = 384:
//   rematerialise t = RMS_norm2(x), n = RMS_0(t), a1, a2, act1, gmid;
//   g_mid = bf16(g W3);  ga1 = bf16(bf16(g_mid * a2) * bf16(act'(a1)));
//   ga2 = bf16(g_mid * act1);  g_h = bf16(ga1 W1 + ga2 W2);
//   _rms_bwd through the block's norm and norm2;  dx = bf16(g + g_in)
// and, summed over all rows in fp32: db3 = sum g, dW3 = g^T gmid,
// db1 = sum ga1, dW1 = ga1^T n, db2 = sum ga2, dW2 = ga2^T n,
// dscale = sum bf16(g_h * u), dscale2 = sum bf16(g_in1 * u0).
// Only the order of the fp32 sums inside a product differs from the JAX
// kernel's; it is fixed, so two calls give the same bits.
//
// What bounds it on this card: 8 products of 128 x 384 a row (2 to
// rematerialise, 3 for the cotangents, 3 for the weight gradients), 786,432
// FLOP: at panels' shape (122,880 rows) 96.6 GFLOP, 0.0977 ms at the 989
// TFLOP/s bf16 tensor-core peak; the bytes (x and g read, dx written, 94
// MB) take 0.028 ms at 3.35 TB/s. So it is bound by operations.
//
// Why fused_ffn_bwd.cu's design does not carry over: it keeps the three
// weights in shared memory (309 KB here) and 48 x 32 tiles of the three
// weight gradients in registers across all its tiles (590 KB of fp32 a
// block here). This first design splits the work in two passes over the
// rows and keeps every rounding point:
//   1. ffn128_bwd_rows_kernel, persistent blocks of 8 warps over 128-row
//      tiles (warp w owns rows 16w..16w+15), the weights streamed in 6
//      chunks of 64 middle columns through two shared-memory stages (W1,
//      W2 and W3^T rows [64][136], staged once a call as bf16 by
//      ffn128_bwd_stage_kernel): a1, a2 (A = n) and g_mid (A = g) against
//      ldmatrix'd weight fragments, the act/act' epilogue on the
//      accumulator fragments, and ga1, ga2 straight from registers as the
//      A operand of g_h, whose fp32 sums stay in registers across the
//      chunks (64 a thread). ga1, ga2, gmid and n go to a bf16 scratch in
//      device memory (3 KB a row). The two RMS backwards and dx run four
//      threads a row inside the warp that owns the row; the block's column
//      sums of g, bf16(g_h * u) and bf16(g_in1 * u0) (db3, dscale,
//      dscale2) are per-block partials;
//   2. ffn128_wgrad_kernel: dW1 = ga1^T n, dW2 = ga2^T n and dW3^T =
//      gmid^T g as mma.sync products over the rows, a block per (row split,
//      product, 128-wide middle slice), 64-row tiles of both operands
//      double-buffered by cp.async, a 128 x 128 fp32 tile in registers;
//      with db1 and db2 as column sums of the ga1 and ga2 tiles;
//   3. ffn128_bwd_sum_kernel adds the partials in a fixed order.
// Shared memory: 211,968 bytes (pass 1), 69,632 (pass 2).

#include "ffn_wide.cuh"

namespace {

using namespace tc;
using namespace ffnw;

// one staged chunk, in bf16 elements: W1, W2 and W3^T rows [C][XS] each
constexpr int CH_W2 = C * XS, CH_W3 = 2 * C * XS, CHUNK = 3 * C * XS;
constexpr int PIECES = CHUNK / 8;
// pass 1 shared memory, in bytes
constexpr int SZ_T = TM * XS * 2;            // one [TM][XS] tile
constexpr int OFF_WS = 0;                    // two chunk stages
constexpr int OFF_X = OFF_WS + 2 * CHUNK * 2;  // x tile; later bf16(g_in1 * u0)
constexpr int OFF_G = OFF_X + SZ_T;          // g tile
constexpr int OFF_N = OFF_G + SZ_T;          // n tile; later g_h, then bf16(g_h * u)
constexpr int OFF_VEC = OFF_N + SZ_T;        // b1, b2, scale2, scale (bf16)
constexpr int V_B1 = 0, V_B2 = W, V_S2 = 2 * W, V_S = V_S2 + H, V_TOTAL = V_S + H;
constexpr int OFF_INV = OFF_VEC + V_TOTAL * 2;  // the rows' inv0, inv1 (fp32)
constexpr int SMEM = OFF_INV + 2 * TM * 4;
static_assert(SMEM <= 232448, "shared memory of one block");
// pass 1 partials a block: db3, dscale, dscale2
constexpr int PA_TOTAL = 3 * H;
// pass 2: 64-row tiles of the two operands, two stages
constexpr int TK = 64;
constexpr int SZ_K = TK * XS * 2;
constexpr int SMEM2 = 4 * SZ_K;
constexpr int SLICES = W / 128;          // 128-wide middle slices
constexpr int PRODUCTS = 3 * SLICES;     // (product, slice) blocks of a row split
constexpr int PB_TILE = 128 * H + 128;   // a partial: the 128 x 128 tile and 128 column sums
// the gradient buffer: dW1, dW2 [W][H], dW3 [H][W], db1, db2, db3, dscale, dscale2
constexpr int G_W2 = W * H, G_W3 = 2 * W * H, G_B1 = 3 * W * H, G_B2 = G_B1 + W;
constexpr int G_B3 = G_B2 + W, G_S = G_B3 + H, G_S2 = G_S + H, G_TOTAL = G_S2 + H;

struct Args {
  const __nv_bfloat16* x;  // [rows, H]
  const __nv_bfloat16* g;  // [rows, H] cotangent of y
  __nv_bfloat16* dx;       // [rows, H]
  __nv_bfloat16* wst;      // staged weights [NC][CHUNK]
  __nv_bfloat16* ga1;      // scratch [rows, W]
  __nv_bfloat16* ga2;      // scratch [rows, W]
  __nv_bfloat16* gmid;     // scratch [rows, W]
  __nv_bfloat16* n;        // scratch [rows, H]
  float* part_a;           // [parts_a][PA_TOTAL]
  float* part_b;           // [splits][PRODUCTS][PB_TILE]
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
  int parts_a;
  int splits;
};

// W1, W2 and W3^T as bf16 chunks of C middle rows (zero padding)
__global__ void __launch_bounds__(THREADS) ffn128_bwd_stage_kernel(const Args a) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= NC * CHUNK) return;
  const int c = e / CHUNK, r = e % CHUNK;
  const int which = r / CH_W2, j = c * C + (r % CH_W2) / XS, k = (r % CH_W2) % XS;
  float v = 0.f;
  if (k < H) v = which == 0 ? a.w1[j * H + k] : which == 1 ? a.w2[j * H + k] : a.w3[k * W + j];
  a.wst[e] = __float2bfloat16_rn(v);
}

__global__ void __launch_bounds__(THREADS, 1) ffn128_bwd_rows_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  __nv_bfloat16 *sX = tile(OFF_X), *sG = tile(OFF_G), *sN = tile(OFF_N);
  __nv_bfloat16* vec = tile(OFF_VEC);
  const bf2* vec2 = reinterpret_cast<const bf2*>(vec);
  float* inv01 = reinterpret_cast<float*>(smem + OFF_INV);  // [TM] inv0, then [TM] inv1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < W; j += THREADS) {
    vec[V_B1 + j] = __float2bfloat16_rn(a.b1[j]);
    vec[V_B2 + j] = __float2bfloat16_rn(a.b2[j]);
  }
  for (int o = tid; o < H; o += THREADS) {
    vec[V_S2 + o] = __float2bfloat16_rn(a.scale2[o]);
    vec[V_S + o] = __float2bfloat16_rn(a.scale[o]);
  }
  float cs0 = 0.f, cs1 = 0.f;  // column sums: g and bf16(g_h * u) (tid < H), bf16(g_in1 * u0)

  const long long tiles = (a.rows + TM - 1) / TM;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  auto load_chunk = [&](int stage, int c) {
    copy_pieces(tile(OFF_WS + stage * CHUNK * 2), a.wst + c * CHUNK, PIECES, tid);
  };
  if (t0 < t1) load_chunk(0, 0);
  int step = 0;  // chunk steps so far: the stage of this one is step & 1
  for (long long t = t0; t < t1; ++t) {
    const long long row0 = t * TM;
    load_rows(sX, a.x, row0, a.rows, tid);
    load_rows(sG, a.g, row0, a.rows, tid);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 0;\n");
    __syncthreads();

    // n = RMS_0(RMS_norm2(x)), a quad a row, the warp's own rows; n out to
    // the scratch
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int qr = 16 * warp + 8 * pass + (lane >> 2), qc = (lane & 3) * 32;
      bf2 v[16];
      load16(v, sX + qr * XS + qc);
      const float inv0 = quad_rms_norm(v, vec2 + (V_S2 + qc) / 2);
      const float inv1 = quad_rms_norm(v, vec2 + (V_S + qc) / 2);
      store16(sN + qr * XS + qc, v);
      if ((lane & 3) == 0) {
        inv01[qr] = inv0;
        inv01[TM + qr] = inv1;
      }
    }
    __syncwarp();
    store_warp_rows(a.n, sN, row0, a.rows, warp, lane);
    uint32_t an[H / 16][4], ag[H / 16][4];  // the warp's n and g rows as A fragments
#pragma unroll
    for (int ks = 0; ks < H / 16; ++ks) {
      ldsm(an[ks], a_rows(sN, XS, 16 * warp, 16 * ks, lane));
      ldsm(ag[ks], a_rows(sG, XS, 16 * warp, 16 * ks, lane));
    }
    float gh[H / 8][4];
#pragma unroll
    for (int nn = 0; nn < H / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) gh[nn][e] = 0.f;

    for (int c = 0; c < NC; ++c, ++step) {
      const int ws = step & 1;
      if (c + 1 < NC) {
        load_chunk(ws ^ 1, c + 1);
      } else if (t + 1 < t1) {
        load_chunk(ws ^ 1, 0);
      }
      asm volatile("cp.async.commit_group;\n");
      if (c > 0) {
        asm volatile("cp.async.wait_group 1;\n");
        __syncthreads();
      }
      const __nv_bfloat16* sW1 = tile(OFF_WS + ws * CHUNK * 2);
      const __nv_bfloat16* sW2 = sW1 + CH_W2;
      const __nv_bfloat16* sW3 = sW1 + CH_W3;  // W3^T rows
#pragma unroll 1
      for (int sub = 0; sub < C / 16; ++sub) {
        const int j0 = 16 * sub;
        float a1[2][4], a2[2][4], gm[2][4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) a1[nn][e] = a2[nn][e] = gm[nn][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < H / 16; ++ks) {
          uint32_t b[4];
          ldsm(b, b_rows(sW1, XS, j0, 16 * ks, lane));
          mma(a1[0], an[ks], b[0], b[1]);
          mma(a1[1], an[ks], b[2], b[3]);
          ldsm(b, b_rows(sW2, XS, j0, 16 * ks, lane));
          mma(a2[0], an[ks], b[0], b[1]);
          mma(a2[1], an[ks], b[2], b[3]);
          ldsm(b, b_rows(sW3, XS, j0, 16 * ks, lane));
          mma(gm[0], ag[ks], b[0], b[1]);
          mma(gm[1], ag[ks], b[2], b[3]);
        }
        // the epilogue on the fragments; fa[2n + half] is the A fragment
        // register of row lane/4 + 8 half, columns j0 + 8n + 2(lane%4) + {0, 1}
        uint32_t fa1[4], fa2[4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long row = row0 + 16 * warp + (lane >> 2) + 8 * half;
            const int j = c * C + j0 + 8 * nn + 2 * (lane & 3);
            const int e = 2 * half;
            const bf2 h1 = __hadd2_rn(__floats2bfloat162_rn(a1[nn][e], a1[nn][e + 1]),
                                      vec2[(V_B1 + j) / 2]);
            const bf2 h2 = __hadd2_rn(__floats2bfloat162_rn(a2[nn][e], a2[nn][e + 1]),
                                      vec2[(V_B2 + j) / 2]);
            const bf2 g_mid = __floats2bfloat162_rn(gm[nn][e], gm[nn][e + 1]);
            const float2 hf = __bfloat1622float2(h1);
            float act0, act1, d0, d1;
            act_and_grad(hf.x, a.silu, act0, d0);
            act_and_grad(hf.y, a.silu, act1, d1);
            const bf2 act = __floats2bfloat162_rn(act0, act1);
            const bf2 v1 = ffn::mul3(g_mid, h2, __floats2bfloat162_rn(d0, d1));
            const bf2 v2 = __hmul2_rn(g_mid, act);
            const bf2 vm = __hmul2_rn(act, h2);
            fa1[2 * nn + half] = bits(v1);
            fa2[2 * nn + half] = bits(v2);
            if (row < a.rows) {
              *reinterpret_cast<bf2*>(a.ga1 + row * W + j) = v1;
              *reinterpret_cast<bf2*>(a.ga2 + row * W + j) = v2;
              *reinterpret_cast<bf2*>(a.gmid + row * W + j) = vm;
            }
          }
        // g_h += ga1 W1[j0..j0+15] + ga2 W2[j0..j0+15]
#pragma unroll
        for (int p = 0; p < H / 16; ++p) {
          uint32_t b[4];
          ldsm_t(b, b_cols(sW1, XS, 16 * p, j0, lane));
          mma(gh[2 * p], fa1, b[0], b[1]);
          mma(gh[2 * p + 1], fa1, b[2], b[3]);
          ldsm_t(b, b_cols(sW2, XS, 16 * p, j0, lane));
          mma(gh[2 * p], fa2, b[0], b[1]);
          mma(gh[2 * p + 1], fa2, b[2], b[3]);
        }
      }
      __syncthreads();  // the stage is free for the next step's prefetch
    }

    // g_h = bf16(sum) into the n tile (the warp's rows; n is in the scratch)
#pragma unroll
    for (int nn = 0; nn < H / 8; ++nn)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<bf2*>(sN + (16 * warp + (lane >> 2) + 8 * half) * XS + 8 * nn +
                                2 * (lane & 3)) =
            __floats2bfloat162_rn(gh[nn][2 * half], gh[nn][2 * half + 1]);
    __syncwarp();

    // the two RMS backwards and dx, a quad a row; the scale terms replace
    // g_h (the n tile) and x (the x tile) for the column sums
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int qr = 16 * warp + 8 * pass + (lane >> 2), qc = (lane & 3) * 32;
      bf2 gq[16], xv[16], tv[16], ds[16];
      load16(gq, sN + qr * XS + qc);
      load16(xv, sX + qr * XS + qc);
      const float inv0 = inv01[qr], inv1 = inv01[TM + qr];
      const bf2 i0b = __float2bfloat162_rn(inv0);
#pragma unroll
      for (int i = 0; i < 16; ++i) tv[i] = ffn::mul3(xv[i], i0b, vec2[(V_S2 + qc) / 2 + i]);
      quad_rms_bwd(gq, tv, inv1, vec2 + (V_S + qc) / 2, ds);
      store16(sN + qr * XS + qc, ds);
      quad_rms_bwd(gq, xv, inv0, vec2 + (V_S2 + qc) / 2, ds);
      store16(sX + qr * XS + qc, ds);
      const long long row = row0 + qr;
      if (row < a.rows) {
        bf2 gv[16];
        load16(gv, sG + qr * XS + qc);
#pragma unroll
        for (int i = 0; i < 16; ++i) gq[i] = __hadd2_rn(gv[i], gq[i]);
        store16(a.dx + row * H + qc, gq);
      }
    }
    __syncthreads();
    if (tid < H) {
#pragma unroll 8
      for (int r = 0; r < TM; ++r) {
        cs0 += __bfloat162float(sG[r * XS + tid]);
        cs1 += __bfloat162float(sN[r * XS + tid]);
      }
    } else {
#pragma unroll 8
      for (int r = 0; r < TM; ++r) cs0 += __bfloat162float(sX[r * XS + tid - H]);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n");

  float* out = a.part_a + static_cast<long long>(blockIdx.x) * PA_TOTAL;
  if (tid < H) {
    out[tid] = cs0;          // db3
    out[H + tid] = cs1;      // dscale
  } else {
    out[2 * H + tid - H] = cs0;  // dscale2
  }
}

// out[m][k] = sum over rows of A[row][128 s + m] * B[row][k] for one
// (row split, product, slice): dW1 (A = ga1, B = n), dW2 (ga2, n) and
// dW3^T (gmid, g); with the column sums of A (db1, db2)
__global__ void __launch_bounds__(THREADS) ffn128_wgrad_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, q = blockIdx.y, prod = q / SLICES, slice = q % SLICES;
  const __nv_bfloat16* A = (prod == 0 ? a.ga1 : prod == 1 ? a.ga2 : a.gmid) + 128 * slice;
  const __nv_bfloat16* B = prod == 2 ? a.g : a.n;
  const long long tiles = (a.rows + TK - 1) / TK;
  const long long k0 = tiles * split / a.splits, k1 = tiles * (split + 1) / a.splits;

  auto load = [&](int stage, long long t) {
    __nv_bfloat16* sA = tile(stage * 2 * SZ_K);
    __nv_bfloat16* sB = sA + TK * XS;
#pragma unroll
    for (int i = 0; i < TK * 16 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx >> 4, ch = idx & 15;
      const long long row = t * TK + r;
      const bool valid = row < a.rows;
      const long long rr = valid ? row : 0;
      cp_async16(sA + r * XS + ch * 8, A + rr * W + ch * 8, valid);
      cp_async16(sB + r * XS + ch * 8, B + rr * H + ch * 8, valid);
    }
  };

  const int wm = warp & 3, wn = warp >> 2;  // middle rows 32 wm.., columns 64 wn..
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nn][e] = 0.f;
  float cs = 0.f;

  if (k0 < k1) load(0, k0);
  asm volatile("cp.async.commit_group;\n");
  for (long long t = k0; t < k1; ++t) {
    const int st = static_cast<int>((t - k0) & 1);
    if (t + 1 < k1) load(st ^ 1, t + 1);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 1;\n");
    __syncthreads();
    const __nv_bfloat16* sA = tile(st * 2 * SZ_K);
    const __nv_bfloat16* sB = sA + TK * XS;
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks) {
      uint32_t bk[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) ldsm_t(bk[p], b_cols(sB, XS, 64 * wn + 16 * p, 16 * ks, lane));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t af[4];
        ldsm_t(af, a_cols(sA, XS, 32 * wm + 16 * i, 16 * ks, lane));
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          mma(acc[i][2 * p], af, bk[p][0], bk[p][1]);
          mma(acc[i][2 * p + 1], af, bk[p][2], bk[p][3]);
        }
      }
    }
    if (prod < 2 && tid < 128) {
#pragma unroll 8
      for (int r = 0; r < TK; ++r) cs += __bfloat162float(sA[r * XS + tid]);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n");

  float* out = a.part_b + (static_cast<long long>(split) * PRODUCTS + q) * PB_TILE;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 32 * wm + 16 * i + (lane >> 2) + 8 * half;
        const int k = 64 * wn + 8 * nn + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + m * H + k) =
            make_float2(acc[i][nn][2 * half], acc[i][nn][2 * half + 1]);
      }
  if (tid < 128) out[128 * H + tid] = cs;
}

// grads[k] = the sum of its partials, in split (or block) order
__global__ void __launch_bounds__(THREADS) ffn128_bwd_sum_kernel(const Args a) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= G_TOTAL) return;
  float s = 0.f;
  if (k >= G_B3) {
    const int which = (k - G_B3) / H, h = (k - G_B3) % H;
    for (int p = 0; p < a.parts_a; ++p)
      s += a.part_a[static_cast<long long>(p) * PA_TOTAL + which * H + h];
  } else {
    int q, off;
    if (k < G_W3) {  // dW1, dW2 [W][H]
      const int j = (k % G_W2) / H, h = k % H;
      q = (k / G_W2) * SLICES + j / 128;
      off = (j % 128) * H + h;
    } else if (k < G_B1) {  // dW3 [H][W] from dW3^T
      const int h = (k - G_W3) / W, j = (k - G_W3) % W;
      q = 2 * SLICES + j / 128;
      off = (j % 128) * H + h;
    } else {  // db1, db2
      const int j = (k - G_B1) % W;
      q = ((k - G_B1) / W) * SLICES + j / 128;
      off = 128 * H + j % 128;
    }
    for (int p = 0; p < a.splits; ++p)
      s += a.part_b[(static_cast<long long>(p) * PRODUCTS + q) * PB_TILE + off];
  }
  a.grads[k] = s;
}

}  // namespace

// Sizes the caller allocates: the staged weights (bf16 elements), the pass
// 1 partials a block and the pass 2 partials a row split (fp32 elements).
extern "C" int ffn128_bwd_sizes(int which) {
  return which == 0 ? NC * CHUNK : which == 1 ? PA_TOTAL : which == 2 ? PRODUCTS * PB_TILE
                                                                      : G_TOTAL;
}

// x, g, dx: contiguous bf16 [rows, 128]; wst: bf16 [ffn128_bwd_sizes(0)];
// ga1, ga2, gmid: bf16 scratch [rows, 384]; n: bf16 scratch [rows, 128];
// part_a: fp32 [parts_a, ffn128_bwd_sizes(1)], part_b: fp32 [splits,
// ffn128_bwd_sizes(2)]; grads: fp32 [ffn128_bwd_sizes(3)] laid out dW1
// [384, 128], dW2 [384, 128], dW3 [128, 384], db1, db2 [384], db3, dscale,
// dscale2 [128]; every weight and bias fp32 on the device, nn.Linear
// layout ([out, in]). Returns the CUDA error code of the launches.
extern "C" int ffn128_bwd(const void* x, const void* g, void* dx, void* wst, void* ga1, void* ga2,
                          void* gmid, void* n, void* part_a, void* part_b, void* grads,
                          long long rows, const void* scale2, const void* scale, const void* w1,
                          const void* b1, const void* w2, const void* b2, const void* w3,
                          int silu, int parts_a, int splits, void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.wst = static_cast<__nv_bfloat16*>(wst);
  a.ga1 = static_cast<__nv_bfloat16*>(ga1);
  a.ga2 = static_cast<__nv_bfloat16*>(ga2);
  a.gmid = static_cast<__nv_bfloat16*>(gmid);
  a.n = static_cast<__nv_bfloat16*>(n);
  a.part_a = static_cast<float*>(part_a);
  a.part_b = static_cast<float*>(part_b);
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
  a.parts_a = parts_a;
  a.splits = splits;
  if (rows < 1 || parts_a < 1 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(ffn128_bwd_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ffn128_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM2);
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn128_bwd_stage_kernel<<<(NC * CHUNK + THREADS - 1) / THREADS, THREADS, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ffn128_bwd_rows_kernel<<<parts_a, THREADS, SMEM, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ffn128_wgrad_kernel<<<dim3(splits, PRODUCTS), THREADS, SMEM2, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ffn128_bwd_sum_kernel<<<(G_TOTAL + THREADS - 1) / THREADS, THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
