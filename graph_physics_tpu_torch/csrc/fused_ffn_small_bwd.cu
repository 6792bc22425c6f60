// Gated feed-forward half of the transformer block at hidden 32 and below,
// backward, for Hopper (sm_90a), on the tensor cores; compiled once a
// width, -DFFN_SMALL_H=H for H in 1, 2, 4, 8, 16, 32.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
// _ffn_bwd_kernel (:99) with pre_norm=True, called by the custom VJP of
// fused_gated_ffn (run_bwd, :258), at the hidden widths below 64 that
// JAX's gate fuses. Same function as fused_ffn_bwd.cu, per row x of
// [N*B, H] with its cotangent g, W = 3H:
//   rematerialise t = RMS_norm2(x), n = RMS_0(t), a1, a2, act1 = bf16(act(a1)),
//     gmid = bf16(act1 * a2)                        (as fused_ffn_small.cu)
//   g_mid = bf16(g W3);  ga1 = bf16(bf16(g_mid * a2) * bf16(act'(a1)));
//   ga2 = bf16(g_mid * act1);  g_h = bf16(ga1 W1 + ga2 W2)   (fp32 sums)
//   _rms_bwd through the block's norm (v = t) and norm2 (v = x);
//   dx = bf16(g + g_in)
// and, summed over all rows in fp32: db3 = sum g, dW3 = g^T gmid,
// db1 = sum ga1, dW1 = ga1^T n, db2 = sum ga2, dW2 = ga2^T n,
// dscale = sum bf16(g_h * u), dscale2 = sum bf16(g_in1 * u0). Weights are
// used as bf16 values, as in the forward. Every bf16 rounding point is the
// JAX kernel's; only the order of the fp32 sums differs, and it is fixed.
//
// What bounds it on this card: 8 products of H x 3H a row, 48·H² FLOP,
// against 6·H bytes (x and g read, dx written). At hidden 32 on the
// cylinder transformer slice (122,880 rows): 6.0 GFLOP (0.0061 ms at 989
// TFLOP/s) and 23.6 MB (0.0070 ms at 3.35 TB/s): bound by bytes, as every
// width below is.
//
// What the design does about it (ffn_small.cuh pads the widths to the
// tiles): one pass over the rows, no per-row scratch in device memory.
//   * Persistent blocks of 8 warps, one per SM (``parts`` of them), each
//     walking 128-row tiles; W1, W2 and W3^T are staged once a block as
//     bf16 [WK][HS], zero-padded.
//   * Thread t < 128 loads row t of x and of g into [TM][HS] tiles, and
//     runs both RMS norms in registers into the n tile.
//   * Warp w runs rows 16w..16w+15, 16 middle columns at a time: a1, a2
//     (A = n) and g_mid (A = g) against ldmatrix'd weight fragments, the
//     act/act' epilogue on the accumulator fragments, ga1 and ga2 straight
//     from registers as the A operand of g_h; ga1, ga2 and gmid also go
//     to [TM][WS] tiles for the weight gradients.
//   * The weight gradients: every warp keeps 16 x 16 tiles of dW1, dW2
//     and dW3^T ([WK][HK] each, 3·WK·HK/256 tiles in all, dealt round the
//     8 warps) in registers across all its block's tiles, contracting over
//     the tile's 128 rows on the tensor cores.
//   * Thread t < 128 runs the two RMS backwards of row t and writes dx; the
//     bias and scale sums are column sums of the staged tiles, a thread a
//     column, in row order.
//   * Each block writes its sums to its slot of a partials buffer,
//     [parts][G_TOTAL], and a second kernel adds them in block order:
//     bit-reproducible, no atomics (as csrc/gn_bwd_common.cuh and
//     fused_ffn_bwd.cu do).

#include "ffn_small.cuh"

namespace {

using namespace tc;
using namespace ffns;

// shared memory, in bytes
constexpr int SZ_WT = WK * HS * 2;  // one weight [WK][HS]
constexpr int SZ_T = TM * HS * 2;   // one [TM][HS] tile
constexpr int SZ_M = TM * WS * 2;   // one [TM][WS] tile
constexpr int OFF_W1 = 0, OFF_W2 = SZ_WT, OFF_W3 = 2 * SZ_WT;  // W1, W2 [W][H]; W3^T [W][H]
constexpr int OFF_X = 3 * SZ_WT;            // x tile
constexpr int OFF_G = OFF_X + SZ_T;         // g tile
constexpr int OFF_N = OFF_G + SZ_T;         // n tile
constexpr int OFF_DS1 = OFF_N + SZ_T;       // bf16(g_h * u) tile
constexpr int OFF_DS2 = OFF_DS1 + SZ_T;     // bf16(g_in1 * u0) tile
constexpr int OFF_GA1 = OFF_DS2 + SZ_T;     // ga1 tile
constexpr int OFF_GA2 = OFF_GA1 + SZ_M;     // ga2 tile
constexpr int OFF_GMID = OFF_GA2 + SZ_M;    // gmid tile
constexpr int OFF_GH = OFF_GMID + SZ_M;     // g_h sums [TM][GS] fp32
constexpr int OFF_VEC = OFF_GH + TM * GS * 4;  // b1, b2 [WK]; scale2, scale [HK] (fp32)
constexpr int V_B1 = 0, V_B2 = WK, V_S2 = 2 * WK, V_S = V_S2 + HK;
constexpr int SMEM = OFF_VEC + (V_S + HK) * 4;
static_assert(SMEM <= 232448, "shared memory of one block");
// the gradient buffer: dW1, dW2 [W][H], dW3 [H][W], db1, db2, db3, dscale, dscale2
constexpr int G_W2 = W * H, G_W3 = 2 * W * H, G_B1 = 3 * W * H, G_B2 = G_B1 + W;
constexpr int G_B3 = G_B2 + W, G_S = G_B3 + H, G_S2 = G_S + H, G_TOTAL = G_S2 + H;
// the weight-gradient tiles: (product, 16 middle rows, 16 hidden columns)
constexpr int JT = WK / 16, OT = HK / 16;
constexpr int UNITS = 3 * JT * OT;
constexpr int UPW = (UNITS + 7) / 8;  // units a warp
// the column sums: db1, db2 (W each), then db3, dscale, dscale2 (H each)
constexpr int COLS = 2 * W + 3 * H;
constexpr int CPT = (COLS + THREADS - 1) / THREADS;  // columns a thread

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

// both kernels templated on the width so that each library's kernels have
// names of their own
template <int HH>
__global__ void __launch_bounds__(THREADS, 1) ffn_small_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  __nv_bfloat16 *sW1 = tile(OFF_W1), *sW2 = tile(OFF_W2), *sW3 = tile(OFF_W3);
  __nv_bfloat16 *sX = tile(OFF_X), *sG = tile(OFF_G), *sN = tile(OFF_N);
  __nv_bfloat16 *sDS1 = tile(OFF_DS1), *sDS2 = tile(OFF_DS2);
  __nv_bfloat16 *sGA1 = tile(OFF_GA1), *sGA2 = tile(OFF_GA2), *sGM = tile(OFF_GMID);
  float* sGH = reinterpret_cast<float*>(smem + OFF_GH);
  float* vec = reinterpret_cast<float*>(smem + OFF_VEC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_weight(sW1, HS, WK, a.w1, W, H, false, tid);
  stage_weight(sW2, HS, WK, a.w2, W, H, false, tid);
  stage_weight(sW3, HS, WK, a.w3, H, W, true, tid);
  zero_tile(sX, HS, tid);
  zero_tile(sG, HS, tid);
  zero_tile(sN, HS, tid);
  stage_vec(vec + V_B1, a.b1, W, WK, tid);
  stage_vec(vec + V_B2, a.b2, W, WK, tid);
  stage_vec(vec + V_S2, a.scale2, H, HK, tid);
  stage_vec(vec + V_S, a.scale, H, HK, tid);
  __syncthreads();

  float acc[UPW][2][4];  // the warp's weight-gradient tiles, fp32
#pragma unroll
  for (int q = 0; q < UPW; ++q)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.f;
  float cs[CPT];  // this thread's column sums
#pragma unroll
  for (int i = 0; i < CPT; ++i) cs[i] = 0.f;

  const long long tiles = (a.rows + TM - 1) / TM;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long t = t0; t < t1; ++t) {
    // x and g rows in, n = RMS_0(RMS_norm2(x)), a thread a row; a row past
    // the end is zero in x and g, and a zero g adds nothing to any sum
    const long long row = t * TM + tid;
    const bool valid = tid < TM && row < a.rows;
    float inv0 = 0.f, inv1 = 0.f;
    if (tid < TM) {  // warp-uniform
      float x[H], g[H], tv[H];
      load_row(x, a.x + (valid ? row : 0) * H, valid);
      load_row(g, a.g + (valid ? row : 0) * H, valid);
      put_row(sX + tid * HS, x);
      put_row(sG + tid * HS, g);
      inv0 = rms_norm(tv, x, vec + V_S2);
      inv1 = rms_norm(g, tv, vec + V_S);  // n, in g's registers
      put_row(sN + tid * HS, g);
    }
    __syncthreads();

    // row products, 16 middle columns at a time
    {
      uint32_t an[HK / 16][4], ag[HK / 16][4];
#pragma unroll
      for (int ks = 0; ks < HK / 16; ++ks) {
        ldsm(an[ks], a_rows(sN, HS, 16 * warp, 16 * ks, lane));
        ldsm(ag[ks], a_rows(sG, HS, 16 * warp, 16 * ks, lane));
      }
      float gh[HK / 8][4];
#pragma unroll
      for (int nt = 0; nt < HK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) gh[nt][e] = 0.f;
#pragma unroll
      for (int c = 0; c < WK / 16; ++c) {
        const int j0 = 16 * c;
        float a1[2][4], a2[2][4], gm[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) a1[nt][e] = a2[nt][e] = gm[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < HK / 16; ++ks) {
          uint32_t b[4];
          ldsm(b, b_rows(sW1, HS, j0, 16 * ks, lane));
          mma(a1[0], an[ks], b[0], b[1]);
          mma(a1[1], an[ks], b[2], b[3]);
          ldsm(b, b_rows(sW2, HS, j0, 16 * ks, lane));
          mma(a2[0], an[ks], b[0], b[1]);
          mma(a2[1], an[ks], b[2], b[3]);
          ldsm(b, b_rows(sW3, HS, j0, 16 * ks, lane));
          mma(gm[0], ag[ks], b[0], b[1]);
          mma(gm[1], ag[ks], b[2], b[3]);
        }
        // the epilogue on the fragments; fa[2nt + half] is the A fragment
        // register of row lane/4 + 8 half, columns j0 + 8nt + 2(lane%4) +
        // {0, 1}
        uint32_t fa1[4], fa2[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * warp + (lane >> 2) + 8 * half;
            const int j = j0 + 8 * nt + 2 * (lane & 3);
            float v1[2], v2[2], vm[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float h1 = bf(bf(a1[nt][2 * half + i]) + vec[V_B1 + j + i]);
              const float h2 = bf(bf(a2[nt][2 * half + i]) + vec[V_B2 + j + i]);
              const float g_mid = bf(gm[nt][2 * half + i]);
              float act, d;
              ffn::act_and_grad(h1, a.silu, act, d);
              act = bf(act);
              v1[i] = bf(bf(g_mid * h2) * bf(d));
              v2[i] = bf(g_mid * act);
              vm[i] = bf(act * h2);
            }
            fa1[2 * nt + half] = bf2_bits(v1[0], v1[1]);
            fa2[2 * nt + half] = bf2_bits(v2[0], v2[1]);
            *reinterpret_cast<uint32_t*>(sGA1 + r * WS + j) = fa1[2 * nt + half];
            *reinterpret_cast<uint32_t*>(sGA2 + r * WS + j) = fa2[2 * nt + half];
            *reinterpret_cast<uint32_t*>(sGM + r * WS + j) = bf2_bits(vm[0], vm[1]);
          }
        // g_h += ga1 W1[j0..j0+15] + ga2 W2[j0..j0+15]
#pragma unroll
        for (int p = 0; p < HK / 16; ++p) {
          uint32_t b[4];
          ldsm_t(b, b_cols(sW1, HS, 16 * p, j0, lane));
          mma(gh[2 * p], fa1, b[0], b[1]);
          mma(gh[2 * p + 1], fa1, b[2], b[3]);
          ldsm_t(b, b_cols(sW2, HS, 16 * p, j0, lane));
          mma(gh[2 * p], fa2, b[0], b[1]);
          mma(gh[2 * p + 1], fa2, b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < HK / 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(sGH + (16 * warp + (lane >> 2) + 8 * half) * GS + 8 * nt +
                                     2 * (lane & 3)) =
              make_float2(gh[nt][2 * half], gh[nt][2 * half + 1]);
    }
    __syncthreads();

    // the weight gradients over the tile's rows: dW1 = ga1^T n, dW2 =
    // ga2^T n, dW3^T = gmid^T g
#pragma unroll
    for (int q = 0; q < UPW; ++q) {
      const int unit = warp + 8 * q;
      if (unit < UNITS) {  // warp-uniform
        const int m = unit / (JT * OT), jt = (unit / OT) % JT, ot = unit % OT;
        const __nv_bfloat16* ga = m == 0 ? sGA1 : m == 1 ? sGA2 : sGM;
        const __nv_bfloat16* bt = m == 2 ? sG : sN;
#pragma unroll
        for (int ks = 0; ks < TM / 16; ++ks) {
          uint32_t af[4], b[4];
          ldsm_t(af, a_cols(ga, WS, 16 * jt, 16 * ks, lane));
          ldsm_t(b, b_cols(bt, HS, 16 * ot, 16 * ks, lane));
          mma(acc[q][0], af, b[0], b[1]);
          mma(acc[q][1], af, b[2], b[3]);
        }
      }
    }

    // the two RMS backwards and dx, a thread a row
    if (tid < TM) {
      float x[H], tv[H], gq[H], ds[H];
      get_row(x, sX + tid * HS);
      rms_norm(tv, x, vec + V_S2);
#pragma unroll
      for (int o = 0; o < H; ++o) gq[o] = bf(sGH[tid * GS + o]);
      rms_bwd(gq, tv, inv1, vec + V_S, ds);
      if (!valid) {
#pragma unroll
        for (int o = 0; o < H; ++o) ds[o] = 0.f;
      }
      put_row(sDS1 + tid * HS, ds);
      rms_bwd(gq, x, inv0, vec + V_S2, ds);
      if (!valid) {
#pragma unroll
        for (int o = 0; o < H; ++o) ds[o] = 0.f;
      }
      put_row(sDS2 + tid * HS, ds);
      if (valid) {
        get_row(ds, sG + tid * HS);  // g, in ds's registers
#pragma unroll
        for (int o = 0; o < H; ++o) gq[o] = bf(ds[o] + gq[o]);
        store_row(a.dx + row * H, gq);
      }
    }
    __syncthreads();

    // the bias and scale sums, a thread a column, in row order
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int col = tid + THREADS * i;
      if (col < COLS) {
        const __nv_bfloat16* src;
        int stride;
        if (col < W) {
          src = sGA1 + col;
          stride = WS;
        } else if (col < 2 * W) {
          src = sGA2 + col - W;
          stride = WS;
        } else {
          const int k = col - 2 * W;
          src = (k < H ? sG : k < 2 * H ? sDS1 : sDS2) + k % H;
          stride = HS;
        }
        float s = 0.f;
#pragma unroll 8
        for (int r = 0; r < TM; ++r) s += __bfloat162float(src[r * stride]);
        cs[i] += s;
      }
    }
    __syncthreads();  // every tile of this one is the next's
  }

  // the block's partial sums, every entry of its slot written
  float* out = a.partials + static_cast<long long>(blockIdx.x) * G_TOTAL;
#pragma unroll
  for (int q = 0; q < UPW; ++q) {
    const int unit = warp + 8 * q;
    if (unit < UNITS) {
      const int m = unit / (JT * OT), jt = (unit / OT) % JT, ot = unit % OT;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = 16 * jt + (lane >> 2) + 8 * half;
            const int o = 16 * ot + 8 * nt + 2 * (lane & 3) + i;
            if (j < W && o < H)
              out[m == 2 ? G_W3 + o * W + j : m * G_W2 + j * H + o] = acc[q][nt][2 * half + i];
          }
    }
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int col = tid + THREADS * i;
    if (col < COLS) out[G_B1 + col] = cs[i];  // db1, db2, db3, dscale, dscale2 in order
  }
}

// grads[k] = sum over the parts of partials[part][k], in part order
template <int HH>
__global__ void __launch_bounds__(THREADS) ffn_small_bwd_sum_kernel(const Args a, int parts) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= G_TOTAL) return;
  float s = 0.f;
#pragma unroll 8
  for (int p = 0; p < parts; ++p) s += a.partials[static_cast<long long>(p) * G_TOTAL + k];
  a.grads[k] = s;
}

}  // namespace

// x, g, dx: contiguous bf16 [rows, H] (H = FFN_SMALL_H); partials: fp32
// [parts, 9H² + 9H], one row a block (parts blocks are launched); grads:
// fp32 [9H² + 9H], laid out dW1 [3H, H], dW2 [3H, H], dW3 [H, 3H], db1,
// db2 [3H], db3, dscale, dscale2 [H]; every weight and bias fp32 on the
// device, nn.Linear layout ([out, in]). Returns the CUDA error code of the
// launches (0 on success).
extern "C" int ffn_small_bwd(const void* x, const void* g, void* dx, void* partials,
                             void* grads, long long rows, const void* scale2, const void* scale,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, int silu, int parts, void* stream) {
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
  cudaError_t err = cudaFuncSetAttribute(ffn_small_bwd_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_small_bwd_kernel<H><<<parts, THREADS, SMEM, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ffn_small_bwd_sum_kernel<H><<<(G_TOTAL + THREADS - 1) / THREADS, THREADS, 0, st>>>(a, parts);
  return static_cast<int>(cudaGetLastError());
}
