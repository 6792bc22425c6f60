// Gated feed-forward half of the transformer block at hidden 32 and below,
// forward, for Hopper (sm_90a), on the tensor cores; compiled once a
// width, -DFFN_SMALL_H=H for H in 1, 2, 4, 8, 16, 32.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
// _ffn_fwd_kernel (:74) with pre_norm=True, called by fused_gated_ffn
// (:165) from TransformerBlock, at the hidden widths below 64 that JAX's
// gate fuses (LANES_ % H == 0, graph_physics_tpu/models/layers.py:517-524).
// Same function as fused_ffn.cu, per row x of [N*B, H], W = 3H:
//   t  = RMS_norm2(x);  n = RMS_0(t)
//   a1 = bf16(bf16(n W1) + b1);  a2 = bf16(bf16(n W2) + b2)   (fp32 sums)
//   g  = bf16(bf16(act(a1)) * a2)        (act: exact-erf GELU, or SiLU)
//   y  = bf16(x + bf16(bf16(g W3) + b3))
// with the weights and biases used as bf16 values. Every bf16 rounding
// point is the JAX kernel's; the order of the fp32 sums inside a product
// is fixed, so two calls give the same bits.
//
// What bounds it on this card: 3 products of H x 3H a row, 18·H² FLOP,
// against 4·H bytes (x read, y written). At hidden 32 on the cylinder
// transformer slice (1,920 nodes x 64 samples = 122,880 rows) that is 2.3
// GFLOP (0.0023 ms on the bf16 tensor cores at 989 TFLOP/s) and 15.7 MB
// (0.0047 ms at 3.35 TB/s): bound by bytes, as every width below is.
//
// What the design does about it (ffn_small.cuh pads the widths to the
// tiles): persistent blocks of 8 warps over 128-row tiles, as many as the
// card holds at once:
//   * W1, W2 (nn.Linear [W, H]) are staged once a block as bf16 [WK][HS]
//     and W3 ([H, W]) as [HK][WS], zero-padded; rows padded by 16 bytes
//     to an odd multiple of 16, so the 8 row addresses of an ldmatrix fall
//     in 8 distinct bank groups;
//   * thread t < 128 of a block loads row t of the tile with 16-byte loads
//     (H >= 8; 2H-byte rows below), runs both RMS norms in registers,
//     writes the normalised row n to a [TM][HS] tile and keeps x for the
//     residual;
//   * warp w runs rows 16w..16w+15 through the products, 16 middle
//     columns at a time: a1 and a2 against ldmatrix'd W1 and W2 fragments,
//     bias, act and gate on the accumulator fragments, and the gated
//     fragments straight from registers as the A operand of the W3
//     product (two m16n8 accumulators are one m16k16 A fragment), so the
//     middle never leaves registers;
//   * the fp32 sums of y go through shared memory back to the row's
//     thread, which adds b3 and the residual and stores the row.

#include "ffn_small.cuh"

namespace {

using namespace tc;
using namespace ffns;

// shared memory, in bytes
constexpr int SZ_W12 = WK * HS * 2;  // W1 or W2 [WK][HS]
constexpr int OFF_W1 = 0, OFF_W2 = SZ_W12;
constexpr int OFF_W3 = 2 * SZ_W12;          // W3 [HK][WS]
constexpr int OFF_N = OFF_W3 + HK * WS * 2;  // n tile [TM][HS]
constexpr int OFF_Y = OFF_N + TM * HS * 2;   // y sums [TM][GS] fp32
constexpr int OFF_VEC = OFF_Y + TM * GS * 4;  // b1, b2 [WK]; b3, scale2, scale [HK] (fp32)
constexpr int V_B1 = 0, V_B2 = WK, V_B3 = 2 * WK, V_S2 = V_B3 + HK, V_S = V_S2 + HK;
constexpr int SMEM = OFF_VEC + (V_S + HK) * 4;
static_assert(SMEM <= 232448, "shared memory of one block");

struct Args {
  const __nv_bfloat16* x;  // [rows, H]
  __nv_bfloat16* y;        // [rows, H]
  const float* scale2;     // norm2 scale [H]
  const float* scale;      // the block's own RMSNorm scale [H]
  const float* w1;         // nn.Linear [W, H]
  const float* b1;         // [W]
  const float* w2;         // [W, H]
  const float* b2;         // [W]
  const float* w3;         // [H, W]
  const float* b3;         // [H]
  long long rows;
  int silu;
};

// templated on the width so that each library's kernel has a name of its own
template <int HH>
__global__ void __launch_bounds__(THREADS) ffn_small_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  __nv_bfloat16 *sW1 = tile(OFF_W1), *sW2 = tile(OFF_W2), *sW3 = tile(OFF_W3);
  __nv_bfloat16* sN = tile(OFF_N);
  float* sY = reinterpret_cast<float*>(smem + OFF_Y);
  float* vec = reinterpret_cast<float*>(smem + OFF_VEC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_weight(sW1, HS, WK, a.w1, W, H, false, tid);
  stage_weight(sW2, HS, WK, a.w2, W, H, false, tid);
  stage_weight(sW3, WS, HK, a.w3, H, W, false, tid);
  zero_tile(sN, HS, tid);
  stage_vec(vec + V_B1, a.b1, W, WK, tid);
  stage_vec(vec + V_B2, a.b2, W, WK, tid);
  stage_vec(vec + V_B3, a.b3, H, HK, tid);
  stage_vec(vec + V_S2, a.scale2, H, HK, tid);
  stage_vec(vec + V_S, a.scale, H, HK, tid);
  __syncthreads();

  const long long tiles = (a.rows + TM - 1) / TM;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    // n = RMS_0(RMS_norm2(x)), a thread a row
    const long long row = t * TM + tid;
    const bool valid = tid < TM && row < a.rows;
    float x[H];
    if (tid < TM) {  // warp-uniform
      load_row(x, a.x + (valid ? row : 0) * H, valid);
      float tv[H], n[H];
      rms_norm(tv, x, vec + V_S2);
      rms_norm(n, tv, vec + V_S);
      put_row(sN + tid * HS, n);
    }
    __syncthreads();

    uint32_t an[HK / 16][4];  // the warp's n rows as A fragments, one per k-step
#pragma unroll
    for (int ks = 0; ks < HK / 16; ++ks) ldsm(an[ks], a_rows(sN, HS, 16 * warp, 16 * ks, lane));
    float y[HK / 8][4];
#pragma unroll
    for (int nt = 0; nt < HK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][e] = 0.f;
#pragma unroll
    for (int c = 0; c < WK / 16; ++c) {
      const int j0 = 16 * c;
      float a1[2][4], a2[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) a1[nt][e] = a2[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HK / 16; ++ks) {
        uint32_t b[4];
        ldsm(b, b_rows(sW1, HS, j0, 16 * ks, lane));
        mma(a1[0], an[ks], b[0], b[1]);
        mma(a1[1], an[ks], b[2], b[3]);
        ldsm(b, b_rows(sW2, HS, j0, 16 * ks, lane));
        mma(a2[0], an[ks], b[0], b[1]);
        mma(a2[1], an[ks], b[2], b[3]);
      }
      // bias, act and gate on the fragments; fg[2nt + half] is row lane/4
      // + 8 half, middle columns j0 + 8nt + 2(lane%4) + {0, 1}: the A
      // fragment of the W3 product's k-step j0 (zero in padded columns:
      // a1 = a2 = 0 there, and act(0) = 0)
      uint32_t fg[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = j0 + 8 * nt + 2 * (lane & 3);
          float g[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float h1 = bf(bf(a1[nt][2 * half + i]) + vec[V_B1 + j + i]);
            const float h2 = bf(bf(a2[nt][2 * half + i]) + vec[V_B2 + j + i]);
            g[i] = bf(bf(ffn::act(h1, a.silu)) * h2);
          }
          fg[2 * nt + half] = bf2_bits(g[0], g[1]);
        }
      // y += g[:, j0..j0+15] W3[:, j0..j0+15]ᵀ
#pragma unroll
      for (int p = 0; p < HK / 16; ++p) {
        uint32_t b[4];
        ldsm(b, b_rows(sW3, WS, 16 * p, j0, lane));
        mma(y[2 * p], fg, b[0], b[1]);
        mma(y[2 * p + 1], fg, b[2], b[3]);
      }
    }
    // the sums back to the rows' threads through shared memory
#pragma unroll
    for (int nt = 0; nt < HK / 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(sY + (16 * warp + (lane >> 2) + 8 * half) * GS + 8 * nt +
                                   2 * (lane & 3)) =
            make_float2(y[nt][2 * half], y[nt][2 * half + 1]);
    __syncthreads();

    // y = bf16(x + bf16(bf16(sum) + b3)), a thread a row
    if (valid) {
      float out[H];
#pragma unroll
      for (int o = 0; o < H; ++o)
        out[o] = bf(x[o] + bf(bf(sY[tid * GS + o]) + vec[V_B3 + o]));
      store_row(a.y + row * H, out);
    }
    __syncthreads();  // sN and sY are the next tile's
  }
}

}  // namespace

// x, y: contiguous bf16 [rows, H] (H = FFN_SMALL_H); every weight and bias
// fp32 on the device, nn.Linear layout ([out, in]). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int ffn_small_fwd(const void* x, void* y, long long rows, const void* scale2,
                             const void* scale, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3, int silu,
                             void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.scale2 = static_cast<const float*>(scale2);
  a.scale = static_cast<const float*>(scale);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.w3 = static_cast<const float*>(w3);
  a.b3 = static_cast<const float*>(b3);
  a.rows = rows;
  a.silu = silu;
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = ffn_small_fwd_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const long long tiles = (rows + TM - 1) / TM;
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < most ? tiles : most);
  kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
