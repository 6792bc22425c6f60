// Gated feed-forward half of the transformer block, forward, for Hopper
// (sm_90a), on the tensor cores.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
// _ffn_fwd_kernel (:74) with pre_norm=True, called by fused_gated_ffn
// (:165) from TransformerBlock. Same function, per row x of [N*B, H]:
//   t  = RMS_norm2(x);  n = RMS_0(t)     (_rms_fwd: bf16 squares, fp32 sum,
//                                         inv = 1/(sqrt(sum+1e-24)/sqrt(H)+1e-8),
//                                         bf16(bf16(v*bf16(inv))*bf16(scale)))
//   a1 = bf16(bf16(n W1) + b1);  a2 = bf16(bf16(n W2) + b2)   (fp32 sums)
//   g  = bf16(bf16(act(a1)) * a2)        (act: exact-erf GELU, or SiLU)
//   y  = bf16(x + bf16(bf16(g W3) + b3))
// with H = 64 and the middle width W = 3H = 192; weights and biases are
// used as bf16 values, as flax Dense(dtype=bf16) uses them. Every bf16
// rounding point is the JAX kernel's; only the order of the fp32 sums
// inside a product differs, and it is fixed, so two calls give the same
// bits.
//
// What bounds it on this card: 3 products of 64 x 192 a row, 73,728 FLOP,
// against 256 bytes (x read, y written). On the transformer slice
// (1,920 nodes x 64 samples = 122,880 rows) that is 9.1 GFLOP and 31.5 MB,
// 0.0092 ms on the bf16 tensor cores (989 TFLOP/s) and 0.0094 ms at 3.35
// TB/s; on the graded slice (27,008 x 16 = 432,128 rows) 31.9 GFLOP and
// 111 MB, 0.032 and 0.033 ms: balanced between bytes and operations. As
// fp32 FMAs on the CUDA cores the products alone would take 0.14 / 0.48
// ms at the 67 TFLOP/s fp32 peak. Besides the products, every middle value
// needs an erff or expf on the CUDA cores: 83M a call at the graded shape.
//
// What the design does about it, after fused_ffn_bwd.cu's design with 3
// products and no weight gradients. All 3 products run as
// mma.sync.m16n8k16 bf16 -> fp32 tiles, in one pass over the rows:
//   * persistent blocks, one per SM, each of 16 warps walking a contiguous
//     range of 128-row tiles; W1 and W2 are staged once per block as bf16
//     [192][72] and W3 (nn.Linear's [64][192]) as [64][200]: rows padded
//     by 16 bytes to an odd multiple of 16, so the 8 row addresses of an
//     ldmatrix fall in 8 distinct bank groups. The weights' 81 KB of
//     shared memory leave room for one block an SM, so the block is wide:
//     of the layouts tried on the card (8 warps over 64 rows, 16 over 64
//     rows split four ways along the middle, 16 over 128 rows) the last
//     hid the latency of the products and of the erff / expf epilogue best
//     at both shapes;
//   * the x tile comes in by cp.async, double-buffered: tile t+1 loads
//     while tile t computes; rows past the end are zero-filled and never
//     stored;
//   * the two RMS norms run four threads a row, the row sums reduced
//     across the quad with shuffles, into an n tile in shared memory;
//   * warp (m, h) owns rows 16m..16m+15 and middle columns 96h..96h+95,
//     16 at a time: a1 and a2 against ldmatrix'd W1 and W2 fragments (the
//     n fragments loaded once a tile), then bias, act and gate on the
//     accumulator fragments as bf16 pairs; the gated fragments are the A operand of the W3 product
//     straight from registers (two m16n8 accumulators are one m16k16 A
//     fragment), so the middle never leaves registers;
//   * the two halves' fp32 sums meet in shared memory (h = 0's plus
//     h = 1's), then one rounding, + b3, the residual, and 16-byte stores,
//     four threads a row.
// Shared memory: 174,208 bytes, one block per SM.

#include "ffn_common.cuh"

namespace {

using namespace tc;
using namespace ffn;

constexpr int THREADS = 512;  // 16 warps: 8 along the rows x 2 along the middle
constexpr int TM = 128;       // rows per tile: THREADS / 4, a quad of threads a row
constexpr int WS = H + 8;     // row stride (bf16) of W1, W2 and of the x and n tiles
constexpr int MS = W + 8;     // row stride (bf16) of W3
constexpr int YS = H + 8;     // row stride (fp32) of the y sums
// shared memory, in bytes
constexpr int SZ_W12 = W * WS * 2;  // W1 or W2 [192][72]
constexpr int SZ_T = TM * WS * 2;   // one [TM][72] tile
constexpr int OFF_W1 = 0, OFF_W2 = SZ_W12;  // W1, W2 [W][H]
constexpr int OFF_W3 = 2 * SZ_W12;          // W3 [H][W]
constexpr int OFF_X = OFF_W3 + H * MS * 2;  // x tile, two stages
constexpr int OFF_N = OFF_X + 2 * SZ_T;     // n tile
constexpr int OFF_Y = OFF_N + SZ_T;         // y sums [TM][72] fp32
constexpr int OFF_VEC = OFF_Y + TM * YS * 4;  // b1, b2, b3, scale2, scale (bf16)
constexpr int V_B1 = 0, V_B2 = W, V_B3 = 2 * W, V_S2 = V_B3 + H, V_S = V_S2 + H;
constexpr int V_TOTAL = V_S + H;
constexpr int SMEM = OFF_VEC + V_TOTAL * 2;
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

__device__ __forceinline__ uint32_t bits(bf2 v) { return *reinterpret_cast<uint32_t*>(&v); }

__global__ void __launch_bounds__(THREADS, 1) ffn_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  __nv_bfloat16 *sW1 = tile(OFF_W1), *sW2 = tile(OFF_W2), *sW3 = tile(OFF_W3);
  __nv_bfloat16* sN = tile(OFF_N);
  float* sY = reinterpret_cast<float*>(smem + OFF_Y);
  __nv_bfloat16* vec = tile(OFF_VEC);
  const bf2* vec2 = reinterpret_cast<const bf2*>(vec);  // the same, as pairs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

#pragma unroll 4
  for (int i = tid; i < W * H; i += THREADS) {
    const int j = i / H, k = i % H;   // W1, W2 [j][k]
    const int o = i / W, m3 = i % W;  // W3 [o][m3]
    sW1[j * WS + k] = __float2bfloat16_rn(a.w1[i]);
    sW2[j * WS + k] = __float2bfloat16_rn(a.w2[i]);
    sW3[o * MS + m3] = __float2bfloat16_rn(a.w3[i]);
  }
  for (int j = tid; j < W; j += THREADS) {
    vec[V_B1 + j] = __float2bfloat16_rn(a.b1[j]);
    vec[V_B2 + j] = __float2bfloat16_rn(a.b2[j]);
  }
  for (int o = tid; o < H; o += THREADS) {
    vec[V_B3 + o] = __float2bfloat16_rn(a.b3[o]);
    vec[V_S2 + o] = __float2bfloat16_rn(a.scale2[o]);
    vec[V_S + o] = __float2bfloat16_rn(a.scale[o]);
  }

  const long long tiles = (a.rows + TM - 1) / TM;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const long long t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  auto load_tile = [&](int stage, long long t) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * THREADS;  // 128 rows x 8 chunks of 16 bytes
      const int r = idx >> 3, ch = idx & 7;
      const long long row = t * TM + r;
      const bool valid = row < a.rows;
      cp_async16(tile(OFF_X + stage * SZ_T) + r * WS + ch * 8,
                 a.x + (valid ? row : 0) * H + ch * 8, valid);
    }
  };

  // the products: rows 16m..16m+15, middle columns 96h..96h+95; the quad
  // layout: row tid/4, columns 16(tid%4)..+15
  const int m = warp & 7, hh = warp >> 3;
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

    // n = RMS_0(RMS_norm2(x)), a quad a row
    {
      bf2 v[8];
      load8(v, sX + qr * WS + qc);
      quad_rms_norm(v, vec2 + (V_S2 + qc) / 2);
      quad_rms_norm(v, vec2 + (V_S + qc) / 2);
      store8(sN + qr * WS + qc, v);
    }
    __syncthreads();

    uint32_t an[H / 16][4];  // the warp's n rows as A fragments, one per k-step
#pragma unroll
    for (int ks = 0; ks < H / 16; ++ks) ldsm(an[ks], a_rows(sN, WS, 16 * m, 16 * ks, lane));
    float y[H / 8][4];
#pragma unroll
    for (int n = 0; n < H / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[n][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < 6; ++c) {
      const int j0 = 96 * hh + 16 * c;
      float a1[2][4], a2[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) a1[n][e] = a2[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        uint32_t b[4];
        ldsm(b, b_rows(sW1, WS, j0, 16 * ks, lane));
        mma(a1[0], an[ks], b[0], b[1]);
        mma(a1[1], an[ks], b[2], b[3]);
        ldsm(b, b_rows(sW2, WS, j0, 16 * ks, lane));
        mma(a2[0], an[ks], b[0], b[1]);
        mma(a2[1], an[ks], b[2], b[3]);
      }
      // bias, act and gate on the fragments; fg[2n + half] is row
      // lane/4 + 8 half, middle columns j0 + 8n + 2(lane%4) + {0, 1}: the
      // A fragment of the W3 product's k-step j0
      uint32_t fg[4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = j0 + 8 * n + 2 * (lane & 3);
          const int e = 2 * half;
          const bf2 h1 = __hadd2_rn(__floats2bfloat162_rn(a1[n][e], a1[n][e + 1]),
                                    vec2[(V_B1 + j) / 2]);
          const bf2 h2 = __hadd2_rn(__floats2bfloat162_rn(a2[n][e], a2[n][e + 1]),
                                    vec2[(V_B2 + j) / 2]);
          const float2 hf = __bfloat1622float2(h1);
          const bf2 act1 = __floats2bfloat162_rn(act(hf.x, a.silu), act(hf.y, a.silu));
          fg[2 * n + half] = bits(__hmul2_rn(act1, h2));
        }
      // y += g[:, j0..j0+15] W3[:, j0..j0+15]ᵀ
#pragma unroll
      for (int p = 0; p < H / 16; ++p) {
        uint32_t b[4];
        ldsm(b, b_rows(sW3, MS, 16 * p, j0, lane));
        mma(y[2 * p], fg, b[0], b[1]);
        mma(y[2 * p + 1], fg, b[2], b[3]);
      }
    }
    // the two middle halves' sums meet in shared memory: h = 0's plus h = 1's
    float* yrow = sY + (16 * m + (lane >> 2)) * YS + 2 * (lane & 3);  // row lane/4, n-tile 0
    if (hh == 1) {
#pragma unroll
      for (int n = 0; n < H / 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(yrow + 8 * half * YS + 8 * n) =
              make_float2(y[n][2 * half], y[n][2 * half + 1]);
    }
    __syncthreads();
    if (hh == 0) {
#pragma unroll
      for (int n = 0; n < H / 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* p = reinterpret_cast<float2*>(yrow + 8 * half * YS + 8 * n);
          const float2 o = *p;
          *p = make_float2(y[n][2 * half] + o.x, y[n][2 * half + 1] + o.y);
        }
    }
    __syncthreads();

    // y = bf16(x + bf16(bf16(sum) + b3)), a quad a row, 16-byte stores
    const long long row = t * TM + qr;
    if (row < a.rows) {
      bf2 xv[8];
      load8(xv, sX + qr * WS + qc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 f = *reinterpret_cast<const float2*>(sY + qr * YS + qc + 2 * i);
        const bf2 z = __hadd2_rn(__floats2bfloat162_rn(f.x, f.y), vec2[(V_B3 + qc) / 2 + i]);
        xv[i] = __hadd2_rn(xv[i], z);
      }
      store8(a.y + row * H + qc, xv);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n");
}

}  // namespace

// x, y: contiguous bf16 [rows, 64]; every weight and bias fp32 on the
// device, nn.Linear layout ([out, in]). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int ffn_fwd(const void* x, void* y, long long rows, const void* scale2,
                       const void* scale, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* w3, const void* b3, int silu, void* stream) {
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
  cudaError_t err =
      cudaFuncSetAttribute(ffn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const long long tiles = (rows + TM - 1) / TM;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  ffn_fwd_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
