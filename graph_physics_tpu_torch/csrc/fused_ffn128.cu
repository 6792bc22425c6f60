// Gated feed-forward half of the transformer block at hidden 128, forward,
// for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
// _ffn_fwd_kernel (:74) with pre_norm=True at hidden 128 (the panels
// workload, training_config/panels.json), called by fused_gated_ffn (:165)
// from TransformerBlock. The function and every bf16 rounding point are
// fused_ffn.cu's, per row x of [N*B, H] with H = 128 and the middle width
// W = 3H = 384:
//   t = RMS_norm2(x);  n = RMS_0(t);  a1 = bf16(bf16(n W1) + b1);
//   a2 = bf16(bf16(n W2) + b2);  g = bf16(bf16(act(a1)) * a2);
//   y = bf16(x + bf16(bf16(g W3) + b3)).
// Only the order of the fp32 sums inside a product differs from the JAX
// kernel's, and it is fixed, so two calls give the same bits.
//
// What bounds it on this card: 3 products of 128 x 384 a row, 294,912
// FLOP, against 512 bytes (x read, y written). At panels' shape (1,920
// nodes x 64 samples = 122,880 rows) that is 36.2 GFLOP, 0.0366 ms on the
// bf16 tensor cores (989 TFLOP/s), and 62.9 MB, 0.0188 ms at 3.35 TB/s:
// bound by operations.
//
// Why fused_ffn.cu's design does not carry over: it keeps W1, W2 and W3
// resident in shared memory; at H = 128 the three padded bf16 weights take
// 309 KB, more than a block's 227 KB. So the middle is streamed:
//   * a first kernel stages the weights once a call as bf16 in global
//     memory, in 6 chunks of 64 middle columns, each chunk one contiguous
//     53,248-byte run: W1 and W2 rows [64][136] and W3's matching columns
//     [128][72] (rows padded by 16 bytes to an odd multiple of 16, so the 8
//     row addresses of an ldmatrix fall in 8 distinct bank groups);
//   * persistent blocks, one per SM, of 8 warps each walking a contiguous
//     range of 128-row tiles, warp w owning rows 16w..16w+15 of a tile;
//   * the chunks stream through two shared-memory stages by cp.async: chunk
//     c+1 (or the next tile's chunk 0, with its x tile) loads while chunk
//     c computes; the staged weights, 295 KB, stay in L2;
//   * the two RMS norms run four threads a row, inside the warp that owns
//     the row; the warp then holds its n rows as A fragments (32
//     registers) for the whole tile;
//   * per chunk and 16 middle columns: a1 and a2 against ldmatrix'd W1 and
//     W2 fragments, bias, act and gate on the accumulator fragments as bf16
//     pairs, and the gated fragments straight from registers as the A
//     operand of the W3 product (two m16n8 accumulators are one m16k16 A
//     fragment), so the middle never leaves registers;
//   * y stays in fp32 registers across the 6 chunks (64 a thread); at the
//     tile's end + b3 and the residual round into the x tile in place, and
//     the warp stores its 16 rows with 16-byte stores.
// Shared memory: 213,248 bytes, one block per SM.

#include "ffn_wide.cuh"

namespace {

using namespace tc;
using namespace ffnw;

constexpr int MS3 = C + 8;  // row stride (bf16) of a chunk's W3 columns [H][C]
// one chunk, in bf16 elements: W1 rows [C][XS], W2 rows [C][XS], W3 columns [H][MS3]
constexpr int CH_W2 = C * XS, CH_W3 = 2 * C * XS, CHUNK = 2 * C * XS + H * MS3;
constexpr int PIECES = CHUNK / 8;  // 16-byte pieces a chunk
// shared memory, in bytes
constexpr int SZ_T = TM * XS * 2;               // one [TM][XS] tile
constexpr int OFF_WS = 0;                       // two chunk stages
constexpr int OFF_X = OFF_WS + 2 * CHUNK * 2;   // x tile, two stages
constexpr int OFF_N = OFF_X + 2 * SZ_T;         // n tile
constexpr int OFF_VEC = OFF_N + SZ_T;           // b1, b2, b3, scale2, scale (bf16)
constexpr int V_B1 = 0, V_B2 = W, V_B3 = 2 * W, V_S2 = V_B3 + H, V_S = V_S2 + H;
constexpr int V_TOTAL = V_S + H;
constexpr int SMEM = OFF_VEC + V_TOTAL * 2;
static_assert(SMEM <= 232448, "shared memory of one block");
static_assert(CHUNK % 8 == 0 && (CH_W3 * 2) % 16 == 0, "16-byte pieces");

struct Args {
  const __nv_bfloat16* x;   // [rows, H]
  __nv_bfloat16* y;         // [rows, H]
  __nv_bfloat16* wst;       // staged weights [NC][CHUNK]
  const float* scale2;      // norm2 scale [H]
  const float* scale;       // the block's own RMSNorm scale [H]
  const float* w1;          // nn.Linear [W, H]
  const float* b1;          // [W]
  const float* w2;          // [W, H]
  const float* b2;          // [W]
  const float* w3;          // [H, W]
  const float* b3;          // [H]
  long long rows;
  int silu;
};

// the weights as bf16 chunks (zero padding)
__global__ void __launch_bounds__(THREADS) ffn128_stage_kernel(const Args a) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= NC * CHUNK) return;
  const int c = e / CHUNK, r = e % CHUNK;
  float v = 0.f;
  if (r < CH_W3) {
    const int j = c * C + (r % CH_W2) / XS, k = (r % CH_W2) % XS;
    if (k < H) v = (r < CH_W2 ? a.w1 : a.w2)[j * H + k];
  } else {
    const int o = (r - CH_W3) / MS3, m = (r - CH_W3) % MS3;
    if (m < C) v = a.w3[o * W + c * C + m];
  }
  a.wst[e] = __float2bfloat16_rn(v);
}

__global__ void __launch_bounds__(THREADS, 1) ffn128_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  __nv_bfloat16* sN = tile(OFF_N);
  __nv_bfloat16* vec = tile(OFF_VEC);
  const bf2* vec2 = reinterpret_cast<const bf2*>(vec);  // the same, as pairs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

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
  if (t0 >= t1) return;
  auto load_chunk = [&](int stage, int c) {
    copy_pieces(tile(OFF_WS + stage * CHUNK * 2), a.wst + c * CHUNK, PIECES, tid);
  };
  auto x_tile = [&](long long t) { return tile(OFF_X + static_cast<int>((t - t0) & 1) * SZ_T); };

  load_rows(x_tile(t0), a.x, t0 * TM, a.rows, tid);
  load_chunk(0, 0);
  asm volatile("cp.async.commit_group;\n");
  int step = 0;  // chunk steps so far: the stage of this one is step & 1
  uint32_t an[H / 16][4];  // the warp's n rows as A fragments, one per k-step
  float y[H / 8][4];
  for (long long t = t0; t < t1; ++t) {
    __nv_bfloat16* sX = x_tile(t);
    for (int c = 0; c < NC; ++c, ++step) {
      const int ws = step & 1;
      if (c + 1 < NC) {
        load_chunk(ws ^ 1, c + 1);
      } else if (t + 1 < t1) {
        load_chunk(ws ^ 1, 0);
        load_rows(x_tile(t + 1), a.x, (t + 1) * TM, a.rows, tid);
      }
      asm volatile("cp.async.commit_group;\n");
      asm volatile("cp.async.wait_group 1;\n");
      __syncthreads();
      const __nv_bfloat16* sW1 = tile(OFF_WS + ws * CHUNK * 2);
      const __nv_bfloat16* sW2 = sW1 + CH_W2;
      const __nv_bfloat16* sW3 = sW1 + CH_W3;

      if (c == 0) {
        // n = RMS_0(RMS_norm2(x)), a quad a row, the warp's own rows
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          const int qr = 16 * warp + 8 * pass + (lane >> 2), qc = (lane & 3) * 32;
          bf2 v[16];
          load16(v, sX + qr * XS + qc);
          quad_rms_norm(v, vec2 + (V_S2 + qc) / 2);
          quad_rms_norm(v, vec2 + (V_S + qc) / 2);
          store16(sN + qr * XS + qc, v);
        }
        __syncwarp();
#pragma unroll
        for (int ks = 0; ks < H / 16; ++ks) ldsm(an[ks], a_rows(sN, XS, 16 * warp, 16 * ks, lane));
#pragma unroll
        for (int n = 0; n < H / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[n][e] = 0.f;
      }

#pragma unroll 1
      for (int sub = 0; sub < C / 16; ++sub) {
        const int j0 = 16 * sub;  // local middle column of the chunk
        float a1[2][4], a2[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) a1[n][e] = a2[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < H / 16; ++ks) {
          uint32_t b[4];
          ldsm(b, b_rows(sW1, XS, j0, 16 * ks, lane));
          mma(a1[0], an[ks], b[0], b[1]);
          mma(a1[1], an[ks], b[2], b[3]);
          ldsm(b, b_rows(sW2, XS, j0, 16 * ks, lane));
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
            const int j = c * C + j0 + 8 * n + 2 * (lane & 3);
            const int e = 2 * half;
            const bf2 h1 = __hadd2_rn(__floats2bfloat162_rn(a1[n][e], a1[n][e + 1]),
                                      vec2[(V_B1 + j) / 2]);
            const bf2 h2 = __hadd2_rn(__floats2bfloat162_rn(a2[n][e], a2[n][e + 1]),
                                      vec2[(V_B2 + j) / 2]);
            const float2 hf = __bfloat1622float2(h1);
            const bf2 act1 =
                __floats2bfloat162_rn(ffn::act(hf.x, a.silu), ffn::act(hf.y, a.silu));
            fg[2 * n + half] = bits(__hmul2_rn(act1, h2));
          }
        // y += g[:, j0..j0+15] W3[:, j0..j0+15]ᵀ
#pragma unroll
        for (int p = 0; p < H / 16; ++p) {
          uint32_t b[4];
          ldsm(b, b_rows(sW3, MS3, 16 * p, j0, lane));
          mma(y[2 * p], fg, b[0], b[1]);
          mma(y[2 * p + 1], fg, b[2], b[3]);
        }
      }

      if (c == NC - 1) {
        // y = bf16(x + bf16(bf16(sum) + b3)) into the x tile, the warp's
        // rows, then 16-byte stores
#pragma unroll
        for (int n = 0; n < H / 8; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * warp + (lane >> 2) + 8 * half;
            const int col = 8 * n + 2 * (lane & 3);
            bf2* px = reinterpret_cast<bf2*>(sX + r * XS + col);
            const bf2 z = __hadd2_rn(__floats2bfloat162_rn(y[n][2 * half], y[n][2 * half + 1]),
                                     vec2[(V_B3 + col) / 2]);
            *px = __hadd2_rn(*px, z);
          }
        __syncwarp();
        store_warp_rows(a.y, sX, t * TM, a.rows, warp, lane);
      }
      __syncthreads();
    }
  }
  asm volatile("cp.async.wait_group 0;\n");
}

}  // namespace

// x, y: contiguous bf16 [rows, 128]; wst: bf16 scratch of ffn128_fwd_stage
// elements; every weight and bias fp32 on the device, nn.Linear layout
// ([out, in]). Returns the CUDA error code of the launches (0 on success).
extern "C" int ffn128_fwd_stage() { return NC * CHUNK; }

extern "C" int ffn128_fwd(const void* x, void* y, void* wst, long long rows, const void* scale2,
                          const void* scale, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* w3, const void* b3, int silu,
                          void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.wst = static_cast<__nv_bfloat16*>(wst);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(ffn128_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  ffn128_stage_kernel<<<(NC * CHUNK + THREADS - 1) / THREADS, THREADS, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (rows + TM - 1) / TM;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  ffn128_fwd_kernel<<<grid, THREADS, SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
