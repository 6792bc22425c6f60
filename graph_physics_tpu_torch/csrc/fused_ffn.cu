// Gated feed-forward half of the transformer block, forward, for Hopper
// (sm_90a).
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
// used as bf16 values, as flax Dense(dtype=bf16) uses them.
//
// What bounds it on this card: the transformer slice (1,920 nodes x 64
// samples = 122,880 rows) does 3 x 64 x 192 multiply-adds a row, 9.1 GFLOP
// a block, and moves one read and one write of x, 31.5 MB. On bf16 tensor
// cores both would take ~0.0094 ms. This first version runs the products
// as fp32 FMAs on the CUDA cores, which cannot beat ~0.135 ms (67 TFLOP/s);
// mma.sync or wgmma tiles are later work.
//
// What the design does about it: the TPU's kron I(x)W weight packing is
// left behind. All weights (bf16 values held as fp32, 146 KB) are staged
// once per block in shared memory, one block of 256 threads per SM that
// walks over the rows; one thread owns a row. The normalised row stays in
// registers as 32 packed bf16 pairs, the output as 64 fp32 sums, and the
// 192-wide middle is produced 8 columns at a time: each chunk's a1, a2
// columns are finished, gated and folded into the output at once, so the
// middle never leaves registers. Weight reads are float4 broadcasts from
// shared memory, one load feeding four FMAs.

#include "ffn_common.cuh"

namespace {

using ffn::act;
using ffn::bf;
using ffn::H;
using ffn::load_row;
using ffn::pack2;
using ffn::rms_norm;
using ffn::THREADS;
using ffn::W;

constexpr int CH = 8;          // middle columns per chunk
constexpr int NC = W / CH;     // chunks
// shared memory, in floats: [H][NC][2*CH] W1|W2 chunks, [W][H] W3, biases, scales
constexpr int OFF_W3 = H * W * 2;
constexpr int OFF_B1 = OFF_W3 + W * H;
constexpr int OFF_B2 = OFF_B1 + W;
constexpr int OFF_B3 = OFF_B2 + W;
constexpr int OFF_S2 = OFF_B3 + H;
constexpr int OFF_S = OFF_S2 + H;
constexpr int SMEM_FLOATS = OFF_S + H;

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

__global__ void __launch_bounds__(THREADS, 1) ffn_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < H * W; i += blockDim.x) {
    // i = (input row r, middle column j) of the W1|W2 chunk table
    const int r = i / W, j = i % W;
    const int c = j / CH, jj = j % CH;
    float* dst = smem + (r * NC + c) * 2 * CH + jj;
    dst[0] = bf(a.w1[j * H + r]);
    dst[CH] = bf(a.w2[j * H + r]);
    const int o = i % H, m = i / H;  // W3 as [m][o]
    smem[OFF_W3 + m * H + o] = bf(a.w3[o * W + m]);
  }
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    smem[OFF_B1 + j] = bf(a.b1[j]);
    smem[OFF_B2 + j] = bf(a.b2[j]);
  }
  for (int o = threadIdx.x; o < H; o += blockDim.x) {
    smem[OFF_B3 + o] = bf(a.b3[o]);
    smem[OFF_S2 + o] = bf(a.scale2[o]);
    smem[OFF_S + o] = bf(a.scale[o]);
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < a.rows;
       t += stride) {
    uint32_t npk[H / 2];  // the normalised row, two bf16 values a register
    {
      float v[H];
      load_row(v, a.x + t * H);
      rms_norm(v, smem + OFF_S2);
      rms_norm(v, smem + OFF_S);
#pragma unroll
      for (int i = 0; i < H / 2; ++i) npk[i] = pack2(v[2 * i], v[2 * i + 1]);
    }

    float out[H];
#pragma unroll
    for (int o = 0; o < H; ++o) out[o] = 0.f;

#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      float a1[CH], a2[CH];
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) a1[jj] = a2[jj] = 0.f;
      const float* wc = smem + c * 2 * CH;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float nv = (i & 1) ? __uint_as_float(npk[i / 2] & 0xffff0000u)
                                 : __uint_as_float(npk[i / 2] << 16);
        const float4* w4 = reinterpret_cast<const float4*>(wc + i * NC * 2 * CH);
#pragma unroll
        for (int q = 0; q < CH / 4; ++q) {
          const float4 p = w4[q];
          a1[4 * q + 0] = fmaf(nv, p.x, a1[4 * q + 0]);
          a1[4 * q + 1] = fmaf(nv, p.y, a1[4 * q + 1]);
          a1[4 * q + 2] = fmaf(nv, p.z, a1[4 * q + 2]);
          a1[4 * q + 3] = fmaf(nv, p.w, a1[4 * q + 3]);
          const float4 r = w4[CH / 4 + q];
          a2[4 * q + 0] = fmaf(nv, r.x, a2[4 * q + 0]);
          a2[4 * q + 1] = fmaf(nv, r.y, a2[4 * q + 1]);
          a2[4 * q + 2] = fmaf(nv, r.z, a2[4 * q + 2]);
          a2[4 * q + 3] = fmaf(nv, r.w, a2[4 * q + 3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = c * CH + jj;
        const float h1 = bf(bf(a1[jj]) + smem[OFF_B1 + j]);
        const float h2 = bf(bf(a2[jj]) + smem[OFF_B2 + j]);
        const float g = bf(bf(act(h1, a.silu)) * h2);
        const float4* w4 = reinterpret_cast<const float4*>(smem + OFF_W3 + j * H);
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 p = w4[q];
          out[4 * q + 0] = fmaf(g, p.x, out[4 * q + 0]);
          out[4 * q + 1] = fmaf(g, p.y, out[4 * q + 1]);
          out[4 * q + 2] = fmaf(g, p.z, out[4 * q + 2]);
          out[4 * q + 3] = fmaf(g, p.w, out[4 * q + 3]);
        }
      }
    }

    float xv[H];
    load_row(xv, a.x + t * H);
    uint4* d = reinterpret_cast<uint4*>(a.y + t * H);
#pragma unroll
    for (int c = 0; c < H / 8; ++c) {
      uint32_t wd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = 8 * c + 2 * q;
        const float lo = bf(xv[o] + bf(bf(out[o]) + smem[OFF_B3 + o]));
        const float hi = bf(xv[o + 1] + bf(bf(out[o + 1]) + smem[OFF_B3 + o + 1]));
        wd[q] = pack2(lo, hi);
      }
      d[c] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
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
  const size_t smem = sizeof(float) * SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const long long need = (rows + THREADS - 1) / THREADS;
  const int grid = static_cast<int>(need < sms ? need : sms);
  ffn_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
