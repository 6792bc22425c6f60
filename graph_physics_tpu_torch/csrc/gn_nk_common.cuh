// Helpers shared by the GraphNetBlock kernels, forward and backward, on the
// NK slot layout (fused_gnblock_nk*.cu) and on the CSR layout
// (fused_gnblock_csr*.cu): the MLP weight layout in shared memory, bf16
// rounding, row loads and stores, the forward MLP numerics of the JAX
// kernel's _mlp_fwd/_rms_fwd (bf16 values between layers, fp32
// accumulation, fp32 RMS statistics of bf16 squares), the folded edge
// encoder, the node pre-pass of the GraphNetBlock kernels (both layouts,
// forward and backward) and the grid size of a striding kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn_nk {

constexpr int H = 32;     // hidden width
constexpr int MAXL = 8;   // most Dense layers per MLP

struct Mlp {
  const float* w[MAXL];  // nn.Linear weights [out, in], fp32
  const float* b[MAXL];  // biases [out]
  const float* scale;    // RMSNorm scale [H], or null without a norm
  int n_layers;
  int in_dim;
};

// floats one MLP takes in shared memory: [in][H] W0, b0, then [H][H] W_l
// and b_l per further layer, then the scale
__host__ __device__ inline int mlp_floats(const Mlp& m) {
  return m.in_dim * H + H + (m.n_layers - 1) * (H * H + H) + (m.scale ? H : 0);
}

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// stage one MLP into shared memory, transposed to [in][out] and rounded to
// bf16 values (the weights are used as bf16, as flax Dense(dtype=bf16))
__device__ inline void stage_mlp(float* dst, const Mlp& m) {
  for (int l = 0; l < m.n_layers; ++l) {
    const int rows = l == 0 ? m.in_dim : H;
    const float* w = m.w[l];
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H, o = i % H;
      dst[i] = bf(w[o * rows + r]);
    }
    dst += rows * H;
    for (int o = threadIdx.x; o < H; o += blockDim.x) dst[o] = bf(m.b[l][o]);
    dst += H;
  }
  if (m.scale)
    for (int o = threadIdx.x; o < H; o += blockDim.x) dst[o] = bf(m.scale[o]);
}

// acc[o] += v * W[o] for one input value against one weight row in smem
__device__ __forceinline__ void fma_row(float (&acc)[H], float v, const float* wrow) {
  const float4* w4 = reinterpret_cast<const float4*>(wrow);
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 w = w4[q];
    acc[4 * q + 0] = fmaf(v, w.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v, w.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v, w.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v, w.w, acc[4 * q + 3]);
  }
}

// acc += row @ W for one H-wide bf16 row in device memory (64-byte aligned)
__device__ __forceinline__ void fma_global_row(float (&acc)[H], const __nv_bfloat16* src,
                                               const float* w) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < H / 8; ++c) {
    const uint4 u = __ldg(s + c);
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      fma_row(acc, __uint_as_float(wd[q] << 16), w + (8 * c + 2 * q) * H);
      fma_row(acc, __uint_as_float(wd[q] & 0xffff0000u), w + (8 * c + 2 * q + 1) * H);
    }
  }
}

__device__ __forceinline__ void load_row(float (&v)[H], const __nv_bfloat16* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < H / 8; ++c) {
    const uint4 u = __ldg(s + c);
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[8 * c + 2 * q] = __uint_as_float(wd[q] << 16);
      v[8 * c + 2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
    }
  }
}

// store v rounded to bf16 (round to nearest even)
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float (&v)[H]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int c = 0; c < H / 8; ++c) {
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

__device__ __forceinline__ void zero(float (&v)[H]) {
#pragma unroll
  for (int o = 0; o < H; ++o) v[o] = 0.f;
}

// h = bf16(bf16(acc) + bias): a Dense output in bf16
__device__ __forceinline__ void finish(float (&h)[H], const float (&acc)[H], const float* bias) {
#pragma unroll
  for (int o = 0; o < H; ++o) h[o] = bf(bf(acc[o]) + bias[o]);
}

__device__ __forceinline__ void rms_norm(float (&h)[H], const float* scale) {
  float gs = 0.f;
#pragma unroll
  for (int o = 0; o < H; ++o) gs += bf(h[o] * h[o]);
  const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
  const float inv = bf(1.0f / (rms + 1e-8f));
#pragma unroll
  for (int o = 0; o < H; ++o) h[o] = bf(bf(h[o] * inv) * scale[o]);
}

// layers 1..n-1 (relu between layers) and the optional RMSNorm tail; h holds
// layer 0's output, w points at layer 1's weights in shared memory
__device__ __forceinline__ void mlp_tail(float (&h)[H], const float* w, int n_layers,
                                         bool norm) {
  for (int l = 1; l < n_layers; ++l) {
    float acc[H];
    zero(acc);
#pragma unroll
    for (int i = 0; i < H; ++i) fma_row(acc, fmaxf(h[i], 0.f), w + i * H);
    w += H * H;
    finish(h, acc, w);
    w += H;
  }
  if (norm) rms_norm(h, w);
}

// the folded edge encoder's first-layer product on one raw row
__device__ __forceinline__ void enc_first(float (&acc)[H], const __nv_bfloat16* raw, int fe,
                                          const float* s_enc) {
  zero(acc);
  for (int i = 0; i < fe; ++i) fma_row(acc, __bfloat162float(raw[i]), s_enc + i * H);
}

// the folded encoder's output on one raw row (the forward's e_in)
__device__ __forceinline__ void encode(float (&ein)[H], const __nv_bfloat16* raw, int fe,
                                       const float* s_enc, int n_layers, bool norm) {
  float acc[H];
  enc_first(acc, raw, fe, s_enc);
  finish(ein, acc, s_enc + fe * H);
  mlp_tail(ein, s_enc + fe * H + H, n_layers, norm);
}

// one MLP from 2 * n_layers + 1 pointers: w0, b0, w1, b1, ..., then the
// RMSNorm scale (null without a norm)
inline bool make_mlp(Mlp* m, const void* const* p, int n_layers, int in_dim) {
  if (n_layers < 1 || n_layers > MAXL) return false;
  for (int l = 0; l < MAXL; ++l) {
    m->w[l] = l < n_layers ? static_cast<const float*>(p[2 * l]) : nullptr;
    m->b[l] = l < n_layers ? static_cast<const float*>(p[2 * l + 1]) : nullptr;
  }
  m->scale = static_cast<const float*>(p[2 * n_layers]);
  m->n_layers = n_layers;
  m->in_dim = in_dim;
  return true;
}

// two values rounded to bf16 and packed into one register (low, high)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (__float_as_uint(bf(lo)) >> 16) | (__float_as_uint(bf(hi)) & 0xffff0000u);
}

constexpr int PARTIAL_THREADS = 128;

// The GraphNetBlock kernels' node pre-pass, of both layouts: out[t] =
// bf16(x[t] @ K) for every (node, sample) row t, K the rows col..col+H-1
// of the edge MLP's first layer (w0: nn.Linear [H, 3H]; col = H for the
// receiver part Kr, 2H for the sender part Ks), so a node's partial is a
// 64-byte row load per edge (fused_gnblock.py:blocked_reference rounds
// x @ Kr and x @ Ks per node too, as fused_gnblock_nk.py:_edge_fwd does).
__global__ void __launch_bounds__(PARTIAL_THREADS)
    gn_partial_kernel(const __nv_bfloat16* x, __nv_bfloat16* out, const float* w0,
                      long long total, int col) {
  __shared__ __align__(16) float s_k[H * H];
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    const int r = i / H, o = i % H;
    s_k[i] = bf(w0[o * 3 * H + col + r]);
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    float acc[H];
    zero(acc);
    fma_global_row(acc, x + t * H, s_k);
    store_row(out + t * H, acc);
  }
}

// a grid of at most as many blocks of ``threads`` as fit on the card at
// once, each striding over the work (each block stages the weights once)
inline cudaError_t grid_for(const void* kernel, int threads, size_t smem, long long total,
                            int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (total + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * per_sm;
  *grid = static_cast<int>(need < cap ? need : cap);
  return cudaSuccess;
}

}  // namespace gn_nk
