// Helpers shared by the GraphNetBlock kernels, forward and backward, on the
// NK slot layout (fused_gnblock_nk*.cu) and on the CSR layout
// (fused_gnblock_csr*.cu): the widths, the MLP parameters as the C
// interfaces pass them, the fp32 gradient layout of an MLP, bf16 rounding,
// the row loads and stores of the backward's sender pass (on the CUDA
// cores) and the grid size of a striding kernel. The MLPs' products run on
// tensor-core tiles (gn_tile.cuh).
//
// Those sources are built once a hidden width, nvcc -DGN_SMALL_H=h for
// h = 1, 2, 4, 8, 16 (ops/kernel_build.py: FLAGS) and without the flag
// for 32; the wide kernels (gn_wide.cuh) share the MLP parameters.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GN_SMALL_H
#define GN_SMALL_H 32
#endif

namespace gn_nk {

constexpr int H = GN_SMALL_H;  // hidden width
static_assert(H == 1 || H == 2 || H == 4 || H == 8 || H == 16 || H == 32,
              "the GraphNetBlock tile kernels are built for hidden 1 to 32");
constexpr int MAXL = 8;  // most Dense layers per MLP

struct Mlp {
  const float* w[MAXL];  // nn.Linear weights [out, in], fp32
  const float* b[MAXL];  // biases [out]
  const float* scale;    // RMSNorm scale [H], or null without a norm
  int n_layers;
  int in_dim;
  int parts;  // layer 0's input: ``parts`` blocks of in_dim / parts columns
  int act;    // the activation between layers (act_common.cuh: mlp_act::Kind)
};

// floats one MLP's fp32 gradients take staged in shared memory
// (gn_bwd_common.cuh:grad_slot): [in][H] W0, b0, then [H][H] W_l and b_l
// per further layer, then the scale
__host__ __device__ inline int mlp_floats(const Mlp& m) {
  return m.in_dim * H + H + (m.n_layers - 1) * (H * H + H) + (m.scale ? H : 0);
}

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load_row(float (&v)[H], const __nv_bfloat16* src) {
  if constexpr (H % 8 != 0) {  // rows of 2 to 8 bytes: one value at a time
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int o = 0; o < H; ++o) v[o] = __uint_as_float(static_cast<uint32_t>(__ldg(s + o)) << 16);
    return;
  }
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
  if constexpr (H % 8 != 0) {
#pragma unroll
    for (int o = 0; o < H; ++o) dst[o] = __float2bfloat16_rn(v[o]);
    return;
  }
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

// one MLP from 2 * n_layers + 1 pointers: w0, b0, w1, b1, ..., then the
// RMSNorm scale (null without a norm); layer 0's input in ``parts`` blocks
// of in_dim / parts columns (the edge MLP's e, x_r, x_s; the node MLP's x,
// agg), ``act`` its activation
inline bool make_mlp(Mlp* m, const void* const* p, int n_layers, int in_dim, int parts = 1,
                     int act = 0) {
  if (n_layers < 1 || n_layers > MAXL || act < 0 || act > 2) return false;
  m->parts = parts;
  m->act = act;
  for (int l = 0; l < MAXL; ++l) {
    m->w[l] = l < n_layers ? static_cast<const float*>(p[2 * l]) : nullptr;
    m->b[l] = l < n_layers ? static_cast<const float*>(p[2 * l + 1]) : nullptr;
  }
  m->scale = static_cast<const float*>(p[2 * n_layers]);
  m->n_layers = n_layers;
  m->in_dim = in_dim;
  return true;
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
