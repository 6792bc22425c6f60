// Helpers shared by the GraphNetBlock backward kernels on the NK slot layout
// (fused_gnblock_nk_bwd.cu) and on the CSR layout (fused_gnblock_csr_bwd.cu)
// that run on the CUDA cores: the sender pass's H x H products and its
// weight gradients reduced per warp in shared memory, and the fixed-order
// sum of the blocks' gradient partials into the global fp32 gradients.
//
// Weight gradients of the sender pass: a warp is 32 rows; each row's
// (activation, cotangent) pair is staged in a per-warp shared buffer, then
// lane o sums column o of the outer products over the 32 rows (one float4
// broadcast feeds four FMAs) and adds the 32-row partial into the warp's
// own fp32 accumulator in shared memory. Every lane of a warp must call
// the staging helpers together, so the pass runs warp-uniform loops and
// gives idle lanes zero cotangents.
//
// No atomics: each block writes its sums to its own slot of a partials
// buffer, and reduce_mlp_kernel / reduce_send_kernel add the slots in block
// order, so a backward gives the same bits on every call.
#pragma once

#include "gn_nk_common.cuh"

namespace gn_bwd {

using namespace gn_nk;

constexpr int NL = 4;  // Dense layers per MLP of the NL instances (gn_bwd_passes.cuh)
// per warp: activations transposed [H][32], cotangents [32][H + 1]
constexpr int STAGE_G = H * 32;
constexpr int STAGE = H * 32 + 32 * (H + 1);
// floats of an H x H matrix in the sender pass's shared memory, a multiple
// of 4 (16 bytes) so that the buffers after it stay aligned
constexpr int SQ = (H * H + 3) / 4 * 4;

// sum_o g[o] * W[o] for one weight row in shared memory
__device__ __forceinline__ float dot_row(const float (&g)[H], const float* wrow) {
  float s = 0.f;
  if constexpr (H % 4 != 0) {
#pragma unroll
    for (int o = 0; o < H; ++o) s = fmaf(g[o], wrow[o], s);
    return s;
  }
  const float4* w4 = reinterpret_cast<const float4*>(wrow);
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 w = w4[q];
    s = fmaf(g[4 * q + 0], w.x, s);
    s = fmaf(g[4 * q + 1], w.y, s);
    s = fmaf(g[4 * q + 2], w.z, s);
    s = fmaf(g[4 * q + 3], w.w, s);
  }
  return s;
}

// stage_cols writes each lane's cotangent row into the warp's buffer and
// hands lane o < H column o (gcol[l] = row l's value o; lanes past H get
// zeros).
__device__ __forceinline__ void stage_cols(float* st, const float (&g)[H], float (&gcol)[32]) {
  const int lane = threadIdx.x & 31;
  float* sg = st + STAGE_G;
#pragma unroll
  for (int o = 0; o < H; ++o) sg[lane * (H + 1) + o] = g[o];
  __syncwarp();
#pragma unroll
  for (int l = 0; l < 32; ++l) gcol[l] = lane < H ? sg[l * (H + 1) + lane] : 0.f;
  __syncwarp();
}

__device__ __forceinline__ void stage_rows_global(float* st, const __nv_bfloat16* src, int rows) {
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < rows; ++i) st[i * 32 + lane] = __bfloat162float(src[i]);
  __syncwarp();
}

// dW[i][o] += sum over the warp's 32 rows of a[i] * g[o], lane o < H
// owning column o of the warp's own accumulator dw; the staged activations
// are read as float4 broadcasts
__device__ __forceinline__ void outer(float* st, const float (&gcol)[32], int rows, float* dw) {
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < rows; ++i) {
    const float4* a4 = reinterpret_cast<const float4*>(st + i * 32);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = a4[q];
      s = fmaf(v.x, gcol[4 * q + 0], s);
      s = fmaf(v.y, gcol[4 * q + 1], s);
      s = fmaf(v.z, gcol[4 * q + 2], s);
      s = fmaf(v.w, gcol[4 * q + 3], s);
    }
    if (lane < H) dw[i * H + lane] += s;
  }
  __syncwarp();
}

// write a block's n staged gradient floats to its slot (blockIdx.x) of the
// partials
__device__ inline void store_partial(const float* src, float* part, int n) {
  float* dst = part + static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// where element i of a staged gradient MLP (per layer: W as [in][out], the
// bias; then the scale) lies in the global fp32 gradients ([out, in]
// kernels)
__device__ inline float* grad_slot(const Mlp& g, int i) {
  for (int l = 0; l < g.n_layers; ++l) {
    const int rows = l == 0 ? g.in_dim : H;
    if (i < rows * H) return const_cast<float*>(g.w[l]) + (i % H) * rows + i / H;
    i -= rows * H;
    if (i < H) return const_cast<float*>(g.b[l]) + i;
    i -= H;
  }
  return const_cast<float*>(g.scale) + i;
}

// adds one MLP's partials (its mlp_floats(g) floats at ``part`` in each of
// ``blocks`` slots, ``stride`` floats apart) into its global gradients,
// the slots summed in block order
// (W = H: the kernel's name carries the width)
template <int W>
__global__ void reduce_mlp_kernel(const float* part, int blocks, int stride, Mlp g) {
  const int n = mlp_floats(g);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += part[static_cast<long long>(b) * stride + i];
    *grad_slot(g, i) += s;
  }
}

// adds the sender pass's partials (dKr then dKs, each [in][out], in each
// of ``blocks`` slots of 2 H^2 floats) into the receiver and sender columns
// of the edge MLP's first kernel gradient gw0 [H, 3H], in block order
template <int W>
__global__ void reduce_send_kernel(const float* part, int blocks, float* gw0) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 2 * H * H;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += part[static_cast<long long>(b) * 2 * H * H + i];
    const int j = i % (H * H), half = i / (H * H);
    gw0[(j % H) * 3 * H + (1 + half) * H + j / H] += s;
  }
}

// a weight MLP and its gradient MLP of 1 to MAXL layers from the two
// pointer lists, with norms on both or on neither; layer 0's input in
// ``parts`` blocks, ``act`` the activation (gn_nk_common.cuh:make_mlp)
inline bool make_mlp_pair(Mlp* w, Mlp* g, const void* const* wp, const void* const* gp,
                          int n_layers, int in_dim, int parts, int act) {
  return make_mlp(w, wp, n_layers, in_dim, parts, act) &&
         make_mlp(g, gp, n_layers, in_dim, parts, act) &&
         (w->scale == nullptr) == (g->scale == nullptr);
}

}  // namespace gn_bwd
