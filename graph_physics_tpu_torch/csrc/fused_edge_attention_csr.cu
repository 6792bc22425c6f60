// Edge-masked multi-head attention forward on the receiver-sorted CSR edge
// layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention.py: _fwd_kernel (:124, body _attn_common :63),
// called by fused_edge_attention (:206), without the world-edge sidecar.
// Same function, on a graph of any degree: for every receiver r, sample b
// and head h, over r's rows s = row_ptr[r] .. row_ptr[r+1]-1 with sender j,
//   l_s   = sum_d bf16(q[r,b,h,d] * k[j,b,h,d]) / sqrt(dh)      (fp32 sum)
//   p_s   = mask[s] ? bf16(exp(l_s - max over valid rows of l)) : 0
//   out   = sum_s bf16(p_s * v[j,b,h,:]) / sum_s p_s             (fp32 sums)
// rounded to bf16, and exactly 0 for a receiver with no valid row. The TPU
// kernel shifts by one max per tile; this one by the receiver's own max,
// which agrees to rounding and cannot underflow where a tile's max would.
//
// What bounds it on this card: the graded transformer slice (27,008
// receivers x 16 samples x 4 heads x dh 16, 160,612 edges) does ~0.66 GFLOP
// a block and must read q, k, v once and write the output: 4 x 55 MB =
// 221 MB, ~0.066 ms at 3.35 TB/s. It is bound by memory traffic. k and v
// (111 MB) exceed the 50 MB L2, but nodes come in mesh order, so the
// receivers of one block share most of their senders' rows.
//
// What the design does about it, in this first version: one thread per
// (receiver, sample, head), as the NK kernel, with no cap on the degree:
// two passes over the receiver's row range, the first for the max of the
// logits, the second recomputing each logit for exp and the weighted sum,
// so nothing per row stays in registers and the rounding is the NK
// kernel's. The second pass reads the same few k rows again, shortly
// after the first, mostly from cache. Consecutive threads
// take consecutive heads, then samples, of one receiver, so each row's k
// and v reads of a warp are contiguous. Neighbouring receivers have
// different degrees, so a warp waits for its longest range; that is left
// as it is.

#include "ea_nk_common.cuh"

namespace {

using ea_nk::bf;
using ea_nk::load_vec;
using ea_nk::store_vec;
using ea_nk::THREADS;

struct Args {
  const __nv_bfloat16* q;  // [N, B, H, dh]
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;      // [N, B, H, dh]
  const int32_t* row_ptr;  // [N + 1] receiver r owns rows row_ptr[r]:row_ptr[r+1]
  const int32_t* senders;  // [S] sender per row (0 on padding)
  const uint8_t* mask;     // [S] 1 on valid rows
  int n_nodes, batch, heads;
};

template <int DH>
__device__ __forceinline__ float logit(const float (&qv)[DH], const __nv_bfloat16* krow,
                                       float sqrt_dh) {
  float kv[DH];
  load_vec<DH>(kv, krow);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc += bf(qv[d] * kv[d]);
  return acc / sqrt_dh;
}

template <int DH>
__global__ void __launch_bounds__(THREADS) ea_csr_fwd_kernel(const Args a) {
  const long long per_node = static_cast<long long>(a.batch) * a.heads;  // (b, h) pairs
  const long long total = static_cast<long long>(a.n_nodes) * per_node;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float sqrt_dh = sqrtf(static_cast<float>(DH));

  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int r = static_cast<int>(t / per_node);
    const long long bh = t % per_node;  // b * H + h
    const int begin = a.row_ptr[r], end = a.row_ptr[r + 1];

    float qv[DH];
    load_vec<DH>(qv, a.q + t * DH);

    // pass 1: the max of the valid rows' logits
    float m = -CUDART_INF_F;
    for (int s = begin; s < end; ++s)
      if (a.mask[s]) m = fmaxf(m, logit<DH>(qv, a.k + (a.senders[s] * per_node + bh) * DH,
                                            sqrt_dh));

    // pass 2: p = bf16(exp(l - m)); fp32 sums of p and of bf16(p * v)
    float num[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) num[d] = 0.f;
    float den = 0.f;
    for (int s = begin; s < end; ++s) {
      if (!a.mask[s]) continue;
      const long long row = (a.senders[s] * per_node + bh) * DH;
      const float p = bf(expf(logit<DH>(qv, a.k + row, sqrt_dh) - m));
      float vv[DH];
      load_vec<DH>(vv, a.v + row);
      den += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) num[d] += bf(p * vv[d]);
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) num[d] = den > 0.f ? num[d] / den : 0.f;
    store_vec<DH>(a.out + t * DH, num);
  }
}

template <int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long grid = ea_nk::grid_for(static_cast<long long>(a.n_nodes) * a.batch * a.heads);
  ea_csr_fwd_kernel<DH><<<static_cast<int>(grid), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous bf16 [n_nodes, batch, heads, head_dim]; row_ptr
// (int32, n_nodes + 1 entries) indexes the rows of senders (int32) and mask
// (bool). Returns the CUDA error code of the launch (0 on success).
extern "C" int ea_csr_fwd(const void* q, const void* k, const void* v, void* out,
                          const void* row_ptr, const void* senders, const void* mask,
                          int n_nodes, int batch, int heads, int head_dim, void* stream) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.senders = static_cast<const int32_t*>(senders);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.heads = heads;
  if (n_nodes < 1 || batch < 1 || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch<16>(a, st));
    case 32: return static_cast<int>(launch<32>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
