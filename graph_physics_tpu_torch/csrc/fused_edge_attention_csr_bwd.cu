// Edge-masked multi-head attention backward on the receiver-sorted CSR edge
// layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention.py: _bwd_kernel (:143), called by the custom VJP of
// fused_edge_attention (pallas_call :360), without the world-edge sidecar.
// Same function, on a graph of any degree: for every receiver r, sample b
// and head h, over r's rows s with sender j_s, with the forward's p_s
// (recomputed, shifted by the receiver's own max as
// fused_edge_attention_csr.cu shifts) and their sum denom,
//   inv    = denom > 0 ? 1/denom : 0
//   gp     = bf16(g_out[r] * inv)
//   abar_s = bf16(sum_d bf16(v[j_s,d] * gp[d]))                    (fp32 sum)
//   s_r    = bf16(sum_s bf16(p_s * abar_s) * inv)
//   g_s    = bf16(bf16(p_s * bf16(abar_s - s_r)) / sqrt(dh))
//   dq[r]  = bf16(sum_s bf16(g_s * k[j_s]))
// and at every sender j, over the valid rows s that send from j,
//   dk[j] = bf16(sum_s bf16(g_s * q[r_s])),  dv[j] = bf16(sum_s bf16(p_s * gp[r_s])).
// A receiver with no valid row has inv = 0: its dq and everything it sends
// back are exactly 0; a node that sends on no valid row gets dk = dv = 0.
// The rounding is the NK backward's (fused_edge_attention_nk_bwd.cu).
//
// What bounds it on this card: the graded transformer slice (27,008 nodes
// x 16 samples x 4 heads x dh 16, 160,612 edges) must read q, k, v and
// g_out and write dq, dk and dv, 7 x 55 MB = 387 MB, ~0.12 ms at
// 3.35 TB/s; its ~1.6 GFLOP are nothing beside that. It is bound by memory
// traffic.
//
// What the design does about it: the NK backward's two passes, and no
// atomics, so the result is deterministic.
//  1. receiver pass, one thread per (receiver, sample, head), as in the
//     forward, with no cap on the degree: nothing per row stays in
//     registers, so it walks the receiver's row range four times (the max
//     of the logits; p and its sum; abar and s_r; g and dq), keeping p_s
//     and abar_s, then g_s, in two bf16 per-row scratch arrays [S, B, H]
//     (all three are bf16 values, so nothing is lost) and gp [N, B, H, dh];
//  2. sender pass, one thread per (sender, sample, head): walk the valid
//     rows that send from j in a sender-sorted row list (the transpose of
//     the CSR rows, built once per layout by the wrapper) and sum
//     g_s * q and p_s * gp of each row's receiver in registers.
// Consecutive threads take consecutive heads, then samples, of one node,
// so every row a warp reads or writes is contiguous memory.

#include "ea_nk_common.cuh"

namespace {

using ea_nk::bf;
using ea_nk::load_vec;
using ea_nk::store_vec;
using ea_nk::THREADS;

struct Args {
  const __nv_bfloat16* q;      // [N, B, H, dh]
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g_out;  // [N, B, H, dh] cotangent of the output
  const int32_t* row_ptr;      // [N + 1] receiver r owns rows row_ptr[r]:row_ptr[r+1]
  const int32_t* senders;      // [S] sender per row (0 on padding)
  const int32_t* receivers;    // [S] receiver per row
  const uint8_t* mask;         // [S] 1 on valid rows
  const int32_t* order;        // the valid rows sorted by sender
  const int32_t* offsets;      // [N + 1] node j sends on order[offsets[j]:offsets[j+1]]
  __nv_bfloat16* dq;           // [N, B, H, dh]
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  __nv_bfloat16* gp;           // [N, B, H, dh] scratch: bf16(g_out * inv)
  __nv_bfloat16* p_row;        // [S, B, H] scratch: p_s
  __nv_bfloat16* g_row;        // [S, B, H] scratch: abar_s, then g_s
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
__global__ void __launch_bounds__(THREADS) ea_csr_bwd_recv_kernel(const Args a) {
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

    // 1: the max of the valid rows' logits
    float m = -CUDART_INF_F;
    for (int s = begin; s < end; ++s)
      if (a.mask[s]) m = fmaxf(m, logit<DH>(qv, a.k + (a.senders[s] * per_node + bh) * DH,
                                            sqrt_dh));

    // 2: p = bf16(exp(l - m)) per row, and its fp32 sum
    float den = 0.f;
    for (int s = begin; s < end; ++s) {
      float p = 0.f;
      if (a.mask[s])
        p = bf(expf(logit<DH>(qv, a.k + (a.senders[s] * per_node + bh) * DH, sqrt_dh) - m));
      a.p_row[s * per_node + bh] = __float2bfloat16_rn(p);
      den += p;
    }
    const float inv = den > 0.f ? 1.0f / den : 0.f;

    float gp[DH];
    load_vec<DH>(gp, a.g_out + t * DH);
#pragma unroll
    for (int d = 0; d < DH; ++d) gp[d] = bf(gp[d] * inv);
    store_vec<DH>(a.gp + t * DH, gp);

    // 3: abar_s and s_r
    float sacc = 0.f;
    for (int s = begin; s < end; ++s) {
      const float p = __bfloat162float(a.p_row[s * per_node + bh]);
      float ab = 0.f;
      if (p != 0.f) {
        float vv[DH];
        load_vec<DH>(vv, a.v + (a.senders[s] * per_node + bh) * DH);
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc += bf(vv[d] * gp[d]);
        ab = bf(acc);
        sacc += bf(p * ab);
      }
      a.g_row[s * per_node + bh] = __float2bfloat16_rn(ab);
    }
    const float s_r = bf(sacc * inv);

    // 4: g_s (over abar_s in the scratch) and dq
    float dq[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[d] = 0.f;
    for (int s = begin; s < end; ++s) {
      float g = 0.f;
      if (a.mask[s]) {
        const float p = __bfloat162float(a.p_row[s * per_node + bh]);
        const float ab = __bfloat162float(a.g_row[s * per_node + bh]);
        g = bf(bf(p * bf(ab - s_r)) / sqrt_dh);
        float kv[DH];
        load_vec<DH>(kv, a.k + (a.senders[s] * per_node + bh) * DH);
#pragma unroll
        for (int d = 0; d < DH; ++d) dq[d] += bf(g * kv[d]);
      }
      a.g_row[s * per_node + bh] = __float2bfloat16_rn(g);
    }
    store_vec<DH>(a.dq + t * DH, dq);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) ea_csr_bwd_send_kernel(const Args a) {
  const long long per_node = static_cast<long long>(a.batch) * a.heads;
  const long long total = static_cast<long long>(a.n_nodes) * per_node;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int j = static_cast<int>(t / per_node);
    const long long bh = t % per_node;
    float dk[DH], dv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dk[d] = dv[d] = 0.f;
    const int hi = a.offsets[j + 1];
    for (int i = a.offsets[j]; i < hi; ++i) {
      const long long s = a.order[i];
      const long long r = a.receivers[s];
      const float g = __bfloat162float(a.g_row[s * per_node + bh]);
      const float p = __bfloat162float(a.p_row[s * per_node + bh]);
      float qv[DH], gv[DH];
      load_vec<DH>(qv, a.q + (r * per_node + bh) * DH);
      load_vec<DH>(gv, a.gp + (r * per_node + bh) * DH);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[d] += bf(g * qv[d]);
        dv[d] += bf(p * gv[d]);
      }
    }
    store_vec<DH>(a.dk + t * DH, dk);
    store_vec<DH>(a.dv + t * DH, dv);
  }
}

template <int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long grid = ea_nk::grid_for(static_cast<long long>(a.n_nodes) * a.batch * a.heads);
  ea_csr_bwd_recv_kernel<DH><<<static_cast<int>(grid), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ea_csr_bwd_send_kernel<DH><<<static_cast<int>(grid), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g_out, dq, dk, dv, gp: contiguous bf16 [n_nodes, batch, heads,
// head_dim]; row_ptr (int32, n_nodes + 1 entries) indexes the rows of
// senders, receivers (int32) and mask (bool); p_row, g_row: bf16
// [rows, batch, heads] scratch; order (int32, the valid rows sorted by
// sender) and offsets (int32, [n_nodes + 1]) the transpose of the rows.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int ea_csr_bwd(const void* q, const void* k, const void* v, const void* g_out,
                          const void* row_ptr, const void* senders, const void* receivers,
                          const void* mask, const void* order, const void* offsets, void* dq,
                          void* dk, void* dv, void* gp, void* p_row, void* g_row, int n_nodes,
                          int batch, int heads, int head_dim, void* stream) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.g_out = static_cast<const __nv_bfloat16*>(g_out);
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.senders = static_cast<const int32_t*>(senders);
  a.receivers = static_cast<const int32_t*>(receivers);
  a.mask = static_cast<const uint8_t*>(mask);
  a.order = static_cast<const int32_t*>(order);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.gp = static_cast<__nv_bfloat16*>(gp);
  a.p_row = static_cast<__nv_bfloat16*>(p_row);
  a.g_row = static_cast<__nv_bfloat16*>(g_row);
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
