// Edge-masked multi-head attention backward on the uniform-degree ("NK")
// slot layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention_nk.py: _nk_bwd_kernel (:495), called by the custom
// VJP of fused_edge_attention_nk (run_bwd, :661), without the world-edge
// sidecar (has_world=False). Same function: for every receiver r, sample
// b and head h, with the forward's p_s (recomputed, shifted by the
// receiver's own max as fused_edge_attention_nk.cu shifts) and sum denom,
//   inv   = denom > 0 ? 1/denom : 0
//   gp    = bf16(g_out[r] * inv)
//   abar_s = bf16(sum_d bf16(v[j_s,d] * gp[d]))                    (fp32 sum)
//   s_r   = bf16(sum_s bf16(p_s * abar_s) * inv)
//   g_s   = bf16(bf16(p_s * bf16(abar_s - s_r)) / sqrt(dh))
//   dq[r] = bf16(sum_s bf16(g_s * k[j_s]))
// and at every sender j, over the valid slots s that send from j,
//   dk[j] = bf16(sum_s bf16(g_s * q[r_s])),  dv[j] = bf16(sum_s bf16(p_s * gp[r_s])).
// A receiver with no valid slot has inv = 0: its dq and everything it
// sends back are exactly 0.
//
// What bounds it on this card: at the transformer slice (1,920 nodes x
// 64 samples x 4 heads x dh 16, K=6) it must read q, k, v and g_out and
// write dq, dk and dv, 7 x 15.7 MB = 110 MB, ~0.033 ms at 3.35 TB/s; its
// ~0.5 GFLOP are nothing beside that. It is bound by memory traffic.
//
// What the design does about it. dk and dv are sums at the sender side:
// the TPU kernel writes per-window partials and adds them with a
// segment_sum. Here two kernels, and no atomics, so the result is
// deterministic:
//  1. receiver pass, one thread per (receiver, sample, head) as in the
//     forward: recompute p, write dq, gp [N, B, H, dh] and the two
//     per-slot scalars p_s and g_s ([S, B, H], bf16: both are bf16 values
//     already, so nothing is lost);
//  2. sender pass, one thread per (sender, sample, head): walk the valid
//     slots that send from j, in a sender-sorted list (the transpose of
//     the slot table, built by the wrapper), and sum g_s * q and p_s * gp
//     of each slot's receiver in registers.
// Consecutive threads take consecutive heads, then samples, of one node,
// so every row a warp reads or writes is 1 KB of contiguous memory. The
// scratch (gp, p_s, g_s) adds ~70 MB of traffic to the 110 MB bound.

#include "ea_nk_common.cuh"

namespace {

using ea_nk::bf;
using ea_nk::load_vec;
using ea_nk::MAXK;
using ea_nk::store_vec;
using ea_nk::THREADS;

struct Args {
  const __nv_bfloat16* q;      // [N, B, H, dh]
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g_out;  // [N, B, H, dh] cotangent of the output
  const int32_t* senders;      // [G*K*nb] sender per slot (0 on padding)
  const uint8_t* mask;         // [G*K*nb] 1 on valid slots
  const int32_t* order;        // valid slots sorted by sender
  const int32_t* offsets;      // [N+1] sender j's slots: order[offsets[j]:offsets[j+1]]
  __nv_bfloat16* dq;           // [N, B, H, dh]
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  __nv_bfloat16* gp;           // [N, B, H, dh] scratch: bf16(g_out * inv)
  __nv_bfloat16* p_slot;       // [G*K*nb, B, H] scratch: p_s
  __nv_bfloat16* g_slot;       // [G*K*nb, B, H] scratch: g_s
  int n_nodes, batch, heads, k_slots, node_block;
};

// KMAX: the per-slot register arrays, a compile-time bound on K
template <int DH, int KMAX>
__global__ void __launch_bounds__(THREADS) ea_nk_bwd_recv_kernel(const Args a) {
  const int K = a.k_slots, nb = a.node_block;
  const long long per_node = static_cast<long long>(a.batch) * a.heads;  // (b, h) pairs
  const long long total = static_cast<long long>(a.n_nodes) * per_node;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float sqrt_dh = sqrtf(static_cast<float>(DH));

  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int r = static_cast<int>(t / per_node);
    const long long bh = t % per_node;  // b * H + h
    const long long slot0 = static_cast<long long>(r / nb) * K * nb + r % nb;

    float qv[DH];
    load_vec<DH>(qv, a.q + t * DH);

    // the forward's logits, their max, p = bf16(exp(l - m)) and its sum
    float p[KMAX];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      p[k] = -CUDART_INF_F;
      if (k < K) {
        const long long s = slot0 + static_cast<long long>(k) * nb;
        if (a.mask[s]) {
          float kv[DH];
          load_vec<DH>(kv, a.k + (a.senders[s] * per_node + bh) * DH);
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc += bf(qv[d] * kv[d]);
          p[k] = acc / sqrt_dh;
          m = fmaxf(m, p[k]);
        }
      }
    }
    float den = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      p[k] = (k < K && p[k] != -CUDART_INF_F) ? bf(expf(p[k] - m)) : 0.f;
      den += p[k];
    }
    const float inv = den > 0.f ? 1.0f / den : 0.f;

    float gp[DH];
    load_vec<DH>(gp, a.g_out + t * DH);
#pragma unroll
    for (int d = 0; d < DH; ++d) gp[d] = bf(gp[d] * inv);
    store_vec<DH>(a.gp + t * DH, gp);

    // abar_s and s_r
    float ab[KMAX];
    float sacc = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      ab[k] = 0.f;
      if (k < K && p[k] != 0.f) {
        const long long s = slot0 + static_cast<long long>(k) * nb;
        float vv[DH];
        load_vec<DH>(vv, a.v + (a.senders[s] * per_node + bh) * DH);
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc += bf(vv[d] * gp[d]);
        ab[k] = bf(acc);
        sacc += bf(p[k] * ab[k]);
      }
    }
    const float s_r = bf(sacc * inv);

    // g_s, dq, and the per-slot scalars for the sender pass
    float dq[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[d] = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const long long s = slot0 + static_cast<long long>(k) * nb;
        float g = 0.f;
        if (a.mask[s]) {
          g = bf(bf(p[k] * bf(ab[k] - s_r)) / sqrt_dh);
          float kv[DH];
          load_vec<DH>(kv, a.k + (a.senders[s] * per_node + bh) * DH);
#pragma unroll
          for (int d = 0; d < DH; ++d) dq[d] += bf(g * kv[d]);
        }
        a.p_slot[s * per_node + bh] = __float2bfloat16_rn(p[k]);
        a.g_slot[s * per_node + bh] = __float2bfloat16_rn(g);
      }
    }
    store_vec<DH>(a.dq + t * DH, dq);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) ea_nk_bwd_send_kernel(const Args a) {
  const int K = a.k_slots, nb = a.node_block;
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
      const long long r = (s / (static_cast<long long>(K) * nb)) * nb + s % nb;  // receiver
      const float g = __bfloat162float(a.g_slot[s * per_node + bh]);
      const float p = __bfloat162float(a.p_slot[s * per_node + bh]);
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

template <int DH, int KMAX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long grid = ea_nk::grid_for(static_cast<long long>(a.n_nodes) * a.batch * a.heads);
  ea_nk_bwd_recv_kernel<DH, KMAX><<<static_cast<int>(grid), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ea_nk_bwd_send_kernel<DH><<<static_cast<int>(grid), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// the smallest per-slot arrays that hold K: fewer registers, more warps per SM
template <int DH>
cudaError_t launch_k(const Args& a, cudaStream_t stream) {
  if (a.k_slots <= 8) return launch<DH, 8>(a, stream);
  if (a.k_slots <= 16) return launch<DH, 16>(a, stream);
  return launch<DH, MAXK>(a, stream);
}

}  // namespace

// q, k, v, g_out, dq, dk, dv, gp: contiguous bf16 [n_nodes, batch, heads,
// head_dim]; senders (int32) and mask (bool) hold one entry per slot,
// k_slots * n_nodes in all; p_slot, g_slot: bf16 [slots, batch, heads]
// scratch; order (int32, the valid slots sorted by sender) and offsets
// (int32, [n_nodes + 1]) the transpose of the slot table. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int ea_nk_bwd(const void* q, const void* k, const void* v, const void* g_out,
                         const void* senders, const void* mask, const void* order,
                         const void* offsets, void* dq, void* dk, void* dv, void* gp,
                         void* p_slot, void* g_slot, int n_nodes, int batch, int heads,
                         int head_dim, int k_slots, int node_block, void* stream) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.g_out = static_cast<const __nv_bfloat16*>(g_out);
  a.senders = static_cast<const int32_t*>(senders);
  a.mask = static_cast<const uint8_t*>(mask);
  a.order = static_cast<const int32_t*>(order);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.gp = static_cast<__nv_bfloat16*>(gp);
  a.p_slot = static_cast<__nv_bfloat16*>(p_slot);
  a.g_slot = static_cast<__nv_bfloat16*>(g_slot);
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.heads = heads;
  a.k_slots = k_slots;
  a.node_block = node_block;
  if (n_nodes < 1 || batch < 1 || heads < 1 || k_slots < 1 || k_slots > MAXK ||
      node_block < 1 || n_nodes % node_block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch_k<16>(a, st));
    case 32: return static_cast<int>(launch_k<32>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
