// Edge-masked multi-head attention forward on the uniform-degree ("NK")
// slot layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention_nk.py: _nk_fwd_kernel (:476, body _nk_common :437),
// called by fused_edge_attention_nk (:545), without the world-edge
// sidecar. Same function: for every receiver r, sample b and head h, over
// r's K slots s with sender j (slot g*K*nb + k*nb + r%nb, g = r / nb),
//   l_s   = sum_d bf16(q[r,b,h,d] * k[j,b,h,d]) / sqrt(dh)      (fp32 sum)
//   p_s   = mask[s] ? bf16(exp(l_s - max over valid slots of l)) : 0
//   out   = sum_s bf16(p_s * v[j,b,h,:]) / sum_s p_s             (fp32 sums)
// rounded to bf16, and 0 for a receiver with no valid slot. The TPU kernel
// shifts by one max per tile; this one by the receiver's own max, which
// agrees to rounding and cannot underflow where a tile's max would.
//
// What bounds it on this card: the transformer slice (1,920 receivers x
// 64 samples x 4 heads x dh 16, K=6) does ~0.19 GFLOP a block and moves
// q, k, v once and writes the output: 4 x 15.7 MB = 63 MB, ~0.019 ms at
// 3.35 TB/s. It is bound by memory traffic. k and v (31 MB) fit in the
// 50 MB L2, so the K-fold sender gather mostly hits L2.
//
// What the design does about it, in this first version: one thread per
// (receiver, sample, head); the TPU's windowed one-hot gathers and the
// win_start/sidx prefetch are left behind, the sender comes from the slot
// table. Consecutive threads take consecutive heads, then samples, of one
// receiver, so the q reads and each slot's k and v reads of a warp are
// 1 KB of contiguous memory (each thread loads its dh values as 16-byte
// vectors). The K logits stay in registers between the two passes (max,
// then exp and the weighted sum), in an array sized by a compile-time
// bound on K (8, 16 or 32), so a mesh with K=6 keeps registers, and
// warps per SM, to what it needs.

#include "ea_nk_common.cuh"

namespace {

using ea_nk::bf;
using ea_nk::load_vec;
using ea_nk::MAXK;
using ea_nk::store_vec;
using ea_nk::THREADS;

struct Args {
  const __nv_bfloat16* q;  // [N, B, H, dh]
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;      // [N, B, H, dh]
  const int32_t* senders;  // [G*K*nb] sender per slot (0 on padding)
  const uint8_t* mask;     // [G*K*nb] 1 on valid slots
  int n_nodes, batch, heads, k_slots, node_block;
};

// KMAX: the K logits' register array, a compile-time bound on K
template <int DH, int KMAX>
__global__ void __launch_bounds__(THREADS) ea_nk_fwd_kernel(const Args a) {
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

    // pass 1: the valid slots' logits and their max
    float lg[KMAX];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      lg[k] = -CUDART_INF_F;
      if (k < K) {
        const long long s = slot0 + static_cast<long long>(k) * nb;
        if (a.mask[s]) {
          float kv[DH];
          load_vec<DH>(kv, a.k + (a.senders[s] * per_node + bh) * DH);
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc += bf(qv[d] * kv[d]);
          lg[k] = acc / sqrt_dh;
          m = fmaxf(m, lg[k]);
        }
      }
    }

    // pass 2: p = bf16(exp(l - m)); fp32 sums of p and of bf16(p * v)
    float num[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) num[d] = 0.f;
    float den = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K && lg[k] != -CUDART_INF_F) {
        const long long s = slot0 + static_cast<long long>(k) * nb;
        const float p = bf(expf(lg[k] - m));
        float vv[DH];
        load_vec<DH>(vv, a.v + (a.senders[s] * per_node + bh) * DH);
        den += p;
#pragma unroll
        for (int d = 0; d < DH; ++d) num[d] += bf(p * vv[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) num[d] = den > 0.f ? num[d] / den : 0.f;
    store_vec<DH>(a.out + t * DH, num);
  }
}

template <int DH, int KMAX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long grid = ea_nk::grid_for(static_cast<long long>(a.n_nodes) * a.batch * a.heads);
  ea_nk_fwd_kernel<DH, KMAX><<<static_cast<int>(grid), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// the smallest logit array that holds K: fewer registers, more warps per SM
template <int DH>
cudaError_t launch_k(const Args& a, cudaStream_t stream) {
  if (a.k_slots <= 8) return launch<DH, 8>(a, stream);
  if (a.k_slots <= 16) return launch<DH, 16>(a, stream);
  return launch<DH, MAXK>(a, stream);
}

}  // namespace

// q, k, v, out: contiguous bf16 [n_nodes, batch, heads, head_dim]; senders
// (int32) and mask (bool) hold one entry per slot, k_slots * n_nodes in
// all. Returns the CUDA error code of the launch (0 on success).
extern "C" int ea_nk_fwd(const void* q, const void* k, const void* v, void* out,
                         const void* senders, const void* mask, int n_nodes, int batch,
                         int heads, int head_dim, int k_slots, int node_block, void* stream) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.senders = static_cast<const int32_t*>(senders);
  a.mask = static_cast<const uint8_t*>(mask);
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
