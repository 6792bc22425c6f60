// Edge-masked multi-head attention backward on the uniform-degree ("NK")
// slot layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention_nk.py: _nk_bwd_kernel (:495), called by the custom
// VJP of fused_edge_attention_nk (run_bwd, :661), with its world-edge seam
// (has_world, :535-542: the cotangents of num_w and den_w). Same function (ea_bwd_passes.cuh states it):
// receiver r's rows are its K slots (fused_edge_attention_nk.cu), masked
// ones among them; it takes the forward's output and the statistics it
// kept, and keeps products exact in fp32 as the forward does.
//
// Every head width dividing 128 has an instance (ea_common.cuh: Head<DH>).
//
// What bounds it on this card: at the transformer slice (1,920 nodes x
// 64 samples x 4 heads x dh 16, K=6) it must read q, k, v and g_out and
// write dq, dk and dv, 7 x 15.7 MB = 110 MB, ~0.033 ms at 3.35 TB/s; its
// ~0.5 GFLOP are nothing beside that. It is bound by memory traffic. This
// design also reads the forward's output (15.7 MB) and statistics (3.9 MB)
// and writes and reads the pg scratch (11.8 MB: a bf16 pair per valid
// slot, sample and head).
//
// What the design does about it: the two passes of ea_bwd_passes.cuh,
// shared with the CSR backward (fused_edge_attention_csr_bwd.cu), the
// receiver pass on the NK row map (gn_rows.cuh:NkRows): one walk of each
// receiver's valid slots (k and v read once, s_r from the output, no
// per-slot scratch but pg), p_s and g_s kept at each slot's place in the
// sender-sorted transpose, then a sender pass over that transpose; no
// atomics.

#include "ea_bwd_passes.cuh"

namespace {

template <int DH, bool WORLD>
__global__ void __launch_bounds__(ea::THREADS, ea::MIN_BLOCKS)
    ea_nk_bwd_recv_kernel(const ea::BwdArgs a) {
  ea::bwd_recv_body<DH, gn_rows::NkRows, WORLD>(a);
}

template <int DH>
__global__ void __launch_bounds__(ea::THREADS, ea::MIN_BLOCKS)
    ea_nk_bwd_send_kernel(const ea::BwdArgs a) {
  ea::bwd_send_body<DH>(a);
}

// the instances, by head width and world seam (ea::BwdLaunch)
struct NkBwd {
  template <int DH, bool WORLD>
  static ea::BwdKernel recv() { return ea_nk_bwd_recv_kernel<DH, WORLD>; }
  template <int DH>
  static ea::BwdKernel send() { return ea_nk_bwd_send_kernel<DH>; }
};

}  // namespace

// q, k, v, out, g_out, dq, dk, dv: contiguous bf16 [n_nodes, batch, heads,
// head_dim]; m, inv: the forward's fp32 [n_nodes, batch, heads]; senders
// (int32) and mask (bool) one entry per slot, receiver g·nb + r owning
// slots g·k_slots·nb + k·nb + r (nb = node_block); offsets (int32,
// [n_nodes + 1]), place and recv (int32, [slots]) the transpose of the
// slots: node j sends on places offsets[j]:offsets[j+1], slot s has place
// place[s], and the slot at place i has receiver recv[i]; pg: 32-bit
// [slots, batch, heads] scratch; s_w (fp32 [n_nodes, batch, heads], read),
// dnum_w (fp32 [n_nodes, batch, heads, head_dim]) and dden_w (fp32
// [n_nodes, batch, heads], written): the world seam, all null without
// world edges (with them, ``out`` is the forward's fp32 output before
// rounding). Returns the CUDA error code of the launches (0 on success).
extern "C" int ea_nk_bwd(const void* q, const void* k, const void* v, const void* out,
                         const void* m, const void* inv, const void* g_out, const void* senders,
                         const void* mask, const void* offsets, const void* place,
                         const void* recv, void* dq, void* dk, void* dv, void* pg,
                         const void* s_w, void* dnum_w, void* dden_w, int n_nodes, int batch,
                         int heads, int head_dim, int k_slots, int node_block, void* stream) {
  ea::BwdArgs a = {};
  a.k_slots = k_slots;
  a.node_block = node_block;
  a.total_rows = n_nodes * k_slots;
  if (k_slots < 1 || node_block < 1 || n_nodes % node_block != 0 ||
      !ea::make_bwd_args(&a, q, k, v, out, m, inv, g_out, senders, mask, offsets, place, recv,
                         dq, dk, dv, pg, s_w, dnum_w, dden_w, n_nodes, batch, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  return ea::launch_bwd<NkBwd>(a, head_dim, stream);
}
