// Edge-masked multi-head attention backward on the receiver-sorted CSR edge
// layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention.py: _bwd_kernel (:143), called by the custom VJP of
// fused_edge_attention (pallas_call :360), with its world-edge seam
// (has_world, :180-203: the cotangents of num_w and den_w).
// Same function (ea_bwd_passes.cuh states it), on a graph of any degree:
// receiver r's rows are s = row_ptr[r] .. row_ptr[r+1]-1; it takes the
// forward's output and the statistics it kept (fused_edge_attention_csr.cu).
//
// Every head width dividing 128 has an instance (ea_common.cuh: Head<DH>).
//
// What bounds it on this card: the graded transformer slice (27,008 nodes
// x 16 samples x 4 heads x dh 16, 160,612 edges) must read q, k, v and
// g_out and write dq, dk and dv, 7 x 55 MB = 387 MB: 0.116 ms at 3.35 TB/s
// with the row arrays; its ~1.6 GFLOP are nothing beside that. It is
// bound by memory traffic. This design also reads the forward's output
// (55 MB) and statistics (13.8 MB: m and inv, fp32 [27,008, 16, 4] each)
// in place of a second walk of the rows, and writes and reads the pg
// scratch (41 MB). Each edge also gathers 2 KB rows, k and v at its
// sender in the receiver pass, q and g_out at its receiver in the sender
// pass: 1.3 GB through L2, which sets the pace.
//
// What the design does about it: the two passes of ea_bwd_passes.cuh,
// shared with the NK backward (fused_edge_attention_nk_bwd.cu), the
// receiver pass on the CSR row map (gn_rows.cuh:CsrRows): one walk of each
// receiver's valid rows (k and v read once), p_s and g_s kept at each
// row's place in the sender-sorted transpose, then a sender pass over that
// transpose; no atomics.

#include "ea_bwd_passes.cuh"

namespace {

template <int DH, bool WORLD>
__global__ void __launch_bounds__(ea::THREADS, ea::MIN_BLOCKS)
    ea_csr_bwd_recv_kernel(const ea::BwdArgs a) {
  ea::bwd_recv_body<DH, gn_rows::CsrRows, WORLD>(a);
}

template <int DH>
__global__ void __launch_bounds__(ea::THREADS, ea::MIN_BLOCKS)
    ea_csr_bwd_send_kernel(const ea::BwdArgs a) {
  ea::bwd_send_body<DH>(a);
}

// the instances, by head width and world seam (ea::BwdLaunch)
struct CsrBwd {
  template <int DH, bool WORLD>
  static ea::BwdKernel recv() { return ea_csr_bwd_recv_kernel<DH, WORLD>; }
  template <int DH>
  static ea::BwdKernel send() { return ea_csr_bwd_send_kernel<DH>; }
};

}  // namespace

// q, k, v, out, g_out, dq, dk, dv: contiguous bf16 [n_nodes, batch, heads,
// head_dim]; m, inv: the forward's fp32 [n_nodes, batch, heads]; row_ptr
// (int32, n_nodes + 1 entries) indexes the rows of senders (int32) and
// mask (bool); offsets (int32, [n_nodes + 1]), place and recv (int32,
// [rows]) the transpose of the rows: node j sends on places
// offsets[j]:offsets[j+1], row s has place place[s], and the row at place
// i has receiver recv[i]; pg: 32-bit [rows, batch, heads] scratch; s_w
// (fp32 [n_nodes, batch, heads], read), dnum_w (fp32 [n_nodes, batch,
// heads, head_dim]) and dden_w (fp32 [n_nodes, batch, heads], written):
// the world seam, all null without world edges (with them, ``out`` is the
// forward's fp32 output before rounding). Returns the CUDA error code of
// the launches (0 on success).
extern "C" int ea_csr_bwd(const void* q, const void* k, const void* v, const void* out,
                          const void* m, const void* inv, const void* g_out, const void* row_ptr,
                          const void* senders, const void* mask, const void* offsets,
                          const void* place, const void* recv, void* dq, void* dk, void* dv,
                          void* pg, const void* s_w, void* dnum_w, void* dden_w, int n_nodes,
                          int batch, int heads, int head_dim, void* stream) {
  ea::BwdArgs a = {};
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  if (!ea::make_bwd_args(&a, q, k, v, out, m, inv, g_out, senders, mask, offsets, place, recv,
                         dq, dk, dv, pg, s_w, dnum_w, dden_w, n_nodes, batch, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  return ea::launch_bwd<CsrBwd>(a, head_dim, stream);
}
