// Fused GraphNetBlock backward on the receiver-sorted CSR edge layout, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock.py:
// _bwd_kernel (:453), called by the custom VJP of fused_gn_block
// (pallas_call :1053), without the lane tiling, the sender windows and the
// extra_agg cotangent. Given the block's inputs (x, e), the aggregate its
// forward (fused_gnblock_csr.cu) kept and the cotangents g_xout (and g_eout
// unless it is the last block), it rematerializes the rest of that forward
// and returns
//   dx  = bf16(bf16(bf16(g_xout + NodeMLP'ᵀ g_xout [x part]) + bf16(P_r·Krᵀ))
//             + bf16(P_s·Ksᵀ))
//   de  = g_e_mlp + g_eout on the rows of a receiver's range, g_eout on the
//         padding rows (their e_out is e_in), or, when the edge encoder is
//         folded in, the encoder's backward on that cotangent
//   and fp32 gradients of every Dense kernel, bias and RMSNorm scale of the
//   edge, node and (folded) encoder MLPs, summed over all rows x samples.
// g_h0 is the cotangent at the edge MLP's first-layer output (zero on
// masked rows); P_r and P_s are its sums over a node's receiver rows and
// over its sender rows, each rounded to bf16; Kr / Ks are the receiver /
// sender rows of the edge MLP's first Dense kernel. As in the JAX kernel
// (:534-546, :585-591) the scatter is commuted through Kr and Ks: their
// gradients are the node-sized products Σ x ⊗ P_r and Σ x ⊗ P_s, and the
// sender part of dx is one H x H product per (node, sample), not one per
// edge. The numeric flow is the JAX kernel's _mlp_bwd (gn_bwd_common.cuh).
//
// What bounds it on this card: per valid row the backward does about 2.5x
// the forward's multiply-adds (the edge MLP forward, keeping its
// activations; the cotangent through 4 layers; the weight-gradient outer
// products), ~15k FMAs a row against ~256 bytes of row traffic (e, g_eout
// read, de and g_h0 written). On the graded airfoil-sized slice (27,008
// receivers x 16 samples, 160,612 edges) that is ~80 GFLOP against ~0.7 GB:
// bound by fp32 FMA throughput on the CUDA cores (~1.2 ms at 67 TFLOP/s),
// ~0.2 ms of HBM traffic.
//
// What the design does about it, in this first version: the pass design of
// gn_bwd_passes.cuh, shared with the NK backward (fused_gnblock_nk_bwd.cu),
// on the CSR row map: the forward's node pre-pass, run twice, writes
// bf16(x @ Kr) and bf16(x @ Ks) per (node, sample); then a node-MLP pass
// that reads the aggregate the forward kept (27.6 MB a block on the
// graded slice; recomputing it took 16 of an earlier version's 39 ms on
// the card, PERF.md §6), a row pass with one thread per (row, sample) of
// every row, padding rows included (a receiver-major version, one thread
// per (receiver, sample) walking the receiver's rows, took 2.7x as long on
// the card, PERF.md §6, most likely latency-bound on its loop-carried
// registers and its warps' longest ranges), and a sender pass over the
// node's own rows and a sender-sorted row list (the transpose of the CSR
// rows, built once per layout by the wrapper). No atomics on dx or de.
// Passes 1 and 2 share the register-packed activations and warp-staged
// weight gradients of gn_bwd_common.cuh: the staging is warp-collective,
// so idle lanes carry zero cotangents. Tensor cores are left to later
// versions.

#include "gn_bwd_passes.cuh"

using namespace gn_nk;
using namespace gn_bwd;

namespace {

__global__ void __launch_bounds__(PASS_THREADS, 1) gn_csr_bwd_nodemlp_kernel(const PassArgs a) {
  nodemlp_pass(a);
}

__global__ void __launch_bounds__(PASS_THREADS, 1) gn_csr_bwd_row_kernel(const PassArgs a) {
  row_pass<CsrRows>(a);
}

__global__ void __launch_bounds__(SEND_THREADS) gn_csr_bwd_send_kernel(const PassArgs a) {
  send_pass<CsrRows>(a);
}

}  // namespace

// Weight and gradient lists hold 2 * n_layers + 1 pointers each: w0, b0,
// w1, b1, ..., then the RMSNorm scale (null without a norm); gradients are
// fp32, shaped like their weights, and zeroed by the caller. agg is the
// bf16 aggregate [n_nodes, batch, 32] the forward kept. fe > 0 folds
// the edge encoder in (e is the raw [S, B, fe] array, de is null); g_eout
// null marks the last block. xkr, xks, gagg [n_nodes, batch, 32] and gh0
// [total_rows, batch, 32] are bf16 scratch; order and offsets (int32) are
// the valid rows sorted by sender and each node's range in them. Returns
// the CUDA error code of the launches (0 on success).
extern "C" int gn_csr_bwd(const void* x, const void* e, const void* agg, const void* g_xout,
                          const void* g_eout, void* dx, void* de, void* xkr, void* xks,
                          void* gagg, void* gh0, const void* row_ptr, const void* senders,
                          const void* receivers, const void* mask, const void* order,
                          const void* offsets, int n_nodes, int batch, int total_rows, int fe,
                          const void* const* enc_w, const void* const* enc_g, int n_enc_layers,
                          const void* const* edge_w, const void* const* edge_g,
                          int n_edge_layers, const void* const* node_w,
                          const void* const* node_g, int n_node_layers, void* stream) {
  PassArgs a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.e = static_cast<const __nv_bfloat16*>(e);
  a.xkr = static_cast<const __nv_bfloat16*>(xkr);
  a.xks = static_cast<const __nv_bfloat16*>(xks);
  a.agg = static_cast<const __nv_bfloat16*>(agg);
  a.g_xout = static_cast<const __nv_bfloat16*>(g_xout);
  a.g_eout = static_cast<const __nv_bfloat16*>(g_eout);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.de = static_cast<__nv_bfloat16*>(de);
  a.gh0 = static_cast<__nv_bfloat16*>(gh0);
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.senders = static_cast<const int32_t*>(senders);
  a.receivers = static_cast<const int32_t*>(receivers);
  a.gagg = static_cast<__nv_bfloat16*>(gagg);
  a.mask = static_cast<const uint8_t*>(mask);
  a.order = static_cast<const int32_t*>(order);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.total_rows = total_rows;
  a.fe = fe;
  if (!make_pass_mlps(&a, enc_w, enc_g, n_enc_layers, edge_w, edge_g, n_edge_layers, node_w,
                      node_g, n_node_layers))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_passes(a, static_cast<cudaStream_t>(stream),
                                        gn_csr_bwd_nodemlp_kernel,
                                        gn_csr_bwd_row_kernel, gn_csr_bwd_send_kernel));
}
