// Fused GraphNetBlock backward on the uniform-degree ("NK") slot layout,
// for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock_nk.py:
// _nk_bwd_kernel (:189) and the sender-side segment_sum of its wrapper
// (run_bwd, :694-699). Given the block's inputs (x, e), the aggregate its
// forward (fused_gnblock_nk.cu) kept and the cotangents g_xout (and
// g_eout unless it is the last block), it rematerializes the rest of that
// forward and returns
//   dx  = bf16(bf16(bf16(g_xout + NodeMLP'ᵀ g_xout [x part]) + bf16(P_r·Krᵀ))
//             + bf16(P_s·Ksᵀ))
//   de  = g_e_mlp + g_eout on every slot (g_eout alone on masked slots), or,
//         when the edge encoder is folded in, the encoder's backward on it
//   and fp32 gradients of every Dense kernel, bias and RMSNorm scale of the
//   edge, node and (folded) encoder MLPs, summed over all slots x samples.
// g_h0 is the cotangent at the edge MLP's first-layer output (zero on
// masked slots); P_r and P_s are its sums over a node's K receiver slots
// and over the slots it sends on, each rounded to bf16; Kr / Ks are the
// receiver / sender rows of the edge MLP's first Dense kernel. As in the
// JAX kernel (:270-275) the scatter is commuted through Kr and Ks: their
// gradients are the node-sized products Σ x ⊗ P_r and Σ x ⊗ P_s, and the
// sender part of dx is one H x H product per (node, sample), not one per
// slot. The rematerialized first layer adds the per-node partials
// bf16(x @ Kr) and bf16(x @ Ks), as the forward and the JAX kernel's
// _edge_fwd do, so it differentiates the forward that ran. The numeric
// flow is the JAX kernel's _mlp_bwd (gn_tile.cuh).
//
// What bounds it on this card: per valid slot the backward does about 2.5x
// the forward's multiply-adds (the edge MLP forward again; the cotangent
// through 4 layers; the weight gradients), ~15k multiply-adds a slot
// against ~256 bytes of slot traffic (e, g_eout read, de and g_h0
// written). On the cylinder slice (1,920 nodes x 128 samples, 11,170
// edges in 11,520 slots) that is ~43 GFLOP against ~0.5 GB: 0.04 ms on the
// bf16 tensor cores, ~0.1 ms of HBM traffic, so bound by bytes.
//
// What the design does about it: the pass design of gn_bwd_passes.cuh,
// written once for both layouts, on the NK row map (slot s = g·K·nb +
// k·nb + r belongs to receiver g·nb + r; ops/tiling.py). It replaces a
// receiver-major loop (one thread per (receiver, sample) over its K
// slots) that needed 255 registers and spilled ~0.9 KB a thread,
// recomputed the aggregate (1.0 of its 7.9 ms) and added the sender side
// into a zeroed fp32 dx with global atomics (0.7 ms; PERF.md §6):
//  0. a tile pre-pass (gn_tile.cuh:gn_partial_tc_kernel) writes
//     bf16(x @ Kr) and bf16(x @ Ks);
//  1. node-MLP pass, one warp per (node, 16 samples): the node MLP's
//     backward from g_xout and the bf16 aggregate the forward kept (15.7
//     MB a block at B=128); dx's node-MLP part and g_agg;
//  2. row pass, one warp per (slot, 16 samples) over every slot (8 tiles
//     a slot at B=128): the edge MLP forward, its backward, de, and g_h0 to
//     a bf16 scratch;
//  3. sender pass, one thread per (node, sample): P_r over the node's K
//     slots (stride nb), P_s over the sender-sorted slot list
//     (ops/tiling.cached_sender_slots), dx finished in bf16, dKr and dKs.
// Passes 1 and 2 run every product on mma.sync bf16 -> fp32 tiles, the
// weight gradients shared by a block's warps (gn_bwd_passes.cuh). No
// atomics and no fp32 accumulator touch dx or de; the weight gradients
// are the blocks' partials added in block order, the same bits on every
// call.

#include "gn_bwd_passes.cuh"

using namespace gn_nk;
using namespace gn_bwd;

namespace {

// W = H: the kernels' names carry the width; ACTS: gn_tile.cuh:fix_act
template <int W, bool ACTS>
__global__ void __launch_bounds__(PASS_THREADS, 1) gn_nk_bwd_nodemlp_kernel(const PassArgs a) {
  nodemlp_pass<ACTS>(a);
}

template <int W, bool FOLD, bool ACTS>
__global__ void __launch_bounds__(PASS_THREADS, 1) gn_nk_bwd_row_kernel(const PassArgs a) {
  row_pass<NkRows, FOLD, ACTS>(a);
}

template <int W>
__global__ void __launch_bounds__(SEND_THREADS) gn_nk_bwd_send_kernel(const PassArgs a) {
  send_pass<NkRows>(a);
}

// the instances for MLPs of another depth than NL (gn_bwd_passes.cuh)
template <int W>
__global__ void __launch_bounds__(DEEP_THREADS) gn_nk_bwd_deep_nodemlp_kernel(const PassArgs a) {
  deep_nodemlp_pass(a);
}

template <int W, bool FOLD>
__global__ void __launch_bounds__(DEEP_THREADS) gn_nk_bwd_deep_row_kernel(const PassArgs a) {
  deep_row_pass<NkRows, FOLD>(a);
}

template <bool ACTS>
cudaError_t launch(const PassArgs& a, cudaStream_t stream) {
  const DeepKernels deep = {gn_nk_bwd_deep_nodemlp_kernel<H>, gn_nk_bwd_deep_row_kernel<H, false>,
                            gn_nk_bwd_deep_row_kernel<H, true>};
  return launch_passes(a, stream, gn_nk_bwd_nodemlp_kernel<H, ACTS>,
                       gn_nk_bwd_row_kernel<H, false, ACTS>,
                       gn_nk_bwd_row_kernel<H, true, ACTS>, gn_nk_bwd_send_kernel<H>, deep);
}

}  // namespace

// Weight and gradient lists hold 2 * n_layers + 1 pointers each: w0, b0,
// w1, b1, ..., then the RMSNorm scale (null without a norm), each MLP's
// activation a code (act_common.cuh: mlp_act::Kind); gradients are
// fp32, shaped like their weights, and zeroed by the caller. agg is the
// bf16 aggregate [n_nodes, batch, H] the forward kept. fe > 0 folds the
// edge encoder in (e is the raw [S, B, fe] array, de is null); g_eout null
// marks the last block. xkr, xks, gagg [n_nodes, batch, H] and gh0
// [S, batch, H] (S = n_nodes * k_slots) are bf16 scratch; order and
// offsets (int32) are the valid slots sorted by sender and each node's
// range in them. Returns the CUDA error code of the launches (0 on
// success).
extern "C" int gn_nk_bwd(const void* x, const void* e, const void* agg, const void* g_xout,
                         const void* g_eout, void* dx, void* de, void* xkr, void* xks, void* gagg,
                         void* gh0, const void* senders, const void* mask, const void* order,
                         const void* offsets, int n_nodes, int batch, int k_slots, int node_block,
                         int fe, const void* const* enc_w, const void* const* enc_g,
                         int n_enc_layers, int enc_act, const void* const* edge_w,
                         const void* const* edge_g, int n_edge_layers, int edge_act,
                         const void* const* node_w, const void* const* node_g, int n_node_layers,
                         int node_act, void* stream) {
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
  a.gagg = static_cast<__nv_bfloat16*>(gagg);
  a.gh0 = static_cast<__nv_bfloat16*>(gh0);
  a.senders = static_cast<const int32_t*>(senders);
  a.mask = static_cast<const uint8_t*>(mask);
  a.order = static_cast<const int32_t*>(order);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.k_slots = k_slots;
  a.node_block = node_block;
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.total_rows = n_nodes * k_slots;
  a.fe = fe;
  if (k_slots < 1 || node_block < 1 || n_nodes % node_block != 0 ||
      !make_pass_mlps(&a, enc_w, enc_g, n_enc_layers, enc_act, edge_w, edge_g, n_edge_layers,
                      edge_act, node_w, node_g, n_node_layers, node_act))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(any_act(a) ? launch<true>(a, st) : launch<false>(a, st));
}
