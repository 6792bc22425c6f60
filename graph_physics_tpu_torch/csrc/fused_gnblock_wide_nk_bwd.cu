// Fused GraphNetBlock backward on the uniform-degree ("NK") slot layout at
// hidden 64 and 128, for Hopper (sm_90a), on wgmma warpgroup tiles;
// compiled once per width (-DGN_WIDE_H=64 or 128, ops/kernel_build.py:
// FLAGS).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock_nk.py:
// _nk_bwd_kernel (:189) and the sender-side segment_sum of its wrapper
// (run_bwd, :694-699) at the hidden widths that are not 32
// (fused_gnblock_nk_bwd.cu keeps hidden 32). The function, the bound and
// the passes are gn_wide_bwd.cuh's, on the NK row map.

#include "gn_wide_bwd.cuh"

using namespace gnw;

namespace {

template <bool ACTS, int WGS>
__global__ void __launch_bounds__(WG_THREADS * WGS, 1)
    GNW(nk_row_bwd)(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char row_smem[];
  row_bwd_body<NkRows, ACTS, WGS>(a, row_smem);
}

__global__ void __launch_bounds__(2 * WG_THREADS)
    GNW(nk_send)(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char send_smem[];
  send_body<NkRows>(a, send_smem);
}

}  // namespace

extern "C" int gnw_hidden() { return H; }

// bf16 scratch elements (which = 0) and fp32 partial elements (1) that
// gnw_nk_bwd takes for these sizes (fe > 0: folded) and MLP depths
extern "C" long long gnw_bwd_sizes(int which, int n_nodes, int batch, long long total_rows,
                                   int fe, int n_edge_layers, int n_node_layers,
                                   int n_enc_layers) {
  return bwd_sizes(which, n_nodes, batch, total_rows, fe, n_edge_layers, n_node_layers,
                   n_enc_layers);
}

// Weight and gradient lists hold 2 * n_layers + 1 pointers each (1 to 8
// layers): w0, b0, w1, b1, ..., then the RMSNorm scale (null without a norm); gradients are fp32,
// shaped like their weights, and written whole. agg is the bf16 aggregate
// [n_nodes, batch, H] the forward kept. fe > 0 folds the edge encoder in
// (e is the raw [S, B, fe] array, de is null); g_eout null marks the last
// block; dea, when not null, receives the bf16 cotangent [n_nodes, batch,
// H] of the aggregate (of the extra aggregate the forward added). scratch
// and part hold gnw_bwd_sizes(0 / 1, ...) bf16 / fp32
// elements; order and offsets (int32) are the valid slots sorted by sender
// and each node's range in them. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int gnw_nk_bwd(const void* x, const void* e, const void* agg, const void* g_xout,
                          const void* g_eout, void* dx, void* de, void* dea, void* scratch,
                          void* part, const void* senders, const void* mask, const void* order,
                          const void* offsets, int n_nodes, int batch, int k_slots, int node_block,
                          int fe, const void* const* enc_w, const void* const* enc_g,
                          int n_enc_layers, int enc_act, const void* const* edge_w,
                          const void* const* edge_g, int n_edge_layers, int edge_act,
                          const void* const* node_w, const void* const* node_g, int n_node_layers,
                          int node_act, void* stream) {
  BwdArgs a = {};
  a.k_slots = k_slots;
  a.node_block = node_block;
  a.n_nodes = n_nodes;
  a.total_rows = n_nodes * k_slots;
  if (k_slots < 1 || node_block < 1 || n_nodes % node_block != 0 ||
      !make_bwd_args(&a, x, e, agg, g_xout, g_eout, dx, de, dea, senders, mask, order, offsets,
                     batch, fe, enc_w, enc_g, n_enc_layers, enc_act, edge_w, edge_g,
                     n_edge_layers, edge_act, node_w, node_g, n_node_layers, node_act))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdKernel rows[3] = {GNW(nk_row_bwd)<false, 2>, GNW(nk_row_bwd)<true, 2>,
                            GNW(nk_row_bwd)<true, 1>};
  return static_cast<int>(launch_bwd(a, static_cast<bf16*>(scratch), static_cast<float*>(part),
                                     static_cast<cudaStream_t>(stream), rows, GNW(nk_send)));
}
