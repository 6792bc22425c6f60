// Fused GraphNetBlock backward on the receiver-sorted CSR edge layout at
// hidden 64 and 128, for Hopper (sm_90a), on wgmma warpgroup tiles;
// compiled once per width (-DGN_WIDE_H=64 or 128, ops/kernel_build.py:
// FLAGS).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock.py:
// _bwd_kernel (:453), called by the custom VJP of fused_gn_block
// (pallas_call :1053), at the hidden widths that are not 32
// (fused_gnblock_csr_bwd.cu keeps hidden 32), without the lane tiling, the
// sender windows and the extra_agg cotangent. The function, the bound and
// the passes are gn_wide_bwd.cuh's, on the CSR row map; padding rows take
// de = g_eout and add nothing to the weight gradients.

#include "gn_wide_bwd.cuh"

using namespace gnw;

namespace {

template <bool ACTS, int WGS>
__global__ void __launch_bounds__(WG_THREADS * WGS, 1)
    GNW(csr_row_bwd)(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char row_smem[];
  row_bwd_body<CsrRows, ACTS, WGS>(a, row_smem);
}

__global__ void __launch_bounds__(2 * WG_THREADS)
    GNW(csr_send)(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char send_smem[];
  send_body<CsrRows>(a, send_smem);
}

}  // namespace

extern "C" int gnw_hidden() { return H; }

// bf16 scratch elements (which = 0) and fp32 partial elements (1) that
// gnw_csr_bwd takes for these sizes (fe > 0: folded) and MLP depths
extern "C" long long gnw_bwd_sizes(int which, int n_nodes, int batch, long long total_rows,
                                   int fe, int n_edge_layers, int n_node_layers,
                                   int n_enc_layers) {
  return bwd_sizes(which, n_nodes, batch, total_rows, fe, n_edge_layers, n_node_layers,
                   n_enc_layers);
}

// As gnw_nk_bwd (fused_gnblock_wide_nk_bwd.cu), with the CSR rows: row_ptr
// [n_nodes + 1], receivers [total_rows] (n_nodes - 1 on padding) and
// total_rows rows, padding included.
extern "C" int gnw_csr_bwd(const void* x, const void* e, const void* agg, const void* g_xout,
                           const void* g_eout, void* dx, void* de, void* dea, void* scratch,
                           void* part, const void* row_ptr, const void* senders,
                           const void* receivers, const void* mask, const void* order,
                           const void* offsets, int n_nodes, int batch, int total_rows, int fe,
                           const void* const* enc_w, const void* const* enc_g, int n_enc_layers,
                           int enc_act, const void* const* edge_w, const void* const* edge_g,
                           int n_edge_layers, int edge_act, const void* const* node_w,
                           const void* const* node_g, int n_node_layers, int node_act,
                           void* stream) {
  BwdArgs a = {};
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.receivers = static_cast<const int32_t*>(receivers);
  a.n_nodes = n_nodes;
  a.total_rows = total_rows;
  if (!make_bwd_args(&a, x, e, agg, g_xout, g_eout, dx, de, dea, senders, mask, order, offsets,
                     batch, fe, enc_w, enc_g, n_enc_layers, enc_act, edge_w, edge_g,
                     n_edge_layers, edge_act, node_w, node_g, n_node_layers, node_act))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdKernel rows[3] = {GNW(csr_row_bwd)<false, 2>, GNW(csr_row_bwd)<true, 2>,
                            GNW(csr_row_bwd)<true, 1>};
  return static_cast<int>(launch_bwd(a, static_cast<bf16*>(scratch), static_cast<float*>(part),
                                     static_cast<cudaStream_t>(stream), rows, GNW(csr_send)));
}
