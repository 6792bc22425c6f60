// Fused GraphNetBlock forward on the receiver-sorted CSR edge layout at
// hidden 64 and 128, for Hopper (sm_90a), on wgmma warpgroup tiles; compiled
// once per width (-DGN_WIDE_H=64 or 128, ops/kernel_build.py: FLAGS).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock.py:
// _fwd_kernel (:392), called by fused_gn_block (:687), at the hidden widths
// that are not 32 (fused_gnblock_csr.cu keeps hidden 32), with its
// extra_agg seam (:399) and without the lane tiling and the runtime
// tiling_idx. The function, the
// bound and the passes are gn_wide_fwd.cuh's, on the CSR row map
// (gn_rows.cuh:CsrRows): receiver r owns rows row_ptr[r]..row_ptr[r+1]-1
// (a warp walks its receiver's range, its warpgroup as many steps as the
// longest of its four), and the padding rows after row_ptr[N] get e_out =
// e_in.

#include "gn_wide_fwd.cuh"

using namespace gnw;

namespace {

template <bool LAST, bool ACTS, int WGS>
__global__ void __launch_bounds__(WG_THREADS * WGS, 1)
    GNW(csr_edge_fwd)(const __grid_constant__ FwdArgs a) {
  extern __shared__ unsigned char edge_smem[];
  edge_fwd_body<CsrRows, LAST, ACTS, WGS>(a, edge_smem);
}

}  // namespace

extern "C" int gnw_hidden() { return H; }

// bytes of the packed MLPs (``img``) a forward or backward call takes
extern "C" long long gnw_image_bytes(int fe, int n_enc_layers, int n_edge_layers,
                                     int n_node_layers) {
  return image_bytes_of(fe, n_enc_layers, n_edge_layers, n_node_layers);
}

// As gnw_nk_fwd (fused_gnblock_wide_nk.cu), with the CSR rows: row_ptr
// [n_nodes + 1] and total_rows rows, padding included.
extern "C" int gnw_csr_fwd(const void* x, const void* e, void* xkr, void* xks, void* ein,
                           void* img, void* x_out, void* e_out, void* agg, const void* extra,
                           const void* row_ptr, const void* senders, const void* mask, int n_nodes,
                           int batch, int total_rows, int fe, const void* const* enc_w,
                           int n_enc_layers, int enc_act, const void* const* edge_w,
                           int n_edge_layers, int edge_act, const void* const* node_w,
                           int n_node_layers, int node_act, void* stream) {
  FwdArgs a = {};
  Mlp enc = {};
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.n_nodes = n_nodes;
  a.total_rows = total_rows;
  if (!make_fwd_args(&a, &enc, x, e, xkr, xks, x_out, e_out, agg, extra, senders, mask, batch,
                     fe, enc_w, n_enc_layers, enc_act, edge_w, n_edge_layers, edge_act, node_w,
                     n_node_layers, node_act) ||
      (fe > 0 && e_out == nullptr && ein == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdKernel mid[3] = {GNW(csr_edge_fwd)<false, false, 2>,
                            GNW(csr_edge_fwd)<false, true, 2>, GNW(csr_edge_fwd)<false, true, 1>};
  const FwdKernel last[3] = {GNW(csr_edge_fwd)<true, false, 2>, GNW(csr_edge_fwd)<true, true, 2>,
                             GNW(csr_edge_fwd)<true, true, 1>};
  return static_cast<int>(launch_fwd<CsrRows>(a, static_cast<const bf16*>(e),
                                             static_cast<bf16*>(ein), enc, fe,
                                             static_cast<unsigned char*>(img),
                                             static_cast<cudaStream_t>(stream), mid, last));
}
