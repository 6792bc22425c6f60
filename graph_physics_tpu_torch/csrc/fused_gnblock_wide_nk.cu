// Fused GraphNetBlock forward on the uniform-degree ("NK") slot layout at
// hidden 64 and 128, for Hopper (sm_90a), on wgmma warpgroup tiles; compiled
// once per width (-DGN_WIDE_H=64 or 128, ops/kernel_build.py: FLAGS).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock_nk.py:
// _nk_fwd_kernel (:147), called by fused_gn_block_nk (:332), at the hidden
// widths that are not 32 (fused_gnblock_nk.cu keeps hidden 32). The
// function, the bound and the passes are gn_wide_fwd.cuh's, on the NK row
// map (gn_rows.cuh:NkRows): receiver g·nb + r' owns slots g·K·nb + k·nb +
// r', every slot belongs to its receiver (every warp of a warpgroup walks
// K rows), and a masked slot gives h = 0 and e_out = e_in.

#include "gn_wide_fwd.cuh"

using namespace gnw;

namespace {

template <bool LAST, bool ACTS, int WGS>
__global__ void __launch_bounds__(WG_THREADS * WGS, 1)
    GNW(nk_edge_fwd)(const __grid_constant__ FwdArgs a) {
  extern __shared__ unsigned char edge_smem[];
  edge_fwd_body<NkRows, LAST, ACTS, WGS>(a, edge_smem);
}

}  // namespace

extern "C" int gnw_hidden() { return H; }

// bytes of the packed MLPs (``img``) a forward or backward call takes
extern "C" long long gnw_image_bytes(int fe, int n_enc_layers, int n_edge_layers,
                                     int n_node_layers) {
  return image_bytes_of(fe, n_enc_layers, n_edge_layers, n_node_layers);
}

// Each weight list holds 2 * n_layers + 1 pointers (1 to 8 layers): w0,
// b0, w1, b1, ..., then the RMSNorm scale (null without a norm). fe > 0
// folds the edge encoder in (e is the raw [S, B, fe] array); e_out null
// marks the last block. xkr, xks
// are [n_nodes, batch, H] bf16 scratch, ein a [S, batch, H] scratch for
// the encoder's output on a folded last block (else unused), agg receives
// the bf16 aggregate [n_nodes, batch, H], to which extra, when not null (a
// bf16 [n_nodes, batch, H] aggregate: the world edges'), is added; img
// holds gnw_image_bytes(...) bytes for the packed MLPs. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int gnw_nk_fwd(const void* x, const void* e, void* xkr, void* xks, void* ein,
                          void* img, void* x_out, void* e_out, void* agg, const void* extra,
                          const void* senders, const void* mask, int n_nodes, int batch,
                          int k_slots, int node_block, int fe, const void* const* enc_w,
                          int n_enc_layers, int enc_act, const void* const* edge_w,
                          int n_edge_layers, int edge_act, const void* const* node_w,
                          int n_node_layers, int node_act, void* stream) {
  FwdArgs a = {};
  Mlp enc = {};
  a.k_slots = k_slots;
  a.node_block = node_block;
  a.n_nodes = n_nodes;
  a.total_rows = n_nodes * k_slots;
  if (k_slots < 1 || node_block < 1 || n_nodes % node_block != 0 ||
      !make_fwd_args(&a, &enc, x, e, xkr, xks, x_out, e_out, agg, extra, senders, mask, batch,
                     fe, enc_w, n_enc_layers, enc_act, edge_w, n_edge_layers, edge_act, node_w,
                     n_node_layers, node_act) ||
      (fe > 0 && e_out == nullptr && ein == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdKernel mid[3] = {GNW(nk_edge_fwd)<false, false, 2>, GNW(nk_edge_fwd)<false, true, 2>,
                            GNW(nk_edge_fwd)<false, true, 1>};
  const FwdKernel last[3] = {GNW(nk_edge_fwd)<true, false, 2>, GNW(nk_edge_fwd)<true, true, 2>,
                             GNW(nk_edge_fwd)<true, true, 1>};
  return static_cast<int>(launch_fwd<NkRows>(a, static_cast<const bf16*>(e),
                                            static_cast<bf16*>(ein), enc, fe,
                                            static_cast<unsigned char*>(img),
                                            static_cast<cudaStream_t>(stream), mid, last));
}
