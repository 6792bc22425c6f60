// Fused GraphNetBlock forward on the receiver-sorted CSR edge layout, for
// Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock.py:
// _fwd_kernel (:392), called by fused_gn_block (:687), with its extra_agg
// seam (:399) and without the lane tiling and the runtime tiling_idx.
// Same function, on a graph of any degree (gn_fwd.cuh states it):
// receiver r's rows are s = row_ptr[r] .. row_ptr[r+1]-1; the padding rows
// after row_ptr[N] belong to no receiver and get e_out = e_in.
//
// What bounds it on this card: at hidden 32 an edge row costs 4.1k
// multiply-adds (its first layer 1k, the per-node partials 2k a node)
// against 128 bytes of edge traffic (read e, write e_out). On the graded
// airfoil-sized slice (27,008 receivers x 16 samples, 160,612 edges) that
// is ~27 GFLOP against ~0.41 GB: 0.027 ms on the bf16 tensor cores (989
// TFLOP/s), 0.12 ms of HBM traffic at 3.35 TB/s. So on the tensor cores it
// is bound by bytes; as fp32 FMAs on the CUDA cores (its first version,
// one thread per (receiver, sample)) it was bound by operations (0.4 ms
// at 67 TFLOP/s) and took 3.48 ms, its warps waiting on their longest
// receiver's rows (in-degrees 2 to 13).
//
// What the design does about it: the forward body of gn_fwd.cuh on the
// CSR row map (gn_rows.cuh:CsrRows), shared with the NK forward
// (fused_gnblock_nk.cu): the tile pre-pass, then one warp per (receiver,
// 16-sample chunk) with every product an mma.sync bf16 -> fp32 tile, so
// receivers of different degree run on different warps; the padding rows
// are work items of their own after the receivers.

#include "gn_fwd.cuh"

using namespace gn_fwd;

namespace {

// W = H: the kernel's name carries the width; ACTS: gn_tile.cuh:fix_act
template <int W, bool FOLD, bool LAST, bool ACTS>
__global__ void __launch_bounds__(FWD_THREADS) gn_csr_fwd_kernel(const FwdArgs a) {
  fwd_body<CsrRows, FOLD, LAST, ACTS>(a);
}

template <bool ACTS>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  return launch_fwd<CsrRows>(
      a, stream, gn_csr_fwd_kernel<H, false, false, ACTS>, gn_csr_fwd_kernel<H, false, true, ACTS>,
      gn_csr_fwd_kernel<H, true, false, ACTS>, gn_csr_fwd_kernel<H, true, true, ACTS>);
}

}  // namespace

// Each weight list holds 2 * n_layers + 1 pointers: w0, b0, w1, b1, ...,
// then the RMSNorm scale (null without a norm); each MLP's activation is a
// code (act_common.cuh: mlp_act::Kind). fe > 0 folds the edge
// encoder in (e is the raw [S, B, fe] array); e_out null marks the last
// block. xks is a [n_nodes, batch, H] bf16 scratch; agg_out, when not
// null, receives the bf16 aggregate [n_nodes, batch, H] for the backward;
// extra, when not null, is a bf16 [n_nodes, batch, H] aggregate added to
// the messages' (the world edges'). Returns the CUDA error code of the
// launches (0 on success).
extern "C" int gn_csr_fwd(const void* x, const void* e, void* xks, void* x_out, void* e_out,
                          void* agg_out, const void* extra, const void* row_ptr,
                          const void* senders, const void* mask, int n_nodes, int batch,
                          int total_rows, int fe, const void* const* enc_w, int n_enc_layers,
                          int enc_act, const void* const* edge_w, int n_edge_layers, int edge_act,
                          const void* const* node_w, int n_node_layers, int node_act,
                          void* stream) {
  FwdArgs a = {};
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.n_nodes = n_nodes;
  a.total_rows = total_rows;
  if (!make_fwd_args(&a, x, e, xks, x_out, e_out, agg_out, extra, senders, mask, batch, fe,
                     enc_w, n_enc_layers, enc_act, edge_w, n_edge_layers, edge_act, node_w,
                     n_node_layers, node_act))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(any_act(a) ? launch<true>(a, st) : launch<false>(a, st));
}
