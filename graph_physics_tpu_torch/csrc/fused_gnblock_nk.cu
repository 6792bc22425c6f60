// Fused GraphNetBlock forward on the uniform-degree ("NK") slot layout,
// for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock_nk.py:
// _nk_fwd_kernel (:147), called by fused_gn_block_nk (:332). Same function
// (gn_fwd.cuh states it): receiver r's rows are its K slots, slot
// s = g·K·nb + k·nb + r' for receiver g·nb + r' (ops/tiling.py); every
// slot belongs to its receiver, and a masked slot gives h = 0 and
// e_out = e_in. Under autograd it also writes the bf16 aggregate the
// backward (fused_gnblock_nk_bwd.cu) reads: 15.7 MB a block at B=128.
// A node-aligned extra aggregate (the world edges', _nk_fwd_kernel's
// has_extra_agg, :154 and :218) joins the rounded sum before the node
// MLP. The first edge layer adds the per-node partials bf16(x @ Kr) and
// bf16(x @ Ks) to the fp32 e_in @ Ke, as the JAX kernel's _edge_fwd
// (:130-134) does and as the backward rebuilds it.
//
// What bounds it on this card: at hidden 32 every valid slot costs ~4.1k
// multiply-adds in the edge MLP (its first layer 1k, the per-node partials
// 2k a node) against 128 bytes of slot traffic (read e, write e_out), so a
// middle block does ~15 GFLOP on the cylinder batch (1,920 receivers x 128
// samples x 6 slots) while moving ~0.22 GB: 0.015 ms on the bf16 tensor
// cores (989 TFLOP/s), 0.066 ms of HBM traffic at 3.35 TB/s, so bound by
// bytes; as fp32 FMAs on the CUDA cores the products alone would take
// ~0.22 ms at the 67 TFLOP/s fp32 peak.
//
// What the design does about it: the forward body of gn_fwd.cuh, shared
// with the CSR forward (fused_gnblock_csr.cu), on the NK row map
// (gn_rows.cuh:NkRows), as the backward runs the CSR backward's passes on
// it: the tile pre-pass (gn_tile.cuh:gn_partial_tc_kernel) writes
// bf16(x @ Ks), then one warp per (receiver, 16-sample chunk), 8 chunks a
// receiver at B=128, walks the receiver's K slots (stride nb) with every
// MLP product an mma.sync.m16n8k16 bf16 -> fp32 tile; a slot's 16 samples
// are one contiguous 1 KB tile, the K-sum stays in accumulator fragments
// (no atomics), and the weights sit in shared memory as bf16 tiles. The
// MLPs may have 1 to 8 Dense layers. There are no padding rows, so the
// body's padding items compile away.

#include "gn_fwd.cuh"

using namespace gn_fwd;

namespace {

// W = H: the kernel's name carries the width; ACTS: gn_tile.cuh:fix_act
template <int W, bool FOLD, bool LAST, bool ACTS>
__global__ void __launch_bounds__(FWD_THREADS) gn_nk_fwd_kernel(const FwdArgs a) {
  fwd_body<NkRows, FOLD, LAST, ACTS>(a);
}

template <bool ACTS>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  return launch_fwd<NkRows>(
      a, stream, gn_nk_fwd_kernel<H, false, false, ACTS>, gn_nk_fwd_kernel<H, false, true, ACTS>,
      gn_nk_fwd_kernel<H, true, false, ACTS>, gn_nk_fwd_kernel<H, true, true, ACTS>);
}

}  // namespace

// Each weight list holds 2 * n_layers + 1 pointers: w0, b0, w1, b1, ...,
// then the RMSNorm scale (null without a norm); each MLP's activation is a
// code (act_common.cuh: mlp_act::Kind). fe > 0 folds the edge
// encoder in (e is the raw [S, B, fe] array); e_out null marks the last
// block. xks is a [n_nodes, batch, H] bf16 scratch; agg_out, when not
// null, receives the bf16 aggregate [n_nodes, batch, H] for the
// backward; extra, when not null, is a bf16 [n_nodes, batch, H] aggregate
// added to the messages' (the world edges'). Returns the CUDA error code of
// the launches (0 on success).
extern "C" int gn_nk_fwd(const void* x, const void* e, void* xks, void* x_out, void* e_out,
                         void* agg_out, const void* extra, const void* senders, const void* mask,
                         int n_nodes, int batch, int k_slots, int node_block, int fe,
                         const void* const* enc_w, int n_enc_layers, int enc_act,
                         const void* const* edge_w, int n_edge_layers, int edge_act,
                         const void* const* node_w, int n_node_layers, int node_act, void* stream) {
  FwdArgs a = {};
  a.k_slots = k_slots;
  a.node_block = node_block;
  a.n_nodes = n_nodes;
  a.total_rows = n_nodes * k_slots;
  if (k_slots < 1 || node_block < 1 || n_nodes % node_block != 0 ||
      !make_fwd_args(&a, x, e, xks, x_out, e_out, agg_out, extra, senders, mask, batch, fe,
                     enc_w, n_enc_layers, enc_act, edge_w, n_edge_layers, edge_act, node_w,
                     n_node_layers, node_act))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(any_act(a) ? launch<true>(a, st) : launch<false>(a, st));
}
