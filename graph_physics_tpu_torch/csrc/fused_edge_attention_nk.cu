// Edge-masked multi-head attention forward on the uniform-degree ("NK")
// slot layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention_nk.py: _nk_fwd_kernel (:476, body _nk_common :437),
// called by fused_edge_attention_nk (:545), with its world-edge seam
// (has_world, :455-466). Same function (ea_fwd.cuh states it): receiver
// r's rows are its K slots, slot s = g·K·nb + k·nb + r' for receiver g·nb + r' (ops/
// tiling.py), masked ones among them; a receiver of any K. The Pallas
// kernel rounds each q·k and p·v product to bf16; this one keeps them
// exact in fp32, as the CSR forward does (one rounding contract for both
// layouts). When asked (the forward under autograd), it also writes the
// softmax statistics the backward (fused_edge_attention_nk_bwd.cu) reuses.
//
// Every head width dividing 128 has an instance (ea_common.cuh: Head<DH>).
//
// What bounds it on this card: the transformer slice (1,920 receivers x
// 64 samples x 4 heads x dh 16, K=6) does ~0.19 GFLOP a block and must
// read q, k, v once and write the output: 4 x 15.7 MB = 63 MB, ~0.019 ms
// at 3.35 TB/s (under autograd the statistics add 3.9 MB: m and inv, fp32
// [1,920, 64, 4] each). It is bound by memory traffic. k and v (31 MB) fit
// in the 50 MB L2, so the K-fold sender gather mostly hits L2.
//
// What the design does about it: the forward body of ea_fwd.cuh, shared
// with the CSR forward (fused_edge_attention_csr.cu), on the NK row map
// (gn_rows.cuh:NkRows: first g·K·nb + r', K rows at stride nb): one walk
// of the receiver's valid slots, a warp per receiver over its (sample,
// head) pair groups, the slot indices staged per warp, a chunk of 4 slots'
// k and v copied by cp.async into shared memory (ea_common.cuh).

#include "ea_fwd.cuh"

namespace {

template <int DH, bool WORLD>
__global__ void __launch_bounds__(ea::THREADS, ea::MIN_BLOCKS)
    ea_nk_fwd_kernel(const ea::FwdArgs a) {
  ea::fwd_body<DH, gn_rows::NkRows, WORLD>(a);
}

// the instances, by head width and world seam (ea::FwdLaunch)
struct NkFwd {
  template <int DH, bool WORLD>
  static ea::FwdKernel kernel() { return ea_nk_fwd_kernel<DH, WORLD>; }
};

}  // namespace

// q, k, v, out: contiguous bf16 [n_nodes, batch, heads, head_dim]; m, inv:
// fp32 [n_nodes, batch, heads], both null or both given (then written);
// senders (int32) and mask (bool) hold one entry per slot, k_slots *
// n_nodes in all, receiver g·nb + r owning slots g·k_slots·nb + k·nb + r
// (nb = node_block); num_w (fp32 [n_nodes, batch, heads, head_dim]),
// den_w and s_w (fp32 [n_nodes, batch, heads]): the world pieces, all
// null without world edges; out32 (fp32 [n_nodes, batch, heads,
// head_dim]) the output before rounding, given with the world pieces and
// m, inv, else null. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ea_nk_fwd(const void* q, const void* k, const void* v, void* out, void* m,
                         void* inv, const void* senders, const void* mask, const void* num_w,
                         const void* den_w, const void* s_w, void* out32, int n_nodes, int batch,
                         int heads, int head_dim, int k_slots, int node_block, void* stream) {
  ea::FwdArgs a = {};
  a.k_slots = k_slots;
  a.node_block = node_block;
  a.total_rows = n_nodes * k_slots;
  if (k_slots < 1 || node_block < 1 || n_nodes % node_block != 0 ||
      !ea::make_fwd_args(&a, q, k, v, out, m, inv, senders, mask, num_w, den_w, s_w, out32,
                          n_nodes, batch, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  return ea::launch_fwd<NkFwd>(a, head_dim, stream);
}
