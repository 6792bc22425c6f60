// Edge-masked multi-head attention forward on the receiver-sorted CSR edge
// layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention.py: _fwd_kernel (:124, body _attn_common :63),
// called by fused_edge_attention (:206), with its world-edge seam (has_world).
// Same function (ea_fwd.cuh states it), on a graph of any degree: receiver
// r's rows are s = row_ptr[r] .. row_ptr[r+1]-1. When asked (the forward
// under autograd), it also writes the softmax statistics the backward
// (fused_edge_attention_csr_bwd.cu) reuses. Given the world pieces, the
// joint mesh + world softmax (ea_fwd.cuh): their extra reads (num_w fp32,
// 4 bytes a value; den_w, s_w) outweigh q, k or v at a plate shape.
//
// Every head width dividing 128 has an instance (ea_common.cuh: Head<DH>).
//
// What bounds it on this card: the graded transformer slice (27,008
// receivers x 16 samples x 4 heads x dh 16, 160,612 edges) does ~0.66 GFLOP
// a block and must read q, k, v once and write the output: 4 x 55 MB =
// 221 MB, 0.066 ms at 3.35 TB/s (under autograd the statistics add 13.8
// MB: m and inv, fp32 [27,008, 16, 4] each). It is bound
// by memory traffic. Each edge also gathers its sender's k and v rows
// (2 KB each): 0.66 GB through L2, which k and v (111 MB) exceed; the
// nodes are sorted along x, so a receiver's senders lie in a narrow band
// that stays in L2, and the gathers, not HBM, set the pace.
//
// What the design does about it: the forward body of ea_fwd.cuh, shared
// with the NK forward (fused_edge_attention_nk.cu), on the CSR row map
// (gn_rows.cuh:CsrRows): one walk of the rows, a warp per receiver over
// its (sample, head) pair groups, the row indices staged per warp, a chunk
// of 4 rows' k and v copied by cp.async into shared memory (ea_common.cuh).
// The layout (rows a chunk, groups a warp, values a lane, the register
// cap) was the fastest of the alternatives timed on the H100 (PERF.md
// §6).

#include "ea_fwd.cuh"

namespace {

template <int DH, bool WORLD>
__global__ void __launch_bounds__(ea::THREADS, ea::MIN_BLOCKS)
    ea_csr_fwd_kernel(const ea::FwdArgs a) {
  ea::fwd_body<DH, gn_rows::CsrRows, WORLD>(a);
}

// the instances, by head width and world seam (ea::FwdLaunch)
struct CsrFwd {
  template <int DH, bool WORLD>
  static ea::FwdKernel kernel() { return ea_csr_fwd_kernel<DH, WORLD>; }
};

}  // namespace

// q, k, v, out: contiguous bf16 [n_nodes, batch, heads, head_dim]; m, inv:
// fp32 [n_nodes, batch, heads], both null or both given (then written);
// row_ptr (int32, n_nodes + 1 entries) indexes the rows of senders (int32)
// and mask (bool); num_w (fp32 [n_nodes, batch, heads, head_dim]), den_w
// and s_w (fp32 [n_nodes, batch, heads]): the world pieces, all null
// without world edges; out32 (fp32 [n_nodes, batch, heads, head_dim]) the
// output before rounding, given with the world pieces and m, inv, else
// null. Returns the CUDA error code of the launch (0 on success).
extern "C" int ea_csr_fwd(const void* q, const void* k, const void* v, void* out, void* m,
                          void* inv, const void* row_ptr, const void* senders, const void* mask,
                          const void* num_w, const void* den_w, const void* s_w, void* out32,
                          int n_nodes, int batch, int heads, int head_dim, void* stream) {
  ea::FwdArgs a = {};
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  if (!ea::make_fwd_args(&a, q, k, v, out, m, inv, senders, mask, num_w, den_w, s_w, out32,
                         n_nodes, batch, heads, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  return ea::launch_fwd<CsrFwd>(a, head_dim, stream);
}
