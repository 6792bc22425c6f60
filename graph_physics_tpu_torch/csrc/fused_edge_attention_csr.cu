// Edge-masked multi-head attention forward on the receiver-sorted CSR edge
// layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention.py: _fwd_kernel (:124, body _attn_common :63),
// called by fused_edge_attention (:206), without the world-edge sidecar.
// Same function, on a graph of any degree: for every receiver r, sample b
// and head h, over r's valid rows s = row_ptr[r] .. row_ptr[r+1]-1 with
// sender j,
//   l_s   = sum_d q[r,b,h,d] * k[j,b,h,d] / sqrt(dh)
//   m     = max_s l_s
//   p_s   = bf16(exp(l_s - m))
//   out   = bf16(sum_s p_s * v[j,b,h,:] / sum_s p_s)
// and exactly 0 for a receiver with no valid row. Rounding: every product
// is of two bf16 values, exact in fp32, and every sum is fp32; only p_s
// and the output round to bf16. A receiver of more than 4 valid rows is
// walked in chunks with the online softmax: p_s rounds against the
// running max of the chunks so far and is rescaled by exp(running -
// final) in fp32; where the max does not change the scale is exactly 1. The TPU kernel shifts by one max per
// tile; this one by the receiver's own, which agrees to rounding and
// cannot underflow where a tile's max would. When asked (the forward under
// autograd), it also writes the softmax statistics the backward reuses,
// fp32 [N, B, H]: m (-inf without a valid row) and inv = 1 / sum_s p_s
// (0 without one).
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
// What the design does about it: one walk of the rows, with the loads of
// a chunk of rows in flight and few registers (ea_csr_common.cuh).
//  - A warp per receiver: 2 lanes a (sample, head) pair of head width 16
//    (4 of width 32), 8 values (16 bytes) each, 16 pairs at a time, the
//    warp walking its 4 groups of 16 pairs in turn (8 groups of 8 at
//    width 32: two warps). Each row's k and v reads of a warp are 512
//    contiguous bytes.
//  - The receiver's row indices and mask come in one coalesced load of up
//    to 32 rows, once for all groups, and go round by __shfl_sync; only
//    valid rows are walked.
//  - Rows go in chunks of 4: cp.async copies the chunk's k and v into the
//    warp's shared memory (4 KB), so no register holds a load in flight,
//    and a thread needs 64 registers: 32 warps an SM.
//  - k and v are each read once.
// The layout (rows a chunk, groups a warp, values a lane, the register
// cap) was the fastest of the alternatives timed on the H100 (PERF.md
// §6).

#include "ea_csr_common.cuh"

namespace {

using ea_csr::CHUNK;
using ea_csr::EPL;
using ea_csr::FULL;
using ea_csr::Head;
using ea_csr::Lane;
using ea_csr::Packed;

struct Args {
  const __nv_bfloat16* q;  // [N, B, H, dh]
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;      // [N, B, H, dh]
  float* m;                // [N, B, H] the max logit, or null
  float* inv;              // [N, B, H] 1 / the softmax's denominator, or null
  const int32_t* row_ptr;  // [N + 1] receiver r owns rows row_ptr[r]:row_ptr[r+1]
  const int32_t* senders;  // [S] sender per row (0 on padding)
  const uint8_t* mask;     // [S] 1 on valid rows
  int n_nodes, batch, heads;
};

template <int DH>
__global__ void __launch_bounds__(ea_csr::THREADS, ea_csr::MIN_BLOCKS)
    ea_csr_fwd_kernel(const Args a) {
  const int pairs = a.batch * a.heads;
  Lane<DH> ln(pairs);
  if (ln.node >= a.n_nodes) return;  // the whole warp
  extern __shared__ uint4 smem[];
  const ea_csr::Stage<2> stage(smem);  // k and v of a chunk of rows
  const int r = ln.node;
  const int begin = a.row_ptr[r], end = a.row_ptr[r + 1];
  const int lane = threadIdx.x % 32;
  // the first 32 rows' senders, one a lane, and whether they are valid:
  // kept for every group the warp walks
  int sender0 = 0;
  bool ok0 = false;
  if (begin + lane < end) {
    sender0 = a.senders[begin + lane];
    ok0 = a.mask[begin + lane] != 0;
  }

  for (int grp = ln.first; grp < ln.last; ++grp) {  // warp-uniform
    ln.group(grp, pairs);
    const Packed qv = ea_csr::load_packed(a.q + ln.at(r, pairs));
    float num[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) num[e] = 0.f;
    float den = 0.f, m = -CUDART_INF_F;

    for (int base = begin; base < end; base += 32) {
      int sender = sender0;
      bool ok = ok0;
      if (base != begin) {  // the next 32 rows
        sender = 0;
        ok = false;
        if (base + lane < end) {
          sender = a.senders[base + lane];
          ok = a.mask[base + lane] != 0;
        }
      }
      unsigned left = __ballot_sync(FULL, ok);
      while (left) {  // warp-uniform: a chunk of up to CHUNK valid rows
        int js[CHUNK];
        int count = 0;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const int from = left ? __ffs(left) - 1 : 0;
          js[c] = __shfl_sync(FULL, sender, from);
          if (left) {
            ++count;
            left &= left - 1;
          }
        }
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < count) {
            stage.load(c, 0, a.k + ln.at(js[c], pairs));
            stage.load(c, 1, a.v + ln.at(js[c], pairs));
          }
        stage.wait();
        float l[CHUNK];
        float cmax = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < count) {
            l[c] = ea_csr::pair_dot<DH>(qv, stage.get(c, 0)) * Head<DH>::SCALE;
            cmax = fmaxf(cmax, l[c]);
          }
        // the online softmax: rescale what earlier chunks summed (by
        // exactly 1 where the max holds, by 0 on the first chunk)
        const float mnew = fmaxf(m, cmax);
        const float scale = expf(m - mnew);
        den *= scale;
#pragma unroll
        for (int e = 0; e < EPL; ++e) num[e] *= scale;
        m = mnew;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < count) {
            const float p = ea_nk::bf(expf(l[c] - m));
            float vv[EPL];
            ea_csr::unpack(vv, stage.get(c, 1));
            den += p;
#pragma unroll
            for (int e = 0; e < EPL; ++e) num[e] = fmaf(p, vv[e], num[e]);
          }
      }
    }
    if (ln.active) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) num[e] = den > 0.f ? num[e] / den : 0.f;
      ea_nk::store_vec<EPL>(a.out + ln.at(r, pairs), num);
    }
    if (a.m != nullptr && ln.writes_pair()) {
      a.m[ln.stat(r, pairs)] = m;
      a.inv[ln.stat(r, pairs)] = den > 0.f ? 1.0f / den : 0.f;
    }
  }
}

template <int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int grid = ea_csr::grid_for<DH>(a.n_nodes, a.batch * a.heads);
  ea_csr_fwd_kernel<DH><<<grid, ea_csr::THREADS, ea_csr::Stage<2>::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous bf16 [n_nodes, batch, heads, head_dim]; m, inv:
// fp32 [n_nodes, batch, heads], both null or both given (then written);
// row_ptr (int32, n_nodes + 1 entries) indexes the rows of senders (int32)
// and mask (bool). Returns the CUDA error code of the launch (0 on success).
extern "C" int ea_csr_fwd(const void* q, const void* k, const void* v, void* out, void* m,
                          void* inv, const void* row_ptr, const void* senders, const void* mask,
                          int n_nodes, int batch, int heads, int head_dim, void* stream) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.m = static_cast<float*>(m);
  a.inv = static_cast<float*>(inv);
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.senders = static_cast<const int32_t*>(senders);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.heads = heads;
  if (n_nodes < 1 || batch < 1 || heads < 1 || (m == nullptr) != (inv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch<16>(a, st));
    case 32: return static_cast<int>(launch<32>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
