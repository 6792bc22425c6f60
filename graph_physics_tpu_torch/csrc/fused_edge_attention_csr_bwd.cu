// Edge-masked multi-head attention backward on the receiver-sorted CSR edge
// layout, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/
// fused_edge_attention.py: _bwd_kernel (:143), called by the custom VJP of
// fused_edge_attention (pallas_call :360), without the world-edge sidecar.
// Same function, on a graph of any degree: for every receiver r, sample b
// and head h, over r's valid rows s with sender j_s, from the forward's
// output out[r] and the statistics it kept (fused_edge_attention_csr.cu:
// the max m and inv = 1 / the softmax's denominator, 0 for a receiver
// with no valid row),
//   l_s    = sum_d q[r,d] * k[j_s,d] / sqrt(dh)
//   p_s    = bf16(exp(l_s - m))                      (the forward's p_s)
//   gp     = bf16(g_out[r] * inv)
//   s_r    = bf16(sum_d gp[d] * out[r,d])            (= inv · sum_s p_s·abar_s)
//   abar_s = bf16(sum_d v[j_s,d] * gp[d])
//   g_s    = bf16(bf16(p_s * bf16(abar_s - s_r)) / sqrt(dh))
//   dq[r]  = bf16(sum_s g_s * k[j_s])
// and at every sender j, over the valid rows s that send from j,
//   dk[j] = bf16(sum_s g_s * q[r_s]),  dv[j] = bf16(sum_s p_s * gp[r_s]).
// Rounding: every product is of two bf16 values, exact in fp32, and every
// sum is fp32; the values shown round to bf16. s_r is FlashAttention's D
// term, taken from the forward's bf16 output instead of a walk over the
// rows. A receiver with no valid row has inv = 0: its dq
// and everything it sends back are exactly 0; a node that sends on no
// valid row gets dk = dv = 0.
//
// What bounds it on this card: the graded transformer slice (27,008 nodes
// x 16 samples x 4 heads x dh 16, 160,612 edges) must read q, k, v and
// g_out and write dq, dk and dv, 7 x 55 MB = 387 MB: 0.116 ms at 3.35 TB/s
// with the row arrays; its ~1.6 GFLOP are nothing beside that. It is
// bound by memory traffic. This design also reads the forward's output
// (55 MB) and statistics (13.8 MB: m and inv, fp32 [27,008, 16, 4] each)
// in place of a second walk of the rows. Each edge also gathers 2 KB
// rows, k and v at its sender in the receiver pass, q and g_out at its
// receiver in the sender pass: 1.3 GB through L2, which sets the pace.
//
// What the design does about it: two passes, no atomics (deterministic),
// each on the forward's layout: a warp per node walking its pair groups in
// turn, its row indices staged per warp, a chunk of 4 rows' gathers copied
// by cp.async into the warp's shared memory, 64 registers a thread
// (ea_csr_common.cuh).
//  1. receiver pass: one walk of each receiver's valid rows, reading k
//     and v once: l_s, p_s, abar_s and g_s, and the sum dq. It keeps p_s
//     and g_s, both bf16 values, for the sender pass, as one bf16 pair a
//     (row, sample, head) at the row's place in the transpose: pg [S, B,
//     H] (41 MB at the graded shape). The max and the denominator are the
//     forward's; nothing else is recomputed or kept.
//  2. sender pass: a warp per (sender, pair groups) walks the places of
//     the valid rows that send from j (the transpose of the CSR rows,
//     built once per layout by the wrapper), 32 receivers' indices staged
//     at a time, reads pg there contiguously, gathers q and g_out of the
//     row's receiver and its inv, and sums g_s · q and p_s · gp, gp formed
//     in registers.

#include "ea_csr_common.cuh"

namespace {

using ea_csr::CHUNK;
using ea_csr::EPL;
using ea_csr::FULL;
using ea_csr::Head;
using ea_csr::Lane;
using ea_csr::Packed;
using ea_nk::bf;

struct Args {
  const __nv_bfloat16* q;      // [N, B, H, dh]
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* out;    // [N, B, H, dh] the forward's output
  const float* m;              // [N, B, H] the forward's max logit
  const float* inv;            // [N, B, H] 1 / the forward's denominator
  const __nv_bfloat16* g_out;  // [N, B, H, dh] cotangent of the output
  const int32_t* row_ptr;      // [N + 1] receiver r owns rows row_ptr[r]:row_ptr[r+1]
  const int32_t* senders;      // [S] sender per row (0 on padding)
  const uint8_t* mask;         // [S] 1 on valid rows
  // the transpose: the valid rows sorted by sender, node j sending on
  // places offsets[j]:offsets[j+1]; place[s] is row s's place, recv[i]
  // the receiver of the row at place i
  const int32_t* offsets;      // [N + 1]
  const int32_t* place;        // [S]
  const int32_t* recv;         // [S]
  __nv_bfloat16* dq;           // [N, B, H, dh]
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  uint32_t* pg;                // [S, B, H] scratch: bf16 pair (p_s, g_s) by place, valid rows
  int n_nodes, batch, heads;
};

template <int DH>
__global__ void __launch_bounds__(ea_csr::THREADS, ea_csr::MIN_BLOCKS)
    ea_csr_bwd_recv_kernel(const Args a) {
  const int pairs = a.batch * a.heads;
  Lane<DH> ln(pairs);
  if (ln.node >= a.n_nodes) return;  // the whole warp
  extern __shared__ uint4 smem[];
  const ea_csr::Stage<2> stage(smem);  // k and v of a chunk of rows
  const int r = ln.node;
  const int begin = a.row_ptr[r], end = a.row_ptr[r + 1];
  const int lane = threadIdx.x % 32;
  int sender0 = 0, place0 = 0;  // the first 32 rows, kept for every group
  bool ok0 = false;
  if (begin + lane < end) {
    sender0 = a.senders[begin + lane];
    place0 = a.place[begin + lane];
    ok0 = a.mask[begin + lane] != 0;
  }

  for (int grp = ln.first; grp < ln.last; ++grp) {  // warp-uniform
    ln.group(grp, pairs);
    const Packed qv = ea_csr::load_packed(a.q + ln.at(r, pairs));
    float gv[EPL], ov[EPL];
    ea_nk::load_vec<EPL>(gv, a.g_out + ln.at(r, pairs));
    ea_nk::load_vec<EPL>(ov, a.out + ln.at(r, pairs));
    const float m = a.m[ln.stat(r, pairs)], inv = a.inv[ln.stat(r, pairs)];
    float sr = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      gv[e] = bf(gv[e] * inv);
      sr = fmaf(gv[e], ov[e], sr);
    }
    const Packed gp = ea_csr::pack(gv);
#pragma unroll
    for (int o = 1; o < Head<DH>::LPP; o *= 2) sr += __shfl_xor_sync(FULL, sr, o);
    sr = bf(sr);

    float dq[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) dq[e] = 0.f;
    for (int base = begin; base < end; base += 32) {
      int sender = sender0, place = place0;
      bool ok = ok0;
      if (base != begin) {  // the next 32 rows
        sender = place = 0;
        ok = false;
        if (base + lane < end) {
          sender = a.senders[base + lane];
          place = a.place[base + lane];
          ok = a.mask[base + lane] != 0;
        }
      }
      unsigned left = __ballot_sync(FULL, ok);
      while (left) {  // warp-uniform: a chunk of up to CHUNK valid rows
        int js[CHUNK], places[CHUNK];
        int count = 0;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const int from = left ? __ffs(left) - 1 : 0;
          js[c] = __shfl_sync(FULL, sender, from);
          places[c] = __shfl_sync(FULL, place, from);
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
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < count) {
            const Packed kr = stage.get(c, 0);
            const float l = ea_csr::pair_dot<DH>(qv, kr) * Head<DH>::SCALE;
            const float p = bf(expf(l - m));
            const float abar = bf(ea_csr::pair_dot<DH>(gp, stage.get(c, 1)));
            const float g = bf(bf(p * bf(abar - sr)) * Head<DH>::SCALE);
            float kv[EPL];
            ea_csr::unpack(kv, kr);
#pragma unroll
            for (int e = 0; e < EPL; ++e) dq[e] = fmaf(g, kv[e], dq[e]);
            if (ln.writes_pair()) a.pg[ln.stat(places[c], pairs)] = ea_csr::pack2(p, g);
          }
      }
    }
    if (ln.active) ea_nk::store_vec<EPL>(a.dq + ln.at(r, pairs), dq);
  }
}

template <int DH>
__global__ void __launch_bounds__(ea_csr::THREADS, ea_csr::MIN_BLOCKS)
    ea_csr_bwd_send_kernel(const Args a) {
  const int pairs = a.batch * a.heads;
  Lane<DH> ln(pairs);
  if (ln.node >= a.n_nodes) return;  // the whole warp
  extern __shared__ uint4 smem[];
  const ea_csr::Stage<2> stage(smem);  // q and g_out of a chunk of rows' receivers
  const int j = ln.node;
  const int lo = a.offsets[j], hi = a.offsets[j + 1];
  const int lane = threadIdx.x % 32;
  // the receivers of the first 32 rows sending from j, kept for every group
  const int recv0 = lo + lane < hi ? a.recv[lo + lane] : 0;

  for (int grp = ln.first; grp < ln.last; ++grp) {  // warp-uniform
    ln.group(grp, pairs);
    float dk[EPL], dv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) dk[e] = dv[e] = 0.f;
    for (int base = lo; base < hi; base += 32) {
      int recv = recv0;
      if (base != lo) recv = base + lane < hi ? a.recv[base + lane] : 0;  // the next 32
      const int n = min(32, hi - base);
      for (int head = 0; head < n; head += CHUNK) {  // warp-uniform
        const int count = min(CHUNK, n - head);
        int rs[CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) rs[c] = __shfl_sync(FULL, recv, (head + c) & 31);
        uint32_t pgs[CHUNK];
        float invs[CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < count) {
            stage.load(c, 0, a.q + ln.at(rs[c], pairs));
            stage.load(c, 1, a.g_out + ln.at(rs[c], pairs));
            pgs[c] = __ldg(a.pg + ln.stat(base + head + c, pairs));
            invs[c] = __ldg(a.inv + ln.stat(rs[c], pairs));
          }
        stage.wait();
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < count) {
            const float p = ea_csr::lo_of(pgs[c]), g = ea_csr::hi_of(pgs[c]);
            float qv[EPL], go[EPL];
            ea_csr::unpack(qv, stage.get(c, 0));
            ea_csr::unpack(go, stage.get(c, 1));
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
              dk[e] = fmaf(g, qv[e], dk[e]);
              dv[e] = fmaf(p, bf(go[e] * invs[c]), dv[e]);
            }
          }
      }
    }
    if (ln.active) {
      ea_nk::store_vec<EPL>(a.dk + ln.at(j, pairs), dk);
      ea_nk::store_vec<EPL>(a.dv + ln.at(j, pairs), dv);
    }
  }
}

template <int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int grid = ea_csr::grid_for<DH>(a.n_nodes, a.batch * a.heads);
  constexpr int smem = ea_csr::Stage<2>::BYTES;
  ea_csr_bwd_recv_kernel<DH><<<grid, ea_csr::THREADS, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ea_csr_bwd_send_kernel<DH><<<grid, ea_csr::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out, g_out, dq, dk, dv: contiguous bf16 [n_nodes, batch, heads,
// head_dim]; m, inv: the forward's fp32 [n_nodes, batch, heads]; row_ptr
// (int32, n_nodes + 1 entries) indexes the rows of senders (int32) and
// mask (bool); offsets (int32, [n_nodes + 1]), place and recv (int32,
// [rows]) the transpose of the rows: node j sends on places
// offsets[j]:offsets[j+1], row s has place place[s], and the row at place
// i has receiver recv[i]; pg: 32-bit [rows, batch, heads] scratch. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int ea_csr_bwd(const void* q, const void* k, const void* v, const void* out,
                          const void* m, const void* inv, const void* g_out, const void* row_ptr,
                          const void* senders, const void* mask, const void* offsets,
                          const void* place, const void* recv, void* dq, void* dk, void* dv,
                          void* pg, int n_nodes, int batch, int heads, int head_dim,
                          void* stream) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<const __nv_bfloat16*>(out);
  a.m = static_cast<const float*>(m);
  a.inv = static_cast<const float*>(inv);
  a.g_out = static_cast<const __nv_bfloat16*>(g_out);
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.senders = static_cast<const int32_t*>(senders);
  a.mask = static_cast<const uint8_t*>(mask);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.place = static_cast<const int32_t*>(place);
  a.recv = static_cast<const int32_t*>(recv);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.pg = static_cast<uint32_t*>(pg);
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.heads = heads;
  if (n_nodes < 1 || batch < 1 || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch<16>(a, st));
    case 32: return static_cast<int>(launch<32>(a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
