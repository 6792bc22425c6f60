// The edge-attention backward's two passes, written once for both edge
// layouts: the receiver pass templated on the row map (gn_rows.cuh),
// receiver-sorted CSR rows (fused_edge_attention_csr_bwd.cu) or NK slots
// (fused_edge_attention_nk_bwd.cu); the sender pass walks the layout's
// sender-sorted transpose, the same for both. Each source wraps them in
// kernels of its own names and launches them with launch_bwd. The
// function, for every receiver r, sample b and head h, over r's valid rows
// s with sender j_s, from the forward's output out[r] and the statistics
// it kept (ea_fwd.cuh: the max m and inv = 1 / the softmax's denominator,
// 0 for a receiver with no valid row),
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
// rows. A receiver with no valid row has inv = 0: its dq and everything
// it sends back are exactly 0; a node that sends on no valid row gets
// dk = dv = 0.
//
// The world seam (WORLD, ea_fwd.cuh): the forward's output and statistics
// are then the joint mesh + world ones, so s_r above already holds the
// world's share (the Pallas kernels add it as a separate term, w_sr), and
// the receiver pass also writes the cotangents of the world pieces, with
// w = exp(s_w - m) from the kept joint max m, gp32 = g_out·inv in fp32 and
// the forward's output before rounding (out32, fp32), which also gives s_r:
//   dnum_w[r] = gp32·w                 (fp32 [N, B, H, dh])
//   dden_w[r] = -sum_d out[r,d]·gp32[d]·w   (fp32 [N, B, H])
// s_w takes no gradient; the world edges' q, k and v gradients flow back
// through the pieces' own autograd (ops/edge_attention.
// world_attention_parts). Without WORLD the code and its bits are those
// of the mesh-only kernel.
//
// At head widths 8 and below (Head<DH>::FP32_GRAD, ea_common.cuh says
// why) the per-pair terms stay fp32: gp = g_out·inv, s_r = sum_d
// gp[d]·out32[r,d] from the forward's fp32 output, abar_s = sum_d
// v[j_s,d]·gp[d] and g_s = p_s·(abar_s - s_r)/sqrt(dh); dq sums the fp32
// g_s, the sender pass takes bf16(g_s) from pg and forms gp in fp32 for
// dv.
//
// The design: two passes, no atomics (deterministic), each on the
// forward's layout (ea_common.cuh): a warp per node walking its pair
// groups in turn, its row indices staged per warp, a chunk of 4 rows'
// gathers copied by cp.async into the warp's shared memory, at most 64
// registers a thread.
//  1. receiver pass: one walk of each receiver's valid rows, reading k
//     and v once: l_s, p_s, abar_s and g_s, and the sum dq. It keeps p_s
//     and g_s, both bf16 values, for the sender pass, as one bf16 pair a
//     (row, sample, head) at the row's place in the transpose: pg [S, B,
//     H]. The max and the denominator are the forward's; nothing else is
//     recomputed or kept.
//  2. sender pass: a warp per (sender, pair groups) walks the places of
//     the valid rows that send from j (the transpose of the rows, built
//     once per layout by the wrapper), 32 receivers' indices staged at a
//     time, reads pg there contiguously, gathers q and g_out of the row's
//     receiver and its inv, and sums g_s · q and p_s · gp, gp formed in
//     registers.
#pragma once

#include "ea_common.cuh"

namespace ea {

struct BwdArgs : gn_rows::RowMap {
  const __nv_bfloat16* q;      // [N, B, H, dh]
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* out;    // [N, B, H, dh] the forward's output (without world)
  const float* out32;          // [N, B, H, dh] its output before rounding (with world)
  const float* m;              // [N, B, H] the forward's max logit
  const float* inv;            // [N, B, H] 1 / the forward's denominator
  const __nv_bfloat16* g_out;  // [N, B, H, dh] cotangent of the output
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
  // the world seam, all null without world edges
  const float* s_w;            // [N, B, H] the world pieces' shift
  float* dnum_w;               // [N, B, H, dh]
  float* dden_w;               // [N, B, H]
  int batch, heads;
};

template <int DH, class Rows, bool WORLD>
__device__ __forceinline__ void bwd_recv_body(const BwdArgs& a) {
  constexpr int EPL = Head<DH>::EPL;
  const int pairs = a.batch * a.heads;
  Lane<DH> ln(pairs);
  if (ln.node >= a.n_nodes) return;  // the whole warp
  extern __shared__ uint4 smem[];
  Stage2<DH> stage(smem);  // k and v of a chunk of rows
  const int r = ln.node;
  const Walk<Rows> walk(a, r);
  // the first 32 rows' senders and places, kept for every group
  const long long row0 = walk.row(0);
  const int sender0 = walk.sender(row0, a.senders, a.mask);
  const int place0 = row0 >= 0 ? a.place[row0] : 0;

  for (int grp = ln.first; grp < ln.last; ++grp) {  // warp-uniform
    ln.group(grp, pairs);
    const Packed<EPL> qv = load_packed<EPL>(a.q + ln.at(r, pairs));
    float gv[EPL], ov[EPL];
    load<EPL>(gv, a.g_out + ln.at(r, pairs));
    if (WORLD || Head<DH>::FP32_GRAD)
      loadf<EPL>(ov, a.out32 + ln.at(r, pairs));
    else
      load<EPL>(ov, a.out + ln.at(r, pairs));
    const float m = a.m[ln.stat(r, pairs)], inv = a.inv[ln.stat(r, pairs)];
    if (WORLD) {  // the world pieces' cotangents, before g_out is rounded
      const float w = expf(a.s_w[ln.stat(r, pairs)] - m);
      float dn[EPL];
      float dd = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        dn[e] = gv[e] * inv * w;
        dd = fmaf(ov[e], dn[e], dd);
      }
#pragma unroll
      for (int o = 1; o < Head<DH>::LPP; o *= 2) dd += __shfl_xor_sync(FULL, dd, o);
      if (ln.active) storef<EPL>(a.dnum_w + ln.at(r, pairs), dn);
      if (ln.writes_pair()) a.dden_w[ln.stat(r, pairs)] = -dd;
    }
    constexpr bool F32 = Head<DH>::FP32_GRAD;
    float sr = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      gv[e] = F32 ? gv[e] * inv : bf(gv[e] * inv);
      sr = fmaf(gv[e], ov[e], sr);
    }
    const Packed<EPL> gp = pack<EPL>(gv);  // bf16 values unless F32 (then unused)
#pragma unroll
    for (int o = 1; o < Head<DH>::LPP; o *= 2) sr += __shfl_xor_sync(FULL, sr, o);
    if (!F32) sr = bf(sr);

    float dq[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) dq[e] = 0.f;
    for (int base = 0; base < walk.count; base += 32) {
      int sender = sender0, place = place0;
      if (base != 0) {  // the next 32 rows
        const long long s = walk.row(base);
        sender = walk.sender(s, a.senders, a.mask);
        place = s >= 0 ? a.place[s] : 0;
      }
      unsigned left = __ballot_sync(FULL, sender >= 0);
      while (left) {  // warp-uniform: a chunk of up to CHUNK valid rows
        unsigned froms;
        const int count = take_chunk(left, froms);
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < count) {
            const int j = __shfl_sync(FULL, sender, lane_of(froms, c));
            stage.load(c, 0, a.k + ln.at(j, pairs));
            stage.load(c, 1, a.v + ln.at(j, pairs));
          }
        stage.wait();
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < count) {
            const Packed<EPL> kr = stage.get(c, 0);
            const float l = pair_dot<DH>(qv, kr) * Head<DH>::SCALE;
            const float p = bf(expf(l - m));
            float g;
            if constexpr (F32) {  // a pair a lane (LPP = 1): no butterfly
              float vv[EPL];
              unpack<EPL>(vv, stage.get(c, 1));
              float abar = 0.f;
#pragma unroll
              for (int e = 0; e < EPL; ++e) abar = fmaf(gv[e], vv[e], abar);
              g = p * (abar - sr) * Head<DH>::SCALE;
            } else {
              const float abar = bf(pair_dot<DH>(gp, stage.get(c, 1)));
              g = bf(bf(p * bf(abar - sr)) * Head<DH>::SCALE);
            }
            float kv[EPL];
            unpack<EPL>(kv, kr);
#pragma unroll
            for (int e = 0; e < EPL; ++e) dq[e] = fmaf(g, kv[e], dq[e]);
            const int place_c = __shfl_sync(FULL, place, lane_of(froms, c));
            if (ln.writes_pair()) a.pg[ln.stat(place_c, pairs)] = pack2(p, bf(g));
          }
      }
    }
    if (ln.active) store<EPL>(a.dq + ln.at(r, pairs), dq);
  }
}

template <int DH>
__device__ __forceinline__ void bwd_send_body(const BwdArgs& a) {
  constexpr int EPL = Head<DH>::EPL;
  const int pairs = a.batch * a.heads;
  Lane<DH> ln(pairs);
  if (ln.node >= a.n_nodes) return;  // the whole warp
  extern __shared__ uint4 smem[];
  Stage2<DH> stage(smem);  // q and g_out of a chunk of rows' receivers
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
            const float p = lo_of(pgs[c]), g = hi_of(pgs[c]);
            float qv[EPL], go[EPL];
            unpack<EPL>(qv, stage.get(c, 0));
            unpack<EPL>(go, stage.get(c, 1));
#pragma unroll
            for (int e = 0; e < EPL; ++e) {
              dk[e] = fmaf(g, qv[e], dk[e]);
              const float gp = go[e] * invs[c];
              dv[e] = fmaf(p, Head<DH>::FP32_GRAD ? gp : bf(gp), dv[e]);
            }
          }
      }
    }
    if (ln.active) {
      store<EPL>(a.dk + ln.at(j, pairs), dk);
      store<EPL>(a.dv + ln.at(j, pairs), dv);
    }
  }
}

// The arguments both sources take: q, k, v, out, g_out, dq, dk, dv
// contiguous bf16 [n_nodes, batch, heads, head_dim]; m, inv the forward's
// fp32 [n_nodes, batch, heads]; senders (int32) and mask (bool) one entry
// a row; offsets (int32, [n_nodes + 1]), place and recv (int32, [rows])
// the transpose of the rows; pg 32-bit [rows, batch, heads] scratch; the
// world seam's s_w (fp32 [n_nodes, batch, heads], read), dnum_w (fp32
// [n_nodes, batch, heads, head_dim]) and dden_w (fp32 [n_nodes, batch,
// heads], written), all null or all given; with them, and at head widths
// 8 and below, ``out`` is the forward's fp32 output before rounding (out32).
// False on arguments no launch takes.
inline bool make_bwd_args(BwdArgs* a, const void* q, const void* k, const void* v,
                          const void* out, const void* m, const void* inv, const void* g_out,
                          const void* senders, const void* mask, const void* offsets,
                          const void* place, const void* recv, void* dq, void* dk, void* dv,
                          void* pg, const void* s_w, void* dnum_w, void* dden_w, int n_nodes,
                          int batch, int heads) {
  a->q = static_cast<const __nv_bfloat16*>(q);
  a->k = static_cast<const __nv_bfloat16*>(k);
  a->v = static_cast<const __nv_bfloat16*>(v);
  a->out = static_cast<const __nv_bfloat16*>(out);
  a->out32 = static_cast<const float*>(out);
  a->m = static_cast<const float*>(m);
  a->inv = static_cast<const float*>(inv);
  a->g_out = static_cast<const __nv_bfloat16*>(g_out);
  a->senders = static_cast<const int32_t*>(senders);
  a->mask = static_cast<const uint8_t*>(mask);
  a->offsets = static_cast<const int32_t*>(offsets);
  a->place = static_cast<const int32_t*>(place);
  a->recv = static_cast<const int32_t*>(recv);
  a->dq = static_cast<__nv_bfloat16*>(dq);
  a->dk = static_cast<__nv_bfloat16*>(dk);
  a->dv = static_cast<__nv_bfloat16*>(dv);
  a->pg = static_cast<uint32_t*>(pg);
  a->s_w = static_cast<const float*>(s_w);
  a->dnum_w = static_cast<float*>(dnum_w);
  a->dden_w = static_cast<float*>(dden_w);
  a->n_nodes = n_nodes;
  a->batch = batch;
  a->heads = heads;
  const bool world = s_w != nullptr;
  return n_nodes >= 1 && batch >= 1 && heads >= 1 && (dnum_w != nullptr) == world &&
         (dden_w != nullptr) == world;
}

using BwdKernel = void (*)(BwdArgs);

// launch the source's receiver pass, then its sender pass, for head width
// DH: K::template recv<DH, WORLD>() and K::template send<DH>() are the
// source's instances
template <class K>
struct BwdLaunch {
  const BwdArgs& a;
  cudaStream_t st;
  template <int DH>
  int run() const {
    const int grid = grid_for<DH>(a.n_nodes, a.batch * a.heads);
    constexpr int smem = Stage2<DH>::BYTES;
    const BwdKernel recv =
        a.s_w != nullptr ? K::template recv<DH, true>() : K::template recv<DH, false>();
    const BwdKernel send = K::template send<DH>();
    recv<<<grid, THREADS, smem, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    send<<<grid, THREADS, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

// launch both passes for any head width dividing 128
template <class K>
inline int launch_bwd(const BwdArgs& a, int head_dim, void* stream) {
  return with_head_dim(head_dim, BwdLaunch<K>{a, static_cast<cudaStream_t>(stream)});
}

}  // namespace ea
