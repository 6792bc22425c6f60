// The edge-attention forward's body, written once for both edge layouts
// and templated on the row map (gn_rows.cuh): receiver-sorted CSR rows
// (fused_edge_attention_csr.cu) and NK slots (fused_edge_attention_nk.cu).
// Each source wraps it in a kernel of its own name and launches it with
// launch_fwd. The function, for every receiver r, sample b and head h,
// over r's valid rows s (first + c·step, c < count, mask[s]) with sender j,
//   l_s   = sum_d q[r,b,h,d] * k[j,b,h,d] / sqrt(dh)
//   m     = max_s l_s
//   p_s   = bf16(exp(l_s - m))
//   out   = bf16(sum_s p_s * v[j,b,h,:] / sum_s p_s)
// and exactly 0 for a receiver with no valid row. Rounding: every product
// is of two bf16 values, exact in fp32, and every sum is fp32; only p_s
// and the output round to bf16. A receiver of more than 4 valid rows is
// walked in chunks with the online softmax: p_s rounds against the
// running max of the chunks so far and is rescaled by exp(running -
// final) in fp32; where the max does not change the scale is exactly 1.
// The TPU kernels shift by one max per tile; this one by the receiver's
// own, which agrees to rounding and cannot underflow where a tile's max
// would. When asked (the forward under autograd), it also writes the
// softmax statistics the backward (ea_bwd_passes.cuh) reuses, fp32
// [N, B, H]: m (-inf without a valid row) and inv = 1 / sum_s p_s (0
// without one).
//
// The world seam (WORLD: the per-sample world-edge sidecar, ops/
// edge_attention.world_attention_parts): fp32 pieces num_w [N, B, H, dh],
// den_w and their shift s_w [N, B, H] join each receiver's softmax after
// the walk of its rows, re-based from s_w to the joint max:
//   m'  = max(m, s_w)          (m = -inf without a valid row; s_w finite)
//   num = num·exp(m - m') + num_w·exp(s_w - m')
//   den = den·exp(m - m') + den_w·exp(s_w - m')
//   out = den > 0 ? bf16(num / den) : 0
// and the kept statistics are the joint ones, m' and 1 / den, with the
// output before its bf16 rounding (out32, fp32): the backward's world
// cotangents take it, as the Pallas kernel recomputes its fp32 output.
// Without WORLD the code and its bits are those of the mesh-only kernel.
// At head widths 8 and below the forward under autograd keeps out32
// without world pieces too (Head<DH>::FP32_GRAD), for the backward's s_r.
//
// The design (ea_common.cuh): one walk of the rows, with the loads of a
// chunk of rows in flight and few registers.
//  - A warp per receiver: 2 lanes a (sample, head) pair of head width 16
//    (4 of width 32, DH / 8 of any width from 8 up), 8 values (16 bytes)
//    each, 16 pairs at a time, the warp walking its 4 groups of 16 pairs
//    in turn (8 groups of 8 at width 32: two warps). Each row's k and v
//    reads of a warp are 512 contiguous bytes. Below head width 8 a lane
//    holds a whole pair (ea_common.cuh) and a warp's reads of a row are
//    32·2·DH bytes.
//  - The receiver's row indices and mask come in one load of up to 32
//    rows, a row a lane, once for all groups, and go round by
//    __shfl_sync; only valid rows are walked, so masked slots between
//    valid ones drop out.
//  - Rows go in chunks of 4: cp.async copies the chunk's k and v into the
//    warp's shared memory (4 KB), so no register holds a load in flight,
//    and a thread needs at most 64 registers: 32 warps an SM (below head
//    width 8 the chunk's 8 small loads go to registers instead).
//  - k and v are each read once; the degree has no cap.
#pragma once

#include "ea_common.cuh"

namespace ea {

struct FwdArgs : gn_rows::RowMap {
  const __nv_bfloat16* q;  // [N, B, H, dh]
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;      // [N, B, H, dh]
  float* m;                // [N, B, H] the max logit, or null
  float* inv;              // [N, B, H] 1 / the softmax's denominator, or null
  const int32_t* senders;  // [S] sender per row (0 on padding)
  const uint8_t* mask;     // [S] 1 on valid rows
  // the world seam's pieces, fp32, all null without world edges
  const float* num_w;      // [N, B, H, dh]
  const float* den_w;      // [N, B, H]
  const float* s_w;        // [N, B, H]
  float* out32;            // [N, B, H, dh] the output before rounding, or null
  int batch, heads;
};

template <int DH, class Rows, bool WORLD>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
  constexpr int EPL = Head<DH>::EPL;
  const int pairs = a.batch * a.heads;
  Lane<DH> ln(pairs);
  if (ln.node >= a.n_nodes) return;  // the whole warp
  extern __shared__ uint4 smem[];
  Stage2<DH> stage(smem);  // k and v of a chunk of rows
  const int r = ln.node;
  const Walk<Rows> walk(a, r);
  // the first 32 rows' senders, kept for every group the warp walks
  const int sender0 = walk.sender(walk.row(0), a.senders, a.mask);

  for (int grp = ln.first; grp < ln.last; ++grp) {  // warp-uniform
    ln.group(grp, pairs);
    const Packed<EPL> qv = load_packed<EPL>(a.q + ln.at(r, pairs));
    float num[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) num[e] = 0.f;
    float den = 0.f, m = -CUDART_INF_F;

    for (int base = 0; base < walk.count; base += 32) {
      const int sender = base == 0 ? sender0 : walk.sender(walk.row(base), a.senders, a.mask);
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
        float l[CHUNK];
        float cmax = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (c < count) {
            l[c] = pair_dot<DH>(qv, stage.get(c, 0)) * Head<DH>::SCALE;
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
            const float p = bf(expf(l[c] - m));
            float vv[EPL];
            unpack<EPL>(vv, stage.get(c, 1));
            den += p;
#pragma unroll
            for (int e = 0; e < EPL; ++e) num[e] = fmaf(p, vv[e], num[e]);
          }
      }
    }
    if (WORLD) {  // the world pieces join the softmax at the joint max
      const long long st = ln.stat(r, pairs);
      const float sw = a.s_w[st];
      const float mj = fmaxf(m, sw);
      const float c = expf(m - mj), w = expf(sw - mj);
      float nw[EPL];
      loadf<EPL>(nw, a.num_w + ln.at(r, pairs));
      den = fmaf(a.den_w[st], w, den * c);
#pragma unroll
      for (int e = 0; e < EPL; ++e) num[e] = fmaf(nw[e], w, num[e] * c);
      m = mj;
    }
    if (ln.active) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) num[e] = den > 0.f ? num[e] / den : 0.f;
      if ((WORLD || Head<DH>::FP32_GRAD) && a.out32 != nullptr)
        storef<EPL>(a.out32 + ln.at(r, pairs), num);
      store<EPL>(a.out + ln.at(r, pairs), num);
    }
    if (a.m != nullptr && ln.writes_pair()) {
      a.m[ln.stat(r, pairs)] = m;
      a.inv[ln.stat(r, pairs)] = den > 0.f ? 1.0f / den : 0.f;
    }
  }
}

// The arguments both sources take: q, k, v, out contiguous bf16 [n_nodes,
// batch, heads, head_dim]; m, inv fp32 [n_nodes, batch, heads], both null
// or both given; senders (int32) and mask (bool) one entry a row; the
// world pieces num_w (fp32 [n_nodes, batch, heads, head_dim]), den_w and
// s_w (fp32 [n_nodes, batch, heads]), all null or all given; out32 (fp32
// [n_nodes, batch, heads, head_dim], the output before rounding) given
// with the statistics where the world pieces are given or head_dim is 8
// or below (keeps_fp32_out), else null. False on arguments no launch takes.
inline bool make_fwd_args(FwdArgs* a, const void* q, const void* k, const void* v, void* out,
                          void* m, void* inv, const void* senders, const void* mask,
                          const void* num_w, const void* den_w, const void* s_w, void* out32,
                          int n_nodes, int batch, int heads, int head_dim) {
  a->q = static_cast<const __nv_bfloat16*>(q);
  a->k = static_cast<const __nv_bfloat16*>(k);
  a->v = static_cast<const __nv_bfloat16*>(v);
  a->out = static_cast<__nv_bfloat16*>(out);
  a->m = static_cast<float*>(m);
  a->inv = static_cast<float*>(inv);
  a->senders = static_cast<const int32_t*>(senders);
  a->mask = static_cast<const uint8_t*>(mask);
  a->num_w = static_cast<const float*>(num_w);
  a->den_w = static_cast<const float*>(den_w);
  a->s_w = static_cast<const float*>(s_w);
  a->out32 = static_cast<float*>(out32);
  a->n_nodes = n_nodes;
  a->batch = batch;
  a->heads = heads;
  const bool world = num_w != nullptr;
  return n_nodes >= 1 && batch >= 1 && heads >= 1 && (m == nullptr) == (inv == nullptr) &&
         (den_w != nullptr) == world && (s_w != nullptr) == world &&
         (out32 != nullptr) == ((world || keeps_fp32_out(head_dim)) && m != nullptr);
}

using FwdKernel = void (*)(FwdArgs);

// launch the source's kernel for head width DH: K::template kernel<DH,
// WORLD>() is the source's instance, without world edges or with them
template <class K>
struct FwdLaunch {
  const FwdArgs& a;
  cudaStream_t st;
  template <int DH>
  int run() const {
    const FwdKernel k =
        a.num_w != nullptr ? K::template kernel<DH, true>() : K::template kernel<DH, false>();
    k<<<grid_for<DH>(a.n_nodes, a.batch * a.heads), THREADS, Stage2<DH>::BYTES, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

// launch the source's kernel for any head width dividing 128
template <class K>
inline int launch_fwd(const FwdArgs& a, int head_dim, void* stream) {
  return with_head_dim(head_dim, FwdLaunch<K>{a, static_cast<cudaStream_t>(stream)});
}

}  // namespace ea
