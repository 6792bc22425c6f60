// The GraphNetBlock forward at hidden 64 and 128, written once for both
// edge layouts and templated on the row map (gn_rows.cuh): the NK slot
// layout (fused_gnblock_wide_nk.cu, row 1) and receiver-sorted CSR
// (fused_gnblock_wide_csr.cu, row 3). The function is gn_fwd.cuh's, for
// every receiver r and sample b over r's rows s with sender j:
//   e_in  = folded ? EncMLP(raw[s, b]) : e[s, b]
//   h     = edge_mask[s] ? EdgeMLP(e_in, x[r, b], x[j, b]) : 0
//   e_out = e_in + h                       (not written on the last block)
//   agg   = bf16(sum_s h)                  (fp32 sum, in row order)
//   agg   = bf16(agg + extra[r, b])        (with an extra aggregate, the
//                                           world edges')
//   x_out = x[r, b] + NodeMLP(cat[x[r, b], agg])
// with the edge MLP's first layer in the TPU kernels' order: the node
// partials bf16(x @ Kr) and bf16(x @ Ks) added to the fp32 e_in @ Ke, one
// rounding after (fused_gnblock_nk.py:_edge_fwd :130-134).
//
// Passes (gn_wide.cuh says why the MLPs are split over kernels):
//  0. pre-pass: xkr and xks, a warp per (node, 16 samples);
//  1. (folded) encoder pass: e_in of every row, into e_out's buffer (a
//     scratch on the last block);
//  2. edge pass, a warp per (receiver, 16 samples) over its rows, the edge
//     MLP (Ke and its later layers, gn_wide.cuh) resident: each valid row's
//     message from e_in, xkr[r] and xks[j]; the fp32 aggregate in
//     accumulator fragments (no atomics); e_out = e_in + h, in place when
//     e_in is already in e_out's buffer; then bf16(agg), plus the extra
//     aggregate's tile when given (one more rounding), to device memory;
//     masked rows copy e_in (nothing to do in place), CSR padding rows are
//     items of their own after the receivers;
//  3. node pass, a warp per (node, 16 samples), the node MLP resident:
//     x_out = x + NodeMLP([x | agg]).
// What bounds it on this card: at hidden 128 a valid row costs 65.5k
// multiply-adds in the edge MLP (Ke and 3 layers) against 1 KB of row
// traffic (read e, write e_out); with the node partials and the node MLP,
// a middle block on the cylinder batch (11,170 valid of 11,520 slots x 128
// samples, 1,920 x 128 nodes) does ~0.24 TFLOP against ~0.94 GB: 0.24 ms on
// the bf16 tensor cores, 0.28 ms at 3.35 TB/s, so near the ridge; the
// passes add the aggregate's and the partials' round trips (~0.19 GB).
#pragma once

#include "gn_wide.cuh"

namespace gnw {

using namespace gn_rows;

struct FwdArgs : RowMap {
  const bf16* x;           // [N, B, H]
  const bf16* e;           // [S, B, H] e_in (the encoder pass's output when folded)
  const bf16* xkr;         // [N, B, H] bf16(x @ Kr), from the pre-pass
  const bf16* xks;         // [N, B, H] bf16(x @ Ks)
  bf16* x_out;             // [N, B, H]
  bf16* e_out;             // [S, B, H] (may be e: in place); null on the last block
  bf16* agg;               // [N, B, H] bf16(agg)
  const bf16* extra;       // [N, B, H] added to the aggregate, or null
  const int32_t* senders;  // [S] sender per row (0 on padding)
  const uint8_t* mask;     // [S] 1 on valid rows
  int batch;
  Mlp edge, node;
};

template <class Rows, bool LAST, bool ACTS>
__device__ __forceinline__ void edge_fwd_body(const FwdArgs& a) {
  extern __shared__ __align__(16) unsigned char edge_smem[];
  WMlp edge = stage_mlp(reinterpret_cast<bf16*>(edge_smem), a.edge, H);  // Ke, W1..
  fix_act<ACTS>(edge);
  __syncthreads();

  const int B = a.batch;
  const int chunks = (B + 15) / 16;
  const long long recv_items = static_cast<long long>(a.n_nodes) * chunks;
  const long long pad0 = Rows::ranged_end(a);  // the first padding row
  const bool copy = !LAST && a.e_out != a.e;   // masked and padding rows: e_out = e_in
  const long long items = recv_items + (Rows::PADDED && copy ? (a.total_rows - pad0) * chunks : 0);
  const long long step = static_cast<long long>(gridDim.x) * WARPS;

  for (long long it = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
       it < items; it += step) {
    if (Rows::PADDED && it >= recv_items) {  // a padding row
      const long long p = it - recv_items;
      const int b0 = 16 * static_cast<int>(p % chunks);
      const long long rb = (pad0 + p / chunks) * B + b0;
      const int nv = min(16, B - b0);
      uint32_t t[NF];
      frag_load(t, a.e + rb * H, nv);
      frag_store(a.e_out + rb * H, nv, t);
      continue;
    }
    const int r = static_cast<int>(it / chunks);
    const int b0 = 16 * static_cast<int>(it % chunks);
    const int nv = min(16, B - b0);
    const long long xb = (static_cast<long long>(r) * B + b0) * H;  // tile (r, b0)

    float agg[NT][4];
    zero_acc(agg);
    long long first;
    int count, row_step;
    Rows::own(a, r, first, count, row_step);
#pragma unroll 1
    for (int c = 0; c < count; ++c) {
      const long long s = first + static_cast<long long>(c) * row_step;
      const long long rb = s * B + b0;
      if (a.mask[s] == 0) {
        if (copy) {
          uint32_t t[NF];
          frag_load(t, a.e + rb * H, nv);
          frag_store(a.e_out + rb * H, nv, t);
        }
        continue;
      }
      uint32_t h[NF];
      {
        float d[NT][4];
        uint32_t t[NF];
        frag_load(t, a.e + rb * H, nv);
        zero_acc(d);
        mma_awt(d, t, edge.layer(0), edge.stride0, 0);  // e_in @ Ke
        frag_load(t, a.xkr + xb, nv);
        add_frag(d, t);
        frag_load(t, a.xks + (static_cast<long long>(a.senders[s]) * B + b0) * H, nv);
        add_frag(d, t);
        finish(h, d, edge.bias(0));
      }
      mlp_tail<ACTS>(h, edge);
      add_frag(agg, h);
      if (!LAST) {
        uint32_t t[NF];
        frag_load(t, a.e + rb * H, nv);
        add_tiles(t, t, h);
        frag_store(a.e_out + rb * H, nv, t);
      }
    }
    uint32_t ag[NF];
    round_acc(ag, agg);
    if (a.extra) {  // the seam: the node pass and the backward read this sum
      uint32_t t[NF];
      frag_load(t, a.extra + xb, nv);
      add_tiles(ag, ag, t);
    }
    frag_store(a.agg + xb, nv, ag);
  }
}

// pass 3: x_out = x + NodeMLP([x | agg]), a warp per (node, 16 samples)
template <bool ACTS>
__global__ void __launch_bounds__(THREADS, 1) GNW(node_fwd)(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char node_smem[];
  WMlp node = stage_mlp(reinterpret_cast<bf16*>(node_smem), a.node, 2 * H);
  fix_act<ACTS>(node);
  __syncthreads();
  const int B = a.batch;
  const int chunks = (B + 15) / 16;
  const long long tiles = static_cast<long long>(a.n_nodes) * chunks;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32; t < tiles;
       t += step) {
    const int b0 = 16 * static_cast<int>(t % chunks);
    const int nv = min(16, B - b0);
    const long long xb = ((t / chunks) * B + b0) * H;
    uint32_t h[NF];
    {
      float d[NT][4];
      uint32_t f[NF];
      zero_acc(d);
      frag_load(f, a.x + xb, nv);
      mma_awt(d, f, node.layer(0), node.stride0, 0);
      frag_load(f, a.agg + xb, nv);
      mma_awt(d, f, node.layer(0), node.stride0, H);
      finish(h, d, node.bias(0));
    }
    mlp_tail<ACTS>(h, node);
    uint32_t f[NF];
    frag_load(f, a.x + xb, nv);
    add_tiles(h, f, h);
    frag_store(a.x_out + xb, nv, h);
  }
}

using FwdKernel = void (*)(const FwdArgs);

// The passes on ``stream``: ``mid`` / ``last`` are the calling source's
// wrappers of edge_fwd_body<Rows, LAST, ACTS> (the edge MLP's instance,
// gn_wide.cuh:any_instance). raw (folded, fe > 0) is the
// encoder's [S, B, fe] input and ein a [S, B, H] scratch for its output on
// the last block; a.e is set here when folded.
template <class Rows>
cudaError_t launch_fwd(FwdArgs a, const bf16* raw, bf16* ein, const Mlp& enc, int fe,
                       cudaStream_t stream, FwdKernel mid, FwdKernel last) {
  cudaError_t err = launch_partial(a.x, const_cast<bf16*>(a.xkr), const_cast<bf16*>(a.xks),
                                   a.edge.w[0], a.n_nodes, a.batch, stream);
  if (err != cudaSuccess) return err;
  const bool is_last = a.e_out == nullptr;
  if (fe > 0) {
    bf16* dst = is_last ? ein : a.e_out;
    err = launch_enc_fwd(raw, dst, enc, a.total_rows, a.batch, stream);
    if (err != cudaSuccess) return err;
    a.e = dst;
  }
  const int chunks = (a.batch + 15) / 16;
  const FwdKernel kernel = is_last ? last : mid;
  size_t smem = sizeof(bf16) * wmlp_elems(H, a.edge.n_layers);
  int grid = 0;
  const long long tiles =
      static_cast<long long>(a.n_nodes + (Rows::PADDED && !is_last ? a.total_rows : 0)) * chunks;
  if ((err = grid_of(reinterpret_cast<const void*>(kernel), smem, tiles, &grid)) != cudaSuccess)
    return err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = sizeof(bf16) * wmlp_elems(2 * H, a.node.n_layers);
  const FwdKernel node =
      any_instance(a.node, 2 * H) ? GNW(node_fwd)<true> : GNW(node_fwd)<false>;
  if ((err = grid_of(reinterpret_cast<const void*>(node), smem,
                     static_cast<long long>(a.n_nodes) * chunks, &grid)) != cudaSuccess)
    return err;
  node<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Fills ``a`` from a forward's C arguments (each weight list 2 * n_layers
// + 1 pointers: w0, b0, w1, b1, ..., then the RMSNorm scale, null without
// a norm; fe > 0 folds the edge encoder in); false if they do not fit the
// kernels. The caller sets the row map.
inline bool make_fwd_args(FwdArgs* a, Mlp* enc, const void* x, const void* e, void* xkr,
                          void* xks, void* x_out, void* e_out, void* agg, const void* extra,
                          const void* senders, const void* mask, int batch, int fe,
                          const void* const* enc_w, int n_enc_layers, int enc_act,
                          const void* const* edge_w, int n_edge_layers, int edge_act,
                          const void* const* node_w, int n_node_layers, int node_act) {
  a->x = static_cast<const bf16*>(x);
  a->e = static_cast<const bf16*>(e);
  a->xkr = static_cast<const bf16*>(xkr);
  a->xks = static_cast<const bf16*>(xks);
  a->x_out = static_cast<bf16*>(x_out);
  a->e_out = static_cast<bf16*>(e_out);
  a->agg = static_cast<bf16*>(agg);
  a->extra = static_cast<const bf16*>(extra);
  a->senders = static_cast<const int32_t*>(senders);
  a->mask = static_cast<const uint8_t*>(mask);
  a->batch = batch;
  return (fe <= 0 || (fe <= H && make_wide_mlp(enc, enc_w, n_enc_layers, fe, enc_act))) &&
         make_wide_mlp(&a->edge, edge_w, n_edge_layers, 3 * H, edge_act) &&
         make_wide_mlp(&a->node, node_w, n_node_layers, 2 * H, node_act) && agg != nullptr &&
         a->n_nodes >= 1 && batch >= 1 && a->total_rows >= 1;
}

}  // namespace gnw
