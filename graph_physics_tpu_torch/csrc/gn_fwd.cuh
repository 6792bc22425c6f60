// The GraphNetBlock forward's body, written once for both edge layouts and
// templated on the row map (gn_rows.cuh): receiver-sorted CSR
// (fused_gnblock_csr.cu) and the NK slot layout (fused_gnblock_nk.cu).
// Each source wraps it in kernels of its own name and launches them with
// launch_fwd. The function, for every receiver r and sample b, over r's
// rows s (first + c·step, c < count) with sender j:
//   e_in  = folded ? EncMLP(raw[s, b]) : e[s, b]
//   h     = edge_mask[s] ? EdgeMLP(e_in, x[r, b], x[j, b]) : 0
//   e_out = e_in + h                       (not written on the last block)
//   agg   = bf16(sum_s h)                  (fp32 sum, in row order)
//   agg   = bf16(agg + extra[r, b])        (with an extra aggregate: the
//                                           seam, fused_gnblock_nk.py:218)
//   x_out = x[r, b] + NodeMLP(cat[x[r, b], agg])
// Rows outside every receiver's range (CSR padding) get e_out = e_in. The
// edge MLP's first layer follows the TPU kernels' order
// (fused_gnblock.py:blocked_reference :1173-1183, fused_gnblock_nk.py:
// _edge_fwd :130-134): the node partials x @ Kr and x @ Ks are computed
// per node and rounded to bf16, then added to the fp32 product e_in @ Ke,
// and the sum is rounded once; the backward (gn_bwd_passes.cuh:row_tile)
// rebuilds it so, so forward and backward are one function. Between
// layers the numerics are the JAX kernel's _mlp_fwd / _rms_fwd (bf16
// values, fp32 sums, fp32 RMS statistics of bf16 squares; gn_tile.cuh).
//
// Every product runs as mma.sync.m16n8k16 bf16 -> fp32 (gn_tile.cuh),
// with one warp per (receiver, 16-sample chunk):
//   * a pre-pass (gn_partial_tc_kernel, on tiles too) writes bf16(x @ Ks)
//     per (node, sample) to a scratch [N, B, H] array, so a sender's
//     partial is a tile load per edge row (1 KB at H = 32);
//   * the warp computes its receiver's bf16(x_r @ Kr) once, then walks the
//     receiver's rows: each row is one m16 tile of its 16 samples (1 KB,
//     contiguous at B = 16 or a multiple of it), e_in @ Ke on the tensor
//     cores, the two partials added in fp32, the bias, then layers 1-3
//     with each layer's A operand taken from the previous layer's
//     accumulators (two m16n8 accumulators are one m16k16 A fragment) and
//     the RMSNorm's row sums over quads of lanes;
//   * h goes into an fp32 aggregate held in accumulator fragments, summed
//     in row order; e_out = e_in + h is stored from the fragments;
//   * the extra aggregate's tile (the world edges', when given) is added
//     to the rounded aggregate (one bf16 rounding of the sum), then the
//     node MLP runs on the [x_r | agg] tile (K = 2·HP), the residual is
//     added and x_out (and agg, that sum, when training) stored;
//   * receivers of different degree run on different warps, so no lane
//     waits on another's range; masked rows in a range give h = 0 and skip
//     the MLP (a warp-uniform branch); CSR padding rows are work items of
//     their own after the receivers (a copy, or the folded encoder).
// The weights sit in shared memory as bf16 tiles, ~37 KB for the three
// 4-layer MLPs at H = 32. The MLPs may have 1 to 8 Dense layers (MAXL),
// each its own activation (relu, SiLU or GELU: gn_tile.cuh:activate);
// samples past B in a receiver's last chunk are zero rows that are never
// stored. One source is built for each hidden width 1 to 32, the tiles
// padded to 16 columns below 16 (gn_tile.cuh).
#pragma once

#include "gn_rows.cuh"
#include "gn_tile.cuh"

namespace gn_fwd {

using namespace gn_rows;
using namespace gn_tile;

constexpr int FWD_THREADS = 256;
constexpr int FWD_WARPS = FWD_THREADS / 32;

struct FwdArgs : RowMap {
  const bf16* x;           // [N, B, H]
  const bf16* e;           // [S, B, H], or raw [S, B, fe] when folded
  const bf16* xks;         // [N, B, H] scratch: bf16(x @ Ks), from the pre-pass
  bf16* x_out;             // [N, B, H]
  bf16* agg_out;           // [N, B, H] bf16(agg) for the backward, or null
  const bf16* extra;       // [N, B, H] added to the aggregate, or null
  bf16* e_out;             // [S, B, H]; null on the last block
  const int32_t* senders;  // [S] sender per row (0 on padding)
  const uint8_t* mask;     // [S] 1 on valid rows
  int batch, fe;
  Mlp enc, edge, node;
};

// e_in of the 16-sample tile at row-sample index rb = s * B + b0
template <bool FOLD>
__device__ __forceinline__ void edge_in(uint32_t (&ein)[FR], const FwdArgs& a, const TileMlp& enc,
                                        long long rb, int nv) {
  if (FOLD)
    encode(ein, a.e + rb * a.fe, a.fe, enc, nv);
  else
    frag_load(ein, a.e + rb * H, H, nv);
}

template <class Rows, bool FOLD, bool LAST, bool ACTS>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  bf16* base = reinterpret_cast<bf16*>(fwd_smem);
  TileMlp enc{};
  if (FOLD) {
    enc = stage_tile_mlp(base, a.enc);
    base += tile_mlp_elems(a.enc);
  }
  TileMlp edge = stage_tile_mlp(base, a.edge);
  TileMlp node = stage_tile_mlp(base + tile_mlp_elems(a.edge), a.node);
  fix_act<ACTS>(enc);
  fix_act<ACTS>(edge);
  fix_act<ACTS>(node);
  __syncthreads();

  const int B = a.batch;
  const int chunks = (B + 15) / 16;
  const long long recv_items = static_cast<long long>(a.n_nodes) * chunks;
  const long long pad0 = Rows::ranged_end(a);  // the first padding row
  const long long items =
      recv_items + (Rows::PADDED && !LAST ? (a.total_rows - pad0) * chunks : 0);
  const long long step = static_cast<long long>(gridDim.x) * FWD_WARPS;

  for (long long it = static_cast<long long>(blockIdx.x) * FWD_WARPS + threadIdx.x / 32;
       it < items; it += step) {
    if (Rows::PADDED && it >= recv_items) {  // a padding row (mask False): e_out = e_in
      const long long p = it - recv_items;
      const int b0 = 16 * static_cast<int>(p % chunks);
      const long long rb = (pad0 + p / chunks) * B + b0;
      const int nv = min(16, B - b0);
      uint32_t ein[FR];
      edge_in<FOLD>(ein, a, enc, rb, nv);
      frag_store(a.e_out + rb * H, H, nv, ein);
      continue;
    }
    const int r = static_cast<int>(it / chunks);
    const int b0 = 16 * static_cast<int>(it % chunks);
    const int nv = min(16, B - b0);
    const long long xb = (static_cast<long long>(r) * B + b0) * H;  // tile (r, b0)

    uint32_t xr[FR], xkr[FR];
    frag_load(xr, a.x + xb, H, nv);
    float d[NT][4];
    zero_acc(d);
    mma_awt(d, xr, edge.layer(0), edge.stride0, HP);  // x_r @ Kr
    round_acc(xkr, d);

    float agg[NT][4];
    zero_acc(agg);
    long long first;
    int count, row_step;
    Rows::own(a, r, first, count, row_step);
    for (int c = 0; c < count; ++c) {
      const long long s = first + static_cast<long long>(c) * row_step;
      const bool valid = a.mask[s] != 0;
      if (LAST && !valid) continue;
      const long long rb = s * B + b0;
      uint32_t ein[FR];
      edge_in<FOLD>(ein, a, enc, rb, nv);
      if (valid) {
        zero_acc(d);
        mma_awt(d, ein, edge.layer(0), edge.stride0, 0);  // e_in @ Ke
        uint32_t h[FR];
        frag_load(h, a.xks + (static_cast<long long>(a.senders[s]) * B + b0) * H, H, nv);
        add_frag(d, xkr);
        add_frag(d, h);
        finish(h, d, edge.bias(0));
        mlp_tail(h, edge);
        add_frag(agg, h);
        if (!LAST) add_tiles(ein, ein, h);
      }
      if (!LAST) frag_store(a.e_out + rb * H, H, nv, ein);
    }

    uint32_t ag[FR], h[FR];
    round_acc(ag, agg);
    if (a.extra) {
      frag_load(h, a.extra + xb, H, nv);
      add_tiles(ag, ag, h);
    }
    if (a.agg_out) frag_store(a.agg_out + xb, H, nv, ag);
    zero_acc(d);
    mma_awt(d, xr, node.layer(0), node.stride0, 0);
    mma_awt(d, ag, node.layer(0), node.stride0, HP);
    finish(h, d, node.bias(0));
    mlp_tail(h, node);
    add_tiles(h, xr, h);
    frag_store(a.x_out + xb, H, nv, h);
  }
}

// Fills the MLPs and pointers of ``a`` from a forward's C arguments (each
// weight list 2 * n_layers + 1 pointers: w0, b0, w1, b1, ..., then the
// RMSNorm scale, null without a norm, and its activation's code,
// mlp_act::Kind; fe > 0 folds the edge encoder in);
// false if they do not fit the body. The caller sets the row map.
inline bool make_fwd_args(FwdArgs* a, const void* x, const void* e, void* xks, void* x_out,
                          void* e_out, void* agg_out, const void* extra, const void* senders,
                          const void* mask,
                          int batch, int fe, const void* const* enc_w, int n_enc_layers,
                          int enc_act, const void* const* edge_w, int n_edge_layers,
                          int edge_act, const void* const* node_w, int n_node_layers,
                          int node_act) {
  a->x = static_cast<const bf16*>(x);
  a->e = static_cast<const bf16*>(e);
  a->xks = static_cast<const bf16*>(xks);
  a->x_out = static_cast<bf16*>(x_out);
  a->e_out = static_cast<bf16*>(e_out);
  a->agg_out = static_cast<bf16*>(agg_out);
  a->extra = static_cast<const bf16*>(extra);
  a->senders = static_cast<const int32_t*>(senders);
  a->mask = static_cast<const uint8_t*>(mask);
  a->batch = batch;
  a->fe = fe;
  return (fe <= 0 || gn_nk::make_mlp(&a->enc, enc_w, n_enc_layers, fe, 1, enc_act)) &&
         gn_nk::make_mlp(&a->edge, edge_w, n_edge_layers, 3 * H, 3, edge_act) &&
         gn_nk::make_mlp(&a->node, node_w, n_node_layers, 2 * H, 2, node_act) &&
         a->n_nodes >= 1 &&
         batch >= 1 && a->total_rows >= 1;
}

using FwdKernel = void (*)(const FwdArgs);

// whether an MLP of the forward takes another activation than relu (the
// ACTS instance, gn_tile.cuh:fix_act)
inline bool any_act(const FwdArgs& a) {
  return (a.fe > 0 && a.enc.act != mlp_act::RELU) || a.edge.act != mlp_act::RELU ||
         a.node.act != mlp_act::RELU;
}

// The pre-pass (gn_partial_tc_kernel) and the forward on ``stream``: one of
// the calling source's four wrappers of fwd_body<Rows, FOLD, LAST, ACTS>
// (of the ACTS any_act chose), chosen by fe > 0 (folded) and e_out == null
// (last block)
template <class Rows>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream, FwdKernel mid, FwdKernel last,
                       FwdKernel fold_mid, FwdKernel fold_last) {
  cudaError_t err = launch_partial(a.x, nullptr, const_cast<bf16*>(a.xks), a.edge.w[0],
                                   a.n_nodes, a.batch, stream);
  if (err != cudaSuccess) return err;
  const bool fold = a.fe > 0, is_last = a.e_out == nullptr;
  const FwdKernel kernel = fold ? (is_last ? fold_last : fold_mid) : (is_last ? last : mid);
  const size_t smem = sizeof(bf16) * ((fold ? tile_mlp_elems(a.enc) : 0) +
                                      tile_mlp_elems(a.edge) + tile_mlp_elems(a.node));
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // the receivers' tiles plus, on a padded layout, at most total_rows
  // padding-row tiles
  const int chunks = (a.batch + 15) / 16;
  const long long tiles =
      static_cast<long long>(a.n_nodes + (Rows::PADDED && !is_last ? a.total_rows : 0)) * chunks;
  int grid = 0;
  err = gn_nk::grid_for(reinterpret_cast<const void*>(kernel), FWD_THREADS, smem, 32 * tiles,
                        &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, FWD_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace gn_fwd
