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
// Passes (at H = 128 the two MLPs do not fit one block's shared memory
// together, so each pass holds one):
//  0. the packing of the call's MLPs and the pre-pass (gn_wide.cuh): xkr,
//     xks on the warpgroup tiles;
//  1. (folded) encoder pass: e_in of every row, into e_out's buffer (a
//     scratch on the last block);
//  2. edge pass: a warpgroup item is four warp tiles of (receiver, 16
//     samples), 64 samples of one receiver at B >= 64; each warp walks its
//     receiver's rows (NK: its K slots, CSR: its row range; the group runs
//     as many row steps as its longest), the edge MLP (Ke and its later
//     layers) resident; the next row's e and xks[j] tiles come through the
//     ring while the current row runs (two e slots: e_out = e_in + h reads
//     the current one again); the fp32 aggregate stays in registers, summed
//     in row order (no atomics); then bf16(agg), plus the extra aggregate's
//     tile when given (one more rounding), to device memory; masked rows
//     copy e_in (nothing to do in place), CSR padding rows are warpgroup
//     items of their own after the receivers;
//  3. node pass on the node tiles, the node MLP resident, x and agg
//     through the ring: x_out = x + NodeMLP([x | agg]).
// What bounds it on this card: at hidden 128 a valid row costs 49k
// multiply-adds with 3-layer MLPs (Ke and 2 layers) against 512 bytes of
// row traffic (read e, write e_out); with the node partials and the node
// MLP, a middle block on the cylinder batch (11,170 valid of 11,520 slots
// x 128 samples, 1,920 x 128 nodes) does ~0.17 TFLOP against ~0.88 GB:
// 0.17 ms on the bf16 tensor cores, 0.26 ms at 3.35 TB/s. The 16-row
// mma.sync design, every row tile loaded synchronously, took 1.38 device
// ms there; here 64-row wgmma tiles read each weight once per 64 rows and
// the next row's tiles are in flight while a row computes: ~0.86 device
// ms, the edge pass ~0.66 of it.
#pragma once

#include "gn_wide.cuh"

namespace gnw {

using namespace gn_rows;

struct FwdArgs : RowMap {
  CUtensorMap m_e;         // the ring's maps ([rows][B][H], boxes of 16 samples): e_in,
  CUtensorMap m_x;         // x
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
  const unsigned char* img_edge;  // the packed MLPs (gn_wide.cuh:img_layout)
  const unsigned char* img_node;
  int batch;
  Mlp edge, node;
};

// A warp's receiver tile of the edge pass: its rows (first, count, step)
struct Recv {
  long long first;
  int count, step, b0, nv;
  int r;
};

template <class Rows>
__device__ __forceinline__ Recv recv_of(const FwdArgs& a, long long t, long long tiles,
                                        int chunks) {
  Recv v;
  v.first = 0;
  v.count = 0;
  v.step = 0;
  v.b0 = 0;
  v.nv = 0;
  v.r = 0;
  if (t < tiles) {
    v.r = static_cast<int>(t / chunks);
    v.b0 = 16 * static_cast<int>(t % chunks);
    v.nv = min(16, a.batch - v.b0);
    Rows::own(a, v.r, v.first, v.count, v.step);
  }
  return v;
}

template <class Rows, bool LAST, bool ACTS, int WGS>
__device__ __forceinline__ void edge_fwd_body(const FwdArgs& a, unsigned char* smem) {
  enum { S_E0, S_E1, NS };
  Carve cv;
  WMlp edge = stage_mlp<WGS>(cv, smem, a.img_edge, a.edge, H, NS, false);  // Ke, W1..
  fix_act<ACTS>(edge);
  Ring ring(cv, NS);
  unsigned char* stg = cv.stage();

  const int B = a.batch;
  const int chunks = (B + 15) / 16, w = (threadIdx.x >> 5) & 3;
  const long long recv_tiles = static_cast<long long>(a.n_nodes) * chunks;
  const long long recv_items = (recv_tiles + 3) / 4;
  const long long pad0 = Rows::ranged_end(a);  // the first padding row
  const bool copy = !LAST && a.e_out != a.e;   // masked and padding rows: e_out = e_in
  const long long pad_tiles = Rows::PADDED && copy ? (a.total_rows - pad0) * chunks : 0;
  const long long items = recv_items + (pad_tiles + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * WGS;
  long long g = blockIdx.x * static_cast<long long>(WGS) + (threadIdx.x >> 7);

  // the ring's e slots alternate over the warp's rows in load order; ready:
  // the current item's first row is asked for
  int e_loads = 0, e_uses = 0;
  bool ready = false;
  auto load_row = [&](long long s, int b0) {
    ring.load(S_E0 + (e_loads & 1), &a.m_e, s, b0);
    ++e_loads;
  };

  for (; g < items; g += stride) {
    if (g >= recv_items) {  // CSR padding rows: e_out = e_in
      const long long t = 4 * (g - recv_items) + w;
      if (t < pad_tiles) {
        const int b0 = 16 * static_cast<int>(t % chunks);
        const long long rb = (pad0 + t / chunks) * B + b0;
        const int nv = min(16, B - b0);
        uint32_t f[NF];
        stage_load(f, a.e + rb * H, nv, stg);
        stage_store(a.e_out + rb * H, nv, f, stg);
      }
      continue;
    }
    const Recv v = recv_of<Rows>(a, 4 * g + w, recv_tiles, chunks);
    Recv nx = {};
    if (g + stride < recv_items) nx = recv_of<Rows>(a, 4 * (g + stride) + w, recv_tiles, chunks);
    // the group's row steps: its longest receiver's
    int steps = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const Recv o = recv_of<Rows>(a, 4 * g + u, recv_tiles, chunks);
      steps = max(steps, o.nv > 0 ? o.count : 0);
    }
    const int own = v.nv > 0 ? v.count : 0;
    const long long xb = (static_cast<long long>(v.r) * B + v.b0) * H;  // tile (r, b0)
    if (own > 0 && !ready) load_row(v.first, v.b0);
    ready = false;

    float agg[NT][4];
    zero_acc(agg);
#pragma unroll 1
    for (int c = 0; c < steps; ++c) {
      const bool have = c < own;
      const long long s = v.first + static_cast<long long>(c) * v.step;
      const long long rb = s * B + v.b0;
      const bool ok = have && a.mask[s];
      const int es = S_E0 + (e_uses & 1);
      const int nv = have ? v.nv : 0;
      uint32_t h[NF];
      {
        float d[NT][4];
        uint32_t t[NF];
        Pend pr, ps;
        pend_issue(pr, a.xkr + xb, nv);
        pend_issue(ps, a.xks + (have ? static_cast<long long>(a.senders[s]) * B + v.b0 : 0) * H,
                   nv);
        uint32_t u[NF];
        ring.read(t, es, have);
        awt_issue(d, t, edge.w, 0, false);  // e_in @ Ke
        if (have) pend_take(u, pr, stg);
        wg::wait<0>();
        __syncwarp();
        if (have) {
          ++e_uses;
          if (c + 1 < own) {
            load_row(s + v.step, v.b0);
          } else if (nx.nv > 0 && nx.count > 0) {
            load_row(nx.first, nx.b0);
            ready = true;
          }
          add_frag(d, u);
          pend_take(u, ps, stg);
          add_frag(d, u);
        }
        finish(h, d, edge.bias(0));
      }
      mlp_tail<WGS>(h, edge, smem);
      if (ok) add_frag(agg, h);
      if (!LAST && (ok || (have && copy))) {
        uint32_t t[NF];
        ring.reread(t, es);
        if (ok) add_tiles(t, t, h);
        stage_store(a.e_out + rb * H, v.nv, t, stg);
      }
    }
    uint32_t ag[NF];
    round_acc(ag, agg);
    if (a.extra) {  // the seam: the node pass and the backward read this sum
      uint32_t t[NF];
      stage_load(t, a.extra + xb, v.nv, stg);
      add_tiles(ag, ag, t);
    }
    stage_store(a.agg + xb, v.nv, ag, stg);
  }
  drain<WGS>(edge);
}

// pass 3: x_out = x + NodeMLP([x | agg]) on the node tiles; x through the
// ring, agg loaded a product ahead
template <bool ACTS, int WGS>
__global__ void __launch_bounds__(WG_THREADS * WGS, 1)
    GNW(node_fwd)(const __grid_constant__ FwdArgs a) {
  extern __shared__ unsigned char node_smem[];
  enum { S_X, NS };
  Carve c;
  WMlp node = stage_mlp<WGS>(c, node_smem, a.img_node, a.node, 2 * H, NS, false);
  fix_act<ACTS>(node);
  Ring ring(c, NS);
  unsigned char* stg = c.stage();
  const int B = a.batch, chunks = (B + 15) / 16, w = (threadIdx.x >> 5) & 3;
  const long long tiles = static_cast<long long>(a.n_nodes) * chunks, items = (tiles + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * WGS;
  long long g = blockIdx.x * static_cast<long long>(WGS) + (threadIdx.x >> 7);
  if (g < items) {
    const Item it(4 * g + w, tiles, chunks, B);
    if (it.nv > 0) ring.load(S_X, &a.m_x, it.row, it.b0);
  }
  for (; g < items; g += stride) {
    const Item it(4 * g + w, tiles, chunks, B);
    const Item nx(4 * (g + stride) + w, tiles, chunks, B);
    const bool have = it.nv > 0, next = g + stride < items && nx.nv > 0;
    const long long xb = (it.row * B + it.b0) * H;
    uint32_t h[NF];
    {
      float d[NT][4];
      uint32_t f[NF];
      uint32_t t[NF];
      Pend pa;
      pend_issue(pa, a.agg + xb, it.nv);
      ring.read(f, S_X, have);
      awt_issue(d, f, node.w, 0, false);
      pend_take(t, pa, stg);
      wg::wait<0>();
      awt(d, t, node.w, KS, true);
      finish(h, d, node.bias(0));
    }
    mlp_tail<WGS>(h, node, node_smem);
    uint32_t f[NF];
    if (have)
      ring.reread(f, S_X);
    else
      zero_frag(f);
    __syncwarp();
    if (next) ring.load(S_X, &a.m_x, nx.row, nx.b0);
    add_tiles(h, f, h);
    stage_store(a.x_out + xb, it.nv, h, stg);
  }
  drain<WGS>(node);
}

using FwdKernel = void (*)(const FwdArgs);

// The passes on ``stream``: ``mid[i]`` / ``last[i]`` are the calling
// source's wrappers of edge_fwd_body<Rows, LAST, ...> (instance i,
// gn_wide.cuh:instance_of). raw (folded, fe > 0) is the encoder's [S, B,
// fe] input and ein a [S, B, H] scratch for its output on the last block;
// a.e is set here when folded; ``img`` holds img_layout(...).total bytes.
template <class Rows>
cudaError_t launch_fwd(FwdArgs a, const bf16* raw, bf16* ein, const Mlp& enc, int fe,
                       unsigned char* img, cudaStream_t stream, const FwdKernel* mid,
                       const FwdKernel* last) {
  const Images im = img_layout(fe, fe > 0 ? enc.n_layers : 0, a.edge.n_layers, a.node.n_layers);
  a.img_edge = img + im.edge;
  a.img_node = img + im.node;
  cudaError_t err = pack_call(img, im, &enc, fe, a.edge, a.node, stream);
  if (err != cudaSuccess) return err;
  if ((err = launch_partial(a.x, const_cast<bf16*>(a.xkr), const_cast<bf16*>(a.xks),
                            reinterpret_cast<const bf16*>(img + im.kk), a.n_nodes, a.batch,
                            stream)) != cudaSuccess)
    return err;
  const bool is_last = a.e_out == nullptr;
  if (fe > 0) {
    bf16* dst = is_last ? ein : a.e_out;
    err = launch_enc_fwd(raw, dst, img + im.enc, enc, a.total_rows, a.batch, stream);
    if (err != cudaSuccess) return err;
    a.e = dst;
  }
  if (!row_map(&a.m_e, a.e, a.total_rows, a.batch) || !row_map(&a.m_x, a.x, a.n_nodes, a.batch))
    return cudaErrorInvalidValue;
  const int chunks = (a.batch + 15) / 16;
  int grid = 0;
  {
    const int inst = instance_of(a.edge, H, 2), wgs = wgs_of(inst);
    const FwdKernel kernel = is_last ? last[inst] : mid[inst];
    const size_t smem = pass_bytes(H, a.edge.n_layers, plan_pass(H, a.edge.n_layers, 2).resident,
                                   wgs, 2);
    const long long tiles = static_cast<long long>(a.n_nodes) * chunks;
    const long long pads =
        Rows::PADDED && !is_last ? static_cast<long long>(a.total_rows) * chunks : 0;
    const long long items = (tiles + 3) / 4 + (pads + 3) / 4;
    if ((err = grid_of(reinterpret_cast<const void*>(kernel), wgs, smem, items, &grid)) !=
        cudaSuccess)
      return err;
    kernel<<<grid, WG_THREADS * wgs, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int inst = instance_of(a.node, 2 * H, 1), wgs = wgs_of(inst);
  const FwdKernel node = inst == 0 ? GNW(node_fwd)<false, 2>
                         : inst == 1 ? GNW(node_fwd)<true, 2> : GNW(node_fwd)<true, 1>;
  const size_t smem = pass_bytes(2 * H, a.node.n_layers,
                                 plan_pass(2 * H, a.node.n_layers, 1).resident, wgs, 1);
  if ((err = grid_of(reinterpret_cast<const void*>(node), wgs, smem,
                     (static_cast<long long>(a.n_nodes) * chunks + 3) / 4, &grid)) != cudaSuccess)
    return err;
  node<<<grid, WG_THREADS * wgs, smem, stream>>>(a);
  return cudaGetLastError();
}

// bytes of the packed MLPs a forward or backward call needs
inline long long image_bytes_of(int fe, int n_enc, int n_edge, int n_node) {
  return img_layout(fe, fe > 0 ? n_enc : 0, n_edge, n_node).total;
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
