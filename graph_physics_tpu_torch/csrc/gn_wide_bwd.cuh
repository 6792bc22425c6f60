// The GraphNetBlock backward at hidden 64 and 128, written once for both
// edge layouts and templated on the row map: the NK slot layout
// (fused_gnblock_wide_nk_bwd.cu, row 2) and receiver-sorted CSR
// (fused_gnblock_wide_csr_bwd.cu, row 4). Given the block's inputs (x, e),
// the aggregate its forward (gn_wide_fwd.cuh) kept and the cotangents
// g_xout (and g_eout unless it is the last block), it rematerialises the
// forward and returns the function of fused_gnblock_nk_bwd.cu's header:
//   dx = bf16(bf16(bf16(g_xout + NodeMLP'ᵀ g_xout [x part]) + bf16(P_r·Krᵀ))
//            + bf16(P_s·Ksᵀ)),
//   de = g_e_mlp + g_eout on valid rows (g_eout alone elsewhere), or the
//        folded encoder's backward on it,
//   and the fp32 gradient of every Dense kernel, bias and RMSNorm scale,
// P_r / P_s being g_h0 summed over a node's own rows / the rows it sends
// on, each rounded to bf16 (the JAX kernel's scatter commuted through Kr
// and Ks, fused_gnblock.py:534-546). The numeric flow is _mlp_bwd's.
//
// At H = 128 the edge MLP's weight gradients alone are 64k fp32, more than
// a block can hold beside its work, so the passes write what the weight
// gradients contract over to a bf16 scratch, and the gradients are
// products over the rows afterwards:
//  0. the packing of the call's MLPs, the pre-pass (gn_wide.cuh): xkr,
//     xks; (folded) the encoder pass writes e_in to a scratch;
//  1. node pass on the warpgroup tiles (gn_wide.cuh), the node MLP
//     resident, x through the ring, agg and g_xout loaded a product ahead:
//     its forward from [x | agg] and backward from g_xout, storing each
//     later layer's relu'd input A_1.. (relu's pass masks kept by the
//     thread for the backward) and the cotangents G_0.. at the layers'
//     outputs; dx's node part and g_agg; the RMSNorm scale's terms P
//     summed per warp in fp32;
//  2. row pass on the tiles of every row, in receiver order (a receiver's
//     rows go to warpgroups at once, which share its node tiles in L2),
//     the edge MLP (Ke, its later layers) resident, e and g_eout through
//     the ring, xkr[r], xks[j] and g_agg[r] loaded a product ahead: the
//     edge MLP's forward, its backward from g_agg[r] + g_eout, its A_1..,
//     G_0.. (G_0 is g_h0), the scale's column sums, de; rows outside every
//     receiver's range and masked rows run on zero inputs with a zero
//     cotangent, so their G slots are zero and de is g_eout;
//  3. sender pass on the node tiles: P_r over the node's own rows and P_s
//     over the sender-sorted row list (fp32 sums in row order,
//     ops/tiling.cached_sender_slots), both stored; dx finished with the
//     two products;
//  4. weight-gradient pass: for each (product, row split) one block forms
//     Gᵀ·A over its rows: a producer warp keeps four stages of 64-row TMA
//     boxes of both operands in flight, one consumer warpgroup per 64
//     outputs runs wgmma with both operands from shared memory, and sums
//     G's columns (the bias) from the same stage; Kr's and Ks's gradients
//     are the products P_rᵀ·x and P_sᵀ·x;
//  5. a last kernel adds the partials in split order into the gradients,
//     and (its last blocks) the scales' per-warp column sums in warp order;
//  6. (folded) the encoder's pass: its forward from the raw features and
//     its backward from de, into the scratch of pass 2 (read by then),
//     then passes 4-5 on its products.
// No atomics anywhere: two calls give the same bits.
//
// What bounds it on this card: per valid row the backward does ~3x the
// forward's multiply-adds (the edge MLP forward again, the cotangent back
// through its layers, the weight gradients); at hidden 128 on the cylinder
// batch (B = 128, 11,520 rows x 128 samples) a middle block with 3-layer
// MLPs and the norm is ~0.57 TFLOP against ~1.9 GB of the function's
// traffic: 0.57 ms on the tensor cores, 0.57 ms at 3.35 TB/s. The 16-row
// mma.sync design (each weight fragment read from shared memory once per
// 16 rows, the row tiles loaded with nothing in flight, a sixth scratch
// slot for P) took 4.8 device ms there. Here the products are 64-row
// wgmma tiles, the row tiles arrive through TMA a tile ahead or are
// loaded a product ahead, stores and loads go through a staging tile as
// whole rows, and P never leaves the chip: ~3.3 device ms, of which the
// row pass ~1.5 and the weight gradients ~1.0 move ~3.5 and ~2.6 GB, the
// scratch's round trip (5 slots of [S, B, H] at 3 layers written and read)
// being what this design still pays for not fusing the weight gradients
// into the row pass.
#pragma once

#include "gn_wide.cuh"

namespace gnw {

using namespace gn_rows;

// an MLP's scratch slots: A_1..A_{MAXL-1}, G_0..G_{MAXL-1} (an MLP of n
// layers uses A_1..A_{n-1}, G_0..G_{n-1}: 2n - 1 slots; launch_bwd gives
// only those memory)
enum { A1 = 0, G0 = MAXL - 1, SLOTS = 2 * MAXL - 1, PR = SLOTS, PS = SLOTS + 1 };

// whether an MLP of n layers uses slot i
__host__ __device__ inline bool slot_used(int i, int n) {
  return (i >= A1 && i < A1 + n - 1) || (i >= G0 && i < G0 + n);
}

// the per-warp column sums of the RMSNorm scales' terms: one block of
// rows per MLP
enum { P_EDGE = 0, P_NODE = 1, P_ENC = 2 };

struct BwdArgs : RowMap {
  CUtensorMap m_e;         // the ring's maps ([rows][B][H], boxes of 16 samples): e_in,
  CUtensorMap m_geo;       // g_eout,
  CUtensorMap m_x;         // x
  const bf16* x;           // [N, B, H]
  const bf16* e;           // [S, B, H] e_in (the encoder pass's output when folded)
  const bf16* raw;         // [S, B, fe] the encoder's input when folded
  const bf16* agg;         // [N, B, H] the forward's bf16 aggregate
  const bf16* g_xout;      // [N, B, H]
  const bf16* g_eout;      // [S, B, H]; null on the last block
  bf16* dx;                // [N, B, H]: the node-MLP part, then all of dx
  bf16* de;                // [S, B, H] de, or e_in's cotangent (a scratch) when folded
  const bf16* xkr;         // [N, B, H] scratch: bf16(x @ Kr)
  const bf16* xks;         // [N, B, H] scratch: bf16(x @ Ks)
  bf16* gagg;              // [N, B, H] the aggregate's cotangent: the caller's dea
                           // (the extra aggregate's), else a scratch slot
  bf16* es[SLOTS];         // [S, B, H] each: the edge MLP's slots
  bf16* ns[SLOTS + 2];     // [N, B, H] each: the node MLP's slots, then P_r, P_s
  bf16* cs[SLOTS + 1];     // [S, B, H] each: the encoder's A_0 (the raw rows, zero
                           // past fe), then its slots
  const unsigned char* img_enc;   // the packed MLPs (gn_wide.cuh:img_layout)
  const unsigned char* img_edge;
  const unsigned char* img_node;
  const unsigned char* img_kk;    // [Kr | Ks]
  float* pparts;           // [3][pwarps][H]: the scales' terms summed per warp
  int pwarps;
  const int32_t* senders;  // [S] sender per row (0 on padding)
  const uint8_t* mask;     // [S] 1 on valid rows
  const int32_t* order;    // the valid rows sorted by sender
  const int32_t* offsets;  // [N + 1] node j sends on order[offsets[j]:offsets[j+1]]
  int batch, fe;
  Mlp enc, edge, node;     // weights
  Mlp genc, gedge, gnode;  // their gradients: same shapes, fp32, zeroed
};

// stores of an MLP's A_l (l >= 1) and G_l at element offset ``off``
struct Slots {
  bf16* const* s;
  __device__ bf16* a(int l) const { return s[A1 + l - 1]; }
  __device__ bf16* g(int l) const { return s[G0 + l]; }
};

// the warp's global index in a pass (its row of the scale's sums)
template <int WGS>
__device__ __forceinline__ int warp_index() {
  return blockIdx.x * WGS * 4 + (threadIdx.x >> 5);
}

// relu's pass masks of a pass's tiles, a layer a row: 2 bits a pair
// register (kept by the thread, indexed at run time: local memory, which
// L1 holds; the backward reads them where it would reload A_l)
constexpr int MW = NF / 16;
struct Masks {
  uint32_t w[MAXL][MW];
};

__device__ __forceinline__ void mask_of(uint32_t (&w)[MW], const uint32_t (&act)[NF]) {
#pragma unroll
  for (int k = 0; k < MW; ++k) w[k] = 0u;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const uint32_t pm = pos_mask(act[i]);
    w[i / 16] |= ((pm & 1u) | ((pm >> 15) & 2u)) << (2 * (i % 16));
  }
}

__device__ __forceinline__ uint32_t mask_pair(const uint32_t (&w)[MW], int i) {
  const uint32_t b = w[i / 16] >> (2 * (i % 16));
  return ((b & 1u) ? 0x0000ffffu : 0u) | ((b & 2u) ? 0xffff0000u : 0u);
}

// An MLP's forward on the tiles from its first layer's fp32 product d0
// (bias not yet added), storing each later layer's input to its slot: with
// relu its relu'd input A_l (and its pass mask to ``mk``), with SiLU or
// GELU the pre-activation, which bwd_chain needs for the derivative and
// then overwrites with A_l = act(pre), so the slot's bytes are relu's; v
// gets the last layer's output (the RMSNorm's input) and inv its statistic
template <int WGS>
__device__ __forceinline__ void fwd_keep(const float (&d0)[NT][4], WMlp& m, unsigned char* smem,
                                         const Slots& sl, long long off, int nv,
                                         uint32_t (&v)[NF], float (&inv)[2],
                                         unsigned char* stg, Masks& mk) {
  finish(v, d0, m.bias(0));
#pragma unroll 1
  for (int l = 1; l < m.n_layers; ++l) {
    uint32_t act[NF];
    activate(act, v, m.act);
    float d[NT][4];
    layer_awt_issue<WGS>(d, act, m, l);  // the store runs beside the product
    if (m.act == mlp_act::RELU) {  // two calls: a selected array would go to local memory
      stage_store(sl.a(l) + off, nv, act, stg);
      mask_of(mk.w[l], act);
    } else {
      stage_store(sl.a(l) + off, nv, v, stg);
    }
    layer_wait<WGS>(m, smem, l);
    finish(v, d, m.bias(l));
  }
  inv[0] = inv[1] = 1.f;
  if (m.norm) rms_inv(inv, v);
}

// The backward through the RMSNorm and layers n-1..1 (JAX _mlp_bwd): g in,
// the cotangent at the MLP's output; out, the cotangent at layer 0's
// output. Adds the scale's terms bf16(g · u) to the warp's column sums
// ``psum``, stores every G_l; with relu masks g by fwd_keep's masks, with
// SiLU or GELU reads back the lanes' own pre-activation stores (their
// loads in flight during the layer's product).
template <int WGS>
__device__ __forceinline__ void bwd_chain(uint32_t (&g)[NF], WMlp& m, unsigned char* smem,
                                          const Slots& sl, long long off, int nv,
                                          const uint32_t (&v)[NF], const float (&inv)[2],
                                          float (&psum)[CS], unsigned char* stg,
                                          const Masks& mk) {
  if (m.norm) {
    uint32_t p[NF];
    rms_bwd(g, p, v, inv, m.scale());
    colsum_add(psum, p);
  }
#pragma unroll 1
  for (int l = m.n_layers - 1; l >= 1; --l) {
    float d[NT][4];
    if (m.act == mlp_act::RELU) {
      layer_gw_issue<WGS>(d, g, m, l);  // the store runs beside the product
      stage_store(sl.g(l) + off, nv, g, stg);
      layer_wait<WGS>(m, smem, l);
      round_acc(g, d);
#pragma unroll
      for (int i = 0; i < NF; ++i) g[i] &= mask_pair(mk.w[l], i);
    } else {  // g · act'(pre), then A_l = act(pre)
      Pend pa;
      pend_issue(pa, sl.a(l) + off, nv);
      layer_gw_issue<WGS>(d, g, m, l);  // the store and the loads run beside the product
      stage_store(sl.g(l) + off, nv, g, stg);
      uint32_t pre[NF];
      pend_take(pre, pa, stg);
      layer_wait<WGS>(m, smem, l);
      round_acc(g, d);
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        g[i] = mlp_act::grad_pair(g[i], pre[i], m.act);
        pre[i] = mlp_act::act_pair(pre[i], m.act);
      }
      stage_store(sl.a(l) + off, nv, pre, stg);
    }
  }
  stage_store(sl.g(0) + off, nv, g, stg);
}

// a pass's warp column sums of its MLP's scale terms to their row
template <int WGS>
__device__ __forceinline__ void store_psum(const BwdArgs& a, int mlp, const WMlp& m,
                                           const float (&psum)[CS]) {
  if (m.norm)
    colsum_store(a.pparts + (static_cast<long long>(mlp) * a.pwarps + warp_index<WGS>()) * H,
                 psum);
}

// pass 1: the node MLP's backward; x through the ring, agg and g_xout
// loaded a product ahead
template <bool ACTS, int WGS>
__global__ void __launch_bounds__(WG_THREADS * WGS, 1)
    GNW(node_bwd)(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char node_smem[];
  enum { S_X, NS };
  Carve c;
  WMlp node = stage_mlp<WGS>(c, node_smem, a.img_node, a.node, 2 * H, NS, true);
  fix_act<ACTS>(node);
  Ring ring(c, NS);
  unsigned char* stg = c.stage();
  const Slots sl{a.ns};
  const int B = a.batch, chunks = (B + 15) / 16, w = (threadIdx.x >> 5) & 3;
  const long long tiles = static_cast<long long>(a.n_nodes) * chunks, items = (tiles + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * WGS;
  float psum[CS] = {};
  Masks mk;
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
    uint32_t v[NF], gt[NF];
    float inv[2];
    {
      float d[NT][4];
      uint32_t f[NF];
      Pend pa;
      pend_issue(pa, a.agg + xb, it.nv);
      uint32_t t[NF];
      ring.read(f, S_X, have);
      awt_issue(d, f, node.w, 0, false);
      pend_take(t, pa, stg);
      wg::wait<0>();
      __syncwarp();
      if (next) ring.load(S_X, &a.m_x, nx.row, nx.b0);
      awt(d, t, node.w, KS, true);
      Pend po;
      pend_issue(po, a.g_xout + xb, it.nv);
      fwd_keep<WGS>(d, node, node_smem, sl, xb, it.nv, v, inv, stg, mk);
      pend_take(gt, po, stg);
    }
    bwd_chain<WGS>(gt, node, node_smem, sl, xb, it.nv, v, inv, psum, stg, mk);
    float d[NT][4];
    uint32_t f[NF];
    gw_issue(d, gt, node.w, 0);  // the x part
    stage_load(f, a.g_xout + xb, it.nv, stg);
    wg::wait<0>();
    round_acc(v, d);
    add_tiles(f, f, v);
    gw_issue(d, gt, node.w, KB);  // the aggregate's part
    stage_store(a.dx + xb, it.nv, f, stg);  // finished by the sender pass
    wg::wait<0>();
    round_acc(v, d);
    stage_store(a.gagg + xb, it.nv, v, stg);
  }
  store_psum<WGS>(a, P_NODE, node, psum);
  drain<WGS>(node);
}

// pass 2: the edge MLP's backward on every row; e and g_eout through the
// ring, xkr[r], xks[j] and g_agg[r] loaded a product ahead
template <class Rows, bool ACTS, int WGS>
__device__ __forceinline__ void row_bwd_body(const BwdArgs& a, unsigned char* smem) {
  enum { S_E, S_GEO, NS };
  Carve c;
  WMlp edge = stage_mlp<WGS>(c, smem, a.img_edge, a.edge, H, NS, true);  // Ke, W1..
  fix_act<ACTS>(edge);
  Ring ring(c, NS);
  unsigned char* stg = c.stage();
  const Slots sl{a.es};
  const int B = a.batch, chunks = (B + 15) / 16, w = (threadIdx.x >> 5) & 3;
  const long long pad0 = Rows::ranged_end(a);
  const long long tiles = static_cast<long long>(a.total_rows) * chunks, items = (tiles + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * WGS;
  const bool geo = a.g_eout != nullptr;
  float psum[CS] = {};
  Masks mk;
  long long g = blockIdx.x * static_cast<long long>(WGS) + (threadIdx.x >> 7);
  // rows in receiver order (gn_rows.cuh: by_receiver), so that the
  // warpgroups a receiver's rows go to at once share its node tiles in L2
  auto item = [&](long long gi) {
    Item it(4 * gi + w, tiles, chunks, B);
    it.row = Rows::by_receiver(a, it.row);
    return it;
  };
  if (g < items) {
    const Item it = item(g);
    if (it.nv > 0) {
      ring.load(S_E, &a.m_e, it.row, it.b0);
      if (geo) ring.load(S_GEO, &a.m_geo, it.row, it.b0);
    }
  }
  for (; g < items; g += stride) {
    const Item it = item(g);
    const Item nx = item(g + stride);
    const bool have = it.nv > 0, next = g + stride < items && nx.nv > 0;
    const long long s = it.row;
    const bool ok = have && s < pad0 && a.mask[s];  // else: zero inputs, zero cotangent
    const int nv = ok ? it.nv : 0;                  // the rows its node tiles give
    const long long off = (s * B + it.b0) * H;
    const long long rt = ok ? (Rows::receiver(a, s) * B + it.b0) * H : 0;
    const long long st = ok ? (static_cast<long long>(a.senders[s]) * B + it.b0) * H : 0;
    uint32_t v[NF], gt[NF];
    float inv[2];
    {
      float d[NT][4];
      uint32_t f[NF];
      Pend pr, ps;
      pend_issue(pr, a.xkr + rt, nv);
      pend_issue(ps, a.xks + st, nv);
      uint32_t t[NF];
      ring.read(f, S_E, have);
      if (!ok) zero_frag(f);
      awt_issue(d, f, edge.w, 0, false);  // e_in @ Ke
      if (ok) pend_take(t, pr, stg);
      wg::wait<0>();
      __syncwarp();
      if (next) ring.load(S_E, &a.m_e, nx.row, nx.b0);
      if (ok) {
        add_frag(d, t);
        pend_take(t, ps, stg);
        add_frag(d, t);
      }
      Pend pg;
      pend_issue(pg, a.gagg + rt, nv);
      fwd_keep<WGS>(d, edge, smem, sl, off, it.nv, v, inv, stg, mk);
      ring.read(f, S_GEO, have && geo);
      pend_take(gt, pg, stg);
      if (ok)
        add_tiles(gt, gt, f);
      else
        zero_frag(gt);
    }
    bwd_chain<WGS>(gt, edge, smem, sl, off, it.nv, v, inv, psum, stg, mk);
    float d[NT][4];
    uint32_t f[NF];
    gw_issue(d, gt, edge.w, 0);  // g_h0 · Ke
    if (have && geo)
      ring.reread(f, S_GEO);
    else
      zero_frag(f);
    wg::wait<0>();
    round_acc(v, d);
    add_tiles(v, v, f);
    stage_store(a.de + off, it.nv, v, stg);
    __syncwarp();
    if (next && geo) ring.load(S_GEO, &a.m_geo, nx.row, nx.b0);
  }
  store_psum<WGS>(a, P_EDGE, edge, psum);
  drain<WGS>(edge);
}

// out = bf16(the fp32 sum of the tiles at row(0..count-1), in that order)
template <class RowAt>
__device__ __forceinline__ void gather_sum(uint32_t (&out)[NF], int count, RowAt row, int nv) {
  float d[NT][4];
  uint32_t f[NF];
  zero_acc(d);
#pragma unroll 1
  for (int c = 0; c < count; ++c) {
    tile_load(f, row(c), nv);
    add_frag(d, f);
  }
  round_acc(out, d);
}

// pass 3: P_r, P_s and dx's receiver and sender parts
template <class Rows>
__device__ __forceinline__ void send_body(const BwdArgs& a, unsigned char* smem) {
  unsigned char* k = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);  // [Kr | Ks]
  unsigned char* stg = k + 2 * LAYER_BYTES + (threadIdx.x >> 5) * TILE_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(k + 2 * LAYER_BYTES + 8 * TILE_BYTES);
  if (threadIdx.x == 0) {
    wg::bar_init(bar, 1);
    wg::bar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect(bar, 2 * LAYER_BYTES);
    wg::bulk_load(k, a.img_kk, 2 * LAYER_BYTES, bar);
  }
  wg::bar_wait(bar, 0);
  const bf16* gh0 = a.es[G0];
  const int B = a.batch, chunks = (B + 15) / 16, w = (threadIdx.x >> 5) & 3;
  const long long tiles = static_cast<long long>(a.n_nodes) * chunks, items = (tiles + 3) / 4;
  for (long long g = blockIdx.x * 2LL + (threadIdx.x >> 7); g < items; g += gridDim.x * 2LL) {
    const Item it(4 * g + w, tiles, chunks, B);
    const int j = static_cast<int>(it.row), b0 = it.b0, nv = it.nv;
    const long long xb = (it.row * B + b0) * H;
    uint32_t pr[NF], ps[NF];
    {
      long long first = 0;
      int count = 0, row_step = 0;
      if (nv > 0) Rows::own(a, j, first, count, row_step);
      gather_sum(pr, count, [&](int c) {  // j's own rows
        return gh0 + ((first + static_cast<long long>(c) * row_step) * B + b0) * H;
      }, nv);
      const int i0 = nv > 0 ? a.offsets[j] : 0, i1 = nv > 0 ? a.offsets[j + 1] : 0;
      gather_sum(ps, i1 - i0, [&](int c) {  // the rows j sends on
        return gh0 + (static_cast<long long>(a.order[i0 + c]) * B + b0) * H;
      }, nv);
    }
    stage_store(a.ns[PR] + xb, nv, pr, stg);
    stage_store(a.ns[PS] + xb, nv, ps, stg);
    float d[NT][4];
    uint32_t f[NF], u[NF];
    stage_load(f, a.dx + xb, nv, stg);
    gw(d, pr, wg::smem_u32(k), 0);  // P_r · Krᵀ
    round_acc(u, d);
    add_tiles(f, f, u);
    gw(d, ps, wg::smem_u32(k), KB);  // P_s · Ksᵀ
    round_acc(u, d);
    add_tiles(f, f, u);
    stage_store(a.dx + xb, nv, f, stg);
  }
}

// pass 6 (folded): the encoder's forward and backward on every row, its
// cotangent de from the row pass
template <bool ACTS, int WGS>
__global__ void __launch_bounds__(WG_THREADS * WGS, 1)
    GNW(enc_bwd)(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char enc_smem[];
  const int fe = a.fe;
  Carve c;
  WMlp enc = stage_mlp<WGS>(c, enc_smem, a.img_enc, a.enc, fe, 0, true);
  fix_act<ACTS>(enc);
  unsigned char* stg = c.stage();
  const Slots sl{a.cs + 1};
  const int B = a.batch, chunks = (B + 15) / 16, w = (threadIdx.x >> 5) & 3;
  const long long tiles = static_cast<long long>(a.total_rows) * chunks, items = (tiles + 3) / 4;
  float psum[CS] = {};
  Masks mk;
  for (long long g = blockIdx.x * static_cast<long long>(WGS) + (threadIdx.x >> 7); g < items;
       g += static_cast<long long>(gridDim.x) * WGS) {
    const Item it(4 * g + w, tiles, chunks, B);
    const long long rb = it.row * B + it.b0;
    const long long off = rb * H;
    uint32_t v[NF], gt[NF];
    float inv[2];
    {
      float d[NT][4];
      uint32_t rf[NF];
      enc_first(d, rf, a.raw + rb * fe, fe, enc, it.nv);
      stage_store(a.cs[0] + off, it.nv, rf, stg);  // A_0: the raw rows, zero past fe
      fwd_keep<WGS>(d, enc, enc_smem, sl, off, it.nv, v, inv, stg, mk);
    }
    stage_load(gt, a.de + off, it.nv, stg);
    bwd_chain<WGS>(gt, enc, enc_smem, sl, off, it.nv, v, inv, psum, stg, mk);
  }
  store_psum<WGS>(a, P_ENC, enc, psum);
  drain<WGS>(enc);
}

// ---- weight gradients: products over the rows, partials, ordered sum ----

constexpr int TK = 64;              // rows a stage of the weight-gradient pass
constexpr int STAGES = 4;           // its ring's stages
constexpr int BOX = TK * 128;       // a TK-row x 64-column TMA box
constexpr int STAGE_BYTES = 2 * KB * BOX;  // G's and A's boxes
constexpr int WGRAD_THREADS = KB * WG_THREADS + 32;  // consumers, then the producer warp
constexpr int CS_GROUPS = KB * WG_THREADS / (H / 8);  // row groups of the bias sums (16)
constexpr int CS_ROWS = TK / CS_GROUPS;               // rows of a stage a group adds
constexpr int MAXP = 24;            // products a call (the main call at MAXL layers: 20)
constexpr int PSZ = H * H + H;      // a partial: the [H][H] tile and H column sums
constexpr int SPLIT_ROWS = 8192;
constexpr int MAX_SPLITS = 96;
// the weight-gradient pass's arrays, by their TMA map: the edge rows'
// scratch, the nodes' scratch, e_in (when not folded), x, agg
enum { MAP_EDGE, MAP_NODE, MAP_E, MAP_X, MAP_AGG, MAPS };

// One product: out[m][k] = sum over rows of g[row][m] · a[row][k], into
// w[m · in_dim + col0 + k] for k < width, and the column sums of g into
// sum[m] (null: none); g and a are [rows, H] bf16 planes of the maps
struct Prod {
  float* w;
  float* sum;
  long long rows;
  int in_dim, col0, width;
  int gm, gz, am, az;  // G's and A's map and plane
};

// A scale's gradient from a pass's per-warp column sums
struct ScaleJob {
  const float* parts;  // [warps][H]
  float* out;          // [H]
  int warps;
};

struct WgradArgs {
  CUtensorMap map[MAPS];  // [planes][rows][H], boxes of 64 rows
  Prod p[MAXP];
  ScaleJob sj[2];
  float* part;  // [n][splits][PSZ]
  int n, splits, n_sj;
};

__host__ __device__ inline int splits_for(long long rows) {
  const long long s = (rows + SPLIT_ROWS - 1) / SPLIT_ROWS;
  return static_cast<int>(s < 1 ? 1 : s > MAX_SPLITS ? MAX_SPLITS : s);
}

// pass 4: block (split, product) forms its rows' partial; consumer
// warpgroup i owns outputs 64i..64i+63
__global__ void __launch_bounds__(WGRAD_THREADS, 1)
    GNW(wgrad)(const __grid_constant__ WgradArgs wa) {
  extern __shared__ unsigned char wg_smem[];
  unsigned char* st = wg_smem + ((1024 - (wg::smem_u32(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(st + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  float* csum = reinterpret_cast<float*>(empty + STAGES);  // [CS_GROUPS][H]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, q = blockIdx.y;
  const Prod& p = wa.p[q];
  const long long n_tiles = (p.rows + TK - 1) / TK;
  const long long k0 = n_tiles * split / wa.splits, k1 = n_tiles * (split + 1) / wa.splits;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      wg::bar_init(full + i, 1);
      wg::bar_init(empty + i, 4 * KB);
    }
    wg::bar_fence_init();
  }
  __syncthreads();
  if (warp == 4 * KB) {  // the producer
    if (lane == 0)
      for (long long t = k0; t < k1; ++t) {
        const int i = static_cast<int>(t - k0), s = i % STAGES;
        if (i >= STAGES) wg::bar_wait(empty + s, ((i / STAGES) - 1) & 1);
        unsigned char* sg = st + s * STAGE_BYTES;
        wg::bar_expect(full + s, STAGE_BYTES);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          wg::tma_load3(sg + kb * BOX, &wa.map[p.gm], 64 * kb, static_cast<int>(t * TK), p.gz,
                        full + s);
          wg::tma_load3(sg + (KB + kb) * BOX, &wa.map[p.am], 64 * kb, static_cast<int>(t * TK),
                        p.az, full + s);
        }
      }
    return;
  }
  const int wgi = warp >> 2;
  // the bias sums: thread tid adds the 8 columns of chunk cc over the rows
  // CS_ROWS·rg.. of each stage
  const int cc = tid % (H / 8), rg = tid / (H / 8);
  float acc[NT][4];
  zero_acc(acc);
  float cs[8] = {};
  for (long long t = k0; t < k1; ++t) {
    const int i = static_cast<int>(t - k0), s = i % STAGES;
    wg::bar_wait(full + s, (i / STAGES) & 1);
    const unsigned char* sg = st + s * STAGE_BYTES;
    const uint32_t ga = wg::smem_u32(sg + wgi * BOX), aa = wg::smem_u32(sg + KB * BOX);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks)
      wg::mma_ss<1, 1>(acc, wg::desc_mn(ga, ks, BOX), wg::desc_mn(aa, ks, BOX), 1);
    wg::commit();
    if (p.sum) {
      const unsigned char* gb = sg + (cc >> 3) * BOX;
#pragma unroll
      for (int r = CS_ROWS * rg; r < CS_ROWS * (rg + 1); ++r) {
        const uint4 u = *reinterpret_cast<const uint4*>(gb + wg::sw128(r, 8 * (cc & 7)));
        const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          cs[2 * k] += __uint_as_float(wd[k] << 16);
          cs[2 * k + 1] += __uint_as_float(wd[k] & 0xffff0000u);
        }
      }
    }
    wg::wait<0>();
    __syncwarp();
    if (lane == 0) wg::bar_arrive(empty + s);
  }

  float* out = wa.part + (static_cast<long long>(q) * wa.splits + split) * PSZ;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = 64 * wgi + 16 * (warp & 3) + (lane >> 2) + 8 * half;
      const int k = 8 * n + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + m * H + k) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
#pragma unroll
  for (int k = 0; k < 8; ++k) csum[rg * H + 8 * cc + k] = cs[k];
  asm volatile("bar.sync 1, %0;\n" ::"n"(KB * WG_THREADS) : "memory");
  if (tid < H) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < CS_GROUPS; ++g) t += csum[g * H + tid];
    out[H * H + tid] = t;
  }
}

// the scale's gradient of a ScaleJob, SJ_BLOCKS blocks of SJ_COLS columns:
// thread (c, j) adds the warps j, j + WAYS, ... in order, then column c's
// WAYS sums are added in j order
constexpr int SJ_BLOCKS = 8, SJ_COLS = H / SJ_BLOCKS, WAYS = 256 / SJ_COLS;

__device__ __forceinline__ void scale_sum(const ScaleJob& sj, int k) {
  __shared__ float part[WAYS][SJ_COLS];
  const int c = threadIdx.x % SJ_COLS, j = threadIdx.x / SJ_COLS, col = k * SJ_COLS + c;
  float s = 0.f;
#pragma unroll 8
  for (int w = j; w < sj.warps; w += WAYS) s += sj.parts[static_cast<long long>(w) * H + col];
  part[j][c] = s;
  __syncthreads();
  if (j == 0) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < WAYS; ++q) t += part[q][c];
    sj.out[col] = t;
  }
}

// pass 5: each gradient element the sum of its partials, in split order;
// the last n_sj · SJ_BLOCKS blocks the scales' sums
__global__ void __launch_bounds__(256) GNW(wsum)(const __grid_constant__ WgradArgs wa) {
  const int sum_blocks = static_cast<int>((static_cast<long long>(wa.n) * PSZ + 255) / 256);
  if (static_cast<int>(blockIdx.x) >= sum_blocks) {
    const int b = blockIdx.x - sum_blocks;
    scale_sum(wa.sj[b / SJ_BLOCKS], b % SJ_BLOCKS);
    return;
  }
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= static_cast<long long>(wa.n) * PSZ) return;
  const int q = static_cast<int>(idx / PSZ), e = static_cast<int>(idx % PSZ);
  const Prod& p = wa.p[q];
  const float* src = wa.part + static_cast<long long>(q) * wa.splits * PSZ + e;
  float s = 0.f;
  for (int sp = 0; sp < wa.splits; ++sp) s += src[static_cast<long long>(sp) * PSZ];
  if (e < H * H) {
    const int m = e / H, k = e % H;
    if (k < p.width) p.w[m * p.in_dim + p.col0 + k] = s;
  } else if (p.sum) {
    p.sum[e - H * H] = s;
  }
}

inline cudaError_t launch_wgrad(const WgradArgs& wa, cudaStream_t stream) {
  const size_t smem = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8 + CS_GROUPS * H * 4;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(GNW(wgrad)),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  GNW(wgrad)<<<dim3(wa.splits, wa.n), WGRAD_THREADS, smem, stream>>>(wa);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int blocks = static_cast<int>((static_cast<long long>(wa.n) * PSZ + 255) / 256);
  GNW(wsum)<<<blocks + wa.n_sj * SJ_BLOCKS, 256, 0, stream>>>(wa);
  return cudaGetLastError();
}

// an MLP's products: layer 0 (g_0 against A plane ``a0`` of map ``am``, its
// first ``width`` of in_dim inputs, with the bias), layers 1.. (g_l against
// A_l); the MLP's slots are planes of map ``sm`` (``plane``: a slot's)
inline void add_mlp_products(WgradArgs& wa, const Mlp& grad, const int* plane, int sm, int am,
                             int a0, long long rows, int width) {
  wa.p[wa.n++] = {const_cast<float*>(grad.w[0]), const_cast<float*>(grad.b[0]), rows,
                  grad.in_dim, 0, width, sm, plane[G0], am, a0};
  for (int l = 1; l < grad.n_layers; ++l)
    wa.p[wa.n++] = {const_cast<float*>(grad.w[l]), const_cast<float*>(grad.b[l]), rows, H, 0, H,
                    sm, plane[G0 + l], sm, plane[A1 + l - 1]};
}

// the warps a P-summing pass may have: 64 a multiprocessor
inline int pass_warps() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return 64 * sms;
}

// The scratch's layout: the nodes' planes (xkr, xks, g_agg, the node
// MLP's slots, P_r, P_s) and the edge rows' (the edge MLP's slots, which
// the encoder reuses, then e_in / A_0 and de when folded), as one
// [planes][rows][H] array each, then the packed MLPs
struct Scratch {
  int node_planes, edge_planes;
  int np[SLOTS + 2];  // node plane of each node slot (or -1)
  int ep[SLOTS];      // edge plane of each edge slot (or -1)
};

inline Scratch scratch_layout(int fe, int n_edge, int n_node, int n_enc) {
  Scratch s;
  int k = 3;  // xkr, xks, g_agg
  for (int i = 0; i < SLOTS + 2; ++i) s.np[i] = i >= SLOTS || slot_used(i, n_node) ? k++ : -1;
  s.node_planes = k;
  k = 0;
  for (int i = 0; i < SLOTS; ++i)
    s.ep[i] = slot_used(i, n_edge) || (fe > 0 && slot_used(i, n_enc)) ? k++ : -1;
  s.edge_planes = k + (fe > 0 ? 2 : 0);
  return s;
}

// bf16 scratch elements (which = 0) and fp32 partial elements (1) of a
// call with MLPs of n_edge, n_node and (folded, fe > 0) n_enc layers
inline long long bwd_sizes(int which, int n_nodes, int batch, long long total_rows, int fe,
                           int n_edge, int n_node, int n_enc) {
  const long long nrows = static_cast<long long>(n_nodes) * batch, erows = total_rows * batch;
  const Scratch sc = scratch_layout(fe, n_edge, n_node, n_enc);
  if (which == 0)
    return (sc.node_planes * nrows + sc.edge_planes * erows) * H +
           img_layout(fe, n_enc, n_edge, n_node).total / 2;
  // the main call's products: the edge MLP's, Kr and Ks, the node MLP's
  // and its aggregate's columns; the encoder's call reuses the buffer;
  // then the scales' per-warp sums
  const int main = n_edge + 2 + n_node + 1, enc = fe > 0 ? n_enc : 0;
  return static_cast<long long>(main > enc ? main : enc) *
             splits_for(erows > nrows ? erows : nrows) * PSZ +
         3LL * pass_warps() * H;
}

// a [planes][rows][H] map with boxes of TK rows
inline bool plane_map(CUtensorMap* m, const void* base, long long rows, int planes) {
  return wg::tensor_map3(m, base, H, rows, planes, TK, 1);
}

using BwdKernel = void (*)(const BwdArgs);

// launches a pass kernel of ``wgs`` warpgroups a block over ``items``
// warpgroup items; ``warps`` gets its warp count
inline cudaError_t launch_pass(BwdKernel kernel, int wgs, size_t smem, long long items,
                               const BwdArgs& a, cudaStream_t stream, int* warps = nullptr) {
  int grid = 0;
  cudaError_t err = grid_of(reinterpret_cast<const void*>(kernel), wgs, smem, items, &grid);
  if (err != cudaSuccess) return err;
  if (warps) *warps = grid * wgs * 4;
  kernel<<<grid, WG_THREADS * wgs, smem, stream>>>(a);
  return cudaGetLastError();
}

// adds the scale of an MLP (its gradient ``grad``) whose pass had ``warps``
// warps to the ordered sum's jobs
inline void add_scale_job(WgradArgs& wa, const BwdArgs& a, int mlp, const Mlp& grad, int warps) {
  if (grad.scale != nullptr)
    wa.sj[wa.n_sj++] = {a.pparts + static_cast<long long>(mlp) * a.pwarps * H,
                        const_cast<float*>(grad.scale), warps};
}

// Every pass on ``stream``: ``rows[i]`` and ``send`` are the calling
// source's wrappers of row_bwd_body<Rows, ACTS, WGS> (instance i,
// gn_wide.cuh:instance_of) and send_body<Rows>. ``scratch`` holds
// bwd_sizes(0, ...) bf16 elements, ``part`` bwd_sizes(1, ...) floats; a
// carries the inputs, outputs, MLPs and row map (a.e is the raw features
// when folded).
inline cudaError_t launch_bwd(BwdArgs a, bf16* scratch, float* part, cudaStream_t stream,
                              const BwdKernel* rows, BwdKernel send) {
  const int B = a.batch, chunks = (B + 15) / 16;
  const long long nrows = static_cast<long long>(a.n_nodes) * B;
  const long long erows = static_cast<long long>(a.total_rows) * B;
  const bool fold = a.fe > 0;
  const Scratch sc = scratch_layout(a.fe, a.edge.n_layers, a.node.n_layers,
                                    fold ? a.enc.n_layers : 0);
  bf16* node_slab = scratch;
  bf16* edge_slab = node_slab + sc.node_planes * nrows * H;
  unsigned char* img = reinterpret_cast<unsigned char*>(edge_slab + sc.edge_planes * erows * H);
  const Images im = img_layout(a.fe, fold ? a.enc.n_layers : 0, a.edge.n_layers,
                               a.node.n_layers);
  a.xkr = node_slab;
  a.xks = node_slab + nrows * H;
  if (a.gagg == nullptr) a.gagg = node_slab + 2 * nrows * H;
  for (int i = 0; i < SLOTS + 2; ++i)
    a.ns[i] = sc.np[i] < 0 ? nullptr : node_slab + sc.np[i] * nrows * H;
  for (int i = 0; i < SLOTS; ++i)
    a.es[i] = sc.ep[i] < 0 ? nullptr : edge_slab + sc.ep[i] * erows * H;
  const int ein_plane = sc.edge_planes - 2;
  if (fold) {
    a.raw = a.e;
    a.e = edge_slab + ein_plane * erows * H;  // e_in, then the encoder's A_0
    a.de = edge_slab + (ein_plane + 1) * erows * H;
    a.cs[0] = const_cast<bf16*>(a.e);
    for (int i = 0; i < SLOTS; ++i) a.cs[1 + i] = a.es[i];
  }
  a.img_enc = img + im.enc;
  a.img_edge = img + im.edge;
  a.img_node = img + im.node;
  a.img_kk = img + im.kk;
  a.pwarps = pass_warps();
  const int main_products = a.edge.n_layers + 2 + a.node.n_layers + 1;
  const int enc_products = fold ? a.enc.n_layers : 0;
  a.pparts = part + static_cast<long long>(main_products > enc_products ? main_products
                                                                          : enc_products) *
                        splits_for(erows > nrows ? erows : nrows) * PSZ;
  if (!row_map(&a.m_e, a.e, a.total_rows, B) || !row_map(&a.m_geo, a.g_eout, a.total_rows, B) ||
      !row_map(&a.m_x, a.x, a.n_nodes, B) || a.pwarps == 0)
    return cudaErrorInvalidValue;

  cudaError_t err = pack_call(img, im, &a.enc, a.fe, a.edge, a.node, stream);
  if (err != cudaSuccess) return err;
  if ((err = launch_partial(a.x, const_cast<bf16*>(a.xkr), const_cast<bf16*>(a.xks),
                            reinterpret_cast<const bf16*>(a.img_kk), a.n_nodes, B, stream)) !=
      cudaSuccess)
    return err;
  if (fold && (err = launch_enc_fwd(a.raw, const_cast<bf16*>(a.e), a.img_enc, a.enc,
                                    a.total_rows, B, stream)) != cudaSuccess)
    return err;
  const long long node_items = (a.n_nodes * static_cast<long long>(chunks) + 3) / 4;
  const long long row_items = (a.total_rows * static_cast<long long>(chunks) + 3) / 4;
  int node_warps = 0, row_warps = 0;
  {
    const int inst = instance_of(a.node, 2 * H, 1), wgs = wgs_of(inst);
    const BwdKernel k = inst == 0 ? GNW(node_bwd)<false, 2>
                        : inst == 1 ? GNW(node_bwd)<true, 2> : GNW(node_bwd)<true, 1>;
    const size_t smem = pass_bytes(2 * H, a.node.n_layers,
                                   plan_pass(2 * H, a.node.n_layers, 1).resident, wgs, 1);
    if ((err = launch_pass(k, wgs, smem, node_items, a, stream, &node_warps)) != cudaSuccess)
      return err;
  }
  {
    const int inst = instance_of(a.edge, H, 2), wgs = wgs_of(inst);
    const size_t smem = pass_bytes(H, a.edge.n_layers, plan_pass(H, a.edge.n_layers, 2).resident,
                                   wgs, 2);
    if ((err = launch_pass(rows[inst], wgs, smem, row_items, a, stream, &row_warps)) !=
        cudaSuccess)
      return err;
  }
  if ((err = launch_pass(send, 2, 2 * LAYER_BYTES + 8 * TILE_BYTES + 2048, node_items, a,
                         stream)) != cudaSuccess)
    return err;

  WgradArgs wa = {};
  wa.part = part;
  wa.splits = splits_for(erows > nrows ? erows : nrows);
  if (!plane_map(&wa.map[MAP_EDGE], edge_slab, erows, sc.edge_planes) ||
      !plane_map(&wa.map[MAP_NODE], node_slab, nrows, sc.node_planes) ||
      !plane_map(&wa.map[MAP_E], a.e, erows, 1) || !plane_map(&wa.map[MAP_X], a.x, nrows, 1) ||
      !plane_map(&wa.map[MAP_AGG], a.agg, nrows, 1))
    return cudaErrorInvalidValue;
  // Ke against e_in (the caller's e, or the encoder's output in the edge scratch)
  add_mlp_products(wa, a.gedge, sc.ep, MAP_EDGE, fold ? MAP_EDGE : MAP_E, fold ? ein_plane : 0,
                   erows, H);
  float* gw0 = const_cast<float*>(a.gedge.w[0]);
  wa.p[wa.n++] = {gw0, nullptr, nrows, 3 * H, H, H, MAP_NODE, sc.np[PR], MAP_X, 0};      // Kr
  wa.p[wa.n++] = {gw0, nullptr, nrows, 3 * H, 2 * H, H, MAP_NODE, sc.np[PS], MAP_X, 0};  // Ks
  add_mlp_products(wa, a.gnode, sc.np, MAP_NODE, MAP_X, 0, nrows, H);  // x's columns, the bias
  wa.p[wa.n++] = {const_cast<float*>(a.gnode.w[0]), nullptr, nrows, 2 * H, H, H, MAP_NODE,
                  sc.np[G0], MAP_AGG, 0};  // the aggregate's columns
  add_scale_job(wa, a, P_EDGE, a.gedge, row_warps);
  add_scale_job(wa, a, P_NODE, a.gnode, node_warps);
  if ((err = launch_wgrad(wa, stream)) != cudaSuccess || !fold) return err;

  int enc_warps = 0;
  {
    const int inst = instance_of(a.enc, a.fe, 0), wgs = wgs_of(inst);
    const BwdKernel k = inst == 0 ? GNW(enc_bwd)<false, 2>
                        : inst == 1 ? GNW(enc_bwd)<true, 2> : GNW(enc_bwd)<true, 1>;
    const size_t smem = pass_bytes(a.fe, a.enc.n_layers,
                                   plan_pass(a.fe, a.enc.n_layers, 0).resident, wgs, 0);
    if ((err = launch_pass(k, wgs, smem, row_items, a, stream, &enc_warps)) != cudaSuccess)
      return err;
  }
  WgradArgs we = {};
  we.part = part;
  we.splits = wa.splits;
  we.map[MAP_EDGE] = wa.map[MAP_EDGE];
  add_mlp_products(we, a.genc, sc.ep, MAP_EDGE, MAP_EDGE, ein_plane, erows, a.fe);
  add_scale_job(we, a, P_ENC, a.genc, enc_warps);
  return launch_wgrad(we, stream);
}

// Fills the pointers and MLPs of ``a`` from a backward's C arguments (each
// weight and gradient list 2 * n_layers + 1 pointers: w0, b0, w1, b1, ...,
// the RMSNorm scale or null); false if they do not fit the kernels. fe > 0
// folds the encoder in (then de is null); dea, when not null, receives the
// aggregate's cotangent (that of an extra aggregate the forward added: the
// node pass writes it there in place of its scratch slot). The caller sets
// the row map.
inline bool make_bwd_args(BwdArgs* a, const void* x, const void* e, const void* agg,
                          const void* g_xout, const void* g_eout, void* dx, void* de, void* dea,
                          const void* senders, const void* mask, const void* order,
                          const void* offsets, int batch, int fe, const void* const* enc_w,
                          const void* const* enc_g, int n_enc_layers, int enc_act,
                          const void* const* edge_w, const void* const* edge_g,
                          int n_edge_layers, int edge_act, const void* const* node_w,
                          const void* const* node_g, int n_node_layers, int node_act) {
  a->x = static_cast<const bf16*>(x);
  a->e = static_cast<const bf16*>(e);
  a->agg = static_cast<const bf16*>(agg);
  a->g_xout = static_cast<const bf16*>(g_xout);
  a->g_eout = static_cast<const bf16*>(g_eout);
  a->dx = static_cast<bf16*>(dx);
  a->de = static_cast<bf16*>(de);
  a->gagg = static_cast<bf16*>(dea);
  a->senders = static_cast<const int32_t*>(senders);
  a->mask = static_cast<const uint8_t*>(mask);
  a->order = static_cast<const int32_t*>(order);
  a->offsets = static_cast<const int32_t*>(offsets);
  a->batch = batch;
  a->fe = fe;
  const bool fold = fe > 0;
  auto pair = [](Mlp* w, Mlp* g, const void* const* wp, const void* const* gp, int n, int in,
                 int act) {
    return make_wide_mlp(w, wp, n, in, act) && make_wide_mlp(g, gp, n, in, act) &&
           (w->scale == nullptr) == (g->scale == nullptr);
  };
  return (!fold ||
          (fe <= H && pair(&a->enc, &a->genc, enc_w, enc_g, n_enc_layers, fe, enc_act))) &&
         pair(&a->edge, &a->gedge, edge_w, edge_g, n_edge_layers, 3 * H, edge_act) &&
         pair(&a->node, &a->gnode, node_w, node_g, n_node_layers, 2 * H, node_act) &&
         (de == nullptr) == fold && a->n_nodes >= 1 && batch >= 1 && a->total_rows >= 1;
}

}  // namespace gnw
