// The pass bodies of the GraphNetBlock backward, written once for both
// edge layouts and templated on the row map: receiver-sorted CSR
// (fused_gnblock_csr_bwd.cu) and the NK slot layout
// (fused_gnblock_nk_bwd.cu). Each source wraps them in kernels of its own
// name and launches them with launch_passes:
//  0. a node pre-pass (gn_tile.cuh:gn_partial_tc_kernel) writes bf16(x @ Kr)
//     and bf16(x @ Ks) per (node, sample);
//  1. node-MLP pass, one warp per (node, 16-sample) tile: the node MLP's
//     backward from g_xout and the aggregate the forward kept; it writes
//     dx's node-MLP part and the aggregate's cotangent g_agg [N, B, H]
//     (bf16);
//  2. row pass, one warp per (row, 16-sample) tile of every row: the edge
//     MLP (and folded encoder) forward, its backward from g_agg of the
//     row's receiver plus g_eout, de, and g_h0 to a bf16 scratch [S, B, H].
//     A row's samples are contiguous, so its tile is one 1 KB load at
//     B = 16, and no warp waits on a longer row range than its own. Rows
//     outside every receiver's range (CSR padding) and masked rows take a
//     zero cotangent and skip the edge MLP: their g_h0 is 0 and their de
//     is g_eout;
//  3. sender pass, one thread per (node, sample), on the CUDA cores: sums
//     P_r over the node's own rows and P_s over the rows it sends on (a
//     sender-sorted row list, the layout's transpose), both in fp32; adds
//     bf16(P_r·Krᵀ) and bf16(P_s·Ksᵀ) to its own dx and stages x ⊗ P_r and
//     x ⊗ P_s for dKr and dKs (gn_bwd_common.cuh).
// No atomics: the weight gradients are summed from per-block partials in
// block order (gn_bwd_common.cuh), so two calls give the same bits.
//
// Passes 1 and 2 run every product on the tensor cores (gn_tile.cuh). A
// block is 8 warps and takes 8 tiles (128 sample rows) at a time. Each
// warp runs its tile's MLP forward with the fragments in registers, then
// the backward through the RMSNorm and the layers (g·W products with the
// relu masks and the bf16 roundings of the JAX kernel's _mlp_bwd), and
// stages in shared memory what the weight gradients contract over: each
// layer's (relu'd) input A_l, the cotangent G_l at its output and the
// RMSNorm scale's terms P. After a barrier the block's 8 warps share the
// weight gradients of the 128 rows: warp w owns output rows 16(w % 2)..+15
// of layer w / 2 (and of the scale on the last layer), dW = Gᵀ·A from
// ldmatrix.trans'd staged tiles, contracting over the rows, and the bias
// (or scale) sums as products with a column of ones. The accumulators stay
// in registers across the block's tiles (24 to 40 a lane per MLP); at its
// end the block writes them to shared memory in grad_slot's layout and
// from there to its slot of the partials, which reduce_mlp_kernel adds
// into the global fp32 gradients in block order (gn_bwd_common.cuh).
//
// A row map (gn_rows.cuh) gives, for a layout: the end of the rows that
// belong to some receiver (ranged_end), the receiver of a row, and the rows
// a node owns (first, count, step).
#pragma once

#include "gn_bwd_common.cuh"
#include "gn_rows.cuh"
#include "gn_tile.cuh"

namespace gn_bwd {

using namespace gn_rows;
using namespace gn_tile;

constexpr int PASS_THREADS = 256;
constexpr int PASS_WARPS = PASS_THREADS / 32;
constexpr int ROWS = 16 * PASS_WARPS;  // staged sample rows of a block
constexpr int SEND_THREADS = 128;
constexpr int SEND_WARPS = SEND_THREADS / 32;
constexpr int MT = HP / 16;  // m-tiles of a layer's outputs in the weight gradients

struct PassArgs : RowMap {
  const __nv_bfloat16* x;       // [N, B, H]
  const __nv_bfloat16* e;       // [S, B, H], or raw [S, B, fe] when folded
  const __nv_bfloat16* xkr;     // [N, B, H] scratch: bf16(x @ Kr), from the pre-pass
  const __nv_bfloat16* xks;     // [N, B, H] scratch: bf16(x @ Ks), from the pre-pass
  const __nv_bfloat16* agg;     // [N, B, H] the forward's bf16 aggregate
  const __nv_bfloat16* g_xout;  // [N, B, H]
  const __nv_bfloat16* g_eout;  // [S, B, H]; null on the last block
  __nv_bfloat16* dx;            // [N, B, H]: the node-MLP part, then all of dx
  __nv_bfloat16* de;            // [S, B, H]; null when folded
  __nv_bfloat16* gagg;          // [N, B, H] scratch: the aggregate's cotangent
  __nv_bfloat16* gh0;           // [S, B, H] scratch: g_h0 of every row of a range
  const int32_t* senders;       // [S] sender per row (0 on padding)
  const uint8_t* mask;          // [S] 1 on valid rows
  const int32_t* order;         // the valid rows sorted by sender
  const int32_t* offsets;       // [N + 1] node j sends on order[offsets[j]:offsets[j+1]]
  int batch, fe;
  Mlp enc, edge, node;     // weights
  Mlp genc, gedge, gnode;  // their gradients: same shapes, fp32, zeroed
  float* part;              // each block's gradient sums (launch_passes sizes it)
};

// A block's staging of one MLP's backward for the weight gradients: each
// layer's input A_l (relu'd; [ROWS][a0_stride] for layer 0, else
// [ROWS][TS]), the cotangent G_l at each layer's output and the RMSNorm
// scale's terms P ([ROWS][TS]); warp w's tile is rows 16w..16w+15.
struct Stage {
  bf16* a[NL];
  bf16* g[NL];
  bf16* p;
  int a0_stride;
};

// bytes of one Stage
__host__ __device__ inline size_t stage_bytes(int a0_stride) {
  return sizeof(bf16) * ROWS * (a0_stride + (2 * NL) * TS);
}

__device__ inline Stage carve_stage(bf16*& at, int a0_stride) {
  Stage st;
  st.a0_stride = a0_stride;
  st.a[0] = at;
  at += ROWS * a0_stride;
  for (int l = 1; l < NL; ++l, at += ROWS * TS) st.a[l] = at;
  for (int l = 0; l < NL; ++l, at += ROWS * TS) st.g[l] = at;
  st.p = at;
  at += ROWS * TS;
  return st;
}

// layer L's staged G and A (L may vary at run time)
__device__ __forceinline__ const bf16* g_of(const Stage& st, int L) {
  return st.g[0] + L * ROWS * TS;
}
__device__ __forceinline__ const bf16* a_of(const Stage& st, int L) {
  return L == 0 ? st.a[0] : st.a[1] + (L - 1) * ROWS * TS;
}

// this warp's 16 rows of a staged tensor
__device__ __forceinline__ bf16* mine(bf16* t, int stride) {
  return t + (threadIdx.x / 32) * 16 * stride;
}

// zero a block's staging (elements from..to, 16-byte aligned), so the
// rows a tile leaves unwritten are finite
__device__ inline void zero_smem(bf16* from, const bf16* to) {
  uint4* p = reinterpret_cast<uint4*>(from);
  const long long n = (to - from) / 8;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// a tile that adds nothing to the weight gradients: zero cotangents
__device__ __forceinline__ void zero_cots(const Stage& st, bool norm) {
  uint32_t z[FR];
  zero_frag(z);
#pragma unroll
  for (int l = 0; l < NL; ++l) frag_to_smem(mine(st.g[l], TS), TS, z);
  if (norm) frag_to_smem(mine(st.p, TS), TS, z);
}

// An MLP's forward on the warp's tile from its first layer's fp32 product
// d0 (bias not yet added), staging each later layer's input: with relu its
// relu'd input A_l (its pass mask too), with SiLU or GELU the
// pre-activation, which bwd_chain needs for the derivative and then
// overwrites with A_l = act(pre) (_mlp_bwd recomputes act(pres[i]) at
// use); v gets the last layer's output (the RMSNorm's input) and inv its
// statistic. The caller stages A_0.
__device__ __forceinline__ void fwd_keep(const float (&d0)[NT][4], const TileMlp& m,
                                         const Stage& st, uint32_t (&v)[FR], float (&inv)[2]) {
  finish(v, d0, m.bias(0));
#pragma unroll
  for (int l = 1; l < NL; ++l) {
    uint32_t act[FR];
    activate(act, v, m.act);
    if (m.act == mlp_act::RELU)  // two calls: a selected array would go to local memory
      frag_to_smem(mine(st.a[l], TS), TS, act);
    else
      frag_to_smem(mine(st.a[l], TS), TS, v);
    float d[NT][4];
    zero_acc(d);
    mma_awt(d, act, m.layer(l), TS, 0);
    finish(v, d, m.bias(l));
  }
  inv[0] = inv[1] = 1.f;
  if (m.norm) rms_inv(inv, v);
}

// The backward through the RMSNorm and layers NL-1..1 (JAX _mlp_bwd): g in,
// the cotangent at the MLP's output; out, the cotangent at layer 0's
// output. Stages P and every G_l.
__device__ __forceinline__ void bwd_chain(uint32_t (&g)[FR], const TileMlp& m, const Stage& st,
                                          const uint32_t (&v)[FR], const float (&inv)[2]) {
  if (m.norm) {
    uint32_t p[FR];
    rms_bwd(g, p, v, inv, m.scale());
    frag_to_smem(mine(st.p, TS), TS, p);
  }
#pragma unroll
  for (int l = NL - 1; l >= 1; --l) {
    frag_to_smem(mine(st.g[l], TS), TS, g);
    float d[NT][4];
    zero_acc(d);
    mma_gw(d, g, m.layer(l), TS, 0);
    uint32_t act[FR];
    frag_from_smem(act, mine(st.a[l], TS), TS);  // this lane's own stores
    round_acc(g, d);
    if (m.act == mlp_act::RELU) {
#pragma unroll
      for (int i = 0; i < FR; ++i) g[i] &= pos_mask(act[i]);
    } else {  // act holds the pre-activation: g · act'(pre), then A_l = act(pre)
#pragma unroll
      for (int i = 0; i < FR; ++i) {
        g[i] = mlp_act::grad_pair(g[i], act[i], m.act);
        act[i] = mlp_act::act_pair(act[i], m.act);
      }
      frag_to_smem(mine(st.a[l], TS), TS, act);
    }
  }
  frag_to_smem(mine(st.g[0], TS), TS, g);
}

// B fragment of a column of ones (B[k][0] = 1, other columns 0): a column
// sum of the A operand as a product
__device__ __forceinline__ uint32_t ones_b() { return lane_id() < 4 ? 0x3f803f80u : 0u; }

// A warp's share of one MLP's weight gradients: output rows 16·mt..+15 of
// a layer, dw += Gᵀ·A over the block's 16·KST staged rows (nt <= NT
// n-tiles of 8 inputs), db += the column sums of G (the bias), and, with
// P, ds += those of P (the RMSNorm scale).
template <int N, int KST = PASS_WARPS>
__device__ __forceinline__ void wgrad(float (&dw)[N][4], float (&db)[4], float (&ds)[4],
                                      const bf16* G, const bf16* A, int a_stride, const bf16* P,
                                      int mt, int nt) {
  const int lane = lane_id();
  const uint32_t one = ones_b();
#pragma unroll 2
  for (int ks = 0; ks < KST; ++ks) {
    uint32_t af[4];
    ldsm_t(af, a_cols(G, TS, 16 * mt, 16 * ks, lane));
#pragma unroll
    for (int p = 0; p < N / 2; ++p) {
      if (2 * p < nt) {
        uint32_t b[4];
        ldsm_t(b, b_cols(A, a_stride, 16 * p, 16 * ks, lane));
        mma(dw[2 * p], af, b[0], b[1]);
        mma(dw[2 * p + 1], af, b[2], b[3]);
      }
    }
    mma(db, af, one, one);
    if (P) {
      ldsm_t(af, a_cols(P, TS, 16 * mt, 16 * ks, lane));
      mma(ds, af, one, one);
    }
  }
}

// Write a warp's share (wgrad's sums for layer L, rows 16·mt..) into the
// block's zeroed gradient buffer in grad_slot's layout (per layer
// [in][H] then the bias; then the scale); inputs past the layer's width
// (or past the N n-tiles), padded inputs and outputs past H are left out.
// Layer 0's staged input is ``parts`` blocks of in_dim / parts columns,
// each padded to HP when there are several.
template <int N>
__device__ __forceinline__ void put_grads(float* buf, const float (&dw)[N][4],
                                          const float (&db)[4], const float (&ds)[4],
                                          int in_dim, int parts, int L, int mt, bool scale) {
  const int lane = lane_id(), g = lane >> 2, q = lane & 3;
  const int rows = L == 0 ? in_dim : H;
  const int pw = L == 0 ? in_dim / parts : H;      // a block's true columns
  const int pp = L == 0 && parts == 1 ? in_dim : HP;  // and its staged width
  float* w = buf + (L == 0 ? 0 : in_dim * H + H + (L - 1) * (H * H + H));
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = 16 * mt + g + 8 * (e >> 1), i = 8 * n + 2 * q + (e & 1);
      const int blk = i / pp, k = i % pp, row = blk * pw + k;
      if (o < H && k < pw && row < rows) w[row * H + o] = dw[n][e];
    }
  if (q == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int o = 16 * mt + g + 8 * r;
      if (o >= H) continue;
      w[rows * H + o] = db[2 * r];
      if (scale) buf[in_dim * H + H + (NL - 1) * (H * H + H) + o] = ds[2 * r];
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_sums(float (&dw)[N][4], float (&db)[4], float (&ds)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < N; ++n) dw[n][e] = 0.f;
    db[e] = ds[e] = 0.f;
  }
}

// pass 1 on tile t: the node MLP's backward on (node, 16 samples)
__device__ __forceinline__ void node_tile(const PassArgs& a, const TileMlp& node,
                                          const Stage& st, long long t, int chunks) {
  const int B = a.batch;
  const int b0 = 16 * static_cast<int>(t % chunks), nv = min(16, B - b0);
  const long long xb = ((t / chunks) * B + b0) * H;
  uint32_t xf[FR], ag[FR];
  frag_load(xf, a.x + xb, H, nv);
  frag_load(ag, a.agg + xb, H, nv);
  bf16* a0 = mine(st.a[0], st.a0_stride);
  frag_to_smem(a0, st.a0_stride, xf);
  frag_to_smem(a0 + HP, st.a0_stride, ag);
  float d[NT][4];
  zero_acc(d);
  mma_awt(d, xf, node.layer(0), node.stride0, 0);
  mma_awt(d, ag, node.layer(0), node.stride0, HP);
  uint32_t v[FR], g[FR];
  float inv[2];
  fwd_keep(d, node, st, v, inv);
  frag_load(xf, a.g_xout + xb, H, nv);
#pragma unroll
  for (int i = 0; i < FR; ++i) g[i] = xf[i];
  bwd_chain(g, node, st, v, inv);
  zero_acc(d);
  mma_gw(d, g, node.layer(0), node.stride0, 0);  // the x part
  round_acc(v, d);
  add_tiles(xf, xf, v);
  frag_store(a.dx + xb, H, nv, xf);  // finished by the sender pass
  zero_acc(d);
  mma_gw(d, g, node.layer(0), node.stride0, HP);  // the aggregate's part
  round_acc(v, d);
  frag_store(a.gagg + xb, H, nv, v);
}

// pass 1: the node MLP's backward, one warp per (node, 16-sample) tile:
// dx's node-MLP part, the aggregate's cotangent g_agg, the node MLP's
// gradients
template <bool ACTS>
__device__ __forceinline__ void nodemlp_pass(const PassArgs& a) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  constexpr int A0S = 2 * HP + 8;  // [x | agg] rows
  bf16* at = reinterpret_cast<bf16*>(pass_smem);
  TileMlp node = stage_tile_mlp(at, a.node);
  fix_act<ACTS>(node);
  at += tile_mlp_elems(a.node);
  bf16* const stage0 = at;
  const Stage st = carve_stage(at, A0S);
  zero_smem(stage0, at);
  __syncthreads();

  // warp w holds output rows 16·mt.. of layer L (MT m-tiles a layer); at
  // HP = 16 warps 4-7 hold none
  const int warp = threadIdx.x / 32, L = warp / MT, mt = warp % MT;
  const bool sums = L < NL;
  const bool scale = node.norm && L == NL - 1;
  const bf16* G = sums ? g_of(st, L) : nullptr;
  const bf16* A = sums ? a_of(st, L) : nullptr;
  const bf16* P = scale ? st.p : nullptr;
  const int as = L == 0 ? A0S : TS, nt = L == 0 ? 2 * NT : NT;
  float dw[2 * NT][4], db[4], ds[4];  // layer 0 has 2·NT n-tiles (2·HP inputs), the others NT
  zero_sums<2 * NT>(dw, db, ds);
  const int chunks = (a.batch + 15) / 16;
  const long long tiles = static_cast<long long>(a.n_nodes) * chunks;
  const long long groups = (tiles + PASS_WARPS - 1) / PASS_WARPS;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long t = grp * PASS_WARPS + warp;
    if (t < tiles)
      node_tile(a, node, st, t, chunks);
    else
      zero_cots(st, node.norm);
    __syncthreads();
    if (sums) wgrad<2 * NT>(dw, db, ds, G, A, as, P, mt, nt);
    __syncthreads();
  }
  float* buf = reinterpret_cast<float*>(stage0);
  for (int i = threadIdx.x; i < mlp_floats(a.node); i += blockDim.x) buf[i] = 0.f;
  __syncthreads();
  if (sums) put_grads<2 * NT>(buf, dw, db, ds, 2 * H, 2, L, mt, scale);
  __syncthreads();
  store_partial(buf, a.part, mlp_floats(a.node));
}

// pass 2 on tile t: the edge MLP's (and folded encoder's) backward on
// (row, 16 samples)
template <class Rows, bool FOLD>
__device__ __forceinline__ void row_tile(const PassArgs& a, const TileMlp& edge,
                                         const TileMlp& enc, const Stage& es, const Stage& ns,
                                         long long t, int chunks, long long pad0) {
  const int B = a.batch;
  const long long s = t / chunks;
  const int b0 = 16 * static_cast<int>(t % chunks), nv = min(16, B - b0);
  const long long rb = s * B + b0;
  const bool ranged = s < pad0;  // a row of some receiver's range
  const bool valid = ranged && a.mask[s];
  uint32_t geo[FR];
  if (a.g_eout)
    frag_load(geo, a.g_eout + rb * H, H, nv);
  else
    zero_frag(geo);
  // the folded encoder's cotangent is 0 on a row with neither
  const bool enc_live = FOLD && (valid || a.g_eout != nullptr);
  uint32_t ein[FR], venc[FR];
  float ienc[2];
  if (FOLD) {
    if (enc_live) {
      uint32_t rf[FR];
      raw_load(rf, a.e + rb * a.fe, a.fe, 0, nv);
      frag_to_smem(mine(ns.a[0], TS), TS, rf);
      float d[NT][4];
      zero_acc(d);
      mma_awt(d, rf, enc.layer(0), enc.stride0, 0, (a.fe + 15) / 16);
      fwd_keep(d, enc, ns, venc, ienc);
#pragma unroll
      for (int i = 0; i < FR; ++i) ein[i] = venc[i];
      if (enc.norm) rms_apply(ein, ienc, enc.scale());
    }
  } else {
    frag_load(ein, a.e + rb * H, H, nv);
  }
  uint32_t de[FR];
  if (valid) {
    frag_to_smem(mine(es.a[0], TS), TS, ein);
    float d[NT][4];
    zero_acc(d);
    mma_awt(d, ein, edge.layer(0), edge.stride0, 0);  // e_in @ Ke
    const long long r = Rows::receiver(a, s);
    uint32_t g[FR], v[FR];
    frag_load(g, a.xkr + (r * B + b0) * H, H, nv);
    add_frag(d, g);
    frag_load(g, a.xks + (static_cast<long long>(a.senders[s]) * B + b0) * H, H, nv);
    add_frag(d, g);
    float inv[2];
    fwd_keep(d, edge, es, v, inv);
    frag_load(g, a.gagg + (r * B + b0) * H, H, nv);
    add_tiles(g, g, geo);
    bwd_chain(g, edge, es, v, inv);
    frag_store(a.gh0 + rb * H, H, nv, g);
    zero_acc(d);
    mma_gw(d, g, edge.layer(0), edge.stride0, 0);  // g_h0 · Ke
    round_acc(de, d);
    add_tiles(de, de, geo);
  } else {
    zero_cots(es, edge.norm);
    zero_frag(de);
    if (ranged) frag_store(a.gh0 + rb * H, H, nv, de);
#pragma unroll
    for (int i = 0; i < FR; ++i) de[i] = geo[i];
  }
  if (!FOLD)
    frag_store(a.de + rb * H, H, nv, de);
  else if (enc_live)
    bwd_chain(de, enc, ns, venc, ienc);
  else
    zero_cots(ns, enc.norm);
}

// pass 2: the edge MLP's (and folded encoder's) backward, one warp per
// (row, 16-sample) tile of every row: g_h0, de, the MLPs' gradients (the
// edge MLP's first layer only on its e_in rows Ke: the sender pass adds
// those of Kr and Ks)
template <class Rows, bool FOLD, bool ACTS>
__device__ __forceinline__ void row_pass(const PassArgs& a) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  bf16* at = reinterpret_cast<bf16*>(pass_smem);
  TileMlp edge = stage_tile_mlp(at, a.edge);
  at += tile_mlp_elems(a.edge);
  TileMlp enc{};
  if (FOLD) {
    enc = stage_tile_mlp(at, a.enc);
    at += tile_mlp_elems(a.enc);
  }
  fix_act<ACTS>(edge);
  fix_act<ACTS>(enc);
  bf16* const stage0 = at;
  const Stage es = carve_stage(at, TS);
  Stage ns{};
  if (FOLD) ns = carve_stage(at, TS);
  zero_smem(stage0, at);
  __syncthreads();

  const int warp = threadIdx.x / 32, L = warp / MT, mt = warp % MT;  // as in nodemlp_pass
  const bool sums = L < NL, last = L == NL - 1;
  const bf16 *eG = nullptr, *eA = nullptr, *eP = edge.norm && last ? es.p : nullptr;
  const bf16 *nG = nullptr, *nA = nullptr, *nP = nullptr;
  if (sums) {
    eG = g_of(es, L);
    eA = a_of(es, L);
  }
  if (FOLD && sums) {
    nG = g_of(ns, L);
    nA = a_of(ns, L);
    nP = enc.norm && last ? ns.p : nullptr;
  }
  float dw[NT][4], db[4], ds[4], ew[NT][4], eb[4], eds[4];
  zero_sums<NT>(dw, db, ds);
  zero_sums<NT>(ew, eb, eds);
  const int chunks = (a.batch + 15) / 16;
  const long long pad0 = Rows::ranged_end(a);
  const long long tiles = static_cast<long long>(a.total_rows) * chunks;
  const long long groups = (tiles + PASS_WARPS - 1) / PASS_WARPS;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long t = grp * PASS_WARPS + warp;
    if (t < tiles) {
      row_tile<Rows, FOLD>(a, edge, enc, es, ns, t, chunks, pad0);
    } else {
      zero_cots(es, edge.norm);
      if (FOLD) zero_cots(ns, enc.norm);
    }
    __syncthreads();
    if (sums) {
      wgrad<NT>(dw, db, ds, eG, eA, TS, eP, mt, NT);
      if (FOLD) wgrad<NT>(ew, eb, eds, nG, nA, TS, nP, mt, NT);
    }
    __syncthreads();
  }
  float* buf = reinterpret_cast<float*>(stage0);
  const int n_edge = mlp_floats(a.edge), n_enc = FOLD ? mlp_floats(a.enc) : 0;
  for (int i = threadIdx.x; i < n_edge + n_enc; i += blockDim.x) buf[i] = 0.f;
  __syncthreads();
  if (sums) {
    put_grads<NT>(buf, dw, db, ds, 3 * H, 3, L, mt, edge.norm && last);
    if (FOLD) put_grads<NT>(buf + n_edge, ew, eb, eds, a.fe, 1, L, mt, enc.norm && last);
  }
  __syncthreads();
  store_partial(buf, a.part, n_edge + n_enc);
}

// pass 3: P_r and P_s, dx's receiver and sender parts, dKr and dKs, one
// thread per (node, sample)
template <class Rows>
__device__ __forceinline__ void send_pass(const PassArgs& a) {
  extern __shared__ __align__(16) float smem[];
  float* s_kr = smem;       // Kr as [in][out], bf16 values
  float* s_ks = s_kr + SQ;  // Ks
  float* gw = s_ks + SQ;    // per warp: its dKr, then its dKs, [in][out]
  float* g_kr = gw + (threadIdx.x / 32) * 2 * SQ;
  float* g_ks = g_kr + SQ;
  float* st = gw + SEND_WARPS * 2 * SQ + (threadIdx.x / 32) * STAGE;
  const float* w0 = a.edge.w[0];  // nn.Linear [H, 3H]
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    const int r = i / H, o = i % H;
    s_kr[i] = bf(w0[o * 3 * H + H + r]);
    s_ks[i] = bf(w0[o * 3 * H + 2 * H + r]);
  }
  for (int i = threadIdx.x; i < SEND_WARPS * 2 * SQ; i += blockDim.x) gw[i] = 0.f;
  __syncthreads();

  const int B = a.batch;
  const long long total = static_cast<long long>(a.n_nodes) * B;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
       base < total; base += stride) {
    const long long t0 = base + lane;
    const bool active = t0 < total;
    const long long t = active ? t0 : total - 1;
    const int j = static_cast<int>(t / B);
    const int b = static_cast<int>(t % B);
    float p_r[H], p_s[H], g[H];
    zero(p_r);
    zero(p_s);
    if (active) {
      long long first;
      int count, step;
      Rows::own(a, j, first, count, step);
      for (int c = 0; c < count; ++c) {  // j's own rows
        load_row(g, a.gh0 + ((first + static_cast<long long>(c) * step) * B + b) * H);
#pragma unroll
        for (int o = 0; o < H; ++o) p_r[o] += g[o];
      }
      for (int i = a.offsets[j]; i < a.offsets[j + 1]; ++i) {  // the rows j sends on
        load_row(g, a.gh0 + (static_cast<long long>(a.order[i]) * B + b) * H);
#pragma unroll
        for (int o = 0; o < H; ++o) p_s[o] += g[o];
      }
    }
#pragma unroll
    for (int o = 0; o < H; ++o) {
      p_r[o] = bf(p_r[o]);
      p_s[o] = bf(p_s[o]);
    }
    {
      float gcol[32];
      stage_rows_global(st, a.x + t * H, H);
      stage_cols(st, p_r, gcol);
      outer(st, gcol, H, g_kr);
      stage_cols(st, p_s, gcol);
      outer(st, gcol, H, g_ks);
    }
    if (active) {
      float dx[H];
      load_row(dx, a.dx + t * H);
#pragma unroll
      for (int i = 0; i < H; ++i)
        dx[i] = bf(dx[i] + bf(dot_row(p_r, s_kr + i * H))) + bf(dot_row(p_s, s_ks + i * H));
      store_row(a.dx + t * H, dx);
    }
  }
  __syncthreads();
  float* dst = a.part + static_cast<long long>(blockIdx.x) * 2 * H * H;
  for (int i = threadIdx.x; i < 2 * H * H; i += blockDim.x) {
    const int at = (i / (H * H)) * SQ + i % (H * H);  // dKr, then dKs
    float s = 0.f;
    for (int w = 0; w < SEND_WARPS; ++w) s += gw[w * 2 * SQ + at];
    dst[i] = s;
  }
}

// ---- MLPs of another depth than NL: the deep instances ----
//
// The passes above are built for MLPs of NL Dense layers: their stage and
// each warp's share of the weight gradients are fixed when they compile,
// so those instances keep their registers, and with them their grid and
// the order of their block sums (their bits). An MLP of 1 to MAXL layers
// takes the passes below instead (launch_passes picks them per pass):
//  - blocks of DEEP_WARPS warps, DEEP_ROWS sample rows staged, so that the
//    stages of two MLPs of MAXL layers and their weights fit one block's
//    shared memory (the folded row pass at hidden 32: ~220 KB);
//  - the stage carved at run time by each MLP's depth (A_0, A_1..A_{n-1},
//    G_0..G_{n-1}, P);
//  - after each group of tiles, warp w forms the sums of (layer, m-tile)
//    pairs w, w + DEEP_WARPS, ... one at a time in registers and adds each
//    into its block's slot of the partials in device memory, in
//    grad_slot's layout (zeroed at the start). Each element has one owner
//    lane, so there are no atomics and the order is fixed;
//  - the activation read at run time (relu included).
constexpr int DEEP_WARPS = 4;
constexpr int DEEP_THREADS = 32 * DEEP_WARPS;
constexpr int DEEP_ROWS = 16 * DEEP_WARPS;

// A deep block's staging of one MLP's backward: A_0 [DEEP_ROWS][a0_stride],
// then A_1.., G_0.. and P, [DEEP_ROWS][TS] each
struct DeepStage {
  bf16* a0;
  bf16* a1;
  bf16* g0;
  bf16* p;
  int a0_stride;
  __device__ bf16* a(int l) const { return l == 0 ? a0 : a1 + (l - 1) * DEEP_ROWS * TS; }
  __device__ bf16* g(int l) const { return g0 + l * DEEP_ROWS * TS; }
};

// bytes of one DeepStage of an MLP of n_layers
__host__ __device__ inline size_t deep_stage_bytes(int a0_stride, int n_layers) {
  return sizeof(bf16) * DEEP_ROWS * (a0_stride + 2 * n_layers * TS);
}

__device__ inline DeepStage carve_deep(bf16*& at, int a0_stride, int n_layers) {
  DeepStage st;
  st.a0_stride = a0_stride;
  st.a0 = at;
  at += DEEP_ROWS * a0_stride;
  st.a1 = at;
  at += (n_layers - 1) * DEEP_ROWS * TS;
  st.g0 = at;
  at += n_layers * DEEP_ROWS * TS;
  st.p = at;
  at += DEEP_ROWS * TS;
  return st;
}

__device__ __forceinline__ void deep_zero_cots(const DeepStage& st, const TileMlp& m) {
  uint32_t z[FR];
  zero_frag(z);
  for (int l = 0; l < m.n_layers; ++l) frag_to_smem(mine(st.g(l), TS), TS, z);
  if (m.norm) frag_to_smem(mine(st.p, TS), TS, z);
}

// fwd_keep for an MLP of m.n_layers layers
__device__ __forceinline__ void deep_fwd_keep(const float (&d0)[NT][4], const TileMlp& m,
                                              const DeepStage& st, uint32_t (&v)[FR],
                                              float (&inv)[2]) {
  finish(v, d0, m.bias(0));
#pragma unroll 1
  for (int l = 1; l < m.n_layers; ++l) {
    uint32_t act[FR];
    activate(act, v, m.act);
    if (m.act == mlp_act::RELU)
      frag_to_smem(mine(st.a(l), TS), TS, act);
    else
      frag_to_smem(mine(st.a(l), TS), TS, v);
    float d[NT][4];
    zero_acc(d);
    mma_awt(d, act, m.layer(l), TS, 0);
    finish(v, d, m.bias(l));
  }
  inv[0] = inv[1] = 1.f;
  if (m.norm) rms_inv(inv, v);
}

// bwd_chain for an MLP of m.n_layers layers
__device__ __forceinline__ void deep_bwd_chain(uint32_t (&g)[FR], const TileMlp& m,
                                               const DeepStage& st, const uint32_t (&v)[FR],
                                               const float (&inv)[2]) {
  if (m.norm) {
    uint32_t p[FR];
    rms_bwd(g, p, v, inv, m.scale());
    frag_to_smem(mine(st.p, TS), TS, p);
  }
#pragma unroll 1
  for (int l = m.n_layers - 1; l >= 1; --l) {
    frag_to_smem(mine(st.g(l), TS), TS, g);
    float d[NT][4];
    zero_acc(d);
    mma_gw(d, g, m.layer(l), TS, 0);
    uint32_t act[FR];
    frag_from_smem(act, mine(st.a(l), TS), TS);
    round_acc(g, d);
    if (m.act == mlp_act::RELU) {
#pragma unroll
      for (int i = 0; i < FR; ++i) g[i] &= pos_mask(act[i]);
    } else {
#pragma unroll
      for (int i = 0; i < FR; ++i) {
        g[i] = mlp_act::grad_pair(g[i], act[i], m.act);
        act[i] = mlp_act::act_pair(act[i], m.act);
      }
      frag_to_smem(mine(st.a(l), TS), TS, act);
    }
  }
  frag_to_smem(mine(st.g(0), TS), TS, g);
}

// put_grads's layout, added (+=) into a block's slot in device memory, for
// an MLP of n_layers layers
template <int N>
__device__ __forceinline__ void add_grads(float* slot, const float (&dw)[N][4],
                                          const float (&db)[4], const float (&ds)[4],
                                          int in_dim, int parts, int L, int mt, bool scale,
                                          int n_layers) {
  const int lane = lane_id(), g = lane >> 2, q = lane & 3;
  const int rows = L == 0 ? in_dim : H;
  const int pw = L == 0 ? in_dim / parts : H;
  const int pp = L == 0 && parts == 1 ? in_dim : HP;
  float* w = slot + (L == 0 ? 0 : in_dim * H + H + (L - 1) * (H * H + H));
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = 16 * mt + g + 8 * (e >> 1), i = 8 * n + 2 * q + (e & 1);
      const int blk = i / pp, k = i % pp, row = blk * pw + k;
      if (o < H && k < pw && row < rows) w[row * H + o] += dw[n][e];
    }
  if (q == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int o = 16 * mt + g + 8 * r;
      if (o >= H) continue;
      w[rows * H + o] += db[2 * r];
      if (scale) slot[in_dim * H + H + (n_layers - 1) * (H * H + H) + o] += ds[2 * r];
    }
  }
}

// zero a block's slot of the partials (n floats); the block syncs after
__device__ inline float* zero_slot(float* part, int n) {
  float* slot = part + static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) slot[i] = 0.f;
  return slot;
}

// pass 1 on tile t, deep: node_tile on a DeepStage
__device__ __forceinline__ void deep_node_tile(const PassArgs& a, const TileMlp& node,
                                               const DeepStage& st, long long t, int chunks) {
  const int B = a.batch;
  const int b0 = 16 * static_cast<int>(t % chunks), nv = min(16, B - b0);
  const long long xb = ((t / chunks) * B + b0) * H;
  uint32_t xf[FR], ag[FR];
  frag_load(xf, a.x + xb, H, nv);
  frag_load(ag, a.agg + xb, H, nv);
  bf16* a0 = mine(st.a0, st.a0_stride);
  frag_to_smem(a0, st.a0_stride, xf);
  frag_to_smem(a0 + HP, st.a0_stride, ag);
  float d[NT][4];
  zero_acc(d);
  mma_awt(d, xf, node.layer(0), node.stride0, 0);
  mma_awt(d, ag, node.layer(0), node.stride0, HP);
  uint32_t v[FR], g[FR];
  float inv[2];
  deep_fwd_keep(d, node, st, v, inv);
  frag_load(xf, a.g_xout + xb, H, nv);
#pragma unroll
  for (int i = 0; i < FR; ++i) g[i] = xf[i];
  deep_bwd_chain(g, node, st, v, inv);
  zero_acc(d);
  mma_gw(d, g, node.layer(0), node.stride0, 0);
  round_acc(v, d);
  add_tiles(xf, xf, v);
  frag_store(a.dx + xb, H, nv, xf);
  zero_acc(d);
  mma_gw(d, g, node.layer(0), node.stride0, HP);
  round_acc(v, d);
  frag_store(a.gagg + xb, H, nv, v);
}

// pass 1, deep: nodemlp_pass for a node MLP of any depth
__device__ __forceinline__ void deep_nodemlp_pass(const PassArgs& a) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  constexpr int A0S = 2 * HP + 8;
  bf16* at = reinterpret_cast<bf16*>(pass_smem);
  const TileMlp node = stage_tile_mlp(at, a.node);
  at += tile_mlp_elems(a.node);
  bf16* const stage0 = at;
  const DeepStage st = carve_deep(at, A0S, node.n_layers);
  zero_smem(stage0, at);
  float* slot = zero_slot(a.part, mlp_floats(a.node));
  __syncthreads();
  const int warp = threadIdx.x / 32, pairs = node.n_layers * MT;
  const int chunks = (a.batch + 15) / 16;
  const long long tiles = static_cast<long long>(a.n_nodes) * chunks;
  const long long groups = (tiles + DEEP_WARPS - 1) / DEEP_WARPS;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long t = grp * DEEP_WARPS + warp;
    if (t < tiles)
      deep_node_tile(a, node, st, t, chunks);
    else
      deep_zero_cots(st, node);
    __syncthreads();
#pragma unroll 1
    for (int pi = warp; pi < pairs; pi += DEEP_WARPS) {
      const int L = pi / MT, mt = pi % MT;
      const bool scale = node.norm && L == node.n_layers - 1;
      float dw[2 * NT][4], db[4], ds[4];
      zero_sums<2 * NT>(dw, db, ds);
      wgrad<2 * NT, DEEP_WARPS>(dw, db, ds, st.g(L), st.a(L), L == 0 ? A0S : TS,
                                scale ? st.p : nullptr, mt, L == 0 ? 2 * NT : NT);
      add_grads<2 * NT>(slot, dw, db, ds, 2 * H, 2, L, mt, scale, node.n_layers);
    }
    __syncthreads();
  }
}

// pass 2 on tile t, deep: row_tile on DeepStages
template <class Rows, bool FOLD>
__device__ __forceinline__ void deep_row_tile(const PassArgs& a, const TileMlp& edge,
                                              const TileMlp& enc, const DeepStage& es,
                                              const DeepStage& ns, long long t, int chunks,
                                              long long pad0) {
  const int B = a.batch;
  const long long s = t / chunks;
  const int b0 = 16 * static_cast<int>(t % chunks), nv = min(16, B - b0);
  const long long rb = s * B + b0;
  const bool ranged = s < pad0;
  const bool valid = ranged && a.mask[s];
  uint32_t geo[FR];
  if (a.g_eout)
    frag_load(geo, a.g_eout + rb * H, H, nv);
  else
    zero_frag(geo);
  const bool enc_live = FOLD && (valid || a.g_eout != nullptr);
  uint32_t ein[FR], venc[FR];
  float ienc[2];
  if (FOLD) {
    if (enc_live) {
      uint32_t rf[FR];
      raw_load(rf, a.e + rb * a.fe, a.fe, 0, nv);
      frag_to_smem(mine(ns.a0, TS), TS, rf);
      float d[NT][4];
      zero_acc(d);
      mma_awt(d, rf, enc.layer(0), enc.stride0, 0, (a.fe + 15) / 16);
      deep_fwd_keep(d, enc, ns, venc, ienc);
#pragma unroll
      for (int i = 0; i < FR; ++i) ein[i] = venc[i];
      if (enc.norm) rms_apply(ein, ienc, enc.scale());
    }
  } else {
    frag_load(ein, a.e + rb * H, H, nv);
  }
  uint32_t de[FR];
  if (valid) {
    frag_to_smem(mine(es.a0, TS), TS, ein);
    float d[NT][4];
    zero_acc(d);
    mma_awt(d, ein, edge.layer(0), edge.stride0, 0);
    const long long r = Rows::receiver(a, s);
    uint32_t g[FR], v[FR];
    frag_load(g, a.xkr + (r * B + b0) * H, H, nv);
    add_frag(d, g);
    frag_load(g, a.xks + (static_cast<long long>(a.senders[s]) * B + b0) * H, H, nv);
    add_frag(d, g);
    float inv[2];
    deep_fwd_keep(d, edge, es, v, inv);
    frag_load(g, a.gagg + (r * B + b0) * H, H, nv);
    add_tiles(g, g, geo);
    deep_bwd_chain(g, edge, es, v, inv);
    frag_store(a.gh0 + rb * H, H, nv, g);
    zero_acc(d);
    mma_gw(d, g, edge.layer(0), edge.stride0, 0);
    round_acc(de, d);
    add_tiles(de, de, geo);
  } else {
    deep_zero_cots(es, edge);
    zero_frag(de);
    if (ranged) frag_store(a.gh0 + rb * H, H, nv, de);
#pragma unroll
    for (int i = 0; i < FR; ++i) de[i] = geo[i];
  }
  if (!FOLD)
    frag_store(a.de + rb * H, H, nv, de);
  else if (enc_live)
    deep_bwd_chain(de, enc, ns, venc, ienc);
  else
    deep_zero_cots(ns, enc);
}

// pass 2, deep: row_pass for edge (and encoder) MLPs of any depth
template <class Rows, bool FOLD>
__device__ __forceinline__ void deep_row_pass(const PassArgs& a) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  bf16* at = reinterpret_cast<bf16*>(pass_smem);
  const TileMlp edge = stage_tile_mlp(at, a.edge);
  at += tile_mlp_elems(a.edge);
  TileMlp enc{};
  if (FOLD) {
    enc = stage_tile_mlp(at, a.enc);
    at += tile_mlp_elems(a.enc);
  }
  bf16* const stage0 = at;
  const DeepStage es = carve_deep(at, TS, edge.n_layers);
  DeepStage ns{};
  if (FOLD) ns = carve_deep(at, TS, enc.n_layers);
  zero_smem(stage0, at);
  const int n_edge = mlp_floats(a.edge), n_enc = FOLD ? mlp_floats(a.enc) : 0;
  float* slot = zero_slot(a.part, n_edge + n_enc);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int edge_pairs = edge.n_layers * MT, pairs = edge_pairs + (FOLD ? enc.n_layers * MT : 0);
  const int chunks = (a.batch + 15) / 16;
  const long long pad0 = Rows::ranged_end(a);
  const long long tiles = static_cast<long long>(a.total_rows) * chunks;
  const long long groups = (tiles + DEEP_WARPS - 1) / DEEP_WARPS;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long t = grp * DEEP_WARPS + warp;
    if (t < tiles) {
      deep_row_tile<Rows, FOLD>(a, edge, enc, es, ns, t, chunks, pad0);
    } else {
      deep_zero_cots(es, edge);
      if (FOLD) deep_zero_cots(ns, enc);
    }
    __syncthreads();
#pragma unroll 1
    for (int pi = warp; pi < pairs; pi += DEEP_WARPS) {
      const bool is_enc = pi >= edge_pairs;
      const int q = is_enc ? pi - edge_pairs : pi;
      const int L = q / MT, mt = q % MT;
      const int n = is_enc ? enc.n_layers : edge.n_layers;
      const bool scale = (is_enc ? enc.norm : edge.norm) && L == n - 1;
      const DeepStage& st = is_enc ? ns : es;
      float dw[NT][4], db[4], ds[4];
      zero_sums<NT>(dw, db, ds);
      wgrad<NT, DEEP_WARPS>(dw, db, ds, st.g(L), st.a(L), TS, scale ? st.p : nullptr, mt, NT);
      if (is_enc)
        add_grads<NT>(slot + n_edge, dw, db, ds, a.fe, 1, L, mt, scale, n);
      else
        add_grads<NT>(slot, dw, db, ds, 3 * H, 3, L, mt, scale, n);
    }
    __syncthreads();
  }
}

using PassKernel = void (*)(const PassArgs);

// the calling source's wrappers of deep_nodemlp_pass and deep_row_pass
// (without and with the folded encoder)
struct DeepKernels {
  PassKernel nodemlp, rows, rows_fold;
};

// whether an MLP of the backward takes another activation than relu (the
// ACTS instances of the node-MLP and row passes, gn_tile.cuh:fix_act)
inline bool any_act(const PassArgs& a) {
  return (a.fe > 0 && a.enc.act != mlp_act::RELU) || a.edge.act != mlp_act::RELU ||
         a.node.act != mlp_act::RELU;
}

// this library's memory pool on the current device, for the partials: it
// keeps what is freed into it, so a stream-ordered allocation of the same
// size again maps no memory
inline cudaError_t partial_pool(cudaMemPool_t* pool) {
  constexpr int MAX_DEVICES = 64;
  static cudaMemPool_t pools[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidValue;
  if (pools[dev] == nullptr) {
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = dev;
    cudaMemPool_t made;
    if ((err = cudaMemPoolCreate(&made, &props)) != cudaSuccess) return err;
    unsigned long long keep = ~0ULL;
    err = cudaMemPoolSetAttribute(made, cudaMemPoolAttrReleaseThreshold, &keep);
    if (err != cudaSuccess) return err;
    pools[dev] = made;
  }
  *pool = pools[dev];
  return cudaSuccess;
}

// the pre-pass (gn_partial_tc_kernel) and passes 1-3 on ``stream``, each
// pass kernel one of the calling source's wrappers of the bodies above
// (those of the ACTS instance any_act chose, or the deep instance of a pass
// whose MLPs have another depth than NL; the row pass in two instances:
// without and with the folded encoder),
// each pass followed by the block-ordered sum of its blocks' gradient
// partials (gn_bwd_common.cuh) from one stream-ordered fp32 buffer of
// partial_pool
inline cudaError_t launch_passes(const PassArgs& args, cudaStream_t stream, PassKernel nodemlp,
                                 PassKernel rows, PassKernel rows_fold, PassKernel send,
                                 const DeepKernels& deep) {
  PassArgs a = args;
  const int chunks = (a.batch + 15) / 16;
  const bool fold = a.fe > 0;
  // an MLP of another depth than NL takes the deep instance of its pass
  const bool deep_node = a.node.n_layers != NL;
  const bool deep_rows = a.edge.n_layers != NL || (fold && a.enc.n_layers != NL);
  // each block of an NL instance stages its gradients in its staging area
  // at its end: the staging (>= 92 KB) outsizes the MLPs' fp32 gradients
  // (<= 42 KB)
  const PassKernel kernels[3] = {
      deep_node ? deep.nodemlp : nodemlp,
      deep_rows ? (fold ? deep.rows_fold : deep.rows) : (fold ? rows_fold : rows), send};
  const size_t mlps_bytes = sizeof(bf16) * (tile_mlp_elems(a.edge) +
                                            (fold ? tile_mlp_elems(a.enc) : 0));
  const size_t smem[3] = {
      sizeof(bf16) * tile_mlp_elems(a.node) +
          (deep_node ? deep_stage_bytes(2 * HP + 8, a.node.n_layers) : stage_bytes(2 * HP + 8)),
      mlps_bytes + (deep_rows ? deep_stage_bytes(TS, a.edge.n_layers) +
                                    (fold ? deep_stage_bytes(TS, a.enc.n_layers) : 0)
                              : stage_bytes(TS) * (fold ? 2 : 1)),
      sizeof(float) * (2 * SQ + SEND_WARPS * (2 * SQ + STAGE))};
  const int threads[3] = {deep_node ? DEEP_THREADS : PASS_THREADS,
                          deep_rows ? DEEP_THREADS : PASS_THREADS, SEND_THREADS};
  // a warp a 16-sample tile in passes 1 and 2, a thread a (node, sample) in 3
  const long long work[3] = {32LL * a.n_nodes * chunks, 32LL * a.total_rows * chunks,
                             static_cast<long long>(a.n_nodes) * a.batch};
  const int n_edge = mlp_floats(a.edge), n_enc = fold ? mlp_floats(a.enc) : 0;
  const int floats[3] = {mlp_floats(a.node), n_edge + n_enc, 2 * H * H};
  int grid[3];
  long long part_floats = 0;
  cudaError_t err;
  for (int k = 0; k < 3; ++k) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernels[k]),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem[k]));
    if (err != cudaSuccess) return err;
    err = gn_nk::grid_for(reinterpret_cast<const void*>(kernels[k]), threads[k], smem[k],
                          work[k], &grid[k]);
    if (err != cudaSuccess) return err;
    const long long need = static_cast<long long>(grid[k]) * floats[k];
    part_floats = need > part_floats ? need : part_floats;
  }
  err = launch_partial(a.x, const_cast<bf16*>(a.xkr), const_cast<bf16*>(a.xks), a.edge.w[0],
                       a.n_nodes, a.batch, stream);
  if (err != cudaSuccess) return err;
  cudaMemPool_t pool;
  if ((err = partial_pool(&pool)) != cudaSuccess) return err;
  err = cudaMallocFromPoolAsync(reinterpret_cast<void**>(&a.part), sizeof(float) * part_floats,
                                pool, stream);
  if (err != cudaSuccess) return err;

  constexpr int RT = 256;  // threads of a reduce kernel, one a gradient float
  kernels[0]<<<grid[0], threads[0], smem[0], stream>>>(a);
  reduce_mlp_kernel<H><<<(floats[0] + RT - 1) / RT, RT, 0, stream>>>(a.part, grid[0],
                                                                      floats[0], a.gnode);
  kernels[1]<<<grid[1], threads[1], smem[1], stream>>>(a);
  reduce_mlp_kernel<H><<<(n_edge + RT - 1) / RT, RT, 0, stream>>>(a.part, grid[1], floats[1],
                                                                  a.gedge);
  if (fold)
    reduce_mlp_kernel<H><<<(n_enc + RT - 1) / RT, RT, 0, stream>>>(a.part + n_edge, grid[1],
                                                                   floats[1], a.genc);
  kernels[2]<<<grid[2], threads[2], smem[2], stream>>>(a);
  reduce_send_kernel<H><<<(floats[2] + RT - 1) / RT, RT, 0, stream>>>(
      a.part, grid[2], const_cast<float*>(a.gedge.w[0]));
  err = cudaGetLastError();
  const cudaError_t freed = cudaFreeAsync(a.part, stream);
  return err != cudaSuccess ? err : freed;
}

// Fills the weight and gradient MLPs of ``a`` from the pointer lists (2 *
// n_layers + 1 pointers each: w0, b0, w1, b1, ..., the RMSNorm scale or
// null) and their activations' codes (mlp_act::Kind), checking that they
// fit the passes: fe > 0 folds the encoder in (then de is null).
inline bool make_pass_mlps(PassArgs* a, const void* const* enc_w, const void* const* enc_g,
                           int n_enc_layers, int enc_act, const void* const* edge_w,
                           const void* const* edge_g, int n_edge_layers, int edge_act,
                           const void* const* node_w, const void* const* node_g,
                           int n_node_layers, int node_act) {
  const bool fold = a->fe > 0;
  return (!fold || (a->fe <= H && make_mlp_pair(&a->enc, &a->genc, enc_w, enc_g, n_enc_layers,
                                                a->fe, 1, enc_act))) &&
         make_mlp_pair(&a->edge, &a->gedge, edge_w, edge_g, n_edge_layers, 3 * H, 3, edge_act) &&
         make_mlp_pair(&a->node, &a->gnode, node_w, node_g, n_node_layers, 2 * H, 2, node_act) &&
         (a->de == nullptr) == fold && a->n_nodes >= 1 && a->batch >= 1 && a->total_rows >= 1;
}

}  // namespace gn_bwd
