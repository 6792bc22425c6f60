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
// Why the hidden-32 design does not carry over: there a block's warps
// share each MLP's weight gradients in registers across all its tiles
// (24-40 a lane); at H = 128 the edge MLP's alone are 64k fp32, 256 KB a
// block. So the passes write what the weight gradients contract over to a
// bf16 scratch, and the gradients are products over the rows afterwards:
//  0. the pre-pass (gn_wide.cuh): xkr, xks; (folded) the encoder pass
//     writes e_in to a scratch;
//  1. node pass, a warp per (node, 16 samples), the node MLP resident: its
//     forward from [x | agg] and backward from g_xout, storing each
//     later layer's relu'd input A_1.., the cotangents G_0.. at the
//     layers' outputs and the RMSNorm scale's terms P; dx's node part and
//     g_agg;
//  2. row pass, a warp per (row, 16 samples) of every row, the edge MLP
//     (Ke, its later layers) resident: the edge MLP's forward, its
//     backward from g_agg[r] + g_eout, its A_1.., G_0.. (G_0 is g_h0) and
//     P, de; rows outside every receiver's range and masked rows store
//     zeros;
//  3. sender pass, a warp per (node, 16 samples): P_r over the node's own
//     rows and P_s over the sender-sorted row list (fp32 sums in row
//     order, ops/tiling.cached_sender_slots), both stored; dx finished
//     with the two products on tiles;
//  4. weight-gradient pass: for each (product, row split) one block forms
//     Gᵀ·A over its rows as mma.sync products (64-row tiles of both
//     operands by cp.async, two stages) and G's column sums (a bias, or
//     P's: the scale), into a partial; Kr's and Ks's gradients are the
//     products P_rᵀ·x and P_sᵀ·x;
//  5. a last kernel adds the partials in split order into the gradients;
//  6. (folded) the encoder's pass, a warp per (row, 16 samples): its
//     forward from the raw features and its backward from de, into the
//     scratch of pass 2 (read by then), then passes 4-5 on its products.
// No atomics anywhere: two calls give the same bits.
//
// What bounds it on this card: per valid row the backward does ~3x the
// forward's multiply-adds (the edge MLP forward again, the cotangent
// through 4 layers, the weight gradients); at hidden 128 on the cylinder
// batch (B = 128) a middle block is ~0.73 TFLOP against ~1.9 GB of the
// function's traffic (x, e, agg, both cotangents read; dx, de written):
// 0.74 ms on the tensor cores, 0.57 ms at 3.35 TB/s. The scratch adds
// 8 x [S, B, H] bf16 (3.0 GB at that shape) written and read back.
#pragma once

#include "gn_wide.cuh"

namespace gnw {

using namespace gn_rows;

// an MLP's scratch slots: A_1..A_{MAXL-1}, G_0..G_{MAXL-1}, P (an MLP of n
// layers uses A_1..A_{n-1}, G_0..G_{n-1} and P: 2n slots; launch_bwd gives
// only those memory)
enum { A1 = 0, G0 = MAXL - 1, P_SLOT = 2 * MAXL - 1, SLOTS = 2 * MAXL, PR = SLOTS,
       PS = SLOTS + 1 };

// whether an MLP of n layers uses slot i
__host__ __device__ inline bool slot_used(int i, int n) {
  return (i >= A1 && i < A1 + n - 1) || (i >= G0 && i < G0 + n) || i == P_SLOT;
}

struct BwdArgs : RowMap {
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
  const int32_t* senders;  // [S] sender per row (0 on padding)
  const uint8_t* mask;     // [S] 1 on valid rows
  const int32_t* order;    // the valid rows sorted by sender
  const int32_t* offsets;  // [N + 1] node j sends on order[offsets[j]:offsets[j+1]]
  int batch, fe;
  Mlp enc, edge, node;     // weights
  Mlp genc, gedge, gnode;  // their gradients: same shapes, fp32, zeroed
};

// stores of an MLP's A_l (l >= 1), G_l and P at element offset ``off``
struct Slots {
  bf16* const* s;
  __device__ bf16* a(int l) const { return s[A1 + l - 1]; }
  __device__ bf16* g(int l) const { return s[G0 + l]; }
  __device__ bf16* p() const { return s[P_SLOT]; }
};

// An MLP's forward on the warp's tile from its first layer's fp32 product
// d0 (bias not yet added), storing each later layer's input to its slot:
// with relu its relu'd input A_l (its pass mask too), with SiLU or GELU
// the pre-activation, which bwd_chain needs for the derivative and then
// overwrites with A_l = act(pre), so the slot's bytes are relu's; v gets
// the last layer's output (the RMSNorm's input) and inv its statistic
template <bool STREAM>
__device__ __forceinline__ void fwd_keep(const float (&d0)[NT][4], const WMlp& m, const Slots& sl,
                                         long long off, int nv, uint32_t (&v)[NF],
                                         float (&inv)[2]) {
  finish(v, d0, m.bias(0));
#pragma unroll 1
  for (int l = 1; l < m.n_layers; ++l) {
    uint32_t act[NF];
    activate(act, v, m.act);
    if (m.act == mlp_act::RELU)  // two calls: a selected array would go to local memory
      frag_store(sl.a(l) + off, nv, act);
    else
      frag_store(sl.a(l) + off, nv, v);
    float d[NT][4];
    zero_acc(d);
    layer_awt<STREAM>(d, act, m, l);
    finish(v, d, m.bias(l));
  }
  inv[0] = inv[1] = 1.f;
  if (m.norm) rms_inv(inv, v);
}

// The backward through the RMSNorm and layers n-1..1 (JAX _mlp_bwd): g in,
// the cotangent at the MLP's output; out, the cotangent at layer 0's
// output. Stores P and every G_l; reads back the lane's own A_l stores.
template <bool STREAM>
__device__ __forceinline__ void bwd_chain(uint32_t (&g)[NF], const WMlp& m, const Slots& sl,
                                          long long off, int nv, const uint32_t (&v)[NF],
                                          const float (&inv)[2]) {
  if (m.norm) {
    uint32_t p[NF];
    rms_bwd(g, p, v, inv, m.scale());
    frag_store(sl.p() + off, nv, p);
  }
#pragma unroll 1
  for (int l = m.n_layers - 1; l >= 1; --l) {
    frag_store(sl.g(l) + off, nv, g);
    float d[NT][4];
    zero_acc(d);
    layer_gw<STREAM>(d, g, m, l);
    uint32_t act[NF];
    frag_load(act, sl.a(l) + off, nv);
    round_acc(g, d);
    if (m.act == mlp_act::RELU) {
#pragma unroll
      for (int i = 0; i < NF; ++i) g[i] &= pos_mask(act[i]);
    } else {  // act holds the pre-activation: g · act'(pre), then A_l = act(pre)
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        g[i] = mlp_act::grad_pair(g[i], act[i], m.act);
        act[i] = mlp_act::act_pair(act[i], m.act);
      }
      frag_store(sl.a(l) + off, nv, act);
    }
  }
  frag_store(sl.g(0) + off, nv, g);
}

// a tile that adds nothing to the weight gradients: zero slots
__device__ __forceinline__ void zero_slots(const Slots& sl, long long off, int nv,
                                           const WMlp& m) {
  uint32_t z[NF];
  zero_frag(z);
  for (int l = 1; l < m.n_layers; ++l) frag_store(sl.a(l) + off, nv, z);
  for (int l = 0; l < m.n_layers; ++l) frag_store(sl.g(l) + off, nv, z);
  if (m.norm) frag_store(sl.p() + off, nv, z);
}

// g_eout's tile, or zeros on the last block
__device__ __forceinline__ void eout_cot(uint32_t (&f)[NF], const BwdArgs& a, long long off,
                                         int nv) {
  if (a.g_eout)
    frag_load(f, a.g_eout + off, nv);
  else
    zero_frag(f);
}

// pass 1: the node MLP's backward
template <bool ACTS>
__global__ void __launch_bounds__(THREADS, 1) GNW(node_bwd)(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char node_smem[];
  WMlp node = stage_mlp(reinterpret_cast<bf16*>(node_smem), a.node, 2 * H);
  fix_act<ACTS>(node);
  __syncthreads();
  const Slots sl{a.ns};
  const int B = a.batch;
  const int chunks = (B + 15) / 16;
  const long long tiles = static_cast<long long>(a.n_nodes) * chunks;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32; t < tiles;
       t += step) {
    const int b0 = 16 * static_cast<int>(t % chunks);
    const int nv = min(16, B - b0);
    const long long xb = ((t / chunks) * B + b0) * H;
    uint32_t v[NF], g[NF];
    float inv[2];
    {
      float d[NT][4];
      uint32_t f[NF];
      zero_acc(d);
      frag_load(f, a.x + xb, nv);
      mma_awt(d, f, node.layer(0), node.stride0, 0);
      frag_load(f, a.agg + xb, nv);
      mma_awt(d, f, node.layer(0), node.stride0, H);
      fwd_keep<ACTS>(d, node, sl, xb, nv, v, inv);
    }
    frag_load(g, a.g_xout + xb, nv);
    bwd_chain<ACTS>(g, node, sl, xb, nv, v, inv);
    float d[NT][4];
    uint32_t f[NF];
    zero_acc(d);
    mma_gw(d, g, node.layer(0), node.stride0, 0);  // the x part
    round_acc(v, d);
    frag_load(f, a.g_xout + xb, nv);
    add_tiles(f, f, v);
    frag_store(a.dx + xb, nv, f);  // finished by the sender pass
    zero_acc(d);
    mma_gw(d, g, node.layer(0), node.stride0, H);  // the aggregate's part
    round_acc(v, d);
    frag_store(a.gagg + xb, nv, v);
  }
}

// pass 2: the edge MLP's backward on every row
template <class Rows, bool ACTS>
__device__ __forceinline__ void row_bwd_body(const BwdArgs& a) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  WMlp edge = stage_mlp(reinterpret_cast<bf16*>(row_smem), a.edge, H);  // Ke, W1..
  fix_act<ACTS>(edge);
  __syncthreads();
  const Slots sl{a.es};
  const int B = a.batch;
  const int chunks = (B + 15) / 16;
  const long long pad0 = Rows::ranged_end(a);
  const long long tiles = static_cast<long long>(a.total_rows) * chunks;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32; t < tiles;
       t += step) {
    const long long s = t / chunks;
    const int b0 = 16 * static_cast<int>(t % chunks);
    const int nv = min(16, B - b0);
    const long long off = (s * B + b0) * H;
    if (!(s < pad0 && a.mask[s])) {  // padding or masked: g_h0 = 0, de = g_eout
      zero_slots(sl, off, nv, edge);
      uint32_t f[NF];
      eout_cot(f, a, off, nv);
      frag_store(a.de + off, nv, f);
      continue;
    }
    const long long rt = (Rows::receiver(a, s) * B + b0) * H;
    uint32_t v[NF], g[NF];
    float inv[2];
    {
      float d[NT][4];
      uint32_t f[NF];
      frag_load(f, a.e + off, nv);
      zero_acc(d);
      mma_awt(d, f, edge.layer(0), edge.stride0, 0);  // e_in @ Ke
      frag_load(f, a.xkr + rt, nv);
      add_frag(d, f);
      frag_load(f, a.xks + (static_cast<long long>(a.senders[s]) * B + b0) * H, nv);
      add_frag(d, f);
      fwd_keep<ACTS>(d, edge, sl, off, nv, v, inv);
    }
    {
      uint32_t f[NF];
      frag_load(g, a.gagg + rt, nv);
      eout_cot(f, a, off, nv);
      add_tiles(g, g, f);
    }
    bwd_chain<ACTS>(g, edge, sl, off, nv, v, inv);
    float d[NT][4];
    uint32_t f[NF];
    zero_acc(d);
    mma_gw(d, g, edge.layer(0), edge.stride0, 0);  // g_h0 · Ke
    round_acc(v, d);
    eout_cot(f, a, off, nv);
    add_tiles(v, v, f);
    frag_store(a.de + off, nv, v);
  }
}

// pass 3: P_r, P_s and dx's receiver and sender parts
template <class Rows>
__device__ __forceinline__ void send_body(const BwdArgs& a) {
  extern __shared__ __align__(16) unsigned char send_smem[];
  constexpr int KS2 = 2 * H + 8;
  bf16* s_k = reinterpret_cast<bf16*>(send_smem);  // [H out][Kr | Ks]
  stage_w(s_k, a.edge.w[0], 3 * H, H, 2 * H, KS2);
  __syncthreads();
  const bf16* gh0 = a.es[G0];
  const int B = a.batch;
  const int chunks = (B + 15) / 16;
  const long long tiles = static_cast<long long>(a.n_nodes) * chunks;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32; t < tiles;
       t += step) {
    const int j = static_cast<int>(t / chunks);
    const int b0 = 16 * static_cast<int>(t % chunks);
    const int nv = min(16, B - b0);
    const long long xb = (static_cast<long long>(j) * B + b0) * H;
    uint32_t pr[NF], ps[NF];
    {
      float d[NT][4];
      uint32_t f[NF];
      long long first;
      int count, row_step;
      Rows::own(a, j, first, count, row_step);
      zero_acc(d);
#pragma unroll 1
      for (int c = 0; c < count; ++c) {  // j's own rows
        frag_load(f, gh0 + ((first + static_cast<long long>(c) * row_step) * B + b0) * H, nv);
        add_frag(d, f);
      }
      round_acc(pr, d);
      zero_acc(d);
#pragma unroll 1
      for (int i = a.offsets[j]; i < a.offsets[j + 1]; ++i) {  // the rows j sends on
        frag_load(f, gh0 + (static_cast<long long>(a.order[i]) * B + b0) * H, nv);
        add_frag(d, f);
      }
      round_acc(ps, d);
    }
    frag_store(a.ns[PR] + xb, nv, pr);
    frag_store(a.ns[PS] + xb, nv, ps);
    float d[NT][4];
    uint32_t f[NF], u[NF];
    frag_load(f, a.dx + xb, nv);
    zero_acc(d);
    mma_gw(d, pr, s_k, KS2, 0);  // P_r · Krᵀ
    round_acc(u, d);
    add_tiles(f, f, u);
    zero_acc(d);
    mma_gw(d, ps, s_k, KS2, H);  // P_s · Ksᵀ
    round_acc(u, d);
    add_tiles(f, f, u);
    frag_store(a.dx + xb, nv, f);
  }
}

// pass 6 (folded): the encoder's forward and backward on every row, its
// cotangent de from the row pass
template <bool ACTS>
__global__ void __launch_bounds__(THREADS, 1) GNW(enc_bwd)(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char enc_smem[];
  const int fe = a.fe;
  WMlp enc = stage_mlp(reinterpret_cast<bf16*>(enc_smem), a.enc, fe);
  fix_act<ACTS>(enc);
  __syncthreads();
  const Slots sl{a.cs + 1};
  const int B = a.batch;
  const int chunks = (B + 15) / 16;
  const long long tiles = static_cast<long long>(a.total_rows) * chunks;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32; t < tiles;
       t += step) {
    const int b0 = 16 * static_cast<int>(t % chunks);
    const int nv = min(16, B - b0);
    const long long rb = (t / chunks) * B + b0;
    const long long off = rb * H;
    uint32_t v[NF], g[NF];
    float inv[2];
    {
      float d[NT][4];
      uint32_t rf[NF];
      enc_first(d, rf, a.raw + rb * fe, fe, enc, nv);
      frag_store(a.cs[0] + off, nv, rf);  // A_0: the raw rows, zero past fe
      fwd_keep<ACTS>(d, enc, sl, off, nv, v, inv);
    }
    frag_load(g, a.de + off, nv);
    bwd_chain<ACTS>(g, enc, sl, off, nv, v, inv);
  }
}

// ---- weight gradients: products over the rows, partials, ordered sum ----

constexpr int TK = 64;           // rows a tile of the weight-gradient pass
constexpr int MAXP = 24;         // products a call (the main call at MAXL layers: 21)
constexpr int PSZ = H * H + H;   // a partial: the [H][H] tile and H column sums
constexpr int SPLIT_ROWS = 8192;
constexpr int MAX_SPLITS = 96;

// One product: out[m][k] = sum over rows of g[row][m] · a[row][k], into
// w[m · in_dim + col0 + k] for k < width (a null: none), and the column
// sums of g into sum[m] (null: none); g and a are [rows, H] bf16.
struct Prod {
  const bf16* g;
  const bf16* a;
  float* w;
  float* sum;
  long long rows;
  int in_dim, col0, width;
};

struct WgradArgs {
  Prod p[MAXP];
  float* part;  // [n][splits][PSZ]
  int n, splits;
};

__host__ __device__ inline int splits_for(long long rows) {
  const long long s = (rows + SPLIT_ROWS - 1) / SPLIT_ROWS;
  return static_cast<int>(s < 1 ? 1 : s > MAX_SPLITS ? MAX_SPLITS : s);
}

// pass 4: block (split, product) forms its rows' partial; warp w owns
// outputs (H/4)·(w % 4).. and inputs (H/2)·(w / 4).. of the tile
__global__ void __launch_bounds__(THREADS) GNW(wgrad)(const WgradArgs wa) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  bf16* tiles_smem = reinterpret_cast<bf16*>(wg_smem);  // [stage][G | A][TK][TS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, q = blockIdx.y;
  const Prod p = wa.p[q];
  const long long n_tiles = (p.rows + TK - 1) / TK;
  const long long k0 = n_tiles * split / wa.splits, k1 = n_tiles * (split + 1) / wa.splits;
  constexpr int PIECES = TK * H / 8;  // 16-byte pieces of a tile

  auto load = [&](int stage, long long t) {
    bf16* sG = tiles_smem + stage * 2 * TK * TS;
    bf16* sA = sG + TK * TS;
#pragma unroll
    for (int i = 0; i < PIECES / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (H / 8), ch = idx % (H / 8);
      const long long row = t * TK + r;
      const bool valid = row < p.rows;
      const long long rr = valid ? row : 0;
      cp_async16(sG + r * TS + ch * 8, p.g + rr * H + ch * 8, valid);
      if (p.a) cp_async16(sA + r * TS + ch * 8, p.a + rr * H + ch * 8, valid);
    }
  };

  constexpr int MT = H / 64;  // m16 tiles of a warp (H / 4 outputs)
  constexpr int NW = H / 16;  // n8 tiles of a warp (H / 2 inputs)
  const int wm = warp & 3, wn = warp >> 2;
  float acc[MT][NW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  float cs = 0.f;

  if (k0 < k1) load(0, k0);
  asm volatile("cp.async.commit_group;\n");
  for (long long t = k0; t < k1; ++t) {
    const int st = static_cast<int>((t - k0) & 1);
    if (t + 1 < k1) load(st ^ 1, t + 1);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 1;\n");
    __syncthreads();
    const bf16* sG = tiles_smem + st * 2 * TK * TS;
    const bf16* sA = sG + TK * TS;
    if (p.a) {
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) {
        uint32_t bk[NW / 2][4];
#pragma unroll
        for (int pp = 0; pp < NW / 2; ++pp)
          ldsm_t(bk[pp], b_cols(sA, TS, (H / 2) * wn + 16 * pp, 16 * ks, lane));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4];
          ldsm_t(af, a_cols(sG, TS, (H / 4) * wm + 16 * i, 16 * ks, lane));
#pragma unroll
          for (int pp = 0; pp < NW / 2; ++pp) {
            mma(acc[i][2 * pp], af, bk[pp][0], bk[pp][1]);
            mma(acc[i][2 * pp + 1], af, bk[pp][2], bk[pp][3]);
          }
        }
      }
    }
    if (p.sum && tid < H) {
#pragma unroll 8
      for (int r = 0; r < TK; ++r) cs += __bfloat162float(sG[r * TS + tid]);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n");

  float* out = wa.part + (static_cast<long long>(q) * wa.splits + split) * PSZ;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (H / 4) * wm + 16 * i + (lane >> 2) + 8 * half;
        const int k = (H / 2) * wn + 8 * n + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + m * H + k) =
            make_float2(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
      }
  if (tid < H) out[H * H + tid] = cs;
}

// pass 5: each gradient element the sum of its partials, in split order
__global__ void __launch_bounds__(THREADS) GNW(wsum)(const WgradArgs wa) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(wa.n) * PSZ) return;
  const int q = static_cast<int>(idx / PSZ), e = static_cast<int>(idx % PSZ);
  const Prod& p = wa.p[q];
  const float* src = wa.part + static_cast<long long>(q) * wa.splits * PSZ + e;
  float s = 0.f;
  for (int sp = 0; sp < wa.splits; ++sp) s += src[static_cast<long long>(sp) * PSZ];
  if (e < H * H) {
    const int m = e / H, k = e % H;
    if (p.a && k < p.width) p.w[m * p.in_dim + p.col0 + k] = s;
  } else if (p.sum) {
    p.sum[e - H * H] = s;
  }
}

inline cudaError_t launch_wgrad(const WgradArgs& wa, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 2 * 2 * TK * TS;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(GNW(wgrad)),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  GNW(wgrad)<<<dim3(wa.splits, wa.n), THREADS, smem, stream>>>(wa);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int blocks = static_cast<int>((static_cast<long long>(wa.n) * PSZ + THREADS - 1) / THREADS);
  GNW(wsum)<<<blocks, THREADS, 0, stream>>>(wa);
  return cudaGetLastError();
}

// an MLP's products: layer 0 (g_0 against a0, its first ``width`` of in_dim
// inputs, with the bias), layers 1.. (g_l against A_l), the scale (P's
// column sums)
inline void add_mlp_products(WgradArgs& wa, const Mlp& grad, bf16* const* slots, const bf16* a0,
                             long long rows, int width) {
  wa.p[wa.n++] = {slots[G0], a0, const_cast<float*>(grad.w[0]), const_cast<float*>(grad.b[0]),
                  rows, grad.in_dim, 0, width};
  for (int l = 1; l < grad.n_layers; ++l)
    wa.p[wa.n++] = {slots[G0 + l], slots[A1 + l - 1], const_cast<float*>(grad.w[l]),
                    const_cast<float*>(grad.b[l]), rows, H, 0, H};
  if (grad.scale)
    wa.p[wa.n++] = {slots[P_SLOT], nullptr, nullptr, const_cast<float*>(grad.scale), rows, 0, 0,
                    0};
}

// bf16 scratch elements (which = 0) and fp32 partial elements (1) of a
// call with MLPs of n_edge, n_node and (folded, fe > 0) n_enc layers: the
// node MLP's 2·n_node slots, and 2·n edge-row slots for the deeper of the
// edge MLP and the encoder, which reuses the edge MLP's
inline long long bwd_sizes(int which, int n_nodes, int batch, long long total_rows, int fe,
                           int n_edge, int n_node, int n_enc) {
  const long long nrows = static_cast<long long>(n_nodes) * batch, erows = total_rows * batch;
  const int n_rows_mlp = fe > 0 && n_enc > n_edge ? n_enc : n_edge;
  if (which == 0)
    return (3 + 2 * n_node + 2) * nrows * H + (2 * n_rows_mlp + (fe > 0 ? 2 : 0)) * erows * H;
  // the main call's products: the edge MLP's (Kr and Ks among them), then
  // the node MLP's (its aggregate's columns among them), each scale
  // counted; the encoder's call reuses the buffer
  const int main = n_edge + 3 + n_node + 2, enc = fe > 0 ? n_enc + 1 : 0;
  return static_cast<long long>(main > enc ? main : enc) *
         splits_for(erows > nrows ? erows : nrows) * PSZ;
}

using BwdKernel = void (*)(const BwdArgs);

// Every pass on ``stream``: ``rows`` and ``send`` are the calling source's
// wrappers of row_bwd_body<Rows, ACTS> (the instance of the edge MLP's
// activation, gn_wide.cuh:fix_act) and send_body<Rows>. ``scratch`` holds
// bwd_sizes(0, ...) bf16 elements, ``part`` bwd_sizes(1, ...) floats; a
// carries the inputs, outputs, MLPs and row map (a.e is the raw features
// when folded).
inline cudaError_t launch_bwd(BwdArgs a, bf16* scratch, float* part, cudaStream_t stream,
                              BwdKernel rows, BwdKernel send) {
  const int B = a.batch, chunks = (B + 15) / 16;
  const long long nrows = static_cast<long long>(a.n_nodes) * B;
  const long long erows = static_cast<long long>(a.total_rows) * B;
  const bool fold = a.fe > 0;
  bf16* s = scratch;
  a.xkr = s;
  a.xks = s += nrows * H;
  s += nrows * H;
  if (a.gagg == nullptr) a.gagg = s;
  s += nrows * H;
  for (int i = 0; i < SLOTS + 2; ++i) {  // the node MLP's slots, then P_r, P_s
    a.ns[i] = i >= SLOTS || slot_used(i, a.node.n_layers) ? s : nullptr;
    if (a.ns[i]) s += nrows * H;
  }
  for (int i = 0; i < SLOTS; ++i) {  // the edge MLP's, which the encoder reuses
    a.es[i] = slot_used(i, a.edge.n_layers) || (fold && slot_used(i, a.enc.n_layers)) ? s
                                                                                      : nullptr;
    if (a.es[i]) s += erows * H;
  }
  if (fold) {
    a.raw = a.e;
    a.e = s;  // e_in, then the encoder's A_0
    a.de = s + erows * H;
    a.cs[0] = s;
    for (int i = 0; i < SLOTS; ++i) a.cs[1 + i] = a.es[i];
  }

  cudaError_t err = launch_partial(a.x, const_cast<bf16*>(a.xkr), const_cast<bf16*>(a.xks),
                                   a.edge.w[0], a.n_nodes, B, stream);
  if (err != cudaSuccess) return err;
  if (fold && (err = launch_enc_fwd(a.raw, const_cast<bf16*>(a.e), a.enc, a.total_rows, B,
                                    stream)) != cudaSuccess)
    return err;
  int grid = 0;
  size_t smem = sizeof(bf16) * wmlp_elems(2 * H, a.node.n_layers);
  const BwdKernel node =
      any_instance(a.node, 2 * H) ? GNW(node_bwd)<true> : GNW(node_bwd)<false>;
  if ((err = grid_of(reinterpret_cast<const void*>(node), smem, nrows / B * chunks, &grid)) !=
      cudaSuccess)
    return err;
  node<<<grid, THREADS, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = sizeof(bf16) * wmlp_elems(H, a.edge.n_layers);
  if ((err = grid_of(reinterpret_cast<const void*>(rows), smem,
                     static_cast<long long>(a.total_rows) * chunks, &grid)) != cudaSuccess)
    return err;
  rows<<<grid, THREADS, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = sizeof(bf16) * H * (2 * H + 8);
  if ((err = grid_of(reinterpret_cast<const void*>(send), smem,
                     static_cast<long long>(a.n_nodes) * chunks, &grid)) != cudaSuccess)
    return err;
  send<<<grid, THREADS, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  WgradArgs wa = {};
  wa.part = part;
  wa.splits = splits_for(erows > nrows ? erows : nrows);
  add_mlp_products(wa, a.gedge, a.es, a.e, erows, H);  // Ke against e_in
  float* gw0 = const_cast<float*>(a.gedge.w[0]);
  wa.p[wa.n++] = {a.ns[PR], a.x, gw0, nullptr, nrows, 3 * H, H, H};      // Kr
  wa.p[wa.n++] = {a.ns[PS], a.x, gw0, nullptr, nrows, 3 * H, 2 * H, H};  // Ks
  add_mlp_products(wa, a.gnode, a.ns, a.x, nrows, H);  // x's columns, the bias
  wa.p[wa.n++] = {a.ns[G0], a.agg, const_cast<float*>(a.gnode.w[0]), nullptr, nrows, 2 * H, H,
                  H};  // the aggregate's columns
  if ((err = launch_wgrad(wa, stream)) != cudaSuccess || !fold) return err;

  smem = sizeof(bf16) * wmlp_elems(a.fe, a.enc.n_layers);
  const BwdKernel enc = any_instance(a.enc, a.fe) ? GNW(enc_bwd)<true> : GNW(enc_bwd)<false>;
  if ((err = grid_of(reinterpret_cast<const void*>(enc), smem,
                     static_cast<long long>(a.total_rows) * chunks, &grid)) != cudaSuccess)
    return err;
  enc<<<grid, THREADS, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  WgradArgs we = {};
  we.part = part;
  we.splits = wa.splits;
  add_mlp_products(we, a.genc, a.cs + 1, a.cs[0], erows, a.fe);
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
