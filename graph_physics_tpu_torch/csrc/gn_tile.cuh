// GraphNetBlock MLPs on tensor-core tiles, for the forward body of both
// layouts (gn_fwd.cuh) and the node-MLP and row passes of both
// GraphNetBlock backwards (gn_bwd_passes.cuh): every product is
// mma.sync.m16n8k16 with bf16 operands and fp32 sums.
//
// A tile is 16 rows of an H-wide bf16 stream: the samples b0..b0+15 of one
// edge row or one node ([rows, B, H] arrays, so a tile is contiguous when
// B is a multiple of 16; samples past B are zero rows that are never
// stored), held HP = max(H, 16) columns wide. One warp holds a tile in the
// m16n8 accumulator layout, as bf16 pairs: f[2n + half] is row lane/4 +
// 8·half, columns 8n + 2(lane%4) + {0, 1}. f[4ks..4ks+3] is then the A
// fragment of k-step ks, so a layer's output feeds the next layer's
// product straight from registers, and a warp's elementwise work (bias,
// activation, RMSNorm) runs on its own HP / 2 values. Row sums of the
// RMSNorm are sums over the quad of lanes that share a row.
//
// Below hidden 16 every product's K and N are zero-padded to 16 (the
// mma's k-step): columns H..15 of a tile, the rows of a weight past H, its
// columns past each input block's H (layer 0 takes its input as blocks of
// H columns, each padded to HP: [e | x_r | x_s], [x | agg]), and the
// biases and RMSNorm scale past H are zeros. relu, SiLU and GELU map 0 to
// 0, so a padded column is exactly 0 through every layer; the RMSNorm's
// mean divides by the true H (its sums add exact zeros), and loads and
// stores touch only the H real columns.
//
// The numerics are the JAX kernel's _mlp_fwd / _rms_fwd / _mlp_bwd
// (fused_gnblock.py:219, :245): weights are bf16 values, each layer's
// input is bf16, products sum in fp32, and every bf16 rounding point is
// kept; only the order of the fp32 sums inside a product (and inside the
// RMS row sums) differs. Elementwise steps run on bf16 pairs
// (mul/add/sub .rn.bf16x2: the exact result rounded once, as the fp32
// operation rounded to bf16).
//
// Weights sit in shared memory as bf16 [out][in] (nn.Linear's layout) with
// rows padded to an odd multiple of 16 bytes, so the 8 row addresses of an
// ldmatrix fall in 8 distinct bank groups: A · Wᵀ reads W with ldmatrix,
// G · W (an input gradient) with ldmatrix.trans.
#pragma once

#include "act_common.cuh"
#include "gn_nk_common.cuh"
#include "mma_common.cuh"

namespace gn_tile {

using namespace tc;
using gn_nk::H;
using gn_nk::Mlp;
using bf16 = __nv_bfloat16;
using bf2 = __nv_bfloat162;

constexpr int HP = H < 16 ? 16 : H;  // a tile's width: H zero-padded to the mma's k-step
constexpr int FR = HP / 4;           // bf16-pair registers of a tile, a lane
constexpr int NT = HP / 8;           // n8 tiles of a tile's width
constexpr int KS = HP / 16;          // k-steps of a tile's width
constexpr int TS = HP + 8;  // row stride (bf16) of a tile-wide weight or staged tile: an odd
                            // multiple of 16 bytes

__device__ __forceinline__ uint32_t bits(bf2 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ bf2 pair(uint32_t u) { return *reinterpret_cast<bf2*>(&u); }

// the padded width of one of layer 0's input blocks of w columns: a
// multiple of 16
__host__ __device__ inline int pad16(int w) { return (w + 15) / 16 * 16; }

// row stride (bf16) of a layer-0 weight: its input blocks, each padded to
// a multiple of 16, plus 8
__host__ __device__ inline int stride0_of(const Mlp& m) {
  return m.parts * pad16(m.in_dim / m.parts) + 8;
}

// An MLP in shared memory: W0 [HP][stride0] (zero past each input block's
// columns and past H rows), W1.. [HP][TS], then the biases [n_layers][HP]
// and the RMSNorm scale [HP], all bf16
struct TileMlp {
  const bf16* w;
  const bf16* vec;
  int stride0, n_layers;
  bool norm;
  int act;  // mlp_act::Kind
  __device__ const bf16* layer(int l) const {
    return l == 0 ? w : w + HP * stride0 + (l - 1) * HP * TS;
  }
  __device__ const bf16* bias(int l) const { return vec + HP * l; }
  __device__ const bf16* scale() const { return vec + HP * n_layers; }
};

// bf16 elements one MLP takes in shared memory (a multiple of 8: 16 bytes)
__host__ __device__ inline int tile_mlp_elems(const Mlp& m) {
  return HP * stride0_of(m) + (m.n_layers - 1) * HP * TS + HP * (m.n_layers + 1);
}

// stage one MLP (fp32, nn.Linear [out, in]) into shared memory at dst as
// bf16 values; the block must sync before using it
__device__ inline TileMlp stage_tile_mlp(bf16* dst, const Mlp& m) {
  const int s0 = stride0_of(m);
  const int pw = m.in_dim / m.parts, pp = pad16(pw);  // an input block's columns, padded
  TileMlp t;
  t.w = dst;
  t.vec = dst + HP * s0 + (m.n_layers - 1) * HP * TS;
  t.stride0 = s0;
  t.n_layers = m.n_layers;
  t.norm = m.scale != nullptr;
  t.act = m.act;
  for (int i = threadIdx.x; i < HP * s0; i += blockDim.x) {
    const int o = i / s0, c = i % s0, p = c / pp, k = c % pp;
    dst[i] = __float2bfloat16_rn(o < H && p < m.parts && k < pw
                                     ? m.w[0][o * m.in_dim + p * pw + k] : 0.f);
  }
  bf16* w = dst + HP * s0;
  for (int l = 1; l < m.n_layers; ++l, w += HP * TS)
    for (int i = threadIdx.x; i < HP * TS; i += blockDim.x) {
      const int o = i / TS, c = i % TS;
      w[i] = __float2bfloat16_rn(o < H && c < H ? m.w[l][o * H + c] : 0.f);
    }
  bf16* vec = const_cast<bf16*>(t.vec);
  for (int i = threadIdx.x; i < HP * m.n_layers; i += blockDim.x)
    vec[i] = __float2bfloat16_rn(i % HP < H ? m.b[i / HP][i % HP] : 0.f);
  if (m.scale)
    for (int o = threadIdx.x; o < HP; o += blockDim.x)
      vec[HP * m.n_layers + o] = __float2bfloat16_rn(o < H ? m.scale[o] : 0.f);
  return t;
}

// Each kernel comes in two instances, ACTS false and true: with ACTS false
// every MLP is relu, a constant the compiler folds, so that instance is the
// relu-only code (its registers, and so its grid and the order of its
// weight gradients' block sums: its bits); with ACTS true each MLP's
// activation is read at run time. The launchers pick the instance
// (any_act).
template <bool ACTS>
__device__ __forceinline__ void fix_act(TileMlp& m) {
  if (!ACTS) m.act = mlp_act::RELU;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ void zero_frag(uint32_t (&f)[FR]) {
#pragma unroll
  for (int i = 0; i < FR; ++i) f[i] = 0u;
}

__device__ __forceinline__ void zero_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// the pair at columns c, c + 1 of a row of H (c even): both, only c (H
// odd), or none past H
__device__ __forceinline__ uint32_t pair_load(const bf16* row, int c) {
  if (c + 1 < H) return __ldg(reinterpret_cast<const uint32_t*>(row + c));
  if (c < H) return __ldg(reinterpret_cast<const unsigned short*>(row + c));
  return 0u;
}

__device__ __forceinline__ void pair_store(bf16* row, int c, uint32_t v) {
  if (c + 1 < H)
    *reinterpret_cast<uint32_t*>(row + c) = v;
  else if (c < H)
    *reinterpret_cast<unsigned short*>(row + c) = static_cast<unsigned short>(v & 0xffffu);
}

// the 16 x H tile at src (rows ``stride`` bf16 apart); rows >= nv and
// columns >= H read as 0
__device__ __forceinline__ void frag_load(uint32_t (&f)[FR], const bf16* src, int stride, int nv) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
    if (r < nv) {
      if constexpr (HP == H) {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(
                                src + static_cast<long long>(r) * stride) + (lane & 3);
#pragma unroll
        for (int n = 0; n < NT; ++n) f[2 * n + half] = __ldg(p + 4 * n);
      } else {
        const bf16* row = src + static_cast<long long>(r) * stride;
#pragma unroll
        for (int n = 0; n < NT; ++n) f[2 * n + half] = pair_load(row, 8 * n + 2 * (lane & 3));
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) f[2 * n + half] = 0u;
    }
  }
}

// store rows < nv and columns < H of the tile
__device__ __forceinline__ void frag_store(bf16* dst, int stride, int nv,
                                           const uint32_t (&f)[FR]) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
    if (r < nv) {
      if constexpr (HP == H) {
        uint32_t* p = reinterpret_cast<uint32_t*>(dst + static_cast<long long>(r) * stride) +
                      (lane & 3);
#pragma unroll
        for (int n = 0; n < NT; ++n) p[4 * n] = f[2 * n + half];
      } else {
        bf16* row = dst + static_cast<long long>(r) * stride;
#pragma unroll
        for (int n = 0; n < NT; ++n) pair_store(row, 8 * n + 2 * (lane & 3), f[2 * n + half]);
      }
    }
  }
}

// the tile to / from shared memory ([16][stride], the lane's own positions)
__device__ __forceinline__ void frag_to_smem(bf16* t, int stride, const uint32_t (&f)[FR]) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t* p = reinterpret_cast<uint32_t*>(t + ((lane >> 2) + 8 * half) * stride) + (lane & 3);
#pragma unroll
    for (int n = 0; n < NT; ++n) p[4 * n] = f[2 * n + half];
  }
}

__device__ __forceinline__ void frag_from_smem(uint32_t (&f)[FR], const bf16* t, int stride) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(t + ((lane >> 2) + 8 * half) * stride) + (lane & 3);
#pragma unroll
    for (int n = 0; n < NT; ++n) f[2 * n + half] = p[4 * n];
  }
}

// columns c0..c0+HP-1 of 16 raw rows of fe features (row-major), zero past
// fe and on rows >= nv
__device__ __forceinline__ void raw_load(uint32_t (&f)[FR], const bf16* raw, int fe, int c0,
                                         int nv) {
  const int lane = lane_id();
  const unsigned short* u = reinterpret_cast<const unsigned short*>(raw);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = c0 + 8 * n + 2 * (lane & 3);
      const long long at = static_cast<long long>(r) * fe + c;
      const uint32_t lo = r < nv && c < fe ? __ldg(u + at) : 0u;
      const uint32_t hi = r < nv && c + 1 < fe ? __ldg(u + at + 1) : 0u;
      f[2 * n + half] = lo | (hi << 16);
    }
  }
}

// d += A · Wᵀ[k0.., :]: A the tile (k = its HP columns; only the first
// ksteps k-steps of 16), W [HP out][stride] in shared memory, its input
// columns k0..k0+16·ksteps-1 (a Dense layer's product)
__device__ __forceinline__ void mma_awt(float (&d)[NT][4], const uint32_t (&a)[FR],
                                        const bf16* w, int stride, int k0, int ksteps = KS) {
  const int lane = lane_id();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < ksteps) {
      const uint32_t af[4] = {a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3]};
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldsm(b, b_rows(w, stride, 16 * p, k0 + 16 * ks, lane));
        mma(d[2 * p], af, b[0], b[1]);
        mma(d[2 * p + 1], af, b[2], b[3]);
      }
    }
  }
}

// d += G · W[:, n0..n0+HP-1]: G the tile over W's HP outputs (a Dense
// layer's input gradient), W [HP out][stride] in shared memory
__device__ __forceinline__ void mma_gw(float (&d)[NT][4], const uint32_t (&g)[FR], const bf16* w,
                                       int stride, int n0) {
  const int lane = lane_id();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t af[4] = {g[4 * ks], g[4 * ks + 1], g[4 * ks + 2], g[4 * ks + 3]};
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t b[4];
      ldsm_t(b, b_cols(w, stride, n0 + 16 * p, 16 * ks, lane));
      mma(d[2 * p], af, b[0], b[1]);
      mma(d[2 * p + 1], af, b[2], b[3]);
    }
  }
}

// h = bf16(d)
__device__ __forceinline__ void round_acc(uint32_t (&h)[FR], const float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      h[2 * n + half] = bits(__floats2bfloat162_rn(d[n][2 * half], d[n][2 * half + 1]));
}

// d += f in fp32 (a bf16 partial added to a product before its rounding)
__device__ __forceinline__ void add_frag(float (&d)[NT][4], const uint32_t (&f)[FR]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = __bfloat1622float2(pair(f[2 * n + half]));
      d[n][2 * half] += v.x;
      d[n][2 * half + 1] += v.y;
    }
}

// h = bf16(bf16(d) + bias): a Dense output
__device__ __forceinline__ void finish(uint32_t (&h)[FR], const float (&d)[NT][4],
                                       const bf16* bias) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const bf2 b = *reinterpret_cast<const bf2*>(bias + 8 * n + 2 * q);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      h[2 * n + half] = bits(
          __hadd2_rn(__floats2bfloat162_rn(d[n][2 * half], d[n][2 * half + 1]), b));
  }
}

__device__ __forceinline__ void relu(uint32_t (&a)[FR], const uint32_t (&h)[FR]) {
  const bf2 z = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < FR; ++i) a[i] = bits(__hmax2(pair(h[i]), z));
}

// a = act(h), the MLP's activation (mlp_act::Kind) on the tile
__device__ __forceinline__ void activate(uint32_t (&a)[FR], const uint32_t (&h)[FR], int kind) {
  if (kind == mlp_act::RELU) {
    relu(a, h);
    return;
  }
#pragma unroll
  for (int i = 0; i < FR; ++i) a[i] = mlp_act::act_pair(h[i], kind);
}

// c = a + b, each pair rounded once
__device__ __forceinline__ void add_tiles(uint32_t (&c)[FR], const uint32_t (&a)[FR],
                                          const uint32_t (&b)[FR]) {
#pragma unroll
  for (int i = 0; i < FR; ++i) c[i] = bits(__hadd2_rn(pair(a[i]), pair(b[i])));
}

// the bits of the pair's halves that are > 0 (a relu's pass mask)
__device__ __forceinline__ uint32_t pos_mask(uint32_t u) {
  const uint32_t lo = static_cast<int16_t>(u & 0xffffu) > 0 ? 0x0000ffffu : 0u;
  const uint32_t hi = static_cast<int16_t>(u >> 16) > 0 ? 0xffff0000u : 0u;
  return lo | hi;
}

// _rms_fwd's statistic 1 / (rms + eps) of the tile's two rows of this lane
// (fp32 sums of the bf16 squares; the padded columns add exact zeros, and
// the mean is over the true H)
__device__ __forceinline__ void rms_inv(float (&inv)[2], const uint32_t (&h)[FR]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float gs = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf2 v = pair(h[2 * n + half]);
      const float2 sq = __bfloat1622float2(__hmul2_rn(v, v));
      gs += sq.x;
      gs += sq.y;
    }
    gs = quad_sum(gs);
    const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
    inv[half] = 1.0f / (rms + 1e-8f);
  }
}

// h = bf16(bf16(h · bf16(inv)) · scale)
__device__ __forceinline__ void rms_apply(uint32_t (&h)[FR], const float (&inv)[2],
                                          const bf16* scale) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf2 ib = __float2bfloat162_rn(inv[half]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf2 s = *reinterpret_cast<const bf2*>(scale + 8 * n + 2 * q);
      h[2 * n + half] = bits(__hmul2_rn(__hmul2_rn(pair(h[2 * n + half]), ib), s));
    }
  }
}

// _rms_bwd in place on the cotangent g: v the norm's input, inv its
// statistic; p gets the scale's terms bf16(g · u). The correction divides
// by the true H; padded columns (v = scale = 0) give g = 0.
__device__ __forceinline__ void rms_bwd(uint32_t (&g)[FR], uint32_t (&p)[FR],
                                        const uint32_t (&v)[FR], const float (&inv)[2],
                                        const bf16* scale) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf2 ib = __float2bfloat162_rn(inv[half]);
    bf2 gu[NT];
    float dot = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int i = 2 * n + half;
      const bf2 gv = pair(g[i]), vv = pair(v[i]);
      const bf2 s = *reinterpret_cast<const bf2*>(scale + 8 * n + 2 * q);
      p[i] = bits(__hmul2_rn(gv, __hmul2_rn(vv, ib)));
      gu[n] = __hmul2_rn(gv, s);
      const float2 t = __bfloat1622float2(__hmul2_rn(gu[n], vv));
      dot += t.x;
      dot += t.y;
    }
    dot = quad_sum(dot);
    const float rms = fmaxf(1.0f / inv[half] - 1e-8f, 1e-30f);
    const bf2 corr = __float2bfloat162_rn(dot * (inv[half] * inv[half]) / (H * rms));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int i = 2 * n + half;
      g[i] = bits(__hsub2_rn(__hmul2_rn(gu[n], ib), __hmul2_rn(pair(v[i]), corr)));
    }
  }
}

// layers 1..n-1 (the activation between layers) and the RMSNorm tail, if
// any, of an MLP on the tile; h holds layer 0's output
__device__ __forceinline__ void mlp_tail(uint32_t (&h)[FR], const TileMlp& m) {
  for (int l = 1; l < m.n_layers; ++l) {
    uint32_t a[FR];
    activate(a, h, m.act);
    float d[NT][4];
    zero_acc(d);
    mma_awt(d, a, m.layer(l), TS, 0);
    finish(h, d, m.bias(l));
  }
  if (m.norm) {
    float inv[2];
    rms_inv(inv, h);
    rms_apply(h, inv, m.scale());
  }
}

// the folded encoder's first-layer product on 16 raw rows of fe features
// (K padded to a multiple of 16 with zeros)
__device__ __forceinline__ void enc_first(float (&d)[NT][4], const bf16* raw, int fe,
                                          const TileMlp& enc, int nv) {
  zero_acc(d);
  for (int c0 = 0; c0 < fe; c0 += HP) {
    uint32_t rf[FR];
    raw_load(rf, raw, fe, c0, nv);
    mma_awt(d, rf, enc.layer(0), enc.stride0, c0, min(KS, (fe - c0 + 15) / 16));
  }
}

// the folded encoder's output on 16 raw rows (the forward's e_in)
__device__ __forceinline__ void encode(uint32_t (&h)[FR], const bf16* raw, int fe,
                                       const TileMlp& enc, int nv) {
  float d[NT][4];
  enc_first(d, raw, fe, enc, nv);
  finish(h, d, enc.bias(0));
  mlp_tail(h, enc);
}

constexpr int PARTIAL_TC_THREADS = 256;

// The node pre-pass of the GraphNetBlock kernels, both layouts, forward and
// backward, on tiles: xkr = bf16(x @ Kr) and xks = bf16(x @ Ks) for every
// (node, sample) row, a warp a 16-sample tile (either output may be null);
// Kr, Ks the columns H..2H-1 and 2H..3H-1 of the edge MLP's first layer
// (w0: nn.Linear [H, 3H], fp32). The node partials are rounded per node,
// as fused_gnblock.py:blocked_reference and fused_gnblock_nk.py:_edge_fwd
// round them, so a node's partial is a tile load per edge row. The width
// is a template argument so that the kernel's name carries it.
template <int W>
__global__ void __launch_bounds__(PARTIAL_TC_THREADS)
    gn_partial_tc_kernel(const bf16* x, bf16* xkr, bf16* xks, const float* w0, int n_nodes,
                         int batch) {
  constexpr int KST = 2 * HP + 8;
  __shared__ __align__(16) bf16 s_k[HP * KST];  // [out][Kr | Ks], each HP wide
  for (int i = threadIdx.x; i < HP * KST; i += blockDim.x) {
    const int o = i / KST, c = i % KST, part = c / HP, k = c % HP;
    s_k[i] = __float2bfloat16_rn(o < W && part < 2 && k < W ? w0[o * 3 * W + (1 + part) * W + k]
                                                            : 0.f);
  }
  __syncthreads();
  const int chunks = (batch + 15) / 16;
  const long long tiles = static_cast<long long>(n_nodes) * chunks;
  const long long step = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long t = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
       t < tiles; t += step) {
    const int b0 = 16 * static_cast<int>(t % chunks);
    const int nv = min(16, batch - b0);
    const long long at = ((t / chunks) * batch + b0) * W;
    uint32_t xf[FR], h[FR];
    frag_load(xf, x + at, W, nv);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      bf16* out = part == 0 ? xkr : xks;
      if (out == nullptr) continue;
      float d[NT][4];
      zero_acc(d);
      mma_awt(d, xf, s_k, KST, part * HP);
      round_acc(h, d);
      frag_store(out + at, W, nv, h);
    }
  }
}

inline cudaError_t launch_partial(const bf16* x, bf16* xkr, bf16* xks, const float* w0,
                                  int n_nodes, int batch, cudaStream_t stream) {
  int grid = 0;
  const long long tiles = static_cast<long long>(n_nodes) * ((batch + 15) / 16);
  cudaError_t err = gn_nk::grid_for(reinterpret_cast<const void*>(gn_partial_tc_kernel<H>),
                                    PARTIAL_TC_THREADS, 0, 32 * tiles, &grid);  // a warp a tile
  if (err != cudaSuccess) return err;
  gn_partial_tc_kernel<H><<<grid, PARTIAL_TC_THREADS, 0, stream>>>(x, xkr, xks, w0, n_nodes,
                                                                   batch);
  return cudaGetLastError();
}

}  // namespace gn_tile
