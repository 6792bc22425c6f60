// The GraphNetBlock kernels at hidden 64 and 128 (rows 1-4 of PERF.md's
// table at the wide widths): the tile helpers, the MLPs' weights in shared
// memory, and the kernels the forward (gn_wide_fwd.cuh) and the backward
// (gn_wide_bwd.cuh) share: the node pre-pass and the edge encoder's
// forward. Each library that includes it is compiled for one width,
// nvcc -DGN_WIDE_H=64 or -DGN_WIDE_H=128 (ops/kernel_build.py: FLAGS); the
// hidden-32 sources (gn_tile.cuh, gn_fwd.cuh, gn_bwd_passes.cuh) are
// another family and keep their bits.
//
// A tile is 16 rows of an H-wide bf16 stream: the samples b0..b0+15 of one
// edge row or one node of a [rows, B, H] array (samples past B are zero
// rows that are never stored). One warp holds a tile in the m16n8
// accumulator layout as bf16 pairs, H / 4 registers a lane: f[2n + half] is
// row lane/4 + 8·half, columns 8n + 2(lane%4) + {0, 1}, and f[4ks..4ks+3]
// is the A fragment of k-step ks, so a layer's output feeds the next
// layer's product from registers (gn_tile.cuh's layout at H = 32). Every
// product is mma.sync.m16n8k16 bf16 -> fp32; the numerics are the JAX
// kernel's _mlp_fwd / _rms_fwd / _mlp_bwd (fused_gnblock.py:182-290):
// bf16 values, fp32 sums, every bf16 rounding point kept, only the order
// of the fp32 sums inside a product or a row sum differs.
//
// Why the hidden-32 design does not carry over: there a block holds the
// edge and node MLPs (and the folded encoder) in shared memory at once
// (~37 KB). At H = 128 the two MLPs take 11·H² bf16 values, 352 KB, more
// than a block's 227 KB. So each kernel here holds one MLP: the edge pass
// the edge MLP's e_in columns Ke and layers 1-3 (139 KB at 128), the node
// pass the node MLP (172 KB), the encoder pass the encoder (<= 123 KB). The
// node partials x @ Kr and x @ Ks come from the pre-pass, the folded
// encoder's output e_in from the encoder pass (written where e_out goes,
// and read back in place), and the aggregate goes to device memory between
// the edge and node passes.
//
// An MLP may have 1 to MAXL Dense layers. Each further layer takes H·TS
// bf16 (35 KB at 128), so at hidden 128 an MLP of more layers than fit a
// block's 227 KB (the node MLP 5, the edge MLP 6) keeps its first layers
// resident (resident_layers) and reads the rest from device memory: their
// B fragments straight from the fp32 nn.Linear weights, each pair rounded
// to bf16 as staging rounds it (mma_awt_g, mma_gw_g), so a product has the
// same operands and order, resident or not. The weights are small (64 KB a
// layer) and stay in L2.
#pragma once

#ifndef GN_WIDE_H
#error "compile with -DGN_WIDE_H=64 or -DGN_WIDE_H=128"
#endif

#include "act_common.cuh"
#include "gn_nk_common.cuh"
#include "gn_rows.cuh"
#include "mma_common.cuh"

// kernel names carry the width: gnw128_edge_fwd, ...
#define GNW_NAME2(h, n) gnw##h##_##n
#define GNW_NAME1(h, n) GNW_NAME2(h, n)
#define GNW(n) GNW_NAME1(GN_WIDE_H, n)

namespace gnw {

using namespace tc;
using gn_nk::Mlp;
using bf16 = __nv_bfloat16;
using bf2 = __nv_bfloat162;

constexpr int H = GN_WIDE_H;  // hidden width
static_assert(H == 64 || H == 128, "the wide GraphNetBlock kernels are built for 64 and 128");
using gn_nk::MAXL;            // most Dense layers per MLP
constexpr int NF = H / 4;     // bf16-pair registers of a tile, a lane
constexpr int NT = H / 8;     // n8 tiles of a tile's width
constexpr int KS = H / 16;    // k-steps of a tile's width
constexpr int TS = H + 8;     // row stride (bf16) of an H-wide weight: an odd multiple of 16 bytes
constexpr int THREADS = 256;  // every kernel: 8 warps
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ uint32_t bits(bf2 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ bf2 pair(uint32_t u) { return *reinterpret_cast<bf2*>(&u); }
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ void zero_frag(uint32_t (&f)[NF]) {
#pragma unroll
  for (int i = 0; i < NF; ++i) f[i] = 0u;
}

__device__ __forceinline__ void zero_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// the 16 x H tile at src (rows H apart); rows >= nv read as 0. Plain
// loads: the edge pass reads e where it writes e_out in place.
__device__ __forceinline__ void frag_load(uint32_t (&f)[NF], const bf16* src, int nv) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
    if (r < nv) {
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(src + static_cast<long long>(r) * H) + (lane & 3);
#pragma unroll
      for (int n = 0; n < NT; ++n) f[2 * n + half] = p[4 * n];
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) f[2 * n + half] = 0u;
    }
  }
}

// store rows < nv of the tile
__device__ __forceinline__ void frag_store(bf16* dst, int nv, const uint32_t (&f)[NF]) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
    if (r < nv) {
      uint32_t* p = reinterpret_cast<uint32_t*>(dst + static_cast<long long>(r) * H) + (lane & 3);
#pragma unroll
      for (int n = 0; n < NT; ++n) p[4 * n] = f[2 * n + half];
    }
  }
}

// columns 0..H-1 of 16 raw rows of fe <= H features (row-major), zero past
// fe and on rows >= nv
__device__ __forceinline__ void raw_load(uint32_t (&f)[NF], const bf16* raw, int fe, int nv) {
  const int lane = lane_id();
  const unsigned short* u = reinterpret_cast<const unsigned short*>(raw);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * (lane & 3);
      const long long at = static_cast<long long>(r) * fe + c;
      const uint32_t lo = r < nv && c < fe ? u[at] : 0u;
      const uint32_t hi = r < nv && c + 1 < fe ? u[at + 1] : 0u;
      f[2 * n + half] = lo | (hi << 16);
    }
  }
}

// d += A · Wᵀ[:, k0..]: A the tile (its first ksteps k-steps of 16), W
// [H out][stride] in shared memory, its input columns k0..k0+16·ksteps-1
__device__ __forceinline__ void mma_awt(float (&d)[NT][4], const uint32_t (&a)[NF], const bf16* w,
                                        int stride, int k0, int ksteps = KS) {
  const int lane = lane_id();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < ksteps) {
      const uint32_t af[4] = {a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3]};
#pragma unroll
      for (int p = 0; p < H / 16; ++p) {
        uint32_t b[4];
        ldsm(b, b_rows(w, stride, 16 * p, k0 + 16 * ks, lane));
        mma(d[2 * p], af, b[0], b[1]);
        mma(d[2 * p + 1], af, b[2], b[3]);
      }
    }
  }
}

// d += G · W[:, n0..n0+H-1]: G the tile over W's H outputs (a Dense
// layer's input gradient), W [H out][stride] in shared memory
__device__ __forceinline__ void mma_gw(float (&d)[NT][4], const uint32_t (&g)[NF], const bf16* w,
                                       int stride, int n0) {
  const int lane = lane_id();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t af[4] = {g[4 * ks], g[4 * ks + 1], g[4 * ks + 2], g[4 * ks + 3]};
#pragma unroll
    for (int p = 0; p < H / 16; ++p) {
      uint32_t b[4];
      ldsm_t(b, b_cols(w, stride, n0 + 16 * p, 16 * ks, lane));
      mma(d[2 * p], af, b[0], b[1]);
      mma(d[2 * p + 1], af, b[2], b[3]);
    }
  }
}

// h = bf16(d)
__device__ __forceinline__ void round_acc(uint32_t (&h)[NF], const float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      h[2 * n + half] = bits(__floats2bfloat162_rn(d[n][2 * half], d[n][2 * half + 1]));
}

// d += f in fp32
__device__ __forceinline__ void add_frag(float (&d)[NT][4], const uint32_t (&f)[NF]) {
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
__device__ __forceinline__ void finish(uint32_t (&h)[NF], const float (&d)[NT][4],
                                       const bf16* bias) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const bf2 b = *reinterpret_cast<const bf2*>(bias + 8 * n + 2 * q);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      h[2 * n + half] =
          bits(__hadd2_rn(__floats2bfloat162_rn(d[n][2 * half], d[n][2 * half + 1]), b));
  }
}

__device__ __forceinline__ void relu(uint32_t (&a)[NF], const uint32_t (&h)[NF]) {
  const bf2 z = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < NF; ++i) a[i] = bits(__hmax2(pair(h[i]), z));
}

// c = a + b, each pair rounded once
__device__ __forceinline__ void add_tiles(uint32_t (&c)[NF], const uint32_t (&a)[NF],
                                          const uint32_t (&b)[NF]) {
#pragma unroll
  for (int i = 0; i < NF; ++i) c[i] = bits(__hadd2_rn(pair(a[i]), pair(b[i])));
}

// a = act(h), the MLP's activation (mlp_act::Kind) on the tile
__device__ __forceinline__ void activate(uint32_t (&a)[NF], const uint32_t (&h)[NF], int kind) {
  if (kind == mlp_act::RELU) {
    relu(a, h);
    return;
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) a[i] = mlp_act::act_pair(h[i], kind);
}

// the bits of the pair's halves that are > 0 (a relu's pass mask)
__device__ __forceinline__ uint32_t pos_mask(uint32_t u) {
  const uint32_t lo = static_cast<int16_t>(u & 0xffffu) > 0 ? 0x0000ffffu : 0u;
  const uint32_t hi = static_cast<int16_t>(u >> 16) > 0 ? 0xffff0000u : 0u;
  return lo | hi;
}

// _rms_fwd's statistic 1 / (rms + eps) of the tile's two rows of this lane
// (fp32 sums of the bf16 squares)
__device__ __forceinline__ void rms_inv(float (&inv)[2], const uint32_t (&h)[NF]) {
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
__device__ __forceinline__ void rms_apply(uint32_t (&h)[NF], const float (&inv)[2],
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
// statistic; p gets the scale's terms bf16(g · u)
__device__ __forceinline__ void rms_bwd(uint32_t (&g)[NF], uint32_t (&p)[NF],
                                        const uint32_t (&v)[NF], const float (&inv)[2],
                                        const bf16* scale) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf2 ib = __float2bfloat162_rn(inv[half]);
    float dot = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int i = 2 * n + half;
      const bf2 gv = pair(g[i]), vv = pair(v[i]);
      const bf2 s = *reinterpret_cast<const bf2*>(scale + 8 * n + 2 * q);
      p[i] = bits(__hmul2_rn(gv, __hmul2_rn(vv, ib)));
      const bf2 gu = __hmul2_rn(gv, s);
      g[i] = bits(gu);
      const float2 t = __bfloat1622float2(__hmul2_rn(gu, vv));
      dot += t.x;
      dot += t.y;
    }
    dot = quad_sum(dot);
    const float rms = fmaxf(1.0f / inv[half] - 1e-8f, 1e-30f);
    const bf2 corr = __float2bfloat162_rn(dot * (inv[half] * inv[half]) / (H * rms));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int i = 2 * n + half;
      g[i] = bits(__hsub2_rn(__hmul2_rn(pair(g[i]), ib), __hmul2_rn(pair(v[i]), corr)));
    }
  }
}

// An MLP of n_layers Dense layers in shared memory: layer 0's first
// ``width0`` input columns as [H][pad16(width0) + 8] (zero past width0),
// layers 1..resident-1 as [H][TS], then the biases [n_layers][H] and the
// RMSNorm scale [H], all bf16; layers resident.. stay in device memory
// (``wg``: the fp32 nn.Linear weights)
struct WMlp {
  const bf16* w0;
  const bf16* vec;
  const float* const* wg;
  int stride0, n_layers, resident;
  bool norm;
  int act;  // the activation between layers (mlp_act::Kind)
  __device__ const bf16* layer(int l) const {
    return l == 0 ? w0 : w0 + H * stride0 + (l - 1) * H * TS;
  }
  __device__ const bf16* bias(int l) const { return vec + H * l; }
  __device__ const bf16* scale() const { return vec + H * n_layers; }
};

// the dynamic shared memory an MLP may take: a block's 227 KB on this
// card, less a margin for the kernels' static arrays (stage_mlp's)
constexpr int SMEM_LIMIT = 232448 - 1024;

// bf16 elements a WMlp takes with its first ``resident`` layers in shared
// memory (a multiple of 8: 16 bytes)
__host__ __device__ inline int wmlp_elems_of(int width0, int n_layers, int resident) {
  return H * (pad16(width0) + 8) + (resident - 1) * H * TS + H * (n_layers + 1);
}

// how many of an MLP's layers, from layer 0, fit in shared memory
__host__ __device__ inline int resident_layers(int width0, int n_layers) {
  int r = n_layers;
  while (r > 1 && 2 * wmlp_elems_of(width0, n_layers, r) > SMEM_LIMIT) --r;
  return r;
}

// bf16 elements a WMlp of n_layers takes in shared memory
__host__ __device__ inline int wmlp_elems(int width0, int n_layers) {
  return wmlp_elems_of(width0, n_layers, resident_layers(width0, n_layers));
}

// columns col0..col0+width-1 of an fp32 [H, in_dim] kernel as bf16
// [H][stride], zero past width
__device__ inline void stage_w(bf16* dst, const float* w, int in_dim, int col0, int width,
                               int stride) {
  for (int i = threadIdx.x; i < H * stride; i += blockDim.x) {
    const int o = i / stride, c = i % stride;
    dst[i] = __float2bfloat16_rn(c < width ? w[o * in_dim + col0 + c] : 0.f);
  }
}

// stage the MLP (fp32, nn.Linear [out, in]) at dst with layer 0's first
// width0 input columns (its resident layers, the vectors; the layers'
// device pointers in a shared table, so that no kernel takes the address
// of its parameters); the block must sync before using it
__device__ inline WMlp stage_mlp(bf16* dst, const Mlp& m, int width0) {
  __shared__ const float* s_wg[MAXL];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < MAXL; ++l) s_wg[l] = m.w[l];
  }
  WMlp t;
  t.w0 = dst;
  t.wg = s_wg;
  t.stride0 = pad16(width0) + 8;
  t.n_layers = m.n_layers;
  t.resident = resident_layers(width0, m.n_layers);
  t.norm = m.scale != nullptr;
  t.act = m.act;
  stage_w(dst, m.w[0], m.in_dim, 0, width0, t.stride0);
  bf16* w = dst + H * t.stride0;
  for (int l = 1; l < t.resident; ++l, w += H * TS) stage_w(w, m.w[l], H, 0, H, TS);
  t.vec = w;
  const int nl = m.n_layers;
  for (int i = threadIdx.x; i < H * (nl + 1); i += blockDim.x) {
    const int l = i / H, o = i % H;
    const float v = l < nl ? m.b[l][o] : (m.scale ? m.scale[o] : 0.f);
    w[i] = __float2bfloat16_rn(v);
  }
  return t;
}

// two fp32 values as a bf16 pair (each rounded once), lo in the low half
__device__ __forceinline__ uint32_t pack_bf(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// mma_awt(d, a, W, TS, 0) for an H x H layer W in device memory (fp32
// nn.Linear [out, in]): lane l's B fragment of n-tile n, k-step ks is
// W[8n + l/4][16ks + 2(l%4) + {0, 1}] and the same 8 columns on
__device__ __forceinline__ void mma_awt_g(float (&d)[NT][4], const uint32_t (&a)[NF],
                                          const float* w) {
  const int lane = lane_id(), r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t af[4] = {a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3]};
#pragma unroll 4
    for (int n = 0; n < NT; ++n) {
      const float* p = w + (8 * n + r) * H + 16 * ks + c;
      const float2 lo = __ldg(reinterpret_cast<const float2*>(p));
      const float2 hi = __ldg(reinterpret_cast<const float2*>(p + 8));
      mma(d[n], af, pack_bf(lo.x, lo.y), pack_bf(hi.x, hi.y));
    }
  }
}

// mma_gw(d, g, W, TS, 0) for an H x H layer W in device memory: lane l's
// B fragment of n-tile n, k-step ks is W[16ks + 2(l%4) + {0, 1}][8n + l/4]
// and the same 8 rows on
__device__ __forceinline__ void mma_gw_g(float (&d)[NT][4], const uint32_t (&g)[NF],
                                         const float* w) {
  const int lane = lane_id(), r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t af[4] = {g[4 * ks], g[4 * ks + 1], g[4 * ks + 2], g[4 * ks + 3]};
#pragma unroll 4
    for (int n = 0; n < NT; ++n) {
      const float* p = w + (16 * ks + c) * H + 8 * n + r;
      mma(d[n], af, pack_bf(__ldg(p), __ldg(p + H)), pack_bf(__ldg(p + 8 * H), __ldg(p + 9 * H)));
    }
  }
}

// d += A · W_lᵀ: layer l (>= 1) of the MLP, resident or (STREAM: the
// any-activation instance, fix_act) in device memory
template <bool STREAM>
__device__ __forceinline__ void layer_awt(float (&d)[NT][4], const uint32_t (&a)[NF],
                                          const WMlp& m, int l) {
  if (!STREAM || l < m.resident)
    mma_awt(d, a, m.layer(l), TS, 0);
  else
    mma_awt_g(d, a, m.wg[l]);
}

// d += G · W_l: layer l (>= 1) of the MLP, resident or (STREAM) in
// device memory
template <bool STREAM>
__device__ __forceinline__ void layer_gw(float (&d)[NT][4], const uint32_t (&g)[NF],
                                         const WMlp& m, int l) {
  if (!STREAM || l < m.resident)
    mma_gw(d, g, m.layer(l), TS, 0);
  else
    mma_gw_g(d, g, m.wg[l]);
}

// Each kernel that runs an MLP comes in two instances, ACTS false and
// true: with ACTS false its MLP is relu and all its layers resident,
// constants the compiler folds, so that instance is the relu-only code
// (its registers, its grid, its bits); with ACTS true the activation is
// read at run time and layers past resident_layers come from device
// memory. The launchers pick the instance by the MLP (any_instance).
template <bool ACTS>
__device__ __forceinline__ void fix_act(WMlp& m) {
  if (!ACTS) m.act = mlp_act::RELU;
}

// whether an MLP (layer 0 width0 wide) takes a kernel's ACTS instance:
// another activation than relu, or layers that do not all fit
inline bool any_instance(const Mlp& m, int width0) {
  return m.act != mlp_act::RELU || resident_layers(width0, m.n_layers) < m.n_layers;
}

// layers 1..n_layers-1 (the activation between layers) and the RMSNorm
// tail, if any, of an MLP on the tile; h holds layer 0's output
template <bool STREAM>
__device__ __forceinline__ void mlp_tail(uint32_t (&h)[NF], const WMlp& m) {
#pragma unroll 1
  for (int l = 1; l < m.n_layers; ++l) {
    uint32_t a[NF];
    activate(a, h, m.act);
    float d[NT][4];
    zero_acc(d);
    layer_awt<STREAM>(d, a, m, l);
    finish(h, d, m.bias(l));
  }
  if (m.norm) {
    float inv[2];
    rms_inv(inv, h);
    rms_apply(h, inv, m.scale());
  }
}

// the folded encoder's first-layer product on 16 raw rows of fe features
__device__ __forceinline__ void enc_first(float (&d)[NT][4], uint32_t (&rf)[NF], const bf16* raw,
                                          int fe, const WMlp& enc, int nv) {
  raw_load(rf, raw, fe, nv);
  zero_acc(d);
  mma_awt(d, rf, enc.layer(0), enc.stride0, 0, pad16(fe) / 16);
}

// the grid of a kernel of THREADS threads whose warps stride over ``tiles``
// warp items: at most as many blocks as fit on the card at once
inline cudaError_t grid_of(const void* kernel, size_t smem, long long tiles, int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return gn_nk::grid_for(kernel, THREADS, smem, 32 * tiles, grid);
}

// The node pre-pass, forward and backward: xkr = bf16(x @ Kr) and xks =
// bf16(x @ Ks) for every (node, sample) row, a warp a 16-sample tile; Kr,
// Ks the columns H..2H-1 and 2H..3H-1 of the edge MLP's first layer (w0:
// nn.Linear [H, 3H], fp32), staged as one [H][2H + 8] bf16 array. The
// partials are rounded per node, as fused_gnblock.py:blocked_reference and
// fused_gnblock_nk.py:_edge_fwd round them.
__global__ void __launch_bounds__(THREADS) GNW(partial)(const bf16* x, bf16* xkr, bf16* xks,
                                                        const float* w0, int n_nodes,
                                                        int batch) {
  extern __shared__ __align__(16) unsigned char partial_smem[];
  constexpr int KS2 = 2 * H + 8;
  bf16* s_k = reinterpret_cast<bf16*>(partial_smem);
  stage_w(s_k, w0, 3 * H, H, 2 * H, KS2);
  __syncthreads();
  const int chunks = (batch + 15) / 16;
  const long long tiles = static_cast<long long>(n_nodes) * chunks;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32; t < tiles;
       t += step) {
    const int b0 = 16 * static_cast<int>(t % chunks);
    const int nv = min(16, batch - b0);
    const long long at = ((t / chunks) * batch + b0) * H;
    uint32_t xf[NF], h[NF];
    frag_load(xf, x + at, nv);
#pragma unroll 1
    for (int part = 0; part < 2; ++part) {
      float d[NT][4];
      zero_acc(d);
      mma_awt(d, xf, s_k, KS2, part * H);
      round_acc(h, d);
      frag_store((part == 0 ? xkr : xks) + at, nv, h);
    }
  }
}

inline cudaError_t launch_partial(const bf16* x, bf16* xkr, bf16* xks, const float* w0,
                                  int n_nodes, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * H * (2 * H + 8);
  int grid = 0;
  cudaError_t err = grid_of(reinterpret_cast<const void*>(GNW(partial)), smem,
                            static_cast<long long>(n_nodes) * ((batch + 15) / 16), &grid);
  if (err != cudaSuccess) return err;
  GNW(partial)<<<grid, THREADS, smem, stream>>>(x, xkr, xks, w0, n_nodes, batch);
  return cudaGetLastError();
}

// The folded edge encoder's forward on every row (padding rows included):
// dst[s, b] = Enc(raw[s, b]), raw [rows, B, fe] and dst [rows, B, H] bf16,
// a warp a (row, 16-sample) tile. The forward writes it where e_out goes
// (or to a scratch on the last block) and the edge pass reads it there;
// the backward writes it to a scratch, the A operand of Ke's gradient.
template <bool ACTS>
__global__ void __launch_bounds__(THREADS, 1) GNW(enc_fwd)(const bf16* raw, bf16* dst,
                                                           const Mlp enc, long long rows,
                                                           int batch) {
  extern __shared__ __align__(16) unsigned char enc_smem[];
  const int fe = enc.in_dim;
  WMlp m = stage_mlp(reinterpret_cast<bf16*>(enc_smem), enc, fe);
  fix_act<ACTS>(m);
  __syncthreads();
  const int chunks = (batch + 15) / 16;
  const long long tiles = rows * chunks;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long t = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32; t < tiles;
       t += step) {
    const int b0 = 16 * static_cast<int>(t % chunks);
    const int nv = min(16, batch - b0);
    const long long rb = (t / chunks) * batch + b0;
    float d[NT][4];
    uint32_t h[NF];
    enc_first(d, h, raw + rb * fe, fe, m, nv);
    finish(h, d, m.bias(0));
    mlp_tail<ACTS>(h, m);
    frag_store(dst + rb * H, nv, h);
  }
}

inline cudaError_t launch_enc_fwd(const bf16* raw, bf16* dst, const Mlp& enc, long long rows,
                                  int batch, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * wmlp_elems(enc.in_dim, enc.n_layers);
  const auto kernel = any_instance(enc, enc.in_dim) ? GNW(enc_fwd)<true> : GNW(enc_fwd)<false>;
  int grid = 0;
  cudaError_t err = grid_of(reinterpret_cast<const void*>(kernel), smem,
                            rows * ((batch + 15) / 16), &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(raw, dst, enc, rows, batch);
  return cudaGetLastError();
}

// the MLPs a wide kernel takes: 1 to MAXL Dense layers each (layer 0
// in_dim wide), ``act`` the activation (mlp_act::Kind)
inline bool make_wide_mlp(Mlp* m, const void* const* p, int n_layers, int in_dim, int act) {
  return gn_nk::make_mlp(m, p, n_layers, in_dim, 1, act);
}

}  // namespace gnw
