// GraphNetBlock MLPs on tensor-core tiles, for the forward body of both
// layouts (gn_fwd.cuh) and the node-MLP and row passes of both
// GraphNetBlock backwards (gn_bwd_passes.cuh): every product is
// mma.sync.m16n8k16 with bf16 operands and fp32 sums.
//
// A tile is 16 rows of a 32-wide bf16 stream: the samples b0..b0+15 of one
// edge row or one node ([rows, B, 32] arrays, so a tile is contiguous when
// B is a multiple of 16; samples past B are zero rows that are never
// stored). One warp holds a tile in the m16n8 accumulator layout, as bf16
// pairs: f[2n + half] is row lane/4 + 8·half, columns 8n + 2(lane%4) + {0,
// 1}. f[4ks..4ks+3] is then the A fragment of k-step ks, so a layer's
// output feeds the next layer's product straight from registers, and a
// warp's elementwise work (bias, relu, RMSNorm) runs on its own 16 values.
// Row sums of the RMSNorm are sums over the quad of lanes that share a row.
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

#include "gn_nk_common.cuh"
#include "mma_common.cuh"

namespace gn_tile {

using namespace tc;
using gn_nk::H;
using gn_nk::Mlp;
using bf16 = __nv_bfloat16;
using bf2 = __nv_bfloat162;

constexpr int TS = H + 8;  // row stride (bf16) of a 32-wide weight or staged tile: 80 bytes

__device__ __forceinline__ uint32_t bits(bf2 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ bf2 pair(uint32_t u) { return *reinterpret_cast<bf2*>(&u); }

// row stride (bf16) of a layer-0 weight with in_dim inputs: K padded to a
// multiple of 16, plus 8
__host__ __device__ inline int stride0_of(int in_dim) { return (in_dim + 15) / 16 * 16 + 8; }

// An MLP in shared memory: W0 [32][stride0] (columns past in_dim zero),
// W1.. [32][TS], then the biases [n_layers][32] and the RMSNorm scale [32],
// all bf16
struct TileMlp {
  const bf16* w;
  const bf16* vec;
  int stride0, n_layers;
  bool norm;
  __device__ const bf16* layer(int l) const {
    return l == 0 ? w : w + H * stride0 + (l - 1) * H * TS;
  }
  __device__ const bf16* bias(int l) const { return vec + H * l; }
  __device__ const bf16* scale() const { return vec + H * n_layers; }
};

// bf16 elements one MLP takes in shared memory (a multiple of 8: 16 bytes)
__host__ __device__ inline int tile_mlp_elems(const Mlp& m) {
  return H * stride0_of(m.in_dim) + (m.n_layers - 1) * H * TS + H * (m.n_layers + 1);
}

// stage one MLP (fp32, nn.Linear [out, in]) into shared memory at dst as
// bf16 values; the block must sync before using it
__device__ inline TileMlp stage_tile_mlp(bf16* dst, const Mlp& m) {
  const int s0 = stride0_of(m.in_dim);
  TileMlp t;
  t.w = dst;
  t.vec = dst + H * s0 + (m.n_layers - 1) * H * TS;
  t.stride0 = s0;
  t.n_layers = m.n_layers;
  t.norm = m.scale != nullptr;
  for (int i = threadIdx.x; i < H * s0; i += blockDim.x) {
    const int o = i / s0, c = i % s0;
    dst[i] = __float2bfloat16_rn(c < m.in_dim ? m.w[0][o * m.in_dim + c] : 0.f);
  }
  bf16* w = dst + H * s0;
  for (int l = 1; l < m.n_layers; ++l, w += H * TS)
    for (int i = threadIdx.x; i < H * TS; i += blockDim.x) {
      const int o = i / TS, c = i % TS;
      w[i] = __float2bfloat16_rn(c < H ? m.w[l][o * H + c] : 0.f);
    }
  bf16* vec = const_cast<bf16*>(t.vec);
  for (int i = threadIdx.x; i < H * m.n_layers; i += blockDim.x)
    vec[i] = __float2bfloat16_rn(m.b[i / H][i % H]);
  if (m.scale)
    for (int o = threadIdx.x; o < H; o += blockDim.x)
      vec[H * m.n_layers + o] = __float2bfloat16_rn(m.scale[o]);
  return t;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ void zero_frag(uint32_t (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = 0u;
}

__device__ __forceinline__ void zero_acc(float (&d)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// the 16 x 32 tile at src (rows ``stride`` bf16 apart); rows >= nv read as 0
__device__ __forceinline__ void frag_load(uint32_t (&f)[8], const bf16* src, int stride, int nv) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
    if (r < nv) {
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(src + static_cast<long long>(r) * stride) + (lane & 3);
#pragma unroll
      for (int n = 0; n < 4; ++n) f[2 * n + half] = __ldg(p + 4 * n);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n) f[2 * n + half] = 0u;
    }
  }
}

// store rows < nv of the tile
__device__ __forceinline__ void frag_store(bf16* dst, int stride, int nv, const uint32_t (&f)[8]) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
    if (r < nv) {
      uint32_t* p = reinterpret_cast<uint32_t*>(dst + static_cast<long long>(r) * stride) + (lane & 3);
#pragma unroll
      for (int n = 0; n < 4; ++n) p[4 * n] = f[2 * n + half];
    }
  }
}

// the tile to / from shared memory ([16][stride], the lane's own positions)
__device__ __forceinline__ void frag_to_smem(bf16* t, int stride, const uint32_t (&f)[8]) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t* p = reinterpret_cast<uint32_t*>(t + ((lane >> 2) + 8 * half) * stride) + (lane & 3);
#pragma unroll
    for (int n = 0; n < 4; ++n) p[4 * n] = f[2 * n + half];
  }
}

__device__ __forceinline__ void frag_from_smem(uint32_t (&f)[8], const bf16* t, int stride) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(t + ((lane >> 2) + 8 * half) * stride) + (lane & 3);
#pragma unroll
    for (int n = 0; n < 4; ++n) f[2 * n + half] = p[4 * n];
  }
}

// columns c0..c0+31 of 16 raw rows of fe features (row-major), zero past fe
// and on rows >= nv
__device__ __forceinline__ void raw_load(uint32_t (&f)[8], const bf16* raw, int fe, int c0, int nv) {
  const int lane = lane_id();
  const unsigned short* u = reinterpret_cast<const unsigned short*>(raw);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = c0 + 8 * n + 2 * (lane & 3);
      const long long at = static_cast<long long>(r) * fe + c;
      const uint32_t lo = r < nv && c < fe ? __ldg(u + at) : 0u;
      const uint32_t hi = r < nv && c + 1 < fe ? __ldg(u + at + 1) : 0u;
      f[2 * n + half] = lo | (hi << 16);
    }
  }
}

// d += A · Wᵀ[k0.., :]: A the tile (k = its 32 columns; only the first
// ksteps k-steps of 16), W [32 out][stride] in shared memory, its input
// columns k0..k0+16·ksteps-1 (a Dense layer's product)
__device__ __forceinline__ void mma_awt(float (&d)[4][4], const uint32_t (&a)[8], const bf16* w,
                                        int stride, int k0, int ksteps = 2) {
  const int lane = lane_id();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks < ksteps) {
      const uint32_t af[4] = {a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3]};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t b[4];
        ldsm(b, b_rows(w, stride, 16 * p, k0 + 16 * ks, lane));
        mma(d[2 * p], af, b[0], b[1]);
        mma(d[2 * p + 1], af, b[2], b[3]);
      }
    }
  }
}

// d += G · W[:, n0..n0+31]: G the tile over W's 32 outputs (a Dense
// layer's input gradient), W [32 out][stride] in shared memory
__device__ __forceinline__ void mma_gw(float (&d)[4][4], const uint32_t (&g)[8], const bf16* w,
                                       int stride, int n0) {
  const int lane = lane_id();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint32_t af[4] = {g[4 * ks], g[4 * ks + 1], g[4 * ks + 2], g[4 * ks + 3]};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t b[4];
      ldsm_t(b, b_cols(w, stride, n0 + 16 * p, 16 * ks, lane));
      mma(d[2 * p], af, b[0], b[1]);
      mma(d[2 * p + 1], af, b[2], b[3]);
    }
  }
}

// h = bf16(d)
__device__ __forceinline__ void round_acc(uint32_t (&h)[8], const float (&d)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      h[2 * n + half] = bits(__floats2bfloat162_rn(d[n][2 * half], d[n][2 * half + 1]));
}

// d += f in fp32 (a bf16 partial added to a product before its rounding)
__device__ __forceinline__ void add_frag(float (&d)[4][4], const uint32_t (&f)[8]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = __bfloat1622float2(pair(f[2 * n + half]));
      d[n][2 * half] += v.x;
      d[n][2 * half + 1] += v.y;
    }
}

// h = bf16(bf16(d) + bias): a Dense output
__device__ __forceinline__ void finish(uint32_t (&h)[8], const float (&d)[4][4], const bf16* bias) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const bf2 b = *reinterpret_cast<const bf2*>(bias + 8 * n + 2 * q);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      h[2 * n + half] = bits(
          __hadd2_rn(__floats2bfloat162_rn(d[n][2 * half], d[n][2 * half + 1]), b));
  }
}

__device__ __forceinline__ void relu(uint32_t (&a)[8], const uint32_t (&h)[8]) {
  const bf2 z = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = bits(__hmax2(pair(h[i]), z));
}

// c = a + b, each pair rounded once
__device__ __forceinline__ void add_tiles(uint32_t (&c)[8], const uint32_t (&a)[8],
                                          const uint32_t (&b)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = bits(__hadd2_rn(pair(a[i]), pair(b[i])));
}

// the bits of the pair's halves that are > 0 (a relu's pass mask)
__device__ __forceinline__ uint32_t pos_mask(uint32_t u) {
  const uint32_t lo = static_cast<int16_t>(u & 0xffffu) > 0 ? 0x0000ffffu : 0u;
  const uint32_t hi = static_cast<int16_t>(u >> 16) > 0 ? 0xffff0000u : 0u;
  return lo | hi;
}

// _rms_fwd's statistic 1 / (rms + eps) of the tile's two rows of this lane
// (fp32 sums of the bf16 squares)
__device__ __forceinline__ void rms_inv(float (&inv)[2], const uint32_t (&h)[8]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float gs = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
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
__device__ __forceinline__ void rms_apply(uint32_t (&h)[8], const float (&inv)[2],
                                          const bf16* scale) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf2 ib = __float2bfloat162_rn(inv[half]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const bf2 s = *reinterpret_cast<const bf2*>(scale + 8 * n + 2 * q);
      h[2 * n + half] = bits(__hmul2_rn(__hmul2_rn(pair(h[2 * n + half]), ib), s));
    }
  }
}

// _rms_bwd in place on the cotangent g: v the norm's input, inv its
// statistic; p gets the scale's terms bf16(g · u)
__device__ __forceinline__ void rms_bwd(uint32_t (&g)[8], uint32_t (&p)[8], const uint32_t (&v)[8],
                                        const float (&inv)[2], const bf16* scale) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf2 ib = __float2bfloat162_rn(inv[half]);
    bf2 gu[4];
    float dot = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
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
    for (int n = 0; n < 4; ++n) {
      const int i = 2 * n + half;
      g[i] = bits(__hsub2_rn(__hmul2_rn(gu[n], ib), __hmul2_rn(pair(v[i]), corr)));
    }
  }
}

// layers 1..n-1 (relu between layers) and the RMSNorm tail, if any, of an
// MLP on the tile; h holds layer 0's output
__device__ __forceinline__ void mlp_tail(uint32_t (&h)[8], const TileMlp& m) {
  for (int l = 1; l < m.n_layers; ++l) {
    uint32_t a[8];
    relu(a, h);
    float d[4][4];
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
__device__ __forceinline__ void enc_first(float (&d)[4][4], const bf16* raw, int fe,
                                          const TileMlp& enc, int nv) {
  zero_acc(d);
  for (int c0 = 0; c0 < fe; c0 += 32) {
    uint32_t rf[8];
    raw_load(rf, raw, fe, c0, nv);
    mma_awt(d, rf, enc.layer(0), enc.stride0, c0, min(2, (fe - c0 + 15) / 16));
  }
}

// the folded encoder's output on 16 raw rows (the forward's e_in)
__device__ __forceinline__ void encode(uint32_t (&h)[8], const bf16* raw, int fe,
                                       const TileMlp& enc, int nv) {
  float d[4][4];
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
// round them, so a node's partial is a tile load per edge row.
__global__ void __launch_bounds__(PARTIAL_TC_THREADS)
    gn_partial_tc_kernel(const bf16* x, bf16* xkr, bf16* xks, const float* w0, int n_nodes,
                         int batch) {
  constexpr int KS = 2 * H + 8;
  __shared__ __align__(16) bf16 s_k[H * KS];  // [out][Kr | Ks]
  for (int i = threadIdx.x; i < H * KS; i += blockDim.x) {
    const int o = i / KS, c = i % KS;
    s_k[i] = __float2bfloat16_rn(c < 2 * H ? w0[o * 3 * H + H + c] : 0.f);
  }
  __syncthreads();
  const int chunks = (batch + 15) / 16;
  const long long tiles = static_cast<long long>(n_nodes) * chunks;
  const long long step = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long t = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
       t < tiles; t += step) {
    const int b0 = 16 * static_cast<int>(t % chunks);
    const int nv = min(16, batch - b0);
    const long long at = ((t / chunks) * batch + b0) * H;
    uint32_t xf[8], h[8];
    frag_load(xf, x + at, H, nv);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      bf16* out = part == 0 ? xkr : xks;
      if (out == nullptr) continue;
      float d[4][4];
      zero_acc(d);
      mma_awt(d, xf, s_k, KS, part * H);
      round_acc(h, d);
      frag_store(out + at, H, nv, h);
    }
  }
}

inline cudaError_t launch_partial(const bf16* x, bf16* xkr, bf16* xks, const float* w0,
                                  int n_nodes, int batch, cudaStream_t stream) {
  int grid = 0;
  const long long tiles = static_cast<long long>(n_nodes) * ((batch + 15) / 16);
  cudaError_t err = gn_nk::grid_for(reinterpret_cast<const void*>(gn_partial_tc_kernel),
                                    PARTIAL_TC_THREADS, 0, 32 * tiles, &grid);  // a warp a tile
  if (err != cudaSuccess) return err;
  gn_partial_tc_kernel<<<grid, PARTIAL_TC_THREADS, 0, stream>>>(x, xkr, xks, w0, n_nodes, batch);
  return cudaGetLastError();
}

}  // namespace gn_tile
