// Helpers shared by the GraphNetBlock backward kernels on the NK slot layout
// (fused_gnblock_nk_bwd.cu) and on the CSR layout (fused_gnblock_csr_bwd.cu):
// layer activations kept as packed bf16 pairs, the forward of one MLP that
// keeps them, the backward through an MLP in the JAX kernel's _mlp_bwd
// rounding, and the weight gradients reduced per warp in shared memory and
// per block into the global fp32 gradients.
//
// Weight gradients: a warp is 32 rows; each row's (activation, cotangent)
// pair is staged in a per-warp shared buffer, then lane o sums column o of
// the outer products over the 32 rows (one float4 broadcast feeds four
// FMAs) and adds the 32-row partial into a per-block fp32 accumulator in
// shared memory (one shared atomic per weight per layer per warp step).
// Each block adds its accumulators into the global fp32 gradients once, at
// its end. Every lane of a warp must call the staging helpers together, so
// the kernels run warp-uniform loops and give idle lanes zero cotangents.
#pragma once

#include "gn_nk_common.cuh"

namespace gn_bwd {

using namespace gn_nk;

constexpr int NL = 4;  // Dense layers per MLP the backward kernels are built for
// per warp: activations transposed [H][32], cotangents [32][H + 1]
constexpr int STAGE_G = H * 32;
constexpr int STAGE = H * 32 + 32 * (H + 1);

// the NL layer outputs of one MLP row (bf16 values, two to a register) and
// the RMSNorm's fp32 1 / (rms + eps)
struct Acts {
  uint32_t v[NL][H / 2];
  float inv;
};

// h must hold bf16 values: the packing keeps their upper halves
__device__ __forceinline__ void pack(uint32_t (&p)[H / 2], const float (&h)[H]) {
#pragma unroll
  for (int q = 0; q < H / 2; ++q)
    p[q] = (__float_as_uint(h[2 * q]) >> 16) | (__float_as_uint(h[2 * q + 1]) & 0xffff0000u);
}

__device__ __forceinline__ void unpack(float (&h)[H], const uint32_t (&p)[H / 2]) {
#pragma unroll
  for (int q = 0; q < H / 2; ++q) {
    h[2 * q] = __uint_as_float(p[q] << 16);
    h[2 * q + 1] = __uint_as_float(p[q] & 0xffff0000u);
  }
}

// sum_o g[o] * W[o] for one weight row in shared memory
__device__ __forceinline__ float dot_row(const float (&g)[H], const float* wrow) {
  const float4* w4 = reinterpret_cast<const float4*>(wrow);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 w = w4[q];
    s = fmaf(g[4 * q + 0], w.x, s);
    s = fmaf(g[4 * q + 1], w.y, s);
    s = fmaf(g[4 * q + 2], w.z, s);
    s = fmaf(g[4 * q + 3], w.w, s);
  }
  return s;
}

// Same as the forward's MLP, keeping every layer's output. h holds the
// fp32 first-layer product (no bias) and ends as the MLP's output.
__device__ __forceinline__ void mlp_fwd_keep(float (&h)[H], const float* w, int in_dim,
                                             bool norm, Acts& a) {
  const float* wl = w + in_dim * H;
  finish(h, h, wl);
  wl += H;
  pack(a.v[0], h);
#pragma unroll
  for (int l = 1; l < NL; ++l) {
    float acc[H];
    zero(acc);
#pragma unroll
    for (int i = 0; i < H; ++i) fma_row(acc, fmaxf(h[i], 0.f), wl + i * H);
    wl += H * H;
    finish(h, acc, wl);
    wl += H;
    pack(a.v[l], h);
  }
  a.inv = 1.f;
  if (norm) {
    float gs = 0.f;
#pragma unroll
    for (int o = 0; o < H; ++o) gs += bf(h[o] * h[o]);
    const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
    a.inv = 1.0f / (rms + 1e-8f);
    const float inv = bf(a.inv);
#pragma unroll
    for (int o = 0; o < H; ++o) h[o] = bf(bf(h[o] * inv) * wl[o]);
  }
}

// stage_cols writes each lane's cotangent row into the warp's buffer and
// hands lane o column o (gcol[l] = row l's value o); with ``sum_to`` it
// also adds the column sum (a bias or scale gradient).
__device__ __forceinline__ void stage_cols(float* st, const float (&g)[H], float (&gcol)[H],
                                           float* sum_to) {
  const int lane = threadIdx.x & 31;
  float* sg = st + STAGE_G;
#pragma unroll
  for (int o = 0; o < H; ++o) sg[lane * (H + 1) + o] = g[o];
  __syncwarp();
  float s = 0.f;
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    gcol[l] = sg[l * (H + 1) + lane];
    s += gcol[l];
  }
  __syncwarp();
  if (sum_to) atomicAdd(sum_to + lane, s);
}

// stage each lane's activation row transposed: st[i * 32 + lane]
__device__ __forceinline__ void stage_rows(float* st, const float (&a)[H]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < H; ++i) st[i * 32 + lane] = a[i];
  __syncwarp();
}

__device__ __forceinline__ void stage_rows_global(float* st, const __nv_bfloat16* src, int rows) {
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < rows; ++i) st[i * 32 + lane] = __bfloat162float(src[i]);
  __syncwarp();
}

// dW[i][o] += sum over the warp's 32 rows of a[i] * g[o], lane o owning
// column o; the staged activations are read as float4 broadcasts
__device__ __forceinline__ void outer(float* st, const float (&gcol)[H], int rows, float* dw) {
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < rows; ++i) {
    const float4* a4 = reinterpret_cast<const float4*>(st + i * 32);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = a4[q];
      s = fmaf(v.x, gcol[4 * q + 0], s);
      s = fmaf(v.y, gcol[4 * q + 1], s);
      s = fmaf(v.z, gcol[4 * q + 2], s);
      s = fmaf(v.w, gcol[4 * q + 3], s);
    }
    atomicAdd(dw + i * H + lane, s);
  }
  __syncwarp();
}

// Backward through the RMSNorm and layers NL-1..1 of one MLP (JAX
// _mlp_bwd). g: in, the cotangent at the MLP output; out, the cotangent at
// layer 0's output. gw: the MLP's gradient accumulators (w's layout).
__device__ __forceinline__ void mlp_bwd(float (&g)[H], const Acts& a, const float* w, float* gw,
                                        int in_dim, bool norm, float* st) {
  const int first = in_dim * H + H;  // layer 1's kernel
  float gcol[H];
  if (norm) {
    const int so = first + (NL - 1) * (H * H + H);
    float v[H];
    unpack(v, a.v[NL - 1]);
    const float invb = bf(a.inv);
    float gu[H], prod[H];
    float dot = 0.f;
#pragma unroll
    for (int o = 0; o < H; ++o) {
      prod[o] = bf(g[o] * bf(v[o] * invb));  // g * u, for the scale's gradient
      gu[o] = bf(g[o] * w[so + o]);
      dot += bf(gu[o] * v[o]);
    }
    stage_cols(st, prod, gcol, gw + so);
    const float rms = 1.0f / a.inv - 1e-8f;
    const float corr = bf(dot * (a.inv * a.inv) / (H * fmaxf(rms, 1e-30f)));
#pragma unroll
    for (int o = 0; o < H; ++o) g[o] = bf(bf(gu[o] * invb) - bf(v[o] * corr));
  }
#pragma unroll
  for (int l = NL - 1; l >= 1; --l) {
    const int off = first + (l - 1) * (H * H + H);
    float act[H];
    unpack(act, a.v[l - 1]);
#pragma unroll
    for (int i = 0; i < H; ++i) act[i] = fmaxf(act[i], 0.f);
    stage_cols(st, g, gcol, gw + off + H * H);  // bias l
    stage_rows(st, act);
    outer(st, gcol, H, gw + off);  // kernel l
    float ng[H];
#pragma unroll
    for (int i = 0; i < H; ++i) ng[i] = dot_row(g, w + off + i * H);
#pragma unroll
    for (int i = 0; i < H; ++i) g[i] = act[i] > 0.f ? bf(ng[i]) : 0.f;
  }
}

// The node MLP's backward on one (node, sample) row: x (its row in device
// memory) and the bf16 aggregate agg are the MLP's input, g_xout_row the
// cotangent of x_out (zero on an idle lane). Stages the MLP's weight
// gradients into g_node (warp-collective) and returns gx = g_xout + the x
// part of the input gradient and ga = the aggregate's cotangent, each
// part rounded to bf16.
__device__ __forceinline__ void node_mlp_bwd(float (&gx)[H], float (&ga)[H],
                                             const __nv_bfloat16* xr, const float (&agg)[H],
                                             const __nv_bfloat16* g_xout_row, bool active,
                                             const float* s_node, float* g_node, bool norm,
                                             float* st) {
  float g[H];
  zero(g);
  fma_global_row(g, xr, s_node);
#pragma unroll
  for (int i = 0; i < H; ++i) fma_row(g, agg[i], s_node + (H + i) * H);
  Acts acts;
  mlp_fwd_keep(g, s_node, 2 * H, norm, acts);
  if (active)
    load_row(g, g_xout_row);
  else
    zero(g);
  mlp_bwd(g, acts, s_node, g_node, 2 * H, norm, st);
  float gcol[H];
  stage_cols(st, g, gcol, g_node + 2 * H * H);  // bias 0
  stage_rows_global(st, xr, H);
  outer(st, gcol, H, g_node);  // kernel 0, x rows
  stage_rows(st, agg);
  outer(st, gcol, H, g_node + H * H);  // kernel 0, agg rows
  load_row(gx, g_xout_row);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    gx[i] += bf(dot_row(g, s_node + i * H));
    ga[i] = bf(dot_row(g, s_node + (H + i) * H));
  }
}

// Backward through the folded encoder of one raw row, from the cotangent
// ``de`` at its output: the encoder's weight gradients (the raw features
// take none). Warp-collective.
__device__ __forceinline__ void encoder_bwd(float (&de)[H], const __nv_bfloat16* raw, int fe,
                                            const float* s_enc, float* g_enc, bool norm,
                                            float* st) {
  float h[H];
  enc_first(h, raw, fe, s_enc);
  Acts acts;
  mlp_fwd_keep(h, s_enc, fe, norm, acts);
  mlp_bwd(de, acts, s_enc, g_enc, fe, norm, st);
  float gcol[H];
  stage_cols(st, de, gcol, g_enc + fe * H);  // bias 0
  stage_rows_global(st, raw, fe);
  outer(st, gcol, fe, g_enc);  // kernel 0
}

// add a staged gradient MLP (w's layout, [in][out]) into the global fp32
// gradients ([out, in] kernels)
__device__ inline void flush_mlp(const float* src, const Mlp& g) {
  for (int l = 0; l < g.n_layers; ++l) {
    const int rows = l == 0 ? g.in_dim : H;
    float* w = const_cast<float*>(g.w[l]);
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x)
      atomicAdd(w + (i % H) * rows + i / H, src[i]);
    src += rows * H;
    float* b = const_cast<float*>(g.b[l]);
    for (int o = threadIdx.x; o < H; o += blockDim.x) atomicAdd(b + o, src[o]);
    src += H;
  }
  if (g.scale) {
    float* s = const_cast<float*>(g.scale);
    for (int o = threadIdx.x; o < H; o += blockDim.x) atomicAdd(s + o, src[o]);
  }
}

// a weight MLP and its gradient MLP of NL layers from the two pointer lists,
// with norms on both or on neither
inline bool make_mlp_pair(Mlp* w, Mlp* g, const void* const* wp, const void* const* gp,
                          int n_layers, int in_dim) {
  return n_layers == NL && make_mlp(w, wp, NL, in_dim) && make_mlp(g, gp, NL, in_dim) &&
         (w->scale == nullptr) == (g->scale == nullptr);
}

}  // namespace gn_bwd
