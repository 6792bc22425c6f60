// Fused GraphNetBlock backward on the uniform-degree ("NK") slot layout,
// for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock_nk.py:
// _nk_bwd_kernel (:189) and the sender-side segment_sum of its wrapper
// (run_bwd, :694-699). Given the block's inputs (x, e) and the cotangents
// g_xout (and g_eout unless it is the last block), it rematerializes the
// forward of fused_gnblock_nk.cu and returns
//   dx  = g_xout + NodeMLP'ᵀ g_xout [x part] + P_r·Krᵀ + Σ_{slots with sender j} g_h0·Ksᵀ
//   de  = g_e_mlp + g_eout on every slot (the edge-stream cotangent), or,
//         when the edge encoder is folded in, the encoder's backward on it
//   and fp32 gradients of every Dense kernel, bias and RMSNorm scale of the
//   edge, node and (folded) encoder MLPs, summed over all slots x samples.
// g_h0 is the cotangent at the edge MLP's first-layer output; P_r = Σ_k g_h0
// over a receiver's K slots; Kr / Ks are the receiver / sender rows of the
// edge MLP's first Dense kernel. The numeric flow is the JAX kernel's
// _mlp_bwd: bf16 values between layers, fp32 dot accumulation, the RMSNorm
// VJP in the same rounding steps.
//
// What bounds it on this card: per valid slot the backward does about 3.5x
// the forward's multiply-adds (the edge MLP forward twice, once for the
// aggregate and once to keep its activations; the cotangent through 4
// layers; the weight-gradient outer products), ~22k FMAs a slot against
// ~256 bytes of row traffic, so like the forward it would be bound by fp32 FMA
// throughput on the CUDA cores (~66 GFLOP per cylinder block, ~1 ms at the
// 67 TFLOP/s peak). The weight gradients are the hard part: on the TPU the
// grid runs in order and carries them in scratch; here blocks run in
// parallel. Measured on an H100 80GB HBM3 at 700 W: 7.9 ms per middle
// block at B=128 (~8.4 TFLOP/s, 12.5% of that peak). The thread needs 255
// registers and spills ~0.9 KB, and the block's shared memory allows one
// block of 8 warps per SM, too few warps to hide shared-memory and FMA
// latency. Of the 7.9 ms, the weight-gradient products take 1.7, the
// aggregate's recomputation 1.0 and the sender atomics 0.7.
//
// What the design does about it, in this first version:
//   * one thread per (receiver, sample), as in the forward: the K-sums
//     (agg, P_r) stay in registers, no atomics;
//   * layer activations are kept packed as bf16 pairs in registers (they
//     are bf16 values, so the packing is exact): 64 registers an MLP;
//   * weight gradients: a warp is 32 rows; each row's (activation,
//     cotangent) pair is staged in a per-warp shared buffer, then lane o
//     sums column o of the outer products over the 32 rows (one float4
//     broadcast feeds four FMAs) and adds the 32-row partial into a
//     per-block fp32 accumulator in shared memory (one shared atomic per
//     weight per layer per warp step). Each block adds its accumulators
//     into the global fp32 gradients once, at its end (~15k global atomics
//     a block);
//   * the sender-side transpose: each valid slot adds g_h0·Ksᵀ into an fp32
//     [N, B, H] dx accumulator with global atomics; padded slots skip it.
//     The receiver side and g_xout go into the same accumulator, which the
//     wrapper rounds to bf16;
//   * the edge mask is applied as a zero cotangent, so every lane of a warp
//     runs the same code and the warp-level outer products need no masks.
// Weights (~60 KB), gradient accumulators (~60 KB) and the per-warp stage
// buffers (8 warps x 8.3 KB) take ~185 KB of shared memory: one block of
// 256 threads per SM. Tensor cores are left to later versions.

#include "gn_nk_common.cuh"

using namespace gn_nk;

namespace {

constexpr int NL = 4;  // Dense layers per MLP the backward is built for
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// per warp: activations transposed [H][32], cotangents [32][H + 1]
constexpr int STAGE_G = H * 32;
constexpr int STAGE = H * 32 + 32 * (H + 1);

struct Args {
  const __nv_bfloat16* x;       // [N, B, H]
  const __nv_bfloat16* e;       // [S, B, H], or raw [S, B, fe] when folded
  const __nv_bfloat16* g_xout;  // [N, B, H]
  const __nv_bfloat16* g_eout;  // [S, B, H]; null on the last block
  float* dx;                    // [N, B, H] fp32, zeroed; accumulated with atomics
  __nv_bfloat16* de;            // [S, B, H]; null when folded
  const int32_t* senders;       // [S] global sender per slot (0 on padding)
  const uint8_t* mask;          // [S] 1 on valid slots
  int n_nodes, batch, k_slots, node_block, fe;
  Mlp enc, edge, node;     // weights
  Mlp genc, gedge, gnode;  // their gradients: same shapes, fp32, zeroed
};

// the NL layer outputs of one MLP row (bf16 values, two to a register) and
// the RMSNorm's fp32 1 / (rms + eps)
struct Acts {
  uint32_t v[NL][H / 2];
  float inv;
};

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

// Warp-level gradient staging. Every lane of the warp must call these
// together. stage_cols writes each lane's cotangent row into the warp's
// buffer and hands lane o column o (gcol[l] = row l's value o); with
// ``sum_to`` it also adds the column sum (a bias or scale gradient).
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

// the folded edge encoder's first-layer product on one raw row
__device__ __forceinline__ void enc_first(float (&acc)[H], const __nv_bfloat16* raw, int fe,
                                          const float* s_enc) {
  zero(acc);
  for (int i = 0; i < fe; ++i) fma_row(acc, __bfloat162float(raw[i]), s_enc + i * H);
}

// add a staged gradient MLP (w's layout, [in][out]) into the global fp32
// gradients ([out, in] kernels)
__device__ void flush_mlp(const float* src, const Mlp& g) {
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

__global__ void __launch_bounds__(THREADS, 1) gn_nk_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const bool fold = a.fe > 0;
  const int n_enc = fold ? mlp_floats(a.enc) : 0;
  const int n_edge = mlp_floats(a.edge), n_node = mlp_floats(a.node);
  float* s_enc = smem;
  float* s_edge = s_enc + n_enc;
  float* s_node = s_edge + n_edge;
  float* g_enc = s_node + n_node;
  float* g_edge = g_enc + n_enc;
  float* g_node = g_edge + n_edge;
  float* st = g_node + n_node + (threadIdx.x / 32) * STAGE;
  if (fold) stage_mlp(s_enc, a.enc);
  stage_mlp(s_edge, a.edge);
  stage_mlp(s_node, a.node);
  for (int i = threadIdx.x; i < n_enc + n_edge + n_node; i += blockDim.x) g_enc[i] = 0.f;
  __syncthreads();

  const int B = a.batch, K = a.k_slots, nb = a.node_block, fe = a.fe;
  const bool enc_norm = a.enc.scale != nullptr;
  const bool edge_norm = a.edge.scale != nullptr;
  const bool node_norm = a.node.scale != nullptr;
  const long long total = static_cast<long long>(a.n_nodes) * B;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;

  // warp-uniform loop: lanes past the end compute on the last row with
  // zero cotangents and write nothing
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
       base < total; base += stride) {
    const long long t0 = base + lane;
    const bool active = t0 < total;
    const long long t = active ? t0 : total - 1;
    const int r = static_cast<int>(t / B);
    const int b = static_cast<int>(t % B);
    const long long slot0 = static_cast<long long>(r / nb) * K * nb + r % nb;
    const __nv_bfloat16* xr = a.x + t * H;

    // ---- rematerialize the aggregate (forward of the edge MLP) ----
    float agg[H];
    zero(agg);
    for (int k = 0; k < K; ++k) {
      const long long s = slot0 + static_cast<long long>(k) * nb;
      if (!a.mask[s]) continue;
      const long long row = s * B + b;
      float acc[H];
      zero(acc);
      if (fold) {
        float ein[H];
        enc_first(acc, a.e + row * fe, fe, s_enc);
        finish(ein, acc, s_enc + fe * H);
        mlp_tail(ein, s_enc + fe * H + H, a.enc.n_layers, enc_norm);
        zero(acc);
#pragma unroll
        for (int i = 0; i < H; ++i) fma_row(acc, ein[i], s_edge + i * H);
      } else {
        fma_global_row(acc, a.e + row * H, s_edge);
      }
      fma_global_row(acc, xr, s_edge + H * H);
      fma_global_row(acc, a.x + (static_cast<long long>(a.senders[s]) * B + b) * H,
                     s_edge + 2 * H * H);
      float h[H];
      finish(h, acc, s_edge + 3 * H * H);
      mlp_tail(h, s_edge + 3 * H * H + H, a.edge.n_layers, edge_norm);
#pragma unroll
      for (int o = 0; o < H; ++o) agg[o] += h[o];
    }
#pragma unroll
    for (int o = 0; o < H; ++o) agg[o] = bf(agg[o]);

    // ---- node MLP: forward with activations, then backward ----
    uint32_t g_agg[H / 2];
    {
      float g[H];
      zero(g);
      fma_global_row(g, xr, s_node);
#pragma unroll
      for (int i = 0; i < H; ++i) fma_row(g, agg[i], s_node + (H + i) * H);
      Acts acts;
      mlp_fwd_keep(g, s_node, 2 * H, node_norm, acts);
      if (active)
        load_row(g, a.g_xout + t * H);
      else
        zero(g);
      mlp_bwd(g, acts, s_node, g_node, 2 * H, node_norm, st);
      float gcol[H];
      stage_cols(st, g, gcol, g_node + 2 * H * H);  // bias 0
      stage_rows_global(st, xr, H);
      outer(st, gcol, H, g_node);  // kernel 0, x rows
      stage_rows(st, agg);
      outer(st, gcol, H, g_node + H * H);  // kernel 0, agg rows
      float gx[H], ga[H];
      load_row(gx, a.g_xout + t * H);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        gx[i] += bf(dot_row(g, s_node + i * H));
        ga[i] = bf(dot_row(g, s_node + (H + i) * H));
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < H; ++i) atomicAdd(a.dx + t * H + i, gx[i]);
      }
      pack(g_agg, ga);
    }

    // ---- edge MLP backward, slot by slot ----
    float p_r[H];
    zero(p_r);
    for (int k = 0; k < K; ++k) {
      const long long s = slot0 + static_cast<long long>(k) * nb;
      const long long row = s * B + b;
      const bool valid = active && a.mask[s];
      const long long srow = static_cast<long long>(a.senders[s]) * B + b;
      uint32_t ein_p[H / 2];
      float g[H];
      {
        float ein[H];
        if (fold) {
          enc_first(g, a.e + row * fe, fe, s_enc);
          finish(ein, g, s_enc + fe * H);
          mlp_tail(ein, s_enc + fe * H + H, a.enc.n_layers, enc_norm);
        } else {
          load_row(ein, a.e + row * H);
        }
        pack(ein_p, ein);
        zero(g);
#pragma unroll
        for (int i = 0; i < H; ++i) fma_row(g, ein[i], s_edge + i * H);
      }
      fma_global_row(g, xr, s_edge + H * H);
      fma_global_row(g, a.x + srow * H, s_edge + 2 * H * H);
      Acts acts;
      mlp_fwd_keep(g, s_edge, 3 * H, edge_norm, acts);
      // d(ehm) = ktile(g_agg) + g_eout, zero on padded slots
      float geo[H];
      if (a.g_eout && active)
        load_row(geo, a.g_eout + row * H);
      else
        zero(geo);
      unpack(g, g_agg);
#pragma unroll
      for (int o = 0; o < H; ++o) g[o] = valid ? bf(g[o] + geo[o]) : 0.f;
      mlp_bwd(g, acts, s_edge, g_edge, 3 * H, edge_norm, st);
      {
        float gcol[H];
        stage_cols(st, g, gcol, g_edge + 3 * H * H);  // bias 0
        float ein[H];
        unpack(ein, ein_p);
        stage_rows(st, ein);
        outer(st, gcol, H, g_edge);  // kernel 0, edge rows
        stage_rows_global(st, a.x + srow * H, H);
        outer(st, gcol, H, g_edge + 2 * H * H);  // kernel 0, sender rows
      }
#pragma unroll
      for (int o = 0; o < H; ++o) p_r[o] += g[o];
      if (valid) {  // sender side: dx[j] += g_h0 · Ksᵀ
#pragma unroll
        for (int i = 0; i < H; ++i)
          atomicAdd(a.dx + srow * H + i, dot_row(g, s_edge + (2 * H + i) * H));
      }
      // the edge-stream cotangent, on every slot
      float de[H];
      if (a.g_eout && active) load_row(geo, a.g_eout + row * H);
#pragma unroll
      for (int i = 0; i < H; ++i) de[i] = bf(bf(dot_row(g, s_edge + i * H)) + geo[i]);
      if (!fold) {
        if (active) store_row(a.de + row * H, de);
      } else {  // through the folded encoder; raw features take no gradient
        const __nv_bfloat16* raw = a.e + row * fe;
        enc_first(g, raw, fe, s_enc);
        Acts eacts;
        mlp_fwd_keep(g, s_enc, fe, enc_norm, eacts);
        mlp_bwd(de, eacts, s_enc, g_enc, fe, enc_norm, st);
        float gcol[H];
        stage_cols(st, de, gcol, g_enc + fe * H);  // bias 0
        stage_rows_global(st, raw, fe);
        outer(st, gcol, fe, g_enc);  // kernel 0
      }
    }

    // ---- receiver side: dKr += x_r ⊗ P_r, dx += P_r · Krᵀ ----
#pragma unroll
    for (int o = 0; o < H; ++o) p_r[o] = bf(p_r[o]);
    {
      float gcol[H];
      stage_cols(st, p_r, gcol, nullptr);
      stage_rows_global(st, xr, H);
      outer(st, gcol, H, g_edge + H * H);
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < H; ++i)
        atomicAdd(a.dx + t * H + i, bf(dot_row(p_r, s_edge + (H + i) * H)));
    }
  }

  __syncthreads();
  if (fold) flush_mlp(g_enc, a.genc);
  flush_mlp(g_edge, a.gedge);
  flush_mlp(g_node, a.gnode);
}

}  // namespace

// Weight and gradient lists hold 2 * n_layers + 1 pointers each: w0, b0,
// w1, b1, ..., then the RMSNorm scale (null without a norm); gradients are
// fp32, shaped like their weights, and zeroed by the caller, as is dx.
// fe > 0 folds the edge encoder in (e is the raw [S, B, fe] array, de is
// null); g_eout null marks the last block. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int gn_nk_bwd(const void* x, const void* e, const void* g_xout, const void* g_eout,
                         void* dx, void* de, const void* senders, const void* mask, int n_nodes,
                         int batch, int k_slots, int node_block, int fe,
                         const void* const* enc_w, const void* const* enc_g, int n_enc_layers,
                         const void* const* edge_w, const void* const* edge_g, int n_edge_layers,
                         const void* const* node_w, const void* const* node_g, int n_node_layers,
                         void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.e = static_cast<const __nv_bfloat16*>(e);
  a.g_xout = static_cast<const __nv_bfloat16*>(g_xout);
  a.g_eout = static_cast<const __nv_bfloat16*>(g_eout);
  a.dx = static_cast<float*>(dx);
  a.de = static_cast<__nv_bfloat16*>(de);
  a.senders = static_cast<const int32_t*>(senders);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.k_slots = k_slots;
  a.node_block = node_block;
  a.fe = fe;
  const bool fold = fe > 0;
  const bool ok =
      (!fold || (n_enc_layers == NL && fe <= H && make_mlp(&a.enc, enc_w, NL, fe) &&
                 make_mlp(&a.genc, enc_g, NL, fe) && (a.enc.scale == nullptr) == (a.genc.scale == nullptr))) &&
      n_edge_layers == NL && n_node_layers == NL && make_mlp(&a.edge, edge_w, NL, 3 * H) &&
      make_mlp(&a.gedge, edge_g, NL, 3 * H) && make_mlp(&a.node, node_w, NL, 2 * H) &&
      make_mlp(&a.gnode, node_g, NL, 2 * H) &&
      (a.edge.scale == nullptr) == (a.gedge.scale == nullptr) &&
      (a.node.scale == nullptr) == (a.gnode.scale == nullptr) && (de == nullptr) == fold &&
      n_nodes >= 1 && batch >= 1 && k_slots >= 1 && node_block >= 1 && n_nodes % node_block == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  const size_t smem = sizeof(float) * (2 * ((fold ? mlp_floats(a.enc) : 0) + mlp_floats(a.edge) +
                                            mlp_floats(a.node)) +
                                       WARPS * STAGE);
  cudaError_t err = cudaFuncSetAttribute(gn_nk_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_nk_bwd_kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long total = static_cast<long long>(n_nodes) * batch;
  const long long need = (total + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(need < cap ? need : cap);
  gn_nk_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
