// Fused GraphNetBlock backward on the receiver-sorted CSR edge layout, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock.py:
// _bwd_kernel (:453), called by the custom VJP of fused_gn_block
// (pallas_call :1053), without the lane tiling, the sender windows and the
// extra_agg cotangent. Given the block's inputs (x, e), the aggregate its
// forward (fused_gnblock_csr.cu) kept and the cotangents g_xout (and g_eout
// unless it is the last block), it rematerializes the rest of that forward
// and returns
//   dx  = bf16(bf16(bf16(g_xout + NodeMLP'ᵀ g_xout [x part]) + bf16(P_r·Krᵀ))
//             + bf16(P_s·Ksᵀ))
//   de  = g_e_mlp + g_eout on the rows of a receiver's range, g_eout on the
//         padding rows (their e_out is e_in), or, when the edge encoder is
//         folded in, the encoder's backward on that cotangent
//   and fp32 gradients of every Dense kernel, bias and RMSNorm scale of the
//   edge, node and (folded) encoder MLPs, summed over all rows x samples.
// g_h0 is the cotangent at the edge MLP's first-layer output (zero on
// masked rows); P_r and P_s are its sums over a node's receiver rows and
// over its sender rows, each rounded to bf16; Kr / Ks are the receiver /
// sender rows of the edge MLP's first Dense kernel. As in the JAX kernel
// (:534-546, :585-591) the scatter is commuted through Kr and Ks: their
// gradients are the node-sized products Σ x ⊗ P_r and Σ x ⊗ P_s, and the
// sender part of dx is one H x H product per (node, sample), not one per
// edge. The numeric flow is the JAX kernel's _mlp_bwd (gn_bwd_common.cuh).
//
// What bounds it on this card: per valid row the backward does about 2.5x
// the forward's multiply-adds (the edge MLP forward, keeping its
// activations; the cotangent through 4 layers; the weight-gradient outer
// products), ~15k FMAs a row against ~256 bytes of row traffic (e, g_eout
// read, de and g_h0 written). On the graded airfoil-sized slice (27,008
// receivers x 16 samples, 160,612 edges) that is ~80 GFLOP against ~0.7 GB:
// bound by fp32 FMA throughput on the CUDA cores (~1.2 ms at 67 TFLOP/s),
// ~0.2 ms of HBM traffic.
//
// What the design does about it, in this first version: the forward's
// node pre-pass (gn_nk_common.cuh), run twice, writes bf16(x @ Kr) and
// bf16(x @ Ks) per (node, sample); then three kernels, and no atomics on
// dx or de:
//  1. node-MLP pass, one thread per (node, sample): the node MLP's
//     backward from g_xout and the aggregate the forward kept (27.6 MB a
//     block on the graded slice; recomputing it took 16 of an earlier
//     version's 39 ms on the card, PERF.md §6). It writes dx's node-MLP
//     part and the aggregate's cotangent g_agg [N, B, H] (bf16);
//  2. row pass, one thread per (row, sample) of every row, padding rows
//     included: the edge MLP (and folded encoder) forward with activations
//     kept, its backward from g_agg of the row's receiver plus g_eout, de,
//     and g_h0 to a bf16 scratch [S, B, H]. Consecutive threads take
//     consecutive samples of one row, so every row access of a warp is
//     contiguous, and no thread waits on a longer row range than its own:
//     a receiver-major version of this pass (one thread per (receiver,
//     sample) walking the receiver's rows, as the NK backward does) took
//     2.7x as long on the card (PERF.md §6), most likely latency-bound on
//     its loop-carried registers and its warps' longest ranges;
//  3. sender pass, one thread per (node, sample): sums P_r over the node's
//     own rows of the scratch and P_s over the rows it sends on, in a
//     sender-sorted row list (the transpose of the CSR rows, built once
//     per layout by the wrapper), both in fp32; adds bf16(P_r·Krᵀ) and
//     bf16(P_s·Ksᵀ) to its own dx and stages x ⊗ P_r and x ⊗ P_s for dKr
//     and dKs.
// Passes 1 and 2 share the NK backward's register-packed activations and
// warp-staged weight gradients (gn_bwd_common.cuh): the staging is
// warp-collective, so idle lanes carry zero cotangents. Pass 2 keeps the
// edge (and encoder) weights, their gradient accumulators and the per-warp
// stage buffers (8 warps x 8.3 KB) in shared memory: one block of 256
// threads per SM. Tensor cores are left to later versions.

#include "gn_bwd_common.cuh"

using namespace gn_nk;
using namespace gn_bwd;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEND_THREADS = 128;
constexpr int SEND_WARPS = SEND_THREADS / 32;

struct Args {
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
  const int32_t* row_ptr;       // [N + 1] receiver r owns rows row_ptr[r]:row_ptr[r+1]
  const int32_t* senders;       // [S] sender per row (0 on padding)
  const int32_t* receivers;     // [S] receiver per row (N-1 on padding)
  const uint8_t* mask;          // [S] 1 on valid rows
  const int32_t* order;         // the valid rows sorted by sender
  const int32_t* offsets;       // [N + 1] node j sends on order[offsets[j]:offsets[j+1]]
  int n_nodes, batch, total_rows, fe;
  Mlp enc, edge, node;     // weights
  Mlp genc, gedge, gnode;  // their gradients: same shapes, fp32, zeroed
};

// The edge MLP's first-layer sum on one row before its bias, in the
// forward's order: the fp32 product e_in @ Ke, then the bf16 node partials
// x_r @ Kr and x_j @ Ks (the pre-passes' rows).
__device__ __forceinline__ void first_layer(float (&acc)[H], const float (&ein)[H],
                                            const __nv_bfloat16* xkr_row,
                                            const __nv_bfloat16* xks_row, const float* s_edge) {
  zero(acc);
#pragma unroll
  for (int i = 0; i < H; ++i) fma_row(acc, ein[i], s_edge + i * H);
  float xp[H];
  load_row(xp, xkr_row);
#pragma unroll
  for (int o = 0; o < H; ++o) acc[o] += xp[o];
  load_row(xp, xks_row);
#pragma unroll
  for (int o = 0; o < H; ++o) acc[o] += xp[o];
}

// the node MLP's backward, one thread per (node, sample): dx's node-MLP
// part and the aggregate's cotangent g_agg
__global__ void __launch_bounds__(THREADS, 1) gn_csr_bwd_nodemlp_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int n_node = mlp_floats(a.node);
  float* s_node = smem;
  float* g_node = s_node + n_node;
  float* st = g_node + n_node + (threadIdx.x / 32) * STAGE;
  stage_mlp(s_node, a.node);
  for (int i = threadIdx.x; i < n_node; i += blockDim.x) g_node[i] = 0.f;
  __syncthreads();
  const bool node_norm = a.node.scale != nullptr;
  const long long total = static_cast<long long>(a.n_nodes) * a.batch;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
       base < total; base += stride) {
    const long long t0 = base + lane;
    const bool active = t0 < total;
    const long long t = active ? t0 : total - 1;
    const __nv_bfloat16* xr = a.x + t * H;
    float agg[H];
    load_row(agg, a.agg + t * H);
    float gx[H], ga[H];
    node_mlp_bwd(gx, ga, xr, agg, a.g_xout + t * H, active, s_node, g_node, node_norm, st);
    if (active) {
      store_row(a.dx + t * H, gx);  // finished by the sender pass
      store_row(a.gagg + t * H, ga);
    }
  }
  __syncthreads();
  flush_mlp(g_node, a.gnode);
}

// the edge MLP's (and folded encoder's) backward, one thread per (row,
// sample) of every row, the padding rows included: g_h0 and de
__global__ void __launch_bounds__(THREADS, 1) gn_csr_bwd_row_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const bool fold = a.fe > 0;
  const int n_enc = fold ? mlp_floats(a.enc) : 0;
  const int n_edge = mlp_floats(a.edge);
  float* s_enc = smem;
  float* s_edge = s_enc + n_enc;
  float* g_enc = s_edge + n_edge;
  float* g_edge = g_enc + n_enc;
  float* st = g_edge + n_edge + (threadIdx.x / 32) * STAGE;
  if (fold) stage_mlp(s_enc, a.enc);
  stage_mlp(s_edge, a.edge);
  for (int i = threadIdx.x; i < n_enc + n_edge; i += blockDim.x) g_enc[i] = 0.f;
  __syncthreads();
  const int B = a.batch, fe = a.fe;
  const bool enc_norm = a.enc.scale != nullptr;
  const bool edge_norm = a.edge.scale != nullptr;
  const long long pad0 = a.row_ptr[a.n_nodes];
  const long long total = static_cast<long long>(a.total_rows) * B;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
       base < total; base += stride) {
    const long long i0 = base + lane;
    const bool in = i0 < total;
    const long long row = in ? i0 : total - 1;
    const long long s = row / B;
    const int b = static_cast<int>(row % B);
    const bool ranged = s < pad0;  // a row of some receiver's range
    const bool valid = in && ranged && a.mask[s];
    const long long r = a.receivers[s];
    uint32_t ein_p[H / 2];
    float g[H];
    {
      float ein[H];
      if (fold)
        encode(ein, a.e + row * fe, fe, s_enc, a.enc.n_layers, enc_norm);
      else
        load_row(ein, a.e + row * H);
      pack(ein_p, ein);
      first_layer(g, ein, a.xkr + (r * B + b) * H,
                  a.xks + (static_cast<long long>(a.senders[s]) * B + b) * H, s_edge);
    }
    Acts acts;
    mlp_fwd_keep(g, s_edge, 3 * H, edge_norm, acts);
    float geo[H];
    if (a.g_eout && in)
      load_row(geo, a.g_eout + row * H);
    else
      zero(geo);
    load_row(g, a.gagg + (r * B + b) * H);
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
    }
    if (in && ranged) store_row(a.gh0 + row * H, g);
    float de[H];
#pragma unroll
    for (int i = 0; i < H; ++i) de[i] = bf(bf(dot_row(g, s_edge + i * H)) + geo[i]);
    if (!fold) {
      if (in) store_row(a.de + row * H, de);
    } else {
      encoder_bwd(de, a.e + row * fe, fe, s_enc, g_enc, enc_norm, st);
    }
  }
  __syncthreads();
  if (fold) flush_mlp(g_enc, a.genc);
  flush_mlp(g_edge, a.gedge);
}

// P_r and P_s, dx's receiver and sender parts, dKr and dKs, one thread per
// (node, sample)
__global__ void __launch_bounds__(SEND_THREADS) gn_csr_bwd_send_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* s_kr = smem;          // Kr as [in][out], bf16 values
  float* s_ks = s_kr + H * H;  // Ks
  float* g_kr = s_ks + H * H;  // the block's dKr, [in][out]
  float* g_ks = g_kr + H * H;  // the block's dKs
  float* st = g_ks + H * H + (threadIdx.x / 32) * STAGE;
  const float* w0 = a.edge.w[0];  // nn.Linear [H, 3H]
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    const int r = i / H, o = i % H;
    s_kr[i] = bf(w0[o * 3 * H + H + r]);
    s_ks[i] = bf(w0[o * 3 * H + 2 * H + r]);
    g_kr[i] = g_ks[i] = 0.f;
  }
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
      for (int s = a.row_ptr[j]; s < a.row_ptr[j + 1]; ++s) {  // j's own rows
        load_row(g, a.gh0 + (static_cast<long long>(s) * B + b) * H);
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
      float gcol[H];
      stage_rows_global(st, a.x + t * H, H);
      stage_cols(st, p_r, gcol, nullptr);
      outer(st, gcol, H, g_kr);
      stage_cols(st, p_s, gcol, nullptr);
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
  float* gw0 = const_cast<float*>(a.gedge.w[0]);
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    atomicAdd(gw0 + (i % H) * 3 * H + H + i / H, g_kr[i]);
    atomicAdd(gw0 + (i % H) * 3 * H + 2 * H + i / H, g_ks[i]);
  }
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.n_nodes) * a.batch;
  int grid = 0;
  cudaError_t err = grid_for(reinterpret_cast<const void*>(gn_csr_partial_kernel),
                             PARTIAL_THREADS, 0, rows, &grid);
  if (err != cudaSuccess) return err;
  gn_csr_partial_kernel<<<grid, PARTIAL_THREADS, 0, stream>>>(  // x @ Kr
      a.x, const_cast<__nv_bfloat16*>(a.xkr), a.edge.w[0], rows, H);
  gn_csr_partial_kernel<<<grid, PARTIAL_THREADS, 0, stream>>>(  // x @ Ks
      a.x, const_cast<__nv_bfloat16*>(a.xks), a.edge.w[0], rows, 2 * H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const bool fold = a.fe > 0;
  const size_t nsmem = sizeof(float) * (2 * mlp_floats(a.node) + WARPS * STAGE);
  err = cudaFuncSetAttribute(gn_csr_bwd_nodemlp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(nsmem));
  if (err != cudaSuccess) return err;
  err = grid_for(reinterpret_cast<const void*>(gn_csr_bwd_nodemlp_kernel), THREADS, nsmem, rows,
                 &grid);
  if (err != cudaSuccess) return err;
  gn_csr_bwd_nodemlp_kernel<<<grid, THREADS, nsmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t rsmem = sizeof(float) * (2 * ((fold ? mlp_floats(a.enc) : 0) + mlp_floats(a.edge)) +
                                        WARPS * STAGE);
  err = cudaFuncSetAttribute(gn_csr_bwd_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(rsmem));
  if (err != cudaSuccess) return err;
  const long long work = static_cast<long long>(a.total_rows) * a.batch;
  err = grid_for(reinterpret_cast<const void*>(gn_csr_bwd_row_kernel), THREADS, rsmem, work, &grid);
  if (err != cudaSuccess) return err;
  gn_csr_bwd_row_kernel<<<grid, THREADS, rsmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t send_smem = sizeof(float) * (4 * H * H + SEND_WARPS * STAGE);
  err = cudaFuncSetAttribute(gn_csr_bwd_send_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(send_smem));
  if (err != cudaSuccess) return err;
  err = grid_for(reinterpret_cast<const void*>(gn_csr_bwd_send_kernel), SEND_THREADS, send_smem,
                 rows, &grid);
  if (err != cudaSuccess) return err;
  gn_csr_bwd_send_kernel<<<grid, SEND_THREADS, send_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Weight and gradient lists hold 2 * n_layers + 1 pointers each: w0, b0,
// w1, b1, ..., then the RMSNorm scale (null without a norm); gradients are
// fp32, shaped like their weights, and zeroed by the caller. agg is the
// bf16 aggregate [n_nodes, batch, 32] the forward kept. fe > 0 folds
// the edge encoder in (e is the raw [S, B, fe] array, de is null); g_eout
// null marks the last block. xkr, xks, gagg [n_nodes, batch, 32] and gh0
// [total_rows, batch, 32] are bf16 scratch; order and offsets (int32) are
// the valid rows sorted by sender and each node's range in them. Returns
// the CUDA error code of the launches (0 on success).
extern "C" int gn_csr_bwd(const void* x, const void* e, const void* agg, const void* g_xout,
                          const void* g_eout, void* dx, void* de, void* xkr, void* xks,
                          void* gagg, void* gh0, const void* row_ptr, const void* senders,
                          const void* receivers, const void* mask, const void* order,
                          const void* offsets, int n_nodes, int batch, int total_rows, int fe,
                          const void* const* enc_w, const void* const* enc_g, int n_enc_layers,
                          const void* const* edge_w, const void* const* edge_g,
                          int n_edge_layers, const void* const* node_w,
                          const void* const* node_g, int n_node_layers, void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.e = static_cast<const __nv_bfloat16*>(e);
  a.xkr = static_cast<const __nv_bfloat16*>(xkr);
  a.xks = static_cast<const __nv_bfloat16*>(xks);
  a.agg = static_cast<const __nv_bfloat16*>(agg);
  a.g_xout = static_cast<const __nv_bfloat16*>(g_xout);
  a.g_eout = static_cast<const __nv_bfloat16*>(g_eout);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.de = static_cast<__nv_bfloat16*>(de);
  a.gh0 = static_cast<__nv_bfloat16*>(gh0);
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.senders = static_cast<const int32_t*>(senders);
  a.receivers = static_cast<const int32_t*>(receivers);
  a.gagg = static_cast<__nv_bfloat16*>(gagg);
  a.mask = static_cast<const uint8_t*>(mask);
  a.order = static_cast<const int32_t*>(order);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.total_rows = total_rows;
  a.fe = fe;
  const bool fold = fe > 0;
  const bool ok =
      (!fold || (fe <= H && make_mlp_pair(&a.enc, &a.genc, enc_w, enc_g, n_enc_layers, fe))) &&
      make_mlp_pair(&a.edge, &a.gedge, edge_w, edge_g, n_edge_layers, 3 * H) &&
      make_mlp_pair(&a.node, &a.gnode, node_w, node_g, n_node_layers, 2 * H) &&
      (de == nullptr) == fold && n_nodes >= 1 && batch >= 1 && total_rows >= 1;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}
