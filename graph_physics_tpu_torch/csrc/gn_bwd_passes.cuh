// The pass bodies of the GraphNetBlock backward, written once for both
// edge layouts and templated on the row map: receiver-sorted CSR
// (fused_gnblock_csr_bwd.cu) and the NK slot layout
// (fused_gnblock_nk_bwd.cu). Each source wraps them in kernels of its own
// name and launches them with launch_passes:
//  0. two node pre-passes (gn_nk_common.cuh:gn_partial_kernel) write bf16(x @ Kr)
//     and bf16(x @ Ks) per (node, sample);
//  1. node-MLP pass, one thread per (node, sample): the node MLP's backward
//     from g_xout and the aggregate the forward kept; it writes dx's
//     node-MLP part and the aggregate's cotangent g_agg [N, B, H] (bf16);
//  2. row pass, one thread per (row, sample) of every row: the edge MLP
//     (and folded encoder) forward with activations kept, its backward
//     from g_agg of the row's receiver plus g_eout, de, and g_h0 to a bf16
//     scratch [S, B, H]. Consecutive threads take consecutive samples of
//     one row, so every row access of a warp is contiguous, and no thread
//     waits on a longer row range than its own. Rows outside every
//     receiver's range (CSR padding) and masked rows take a zero
//     cotangent: their g_h0 is 0 and their de is g_eout;
//  3. sender pass, one thread per (node, sample): sums P_r over the node's
//     own rows and P_s over the rows it sends on (a sender-sorted row list,
//     the layout's transpose), both in fp32; adds bf16(P_r·Krᵀ) and
//     bf16(P_s·Ksᵀ) to its own dx and stages x ⊗ P_r and x ⊗ P_s for dKr
//     and dKs.
// No atomics touch dx or de; the weight gradients are staged per warp and
// per block (gn_bwd_common.cuh) and added into the global fp32 gradients
// once per block. Pass 2 keeps the edge (and encoder) weights, their
// gradient accumulators and the per-warp stage buffers (8 warps x 8.3 KB)
// in shared memory: one block of 256 threads per SM.
//
// A row map gives, for a layout: the end of the rows that belong to some
// receiver (ranged_end), the receiver of a row, and the rows a node owns
// (first, count, step).
#pragma once

#include "gn_bwd_common.cuh"

namespace gn_bwd {

constexpr int PASS_THREADS = 256;
constexpr int PASS_WARPS = PASS_THREADS / 32;
constexpr int SEND_THREADS = 128;
constexpr int SEND_WARPS = SEND_THREADS / 32;

struct PassArgs {
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
  const int32_t* row_ptr;       // CSR: [N + 1] receiver r owns rows row_ptr[r]:row_ptr[r+1]
  const int32_t* receivers;     // CSR: [S] receiver per row (N-1 on padding)
  int k_slots, node_block;      // NK: K slots a receiver, nb receivers a node block
  const int32_t* senders;       // [S] sender per row (0 on padding)
  const uint8_t* mask;          // [S] 1 on valid rows
  const int32_t* order;         // the valid rows sorted by sender
  const int32_t* offsets;       // [N + 1] node j sends on order[offsets[j]:offsets[j+1]]
  int n_nodes, batch, total_rows, fe;
  Mlp enc, edge, node;     // weights
  Mlp genc, gedge, gnode;  // their gradients: same shapes, fp32, zeroed
};

// receiver-sorted CSR; rows from row_ptr[N] on are padding
struct CsrRows {
  static __device__ __forceinline__ long long ranged_end(const PassArgs& a) {
    return a.row_ptr[a.n_nodes];
  }
  static __device__ __forceinline__ long long receiver(const PassArgs& a, long long s) {
    return a.receivers[s];
  }
  static __device__ __forceinline__ void own(const PassArgs& a, int j, long long& first,
                                             int& count, int& step) {
    first = a.row_ptr[j];
    count = a.row_ptr[j + 1] - a.row_ptr[j];
    step = 1;
  }
};

// NK slots (ops/tiling.py): receiver g·nb + r owns slots g·K·nb + k·nb + r,
// k < K; every slot belongs to its receiver, masked ones included
struct NkRows {
  static __device__ __forceinline__ long long ranged_end(const PassArgs& a) {
    return a.total_rows;
  }
  static __device__ __forceinline__ long long receiver(const PassArgs& a, long long s) {
    const long long per_group = static_cast<long long>(a.k_slots) * a.node_block;
    return (s / per_group) * a.node_block + s % a.node_block;
  }
  static __device__ __forceinline__ void own(const PassArgs& a, int j, long long& first,
                                             int& count, int& step) {
    first = static_cast<long long>(j / a.node_block) * a.k_slots * a.node_block +
            j % a.node_block;
    count = a.k_slots;
    step = a.node_block;
  }
};

// The edge MLP's first-layer sum on one row before its bias, in the JAX
// kernels' order: the fp32 product e_in @ Ke, then the bf16 node partials
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

// pass 1: the node MLP's backward, one thread per (node, sample): dx's
// node-MLP part and the aggregate's cotangent g_agg
__device__ __forceinline__ void nodemlp_pass(const PassArgs& a) {
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

// pass 2: the edge MLP's (and folded encoder's) backward, one thread per
// (row, sample) of every row: g_h0 and de
template <class Rows>
__device__ __forceinline__ void row_pass(const PassArgs& a) {
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
  const long long pad0 = Rows::ranged_end(a);
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
    const long long r = Rows::receiver(a, s);
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

// pass 3: P_r and P_s, dx's receiver and sender parts, dKr and dKs, one
// thread per (node, sample)
template <class Rows>
__device__ __forceinline__ void send_pass(const PassArgs& a) {
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

using PassKernel = void (*)(const PassArgs);

// the pre-passes (gn_partial_kernel) and passes 1-3 on ``stream``, each
// pass kernel one of the calling source's wrappers of the bodies above
inline cudaError_t launch_passes(const PassArgs& a, cudaStream_t stream, PassKernel nodemlp,
                                 PassKernel rows, PassKernel send) {
  const long long nodes = static_cast<long long>(a.n_nodes) * a.batch;
  int grid = 0;
  cudaError_t err = grid_for(reinterpret_cast<const void*>(gn_partial_kernel), PARTIAL_THREADS,
                             0, nodes, &grid);
  if (err != cudaSuccess) return err;
  gn_partial_kernel<<<grid, PARTIAL_THREADS, 0, stream>>>(  // x @ Kr
      a.x, const_cast<__nv_bfloat16*>(a.xkr), a.edge.w[0], nodes, H);
  gn_partial_kernel<<<grid, PARTIAL_THREADS, 0, stream>>>(  // x @ Ks
      a.x, const_cast<__nv_bfloat16*>(a.xks), a.edge.w[0], nodes, 2 * H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const bool fold = a.fe > 0;
  const size_t nsmem = sizeof(float) * (2 * mlp_floats(a.node) + PASS_WARPS * STAGE);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(nodemlp),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(nsmem));
  if (err != cudaSuccess) return err;
  err = grid_for(reinterpret_cast<const void*>(nodemlp), PASS_THREADS, nsmem, nodes, &grid);
  if (err != cudaSuccess) return err;
  nodemlp<<<grid, PASS_THREADS, nsmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t rsmem = sizeof(float) * (2 * ((fold ? mlp_floats(a.enc) : 0) + mlp_floats(a.edge)) +
                                        PASS_WARPS * STAGE);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(rows),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(rsmem));
  if (err != cudaSuccess) return err;
  const long long work = static_cast<long long>(a.total_rows) * a.batch;
  err = grid_for(reinterpret_cast<const void*>(rows), PASS_THREADS, rsmem, work, &grid);
  if (err != cudaSuccess) return err;
  rows<<<grid, PASS_THREADS, rsmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t send_smem = sizeof(float) * (4 * H * H + SEND_WARPS * STAGE);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(send),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(send_smem));
  if (err != cudaSuccess) return err;
  err = grid_for(reinterpret_cast<const void*>(send), SEND_THREADS, send_smem, nodes, &grid);
  if (err != cudaSuccess) return err;
  send<<<grid, SEND_THREADS, send_smem, stream>>>(a);
  return cudaGetLastError();
}

// Fills the weight and gradient MLPs of ``a`` from the pointer lists (2 *
// n_layers + 1 pointers each: w0, b0, w1, b1, ..., the RMSNorm scale or
// null), checking that they fit the passes: fe > 0 folds the encoder in
// (then de is null).
inline bool make_pass_mlps(PassArgs* a, const void* const* enc_w, const void* const* enc_g,
                           int n_enc_layers, const void* const* edge_w,
                           const void* const* edge_g, int n_edge_layers,
                           const void* const* node_w, const void* const* node_g,
                           int n_node_layers) {
  const bool fold = a->fe > 0;
  return (!fold ||
          (a->fe <= H && make_mlp_pair(&a->enc, &a->genc, enc_w, enc_g, n_enc_layers, a->fe))) &&
         make_mlp_pair(&a->edge, &a->gedge, edge_w, edge_g, n_edge_layers, 3 * H) &&
         make_mlp_pair(&a->node, &a->gnode, node_w, node_g, n_node_layers, 2 * H) &&
         (a->de == nullptr) == fold && a->n_nodes >= 1 && a->batch >= 1 && a->total_rows >= 1;
}

}  // namespace gn_bwd
