// Fused GraphNetBlock forward on the uniform-degree ("NK") slot layout,
// for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock_nk.py:
// _nk_fwd_kernel (:147), called by fused_gn_block_nk (:332). Same function:
// for every receiver r and sample b, over r's K slots s with sender j,
//   e_in  = folded ? EncMLP(raw[s, b]) : e[s, b]
//   h     = edge_mask[s] ? EdgeMLP(cat[e_in, x[r, b], x[j, b]]) : 0
//   e_out = e_in + h                       (not written on the last block)
//   agg   = bf16(sum_k h)                  (fp32 sum; written out under autograd,
//                                           for the backward: 15.7 MB a block at B=128)
//   x_out = x[r, b] + NodeMLP(cat[x[r, b], agg])
// with the numeric flow of the JAX kernel's _mlp_fwd/_rms_fwd: bf16 values
// between layers (each Dense rounds its fp32 product, then rounds again
// after the bias), fp32 accumulation, fp32 RMS statistics of bf16 squares.
// The first edge layer follows the JAX kernel's _edge_fwd (:130-134): the
// node partials x @ Kr and x @ Ks are computed per node and rounded to
// bf16, then added to the fp32 product e_in @ Ke, as in the CSR forward
// (fused_gnblock_csr.cu) and as the backward (gn_bwd_passes.cuh:
// first_layer) rebuilds it, so forward and backward are one function.
//
// What bounds it on this card: at hidden 32 every slot costs ~4.1k
// multiply-adds in the edge MLP (its first layer 1k, the per-node
// partials 2k a node) against 192 bytes of edge row traffic (read e,
// write e_out), so the block does ~15 GFLOP on the cylinder batch (1,920
// receivers x 128 samples x 6 slots) while moving ~0.27 GB. As plain fp32
// FMAs on the CUDA cores that is compute-bound (~0.2 ms at the 67 TFLOP/s
// fp32 peak, against ~0.08 ms of HBM traffic).
//
// What the design does about it, in this first version: a pre-pass (one
// thread per (node, sample), gn_nk_common.cuh:gn_partial_kernel) writes
// x @ Ks as bf16 to a scratch [N, B, 32] array, so a sender's partial is
// a 64-byte row load per slot; then one thread per (receiver, sample)
// computes its own x @ Kr once, keeps it as packed bf16 pairs, and loops
// over the receiver's K slots, so the K-sum needs no atomics and the
// messages never leave registers; all MLP weights
// (bf16 values held as fp32, ~60 KB) are staged once per block in shared
// memory and read as float4 broadcasts (one load feeds four FMAs); rows
// are read as whole 64-byte vectors from the packed [N, B, 32] layout, so
// the 32 threads of a warp (32 samples of one receiver) read 2 KB of
// contiguous memory, and the sender's partial is a coalesced row load
// that mostly hits L2 (the scratch is 15.7 MB). Blocks stride over the work so each SM
// stages the weights a few times only. Tensor cores (wgmma), TMA and
// tiling are left to later versions.

#include "gn_nk_common.cuh"

using namespace gn_nk;

namespace {

constexpr int THREADS = 128;

struct Args {
  const __nv_bfloat16* x;  // [N, B, H]
  const __nv_bfloat16* e;    // [S, B, H], or raw [S, B, fe] when folded
  const __nv_bfloat16* xks;  // [N, B, H] scratch: bf16(x @ Ks), from the pre-pass
  __nv_bfloat16* x_out;      // [N, B, H]
  __nv_bfloat16* e_out;      // [S, B, H]; null on the last block
  __nv_bfloat16* agg_out;    // [N, B, H] bf16(agg) for the backward, or null
  const int32_t* senders;    // [S] global sender per slot (0 on padding)
  const uint8_t* mask;       // [S] 1 on valid slots
  int n_nodes, batch, k_slots, node_block, fe;
  Mlp enc, edge, node;
};

template <bool FOLD, bool LAST>
__global__ void __launch_bounds__(THREADS) gn_nk_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* s_enc = smem;
  float* s_edge = s_enc + (FOLD ? mlp_floats(a.enc) : 0);
  float* s_node = s_edge + mlp_floats(a.edge);
  if (FOLD) stage_mlp(s_enc, a.enc);
  stage_mlp(s_edge, a.edge);
  stage_mlp(s_node, a.node);
  __syncthreads();

  const int B = a.batch, K = a.k_slots, nb = a.node_block;
  const bool enc_norm = a.enc.scale != nullptr;
  const bool edge_norm = a.edge.scale != nullptr;
  const bool node_norm = a.node.scale != nullptr;
  const long long total = static_cast<long long>(a.n_nodes) * B;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int r = static_cast<int>(t / B);
    const int b = static_cast<int>(t % B);
    const long long slot0 = static_cast<long long>(r / nb) * K * nb + r % nb;
    const __nv_bfloat16* xr = a.x + t * H;  // row (r, b)

    uint32_t xkr[H / 2];  // bf16(x[r, b] @ Kr) as packed pairs
    {
      float acc[H];
      zero(acc);
      fma_global_row(acc, xr, s_edge + H * H);
#pragma unroll
      for (int i = 0; i < H / 2; ++i) xkr[i] = pack2(acc[2 * i], acc[2 * i + 1]);
    }

    float agg[H];
    zero(agg);
    for (int k = 0; k < K; ++k) {
      const long long s = slot0 + static_cast<long long>(k) * nb;
      const long long row = s * B + b;
      float ein[H];
      if (FOLD)  // edge encoder on the raw features
        encode(ein, a.e + row * a.fe, a.fe, s_enc, a.enc.n_layers, enc_norm);
      float h[H];
      if (a.mask[s]) {
        const long long j = a.senders[s];
        float acc[H];
        zero(acc);
        if (FOLD) {
#pragma unroll
          for (int i = 0; i < H; ++i) fma_row(acc, ein[i], s_edge + i * H);
        } else {
          fma_global_row(acc, a.e + row * H, s_edge);
        }
        float xs[H];
        load_row(xs, a.xks + (j * B + b) * H);
#pragma unroll
        for (int i = 0; i < H / 2; ++i) {
          acc[2 * i] += __uint_as_float(xkr[i] << 16);
          acc[2 * i + 1] += __uint_as_float(xkr[i] & 0xffff0000u);
        }
#pragma unroll
        for (int o = 0; o < H; ++o) acc[o] += xs[o];
        finish(h, acc, s_edge + 3 * H * H);
        mlp_tail(h, s_edge + 3 * H * H + H, a.edge.n_layers, edge_norm);
#pragma unroll
        for (int o = 0; o < H; ++o) agg[o] += h[o];
      } else {
        zero(h);
      }
      if (!LAST) {
        if (!FOLD) load_row(ein, a.e + row * H);
#pragma unroll
        for (int o = 0; o < H; ++o) h[o] += ein[o];
        store_row(a.e_out + row * H, h);
      }
    }

    if (a.agg_out) store_row(a.agg_out + t * H, agg);
    float acc[H];
    zero(acc);
    fma_global_row(acc, xr, s_node);
#pragma unroll
    for (int i = 0; i < H; ++i) fma_row(acc, bf(agg[i]), s_node + (H + i) * H);
    float h[H];
    finish(h, acc, s_node + 2 * H * H);
    mlp_tail(h, s_node + 2 * H * H + H, a.node.n_layers, node_norm);
    float xv[H];
    load_row(xv, xr);
#pragma unroll
    for (int o = 0; o < H; ++o) h[o] += xv[o];
    store_row(a.x_out + t * H, h);
  }
}

template <bool FOLD, bool LAST>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.n_nodes) * a.batch;
  int grid = 0;
  cudaError_t err = grid_for(reinterpret_cast<const void*>(gn_partial_kernel),
                             PARTIAL_THREADS, 0, rows, &grid);
  if (err != cudaSuccess) return err;
  gn_partial_kernel<<<grid, PARTIAL_THREADS, 0, stream>>>(
      a.x, const_cast<__nv_bfloat16*>(a.xks), a.edge.w[0], rows, 2 * H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem = sizeof(float) *
      ((FOLD ? mlp_floats(a.enc) : 0) + mlp_floats(a.edge) + mlp_floats(a.node));
  auto kernel = gn_nk_fwd_kernel<FOLD, LAST>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = grid_for(reinterpret_cast<const void*>(kernel), THREADS, smem, rows, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Each weight list holds 2 * n_layers + 1 pointers: w0, b0, w1, b1, ...,
// then the RMSNorm scale (null without a norm). fe > 0 folds the edge
// encoder in (e is the raw [S, B, fe] array); e_out null marks the last
// block. xks is a [n_nodes, batch, 32] bf16 scratch; agg_out, when not
// null, receives the bf16 aggregate [n_nodes, batch, 32] for the
// backward. Returns the CUDA error code of the launches (0 on success).
extern "C" int gn_nk_fwd(const void* x, const void* e, void* xks, void* x_out, void* e_out,
                         void* agg_out, const void* senders, const void* mask, int n_nodes,
                         int batch, int k_slots, int node_block, int fe,
                         const void* const* enc_w, int n_enc_layers, const void* const* edge_w,
                         int n_edge_layers, const void* const* node_w, int n_node_layers,
                         void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.e = static_cast<const __nv_bfloat16*>(e);
  a.xks = static_cast<const __nv_bfloat16*>(xks);
  a.x_out = static_cast<__nv_bfloat16*>(x_out);
  a.e_out = static_cast<__nv_bfloat16*>(e_out);
  a.agg_out = static_cast<__nv_bfloat16*>(agg_out);
  a.senders = static_cast<const int32_t*>(senders);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.k_slots = k_slots;
  a.node_block = node_block;
  a.fe = fe;
  const bool fold = fe > 0;
  if ((fold && !make_mlp(&a.enc, enc_w, n_enc_layers, fe)) ||
      !make_mlp(&a.edge, edge_w, n_edge_layers, 3 * H) ||
      !make_mlp(&a.node, node_w, n_node_layers, 2 * H) || n_nodes < 1 || batch < 1 ||
      k_slots < 1 || node_block < 1 || n_nodes % node_block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool last = e_out == nullptr;
  cudaError_t err;
  if (fold)
    err = last ? launch<true, true>(a, st) : launch<true, false>(a, st);
  else
    err = last ? launch<false, true>(a, st) : launch<false, false>(a, st);
  return static_cast<int>(err);
}
