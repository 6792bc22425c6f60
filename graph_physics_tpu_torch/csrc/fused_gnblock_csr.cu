// Fused GraphNetBlock forward on the receiver-sorted CSR edge layout, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock.py:
// _fwd_kernel (:392), called by fused_gn_block (:687), without the lane
// tiling, the runtime tiling_idx and the extra_agg seam. Same function, on
// a graph of any degree: for every receiver r and sample b, over r's rows
// s = row_ptr[r] .. row_ptr[r+1]-1 with sender j,
//   e_in  = folded ? EncMLP(raw[s, b]) : e[s, b]
//   h     = edge_mask[s] ? EdgeMLP(e_in, x[r, b], x[j, b]) : 0
//   e_out = e_in + h                       (not written on the last block)
//   agg   = bf16(sum_s h)                  (fp32 sum)
//   x_out = x[r, b] + NodeMLP(cat[x[r, b], agg])
// Padding rows (after row_ptr[N]) belong to no receiver; they get
// e_out = e_in. The edge MLP's first layer follows the TPU kernel's order
// (fused_gnblock.py:blocked_reference :1173-1183): the node partials
// x @ Kr and x @ Ks are computed per node and rounded to bf16, then added
// to the fp32 product e_in @ Ke, and the sum is rounded once. Between
// layers the numerics are the NK kernel's (gn_nk_common.cuh): bf16 values,
// fp32 accumulation, fp32 RMS statistics of bf16 squares.
//
// What bounds it on this card: at hidden 32 an edge row costs 4.1k
// multiply-adds (its first layer now 1k, the per-node partials 2k a node)
// against 128 bytes of edge traffic (read e, write e_out). On the graded
// airfoil-sized slice (27,008 receivers x 16 samples, 160,612 edges) that
// is ~27 GFLOP against ~0.41 GB: compute-bound as fp32 FMAs on the CUDA
// cores (~0.4 ms at 67 TFLOP/s), ~0.12 ms of HBM traffic.
//
// What the design does about it, in this first version: a pre-pass
// (one thread per (node, sample)) writes x @ Ks as bf16 to a scratch
// [N, B, 32] array, so a sender's partial is a 64-byte row load per edge
// instead of 1k multiply-adds; then one thread per (receiver, sample)
// computes its own x @ Kr once, keeps it as packed bf16 pairs, and walks
// its CSR rows, so the sum over a receiver's edges needs no atomics and
// the messages never leave registers. The weights sit in shared memory as
// in the NK kernel. Neighbouring receivers have different degrees, so a
// warp waits for its longest row range; that is left as it is.

#include "gn_nk_common.cuh"

using namespace gn_nk;

namespace {

constexpr int THREADS = 128;

struct Args {
  const __nv_bfloat16* x;    // [N, B, H]
  const __nv_bfloat16* e;    // [S, B, H], or raw [S, B, fe] when folded
  const __nv_bfloat16* xks;  // [N, B, H] scratch: bf16(x @ Ks), from the pre-pass
  __nv_bfloat16* x_out;      // [N, B, H]
  __nv_bfloat16* agg_out;    // [N, B, H] bf16(agg) for the backward, or null
  __nv_bfloat16* e_out;      // [S, B, H]; null on the last block
  const int32_t* row_ptr;    // [N + 1] receiver r owns rows row_ptr[r]:row_ptr[r+1]
  const int32_t* senders;    // [S] sender per row (0 on padding)
  const uint8_t* mask;       // [S] 1 on valid rows
  int n_nodes, batch, total_rows, fe;
  Mlp enc, edge, node;
};

template <bool FOLD, bool LAST>
__global__ void __launch_bounds__(THREADS) gn_csr_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* s_enc = smem;
  float* s_edge = s_enc + (FOLD ? mlp_floats(a.enc) : 0);
  float* s_node = s_edge + mlp_floats(a.edge);
  if (FOLD) stage_mlp(s_enc, a.enc);
  stage_mlp(s_edge, a.edge);
  stage_mlp(s_node, a.node);
  __syncthreads();

  const int B = a.batch;
  const bool enc_norm = a.enc.scale != nullptr;
  const bool edge_norm = a.edge.scale != nullptr;
  const bool node_norm = a.node.scale != nullptr;
  const long long recv_work = static_cast<long long>(a.n_nodes) * B;
  const long long pad0 = a.row_ptr[a.n_nodes];  // the first padding row
  const long long total = recv_work + (LAST ? 0 : (a.total_rows - pad0) * B);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    if (t >= recv_work) {  // a padding row (mask False): e_out = e_in
      const long long row = pad0 * B + (t - recv_work);
      float ein[H];
      if (FOLD)
        encode(ein, a.e + row * a.fe, a.fe, s_enc, a.enc.n_layers, enc_norm);
      else
        load_row(ein, a.e + row * H);
      store_row(a.e_out + row * H, ein);
      continue;
    }
    const int r = static_cast<int>(t / B);
    const int b = static_cast<int>(t % B);
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
    const int end = a.row_ptr[r + 1];
    for (int s = a.row_ptr[r]; s < end; ++s) {
      const long long row = static_cast<long long>(s) * B + b;
      float ein[H];
      if (FOLD) encode(ein, a.e + row * a.fe, a.fe, s_enc, a.enc.n_layers, enc_norm);
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
  auto kernel = gn_csr_fwd_kernel<FOLD, LAST>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // the receivers' work plus at most total_rows padding-row copies
  const long long work = rows + (LAST ? 0 : static_cast<long long>(a.total_rows) * a.batch);
  err = grid_for(reinterpret_cast<const void*>(kernel), THREADS, smem, work, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Each weight list holds 2 * n_layers + 1 pointers: w0, b0, w1, b1, ...,
// then the RMSNorm scale (null without a norm). fe > 0 folds the edge
// encoder in (e is the raw [S, B, fe] array); e_out null marks the last
// block. xks is a [n_nodes, batch, 32] bf16 scratch; agg_out, when not
// null, receives the bf16 aggregate [n_nodes, batch, 32] for the backward.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int gn_csr_fwd(const void* x, const void* e, void* xks, void* x_out, void* e_out,
                          void* agg_out, const void* row_ptr, const void* senders,
                          const void* mask, int n_nodes, int batch, int total_rows, int fe,
                          const void* const* enc_w, int n_enc_layers,
                          const void* const* edge_w, int n_edge_layers,
                          const void* const* node_w, int n_node_layers, void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.e = static_cast<const __nv_bfloat16*>(e);
  a.xks = static_cast<const __nv_bfloat16*>(xks);
  a.x_out = static_cast<__nv_bfloat16*>(x_out);
  a.e_out = static_cast<__nv_bfloat16*>(e_out);
  a.agg_out = static_cast<__nv_bfloat16*>(agg_out);
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.senders = static_cast<const int32_t*>(senders);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n_nodes = n_nodes;
  a.batch = batch;
  a.total_rows = total_rows;
  a.fe = fe;
  const bool fold = fe > 0;
  if ((fold && !make_mlp(&a.enc, enc_w, n_enc_layers, fe)) ||
      !make_mlp(&a.edge, edge_w, n_edge_layers, 3 * H) ||
      !make_mlp(&a.node, node_w, n_node_layers, 2 * H) || n_nodes < 1 || batch < 1 ||
      total_rows < 1)
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
