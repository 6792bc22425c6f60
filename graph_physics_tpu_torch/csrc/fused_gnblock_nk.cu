// Fused GraphNetBlock forward on the uniform-degree ("NK") slot layout,
// for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_gnblock_nk.py:
// _nk_fwd_kernel (:147), called by fused_gn_block_nk (:332). Same function:
// for every receiver r and sample b, over r's K slots s with sender j,
//   e_in  = folded ? EncMLP(raw[s, b]) : e[s, b]
//   h     = edge_mask[s] ? EdgeMLP(cat[e_in, x[r, b], x[j, b]]) : 0
//   e_out = e_in + h                       (not written on the last block)
//   agg   = bf16(sum_k h)                  (fp32 sum)
//   x_out = x[r, b] + NodeMLP(cat[x[r, b], agg])
// with the numeric flow of the JAX kernel's _mlp_fwd/_rms_fwd: bf16 values
// between layers (each Dense rounds its fp32 product, then rounds again
// after the bias), fp32 accumulation, fp32 RMS statistics of bf16 squares.
// The first edge layer is one fp32 sum over the gathered inputs; the TPU
// kernel instead rounds per-part partial products to bf16 first.
//
// What bounds it on this card: at hidden 32 every slot costs ~6.1k
// multiply-adds in the edge MLP against 192 bytes of edge row traffic
// (read e, write e_out), so the block does ~20 GFLOP on the cylinder
// batch (1,920 receivers x 128 samples x 6 slots) while moving ~0.25 GB.
// As plain fp32 FMAs on the CUDA cores that is compute-bound (~0.3 ms at
// the 67 TFLOP/s fp32 peak, against ~0.07 ms of HBM traffic).
//
// What the design does about it, in this first version: one thread per
// (receiver, sample) loops over the receiver's K slots, so the K-sum needs
// no atomics and the messages never leave registers; all MLP weights
// (bf16 values held as fp32, ~60 KB) are staged once per block in shared
// memory and read as float4 broadcasts (one load feeds four FMAs); rows
// are read as whole 64-byte vectors from the packed [N, B, 32] layout, so
// the 32 threads of a warp (32 samples of one receiver) read 2 KB of
// contiguous memory, and the sender gather is a coalesced row load that
// mostly hits L2 (x is 15.7 MB). Blocks stride over the work so each SM
// stages the weights a few times only. Tensor cores (wgmma), TMA and
// tiling are left to later versions.

#include "gn_nk_common.cuh"

using namespace gn_nk;

namespace {

constexpr int THREADS = 128;

struct Args {
  const __nv_bfloat16* x;  // [N, B, H]
  const __nv_bfloat16* e;  // [S, B, H], or raw [S, B, fe] when folded
  __nv_bfloat16* x_out;    // [N, B, H]
  __nv_bfloat16* e_out;    // [S, B, H]; null on the last block
  const int32_t* senders;  // [S] global sender per slot (0 on padding)
  const uint8_t* mask;     // [S] 1 on valid slots
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

    float agg[H];
    zero(agg);
    for (int k = 0; k < K; ++k) {
      const long long s = slot0 + static_cast<long long>(k) * nb;
      const long long row = s * B + b;
      float ein[H];
      if (FOLD) {  // edge encoder on the raw features
        float acc[H];
        zero(acc);
        const __nv_bfloat16* raw = a.e + row * a.fe;
        for (int i = 0; i < a.fe; ++i) fma_row(acc, __bfloat162float(raw[i]), s_enc + i * H);
        finish(ein, acc, s_enc + a.fe * H);
        mlp_tail(ein, s_enc + a.fe * H + H, a.enc.n_layers, enc_norm);
      }
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
        fma_global_row(acc, xr, s_edge + H * H);
        fma_global_row(acc, a.x + (j * B + b) * H, s_edge + 2 * H * H);
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
  const size_t smem = sizeof(float) *
      ((FOLD ? mlp_floats(a.enc) : 0) + mlp_floats(a.edge) + mlp_floats(a.node));
  auto kernel = gn_nk_fwd_kernel<FOLD, LAST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long total = static_cast<long long>(a.n_nodes) * a.batch;
  const long long need = (total + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(need < cap ? need : cap);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Each weight list holds 2 * n_layers + 1 pointers: w0, b0, w1, b1, ...,
// then the RMSNorm scale (null without a norm). fe > 0 folds the edge
// encoder in (e is the raw [S, B, fe] array); e_out null marks the last
// block. Returns the CUDA error code of the launch (0 on success).
extern "C" int gn_nk_fwd(const void* x, const void* e, void* x_out, void* e_out,
                         const void* senders, const void* mask, int n_nodes, int batch,
                         int k_slots, int node_block, int fe, const void* const* enc_w,
                         int n_enc_layers, const void* const* edge_w, int n_edge_layers,
                         const void* const* node_w, int n_node_layers, void* stream) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.e = static_cast<const __nv_bfloat16*>(e);
  a.x_out = static_cast<__nv_bfloat16*>(x_out);
  a.e_out = static_cast<__nv_bfloat16*>(e_out);
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
