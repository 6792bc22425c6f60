// Gated feed-forward half of the transformer block at hidden 128, forward,
// for Hopper (sm_90a), on warpgroup products.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
// _ffn_fwd_kernel (:74) with pre_norm=True at hidden 128 (the panels
// workload, training_config/panels.json), called by fused_gated_ffn (:165)
// from TransformerBlock. The function and every bf16 rounding point are
// fused_ffn.cu's, per row x of [N*B, H] with H = 128 and the middle width
// W = 3H = 384:
//   t = RMS_norm2(x);  n = RMS_0(t);  a1 = bf16(bf16(n W1) + b1);
//   a2 = bf16(bf16(n W2) + b2);  g = bf16(bf16(act(a1)) * a2);
//   y = bf16(x + bf16(bf16(g W3) + b3)).
// Only the order of the fp32 sums inside a product or a row sum differs
// from the JAX kernel's, and it is fixed (y: one accumulator over the
// middle in order, each product's k16 steps in order), so two calls give
// the same bits.
//
// What bounds it on this card: 3 products of 128 x 384 a row, 294,912
// FLOP, against 512 bytes (x read, y written). At panels' shape (1,920
// nodes x 64 samples = 122,880 rows) that is 36.2 GFLOP, 0.0366 ms on the
// bf16 tensor cores (989 TFLOP/s), and 62.9 MB, 0.0188 ms at 3.35 TB/s:
// bound by operations.
//
// Design. The three bf16 weights take 288 KB, more than a block's 227 KB,
// so they stream through shared memory in six slices of 64 middle columns
// (ffn_wide.cuh's image, packed once a call by ffn128_fwd_pack):
//   * persistent blocks, one per SM, of two consumer warpgroups and a
//     producer warpgroup that gives its registers to them (setmaxnreg);
//     a 128-row tile at a time, warpgroup q owning rows 64q..64q+63 (warp
//     w of it the 16 rows 64q + 16w ..);
//   * one producer thread keeps a 3-stage ring of slices full with one
//     cp.async.bulk each (48 KB from L2) and brings each tile's x through
//     TMA (two 64-column boxes, 128-byte swizzle, zeros past the last row)
//     into one of two stages, a tile ahead;
//   * a warp reads its x rows into m16n8 fragments, runs both RMS norms
//     there (a quad of lanes a row) and keeps n as the A operand of its
//     products (32 registers);
//   * per slice: a1 and a2 as wgmma m64n64k16 (A = n from registers, B the
//     slice's W1 or W2 rows, K-major); bias, act and gate on the
//     accumulators as bf16 pairs, the 32 values' chains in one straight
//     run; the gated pairs straight from registers as the A operand of y
//     += g·W3ᵀ (m64n128k16, B the slice's W3 columns): the middle never
//     leaves registers;
//   * y stays in fp32 registers across the slices (64 a thread); at the
//     tile's end + b3 and the residual round into the x tile in place, and
//     each warp stores its 16 rows with 16-byte stores (rows past the end
//     masked).
// The slice of step s is released to the producer once y of that slice
// is done, i.e. at the next wait.
// Shared memory: 1 KB of alignment, the ring 3 x 48 KB, x 2 x 32 KB, the
// vectors 2,304 bytes and 11 barriers: 216,408 bytes, one block per SM. Registers (at most 232 a consumer thread): n 32, y 64,
// a1 and a2 64, the gated pairs 16.

#include "ffn_wide.cuh"

namespace {

using namespace ffnw;

constexpr int WGS = 2;                     // consumer warpgroups
constexpr int THREADS = WGS * 128 + 128;   // and the producer's warpgroup
constexpr int TM = 64 * WGS;               // rows a tile
constexpr int STAGES = 3;                  // the ring's slices
constexpr int XBLK = TM * 128;             // a 64-column block of an x tile
constexpr int XT = 2 * XBLK;               // an x tile
constexpr int OFF_X = STAGES * SLICE, OFF_VEC = OFF_X + 2 * XT, OFF_BAR = OFF_VEC + VEC_BYTES;
constexpr int SMEM = 1024 + OFF_BAR + 11 * 8;
static_assert(SMEM <= 232448, "shared memory of one block");

struct Args {
  CUtensorMap xmap;         // x [rows][H], boxes of 64 columns x TM rows
  __nv_bfloat16* y;         // [rows, H]
  const unsigned char* img;  // the packed weights (ffn_wide.cuh)
  long long rows;
  int silu;
};

struct PackArgs {
  unsigned char* img;
  const float *w1, *b1, *w2, *b2, *w3, *b3, *scale2, *scale;
};

__global__ void __launch_bounds__(256) ffn128_fwd_pack(const PackArgs p) {
  pack_image(p.img, p.w1, p.b1, p.w2, p.b2, p.w3, p.b3, p.scale2, p.scale);
}

__global__ void __launch_bounds__(THREADS, 1) ffn128_fwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sm;
  unsigned char* xt = sm + OFF_X;
  const bf2* v2 = reinterpret_cast<const bf2*>(sm + OFF_VEC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + OFF_BAR);
  uint64_t *wfull = bars, *wempty = bars + STAGES, *xfull = bars + 2 * STAGES;
  uint64_t *xempty = xfull + 2, *vbar = xfull + 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long tiles = (a.rows + TM - 1) / TM;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::bar_init(wfull + s, 1);
      wg::bar_init(wempty + s, 4 * WGS);
    }
    for (int s = 0; s < 2; ++s) {
      wg::bar_init(xfull + s, 1);
      wg::bar_init(xempty + s, 4 * WGS);
    }
    wg::bar_init(vbar, 1);
    wg::bar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * WGS) {  // the producer: one thread, its warpgroup's registers given to the others
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * WGS && lane == 0) {
      wg::bar_expect(vbar, VEC_BYTES);
      wg::bulk_load(sm + OFF_VEC, a.img + NS * SLICE, VEC_BYTES, vbar);
      int step = 0;
      int i = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int xs = i & 1;
        if (i >= 2) bwait<false>(xempty + xs, ((i >> 1) - 1) & 1);
        wg::bar_expect(xfull + xs, XT);
        for (int kb = 0; kb < 2; ++kb)
          wg::tma_load2(xt + xs * XT + kb * XBLK, &a.xmap, 64 * kb, static_cast<int>(t * TM),
                        xfull + xs);
        for (int c = 0; c < NS; ++c, ++step) {
          const int s = step % STAGES;
          if (step >= STAGES) bwait<false>(wempty + s, ((step / STAGES) - 1) & 1);
          wg::bar_expect(wfull + s, SLICE);
          wg::bulk_load(ring + s * SLICE, a.img + c * SLICE, SLICE, wfull + s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int q = warp >> 2, row0 = 64 * q + 16 * (warp & 3);
  bwait<false>(vbar, 0);
  __syncwarp();
  int step = 0;
  int i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int xs = i & 1;
    bwait<false>(xfull + xs, (i >> 1) & 1);
    __syncwarp();
    const uint32_t xu = wg::smem_u32(xt + xs * XT);
    // n = RMS_0(RMS_norm2(x)), the warp's 16 rows, as A fragments
    uint32_t nf[32];
    wg::frag_load(nf, xu, row0, XBLK);
    float inv[2];
    rms_rows(nf, v2 + V_S2 / 2, inv);
    rms_rows(nf, v2 + V_S / 2, inv);

    float y[16][4];
    for (int c = 0; c < NS; ++c, ++step) {
      const int s = step % STAGES;
      bwait<false>(wfull + s, (step / STAGES) & 1);
      __syncwarp();
      const uint32_t w = wg::smem_u32(ring + s * SLICE);
      float a1[8][4], a2[8][4];
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const uint32_t af[4] = {nf[4 * ks], nf[4 * ks + 1], nf[4 * ks + 2], nf[4 * ks + 3]};
        wg::mma_rs64<0>(a1, af, wg::desc_k(w + SL_W1, ks, BLK), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const uint32_t af[4] = {nf[4 * ks], nf[4 * ks + 1], nf[4 * ks + 2], nf[4 * ks + 3]};
        wg::mma_rs64<0>(a2, af, wg::desc_k(w + SL_W2, ks, BLK), ks > 0);
      }
      wg::commit();
      wg::wait<0>();
      if (c > 0) {  // y of the previous slice is done with its stage
        __syncwarp();
        if (lane == 0) wg::bar_arrive(wempty + (step - 1) % STAGES);
      }
      // bias, act and gate on the accumulators; gf[2n + half] is row
      // lane/4 + 8 half, middle columns 64c + 8n + 2(lane%4) + {0, 1}: the A
      // fragments of the W3 product's four k-steps
      uint32_t h1[16], h2[16], gf[16];
      bias_pairs(h1, a1, v2 + V_B1 / 2, c * C);
      bias_pairs(h2, a2, v2 + V_B2 / 2, c * C);
      act_pairs<false>(h1, gf, gf, a.silu);
#pragma unroll
      for (int k = 0; k < 16; ++k) gf[k] = bits(__hmul2_rn(pair(gf[k]), pair(h2[k])));
      // y += g W3[:, 64c..64c+63]ᵀ, left in flight
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        const uint32_t af[4] = {gf[4 * ks], gf[4 * ks + 1], gf[4 * ks + 2], gf[4 * ks + 3]};
        wg::mma_rs128<0>(y, af, wg::desc_k(w + SL_W3, ks, 2 * BLK), c > 0 || ks > 0);
      }
      wg::commit();
    }
    wg::wait<0>();
    __syncwarp();
    if (lane == 0) wg::bar_arrive(wempty + (step - 1) % STAGES);

    // y = bf16(x + bf16(bf16(sum) + b3)) into the x tile in place, the
    // warp's rows, then 16-byte stores of its rows
    uint32_t xf[32];
    wg::frag_load(xf, xu, row0, XBLK);
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 8 * n + 2 * (lane & 3);
        const bf2 z = __hadd2_rn(__floats2bfloat162_rn(y[n][2 * half], y[n][2 * half + 1]),
                                 v2[(V_B3 + col) / 2]);
        xf[2 * n + half] = bits(__hadd2_rn(pair(xf[2 * n + half]), z));
      }
    wg::frag_store(xu, row0, XBLK, xf);
    __syncwarp();
    const long long r0 = t * TM + row0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = 32 * k + lane, r = idx >> 4, ch = idx & 15;
      if (r0 + r < a.rows)
        *reinterpret_cast<uint4*>(a.y + (r0 + r) * H + 8 * ch) = *reinterpret_cast<const uint4*>(
            xt + xs * XT + (ch >> 3) * XBLK + (row0 + r) * 128 + (((ch ^ r) & 7) << 4));
    }
    wg::fence_proxy_async();  // the next TMA load overwrites what this warp wrote
    __syncwarp();
    if (lane == 0) wg::bar_arrive(xempty + xs);
  }
}

}  // namespace

// Bytes of the packed weights the caller allocates (ffn_wide.cuh's image).
extern "C" int ffn128_fwd_image_bytes() { return IMAGE_BYTES; }


// x, y: contiguous bf16 [rows, 128]; img: ffn128_fwd_image_bytes() bytes,
// 16-byte aligned; every weight and bias fp32 on the device, nn.Linear
// layout ([out, in]). Returns the CUDA error code of the launches (0 on
// success).
extern "C" int ffn128_fwd(const void* x, void* y, void* img, long long rows, const void* scale2,
                          const void* scale, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* w3, const void* b3, int silu,
                          void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  PackArgs p = {static_cast<unsigned char*>(img),    static_cast<const float*>(w1),
                static_cast<const float*>(b1),       static_cast<const float*>(w2),
                static_cast<const float*>(b2),       static_cast<const float*>(w3),
                static_cast<const float*>(b3),       static_cast<const float*>(scale2),
                static_cast<const float*>(scale)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaFuncSetAttribute(ffn128_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  ffn128_fwd_pack<<<PACK_BLOCKS, 256, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // the tensor map after a launch: cuTensorMapEncodeTiled needs the
  // context current on this thread (an autograd worker's too), which the
  // launch makes it
  Args a = {};
  if (!wg::tensor_map2(&a.xmap, x, H, static_cast<unsigned long long>(rows), TM))
    return static_cast<int>(cudaErrorInvalidValue);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.img = static_cast<const unsigned char*>(img);
  a.rows = rows;
  a.silu = silu;
  const long long tiles = (rows + TM - 1) / TM;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  ffn128_fwd_kernel<<<grid, THREADS, SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
