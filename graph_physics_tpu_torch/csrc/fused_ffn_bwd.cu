// Gated feed-forward half of the transformer block, backward, for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
// _ffn_bwd_kernel (:99) with pre_norm=True, called by the custom VJP of
// fused_gated_ffn (run_bwd, :258). Same function, per row x of [N*B, H]
// with its cotangent g (H = 64, W = 3H = 192):
//   rematerialise t = RMS_norm2(x), n = RMS_0(t), a1, a2, act1 = bf16(act(a1)),
//     gmid = bf16(act1 * a2)                            (as fused_ffn.cu)
//   g_mid = bf16(g W3);  ga1 = bf16(bf16(g_mid * a2) * bf16(act'(a1)));
//   ga2 = bf16(g_mid * act1);  g_h = bf16(ga1 W1 + ga2 W2)   (fp32 sums)
//   _rms_bwd through the block's norm (v = t) and norm2 (v = x):
//     g_u = bf16(g_h * scale);  dot = sum bf16(g_u * v);
//     corr = bf16(dot * inv^2 / (H * (1/inv - 1e-8)));
//     g_in = bf16(bf16(g_u * bf16(inv)) - bf16(v * corr))
//   dx = bf16(g + g_in)
// and, summed over all rows in fp32: db3 = sum g, dW3 = g^T gmid,
// db1 = sum ga1, dW1 = ga1^T n, db2 = sum ga2, dW2 = ga2^T n,
// dscale = sum bf16(g_h * u), dscale2 = sum bf16(g_in1 * u0) (u = the
// rounded RMS quotients). Weights are used as bf16 values, as in the
// forward.
//
// What bounds it on this card: the transformer slice (122,880 rows) does
// 8 products of 64 x 192 per row (2 to rematerialise, 3 for the
// cotangents, 3 for the weight gradients), 24.2 GFLOP a block, ~0.024 ms
// on bf16 tensor cores; it must read x and g and write dx, 3 x 15.7 MB,
// ~0.014 ms. This first version runs the products as fp32 FMAs on the
// CUDA cores, whose floor is ~0.36 ms (67 TFLOP/s); mma.sync or wgmma
// tiles are later work.
//
// What the design does about it. The forward stages all weights (146 KB
// of fp32) in shared memory; fp32 accumulators for dW1, dW2 and dW3 would
// add 147 KB, over the 227 KB a block may have. So the work is split in
// four kernels of this source, and no atomics, so the result is
// bit-reproducible. Each row's bf16 n, gmid, ga1, ga2 and the two scale
// terms (768 values, lossless: they are bf16 values) go to a scratch laid
// out [column chunk of 8][row][8], so a warp's stores are contiguous.
//  1. middle pass, one thread per row, W1, W2 (as [W][H]) and W3 (as
//     [H][W]) in shared memory, 146 KB, each read as float4 broadcasts:
//     rematerialise n, then go over the 192-wide middle 8 columns at a
//     time, finishing each chunk's a1, a2, g_mid, gmid, ga1 and ga2 in
//     registers; n and g stay in registers as packed bf16 pairs;
//  2. input pass, one thread per row, W1 and W2 in shared memory: g_h from
//     the scratch's ga1 and ga2, the two RMS backwards, dx. Passes 1 and
//     2 are one pass on the TPU; as one kernel, g_h's 64 sums beside n, g
//     and the chunk spilled out of the 255 registers a thread may have,
//     and it ran slower than the plain PyTorch backward;
//  3. reduction pass, one block per SM over a contiguous range of rows:
//     tiles of 32 rows (with g) go to shared memory as fp32; each thread
//     owns a 4 x 12 tile of each of dW1, dW2 and dW3 (144 fp32 sums in
//     registers) and a few of the vector sums, and writes its block's
//     partial sums;
//  4. one thread per gradient value adds the blocks' partials in order.

#include "ffn_common.cuh"

namespace {

using ffn::act;
using ffn::bf;
using ffn::H;
using ffn::load_row;
using ffn::pack2;
using ffn::THREADS;
using ffn::W;

constexpr int CH = 8;       // middle columns per chunk
constexpr int NC = W / CH;  // chunks
// row pass shared memory, in floats: W1 [W][H], W2 [W][H], W3 [H][W], biases, scales
constexpr int OFF_W2 = W * H;
constexpr int OFF_W3 = 2 * W * H;
constexpr int OFF_B1 = 3 * W * H;
constexpr int OFF_B2 = OFF_B1 + W;
constexpr int OFF_S2 = OFF_B2 + W;
constexpr int OFF_S = OFF_S2 + H;
constexpr int SMEM_ROW = OFF_S + H;
// pass 2 shared memory, in floats: W1 [W][H], W2 [W][H], scales
constexpr int IN_S2 = 2 * W * H, IN_S = IN_S2 + H, SMEM_IN = IN_S + H;

// scratch columns, in chunks of 8 bf16 values: n, gmid, ga1, ga2, the two
// scale terms; the reduction pass appends g as chunks SC_G.. of its tile
constexpr int SC_N = 0, SC_GMID = H / 8, SC_GA1 = SC_GMID + NC, SC_GA2 = SC_GA1 + NC;
constexpr int SC_DS = SC_GA2 + NC, SC_DS2 = SC_DS + H / 8, SC_G = SC_DS2 + H / 8;
constexpr int TILE_CHUNKS = SC_G + H / 8;  // 104
// reduction pass: rows per tile, floats per tile row (padded against bank conflicts)
constexpr int TILE = 32;
constexpr int ROWF = TILE_CHUNKS * 8 + 4;
// the gradient buffer: dW1, dW2 [W][H], dW3 [H][W], db1, db2, db3, dscale, dscale2
constexpr int G_W2 = W * H, G_W3 = 2 * W * H, G_B1 = 3 * W * H, G_B2 = G_B1 + W;
constexpr int G_B3 = G_B2 + W, G_S = G_B3 + H, G_S2 = G_S + H, G_TOTAL = G_S2 + H;

struct Args {
  const __nv_bfloat16* x;      // [rows, H]
  const __nv_bfloat16* g;      // [rows, H] cotangent of y
  __nv_bfloat16* dx;           // [rows, H]
  __nv_bfloat16* scratch;      // [SC_G chunks][rows][8]
  float* partials;             // [parts][G_TOTAL]
  float* grads;                // [G_TOTAL]
  const float* scale2;         // norm2 scale [H]
  const float* scale;          // the block's own RMSNorm scale [H]
  const float* w1;             // nn.Linear [W, H]
  const float* b1;             // [W]
  const float* w2;             // [W, H]
  const float* b2;             // [W]
  const float* w3;             // [H, W]
  long long rows;
  int silu;
};

__device__ __forceinline__ float act_grad(float x, int silu) {
  if (silu) {
    const float s = 1.0f / (1.0f + expf(-x));
    return s * (1.0f + x * (1.0f - s));
  }
  return 0.5f * (1.0f + erff(x * 0.7071067811865476f)) +
         x * expf(-0.5f * x * x) * 0.3989422804014327f;
}

__device__ __forceinline__ float unpack(const uint32_t (&pk)[H / 2], int i) {
  return (i & 1) ? __uint_as_float(pk[i / 2] & 0xffff0000u) : __uint_as_float(pk[i / 2] << 16);
}

// 8 floats (bf16 values) as one 16-byte store of scratch chunk c, row t
__device__ __forceinline__ void store_chunk(const Args& a, int c, long long t, const float* v) {
  uint4* d = reinterpret_cast<uint4*>(a.scratch + (c * a.rows + t) * 8);
  *d = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// _rms_bwd on one row, in place on g (bf16 values in, bf16 values out):
// v_of(i) gives the norm's input, u = bf16(v * bf16(inv)); the scale
// terms bf16(g * u) go to scratch chunks c0..c0+7
template <typename V>
__device__ __forceinline__ void rms_bwd(const Args& a, float (&g)[H], V v_of, float inv,
                                        const float* scale, int c0, long long t) {
  const float inv_b = bf(inv);
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < H / 8; ++c) {
    float ds[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = 8 * c + q;
      const float v = v_of(i);
      ds[q] = bf(g[i] * bf(v * inv_b));
      g[i] = bf(g[i] * scale[i]);  // g_u
      dot += bf(g[i] * v);
    }
    store_chunk(a, c0 + c, t, ds);
  }
  const float rms = fmaxf(1.0f / inv - 1e-8f, 1e-30f);
  const float corr = bf(dot * (inv * inv) / (H * rms));
#pragma unroll
  for (int i = 0; i < H; ++i) g[i] = bf(bf(g[i] * inv_b) - bf(v_of(i) * corr));
}

// pass 1: the weights W1, W2, W3 in shared memory; per row, n and the
// middle's gmid, ga1, ga2 to the scratch
__global__ void __launch_bounds__(THREADS, 1) ffn_bwd_mid_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < H * W; i += blockDim.x) {
    smem[i] = bf(a.w1[i]);
    smem[OFF_W2 + i] = bf(a.w2[i]);
    smem[OFF_W3 + i] = bf(a.w3[i]);
  }
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    smem[OFF_B1 + j] = bf(a.b1[j]);
    smem[OFF_B2 + j] = bf(a.b2[j]);
  }
  for (int o = threadIdx.x; o < H; o += blockDim.x) {
    smem[OFF_S2 + o] = bf(a.scale2[o]);
    smem[OFF_S + o] = bf(a.scale[o]);
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < a.rows;
       t += stride) {
    // rematerialise n = RMS_0(RMS_norm2(x)); keep n and g as packed bf16 pairs
    uint32_t npk[H / 2], gpk[H / 2];
    {
      float v[H];
      load_row(v, a.x + t * H);
      ffn::rms_norm(v, smem + OFF_S2);
      ffn::rms_norm(v, smem + OFF_S);
#pragma unroll
      for (int c = 0; c < H / 8; ++c) store_chunk(a, SC_N + c, t, v + 8 * c);
#pragma unroll
      for (int i = 0; i < H / 2; ++i) npk[i] = pack2(v[2 * i], v[2 * i + 1]);
      load_row(v, a.g + t * H);
#pragma unroll
      for (int i = 0; i < H / 2; ++i) gpk[i] = pack2(v[2 * i], v[2 * i + 1]);
    }

#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      const int j0 = c * CH;
      // a1, a2 of the chunk's 8 middle columns: rows of W1, W2 over the input
      float a1[CH], a2[CH];
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float4* w1 = reinterpret_cast<const float4*>(smem + (j0 + jj) * H);
        const float4* w2 = reinterpret_cast<const float4*>(smem + OFF_W2 + (j0 + jj) * H);
        float s1a = 0.f, s2a = 0.f;
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 p = w1[q], r = w2[q];
          const float n0 = unpack(npk, 4 * q), n1 = unpack(npk, 4 * q + 1);
          const float n2 = unpack(npk, 4 * q + 2), n3 = unpack(npk, 4 * q + 3);
          s1a = fmaf(n0, p.x, fmaf(n1, p.y, fmaf(n2, p.z, fmaf(n3, p.w, s1a))));
          s2a = fmaf(n0, r.x, fmaf(n1, r.y, fmaf(n2, r.z, fmaf(n3, r.w, s2a))));
        }
        a1[jj] = s1a;
        a2[jj] = s2a;
      }
      // g_mid of the chunk: W3 columns j0..j0+7 over the output
      float gm[CH];
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) gm[jj] = 0.f;
#pragma unroll
      for (int o = 0; o < H; ++o) {
        const float go = unpack(gpk, o);
        const float4* w3 = reinterpret_cast<const float4*>(smem + OFF_W3 + o * W + j0);
        const float4 p = w3[0], r = w3[1];
        gm[0] = fmaf(go, p.x, gm[0]);
        gm[1] = fmaf(go, p.y, gm[1]);
        gm[2] = fmaf(go, p.z, gm[2]);
        gm[3] = fmaf(go, p.w, gm[3]);
        gm[4] = fmaf(go, r.x, gm[4]);
        gm[5] = fmaf(go, r.y, gm[5]);
        gm[6] = fmaf(go, r.z, gm[6]);
        gm[7] = fmaf(go, r.w, gm[7]);
      }
      float gmid[CH], ga1[CH], ga2[CH];
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float h1 = bf(bf(a1[jj]) + smem[OFF_B1 + j0 + jj]);
        const float h2 = bf(bf(a2[jj]) + smem[OFF_B2 + j0 + jj]);
        const float act1 = bf(act(h1, a.silu));
        const float g_mid = bf(gm[jj]);
        gmid[jj] = bf(act1 * h2);
        ga1[jj] = bf(bf(g_mid * h2) * bf(act_grad(h1, a.silu)));
        ga2[jj] = bf(g_mid * act1);
      }
      store_chunk(a, SC_GMID + c, t, gmid);
      store_chunk(a, SC_GA1 + c, t, ga1);
      store_chunk(a, SC_GA2 + c, t, ga2);
    }
  }
}

// the 8 bf16 values of scratch chunk c, row t, as floats
__device__ __forceinline__ void load_chunk(const Args& a, int c, long long t, float (&v)[8]) {
  ffn::unpack8(__ldg(reinterpret_cast<const uint4*>(a.scratch + (c * a.rows + t) * 8)), v);
}

// pass 2: W1, W2 in shared memory; per row, g_h = ga1 W1 + ga2 W2 from the
// scratch, the two RMS backwards (their scale terms to the scratch), dx
__global__ void __launch_bounds__(THREADS, 1) ffn_bwd_in_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < H * W; i += blockDim.x) {
    smem[i] = bf(a.w1[i]);
    smem[OFF_W2 + i] = bf(a.w2[i]);
  }
  for (int o = threadIdx.x; o < H; o += blockDim.x) {
    smem[IN_S2 + o] = bf(a.scale2[o]);
    smem[IN_S + o] = bf(a.scale[o]);
  }
  __syncthreads();
  const float* s2 = smem + IN_S2;
  const float* s1 = smem + IN_S;

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < a.rows;
       t += stride) {
    float inv0, inv1;  // the two norms' statistics, from x
    {
      float v[H];
      load_row(v, a.x + t * H);
      inv0 = ffn::rms_inv(v);
      const float inv0_b = bf(inv0);
#pragma unroll
      for (int i = 0; i < H; ++i) v[i] = bf(bf(v[i] * inv0_b) * s2[i]);  // t
      inv1 = ffn::rms_inv(v);
    }

    float gh[H];
#pragma unroll
    for (int i = 0; i < H; ++i) gh[i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      float ga1[CH], ga2[CH];
      load_chunk(a, SC_GA1 + c, t, ga1);
      load_chunk(a, SC_GA2 + c, t, ga2);
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float4* w1 = reinterpret_cast<const float4*>(smem + (c * CH + jj) * H);
        const float4* w2 = reinterpret_cast<const float4*>(smem + OFF_W2 + (c * CH + jj) * H);
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 p = w1[q], r = w2[q];
          gh[4 * q + 0] = fmaf(ga1[jj], p.x, fmaf(ga2[jj], r.x, gh[4 * q + 0]));
          gh[4 * q + 1] = fmaf(ga1[jj], p.y, fmaf(ga2[jj], r.y, gh[4 * q + 1]));
          gh[4 * q + 2] = fmaf(ga1[jj], p.z, fmaf(ga2[jj], r.z, gh[4 * q + 2]));
          gh[4 * q + 3] = fmaf(ga1[jj], p.w, fmaf(ga2[jj], r.w, gh[4 * q + 3]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < H; ++i) gh[i] = bf(gh[i]);

    // through the block's norm (input t, recomputed from x), then through
    // norm2 (input x); then dx = g + g_in, 8 values at a time
    float xv[H];
    load_row(xv, a.x + t * H);
    const float inv0_b = bf(inv0);
    rms_bwd(a, gh, [&](int i) { return bf(bf(xv[i] * inv0_b) * s2[i]); }, inv1, s1, SC_DS, t);
    rms_bwd(a, gh, [&](int i) { return xv[i]; }, inv0, s2, SC_DS2, t);
    const uint4* g = reinterpret_cast<const uint4*>(a.g + t * H);
    uint4* d = reinterpret_cast<uint4*>(a.dx + t * H);
#pragma unroll
    for (int c = 0; c < H / 8; ++c) {
      float v[8];
      ffn::unpack8(__ldg(g + c), v);
      uint32_t wd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wd[q] = pack2(bf(v[2 * q] + gh[8 * c + 2 * q]), bf(v[2 * q + 1] + gh[8 * c + 2 * q + 1]));
      d[c] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

// one block per part: partial sums of every gradient over its rows
__global__ void __launch_bounds__(THREADS, 1) ffn_bwd_reduce_kernel(const Args a) {
  extern __shared__ __align__(16) float tile[];  // [TILE][ROWF]
  const int tid = threadIdx.x;
  const int ig = tid % (H / 4);  // input (dW1, dW2) or output (dW3) columns 4ig..4ig+3
  const int jg = tid / (H / 4);  // middle columns 12jg..12jg+11
  constexpr int JN = W / (THREADS / (H / 4));  // 12
  const long long per = (a.rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = per * blockIdx.x;
  const long long r1 = r0 + per < a.rows ? r0 + per : a.rows;

  float acc1[4][JN], acc2[4][JN], acc3[4][JN];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < JN; ++jj) acc1[ii][jj] = acc2[ii][jj] = acc3[ii][jj] = 0.f;
  float vb1 = 0.f, vb2 = 0.f, vb3 = 0.f, vs = 0.f, vs2 = 0.f;

  for (long long base = r0; base < r1; base += TILE) {
    __syncthreads();
    for (int e = tid; e < TILE * TILE_CHUNKS; e += THREADS) {
      const int tr = e % TILE, ch = e / TILE;
      const long long r = base + tr;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < r1)
        u = ch < SC_G ? __ldg(reinterpret_cast<const uint4*>(a.scratch + (ch * a.rows + r) * 8))
                      : __ldg(reinterpret_cast<const uint4*>(a.g + r * H + (ch - SC_G) * 8));
      float v[8];
      ffn::unpack8(u, v);
      float4* dst = reinterpret_cast<float4*>(tile + tr * ROWF + ch * 8);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
#pragma unroll 1
    for (int tr = 0; tr < TILE; ++tr) {
      const float* row = tile + tr * ROWF;
      const float4 n4 = *reinterpret_cast<const float4*>(row + SC_N * 8 + 4 * ig);
      const float4 g4 = *reinterpret_cast<const float4*>(row + SC_G * 8 + 4 * ig);
      const float nv[4] = {n4.x, n4.y, n4.z, n4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int q = 0; q < JN / 4; ++q) {
        const int j = JN * jg + 4 * q;
        const float4 m4 = *reinterpret_cast<const float4*>(row + SC_GMID * 8 + j);
        const float4 p4 = *reinterpret_cast<const float4*>(row + SC_GA1 * 8 + j);
        const float4 r4 = *reinterpret_cast<const float4*>(row + SC_GA2 * 8 + j);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc1[ii][4 * q + k] = fmaf(nv[ii], pv[k], acc1[ii][4 * q + k]);
            acc2[ii][4 * q + k] = fmaf(nv[ii], rv[k], acc2[ii][4 * q + k]);
            acc3[ii][4 * q + k] = fmaf(gv[ii], mv[k], acc3[ii][4 * q + k]);
          }
      }
      if (tid < W) {
        vb1 += row[SC_GA1 * 8 + tid];
        vb2 += row[SC_GA2 * 8 + tid];
      }
      if (tid < H) {
        vb3 += row[SC_G * 8 + tid];
        vs += row[SC_DS * 8 + tid];
        vs2 += row[SC_DS2 * 8 + tid];
      }
    }
  }

  float* out = a.partials + static_cast<long long>(blockIdx.x) * G_TOTAL;
#pragma unroll
  for (int jj = 0; jj < JN; ++jj) {
    const int j = JN * jg + jj;
    *reinterpret_cast<float4*>(out + j * H + 4 * ig) =
        make_float4(acc1[0][jj], acc1[1][jj], acc1[2][jj], acc1[3][jj]);
    *reinterpret_cast<float4*>(out + G_W2 + j * H + 4 * ig) =
        make_float4(acc2[0][jj], acc2[1][jj], acc2[2][jj], acc2[3][jj]);
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int q = 0; q < JN / 4; ++q)
      *reinterpret_cast<float4*>(out + G_W3 + (4 * ig + ii) * W + JN * jg + 4 * q) =
          make_float4(acc3[ii][4 * q], acc3[ii][4 * q + 1], acc3[ii][4 * q + 2],
                      acc3[ii][4 * q + 3]);
  if (tid < W) {
    out[G_B1 + tid] = vb1;
    out[G_B2 + tid] = vb2;
  }
  if (tid < H) {
    out[G_B3 + tid] = vb3;
    out[G_S + tid] = vs;
    out[G_S2 + tid] = vs2;
  }
}

// grads[k] = sum over the parts of partials[part][k], in part order
__global__ void __launch_bounds__(THREADS) ffn_bwd_sum_kernel(const Args a, int parts) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= G_TOTAL) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += a.partials[static_cast<long long>(p) * G_TOTAL + k];
  a.grads[k] = s;
}

}  // namespace

// x, g, dx: contiguous bf16 [rows, 64]; scratch: bf16 [rows * 768];
// partials: fp32 [parts, 37440]; grads: fp32 [37440], laid out dW1 [192,
// 64], dW2 [192, 64], dW3 [64, 192], db1, db2 [192], db3, dscale,
// dscale2 [64]; every weight and bias fp32 on the device, nn.Linear
// layout ([out, in]). Returns the CUDA error code of the launches (0 on
// success).
extern "C" int ffn_bwd(const void* x, const void* g, void* dx, void* scratch, void* partials,
                       void* grads, long long rows, const void* scale2, const void* scale,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       const void* w3, const void* b3, int silu, int parts, void* stream) {
  (void)b3;  // the output bias does not enter the backward
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.scratch = static_cast<__nv_bfloat16*>(scratch);
  a.partials = static_cast<float*>(partials);
  a.grads = static_cast<float*>(grads);
  a.scale2 = static_cast<const float*>(scale2);
  a.scale = static_cast<const float*>(scale);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.w3 = static_cast<const float*>(w3);
  a.rows = rows;
  a.silu = silu;
  if (rows < 1 || parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_row = sizeof(float) * SMEM_ROW;
  const size_t smem_in = sizeof(float) * SMEM_IN;
  const size_t smem_tile = sizeof(float) * TILE * ROWF;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_mid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_row));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ffn_bwd_in_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_in));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ffn_bwd_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_tile));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const long long need = (rows + THREADS - 1) / THREADS;
  const int grid = static_cast<int>(need < sms ? need : sms);
  ffn_bwd_mid_kernel<<<grid, THREADS, smem_row, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_in_kernel<<<grid, THREADS, smem_in, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_reduce_kernel<<<parts, THREADS, smem_tile, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_sum_kernel<<<(G_TOTAL + THREADS - 1) / THREADS, THREADS, 0, st>>>(a, parts);
  return static_cast<int>(cudaGetLastError());
}
