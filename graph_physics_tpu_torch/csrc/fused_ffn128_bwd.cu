// Gated feed-forward half of the transformer block at hidden 128,
// backward, for Hopper (sm_90a), on warpgroup products, in clusters of six
// blocks that own the middle between them.
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/fused_ffn.py:
// _ffn_bwd_kernel (:99) with pre_norm=True at hidden 128 (the panels
// workload), called by the custom VJP of fused_gated_ffn (run_bwd, :258).
// The function and every bf16 rounding point are fused_ffn_bwd.cu's, with
// H = 128 and W = 3H = 384:
//   rematerialise t = RMS_norm2(x), n = RMS_0(t), a1, a2, act1, gmid;
//   g_mid = bf16(g W3);  ga1 = bf16(bf16(g_mid * a2) * bf16(act'(a1)));
//   ga2 = bf16(g_mid * act1);  g_h = bf16(ga1 W1 + ga2 W2);
//   _rms_bwd through the block's norm and norm2;  dx = bf16(g + g_in)
// and, summed over all rows in fp32: db3 = sum g, dW3 = g^T gmid,
// db1 = sum ga1, dW1 = ga1^T n, db2 = sum ga2, dW2 = ga2^T n,
// dscale = sum bf16(g_h * u), dscale2 = sum bf16(g_in1 * u0).
// Only the order of the fp32 sums inside a product or a row or column sum
// differs from the JAX kernel's; it is fixed (no atomics), so two calls
// give the same bits.
//
// What bounds it on this card: 8 products of 128 x 384 a row (2 to
// rematerialise, 3 for the cotangents, 3 for the weight gradients), 786,432
// FLOP: at panels' shape (122,880 rows) 96.6 GFLOP, 0.0977 ms at the 989
// TFLOP/s bf16 tensor-core peak; the bytes (x and g read, dx written, 94
// MB) take 0.028 ms at 3.35 TB/s. So it is bound by operations.
//
// Design. Nothing of the middle (ga1, ga2, gmid: 3 x 384 values a row)
// goes to device memory. A cluster of NS = 6 blocks walks 64-row tiles
// together; block r owns middle columns 64r..64r+63 and keeps its slice of
// the packed weights (ffn_wide.cuh: W1 and W2 rows, W3 columns, 48 KB) and
// the vectors in shared memory for the whole call. Its three warpgroups:
//   A (rows):  n = RMS_0(RMS_norm2(x)) on the warp's fragments (a quad of
//              lanes a row; the rows' statistics left for C), written to
//              an SW128 tile; g_mid = g·W3
//              (wgmma m64n64k16, A the g tile, B the W3 columns MN-major),
//              a1, a2 = n·W1ᵀ, n·W2ᵀ (A = n from registers) for its 64
//              columns; the epilogue on the accumulators as bf16 pairs
//              (act and act' of 32 values a thread in one straight run);
//              ga1, ga2 and the gated
//              middle vm = bf16(act1 · a2) to SW128 tiles;
//   B:         dW1 += ga1ᵀ·n and dW2 += ga2ᵀ·n (m64n128k16,
//              both operands MN-major from the tiles), the block's slices
//              held in registers across all of the cluster's tiles (128 a
//              thread), and the column sums of ga1 and ga2 (db1, db2);
//   C:         dW3ᵀ += vmᵀ·g likewise (64 registers) and its share of g_h =
//              ga1·W1 + ga2·W2 (A the ga tiles, B the same W1 and W2 rows
//              MN-major); copies its rank's rows of x and g (rank r: rows
//              64r/6 .. 64(r+1)/6) so that the x/g stage goes back to the
//              loader; sends each row of its g_h share to the block that
//              owns the row (st.async, the bytes counted on the owner's
//              barrier); then its own rows: the six shares added in rank
//              order, bf16(g_h), the two RMS backwards, dx, and the column
//              sums of g, bf16(g_h·u) and bf16(g_in1·u0) (db3, dscale,
//              dscale2); its thread 0 brings the x and g tiles by TMA
//              (64-column boxes, zeros past the last row) into two stages,
//              and the tile after each into L2.
// Hand-offs are mbarriers: the x/g stages (TMA bytes; A and C done), the
// middle tiles (A to B and C; B and C back to A),
// and across the cluster the g_h shares (st.async bytes) and their
// release (one relaxed arrival from every block once its C holds the
// values it read: nothing of theirs is left to order). At the
// end each block writes its slices and sums to its cluster's partials, and
// ffn128_bwd_sum adds the clusters in order. The number of clusters is a
// fixed function of the card and the row count (ffn128_bwd_clusters).
// Shared memory: 1 KB of alignment, weights 48 KB, x/g 2 x 32 KB, n 16
// KB, ga1, ga2, vm 3 x 8 KB, the g_h shares 33 KB, the vectors 2,304
// bytes, the statistics 1 KB, C's rows 11 KB (its column sums at the end)
// and 10 barriers: 205,312 bytes, one block an SM. Registers (384
// threads, at most 168 each): A about 140 (n 32, a1, a2, g_mid 96), B 128
// of accumulators, C 64 and g_h's 64.
// Device memory at panels' shape (122,880 rows, 16 clusters): x and g
// read once a tile by the first block of the cluster to ask, the other
// five served by L2 (62.9 MB); dx written (31.5 MB); the partials, 602,112
// bytes a cluster, written and read back (19.3 MB); the packed weights
// written and read (0.6 MB); the fp32 parameters read and the gradients
// written (1.2 MB): 115.4 MB, against the earlier two-pass design's ~975
// MB (chip_smoke.ffn128_backward_bytes counts the same).

#include "ffn_wide.cuh"


namespace {

using namespace ffnw;

constexpr int THREADS = 3 * 128;  // warpgroups A, B, C
constexpr int TR = 64;            // rows a tile
constexpr int XG = 4 * BLK;       // a stage: the x tile, then the g tile (two blocks each)
constexpr int RMAX = TR / NS + 1;  // rows a rank owns at most
// shared memory (bytes, after the 1024-byte alignment)
constexpr int OFF_XG = SLICE, OFF_N = OFF_XG + 2 * XG, OFF_GA1 = OFF_N + 2 * BLK;
constexpr int OFF_GA2 = OFF_GA1 + BLK, OFF_VM = OFF_GA2 + BLK, OFF_P = OFF_VM + BLK;
constexpr int OFF_VEC = OFF_P + NS * RMAX * H * 4, OFF_INV = OFF_VEC + VEC_BYTES;
constexpr int OFF_ROWS = OFF_INV + 2 * 2 * TR * 4;  // C's rows: [stage][x, g][RMAX][H] bf16
constexpr int OFF_RINV = OFF_ROWS + 2 * 2 * RMAX * H * 2;  // and their [stage][RMAX][inv0, inv1]
constexpr int OFF_BAR = OFF_RINV + 2 * RMAX * 2 * 4;
// C's column sums at the end, [warp][3][H] fp32, over its rows' stages
constexpr int OFF_CS = OFF_ROWS;
static_assert(4 * 3 * H * 4 <= 2 * 2 * RMAX * H * 2, "the column sums fit the rows' stages");
// barriers: the weights, x/g full [2] and empty [2], the middle tiles
// full, freed by B and by C, the partials full and free
enum { B_W, B_XG_FULL, B_XG_EMPTY = B_XG_FULL + 2, B_GA_FULL = B_XG_EMPTY + 2, B_FREE_B,
       B_FREE_C, B_P_FULL, B_P_FREE, N_BARS };
constexpr int SMEM = 1024 + OFF_BAR + N_BARS * 8;
static_assert(SMEM <= 232448, "shared memory of one block");
// a cluster's partials (fp32): dW1, dW2 and dW3ᵀ [3][W][H], db1, db2 [2][W],
// then each rank's db3, dscale, dscale2 [NS][3][H]
constexpr int P_W = 0, P_B = 3 * W * H, P_S = P_B + 2 * W, PART = P_S + NS * 3 * H;
// the gradient buffer: dW1, dW2 [W][H], dW3 [H][W], db1, db2, db3, dscale, dscale2
constexpr int G_W3 = 2 * W * H, G_B1 = 3 * W * H, G_B3 = G_B1 + 2 * W, G_TOTAL = G_B3 + 3 * H;

struct Args {
  CUtensorMap xmap, gmap;   // x, g [rows][H], boxes of 64 columns x TR rows
  __nv_bfloat16* dx;        // [rows, H]
  const unsigned char* img;  // the packed weights (ffn_wide.cuh)
  float* part;              // [clusters][PART]
  float* grads;             // [G_TOTAL]
  long long rows;
  int silu, clusters;
};

struct PackArgs {
  unsigned char* img;
  const float *w1, *b1, *w2, *b2, *w3, *scale2, *scale;
};

__global__ void __launch_bounds__(256) ffn128_bwd_pack(const PackArgs p) {
  pack_image(p.img, p.w1, p.b1, p.w2, p.b2, p.w3, nullptr, p.scale2, p.scale);
}

// two floats to another block's shared memory (``remote``: a mapa address),
// their bytes counted on its barrier ``bar`` (a mapa address)
__device__ __forceinline__ void st_async2(uint32_t remote, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          remote),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// _rms_bwd of one row held by a warp, 4 columns a lane (two bf16 pairs), in
// place on g: v the norm's input, inv its statistic, scale its pairs; ds
// gets the scale's terms bf16(g · bf16(v · bf16(inv)))
__device__ __forceinline__ void row_rms_bwd(bf2 (&g)[2], const bf2 (&v)[2], float inv,
                                            const bf2* scale, bf2 (&ds)[2]) {
  const bf2 ib = __float2bfloat162_rn(inv);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ds[i] = __hmul2_rn(g[i], __hmul2_rn(v[i], ib));
    g[i] = __hmul2_rn(g[i], scale[i]);  // g_u
    const float2 p = __bfloat1622float2(__hmul2_rn(g[i], v[i]));
    dot += p.x;
    dot += p.y;
  }
  dot = warp_sum(dot);
  const float rms = fmaxf(1.0f / inv - 1e-8f, 1e-30f);
  const bf2 corr = __float2bfloat162_rn(dot * (inv * inv) / (H * rms));
#pragma unroll
  for (int i = 0; i < 2; ++i) g[i] = __hsub2_rn(__hmul2_rn(g[i], ib), __hmul2_rn(v[i], corr));
}

__device__ __forceinline__ void add2(float (&s)[4], const bf2 (&v)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    s[2 * i] += f.x;
    s[2 * i + 1] += f.y;
  }
}

__global__ void __cluster_dims__(NS, 1, 1) __launch_bounds__(THREADS, 1)
    ffn128_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t su = wg::smem_u32(sm);
  const bf2* v2 = reinterpret_cast<const bf2*>(sm + OFF_VEC);
  float* recv = reinterpret_cast<float*>(sm + OFF_P);  // [source rank][RMAX][H]: g_h partials
  float* inv_s = reinterpret_cast<float*>(sm + OFF_INV);  // [stage][inv0, inv1][TR]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + OFF_BAR);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, role = warp >> 2;
  const int rank = static_cast<int>(wg::cluster_rank());
  const long long cl = wg::cluster_id(), ncl = wg::cluster_count();
  const long long tiles = (a.rows + TR - 1) / TR;
  const int my_tiles = cl < tiles ? static_cast<int>((tiles - 1 - cl) / ncl + 1) : 0;
  if (tid == 0) {
    wg::bar_init(bar + B_W, 1);
    for (int s = 0; s < 2; ++s) {
      wg::bar_init(bar + B_XG_FULL + s, 1);
      wg::bar_init(bar + B_XG_EMPTY + s, 8);  // A's and C's warps
    }
    wg::bar_init(bar + B_GA_FULL, 4);
    wg::bar_init(bar + B_FREE_B, 4);
    wg::bar_init(bar + B_FREE_C, 4);
    wg::bar_init(bar + B_P_FULL, 1);   // its C's thread 0, and the partials' bytes
    wg::bar_init(bar + B_P_FREE, NS);  // a thread of every block's C
    wg::bar_fence_init();
  }
  __syncthreads();
  wg::cluster_sync();  // every block's barriers are set before any remote arrival

  auto load_xg = [&](int i) {  // tile i of the cluster into stage i % 2; tile i + 1 into L2
    const int s = i & 1, row = static_cast<int>((cl + i * ncl) * TR);
    wg::bar_expect(bar + B_XG_FULL + s, XG);
    for (int kb = 0; kb < 2; ++kb) {
      wg::tma_load2(sm + OFF_XG + s * XG + kb * BLK, &a.xmap, 64 * kb, row, bar + B_XG_FULL + s);
      wg::tma_load2(sm + OFF_XG + s * XG + (2 + kb) * BLK, &a.gmap, 64 * kb, row,
                    bar + B_XG_FULL + s);
    }
    if (i + 1 < my_tiles)
      for (int kb = 0; kb < 2; ++kb) {
        wg::tma_prefetch2(&a.xmap, 64 * kb, static_cast<int>(row + ncl * TR));
        wg::tma_prefetch2(&a.gmap, 64 * kb, static_cast<int>(row + ncl * TR));
      }
  };
  const uint32_t w1 = su + SL_W1, w2 = su + SL_W2, w3 = su + SL_W3, n_t = su + OFF_N;
  const uint32_t ga1_t = su + OFF_GA1, ga2_t = su + OFF_GA2, vm_t = su + OFF_VM;
  float* part = a.part + cl * PART;

  if (role == 0) {  // A: the row products
    const int row0 = 16 * warp;
    bwait<false>(bar + B_W, 0);
    for (int i = 0; i < my_tiles; ++i) {
      const int s = i & 1;
      bwait<false>(bar + B_XG_FULL + s, (i >> 1) & 1);
      __syncwarp();
      const uint32_t x_t = su + OFF_XG + s * XG, g_t = x_t + 2 * BLK;
      // n = RMS_0(RMS_norm2(x)), the warp's 16 rows, as A fragments; the
      // rows' statistics for C
      uint32_t nf[32];
      wg::frag_load(nf, x_t, row0, BLK);
      float inv0[2], inv1[2];
      rms_rows(nf, v2 + V_S2 / 2, inv0);
      rms_rows(nf, v2 + V_S / 2, inv1);
      if ((lane & 3) == 0)
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + (lane >> 2) + 8 * half;
          inv_s[(2 * s) * TR + r] = inv0[half];
          inv_s[(2 * s + 1) * TR + r] = inv1[half];
        }
      if (i > 0) bwait<false>(bar + B_FREE_B, (i - 1) & 1);  // B is done with n and ga1, ga2
      __syncwarp();
      wg::frag_store(n_t, row0, BLK, nf);
      wg::fence_proxy_async();
      // g_mid = g W3[:, 64r..], a1 = n W1[64r..]ᵀ, a2 = n W2[64r..]ᵀ
      float a1[8][4], a2[8][4], gm[8][4];
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks)
        wg::mma_ss64<0, 1>(gm, wg::desc_k(g_t, ks, BLK), wg::desc_mn(w3, ks, 2 * BLK), ks > 0);
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const uint32_t af[4] = {nf[4 * ks], nf[4 * ks + 1], nf[4 * ks + 2], nf[4 * ks + 3]};
        wg::mma_rs64<0>(a1, af, wg::desc_k(w1, ks, BLK), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const uint32_t af[4] = {nf[4 * ks], nf[4 * ks + 1], nf[4 * ks + 2], nf[4 * ks + 3]};
        wg::mma_rs64<0>(a2, af, wg::desc_k(w2, ks, BLK), ks > 0);
      }
      wg::commit();
      wg::wait<0>();
      __syncwarp();
      if (lane == 0) wg::bar_arrive(bar + B_XG_EMPTY + s);  // A is done with x and g

      // the epilogue: bias, act and act' on the accumulators as bf16 pairs
      uint32_t h1[16], h2[16], gq[16], act[16], d[16];
      bias_pairs(h1, a1, v2 + V_B1 / 2, C * rank);
      bias_pairs(h2, a2, v2 + V_B2 / 2, C * rank);
      bias_pairs(gq, gm, nullptr, 0);
      act_pairs<true>(h1, act, d, a.silu);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const bf2 g_mid = pair(gq[k]), a2b = pair(h2[k]), ab = pair(act[k]);
        d[k] = bits(ffn::mul3(g_mid, a2b, pair(d[k])));  // ga1
        gq[k] = bits(__hmul2_rn(g_mid, ab));             // ga2
        h2[k] = bits(__hmul2_rn(ab, a2b));               // vm = bf16(act1 · a2)
      }
      if (i > 0) bwait<false>(bar + B_FREE_C, (i - 1) & 1);  // C is done with ga1, ga2, vm
      __syncwarp();
      wg::frag_store(ga1_t, row0, BLK, d);
      wg::frag_store(ga2_t, row0, BLK, gq);
      wg::frag_store(vm_t, row0, BLK, h2);
      wg::fence_proxy_async();
      __syncwarp();
      if (lane == 0) wg::bar_arrive(bar + B_GA_FULL);
    }
  } else if (role == 1) {  // B: dW1, dW2, db1, db2
    const int bt = tid - 128;
    float d1[16][4], d2[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) d1[n][e] = d2[n][e] = 0.f;
    float cb = 0.f;  // db1 (bt < 64) or db2, column bt % 64
    const unsigned char* cb_tile = sm + (bt < 64 ? OFF_GA1 : OFF_GA2);
    for (int i = 0; i < my_tiles; ++i) {
      bwait<false>(bar + B_GA_FULL, i & 1);
      __syncwarp();
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < TR / 16; ++ks)
        wg::mma_ss128<1, 1>(d1, wg::desc_mn(ga1_t, ks, BLK), wg::desc_mn(n_t, ks, BLK), 1);
#pragma unroll
      for (int ks = 0; ks < TR / 16; ++ks)
        wg::mma_ss128<1, 1>(d2, wg::desc_mn(ga2_t, ks, BLK), wg::desc_mn(n_t, ks, BLK), 1);
      wg::commit();
#pragma unroll 8
      for (int r = 0; r < TR; ++r)
        cb += __bfloat162float(
            *reinterpret_cast<const bf16*>(cb_tile + wg::sw128(r, bt & 63)));
      wg::wait<0>();
      __syncwarp();
      if (lane == 0) wg::bar_arrive(bar + B_FREE_B);
    }
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = C * rank + 16 * (warp & 3) + (lane >> 2) + 8 * half;
        const int k = 8 * n + 2 * (lane & 3);
        *reinterpret_cast<float2*>(part + P_W + j * H + k) =
            make_float2(d1[n][2 * half], d1[n][2 * half + 1]);
        *reinterpret_cast<float2*>(part + P_W + W * H + j * H + k) =
            make_float2(d2[n][2 * half], d2[n][2 * half + 1]);
      }
    part[P_B + (bt >> 6) * W + C * rank + (bt & 63)] = cb;
  } else {  // C: dW3ᵀ, g_h's share, db1, db2, then the tile's rows of this rank
    const int ct = tid - 256, wc = warp - 8, row0 = 16 * wc;
    if (ct == 0) {
      wg::bar_expect(bar + B_W, SLICE + VEC_BYTES);
      wg::bulk_load(sm, a.img + rank * SLICE, SLICE, bar + B_W);
      wg::bulk_load(sm + OFF_VEC, a.img + NS * SLICE, VEC_BYTES, bar + B_W);
      for (int i = 0; i < 2 && i < my_tiles; ++i) load_xg(i);
    }
    __syncwarp();
    float d3[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) d3[n][e] = 0.f;
    float cs[3][4] = {};  // db3, dscale, dscale2 of columns 4·lane..
    const int r_lo = TR * rank / NS, r_hi = TR * (rank + 1) / NS;
    int own_q[2];  // the ranks that own this thread's two accumulator rows
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + (lane >> 2) + 8 * half;
      own_q[half] = 0;
      while (own_q[half] + 1 < NS && r >= TR * (own_q[half] + 1) / NS) ++own_q[half];
    }
    bwait<false>(bar + B_W, 0);
    const bf2* s2p = v2 + V_S2 / 2 + 2 * lane;
    const bf2* s1p = v2 + V_S / 2 + 2 * lane;
    for (int i = 0; i < my_tiles; ++i) {
      const int s = i & 1;
      const long long t = cl + i * ncl;
      const uint32_t g_t = su + OFF_XG + s * XG + 2 * BLK;
      bwait<false>(bar + B_XG_FULL + s, (i >> 1) & 1);  // the tiles' bytes, seen here too
      bwait<false>(bar + B_GA_FULL, i & 1);
      __syncwarp();
      // dW3ᵀ += vmᵀ g, and this block's share of g_h = ga1 W1 + ga2 W2 over
      // its 64 columns
      float gh[16][4];
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < TR / 16; ++ks)
        wg::mma_ss128<1, 1>(d3, wg::desc_mn(vm_t, ks, BLK), wg::desc_mn(g_t, ks, BLK), 1);
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wg::mma_ss128<0, 1>(gh, wg::desc_k(ga1_t, ks, BLK), wg::desc_mn(w1, ks, BLK), ks > 0);
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wg::mma_ss128<0, 1>(gh, wg::desc_k(ga2_t, ks, BLK), wg::desc_mn(w2, ks, BLK), 1);
      wg::commit();
      // this rank's rows of x and g, and their statistics, to its own
      // stage, so that the x/g stage goes back to the loader now
      const int nr = r_hi - r_lo;
      unsigned char* rows_s = sm + OFF_ROWS + s * 2 * RMAX * H * 2;
      float* rinv = reinterpret_cast<float*>(sm + OFF_RINV) + s * RMAX * 2;
      const unsigned char* xs = sm + OFF_XG + s * XG;
      for (int k = ct; k < 2 * nr * 16; k += 128) {
        const int which = k / (nr * 16), lr = (k % (nr * 16)) >> 4, ch = k & 15;
        const int r = r_lo + lr;
        *reinterpret_cast<uint4*>(rows_s + (which * RMAX + lr) * H * 2 + 16 * ch) =
            *reinterpret_cast<const uint4*>(xs + which * 2 * BLK + (ch >> 3) * BLK + r * 128 +
                                            (((ch ^ r) & 7) << 4));
      }
      if (ct < 2 * nr) rinv[ct] = inv_s[(2 * s + (ct & 1)) * TR + r_lo + (ct >> 1)];
      wg::wait<0>();
      __syncwarp();
      if (lane == 0) {
        wg::bar_arrive(bar + B_FREE_C);
        wg::bar_arrive(bar + B_XG_EMPTY + s);  // C is done with x and g
      }
      if (ct == 0 && i + 2 < my_tiles) {
        bwait<false>(bar + B_XG_EMPTY + s, (i >> 1) & 1);
        load_xg(i + 2);
      }
      __syncwarp();
      // each row's partial to the block that owns the row, as stores that
      // count their bytes on its barrier
      if (i > 0) bwait<true>(bar + B_P_FREE, (i - 1) & 1);  // the owners read the last
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = own_q[half], lr = row0 + (lane >> 2) + 8 * half - TR * q / NS;
        const uint32_t base = wg::mapa(wg::smem_u32(recv + (rank * RMAX + lr) * H), q);
        const uint32_t full = wg::mapa(wg::smem_u32(bar + B_P_FULL), q);
#pragma unroll
        for (int n = 0; n < 16; ++n)
          st_async2(base + 4 * (8 * n + 2 * (lane & 3)), gh[n][2 * half], gh[n][2 * half + 1],
                    full);
      }

      // the rows r_lo..r_hi-1 of the tile, a warp a row, 4 columns a lane:
      // first the six partials of each of the warp's rows, then the rows
      if (ct == 0) wg::bar_expect(bar + B_P_FULL, NS * (r_hi - r_lo) * H * 4);
      bwait<true>(bar + B_P_FULL, i & 1);
      constexpr int RW = (RMAX + 3) / 4;  // rows a warp at most
      bf2 gh2[RW][2];  // bf16(g_h) of the warp's rows
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        const int lr = wc + 4 * q;
        if (lr < nr) {
#pragma unroll
          for (int p = 0; p < NS; ++p) {
            const float4 v = *reinterpret_cast<const float4*>(recv + (p * RMAX + lr) * H + 4 * lane);
            acc.x += v.x;
            acc.y += v.y;
            acc.z += v.z;
            acc.w += v.w;
          }
        }
        gh2[q][0] = __floats2bfloat162_rn(acc.x, acc.y);
        gh2[q][1] = __floats2bfloat162_rn(acc.z, acc.w);
      }
      // the values are in registers: the shares may be sent again
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      if (ct == 0) {
#pragma unroll
        for (int r = 0; r < NS; ++r)
          wg::bar_arrive_remote_relaxed(wg::mapa(wg::smem_u32(bar + B_P_FREE), r));
      }
      // the rows: every lane of the warp on all of its rows at once (rows
      // past the rank's or the array's end computed and dropped)
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int lr = wc + 4 * q;
        const long long row = t * TR + r_lo + lr;
        const bool ok = lr < nr && row < a.rows;
        const int l = ok ? lr : 0;
        const uint2 xu = *reinterpret_cast<const uint2*>(rows_s + l * H * 2 + 8 * lane);
        const uint2 gu = *reinterpret_cast<const uint2*>(rows_s + (RMAX + l) * H * 2 + 8 * lane);
        const bf2 xv[2] = {pair(xu.x), pair(xu.y)}, gv[2] = {pair(gu.x), pair(gu.y)};
        const float i0 = rinv[2 * l], i1 = rinv[2 * l + 1];
        const bf2 i0b = __float2bfloat162_rn(i0);
        bf2 tv[2], gr[2] = {gh2[q][0], gh2[q][1]};
        for (int k = 0; k < 2; ++k) tv[k] = ffn::mul3(xv[k], i0b, s2p[k]);
        bf2 ds1[2], ds2[2];
        row_rms_bwd(gr, tv, i1, s1p, ds1);
        row_rms_bwd(gr, xv, i0, s2p, ds2);
        if (ok) {
          add2(cs[0], gv);
          add2(cs[1], ds1);
          add2(cs[2], ds2);
          const bf2 dx[2] = {__hadd2_rn(gv[0], gr[0]), __hadd2_rn(gv[1], gr[1])};
          *reinterpret_cast<uint2*>(a.dx + row * H + 4 * lane) =
              make_uint2(bits(dx[0]), bits(dx[1]));
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = C * rank + 16 * (warp & 3) + (lane >> 2) + 8 * half;
        const int k = 8 * n + 2 * (lane & 3);
        *reinterpret_cast<float2*>(part + P_W + 2 * W * H + j * H + k) =
            make_float2(d3[n][2 * half], d3[n][2 * half + 1]);
      }
    float* csum = reinterpret_cast<float*>(sm + OFF_CS);  // [warp][3][H]
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // every warp is done with its rows
    for (int k = 0; k < 3; ++k)
      for (int e = 0; e < 4; ++e) csum[(wc * 3 + k) * H + 4 * lane + e] = cs[k][e];
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    for (int k = 0; k < 3; ++k) {
      float v = 0.f;
      for (int w = 0; w < 4; ++w) v += csum[(w * 3 + k) * H + ct];
      part[P_S + (rank * 3 + k) * H + ct] = v;
    }
  }
  __syncwarp();
  wg::cluster_sync();  // no block leaves while the cluster may still touch its shared memory
}

// grads[k] = the sum of its partials: the clusters' in order, and for the
// column sums of the rows each rank's in order within a cluster
__global__ void __launch_bounds__(256) ffn128_bwd_sum(const float* part, float* grads,
                                                      int clusters) {
  const int k = blockIdx.x * 256 + threadIdx.x;
  if (k >= G_TOTAL) return;
  float s = 0.f;
  if (k >= G_B3) {
    const int which = (k - G_B3) / H, h = (k - G_B3) % H;
    for (int c = 0; c < clusters; ++c)
      for (int r = 0; r < NS; ++r)
        s += part[static_cast<long long>(c) * PART + P_S + (r * 3 + which) * H + h];
  } else {
    int src;
    if (k < G_W3) {  // dW1, dW2 [W][H]
      src = P_W + k;
    } else if (k < G_B1) {  // dW3 [H][W] from dW3ᵀ
      const int o = (k - G_W3) / W, j = (k - G_W3) % W;
      src = P_W + 2 * W * H + j * H + o;
    } else {  // db1, db2
      src = P_B + k - G_B1;
    }
    for (int c = 0; c < clusters; ++c) s += part[static_cast<long long>(c) * PART + src];
  }
  grads[k] = s;
}

cudaError_t set_smem() {
  return cudaFuncSetAttribute(ffn128_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM);
}

}  // namespace

// Sizes the caller allocates: the packed weights (bytes), a cluster's
// partials and the gradient buffer (fp32 elements).
extern "C" int ffn128_bwd_sizes(int which) {
  return which == 0 ? IMAGE_BYTES : which == 1 ? PART : G_TOTAL;
}

// The clusters a call over ``rows`` rows launches: SMs · 16 / 132 (16 on an
// H100 SXM, which keeps 17 co-resident; they never wait for each other,
// so fewer resident only costs time), at most one a tile. A fixed function
// of the card and the row count, so that the partials add in one order;
// a negative CUDA error code on failure.
extern "C" int ffn128_bwd_clusters(long long rows) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (rows < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (rows + TR - 1) / TR, fixed = sms * 16 / 132 > 0 ? sms * 16 / 132 : 1;
  return static_cast<int>(tiles < fixed ? tiles : fixed);
}

// x, g, dx: contiguous bf16 [rows, 128]; img: ffn128_bwd_sizes(0) bytes,
// 16-byte aligned; part: fp32 [clusters, ffn128_bwd_sizes(1)] with
// clusters = ffn128_bwd_clusters(rows); grads: fp32 [ffn128_bwd_sizes(2)]
// laid out dW1 [384, 128], dW2 [384, 128], dW3 [128, 384], db1, db2 [384],
// db3, dscale, dscale2 [128]; every weight and bias fp32 on the device,
// nn.Linear layout ([out, in]). Returns the CUDA error code of the launches.
extern "C" int ffn128_bwd(const void* x, const void* g, void* dx, void* img, void* part,
                          void* grads, long long rows, const void* scale2, const void* scale,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* w3, int silu, int clusters, void* stream) {
  if (rows < 1 || clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
  PackArgs p = {static_cast<unsigned char*>(img), static_cast<const float*>(w1),
                static_cast<const float*>(b1),    static_cast<const float*>(w2),
                static_cast<const float*>(b2),    static_cast<const float*>(w3),
                static_cast<const float*>(scale2), static_cast<const float*>(scale)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn128_bwd_pack<<<PACK_BLOCKS, 256, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // the tensor maps after a launch: cuTensorMapEncodeTiled needs the
  // context current on this thread (autograd's worker calls the
  // backward), which the launch makes it
  Args a = {};
  if (!wg::tensor_map2(&a.xmap, x, H, static_cast<unsigned long long>(rows), TR) ||
      !wg::tensor_map2(&a.gmap, g, H, static_cast<unsigned long long>(rows), TR))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.img = static_cast<const unsigned char*>(img);
  a.part = static_cast<float*>(part);
  a.grads = static_cast<float*>(grads);
  a.rows = rows;
  a.silu = silu;
  a.clusters = clusters;
  ffn128_bwd_kernel<<<NS * clusters, THREADS, SMEM, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ffn128_bwd_sum<<<(G_TOTAL + 255) / 256, 256, 0, st>>>(a.part, a.grads, clusters);
  return static_cast<int>(cudaGetLastError());
}
