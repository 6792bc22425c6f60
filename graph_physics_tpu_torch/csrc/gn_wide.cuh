// The GraphNetBlock kernels at hidden 64 and 128 (rows 1-4 of PERF.md's
// table at the wide widths): the warp tiles, the warpgroup products, the
// MLPs' packed weights, the shared-memory plan of a pass, the ring of row
// tiles, and the kernels the forward (gn_wide_fwd.cuh) and the backward
// (gn_wide_bwd.cuh) share: the weight packing, the node pre-pass and the
// edge encoder's forward. Each library that includes it is compiled for
// one width, nvcc -DGN_WIDE_H=64 or -DGN_WIDE_H=128 (ops/kernel_build.py:
// FLAGS); the hidden-32 sources (gn_tile.cuh, gn_fwd.cuh,
// gn_bwd_passes.cuh) are another family and keep their bits.
//
// A warp tile is 16 rows of an H-wide bf16 stream: the samples b0..b0+15
// of one edge row or one node of a [rows, B, H] array (samples past B are
// zero rows that are never stored). A warp holds its tile in the m16n8
// accumulator layout as bf16 pairs, H / 4 registers a lane: f[2n + half] is
// row lane/4 + 8·half, columns 8n + 2(lane%4) + {0, 1}, and f[4ks..4ks+3]
// is the A fragment of k-step ks. That is also the fragment of a
// warpgroup product's A operand and accumulator (each warp its 16 of the
// 64 rows), so the numerics are unchanged from the m16n8k16 tiles: the JAX
// kernel's _mlp_fwd / _rms_fwd / _mlp_bwd (fused_gnblock.py:182-290), bf16
// values, fp32 sums, every bf16 rounding point kept, only the order of the
// fp32 sums inside a product or a row sum differs.
//
// The tile of a product is a warpgroup's four warp tiles, 64 (row or node,
// sample) pairs: warp w of the group takes warp item 4·g + w of the pass's
// enumeration (row-major over (row, 16-sample chunk)), so at B >= 64 a tile
// is 64 samples of one row and below 64 samples it spans 2 to 4 rows or
// nodes, with no padding sample computed past what the 16-sample chunks
// need. Every product is wgmma.mma_async m64nHk16 (wgmma_common.cuh): A the
// four warps' tiles in registers, B the layer's weights in shared memory,
// read by the tensor cores once for 64 rows (the m16n8k16 tiles read them
// through ldmatrix once for 16). A layer's output goes from the fp32
// accumulator, through bias, activation and bf16 rounding, into registers
// as the next product's A operand.
//
// Weights: a call first packs every MLP it runs (pack kernel) into a bf16
// image in the 128-byte swizzled K-major layout wgmma reads; a pass's block
// loads its MLP's image with one cp.async.bulk on an mbarrier. A layer
// image is H·H bf16 (32 KB at 128). An MLP whose layers do not all fit
// beside the ring (plan_pass) runs on blocks of one warpgroup that keep
// its first layers resident and take the rest through two slots filled
// one layer ahead, in the order the pass uses them (bulk copies of the
// packed bf16 image from L2): 32 KB a use for 64 rows, where the m16n8k16
// tiles read 64 KB of fp32 weights from L2 for every 16 rows.
//
// Row tiles: the passes' per-row streams (e, the node partials, the
// cotangents) come through a ring of warp tiles in shared memory: lane 0
// of each warp asks TMA for the next item's tiles (boxes of 64 columns x 16
// samples, 128-byte swizzled, zero past B) as soon as it has read the
// current one into registers, so the next loads are in flight while the
// warpgroup runs its products.
#pragma once

#ifndef GN_WIDE_H
#error "compile with -DGN_WIDE_H=64 or -DGN_WIDE_H=128"
#endif

#include "act_common.cuh"
#include "gn_nk_common.cuh"
#include "gn_rows.cuh"
#include "mma_common.cuh"
#include "wgmma_common.cuh"

// kernel names carry the width: gnw128_edge_fwd, ...
#define GNW_NAME2(h, n) gnw##h##_##n
#define GNW_NAME1(h, n) GNW_NAME2(h, n)
#define GNW(n) GNW_NAME1(GN_WIDE_H, n)

namespace gnw {

using tc::quad_sum;
using gn_nk::Mlp;
using bf16 = __nv_bfloat16;
using bf2 = __nv_bfloat162;

constexpr int H = GN_WIDE_H;  // hidden width
static_assert(H == 64 || H == 128, "the wide GraphNetBlock kernels are built for 64 and 128");
using gn_nk::MAXL;            // most Dense layers per MLP
constexpr int NF = H / 4;     // bf16-pair registers of a tile, a lane
constexpr int NT = H / 8;     // n8 tiles of a tile's width
constexpr int KS = H / 16;    // k-steps of a tile's width
constexpr int KB = H / 64;    // 64-column blocks of a tile's width
constexpr int WG_THREADS = 128;             // a warpgroup
constexpr int BLOCK_BYTES = H * 128;        // a 64-column block of an H-row weight image
constexpr int LAYER_BYTES = H * H * 2;      // an H x H layer's image
constexpr int TILE_BYTES = KB * 16 * 128;   // a warp tile in the ring (KB boxes)
// the dynamic shared memory of a block on this card (227 KB)
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ uint32_t bits(bf2 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ bf2 pair(uint32_t u) { return *reinterpret_cast<bf2*>(&u); }
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ void zero_frag(uint32_t (&f)[NF]) {
#pragma unroll
  for (int i = 0; i < NF; ++i) f[i] = 0u;
}

__device__ __forceinline__ void zero_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// the 16 x H tile at src (rows H apart; rows >= nv read as 0) straight
// into fragments: the sender pass's gathers, whose rows L1 keeps
__device__ __forceinline__ void tile_load(uint32_t (&f)[NF], const bf16* src, int nv) {
  const int lane = lane_id();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
    if (r < nv) {
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(src + static_cast<long long>(r) * H) + (lane & 3);
#pragma unroll
      for (int n = 0; n < NT; ++n) f[2 * n + half] = p[4 * n];
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) f[2 * n + half] = 0u;
    }
  }
}

// columns 0..H-1 of 16 raw rows of fe <= H features (row-major), zero past
// fe and on rows >= nv
__device__ __forceinline__ void raw_load(uint32_t (&f)[NF], const bf16* raw, int fe, int nv) {
  const int lane = lane_id();
  const unsigned short* u = reinterpret_cast<const unsigned short*>(raw);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (lane >> 2) + 8 * half;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * (lane & 3);
      const long long at = static_cast<long long>(r) * fe + c;
      const uint32_t lo = r < nv && c < fe ? u[at] : 0u;
      const uint32_t hi = r < nv && c + 1 < fe ? u[at + 1] : 0u;
      f[2 * n + half] = lo | (hi << 16);
    }
  }
}


// ---- warpgroup products: all four warps of the group call them together ----

// d = A · W[:, 16·k0 ..]ᵀ over ``ksteps`` k-steps (d += with ``acc``): A the
// warp tiles in registers (their first ksteps k-steps), W the image at
// shared address ``w`` (an nn.Linear [H out][in] weight, K-major). The
// _issue forms return with the product in flight: until wg::wait<0> the
// caller may read A but not change it, and must not touch d.
__device__ __forceinline__ void awt_issue(float (&d)[NT][4], const uint32_t (&a)[NF],
                                          uint32_t w, int k0, bool acc, int ksteps = KS) {
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < ksteps) {
      const uint32_t af[4] = {a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3]};
      wg::mma_rs<0>(d, af, wg::desc_k(w, k0 + ks, BLOCK_BYTES), acc || ks > 0);
    }
  }
  wg::commit();
}

__device__ __forceinline__ void awt(float (&d)[NT][4], const uint32_t (&a)[NF], uint32_t w,
                                    int k0, bool acc, int ksteps = KS) {
  awt_issue(d, a, w, k0, acc, ksteps);
  wg::wait<0>();
}

// d = G · W[:, 64·nb0 .. 64·nb0 + H - 1]: G the warp tiles over W's H
// outputs (a Dense layer's input gradient), W the image at ``w`` read
// MN-major
__device__ __forceinline__ void gw_issue(float (&d)[NT][4], const uint32_t (&g)[NF], uint32_t w,
                                         int nb0) {
  wg::fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t af[4] = {g[4 * ks], g[4 * ks + 1], g[4 * ks + 2], g[4 * ks + 3]};
    wg::mma_rs<1>(d, af, wg::desc_mn(w + nb0 * BLOCK_BYTES, ks, BLOCK_BYTES), ks > 0);
  }
  wg::commit();
}

__device__ __forceinline__ void gw(float (&d)[NT][4], const uint32_t (&g)[NF], uint32_t w,
                                   int nb0) {
  gw_issue(d, g, w, nb0);
  wg::wait<0>();
}

// ---- the MLPs' packed images ----

// An MLP's image (global, then shared): layer 0's first width0 input
// columns as pad64(width0) / 64 blocks, layers 1.. as LAYER_BYTES each
// (wgmma_common.cuh:pack_rows), then the biases [n][H] and the RMSNorm
// scale [H] as bf16
__host__ __device__ inline int layer0_bytes(int width0) { return (width0 + 63) / 64 * BLOCK_BYTES; }
__host__ __device__ inline long long layer_offset(int width0, int l) {
  return l == 0 ? 0 : layer0_bytes(width0) + static_cast<long long>(l - 1) * LAYER_BYTES;
}
__host__ __device__ inline int vec_bytes(int n_layers) { return (n_layers + 1) * H * 2; }
__host__ __device__ inline long long image_bytes(int width0, int n_layers) {
  return layer_offset(width0, n_layers) + vec_bytes(n_layers);
}

constexpr int MAX_PACK = 4 * MAXL + 2;  // matrices a pack launch writes
constexpr int MAX_VECS = 4;             // vector blocks a pack launch writes

// One launch packs a call's MLPs: mat[i] the columns col0..col0+width-1 of
// an fp32 [H][in_dim] weight, vec[i] an MLP's biases and scale
struct PackArgs {
  struct Mat {
    const float* w;
    bf16* dst;
    int in_dim, col0, width;
  } mat[MAX_PACK];
  struct Vec {
    const float* b[MAXL];
    const float* scale;
    bf16* dst;
    int n;
  } vec[MAX_VECS];
  int n_mat, n_vec;
};

__global__ void __launch_bounds__(256) GNW(pack)(const PackArgs p) {
  const int job = blockIdx.y;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, threads = gridDim.x * blockDim.x;
  if (job < p.n_mat) {
    const PackArgs::Mat& m = p.mat[job];
    wg::pack_rows(m.dst, m.w, H, m.in_dim, m.col0, m.width, tid, threads);
    return;
  }
  const PackArgs::Vec& v = p.vec[job - p.n_mat];
  for (int i = tid; i < (v.n + 1) * H; i += threads) {
    const int l = i / H, o = i % H;
    const float x = l < v.n ? v.b[l][o] : (v.scale ? v.scale[o] : 0.f);
    v.dst[i] = __float2bfloat16_rn(x);
  }
}

// adds an MLP (layer 0 width0 of in_dim columns from col0) to a pack
// launch, its image at dst
inline void add_pack(PackArgs& p, const Mlp& m, int col0, int width0, bf16* dst) {
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  for (int l = 0; l < m.n_layers; ++l)
    p.mat[p.n_mat++] = {m.w[l], reinterpret_cast<bf16*>(d + layer_offset(width0, l)),
                        l == 0 ? m.in_dim : H, l == 0 ? col0 : 0, l == 0 ? width0 : H};
  PackArgs::Vec& v = p.vec[p.n_vec++];
  for (int l = 0; l < MAXL; ++l) v.b[l] = m.b[l];
  v.scale = m.scale;
  v.dst = reinterpret_cast<bf16*>(d + layer_offset(width0, m.n_layers));
  v.n = m.n_layers;
}

inline cudaError_t launch_pack(const PackArgs& p, cudaStream_t stream) {
  GNW(pack)<<<dim3(8, p.n_mat + p.n_vec), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---- a pass's shared memory ----

// Bytes of a pass's shared memory: the 1024-byte alignment, its MLP's
// first ``resident`` layers, two streamed-layer slots when resident < n,
// ``ns`` ring tiles and a staging tile for each of its 4·wgs warps, the
// vectors and the barriers (weights, the two slots, the ring)
__host__ __device__ inline long long pass_bytes(int width0, int n, int resident, int wgs,
                                                int ns) {
  return 1024 + layer_offset(width0, resident) + (resident < n ? 2LL * LAYER_BYTES : 0) +
         4LL * wgs * (ns + 1) * TILE_BYTES + vec_bytes(n) + 8LL * (3 + 4 * wgs * ns);
}

// How a pass runs an MLP of n layers (layer 0 width0 wide) beside ns ring
// tiles a warp: blocks of two warpgroups with every layer resident where
// that fits, else of one warpgroup, with as many layers resident as fit
// beside the streamed-layer slots
struct Plan {
  int wgs, resident;
};

__host__ __device__ inline Plan plan_pass(int width0, int n, int ns) {
  if (pass_bytes(width0, n, n, 2, ns) <= SMEM_LIMIT) return {2, n};
  if (pass_bytes(width0, n, n, 1, ns) <= SMEM_LIMIT) return {1, n};
  int r = n - 1;
  while (r > 1 && pass_bytes(width0, n, r, 1, ns) > SMEM_LIMIT) --r;
  return {1, r};
}

// An MLP in a pass's shared memory: the resident layers at ``w``, the
// vectors, and (one-warpgroup blocks) the two slots that the streamed
// layers pass through, in the order of ``stream_layer``
struct WMlp {
  uint32_t w;            // shared address of layer 0's image
  uint32_t slots;        // shared address of the two streamed-layer slots
  const bf16* vec;       // biases [n][H], then the scale [H]
  const unsigned char* img;  // the global image
  uint64_t* slot_bar;    // the slots' barriers
  int width0, n_layers, resident, act;
  bool norm, both;       // both: each item runs the layers forward, then backward
  int uses;              // streamed layers taken so far
  __device__ const bf16* bias(int l) const { return vec + H * l; }
  __device__ const bf16* scale() const { return vec + H * n_layers; }
  // the streamed layer of use u: layers resident..n-1, then (both) back
  __device__ int stream_layer(int u) const {
    const int k = n_layers - resident;
    const int i = u % (both ? 2 * k : k);
    return i < k ? resident + i : n_layers - 1 - (i - k);
  }
};

// The shared memory a pass's kernel carves (pass_bytes): its MLP and its
// warps' ring tiles, staging tiles and barriers
struct Carve {
  unsigned char* ring;  // [warp][ns + 1] tiles: the ring's, then the staging tile
  uint64_t* ring_bar;   // [warp][ns]
  int ns;
  // the warp's staging tile (stage_load, stage_store)
  __device__ unsigned char* stage() const {
    return ring + ((threadIdx.x >> 5) * (ns + 1) + ns) * TILE_BYTES;
  }
};

// Lays out the pass's shared memory, loads its MLP (``img``, packed with
// layer 0 width0 wide) and inits the ring's barriers (ns a warp); every
// thread returns with the resident layers and vectors in place
template <int WGS>
__device__ inline WMlp stage_mlp(Carve& c, unsigned char* smem, const unsigned char* img,
                                 const Mlp& m, int width0, int ns, bool both) {
  unsigned char* p = smem + ((1024 - (wg::smem_u32(smem) & 1023)) & 1023);
  WMlp t;
  t.width0 = width0;
  t.n_layers = m.n_layers;
  t.resident = plan_pass(width0, m.n_layers, ns).resident;
  t.act = m.act;
  t.norm = m.scale != nullptr;
  t.both = both;
  t.uses = 0;
  t.img = img;
  t.w = wg::smem_u32(p);
  p += layer_offset(width0, t.resident);
  const bool streams = t.resident < t.n_layers;
  t.slots = wg::smem_u32(p);
  if (streams) p += 2 * LAYER_BYTES;
  c.ring = p;
  c.ns = ns;
  p += 4 * WGS * (ns + 1) * TILE_BYTES;
  bf16* vec = reinterpret_cast<bf16*>(p);
  t.vec = vec;
  p += vec_bytes(m.n_layers);
  uint64_t* bars = reinterpret_cast<uint64_t*>(p);
  t.slot_bar = bars + 1;
  c.ring_bar = bars + 3;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3 + 4 * WGS * ns; ++i) wg::bar_init(bars + i, 1);
    wg::bar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t res = static_cast<uint32_t>(layer_offset(width0, t.resident));
    const uint32_t vb = static_cast<uint32_t>(vec_bytes(t.n_layers));
    wg::bar_expect(bars, res + vb);
    wg::bulk_load(smem + (t.w - wg::smem_u32(smem)), img, res, bars);
    wg::bulk_load(vec, img + layer_offset(width0, t.n_layers), vb, bars);
    if (streams)
      for (int u = 0; u < 2; ++u) {
        wg::bar_expect(t.slot_bar + u, LAYER_BYTES);
        wg::bulk_load(smem + (t.slots - wg::smem_u32(smem)) + u * LAYER_BYTES,
                      img + layer_offset(width0, t.stream_layer(u)), LAYER_BYTES,
                      t.slot_bar + u);
      }
  }
  wg::bar_wait(bars, 0);
  return t;
}

// the shared address of layer l's image for its product: resident, or the
// slot of the next streamed use (waiting for its copy)
template <int WGS>
__device__ __forceinline__ uint32_t take(const WMlp& m, int l) {
  if (WGS == 2 || l < m.resident) return m.w + static_cast<uint32_t>(layer_offset(m.width0, l));
  wg::bar_wait(m.slot_bar + (m.uses & 1), (m.uses >> 1) & 1);
  return m.slots + (m.uses & 1) * LAYER_BYTES;
}

// after layer l's product: a streamed layer's slot takes the use two on
// once every warp is done with it (a block of one warpgroup)
template <int WGS>
__device__ __forceinline__ void release(WMlp& m, unsigned char* smem, int l) {
  if (WGS == 2 || l < m.resident) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int u = m.uses + 2;
    wg::bar_expect(m.slot_bar + (u & 1), LAYER_BYTES);
    wg::bulk_load(smem + (m.slots - wg::smem_u32(smem)) + (u & 1) * LAYER_BYTES,
                  m.img + layer_offset(m.width0, m.stream_layer(u)), LAYER_BYTES,
                  m.slot_bar + (u & 1));
  }
  ++m.uses;
}

// at the end of a pass: the two streamed copies still in flight land
// before the block exits
template <int WGS>
__device__ __forceinline__ void drain(const WMlp& m) {
  if constexpr (WGS == 1) {
    if (m.resident < m.n_layers)
      for (int u = m.uses; u < m.uses + 2; ++u) wg::bar_wait(m.slot_bar + (u & 1), (u >> 1) & 1);
  }
}

// d = A · W_lᵀ (layer l >= 1) and d = G · W_l, resident or streamed: the
// _issue forms, then layer_wait (the product done, a streamed layer's
// slot released)
template <int WGS>
__device__ __forceinline__ void layer_awt_issue(float (&d)[NT][4], const uint32_t (&a)[NF],
                                                const WMlp& m, int l) {
  awt_issue(d, a, take<WGS>(m, l), 0, false);
}

template <int WGS>
__device__ __forceinline__ void layer_gw_issue(float (&d)[NT][4], const uint32_t (&g)[NF],
                                               const WMlp& m, int l) {
  gw_issue(d, g, take<WGS>(m, l), 0);
}

template <int WGS>
__device__ __forceinline__ void layer_wait(WMlp& m, unsigned char* smem, int l) {
  wg::wait<0>();
  release<WGS>(m, smem, l);
}

template <int WGS>
__device__ __forceinline__ void layer_awt(float (&d)[NT][4], const uint32_t (&a)[NF], WMlp& m,
                                          unsigned char* smem, int l) {
  layer_awt_issue<WGS>(d, a, m, l);
  layer_wait<WGS>(m, smem, l);
}

// ---- the ring of warp tiles ----

// A warp's ns tiles in shared memory, each filled by TMA from a 3-D map
// of a [rows][B][H] array (box: 64 columns x 16 samples x 1 row) and read
// into fragments; ``ph`` holds each slot's next parity
struct Ring {
  unsigned char* tiles;
  uint64_t* bar;
  uint32_t ph;
  __device__ Ring(const Carve& c, int ns) {
    const int warp = threadIdx.x >> 5;
    tiles = c.ring + warp * (ns + 1) * TILE_BYTES;
    bar = c.ring_bar + warp * ns;
    ph = 0;
  }
  // lane 0 asks for the tile (row, b0..b0+15) of ``map`` in slot s; the
  // warp must have read the slot's previous tile (__syncwarp before)
  __device__ void load(int s, const CUtensorMap* map, long long row, int b0) {
    if ((threadIdx.x & 31) == 0) {
      wg::bar_expect(bar + s, TILE_BYTES);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        wg::tma_load3(tiles + s * TILE_BYTES + kb * 2048, map, 64 * kb, b0,
                      static_cast<int>(row), bar + s);
    }
  }
  // waits for slot s's tile and reads it (zeros when ``have`` is false:
  // no tile was asked for)
  __device__ void read(uint32_t (&f)[NF], int s, bool have) {
    if (!have) {
#pragma unroll
      for (int i = 0; i < NF; ++i) f[i] = 0u;
      return;
    }
    wg::bar_wait(bar + s, (ph >> s) & 1u);
    ph ^= 1u << s;
    wg::frag_sw(f, tiles + s * TILE_BYTES);
  }
  // reads slot s again (its tile already waited for)
  __device__ void reread(uint32_t (&f)[NF], int s) const { wg::frag_sw(f, tiles + s * TILE_BYTES); }
};

// ---- tiles of device memory through the warp's staging tile ----
//
// A tile's 16 rows move between device memory and registers as 16-byte
// chunks, lane l taking chunks 32i + l (coalesced: two whole rows an
// instruction at H = 128), through the warp's staging tile in the SW128
// layout that frag_sw reads without bank conflicts; the m16n8 fragment's
// own 4-byte pieces would touch 8 rows an instruction.

constexpr int CH = 16 * H / 8 / 32;  // the chunks of a tile a lane moves

// a tile's chunks in flight (the loads issued, not yet staged)
struct Pend {
  uint4 v[CH];
};

// byte offset of chunk k of a tile in its staging tile
__device__ __forceinline__ uint32_t chunk_at(int k) {
  const int r = k / (H / 8), c = k % (H / 8);
  return (c >> 3) * 2048 + wg::sw128(r, (c & 7) * 8);
}

// issues the loads of the tile at src (rows H apart; rows >= nv read 0)
__device__ __forceinline__ void pend_issue(Pend& p, const bf16* src, int nv) {
  const int lane = lane_id();
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int k = 32 * i + lane, r = k / (H / 8), c = k % (H / 8);
    p.v[i] = r < nv ? *reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * H + 8 * c)
                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the pending tile as fragments
__device__ __forceinline__ void pend_take(uint32_t (&f)[NF], const Pend& p, unsigned char* stg) {
  const int lane = lane_id();
#pragma unroll
  for (int i = 0; i < CH; ++i) *reinterpret_cast<uint4*>(stg + chunk_at(32 * i + lane)) = p.v[i];
  __syncwarp();
  wg::frag_sw(f, stg);
  __syncwarp();
}

// the tile at src (rows >= nv read 0)
__device__ __forceinline__ void stage_load(uint32_t (&f)[NF], const bf16* src, int nv,
                                           unsigned char* stg) {
  Pend p;
  pend_issue(p, src, nv);
  pend_take(f, p, stg);
}

// stores rows < nv of the tile; a lane writes the chunks it would load,
// so the warp reads its own stores back with stage_load
__device__ __forceinline__ void stage_store(bf16* dst, int nv, const uint32_t (&f)[NF],
                                            unsigned char* stg) {
  wg::frag_sw_store(stg, f);
  __syncwarp();
  const int lane = lane_id();
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int k = 32 * i + lane, r = k / (H / 8), c = k % (H / 8);
    if (r < nv)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * H + 8 * c) =
          *reinterpret_cast<const uint4*>(stg + chunk_at(k));
  }
  __syncwarp();
}

// a 3-D map over a [rows][B][H] bf16 array, boxes of 16 samples (null
// arrays get none)
inline bool row_map(CUtensorMap* m, const void* base, long long rows, int batch) {
  return base == nullptr || wg::tensor_map3(m, base, H, batch, rows, 16, 1);
}

// ---- warp items ----

// The warp item t of a pass over ``rows`` x chunks (16-sample chunks):
// its row, first sample and valid samples (nv 0 past the end)
struct Item {
  long long row;
  int b0, nv;
  __device__ Item(long long t, long long tiles, int chunks, int batch) {
    if (t < tiles) {
      row = t / chunks;
      b0 = 16 * static_cast<int>(t % chunks);
      nv = min(16, batch - b0);
    } else {
      row = 0;
      b0 = 0;
      nv = 0;
    }
  }
};

// h = bf16(d)
__device__ __forceinline__ void round_acc(uint32_t (&h)[NF], const float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      h[2 * n + half] = bits(__floats2bfloat162_rn(d[n][2 * half], d[n][2 * half + 1]));
}

// d += f in fp32
__device__ __forceinline__ void add_frag(float (&d)[NT][4], const uint32_t (&f)[NF]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = __bfloat1622float2(pair(f[2 * n + half]));
      d[n][2 * half] += v.x;
      d[n][2 * half + 1] += v.y;
    }
}

// h = bf16(bf16(d) + bias): a Dense output
__device__ __forceinline__ void finish(uint32_t (&h)[NF], const float (&d)[NT][4],
                                       const bf16* bias) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const bf2 b = *reinterpret_cast<const bf2*>(bias + 8 * n + 2 * q);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      h[2 * n + half] =
          bits(__hadd2_rn(__floats2bfloat162_rn(d[n][2 * half], d[n][2 * half + 1]), b));
  }
}

__device__ __forceinline__ void relu(uint32_t (&a)[NF], const uint32_t (&h)[NF]) {
  const bf2 z = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int i = 0; i < NF; ++i) a[i] = bits(__hmax2(pair(h[i]), z));
}

// c = a + b, each pair rounded once
__device__ __forceinline__ void add_tiles(uint32_t (&c)[NF], const uint32_t (&a)[NF],
                                          const uint32_t (&b)[NF]) {
#pragma unroll
  for (int i = 0; i < NF; ++i) c[i] = bits(__hadd2_rn(pair(a[i]), pair(b[i])));
}

// a = act(h), the MLP's activation (mlp_act::Kind) on the tile
__device__ __forceinline__ void activate(uint32_t (&a)[NF], const uint32_t (&h)[NF], int kind) {
  if (kind == mlp_act::RELU) {
    relu(a, h);
    return;
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) a[i] = mlp_act::act_pair(h[i], kind);
}

// the bits of the pair's halves that are > 0 (a relu's pass mask)
__device__ __forceinline__ uint32_t pos_mask(uint32_t u) {
  const uint32_t lo = static_cast<int16_t>(u & 0xffffu) > 0 ? 0x0000ffffu : 0u;
  const uint32_t hi = static_cast<int16_t>(u >> 16) > 0 ? 0xffff0000u : 0u;
  return lo | hi;
}

// _rms_fwd's statistic 1 / (rms + eps) of the tile's two rows of this lane
// (fp32 sums of the bf16 squares)
__device__ __forceinline__ void rms_inv(float (&inv)[2], const uint32_t (&h)[NF]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float gs = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf2 v = pair(h[2 * n + half]);
      const float2 sq = __bfloat1622float2(__hmul2_rn(v, v));
      gs += sq.x;
      gs += sq.y;
    }
    gs = quad_sum(gs);
    const float rms = sqrtf(gs + 1e-24f) / sqrtf(static_cast<float>(H));
    inv[half] = 1.0f / (rms + 1e-8f);
  }
}

// h = bf16(bf16(h · bf16(inv)) · scale)
__device__ __forceinline__ void rms_apply(uint32_t (&h)[NF], const float (&inv)[2],
                                          const bf16* scale) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf2 ib = __float2bfloat162_rn(inv[half]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf2 s = *reinterpret_cast<const bf2*>(scale + 8 * n + 2 * q);
      h[2 * n + half] = bits(__hmul2_rn(__hmul2_rn(pair(h[2 * n + half]), ib), s));
    }
  }
}

// _rms_bwd in place on the cotangent g: v the norm's input, inv its
// statistic; p gets the scale's terms bf16(g · u)
__device__ __forceinline__ void rms_bwd(uint32_t (&g)[NF], uint32_t (&p)[NF],
                                        const uint32_t (&v)[NF], const float (&inv)[2],
                                        const bf16* scale) {
  const int q = lane_id() & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf2 ib = __float2bfloat162_rn(inv[half]);
    float dot = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int i = 2 * n + half;
      const bf2 gv = pair(g[i]), vv = pair(v[i]);
      const bf2 s = *reinterpret_cast<const bf2*>(scale + 8 * n + 2 * q);
      p[i] = bits(__hmul2_rn(gv, __hmul2_rn(vv, ib)));
      const bf2 gu = __hmul2_rn(gv, s);
      g[i] = bits(gu);
      const float2 t = __bfloat1622float2(__hmul2_rn(gu, vv));
      dot += t.x;
      dot += t.y;
    }
    dot = quad_sum(dot);
    const float rms = fmaxf(1.0f / inv[half] - 1e-8f, 1e-30f);
    const bf2 corr = __float2bfloat162_rn(dot * (inv[half] * inv[half]) / (H * rms));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int i = 2 * n + half;
      g[i] = bits(__hsub2_rn(__hmul2_rn(pair(g[i]), ib), __hmul2_rn(pair(v[i]), corr)));
    }
  }
}


// ---- column sums of a tile, summed over a warp's items ----

constexpr int CS = NT / 4;  // the column sums a lane keeps

// acc += the column sums of the tile p over its 16 rows: the rows' fp32
// sums reduce-scattered over the warp in a fixed order (lanes 4 apart,
// then 8, then 16), lane l keeping the CS columns of col_of(l, k)
__device__ __forceinline__ void colsum_add(float (&acc)[CS], const uint32_t (&p)[NF]) {
  const int lane = lane_id();
  float v[2 * NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 a = __bfloat1622float2(pair(p[2 * n])), b = __bfloat1622float2(pair(p[2 * n + 1]));
    v[2 * n] = a.x + b.x;
    v[2 * n + 1] = a.y + b.y;
  }
#pragma unroll
  for (int stage = 0; stage < 3; ++stage) {
    const int mask = 16 >> stage, half = NT >> stage;  // current count 2·half
    const bool upper = lane & mask;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? v[k] : v[k + half];
      const float keep = upper ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
  }
#pragma unroll
  for (int k = 0; k < CS; ++k) acc[k] += v[k];
}

// the column colsum_add's lane l keeps in acc[k]
__device__ __forceinline__ int col_of(int l, int k) {
  const int i = k + CS * ((l >> 2) & 1) + 2 * CS * ((l >> 3) & 1) + 4 * CS * ((l >> 4) & 1);
  return 8 * (i >> 1) + 2 * (l & 3) + (i & 1);
}

// a warp's column sums to its row of ``out`` ([warps][H])
__device__ __forceinline__ void colsum_store(float* out, const float (&acc)[CS]) {
  const int lane = lane_id();
#pragma unroll
  for (int k = 0; k < CS; ++k) out[col_of(lane, k)] = acc[k];
}

// the launch of a pass kernel over ``items`` warpgroup items: at most as
// many blocks as fit on the card at once
inline cudaError_t grid_of(const void* kernel, int wgs, size_t smem, long long items,
                           int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return gn_nk::grid_for(kernel, WG_THREADS * wgs, smem, items * WG_THREADS, grid);
}

// layers 1..n_layers-1 (the activation between layers) and the RMSNorm
// tail, if any, of an MLP on the tiles; h holds layer 0's output
template <int WGS>
__device__ __forceinline__ void mlp_tail(uint32_t (&h)[NF], WMlp& m, unsigned char* smem) {
#pragma unroll 1
  for (int l = 1; l < m.n_layers; ++l) {
    uint32_t a[NF];
    activate(a, h, m.act);
    float d[NT][4];
    layer_awt<WGS>(d, a, m, smem, l);
    finish(h, d, m.bias(l));
  }
  if (m.norm) {
    float inv[2];
    rms_inv(inv, h);
    rms_apply(h, inv, m.scale());
  }
}

// Each kernel that runs an MLP comes in three instances, <ACTS, WGS>:
// <false, 2> is relu with every layer resident (the activation a constant
// the compiler folds); <true, 2> reads the activation at run time; <true,
// 1> also streams the layers past what fits (plan_pass). The launchers
// pick the instance by the MLP (instance_of).
template <bool ACTS>
__device__ __forceinline__ void fix_act(WMlp& m) {
  if (!ACTS) m.act = mlp_act::RELU;
}

// 0: <false, 2>, 1: <true, 2>, 2: <true, 1>
inline int instance_of(const Mlp& m, int width0, int ns) {
  if (plan_pass(width0, m.n_layers, ns).wgs == 1) return 2;
  return m.act != mlp_act::RELU ? 1 : 0;
}

inline int wgs_of(int instance) { return instance == 2 ? 1 : 2; }

// ---- the pre-pass and the folded encoder ----

// The node pre-pass, forward and backward: xkr = bf16(x @ Kr) and xks =
// bf16(x @ Ks) for every (node, sample) row on the warpgroup tiles; Kr, Ks
// the columns H..2H-1 and 2H..3H-1 of the edge MLP's first layer, packed
// as one [H][2H] image (``kimg``): Kr its first KB blocks, Ks the rest.
// The partials are rounded per node, as fused_gnblock.py:blocked_reference
// and fused_gnblock_nk.py:_edge_fwd round them.
__global__ void __launch_bounds__(2 * WG_THREADS) GNW(partial)(const bf16* x, bf16* xkr,
                                                               bf16* xks, const bf16* kimg,
                                                               int n_nodes, int batch) {
  extern __shared__ unsigned char partial_smem[];
  unsigned char* k = partial_smem + ((1024 - (wg::smem_u32(partial_smem) & 1023)) & 1023);
  unsigned char* stg = k + 2 * LAYER_BYTES + (threadIdx.x >> 5) * TILE_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(k + 2 * LAYER_BYTES + 8 * TILE_BYTES);
  if (threadIdx.x == 0) {
    wg::bar_init(bar, 1);
    wg::bar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect(bar, 2 * LAYER_BYTES);
    wg::bulk_load(k, kimg, 2 * LAYER_BYTES, bar);
  }
  wg::bar_wait(bar, 0);
  const int chunks = (batch + 15) / 16;
  const long long tiles = static_cast<long long>(n_nodes) * chunks, items = (tiles + 3) / 4;
  const int w = (threadIdx.x >> 5) & 3;
  for (long long g = blockIdx.x * 2LL + (threadIdx.x >> 7); g < items; g += gridDim.x * 2LL) {
    const Item it(4 * g + w, tiles, chunks, batch);
    const long long at = (it.row * batch + it.b0) * H;
    uint32_t xf[NF], h[NF];
    stage_load(xf, x + at, it.nv, stg);
#pragma unroll 1
    for (int part = 0; part < 2; ++part) {
      float d[NT][4];
      awt(d, xf, wg::smem_u32(k), part * KS, false);
      round_acc(h, d);
      stage_store((part == 0 ? xkr : xks) + at, it.nv, h, stg);
    }
  }
}

inline cudaError_t launch_partial(const bf16* x, bf16* xkr, bf16* xks, const bf16* kimg,
                                  int n_nodes, int batch, cudaStream_t stream) {
  const size_t smem = 2 * LAYER_BYTES + 8 * TILE_BYTES + 2048;
  int grid = 0;
  const long long items = (static_cast<long long>(n_nodes) * ((batch + 15) / 16) + 3) / 4;
  cudaError_t err = grid_of(reinterpret_cast<const void*>(GNW(partial)), 2, smem, items, &grid);
  if (err != cudaSuccess) return err;
  GNW(partial)<<<grid, 2 * WG_THREADS, smem, stream>>>(x, xkr, xks, kimg, n_nodes, batch);
  return cudaGetLastError();
}

// the folded encoder's first-layer product on 16 raw rows of fe features
__device__ __forceinline__ void enc_first(float (&d)[NT][4], uint32_t (&rf)[NF], const bf16* raw,
                                          int fe, const WMlp& enc, int nv) {
  raw_load(rf, raw, fe, nv);
  awt(d, rf, enc.w, 0, false, pad16(fe) / 16);
}

// The folded edge encoder's forward on every row (padding rows included):
// dst[s, b] = Enc(raw[s, b]), raw [rows, B, fe] and dst [rows, B, H] bf16,
// on the warpgroup tiles. The forward writes it where e_out goes (or to a
// scratch on the last block) and the edge pass reads it there.
template <bool ACTS, int WGS>
__global__ void __launch_bounds__(WG_THREADS * WGS, 1)
    GNW(enc_fwd)(const bf16* raw, bf16* dst, const unsigned char* img, const Mlp enc,
                 long long rows, int batch) {
  extern __shared__ unsigned char enc_smem[];
  const int fe = enc.in_dim;
  Carve c;
  WMlp m = stage_mlp<WGS>(c, enc_smem, img, enc, fe, 0, false);
  fix_act<ACTS>(m);
  const int chunks = (batch + 15) / 16;
  const long long tiles = rows * chunks, items = (tiles + 3) / 4;
  const int w = (threadIdx.x >> 5) & 3;
  for (long long g = blockIdx.x * static_cast<long long>(WGS) + (threadIdx.x >> 7); g < items;
       g += static_cast<long long>(gridDim.x) * WGS) {
    const Item it(4 * g + w, tiles, chunks, batch);
    const long long rb = it.row * batch + it.b0;
    float d[NT][4];
    uint32_t h[NF];
    enc_first(d, h, raw + rb * fe, fe, m, it.nv);
    finish(h, d, m.bias(0));
    mlp_tail<WGS>(h, m, enc_smem);
    stage_store(dst + rb * H, it.nv, h, c.stage());
  }
  drain<WGS>(m);
}

inline cudaError_t launch_enc_fwd(const bf16* raw, bf16* dst, const unsigned char* img,
                                  const Mlp& enc, long long rows, int batch,
                                  cudaStream_t stream) {
  const int inst = instance_of(enc, enc.in_dim, 0), wgs = wgs_of(inst);
  const Plan pl = plan_pass(enc.in_dim, enc.n_layers, 0);
  const size_t smem = pass_bytes(enc.in_dim, enc.n_layers, pl.resident, wgs, 0);
  const auto kernel = inst == 0 ? GNW(enc_fwd)<false, 2>
                      : inst == 1 ? GNW(enc_fwd)<true, 2> : GNW(enc_fwd)<true, 1>;
  int grid = 0;
  const long long items = (rows * ((batch + 15) / 16) + 3) / 4;
  cudaError_t err = grid_of(reinterpret_cast<const void*>(kernel), wgs, smem, items, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WG_THREADS * wgs, smem, stream>>>(raw, dst, img, enc, rows, batch);
  return cudaGetLastError();
}

// the MLPs a wide kernel takes: 1 to MAXL Dense layers each (layer 0
// in_dim wide), ``act`` the activation (mlp_act::Kind)
inline bool make_wide_mlp(Mlp* m, const void* const* p, int n_layers, int in_dim, int act) {
  return gn_nk::make_mlp(m, p, n_layers, in_dim, 1, act);
}

// Bytes of the packed images of a call: the encoder (fe > 0), the edge
// MLP (layer 0: Ke), the node MLP and [Kr | Ks], each 1024-byte aligned
// (img_layout)
struct Images {
  long long enc, edge, node, kk, total;
};

inline Images img_layout(int fe, int n_enc, int n_edge, int n_node) {
  auto up = [](long long b) { return (b + 1023) / 1024 * 1024; };
  Images im;
  im.enc = 0;
  im.edge = fe > 0 ? up(image_bytes(fe, n_enc)) : 0;
  im.node = im.edge + up(image_bytes(H, n_edge));
  im.kk = im.node + up(image_bytes(2 * H, n_node));
  im.total = im.kk + 2 * LAYER_BYTES;
  return im;
}

// packs a call's MLPs into ``img`` (img_layout's offsets)
inline cudaError_t pack_call(unsigned char* img, const Images& im, const Mlp* enc, int fe,
                             const Mlp& edge, const Mlp& node, cudaStream_t stream) {
  PackArgs p = {};
  if (fe > 0) add_pack(p, *enc, 0, fe, reinterpret_cast<bf16*>(img + im.enc));
  add_pack(p, edge, 0, H, reinterpret_cast<bf16*>(img + im.edge));
  add_pack(p, node, 0, 2 * H, reinterpret_cast<bf16*>(img + im.node));
  p.mat[p.n_mat++] = {edge.w[0], reinterpret_cast<bf16*>(img + im.kk), 3 * H, H, 2 * H};
  return launch_pack(p, stream);
}

}  // namespace gnw
