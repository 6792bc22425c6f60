// What the edge-attention kernels share, for both edge layouts (CSR rows,
// NK slots): a warp per (node, groups of (sample, head) pairs), the staging
// of a node's row indices one warp-wide load of 32 rows at a time, shared
// with __shfl_sync, raw 16-byte loads kept packed while they are in
// flight, and bf16 rounding. The forward body is in ea_fwd.cuh, the
// backward passes in ea_bwd_passes.cuh; the row maps (which rows a
// receiver owns) in gn_rows.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "gn_rows.cuh"

namespace ea {

// The layout, the fastest of the alternatives timed on the H100 (PERF.md
// §6): blocks of 256 threads, at least 4 an SM (__launch_bounds__), which
// caps a thread at 64 registers, 32 warps an SM; a lane holds EPL = 8
// bf16 values of a (sample, head) pair, one 16-byte copy a row; a warp
// issues the copies of CHUNK = 4 rows together and walks SPAN = 4 pair
// groups in turn on one set of staged row indices (a warp per receiver at
// 16 samples x 4 heads of 16).
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 4;
constexpr int EPL = 8;
constexpr int CHUNK = 4;
constexpr int SPAN = 4;

template <int DH>
struct Head {
  static_assert(DH == 16 || DH == 32, "head widths 16 and 32");
  static constexpr int LPP = DH / EPL;  // lanes per (sample, head) pair
  static constexpr int PAIRS = 32 / LPP;  // pairs per warp
  // 1/sqrt(dh), as the plain version scales
  static constexpr float SCALE = DH == 16 ? 0.25f : 0.17677669529663687f;
};

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// EPL = 8 bf16 values, packed
using Packed = uint4;

__device__ __forceinline__ Packed load_packed(const __nv_bfloat16* src) {
  return __ldg(reinterpret_cast<const uint4*>(src));
}

__device__ __forceinline__ void unpack(float (&v)[EPL], const Packed& p) {
  const uint32_t wd[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(wd[q] << 16);
    v[2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
  }
}

// EPL bf16 values (already bf16) packed
__device__ __forceinline__ Packed pack(const float (&v)[EPL]) {
  uint32_t wd[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wd[q] = (__float_as_uint(v[2 * q]) >> 16) | (__float_as_uint(v[2 * q + 1]) & 0xffff0000u);
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// the EPL bf16 values at src (16-byte aligned) as floats
__device__ __forceinline__ void load8(float (&v)[EPL], const __nv_bfloat16* src) {
  unpack(v, load_packed(src));
}

// this lane's EPL fp32 values at src (32-byte aligned)
__device__ __forceinline__ void load8f(float (&v)[EPL], const float* src) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// v stored in fp32 at dst (32-byte aligned)
__device__ __forceinline__ void store8f(float* dst, const float (&v)[EPL]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// v rounded to bf16 and stored at dst (16-byte aligned)
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[EPL]) {
  float r[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) r[e] = bf(v[e]);
  *reinterpret_cast<uint4*>(dst) = pack(r);
}

// Σ_d a[d]·b[d] over the pair's DH values: each lane's EPL exact products
// (bf16 × bf16 fits fp32) summed in fp32, then the pair's LPP lanes added
// by a butterfly, which gives every lane of the pair the same bits. Both
// stay packed until here, which keeps registers for loads in flight.
template <int DH>
__device__ __forceinline__ float pair_dot(const Packed& a, const Packed& b) {
  float av[EPL], bv[EPL];
  unpack(av, a);
  unpack(bv, b);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc = fmaf(av[e], bv[e], acc);
#pragma unroll
  for (int o = 1; o < Head<DH>::LPP; o *= 2) acc += __shfl_xor_sync(FULL, acc, o);
  return acc;
}

// This lane's place in the grid. Pairs of a node come in groups of PAIRS;
// warp w serves node w / warps_per_node and its SPAN groups from
// (w % warps_per_node)·SPAN, one at a time (``group``); LPP neighbouring
// lanes share a pair, lane part p holding its values p·EPL .. p·EPL +
// EPL - 1. A lane past the node's last pair reads pair 0 and stores
// nothing.
template <int DH>
struct Lane {
  int node, first, last;  // the warp's node and its groups [first, last)
  int pair, part;
  bool active;

  __device__ explicit Lane(int pairs_per_node) {
    const int groups = (pairs_per_node + Head<DH>::PAIRS - 1) / Head<DH>::PAIRS;
    const int per_node = (groups + SPAN - 1) / SPAN;
    const long long w = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
    node = static_cast<int>(w / per_node);
    first = static_cast<int>(w % per_node) * SPAN;
    last = min(first + SPAN, groups);
    part = (threadIdx.x % 32) % Head<DH>::LPP;
    group(first, pairs_per_node);
  }

  // take this lane's pair in group g
  __device__ __forceinline__ void group(int g, int pairs_per_node) {
    const int p = g * Head<DH>::PAIRS + static_cast<int>(threadIdx.x % 32) / Head<DH>::LPP;
    active = p < pairs_per_node;
    pair = active ? p : 0;
  }

  // this lane's first value of node (or row) i in a [*, B, H, DH] tensor:
  // the node's base in 64 bits (a tensor may hold 2^31 values or more),
  // the lane's offset inside it in 32
  __device__ __forceinline__ long long at(int i, int pairs_per_node) const {
    return static_cast<long long>(i) * (pairs_per_node * DH) + (pair * DH + part * EPL);
  }
  // this lane's pair of node (or row) i in a [*, B, H] tensor
  __device__ __forceinline__ long long stat(int i, int pairs_per_node) const {
    return static_cast<long long>(i) * pairs_per_node + pair;
  }
  // the lane that stores the pair's per-pair values
  __device__ __forceinline__ bool writes_pair() const { return active && part == 0; }
};

// blocks for one warp per (node, SPAN groups of pairs)
template <int DH>
inline int grid_for(int n_nodes, long long pairs_per_node) {
  const long long groups = (pairs_per_node + Head<DH>::PAIRS - 1) / Head<DH>::PAIRS;
  const long long per_node = (groups + SPAN - 1) / SPAN;
  return static_cast<int>((n_nodes * per_node + WARPS - 1) / WARPS);
}

// A receiver's rows as its warp stages them (the row map's own(): first,
// count, step): row i < count is first + i·step. Each lane stages one row
// of 32 at a time: its sender, or -1 where the row is masked out, so the
// warp's ballot of senders >= 0 is its valid rows.
template <class Rows>
struct Walk {
  long long first;
  int count, step;

  __device__ Walk(const gn_rows::RowMap& a, int r) { Rows::own(a, r, first, count, step); }

  // the row this lane stages in the 32 from base, or -1 past the last
  __device__ __forceinline__ long long row(int base) const {
    const int i = base + static_cast<int>(threadIdx.x % 32);
    return i < count ? first + static_cast<long long>(i) * step : -1;
  }
  // its sender, -1 on a masked row or past the last
  __device__ __forceinline__ static int sender(long long s, const int32_t* senders,
                                               const uint8_t* mask) {
    if (s < 0) return -1;
    const int j = senders[s];  // both loads in flight together
    return mask[s] != 0 ? j : -1;
  }
};

// The next up to CHUNK valid rows of ``left`` (a warp-uniform ballot,
// cleared of them as they are taken): returns their number; the lane that
// staged the c-th is lane_of(froms, c).
__device__ __forceinline__ int take_chunk(unsigned& left, unsigned& froms) {
  int count = 0;
  froms = 0;
#pragma unroll
  for (int c = 0; c < CHUNK; ++c)
    if (left) {
      froms |= static_cast<unsigned>(__ffs(left) - 1) << (5 * c);
      left &= left - 1;
      ++count;
    }
  return count;
}
__device__ __forceinline__ int lane_of(unsigned froms, int c) { return (froms >> (5 * c)) & 31; }

// The warp's staging area in shared memory: CHUNK rows x NT tensors of
// each lane's EPL values, filled by cp.async, so that no register holds a
// load in flight. Each lane reads back only what it copied, so the
// lane's own cp.async.wait_all is the only wait.
template <int NT>
struct Stage {
  static constexpr int WARP_VECS = CHUNK * NT * 32;  // 16-byte pieces a warp
  // shared memory a block needs, within the 48 KB a launch gets unasked
  static constexpr int BYTES = WARPS * WARP_VECS * 16;
  static_assert(BYTES <= 48 * 1024, "the stage fits the default shared memory");
  uint32_t lane_base;  // this lane's first piece, as a shared-memory address

  __device__ explicit Stage(uint4* smem)
      : lane_base(static_cast<uint32_t>(__cvta_generic_to_shared(
            smem + (threadIdx.x / 32) * WARP_VECS + threadIdx.x % 32))) {}

  __device__ __forceinline__ uint32_t slot(int c, int t) const {
    return lane_base + static_cast<uint32_t>((c * NT + t) * 32 * 16);
  }
  // start copying this lane's EPL values at src into slot (row c, tensor t)
  __device__ __forceinline__ void load(int c, int t, const __nv_bfloat16* src) const {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(slot(c, t)), "l"(src)
                 : "memory");
  }
  // wait for this lane's copies
  __device__ __forceinline__ static void wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __device__ __forceinline__ Packed get(int c, int t) const {
    Packed p;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(p.x), "=r"(p.y), "=r"(p.z), "=r"(p.w)
                 : "r"(slot(c, t))
                 : "memory");
    return p;
  }
};

// bf16 pair (lo, hi), both already bf16 values, as one 32-bit word, and back
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}
__device__ __forceinline__ float lo_of(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_of(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

}  // namespace ea
