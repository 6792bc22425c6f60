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
//
// Every head width dividing 128 has an instance (Head<DH>). From 8 up, a
// pair spans LPP = DH / 8 lanes of 8 values (a whole pair a lane at 8, 16
// lanes at 128) and the dot products end in a butterfly over them. Below
// 8 a lane holds a whole pair of DH < 8 values, EPL = DH (8, 4 or 2
// bytes): no butterfly, and the rows' k and v come into registers, as
// cp.async has no 2-byte copy and a chunk of them is 16 registers at
// most.
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 4;
constexpr int CHUNK = 4;
constexpr int SPAN = 4;

// 1/sqrt(d) for d a power of 2, as the plain version scales: the double
// 1.0 / math.sqrt(d), later rounded once to fp32 (1/sqrt(2) times a power
// of 2 is exact in double)
constexpr double inv_sqrt(int d) { return d == 1 ? 1.0 : d == 2 ? 0.7071067811865475 : 0.5 * inv_sqrt(d / 4); }

template <int DH>
struct Head {
  static_assert(DH >= 1 && DH <= 128 && (DH & (DH - 1)) == 0, "head widths dividing 128");
  static constexpr int EPL = DH < 8 ? DH : 8;  // values a lane holds
  static constexpr int LPP = DH / EPL;  // lanes per (sample, head) pair
  static constexpr int PAIRS = 32 / LPP;  // pairs per warp
  static constexpr float SCALE = static_cast<float>(inv_sqrt(DH));
  // At 8 values a pair and below the backward keeps its per-pair terms in
  // fp32 (ea_bwd_passes.cuh): gp, s_r from the forward's fp32 output (as
  // the world seam does), abar and g_s, which rounds once where the sender
  // pass keeps it. With the rounding points of the wider instances, dq
  // and dk left the plain backward's fp32 error bound at these widths: a
  // dq value sums a few rows' g_s, each carrying four bf16 roundings that
  // the d values of a wider pair do not dilute (PERF.md §6).
  static constexpr bool FP32_GRAD = DH <= 8;
};

// whether the forward at head width head_dim keeps its fp32 output for
// the backward without world edges too (Head<DH>::FP32_GRAD)
inline bool keeps_fp32_out(int head_dim) { return head_dim <= 8; }

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// E bf16 values, packed: 16, 8, 4 or 2 bytes
template <int E> struct PackedOf;
template <> struct PackedOf<8> { using T = uint4; };
template <> struct PackedOf<4> { using T = uint2; };
template <> struct PackedOf<2> { using T = uint32_t; };
template <> struct PackedOf<1> { using T = unsigned short; };
template <int E>
using Packed = typename PackedOf<E>::T;

// the E bf16 values at src (2E-byte aligned), packed
template <int E>
__device__ __forceinline__ Packed<E> load_packed(const __nv_bfloat16* src) {
  return __ldg(reinterpret_cast<const Packed<E>*>(src));
}

// the packed values as 32-bit words (a lone bf16 in the high half)
template <int E>
__device__ __forceinline__ void words(uint32_t (&wd)[(E + 1) / 2], const Packed<E>& p) {
  if constexpr (E == 8) {
    wd[0] = p.x; wd[1] = p.y; wd[2] = p.z; wd[3] = p.w;
  } else if constexpr (E == 4) {
    wd[0] = p.x; wd[1] = p.y;
  } else if constexpr (E == 2) {
    wd[0] = p;
  } else {
    wd[0] = static_cast<uint32_t>(p) << 16;
  }
}

template <int E>
__device__ __forceinline__ void unpack(float (&v)[E], const Packed<E>& p) {
  uint32_t wd[(E + 1) / 2];
  words<E>(wd, p);
  if constexpr (E == 1) {
    v[0] = __uint_as_float(wd[0]);
  } else {
#pragma unroll
    for (int q = 0; q < E / 2; ++q) {
      v[2 * q] = __uint_as_float(wd[q] << 16);
      v[2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
    }
  }
}

// E bf16 values (already bf16) packed
template <int E>
__device__ __forceinline__ Packed<E> pack(const float (&v)[E]) {
  if constexpr (E == 1) {
    return static_cast<unsigned short>(__float_as_uint(v[0]) >> 16);
  } else {
    uint32_t wd[E / 2];
#pragma unroll
    for (int q = 0; q < E / 2; ++q)
      wd[q] = (__float_as_uint(v[2 * q]) >> 16) | (__float_as_uint(v[2 * q + 1]) & 0xffff0000u);
    if constexpr (E == 8) return make_uint4(wd[0], wd[1], wd[2], wd[3]);
    else if constexpr (E == 4) return make_uint2(wd[0], wd[1]);
    else return wd[0];
  }
}

// the E bf16 values at src (2E-byte aligned) as floats
template <int E>
__device__ __forceinline__ void load(float (&v)[E], const __nv_bfloat16* src) {
  unpack<E>(v, load_packed<E>(src));
}

// this lane's E fp32 values at src (4E-byte aligned)
template <int E>
__device__ __forceinline__ void loadf(float (&v)[E], const float* src) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src) + i);
      v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
    }
  } else if constexpr (E == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = __ldg(src);
  }
}

// v stored in fp32 at dst (4E-byte aligned)
template <int E>
__device__ __forceinline__ void storef(float* dst, const float (&v)[E]) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// v rounded to bf16 and stored at dst (2E-byte aligned)
template <int E>
__device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&v)[E]) {
  float r[E];
#pragma unroll
  for (int e = 0; e < E; ++e) r[e] = bf(v[e]);
  *reinterpret_cast<Packed<E>*>(dst) = pack<E>(r);
}

// Σ_d a[d]·b[d] over the pair's DH values: each lane's EPL exact products
// (bf16 × bf16 fits fp32) summed in fp32, then the pair's LPP lanes added
// by a butterfly, which gives every lane of the pair the same bits. Both
// stay packed until here, which keeps registers for loads in flight.
template <int DH>
__device__ __forceinline__ float pair_dot(const Packed<Head<DH>::EPL>& a,
                                          const Packed<Head<DH>::EPL>& b) {
  constexpr int E = Head<DH>::EPL;
  float av[E], bv[E];
  unpack<E>(av, a);
  unpack<E>(bv, b);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc = fmaf(av[e], bv[e], acc);
#pragma unroll
  for (int o = 1; o < Head<DH>::LPP; o *= 2) acc += __shfl_xor_sync(FULL, acc, o);
  return acc;
}

// This lane's place in the grid. Pairs of a node come in groups of PAIRS;
// warp w serves node w / warps_per_node and its SPAN groups from
// (w % warps_per_node)·SPAN, one at a time (``group``); LPP neighbouring
// lanes share a pair, lane part p holding its values p·EPL .. p·EPL +
// EPL - 1 (EPL = Head<DH>::EPL). A lane past the node's last pair reads
// pair 0 and stores nothing.
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
    return static_cast<long long>(i) * (pairs_per_node * DH) +
           (pair * DH + part * Head<DH>::EPL);
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
// each lane's EPL = 8 values, filled by cp.async, so that no register holds a
// load in flight. Each lane reads back only what it copied, so the
// lane's own cp.async.wait_all is the only wait. Below 8 values a lane
// (head widths 1, 2, 4) the stage is the lane's registers (the
// specialisation below): plain loads of 2E bytes, all issued before the
// first is used.
template <int NT, int E>
struct Stage {
  static constexpr int BYTES = 0;  // no shared memory
  Packed<E> buf[CHUNK][NT];

  __device__ explicit Stage(uint4*) {}
  __device__ __forceinline__ void load(int c, int t, const __nv_bfloat16* src) {
    buf[c][t] = load_packed<E>(src);
  }
  __device__ __forceinline__ static void wait() {}
  __device__ __forceinline__ Packed<E> get(int c, int t) const { return buf[c][t]; }
};

template <int NT>
struct Stage<NT, 8> {
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
  __device__ __forceinline__ Packed<8> get(int c, int t) const {
    Packed<8> p;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(p.x), "=r"(p.y), "=r"(p.z), "=r"(p.w)
                 : "r"(slot(c, t))
                 : "memory");
    return p;
  }
};

// the stage of a DH-wide head's kernels: k and v (or q and g_out) of a
// chunk of rows
template <int DH>
using Stage2 = Stage<2, Head<DH>::EPL>;

// Launch over every head width dividing 128: L::template run<DH>() for
// head_dim = DH, cudaErrorInvalidValue for any other.
template <class L>
inline int with_head_dim(int head_dim, const L& l) {
  switch (head_dim) {
    case 1: return l.template run<1>();
    case 2: return l.template run<2>();
    case 4: return l.template run<4>();
    case 8: return l.template run<8>();
    case 16: return l.template run<16>();
    case 32: return l.template run<32>();
    case 64: return l.template run<64>();
    case 128: return l.template run<128>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 pair (lo, hi), both already bf16 values, as one 32-bit word, and back
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}
__device__ __forceinline__ float lo_of(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_of(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

}  // namespace ea
