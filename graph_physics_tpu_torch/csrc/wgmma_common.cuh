// Hopper's warpgroup products and bulk copies, for the GraphNetBlock
// kernels at hidden 64 and 128 (gn_wide.cuh) and the gated-FFN kernels at
// hidden 128 (ffn_wide.cuh; with 2-D tensor maps, the proxy fence, and the
// thread-block clusters' ranks, mapa and remote arrivals): wgmma.mma_async m64nNk16
// bf16 -> fp32 with N = 64 or 128, A from registers (the m16n8k16 A
// fragment of each warp's 16 rows) or from shared memory, B from shared
// memory; the shared-memory matrix descriptors of the 128-byte swizzled
// layout the operands are kept in; wgmma's fence, commit and wait;
// mbarriers; cp.async.bulk (1-D) and cp.async.bulk.tensor (TMA) loads; and
// the host's tensor maps (cuTensorMapEncodeTiled, found through the
// runtime's driver entry point, so that no library links libcuda).
//
// The layout (SW128): a [rows][64] bf16 block, 128 bytes a row, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8), each 8-row group 1024
// bytes, the block 1024-byte aligned in shared memory. A matrix wider than
// 64 columns is a row of such blocks. That is the layout a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B and a 64-column box writes, and the one
// wgmma reads through a descriptor of layout type 1:
//  * K-major (the operand's reduction index along the 64 columns): start
//    at the block plus 32 bytes a k16 step, SBO 1024 (8 rows), LBO unused;
//  * MN-major (the operand's M or N index along the columns, its
//    reduction index along the rows, the "transposed" operand): start at
//    row 16·kstep of the first block, SBO 1024 (8 rows of the reduction),
//    LBO the bytes from one 64-column block to the next.
// (PTX ISA, "Matrix Descriptor Format" and "Shared Memory Matrix Layout" of
// wgmma; CUTLASS's make_gmma_desc spells out the same strides.)
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, col) in an SW128 block of 64 columns
__host__ __device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// a descriptor of an SW128 operand at shared address ``addr``
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// K-major: k16 step ``ks`` of an operand whose blocks of 64 reduction
// columns lie ``block_bytes`` apart
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int ks, uint32_t block_bytes) {
  return desc(base + (ks >> 2) * block_bytes + (ks & 3) * 32, 16, 1024);
}

// MN-major: k16 step ``ks`` (rows 16ks..16ks+15) of an operand whose
// 64-column blocks lie ``block_bytes`` apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int ks, uint32_t block_bytes) {
  return desc(base + ks * 16 * 128, block_bytes, 1024);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A · B, m64n64k16: A the warpgroup's 64 x 16 bf16 slice in registers (each
// warp its 16 rows, the m16n8k16 A fragment), B from shared memory (``db``;
// TRANS_B 0: K-major, 1: MN-major); ``acc`` 0 overwrites d
template <int TRANS_B>
__device__ __forceinline__ void mma_rs64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  float* f = &d[0][0];
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(f[0]), "+f"(f[1]), "+f"(f[2]), "+f"(f[3]), "+f"(f[4]), "+f"(f[5]), "+f"(f[6]), "+f"(f[7]), "+f"(f[8]), "+f"(f[9]), "+f"(f[10]), "+f"(f[11]), "+f"(f[12]), "+f"(f[13]), "+f"(f[14]), "+f"(f[15]), "+f"(f[16]), "+f"(f[17]), "+f"(f[18]), "+f"(f[19]), "+f"(f[20]), "+f"(f[21]), "+f"(f[22]), "+f"(f[23]), "+f"(f[24]), "+f"(f[25]), "+f"(f[26]), "+f"(f[27]), "+f"(f[28]), "+f"(f[29]), "+f"(f[30]), "+f"(f[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TRANS_B));
}

// d (+)= A · B, m64n128k16: A the warpgroup's 64 x 16 bf16 slice in registers (each
// warp its 16 rows, the m16n8k16 A fragment), B from shared memory (``db``;
// TRANS_B 0: K-major, 1: MN-major); ``acc`` 0 overwrites d
template <int TRANS_B>
__device__ __forceinline__ void mma_rs128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  float* f = &d[0][0];
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(f[0]), "+f"(f[1]), "+f"(f[2]), "+f"(f[3]), "+f"(f[4]), "+f"(f[5]), "+f"(f[6]), "+f"(f[7]), "+f"(f[8]), "+f"(f[9]), "+f"(f[10]), "+f"(f[11]), "+f"(f[12]), "+f"(f[13]), "+f"(f[14]), "+f"(f[15]), "+f"(f[16]), "+f"(f[17]), "+f"(f[18]), "+f"(f[19]), "+f"(f[20]), "+f"(f[21]), "+f"(f[22]), "+f"(f[23]), "+f"(f[24]), "+f"(f[25]), "+f"(f[26]), "+f"(f[27]), "+f"(f[28]), "+f"(f[29]), "+f"(f[30]), "+f"(f[31]), "+f"(f[32]), "+f"(f[33]), "+f"(f[34]), "+f"(f[35]), "+f"(f[36]), "+f"(f[37]), "+f"(f[38]), "+f"(f[39]), "+f"(f[40]), "+f"(f[41]), "+f"(f[42]), "+f"(f[43]), "+f"(f[44]), "+f"(f[45]), "+f"(f[46]), "+f"(f[47]), "+f"(f[48]), "+f"(f[49]), "+f"(f[50]), "+f"(f[51]), "+f"(f[52]), "+f"(f[53]), "+f"(f[54]), "+f"(f[55]), "+f"(f[56]), "+f"(f[57]), "+f"(f[58]), "+f"(f[59]), "+f"(f[60]), "+f"(f[61]), "+f"(f[62]), "+f"(f[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TRANS_B));
}

// d (+)= A · B, m64n64k16, both from shared memory (``da``, ``db``;
// TRANS 0: K-major, 1: MN-major)
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void mma_ss64(float (&d)[8][4], uint64_t da, uint64_t db, int acc) {
  float* f = &d[0][0];
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(f[0]), "+f"(f[1]), "+f"(f[2]), "+f"(f[3]), "+f"(f[4]), "+f"(f[5]), "+f"(f[6]), "+f"(f[7]), "+f"(f[8]), "+f"(f[9]), "+f"(f[10]), "+f"(f[11]), "+f"(f[12]), "+f"(f[13]), "+f"(f[14]), "+f"(f[15]), "+f"(f[16]), "+f"(f[17]), "+f"(f[18]), "+f"(f[19]), "+f"(f[20]), "+f"(f[21]), "+f"(f[22]), "+f"(f[23]), "+f"(f[24]), "+f"(f[25]), "+f"(f[26]), "+f"(f[27]), "+f"(f[28]), "+f"(f[29]), "+f"(f[30]), "+f"(f[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TRANS_A), "n"(TRANS_B));
}

// d (+)= A · B, m64n128k16, both from shared memory (``da``, ``db``;
// TRANS 0: K-major, 1: MN-major)
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void mma_ss128(float (&d)[16][4], uint64_t da, uint64_t db, int acc) {
  float* f = &d[0][0];
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(f[0]), "+f"(f[1]), "+f"(f[2]), "+f"(f[3]), "+f"(f[4]), "+f"(f[5]), "+f"(f[6]), "+f"(f[7]), "+f"(f[8]), "+f"(f[9]), "+f"(f[10]), "+f"(f[11]), "+f"(f[12]), "+f"(f[13]), "+f"(f[14]), "+f"(f[15]), "+f"(f[16]), "+f"(f[17]), "+f"(f[18]), "+f"(f[19]), "+f"(f[20]), "+f"(f[21]), "+f"(f[22]), "+f"(f[23]), "+f"(f[24]), "+f"(f[25]), "+f"(f[26]), "+f"(f[27]), "+f"(f[28]), "+f"(f[29]), "+f"(f[30]), "+f"(f[31]), "+f"(f[32]), "+f"(f[33]), "+f"(f[34]), "+f"(f[35]), "+f"(f[36]), "+f"(f[37]), "+f"(f[38]), "+f"(f[39]), "+f"(f[40]), "+f"(f[41]), "+f"(f[42]), "+f"(f[43]), "+f"(f[44]), "+f"(f[45]), "+f"(f[46]), "+f"(f[47]), "+f"(f[48]), "+f"(f[49]), "+f"(f[50]), "+f"(f[51]), "+f"(f[52]), "+f"(f[53]), "+f"(f[54]), "+f"(f[55]), "+f"(f[56]), "+f"(f[57]), "+f"(f[58]), "+f"(f[59]), "+f"(f[60]), "+f"(f[61]), "+f"(f[62]), "+f"(f[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TRANS_A), "n"(TRANS_B));
}


// the N = 8·NT instance
template <int TRANS_B, int NT>
__device__ __forceinline__ void mma_rs(float (&d)[NT][4], const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  static_assert(NT == 8 || NT == 16, "wgmma widths 64 and 128");
  if constexpr (NT == 16)
    mma_rs128<TRANS_B>(d, a, db, acc);
  else
    mma_rs64<TRANS_B>(d, a, db, acc);
}

template <int TRANS_A, int TRANS_B, int NT>
__device__ __forceinline__ void mma_ss(float (&d)[NT][4], uint64_t da, uint64_t db, int acc) {
  static_assert(NT == 8 || NT == 16, "wgmma widths 64 and 128");
  if constexpr (NT == 16)
    mma_ss128<TRANS_A, TRANS_B>(d, da, db, acc);
  else
    mma_ss64<TRANS_A, TRANS_B>(d, da, db, acc);
}

// ---- mbarriers and bulk copies ----

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

// after the barriers' init, before any thread or copy uses them
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect ``bytes`` more of copies this phase
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

// wait for the phase of parity ``parity`` to complete
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_u32(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst``
// (16-byte aligned), completing on ``b``
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// the box at (c0, c1, c2) of a 3-D tensor map to shared ``dst``
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(b))
      : "memory");
}

// the box at (c0, c1) of a 2-D tensor map to shared ``dst``
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map, int c0, int c1,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(b))
      : "memory");
}

// the box at (c0, c1) of a 2-D tensor map into L2, ahead of its load
__device__ __forceinline__ void tma_prefetch2(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1)
               : "memory");
}

// after a thread's own stores to shared memory that a wgmma (the async
// proxy) reads or a copy overwrites next, before the barrier that hands
// them over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- thread block clusters ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster, with release and acquire
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// the address in block ``rank``'s shared memory of this block's ``addr``
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// arrive on a barrier of the cluster (``remote``: a mapa address), without
// ordering this thread's memory operations: for a barrier that only says
// that values read are in registers
__device__ __forceinline__ void bar_arrive_remote_relaxed(uint32_t remote) {
  asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// ---- the SW128 layout from and to registers ----

// the SW128 K-major image of the columns col0..col0+width-1 of an fp32
// [rows][in_dim] matrix (an nn.Linear weight: rows the outputs), bf16, zero
// past width: pad64(width) / 64 blocks of rows · 128 bytes; thread ``tid``
// of ``threads`` writes its share
__device__ __forceinline__ void pack_rows(__nv_bfloat16* dst, const float* w, int rows,
                                          int in_dim, int col0, int width, int tid,
                                          int threads) {
  const int per_block = rows * 64;
  const int total = (width + 63) / 64 * per_block;
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  for (int i = tid; i < total; i += threads) {
    const int blk = i / per_block, o = (i % per_block) / 64, c = i % 64;
    const int col = 64 * blk + c;
    const float v = col < width ? w[static_cast<long long>(o) * in_dim + col0 + col] : 0.f;
    *reinterpret_cast<__nv_bfloat16*>(d + static_cast<long long>(blk) * rows * 128 +
                                      sw128(o, c)) = __float2bfloat16_rn(v);
  }
}

// f[2n + half] = the bf16 pair at row lane/4 + 8·half, columns 8n + 2(lane%4)
// + {0, 1} of a 16-row tile kept as SW128 blocks of 16 rows (2 KB each,
// block b holding columns 64b..64b+63): the m16n8k16 fragment, by
// ldmatrix, four 8x8 matrices an instruction: (n, rows 0-7), (n, rows
// 8-15), (n + 1, rows 0-7), (n + 1, rows 8-15), lane l giving row l % 8
// of matrix l / 8
__device__ __forceinline__ uint32_t frag_row_addr(const unsigned char* tile, int n) {
  const int lane = threadIdx.x & 31, row = 8 * ((lane >> 3) & 1) + (lane & 7);
  const int nn = n + (lane >> 4);
  return smem_u32(tile) + (nn >> 3) * 2048 + row * 128 + ((((nn & 7) ^ row) & 7) << 4);
}

template <int NF>
__device__ __forceinline__ void frag_sw(uint32_t (&f)[NF], const unsigned char* tile) {
#pragma unroll
  for (int n = 0; n < NF / 2; n += 2)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(f[2 * n]), "=r"(f[2 * n + 1]), "=r"(f[2 * n + 2]), "=r"(f[2 * n + 3])
                 : "r"(frag_row_addr(tile, n))
                 : "memory");
}

// the inverse: the fragment into such a tile, by stmatrix
template <int NF>
__device__ __forceinline__ void frag_sw_store(unsigned char* tile, const uint32_t (&f)[NF]) {
#pragma unroll
  for (int n = 0; n < NF / 2; n += 2)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
                 ::"r"(frag_row_addr(tile, n)), "r"(f[2 * n]), "r"(f[2 * n + 1]),
                 "r"(f[2 * n + 2]), "r"(f[2 * n + 3])
                 : "memory");
}

// The same for the 16 rows row0..row0+15 (row0 a multiple of 8) of a
// tile of SW128 blocks of any row count, ``block_bytes`` apart (block b
// holding columns 64b..64b+63), at shared address ``tile``
__device__ __forceinline__ uint32_t frag_addr(uint32_t tile, int row0, int n, int block_bytes) {
  const int lane = threadIdx.x & 31, row = 8 * ((lane >> 3) & 1) + (lane & 7);
  const int nn = n + (lane >> 4);
  return tile + (nn >> 3) * block_bytes + (row0 + row) * 128 + (((nn ^ row) & 7) << 4);
}

template <int NF>
__device__ __forceinline__ void frag_load(uint32_t (&f)[NF], uint32_t tile, int row0,
                                          int block_bytes) {
#pragma unroll
  for (int n = 0; n < NF / 2; n += 2)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(f[2 * n]), "=r"(f[2 * n + 1]), "=r"(f[2 * n + 2]), "=r"(f[2 * n + 3])
                 : "r"(frag_addr(tile, row0, n, block_bytes))
                 : "memory");
}

template <int NF>
__device__ __forceinline__ void frag_store(uint32_t tile, int row0, int block_bytes,
                                           const uint32_t (&f)[NF]) {
#pragma unroll
  for (int n = 0; n < NF / 2; n += 2)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
                 ::"r"(frag_addr(tile, row0, n, block_bytes)), "r"(f[2 * n]), "r"(f[2 * n + 1]),
                 "r"(f[2 * n + 2]), "r"(f[2 * n + 3])
                 : "memory");
}

// ---- host: tensor maps ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a map of a bf16 array [d2][d1][d0] whose box is (64, b1, b2) elements, with
// the 128-byte swizzle; boxes past an edge read zeros
inline bool tensor_map3(CUtensorMap* m, const void* base, unsigned long long d0,
                        unsigned long long d1, unsigned long long d2, unsigned b1, unsigned b2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || base == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, b1, b2};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a map of a bf16 array [d1][d0] whose box is (64, b1) elements, with the
// 128-byte swizzle; boxes past an edge read zeros
inline bool tensor_map2(CUtensorMap* m, const void* base, unsigned long long d0,
                        unsigned long long d1, unsigned b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || base == nullptr) return false;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {d0 * 2};
  const cuuint32_t box[2] = {64, b1};
  const cuuint32_t step[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
