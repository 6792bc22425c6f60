// The row maps of the GraphNetBlock kernels (the forward body gn_fwd.cuh,
// the backward passes gn_bwd_passes.cuh) and of the edge-attention kernels
// (ea_fwd.cuh, ea_bwd_passes.cuh): for one edge
// layout, the end of the rows that belong to some receiver (ranged_end),
// whether rows lie past it (PADDED: CSR padding), the receiver of a row,
// and the rows a node owns (first, count, step).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gn_rows {

// What a row map reads: the layout's arrays and sizes
struct RowMap {
  const int32_t* row_ptr;    // CSR: [N + 1] receiver r owns rows row_ptr[r]:row_ptr[r+1]
  const int32_t* receivers;  // CSR: [S] receiver per row (N-1 on padding); backward only
  int k_slots, node_block;   // NK: K slots a receiver, nb receivers a node block
  int n_nodes, total_rows;
};

// receiver-sorted CSR; rows from row_ptr[N] on are padding
struct CsrRows {
  static constexpr bool PADDED = true;
  static __device__ __forceinline__ long long ranged_end(const RowMap& a) {
    return a.row_ptr[a.n_nodes];
  }
  static __device__ __forceinline__ long long receiver(const RowMap& a, long long s) {
    return a.receivers[s];
  }
  static __device__ __forceinline__ void own(const RowMap& a, int j, long long& first,
                                             int& count, int& step) {
    first = a.row_ptr[j];
    count = a.row_ptr[j + 1] - a.row_ptr[j];
    step = 1;
  }
  // the t-th row in receiver order: rows are receiver-sorted already
  static __device__ __forceinline__ long long by_receiver(const RowMap&, long long t) {
    return t;
  }
};

// NK slots (ops/tiling.py): receiver g·nb + r owns slots g·K·nb + k·nb + r,
// k < K; every slot belongs to its receiver, masked ones included
struct NkRows {
  static constexpr bool PADDED = false;
  static __device__ __forceinline__ long long ranged_end(const RowMap& a) {
    return a.total_rows;
  }
  static __device__ __forceinline__ long long receiver(const RowMap& a, long long s) {
    const long long per_group = static_cast<long long>(a.k_slots) * a.node_block;
    return (s / per_group) * a.node_block + s % a.node_block;
  }
  static __device__ __forceinline__ void own(const RowMap& a, int j, long long& first,
                                             int& count, int& step) {
    first = static_cast<long long>(j / a.node_block) * a.k_slots * a.node_block +
            j % a.node_block;
    count = a.k_slots;
    step = a.node_block;
  }
  // the t-th row in receiver order: slot t % K of receiver t / K
  static __device__ __forceinline__ long long by_receiver(const RowMap& a, long long t) {
    const long long j = t / a.k_slots;
    return (j / a.node_block) * a.k_slots * a.node_block + (t % a.k_slots) * a.node_block +
           j % a.node_block;
  }
};

}  // namespace gn_rows
