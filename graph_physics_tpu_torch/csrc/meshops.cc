// meshops: the loader's host mesh and graph functions, in C++.
//
// A copy of graph_physics_tpu/native/meshops.cc behind the same C ABI,
// bound with ctypes by graph_physics_tpu_torch/native.py, which builds it
// with g++ (-O3 -pthread -shared -fPIC) into build/native/ on first use.
// Every function is deterministic and allocates nothing that it returns:
// the caller gives the output buffers and their budgets, and a function
// whose budget is too small returns the negated count it needs.
// native.py keeps a numpy version of each function (its plain version),
// which gives the same arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// faces_to_edges: unique undirected edges (both directions) from simplex
// cells, receiver-sorted. cells: [C, nv] (nv = 3 triangles, 4 tets).
// Returns number of directed edges written, or -1 if budget too small.
// senders/receivers buffers must hold `budget` entries.
int64_t faces_to_edges(const int32_t* cells, int64_t num_cells, int32_t nv,
                       int64_t num_nodes, int32_t* senders,
                       int32_t* receivers, int64_t budget) {
  std::vector<uint64_t> keys;
  keys.reserve(num_cells * 12);
  auto push = [&](int64_t a, int64_t b) {
    if (a == b) return;
    int64_t lo = std::min(a, b), hi = std::max(a, b);
    keys.push_back((uint64_t)lo * (uint64_t)num_nodes + (uint64_t)hi);
  };
  for (int64_t c = 0; c < num_cells; ++c) {
    const int32_t* f = cells + c * nv;
    if (nv == 3) {
      push(f[0], f[1]);
      push(f[1], f[2]);
      push(f[2], f[0]);
    } else {  // tet: all 6 undirected edges
      for (int i = 0; i < 4; ++i)
        for (int j = i + 1; j < 4; ++j) push(f[i], f[j]);
    }
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  int64_t e = (int64_t)keys.size() * 2;
  if (e > budget) return -e;
  // emit both directions, then receiver-sort
  std::vector<std::pair<int32_t, int32_t>> edges;  // (recv, send)
  edges.reserve(e);
  for (uint64_t k : keys) {
    int32_t lo = (int32_t)(k / (uint64_t)num_nodes);
    int32_t hi = (int32_t)(k % (uint64_t)num_nodes);
    edges.push_back({hi, lo});
    edges.push_back({lo, hi});
  }
  std::sort(edges.begin(), edges.end());
  for (int64_t i = 0; i < e; ++i) {
    receivers[i] = edges[i].first;
    senders[i] = edges[i].second;
  }
  return e;
}

// ---------------------------------------------------------------------
// k_hop: all pairs within graph distance <= k (no self loops),
// receiver-sorted. Input edges may be in any order. Returns directed
// edge count (negative requirement if budget too small).
int64_t k_hop(const int32_t* senders, const int32_t* receivers,
              int64_t num_edges, int64_t num_nodes, int32_t k,
              int32_t* out_send, int32_t* out_recv, int64_t budget) {
  // CSR
  std::vector<int64_t> deg(num_nodes + 1, 0);
  for (int64_t i = 0; i < num_edges; ++i) deg[senders[i] + 1]++;
  std::vector<int64_t> ptr(num_nodes + 1, 0);
  std::partial_sum(deg.begin(), deg.end(), ptr.begin());
  std::vector<int32_t> adj(num_edges);
  std::vector<int64_t> fill(ptr.begin(), ptr.end() - 1);
  for (int64_t i = 0; i < num_edges; ++i) adj[fill[senders[i]]++] = receivers[i];

  std::vector<std::pair<int32_t, int32_t>> out;  // (recv, send)
  std::vector<int32_t> level(num_nodes, -1);
  std::vector<int32_t> frontier, next, visited;
  for (int64_t s = 0; s < num_nodes; ++s) {
    frontier.clear();
    visited.clear();
    frontier.push_back((int32_t)s);
    level[s] = 0;
    visited.push_back((int32_t)s);
    for (int32_t hop = 1; hop <= k; ++hop) {
      next.clear();
      for (int32_t u : frontier) {
        for (int64_t j = ptr[u]; j < ptr[u + 1]; ++j) {
          int32_t v = adj[j];
          if (level[v] < 0) {
            level[v] = hop;
            visited.push_back(v);
            next.push_back(v);
            out.push_back({v, (int32_t)s});
          }
        }
      }
      frontier.swap(next);
    }
    for (int32_t v : visited) level[v] = -1;
  }
  int64_t e = (int64_t)out.size();
  if (e > budget) return -e;
  std::sort(out.begin(), out.end());
  for (int64_t i = 0; i < e; ++i) {
    out_recv[i] = out[i].first;
    out_send[i] = out[i].second;
  }
  return e;
}

// ---------------------------------------------------------------------
// radius_pairs: all unordered pairs (i<j) with |pos_i - pos_j| <= r,
// via a uniform grid hash (the cKDTree replacement,
// reference preprocessing.py:114-120). pos: [N, dim], dim in {2, 3}.
// Returns pair count (negative requirement if budget too small).
int64_t radius_pairs(const float* pos, int64_t n, int32_t dim, float r,
                     int32_t* out_a, int32_t* out_b, int64_t budget) {
  if (n == 0) return 0;
  float lo[3] = {1e30f, 1e30f, 1e30f};
  for (int64_t i = 0; i < n; ++i)
    for (int32_t d = 0; d < dim; ++d) lo[d] = std::min(lo[d], pos[i * dim + d]);
  const float cell = std::max(r, 1e-12f);
  auto cell_of = [&](int64_t i, int32_t d) {
    return (int64_t)std::floor((pos[i * dim + d] - lo[d]) / cell);
  };
  // hash grid: sort nodes by cell key
  std::vector<std::pair<uint64_t, int32_t>> keyed(n);
  auto key_of = [&](int64_t cx, int64_t cy, int64_t cz) {
    return ((uint64_t)(cx & 0x1FFFFF) << 42) | ((uint64_t)(cy & 0x1FFFFF) << 21) |
           (uint64_t)(cz & 0x1FFFFF);
  };
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = cell_of(i, 0), cy = cell_of(i, 1), cz = dim > 2 ? cell_of(i, 2) : 0;
    keyed[i] = {key_of(cx, cy, cz), (int32_t)i};
  }
  std::sort(keyed.begin(), keyed.end());
  const float r2 = r * r;
  int64_t count = 0;
  // neighbour cell offsets
  for (int64_t i = 0; i < n; ++i) {
    int32_t a = keyed[i].second;
    int64_t ax = cell_of(a, 0), ay = cell_of(a, 1), az = dim > 2 ? cell_of(a, 2) : 0;
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = (dim > 2 ? -1 : 0); dz <= (dim > 2 ? 1 : 0); ++dz) {
          uint64_t nk = key_of(ax + dx, ay + dy, az + dz);
          auto it = std::lower_bound(
              keyed.begin(), keyed.end(), std::make_pair(nk, (int32_t)-1));
          for (; it != keyed.end() && it->first == nk; ++it) {
            int32_t b = it->second;
            if (b <= a) continue;  // unordered pairs, i<j
            float d2 = 0;
            for (int32_t d = 0; d < dim; ++d) {
              float diff = pos[a * dim + d] - pos[b * dim + d];
              d2 += diff * diff;
            }
            if (d2 <= r2) {
              if (count < budget) {
                out_a[count] = a;
                out_b[count] = b;
              }
              ++count;
            }
          }
        }
  }
  if (count > budget) return -count;
  return count;
}

// ---------------------------------------------------------------------
// radius_cross_pairs: all pairs (i in A, j in B) with |a_i - b_j| <= r.
// The world-edge sidecar only keeps {OBSTACLE, HANDLE} x NORMAL pairs
// (reference preprocessing.py:114-124); searching the two groups
// cross-wise skips the dominant same-group candidate volume of the
// full-mesh grid pass. Grid is a dense CSR over A's bounding box
// (callers pass the smaller group as A) and every B point first takes
// a bbox +r reject — on the plate workload most NORMAL nodes are far
// from the obstacle, so the common probe is a handful of compares.
// Falls back to a sorted-key grid when A's bbox would need too many
// cells (sparse A at tiny r). Returns pair count (negative requirement
// if budget too small).
static int64_t cross_pairs_sorted(const float* pa, int64_t na,
                                  const float* pb, int64_t nb, int32_t dim,
                                  float r, const float* lo, float cell,
                                  int32_t* out_a, int32_t* out_b,
                                  int64_t budget) {
  auto cell_of = [&](const float* p, int64_t i, int32_t d) {
    return (int64_t)std::floor((p[i * dim + d] - lo[d]) / cell);
  };
  auto key_of = [&](int64_t cx, int64_t cy, int64_t cz) {
    return ((uint64_t)(cx & 0x1FFFFF) << 42) | ((uint64_t)(cy & 0x1FFFFF) << 21) |
           (uint64_t)(cz & 0x1FFFFF);
  };
  std::vector<std::pair<uint64_t, int32_t>> keyed(na);
  for (int64_t i = 0; i < na; ++i) {
    int64_t cx = cell_of(pa, i, 0), cy = cell_of(pa, i, 1),
            cz = dim > 2 ? cell_of(pa, i, 2) : 0;
    keyed[i] = {key_of(cx, cy, cz), (int32_t)i};
  }
  std::sort(keyed.begin(), keyed.end());
  const float r2 = r * r;
  int64_t count = 0;
  for (int64_t j = 0; j < nb; ++j) {
    int64_t bx = cell_of(pb, j, 0), by = cell_of(pb, j, 1),
            bz = dim > 2 ? cell_of(pb, j, 2) : 0;
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy) {
        // z keys for fixed (x, y) are consecutive integers: one
        // lower_bound covers the whole 3-cell (or 1-cell in 2-D) run
        int64_t z0 = dim > 2 ? bz - 1 : 0, z1 = dim > 2 ? bz + 1 : 0;
        uint64_t k0 = key_of(bx + dx, by + dy, z0);
        uint64_t k1 = key_of(bx + dx, by + dy, z1);
        auto it = std::lower_bound(
            keyed.begin(), keyed.end(), std::make_pair(k0, (int32_t)-1));
        for (; it != keyed.end() && it->first <= k1; ++it) {
          int32_t a = it->second;
          float d2 = 0;
          for (int32_t d = 0; d < dim; ++d) {
            float diff = pa[a * dim + d] - pb[j * dim + d];
            d2 += diff * diff;
          }
          if (d2 <= r2) {
            if (count < budget) {
              out_a[count] = a;
              out_b[count] = (int32_t)j;
            }
            ++count;
          }
        }
      }
  }
  if (count > budget) return -count;
  return count;
}

int64_t radius_cross_pairs(const float* pa, int64_t na, const float* pb,
                           int64_t nb, int32_t dim, float r,
                           int32_t* out_a, int32_t* out_b, int64_t budget) {
  if (na == 0 || nb == 0) return 0;
  float lo[3] = {1e30f, 1e30f, 1e30f};
  float hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < na; ++i)
    for (int32_t d = 0; d < dim; ++d) {
      lo[d] = std::min(lo[d], pa[i * dim + d]);
      hi[d] = std::max(hi[d], pa[i * dim + d]);
    }
  const float cell = std::max(r, 1e-12f);
  int64_t dims[3] = {1, 1, 1};
  int64_t ncells = 1;
  bool dense_ok = true;
  for (int32_t d = 0; d < dim; ++d) {
    double span = ((double)hi[d] - lo[d]) / cell;
    if (!(span < 2e6)) { dense_ok = false; break; }
    dims[d] = (int64_t)span + 1;
    ncells *= dims[d];
    if (ncells > std::max<int64_t>(int64_t(1) << 20, na * 64)) {
      dense_ok = false;
      break;
    }
  }
  if (!dense_ok)
    return cross_pairs_sorted(pa, na, pb, nb, dim, r, lo, cell,
                              out_a, out_b, budget);

  const int64_t sz = dim > 2 ? dims[2] : 1;  // z stride (innermost)
  auto cell_id = [&](int64_t cx, int64_t cy, int64_t cz) {
    return (cx * dims[1] + cy) * sz + cz;
  };
  // dense CSR: counts -> prefix -> fill
  std::vector<int32_t> start(ncells + 1, 0);
  std::vector<int32_t> acell(na), item(na);
  for (int64_t i = 0; i < na; ++i) {
    int64_t cx = (int64_t)((pa[i * dim + 0] - lo[0]) / cell);
    int64_t cy = (int64_t)((pa[i * dim + 1] - lo[1]) / cell);
    int64_t cz = dim > 2 ? (int64_t)((pa[i * dim + 2] - lo[2]) / cell) : 0;
    acell[i] = (int32_t)cell_id(std::min(cx, dims[0] - 1),
                                std::min(cy, dims[1] - 1),
                                std::min(cz, sz - 1));
    ++start[acell[i] + 1];
  }
  for (int64_t c = 0; c < ncells; ++c) start[c + 1] += start[c];
  {
    std::vector<int32_t> cur(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < na; ++i) item[cur[acell[i]]++] = (int32_t)i;
  }
  const float r2 = r * r;
  int64_t count = 0;
  for (int64_t j = 0; j < nb; ++j) {
    const float* p = pb + j * dim;
    bool out = false;  // bbox + r reject: kills far-field probes cheaply
    for (int32_t d = 0; d < dim; ++d)
      if (p[d] < lo[d] - r || p[d] > hi[d] + r) { out = true; break; }
    if (out) continue;
    int64_t bx = (int64_t)std::floor((p[0] - lo[0]) / cell);
    int64_t by = (int64_t)std::floor((p[1] - lo[1]) / cell);
    int64_t bz = dim > 2 ? (int64_t)std::floor((p[2] - lo[2]) / cell) : 0;
    int64_t x0 = std::max<int64_t>(bx - 1, 0), x1 = std::min(bx + 1, dims[0] - 1);
    int64_t y0 = std::max<int64_t>(by - 1, 0), y1 = std::min(by + 1, dims[1] - 1);
    int64_t z0 = std::max<int64_t>(bz - 1, 0), z1 = std::min(bz + 1, sz - 1);
    for (int64_t cx = x0; cx <= x1; ++cx)
      for (int64_t cy = y0; cy <= y1; ++cy) {
        // z cells are contiguous in the CSR: one range per (x, y)
        int64_t c0 = cell_id(cx, cy, z0), c1 = cell_id(cx, cy, z1);
        for (int32_t k = start[c0]; k < start[c1 + 1]; ++k) {
          int32_t a = item[k];
          float d2 = 0;
          for (int32_t d = 0; d < dim; ++d) {
            float diff = pa[a * dim + d] - p[d];
            d2 += diff * diff;
          }
          if (d2 <= r2) {
            if (count < budget) {
              out_a[count] = a;
              out_b[count] = (int32_t)j;
            }
            ++count;
          }
        }
      }
  }
  if (count > budget) return -count;
  return count;
}

// ---------------------------------------------------------------------
// rcb_partition: recursive coordinate bisection; writes part label per
// node. Deterministic, balanced within one node per split.
void rcb_partition(const float* pos, int64_t n, int32_t dim,
                   int32_t num_parts, int32_t* labels) {
  struct Task {
    std::vector<int64_t> ids;
    int32_t parts, base;
  };
  std::vector<Task> stack;
  std::vector<int64_t> all(n);
  std::iota(all.begin(), all.end(), 0);
  stack.push_back({std::move(all), num_parts, 0});
  while (!stack.empty()) {
    Task t = std::move(stack.back());
    stack.pop_back();
    if (t.parts <= 1 || t.ids.size() <= 1) {
      for (int64_t id : t.ids) labels[id] = t.base;
      continue;
    }
    // widest axis
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t id : t.ids)
      for (int32_t d = 0; d < dim; ++d) {
        mn[d] = std::min(mn[d], pos[id * dim + d]);
        mx[d] = std::max(mx[d], pos[id * dim + d]);
      }
    int32_t axis = 0;
    for (int32_t d = 1; d < dim; ++d)
      if (mx[d] - mn[d] > mx[axis] - mn[axis]) axis = d;
    int32_t left_parts = t.parts / 2;
    int64_t cut = (int64_t)std::llround((double)t.ids.size() * left_parts / t.parts);
    std::nth_element(
        t.ids.begin(), t.ids.begin() + cut, t.ids.end(),
        [&](int64_t x, int64_t y) {
          float px = pos[x * dim + axis], py = pos[y * dim + axis];
          if (px != py) return px < py;
          return x < y;  // deterministic tie-break
        });
    Task left{std::vector<int64_t>(t.ids.begin(), t.ids.begin() + cut),
              left_parts, t.base};
    Task right{std::vector<int64_t>(t.ids.begin() + cut, t.ids.end()),
               t.parts - left_parts, t.base + left_parts};
    stack.push_back(std::move(left));
    stack.push_back(std::move(right));
  }
}

// ---------------------------------------------------------------------
// pack_rows / repeat_rows: packed-batch assembly for the host loader
// (training/packed.pack_frames). The [N, B, F] layout interleaves B
// per-frame arrays row-by-row: dst[n, b, :] = srcs[b][n, :]. numpy does
// this single-threaded through generic strided loops (the measured
// loader bottleneck at cylinder scale, BASELINE.md round 4); here it is
// a threaded sequential-write copy. row_bytes = F * itemsize. Called
// through ctypes, which releases the GIL — FrameBuilder workers overlap.

static void pack_rows_range(const void* const* srcs, int64_t num_b,
                            int64_t row_bytes, char* dst, int64_t n0,
                            int64_t n1) {
  if (row_bytes % 8 == 0) {
    // word copies beat memcpy-call overhead at the typical 8-64 B rows
    const int64_t words = row_bytes / 8;
    for (int64_t n = n0; n < n1; ++n) {
      uint64_t* out = (uint64_t*)(dst + n * num_b * row_bytes);
      for (int64_t b = 0; b < num_b; ++b) {
        const uint64_t* in =
            (const uint64_t*)((const char*)srcs[b] + n * row_bytes);
        for (int64_t w = 0; w < words; ++w) *out++ = in[w];
      }
    }
  } else if (row_bytes % 4 == 0) {
    const int64_t words = row_bytes / 4;
    for (int64_t n = n0; n < n1; ++n) {
      uint32_t* out = (uint32_t*)(dst + n * num_b * row_bytes);
      for (int64_t b = 0; b < num_b; ++b) {
        const uint32_t* in =
            (const uint32_t*)((const char*)srcs[b] + n * row_bytes);
        for (int64_t w = 0; w < words; ++w) *out++ = in[w];
      }
    }
  } else {
    for (int64_t n = n0; n < n1; ++n) {
      char* out = dst + n * num_b * row_bytes;
      for (int64_t b = 0; b < num_b; ++b, out += row_bytes)
        std::memcpy(out, (const char*)srcs[b] + n * row_bytes, row_bytes);
    }
  }
}

static void repeat_rows_range(const void* src, int64_t num_b,
                              int64_t row_bytes, char* dst, int64_t n0,
                              int64_t n1) {
  if (row_bytes % 8 == 0) {
    const int64_t words = row_bytes / 8;
    for (int64_t n = n0; n < n1; ++n) {
      const uint64_t* in = (const uint64_t*)((const char*)src + n * row_bytes);
      uint64_t* out = (uint64_t*)(dst + n * num_b * row_bytes);
      for (int64_t b = 0; b < num_b; ++b)
        for (int64_t w = 0; w < words; ++w) *out++ = in[w];
    }
  } else if (row_bytes % 4 == 0) {
    const int64_t words = row_bytes / 4;
    for (int64_t n = n0; n < n1; ++n) {
      const uint32_t* in = (const uint32_t*)((const char*)src + n * row_bytes);
      uint32_t* out = (uint32_t*)(dst + n * num_b * row_bytes);
      for (int64_t b = 0; b < num_b; ++b)
        for (int64_t w = 0; w < words; ++w) *out++ = in[w];
    }
  } else {
    for (int64_t n = n0; n < n1; ++n) {
      const char* in = (const char*)src + n * row_bytes;
      char* out = dst + n * num_b * row_bytes;
      for (int64_t b = 0; b < num_b; ++b, out += row_bytes)
        std::memcpy(out, in, row_bytes);
    }
  }
}

void pack_rows(const void* const* srcs, int64_t num_b, int64_t num_n,
               int64_t row_bytes, void* dst, int32_t nthreads) {
  if (nthreads <= 1 || num_n < 2 * nthreads) {
    pack_rows_range(srcs, num_b, row_bytes, (char*)dst, 0, num_n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  int64_t chunk = (num_n + nthreads - 1) / nthreads;
  for (int32_t t = 0; t < nthreads; ++t) {
    int64_t n0 = t * chunk, n1 = std::min(num_n, n0 + chunk);
    if (n0 >= n1) break;
    ts.emplace_back(pack_rows_range, srcs, num_b, row_bytes, (char*)dst,
                    n0, n1);
  }
  for (auto& t : ts) t.join();
}

// pack_block: strided variant for whole-batch sources — one contiguous
// [B, N, w] block (a fancy-indexed trajectory slice) interleaved into a
// column window of the [N, B, F] batch: dst(n,b) = src + b·sb + n·sn,
// out at dst + n·dn + b·db. All strides in bytes; the fp32 pipeline
// guarantees 4-byte alignment (u32 word path), anything else memcpys.
static void pack_block_range(const char* src, int64_t num_b,
                             int64_t row_bytes, int64_t sb, int64_t sn,
                             char* dst, int64_t dn, int64_t db,
                             int64_t n0, int64_t n1) {
  if (row_bytes % 4 == 0 && sb % 4 == 0 && sn % 4 == 0 && dn % 4 == 0 &&
      db % 4 == 0) {
    const int64_t words = row_bytes / 4;
    for (int64_t n = n0; n < n1; ++n) {
      const char* in_row = src + n * sn;
      char* out_row = dst + n * dn;
      for (int64_t b = 0; b < num_b; ++b) {
        const uint32_t* in = (const uint32_t*)(in_row + b * sb);
        uint32_t* out = (uint32_t*)(out_row + b * db);
        for (int64_t w = 0; w < words; ++w) out[w] = in[w];
      }
    }
  } else {
    for (int64_t n = n0; n < n1; ++n) {
      const char* in_row = src + n * sn;
      char* out_row = dst + n * dn;
      for (int64_t b = 0; b < num_b; ++b)
        std::memcpy(out_row + b * db, in_row + b * sb, row_bytes);
    }
  }
}

void pack_block(const void* src, int64_t num_b, int64_t num_n,
                int64_t row_bytes, int64_t sb, int64_t sn, void* dst,
                int64_t dn, int64_t db, int32_t nthreads) {
  if (nthreads <= 1 || num_n < 2 * nthreads) {
    pack_block_range((const char*)src, num_b, row_bytes, sb, sn,
                     (char*)dst, dn, db, 0, num_n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  int64_t chunk = (num_n + nthreads - 1) / nthreads;
  for (int32_t t = 0; t < nthreads; ++t) {
    int64_t n0 = t * chunk, n1 = std::min(num_n, n0 + chunk);
    if (n0 >= n1) break;
    ts.emplace_back(pack_block_range, (const char*)src, num_b, row_bytes,
                    sb, sn, (char*)dst, dn, db, n0, n1);
  }
  for (auto& t : ts) t.join();
}

void repeat_rows(const void* src, int64_t num_b, int64_t num_n,
                 int64_t row_bytes, void* dst, int32_t nthreads) {
  if (nthreads <= 1 || num_n < 2 * nthreads) {
    repeat_rows_range(src, num_b, row_bytes, (char*)dst, 0, num_n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  int64_t chunk = (num_n + nthreads - 1) / nthreads;
  for (int32_t t = 0; t < nthreads; ++t) {
    int64_t n0 = t * chunk, n1 = std::min(num_n, n0 + chunk);
    if (n0 >= n1) break;
    ts.emplace_back(repeat_rows_range, src, num_b, row_bytes, (char*)dst,
                    n0, n1);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
