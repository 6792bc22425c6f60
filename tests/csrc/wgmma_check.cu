// Card checks of wgmma_common.cuh, the helpers the hidden-64/128
// GraphNetBlock kernels (gn_wide.cuh) build their products from; no TPU
// kernel counterpart. Each C function runs one warpgroup product (or one
// tile copy) the kernels run, for tests/test_torch_cuda.py to hold against
// torch.matmul: A · Wᵀ and A · W with A from registers and W from the
// packed image (the MLP layers' products), Gᵀ · X with both from TMA
// boxes (the weight-gradient pass), and a 16-sample box read into
// fragments (the row tiles' ring). One block each: nothing here is timed.

#include "wgmma_common.cuh"

using namespace wg;
using bf16 = __nv_bfloat16;

namespace {

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__global__ void pack_kernel(bf16* dst, const float* w, int rows, int in_dim, int col0,
                            int width) {
  pack_rows(dst, w, rows, in_dim, col0, width, threadIdx.x, blockDim.x);
}

// out [64][H] fp32 = A · Wᵀ (TRANS 0) or A · W (TRANS 1): A [64][H] bf16,
// img the packed [H][H] W
template <int H, int TRANS>
__global__ void rs_kernel(const bf16* a, const bf16* img, float* out) {
  extern __shared__ unsigned char rs_smem[];
  unsigned char* w = aligned_smem(rs_smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(w + H * H * 2);
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    bar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect(bar, H * H * 2);
    bulk_load(w, img, H * H * 2, bar);
  }
  bar_wait(bar, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r = lane >> 2, q = lane & 3;
  uint32_t f[H / 4];
#pragma unroll
  for (int n = 0; n < H / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      f[2 * n + half] = *reinterpret_cast<const uint32_t*>(
          a + (16 * warp + r + 8 * half) * H + 8 * n + 2 * q);
  float d[H / 8][4];
  const uint32_t base = smem_u32(w);
  fence();
#pragma unroll
  for (int ks = 0; ks < H / 16; ++ks) {
    const uint32_t af[4] = {f[4 * ks], f[4 * ks + 1], f[4 * ks + 2], f[4 * ks + 3]};
    const uint64_t db = TRANS ? desc_mn(base, ks, H * 128) : desc_k(base, ks, H * 128);
    mma_rs<TRANS>(d, af, db, ks > 0);
  }
  commit();
  wait<0>();
#pragma unroll
  for (int n = 0; n < H / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* o = out + (16 * warp + r + 8 * half) * H + 8 * n + 2 * q;
      o[0] = d[n][2 * half];
      o[1] = d[n][2 * half + 1];
    }
}

struct Maps {
  CUtensorMap g, x;
};

// out [H][H] fp32 = Gᵀ · X over 64 rows: G, X [64][H] bf16 by TMA, one
// warpgroup per 64 outputs
template <int H>
__global__ void ss_kernel(const __grid_constant__ Maps m, float* out) {
  extern __shared__ unsigned char ss_smem[];
  unsigned char* s = aligned_smem(ss_smem);
  constexpr int BOX = 64 * 128;
  unsigned char* sg = s;
  unsigned char* sx = s + (H / 64) * BOX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(s + 2 * (H / 64) * BOX);
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    bar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect(bar, 2 * (H / 64) * BOX);
    for (int b = 0; b < H / 64; ++b) {
      tma_load3(sg + b * BOX, &m.g, 64 * b, 0, 0, bar);
      tma_load3(sx + b * BOX, &m.x, 64 * b, 0, 0, bar);
    }
  }
  bar_wait(bar, 0);
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float d[H / 8][4];
  fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    mma_ss<1, 1>(d, desc_mn(smem_u32(sg + wgi * BOX), ks, BOX), desc_mn(smem_u32(sx), ks, BOX),
                 ks > 0);
  commit();
  wait<0>();
#pragma unroll
  for (int n = 0; n < H / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* o = out + (64 * wgi + 16 * warp + (lane >> 2) + 8 * half) * H + 8 * n + 2 * (lane & 3);
      o[0] = d[n][2 * half];
      o[1] = d[n][2 * half + 1];
    }
}

// out [16][H] bf16 = the box of 16 samples from b0 of row ``row`` of a
// [rows][batch][H] array, read back through frag_sw (zeros past batch)
template <int H>
__global__ void box_kernel(const __grid_constant__ CUtensorMap m, int row, int b0, bf16* out) {
  extern __shared__ unsigned char box_smem[];
  unsigned char* s = aligned_smem(box_smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s + (H / 64) * 2048);
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    bar_fence_init();
  }
  __syncwarp();
  if (threadIdx.x == 0) {
    bar_expect(bar, (H / 64) * 2048);
    for (int b = 0; b < H / 64; ++b) tma_load3(s + b * 2048, &m, 64 * b, b0, row, bar);
  }
  bar_wait(bar, 0);
  uint32_t f[H / 4];
  frag_sw(f, s);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < H / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(out + ((lane >> 2) + 8 * half) * H + 8 * n + 2 * (lane & 3)) =
          f[2 * n + half];
}

template <class K>
cudaError_t allow_smem(K kernel, int smem) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// dst = the packed image of w's columns col0..col0+width-1 (pack_rows)
extern "C" int wgc_pack(const void* w, int rows, int in_dim, int col0, int width, void* dst,
                        void* stream) {
  pack_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<bf16*>(dst), static_cast<const float*>(w), rows, in_dim, col0, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgc_rs(int h, int trans, const void* a, const void* img, void* out, void* stream) {
  const int smem = h * h * 2 + 2048;
  auto run = [&](auto kernel) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(img), static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  };
  if (h == 64) return trans ? run(rs_kernel<64, 1>) : run(rs_kernel<64, 0>);
  if (h == 128) return trans ? run(rs_kernel<128, 1>) : run(rs_kernel<128, 0>);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int wgc_ss(int h, const void* g, const void* x, void* out, void* stream) {
  Maps m;
  if ((h != 64 && h != 128) || !tensor_map3(&m.g, g, h, 64, 1, 64, 1) ||
      !tensor_map3(&m.x, x, h, 64, 1, 64, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * (h / 64) * 64 * 128 + 2048;
  auto run = [&](auto kernel) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<1, 128 * (h / 64), smem, static_cast<cudaStream_t>(stream)>>>(
        m, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  };
  return h == 64 ? run(ss_kernel<64>) : run(ss_kernel<128>);
}

extern "C" int wgc_box(int h, const void* src, int rows, int batch, int row, int b0, void* out,
                       void* stream) {
  CUtensorMap m;
  if ((h != 64 && h != 128) || !tensor_map3(&m, src, h, batch, rows, 16, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (h / 64) * 2048 + 2048;
  auto run = [&](auto kernel) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(m, row, b0,
                                                               static_cast<bf16*>(out));
    return static_cast<int>(cudaGetLastError());
  };
  return h == 64 ? run(box_kernel<64>) : run(box_kernel<128>);
}
