// Gumbel perturbation of Transolver slice logits, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel graph_physics_tpu/ops/gumbel.py:_kernel
// (:51), called by gumbel_perturb (:104) from the Transolver's
// gumbel_softmax during training. Same function, per element e of the
// flattened [B*N*H*G] logits x:
//   u   = bitcast_f32((bits >> 9) | 0x3F800000) - 1     (2^-23 grid in [0, 1))
//   out = float(x) - logf(-logf(u + 1e-8) + 1e-8)        (fp32)
// The TPU draws `bits` from the core's hardware generator; here they come
// from Philox4x32-10 (Random123's constants, written out below, no
// curand): thread i makes the block at counter (i, i >> 32, 0, 0) with the
// 2-word key read from device memory, and its 4 words serve elements
// 4i .. 4i+3. The plain version (ops/gumbel.py:gumbel_perturb_reference)
// runs the same Philox on int64 tensors, so both draw the same bits.
// logf, not __logf, so that the plain version's torch.log can match it.
//
// What bounds it on this card: bytes. It reads 2 bytes (bf16) and writes
// 4 a element: 29.9 MB at the Transolver slice (16 x 2,432 padded rows
// x 4 heads x 32 slices), ~8.9 us at 3.35 TB/s; 333 MB (~99.5 us) at the
// graded mesh's 27,136 rows. The ~25 integer operations a element of
// Philox and the two logs stay under that on the CUDA cores.
//
// What the design does about it: the uniform tensor never exists. The
// torch.rand path writes a [B*N*H*G] fp32 uniform tensor and reads it back
// for the logs and the add (10 bytes a element more); here each thread
// reads its 4 logits as one 8-byte load (16 for fp32), keeps the bits in
// registers and writes one float4. A grid-stride loop over the 4-element
// groups; a tail that is not a multiple of 4, or a misaligned input, takes
// scalar loads. Launches go on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t M0 = 0xD2511F53u;
constexpr uint32_t M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u;
constexpr uint32_t W1 = 0xBB67AE85u;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

__device__ __forceinline__ uint4 block_bits(long long i, uint2 k) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32), 0u, 0u), k);
}

__device__ __forceinline__ uint2 load_key(const long long* key) {
  return make_uint2(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]));
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return -logf(-logf(u + 1e-8f) + 1e-8f);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// the 4 logits of group i as floats, one vector load
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, long long base) {
  const uint2 raw = *reinterpret_cast<const uint2*>(x + base);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* x, long long base) {
  return *reinterpret_cast<const float4*>(x + base);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gumbel_perturb_kernel(const T* __restrict__ x, const long long* __restrict__ key,
                          float* __restrict__ out, long long n) {
  const uint2 k = load_key(key);
  const long long groups = (n + 3) / 4;
  const bool vec = reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < groups;
       i += stride) {
    const uint4 r = block_bits(i, k);
    const long long base = 4 * i;
    if (vec && base + 4 <= n) {
      const float4 v = load4(x, base);
      *reinterpret_cast<float4*>(out + base) =
          make_float4(v.x + gumbel(r.x), v.y + gumbel(r.y), v.z + gumbel(r.z),
                      v.w + gumbel(r.w));
    } else {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && base + j < n; ++j)
        out[base + j] = to_float(x[base + j]) + gumbel(w[j]);
    }
  }
}

// the raw words, for the check against the plain version's bits
__global__ void __launch_bounds__(THREADS)
    philox_bits_kernel(const long long* __restrict__ key, uint32_t* __restrict__ out,
                       long long n) {
  const uint2 k = load_key(key);
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < groups;
       i += stride) {
    const uint4 r = block_bits(i, k);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    for (int j = 0; j < 4 && 4 * i + j < n; ++j) out[4 * i + j] = w[j];
  }
}

cudaError_t grid_for(long long n, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long need = ((n + 3) / 4 + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  *grid = static_cast<int>(need < cap ? need : cap);
  return cudaSuccess;
}

}  // namespace

// x: contiguous [n] logits, bf16 (dtype 0) or fp32 (dtype 1); key: int64
// [2] on the device, each word in [0, 2^32); out: fp32 [n]. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int gumbel_perturb(const void* x, const void* key, void* out, long long n, int dtype,
                              void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t err = grid_for(n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const long long*>(key);
  auto* o = static_cast<float*>(out);
  if (dtype == 0)
    gumbel_perturb_kernel<<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x), k, o, n);
  else
    gumbel_perturb_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x), k, o, n);
  return static_cast<int>(cudaGetLastError());
}

// The n random words of key as uint32 [n] (element e: word e % 4 of the
// block at counter e / 4), as the perturbation kernel draws them.
extern "C" int philox_bits(const void* key, void* out, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t err = grid_for(n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  philox_bits_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
