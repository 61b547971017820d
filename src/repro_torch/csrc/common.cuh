// Helpers shared by the attention kernels: element conversion, 16-byte
// vector loads into float registers, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// The Pallas kernels' finite -inf: a fully masked row then gives
// exp(NEG_INF - NEG_INF) = 1 masked to 0 instead of NaN.
constexpr float kNegInf = -1e30f;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Elements of T in one 16-byte load.
template <typename T>
__host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

// Reads vec_width<T>() contiguous elements at a 16-byte aligned address.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < vec_width<T>(); ++i) dst[i] = to_float(v[i]);
}

// Reductions over the `width` lanes of an aligned lane group.
template <int width = 32>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int width = 32>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Opts a kernel into more than 48 KB of dynamic shared memory when it
// needs it; returns the error of that call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro_torch
