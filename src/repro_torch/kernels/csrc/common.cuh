// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exports plain C entry points (extern "C") that take raw
// device pointers, sizes and a cudaStream_t passed as void*, launch on that
// stream, and return cudaGetLastError() so the Python wrapper can raise on a
// refused launch.  Nothing here allocates or synchronises: outputs and
// scratch come from torch.empty/torch.zeros in the wrappers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace repro {

// dtype codes shared with kernels/_lib.py
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Round a float to T and back: the value a T-typed operand would carry.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
