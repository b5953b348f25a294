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
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }

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

// Opt a kernel into more than 48 KB of shared memory when it needs it.  The
// default 48 KB holds static and dynamic shared memory together; the
// kernels here keep under 1 KB static, hence the margin.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes + 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// Asynchronous global -> shared copies (cp.async, sm_80+).  `src_bytes` below
// the copy size zero-fills the rest (0: the whole chunk is zeros, and the
// source is not read), which is how ragged tiles are padded.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Split K in one launch: every CTA of an output tile stores its partial
// sums (MT 16-byte vectors a thread) in its own workspace slot; the last CTA
// to arrive adds all slots in split order 0, 1, ... (a fixed order, so float
// sums are deterministic too) and re-arms the tile's counter to 0 for the
// next call.  `counter` (one int per tile) is zero before the first call:
// the wrappers allocate it zeroed once and cache it.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool split_k_last_arrival(int* counter, int splits) {
  __shared__ int last;
  __threadfence();  // this thread's partials are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == splits - 1;
    if (last) *counter = 0;  // re-arm: every other CTA of the tile has arrived
  }
  __syncthreads();
  if (last) __threadfence();  // order the partials' reads after the count
  return last;
}

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

// acc[mt][0..3] for mt < n_mt are this thread's partials.  ws holds
// (tiles, splits, MT, blockDim.x) 16-byte vectors; tile = (blockIdx.y,
// blockIdx.x), split = blockIdx.z.  Every thread of the CTA must call it.
// Returns true in the last CTA, with the total in acc.
template <int MT, typename T>
__device__ __forceinline__ bool split_k_reduce(T (&acc)[MT][4], int n_mt, T* ws, int* counter) {
  using V = typename Vec4<T>::type;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x, splits = gridDim.z;
  const int nt = blockDim.x, tid = threadIdx.x;
  V* tws = reinterpret_cast<V*>(ws) + (size_t)tile * splits * MT * nt;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    if (mt < n_mt)
      tws[((size_t)blockIdx.z * MT + mt) * nt + tid] =
          V{acc[mt][0], acc[mt][1], acc[mt][2], acc[mt][3]};
  if (!split_k_last_arrival(counter + tile, splits)) return false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[mt][q] = 0;
#pragma unroll 2
  for (int z = 0; z < splits; ++z) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt < n_mt) {
        const V p = __ldcg(tws + ((size_t)z * MT + mt) * nt + tid);
        acc[mt][0] += p.x; acc[mt][1] += p.y; acc[mt][2] += p.z; acc[mt][3] += p.w;
      }
    }
  }
  return true;
}

}  // namespace repro
