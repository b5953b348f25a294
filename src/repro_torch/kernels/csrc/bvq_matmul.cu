// BVQ matmul: y = x @ W with W[row*v + t, j*bc + col] = cb[j, idx[j, row, col], t].
//
// Replaces: repro/kernels/bvq_matmul.py:bvq_matmul_pallas (body _bvq_kernel).
//
// Bound on this card: on the serving path M <= 32 token rows, so a call
// reads the int32 index tensor (4*K*N/v bytes, the dominant stream), the
// small codebooks and x, and does 2*M*K*N flops: bound by device-memory
// bytes.
//
// Design: one block per (bc-column block, tile of up to 32 token rows),
// which is the reference's grid step.  The block loads its codebook (C*v
// floats) into shared memory once, then walks K in chunks: it rebuilds the
// chunk's (Kc x bc) weight tile from the indices in shared memory, rounded
// to x's dtype as _bvq_kernel's w.astype(x.dtype) does, stages the token
// rows' matching slice of x, and every thread accumulates its (row, column)
// outputs in float32.  The rebuilt tile serves every token row of the tile,
// which is the point of the reference kernel (the tile-fusion reuse).
// Warp lanes own consecutive columns, so tile reads are conflict-free and
// x reads are broadcasts.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 4096;   // max outputs per block and floats per staged tile
constexpr int kMaxOut = kTileElems / kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bvq_kernel(const T* __restrict__ x, const float* __restrict__ cb, const int* __restrict__ idx,
           float* __restrict__ out, int M, int K, int N, int C, int v, int bc, int mt, int kc) {
  extern __shared__ float smem[];
  float* cb_s = smem;               // [C][v]
  float* w_s = cb_s + C * v;        // [kc][bc]
  float* x_s = w_s + kc * bc;       // [mt][kc]
  const int j = blockIdx.x;
  const int m0 = blockIdx.y * mt;
  const int nm = min(mt, M - m0);
  const int rows = K / v;
  const int n_out = nm * bc;

  for (int e = threadIdx.x; e < C * v; e += blockDim.x) cb_s[e] = cb[(size_t)j * C * v + e];

  float acc[kMaxOut];
#pragma unroll
  for (int q = 0; q < kMaxOut; ++q) acc[q] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kn = min(kc, K - k0);
    __syncthreads();  // previous chunk consumed (and codebook loaded)
    for (int e = threadIdx.x; e < kn * bc; e += blockDim.x) {
      const int kk = e / bc, col = e % bc;
      const int kg = k0 + kk;
      const int id = idx[((size_t)j * rows + kg / v) * bc + col];
      w_s[e] = repro::round_to<T>(cb_s[id * v + kg % v]);
    }
    for (int e = threadIdx.x; e < nm * kn; e += blockDim.x) {
      const int mm = e / kn, kk = e % kn;
      x_s[mm * kc + kk] = repro::to_float(x[(size_t)(m0 + mm) * K + k0 + kk]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kMaxOut; ++q) {
      const int o = threadIdx.x + q * kThreads;
      if (o < n_out) {
        const int mm = o / bc, col = o % bc;
        const float* xr = x_s + mm * kc;
        float s = acc[q];
        for (int kk = 0; kk < kn; ++kk) s += xr[kk] * w_s[kk * bc + col];
        acc[q] = s;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kMaxOut; ++q) {
    const int o = threadIdx.x + q * kThreads;
    if (o < n_out) {
      const int mm = o / bc, col = o % bc;
      out[(size_t)(m0 + mm) * N + (size_t)j * bc + col] = acc[q];
    }
  }
}

template <typename T>
int launch(const void* x, const float* cb, const int* idx, float* out, int M, int K, int nb,
           int C, int v, int bc, cudaStream_t st) {
  if (bc > kTileElems) return static_cast<int>(cudaErrorInvalidValue);
  const int mt = kTileElems / bc < 32 ? kTileElems / bc : 32;
  int kc = (kTileElems / bc) / v * v;
  kc = kc < v ? v : kc;
  const size_t smem = ((size_t)C * v + (size_t)kc * bc + (size_t)mt * kc) * sizeof(float);
  cudaError_t err = repro::allow_smem(bvq_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(nb, (M + mt - 1) / mt);
  bvq_kernel<T><<<grid, kThreads, smem, st>>>(static_cast<const T*>(x), cb, idx, out, M, K,
                                               nb * bc, C, v, bc, mt, kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) of dtype `dtype`; cb (nb, C, v) f32 dequantized codebooks;
// idx (nb, K/v, bc) int32; out (M, nb*bc) f32.
extern "C" int repro_bvq_matmul(const void* x, const float* cb, const int* idx, float* out,
                                int M, int K, int nb, int C, int v, int bc, int dtype,
                                void* stream) {
  cudaStream_t st = repro::as_stream(stream);
  if (dtype == repro::kF32) return launch<float>(x, cb, idx, out, M, K, nb, C, v, bc, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, cb, idx, out, M, K, nb, C, v, bc, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
