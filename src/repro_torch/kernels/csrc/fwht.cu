// LRU block rotation: y = x @ kron(I_{n/B}, H_B / sqrt(B)), B = m * 2^k.
//
// Replaces: repro/kernels/fwht.py:block_rotate_pallas (bodies
// _rotate_kernel and _fwht_in_kernel).
//
// Bound on this card: each call reads and writes the (tokens, n) activation
// once and does (k + m) adds/multiplies per element: a few operations per
// byte, so it is bound by device-memory bytes (and, at serving sizes of a
// few dozen tokens, by launch latency).
//
// Design: a TPU grid step held a (tokens, B) tile in VMEM.  Here one block
// owns one B-wide channel segment of a few token rows and keeps it in
// shared memory as float: the k radix-2 butterfly stages run in place
// (pairs (i, i+h) inside contiguous groups of 2^k, Sylvester order, one
// __syncthreads per stage), then each thread produces outputs of the m x m
// +-1 product out[b*2^k + r] = sum_a y[a*2^k + r] * H[a][b] (H transposed
// on request) and applies 1/sqrt(B) at the store.  H_m arrives as an input
// tensor in x's dtype, as in the reference, so any Hadamard order m (not
// only powers of two) works.  Arithmetic is float32 throughout; bf16 inputs
// round once at the store.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_rotate_kernel(const T* __restrict__ x, const T* __restrict__ hm, T* __restrict__ out,
                    int tokens, int n, int m, int k, int transpose, int tile, float scale) {
  extern __shared__ float smem[];
  const int size = 1 << k;
  const int B = m * size;
  float* ys = smem;              // [tile][B]
  float* hs = smem + tile * B;   // [m][m], hs[a*m + b] = H[a][b] (or H[b][a])
  const int seg = blockIdx.x;
  const int t0 = blockIdx.y * tile;
  const int nt = min(tile, tokens - t0);

  for (int e = threadIdx.x; e < nt * B; e += blockDim.x) {
    const int t = e / B, i = e % B;
    ys[e] = repro::to_float(x[(size_t)(t0 + t) * n + (size_t)seg * B + i]);
  }
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
    const int a = e / m, b = e % m;
    hs[e] = repro::to_float(transpose ? hm[b * m + a] : hm[e]);
  }
  __syncthreads();

  const int half = B / 2;
  for (int h = 1; h < size; h <<= 1) {
    for (int e = threadIdx.x; e < nt * half; e += blockDim.x) {
      const int t = e / half, p = e % half;
      const int i = (p / h) * 2 * h + (p % h);
      float* y = ys + t * B;
      const float u = y[i], v = y[i + h];
      y[i] = u + v;
      y[i + h] = u - v;
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nt * B; e += blockDim.x) {
    const int t = e / B, j = e % B;
    const int b = j / size, r = j % size;
    const float* y = ys + t * B + r;
    float s = 0.f;
    for (int a = 0; a < m; ++a) s += y[a * size] * hs[a * m + b];
    out[(size_t)(t0 + t) * n + (size_t)seg * B + j] = repro::from_float<T>(s * scale);
  }
}

template <typename T>
int launch(const void* x, const void* hm, void* out, int tokens, int n, int m, int k,
           int transpose, cudaStream_t st) {
  const int B = m << k;
  int tile = 4096 / B;
  tile = tile < 1 ? 1 : (tile > 16 ? 16 : tile);
  const size_t smem = ((size_t)tile * B + (size_t)m * m) * sizeof(float);
  cudaError_t err = repro::allow_smem(block_rotate_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n / B, (tokens + tile - 1) / tile);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(B)));
  block_rotate_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(hm), static_cast<T*>(out), tokens, n,
      m, k, transpose, tile, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (tokens, n), hm (m, m) and out (tokens, n), all of dtype `dtype`
// (repro::kF32 / kBF16); n % (m << k) == 0.
extern "C" int repro_block_rotate(const void* x, const void* hm, void* out, int tokens, int n,
                                  int m, int k, int transpose, int dtype, void* stream) {
  cudaStream_t st = repro::as_stream(stream);
  if (dtype == repro::kF32) return launch<float>(x, hm, out, tokens, n, m, k, transpose, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, hm, out, tokens, n, m, k, transpose, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
