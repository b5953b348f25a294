// W4A8 GEMM: y = (xq @ unpack_int4(wp)) * sx * sw, int32 accumulation.
//
// Replaces: repro/kernels/w4a8_matmul.py:w4a8_matmul_pallas (body
// _w4a8_kernel, nibble unpack _unpack_nibbles).
//
// Bound on this card: on the serving path M is the number of tokens in the
// step (<= 32 for decode/verify), so each call streams the packed int4
// weight (K*N/2 bytes) once and does 2*M*K*N integer operations: far below
// the ~590 int8 ops/byte ridge of an H100, i.e. bound by device-memory bytes.
//
// Design: a weight-streaming GEMV/GEMM on __dp4a.  Each thread owns four
// adjacent output columns and reads one 32-bit word (4 packed bytes, one
// per column) from each of two consecutive packed rows, so a warp reads
// 128 contiguous bytes per row (coalesced along N, the packed layout's
// contiguous axis).  The two bytes of a column hold k = 4j..4j+3 and are
// sign-extended exactly like _unpack_nibbles ((p << 28) >> 28 low, p >> 4
// high) into one int8x4 word for __dp4a against four activations.  Each
// block covers kRows token rows, so a weight word feeds kRows dot
// products.  The loop is bound by the latency of its weight loads, so the
// wrapper splits K over gridDim.z until enough blocks are resident per SM
// (and the loop is unrolled to keep several loads in flight); partial
// sums then meet in an int32 workspace by integer atomics (exact and
// order-independent) and a second small kernel applies the scales.  The epilogue multiplies (float(acc) * sx) * sw in that order,
// as the reference does, so results equal the plain version bit for bit.
// No tensor cores yet (mma.sync s8 / wgmma is later work).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;            // threads per block
constexpr int kRows = 8;                 // token rows per block
constexpr int kCols = 4 * kThreads;      // output columns per block

// Sign-extended byte c of a little-endian 32-bit word.
__device__ __forceinline__ int byte_at(uint32_t word, int c) {
  return static_cast<int>(word << (24 - 8 * c)) >> 24;
}

// Low nibble of a sign-extended packed byte, sign-extended: (p << 28) >> 28
// (shifted as unsigned so the left shift is defined for negative p).
__device__ __forceinline__ int nib_lo(int p) {
  return static_cast<int>(static_cast<uint32_t>(p) << 28) >> 28;
}

// int8x4 of k = 4j..4j+3 for one column from its packed bytes in rows 2j, 2j+1
// (high nibble: p >> 4, an arithmetic shift).
__device__ __forceinline__ int unpack4(int p0, int p1) {
  const uint32_t lo0 = nib_lo(p0) & 0xFF, hi0 = (p0 >> 4) & 0xFF;
  const uint32_t lo1 = nib_lo(p1) & 0xFF, hi1 = (p1 >> 4) & 0xFF;
  return static_cast<int>(lo0 | (hi0 << 8) | (lo1 << 16) | (hi1 << 24));
}

__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wp,
            const float* __restrict__ sx, const float* __restrict__ sw,
            float* __restrict__ out, int* __restrict__ ws,
            int M, int K, int N, int kq_per_split) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * 4;
  const int m0 = blockIdx.y * kRows;
  const int nrows = min(kRows, M - m0);
  const int kq_total = K / 4;
  const int kq0 = blockIdx.z * kq_per_split;
  const int kq1 = min(kq_total, kq0 + kq_per_split);
  if (col >= N) return;

  int acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  const int* x32 = reinterpret_cast<const int*>(xq);
#pragma unroll 4
  for (int j = kq0; j < kq1; ++j) {
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp + (size_t)(2 * j) * N + col);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wp + (size_t)(2 * j + 1) * N + col);
    int wv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) wv[c] = unpack4(byte_at(w0, c), byte_at(w1, c));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        const int xv = x32[(size_t)(m0 + r) * kq_total + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(xv, wv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nrows) break;
    const size_t row = (size_t)(m0 + r) * N + col;
    if (ws == nullptr) {
      const float s = sx[m0 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) out[row + c] = (static_cast<float>(acc[r][c]) * s) * sw[col + c];
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) atomicAdd(ws + row + c, acc[r][c]);
    }
  }
}

__global__ void w4a8_epilogue(const int* __restrict__ ws, const float* __restrict__ sx,
                              const float* __restrict__ sw, float* __restrict__ out,
                              int M, int N) {
  const size_t total = (size_t)M * N;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int m = static_cast<int>(e / N), n = static_cast<int>(e % N);
    out[e] = (static_cast<float>(ws[e]) * sx[m]) * sw[n];
  }
}

}  // namespace

// xq (M, K) int8; wp (K/2, N) int8 nibble-packed along K; sx (M, 1) f32;
// sw (1, N) f32; out (M, N) f32.  K % 4 == 0, N % 4 == 0, pointers 4-byte
// aligned.  ws is a zeroed (M, N) int32 workspace when ksplit > 1, else null.
extern "C" int repro_w4a8_matmul(const int8_t* xq, const int8_t* wp, const float* sx,
                                 const float* sw, float* out, int* ws, int M, int K,
                                 int N, int ksplit, void* stream) {
  cudaStream_t st = repro::as_stream(stream);
  const int kq_total = K / 4;
  const int kq_per_split = (kq_total + ksplit - 1) / ksplit;
  dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows, ksplit);
  w4a8_kernel<<<grid, kThreads, 0, st>>>(xq, wp, sx, sw, out, ksplit > 1 ? ws : nullptr,
                                         M, K, N, kq_per_split);
  if (ksplit > 1) {
    const size_t total = (size_t)M * N;
    const size_t want = (total + 255) / 256;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    w4a8_epilogue<<<blocks, 256, 0, st>>>(ws, sx, sw, out, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_w4a8_cols_per_block() { return kCols; }
extern "C" int repro_w4a8_rows_per_block() { return kRows; }
