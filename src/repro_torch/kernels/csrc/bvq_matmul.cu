// BVQ matmul: y = x @ W with W[row*v + t, j*bc + col] = cb[j, idx[j, row, col], t].
//
// Replaces: repro/kernels/bvq_matmul.py:bvq_matmul_pallas (body _bvq_kernel).
//
// Bound on this card: on the serving path M is the draft's token count (8
// for a chain step, 72 for a tree step), so a call reads the int32 index
// tensor (4*K*N/v bytes, the dominant stream), the small codebooks and x,
// and does 2*M*K*N flops: bound by device-memory bytes.
//
// Design:
//  * Grid: 64 output channels per CTA (4 warps, 16 channels each) for up to
//    128 tokens, times a split of K chosen by the wrapper so that every
//    draft shape launches at least one CTA per SM; M above 128 takes more
//    passes (grid.y).  Above 4 token tiles of 8, MT/4 groups of 4 warps
//    share the channels, each group on 4 tiles.
//  * The CTA's codebooks (at most 4 blocks) sit in shared memory, rounded to
//    x's dtype once at the start, as the reference's w.astype(x.dtype)
//    rounds W.  W is never rebuilt in memory: a lane builds its MMA operand
//    in registers from two indices and two codebook reads.
//  * bf16 x: mma.sync m16n8k16 bf16 -> f32 with A and B swapped (channels on
//    the 16-row side, tokens on the 8-wide side).  K is permuted inside each
//    16-chunk identically for both operands, so lane (g, t) takes K values
//    4t..4t+3: four consecutive K of one channel, which is one index's
//    codebook entry (v = 4) or half of one (v = 8), and four consecutive x
//    values of one token.
//  * f32 x stays on FFMA (TF32 would lose the 1e-4 agreement): the same
//    lanes own the same outputs and sum over the 16-chunk in f32.
//  * Index and x tiles of 32 K stream through an 8-stage ring of shared
//    memory with cp.async (zero-filled past K and M, up to the last token
//    tile).
//  * K partials of the splits meet in a cached f32 workspace; the last CTA
//    of a tile to arrive (an atomic counter it re-arms) adds them in split
//    order 0, 1, ... with 16-byte loads: the same sums in the same order on
//    every call, so the result is deterministic.  One launch per call.
#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async8;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::split_k_reduce;

constexpr int kWarps = 4;            // channel warps (16 channels each)
constexpr int kKStage = 32;          // K values per stage
constexpr int kStages = 8;
constexpr int kIdxStageBytes = kWarps * 8 * 16 * 4;  // 4 warps x <= 8 rows x 16 ints
constexpr int kMaxTokens = 128;
constexpr int kMaxBlocks = 4;        // codebook blocks one CTA's 64 channels touch

// Token groups, as in w4a8_matmul.cu: above 4 token tiles, MT/4 groups of 4
// warps share the CTA's channels, each on 4 of the tiles.
__host__ __device__ constexpr int groups_for(int mt) { return mt >= 8 ? mt / 4 : 1; }

template <typename T> __host__ __device__ constexpr int x_stage_bytes(int mt) {
  return mt * 8 * kKStage * static_cast<int>(sizeof(T));
}
template <typename T> __host__ __device__ constexpr int stage_bytes(int mt) {
  return kIdxStageBytes + x_stage_bytes<T>(mt);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x (M, K) T; cb (nb, C, v) f32; idx (nb, K/v, bc) int32; out (M, N) f32.
// Stages [z*sps, min(nst, (z+1)*sps)) of 32 K; ws (split_k_reduce's layout)
// and cnt (passes x gridDim.x) when gridDim.z > 1.
template <typename T, int MT, bool kX16>
__global__ void __launch_bounds__(128 * groups_for(MT))
bvq_mma_kernel(const T* __restrict__ x, const float* __restrict__ cb,
               const int* __restrict__ idx, float* __restrict__ out, float* __restrict__ ws,
               int* __restrict__ cnt, int M, int K, int N, int C, int v, int bc, int sps) {
  constexpr int kXRows = MT * 8;
  constexpr int kXChunks = kKStage * sizeof(T) / 16;  // 16-byte chunks per x row
  constexpr int kThreads = 128 * groups_for(MT);
  constexpr int MTW = MT / groups_for(MT);  // token tiles per warp
  extern __shared__ __align__(16) uint8_t smem[];
  T* cb_s = reinterpret_cast<T*>(smem + kStages * stage_bytes<T>(MT));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n16 = N >> 4, rows = K / v, rps = kKStage / v;  // idx rows per stage
  const int cw = warp & (kWarps - 1), mt0 = (warp / kWarps) * MTW;  // channel warp, first tile
  const int c16 = blockIdx.x * kWarps + cw;
  const bool warp_live = c16 < n16;
  const int j0 = blockIdx.x * kWarps * 16 / bc;
  const int j = c16 * 16 / bc;
  const T* cbw = cb_s + (size_t)(j - j0) * C * v;  // this warp's codebook
  const int m0 = blockIdx.y * kMaxTokens;
  const int rows8 = (min(kXRows, M - m0) + 7) & ~7;  // x rows up to the last token tile
  const int n_my = min(MTW, max(0, (rows8 >> 3) - mt0));
  const int nst = (K + kKStage - 1) / kKStage;
  const int st0 = blockIdx.z * sps, st1 = min(nst, st0 + sps);

  auto load_stage = [&](int st, int slot) {
    uint8_t* base = smem + slot * stage_bytes<T>(MT);
    const int r0 = st * rps;
    if (tid < kWarps * rps * 4) {  // idx: (warp, row, 4 chunks of 4 ints)
      const int w = tid / (rps * 4), r = (tid >> 2) % rps, q = tid & 3;
      const int c = blockIdx.x * kWarps + w;
      const int jj = c * 16 / bc, cc = c * 16 % bc;
      const bool ok = c < n16 && r0 + r < rows;
      const int* src = ok ? idx + ((size_t)jj * rows + r0 + r) * bc + cc + 4 * q : idx;
      cp_async16(base + ((w * 8 + r) * 16 + 4 * q) * 4, src, ok ? 16 : 0);
    }
    uint8_t* xs = base + kIdxStageBytes;
    for (int e = tid; e < rows8 * kXChunks; e += kThreads) {
      const int r = e / kXChunks, c = e % kXChunks;
      const int m = m0 + r;
      const int k = st * kKStage + c * (16 / (int)sizeof(T));
      uint8_t* dst = xs + r * kKStage * sizeof(T) + ((c ^ (r & 2)) << 4);
      const T* src = x + (size_t)(m < M ? m : 0) * K;
      if (kX16) {
        const bool ok = m < M && k < K;
        cp_async16(dst, ok ? src + k : x, ok ? 16 : 0);
      } else {  // bf16 rows only 8-byte aligned (K % 8 == 4): two 8-byte copies
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kh = k + h * (8 / (int)sizeof(T));
          const bool ok = m < M && kh < K;
          cp_async8(dst + 8 * h, ok ? src + kh : x, ok ? 8 : 0);
        }
      }
    }
  };

  float acc[MTW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (st0 + s < st1) load_stage(st0 + s, s);
    cp_async_commit();
  }
  {  // the CTA's codebooks, rounded to T, while the first stages are in flight
    const int nblk = min(kMaxBlocks, (N - 1) / bc - j0 + 1);
    for (int e = tid; e < nblk * C * v; e += kThreads)
      cb_s[e] = repro::from_float<T>(cb[(size_t)j0 * C * v + e]);
  }

  for (int st = st0; st < st1; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st (and the codebooks) landed; slot of st-1 is free
    {
      const int nxt = st + kStages - 1;
      if (nxt < st1) load_stage(nxt, (nxt - st0) % kStages);
      cp_async_commit();
    }
    if (!warp_live || n_my == 0) continue;
    const uint8_t* base = smem + ((st - st0) % kStages) * stage_bytes<T>(MT);
    const int* is = reinterpret_cast<const int*>(base) + cw * 8 * 16;
    const uint8_t* xs = base + kIdxStageBytes;
#pragma unroll
    for (int u = 0; u < kKStage / 16; ++u) {
      if constexpr (sizeof(T) == 2) {
        // lane (g, t): K values u*16 + 4t .. +3 of channels g and g+8
        const int kl = u * 16 + 4 * t;
        const int r = kl / v, off = kl % v;
        const uint2 wl = *reinterpret_cast<const uint2*>(cbw + is[r * 16 + g] * v + off);
        const uint2 wh = *reinterpret_cast<const uint2*>(cbw + is[r * 16 + g + 8] * v + off);
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          if (mt < n_my) {
            const int row = (mt0 + mt) * 8 + g;
            const int c = (2 * u + (t >> 1)) ^ (row & 2);
            const uint2 xv = *reinterpret_cast<const uint2*>(
                xs + row * kKStage * 2 + c * 16 + (t & 1) * 8);
            mma_bf16(acc[mt], wl.x, wh.x, wl.y, wh.y, xv.x, xv.y);
          }
        }
      } else {
        // lane (g, t) owns channels g, g+8 x tokens 2t, 2t+1 of each tile
        float wv[2][16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kl = u * 16 + 4 * q;
          const int r = kl / v, off = kl % v;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 f = *reinterpret_cast<const float4*>(
                cbw + is[r * 16 + g + 8 * h] * v + off);
            wv[h][4 * q] = f.x; wv[h][4 * q + 1] = f.y;
            wv[h][4 * q + 2] = f.z; wv[h][4 * q + 3] = f.w;
          }
        }
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          if (mt < n_my) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int row = (mt0 + mt) * 8 + 2 * t + i;
              const float* xr = reinterpret_cast<const float*>(xs + row * kKStage * 4);
              float s0 = acc[mt][i], s1 = acc[mt][2 + i];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float4 xv = *reinterpret_cast<const float4*>(
                    xr + (((4 * u + q) ^ (row & 2)) << 2));
                s0 = fmaf(xv.x, wv[0][4 * q], s0); s0 = fmaf(xv.y, wv[0][4 * q + 1], s0);
                s0 = fmaf(xv.z, wv[0][4 * q + 2], s0); s0 = fmaf(xv.w, wv[0][4 * q + 3], s0);
                s1 = fmaf(xv.x, wv[1][4 * q], s1); s1 = fmaf(xv.y, wv[1][4 * q + 1], s1);
                s1 = fmaf(xv.z, wv[1][4 * q + 2], s1); s1 = fmaf(xv.w, wv[1][4 * q + 3], s1);
              }
              acc[mt][i] = s0;
              acc[mt][2 + i] = s1;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (gridDim.z > 1 && !split_k_reduce<MTW>(acc, n_my, ws, cnt)) return;
  // acc[mt][0..1]: channel n, tokens m, m+1; acc[mt][2..3]: channel n+8
  const int n = c16 * 16 + g;
  if (!warp_live) return;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + (mt0 + mt) * 8 + 2 * t + (q & 1);
      if (mt < n_my && m < M) out[(size_t)m * N + n + (q >> 1) * 8] = acc[mt][q];
    }
}

template <typename T, int MT>
int launch(const void* xv, const float* cb, const int* idx, float* out, float* ws, int* cnt,
           int M, int K, int N, int C, int v, int bc, int ksplit, int sps, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const bool x16 = (K * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t smem = (size_t)kStages * stage_bytes<T>(MT) + (size_t)kMaxBlocks * C * v * sizeof(T);
  auto kernel = x16 ? bvq_mma_kernel<T, MT, true> : bvq_mma_kernel<T, MT, false>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N / 16 + kWarps - 1) / kWarps, (M + kMaxTokens - 1) / kMaxTokens, ksplit);
  kernel<<<grid, 128 * groups_for(MT), smem, st>>>(x, cb, idx, out, ws, cnt, M, K, N, C, v, bc,
                                                 sps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mt(int mt, const void* x, const float* cb, const int* idx, float* out, float* ws,
              int* cnt, int M, int K, int N, int C, int v, int bc, int ksplit, int sps,
              cudaStream_t st) {
  switch (mt) {
    case 1: return launch<T, 1>(x, cb, idx, out, ws, cnt, M, K, N, C, v, bc, ksplit, sps, st);
    case 2: return launch<T, 2>(x, cb, idx, out, ws, cnt, M, K, N, C, v, bc, ksplit, sps, st);
    case 4: return launch<T, 4>(x, cb, idx, out, ws, cnt, M, K, N, C, v, bc, ksplit, sps, st);
    case 8: return launch<T, 8>(x, cb, idx, out, ws, cnt, M, K, N, C, v, bc, ksplit, sps, st);
    case 16: return launch<T, 16>(x, cb, idx, out, ws, cnt, M, K, N, C, v, bc, ksplit, sps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (M, K) of dtype `dtype`, K % 4 == 0; cb (nb, C, v) f32 dequantized
// codebooks, v in {4, 8, 16, 32}; idx (nb, K/v, bc) int32, bc % 16 == 0;
// out (M, nb*bc) f32.  mt in {1, 2, 4, 8, 16} token tiles of 8 per pass;
// K split `ksplit` ways of `sps` 32-K stages; ksplit > 1 needs ws (passes *
// 64-channel tiles * ksplit * mt * 128 * 4 f32) and cnt (a zeroed int32
// counter per (pass, 64-channel tile)).
extern "C" int repro_bvq_matmul(const void* x, const float* cb, const int* idx, float* out,
                                float* ws, int* cnt, int M, int K, int nb, int C, int v, int bc,
                                int dtype, int mt, int ksplit, int sps, void* stream) {
  cudaStream_t st = repro::as_stream(stream);
  if (bc % 16 || kKStage % v || v % 4 || K % v || (ksplit > 1 && !(ws && cnt)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int N = nb * bc;
  if (dtype == repro::kF32)
    return launch_mt<float>(mt, x, cb, idx, out, ws, cnt, M, K, N, C, v, bc, ksplit, sps, st);
  if (dtype == repro::kBF16)
    return launch_mt<__nv_bfloat16>(mt, x, cb, idx, out, ws, cnt, M, K, N, C, v, bc, ksplit,
                                    sps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
