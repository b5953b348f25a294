// W4A8 GEMM: y = (xq @ unpack_int4(wp)) * sx * sw, int32 accumulation.
//
// Replaces: repro/kernels/w4a8_matmul.py:w4a8_matmul_pallas (body
// _w4a8_kernel, nibble unpack _unpack_nibbles).
//
// Bound on this card: on the serving path M is the number of tokens in the
// step (<= 128 for decode, verify and a prefill chunk), so a call does
// 2*M*K*N integer operations on K*N/2 bytes of packed weight: at most ~1
// op/byte at M = 128, far below the ~590 int8 ops/byte ridge of an H100.
// The weight bytes bound it; the design streams them once per call.
//
// Design:
//  * Tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, with A and B swapped:
//    output channels take the MMA's 16-row side and tokens its 8-wide side,
//    so M = 32 is four token tiles and M = 72 nine, with no padding to 16.
//  * Weight layout: the wrapper reorders the packed weight once, at load
//    time (kernels/w4a8_matmul.py:prepack, the same K*N/2 bytes), so that one
//    16-byte load gives a lane its whole A operand for 64 values of K: for
//    16 channels c..c+15 and K chunk k..k+63, lane (g, t) holds bytes
//    q = 0..15 = (W[k+16t+q, c+g+8] << 4) | (W[k+16t+q, c+g] & 0xF).  K is
//    permuted inside each 64-chunk identically for A and B (a dot product
//    does not care), so the lane's B operand is the 16 contiguous
//    activation bytes xq[m, k+16t .. k+16t+15]: one 16-byte shared load.
//  * Each CTA (4 warps, 16 channels each) owns 64 channels for up to 128
//    tokens and walks K, so each weight byte is read once per call for any
//    M <= 128 (grid.y = ceil(M/128) passes above that).  Token tiles are a
//    register loop (MT, a template: 1..16 tiles of 8); above 4 tiles the CTA
//    has a second (and fourth) group of 4 warps on the other tiles.
//  * Weight and activation tiles of 128 K stream through a ring of 4-6
//    shared-memory stages with cp.async (16 B per copy; zero-filled past K
//    and M, up to the last token tile), so several stages of weight bytes
//    are in flight per CTA.
//  * Split K (at most 4 ways) where the channel tiles alone give fewer than
//    about 3 CTAs per SM (the wrapper's plan).  Splits store int32 partials
//    in a cached workspace; the last CTA of a tile to arrive (an atomic
//    counter, re-armed by that CTA) sums them with 16-byte loads, all of a
//    split in flight at once, and applies the epilogue, so a call is one
//    launch.  Int32 sums are exact: deterministic.
//  * The epilogue multiplies (float(acc) * sx) * sw in that order, as the
//    reference does, so results equal the plain version bit for bit.
#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::split_k_reduce;

constexpr int kWarps = 4;                              // channel warps (16 channels each)
constexpr int kKStage = 128;                           // K values per stage
constexpr int kWStageBytes = kWarps * 2 * 512;         // 4 c16 tiles x 2 k64 chunks
constexpr int kMaxTokens = 128;                        // tokens per pass

// Token groups: above 4 token tiles the CTA has MT/4 groups of 4 warps, each
// group on 4 of the tiles, so no warp carries more than 4 (more warps per SM
// to hide latency, the same accumulators per thread).
__host__ __device__ constexpr int groups_for(int mt) { return mt >= 8 ? mt / 4 : 1; }

// Ring depth per token-tile count.
__host__ __device__ constexpr int stages_for(int mt) { return mt >= 16 ? 4 : (mt >= 8 ? 5 : 6); }

__host__ __device__ constexpr int stage_bytes(int mt) { return kWStageBytes + mt * 8 * kKStage; }

// Four sign-extended int4 values (one per byte's low nibble) as int8x4.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t u) {
  u &= 0x0F0F0F0Fu;
  return u | ((u & 0x08080808u) * 0x1Eu);  // bit 3 of each byte -> bits 4..7
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// xq (M, K) int8; wpp (n16, nk64, 512) int8, prepacked; sx (M) f32; sw (N)
// f32; out (M, N) f32.  ws (split_k_reduce's layout) and cnt (passes x
// gridDim.x) when gridDim.z > 1.  Stages [z*sps, min(nst, (z+1)*sps)).
template <int MT, bool kX16>
__global__ void __launch_bounds__(128 * groups_for(MT), MT >= 16 ? 2 : 1)
w4a8_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wpp,
                const float* __restrict__ sx, const float* __restrict__ sw,
                float* __restrict__ out, int* __restrict__ ws, int* __restrict__ cnt,
                int M, int K, int N, int n16, int nk64, int sps) {
  constexpr int kStages = stages_for(MT);
  constexpr int kXRows = MT * 8;
  constexpr int kThreads = 128 * groups_for(MT);
  constexpr int MTW = MT / groups_for(MT);  // token tiles per warp
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp & (kWarps - 1), mt0 = (warp / kWarps) * MTW;  // channel warp, first tile
  const int c16 = blockIdx.x * kWarps + cw;  // this warp's 16-channel tile
  const bool warp_live = c16 < n16;
  const int m0 = blockIdx.y * kMaxTokens;
  const int rows = min(kXRows, M - m0);
  const int rows8 = (rows + 7) & ~7;
  const int n_my = min(MTW, max(0, (rows8 >> 3) - mt0));  // this warp's live tiles
  const int nst = nk64 >> 1;
  const int st0 = blockIdx.z * sps;
  const int st1 = min(nst, st0 + sps);
  const int np = n16 * 16;

  auto load_stage = [&](int st, int slot) {
    uint8_t* base = smem + slot * stage_bytes(MT);
    // weight: 4 warps x 2 k64 chunks x 32 lanes of 16 B
    for (int e = tid; e < kWStageBytes / 16; e += kThreads) {
      const int w = e >> 6, kk = (e >> 5) & 1, l = e & 31;
      const int c = blockIdx.x * kWarps + w;
      const bool ok = c < n16;
      const int8_t* src = wpp + ((size_t)(ok ? c : 0) * nk64 + st * 2 + kk) * 512 + l * 16;
      cp_async16(base + e * 16, src, ok ? 16 : 0);
    }
    // activations: kXRows rows x 8 chunks of 16 B; chunk c of row r lands at
    // c ^ ((r & 1) << 2), so the two rows a quarter-warp reads sit on
    // different bank halves
    uint8_t* xs = base + kWStageBytes;
    for (int e = tid; e < rows8 * 8; e += kThreads) {  // rows past the last tile: unread
      const int r = e >> 3, c = e & 7;
      const int k = st * kKStage + c * 16;
      const int m = m0 + r;
      uint8_t* dst = xs + r * kKStage + ((c ^ ((r & 1) << 2)) << 4);
      const int8_t* src = xq + (size_t)(m < M ? m : 0) * K;
      if (kX16) {
        const bool ok = m < M && k < K;
        cp_async16(dst, ok ? src + k : xq, ok ? 16 : 0);
      } else {  // rows only 4-byte aligned (K % 16 != 0): four 4-byte copies
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = m < M && k + 4 * q < K;
          cp_async4(dst + 4 * q, ok ? src + k + 4 * q : xq, ok ? 4 : 0);
        }
      }
    }
  };

  int acc[MTW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (st0 + s < st1) load_stage(st0 + s, s);
    cp_async_commit();
  }

  for (int st = st0; st < st1; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed for every thread; slot of st-1 is free
    {
      const int nxt = st + kStages - 1;
      if (nxt < st1) load_stage(nxt, (nxt - st0) % kStages);
      cp_async_commit();
    }
    if (!warp_live || n_my == 0) continue;
    const uint8_t* base = smem + ((st - st0) % kStages) * stage_bytes(MT);
    const uint8_t* xs = base + kWStageBytes;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint4 wv = *reinterpret_cast<const uint4*>(base + (cw * 2 + kk) * 512 + lane * 16);
      // word j covers k offsets 16t + 4j .. +3: step s takes words 2s, 2s+1
      uint32_t a[2][4];
      a[0][0] = sext_nibbles(wv.x);      a[0][1] = sext_nibbles(wv.x >> 4);
      a[0][2] = sext_nibbles(wv.y);      a[0][3] = sext_nibbles(wv.y >> 4);
      a[1][0] = sext_nibbles(wv.z);      a[1][1] = sext_nibbles(wv.z >> 4);
      a[1][2] = sext_nibbles(wv.w);      a[1][3] = sext_nibbles(wv.w >> 4);
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        if (mt < n_my) {
          const int r = (mt0 + mt) * 8 + g;
          const int c = (kk * 4 + t) ^ ((r & 1) << 2);
          const uint4 xv = *reinterpret_cast<const uint4*>(xs + r * kKStage + c * 16);
          mma_s8(acc[mt], a[0], xv.x, xv.y);
          mma_s8(acc[mt], a[1], xv.z, xv.w);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (gridDim.z > 1 && !split_k_reduce<MTW>(acc, n_my, ws, cnt)) return;
  // C fragment: acc[mt][0..1] = channel n, tokens m, m+1; [2..3] channel n+8
  const int n = c16 * 16 + g;
  if (!warp_live) return;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + (mt0 + mt) * 8 + 2 * t + (j & 1);
      const int nn = n + (j >> 1) * 8;
      if (mt < n_my && m < M && nn < N)
        out[(size_t)m * N + nn] = (static_cast<float>(acc[mt][j]) * sx[m]) * sw[nn];
    }
}

template <int MT>
int launch(bool x16, const int8_t* xq, const int8_t* wpp, const float* sx, const float* sw,
           float* out, int* ws, int* cnt, int M, int K, int N, int n16, int nk64, int ksplit,
           int sps, cudaStream_t st) {
  const size_t smem = (size_t)stages_for(MT) * stage_bytes(MT);
  auto kernel = x16 ? w4a8_mma_kernel<MT, true> : w4a8_mma_kernel<MT, false>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n16 + kWarps - 1) / kWarps, (M + kMaxTokens - 1) / kMaxTokens, ksplit);
  kernel<<<grid, 128 * groups_for(MT), smem, st>>>(xq, wpp, sx, sw, out, ws, cnt, M, K, N, n16,
                                                 nk64, sps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq (M, K) int8 with K % 4 == 0; wpp the prepacked weight (n16, nk64, 512)
// int8 with nk64 even (K padded to a multiple of 128 with zeros); sx (M, 1)
// and sw (1, N) f32; out (M, N) f32.  mt in {1, 2, 4, 8, 16} token tiles of
// 8 per pass; ksplit > 1 needs ws (passes * 64-channel tiles * ksplit * mt *
// 128 * 4 int32) and cnt (a zeroed int32 counter per (pass, 64-channel tile)).
extern "C" int repro_w4a8_matmul(const int8_t* xq, const int8_t* wpp, const float* sx,
                                 const float* sw, float* out, int* ws, int* cnt, int M, int K,
                                 int N, int n16, int nk64, int mt, int ksplit, int sps,
                                 void* stream) {
  cudaStream_t st = repro::as_stream(stream);
  if (K % 4 || nk64 % 2 || nk64 * 64 < K || n16 * 16 < N || (ksplit > 1 && !(ws && cnt)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool x16 = K % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0;
  switch (mt) {
    case 1:
      return launch<1>(x16, xq, wpp, sx, sw, out, ws, cnt, M, K, N, n16, nk64, ksplit, sps, st);
    case 2:
      return launch<2>(x16, xq, wpp, sx, sw, out, ws, cnt, M, K, N, n16, nk64, ksplit, sps, st);
    case 4:
      return launch<4>(x16, xq, wpp, sx, sw, out, ws, cnt, M, K, N, n16, nk64, ksplit, sps, st);
    case 8:
      return launch<8>(x16, xq, wpp, sx, sw, out, ws, cnt, M, K, N, n16, nk64, ksplit, sps, st);
    case 16:
      return launch<16>(x16, xq, wpp, sx, sw, out, ws, cnt, M, K, N, n16, nk64, ksplit, sps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
