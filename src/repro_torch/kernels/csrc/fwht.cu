// LRU rotation: one block stage y = x @ kron(I_{n/B}, H_B / sqrt(B)),
// B = m * 2^k, or a whole two-stage RotationPlan (tiled or two_block), in
// one launch.
//
// Replaces: repro/kernels/fwht.py:block_rotate_pallas (bodies
// _rotate_kernel and _fwht_in_kernel), and the stage composition of
// repro/kernels/ops.py:lru_rotate / lru_rotate_transpose (two kernel calls
// and two rolls, or two calls and two concatenations).
//
// Bound on this card: a call reads the (tokens, n) activation and writes it
// once and does (k + m + 1) operations per element and stage: a few per
// byte, so device-memory bytes bound it (and, at serving sizes of a few
// dozen tokens, the launch).
//
// Design:
//  * A unit is one (row, block) of a single stage, one (row, stage-2 block)
//    of a tiled plan, or one row of a two_block plan.  It has U = B / V
//    threads; thread t holds the V elements [tV, tV + V) of the block it
//    rotates (V = 8 bf16 or 4 f32: one 16-byte load; less where the sizes
//    or offsets are not multiples of it).  A CTA holds P units, chosen by
//    the wrapper so that small calls still spread over the SMs.
//  * The 2^k factor (Sylvester butterflies, stage order h = 1, 2, 4, ...):
//    stages with h < V inside a thread's registers, the rest across the
//    thread's group of 2^k / V lanes with __shfl_xor_sync (k <= 6: inside a
//    warp for V >= 2); shared memory only for lane distances of 32 or more
//    (V = 1 and k = 6).
//  * The m x m +-1 factor: each thread forms its V outputs out[b*2^k + r] =
//    sum_a y[a*2^k + r] * H[a][b] (a = 0, 1, ... in order, fmaf), with H_m
//    read from the input tensor (transposed on request), so every Hadamard
//    order works.  Where a unit's lanes divide a warp and hold one column b
//    each (B / V | 32, 2^k >= V: bf16 m = 4 and 2 at k = 6, the target's
//    R2), the y values come by shuffles and H_m through the read-only
//    cache: no shared memory and no barrier, so a warp never waits for its
//    CTA's slowest.  Otherwise the butterflies' results and H_m go through
//    shared memory.
//  * Tiled plans: stage-2 block j covers stage-1 output [jB + B/2, jB +
//    3B/2) mod n (forward; the transpose runs the shifted stage first, so its
//    window starts at jB - B/2).  The unit loads both stage-1 blocks of its
//    window (the reads double, mostly from L2), rotates them, keeps the
//    middle B outputs in registers, rotates those again and stores them at
//    their cyclic position: no roll, no second pass over device memory.
//  * Two_block plans: one unit per row rotates the first block, stores the
//    outputs outside the overlap, and rotates the second block from the
//    first's outputs (shuffled, or through shared memory) and from x.
//  * Rounding as in the reference's composition: arithmetic in float32,
//    each stage's output scaled by 1/sqrt(B) and rounded to x's dtype
//    before the next stage reads it.  Every add, fma and multiply is
//    explicit (__fadd_rn, fmaf, __fmul_rn) in an order fixed by (m, k, B)
//    alone, so a row's bits do not depend on the number of rows, the row's
//    index, V or P.
#include "common.cuh"

#include <string.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarpThreads = 256;  // a CTA of warp-path units (kernels/fwht.py:CTA_THREADS)
enum Kind : int { kSingle = 0, kTiled = 1, kTwoBlock = 2 };

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

template <typename T, int V> using RawOf = typename Raw<sizeof(T) * V>::type;

// V elements as one load (zeros for an inactive thread), kept raw so that
// nothing waits on it until unpack().
template <typename T, int V>
__device__ __forceinline__ RawOf<T, V> load_raw(const T* p, bool active) {
  RawOf<T, V> r;
  if (active) {
    r = __ldg(reinterpret_cast<const RawOf<T, V>*>(p));
  } else {
    memset(&r, 0, sizeof(r));
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const RawOf<T, V>& r, float (&f)[V]) {
  T t[V];
  memcpy(t, &r, sizeof(r));
#pragma unroll
  for (int v = 0; v < V; ++v) f[v] = repro::to_float(t[v]);
}

template <typename T, int V>
__device__ __forceinline__ void store_chunk(T* p, const float (&f)[V]) {
  T t[V];
#pragma unroll
  for (int v = 0; v < V; ++v) t[v] = repro::from_float<T>(f[v]);
  RawOf<T, V> r;
  memcpy(&r, t, sizeof(r));
  *reinterpret_cast<RawOf<T, V>*>(p) = r;
}

// FWHT of size 2^k over a block whose element tV + v thread t holds in
// f[v].  `buf` (the unit's B floats) is scratch for lane distances >= 32;
// every thread of the CTA calls this (shuffles and barriers), inactive ones
// without touching `buf`.
template <int V>
__device__ __forceinline__ void fwht(float (&f)[V], int size, int t, float* buf, bool active) {
#pragma unroll
  for (int h = 1; h < V; h <<= 1) {
    if (h < size) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!(v & h)) {
          const float a = f[v], b = f[v | h];
          f[v] = __fadd_rn(a, b);
          f[v | h] = __fsub_rn(a, b);
        }
      }
    }
  }
  int h = V;
  for (; h < size && h < 32 * V; h <<= 1) {
    const int d = h / V;
    const bool upper = t & d;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float p = __shfl_xor_sync(0xffffffffu, f[v], d);
      f[v] = upper ? __fsub_rn(p, f[v]) : __fadd_rn(f[v], p);
    }
  }
  if (h >= size) return;
  for (; h < size; h <<= 1) {
    __syncthreads();
    if (active) {
#pragma unroll
      for (int v = 0; v < V; ++v) buf[t * V + v] = f[v];
    }
    __syncthreads();
    if (active) {
      const bool upper = (t * V) & h;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float p = buf[((t * V) ^ h) + v];
        f[v] = upper ? __fsub_rn(p, f[v]) : __fadd_rn(f[v], p);
      }
    }
  }
  __syncthreads();  // buf free for the caller
}

// s[v] = sum_a buf[a*2^k + r] * hs[a*m + b] for the block position
// pos + v = b*2^k + r.
template <int V>
__device__ __forceinline__ void mix(const float* buf, const float* hs, int pos, int m, int k,
                                    float (&s)[V]) {
  const int mask = (1 << k) - 1;
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  if (V % 4 == 0 && (1 << k) >= V) {  // one b for the chunk: 16-byte reads
    const int b = pos >> k, r = pos & mask;
    for (int a = 0; a < m; ++a) {
      const float hv = hs[a * m + b];
      const float4* src = reinterpret_cast<const float4*>(buf + (a << k) + r);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 w = src[q];
        s[4 * q + 0] = fmaf(w.x, hv, s[4 * q + 0]);
        s[4 * q + 1] = fmaf(w.y, hv, s[4 * q + 1]);
        s[4 * q + 2] = fmaf(w.z, hv, s[4 * q + 2]);
        s[4 * q + 3] = fmaf(w.w, hv, s[4 * q + 3]);
      }
    }
    return;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int b = (pos + v) >> k, r = (pos + v) & mask;
    for (int a = 0; a < m; ++a) s[v] = fmaf(buf[(a << k) + r], hs[a * m + b], s[v]);
  }
}

// A stage's output as the next stage (or the store) sees it: scaled and
// rounded to T.
template <typename T, int V>
__device__ __forceinline__ void finish(float (&s)[V], float scale) {
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = repro::round_to<T>(__fmul_rn(s[v], scale));
}

template <int V>
__device__ __forceinline__ void put(float* p, const float (&f)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) p[v] = f[v];
}

// The m x m mix by shuffles, for units of U | 32 lanes with one b per
// chunk (2^k >= V): out at block position el + v from y[a*2^k + r], which
// lane a*L + r/V of the unit holds (L = U / m lanes per group of 2^k).
// kTwo: lanes with `from_y1` read y1 instead (the tiled plan's right
// block).  H_m comes through the read-only cache; the sums run in the
// order of mix().
template <typename T, int V, bool kTwo>
__device__ __forceinline__ void mix_warp(const float (&y0)[V], const float (&y1)[V],
                                         bool from_y1, int el, const T* __restrict__ hm,
                                         int transpose, int m, int k, int U, float (&s)[V]) {
  const int L = U / m, b = el >> k, c = (el & ((1 << k) - 1)) / V;
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.f;
  for (int a = 0; a < m; ++a) {
    const float hv = repro::to_float(__ldg(hm + (transpose ? b * m + a : a * m + b)));
    const int src = a * L + c;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float y = __shfl_sync(0xffffffffu, y0[v], src, U);
      if (kTwo) {
        const float y_1 = __shfl_sync(0xffffffffu, y1[v], src, U);
        y = from_y1 ? y_1 : y;
      }
      s[v] = fmaf(y, hv, s[v]);
    }
  }
}

// kWarp: the mix on shuffles (mix_warp); its CTAs are at most kWarpThreads
// wide, so the tiled stage's registers need not fit the 64 a 1024-thread
// CTA leaves.
template <typename T, int V, bool kWarp>
__global__ void __launch_bounds__(kWarp ? kWarpThreads : kMaxThreads)
block_rotate_kernel(const T* __restrict__ x, const T* __restrict__ hm, T* __restrict__ out,
                    int tokens, int n, int m, int k, int kind, int transpose, int per_cta,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  const int size = 1 << k, B = m << k, U = B / V;
  const int nb = kind == kTwoBlock ? 1 : n / B;  // units per row
  const int per_unit = kind == kSingle ? B : 2 * B;
  float* hs = smem;  // hs[a*m + b] = H[a][b] (or H[b][a])
  const int tid = threadIdx.x;
  const int p = tid / U, t = tid - p * U;  // unit in the CTA, thread in the unit
  const int unit = blockIdx.x * per_cta + p;
  const bool active = p < per_cta && unit < tokens * nb;  // buf below only if active
  const int row = unit / nb, j = unit - row * nb;
  const T* xr = x + (size_t)row * n;
  T* yr = out + (size_t)row * n;
  float* buf = smem + ((m * m + 3) & ~3) + (size_t)p * per_unit;
  const int pos = t * V;

  // o: the first block read (the block, the tiled window, the first end
  // block); o2: the second (the window's right block; the second end block,
  // read from x where it does not overlap the first).  Both loads go out
  // first and are unpacked late, so they overlap each other and H_m's.
  // io: where the last stage's outputs go.
  int o, o2 = 0, io;
  bool second = false, out1 = false;  // two_block: chunk outside the other block
  if (kind == kSingle) {
    o = j * B;
    io = o + pos;
  } else if (kind == kTiled) {
    o = transpose ? (j * B + n - B / 2) % n : j * B;
    o2 = o + B < n ? o + B : o + B - n;
    second = true;
    io = o + B / 2 + pos;
    io -= io < n ? 0 : n;
  } else {
    o = transpose ? n - B : 0;
    o2 = transpose ? 0 : n - B;
    second = o2 + pos < o || o2 + pos >= o + B;
    out1 = o + pos < o2 || o + pos >= o2 + B;
    io = o2 + pos;
  }
  const int i0 = o + pos, i1 = o2 + pos;
  const RawOf<T, V> rf = load_raw<T, V>(xr + (i0 < n ? i0 : i0 - n), active);
  const RawOf<T, V> rg = load_raw<T, V>(xr + (i1 < n ? i1 : i1 - n), active && second);
  float f[V], g[V], s[V];

  if constexpr (kWarp) {  // the whole unit in one warp: no shared memory, no barrier
    unpack<T, V>(rf, f);
    unpack<T, V>(rg, g);
    fwht<V>(f, size, t, nullptr, active);
    if (kind == kTiled) {
      fwht<V>(g, size, t, nullptr, active);
      const int e = B / 2 + pos;  // window position: left block, then right
      mix_warp<T, V, true>(f, g, e >= B, e < B ? e : e - B, hm, transpose, m, k, U, s);
      finish<T, V>(s, scale);
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] = s[v];
    } else if (kind == kTwoBlock) {
      mix_warp<T, V, false>(f, f, false, pos, hm, transpose, m, k, U, s);
      finish<T, V>(s, scale);
      if (active && out1) store_chunk<T, V>(yr + i0, s);
      // the second block: the first's outputs where they overlap, else x
      const int src = second ? 0 : (i1 - o) / V;
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] = __shfl_sync(0xffffffffu, s[v], src, U);
      if (second) unpack<T, V>(rg, f);
    }
    if (kind != kSingle) fwht<V>(f, size, t, nullptr, active);
    mix_warp<T, V, false>(f, f, false, pos, hm, transpose, m, k, U, s);
    finish<T, V>(s, scale);
    if (active) store_chunk<T, V>(yr + io, s);
    return;
  }
  for (int e = tid; e < m * m; e += blockDim.x) {
    const int a = e / m, b = e - a * m;
    hs[e] = repro::to_float(transpose ? hm[b * m + a] : hm[e]);
  }
  __syncthreads();
  unpack<T, V>(rf, f);
  unpack<T, V>(rg, g);
  fwht<V>(f, size, t, buf, active);

  if (kind == kSingle) {
    if (active) put<V>(buf + pos, f);
    __syncthreads();
    if (active) {
      mix<V>(buf, hs, pos, m, k, s);
      finish<T, V>(s, scale);
      store_chunk<T, V>(yr + io, s);
    }
    return;
  }

  if (kind == kTiled) {
    fwht<V>(g, size, t, buf, active);
    if (active) {
      put<V>(buf + pos, f);
      put<V>(buf + B + pos, g);
    }
    __syncthreads();
    // stage-1 outputs at window positions B/2 + pos: the second half of the
    // left block, then the first half of the right one
    const int e = B / 2 + pos;
    if (active) {
      mix<V>(e < B ? buf : buf + B, hs, e < B ? e : e - B, m, k, f);
      finish<T, V>(f, scale);
    }
    __syncthreads();
    fwht<V>(f, size, t, buf, active);
    if (active) put<V>(buf + pos, f);
    __syncthreads();
    if (active) {
      mix<V>(buf, hs, pos, m, k, s);
      finish<T, V>(s, scale);
      store_chunk<T, V>(yr + io, s);
    }
    return;
  }

  // two_block: the first block at o, the second at o2; they overlap
  float* kept = buf + B;  // the first block's rounded outputs
  if (active) put<V>(buf + pos, f);
  __syncthreads();
  if (active) {
    mix<V>(buf, hs, pos, m, k, s);
    finish<T, V>(s, scale);
    if (out1) store_chunk<T, V>(yr + i0, s);
    put<V>(kept + pos, s);
  }
  __syncthreads();
  if (second) {
    unpack<T, V>(rg, f);
  } else if (active) {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = kept[i1 - o + v];
  }
  fwht<V>(f, size, t, buf, active);
  if (active) put<V>(buf + pos, f);
  __syncthreads();
  if (active) {
    mix<V>(buf, hs, pos, m, k, s);
    finish<T, V>(s, scale);
    store_chunk<T, V>(yr + io, s);
  }
}

template <typename T, int V>
int launch(const void* x, const void* hm, void* out, int tokens, int n, int m, int k, int kind,
           int transpose, int per_cta, int warp, int threads, int smem, cudaStream_t st) {
  if (warp && threads > kWarpThreads) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = warp ? block_rotate_kernel<T, V, true> : block_rotate_kernel<T, V, false>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int B = m << k;
  const int units = tokens * (kind == kTwoBlock ? 1 : n / B);
  const int grid = (units + per_cta - 1) / per_cta;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(B)));
  kern<<<grid, threads, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(hm),
                                    static_cast<T*>(out), tokens, n, m, k, kind, transpose,
                                    per_cta, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VMAX>
int launch_v(int vec, const void* x, const void* hm, void* out, int tokens, int n, int m, int k,
             int kind, int transpose, int per_cta, int warp, int threads, int smem,
             cudaStream_t st) {
  if constexpr (VMAX > 1) {
    if (vec < VMAX)
      return launch_v<T, VMAX / 2>(vec, x, hm, out, tokens, n, m, k, kind, transpose, per_cta,
                                   warp, threads, smem, st);
  }
  if (vec != VMAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch<T, VMAX>(x, hm, out, tokens, n, m, k, kind, transpose, per_cta, warp, threads,
                         smem, st);
}

}  // namespace

// x and out (tokens, n), hm (m, m), all of dtype `dtype` (repro::kF32 /
// kBF16).  kind 0: one stage over the n / B blocks of each row; 1: a tiled
// plan (n % B == 0, n >= 2B); 2: a two_block plan (B < n <= 2B).  The
// wrapper (kernels/fwht.py:layout) chooses `vec` (V, a power of two
// dividing n, B, the plan's offsets and 16 bytes), `per_cta` units a CTA,
// `warp` (1: a unit's B / V threads divide a warp and 2^k >= V, so the mix
// runs on shuffles and needs no shared memory), `threads` (a multiple of 32
// >= per_cta * B / vec) and `smem` bytes.
extern "C" int repro_block_rotate(const void* x, const void* hm, void* out, int tokens, int n,
                                  int m, int k, int kind, int transpose, int vec, int per_cta,
                                  int warp, int threads, int smem, int dtype, void* stream) {
  cudaStream_t st = repro::as_stream(stream);
  if (threads > kMaxThreads || threads % 32 || per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kF32)
    return launch_v<float, 4>(vec, x, hm, out, tokens, n, m, k, kind, transpose, per_cta, warp,
                              threads, smem, st);
  if (dtype == repro::kBF16)
    return launch_v<__nv_bfloat16, 8>(vec, x, hm, out, tokens, n, m, k, kind, transpose,
                                      per_cta, warp, threads, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
