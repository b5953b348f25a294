// Split-sequence flash decoding: the body shared by the paged-attention
// kernel (csrc/paged_attn.cu) and the dense int8 decode kernel
// (csrc/decode_attn.cu).
//
// Both compute, for every (request b, kv head), the softmax attention of R
// query rows (W window tokens x G query heads) over a sequence of cached
// positions whose K/V rows lie `KVS * hd` elements apart: a page-table row
// of pages of `ps` positions (paged), or a contiguous cache of S positions
// (dense: one "page" of S positions per request, no table).  Both are bound
// by device-memory bytes (about one flop per byte), and with W <= 9 and G
// <= 8 a tensor-core tile would be mostly empty, so the design spends its
// effort on parallelism over the sequence, wide loads and state in
// registers:
//
// - A block takes one (kv head, request, group of RT <= 4 query rows,
//   split of the sequence): grid (KVS, B * row groups, splits).  The split
//   count comes from static shapes; a block whose split lies past the
//   row's walk exits at once.  Inside a block the warps (4 on the paged
//   kernel's short walks, else 8) take turns of kU steps of PPL positions
//   each, and load the next turn's K/V while they score this one.
// - Lanes own 8 contiguous head dims (16 bytes of bf16, 8 of int8, 32 of
//   f32): LPR = pow2ceil(hd / 8) lanes hold one position's row (lanes past
//   hd idle), so a warp takes PPL = 32 / LPR positions per load.  Partial
//   dots reduce by shuffles inside each lane group.  q rows sit in
//   registers, pre-scaled by log2(e) / sqrt(hd): the softmax runs in base 2
//   (one MUFU.EX2 per exponential).
// - Each lane group keeps its own online-softmax state (running max m, sum
//   l and its 8-dim slice of the accumulator, for every query row) in
//   registers; the same lane slice accumulates P.V, so the walk has no
//   shared-memory round trip and no barrier.  Groups combine by shuffles,
//   warps in shared memory, splits through a workspace read by the block
//   that arrives last (csrc/common.cuh split_k_last_arrival): every combine
//   runs in a fixed order, so two calls on the same inputs give the same
//   bits, with no float atomics.
// - int8 pools fold the per-(position, head) scales: (q . k_int8) * ks for
//   the score and p * vs for the weight, both within f32 rounding of the
//   reference's dequantize-then-attend order.
//
// The reference's contract, kept exactly: validity comes from the length
// mask (any in-range page id may sit in an unused table slot); m starts at
// -1e30, a masked score is -1e30 and l is clamped at 1e-30.  Query row
// (w, g) sees position pos iff rel = pos - (len - W) < 0 (the committed
// prefix) or rel < W and bit rel of row w's window mask is set: the tree
// mask's row, or bits 0..w for the causal window (pos <= len - W + w).
// A block keeps the mask of its own RT rows only, ceil(W / 32) words a row
// in shared memory sized from W at launch, so the window has no fixed cap
// (the dynamic shared memory bounds it near W = 80,000).  The
// walk stops at `len`, which is exact: positions >= len are invisible to
// every row and add exp(-1e30 - m) == 0.  When some row sees nothing at
// all, every row walks all `mp * ps` positions, as the reference does, so
// even that row's uniform average matches it.  A row's output depends only
// on its own scores.
#pragma once

#include "common.cuh"

// Every product that meets a sum is rounded explicitly (fmaf, __fmul_rn),
// so the compiler's choice of contractions cannot differ between
// instantiations.  Each kernel fixes its step count per pool type and its
// warp count per table span, whatever the rows, so a query row's result
// does not depend on
// the window width W, on G or on the mask: the positions a lane group
// takes, and their order, depend on hd, the pool type and the table's span
// (mp * ps) only, so the tree path's rows equal the chain path's bit for
// bit where they see the same positions.

namespace repro {
namespace fd {

constexpr int kE = 8;        // head dims per lane
constexpr int kSteps = 2;    // positions per lane group and warp iteration (paged bf16, int8)
constexpr int kMinBlocks = 2;  // __launch_bounds__ blocks per SM
constexpr double kLog2e = 1.4426950408889634;  // log2(e)

// 2^x, one MUFU instruction (flushes subnormal results to zero)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Args {
  const void* q;           // (B, W, KVS, G, hd) f32 or bf16
  const void* kp;          // K rows: ((page * ps + slot) * KVS + kvh) * hd
  const void* vp;
  const float* ks;         // per-(position, kv head) scales, or null
  const float* vs;
  const float* tm;         // (B, W, W) tree mask, or null (causal window)
  const int* table;        // (B, mp) page ids, or null: page b
  const int* lengths;      // lengths[b * len_stride]
  float* out;              // (B, W, KVS, G, hd) f32
  float* ws;               // (B, KVS, splits, R, hd + 2) split partials
  int* counters;           // (B, KVS, row groups) arrival counters, zero between calls
  int W, KVS, G, hd, ps, mp, len_stride, q_bf16, split_pos;
  int ps_shift;            // log2(ps) when ps is a power of two, else -1
  float scale;
};

// 8 pool values a lane loads at once, and their conversion to f32
template <typename T> struct Pool;

template <> struct Pool<float> {
  struct Raw { float4 a, b; };
  static constexpr int kU = 2;  // 32 bytes a lane per position
  static __device__ __forceinline__ Raw load(const float* p) {
    const float4* v = reinterpret_cast<const float4*>(p);
    return Raw{__ldg(v), __ldg(v + 1)};
  }
  static __device__ __forceinline__ Raw zero() {
    return Raw{make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  static __device__ __forceinline__ void cvt(const Raw& r, float (&f)[kE]) {
    f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
    f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
  }
};

template <> struct Pool<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int kU = kSteps;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void cvt(const Raw& r, float (&f)[kE]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half (little endian)
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <> struct Pool<int8_t> {
  using Raw = uint2;
  static constexpr int kU = kSteps;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
  // int8 b -> f32 exactly, without the quarter-rate I2F: the biased byte
  // b + 128 is the low mantissa byte of 2^23 + (b + 128), one PRMT, then
  // one FADD takes 2^23 + 128 off
  static __device__ __forceinline__ void cvt(const Raw& r, float (&f)[kE]) {
    const unsigned w[2] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < kE; ++i)
      f[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7650u + (i & 3))) - 8388736.f;
  }
};

// One warp step's loads: kU steps of PPL positions, this lane's 8 dims of
// each position's K and V row, and the position's scales.
template <typename T, int kU> struct Stage {
  typename Pool<T>::Raw k[kU], v[kU];
  float ks[kU], vs[kU];
};

// Body of one block: (kv head blockIdx.x, request and row group blockIdx.y,
// split blockIdx.z), NW warps.  R query rows, RT (1, 3 or 4) of them in this
// block; kU positions per lane group and warp iteration.
template <typename T, int LPR, int RT, int kU, int NW>
__device__ __forceinline__ void flash_decode(const Args& a, int R) {
  constexpr int kWarps = NW, kThreads = NW * 32;
  using P = Pool<T>;
  constexpr int PPL = 32 / LPR;           // positions per warp load
  constexpr int HDM = LPR * kE;           // largest hd of this instantiation
  constexpr int kWarpPos = kU * PPL;      // positions per warp iteration
  constexpr int kBlockPos = kWarps * kWarpPos;
  constexpr bool kScaled = sizeof(T) == 1;  // int8 pools carry scales

  __shared__ float part_s[kWarps][RT][HDM];
  __shared__ float pm_s[kWarps][RT], pl_s[kWarps][RT];
  extern __shared__ unsigned bits_s[];  // [RT][nw]: this block's rows' mask words

  const int groups = (R + RT - 1) / RT;
  const int kvh = blockIdx.x, b = blockIdx.y / groups, z = blockIdx.z;
  const int r0 = blockIdx.y % groups * RT;  // this block's first query row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPR, sub = lane % LPR;
  const int W = a.W, G = a.G, KVS = a.KVS, hd = a.hd;
  const bool lane_on = sub * kE < hd;
  const int len = a.lengths[(size_t)b * a.len_stride];
  const int n_all = a.mp * a.ps;
  const int* trow = a.table != nullptr ? a.table + (size_t)b * a.mp : nullptr;
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  // the positions below min(len, n_all) are walked whatever the masks say:
  // the first loads go out before the masks are read
  int n_pos = max(0, min(len, n_all));
  const int p0 = z * a.split_pos;
  int p1 = min(n_pos, p0 + a.split_pos);
  const int base0 = p0 + warp * kWarpPos;

  auto load = [&](Stage<T, kU>& st, int base) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int pos = base + u * PPL + grp;
      st.k[u] = P::zero();
      st.v[u] = P::zero();
      st.ks[u] = 1.f;
      st.vs[u] = 1.f;
      if (pos < p1) {
        size_t row;  // the position's row of the pool (or of request b's cache)
        if (trow == nullptr) {
          row = (size_t)b * a.ps + pos;
        } else {
          const int pi = a.ps_shift >= 0 ? pos >> a.ps_shift : pos / a.ps;
          row = (size_t)__ldg(trow + pi) * a.ps + (pos - pi * a.ps);
        }
        const size_t slot = row * KVS + kvh;
        if (lane_on) {
          const size_t off = slot * hd + sub * kE;
          st.k[u] = P::load(kp + off);
          st.v[u] = P::load(vp + off);
        }
        if (kScaled) {
          st.ks[u] = __ldg(a.ks + slot);
          st.vs[u] = __ldg(a.vs + slot);
        }
      }
    }
  };
  Stage<T, kU> cur, nxt;
  load(cur, base0);

  // this block's q rows in registers, f32 and pre-scaled (rows past R: 0)
  auto q_index = [&](int r) {
    const int w = (r0 + r) / G, g = (r0 + r) % G;
    return ((((size_t)b * W + w) * KVS + kvh) * G + g) * hd + sub * kE;
  };
  float q[RT][kE];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int e = 0; e < kE; ++e) q[r][e] = 0.f;
    if (r0 + r < R && lane_on) {
      if (a.q_bf16) {
        Pool<__nv_bfloat16>::cvt(
            Pool<__nv_bfloat16>::load(static_cast<const __nv_bfloat16*>(a.q) + q_index(r)), q[r]);
      } else {
        Pool<float>::cvt(Pool<float>::load(static_cast<const float*>(a.q) + q_index(r)), q[r]);
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) q[r][e] = __fmul_rn(q[r][e], a.scale);
    }
  }

  // window mask words of this block's rows: bit j of word k of row r is
  // set iff row r's window row w sees window slot 32k + j (the tree mask's
  // row, or slots 0..w for the causal window); rows past R stay 0
  const int nw = (W + 31) / 32;
  for (int e = tid; e < RT * nw; e += kThreads) {
    const int r = e / nw, j0 = e % nw * 32;
    unsigned bits = 0u;
    if (r0 + r < R) {
      const int w = (r0 + r) / G;
      if (a.tm != nullptr) {
        const float* row = a.tm + ((size_t)b * W + w) * W + j0;
        const int n = min(32, W - j0);
#pragma unroll
        for (int j = 0; j < 32; ++j)  // unrolled: the loads go out together
          if (j < n) bits |= (row[j] > 0.5f ? 1u : 0u) << j;
      } else {
        const int d = w - j0;  // causal: slots j0..w of this word
        bits = d < 0 ? 0u : d >= 31 ? 0xffffffffu : (2u << d) - 1u;
      }
    }
    bits_s[e] = bits;
  }
  // a non-empty prefix is seen by every row; else row w sees something iff
  // its mask marks a window slot holding a position in [0, len): a
  // block-wide AND over all W window rows (not only this block's)
  bool every_row_sees = len > W;
  if (!every_row_sees && len > 0) {  // uniform per block
    const int lo = W - len;  // first window slot at a position >= 0
    bool mine = true;
    for (int w = tid; w < W; w += kThreads) {
      bool sees = w >= lo;  // causal: row w sees slots 0..w
      if (a.tm != nullptr) {
        const float* row = a.tm + ((size_t)b * W + w) * W;
        sees = false;
        for (int j = lo; j < W && !sees; ++j) sees = row[j] > 0.5f;
      }
      mine = mine && sees;
    }
    every_row_sees = __syncthreads_and(mine) != 0;
  } else {
    __syncthreads();  // the mask words are written
  }
  if (!every_row_sees) {  // some row sees nothing: walk every page
    n_pos = n_all;
    p1 = min(n_pos, p0 + a.split_pos);
    load(cur, base0);
  }
  const int n_active = (n_pos + a.split_pos - 1) / a.split_pos;
  if (z >= n_active) return;  // past this row's walk (uniform per block)
  const int win0 = len - W;  // position of window slot 0

  float m[RT], l[RT], acc[RT][kE];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = -1e30f;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[r][e] = 0.f;
  }

  for (int base = base0; base < p1; base += kBlockPos) {
    if (base + kBlockPos < p1) load(nxt, base + kBlockPos);
    // scores of this lane group's kU positions; a step past p1 for the
    // whole warp is skipped (it would add exact zeros)
    float s[RT][kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bool step_on = base + u * PPL < p1;  // uniform per warp
      const int pos = base + u * PPL + grp;
      const int rel = pos - win0;
      float kf[kE];
      if (step_on) P::cvt(cur.k[u], kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        s[r][u] = -INFINITY;
        if (r0 + r >= R || !step_on) continue;  // uniform
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) dot = fmaf(q[r][e], kf[e], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (kScaled) dot = __fmul_rn(dot, cur.ks[u]);
        const bool visible =
            rel < 0 || (rel < W && ((bits_s[r * nw + (rel >> 5)] >> (rel & 31)) & 1u));
        if (pos < p1) s[r][u] = visible ? dot : -1e30f;
      }
    }
    // online softmax per row; s becomes the weights
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r0 + r >= R) continue;
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kU; ++u) mx = fmaxf(mx, s[r][u]);
      const float c = exp2_approx(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        s[r][u] = exp2_approx(s[r][u] - mx);
        sum += s[r][u];
      }
      l[r] = fmaf(l[r], c, sum);
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[r][e] = __fmul_rn(acc[r][e], c);
    }
    // P.V into the same lane slice
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (base + u * PPL >= p1) continue;  // uniform
      float vf[kE];
      P::cvt(cur.v[u], vf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r0 + r >= R) continue;
        const float p = kScaled ? __fmul_rn(s[r][u], cur.vs[u]) : s[r][u];
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
    cur = nxt;
  }

  // combine the warp's PPL lane groups (butterfly: every lane ends with the
  // same bits, since each step's two terms only swap places)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r0 + r >= R) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float fa = exp2_approx(m[r] - mx), fb = exp2_approx(mo - mx);
      l[r] = fmaf(l[r], fa, __fmul_rn(lo, fb));
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = fmaf(acc[r][e], fa, __fmul_rn(ao, fb));
      }
      m[r] = mx;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (lane_on) {
#pragma unroll
        for (int e = 0; e < kE; ++e) part_s[warp][r][sub * kE + e] = acc[r][e];
      }
      if (sub == 0) {
        pm_s[warp][r] = m[r];
        pl_s[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  const bool direct = n_active == 1;
  const size_t ws_row = (size_t)hd + 2;
  float* ws_bh = a.ws + ((size_t)b * KVS + kvh) * gridDim.z * R * ws_row;
  auto out_at = [&](int rr, int d) -> float& {
    const int w = rr / G, g = rr % G;
    return a.out[((((size_t)b * W + w) * KVS + kvh) * G + g) * hd + d];
  };
  // combine the warps in order 0..kWarps-1
  for (int e = tid; e < RT * hd; e += kThreads) {
    const int r = e / hd, d = e % hd, rr = r0 + r;
    if (rr >= R) break;
    float mx = pm_s[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, pm_s[w][r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2_approx(pm_s[w][r] - mx);
      lsum = fmaf(pl_s[w][r], f, lsum);
      asum = fmaf(part_s[w][r][d], f, asum);
    }
    if (direct) {
      out_at(rr, d) = asum / fmaxf(lsum, 1e-30f);
    } else {
      float* slot = ws_bh + ((size_t)z * R + rr) * ws_row;
      slot[d] = asum;
      if (d == 0) {
        slot[hd] = mx;
        slot[hd + 1] = lsum;
      }
    }
  }
  if (direct) return;

  // split partials: the last block of this row group to arrive adds them
  // in split order
  int* counter = a.counters + ((size_t)b * KVS + kvh) * groups + r0 / RT;
  if (!split_k_last_arrival(counter, n_active)) return;
  for (int e = tid; e < RT * hd; e += kThreads) {
    const int rr = r0 + e / hd, d = e % hd;
    if (rr >= R) break;
    float mx = -INFINITY;
    for (int zz = 0; zz < n_active; ++zz)
      mx = fmaxf(mx, __ldcg(ws_bh + ((size_t)zz * R + rr) * ws_row + hd));
    float lsum = 0.f, asum = 0.f;
    for (int zz = 0; zz < n_active; ++zz) {
      const float* slot = ws_bh + ((size_t)zz * R + rr) * ws_row;
      const float f = exp2_approx(__ldcg(slot + hd) - mx);
      lsum = fmaf(__ldcg(slot + hd + 1), f, lsum);
      asum = fmaf(__ldcg(slot + d), f, asum);
    }
    out_at(rr, d) = asum / fmaxf(lsum, 1e-30f);
  }
}

// Lanes per position for a head dim: pow2ceil(hd / 8), 2..16.
inline int lanes_per_row(int hd) {
  int lpr = 2;
  while (lpr * kE < hd) lpr *= 2;
  return lpr;
}

// Query rows per block for R rows of a kv head.
// 1 for one row, else 3 or 4, whichever pads R less (4 on a tie): the
// tree window's 9 rows take 3 blocks of 3, not 4 + 4 + 1 padded to 4.
inline int rows_per_block(int R) {
  if (R == 1) return 1;
  const int pad3 = (R + 2) / 3 * 3, pad4 = (R + 3) / 4 * 4;
  return pad3 < pad4 ? 3 : 4;
}

// Positions per split: the caller's split count over the longest walk,
// rounded up to whole block iterations (NW warps of kU steps).
template <int LPR, int kU, int NW> inline int split_positions(int n_all, int splits) {
  constexpr int kBlockPos = NW * kU * (32 / LPR);
  const int per = (n_all + splits - 1) / splits;
  return (per + kBlockPos - 1) / kBlockPos * kBlockPos;
}

// Launch `kernel` (a __global__ wrapper of flash_decode<.., LPR, RT, kU,
// NW>) over (KVS, B * row groups, splits), the splits cut at whole block
// iterations, with ceil(W / 32) mask words per block row in dynamic shared
// memory.  Returns cudaGetLastError().
template <int LPR, int RT, int kU, int NW, typename Kernel>
int launch(Kernel kernel, Args a, int B, int R, int splits, cudaStream_t st) {
  const int n_all = a.mp * a.ps;
  a.split_pos = split_positions<LPR, kU, NW>(n_all, splits);
  const int nz = (n_all + a.split_pos - 1) / a.split_pos;
  if (nz > 1 && (a.ws == nullptr || a.counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(a.KVS, B * ((R + RT - 1) / RT), nz);
  const size_t bits_bytes = sizeof(unsigned) * RT * ((a.W + 31) / 32);
  kernel<<<grid, NW * 32, bits_bytes, st>>>(a, R);
  return static_cast<int>(cudaGetLastError());
}

// log2(ps) when ps is a power of two, else -1.
inline int pow2_shift(int ps) {
  if (ps <= 0 || (ps & (ps - 1)) != 0) return -1;
  int shift = 0;
  while ((1 << shift) < ps) ++shift;
  return shift;
}

}  // namespace fd
}  // namespace repro
