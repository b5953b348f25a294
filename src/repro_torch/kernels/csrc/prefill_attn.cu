// Prefill flash attention over a dense cache (K8): the causal (or full)
// streaming-softmax attention of a call's query rows over the keys a dense
// K / V cache holds, one launch per layer call.
//
// Replaces: no TPU kernel.  The reference computes this attention in plain
// jnp (repro/models/layers.py flash_attention), and the port's plain torch
// version (models/layers.py flash_attention / _flash_block) walked every
// 128-row query block over the whole s_max-slot cache in ~25 eager ops per
// 1,024-key chunk: launch-bound, four times the causal work for a 1k prompt
// in a 4,112-slot cache, and a float32 pass over each score block per op.
// It computes the same function at the same precision: q * 1/sqrt(hd)
// rounded to the model dtype, QK and PV products of model-dtype operands
// accumulated in float32, softmax statistics and the accumulator in
// float32, P rounded to the model dtype before the PV product, the output
// acc / max(l, 1e-30) rounded to the model dtype.  Only the order of the
// sums differs.
//
// Bound on this card: a prefill of S rows does ~4 * S * S/2 * hd * H
// operations against ~S * hd * (2 H + 2 Hkv) * 2 bytes: hundreds of
// operations per byte at S ~ 1k, so the tensor cores bound it.  At the
// serving cells' sizes (1-3k rows, 32-48 heads) a call is tens of
// microseconds, a few percent of the prefill: the point is one launch in
// place of ~120 per 128-row block, and keys past the causal edge left
// unread, more than the tensor cores' peak.
//
// Design: the grid is (query tiles of 64 rows, q heads, batch); q head h
// reads kv head h / G.  Four warps hold 16 rows each: Q in registers as
// mma.sync m16n8k16 A fragments (loaded once through shared memory),
// 64-key K / V tiles double-buffered through shared memory by cp.async
// (rows padded by 16 bytes, so ldmatrix reads are free of bank conflicts
// at every head dim), the scores, the softmax state and the output
// accumulator in registers.  K / V are read in place from the cache's
// strided (B, S, Hkv, hd) view.  The key loop stops at the tile's last
// row's causal edge, capped at the keys the call may read (q_offset + Sq
// when causal, else S); keys past that are zero-filled by predicate and
// masked, so a cache's tail past the call's rows is never read.
//
// Row invariance: key tiles start at absolute key positions (0, 64, ...),
// never relative to the call's first row, and each row's max and sum run
// in a fixed lane order, so a row's bits do not depend on how many rows
// share the call or where the call starts (a prefix hit's tail extend
// against the full prefill).  A tile fully masked for a row (its tile
// walks further) leaves that row's max unchanged, rescales by exactly
// expf(0) = 1 and adds exact zeros.  Query tiles are scheduled longest
// walk first.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kRows = 64;  // query rows a block
constexpr int kKeys = 64;  // keys a tile
constexpr int kWarps = kRows / 16;
constexpr int kThreads = kWarps * 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // (B, Sq, H, hd), contiguous
  long long q_sb, q_ss, q_sh;  // element strides of q's batch, row and head axes
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int Sq, Skv, H, G, q_offset, causal;
  float scale;  // 1/sqrt(hd) as float32
};

template <typename T> struct Dt;
template <> struct Dt<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 r(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Dt<__half> {
  static __device__ __forceinline__ float f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half r(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(repro::smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(repro::smem_u32(p))
               : "memory");
}

// the quad's four lanes hold one row: combined in a fixed order (xor 1,
// then xor 2), so every lane of the quad ends with the same bits
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int HD> constexpr int smem_bytes(int elem) {
  return (kRows + 4 * kKeys) * (HD + 8) * elem;  // Q, then K and V twice each
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) prefill_attn_kernel(Args a) {
  constexpr int LD = HD + 8;  // shared row stride in elements: 16 bytes of padding
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  constexpr int KS = HD / 16;  // k-steps of the QK product
  constexpr int ON = HD / 8;  // 8-wide output tiles a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kRows * LD;
  T* sv = sk + 2 * kKeys * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal walk first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + (h / a.G) * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + (h / a.G) * a.v_sh;

  // keys any row of the call may see, and the keys this tile's rows see
  const int valid = a.causal ? min(a.q_offset + a.Sq, a.Skv) : a.Skv;
  const int walk = a.causal ? min(a.q_offset + min(q0 + kRows, a.Sq), valid) : valid;
  const int n_tiles = (walk + kKeys - 1) / kKeys;

  auto load_kv = [&](int t, int buf) {
    T* dk = sk + buf * kKeys * LD;
    T* dv = sv + buf * kKeys * LD;
    for (int c = tid; c < kKeys * CH; c += kThreads) {
      const int r = c / CH, off = (c % CH) * 8, key = t * kKeys + r;
      const bool in = key < walk;
      repro::cp_async16(dk + r * LD + off, in ? kg + key * a.k_ss + off : kg, in ? 16 : 0);
      repro::cp_async16(dv + r * LD + off, in ? vg + key * a.v_ss + off : vg, in ? 16 : 0);
    }
  };
  load_kv(0, 0);
  repro::cp_async_commit();

  // Q * scale in float32, rounded to T (rows past Sq: zeros, never stored)
  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int r = c / CH, off = (c % CH) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < a.Sq) raw = *reinterpret_cast<const uint4*>(qg + (q0 + r) * a.q_ss + off);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = Dt<T>::r(__fmul_rn(Dt<T>::f(e[i]), a.scale));
    *reinterpret_cast<uint4*>(sq + r * LD + off) = raw;
  }
  __syncthreads();
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], sq + (warp * 16 + (mi & 1) * 8 + mr) * LD + ks * 16 + (mi >> 1) * 8);

  // this lane's rows: g and g + 8 of the warp's 16, at positions pos[0..1]
  const int g = lane >> 2, t4 = lane & 3;
  const int pos[2] = {a.q_offset + q0 + warp * 16 + g, a.q_offset + q0 + warp * 16 + g + 8};
  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();
    __syncthreads();
    const T* kb = sk + buf * kKeys * LD;
    const T* vb = sv + buf * kKeys * LD;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kb + (np * 16 + (mi >> 1) * 8 + mr) * LD + ks * 16 + (mi & 1) * 8);
        Dt<T>::mma(s[2 * np], qf[ks], bk[0], bk[1]);
        Dt<T>::mma(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }
    // mask keys past `valid` and, causal, past each row's position; a tile
    // every row of the block sees whole needs no mask
    const int kbase = t * kKeys;
    const bool whole = kbase + kKeys <= valid &&
                       (!a.causal || kbase + kKeys - 1 <= a.q_offset + q0);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kbase + j * 8 + 2 * t4 + (e & 1);
          if (key >= valid || (a.causal && key > pos[e >> 1])) s[j][e] = -INFINITY;
        }
    }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = expf(m_run[r] - mx[r]);  // 0 on the first tile, exactly 1 if the max held
      m_run[r] = mx[r];
    }
    uint32_t pa[4][4];  // P rounded to T: the A fragments of the four 16-key steps
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[j][e] - mx[e >> 1]);
        rs[e >> 1] = __fadd_rn(rs[e >> 1], p[e]);
      }
      pa[j >> 1][(j & 1) * 2] = Dt<T>::pack(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = Dt<T>::pack(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_run[r] = __fadd_rn(__fmul_rn(l_run[r], alpha[r]), quad_sum(rs[r]));
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      o[n][0] = __fmul_rn(o[n][0], alpha[0]);
      o[n][1] = __fmul_rn(o[n][1], alpha[0]);
      o[n][2] = __fmul_rn(o[n][2], alpha[1]);
      o[n][3] = __fmul_rn(o[n][3], alpha[1]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < ON / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vb + (kk * 16 + (mi & 1) * 8 + mr) * LD + np * 16 + (mi >> 1) * 8);
        Dt<T>::mma(o[2 * np], pa[kk], bv[0], bv[1]);
        Dt<T>::mma(o[2 * np + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // the buffer is free for the load two tiles on
  }

  T* og = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= a.Sq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        og + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * HD + 2 * t4);
#pragma unroll
    for (int n = 0; n < ON; ++n)
      dst[n * 4] = Dt<T>::pack(__fdiv_rn(o[n][2 * r], l), __fdiv_rn(o[n][2 * r + 1], l));
  }
}

template <typename T, int HD>
int run(const Args& a, int B, cudaStream_t st) {
  const size_t smem = smem_bytes<HD>(sizeof(T));
  cudaError_t err = repro::allow_smem(prefill_attn_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sq + kRows - 1) / kRows, a.H, B);
  prefill_attn_kernel<T, HD><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int B, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return run<T, 16>(a, B, st);
    case 32: return run<T, 32>(a, B, st);
    case 64: return run<T, 64>(a, B, st);
    case 112: return run<T, 112>(a, B, st);
    case 128: return run<T, 128>(a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, hd), k / v (B, Skv, Hkv, hd) as strided views (last axis
// contiguous, every row 16-byte aligned; strides in elements), out (B, Sq,
// H, hd) contiguous, all bf16 (half = 0) or fp16 (half = 1).  Causal: row
// i sits at position q_offset + i and sees keys 0..position, of the first
// min(q_offset + Sq, Skv); otherwise every row sees all Skv keys.  hd: 16,
// 32, 64, 112 or 128; H a multiple of Hkv.
extern "C" int repro_prefill_attn(const void* q, const void* k, const void* v, void* out,
                                  long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh, int B, int Sq,
                                  int Skv, int H, int Hkv, int hd, int q_offset, int causal,
                                  int half, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         Sq, Skv, H, H / Hkv, q_offset, causal ? 1 : 0,
         static_cast<float>(1.0 / sqrt(static_cast<double>(hd)))};
  cudaStream_t st = repro::as_stream(stream);
  return half ? dispatch<__half>(a, B, hd, st) : dispatch<__nv_bfloat16>(a, B, hd, st);
}
