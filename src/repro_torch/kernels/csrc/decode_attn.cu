// Decode attention over a dense int8 KV cache: one token's online-softmax
// attention with the per-(token, head) scales folded in.
//
// Replaces: repro/kernels/decode_attn.py:decode_attention_int8_pallas (its
// _kernel).  The contract is the reference's: the K scale multiplies the
// int8 scores (q . k_int8) * ks, the V scale multiplies the softmax weights
// before they meet the int8 values, positions >= length are masked with
// -1e30, m starts at -1e30 and l is clamped at 1e-30.
//
// Bound on this card: a call reads the int8 cache of every (b, kv-head) up
// to `length` once (hd bytes per value row plus two 4-byte scales per
// position) and does ~4*G*hd operations per cached token: a few operations
// per byte, so it is bound by device-memory bytes.
//
// Design: the TPU walked the cache in block_s tiles along a sequential grid
// dimension, carrying m / l / acc in scratch.  Here one block per (b,
// kv-head) loops over the cache itself in tiles of kTile positions (the
// wrapper's block_s, a TPU tiling parameter, is not used): it stages the
// int8 K and V rows of a tile as floats in shared memory with their scales,
// scores the G query rows (one warp per score, lanes split hd, shuffle
// reduction), folds the K scale into the score, and updates the online
// softmax with the V scale folded into each weight.  The walk stops at
// `length`, so the tail past it is never read and cannot change the output
// (a length of 0 walks the whole cache, every score masked, as the
// reference does).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;

__global__ void __launch_bounds__(kThreads)
decode_attn_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                        const float* __restrict__ ks, const int8_t* __restrict__ vc,
                        const float* __restrict__ vs, const int* __restrict__ length_p,
                        float* __restrict__ out, int S, int KVS, int G, int hd, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  float* q_s = smem;              // [G][hd], pre-scaled
  float* acc_s = q_s + G * hd;    // [G][hd]
  float* k_s = acc_s + G * hd;    // [kTile][hd]
  float* v_s = k_s + kTile * hd;  // [kTile][hd]
  float* p_s = v_s + kTile * hd;  // [G][kTile] scores, then weights
  float* vsc_s = p_s + G * kTile; // [kTile] V scales of the tile
  float* m_s = vsc_s + kTile;     // [G] running max
  float* l_s = m_s + G;           // [G] running sum
  float* c_s = l_s + G;           // [G] this tile's correction
  const int length = *length_p;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
    q_s[e] = q[(((size_t)b * KVS + kvh) * G) * hd + e] * scale;
    acc_s[e] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_s[g] = -1e30f;
    l_s[g] = 0.f;
  }
  const int n = length > 0 ? min(length, S) : S;

  for (int base = 0; base < n; base += kTile) {
    const int t = min(kTile, n - base);
    __syncthreads();  // previous tile consumed; init visible on the first
    for (int e = threadIdx.x; e < t * hd; e += blockDim.x) {
      const int s = e / hd, d = e % hd;
      const size_t src = (((size_t)b * S + base + s) * KVS + kvh) * hd + d;
      k_s[e] = static_cast<float>(kc[src]);
      v_s[e] = static_cast<float>(vc[src]);
    }
    for (int s = threadIdx.x; s < t; s += blockDim.x)
      vsc_s[s] = vs[((size_t)b * S + base + s) * KVS + kvh];
    __syncthreads();
    for (int e = warp; e < G * t; e += kWarps) {
      const int g = e / t, s = e % t;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += q_s[g * hd + d] * k_s[s * hd + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const int pos = base + s;
        const float sc = dot * ks[((size_t)b * S + pos) * KVS + kvh];
        p_s[g * kTile + s] = pos < length ? sc : -1e30f;
      }
    }
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float* row = p_s + g * kTile;
      float mx = row[0];
      for (int s = 1; s < t; ++s) mx = fmaxf(mx, row[s]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = 0; s < t; ++s) {
        const float pr = expf(row[s] - m_new);
        sum += pr;
        row[s] = pr * vsc_s[s];  // fold the V scale into the weight
      }
      const float corr = expf(m_prev - m_new);
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
      c_s[g] = corr;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
      const int g = e / hd, d = e % hd;
      const float* pr = p_s + g * kTile;
      float pv = 0.f;
      for (int s = 0; s < t; ++s) pv += pr[s] * v_s[s * hd + d];
      acc_s[e] = acc_s[e] * c_s[g] + pv;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
    const int g = e / hd;
    out[(((size_t)b * KVS + kvh) * G) * hd + e] = acc_s[e] / fmaxf(l_s[g], 1e-30f);
  }
}

}  // namespace

// q (B, KVS, G, hd) f32; k/v caches (B, S, KVS, hd) int8; k/v scales (B, S,
// KVS) f32; length () int32 on the device; out (B, KVS, G, hd) f32.
extern "C" int repro_decode_attn_int8(const float* q, const int8_t* kc, const float* ks,
                                      const int8_t* vc, const float* vs, const int* length,
                                      float* out, int B, int S, int KVS, int G, int hd,
                                      void* stream) {
  const size_t smem =
      ((size_t)2 * G * hd + (size_t)2 * kTile * hd + (size_t)G * kTile + kTile + 3 * G) *
      sizeof(float);
  cudaError_t err = repro::allow_smem(decode_attn_int8_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  dim3 grid(KVS, B);
  decode_attn_int8_kernel<<<grid, kThreads, smem, repro::as_stream(stream)>>>(
      q, kc, ks, vc, vs, length, out, S, KVS, G, hd, scale);
  return static_cast<int>(cudaGetLastError());
}
