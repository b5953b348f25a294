// Paged attention over fp pools: online-softmax attention through a page table.
//
// Replaces: repro/kernels/paged_attn.py:paged_decode_attention_pallas, the
// fp-pool body _kernel via _attend_page (the int8 _kernel_quant and the
// tree-masked bodies are not ported yet).
//
// Bound on this card: a call reads each valid K/V page of each (request,
// kv-head) once and does ~4*W*G*hd flops per cached token, about one flop
// per byte for W = 1: bound by device-memory bytes.
//
// Design: the TPU walked pages in a sequential grid dimension and carried
// the running max / sum / accumulator in scratch between grid steps.  Hopper
// blocks run in no order, so one block per (request b, kv-head) walks that
// request's page-table row itself: it reads the page ids from the table,
// stages one page of K and V (ps x hd, converted to float) in shared memory,
// scores all W*G query rows against it (one warp per score, lanes split hd,
// shuffle reduction), and runs the online softmax with the row statistics
// and the accumulator in shared memory.  The contract of the reference is
// kept: the length mask, not the table, decides validity (query w of a
// W-token window sees positions <= len - W + w); any in-range id may sit in
// an unused table slot; m starts at -1e30 and l is clamped at 1e-30, so a
// row with no visible position still gives finite output.  The block walks
// only the pages that hold valid positions, which is exact: past them
// every score is masked and adds exp(-1e30 - m) == 0.  When some query row
// sees nothing at all (len < W) it walks every page, as the reference does,
// so even that garbage row matches it.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                  const int* __restrict__ table, const int* __restrict__ lengths,
                  float* __restrict__ out, int W, int KVS, int G, int hd, int ps, int mp,
                  float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int R = W * G;  // query rows of this kv head, (w, g) w-major
  float* q_s = smem;              // [R][hd], pre-scaled
  float* acc_s = q_s + R * hd;    // [R][hd]
  float* k_s = acc_s + R * hd;    // [ps][hd]
  float* v_s = k_s + ps * hd;     // [ps][hd]
  float* p_s = v_s + ps * hd;     // [R][ps] scores, then probabilities
  float* m_s = p_s + R * ps;      // [R] running max
  float* l_s = m_s + R;           // [R] running sum
  float* c_s = l_s + R;           // [R] this page's correction
  const int len = lengths[b];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd;
    const int w = r / G, g = r % G;
    q_s[e] = q[((((size_t)b * W + w) * KVS + kvh) * G + g) * hd + d] * scale;
    acc_s[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = -1e30f;
    l_s[r] = 0.f;
  }
  const int n_walk = len >= W ? min(mp, (len + ps - 1) / ps) : mp;

  for (int p = 0; p < n_walk; ++p) {
    __syncthreads();  // previous page consumed; init visible on p == 0
    const size_t page = (size_t)table[(size_t)b * mp + p];
    for (int e = threadIdx.x; e < ps * hd; e += blockDim.x) {
      const int s = e / hd, d = e % hd;
      const size_t src = ((page * ps + s) * KVS + kvh) * hd + d;
      k_s[e] = repro::to_float(kp[src]);
      v_s[e] = repro::to_float(vp[src]);
    }
    __syncthreads();
    for (int e = warp; e < R * ps; e += kWarps) {
      const int r = e / ps, s = e % ps;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += q_s[r * hd + d] * k_s[s * hd + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const int pos = p * ps + s;
        p_s[e] = pos <= len - W + r / G ? dot : -1e30f;
      }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float* row = p_s + r * ps;
      float mx = row[0];
      for (int s = 1; s < ps; ++s) mx = fmaxf(mx, row[s]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = 0; s < ps; ++s) {
        const float pr = expf(row[s] - m_new);
        row[s] = pr;
        sum += pr;
      }
      const float corr = expf(m_prev - m_new);
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
      const int r = e / hd, d = e % hd;
      const float* pr = p_s + r * ps;
      float pv = 0.f;
      for (int s = 0; s < ps; ++s) pv += pr[s] * v_s[s * hd + d];
      acc_s[e] = acc_s[e] * c_s[r] + pv;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd;
    const int w = r / G, g = r % G;
    out[((((size_t)b * W + w) * KVS + kvh) * G + g) * hd + d] = acc_s[e] / fmaxf(l_s[r], 1e-30f);
  }
}

template <typename T>
int launch(const float* q, const void* kp, const void* vp, const int* table,
           const int* lengths, float* out, int B, int W, int KVS, int G, int hd, int ps,
           int mp, cudaStream_t st) {
  const int R = W * G;
  const size_t smem = ((size_t)2 * R * hd + (size_t)2 * ps * hd + (size_t)R * ps + 3 * R) *
                      sizeof(float);
  cudaError_t err = repro::allow_smem(paged_attn_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  dim3 grid(KVS, B);
  paged_attn_kernel<T><<<grid, kThreads, smem, st>>>(q, static_cast<const T*>(kp),
                                                     static_cast<const T*>(vp), table, lengths,
                                                     out, W, KVS, G, hd, ps, mp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, W, KVS, G, hd) f32; k/v pools (P, ps, KVS, hd) of dtype `dtype`;
// table (B, mp) int32 of in-range page ids; lengths (B,) int32 counting the
// window; out (B, W, KVS, G, hd) f32.
extern "C" int repro_paged_attn(const float* q, const void* kp, const void* vp,
                                const int* table, const int* lengths, float* out, int B,
                                int W, int KVS, int G, int hd, int ps, int mp, int dtype,
                                void* stream) {
  cudaStream_t st = repro::as_stream(stream);
  if (dtype == repro::kF32)
    return launch<float>(q, kp, vp, table, lengths, out, B, W, KVS, G, hd, ps, mp, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(q, kp, vp, table, lengths, out, B, W, KVS, G, hd, ps, mp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
