// Paged attention: online-softmax attention through a page table, over fp
// or int8 pools, with a causal or a speculation-tree window mask.
//
// Replaces: repro/kernels/paged_attn.py:paged_decode_attention_pallas, all
// four bodies of its _attend_page: _kernel (fp pools, causal), _kernel_quant
// (int8 pools with per-(slot, head) scales), _kernel_tree (the window's
// ancestor mask) and _kernel_quant_tree (both).  One template covers them:
// the pool type (f32, bf16, int8: int8 pools take scales) and the window
// mask, W bits per query row in ceil(W / 32) words (the tree mask's row, or
// bits 0..w for the causal window), so the causal and the tree bodies are
// one code path.
//
// Bound on this card: a call reads each valid K/V page of each (request,
// kv-head) once (int8 pools: one byte per value plus a 4-byte scale per slot
// and head) and does ~4*W*G*hd flops per cached token, about one flop per
// byte: bound by device-memory bytes.
//
// Design: the TPU walked pages in a sequential grid dimension and carried
// the running max / sum / accumulator in scratch between grid steps.  Here
// (csrc/flash_decode.cuh) a block of 4 warps per (kv head, request, group
// of up to 4 query rows, split) spreads the row's positions over its
// warps, each lane group holding its own softmax state in registers, and
// the partial states meet in a fixed order at the end (tables spanning
// more than 1024 positions: 8 warps and one query row a block).  Page ids
// are read per position from the table.  The main path's rows (<= 12
// pages) take one split, so a call is one launch with no workspace
// traffic; long rows split over blocks and the last block to arrive
// combines them (still one launch).  The block's rows of
// the W x W tree mask are read once into shared memory, ceil(W / 32) words
// a row; a row's validity is indexed, not built from one-hot products as
// on the TPU.
//
// The contract of the reference is kept (flash_decode.cuh lists it): the
// length mask decides validity, and a block walks only the positions below
// len unless some query row sees no position at all (causal: len < W; tree:
// an empty prefix and a mask row that marks no slot holding a position <
// len), when it walks every page, as the reference does.  The engine's idle
// tree slots (len == W, self-only masks) see their own slot and walk one
// page.
#include "flash_decode.cuh"

namespace {

namespace fd = repro::fd;

// One step count per pool type, and one warp count per walk length, for
// every window: a query row's bits then do not depend on W (flash_decode.cuh).
template <typename T> constexpr int kSteps = fd::Pool<T>::kU;
constexpr int kShortWalk = 1024;  // table spans of at most this many positions: 4 warps

template <typename T, int LPR, int RT, int NW>
__global__ void __launch_bounds__(NW * 32, fd::kMinBlocks) paged_attn_kernel(fd::Args a, int R) {
  fd::flash_decode<T, LPR, RT, kSteps<T>, NW>(a, R);
}

template <typename T, int LPR, int RT, int NW>
int run(const fd::Args& a, int B, int R, int splits, cudaStream_t st) {
  return fd::launch<LPR, RT, kSteps<T>, NW>(paged_attn_kernel<T, LPR, RT, NW>, a, B, R, splits,
                                            st);
}

// Long walks: 8 warps, one query row a block (more rows would not fit the
// register budget of 2 blocks per SM).  Short walks: 4 warps, 1, 3 or 4 rows.
template <typename T, int LPR>
int by_rows(const fd::Args& a, int B, int R, int splits, cudaStream_t st) {
  if (a.mp * a.ps > kShortWalk) return run<T, LPR, 1, 8>(a, B, R, splits, st);
  switch (fd::rows_per_block(R)) {
    case 1: return run<T, LPR, 1, 4>(a, B, R, splits, st);
    case 3: return run<T, LPR, 3, 4>(a, B, R, splits, st);
    default: return run<T, LPR, 4, 4>(a, B, R, splits, st);
  }
}

template <typename T>
int by_lanes(const fd::Args& a, int B, int R, int splits, cudaStream_t st) {
  switch (fd::lanes_per_row(a.hd)) {
    case 2: return by_rows<T, 2>(a, B, R, splits, st);
    case 4: return by_rows<T, 4>(a, B, R, splits, st);
    case 8: return by_rows<T, 8>(a, B, R, splits, st);
    default: return by_rows<T, 16>(a, B, R, splits, st);
  }
}

}  // namespace

// q (B, W, KVS, G, hd) of dtype `q_dtype` (f32 or bf16); k/v pools (P, ps,
// KVS, hd) of dtype `dtype` (f32, bf16, or int8 with k/v scales (P, ps,
// KVS, 1) f32, else null); tree mask (B, W, W) f32 or null (causal window);
// table (B, mp) int32 of in-range page ids; lengths (B,) int32 counting the
// window; out (B, W, KVS, G, hd) f32.  `splits` caps the blocks per (b, kv
// head) over the longest walk (mp * ps positions); above one, ws holds at
// least B * KVS * splits * W * G * (hd + 2) floats and counters B * KVS *
// W * G ints, zero before the first call (each call leaves them at zero).
// hd: a multiple of 8 in [16, 128]; any W >= 1.
extern "C" int repro_paged_attn(const void* q, const void* kp, const void* vp,
                                const float* ks, const float* vs, const float* tm,
                                const int* table, const int* lengths, float* out, float* ws,
                                int* counters, int B, int W, int KVS, int G, int hd, int ps,
                                int mp, int dtype, int q_dtype, int splits, void* stream) {
  const bool scaled = ks != nullptr;
  if (scaled != (vs != nullptr) || scaled != (dtype == repro::kI8) || hd % fd::kE != 0 ||
      hd < 16 || hd > 128 || W < 1 || G < 1 || ps < 1 || mp < 1 ||
      splits < 1 || (q_dtype != repro::kF32 && q_dtype != repro::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  fd::Args a{q, kp, vp, ks, vs, tm, table, lengths, out, ws, counters,
             W, KVS, G, hd, ps, mp, /*len_stride=*/1, q_dtype == repro::kBF16,
             /*split_pos=*/0, fd::pow2_shift(ps),
             static_cast<float>(fd::kLog2e / sqrt(static_cast<double>(hd)))};
  const int R = W * G;
  cudaStream_t st = repro::as_stream(stream);
  if (dtype == repro::kF32) return by_lanes<float>(a, B, R, splits, st);
  if (dtype == repro::kBF16) return by_lanes<__nv_bfloat16>(a, B, R, splits, st);
  if (dtype == repro::kI8) return by_lanes<int8_t>(a, B, R, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
