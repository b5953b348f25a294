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
// dimension, carrying m / l / acc in scratch (block_s, a TPU tiling
// parameter, is not used here).  The dense cache is the paged kernel's
// layout with one page of S positions per request and no table, and one
// length for every row, so the same split-sequence body runs it
// (csrc/flash_decode.cuh): B * KVS pairs do not fill the card, so the
// sequence splits over blocks (the caller's split count over S), each
// block's 8 warps walk their positions for one query row with the
// softmax state in registers, and the last block to arrive combines the
// splits in order.
// The walk stops at `length`, so the tail past it is never read and cannot
// change the output (a length of 0 walks the whole cache, every score
// masked, as the reference does).
#include "flash_decode.cuh"

namespace {

namespace fd = repro::fd;

constexpr int kWarps = 8;
constexpr int kSteps = 4;  // positions per lane group and warp iteration

// One query row a block: more would not fit the register budget of 2
// blocks per SM at 8 warps.
template <int LPR>
__global__ void __launch_bounds__(kWarps * 32, fd::kMinBlocks)
    decode_attn_int8_kernel(fd::Args a, int R) {
  fd::flash_decode<int8_t, LPR, 1, kSteps, kWarps>(a, R);
}

template <int LPR>
int run(const fd::Args& a, int B, int R, int splits, cudaStream_t st) {
  return fd::launch<LPR, 1, kSteps, kWarps>(decode_attn_int8_kernel<LPR>, a, B, R, splits, st);
}

}  // namespace

// q (B, KVS, G, hd) of dtype `q_dtype` (f32 or bf16); k/v caches (B, S,
// KVS, hd) int8; k/v scales (B, S, KVS) f32; length () int32 on the device;
// out (B, KVS, G, hd) f32.  `splits` caps the blocks per (b, kv head) over
// S; above one, ws holds at least B * KVS * splits * G * (hd + 2) floats
// and counters B * KVS * G ints, zero before the first call (each call
// leaves them at zero).  hd: a multiple of 8 in [16, 128].
extern "C" int repro_decode_attn_int8(const void* q, const int8_t* kc, const float* ks,
                                      const int8_t* vc, const float* vs, const int* length,
                                      float* out, float* ws, int* counters, int B, int S,
                                      int KVS, int G, int hd, int q_dtype, int splits,
                                      void* stream) {
  if (hd % fd::kE != 0 || hd < 16 || hd > 128 || G < 1 || S < 1 || splits < 1 ||
      (q_dtype != repro::kF32 && q_dtype != repro::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  // W = 1 (causal: position pos visible iff pos < length), page b of S
  // positions, the one length shared by every request
  fd::Args a{q, kc, vc, ks, vs, /*tm=*/nullptr, /*table=*/nullptr, length, out, ws, counters,
             /*W=*/1, KVS, G, hd, /*ps=*/S, /*mp=*/1, /*len_stride=*/0,
             q_dtype == repro::kBF16, /*split_pos=*/0, /*ps_shift=*/-1,
             static_cast<float>(fd::kLog2e / sqrt(static_cast<double>(hd)))};
  cudaStream_t st = repro::as_stream(stream);
  switch (fd::lanes_per_row(hd)) {
    case 2: return run<2>(a, B, G, splits, st);
    case 4: return run<4>(a, B, G, splits, st);
    case 8: return run<8>(a, B, G, splits, st);
    default: return run<16>(a, B, G, splits, st);
  }
}
