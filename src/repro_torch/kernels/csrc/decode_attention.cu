// Flash decode: one-token GQA attention over a linear or ring KV cache, for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// `flash_decode` (:82; shared body `online_softmax_step`, :28).  Same
// function as the plain version `decode_mha_ref` in kernels/ref.py.
//
// Layouts: q (B, Hq, D), caches (B, C, Hkv, D), out (B, Hq, D), contiguous,
// fp32 or bf16; cache_len (B,) int32, the tokens written so far.  Keys at
// slots >= min(cache_len[b], min(C, window)) are masked (ring caches keep
// only in-window tokens, decode_attention.py:98-100).
//
// Design.  bf16 runs a split-KV grid (Hkv, B, splits): each block walks
// whole 64-key tiles of its share of [0, end) with decode_split.cuh's
// `decode_split` (G <= 16 query heads as the 16 rows of mma.sync m16n8k16;
// K and V bf16 in shared memory by cp.async; P V through P's two bf16
// terms) and writes an unnormalised fp32 partial (m in log2 units, l, the
// G x D accumulator) per query head to a scratch that the wrapper
// allocates; a split that starts past its row's end writes an empty one (m
// = -inf, l = 0).  The row's tiles go to the splits in order, ceil(tiles /
// splits) each.  A second launch, grid (Hq, B), merges each head's splits
// in split order (log-sum-exp: weights 2^(m_s - M), then divide by the
// merged l, then store in bf16), so the result is deterministic.  Both
// launches live in decode_split.cuh, which paged_decode_attention.cu runs
// with its block-table rows.  `splits` comes from the host, from shapes
// alone (B, Hkv, min(C, window) and the card's SM count:
// kernels/decode_attention.py `decode_splits`), never from cache_len.
// fp32 inputs keep the first design, one block per (KV head, batch row)
// walking decode_body.cuh's `decode_group` (fp32 FMAs; neither bf16 nor
// TF32 products hold fp32's tolerance).
//
// return_lse (a rank's partial over its block of a cache split by slot,
// which the ranks then merge by log-sum-exp): the merge launch, a template
// instance of its own (kLse), stores the fp32 row instead of the bf16 one
// and the row's log-sum-exp (M + log2 l) ln 2 from the m and l it already
// holds; the fp32 body stores m + ln l.  A row with no valid key (a rank
// whose slots are all still empty) walks nothing and comes back 0 with lse
// -inf, weight 0 in the merge.  Without lse both launches and the fp32 body
// run the instructions they ran before, so flash_decode and
// paged_flash_decode keep their bits.
//
// What bounds it on this card: each cached key and value is read once and
// used by G heads, ~2*G flops per byte, so device-memory bandwidth.  One
// block per (row, KV head) filled 8 of 132 SMs at recurrentgemma-9b's
// decode (B 8, Hkv 1) and each block walked its up to 17 tiles one after
// another; the split grid puts ~2 blocks per SM in flight, each with its
// first tile's K and V loads issued together.  The partials (G x D fp32
// per split) stay in L2 for the merge.

#include "decode_body.cuh"
#include "decode_split.cuh"

namespace {

constexpr int kThreads = repro::kDecodeThreads;
constexpr int kMaxG = repro::kDecodeMaxG;

// Cached key kj of batch row b is row b * C + kj of the (B * C, Hkv, D) cache.
struct LinearRows {
  size_t base;
  __device__ __forceinline__ size_t operator()(int kj) const { return base + kj; }
};

// fp32: one block per (KV head, batch row); lse (B, Hq) or null.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                    const float* __restrict__ vc, float* __restrict__ o,
                    const int* __restrict__ cache_len, int C, int Hq, int Hkv,
                    int cap, float scale, float* __restrict__ lse) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int limit = min(cache_len[b], cap);
  // no valid key: average all C slots, or with lse walk none
  const int end = limit > 0 ? limit : (lse != nullptr ? 0 : C);
  repro::decode_group<float, D>(q, kc, vc, o, b, blockIdx.x, Hq, Hkv, limit, end, scale,
                                LinearRows{static_cast<size_t>(b) * C}, smem, lse);
}

// The rows of batch row b: b * C + kj.
struct LinearRowsOf {
  int C;
  __device__ LinearRows operator()(int b) const { return LinearRows{static_cast<size_t>(b) * C}; }
};

template <int D>
cudaError_t launch_fp32(const void* q, const void* kc, const void* vc, void* o,
                        const int* cache_len, float* lse, int B, int C, int Hq, int Hkv,
                        int cap, cudaStream_t stream) {
  constexpr int smem = repro::decode_smem_floats<D>() * 4;
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const cudaError_t err = repro::allow_dynamic_smem(flash_decode_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<D><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<float*>(o), cache_len, C, Hq, Hkv, cap,
      1.0f / sqrtf(static_cast<float>(D)), lse);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o,
                   const int* cache_len, float* part, float* lse, int B, int C, int Hq,
                   int Hkv, int cap, int splits, int is_bf16, cudaStream_t stream) {
  if (is_bf16 && lse != nullptr)
    return repro::launch_decode_split<D, LinearRowsOf, true>(
        q, kc, vc, o, cache_len, part, B, C, Hq, Hkv, cap, splits, LinearRowsOf{C}, stream,
        lse);
  if (is_bf16)
    return repro::launch_decode_split<D>(q, kc, vc, o, cache_len, part, B, C, Hq, Hkv, cap,
                                         splits, LinearRowsOf{C}, stream);
  return launch_fp32<D>(q, kc, vc, o, cache_len, lse, B, C, Hq, Hkv, cap, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  cap = min(C, window), or C
// without a window.  bf16 takes `splits` >= 1 blocks per (row, KV head) and
// part, a (B * Hq * splits * (D + 2),) fp32 scratch; fp32 ignores both.
// lse null: o in q's dtype.  lse a (B, Hq) fp32 buffer (return_lse): o is
// fp32 whatever q's dtype, lse the rows' natural-log log-sum-exp, and a row
// with no valid key gives o = 0 and lse = -inf instead of the average.
// Returns the cudaError_t of the launches.
extern "C" int repro_flash_decode(const void* q, const void* kc, const void* vc, void* o,
                                  const int* cache_len, float* part, float* lse, int B, int C,
                                  int Hq, int Hkv, int D, int cap, int splits, int is_bf16,
                                  void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || C <= 0 || cap <= 0 || cap > C ||
      splits < 1 || (is_bf16 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define REPRO_CASE(d)                                                                      \
  case d:                                                                                  \
    return static_cast<int>(                                                               \
        launch<d>(q, kc, vc, o, cache_len, part, lse, B, C, Hq, Hkv, cap, splits, is_bf16,  \
                  s));
    REPRO_CASE(16) REPRO_CASE(32) REPRO_CASE(64) REPRO_CASE(128) REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, spill bytes, dynamic shared memory and resident blocks per SM
// of the bf16 split kernel at head_dim D (out: 4 ints).
extern "C" int repro_flash_decode_bf16_info(int D, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
#define REPRO_INFO(d)                                                                      \
  case d:                                                                                  \
    err = repro::decode_split_info<d, LinearRowsOf>(out);                                  \
    break;
    REPRO_INFO(16) REPRO_INFO(32) REPRO_INFO(64) REPRO_INFO(128) REPRO_INFO(256)
#undef REPRO_INFO
  }
  return static_cast<int>(err);
}
