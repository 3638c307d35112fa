// Paged flash decode: one-token GQA attention over a block-pool KV cache,
// for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode_attention.py
// `paged_flash_decode` (:43, pallas_call :75).  Same function as the plain
// version `paged_decode_mha_ref` in kernels/ref.py.
//
// Layouts: q (B, Hq, D), pools (N, bs, Hkv, D), out (B, Hq, D), contiguous,
// fp32 or bf16; block_table (B, M) int32 of physical block ids in [0, N);
// cache_len (B,) int32, the tokens written so far.  Logical key p of row b
// lives at pool[block_table[b, p / bs], p % bs].  Keys at p >= cache_len[b]
// are masked, so table entries past the live prefix (conventionally the
// scratch block 0) never reach the result; a row with cache_len 0 averages
// all M * bs slots, as the plain version does.
//
// Design.  bf16 runs flash_decode's split-KV grid (decode_split.cuh:
// `decode_split` over whole 64-key tiles, grid (Hkv, B, splits), then the
// merge launch in split order), with only the address of each cached row
// changed: the `PagedRows` functor maps key kj of row b to pool row
// tbl[kj / bs] * bs + kj % bs, reading the table entry from global memory
// when the tile's loads are issued, so a block reads only the entries its
// tiles span (at most 64 / bs + 1 a tile).  That works for any bs,
// including one that does not divide the 64-key tile (a tile then spans
// several blocks) and bs > 64.  `splits` comes from shapes alone
// (kernels/decode_attention.py `decode_splits(B, Hkv, M * bs, SMs)`),
// never from cache_len, and the wrapper allocates the partials.  So where
// M * bs == C, every live tile goes to the same split as in flash_decode
// on the gathered (B, C, Hkv, D) cache, with the same key values: the two
// give the same bits.  fp32 inputs keep the first design: one block per
// (KV head, batch row) walks the whole live prefix with decode_body.cuh's
// fp32-FMA `decode_group` (as flash_decode does in fp32, so again the same
// bits), after copying its table row's live prefix into shared memory.
// The TPU kernel's shape, one grid step per table slot with the table
// prefetched as a scalar (paged_decode_attention.py:57-66), is not kept:
// on Hopper a block loads its own indices.  Offsets are size_t: N * bs *
// Hkv * D exceeds 2^31 at realistic pool sizes.
//
// What bounds it on this card: as flash_decode, the bytes of K and V (each
// live key read once, ~2*G flops per byte).  The first design ran one
// block per (row, KV head) whatever the dtype: 16 blocks on 132 SMs at
// qwen2-0.5b's 8 slots, each walking its tiles one after another; the
// split grid puts ~2 blocks per SM in flight.

#include "decode_body.cuh"
#include "decode_split.cuh"

namespace {

constexpr int kThreads = repro::kDecodeThreads;
constexpr int kMaxG = repro::kDecodeMaxG;
// the most dynamic shared memory a block may use on sm_90
constexpr int kMaxSmem = 232448;

// Cached key kj of a row is row tbl[kj / bs] * bs + kj % bs of the
// (N * bs, Hkv, D) pool; tbl is the row's table (in shared memory for fp32,
// in global memory for bf16).
struct PagedRows {
  const int* tbl;
  int bs;
  __device__ __forceinline__ size_t operator()(int kj) const {
    return static_cast<size_t>(tbl[kj / bs]) * bs + kj % bs;
  }
};

// The rows of batch row b: through row b of the (B, M) table.
struct PagedRowsOf {
  const int* table;
  int M, bs;
  __device__ PagedRows operator()(int b) const {
    return PagedRows{table + static_cast<size_t>(b) * M, bs};
  }
};

template <int D>
constexpr int smem_bytes_fixed() {
  return repro::decode_smem_floats<D>() * 4;
}

// fp32: one block per (KV head, batch row).
template <int D>
__global__ void __launch_bounds__(kThreads)
paged_flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                          const float* __restrict__ vp, float* __restrict__ o,
                          const int* __restrict__ block_table,
                          const int* __restrict__ cache_len, int M, int bs, int Hq,
                          int Hkv, float scale) {
  extern __shared__ float smem[];
  int* sTbl = reinterpret_cast<int*>(smem + repro::decode_smem_floats<D>());
  const int b = blockIdx.y;
  const int C = M * bs;
  const int limit = min(cache_len[b], C);
  const int end = limit > 0 ? limit : C;  // no valid key: average all M * bs slots
  const int n_tbl = (end + bs - 1) / bs;  // table entries the walk reads
  const int* row = block_table + static_cast<size_t>(b) * M;
  for (int i = threadIdx.x; i < n_tbl; i += kThreads) sTbl[i] = row[i];
  // decode_group's barrier at the top of its first tile orders these
  // writes before any load that reads them
  repro::decode_group<float, D>(q, kp, vp, o, b, blockIdx.x, Hq, Hkv, limit, end, scale,
                                PagedRows{sTbl, bs}, smem);
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* kp, const void* vp, void* o,
                        const int* block_table, const int* cache_len, int B, int M, int bs,
                        int Hq, int Hkv, cudaStream_t stream) {
  const int smem = smem_bytes_fixed<D>() + M * static_cast<int>(sizeof(int));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the opt-in is the card's most, not this launch's need, so that it is
  // one fixed value whatever the table's length
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const cudaError_t err =
      repro::allow_dynamic_smem(paged_flash_decode_kernel<D>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  paged_flash_decode_kernel<D><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), static_cast<float*>(o), block_table, cache_len, M, bs, Hq,
      Hkv, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, void* o,
                   const int* block_table, const int* cache_len, float* part, int B, int M,
                   int bs, int Hq, int Hkv, int splits, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return repro::launch_decode_split<D>(q, kp, vp, o, cache_len, part, B, M * bs, Hq, Hkv,
                                         M * bs, splits, PagedRowsOf{block_table, M, bs},
                                         stream);
  return launch_fp32<D>(q, kp, vp, o, block_table, cache_len, B, M, bs, Hq, Hkv, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  bf16 takes `splits` >= 1
// blocks per (row, KV head) and part, a (B * Hq * splits * (D + 2),) fp32
// scratch; fp32 ignores both.  Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int repro_paged_flash_decode(const void* q, const void* kp, const void* vp, void* o,
                                        const int* block_table, const int* cache_len,
                                        float* part, int B, int M, int bs, int Hq, int Hkv,
                                        int D, int splits, int is_bf16, void* stream) {
  if (B <= 0 || M <= 0 || bs <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG ||
      static_cast<long long>(M) * bs >= (1ll << 31) || splits < 1 ||
      (is_bf16 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define REPRO_CASE(d)                                                                      \
  case d:                                                                                  \
    return static_cast<int>(launch<d>(q, kp, vp, o, block_table, cache_len, part, B, M, bs, \
                                      Hq, Hkv, splits, is_bf16, s));
    REPRO_CASE(16) REPRO_CASE(32) REPRO_CASE(64) REPRO_CASE(128) REPRO_CASE(256)
#undef REPRO_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, spill bytes, dynamic shared memory and resident blocks per SM
// of the bf16 split kernel at head_dim D (out: 4 ints).
extern "C" int repro_paged_flash_decode_bf16_info(int D, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
#define REPRO_INFO(d)                                                                      \
  case d:                                                                                  \
    err = repro::decode_split_info<d, PagedRowsOf>(out);                                   \
    break;
    REPRO_INFO(16) REPRO_INFO(32) REPRO_INFO(64) REPRO_INFO(128) REPRO_INFO(256)
#undef REPRO_INFO
  }
  return static_cast<int>(err);
}
