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
// Design.  The fp32-FMA decode walk (decode_body.cuh `decode_group`, which
// flash_decode keeps for fp32 inputs: one block per (KV head, batch row)
// over the whole G = Hq / Hkv group, fp32 online softmax, 64-key tiles in
// 16-byte loads all issued before use), in either dtype, with only the
// address of each cached row changed: the block first copies the live
// prefix of its table row into shared memory, and each 16-byte load reads
// row tbl[kj / bs] * bs + kj % bs of the pool.  That works for any bs,
// including one that does not divide the 64-key tile (a tile then spans
// several blocks).  The TPU kernel's shape, one grid step per table slot
// with the table prefetched as a scalar (paged_decode_attention.py:57-66),
// is not kept: on Hopper a block loads its own indices.  In fp32 the kernel
// gives the same bits as flash_decode on the gathered cache (the same body
// in the same tile order); in bf16 flash_decode runs its split-KV
// tensor-core body (decode_split.cuh), and the two differ by rounding.
// Offsets are size_t: N * bs * Hkv * D exceeds 2^31 at realistic pool
// sizes.
//
// What bounds it on this card: as flash_decode, the bytes of K and V (each
// live key read once, ~2*G flops per byte), plus per-block latency at small
// batch: 8 rows with 2 KV heads are 16 blocks on 132 SMs, each walking its
// tiles one after another.  The fix is flash_decode's split-KV body
// (decode_split.cuh, which takes its key rows through the same kind of
// functor as PagedRows below), left for a later version.

#include "decode_body.cuh"

namespace {

constexpr int kThreads = repro::kDecodeThreads;
constexpr int kMaxG = repro::kDecodeMaxG;
// the most dynamic shared memory a block may use on sm_90
constexpr int kMaxSmem = 232448;

// Cached key kj of a row is row tbl[kj / bs] * bs + kj % bs of the
// (N * bs, Hkv, D) pool; tbl is the row's table in shared memory.
struct PagedRows {
  const int* tbl;
  int bs;
  __device__ __forceinline__ size_t operator()(int kj) const {
    return static_cast<size_t>(tbl[kj / bs]) * bs + kj % bs;
  }
};

template <int D>
constexpr int smem_bytes_fixed() {
  return repro::decode_smem_floats<D>() * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp, T* __restrict__ o,
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
  repro::decode_group<T, D>(q, kp, vp, o, b, blockIdx.x, Hq, Hkv, limit, end, scale,
                            PagedRows{sTbl, bs}, smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, void* o,
                   const int* block_table, const int* cache_len, int B, int M, int bs,
                   int Hq, int Hkv, cudaStream_t stream) {
  const int smem = smem_bytes_fixed<D>() + M * static_cast<int>(sizeof(int));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the opt-in is the card's most, not this launch's need, so that it is
  // one fixed value whatever the table's length
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const cudaError_t err =
      repro::allow_dynamic_smem(paged_flash_decode_kernel<T, D>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  paged_flash_decode_kernel<T, D><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<T*>(o), block_table, cache_len, M, bs, Hq, Hkv,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* kp, const void* vp, void* o,
                       const int* block_table, const int* cache_len, int B, int M, int bs,
                       int Hq, int Hkv, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, kp, vp, o, block_table, cache_len, B, M, bs, Hq, Hkv, stream);
    case 32: return launch<T, 32>(q, kp, vp, o, block_table, cache_len, B, M, bs, Hq, Hkv, stream);
    case 64: return launch<T, 64>(q, kp, vp, o, block_table, cache_len, B, M, bs, Hq, Hkv, stream);
    case 128: return launch<T, 128>(q, kp, vp, o, block_table, cache_len, B, M, bs, Hq, Hkv, stream);
    case 256: return launch<T, 256>(q, kp, vp, o, block_table, cache_len, B, M, bs, Hq, Hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int repro_paged_flash_decode(const void* q, const void* kp, const void* vp, void* o,
                                        const int* block_table, const int* cache_len, int B,
                                        int M, int bs, int Hq, int Hkv, int D, int is_bf16,
                                        void* stream) {
  if (B <= 0 || M <= 0 || bs <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dim<__nv_bfloat16>(q, kp, vp, o, block_table, cache_len, B, M, bs, Hq,
                                          Hkv, D, s)
              : launch_dim<float>(q, kp, vp, o, block_table, cache_len, B, M, bs, Hq, Hkv, D,
                                  s);
  return static_cast<int>(err);
}
