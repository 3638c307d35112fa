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
// Design.  One block per (KV head, batch row), covering the whole group of
// G = Hq / Hkv query heads (decode_attention.py:97 reshapes q the same way);
// the block's walk is decode_body.cuh's `decode_group`, shared with the
// paged kernel.  The block walks 64-key cache tiles only up to the row's
// valid length, keeping the online-softmax state (max, sum per head in
// shared memory; the G x D accumulator in registers, one column per thread,
// two at D = 256) in fp32.  A row with no valid key (cache_len 0) walks all C slots with
// every key masked, which gives the plain version's uniform average.
//
// What bounds it on this card: each cached key and value is read once and
// used by G heads, ~2*G flops per byte, so device-memory bandwidth.  With
// one block per (row, KV head) a batch of 8 rows with 2 KV heads fills only
// 16 of the 132 SMs, and a block works through its tiles one after another
// (load, then scores, then softmax, then P V), so this kernel is bound by
// per-block latency at small batch, not by the card.  What the design does
// about it: each tile arrives in 16-byte loads all issued before any is
// used, and each thread reads every shared K/V element once for all the
// heads it serves.  A split-KV grid with a second combining pass (and
// overlapping the next tile's loads with this tile's math) is the fix for
// the idle SMs, left for a later version.

#include "decode_body.cuh"

namespace {

constexpr int kThreads = repro::kDecodeThreads;
constexpr int kMaxG = repro::kDecodeMaxG;

// Cached key kj of batch row b is row b * C + kj of the (B * C, Hkv, D) cache.
struct LinearRows {
  size_t base;
  __device__ __forceinline__ size_t operator()(int kj) const { return base + kj; }
};

template <int D>
constexpr int smem_bytes() {
  return repro::decode_smem_floats<D>() * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, T* __restrict__ o,
                    const int* __restrict__ cache_len, int C, int Hq, int Hkv,
                    int cap, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int limit = min(cache_len[b], cap);
  const int end = limit > 0 ? limit : C;  // no valid key: average all C slots
  repro::decode_group<T, D>(q, kc, vc, o, b, blockIdx.x, Hq, Hkv, limit, end, scale,
                            LinearRows{static_cast<size_t>(b) * C}, smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o,
                   const int* cache_len, int B, int C, int Hq, int Hkv, int cap,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  const cudaError_t err = repro::allow_dynamic_smem(flash_decode_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<T, D><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(o), cache_len, C, Hq, Hkv, cap, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* kc, const void* vc, void* o,
                       const int* cache_len, int B, int C, int Hq, int Hkv, int D,
                       int cap, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, kc, vc, o, cache_len, B, C, Hq, Hkv, cap, stream);
    case 32: return launch<T, 32>(q, kc, vc, o, cache_len, B, C, Hq, Hkv, cap, stream);
    case 64: return launch<T, 64>(q, kc, vc, o, cache_len, B, C, Hq, Hkv, cap, stream);
    case 128: return launch<T, 128>(q, kc, vc, o, cache_len, B, C, Hq, Hkv, cap, stream);
    case 256: return launch<T, 256>(q, kc, vc, o, cache_len, B, C, Hq, Hkv, cap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  cap = min(C, window), or C
// without a window.  Returns the cudaError_t of the launch.
extern "C" int repro_flash_decode(const void* q, const void* kc, const void* vc, void* o,
                                  const int* cache_len, int B, int C, int Hq, int Hkv,
                                  int D, int cap, int is_bf16, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || C <= 0 || cap <= 0 || cap > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dim<__nv_bfloat16>(q, kc, vc, o, cache_len, B, C, Hq, Hkv, D, cap, s)
              : launch_dim<float>(q, kc, vc, o, cache_len, B, C, Hq, Hkv, D, cap, s);
  return static_cast<int>(err);
}
