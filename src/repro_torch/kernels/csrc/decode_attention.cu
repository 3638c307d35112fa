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
// G = Hq / Hkv query heads (decode_attention.py:97 reshapes q the same way).
// G need not be a power of two (qwen2-0.5b has G = 7): every loop over the
// group stops at G, nothing is padded.  The block walks 64-key cache tiles
// only up to the row's valid length, keeping the online-softmax state
// (max, sum per head in shared memory; the G x D accumulator in registers,
// one column per thread) in fp32.  A row with no valid key (cache_len 0)
// walks all C slots with every key masked, which gives the plain version's
// uniform average.
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

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 64;
constexpr int kMaxG = 16;  // largest query-head group per KV head

template <int D>
constexpr int smem_bytes() {
  return (kMaxG * (D + 1) + 2 * kBlockK * (D + 1) + kMaxG * kBlockK + 3 * kMaxG) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, T* __restrict__ o,
                    const int* __restrict__ cache_len, int C, int Hq, int Hkv,
                    int cap, float scale) {
  constexpr int LD = D + 1;
  constexpr int kHeadStep = kThreads / D;  // heads handled side by side in P V
  constexpr int kAccPerThread = (kMaxG + kHeadStep - 1) / kHeadStep;
  constexpr int kScoreHeadStep = kThreads / kBlockK;  // heads side by side in Q K^T
  constexpr int kScoreHeads = kMaxG / kScoreHeadStep;
  constexpr int kVec = 16 / sizeof(T);                 // values per 16-byte load
  constexpr int kChunks = D / kVec;                    // 16-byte loads per cached row
  constexpr int kLoads = kBlockK * kChunks / kThreads;  // per thread, per tile, K and V each
  static_assert(kBlockK * kChunks % kThreads == 0, "tile loads must split evenly");
  extern __shared__ float smem[];
  float* sQ = smem;                      // kMaxG x LD
  float* sK = sQ + kMaxG * LD;           // kBlockK x LD
  float* sV = sK + kBlockK * LD;         // kBlockK x LD
  float* sP = sV + kBlockK * LD;         // kMaxG x kBlockK
  float* sM = sP + kMaxG * kBlockK;      // running max per head
  float* sL = sM + kMaxG;                // running sum per head
  float* sAlpha = sL + kMaxG;            // this tile's rescale per head

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const size_t q_base = (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G) * D;

  for (int i = tid; i < G * D; i += kThreads)
    sQ[(i / D) * LD + i % D] = repro::to_f32(q[q_base + i]);
  if (tid < G) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  const int limit = min(cache_len[b], cap);
  const int end = limit > 0 ? limit : C;  // no valid key: average all C slots

  const int d_own = tid % D;
  const int g_own = tid / D;
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.f;

  for (int k0 = 0; k0 < end; k0 += kBlockK) {
    __syncthreads();  // Q and the running state are set; the last tile is consumed
    // 16-byte loads, all issued before any is used
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * kVec, kj = k0 + r;
      float xk[kVec], xv[kVec];
      if (kj < end) {
        const size_t off = ((static_cast<size_t>(b) * C + kj) * Hkv + hk) * D + c;
        repro::load16_f32(kc + off, xk);
        repro::load16_f32(vc + off, xv);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) xk[e] = xv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sK[r * LD + c + e] = xk[e];
        sV[r * LD + c + e] = xv[e];
      }
    }
    __syncthreads();

    // scores: thread -> key tid % 64 for heads tid / 64 + 2m; each K element
    // is read from shared memory once per thread
    {
      const int j = tid % kBlockK, kj = k0 + j, g0 = tid / kBlockK;
      float sc[kScoreHeads];
#pragma unroll
      for (int m = 0; m < kScoreHeads; ++m) sc[m] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = sK[j * LD + d];
#pragma unroll
        for (int m = 0; m < kScoreHeads; ++m) {
          const int g = g0 + m * kScoreHeadStep;
          if (g < G) sc[m] = fmaf(sQ[g * LD + d], kd, sc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < kScoreHeads; ++m) {
        const int g = g0 + m * kScoreHeadStep;
        if (g >= G) continue;
        float a = sc[m] * scale;
        if (kj >= end) a = -INFINITY;                  // past the walked range: weight 0
        else if (kj >= limit) a = repro::kMaskedLogit;  // only when limit == 0
        sP[g * kBlockK + j] = a;
      }
    }
    __syncthreads();

    // online-softmax update: warp w owns heads w, w + 4, ...
    for (int g = warp; g < G; g += kThreads / 32) {
      const float x0 = sP[g * kBlockK + lane], x1 = sP[g * kBlockK + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mo = sM[g];
      const float mn = fmaxf(mo, mx);  // finite: key k0 < end is in range
      const float p0 = expf(x0 - mn), p1 = expf(x1 - mn);
      sP[g * kBlockK + lane] = p0;
      sP[g * kBlockK + lane + 32] = p1;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) {
        const float alpha = expf(mo - mn);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + rs;
        sM[g] = mn;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for column d_own of heads g_own + a * kHeadStep;
    // each V element is read from shared memory once per thread
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int g = g_own + a * kHeadStep;
      if (g < G) acc[a] *= sAlpha[g];
    }
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      const float vd = sV[j * LD + d_own];
#pragma unroll
      for (int a = 0; a < kAccPerThread; ++a) {
        const int g = g_own + a * kHeadStep;
        if (g < G) acc[a] = fmaf(sP[g * kBlockK + j], vd, acc[a]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int g = g_own + a * kHeadStep;
    if (g < G) repro::store_f32(o + q_base + static_cast<size_t>(g) * D + d_own, acc[a] / sL[g]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o,
                   const int* cache_len, int B, int C, int Hq, int Hkv, int cap,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static bool smem_allowed = false;  // one flag per instantiation
  if (!smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = true;
  }
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
