// The fp32-FMA decode body: the whole of paged_decode_attention.cu (over a
// block pool) and the fp32 path of decode_attention.cu (over a linear or
// ring cache; its bf16 path is decode_split.cuh's split-KV body).  One
// block's walk over the cached keys of one (batch row, KV head) for the
// whole group of G = Hq / Hkv query heads, in 64-key tiles, with an fp32
// online softmax.  The two kernels differ only in where cached key kj of the
// row lives, which the `rows` functor gives: element c of head hk of key kj
// is at ((rows(kj) * Hkv + hk) * D + c).
//
// G need not be a power of two (qwen2-0.5b has G = 7): every loop over the
// group stops at G, nothing is padded.  Keys kj < limit are valid; the walk
// covers [0, end), where end == limit unless limit == 0, in which case the
// caller passes the row's full capacity and every key is masked with the
// finite kMaskedLogit, giving the plain version's uniform average (with
// `lse`, flash_decode's fp32 return_lse path, the caller passes end 0
// instead, and the row comes back 0 with lse -inf).  Each
// tile arrives in 16-byte loads, issued in groups of at most 128 values per
// thread (all of them up to D = 128) before any of the group is used, and
// each thread reads every shared K/V element once for all the heads it
// serves.  Up to D = kDecodeThreads a thread owns one accumulator column of
// kDecodeThreads / D heads side by side; past it (D = 256) a thread owns
// D / kDecodeThreads columns of every head.
#pragma once

#include <math.h>

#include "common.cuh"

namespace repro {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeBlockK = 64;
constexpr int kDecodeMaxG = 16;  // largest query-head group per KV head

// fp32 words of shared memory decode_group uses for head dim D
template <int D>
__host__ __device__ constexpr int decode_smem_floats() {
  return kDecodeMaxG * (D + 1) + 2 * kDecodeBlockK * (D + 1) + kDecodeMaxG * kDecodeBlockK +
         3 * kDecodeMaxG;
}

template <typename T, int D, typename Rows>
__device__ __forceinline__ void decode_group(const T* __restrict__ q, const T* __restrict__ kc,
                                             const T* __restrict__ vc, T* __restrict__ o,
                                             int b, int hk, int Hq, int Hkv, int limit, int end,
                                             float scale, const Rows& rows, float* smem,
                                             float* __restrict__ lse = nullptr) {
  constexpr int kThreads = kDecodeThreads;
  constexpr int kBlockK = kDecodeBlockK;
  constexpr int kMaxG = kDecodeMaxG;
  constexpr int LD = D + 1;
  constexpr int kColStep = D < kThreads ? D : kThreads;  // columns side by side in P V
  constexpr int kCols = D / kColStep;                    // columns per thread
  constexpr int kHeadStep = kThreads / kColStep;         // heads side by side in P V
  constexpr int kAccPerThread = (kMaxG + kHeadStep - 1) / kHeadStep;
  constexpr int kScoreHeadStep = kThreads / kBlockK;  // heads side by side in Q K^T
  constexpr int kScoreHeads = kMaxG / kScoreHeadStep;
  constexpr int kVec = 16 / sizeof(T);                 // values per 16-byte load
  constexpr int kChunks = D / kVec;                    // 16-byte loads per cached row
  constexpr int kLoads = kBlockK * kChunks / kThreads;  // per thread, per tile, K and V each
  constexpr int kLoadGroup = kLoads < 64 / kVec ? kLoads : 64 / kVec;  // 2 * 64 values in flight
  static_assert(kBlockK * kChunks % kThreads == 0, "tile loads must split evenly");
  static_assert(kLoads % kLoadGroup == 0, "load groups must split evenly");
  float* sQ = smem;                      // kMaxG x LD
  float* sK = sQ + kMaxG * LD;           // kBlockK x LD
  float* sV = sK + kBlockK * LD;         // kBlockK x LD
  float* sP = sV + kBlockK * LD;         // kMaxG x kBlockK
  float* sM = sP + kMaxG * kBlockK;      // running max per head
  float* sL = sM + kMaxG;                // running sum per head
  float* sAlpha = sL + kMaxG;            // this tile's rescale per head

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int G = Hq / Hkv;
  const size_t q_base = (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G) * D;

  for (int i = tid; i < G * D; i += kThreads)
    sQ[(i / D) * LD + i % D] = to_f32(q[q_base + i]);
  if (tid < G) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  const int d_own = tid % kColStep;
  const int g_own = tid / kColStep;
  float acc[kAccPerThread][kCols];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < end; k0 += kBlockK) {
    // Q, the running state and whatever the caller put in shared memory
    // before this call are set; the last tile is consumed
    __syncthreads();
    // 16-byte loads, each group issued before any of it is used
#pragma unroll 1
    for (int l0 = 0; l0 < kLoads; l0 += kLoadGroup) {
#pragma unroll
      for (int l = l0; l < l0 + kLoadGroup; ++l) {
        const int i = tid + l * kThreads;
        const int r = i / kChunks, c = (i % kChunks) * kVec, kj = k0 + r;
        float xk[kVec], xv[kVec];
        if (kj < end) {
          const size_t off = (rows(kj) * Hkv + hk) * D + c;
          load16_f32(kc + off, xk);
          load16_f32(vc + off, xv);
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
        if (kj >= end) a = -INFINITY;             // past the walked range: weight 0
        else if (kj >= limit) a = kMaskedLogit;   // only when limit == 0
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

    // acc = acc * alpha + P V for columns d_own + c * kColStep of heads
    // g_own + a * kHeadStep; each V element is read from shared memory once
    // per thread
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int g = g_own + a * kHeadStep;
      if (g < G) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] *= sAlpha[g];
      }
    }
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      float vd[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vd[c] = sV[j * LD + d_own + c * kColStep];
#pragma unroll
      for (int a = 0; a < kAccPerThread; ++a) {
        const int g = g_own + a * kHeadStep;
        if (g < G) {
          const float pj = sP[g * kBlockK + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[a][c] = fmaf(pj, vd[c], acc[a][c]);
        }
      }
    }
  }
  __syncthreads();

  // with lse (flash_decode's return_lse; the caller passes end 0 for a row
  // with no valid key, which walks nothing): head g's natural-log
  // log-sum-exp m + ln l, and for an empty row o = 0 and lse = -inf
  if (lse != nullptr && tid < G)
    lse[q_base / D + tid] = sL[tid] > 0.f ? sM[tid] + logf(sL[tid]) : -INFINITY;
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int g = g_own + a * kHeadStep;
    if (g < G) {
      const bool none = lse != nullptr && sL[g] == 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        store_f32(o + q_base + static_cast<size_t>(g) * D + d_own + c * kColStep,
                  none ? 0.f : acc[a][c] / sL[g]);
    }
  }
}

}  // namespace repro
