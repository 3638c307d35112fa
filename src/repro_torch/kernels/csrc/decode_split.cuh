// The bf16 split-KV body of flash decode (decode_attention.cu): one
// block's walk over whole 64-key tiles [k_begin, k_end) of one (batch row,
// KV head) for the whole group of G = Hq / Hkv <= 16 query heads, with both
// products on mma.sync m16n8k16 (bf16 -> fp32).  As decode_body.cuh's
// `decode_group`, the kernel says where cached key kj of the row lives
// through the `rows` functor (element c of head hk of key kj is at
// ((rows(kj) * Hkv + hk) * D + c)), so the paged kernel can take the same
// body.
//
// Semantics (as kernels/ref.py `decode_mha_ref`): keys kj < limit are
// valid; the row's walk covers [0, end), where end == limit unless limit ==
// 0, in which case the caller passes the row's full capacity and every key
// gets the finite kMaskedLogit (the plain version's uniform average); keys
// at or past end weigh 0.  A split's tiles start below end, so its running
// max is finite after its first tile.
//
// Design.  128 threads (4 warps).  The G query heads are the 16 rows of
// the A operand (rows past G zero-filled): qwen2-0.5b's G = 7 pads, and
// recurrentgemma-9b's G = 16 fills it; wgmma's 64 rows would be three
// quarters padding, and decode is bound by bytes, not by the tensor-core
// rate.  Q, K and V stay bf16 in shared memory, rows padded by 16 bytes so
// that every ldmatrix phase hits 32 distinct banks; cp.async fetches them
// with zero fill past end: the first tile's K and V together, then each
// tile's V while S runs and the next tile's K as soon as S is done with K.
// S = Q K^T: warp w takes keys 16 w .. 16 w + 15 of the tile over all of D
// and stores them, scaled to log2 units and masked, to an fp32 tile in
// shared memory.  The online softmax runs in fp32, 8 threads a row.  P V:
// warp w owns a quarter of D's 8-column n-tiles; P is split into two bf16
// terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both go through
// the same V fragments, so P V keeps P to ~2^-17 where one bf16 P would
// cost ~1e-3 of the output.  Q K^T takes exact bf16 products into fp32.
// The result is unnormalised: m (log2 units) and l per head, and the G x
// D fp32 accumulator, which the caller's split combine merges.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kSplitTile = 64;      // keys of a tile
constexpr int kSplitRows = 16;      // the A operand's rows: G <= 16 query heads

// Byte offsets of the body's shared memory at head dim D.
template <int D>
struct SplitSmem {
  static constexpr int kLd = D + 8;            // bf16 row stride of Q, K and V
  static constexpr int kLdS = kSplitTile + 4;  // fp32 row stride of S and P
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kSplitRows * kLd * 2;
  static constexpr int kV = kK + kSplitTile * kLd * 2;
  static constexpr int kS = kV + kSplitTile * kLd * 2;
  static constexpr int kAlpha = kS + kSplitRows * kLdS * 4;
  static constexpr int kL = kAlpha + kSplitRows * 4;
  static constexpr int kM = kL + kSplitRows * 4;
  static constexpr int kBytes = kM + kSplitRows * 4;
};

// q: the group's G query heads (G x D, contiguous); keys [k_begin, k_end),
// a whole number of tiles starting below end; `scale_log2` is log2(e) /
// sqrt(D).  Stores head g's unnormalised accumulator at pacc + g stride D
// and its m and l at pm[g stride] and pl[g stride], fp32.  smem:
// SplitSmem<D>::kBytes, 16-byte aligned.
template <int D, typename Rows>
__device__ __forceinline__ void decode_split(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, int Hkv, int hk, int G, int limit, int end,
    int k_begin, int k_end, float scale_log2, const Rows& rows, char* smem,
    float* __restrict__ pacc, float* __restrict__ pm, float* __restrict__ pl, int stride) {
  static_assert(D % 16 == 0 && D <= 256, "head_dim must be a multiple of 16, at most 256");
  using L = SplitSmem<D>;
  constexpr int kChunks = D / 8;               // 16-byte chunks of a row
  constexpr int kNT = D / 8;                   // 8-column n-tiles of P V
  constexpr int kNTW = (kNT + 3) / 4;          // n-tiles of a warp
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, t4 = lane & 3;  // a fragment's row group and column pair
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sQ = s0 + L::kQ, sK = s0 + L::kK, sV = s0 + L::kV;
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sAlpha = reinterpret_cast<float*>(smem + L::kAlpha);
  float* sL = reinterpret_cast<float*>(smem + L::kL);
  float* sM = reinterpret_cast<float*>(smem + L::kM);

  // the 64 cached rows from key k0 (zeros past end) into the tile at dst
  auto load_keys = [&](uint32_t dst, const __nv_bfloat16* src, int k0) {
#pragma unroll
    for (int i = 0; i < kSplitTile * kChunks / kSplitThreads; ++i) {
      const int idx = tid + i * kSplitThreads;
      const int r = idx / kChunks, c = idx % kChunks, kj = k0 + r;
      const bool ok = kj < end;
      cp_async16(dst + (r * L::kLd + c * 8) * 2,
                 ok ? src + (rows(kj) * Hkv + hk) * D + c * 8 : src, ok);
    }
  };
  for (int i = tid; i < kSplitRows * kChunks; i += kSplitThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(sQ + (r * L::kLd + c * 8) * 2, r < G ? q + r * D + c * 8 : q, r < G);
  }
  load_keys(sK, kc, k_begin);
  cp_async_commit();
  load_keys(sV, vc, k_begin);
  cp_async_commit();

  // softmax state of row srow, held alike by its 8 threads
  const int srow = tid >> 3, spart = tid & 7;
  float m_run = -INFINITY, l_run = 0.f;
  // acc[n]: columns 8 (warp kNTW + n) + 2 t4 + {0, 1} of rows quad (0, 1)
  // and quad + 8 (2, 3)
  float acc[kNTW][4];
#pragma unroll
  for (int n = 0; n < kNTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kSplitTile) {
    if (k0 == k_begin) {
      cp_async_wait<1>();  // Q and K landed; the first V may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // K of this tile landed; every warp is done with the last V and P
    if (k0 != k_begin) {
      load_keys(sV, vc, k0);
      cp_async_commit();
    }

    // S = Q K^T for keys 16 warp .. 16 warp + 15: s[n] holds keys
    // 16 warp + 8 n + 2 t4 + {0, 1} of rows quad (0, 1) and quad + 8 (2, 3)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, sQ + (((lane & 7) + ((lane >> 3) & 1) * 8) * L::kLd + ks * 16 +
                           (lane >> 4) * 8) * 2);
      ldmatrix_x4(b, sK + ((16 * warp + (lane & 7) + (lane >> 4) * 8) * L::kLd + ks * 16 +
                           ((lane >> 3) & 1) * 8) * 2);
      mma_16816(s[0], a, b[0], b[1]);
      mma_16816(s[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 16 * warp + 8 * n + 2 * t4;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + col + e;
          x[e] = kj >= end     ? -INFINITY
                 : kj >= limit ? kMaskedLogit
                               : s[n][2 * h + e] * scale_log2;
        }
        *reinterpret_cast<float2*>(sS + (quad + 8 * h) * L::kLdS + col) =
            make_float2(x[0], x[1]);
      }
    __syncthreads();  // S is complete and every warp is done with K: fetch the next tile's
    if (k0 + kSplitTile < k_end) load_keys(sK, kc, k0 + kSplitTile);
    cp_async_commit();

    // online softmax of row srow over keys 8 spart .. 8 spart + 7
    {
      float* row = sS + srow * L::kLdS + 8 * spart;
      const float4 x0 = *reinterpret_cast<const float4*>(row);
      const float4 x1 = *reinterpret_cast<const float4*>(row + 4);
      float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float mx = x[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) mx = fmaxf(mx, x[i]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m_run, mx);  // finite: key k0 < end is in the tile
      const float alpha = exp2f(m_run - mn);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = exp2f(x[i] - mn);
        rs += x[i];
      }
      *reinterpret_cast<float4*>(row) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(x[4], x[5], x[6], x[7]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run = l_run * alpha + rs;
      m_run = mn;
      if (spart == 0) sAlpha[srow] = alpha;
    }
    cp_async_wait<1>();  // V of this tile landed (the next K may still be in flight)
    __syncthreads();     // P and alpha are complete

    // acc = acc * alpha + P_hi V + P_lo V
    const float al0 = sAlpha[quad], al1 = sAlpha[quad + 8];
#pragma unroll
    for (int n = 0; n < kNTW; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < kSplitTile / 16; ++kk) {
      uint32_t ph[4], plo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows quad + 8 (i & 1), keys 16 kk + 8 (i >> 1) + 2 t4
        const float2 p = *reinterpret_cast<const float2*>(
            sS + (quad + 8 * (i & 1)) * L::kLdS + 16 * kk + 8 * (i >> 1) + 2 * t4);
        split_bf16(p.x, p.y, &ph[i], &plo[i]);
      }
#pragma unroll
      for (int n = 0; n < kNTW; ++n) {
        const int nt = warp * kNTW + n;
        if (nt < kNT) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, sV + ((16 * kk + (lane & 15)) * L::kLd + nt * 8) * 2);
          mma_16816(acc[n], ph, b0, b1);
          mma_16816(acc[n], plo, b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (spart == 0) {
    sL[srow] = l_run;
    sM[srow] = m_run;
  }
  __syncthreads();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = quad + 8 * h;
    if (g >= G) continue;
    if (warp == 0 && t4 == 0) {
      pm[g * stride] = sM[g];
      pl[g * stride] = sL[g];
    }
#pragma unroll
    for (int n = 0; n < kNTW; ++n) {
      const int col = (warp * kNTW + n) * 8 + 2 * t4;
      if (col < D)
        *reinterpret_cast<float2*>(pacc + static_cast<size_t>(g) * stride * D + col) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// The split grid around `decode_split`, shared by flash_decode
// (decode_attention.cu) and paged_flash_decode (paged_decode_attention.cu):
// launch 1, grid (Hkv, B, splits), writes each split's partial; launch 2,
// grid (Hq, B), merges each head's splits in split order.  A kernel passes
// `rows_of`, whose rows_of(b) is the Rows functor of batch row b, so both
// kernels run the same instructions on the same key values and give the
// same bits.

// The (B * Hq * splits) partials of part: accumulators (D each), then m,
// then l, head h of row b at entry (b * Hq + h) * splits + s.
struct Partials {
  float *acc, *m, *l;
  __device__ Partials(float* part, int B, int Hq, int splits, int D) {
    const size_t n = static_cast<size_t>(B) * Hq * splits;
    acc = part;
    m = part + n * D;
    l = m + n;
  }
};

namespace {

// Split blockIdx.z of (KV head blockIdx.x, batch row blockIdx.y): whole
// tiles of [0, end), ceil(tiles / splits) to a split; a split that starts
// past its row's end writes an empty partial (m = -inf, l = 0).  With
// kLse a row with no valid key walks nothing (end 0): every split is empty.
template <int D, class RowsOf, bool kLse = false>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ cache_len,
                    float* __restrict__ part, int B, int C, int Hq, int Hkv, int cap,
                    int splits, float scale_log2, RowsOf rows_of) {
  extern __shared__ __align__(16) char split_smem[];
  const int hk = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int G = Hq / Hkv;
  const int limit = min(cache_len[b], cap);
  // no valid key: average all C slots, or with kLse walk none
  const int end = limit > 0 ? limit : (kLse ? 0 : C);
  const int tiles = (end + kSplitTile - 1) / kSplitTile;
  const int per = (tiles + splits - 1) / splits;
  const int t_begin = s * per, t_end = min(tiles, t_begin + per);
  const size_t head0 = static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G;
  const Partials p(part, B, Hq, splits, D);
  const size_t at = head0 * splits + s;  // the group's first head, this split
  if (t_begin >= t_end) {  // past the row's end: an empty partial
    if (static_cast<int>(threadIdx.x) < G) {
      p.m[at + threadIdx.x * splits] = -INFINITY;
      p.l[at + threadIdx.x * splits] = 0.f;
    }
    return;
  }
  decode_split<D>(q + head0 * D, kc, vc, Hkv, hk, G, limit, end, t_begin * kSplitTile,
                  t_end * kSplitTile, scale_log2, rows_of(b), split_smem, p.acc + at * D,
                  p.m + at, p.l + at, splits);
}

// Merge the splits of head blockIdx.x of row blockIdx.y in split order.
// Without kLse, o is bf16 and holds the normalised row.  With kLse
// (flash_decode's return_lse), o is fp32 and lse gets the row's natural-log
// log-sum-exp of the scaled logits over its valid keys, (M + log2 l) ln 2 from
// the log2-domain max M; a row with no valid key (every split empty) gets
// o = 0 and lse = -inf, which weighs 0 when ranks merge their partials.
template <int D, bool kLse = false>
__global__ void decode_combine_kernel(float* __restrict__ part, void* __restrict__ o,
                                      float* __restrict__ lse, int B, int Hq, int splits) {
  const Partials p(part, B, Hq, splits, D);
  const size_t at = (static_cast<size_t>(blockIdx.y) * Hq + blockIdx.x) * splits;
  float big = -INFINITY;
  for (int s = 0; s < splits; ++s) big = fmaxf(big, p.m[at + s]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s)
    if (p.m[at + s] != -INFINITY)
      l = __fadd_rn(l, __fmul_rn(exp2f(p.m[at + s] - big), p.l[at + s]));
  const bool none = kLse && big == -INFINITY;
  if (kLse && threadIdx.x == 0)
    lse[at / splits] = none ? -INFINITY : (big + log2f(l)) * kLn2;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s)
      if (p.m[at + s] != -INFINITY)
        acc = __fadd_rn(acc, __fmul_rn(exp2f(p.m[at + s] - big), p.acc[(at + s) * D + c]));
    if constexpr (kLse)
      static_cast<float*>(o)[(at / splits) * D + c] = none ? 0.f : acc / l;
    else
      static_cast<__nv_bfloat16*>(o)[(at / splits) * D + c] = __float2bfloat16(acc / l);
  }
}

template <int D, class RowsOf, bool kLse = false>
cudaError_t decode_split_prepare() {
  static std::atomic<bool> smem_set[kMaxDevices];
  return allow_dynamic_smem(decode_split_kernel<D, RowsOf, kLse>, SplitSmem<D>::kBytes,
                            smem_set);
}

// Both launches on `stream`.  cap = min(C, window) (C without a window);
// part holds B * Hq * splits * (D + 2) floats.  With kLse, o is an fp32
// (B, Hq, D) output and lse a (B, Hq) fp32 one (decode_combine_kernel).
template <int D, class RowsOf, bool kLse = false>
cudaError_t launch_decode_split(const void* q, const void* kc, const void* vc, void* o,
                                const int* cache_len, float* part, int B, int C, int Hq,
                                int Hkv, int cap, int splits, RowsOf rows_of,
                                cudaStream_t stream, float* lse = nullptr) {
  cudaError_t err = decode_split_prepare<D, RowsOf, kLse>();
  if (err != cudaSuccess) return err;
  decode_split_kernel<D, RowsOf, kLse>
      <<<dim3(Hkv, B, splits), kSplitThreads, SplitSmem<D>::kBytes, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
          static_cast<const __nv_bfloat16*>(vc), cache_len, part, B, C, Hq, Hkv, cap, splits,
          kLog2e / sqrtf(static_cast<float>(D)), rows_of);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<D, kLse><<<dim3(Hq, B), D < 128 ? D : 128, 0, stream>>>(
      part, o, lse, B, Hq, splits);
  return cudaGetLastError();
}

// Registers, spill bytes, dynamic shared memory and resident blocks per SM
// of the split kernel (out: 4 ints).
template <int D, class RowsOf>
cudaError_t decode_split_info(int* out) {
  const cudaError_t err = decode_split_prepare<D, RowsOf>();
  if (err != cudaSuccess) return err;
  return kernel_info(decode_split_kernel<D, RowsOf>, kSplitThreads, SplitSmem<D>::kBytes, out);
}

}  // namespace

}  // namespace repro
